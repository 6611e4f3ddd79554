"""h2d_wait_ms.denoise: host milliseconds a request spent inside the
program's upload spans (``stft.upload``, ``istft.upload``,
``istft.norm_upload`` of ``ops/stft.py``: the DFT bases and the
overlap-add norm copied from host memory, which blocks the host), from the
trace."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.span_host_seconds(tr, "*upload")
    return t / tr.steps * 1e3 if t > 0 else None
