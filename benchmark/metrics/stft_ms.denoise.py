"""stft_ms.denoise: device milliseconds a request of the operations that
the benchmark's ``stft`` and ``istft`` spans launched (the program's
``stft_splitter`` and ``stft_mixer_tm`` with the mask), from the trace."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = trace.ops_in_spans(tr, {"stft", "istft"})
    return t / tr.steps * 1e3 if t > 0 else None
