"""Where the time goes on the serving and training paths, on one GPU.

Profiles, at the width of ``recipes/ndns.json`` with random weights, one
offline eval step (B clips of 30 s) and one streaming chunk (B streams,
1 s) of the float model — or, with ``--engine``, one offline call of the
calibrated w8a16 engine (B x 3751 frames) and one streaming forward of the
engine-backed denoiser (one 128-frame block); or, with ``--train``, one
train step of the recipe (B clips of 30 s, dropout 0.1, noBCdecay), which
``--prenorm 0`` (postnorm: the unfused layer around the mixer kernel) or
``--bidirectional`` (the stand-alone scans both ways) put on the mixer
route. ``--topk 0.5`` (with ``approx_topk``) and ``--relufication``
change the model of the float and ``--engine`` regions: a top-k model
runs the stand-alone scan (float) and the engine's per-op route (the
serving mixer kernel, or with ``--relufication`` the scan kernel with its
block requant and top-k on the states, which streams no chunks, so its
streaming region is left out). ``--recipe w8a8`` (or any quantization
recipe) and ``--mxu16`` calibrate and serve the engine at that recipe:
w8a8 runs its denses as int8 dots, ``--mxu16`` a w8a16 engine's every dot
on the two int8 planes of its 16-bit codes — with
``torch.profiler``, after a warm-up, and prints for each: the wall time,
the device time summed over kernels, the device busy share (the union of
the device intervals over the region), the kernels that take the most
device time and the program's spans (``utils/trace.py``) by name. Run on
a machine with the card, from the repository root::

    python -m sparsernns_tpu_torch.utils.profiling [--batch 8] \\
        [--engine [--recipe w8a8] [--mxu16] |
         --train [--prenorm 0] [--bidirectional]] \\
        [--topk 0.5] [--relufication]

Prints the card's name and power limit, then one JSON object per
profiled region.

The cost accounting of the JAX package's profiling module, for reading
kernel and step times against the card: :class:`S5Cost` (FLOPs and bytes
of one S5 layer forward, and its speed-of-light time),
:func:`model_forward_flops` (the NDNS stack's forward FLOPs, for a share
of peak), :func:`chip_peaks` (the card's published peaks, by its name),
:func:`hbm_limit` (the card's memory) and :class:`StepTimer` (wall-clock
steps that end on a device synchronize, warm-up steps dropped).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Optional


@dataclasses.dataclass
class S5Cost:
    """FLOPs / bytes for one S5 layer forward at (B, L, H, P)."""

    flops: int
    hbm_bytes_fused: int
    hbm_bytes_unfused: int

    @staticmethod
    def forward(b: int, l: int, h: int, p: int,
                dtype_bytes: int = 4) -> "S5Cost":
        bl = b * l
        proj = 2 * bl * h * (2 * p) * 2          # B and C projections
        scan = bl * p * 8                        # complex mul-add per step
        d_term = bl * h * 2
        flops = proj + scan + d_term
        # fused kernel: read u, write y (+ weights once)
        io = 2 * bl * h * dtype_bytes
        weights = (h * 2 * p + 2 * p * h + h) * dtype_bytes
        fused = io + weights
        # unfused: u, bu (2P), scan intermediates (two passes at least),
        # xs, y
        unfused = io + weights + (3 * 2 * bl * p) * dtype_bytes * 2
        return S5Cost(flops, fused, unfused)

    def speed_of_light_us(self, hbm_gbps: float = 3350.0,
                          tflops: float = 67.0) -> float:
        """Least runtime (µs) on one card: the fused bytes over the memory
        rate or the FLOPs over the compute rate, whichever is longer. The
        defaults are the H100 SXM data sheet's HBM3 rate and its float32
        rate outside the tensor cores, the precision of the port's
        kernels."""
        t_mem = self.hbm_bytes_fused / (hbm_gbps * 1e3)
        t_flops = self.flops / (tflops * 1e6)
        return max(t_mem, t_flops)


#: Published peaks (dense bf16 FLOP/s, memory bytes/s) by a substring of
#: ``torch.cuda.get_device_name``: NVIDIA's H100 SXM data sheet, at the
#: card's full power limit of 700 W.
CHIP_PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),
    "H100 SXM": (989e12, 3.35e12),
}


def chip_peaks(device=None):
    """(bf16 FLOP/s, memory bytes/s) of the card ``device`` (default: the
    current one). Raises ``ValueError`` for a card the table does not
    hold: no number is assumed."""
    import torch
    name = torch.cuda.get_device_name(device)
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no published peaks for {name!r}; add them to "
                     "CHIP_PEAKS")


def hbm_limit(device=None) -> int:
    """The card's memory in bytes (``torch.cuda.get_device_properties``)."""
    import torch
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device
    ).total_memory)


def model_forward_flops(b: int, l: int, d_io: int, h: int, p: int,
                        n_layers: int, glu_variant: str = "half1") -> float:
    """Analytic forward FLOPs of the NDNS S5 stack (encoder, ``n_layers``
    layers, decoder), the JAX package's count. ``p`` is the number of
    complex states scanned (the B projection is (H, 2P): re|im
    stacked)."""
    bl = b * l
    flops = 2.0 * bl * d_io * h            # encoder
    per_layer = (
        2.0 * bl * h * (2 * p)             # B projection
        + 8.0 * bl * p                     # scan: complex mul-add per step
        + 2.0 * bl * (2 * p) * h           # C projection
        + 8.0 * bl * h                     # D, residual, norm, relu
    )
    if glu_variant in ("half1", "half2", "full"):
        per_layer += 2.0 * bl * h * h + 3.0 * bl * h   # gate dense, sigmoid
    if glu_variant == "full":
        per_layer += 2.0 * bl * h * h
    flops += n_layers * per_layer
    flops += 2.0 * bl * h * d_io           # decoder
    return flops


class StepTimer:
    """Wall-clock step timer with warm-up discard: a ``with`` block per
    step; each step ends on ``torch.cuda.synchronize`` (on the card) before
    the clock is read, so it times the device's work, not its enqueue."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = device
        self.times = []
        self._n = 0
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))


#: chrome-trace categories of device operations (kernels, copies, fills)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the span that bounds a profiled region
REGION = "profile_region"


def _union(intervals):
    """The union of (start, end) intervals, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _covered(intervals) -> float:
    return sum(e - s for s, e in _union(intervals))


def summarize_trace(events, top: int = 10) -> dict:
    """Device time and program spans of the region in a chrome trace
    (``export_chrome_trace``'s ``traceEvents``): the stretch of the
    ``span(REGION)`` that :func:`profile_region` opens. Times in ms.

    ``device_ms`` sums the device operations inside the region;
    ``device_busy_share`` is the union of their intervals over the
    region's length. ``spans`` holds, for each program span by name, its
    count, host ms, self ms (host ms less the time its child spans on the
    same thread cover) and the device ms of the operations launched while
    one of them was open, from any thread (the backward's kernels are
    launched from autograd's thread)."""
    from sparsernns_tpu_torch.utils.trace import PREFIX
    xs = [e for e in events if e.get("ph") == "X"]
    launches, spans = {}, []
    for e in xs:
        ts = float(e["ts"]) * 1e-3
        end = ts + float(e.get("dur", 0.0)) * 1e-3
        corr = (e.get("args") or {}).get("correlation")
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((e["name"][len(PREFIX):], ts, end, e.get("tid")))
    region = [s for s in spans if s[0] == REGION]
    if not region:
        raise ValueError(f"the trace holds no {PREFIX}{REGION} span")
    w0, w1 = region[0][1], region[0][2]
    ops = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            ts = float(e["ts"]) * 1e-3
            end = ts + float(e.get("dur", 0.0)) * 1e-3
            if w0 <= ts and end <= w1:
                corr = (e.get("args") or {}).get("correlation")
                ops.append((e["name"], ts, end, launches.get(corr)))
    spans = [s for s in spans if s[0] != REGION and w0 <= s[1] <= w1]
    by_name = {}
    for name, ts, end, _ in ops:
        n, ms = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, ms + end - ts)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    device_ms = sum(ms for _, (_, ms) in kernels)
    table = {}
    for name, ts, end, tid in spans:
        row = table.setdefault(name, {"count": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "device_ms": 0.0})
        inner = [(a, b) for n2, a, b, t2 in spans
                 if t2 == tid and ts <= a and b <= end
                 and (a, b) != (ts, end)]
        row["count"] += 1
        row["host_ms"] += end - ts
        row["self_ms"] += end - ts - _covered(inner)
    for name, row in table.items():
        opened = [(a, b) for n2, a, b, _ in spans if n2 == name]
        row["device_ms"] = sum(
            end - ts for _, ts, end, launch in ops if launch is not None
            and any(a <= launch <= b for a, b in opened))
    return {
        "device_ms": device_ms,
        "device_busy_share": (_covered([(a, b) for _, a, b, _ in ops])
                              / (w1 - w0) if w1 > w0 else None),
        "device_events": len(ops),
        "top_kernels": [{"name": name[:80], "count": n, "device_ms": ms}
                        for name, (n, ms) in kernels[:top]],
        "spans": dict(sorted(table.items())),
    }


def profile_region(name: str, fn, top: int = 10) -> dict:
    """Run ``fn`` once under the profiler; summarize wall and device time
    and the program's spans (:func:`summarize_trace`).

    The profiler on the H100 machine records no device event for the first
    kernel of a window, so a one-element fill runs first, outside the
    region, to take that place."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparsernns_tpu_torch.utils.trace import span
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        with span(REGION):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return {"region": name, "wall_ms": wall_us / 1e3,
            **summarize_trace(events, top)}


def main() -> int:
    import numpy as np
    import torch

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.steps import make_ndns_eval_step
    from sparsernns_tpu_torch.utils.config import RunConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--engine", action="store_true",
                    help="profile the w8a16 engine instead of the float "
                         "model")
    ap.add_argument("--train", action="store_true",
                    help="profile one train step of the float model")
    ap.add_argument("--prenorm", type=int, choices=(0, 1), default=1,
                    help="with --train: 0 trains the postnorm model")
    ap.add_argument("--bidirectional", action="store_true",
                    help="with --train: the bidirectional model")
    ap.add_argument("--topk", type=float, default=1.0,
                    help="activation top-k share of the model (< 1: on, "
                         "with approx_topk)")
    ap.add_argument("--recipe", default=None,
                    help="with --engine: the quantization recipe "
                         "(default the recipe's convert_quantization)")
    ap.add_argument("--mxu16", action="store_true",
                    help="with --engine: integer dots on 16-bit codes")
    ap.add_argument("--relufication", action="store_true",
                    help="the relufied model (with --topk: top-k on the "
                         "states too)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = RunConfig().with_recipe(os.path.join(root, "recipes", "ndns.json"))
    cfg = dataclasses.replace(
        cfg, topk=args.topk, approx_topk=args.topk < 1.0,
        relufication=cfg.relufication or args.relufication,
        convert_quantization=args.recipe or cfg.convert_quantization,
        engine_mxu16=args.mxu16)
    if (args.recipe or args.mxu16) and not args.engine:
        raise SystemExit("--recipe and --mxu16 profile the engine only")
    if args.train and (args.topk < 1.0 or args.relufication):
        raise SystemExit("--topk and --relufication profile serving only")
    model = build_model(cfg, 257, 257, device="cuda", seed=0)
    b, audio_len, chunk = args.batch, 30 * 16000, 16000
    ds = SyntheticNDNS(size=b, length=audio_len, seed=0)
    pairs = [ds[i] for i in range(b)]
    noisy = np.stack([a for a, _ in pairs])
    noisy_t = torch.from_numpy(noisy).cuda()
    clean_t = torch.from_numpy(np.stack([c for _, c in pairs])).cuda()
    step = make_ndns_eval_step(model)

    def eval_step():
        nm, nph = stft_splitter(noisy_t)
        cm, _ = stft_splitter(clean_t)
        return step(nm, nph, cm, clean_t)

    if args.engine:
        return _profile_engine(cfg, model, noisy, noisy_t)
    if args.train:
        cfg = dataclasses.replace(cfg, prenorm=bool(args.prenorm),
                                  bidirectional=args.bidirectional)
        return _profile_train(cfg, noisy_t, clean_t)

    den = StreamingDenoiser(model, batch_size=b)
    pos = [0]

    def stream_chunk():
        den.process(noisy[:, pos[0]:pos[0] + chunk])
        pos[0] += chunk

    eval_step()                     # warm-up: builds kernels, plans
    for _ in range(2):
        stream_chunk()
    kind = _kind(cfg)
    _report(((f"{kind}offline eval step (incl. STFT)", eval_step),
             (f"{kind}streaming chunk (1 s)", stream_chunk)))
    return 0


def _kind(cfg) -> str:
    """Region-name prefix naming the model's top-k and relu switches."""
    return (f"topk {cfg.topk} " if cfg.topk < 1.0 else "") + (
        "relufied " if cfg.relufication else "")


def _report(regions) -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for name, fn in regions:
        print(json.dumps(profile_region(name, fn)), flush=True)


def _profile_train(cfg, noisy_t, clean_t) -> int:
    """One warm train step as the recipe sets it, STFT included."""
    from sparsernns_tpu_torch.train.loop import (build_model,
                                                 create_run_state,
                                                 prep_ndns_batch)
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step

    model = build_model(cfg, 257, 257, training=True, device="cuda", seed=0)
    state = create_run_state(cfg, model, steps_per_epoch=2)
    step = make_ndns_train_step(model)

    def train_step():
        step(state, *prep_ndns_batch(noisy_t, clean_t), clean_t)

    for _ in range(2):              # warm-up: builds kernels, plans
        train_step()
    kind = ("" if cfg.prenorm else "postnorm ") + (
        "bidirectional " if cfg.bidirectional else "")
    _report(((f"{kind}train step (B={noisy_t.shape[0]}, incl. STFT)",
              train_step),))
    return 0


def _profile_engine(cfg, model, noisy, noisy_t) -> int:
    """The calibrated engine: one offline call (the whole-network kernel)
    and one streaming forward of a 128-frame block (the per-layer carry
    kernel) with its host framing."""
    import torch

    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN

    b, block = noisy.shape[0], 128
    x = (stft_splitter(noisy_t)[0] - STFT_MAG_MEAN).transpose(1, 2)
    x = x.contiguous()
    cal_model = build_model(
        cfg, 257, 257, device="cuda", seed=0, scan_mode="sequential",
        q_config=quantization_recipes[cfg.convert_quantization](
            static_quant=True, calibrating=True))
    frozen = calibrate(cal_model, model.state_dict(),
                       [x[:, :500], x[:, 500:1000]])
    engine = engine_from_frozen(cfg, *frozen, block_t=512)
    den = StreamingDenoiser.from_engine(
        engine_from_frozen(cfg, *frozen, block_t=block), batch_size=b)
    pos = [0]

    def stream_forward():           # 128 hops of audio: one block
        den.process(noisy[:, pos[0]:pos[0] + block * den.hop])
        pos[0] += block * den.hop

    kind = _kind(cfg) + f"{cfg.convert_quantization} " + (
        "mxu16 " if cfg.engine_mxu16 else "")
    regions = [(f"{kind}engine offline call (B={b}, L={x.shape[1]})",
                lambda: engine(x))]
    engine(x)                       # warm-up: builds kernels
    if not engine._state_topk():    # state top-k streams no chunks
        for _ in range(4):          # the first forward waits for nfft
            stream_forward()
        regions.append((f"{kind}engine streaming forward (128-frame "
                        "block)", stream_forward))
    _report(regions)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
