"""The serving-engine kernels alone on one GPU.

Without options: builds every kernel, then runs ``chip_smoke.py``'s phase
4 (K6, K5a, K5b against their plain versions at B = 8 and 32, ragged,
every variant; the passes as the CUDA source recorded them), phase 5 (the
engine offline call, its mask digest, times and peak memory, the stack
route), phase 6 (streaming from the engine), phase 17 (the integer-dot
modes against plain, timed) and phase 18 (the integer-dot engines served)
at the flagship width of ``recipes/ndns.json``, on the inputs
``chip_smoke.py`` gives them. A quicker check than the whole
``chip_smoke.py`` after an edit to ``csrc/engine_*``.

``--digests``: K6, the K5 stack and K4a's engine modes of one tree on
seeded networks of int8, int16 and float32 weights: the SHA-256 of each
output, medians of 5 call times at B = 8 and B = 32, the error against
the plain version, and each row pass's dense products on the tensor cores
and as fmaf tiles (``engine_layer.read_launched_dots``, where the tree
records them). The networks are made here from a seed at the flagship
widths (d_in = d_out = 257, H = 192, P = 128, 3 layers, GLU half1, gelu,
prenorm, bf16 activations, a 16-bit residual grid, a 16-bit state grid
every 512 frames): ``int8`` as the w8a16 engine holds it (int8 codes with
pow2 scales in every dense, with the fragments the engine lays out where
the tree has them), ``int16`` and ``f32`` the same network over int16
codes and float32 weights, ``w8a8`` the int8 network with its encoder,
decoder and GLU gate as integer dots on 8-bit grids. Two trees whose
kernels compute the same values print the same digests, so the script,
run once on this tree and once on another (``--root``) on the same card,
shows which outputs a change moved, and times both. It also holds K6
against the K5 stack bit for bit, at B = 8 and on a ragged call (B = 3,
L = 70). ``--profile`` prints the device time of each launch of one K6
call (the profiler's kernel events, in order). ``--witness`` measures,
on the w8a8 and the int8 networks at B = 8, how far the summation order
alone moves K6: the plain version against itself over the same network
with its hidden units, its states and its input features in reverse
order (the same products, summed in another order), beside K6 with its
float dots on the tensor cores and as fmaf chains, each against plain.

Run from the repository root::

    python3 tools/chip_engine.py
    python3 tools/chip_engine.py --digests [--root DIR] [--no-plain]
        [--kinds int8,...] [--batches 8,32] [--profile] [--witness]

``--root`` imports ``sparsernns_tpu_torch`` from another checkout (its
kernels build under that checkout's ``_build/``). ``--digests`` prints
one JSON line ``{"k6": {...}}`` last.
"""

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, P, D_IO, N_LAYERS, BLOCK = 3751, 192, 128, 257, 3, 512
KINDS = ("int8", "int16", "f32", "w8a8")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _digest(t) -> str:
    import torch
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _median_ms(fn, iters: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _launch_us(fn):
    """(kernel, device us) of each kernel ``fn`` launches, in order."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")   # the window's first kernel is lost
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and "engine" in e.get("name", "")),
                     key=lambda e: e["ts"])
    return [(e["name"].split("(")[0].split("::")[-1][:24],
             round(float(e["dur"]), 1)) for e in kernels]


def network(kind: str, seed: int = 0, device: str = "cuda"):
    """(enc, layers, dec, mode) of a seeded network on ``device``, its
    weights of ``kind``, with the fragments the engine would lay out
    (``engine_layer.attach_fragments``, where the tree has it)."""
    import torch
    from sparsernns_tpu_torch.ops.cuda import engine_layer
    from sparsernns_tpu_torch.ops.cuda.engine_layer import Dense, LayerMode
    from sparsernns_tpu_torch.ops.intdot import weight_colsum
    from sparsernns_tpu_torch.quantize.engine import QWeight, _LayerPack
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device(device)

    def weight(k, n):
        """A weight of ``kind`` whose values are about N(0, 1/k)."""
        if kind == "f32":
            return (torch.randn((k, n), generator=gen) * k ** -0.5).to(dev), \
                None
        top = 16383 if kind == "int16" else 127
        dtype = torch.int16 if kind == "int16" else torch.int8
        w = torch.randint(-top, top + 1, (k, n), generator=gen,
                          dtype=dtype)
        # a pow2 scale near sqrt(3 / k) / top: values of about unit variance
        # over k inputs
        e = round(torch.log2(torch.tensor(3.0 / k)).item() / 2) \
            - (top.bit_length())
        return w.to(dev), 2.0 ** e

    def qweight(k, n):
        w, s = weight(k, n)
        return QWeight(w, s, weight_colsum(w) if kind != "int16" else None)

    # the integer dots' input grids (w8a8): 8 bits
    grid8 = (2.0 ** -5, 8) if kind == "w8a8" else None

    def vec(n, sc=0.1, mean=0.0):
        return (mean + sc * torch.randn(n, generator=gen)).to(dev)

    layers = []
    for _ in range(N_LAYERS):
        radius = torch.rand(P, generator=gen) * 0.39 + 0.6
        angle = torch.rand(P, generator=gen) * 6.0 - 3.0
        lam = ((radius * torch.cos(angle)).to(dev),
               (radius * torch.sin(angle)).to(dev))
        w_b, s_b = weight(H, 2 * P)
        w_c, s_c = weight(2 * P, H)
        layers.append(_LayerPack(
            lam=lam, w_b=w_b, w_c=w_c, d=vec(H, 0.5), norm_w=vec(H, 0.1, 1.0),
            norm_b=vec(H), out2_kernel=qweight(H, H), out2_bias=vec(H),
            out2_in_scale=grid8,
            residual_requant=(2.0 ** -9, 16),
            state_requant=(2.0 ** -7, 2.0 ** -8, 16),
            wb_scales=None if s_b is None else (s_b, s_b),
            wc_scales=None if s_c is None else (2 * s_c, 2 * s_c)))
    enc = Dense(qweight(D_IO, H), vec(H), grid8)
    dec = Dense(qweight(H, D_IO), vec(D_IO), grid8)
    mode = LayerMode(act_dtype=torch.bfloat16)
    if hasattr(engine_layer, "attach_fragments"):
        engine_layer.attach_fragments(enc, layers, dec, mode)
    return enc, layers, dec, mode


def reversed_network(enc, layers, dec):
    """The same network with its hidden units, each half's states and its
    input features in reverse order: every float dot sums the same
    products in another order, every integer dot is the same exact sum.
    Takes x with its features reversed; gives the same output columns."""
    import dataclasses

    import torch
    from sparsernns_tpu_torch.ops.cuda.engine_layer import Dense
    from sparsernns_tpu_torch.ops.intdot import weight_colsum

    def qw(q, w):
        w = w.contiguous()
        return dataclasses.replace(q, data=w, colsum=weight_colsum(w),
                                   frags=None)

    def halves(w, dim):   # [re | im] along dim, each half reversed
        re, im = w.split(P, dim=dim)
        return torch.cat([re.flip(dim), im.flip(dim)], dim=dim).contiguous()

    def rev(v):
        return v.flip(0).contiguous()

    out = [dataclasses.replace(
        lay, lam=tuple(rev(v) for v in lay.lam),
        w_b=halves(lay.w_b.flip(0), 1), w_c=halves(lay.w_c.flip(1), 0),
        d=rev(lay.d), norm_w=rev(lay.norm_w), norm_b=rev(lay.norm_b),
        out2_kernel=qw(lay.out2_kernel, lay.out2_kernel.data.flip(0, 1)),
        out2_bias=rev(lay.out2_bias), wb_frags=None, wc_frags=None)
        for lay in layers]
    r_enc = Dense(qw(enc.kernel, enc.kernel.data.flip(0, 1)), rev(enc.bias),
                  enc.in_spec, enc.out_spec)
    r_dec = Dense(qw(dec.kernel, dec.kernel.data.flip(0)), dec.bias,
                  dec.in_spec, dec.out_spec)
    return r_enc, out, r_dec


def witness(x, report) -> None:
    """How far the summation order alone moves K6 at B = 8 on the w8a8 and
    the int8 networks (module docstring, ``--witness``), against max(1,
    max|plain|)."""
    import torch
    from sparsernns_tpu_torch.ops.cuda import engine_layer, engine_network
    x = x[:8]
    report["witness"] = {}
    for kind in ("w8a8", "int8"):
        enc, layers, dec, mode = network(kind)
        ref = engine_network.engine_network_plain(x, enc, layers, dec, mode,
                                                  block_t=BLOCK)
        scale = max(1.0, ref.abs().max().item())
        got = {"plain, the order reversed":
               engine_network.engine_network_plain(
                   x.flip(-1).contiguous(),
                   *reversed_network(enc, layers, dec), mode,
                   block_t=BLOCK)}
        for name, on in (("fmaf chains", False), ("tensor cores", True)):
            def frags(w):
                return engine_layer.mma_fragments(w) if on else None
            for lay in layers:
                lay.wb_frags, lay.wc_frags = frags(lay.w_b), frags(lay.w_c)
            for q in [enc.kernel, dec.kernel] + [lay.out2_kernel
                                                 for lay in layers]:
                q.frags = frags(q.data)   # an integer dot reads none
            got[f"K6, {name}"] = engine_network.engine_network_cuda(
                x, enc, layers, dec, mode, block_t=BLOCK)
        torch.cuda.synchronize()
        for name, out in got.items():
            d = (out.float() - ref.float()).abs()
            gap = {"max": d.max().item() / scale,
                   "mean": d.mean().item() / scale}
            report["witness"][f"{kind}: {name}"] = gap
            print(f"{kind} K6 B=8, {name} vs plain: max {gap['max']:.3e}, "
                  f"mean {gap['mean']:.3e} of max(1, |plain|)", flush=True)


def phases() -> int:
    """Without options: see the module docstring."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_engine: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.ops.cuda import build
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.steps import make_ndns_eval_step
    from sparsernns_tpu_torch.utils.config import RunConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.time()
    build.build_all()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        if name.startswith("engine"):
            print(f"--- nvcc {name}\n{log.strip()}", flush=True)
    cfg = RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json"))
    model = build_model(cfg, 257, 257, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():   # non-trivial BatchNorm statistics
        for layer in model.encoder.layers:
            h = layer.d_model
            layer.norm.running_mean.copy_(0.1 * torch.randn(h, generator=gen))
            layer.norm.running_var.copy_(0.5 + torch.rand(h, generator=gen))
    ds = SyntheticNDNS(size=cs.B, length=cs.SECONDS * 16000, seed=0)
    pairs = [ds[i] for i in range(cs.B)]
    noisy = np.stack([a for a, _ in pairs])
    clean_t = torch.from_numpy(np.stack([c for _, c in pairs])).to(dev)
    noisy_mag, noisy_phase = stft_splitter(torch.from_numpy(noisy).to(dev))
    clean_mag, _ = stft_splitter(clean_t)
    feats = (noisy_mag, noisy_phase, clean_mag)
    metrics = make_ndns_eval_step(model)(*feats, clean_t)
    float_metrics = (metrics["loss"].item(), metrics["si_snr"].item())
    frames = noisy_mag.shape[-1]
    records = {}
    marks = [time.time()]

    def mark(name):
        marks.append(time.time())
        print(f"[{name}: {marks[-1] - marks[-2]:.1f} s]", flush=True)

    eng = cs.engine_setup(cfg, model, noisy_mag)
    mark("engine set-up")
    cs.engine_kernel_phase(cfg, eng, gen, records)
    mark("engine kernel phase")
    cs.engine_offline_phase(cfg, eng, feats, clean_t, float_metrics, records)
    mark("engine offline phase")
    cs.engine_streaming_phase(cfg, eng, noisy, None, records)
    mark("engine streaming phase")
    trees = cs.intdot_kernel_phase(cfg, model, eng.cal_x, eng.x_eng, frames,
                                   gen, records)
    mark("int-dot kernel phase")
    cs.intdot_serving_phase(cfg, trees, (noisy, clean_t), feats, records,
                            cs.kernel_launches)
    mark("int-dot serving phase")
    print(_card())
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in records.values()]}))
    return 0


def digests(args) -> int:
    """``--digests``: see the module docstring."""
    import torch
    if not torch.cuda.is_available():
        print("chip_engine: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparsernns_tpu_torch.ops.cuda import (build, engine_layer,
                                               engine_network, fused_s5)
    assert os.path.dirname(build.__file__).startswith(root), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    libs = ["engine_network", "engine_layer", "fused_s5"]
    build.build_all(libs)
    print(f"tree {root}: build {time.time() - t0:.1f} s", flush=True)
    for name in libs:
        if name in build.build_logs:
            print(f"--- nvcc {name}\n{build.build_logs[name].strip()}",
                  file=sys.stderr)
    dots = getattr(engine_layer, "read_launched_dots", None)
    takes_frags = "frags" in inspect.signature(
        fused_s5.fused_s5_engine_cuda).parameters
    report = {"root": root, "digests": {}, "errors": {}, "ms": {},
              "dots": {}, "stack_equal": {}}
    gx = torch.Generator().manual_seed(8)
    x32 = torch.randn((32, L, D_IO), generator=gx).abs().to("cuda")
    with torch.no_grad():
        for kind in args.kinds.split(","):
            enc, layers, dec, mode = network(kind)

            def k6(x):
                return engine_network.engine_network_cuda(
                    x, enc, layers, dec, mode, block_t=BLOCK)

            def stack(x):
                r, in_rq = x, None
                for i, lay in enumerate(layers):
                    r = engine_layer.engine_layer_cuda(
                        r, lay, mode, block_t=BLOCK, in_requant=in_rq,
                        enc=enc if i == 0 else None,
                        dec=dec if i == N_LAYERS - 1 else None)
                    in_rq = lay.residual_requant
                return r

            for batch in [int(b) for b in args.batches.split(",")]:
                x = x32[:batch]
                out = k6(x)
                torch.cuda.synchronize()
                tag = f"K6 {kind} B={batch}"
                report["digests"][tag] = _digest(out)
                if dots is not None:
                    report["dots"][tag] = dots("engine_network")
                report["ms"][tag] = _median_ms(lambda: k6(x))
                if args.profile:
                    report.setdefault("launch_us", {})[tag] = \
                        _launch_us(lambda: k6(x))
                    print(f"{tag} launches (us): "
                          f"{report['launch_us'][tag]}", flush=True)
                if batch == 8:
                    stk = stack(x)
                    report["stack_equal"][f"{kind} B=8"] = bool(
                        torch.equal(out, stk))
                    if dots is not None:
                        report["dots"][f"K5 stack {kind} B=8 last"] = \
                            dots("engine_layer")
                    if not args.no_plain:
                        ref = engine_network.engine_network_plain(
                            x, enc, layers, dec, mode, block_t=BLOCK)
                        report["errors"][tag] = (
                            (out - ref).abs().max().item()
                            / max(1.0, ref.abs().max().item()))
                # K5a: the middle layer over the first layer's codes
                r0 = engine_layer.engine_layer_cuda(
                    x, layers[0], mode, block_t=BLOCK, enc=enc)
                kw = dict(block_t=BLOCK,
                          in_requant=layers[0].residual_requant)
                tag5 = f"K5a {kind} B={batch}"
                report["digests"][tag5] = _digest(
                    engine_layer.engine_layer_cuda(r0, layers[1], mode, **kw))
                report["ms"][tag5] = _median_ms(
                    lambda: engine_layer.engine_layer_cuda(
                        r0, layers[1], mode, **kw))
                # K4a engine mode: the middle layer's mixer alone on z
                lay = layers[1]
                u = torch.randn((batch, L, H), generator=gx).to(
                    "cuda", torch.bfloat16)
                kw4 = dict(block_t=BLOCK, wb_scales=lay.wb_scales,
                           wc_scales=lay.wc_scales,
                           block_requant=lay.state_requant)
                # the layer's fragments, where the tree's K4a takes them
                frags = (dict(frags=(lay.wb_frags, lay.wc_frags))
                         if takes_frags else {})
                ops = (u, lay.lam, lay.w_b, lay.w_c, lay.d)
                tag4 = f"K4a engine {kind} B={batch}"
                report["digests"][tag4] = _digest(
                    fused_s5.fused_s5_engine_cuda(*ops, **kw4, **frags))
                if dots is not None:
                    report["dots"][tag4] = dots("fused_s5")
                report["ms"][tag4] = _median_ms(
                    lambda: fused_s5.fused_s5_engine_cuda(*ops, **kw4,
                                                          **frags))
                if batch == 8 and not args.no_plain:
                    ref = fused_s5.fused_s5_engine_plain(*ops, **kw4)
                    got = fused_s5.fused_s5_engine_cuda(*ops, **kw4,
                                                        **frags)
                    report["errors"][tag4] = (
                        (got - ref).abs().max().item()
                        / max(1.0, ref.abs().max().item()))
                for t in (tag, tag5, tag4):
                    print(f"{t}: {report['digests'][t]} "
                          f"{report['ms'][t]:.3f} ms"
                          + (f", err {report['errors'][t]:.2e}"
                             if t in report["errors"] else ""), flush=True)
            # ragged: 210 rows, L below the block
            xr = x32[:3, :70].contiguous()
            report["stack_equal"][f"{kind} ragged"] = bool(
                torch.equal(k6(xr), stack(xr)))
            report["digests"][f"K6 {kind} ragged"] = _digest(k6(xr))
            del enc, layers, dec
            torch.cuda.empty_cache()
        if args.witness:
            witness(x32, report)
    report["card"] = _card()
    print(json.dumps({"k6": report}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--digests", action="store_true")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--no-plain", action="store_true")
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--batches", default="8,32")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args()
    return digests(args) if args.digests else phases()


if __name__ == "__main__":
    sys.exit(main())
