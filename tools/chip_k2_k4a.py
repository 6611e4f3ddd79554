"""K2 and K4a / K4b of one tree on one GPU: the SHA-256 of each kernel's
output on seeded inputs, medians of 5 call times at B = 8 and B = 32, and
the error against the plain version at B = 8.

The inputs are made here from a seed (flagship width H = 192, P = 128,
L = 3751; random weights): K2 in every GLU variant and activation, with
and without dropout masks, affine and non-affine, on f32 and bf16 streams;
K4a in its float mode (relu_state off / on; and at H = 640) and its
engine modes (int8 weights with per-half scales on a 16-bit state grid,
bf16 and f32 input, block 512 and 16; int16 weights; f32 weights on a
32-bit grid); K4b one 128-frame block from a carry on the grid. Two
trees whose kernels compute the same values print the same digests, so
the script, run once on this tree and once on another (``--root``) on the
same card, shows whether a redesign moved any value, and times both.

Run from the repository root::

    python3 tools/chip_k2_k4a.py [--root DIR] [--no-time]

``--root`` imports ``sparsernns_tpu_torch`` from another checkout (its
kernels build under that checkout's ``_build/``). Prints one JSON line
``{"k2_k4a": {...}}`` last.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, H, P = 8, 3751, 192, 128
BLOCK, STREAM_BLOCK = 512, 128
#: the engine modes' 16-bit state grid (s_re, s_im, bits)
GRID16 = (2.0 ** -8, 2.0 ** -9, 16)


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


def operands(batch: int, seed: int = 0):
    """Seeded operands of every case at batch ``batch`` on the card."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")

    def rnd(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).to(dev)

    radius = torch.rand(P, generator=gen) * 0.39 + 0.6
    angle = torch.rand(P, generator=gen) * 6.0 - 3.0
    lam = ((radius * torch.cos(angle)).to(dev),
           (radius * torch.sin(angle)).to(dev))
    x = rnd(batch, L, H)
    keep = 0.9
    mask = lambda: ((torch.rand((batch, 1, H), generator=gen) < keep)  # noqa
                    .float() / keep).to(dev)
    tail = dict(
        x=x, skip=rnd(batch, L, H), lam=lam, w_b=rnd(H, 2 * P, sc=H ** -0.5),
        w_c=rnd(2 * P, H, sc=(2 * P) ** -0.5), d=rnd(H),
        nw=1.0 + 0.1 * rnd(H), nb=0.1 * rnd(H), o2k=rnd(H, H, sc=H ** -0.5),
        o2b=0.1 * rnd(H), o1k=rnd(H, H, sc=H ** -0.5), o1b=0.1 * rnd(H),
        m1=mask(), m2=mask())
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen,  # noqa
                                  dtype=torch.int8).to(dev)
    i16 = lambda *s: torch.randint(-2000, 2000, s, generator=gen,  # noqa
                                   dtype=torch.int16).to(dev)
    mixer = dict(
        u=x, lam=lam, w_b=tail["w_b"], w_c=tail["w_c"], d=tail["d"],
        w_b8=i8(H, 2 * P), w_c8=i8(2 * P, H), w_b16=i16(H, 2 * P),
        w_c16=i16(2 * P, H),
        carry=tuple(torch.round(rnd(batch, P, sc=200.0)) * s
                    for s in GRID16[:2]))
    return tail, mixer


def cases(tail, mixer, fused_s5, layer_tail):
    """name -> a call of one kernel on the card (K2 through
    ``layer_tail_cuda``, K4a / K4b through ``fused_s5_cuda`` /
    ``fused_s5_engine_cuda``) and the plain version's call."""
    import torch
    t = tail
    out = {}
    for glu in ("half1", "full", "half2", "none"):
        for act, flags in (("gelu", (False, False)), ("relu", (True, True))):
            for masks in (False, True):
                if glu == "none" and masks:
                    continue
                kw = dict(act=act, glu=glu, relu_state=flags[0],
                          layer_relu=flags[1],
                          m1=t["m1"] if masks else None,
                          m2=t["m2"] if masks and glu != "none" else None)
                args = (t["x"], t["lam"], t["w_b"], t["w_c"], t["d"],
                        t["nw"], t["nb"], t["o2k"], t["o2b"], t["o1k"],
                        t["o1b"])
                name = f"K2 {glu}/{act}" + (" masks" if masks else "")
                out[name] = (lambda a=args, k=kw: layer_tail.layer_tail_cuda(
                    *a, **k), lambda a=args, k=kw:
                    layer_tail.layer_tail_plain(*a, **k))
    for dtype in (torch.float32, torch.bfloat16):
        for affine in (True, False):
            if dtype == torch.float32 and affine:
                continue
            xs = t["x"].to(dtype)
            kw = dict(act="gelu", glu="half1", m1=t["m1"], m2=t["m2"],
                      skip=None if affine else t["skip"].to(dtype))
            nwb = (t["nw"], t["nb"]) if affine else (None, None)
            args = (xs, t["lam"], t["w_b"], t["w_c"], t["d"], *nwb,
                    t["o2k"], t["o2b"], None, None)
            name = (f"K2 half1/gelu masks {str(dtype)[6:]} "
                    + ("affine" if affine else "non-affine"))
            out[name] = (lambda a=args, k=kw: layer_tail.layer_tail_cuda(
                *a, **k), lambda a=args, k=kw:
                layer_tail.layer_tail_plain(*a, **k))
    m = mixer
    ops = (m["lam"], m["w_b"], m["w_c"], m["d"])
    for relu in (False, True):
        out[f"K4a float relu_state={relu}"] = (
            lambda r=relu: fused_s5.fused_s5_cuda(m["u"], *ops, r),
            lambda r=relu: fused_s5.fused_s5_plain(m["u"], *ops, r))
    eng = {
        "int8 bf16 u block 512": (m["u"].to(torch.bfloat16), m["w_b8"],
                                  m["w_c8"], BLOCK, True),
        "int8 f32 u block 16": (m["u"], m["w_b8"], m["w_c8"], 16, False),
        "int16 bf16 u block 512": (m["u"].to(torch.bfloat16), m["w_b16"],
                                   m["w_c16"], BLOCK, True),
    }
    for name, (u, wb, wc, blk, relu) in eng.items():
        sc = 2.0 ** -14 if wb.dtype == torch.int16 else 2.0 ** -10
        kw = dict(block_t=blk, wb_scales=(sc, sc / 2),
                  wc_scales=(sc, sc / 2), block_requant=GRID16,
                  relu_state=relu)
        args = (u, m["lam"], wb, wc, m["d"])
        out[f"K4a engine {name}"] = (
            lambda a=args, k=kw: fused_s5.fused_s5_engine_cuda(*a, **k),
            lambda a=args, k=kw: fused_s5.fused_s5_engine_plain(*a, **k))
    # a wide mixer, H = 640 at P = 128, from a generator of its own
    gw = torch.Generator().manual_seed(640)
    rw = lambda *s, sc=1.0: (  # noqa: E731
        torch.randn(s, generator=gw) * sc).to(m["u"].device)
    hw = 640
    wide = (rw(m["u"].shape[0], L, hw), m["lam"],
            rw(hw, 2 * P, sc=hw ** -0.5), rw(2 * P, hw, sc=(2 * P) ** -0.5),
            rw(hw))
    out["K4a float H=640 relu_state=True"] = (
        lambda: fused_s5.fused_s5_cuda(*wide, True),
        lambda: fused_s5.fused_s5_plain(*wide, True))
    kw32 = dict(block_t=BLOCK, block_requant=(2.0 ** -26, 2.0 ** -27, 32))
    out["K4a engine f32 weights 32-bit grid"] = (
        lambda: fused_s5.fused_s5_engine_cuda(m["u"], *ops, **kw32),
        lambda: fused_s5.fused_s5_engine_plain(m["u"], *ops, **kw32))
    ub = m["u"][:, :STREAM_BLOCK].to(torch.bfloat16).contiguous()
    kwb = dict(block_t=STREAM_BLOCK, wb_scales=(2.0 ** -10, 2.0 ** -11),
               wc_scales=(2.0 ** -10, 2.0 ** -11), block_requant=GRID16,
               relu_state=True, carry=m["carry"])
    argsb = (ub, m["lam"], m["w_b8"], m["w_c8"], m["d"])
    out["K4b int8 one 128-frame block"] = (
        lambda: fused_s5.fused_s5_engine_cuda(*argsb, **kwb),
        lambda: fused_s5.fused_s5_engine_plain(*argsb, **kwb))
    return out


#: the cases timed at B = 8 and B = 32
TIMED = ("K2 half1/gelu", "K2 half1/gelu masks", "K4a float relu_state=False",
         "K4a engine int8 bf16 u block 512", "K4b int8 one 128-frame block")


def _flat(res):
    import torch
    if isinstance(res, tuple):
        return [r for part in res for r in _flat(part)]
    return [res] if isinstance(res, torch.Tensor) else []


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_k2_k4a: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparsernns_tpu_torch.ops.cuda import build, fused_s5, layer_tail
    assert os.path.dirname(build.__file__).startswith(root), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_all(["layer_tail", "fused_s5"])
    print(f"tree {root}: build {time.time() - t0:.1f} s", flush=True)
    for name in ("layer_tail", "fused_s5"):
        if name in build.build_logs:
            print(f"--- nvcc {name}\n{build.build_logs[name].strip()}",
                  file=sys.stderr)
    report = {"root": root, "digests": {}, "errors": {}, "ms": {},
              "launched": {}}
    for batch in (8, 32):
        tail, mixer = operands(batch)
        with torch.no_grad():
            for name, (run, plain) in cases(tail, mixer, fused_s5,
                                            layer_tail).items():
                outs = _flat(run())
                torch.cuda.synchronize()
                report["digests"][f"{name} B={batch}"] = "-".join(
                    _digest(o) for o in outs)
                if batch == 8:
                    refs = _flat(plain())
                    report["errors"][name] = max(
                        (o.float() - r.float()).abs().max().item()
                        / max(1.0, r.float().abs().max().item())
                        for o, r in zip(outs, refs))
                if not args.no_time and name in TIMED:
                    report["ms"][f"{name} B={batch}"] = _median_ms(run)
                if hasattr(layer_tail, "launched") and name.startswith(
                        "K2 half1/gelu") and name.endswith("masks"):
                    report["launched"][f"K2 B={batch}"] = \
                        layer_tail.launched()
                if hasattr(fused_s5, "launched") and name == TIMED[2]:
                    report["launched"][f"K4a B={batch}"] = \
                        fused_s5.launched()
                print(f"{name} B={batch}: "
                      f"{report['digests'][f'{name} B={batch}']}"
                      + (f", err {report['errors'][name]:.2e}"
                         if batch == 8 else "")
                      + (f", {report['ms'][f'{name} B={batch}']:.3f} ms"
                         if f"{name} B={batch}" in report["ms"] else ""),
                      flush=True)
        del tail, mixer
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    print(json.dumps({"k2_k4a": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
