"""K1 (the diagonal scan, float modes) of one tree on one GPU: the SHA-256
of its output on seeded inputs, its error against the sequential plain
version, and medians of 5 call times.

The inputs are made here from a seed (P = 128, L = 3751, B = 8 and 32;
|λ| 0.9 to 0.999; a 16-bit state grid (2^-8, 2^-9) at block 512): K1
forward, from a carry, reverse, with the block requant (no carry, from a
carry on the grid, reverse, and at block 100, no multiple of the chunk),
a 1 s streaming chunk (L = 125 from a carry), an odd width (P = 12,
L = 70) both ways, and K1 qat reverse with the block requant (t = 1024,
bits (16, 16)). Two trees whose kernels compute the same values print the
same digests; the script, run once on this tree and once on another
(``--root``) on the same card, shows which values a redesign moved and
times both. Cases a tree does not take print "n/a".

Besides, on both trees: the relu decisions of K4a's forward states
against K1's recompute of them (the backward of ``FusedS5Fn`` under
``relu_state``; H = 256 with W_c the identity and d = 0, so that K4a's
output is its relu'd states), and of K1's states against the sequential
recurrence's, counted where they differ. On a tree with the chunked
kernel also: the kernel against its plan's plain mirror (bit for bit),
the launch record against the plan, ``--chunks`` times the calls at
fixed chunk lengths, ``--profile`` the device time of each pass.
``--steps`` times warm steps of the paths K1 runs on (:func:`k1_steps`).
``--pathx`` times K1 at Path-X's scan shape with the launch options of
the bidirectional mixer's buffers and the mixer's scans both ways, forward
and backward, on each route (:func:`pathx_scans`).

Run from the repository root::

    python3 tools/chip_k1.py [--root DIR] [--no-time] [--chunks 16,32,64]
        [--profile] [--steps] [--pathx]

``--root`` imports ``sparsernns_tpu_torch`` from another checkout (its
kernels build under that checkout's ``_build/``). Prints one JSON line
``{"k1": {...}}`` last.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, P, BLOCK = 3751, 128, 512
#: a 16-bit frozen state grid (s_re, s_im, bits)
GRID16 = (2.0 ** -8, 2.0 ** -9, 16)
#: a 16-bit grid for the flagship layer's states (their range about 1 at
#: unit input, so 2^-15 a code)
MODEL_GRID = (2.0 ** -15, 2.0 ** -16, 16)
#: the cases timed at B = 8 and 32
TIMED = ("forward", "carry", "reverse", "requant", "requant reverse",
         "requant model layer")


def _digest(t) -> str:
    t = t.detach().contiguous().cpu()
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

    def lam_of(p):
        radius = torch.rand(p, generator=gen) * 0.099 + 0.9
        angle = torch.rand(p, generator=gen) * 6.0 - 3.0
        return ((radius * torch.cos(angle)).to(dev),
                (radius * torch.sin(angle)).to(dev))

    bu = rnd(batch, L, 2 * P)
    carry = (rnd(batch, P), rnd(batch, P))
    # a layer of the flagship's mixer (seed 0) over a random input: its λ,
    # and a 16-bit grid on its states' range, as calibration sets one
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.utils.config import RunConfig
    cfg = RunConfig().with_recipe(os.path.join(HERE, "recipes", "ndns.json"))
    mixer = build_model(cfg, 257, 257, device=dev, seed=0
                        ).encoder.layers[1].mixer
    with torch.no_grad():
        m_lam, m_wb = mixer.layer_tail_operands()[:2]
        m_lam = tuple(x.contiguous() for x in m_lam)
        gm = torch.Generator().manual_seed(seed + 1)
        m_u = torch.randn((batch, L, cfg.d_model), generator=gm).to(dev)
        m_bu = m_u @ m_wb
    m_bu = (m_bu[..., :P], m_bu[..., P:])
    grid_carry = tuple(torch.round(c * 200.0) * s
                       for c, s in zip(carry, GRID16[:2]))
    return dict(lam=lam_of(P), bu=(bu[..., :P], bu[..., P:]), carry=carry,
                model_lam=m_lam, model_bu=m_bu,
                grid_carry=grid_carry, odd_lam=lam_of(12),
                odd_bu=(rnd(2, 70, 12), rnd(2, 70, 12)),
                u=rnd(batch, 1000, 2 * P),
                w_b=rnd(2 * P, 2 * P, sc=(2 * P) ** -0.5))


def cases(op):
    """name -> (args, kwargs) of a ``diag_scan_cuda`` call."""
    k1 = (op["lam"], op["bu"])
    stream = (op["lam"], tuple(x[:, :125] for x in op["bu"]))
    odd = (op["odd_lam"], op["odd_bu"])
    return {
        "forward": (k1, {}),
        "carry": (k1, dict(carry_init=op["carry"])),
        "reverse": (k1, dict(reverse=True)),
        "requant": (k1, dict(block_requant=GRID16, block_t=BLOCK)),
        "requant carry": (k1, dict(carry_init=op["grid_carry"],
                                   block_requant=GRID16, block_t=BLOCK)),
        "requant reverse": (k1, dict(reverse=True, block_requant=GRID16,
                                     block_t=BLOCK)),
        "requant block 100": (k1, dict(block_requant=GRID16, block_t=100)),
        "requant model layer": ((op["model_lam"], op["model_bu"]),
                                dict(block_requant=MODEL_GRID,
                                     block_t=BLOCK)),
        "requant model layer reverse": (
            (op["model_lam"], op["model_bu"]),
            dict(reverse=True, block_requant=MODEL_GRID, block_t=BLOCK)),
        "carry L=125": (stream, dict(carry_init=op["carry"])),
        "P=12 L=70 forward": (odd, {}),
        "P=12 L=70 reverse": (odd, dict(reverse=True)),
    }


def _compare(out, ref, kw) -> dict:
    """Against the sequential recurrence: the float error over max|x|, or
    the requant's code differences."""
    if "block_requant" not in kw:
        scale = max(r.abs().max().item() for r in ref)
        return {"err_rel": max((o - r).abs().max().item()
                               for o, r in zip(out, ref)) / scale}
    diff = [(o / s - r / s).round().abs()
            for o, r, s in zip(out, ref, kw["block_requant"][:2])]
    return {"code_max": max(d.max().item() for d in diff),
            "code_share": max((d > 0).float().mean().item() for d in diff)}


def relu_flips(op, diag_scan, fused_s5) -> dict:
    """Relu decisions that differ: K4a's forward states (its output with
    W_c the identity, d = 0) against K1's recompute on u @ W_b, and K1's
    against the sequential recurrence's."""
    import torch
    u, w_b, lam = op["u"], op["w_b"], op["lam"]
    h = u.shape[-1]
    eye = torch.eye(h, device=u.device)
    zero = torch.zeros(h, device=u.device)
    y = fused_s5.fused_s5_cuda(u, lam, w_b, eye, zero, relu_state=True)
    bu = u @ w_b
    halves = (bu[..., :P], bu[..., P:])
    k1 = torch.cat(diag_scan.diag_scan_cuda(lam, halves), dim=-1)
    seq = torch.cat(diag_scan.diag_scan_plain(lam, halves), dim=-1)
    return {"elements": k1.numel(),
            "k4a_vs_k1": int(((y > 0) != (k1 > 0)).sum().item()),
            "k1_vs_sequential": int(((k1 > 0) != (seq > 0)).sum().item())}


def _profile(fn) -> dict:
    """Device ms of each kernel of one call (``torch.profiler``)."""
    from sparsernns_tpu_torch.utils.profiling import profile_region
    prof = profile_region("one call", fn, top=8)
    return {k["name"]: k["device_ms"] for k in prof["top_kernels"]
            if "Fill" not in k["name"]}


def k1_steps(report) -> None:
    """Warm steps of the paths K1 runs on, medians of 5 (host clock ended
    by a synchronize) and one profiled step each (device time, busy share,
    K1's kernels' device time and launches): the bidirectional train
    step (K1 6 each way) at B = 8 and 32, the postnorm train step (K1 3
    each way) at B = 32, the top-k float eval step (K1 3) at B = 8."""
    import dataclasses

    import numpy as np
    import torch

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.train.loop import (build_model,
                                                 create_run_state,
                                                 prep_ndns_batch)
    from sparsernns_tpu_torch.train.steps import (make_ndns_eval_step,
                                                  make_ndns_train_step)
    from sparsernns_tpu_torch.utils.config import RunConfig
    from sparsernns_tpu_torch.utils.profiling import profile_region
    base = RunConfig().with_recipe(os.path.join(HERE, "recipes",
                                                "ndns.json"))

    def feats(bsz):
        ds = SyntheticNDNS(size=bsz, length=30 * 16000, seed=0)
        pairs = [ds[i] for i in range(bsz)]
        noisy = torch.from_numpy(np.stack([a for a, _ in pairs])).cuda()
        clean = torch.from_numpy(np.stack([c for _, c in pairs])).cuda()
        return (*prep_ndns_batch(noisy, clean), clean)

    def timed(tag, fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = profile_region(tag, fn, top=400)
        k1 = [k for k in prof["top_kernels"]
              if "k1_" in k["name"] or "diag_scan" in k["name"]]
        report["steps"][tag] = dict(
            walls=walls, median=sorted(walls)[2], device_ms=prof["device_ms"],
            busy=prof["device_busy_share"], events=prof["device_events"],
            k1_ms=sum(k["device_ms"] for k in k1),
            k1_launches=sum(k["count"] for k in k1))
        print(f"{tag}: {report['steps'][tag]}", flush=True)

    for tag, kw, bsz in (("bidirectional train", {"bidirectional": True}, 8),
                         ("bidirectional train", {"bidirectional": True}, 32),
                         ("postnorm train", {"prenorm": False}, 32)):
        cfg = dataclasses.replace(base, **kw)
        model = build_model(cfg, 257, 257, training=True, device="cuda",
                            seed=0)
        box = [create_run_state(cfg, model, steps_per_epoch=2)]
        step, batch = make_ndns_train_step(model), feats(bsz)

        def one():
            box[0], _ = step(box[0], *batch)
        timed(f"{tag} B={bsz}", one)
        del model, box, step, batch
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, topk=0.5, approx_topk=True)
    model = build_model(cfg, 257, 257, device="cuda", seed=0)
    step, batch = make_ndns_eval_step(model), feats(8)
    timed("top-k float eval B=8", lambda: step(*batch))


def pathx_scans(report) -> None:
    """K1 at Path-X's scan shape (B 32, L 16 384, P 128), medians of 5
    (CUDA events) and each kernel's device ms of one profiled call: a plain
    call; with the buffers' options (``out`` into the columns of a 4P
    matrix; the adjoint walk into a 2P buffer with dλ; the second adjoint
    adding to it with dλ); and a bidirectional mixer's two scans forward
    and backward on the buffers route (``BiDiagScanFn``) and on the two
    ``DiagScanFn`` with the concatenations. A tree without the options
    prints "n/a" for them."""
    import torch

    from sparsernns_tpu_torch.ops import scan as tscan
    from sparsernns_tpu_torch.ops.cuda import diag_scan
    from sparsernns_tpu_torch.utils.profiling import profile_region
    b, length, p = 32, 16384, 128
    gen = torch.Generator().manual_seed(5)
    radius = torch.rand(p, generator=gen) * 0.099 + 0.9
    angle = torch.rand(p, generator=gen) * 6.0 - 3.0
    lam = ((radius * torch.cos(angle)).cuda(),
           (radius * torch.sin(angle)).cuda())
    cat = torch.randn((b, length, 2 * p), generator=gen).cuda()
    cot = torch.randn((b, length, 4 * p), generator=gen).cuda()
    bu = (cat[..., :p], cat[..., p:])
    buf = torch.empty((b, length, 4 * p), device="cuda")
    acc = torch.empty((b, length, 2 * p), device="cuda")
    fwd = (buf[..., :p], buf[..., 2 * p:3 * p])
    v = (acc[..., :p], acc[..., p:])
    g_fwd = (cot[..., :p], cot[..., 2 * p:3 * p])
    calls = {
        "plain forward": lambda: diag_scan.diag_scan_cuda(lam, bu),
        "plain reverse": lambda: diag_scan.diag_scan_cuda(lam, bu,
                                                          reverse=True),
    }
    # a tree without the buffers' options (the parent) prints "n/a"
    options = hasattr(diag_scan, "diag_scan_adjoint_cuda")
    if options:
        calls.update({
            "forward into 4P": lambda: diag_scan.diag_scan_cuda(lam, bu,
                                                                out=fwd),
            "adjoint + dlam": lambda: diag_scan.diag_scan_adjoint_cuda(
                lam, g_fwd, fwd, out=v),
            "adjoint + accumulate + dlam":
                lambda: diag_scan.diag_scan_adjoint_cuda(
                    lam, g_fwd, fwd, out=v, accumulate=True),
        })

    def unfused(lr, li, x):
        f = tscan.DiagScanFn.apply(lr, li, x[..., :p], x[..., p:], False)
        r = tscan.DiagScanFn.apply(lr, li, x[..., :p], x[..., p:], True)
        return torch.cat([torch.cat([f[0], r[0]], dim=-1),
                          torch.cat([f[1], r[1]], dim=-1)], dim=-1)

    def mixer_scans(fn):
        leaves = [lam[0].clone().requires_grad_(True),
                  lam[1].clone().requires_grad_(True),
                  cat.clone().requires_grad_(True)]
        return lambda: fn(*leaves).backward(cot)

    calls["bidirectional scans fwd+bwd, unfused"] = mixer_scans(unfused)
    if options:
        calls["bidirectional scans fwd+bwd, buffers"] = mixer_scans(
            tscan.BiDiagScanFn.apply)
    report["pathx"] = {}
    for name in ("forward into 4P", "adjoint + dlam",
                 "adjoint + accumulate + dlam",
                 "bidirectional scans fwd+bwd, buffers"):
        if name not in calls:
            report["pathx"][name] = "n/a"
            print(f"pathx {name}: n/a", flush=True)
    for name, fn in calls.items():
        ms = _median_ms(fn)
        prof = profile_region(name, fn, top=12)
        kernels = {k["name"]: k["device_ms"] for k in prof["top_kernels"]}
        report["pathx"][name] = {"ms": ms, "device_ms": prof["device_ms"],
                                 "kernels": kernels}
        print(f"pathx {name}: {ms:.4f} ms, device {prof['device_ms']:.4f} "
              f"ms, kernels {kernels}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--chunks", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--pathx", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_k1: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparsernns_tpu_torch.ops.cuda import build, diag_scan, fused_s5
    from sparsernns_tpu_torch.ops.cuda import qat_scan
    assert os.path.dirname(build.__file__).startswith(root), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_all(["diag_scan", "fused_s5", "qat_scan"])
    print(f"tree {root}: build {time.time() - t0:.1f} s", flush=True)
    if "diag_scan" in build.build_logs:
        print(f"--- nvcc diag_scan\n{build.build_logs['diag_scan'].strip()}",
              file=sys.stderr)
    new = hasattr(diag_scan, "scan_plan")
    report = {"root": root, "digests": {}, "errors": {}, "mirror": {},
              "ms": {}, "launched": {}, "flips": {}, "profile": {},
              "rewalks": {}, "steps": {}}
    for batch in (8, 32):
        op = operands(batch)
        with torch.no_grad():
            for name, (a, kw) in cases(op).items():
                key = f"{name} B={batch}"
                if batch == 32 and name not in TIMED:
                    continue
                try:
                    out = diag_scan.diag_scan_cuda(*a, **kw)
                except NotImplementedError:   # a mode this tree refuses
                    report["digests"][key] = "n/a"
                    print(f"{key}: n/a", flush=True)
                    continue
                torch.cuda.synchronize()
                report["digests"][key] = "-".join(_digest(o) for o in out)
                if new:
                    report["launched"][key] = diag_scan.launched()
                    b, length, p = a[1][0].shape
                    plan = diag_scan.scan_plan(
                        b, length, p, kw.get("block_t") if "block_requant"
                        in kw else None, kw.get("reverse", False))
                    assert report["launched"][key] == plan.launches(), (
                        key, report["launched"][key], plan.launches())
                    mirror = diag_scan.diag_scan_chunked_plain(*a, **kw)
                    report["mirror"][key] = all(
                        torch.equal(o, m) for o, m in zip(out, mirror))
                    if "block_requant" in kw and batch == 8:
                        again = diag_scan.block_rewalks(*a, **kw)
                        report["rewalks"][key] = [
                            int(again.sum().item()), again.numel(),
                            int(again.sum(dim=1).max().item())]
                ref = diag_scan.diag_scan_plain(*a, **kw)
                report["errors"][key] = _compare(out, ref, kw)
                if not args.no_time and name in TIMED:
                    report["ms"][key] = _median_ms(
                        lambda a=a, kw=kw: diag_scan.diag_scan_cuda(*a,
                                                                    **kw))
                print(f"{key}: {report['digests'][key]}, "
                      f"{report['errors'][key]}"
                      + (f", mirror equal {report['mirror'][key]}"
                         if key in report["mirror"] else "")
                      + (f", {report['ms'][key]:.4f} ms"
                         if key in report["ms"] else "")
                      + (f", launches {report['launched'][key]}"
                         if key in report["launched"] else "")
                      + (f", block pass walks again (warps, of, most in a "
                         f"row) {report['rewalks'][key]}"
                         if key in report["rewalks"] else ""),
                      flush=True)
            key = f"qat requant reverse t=1024 B={batch}"
            if batch == 8:
                qa = (op["lam"], op["bu"], (16, 16), 1024)
                try:
                    out = qat_scan.qat_scan_cuda(*qa, reverse=True,
                                                 block_requant=GRID16)
                except NotImplementedError:
                    report["digests"][key] = "n/a"
                else:
                    ref = qat_scan.qat_scan_plain(*qa, reverse=True,
                                                  block_requant=GRID16)
                    report["digests"][key] = "-".join(_digest(o)
                                                      for o in out)
                    report["errors"][key] = _compare(
                        out, ref, {"block_requant": GRID16})
                    report["mirror"][key] = all(
                        torch.equal(o, r) for o, r in zip(out, ref))
                print(f"{key}: {report['digests'][key]}, "
                      f"{report['errors'].get(key)}, equal to plain "
                      f"{report['mirror'].get(key)}", flush=True)
                report["flips"] = relu_flips(op, diag_scan, fused_s5)
                print(f"relu flips (B=8, L=1000, H=256): {report['flips']}",
                      flush=True)
            if new and args.profile:
                for name in ("forward", "requant", "requant model layer"):
                    a, kw = cases(op)[name]
                    prof = _profile(lambda a=a, kw=kw:
                                    diag_scan.diag_scan_cuda(*a, **kw))
                    report["profile"][f"{name} B={batch}"] = prof
                    print(f"{name} B={batch} device ms: {prof}", flush=True)
            if new and args.chunks and not args.no_time:
                keep = (diag_scan.MIN_CHUNK, diag_scan.MAX_CHUNK)
                for chunk in (int(c) for c in args.chunks.split(",")):
                    diag_scan.MIN_CHUNK = diag_scan.MAX_CHUNK = chunk
                    diag_scan.scan_plan.cache_clear()
                    for name in ("forward", "reverse", "requant"):
                        a, kw = cases(op)[name]
                        key = f"{name} B={batch} chunk {chunk}"
                        report["ms"][key] = _median_ms(
                            lambda a=a, kw=kw: diag_scan.diag_scan_cuda(
                                *a, **kw))
                        print(f"{key}: {report['ms'][key]:.4f} ms",
                              flush=True)
                diag_scan.MIN_CHUNK, diag_scan.MAX_CHUNK = keep
                diag_scan.scan_plan.cache_clear()
        del op
        torch.cuda.empty_cache()
    if args.steps:
        k1_steps(report)
    if args.pathx:
        pathx_scans(report)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    print(smi, flush=True)
    print(json.dumps({"k1": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
