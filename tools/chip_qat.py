"""K1 qat and K4a qat of one tree on one GPU: the SHA-256 of each kernel's
output on seeded inputs, its error against the plain version, and medians
of 5 call times.

The inputs are made here from a seed (flagship width H = 192, P = 128,
L = 3751, B = 8 and 32; random weights, bits (16, 16) as the w8a16
recipe): K1 qat at t = 1024 forward, reverse and from a carry, at t = 256
and at the largest block the plan takes, with the block requant (with and
without a carry), and an odd width (P = 12, L = 70, t = 32, bits (8, 8));
K4a qat at t = 512 with per-block and global state scales, relu_state off
and on, at t = 256 and the largest block, over int8 weights with per-half
scales and the block requant, and an odd width (H = 20, P = 12, L = 45,
t = 16). Two trees whose kernels compute the same values print the same
digests, so the script, run once on this tree and once on another
(``--root``) on the same card, shows whether a redesign moved any value,
and times both. Cases a tree does not take print "n/a".

On a tree with the tables kernel it also holds the kernel's λ tables
against ``lambda_power_tables`` (bit for bit, or the first differing entry
and its size in ulps), prints each call's launches as the CUDA source
recorded them, and the residency ``cudaOccupancyMaxActiveClusters``
reports; ``--split`` times the calls at 128, 64 and 32 KB of a block a
CTA. ``--steps`` times and profiles the QAT recipe's train step (B = 32)
and eval step (B = 8) of the tree (busy share, device events).

Run from the repository root::

    python3 tools/chip_qat.py [--root DIR] [--no-time] [--split] [--steps]

``--root`` imports ``sparsernns_tpu_torch`` from another checkout (its
kernels build under that checkout's ``_build/``). Prints one JSON line
``{"qat": {...}}`` last.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, P = 3751, 192, 128
BITS = (16, 16)
#: a 16-bit frozen state grid (s_re, s_im, bits)
GRID16 = (2.0 ** -8, 2.0 ** -9, 16)


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
        radius = torch.rand(p, generator=gen) * 0.05 + 0.94
        angle = torch.rand(p, generator=gen) * 6.0 - 3.0
        return ((radius * torch.cos(angle)).to(dev),
                (radius * torch.sin(angle)).to(dev))

    bu = rnd(batch, L, 2 * P)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen,  # noqa
                                  dtype=torch.int8).to(dev)
    op = dict(lam=lam_of(P), bu=(bu[..., :P], bu[..., P:]),
              carry=(rnd(batch, P), rnd(batch, P)), u=rnd(batch, L, H),
              w_b=rnd(H, 2 * P, sc=H ** -0.5),
              w_c=rnd(2 * P, H, sc=(2 * P) ** -0.5), d=rnd(H),
              w_b8=i8(H, 2 * P), w_c8=i8(2 * P, H),
              amax=torch.full((), 60.0, device=dev))
    op["odd_lam"] = lam_of(12)
    op["odd_bu"] = (rnd(2, 70, 12), rnd(2, 70, 12))
    op["odd_mix"] = (rnd(2, 45, 20), op["odd_lam"], rnd(20, 24, sc=0.3),
                     rnd(24, 20, sc=0.3), rnd(20))
    return op


def cases(op, qat_scan, fused_s5, t_max):
    """name -> (a call on the card, the plain version's call)."""
    out = {}
    k1 = (op["lam"], op["bu"], BITS)
    for name, t, kw in (
            ("K1 qat t=1024 forward", 1024, {}),
            ("K1 qat t=1024 reverse", 1024, dict(reverse=True)),
            ("K1 qat t=1024 carry", 1024, dict(carry_init=op["carry"])),
            ("K1 qat t=256 forward", 256, {}),
            (f"K1 qat t={t_max} forward", t_max, {}),
            ("K1 qat t=1024 requant", 1024, dict(block_requant=GRID16)),
            ("K1 qat t=1024 requant carry", 1024,
             dict(block_requant=GRID16, carry_init=op["carry"]))):
        out[name] = (lambda t=t, kw=kw: qat_scan.qat_scan_cuda(*k1, t, **kw),
                     lambda t=t, kw=kw: qat_scan.qat_scan_plain(*k1, t,
                                                                **kw))
    for rev in (False, True):
        args = (op["odd_lam"], op["odd_bu"], (8, 8), 32)
        out[f"K1 qat P=12 L=70 t=32 reverse={rev}"] = (
            lambda a=args, r=rev: qat_scan.qat_scan_cuda(*a, reverse=r),
            lambda a=args, r=rev: qat_scan.qat_scan_plain(*a, reverse=r))
    mix = (op["u"], op["lam"], op["w_b"], op["w_c"], op["d"], BITS)
    for name, t, relu, scale, kw in (
            ("K4a qat t=512 per-block", 512, False, None, {}),
            ("K4a qat t=512 per-block relu", 512, True, None, {}),
            ("K4a qat t=512 global", 512, False, op["amax"], {}),
            ("K4a qat t=512 global relu", 512, True, op["amax"], {}),
            ("K4a qat t=256 per-block", 256, False, None, {}),
            (f"K4a qat t={t_max} per-block", t_max, False, None, {})):
        out[name] = (
            lambda t=t, r=relu, s=scale: fused_s5.fused_s5_qat_cuda(
                *mix, t, r, s),
            lambda t=t, r=relu, s=scale: fused_s5.fused_s5_qat_plain(
                *mix, t, r, s))
    i8 = (op["u"], op["lam"], op["w_b8"], op["w_c8"], op["d"], BITS, 512,
          True)
    kw8 = dict(wb_scales=(2.0 ** -10, 2.0 ** -11),
               wc_scales=(2.0 ** -10, 2.0 ** -11), block_requant=GRID16)
    out["K4a qat t=512 int8 scales requant relu"] = (
        lambda: fused_s5.fused_s5_qat_cuda(*i8, **kw8),
        lambda: fused_s5.fused_s5_qat_plain(*i8, **kw8))
    odd = (*op["odd_mix"], (8, 8), 16, True)
    out["K4a qat H=20 P=12 L=45 t=16 relu"] = (
        lambda: fused_s5.fused_s5_qat_cuda(*odd),
        lambda: fused_s5.fused_s5_qat_plain(*odd))
    return out


#: the cases timed (at B = 8; the K4a ones also at B = 32)
TIMED = ("K1 qat t=1024 forward", "K1 qat t=1024 reverse",
         "K4a qat t=512 per-block", "K4a qat t=512 global")


def _flat(res):
    import torch
    if isinstance(res, tuple):
        return [r for part in res for r in _flat(part)]
    return [res] if isinstance(res, torch.Tensor) else []


def _ulps(a: float, b: float) -> int:
    import numpy as np
    ia = np.array([a], np.float32).view(np.int32)[0]
    ib = np.array([b], np.float32).view(np.int32)[0]
    return int(abs(int(ia) - int(ib)))


def check_tables(op, qat_scan, report) -> None:
    """The tables kernel against ``lambda_power_tables`` at the blocks the
    main path uses: equal, or the first differing entry."""
    names = ("pow_re", "pow_im", "ctab_re", "ctab_im")
    for t in (256, 512, 1024):
        n_pass = max(1, (t - 1).bit_length())
        for a_bits in (16, 8, None):
            got = qat_scan.tables_cuda(op["lam"], t, n_pass, a_bits)
            ref = qat_scan.lambda_power_tables(op["lam"], t, n_pass, a_bits)
            tag = f"tables t={t} a_bits={a_bits}"
            first = None
            for name, g, r in zip(names, got, ref):
                diff = (g != r).nonzero()
                if len(diff) and first is None:
                    idx = tuple(diff[0].tolist())
                    first = (f"{name}{list(idx)}: kernel {g[idx].item()!r} "
                             f"vs torch {r[idx].item()!r} "
                             f"({_ulps(g[idx].item(), r[idx].item())} ulps; "
                             f"{len(diff)} of {g.numel()} entries differ)")
            report["tables"][tag] = first or "equal"
            print(f"{tag}: {report['tables'][tag]}", flush=True)


def _profile(fn) -> dict:
    """One call of ``fn`` under the profiler: wall and device time, the
    device's busy share and the number of device events (kernels, copies),
    a one-element fill opening the window (the profiler on the card drops
    the first kernel of a window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: float(getattr(e, "self_device_time_total", 0.0)  # noqa
                             or getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in events if dev_us(e) > 0]
    device = sum(dev_us(e) for e in events) / 1e3
    return dict(wall_ms=wall, device_ms=device, busy=device / wall,
                events=sum(e.count for e in events))


def qat_steps(root: str, report) -> None:
    """The QAT recipe (``recipes/ndns.json`` with ``quantization="w8a16"``,
    ``block_t=512``): three B = 32 train steps after two warm-up steps,
    one more profiled, and the eval step at B = 8, three timed and one
    profiled."""
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
    cfg = RunConfig().with_recipe(os.path.join(root, "recipes",
                                               "ndns.json"))
    cfg = dataclasses.replace(cfg, quantization="w8a16", block_t=512)
    ds = SyntheticNDNS(size=cfg.bsz, length=30 * 16000, seed=0)
    pairs = [ds[i] for i in range(cfg.bsz)]
    noisy = torch.from_numpy(np.stack([a for a, _ in pairs])).cuda()
    clean = torch.from_numpy(np.stack([c for _, c in pairs])).cuda()
    feats = (*prep_ndns_batch(noisy, clean), clean)
    model = build_model(cfg, 257, 257, training=True, device="cuda", seed=0)
    state = create_run_state(cfg, model, steps_per_epoch=2)
    step = make_ndns_train_step(model)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    walls = []
    for i in range(5):
        (state, _), wall = timed(lambda: step(state, *feats))
        if i >= 2:
            walls.append(wall)
    holder = {}
    prof = _profile(lambda: holder.setdefault("out", step(state, *feats)))
    report["steps"][f"train B={cfg.bsz}"] = dict(walls=walls, **prof)
    small = tuple(t[:8].contiguous() for t in feats)
    eval_step = make_ndns_eval_step(model)
    eval_step(*small)
    walls = [timed(lambda: eval_step(*small))[1] for _ in range(3)]
    prof = _profile(lambda: eval_step(*small))
    report["steps"]["eval B=8"] = dict(walls=walls, **prof)
    for name, rec in report["steps"].items():
        print(f"QAT {name} step: " + ", ".join(
            f"{w:.2f}" for w in rec["walls"]) + f" ms; profiled wall "
              f"{rec['wall_ms']:.2f} ms, device {rec['device_ms']:.2f} ms, "
              f"busy {rec['busy']:.3f}, {rec['events']} device events",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_qat: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparsernns_tpu_torch.ops.cuda import build, fused_s5, qat_scan
    assert os.path.dirname(build.__file__).startswith(root), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_all(["qat_scan"])
    print(f"tree {root}: build {time.time() - t0:.1f} s", flush=True)
    if "qat_scan" in build.build_logs:
        print(f"--- nvcc qat_scan\n{build.build_logs['qat_scan'].strip()}",
              file=sys.stderr)
    new = hasattr(qat_scan, "qat_plan")
    # the largest block the plan takes at P = 128 (3592), on either tree
    t_max = qat_scan.max_block(P) if new else 3592
    report = {"root": root, "digests": {}, "errors": {}, "exact": {},
              "ms": {}, "launched": {}, "tables": {}, "residency": {},
              "steps": {}}
    for batch in (8, 32):
        op = operands(batch)
        with torch.no_grad():
            if new and batch == 8:
                check_tables(op, qat_scan, report)
            for name, (run, plain) in cases(op, qat_scan, fused_s5,
                                            t_max).items():
                if batch == 32 and not name.startswith("K4a qat t=512"):
                    continue
                try:
                    outs = _flat(run())
                except TypeError:   # a mode this tree does not take
                    report["digests"][f"{name} B={batch}"] = "n/a"
                    print(f"{name} B={batch}: n/a", flush=True)
                    continue
                torch.cuda.synchronize()
                key = f"{name} B={batch}"
                report["digests"][key] = "-".join(_digest(o) for o in outs)
                if new:
                    report["launched"][key] = qat_scan.launched()
                if batch == 8:
                    refs = _flat(plain())
                    report["errors"][name] = max(
                        (o - r).abs().max().item()
                        / max(1.0, r.abs().max().item())
                        for o, r in zip(outs, refs))
                    report["exact"][name] = all(torch.equal(o, r)
                                                for o, r in zip(outs, refs))
                if not args.no_time and (name in TIMED and (
                        batch == 8 or name.startswith("K4a"))):
                    report["ms"][key] = _median_ms(run)
                print(f"{key}: {report['digests'][key]}"
                      + (f", err {report['errors'][name]:.2e}, equal to "
                         f"plain {report['exact'][name]}"
                         if batch == 8 else "")
                      + (f", {report['ms'][key]:.3f} ms"
                         if key in report["ms"] else "")
                      + (f", launches {report['launched'][key]}"
                         if key in report["launched"] else ""),
                      flush=True)
            if new and batch == 8:
                for t in (256, 512, 1024, t_max):
                    plan = qat_scan.qat_plan(batch, L, P, t)
                    report["residency"][f"t={t}"] = dict(
                        cluster=plan.cluster, cpc=plan.cpc,
                        smem=plan.smem, ctas=plan.ctas,
                        max_active_clusters=qat_scan.max_active_clusters(
                            plan))
                print(f"residency: {report['residency']}", flush=True)
            if new and args.split and not args.no_time and batch == 8:
                keep = qat_scan.CTA_BYTES
                for split in (128 * 1024, 64 * 1024, 32 * 1024):
                    qat_scan.CTA_BYTES = split
                    for name in TIMED:
                        run = cases(op, qat_scan, fused_s5, t_max)[name][0]
                        key = f"{name} B={batch} split {split // 1024} KB"
                        report["ms"][key] = _median_ms(run)
                        print(f"{key}: {report['ms'][key]:.3f} ms",
                              flush=True)
                qat_scan.CTA_BYTES = keep
        del op
        torch.cuda.empty_cache()
    if args.steps:
        qat_steps(root, report)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    print(json.dumps({"qat": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
