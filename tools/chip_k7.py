"""K7 (the block-sparse matmul) of one tree on one GPU: the SHA-256 of its
output on seeded inputs, its error against the plain version, and medians
of 5 of its times.

The inputs are made here from a seed, at ``chip_smoke.py`` phase 13's
shapes: M = 8 · 3751 = 30008 rows; the encoder 257 -> 192, the GLU gate
192 -> 192 and the decoder 192 -> 257; 90 % and 50 % of the (32, 128)
tiles zero (the encoder at 90 % with both kept tiles in output tile 0, so
output tile 1 holds the pad block); int8, int16 and f32 tiles; f32 and bf16
x. Also the exact-grid case (bf16 integer x, small integer tiles) and the
chunk shape M = 8 · 128 = 1024 of ``process_chunk``. Two trees whose
kernels compute the same values print the same digests; run once on this
tree and once on another (``--root``) on the same card, the script shows
what a redesign moved and times both.

Times (``chip_smoke.py``'s helpers): ``event_ms`` one call between two
CUDA events, median of 5 (host time included); ``device_ms`` 20 calls in
a CUDA graph, events around its replay, over 20, median of 5; ``host_us``
the wrapper's host time a call, ``time.perf_counter`` over 1000 calls
without a sync (at the chunk shape, where the card keeps up);
``library_ms`` ``torch.matmul`` of x with the dequantized dense weight
(TF32 off), median of 5; ``plain_ms`` the plain version once.
``--profile``: the kernel's device time in one call from
``torch.profiler``. ``--engine``: the block-pruned engine (the flagship,
seed 0, masks at the recipe's final 90 % update, calibrated) offline at
B = 8 and by ``process_chunk`` at block 128, warm, medians of 5 of the wall
and one profiled call each (device time, busy share, K7's device time).
``--sweep``: the device time of the int8 rows at every row tile and ring
depth the kernel takes, in place of the plan's choice. The build's SASS
(``cuobjdump -sass``): its kernels and their tensor-core (HMMA)
instructions.
On a tree with :func:`launch_plan`, also the launch record against the
plan, the tiles' planes against ``tile_planes`` and the kernel against its
plain mirror.

Run from the repository root::

    python3 tools/chip_k7.py [--root DIR] [--no-time] [--profile]
        [--engine] [--sweep]

``--root`` imports ``sparsernns_tpu_torch`` from another checkout (its
kernels build under that checkout's ``_build/``). Prints one JSON line
``{"k7": {...}}`` last.
"""

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (_bs_weight, _graph_ms, _host_us,  # noqa: E402
                        _median_ms)
M, M_CHUNK = 8 * 3751, 8 * 128
SHAPES = (("encoder", 257, 192), ("gate", 192, 192), ("decoder", 192, 257))
#: tile dtype -> the dequant scale
TILES = {"int8": 2.0 ** -7, "int16": 2.0 ** -15, "float32": None}


def _digest(t) -> str:
    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _median(times):
    return sorted(times)[len(times) // 2]


def cases():
    """name -> (M, K, N, zero share, tile dtype, x dtype, kept tiles)."""
    out = {}
    for dtype in TILES:
        for name, k, n in SHAPES:
            for zero in (0.9, 0.5):
                kept = ([(0, 0), (8, 0)] if (name, zero) == ("encoder", 0.9)
                        else None)
                for x in ("f32", "bf16"):
                    out[f"{name} {k}->{n} {zero:.0%} {dtype} x {x}"] = (
                        M, k, n, zero, dtype, x, kept)
    for name, k, n in SHAPES:
        out[f"chunk {name} {k}->{n} 90% int8 x f32"] = (
            M_CHUNK, k, n, 0.9, "int8", "f32", None)
    out["chunk encoder 257->192 90% int8 x bf16"] = (
        M_CHUNK, 257, 192, 0.9, "int8", "bf16", None)
    return out


def _timed(key: str, dtype: str, m: int) -> bool:
    """The rows timed: every int8 row, the int16 / f32 encoder rows."""
    return dtype == "int8" or (key.startswith("encoder") and m == M)


def tensor_core_sass(lib: str) -> dict:
    """The library's kernels and how many of their SASS instructions are
    tensor-core products (HMMA), by ``cuobjdump -sass``."""
    from sparsernns_tpu_torch.ops.cuda.build import nvcc_path
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    kernels = sass.count("Function : ")
    with_hmma = sum("HMMA" in part for part in sass.split("Function : ")[1:])
    return {"kernels": kernels, "kernels_with_hmma": with_hmma,
            "hmma": sass.count(" HMMA")}


def sweep(bs, call) -> dict:
    """Device ms of ``call`` at every (row tile, stages) the kernel takes,
    the plan's choice of both overridden."""
    plan, out = bs.launch_plan, {}
    try:
        for bm in bs.ROW_TILES:
            for stages in (2, 3, 4):
                bs.launch_plan = functools.partial(plan, bm=bm,
                                                   stages=stages)
                out[f"bm {bm} stages {stages}"] = _graph_ms(call)
    finally:
        bs.launch_plan = plan
    return out


def engine_times(report) -> None:
    """The block-pruned engine: offline call at B = 8 (K7 x 5) and
    ``process_chunk`` at block 128 (K7 x 5), warm, medians of 5 of the wall
    and one profiled call each."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.train.loop import build_model, create_run_state
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.pruning import masked_state_dict
    from sparsernns_tpu_torch.utils.config import RunConfig
    from sparsernns_tpu_torch.utils.profiling import profile_region
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        RunConfig().with_recipe(os.path.join(HERE, "recipes", "ndns.json")),
        epochs=4, pruning="iterative-ste-block-0.9")
    model = build_model(cfg, 257, 257, training=True, device=dev, seed=0)
    state = create_run_state(cfg, model, steps_per_epoch=2)
    state.pruner.update_masks(model, state.masks,
                              state.pruner.cfg.update_end)

    def audio(n, seconds, seed):
        ds = SyntheticNDNS(size=n, length=seconds * 16000, seed=seed)
        return torch.from_numpy(np.stack([ds[i][0] for i in range(n)])).to(
            dev)

    def feats(a):
        return (stft_splitter(a)[0] - STFT_MAG_MEAN).transpose(1, 2)

    cal_x = feats(audio(8, 4, 7))
    recipe = quantization_recipes[cfg.convert_quantization]
    cal_model = build_model(
        cfg, 257, 257, device=dev, seed=0, scan_mode="sequential",
        q_config=recipe(static_quant=True, calibrating=True))
    frozen = calibrate(cal_model, masked_state_dict(model, state.masks),
                       [cal_x[:4], cal_x[4:]])
    x_eng = feats(audio(8, 30, 0)).contiguous()
    engine = engine_from_frozen(cfg, *frozen, device=dev, block_t=512)
    s_engine = engine_from_frozen(cfg, *frozen, device=dev, block_t=128)
    report["engine"]["dense_blocks"] = engine.dense_blocks
    chunk = x_eng[:, :128].contiguous()
    with torch.no_grad():
        for tag, fn in (("offline B=8", lambda: engine(x_eng)),
                        ("process_chunk B=8 block 128",
                         lambda: s_engine.process_chunk(chunk))):
            for _ in range(3):
                out = fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out = out[0] if isinstance(out, tuple) else out
            prof = profile_region(tag, fn, top=40)
            k7 = [k for k in prof["top_kernels"]
                  if "block_sparse" in k["name"]]
            report["engine"][tag] = dict(
                walls=walls, median=_median(walls),
                device_ms=prof["device_ms"],
                busy=prof["device_busy_share"],
                k7_ms=sum(k["device_ms"] for k in k7),
                k7_launches=sum(k["count"] for k in k7),
                digest=_digest(out))
            print(f"engine {tag}: {report['engine'][tag]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_k7: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparsernns_tpu_torch.ops.cuda import block_sparse as bs
    from sparsernns_tpu_torch.ops.cuda import build
    assert os.path.dirname(build.__file__).startswith(root), build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    lib, = build.build_all(["block_sparse"])
    print(f"tree {root}: build {time.time() - t0:.1f} s", flush=True)
    if "block_sparse" in build.build_logs:
        print(f"--- nvcc block_sparse\n"
              f"{build.build_logs['block_sparse'].strip()}", file=sys.stderr)
    new = hasattr(bs, "launch_plan")
    dev = torch.device("cuda")
    report = {"root": root, "digests": {}, "errors": {}, "mirror": {},
              "launched": {}, "times": {}, "profile": {}, "engine": {},
              "sass": tensor_core_sass(lib)}
    print(f"SASS: {report['sass']}", flush=True)
    gen = torch.Generator().manual_seed(15)
    x32 = {k: torch.randn((M, k), generator=gen).to(dev) for k in (192, 257)}
    with torch.no_grad():
        for i, (key, (m, k, n, zero, dtype, x_name, kept)) in enumerate(
                cases().items()):
            rng = np.random.RandomState(100 + i)
            w = bs.pack_block_sparse(_bs_weight(rng, k, n, zero, kept, dtype),
                                     32, 128, scale=TILES[dtype], device=dev)
            x = x32[k][:m]
            if x_name == "bf16":
                x = x.to(torch.bfloat16)
            out = bs.block_sparse_matmul_cuda(x, w)
            torch.cuda.synchronize()
            ref = bs.block_sparse_matmul_plain(x, w)
            bar = max(1.0, ref.abs().max().item())
            report["digests"][key] = _digest(out)
            report["errors"][key] = (out - ref).abs().max().item() / bar
            line = (f"{key}: nnz {w.nnz}, {report['digests'][key]}, err "
                    f"{report['errors'][key]:.3e} of max(1, |ref|)")
            if new:
                got = bs.launched()
                plan = bs.launch_plan(m, n, x_name == "bf16",
                                      bs.n_planes(x.dtype, w.data.dtype),
                                      torch.cuda.get_device_properties(
                                          0).multi_processor_count)
                want = dict(ctas=plan.ctas, bm=plan.bm, stages=plan.stages,
                            smem=plan.smem)
                assert got == want, (key, got, want)
                report["launched"][key] = got
                mirror = torch.stack(bs.tile_planes(
                    w.data.reshape(-1, 32, 128), x.dtype), dim=1)
                assert torch.equal(w.kernel.planes[x.dtype].view(
                    torch.int16), mirror.view(torch.int16)), key
                mirror = bs.block_sparse_matmul_planes(x, w)
                report["mirror"][key] = (out - mirror).abs().max().item() / bar
                line += (f", mirror {report['mirror'][key]:.3e}, launch "
                         f"{got}")
            if not args.no_time and _timed(key, dtype, m):
                dense = w.dequant()

                def call(x=x, w=w):
                    return bs.block_sparse_matmul_cuda(x, w)
                row = dict(
                    event_ms=_median_ms(call), device_ms=_graph_ms(call),
                    library_ms=_median_ms(
                        lambda x=x, d=dense: torch.matmul(x.float(), d)))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                bs.block_sparse_matmul_plain(x, w)
                torch.cuda.synchronize()
                row["plain_ms"] = (time.perf_counter() - t1) * 1e3
                if m == M_CHUNK:
                    row["host_us"] = _host_us(call)
                if args.profile:
                    from sparsernns_tpu_torch.utils.profiling import \
                        profile_region
                    prof = profile_region(key, call, top=4)
                    row["profile_ms"] = sum(
                        p["device_ms"] for p in prof["top_kernels"]
                        if "block_sparse" in p["name"])
                if args.sweep and new and dtype == "int8":
                    row["sweep"] = sweep(bs, call)
                report["times"][key] = row
                line += f", {row}"
            print(line, flush=True)
        # exact grid: every product and every sum an integer below 2^24
        rng = np.random.RandomState(7)
        xi = torch.randint(-8, 9, (M, 257), generator=gen).to(
            dev, torch.bfloat16)
        qi = np.clip(_bs_weight(rng, 257, 192, 0.5), -3, 3)
        wi = bs.pack_block_sparse(qi, 32, 128, device=dev)
        out = bs.block_sparse_matmul_cuda(xi, wi)
        ref = bs.block_sparse_matmul_plain(xi, wi)
        report["digests"]["exact grid"] = _digest(out)
        report["errors"]["exact grid"] = (out - ref).abs().max().item()
        print(f"exact grid: {report['digests']['exact grid']}, max diff "
              f"{report['errors']['exact grid']}", flush=True)
    if args.engine:
        engine_times(report)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    print(smi, flush=True)
    print(json.dumps({"k7": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
