"""Phase 30 of ``chip_smoke.py`` alone on the card(s): builds every kernel,
sets up the flagship model and its w8a16 engine as ``chip_smoke.py`` does,
then runs the device-mesh phase (``parallel/``: DP, TP and SP training,
DP, SP, TP and pipeline serving; one rank over NCCL, then two ranks, one a
card over NCCL or sharing one card over gloo) at the flagship width of
``recipes/ndns.json``. A quicker check than the whole ``chip_smoke.py``
after an edit to the parallel paths.

Run from the repository root: ``python3 tools/chip_parallel.py``.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_parallel: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sparsernns_tpu_torch.ops.cuda import build
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.utils.config import RunConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.time()
    build.build_all()
    print(f"build {time.time() - start:.1f} s", flush=True)
    cfg = RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json"))
    model = build_model(cfg, 257, 257, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():   # non-trivial BatchNorm statistics
        for layer in model.encoder.layers:
            h = layer.d_model
            layer.norm.running_mean.copy_(0.1 * torch.randn(h, generator=gen))
            layer.norm.running_var.copy_(0.5 + torch.rand(h, generator=gen))
    noisy = cs._train_batch(cs.B)[0]
    eng = cs.engine_setup(cfg, model, stft_splitter(noisy)[0])
    t0 = time.time()
    cs.parallel_phase(cfg, model, eng, cs.kernel_launches)
    print(f"[parallel phase: {time.time() - t0:.1f} s]", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"chip_parallel OK in {time.time() - start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
