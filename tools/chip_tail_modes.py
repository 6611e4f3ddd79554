"""The whole-layer tail kernels alone on one GPU: builds every kernel, then
runs ``chip_smoke.py``'s phase 7 (K2 with masks, K3a, K3b in the affine
f32 mode), phase 19 (the non-affine mode and bf16 streams against their
plain versions, timed), phase 20 (LayerNorm training beside the mixer
route) and phase 21 (bf16 against f32 streams) at the flagship width of
``recipes/ndns.json``. A quicker check than the whole ``chip_smoke.py``
after an edit to ``csrc/layer_tail*``.

Run from the repository root: ``python3 tools/chip_tail_modes.py``.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_tail_modes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sparsernns_tpu_torch.ops.cuda import build
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.utils.config import RunConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.build_all()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        if name.startswith("layer_tail"):
            print(f"--- nvcc {name}\n{log.strip()}", flush=True)
    cfg = RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json"))
    model = build_model(cfg, 257, 257, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():   # non-trivial BatchNorm statistics
        for layer in model.encoder.layers:
            h = layer.d_model
            layer.norm.running_mean.copy_(0.1 * torch.randn(h, generator=gen))
            layer.norm.running_var.copy_(0.5 + torch.rand(h, generator=gen))
    layer0 = model.encoder.layers[0]
    frames = cs.SECONDS * 16000 // 128 + 1
    records = {}
    marks = [time.time()]

    def mark(name):
        marks.append(time.time())
        print(f"[{name}: {marks[-1] - marks[-2]:.1f} s]", flush=True)

    cs.training_kernel_phase(layer0, cfg, frames, gen, records)
    mark("phase 7")
    cs.tail_modes_kernel_phase(layer0, cfg, frames, gen, records)
    mark("phase 19")
    batch = cs._train_batch(cfg.bsz)
    cs.layernorm_training_phase(cfg, records, cs.kernel_launches, batch)
    mark("phase 20")
    cs.bf16_training_phase(cfg, records, cs.kernel_launches, batch)
    mark("phase 21")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    print(json.dumps({k: {kk: r.get(kk) for kk in keys}
                      for k, r in records.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
