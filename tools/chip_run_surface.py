"""The run-surface phases of ``chip_smoke.py`` alone on one GPU: builds
every kernel, sets up the flagship model, its B = 32 training batch and
the w8a16 engine as ``chip_smoke.py`` does, then runs phases 24-29 (the
classification and retrieval heads, BatchNorm folding,
``scan_mode="blocked"``, the engine's ``route="xla"``, truncated
backpropagation through time and the WAV corpus) at the flagship width of
``recipes/ndns.json``. A quicker check than the whole ``chip_smoke.py``
after an edit to those paths.

Run from the repository root: ``python3 tools/chip_run_surface.py
[phase ...]``, the phases named by ``classification``, ``bn_fusion``,
``blocked``, ``xla``, ``tbptt``, ``wav`` (default: all six, in that
order).
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
        print("chip_run_surface: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sparsernns_tpu_torch.ops.cuda import build
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
    batch = cs._train_batch(cfg.bsz)
    eng = cs.engine_setup(cfg, model, batch[2][0][:cs.B])
    marks = [time.time()]

    def mark(name):
        marks.append(time.time())
        print(f"[{name}: {marks[-1] - marks[-2]:.1f} s]", flush=True)

    counters = cs.kernel_launches
    phases = {
        "classification": lambda: cs.classification_phase(cfg, ROOT, {},
                                                          counters),
        "bn_fusion": lambda: cs.bn_fusion_phase(cfg, batch, counters),
        "blocked": lambda: cs.blocked_phase(cfg, model, batch, counters),
        "xla": lambda: cs.xla_route_phase(cfg, eng, counters),
        "tbptt": lambda: cs.tbptt_phase(cfg, batch[2], counters),
        "wav": lambda: cs.wav_corpus_phase(cfg, counters)}
    for name in sys.argv[1:] or list(phases):
        phases[name]()
        mark(f"{name} phase")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"chip_run_surface OK in {time.time() - start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
