"""The serving-engine kernels alone on one GPU: builds every kernel, then
runs ``chip_smoke.py``'s phase 4 (K6, K5a, K5b against their plain
versions at B = 8 and 32, ragged, every variant; the passes as the CUDA
source recorded them), phase 5 (the engine offline call, its mask digest,
times and peak memory, the stack route), phase 6 (streaming from the
engine), phase 17 (the integer-dot modes against plain, timed) and phase
18 (the integer-dot engines served) at the flagship width of
``recipes/ndns.json``, on the inputs ``chip_smoke.py`` gives them. A
quicker check than the whole ``chip_smoke.py`` after an edit to
``csrc/engine_*``.

Run from the repository root: ``python3 tools/chip_engine.py``.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_engine: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.ops.cuda import (build, engine_layer,
                                               engine_network, fused_s5)
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

    def counters():
        counts = {"fused_s5_engine": fused_s5.launches_engine,
                  "engine_layer": engine_layer.launches,
                  "engine_layer_carry": engine_layer.launches_carry,
                  "engine_network": engine_network.launches}
        cs._reset_counts()
        return counts

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
                            counters)
    mark("int-dot serving phase")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in records.values()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
