"""The fixed-point golden engine on one GPU, without the training run of
``chip_smoke.py`` phase 22: ``fxp_scan`` against its plain version (phase
23, bit for bit, median of 5), then the integer model of the flagship
(``recipes/ndns.json``, random weights from seed 0, BatchNorm statistics
from seed 1, calibrated at w8a16 on 2 x 8 synthetic clips of 4 s) on
B = 8 clips of 30 s (L = 3751): its forward on the card with the kernel
(median of 3 warm calls, and one profiled call: device time, busy share,
largest device items), the same forward with the plain loop in its
place (one call), and the CPU's forward, which must equal the card's bit
for bit. Prints one JSON line ``{"fxp": {...}}`` last.

Run from the repository root::

    python3 tools/chip_fxp.py [--no-cpu]

``--no-cpu`` skips the CPU forward (about 15 s of int64 matmuls).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import B, CAL_SECONDS, SECONDS, fxp_scan_kernel_phase  # noqa: E402


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-cpu", action="store_true")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_fxp: no CUDA device", file=sys.stderr)
        return 1
    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.fxp import model as fxp_model_mod
    from sparsernns_tpu_torch.fxp.derive import (FxpModelConfig,
                                                 build_fxp_model)
    from sparsernns_tpu_torch.ops.cuda import build, fxp_scan
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.utils.config import RunConfig
    from sparsernns_tpu_torch.utils.profiling import profile_region
    from sparsernns_tpu_torch.utils.trace import launch_counts as ledger

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.build_all(["fxp_scan"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    print(build.build_logs.get("fxp_scan", "").strip(), file=sys.stderr)

    frames = SECONDS * 16000 // 128 + 1
    records = {}
    fxp_scan_kernel_phase(frames, torch.Generator().manual_seed(5), records)
    out = {"card": smi, "kernel": records["fxp_scan"]}

    # ---- the flagship's integer model ----
    cfg = RunConfig().with_recipe(os.path.join(HERE, "recipes", "ndns.json"))
    model = build_model(cfg, 257, 257, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in model.encoder.layers:
            h = layer.d_model
            layer.norm.running_mean.copy_(0.1 * torch.randn(h, generator=gen))
            layer.norm.running_var.copy_(0.5 + torch.rand(h, generator=gen))
    recipe = quantization_recipes[cfg.convert_quantization]
    cal_model = build_model(
        cfg, 257, 257, device=dev, seed=0, scan_mode="sequential",
        q_config=recipe(static_quant=True, calibrating=True))
    cal_ds = SyntheticNDNS(size=2 * B, length=CAL_SECONDS * 16000, seed=7)
    cal_audio = torch.from_numpy(np.stack(
        [cal_ds[i][0] for i in range(2 * B)])).to(dev)
    cal_x = (stft_splitter(cal_audio)[0] - STFT_MAG_MEAN).transpose(1, 2)
    params, stats = calibrate(cal_model, model.state_dict(),
                              [cal_x[:B], cal_x[B:]])
    q_config = recipe(static_quant=True, calibrating=False)
    model_cfg = FxpModelConfig.infer(
        params, glu_variant=cfg.glu_variant, relufication=cfg.relufication,
        prenorm=cfg.prenorm, clip_eigs=cfg.clip_eigs, conj_sym=cfg.conj_sym)
    card = build_fxp_model(params, stats, q_config, model_cfg, device="cuda")
    ds = SyntheticNDNS(size=B, length=SECONDS * 16000, seed=0)
    noisy = torch.from_numpy(np.stack([ds[i][0] for i in range(B)])).to(dev)
    x = (stft_splitter(noisy)[0] - STFT_MAG_MEAN).transpose(1, 2).contiguous()

    def forward():
        return card(x)

    y = forward()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        ledger(reset=True)
        t0 = time.perf_counter()
        y = forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert ledger()["fxp_scan"] == cfg.n_layers, ledger()
    prof = profile_region(f"fxp forward B={B} L={frames}", forward, top=8)
    print(json.dumps(prof), flush=True)
    out.update(forward_ms=sorted(times)[1], forward_ms_all=times,
               device_ms=prof["device_ms"],
               busy_share=prof["device_busy_share"],
               device_events=prof["device_events"], digest=_digest(y.data))
    print(f"fxp forward B={B} L={frames}: {sorted(times)[1]:.2f} ms (median "
          f"of 3: {times}), device {prof['device_ms']:.2f} ms, busy share "
          f"{prof['device_busy_share']:.3f}, digest {out['digest']}",
          flush=True)

    # the same forward with the plain loop on the card
    fxp_model_mod.fxp_scan = fxp_scan.fxp_scan_plain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_plain = forward()
        torch.cuda.synchronize()
        out["forward_plain_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        fxp_model_mod.fxp_scan = fxp_scan.fxp_scan
    same = torch.equal(y_plain.data, y.data)
    print(f"fxp forward with the plain loop: {out['forward_plain_ms']:.1f} "
          f"ms, equal to the kernel's: {same}", flush=True)
    assert same
    if not args.no_cpu:
        cpu = build_fxp_model(params, stats, q_config, model_cfg,
                              device="cpu")
        t0 = time.perf_counter()
        y_cpu = cpu(x.cpu())
        out["cpu_s"] = time.perf_counter() - t0
        same = torch.equal(y_cpu.data, y.data.cpu())
        print(f"fxp forward on the CPU: {out['cpu_s']:.1f} s, card = CPU bit "
              f"for bit: {same}", flush=True)
        assert same
    print(json.dumps({"fxp": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
