"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version at the flagship shapes, and
drives the float NDNS serving path at the width of ``recipes/ndns.json``
(d_model 192, P 128, 3 layers; random weights from a seed):

1. kernel phase — K1 (diagonal scan with carry) and K2 (whole-layer tail)
   against their plain versions on the card, B=8, L=3751, with times;
2. offline phase — the eval step on a synthetic 30 s batch of 8 clips
   (goes through K2), checked against the same model on the CPU;
3. streaming phase — a StreamingDenoiser over the same audio in 1 s chunks
   (goes through K1), checked against its one-chunk output and against
   the offline forward.

Run from the repository root: ``python3 chip_smoke.py``. Prints the card
and its power limit, one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

B, SECONDS, CHUNK = 8, 30, 16000
#: published H100 SXM peaks: f32 on the CUDA cores, device memory rate
F32_FLOPS, MEM_BYTES_S = 67e12, 3.35e12


def _bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / MEM_BYTES_S, n_flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(name: str, err: float, limit: float) -> None:
    print(f"{name}: max_abs_err {err:.3e} (limit {limit:.3e})", flush=True)
    if not err <= limit:
        raise AssertionError(f"{name}: error {err} above {limit}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.ops.cuda import build, diag_scan, layer_tail
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.steps import make_ndns_eval_step
    from sparsernns_tpu_torch.utils.config import RunConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))

    t0 = time.time()
    build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", file=sys.stderr)

    cfg = RunConfig().with_recipe(os.path.join(root, "recipes", "ndns.json"))
    model = build_model(cfg, 257, 257, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():   # non-trivial BatchNorm statistics
        for layer in model.encoder.layers:
            h = layer.d_model
            layer.norm.running_mean.copy_(0.1 * torch.randn(h, generator=gen))
            layer.norm.running_var.copy_(
                0.5 + torch.rand(h, generator=gen))
    layer0 = model.encoder.layers[0]
    h = cfg.d_model
    p = layer0.mixer.p
    n_layers = cfg.n_layers
    audio_len = SECONDS * 16000
    frames = audio_len // 128 + 1
    records = {}

    # ---------------- kernel phase ----------------
    with torch.no_grad():
        lam, w_b, w_c, d, relu_state = layer0.mixer.layer_tail_operands()
        # K1 at the streaming shape, with a non-zero carry; bu is the two
        # halves of one (B, L, 2P) projection, as the mixer gives it
        bu_cat = torch.randn((B, frames, 2 * p), generator=gen).to(dev)
        bu = (bu_cat[..., :p], bu_cat[..., p:])
        carry = tuple(torch.randn((B, p), generator=gen).to(dev)
                      for _ in range(2))
        ref = diag_scan.diag_scan_plain(lam, bu, carry)
        out = diag_scan.diag_scan_cuda(lam, bu, carry)
        torch.cuda.synchronize()
        scale = max(ref[0].abs().max().item(), ref[1].abs().max().item())
        err = max((out[0] - ref[0]).abs().max().item(),
                  (out[1] - ref[1]).abs().max().item())
        _check("K1 diag_scan vs plain", err, 1e-5 * scale)
        ms = _time_ms(lambda: diag_scan.diag_scan_cuda(lam, bu, carry), 20)
        plain_ms = _time_ms(
            lambda: diag_scan.diag_scan_plain(lam, bu, carry), 1, 0)
        elems = B * frames * p
        bound, by = _bound_ms(2 * elems * 4 * 2 + 2 * p * 4 + 2 * B * p * 4,
                              8 * elems)
        records["diag_scan"] = dict(
            name="diag_scan", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/diag_scan.cu",
            replaces="sparsernns_tpu/ops/pallas/scan_kernel.py:433",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)

        # K2 at the offline shape, layer 0's operands
        x = torch.randn((B, frames, h), generator=gen).to(dev)
        nw, nb = layer0.bn_affine()
        o2k, o2b = layer0.out2.weight.T, layer0.out2.bias
        kw = dict(act="gelu", glu=cfg.glu_variant, relu_state=relu_state,
                  layer_relu=False)
        args = (x, lam, w_b, w_c, d, nw, nb, o2k, o2b, None, None)
        ref = layer_tail.layer_tail_plain(*args, **kw)
        out = layer_tail.layer_tail_cuda(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        _check("K2 layer_tail vs plain", err,
               1e-4 * max(1.0, ref.abs().max().item()))
        ms = _time_ms(lambda: layer_tail.layer_tail_cuda(*args, **kw), 5)
        plain_ms = _time_ms(lambda: layer_tail.layer_tail_plain(*args, **kw),
                            1, 0)
        rows = B * frames
        n_dense = {"full": 2, "half1": 1, "half2": 1, "none": 0}[
            cfg.glu_variant]
        flops = rows * (2 * h * 2 * p + 2 * 2 * p * h + n_dense * 2 * h * h
                        + 8 * p + 6 * h)
        weights = (2 * h * 2 * p + n_dense * (h * h + h) + 3 * h + 2 * p)
        bound, by = _bound_ms(2 * rows * h * 4 + weights * 4, flops)
        records["layer_tail"] = dict(
            name="layer_tail", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer_train.py:162",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)

        # every GLU variant and activation of K2 (the recipe runs half1 +
        # gelu), at the full width on a short sequence
        xs = x[:2, :300]
        o1k, o1b = (torch.randn((h, h), generator=gen).to(dev) * h ** -0.5,
                    torch.randn((h,), generator=gen).to(dev) * 0.1)
        for glu in layer_tail.GLU_KINDS:
            for act in layer_tail.ACTS:
                relu = act == "relu"
                kw = dict(act=act, glu=glu, relu_state=relu, layer_relu=relu)
                args = (xs, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b)
                ref = layer_tail.layer_tail_plain(*args, **kw)
                out = layer_tail.layer_tail_cuda(*args, **kw)
                _check(f"K2 {glu}/{act} vs plain",
                       (out - ref).abs().max().item(),
                       1e-4 * max(1.0, ref.abs().max().item()))
    print(json.dumps({"kernel_phase": records}), flush=True)

    # ---------------- offline phase (K2) ----------------
    ds = SyntheticNDNS(size=B, length=audio_len, seed=0)
    pairs = [ds[i] for i in range(B)]
    noisy = np.stack([a for a, _ in pairs])
    clean = np.stack([c for _, c in pairs])
    noisy_t = torch.from_numpy(noisy).to(dev)
    clean_t = torch.from_numpy(clean).to(dev)
    noisy_mag, noisy_phase = stft_splitter(noisy_t)
    clean_mag, _ = stft_splitter(clean_t)
    step = make_ndns_eval_step(model)
    diag_scan.launches = layer_tail.launches = 0
    t0 = time.time()
    metrics = step(noisy_mag, noisy_phase, clean_mag, clean_t)
    torch.cuda.synchronize()
    offline_s = time.time() - t0
    records["layer_tail"]["launches"] = layer_tail.launches
    k1_offline = diag_scan.launches
    loss, snr = metrics["loss"].item(), metrics["si_snr"].item()
    print(f"offline: eval step {offline_s * 1e3:.1f} ms, loss {loss:.4f}, "
          f"si_snr {snr:.3f} dB, K2 launches {layer_tail.launches}, "
          f"K1 launches {k1_offline}", flush=True)
    assert noisy_mag.shape == (B, 257, frames), noisy_mag.shape
    assert np.isfinite(loss) and np.isfinite(snr), metrics
    assert layer_tail.launches == n_layers, layer_tail.launches
    # reference on a small input: the same model on the CPU (plain paths)
    with torch.no_grad():
        x_small = (noisy_mag[:2, :, :200].transpose(1, 2) - STFT_MAG_MEAN)
        y_gpu = model(x_small).cpu()
        cpu_model = build_model(cfg, 257, 257, device="cpu", seed=0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        y_cpu = cpu_model(x_small.cpu())
    _check("offline forward, GPU vs CPU plain", (y_gpu - y_cpu).abs().max()
           .item(), 1e-3)

    # ---------------- streaming phase (K1) ----------------
    den = StreamingDenoiser(model, batch_size=B)
    diag_scan.launches = layer_tail.launches = 0
    t0 = time.time()
    out_chunked = den.process_offline(noisy, chunk_samples=CHUNK)
    torch.cuda.synchronize()
    stream_s = time.time() - t0
    records["diag_scan"]["launches"] = diag_scan.launches
    n_chunks = -(-audio_len // CHUNK)
    print(f"streaming: {n_chunks} chunks of {CHUNK} samples in "
          f"{stream_s * 1e3:.1f} ms, K1 launches {diag_scan.launches}, "
          f"K2 launches {layer_tail.launches}", flush=True)
    assert diag_scan.launches >= n_layers * (n_chunks - 1), diag_scan.launches
    assert layer_tail.launches == 0, layer_tail.launches
    whole = StreamingDenoiser(model, batch_size=B)
    out_whole = np.concatenate([whole.process(noisy), whole.flush()], axis=-1)
    assert out_chunked.shape == out_whole.shape, (out_chunked.shape,
                                                  out_whole.shape)
    assert np.isfinite(out_chunked).all()
    _check("streaming chunked vs one chunk",
           float(np.abs(out_chunked - out_whole).max()), 1e-4)
    with torch.no_grad():
        x_frames = noisy_mag[..., :1000].transpose(1, 2) - STFT_MAG_MEAN
        y_stream, _ = model.forward_stream(x_frames, None)
        y_offline = model(x_frames)
    _check("stream forward (K1 path) vs offline forward (K2 path)",
           (y_stream - y_offline).abs().max().item(), 1e-3)

    # ---------------- report ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
