"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version at the flagship shapes, and
drives the float NDNS serving path, the w8a16 engine serving path, the
float NDNS training path, the mixer route (training and eval of the models
outside the whole-layer kernel), top-k serving, pruned training with
block-sparse serving, quantization-aware and top-k training, the int-dot
engines (w8a8, and w8a16 with ``mxu16``), the LayerNorm and
bf16-stream training of the whole-layer kernels, the conversion pipeline
and the fixed-point golden engine over its artifacts, the classification
and retrieval heads, BatchNorm folding, the kernel-free routes
(``scan_mode="blocked"``, the engine's ``route="xla"``), truncated
backpropagation through time and the WAV corpus at the width of
``recipes/ndns.json`` (d_model 192, P 128, 3 layers; random weights from
a seed):

1. kernel phase — K1 (the time-chunked diagonal scan, from a carry) and
   K2 (whole-layer tail: a B-projection pass, the scan, a tail pass over
   tiles of the flattened B x L rows) against their plain versions on the
   card, B=8, L=3751, and at B=32, with times (K1 at B=8 a mean of 20
   calls, K2 of 5, at B=32 medians of 5); K1 also bit for bit against the
   plain mirror of its plan, its passes' grids as the CUDA source
   recorded them against ``scan_plan`` (at least 132 CTAs a pass over
   (B, L, P)); K2's passes and grids, every product pass at least
   ceil(B x L / 128) CTAs; the SHA-256 digests of K1's and K2's outputs;
2. offline phase — the eval step on a synthetic 30 s batch of 8 clips
   (goes through K2), checked against the same model on the CPU;
3. streaming phase — a StreamingDenoiser over the same audio in 1 s chunks
   (goes through K1: one pass a call, as its plan states for a chunk's
   125 frames), checked against its one-chunk output and against the
   offline forward;
4. engine kernel phase — the float model is calibrated on two synthetic
   batches, its scales are frozen and a ``W8A16Engine`` is built; K5a (one
   serving layer), K5b (with a non-zero carry) and K6 (the whole network),
   each a sequence of row and scan passes, against their plain versions,
   B=8, L=3751, block_t=512, with times and the device time of K6's and
   K5b's passes; K6 and K5a at B=32; a ragged call (B=3, L=70: B*L not a
   multiple of the row tile, L below the block; the K5a stack = K6);
   every pass's grid as the CUDA source recorded it, held against the
   pass plan;
5. engine offline phase — ``engine(x)`` on the 30 s batch (one K6 call:
   its seven passes, every row pass at least one CTA an SM), the SHA-256
   of its mask, median call times and peak memory at B=8 and 32, the same
   through the per-layer stack (three K5a calls, bit-identical mask), and
   the engine on the card against the engine on the CPU;
6. engine streaming phase — ``StreamingDenoiser.from_engine`` at
   block_t=128 over the same audio (K5b on every forward), chunked
   ``process_chunk`` against one whole call, and one chunk's passes;
7. training kernel phase — K2 with dropout masks, K3a (carry history and
   every state) and K3b (the adjoint's passes, every output) against
   their plain versions, B=8, L=3751 for the recipe's variant, and L=1000
   for the other seven of the four GLU kinds x (gelu | relu + relu_state +
   layer_relu); the recipe's variant again at B=32, the train step's
   batch; K2's passes checked and its outputs' digests printed after each
   call; two K3b launches equal bit for bit; K2, K3a and K3b timed at B=8
   and B=32 with their bounds, the passes' device times, the grids as
   launched and registers;
8. training phase — ``build_model(training=True)``, ``create_run_state``
   and ``make_ndns_train_step`` as the recipe sets them (B=32 clips of
   30 s, dropout 0.1, noBCdecay, weight decay 0.04): three steps, then
   two with ``microbatch=8``, the second under the profiler (3 x K2, K3a, K3b per step, x 4 with the
   microbatch, no other kernel); one step on the card against the same
   step on the CPU at a short length; eight dropout-free steps on one
   B=8 batch must lower the loss; step wall time, device busy share and
   peak memory at B=32 and B=8;
9. mixer kernel phase — K1 in reverse (against plain and bit for bit
   against its plan's mirror, its passes against the plan, digests) and
   K4a (the S5 mixer as a head row pass, the scan, a tail row pass; float
   mode, with and without relu_state) against their plain versions, B=8,
   L=3751, B=32, one odd-width case and a wide one (H=640, P=128), with
   times, K4a's passes against its plan and its output's digest; the relu
   decisions of K4a's forward states that K1's recompute flips; the
   gradients of ``FusedS5Fn`` and of the scan in both directions on the
   card against autograd through the plain versions on the card; K1's
   launch options for the bidirectional mixer's buffers at Path-X's scan
   shape (B=32, L=16384, P=128) and an odd one: the states into their
   columns of a (B, L, 4P) matrix, the adjoint's into a (B, L, 2P) buffer
   and added to what one held, bit for bit against the plain mirror, dλ's
   partials once reduced within 1e-5 of their terms' magnitudes of
   ``_dlam`` in float64;
10. mixer-route training phase — the recipe with ``prenorm=false``
   (postnorm BatchNorm: the unfused layer around K4a): three B=32 train
   steps with dropout 0.1 (per step 3 x K4a, 3 x K1 forward, 3 x K1
   reverse and no other kernel), one eval step (3 x K4a), one step on the
   card against the CPU, eight dropout-free B=8 steps that must lower the
   loss; then the bidirectional model at B=8, two steps (6 x K1 forward
   and 6 x K1 reverse a step, every layer's scans on the buffers route,
   forward and backward) and one step on the card against the CPU; step
   wall time, device busy share, peak memory;
11. top-k kernel phase — K1 with the block requant (no carry, from a
   carry, and reverse, its blocks from the end; B=8 and 32; bit for bit
   against its plan's mirror, its passes against the plan), K4a in the
   serving engine's modes (int8 weights with per-half
   scales, bf16 and f32 input, block 512, relu_state off and on, one
   odd-width case; f32 weights on a 32-bit state grid) and K4b (one
   128-frame block from a carry) against their plain versions at B=8,
   L=3751 with layer 1 of the w8a16 engine, and K4a-engine at B=32, with
   times, every call's passes against its plan and the outputs' digests;
   chunked K4b against one K4a-engine call (exact); the engine's per-op
   route forced against its stack route;
12. top-k serving phase — the recipe with ``topk=0.5, approx_topk=true``:
   the float eval step (3 x K1, no K2, no K4a) and a 30-chunk stream
   (3 x K1 a forward); calibrate, freeze, the w8a16 engine (bf16) offline
   (3 x K4a-engine, no K5, no K6) and streaming at block 128 (3 x K4b a
   forward); the relufied model's engine offline (3 x K1 block requant,
   no K4a), checked against the CPU engine, and its refusal to stream
   chunks; wall time, device busy share and peak memory per region;
13. block-sparse kernel phase — K7 (the block-sparse matmul over kept
   (32, 128) tiles, on the tensor cores as exact bf16 planes) against its
   plain version at M = B x 3751 on the encoder, GLU gate and decoder
   shapes, int8 tiles at 90 % and 50 % zero tiles, int16 and f32 tiles on
   the encoder at 90 %, x f32 and bf16, an edge tile and a fully zero
   output tile, the chunk shape M = B x 128, one exact-grid case; each
   launch and the tiles' planes against the plan and the planes' plain
   mirror; device, event, host, plain and ``torch.matmul`` times;
14. pruned training and block-sparse serving phase — the recipe with
   ``pruning="iterative-ste-block-0.9"``: three B = 32 train steps with
   tile-mask updates (K2, K3a, K3b x 3 a step) and the final update (every
   dense kernel at least 83 % zero tiles); masks applied, calibrate,
   freeze; the w8a16 engine (bf16) offline (K7 x 5, K4a-engine x 3) and
   ``process_chunk`` at block 128 (K7 x 5, K4b x 3 a chunk, float32
   mask), chunks against one whole call, card against CPU; the requant
   code flips of the block-sparse engine against the same engine with
   K7's plain version on the card (each layer on the plain run's input:
   its stream codes at most 1 apart in at most 0.5 %, the share printed,
   the whole call's beside it); an engine with
   dense GLU kernels on the stack route (K7 x 2, K5a x 3) against its
   per-op route; three steps of ``recipes/ndns_sparse.json`` (magnitude
   masks through K2/K3) and its weight sparsity;
15. QAT kernel phase — the λ tables kernel against
   ``lambda_power_tables`` (bit for bit, or the first differing entry);
   K1 and K4a in their QAT modes (w8a16's bits, 16 and 16) against their
   plain versions at B=8, L=3751 under the quantized-state bar: K1 at
   t=1024 forward, reverse and from a carry, with the block requant (codes
   on the frozen grid; forward, from a carry and reverse), at t=256 and
   the largest block the plan takes, one odd width; K4a at t=512 with
   per-block and global state scales, relu_state off and on, its states over an exact B-projection, at t=256
   and the largest block, over int8 weights with per-half scales and the
   block requant, one odd width; every call's launches (one cluster per
   (batch row, block): grids and cluster shapes as the CUDA source
   recorded them) against the plan, the scan's residency; times (K4a also
   at B=32) and profiles (at most 3 / 5 kernels a call);
16. QAT and top-k training phase — the recipe with
   ``quantization="w8a16"``, ``block_t=512``: three B=32 steps (K4a qat
   x 3, K1 x 3 each way a step), three with ``qat_global_scales`` (K1 x 3
   more), each profiled (busy share, device events a step), a step
   against the CPU, eight dropout-free B=8 steps that must lower the
   loss, an eval step (K4a qat x 3, profiled), a 30-chunk QAT stream (K1
   qat x 3 a forward; three chunks against the CPU), the per-block and
   global forwards against the associative QAT forward (printed); three
   B=32 steps of the top-k recipe (K1 x 3 each way); the ``w32a32``
   engine offline (per-op route, K4a-engine x 3) against the CPU engine,
   timed;
17. int-dot kernel phase — the flagship calibrated at w8a8 and at w8a16
   and frozen; the w8a8 engine (int8 dots of the denses on their frozen
   input grids) and the w8a16 engine with ``mxu16`` (every dot on the two
   int8 planes of its 16-bit codes, the static model's requants): K6, K5a
   (first launch with the encoder, a middle one, the last with the
   decoder) and K5b (one 128-frame block from a carry) in those modes
   against their plain versions at B=8, L=3751, timed (median of 5 and
   the profiler's device time of a call's passes; K6's pass grids); GLU
   full / half2 / none and f32
   activations at a short length (network vs plain, network = stack); an
   odd-width network (H=400: the plane-wise formula; P=18);
18. int-dot serving phase — the w8a8, w8a8A8 and ``mxu16`` engines
   offline (K6 x 1), on the stack
   route (K5a x 3, bit-identical), streamed by ``from_engine`` at block
   128 (K5b x 3 a forward; chunked = whole), on the card against the
   CPU; the w8a8 top-k engine on the per-op route (K4a-engine x 3, the
   denses' int8 dots as float64 code products), against the CPU engine;
19. tail modes kernel phase — K2, K3a and K3b in their non-affine mode
   (float32) and on bf16 streams (affine and non-affine) against their
   plain versions at B=8, L=3751 (half1 with gelu; with relu and
   layer_relu; with relu, relu_state and layer_relu; dropout masks) and
   one odd width (H=20, P=12, L=70, full GLU), timed (median of 5), K2's
   passes checked and its outputs' digests printed; f32
   at phase 7's bars, bf16 streams within one bf16 ulp of plain (or, near
   0, the f32 bar) with at most 1e-3 of the elements different; under
   relu_state, where recomputed states within rounding of 0 flip the
   relu, K3b at the JAX package's bar for that case, 2e-2;
20. LayerNorm training phase — the recipe with ``batchnorm=false`` (K2,
   K3a, K3b x 3 a step in their non-affine mode, nothing else): three
   B=32 steps, an eval step (K2 x 3), a step against the CPU, eight
   dropout-free B=8 steps that must lower the loss, and three B=32 steps
   of the mixer route (``prenorm=false``) beside it;
21. bf16 stream training phase — the recipe with
   ``train_stream_dtype="bfloat16"``: three B=32 steps on a bf16 stream
   (K2, K3a, K3b x 3 a step, every layer's input and output bf16) and the
   same three on a float32 stream from the same seed, losses within rtol
   2e-3; step times and peak memory of both;
22. pipeline phase — the conversion pipeline from a training run's
   checkpoint, through the command line a user calls: ``cli.main train``
   on the recipe at full width (PIPE_EPOCHS epochs of 4 B=8 steps:
   K2-train, K3a, K3b x 3 a step, K2 x 3 an eval batch; the JAX package's
   quality protocol trains 25 epochs before its gates, and after 2 the
   model is untrained: SI-SNR -11 dB, static quantization 1-3 dB off it
   in both packages), ``cli.main convert`` over its
   checkpoint with every stage on (baseline: K2 x 3; the activation dump:
   the unfused route, K4a x 3; naive scan, QAT validation, QAT
   finetuning, calibration, static-quant validation and static-quant
   finetuning: plain PyTorch, no kernel; engine validation: K6 x 1 a
   batch), each stage's loss, SI-SNR, wall seconds and launches, the JAX
   package's SI-SNR gates (static and engine within 1 dB of the float
   baseline, engine within 0.5 dB of static), the artifacts, then
   ``W8A16Engine.from_artifacts`` on the same directory, whose offline
   call (K6 x 1) equals the convert stage's engine bit for bit; then the
   fixed-point golden engine over the same artifacts, ``cli.main fxp`` in
   each mode (inference: fxp_scan x 3 a validation batch, JAX's SI-SNR
   gates, within 1.5 dB of the float baseline and 0.5 dB of static
   quantization; verify: fxp_scan x 3, every block's statistics equal to
   the CPU run's on the same artifacts, the encoder's block and 2 per
   layer, 4 where the float mixer dumped its states (not on the
   recipe's fused route); export:
   the bundle's files), each mode's wall time and launches, one
   validation batch's integer output on the card equal to the CPU's bit
   for bit, and a full-length forward (B=8 clips of 30 s, L = 3751;
   fxp_scan x 3) timed with its busy share and equal to the CPU's bit for
   bit. Cuts: clips of PIPE_SECONDS s (L = 373 frames), 32 training clips,
   one epoch of each finetuning stage; no width is cut;
23. fxp_scan kernel phase (run before phase 22) — the fixed-point
   engine's integer recurrence (``ops/cuda/csrc/fxp_scan.cu``; JAX runs it
   as ``lax.scan``, no ``pallas_call``) against its plain version on the
   card at B=8, L=3751, P=128 on seeded codes at the flagship's formats
   (16-bit states, a at 2^-15, g = 12), a quarter of the channels near
   |lambda| = 1 driven into saturation: bit for bit, timed (median of 5);
24. classification phase (after 22, as 25-29) — the flagship's layers
   under ``ClassificationModel(mode="pool")`` with 10 classes on the
   synthetic set at the sMNIST shape (784 steps of one input), B = 32:
   three recipe steps (K2-train, K3a, K3b x 3 each a step, nothing
   else), an eval step (K2 x 3), both profiled (wall, device ms, busy
   share); one dropout-free step on the card against the CPU at the
   training bars (``_grads_close``); eight dropout-free steps that lower the loss; eval forwards on
   the card against the CPU at 1e-4 x max(1, |ref|): ``mode="last"``, a
   padded batch through ``masked_meanpool`` and ``RetrievalModel`` on
   2 x 16 sequences (K2 x 3); ``cli.main train`` on a classification
   recipe in a temporary directory (one epoch), its wall seconds;
25. BatchNorm folding phase — three training steps move the running
   statistics, then the eval forward at B = 8 x 30 s with
   ``fuse_batchnorm_linear`` (K1 x 3, the stand-alone scan; no K2)
   against the unfolded model on the card and against the CPU (a
   2 x 500-frame slice) at 1e-4 x max(1, |ref|);
26. blocked scan phase — ``scan_mode="blocked"`` (no kernel at all): the
   eval step at B = 8 x 30 s against the fused route (1e-3), the eval
   forward against the CPU, one train step against the CPU at the
   training bars, a timed and a profiled B = 8 train step;
27. xla route phase — the w8a16 engine of phase 4's frozen tree on
   ``route="xla"`` (no kernel at all): the offline call at B = 8 x 3751
   and ``process_chunk`` over 128-frame blocks against the ``"auto"``
   engine (K6 offline, K5b chunked) at the engine bar with float32
   activations, chunked against one whole call, timed and profiled;
   with phase 4's bf16 activations the card against the CPU (the per-op
   route rounds the mixer input to bf16 where the kernels do not, in the
   JAX package too: that difference is printed);
28. TBPTT phase — the flagship with ``scan_mode="associative"`` on the
   STFT features of B = 8 x 30 s clips in chunks of 375 frames: the
   chunked eval forward with the carry against the whole forward
   (1e-4 x max(1, |ref|)), the first ``make_tbptt_train_step`` step
   (dropout 0, mean-squared error against the clean magnitude) on the
   card against the CPU at the training bars, a pass over the batch's
   chunks that moves the carry and lowers the first chunk's loss, ms a
   chunk step;
29. WAV corpus phase — an N-DNS-layout corpus of 30 s PCM16 clips written
   to a temporary directory (16 train pairs, 8 each for validation and
   test): the native decoder's batch against the ``wave`` reader's bit
   for bit (``native.available()`` printed), then ``train(cfg)`` with
   ``synthetic_data`` false and the ``NDNS_*_SET`` variables, one epoch at
   B = 8 (K2-train, K3a, K3b x 3 a step, K2 x 3 an eval batch), its wall
   seconds;
30. parallel phase — the device mesh (``parallel/``) at the flagship's
   width, dropout 0. First every path as one rank over NCCL (world 1, the
   trivial mesh, no collective): three B = 32 train steps (K2-train, K3a,
   K3b x 3 a step), two B = 8 steps of the ``"associative"`` model, the
   engine's DP forward (K6, equal to ``engine(x)``), its SP and TP
   forwards at L = 3744 (K1 x 3: the per-op float layer body without the
   state requant; against the engine's own route at the JAX package's
   0.1), the pipeline over 3 stages on the visible cards, 6 chunks of 624
   frames: the float route (K1 from a carry x 18) against the same route
   on the CPU at the engine bar and against that body at 0.1 (it keeps
   the mixer input f32, as the JAX package's does), the mxu16 route (K5b
   x 18, time block 208) equal to ``process_chunk``, and both routes
   again on an input the caller's stream writes behind ~10 ms of matrix
   products (the stages wait for it: equal to the first call). Then two
   ranks, one a card over NCCL (``make_mesh`` makes it current) or, with
   one card, both on it over gloo: DP training (3 steps, 16 rows a rank), TP
   training (2 steps, P 128 as 2 x 64), SP training (``scan_mode="sp"``,
   B = 8, 2 steps, 1876 + 1875 frames; K1 x 3 each way a step) against the
   one-rank runs at PR 3's card bars and, at 65 frames, against the CPU;
   DP serving (B = 8, K6 a rank) against one rank bit for bit, SP and TP
   serving against one rank at the engine bar. For each path: backend,
   world, wall, collective bytes and counts, launches per rank. With two
   or more cards also ``cli train`` under ``torch.distributed.run``: two
   ranks, a card each over NCCL, ``--mesh_data 2``, one layer, one epoch
   of 8 clips of 2 s. The whole run's wall time is printed last.

Run from the repository root: ``python3 chip_smoke.py``. Prints the card
and its power limit, one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

B, SECONDS, CHUNK = 8, 30, 16000
#: seconds of audio in a calibration clip; frames per streaming engine block
CAL_SECONDS, STREAM_BLOCK = 4, 128
#: seconds of a clip of the pipeline phase (22): the sequential scan of its
#: plain stages walks every frame, so the clips are short; its training
#: epochs: the JAX package's quality protocol (tools/quality_sweep.py)
#: trains 25 before it holds a converted model to the SI-SNR gates
PIPE_SECONDS, PIPE_EPOCHS = 3, 25
#: published H100 SXM peaks: f32 on the CUDA cores, int8 and bf16 on the
#: tensor cores (dense), device memory rate
F32_FLOPS, INT8_OPS, BF16_FLOPS, MEM_BYTES_S = 67e12, 1979e12, 989e12, 3.35e12


def _bound_ms(n_bytes: float, n_flops: float, int8_ops: float = 0.0,
              bf16_flops: float = 0.0):
    """The least time: the larger of the bytes at the memory rate and the
    operations at the peak of their type (f32 flops on the CUDA cores,
    int8 dot operations and bf16 flops on the tensor cores, which can run
    at once)."""
    t_bytes = n_bytes / MEM_BYTES_S
    t_ops = max(n_flops / F32_FLOPS, int8_ops / INT8_OPS,
                bf16_flops / BF16_FLOPS)
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


def _median_ms(fn, iters: int = 5) -> float:
    """Median over ``iters`` timed calls, after one warm-up call."""
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


def _check(name: str, err: float, limit: float) -> None:
    print(f"{name}: max_abs_err {err:.3e} (limit {limit:.3e})", flush=True)
    if not err <= limit:
        raise AssertionError(f"{name}: error {err} above {limit}")


def _code_diff(name: str, out, ref, max_frac: float = 5e-3) -> float:
    """Stored integer streams: codes differ by at most 1, in at most
    ``max_frac`` of the elements. Returns the largest difference."""
    diff = (out.to(int) - ref.to(int)).abs()
    worst, frac = diff.max().item(), (diff > 0).float().mean().item()
    print(f"{name}: max code diff {worst}, differing share {frac:.2e} "
          f"(limits 1, {max_frac:.1e})", flush=True)
    if worst > 1 or frac > max_frac:
        raise AssertionError(f"{name}: codes differ by {worst} in {frac}")
    return float(worst)


#: the launch counters of the whole-layer training kernels K2, K3a, K3b
TAIL_KERNELS = ("layer_tail_train", "layer_tail_hist", "layer_tail_bwd")
BWD_OUTPUTS = ("g_x", "g_skip", "d_lam", "d_w_b", "d_w_c", "d_d", "d_o2k",
               "d_o2b", "d_o1k", "d_o1b", "d_m1", "d_m2", "d_nw", "d_nb")


def _missing_tail_kernels(profile) -> list:
    """The ``__global__``s that the last K3a and K3b call launched, as the
    CUDA source recorded them, that ``profile`` (``profile_region``'s
    summary of a region that ends with that call) does not show."""
    from sparsernns_tpu_torch.ops.cuda import layer_tail_bwd
    seen = " ".join(k["name"] for k in profile["top_kernels"])
    names = [k for grids in layer_tail_bwd.launched().values()
             for k in grids]
    assert names, "no K3a / K3b launch recorded"
    return [k for k in names if k not in seen]


def _check_tail_kernels(profile) -> None:
    """Every kernel the last K3a and K3b call launched is in ``profile``."""
    missing = _missing_tail_kernels(profile)
    assert not missing, f"kernels not in the profile: {missing}"


def training_kernel_phase(layer0, cfg, frames: int, gen, records) -> None:
    """Phase 7: K2 with masks, K3a and K3b against their plain versions at
    B x frames x H, layer 0's operands; limits 2e-4 of max(1, max|ref|)
    (the JAX package's bar between its adjoint kernel and its XLA
    backward), K3a 1e-5; the recipe's variant also at 4 B (the recipe's
    batch, which the train step runs), whose plan differs. Two K3b
    launches on the same inputs must give the same bits; K3a and K3b are
    timed at B and 4 B beside their bounds, with each pass's device time
    at 4 B from the profiler, every launch's grid as the CUDA source
    recorded it (more CTAs than B; at B, as many as the card has SMs) and
    the kernels' registers and spills from ``nvcc -Xptxas -v``."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import layer_tail, layer_tail_bwd
    dev = torch.device("cuda")
    h, p = cfg.d_model, layer0.mixer.p
    with torch.no_grad():
        lam, w_b, w_c, d, _ = layer0.mixer.layer_tail_operands()
        nw, nb = layer0.bn_affine()
        o2k, o2b = layer0.out2.weight.T.contiguous(), layer0.out2.bias
        o1k = torch.randn((h, h), generator=gen).to(dev) * h ** -0.5
        o1b = torch.randn((h,), generator=gen).to(dev) * 0.1
        x = torch.randn((B, frames, h), generator=gen).to(dev)
        g = torch.randn((B, frames, h), generator=gen).to(dev)
        keep = 1.0 - cfg.p_dropout
        m1, m2 = ((torch.rand((B, 1, h), generator=gen) < keep).float().to(
            dev) / keep for _ in range(2))

        def variant(glu, act):
            relu = act == "relu"
            use2, use1 = glu != "none", glu == "full"
            args = (lam, w_b, w_c, d, nw, nb, o2k if use2 else None,
                    o2b if use2 else None, o1k if use1 else None,
                    o1b if use1 else None)
            kw = dict(act=act, glu=glu, relu_state=relu, layer_relu=relu,
                      m1=m1, m2=m2 if use2 else None)
            return args, kw

        def compare(tag, x, g, args, kw):
            """K2 with masks and every output of K3b against the plain
            versions; returns (forward error, worst relative error of the
            backward's outputs)."""
            ref = layer_tail.layer_tail_plain(x, *args, **kw)
            out = layer_tail.layer_tail_cuda(x, *args, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            _check(f"K2-train {tag} vs plain", err,
                   1e-4 * max(1.0, ref.abs().max().item()))
            _check_k2_passes(f"K2-train {tag}", *x.shape[:2])
            print(f"K2-train {tag} output digest: {_digest(out)}",
                  flush=True)
            refs = layer_tail_bwd.layer_tail_bwd_plain(x, g, *args, **kw)
            outs = layer_tail_bwd.layer_tail_bwd_cuda(x, g, *args, **kw)
            torch.cuda.synchronize()
            rel_worst = 0.0
            for name, r, o in zip(BWD_OUTPUTS, refs, outs):
                if r is None:
                    assert o is None, name
                    continue
                if name == "d_lam":
                    r, o = torch.stack(r), torch.stack(o)
                assert r.shape == o.shape, (name, r.shape, o.shape)
                scale = max(1.0, r.abs().max().item())
                rel_worst = max(rel_worst,
                                (o - r).abs().max().item() / scale)
            _check(f"K3b {tag} vs plain, worst output, relative to "
                   "max(1, max|ref|)", rel_worst, 2e-4)
            return err, rel_worst

        # the recipe's variant at the full length, the other seven at the
        # full width over the first 1000 frames
        worst = {}
        x_cut, g_cut = x[:, :1000].contiguous(), g[:, :1000].contiguous()
        for glu in layer_tail.GLU_KINDS:
            for act in layer_tail.ACTS:
                if glu == cfg.glu_variant and act == "gelu":
                    worst["fwd"], worst["bwd"] = compare(
                        f"{glu}/{act}", x, g, *variant(glu, act))
                else:
                    compare(f"{glu}/{act} L=1000", x_cut, g_cut,
                            *variant(glu, act))

        # widths that are no multiple of the kernels' vector widths, a
        # length with a short last tile: the generic paths of the kernels
        hs, ps, ls = 20, 12, 70
        rnd = lambda *shape, sc=1.0: (  # noqa: E731
            torch.randn(shape, generator=gen) * sc).to(dev)
        radius = torch.rand(ps, generator=gen) * 0.39 + 0.6
        angle = torch.rand(ps, generator=gen) * 6.0 - 3.0
        odd_args = (((radius * torch.cos(angle)).to(dev),
                     (radius * torch.sin(angle)).to(dev)),
                    rnd(hs, 2 * ps, sc=0.3), rnd(2 * ps, hs, sc=0.3),
                    rnd(hs), 1.0 + rnd(hs, sc=0.2), rnd(hs, sc=0.1),
                    rnd(hs, hs, sc=0.3), rnd(hs, sc=0.1),
                    rnd(hs, hs, sc=0.3), rnd(hs, sc=0.1))
        odd_kw = dict(act="relu", glu="full", relu_state=True,
                      layer_relu=True, m1=m1[:2, :, :hs].contiguous(),
                      m2=m2[:2, :, :hs].contiguous())
        compare(f"H={hs} P={ps} L={ls} full/relu", rnd(2, ls, hs),
                rnd(2, ls, hs), odd_args, odd_kw)

        args, kw = variant(cfg.glu_variant, "gelu")
        # the passes' partial sums have a fixed order: two launches on the
        # same inputs give the same bits
        first = layer_tail_bwd.layer_tail_bwd_cuda(x, g, *args, **kw)
        again = layer_tail_bwd.layer_tail_bwd_cuda(x, g, *args, **kw)
        torch.cuda.synchronize()
        for name, o1, o2 in zip(BWD_OUTPUTS, first, again):
            for a1, a2 in zip(*((o1, o2) if name == "d_lam" else
                                ((o1,), (o2,)))):
                assert (a1 is None) == (a2 is None), name
                assert a1 is None or torch.equal(a1, a2), (
                    f"K3b {name}: two launches differ")
        print("K3b: two launches on the same inputs equal bit for bit",
              flush=True)
        del first, again
        hist_ref = layer_tail_bwd.layer_tail_hist_plain(x, lam, w_b, nw, nb)
        hist = layer_tail_bwd.layer_tail_hist_cuda(x, lam, w_b, nw, nb)
        torch.cuda.synchronize()
        hist_scale = max(t.abs().max().item() for t in hist_ref)
        hist_err = max((a - b).abs().max().item()
                       for a, b in zip(hist, hist_ref))
        _check("K3a layer_tail_hist vs plain", hist_err,
               1e-5 * max(1.0, hist_scale))
        assert hist[0].shape == (B, -(-frames // 32), p), hist[0].shape

        # B=32 data from a generator of its own, so that the later phases
        # draw what they drew before
        gen32 = torch.Generator().manual_seed(32)
        x32 = torch.randn((4 * B, frames, h), generator=gen32).to(dev)
        g32 = torch.randn((4 * B, frames, h), generator=gen32).to(dev)
        kw32 = dict(kw, m1=m1.repeat(4, 1, 1), m2=m2.repeat(4, 1, 1))
        # the train step's batch: another plan (chunks, slices, partials)
        # than at B=8, held against the plain versions at the same bars
        # (the records keep the worse of the two batches)
        worst["bwd"] = max(worst["bwd"], compare(
            f"{cfg.glu_variant}/gelu B={4 * B}", x32, g32, args, kw32)[1])
        hist32_ref = layer_tail_bwd.layer_tail_hist_plain(x32, lam, w_b, nw,
                                                          nb)
        hist32 = layer_tail_bwd.layer_tail_hist_cuda(x32, lam, w_b, nw, nb)
        torch.cuda.synchronize()
        hist32_err = max((a - b).abs().max().item()
                         for a, b in zip(hist32, hist32_ref))
        _check(f"K3a layer_tail_hist B={4 * B} vs plain", hist32_err,
               1e-5 * max(1.0, max(t.abs().max().item() for t in hist32_ref)))
        hist_err = max(hist_err, hist32_err)
        del hist32, hist32_ref
        # times: the recipe's variant at B=8 and at the recipe's B=32; K3b
        # alone = (K3a + K3b) - K3a, since the backward wrapper launches
        # both
        ms_fwd = _median_ms(lambda: layer_tail.layer_tail_cuda(
            x, *args, **kw))
        ms_fwd32 = _median_ms(lambda: layer_tail.layer_tail_cuda(
            x32, *args, **kw32))
        ms_hist, ms_bwd, grids = {}, {}, {}
        for bsz, xb, gb, kwb in ((B, x, g, kw), (4 * B, x32, g32, kw32)):
            ms_hist[bsz] = _median_ms(
                lambda: layer_tail_bwd.layer_tail_hist_cuda(
                    xb, lam, w_b, nw, nb))
            ms_bwd[bsz] = _median_ms(
                lambda: layer_tail_bwd.layer_tail_bwd_cuda(
                    xb, gb, *args, **kwb)) - ms_hist[bsz]
            # the grids of the last of those launches, as they launched
            grids[bsz] = layer_tail_bwd.launched()
        # where the backward's time goes, pass by pass, at B=32
        from sparsernns_tpu_torch.utils.profiling import profile_region
        # the profiler drops device events now and then (PERF.md §7): a
        # window that lacks a launched kernel is taken once more, and the
        # second must show every one
        for window in (1, 2):
            profile = profile_region(
                f"K3a + K3b B={4 * B}",
                lambda: layer_tail_bwd.layer_tail_bwd_cuda(
                    x32, g32, *args, **kw32), top=40)
            print(json.dumps(profile), flush=True)
            missing = _missing_tail_kernels(profile)
            if not missing or window == 2:
                break
            print(f"K3a + K3b B={4 * B}: profiler window 1 lacks {missing} "
                  f"({profile['device_events']} device events); again",
                  flush=True)
        _check_tail_kernels(profile)
        del x32, g32
        plain_fwd = _time_ms(lambda: layer_tail.layer_tail_plain(
            x, *args, **kw), 1, 0)
        plain_hist = _time_ms(lambda: layer_tail_bwd.layer_tail_hist_plain(
            x, lam, w_b, nw, nb), 1, 0)
        plain_bwd = _time_ms(lambda: layer_tail_bwd.layer_tail_bwd_plain(
            x, g, *args, **kw), 1, 0)
    rows = B * frames
    n_dense = {"full": 2, "half1": 1, "half2": 1, "none": 0}[cfg.glu_variant]
    mm = 2 * h * 2 * p + 2 * 2 * p * h + n_dense * 2 * h * h
    weights = 2 * h * 2 * p + n_dense * (h * h + h) + 3 * h + 2 * p
    stream = rows * h * 4
    fwd_bound = _bound_ms(2 * stream + (weights + 2 * B * h) * 4,
                          rows * (mm + 8 * p + 8 * h))
    # the history pass: x read, every state and the history written
    states = rows * 2 * p * 4
    hist_bound = _bound_ms(
        stream + states + (h * 2 * p + 2 * h + 2 * p) * 4
        + 2 * hist[0].numel() * 4, rows * (2 * h * 2 * p + 8 * p + 2 * h))
    # the adjoint from the states: the forward's products but the
    # B-projection again, as many transposed products and as many
    # weight-gradient products; x, g and the states read, g_x written, the
    # weight gradients written
    grads = 2 * h * 2 * p + n_dense * h * h + (6 + n_dense) * h + 2 * p
    bwd_work = (3 * stream + states + (weights + 2 * B * h + grads) * 4,
                rows * (3 * mm - 2 * h * 2 * p + 24 * p + 40 * h))
    bwd_bound = _bound_ms(*bwd_work)
    # at B=32 the same work four times over
    hist_bound32 = _bound_ms(
        4 * (stream + states + 2 * hist[0].numel() * 4)
        + (h * 2 * p + 2 * h + 2 * p) * 4,
        4 * rows * (2 * h * 2 * p + 8 * p + 2 * h))
    bwd_bound32 = _bound_ms(4 * bwd_work[0], 4 * bwd_work[1])
    fwd_bound32 = _bound_ms(4 * (2 * stream + 2 * B * h * 4) + weights * 4,
                            4 * rows * (mm + 8 * p + 8 * h))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bsz in (B, 4 * B):
        print(f"K3a + K3b grids at B={bsz}, L={frames} ({sms} SMs), as "
              "launched: " + ", ".join(
                  f"{k} {v}" for kernel in grids[bsz].values()
                  for k, v in kernel.items()), flush=True)
        for kernel, mine in grids[bsz].items():
            assert mine and max(mine.values()) > bsz and (
                bsz > B or max(mine.values()) >= sms), (kernel, bsz, mine)
    from sparsernns_tpu_torch.ops.cuda import build
    for line in build.build_logs.get("layer_tail_bwd", "").splitlines():
        if "Compiling entry" in line or "registers" in line or (
                "spill" in line and " 0 bytes spill" not in line):
            print(f"nvcc layer_tail_bwd: {line.strip()}", flush=True)
    print(f"K2-train: {ms_fwd:.3f} ms at B={B} (bound {fwd_bound[0]:.4f}), "
          f"{ms_fwd32:.3f} ms at B={4 * B} (bound {fwd_bound32[0]:.4f})",
          flush=True)
    print(f"K3a: {ms_hist[B]:.3f} ms at B={B} (bound {hist_bound[0]:.4f}), "
          f"{ms_hist[4 * B]:.3f} ms at B={4 * B} (bound "
          f"{hist_bound32[0]:.4f}); K3b: {ms_bwd[B]:.3f} ms at B={B} (bound "
          f"{bwd_bound[0]:.4f}), {ms_bwd[4 * B]:.3f} ms at B={4 * B} (bound "
          f"{bwd_bound32[0]:.4f})", flush=True)
    common = dict(route="cuda", library_ms=None)
    records["layer_tail_train"] = dict(
        name="layer_tail_train",
        source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail.cu",
        replaces="sparsernns_tpu/ops/pallas/fused_layer_train.py:336",
        max_abs_err=worst["fwd"], ms=ms_fwd, plain_ms=plain_fwd,
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], ms_b32=ms_fwd32,
        bound_ms_b32=fwd_bound32[0], **common)
    records["layer_tail_hist"] = dict(
        name="layer_tail_hist",
        source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail_bwd.cu",
        replaces="sparsernns_tpu/ops/pallas/fused_layer_bwd.py:489",
        max_abs_err=hist_err, ms=ms_hist[B], plain_ms=plain_hist,
        bound_ms=hist_bound[0], bound_by=hist_bound[1],
        ms_b32=ms_hist[4 * B], bound_ms_b32=hist_bound32[0], **common)
    records["layer_tail_bwd"] = dict(
        name="layer_tail_bwd",
        source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail_bwd.cu",
        replaces="sparsernns_tpu/ops/pallas/fused_layer_bwd.py:557",
        max_abs_err=worst["bwd"], ms=ms_bwd[B], plain_ms=plain_bwd,
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        ms_b32=ms_bwd[4 * B], bound_ms_b32=bwd_bound32[0], **common)
    print(json.dumps({"training_kernel_phase": {
        k: records[k] for k in ("layer_tail_train", "layer_tail_hist",
                                "layer_tail_bwd")}}), flush=True)


def _train_batch(bsz: int):
    """(noisy, clean) audio of ``bsz`` synthetic 30 s clips on the card and
    the train step's features of them."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.train.loop import prep_ndns_batch
    ds = SyntheticNDNS(size=bsz, length=SECONDS * 16000, seed=0)
    pairs = [ds[i] for i in range(bsz)]
    noisy = torch.from_numpy(np.stack([a for a, _ in pairs])).cuda()
    clean = torch.from_numpy(np.stack([c for _, c in pairs])).cuda()
    return noisy, clean, (*prep_ndns_batch(noisy, clean), clean)


def _fresh_run(config, device="cuda"):
    """A training model of ``config`` from seed 0 and its run state."""
    from sparsernns_tpu_torch.train.loop import build_model, create_run_state
    model = build_model(config, 257, 257, training=True, device=device,
                        seed=0)
    return model, create_run_state(config, model, steps_per_epoch=2)


def _run_steps(tag, state, step, batch, n, expect, counters):
    """``n`` train steps; every step's launch counts must equal ``expect``
    (name -> count; a kernel not named: 0). Returns (state, the last
    step's counts, the steps' wall times in ms)."""
    import numpy as np
    import torch
    walls = []
    for i in range(n):
        counters()
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, *batch)
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
        counts = counters()
        loss, gn = metrics["loss"].item(), metrics["grad_norm"].item()
        print(f"{tag} step {i}: {walls[-1]:.1f} ms, loss {loss:.4f}, "
              f"si_snr {metrics['si_snr'].item():.3f} dB, grad_norm "
              f"{gn:.3f}, launches {counts}", flush=True)
        assert np.isfinite(loss) and np.isfinite(gn), metrics
        check_launches(tag, counts, expect)
    return state, counts, walls


def _card_vs_cpu_step(tag, config, noisy, clean) -> None:
    """One dropout-free train step at B=2, L=65 on the card against the
    same step on the CPU (the kernels' plain versions)."""
    from sparsernns_tpu_torch.train.loop import prep_ndns_batch
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    short = tuple(t[:2, ..., :64 * 128].contiguous() for t in (noisy, clean))

    def one_step(pair, device):
        model, state = pair
        batch = tuple(t.to(device) for t in short)
        state, metrics = make_ndns_train_step(model)(
            state, *prep_ndns_batch(*batch), batch[1])
        return metrics, model

    _grads_close(f"{tag} (plain on the CPU)", *_card_and_cpu(
        lambda device: _fresh_run(config, device), one_step))


def _learning_steps(tag, config, feats):
    """Eight dropout-free steps on one B=8 batch must lower the loss.
    Returns (state, step function, the batch, peak memory in bytes)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    model, state = _fresh_run(config)
    step = make_ndns_train_step(model)
    small = tuple(t[:B].contiguous() for t in feats)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, *small)
        torch.cuda.synchronize()
        losses.append(metrics["loss"].item())
        print(f"{tag} B={B} dropout 0 step {i}: "
              f"{(time.time() - t0) * 1e3:.1f} ms, loss {losses[-1]:.4f}",
              flush=True)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    return state, step, small, torch.cuda.max_memory_allocated()


def training_phase(cfg, records, counters, batch) -> None:
    """Phase 8: the training entry points at the recipe's settings.
    ``counters()`` returns the launch counts of every kernel by record
    name and sets them to 0; ``batch`` is ``_train_batch(cfg.bsz)``."""
    import torch

    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    from sparsernns_tpu_torch.utils.profiling import profile_region
    n_layers, bsz = cfg.n_layers, cfg.bsz
    assert (bsz, cfg.p_dropout, cfg.opt_config, cfg.weight_decay) == (
        32, 0.1, "noBCdecay", 0.04), cfg
    noisy, clean, feats = batch

    def snapshot(model):
        return ({n: p.detach().clone() for n, p in model.named_parameters()},
                {n: b.detach().clone() for n, b in model.named_buffers()
                 if "running" in n})

    # ---- three full-batch steps, then microbatch=8 (one counted step, one
    # under the profiler) ----
    model, state = _fresh_run(cfg)
    params0, stats0 = snapshot(model)
    step = make_ndns_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    state, counts, _ = _run_steps(
        f"train B={bsz}", state, step, feats, 3,
        dict.fromkeys(TAIL_KERNELS, n_layers), counters)
    peak_full = torch.cuda.max_memory_allocated()
    for name in TAIL_KERNELS:
        records[name]["launches"] = counts[name]
    frozen = {id(q) for grp in state.optimizer.param_groups
              if grp["label"] == "none" for q in grp["params"]}
    for n, q in model.named_parameters():
        assert (id(q) in frozen) == torch.equal(q, params0[n]), n
    for n, b in model.named_buffers():
        if "running" in n:
            assert not torch.equal(b, stats0[n]), n
    assert state.step == 3
    profile = profile_region(f"train step B={bsz}",
                             lambda: step(state, *feats), top=40)
    print(json.dumps(profile), flush=True)
    # the step's backward runs the passes of K3a and K3b
    _check_tail_kernels(profile)
    print(f"train B={bsz}: peak memory {peak_full / 2**20:.0f} MiB, device "
          f"busy share {profile['device_busy_share']:.3f}", flush=True)

    micro = make_ndns_train_step(model, microbatch=8)
    torch.cuda.reset_peak_memory_stats()
    state, _, _ = _run_steps(
        f"train B={bsz} microbatch=8", state, micro, feats, 1,
        dict.fromkeys(TAIL_KERNELS, n_layers * (bsz // 8)), counters)
    peak_micro = torch.cuda.max_memory_allocated()
    profile = profile_region(f"train step B={bsz} microbatch=8",
                             lambda: micro(state, *feats))
    print(json.dumps(profile), flush=True)
    print(f"train B={bsz} microbatch=8: peak memory "
          f"{peak_micro / 2**20:.0f} MiB, device busy share "
          f"{profile['device_busy_share']:.3f}", flush=True)
    del model, state, step, micro

    quiet = dataclasses.replace(cfg, p_dropout=0.0)
    _card_vs_cpu_step("train step", quiet, noisy, clean)
    state, step, small, peak_small = _learning_steps("train", quiet, feats)
    profile = profile_region(f"train step B={B}",
                             lambda: step(state, *small))
    print(json.dumps(profile), flush=True)
    print(f"train B={B}: peak memory {peak_small / 2**20:.0f} MiB, device "
          f"busy share {profile['device_busy_share']:.3f}", flush=True)


def _rel_err(out, ref) -> float:
    """max|out - ref| over max(1, max|ref|)."""
    return ((out - ref).abs().max() / max(1.0, ref.abs().max().item())).item()


def mixer_kernel_phase(layer0, cfg, frames: int, gen, records) -> None:
    """Phase 9: K1 reverse and K4a against their plain versions at
    B x frames, layer 0's operands, and at odd widths (K1 also bit for bit
    against its plan's mirror, and at B = 32); the gradient
    Functions on the card against autograd through the plain versions on
    the card (B x 1000 frames). Limits: K1 1e-5 of max|x|; K4a 1e-4 of
    max(1, max|ref|); gradients 2e-4 of max(1, max|ref|) (f32 sums over
    8000 rows in another order), and under relu_state, where a state within rounding of
    zero may pass the recompute's relu the other way, 2e-2 with at most
    1e-4 of the elements above 2e-4 (the JAX package's bar is 2e-2)."""
    import torch

    from sparsernns_tpu_torch.ops import scan
    from sparsernns_tpu_torch.ops.cuda import diag_scan, fused_s5
    dev = torch.device("cuda")
    h, p = cfg.d_model, layer0.mixer.p
    rnd = lambda *shape, sc=1.0: (  # noqa: E731
        torch.randn(shape, generator=gen) * sc).to(dev)
    with torch.no_grad():
        lam, w_b, w_c, d, _ = (
            t.contiguous() if torch.is_tensor(t) else t
            for t in layer0.mixer.layer_tail_operands())
    hs, ps, ls = 20, 12, 70
    radius = torch.rand(ps, generator=gen) * 0.39 + 0.6
    angle = torch.rand(ps, generator=gen) * 6.0 - 3.0
    odd_lam = ((radius * torch.cos(angle)).to(dev),
               (radius * torch.sin(angle)).to(dev))
    odd = (odd_lam, rnd(hs, 2 * ps, sc=0.3), rnd(2 * ps, hs, sc=0.3),
           rnd(hs))

    # ---- K1 reverse: halves of one (B, L, 2P) tensor, as the mixer's
    # backward hands them over ----
    def scan_case(tag, lam_, bu_cat, pp):
        bu = (bu_cat[..., :pp], bu_cat[..., pp:])
        with torch.no_grad():
            err = _check_k1(f"K1 reverse {tag}", lam_, bu, reverse=True)
        return bu, err

    bu, err_rev = scan_case(f"B={B}", lam, rnd(B, frames, 2 * p), p)
    scan_case(f"P={ps} L={ls}", odd_lam, rnd(2, ls, 2 * ps), ps)
    # B=32 from a generator of its own
    g32 = torch.Generator().manual_seed(324)
    bu32_cat = torch.randn((4 * B, frames, 2 * p), generator=g32).to(dev)
    bu32, _ = scan_case(f"B={4 * B}", lam, bu32_cat, p)
    with torch.no_grad():
        ms = _median_ms(lambda: diag_scan.diag_scan_cuda(lam, bu,
                                                         reverse=True))
        ms_fwd = _median_ms(lambda: diag_scan.diag_scan_cuda(lam, bu))
        ms32 = _median_ms(lambda: diag_scan.diag_scan_cuda(lam, bu32,
                                                           reverse=True))
        plain_ms = _time_ms(lambda: diag_scan.diag_scan_plain(
            lam, bu, reverse=True), 1, 0)
    del bu32_cat, bu32
    elems = B * frames * p
    bound, by = _bound_ms(_k1_bytes(B, frames, p, False), 8 * elems)
    bound32, _ = _bound_ms(_k1_bytes(4 * B, frames, p, False), 32 * elems)
    records["diag_scan_rev"] = dict(
        name="diag_scan_rev", route="cuda",
        source="sparsernns_tpu_torch/ops/cuda/csrc/diag_scan.cu",
        replaces="sparsernns_tpu/ops/pallas/scan_kernel.py:433",
        max_abs_err=err_rev, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, ms_b32=ms32, bound_ms_b32=bound32)
    print(f"K1 at B={B}, no carry: reverse {ms:.4f} ms, forward "
          f"{ms_fwd:.4f} ms (bound {bound:.4f}, {100 * bound / ms:.1f} % "
          f"reverse); reverse at B={4 * B} {ms32:.4f} ms (bound "
          f"{bound32:.4f}, {100 * bound32 / ms32:.1f} %); medians of 5",
          flush=True)

    # ---- K1's options for the bidirectional mixer's buffers: Path-X's
    # scan shape and an odd width, from generators of their own ----
    gx = torch.Generator().manual_seed(326)
    with torch.no_grad():
        worst = _check_k1_buffers(
            "K1 buffers B=32 L=16384", lam,
            torch.randn((32, 16384, 2 * p), generator=gx).to(dev))
        worst_odd = _check_k1_buffers(
            f"K1 buffers P={ps} L={ls}", odd_lam,
            torch.randn((3, ls, 2 * ps), generator=gx).to(dev))
    records["diag_scan_rev"]["buffers_dlam_ratio"] = max(worst, worst_odd)
    torch.cuda.empty_cache()

    # ---- K4a ----
    u = rnd(B, frames, h)
    errs = {}
    with torch.no_grad():
        for relu in (False, True):
            for tag, args in (("", (u, lam, w_b, w_c, d)),
                              (f"H={hs} P={ps} L={ls}",
                               (rnd(2, ls, hs), *odd))):
                ref = fused_s5.fused_s5_plain(*args, relu_state=relu)
                out = fused_s5.fused_s5_cuda(*args, relu_state=relu)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                _check(f"K4a fused_s5 relu_state={relu} {tag} vs plain", err,
                       1e-4 * max(1.0, ref.abs().max().item()))
                _check_mixer_passes(f"K4a relu_state={relu} {tag}",
                                    *args[0].shape, args[2].shape[-1] // 2)
                if not tag:
                    errs[relu] = err
                    print(f"K4a relu_state={relu} output digest: "
                          f"{_digest(out)}", flush=True)
        # a wide layer, H=640 at P=128, from a generator of its own
        gw = torch.Generator().manual_seed(640)
        rw = lambda *shape, sc=1.0: (  # noqa: E731
            torch.randn(shape, generator=gw) * sc).to(dev)
        hw = 640
        wide = (rw(2, 300, hw), lam, rw(hw, 2 * p, sc=hw ** -0.5),
                rw(2 * p, hw, sc=(2 * p) ** -0.5), rw(hw))
        ref = fused_s5.fused_s5_plain(*wide, relu_state=True)
        out = fused_s5.fused_s5_cuda(*wide, relu_state=True)
        torch.cuda.synchronize()
        _check(f"K4a fused_s5 H={hw} P={p} L=300 vs plain",
               (out - ref).abs().max().item(),
               1e-4 * max(1.0, ref.abs().max().item()))
        _check_mixer_passes(f"K4a H={hw}", 2, 300, hw, p)
        del wide, ref, out
        relu_state = layer0.mixer.relufication
        ms = _median_ms(lambda: fused_s5.fused_s5_cuda(
            u, lam, w_b, w_c, d, relu_state=relu_state))
        plain_ms = _time_ms(lambda: fused_s5.fused_s5_plain(
            u, lam, w_b, w_c, d, relu_state=relu_state), 1, 0)
        # B=32 from a generator of its own
        u32 = torch.randn((4 * B, frames, h),
                          generator=torch.Generator().manual_seed(322)).to(dev)
        ref = fused_s5.fused_s5_plain(u32, lam, w_b, w_c, d, relu_state)
        out = fused_s5.fused_s5_cuda(u32, lam, w_b, w_c, d, relu_state)
        torch.cuda.synchronize()
        _check(f"K4a fused_s5 B={4 * B} vs plain",
               (out - ref).abs().max().item(),
               1e-4 * max(1.0, ref.abs().max().item()))
        _check_mixer_passes(f"K4a B={4 * B}", 4 * B, frames, h, p)
        ms32 = _median_ms(lambda: fused_s5.fused_s5_cuda(
            u32, lam, w_b, w_c, d, relu_state=relu_state))
        del u32, ref, out
    rows = B * frames
    work = (2 * rows * h * 4, rows * (2 * h * 2 * p + 2 * 2 * p * h + 8 * p
                                      + 2 * h))
    w_bytes = (2 * h * 2 * p + h + 2 * p) * 4
    bound, by = _bound_ms(work[0] + w_bytes, work[1])
    bound32, _ = _bound_ms(4 * work[0] + w_bytes, 4 * work[1])
    print(f"K4a: {ms:.3f} ms at B={B} (bound {bound:.4f}), {ms32:.3f} ms at "
          f"B={4 * B} (bound {bound32:.4f}), medians of 5", flush=True)
    records["fused_s5"] = dict(
        name="fused_s5", route="cuda",
        source="sparsernns_tpu_torch/ops/cuda/csrc/fused_s5.cu",
        replaces="sparsernns_tpu/ops/pallas/fused_s5.py:204",
        max_abs_err=errs[relu_state], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None, ms_b32=ms32,
        bound_ms_b32=bound32)

    # ---- gradients on the card vs autograd through the plain versions ----
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    def grads_of(fn, operands, g):
        ops = [leaf(t) for t in operands]
        out = fn(*ops)
        torch.autograd.backward(out, g)
        torch.cuda.synchronize()
        return [t.grad for t in ops]

    def compare(tag, names, ours, refs, relu=False):
        worst = max(_rel_err(o, r) for o, r in zip(ours, refs))
        if not relu:
            _check(f"{tag}: worst of {names}, relative to max(1, max|ref|)",
                   worst, 2e-4)
            return
        _check(f"{tag}: worst of {names}, relative to max(1, max|ref|)",
               worst, 2e-2)
        share = max(((o - r).abs() > 2e-4 * max(1.0, r.abs().max().item()))
                    .float().mean().item() for o, r in zip(ours, refs))
        _check(f"{tag}: share of elements above 2e-4", share, 1e-4)

    # K4a's backward recomputes the forward's states through K1: its relu
    # decisions against the forward's own (K4a's output with W_c the
    # identity and d = 0 is its relu'd states; H = 2P), and K1's against
    # the sequential recurrence's, from a generator of its own
    gf = torch.Generator().manual_seed(325)
    uf = torch.randn((B, 1000, 2 * p), generator=gf).to(dev)
    wf = (torch.randn((2 * p, 2 * p), generator=gf) * (2 * p) ** -0.5).to(dev)
    with torch.no_grad():
        y_eye = fused_s5.fused_s5_cuda(
            uf, lam, wf, torch.eye(2 * p, device=dev),
            torch.zeros(2 * p, device=dev), relu_state=True)
        bu_f = uf @ wf
        k1_f = torch.cat(diag_scan.diag_scan_cuda(
            lam, (bu_f[..., :p], bu_f[..., p:])), dim=-1)
        seq_f = torch.cat(diag_scan.diag_scan_plain(
            lam, (bu_f[..., :p], bu_f[..., p:])), dim=-1)
    print(f"relu decisions flipped, B={B} L=1000 H={2 * p}: K4a forward vs "
          f"K1 recompute {int(((y_eye > 0) != (k1_f > 0)).sum().item())}, "
          f"K1 vs sequential {int(((k1_f > 0) != (seq_f > 0)).sum().item())}"
          f" of {k1_f.numel()}", flush=True)
    del uf, wf, y_eye, bu_f, k1_f, seq_f

    # at the full width over B x 1000 frames: autograd through the plain
    # loop keeps every step's state
    cut = 1000
    for reverse in (False, True):
        g = (rnd(B, cut, p), rnd(B, cut, p))
        operands = (*lam, bu[0][:, :cut], bu[1][:, :cut])
        ours = grads_of(lambda a, b_, c, e: scan.diag_ssm_scan(
            (a, b_), (c, e), reverse=reverse), operands, g)
        refs = grads_of(lambda a, b_, c, e: scan.sequential_diag_scan(
            (a, b_), (c, e), reverse=reverse)[0], operands, g)
        compare(f"DiagScanFn reverse={reverse} gradients vs plain autograd",
                "(lam_re, lam_im, bu_re, bu_im)", ours, refs)
    names = "(u, lam_re, lam_im, w_b, w_c, d)"
    for tag, relu, ops, shape in (
            (f"L={cut}", False, (u[:, :cut], *lam, w_b, w_c, d),
             (B, cut, h)),
            ("L=300", True, (u[:2, :300], *lam, w_b, w_c, d), (2, 300, h)),
            (f"H={hs} P={ps} L={ls}", True,
             (rnd(2, ls, hs), *odd_lam, *odd[1:]), (2, ls, hs))):
        g = rnd(*shape)
        ours = grads_of(lambda *a: fused_s5.FusedS5Fn.apply(
            *a, relu, None, None, None), ops, g)
        refs = grads_of(lambda a, lr, li, *w: fused_s5.fused_s5_plain(
            a, (lr, li), *w, relu_state=relu), ops, g)
        compare(f"FusedS5Fn relu_state={relu} {tag} gradients vs plain "
                "autograd", names, ours, refs, relu)
    print(json.dumps({"mixer_kernel_phase": {
        k: records[k] for k in ("diag_scan_rev", "fused_s5")}}), flush=True)


def mixer_training_phase(cfg, records, counters, batch) -> None:
    """Phase 10: training and eval on the mixer route at the recipe's
    width: the postnorm model (the unfused layer around K4a, whose
    backward runs K1 both ways), then the bidirectional model (K1 both
    ways in the forward and in the backward)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.train.steps import (make_ndns_eval_step,
                                                  make_ndns_train_step)
    from sparsernns_tpu_torch.utils.profiling import profile_region
    n_layers, bsz = cfg.n_layers, cfg.bsz
    post = dataclasses.replace(cfg, prenorm=False)
    noisy, clean, feats = batch

    # ---- postnorm: three B=32 steps with dropout, one eval step ----
    model, state = _fresh_run(post)
    assert not model.encoder.layers[0].prenorm
    step = make_ndns_train_step(model)
    per_step = {"fused_s5": n_layers, "diag_scan": n_layers,
                "diag_scan_rev": n_layers}
    torch.cuda.reset_peak_memory_stats()
    state, counts, walls = _run_steps(f"postnorm train B={bsz}", state, step,
                                      feats, 3, per_step, counters)
    peak = torch.cuda.max_memory_allocated()
    records["fused_s5"]["launches"] = counts["fused_s5"]
    records["diag_scan_rev"]["launches"] = counts["diag_scan_rev"]
    profile = profile_region(f"postnorm train step B={bsz}",
                             lambda: step(state, *feats), top=24)
    print(json.dumps(profile), flush=True)
    print(f"postnorm train B={bsz}: peak memory {peak / 2**20:.0f} MiB, "
          f"device busy share {profile['device_busy_share']:.3f}",
          flush=True)
    eval_step = make_ndns_eval_step(model)
    small = tuple(t[:B].contiguous() for t in feats)
    eval_step(*small)                                   # warm-up
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = eval_step(*small)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    print(f"postnorm eval step B={B}: {wall:.1f} ms, loss "
          f"{metrics['loss'].item():.4f}, launches {counts}", flush=True)
    assert np.isfinite(metrics["loss"].item()) and model.training
    check_launches("postnorm eval step", counts, {"fused_s5": n_layers})
    del model, state, step, eval_step

    quiet = dataclasses.replace(post, p_dropout=0.0)
    _card_vs_cpu_step("postnorm train step", quiet, noisy, clean)
    state, step, small, peak_small = _learning_steps("postnorm train", quiet,
                                                     feats)
    profile = profile_region(f"postnorm train step B={B}",
                             lambda: step(state, *small))
    print(json.dumps(profile), flush=True)
    print(f"postnorm train B={B}: peak memory {peak_small / 2**20:.0f} MiB, "
          f"device busy share {profile['device_busy_share']:.3f}",
          flush=True)
    del state, step

    # ---- bidirectional: two B=8 steps, scans both ways, inside the
    # projections' buffers (ops/scan.BiDiagScanFn) ----
    bidir = dataclasses.replace(cfg, bidirectional=True)
    model, state = _fresh_run(bidir)
    assert hasattr(model.encoder.layers[0].mixer, "C1")
    step = make_ndns_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    # each layer's mixer on the buffers route, forward and backward
    state, _, _ = _run_steps(
        f"bidirectional train B={B}", state, step, small, 2,
        {"diag_scan": 2 * n_layers, "diag_scan_rev": 2 * n_layers,
         "bidir_buffers": 2 * n_layers}, counters)
    peak_bi = torch.cuda.max_memory_allocated()
    profile = profile_region(f"bidirectional train step B={B}",
                             lambda: step(state, *small))
    print(json.dumps(profile), flush=True)
    print(f"bidirectional train B={B}: peak memory {peak_bi / 2**20:.0f} "
          f"MiB, device busy share {profile['device_busy_share']:.3f}",
          flush=True)
    del model, state, step
    counters()
    _card_vs_cpu_step("bidirectional train step",
                      dataclasses.replace(bidir, p_dropout=0.0), noisy, clean)
    moved = counters()
    print(f"bidirectional train step, card and CPU: mixer passes by route "
          f"{moved['bidir_buffers']} buffers, {moved['bidir_unfused']} "
          "unfused", flush=True)
    assert (moved["bidir_buffers"], moved["bidir_unfused"]) == (
        2 * 2 * n_layers, 0), moved

def _codes_of(name, out, ref, scale) -> float:
    """States on a frozen grid of ``scale``: every state the kernel wrote
    lies on the grid (its code times ``scale``, exactly); codes at most 1
    apart in at most 0.5 % of the elements (a requant can flip at a tie
    between two summation orders); where the codes agree, the states within
    1e-5 of max|ref|. Returns the largest absolute difference."""
    import torch
    q_out, q_ref = torch.round(out / scale), torch.round(ref / scale)
    _check(f"{name}: distance of the kernel's states from the grid",
           (out - q_out * scale).abs().max().item(), 0.0)
    _code_diff(name, q_out, q_ref)
    diff = (out - ref).abs()
    same = q_out == q_ref
    _check(f"{name}: states where the codes agree",
           diff[same].max().item() if bool(same.any()) else 0.0,
           1e-5 * ref.abs().max().item())
    return diff.max().item()


def _kernel_close(name, out, ref) -> float:
    """A serving-mode kernel against its plain version: max 1e-5 of
    max(1, max|ref|), the bar of the CPU tests against the JAX kernels."""
    err = (out.float() - ref.float()).abs().max().item()
    _check(name, err, 1e-5 * max(1.0, ref.abs().max().item()))
    return err


def _engine_close(name, out, ref) -> float:
    """The engine bar: max 2e-3, mean 1e-4 of max(1, max|ref|); also
    prints the share of elements above 1e-5 of it."""
    diff = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.abs().max().item())
    share = (diff > 1e-5 * scale).float().mean().item()
    print(f"{name}: share above 1e-5 x max(1, |ref|): {share:.2e}",
          flush=True)
    _check(f"{name} (max)", diff.max().item(), 2e-3 * scale)
    _check(f"{name} (mean)", diff.mean().item(), 1e-4 * scale)
    return diff.max().item()


def _topk_close(name, out, ref, limit) -> None:
    """Outputs of two top-k models: elementwise within ``limit``, but for
    at most 0.5 % of the elements, where a top-k selection flipped at a
    near-tie between two summation orders (such an element moves by up to
    the threshold). Prints the count."""
    diff = (out.float() - ref.float()).abs()
    over = int((diff > limit).sum().item())
    share = over / diff.numel()
    print(f"{name}: max_abs_err {diff.max().item():.3e}, {over} of "
          f"{diff.numel()} elements above {limit:.1e} (flips; limit 0.5 %)",
          flush=True)
    if share > 5e-3:
        raise AssertionError(f"{name}: {share} of the elements differ")


def topk_kernel_phase(cfg, engine, x_eng, frames, gen, records,
                      frozen) -> None:
    """Phase 11: K1 with the block requant (forward, from a carry, and
    reverse with its blocks from the end; also at B = 32), K4a's engine
    modes and K4b
    against their plain versions on the card at B x frames, full width,
    layer 1 of the flagship w8a16 engine (int8 weights, per-half scales,
    16-bit state grid), and K4a with that layer's dequantized f32 weights
    on a 32-bit state grid (the ``w32a32`` mode); states on the grid,
    codes at most 1 apart in at most 0.5 %, outputs 1e-5 of max(1,
    max|ref|); chunked K4b at chunk = block against one K4a-engine call
    (exact); the flagship engine's per-op route forced against its stack
    route at float32 activations (engine bar)."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import diag_scan, engine_layer, fused_s5
    from sparsernns_tpu_torch.utils.trace import launch_counts as ledger
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    dev = torch.device("cuda")
    lay = engine.layers[1]
    h, p = lay.w_b.shape[0], lay.p
    s_re, s_im, bits = lay.state_requant
    block = 512
    rnd = lambda *shape, sc=1.0: (  # noqa: E731
        torch.randn(shape, generator=gen) * sc).to(dev)
    # a realistic mixer input: the first layer's input stream of the batch
    u32 = (x_eng @ engine.encoder_kernel.dequant() + engine.encoder_bias)
    u32 = (u32 * lay.norm_w + lay.norm_b).contiguous()
    u16 = u32.to(torch.bfloat16)
    ops = (lay.lam, lay.w_b, lay.w_c, lay.d)
    # the engine's fragments: the B- and C-projections on the tensor cores
    assert engine.tensor_cores and lay.wb_frags is not None
    kw = dict(wb_scales=lay.wb_scales, wc_scales=lay.wc_scales,
              block_requant=lay.state_requant,
              frags=(lay.wb_frags, lay.wc_frags))
    rows = B * frames
    with torch.no_grad():
        # ---- K1 block requant: no carry, then from a carry on the grid ----
        bu = u32 @ lay.wb_f32()
        bu = (bu[..., :p], bu[..., p:])
        carry = tuple(torch.round(rnd(B, p, sc=200.0)) * s
                      for s in (s_re, s_im))
        k1 = {}
        for tag, c, rev in (("no carry", None, False), ("carry", carry, False),
                            ("reverse", None, True)):
            k1[tag] = _check_k1(f"K1 block requant {tag} B={B}", lay.lam,
                                bu, c, rev, lay.state_requant, block)
        # B=32: the batch's stream four times
        bu32 = tuple(x.repeat(4, 1, 1) for x in bu)
        for tag, rev in (("no carry", False), ("reverse", True)):
            _check_k1(f"K1 block requant {tag} B={4 * B}", lay.lam, bu32,
                      None, rev, lay.state_requant, block)
        ms = _median_ms(lambda: diag_scan.diag_scan_cuda(
            lay.lam, bu, None, False, lay.state_requant, block))
        ms_rev = _median_ms(lambda: diag_scan.diag_scan_cuda(
            lay.lam, bu, None, True, lay.state_requant, block))
        ms32 = _median_ms(lambda: diag_scan.diag_scan_cuda(
            lay.lam, bu32, None, False, lay.state_requant, block))
        plain_ms = _time_ms(lambda: diag_scan.diag_scan_plain(
            lay.lam, bu, None, False, lay.state_requant, block), 1, 0)
        del bu32
        elems = B * frames * p
        bound, by = _bound_ms(_k1_bytes(B, frames, p, False), 18 * elems)
        bound32, _ = _bound_ms(_k1_bytes(4 * B, frames, p, False),
                               72 * elems)
        print(f"K1 block requant at B={B}: {ms:.4f} ms, reverse "
              f"{ms_rev:.4f} ms (bound {bound:.4f}, {100 * bound / ms:.1f} "
              f"%); B={4 * B} {ms32:.4f} ms (bound {bound32:.4f}, "
              f"{100 * bound32 / ms32:.1f} %); medians of 5", flush=True)
        records["diag_scan_requant"] = dict(
            name="diag_scan_requant", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/diag_scan.cu",
            replaces="sparsernns_tpu/ops/pallas/scan_kernel.py:433",
            max_abs_err=max(k1.values()), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None, ms_rev=ms_rev,
            ms_b32=ms32, bound_ms_b32=bound32)

        # ---- K4a engine modes: bf16 / f32 input, relu_state off / on ----
        errs = {}
        for name, u in (("bf16", u16), ("f32", u32)):
            for relu in (False, True):
                ref = fused_s5.fused_s5_engine_plain(
                    u, *ops, block_t=block, relu_state=relu, **kw)
                out = fused_s5.fused_s5_engine_cuda(
                    u, *ops, block_t=block, relu_state=relu, **kw)
                torch.cuda.synchronize()
                errs[(name, relu)] = _kernel_close(
                    f"K4a engine u {name} relu_state={relu} vs plain", out,
                    ref)
                _check_mixer_passes(f"K4a engine u {name} relu_state={relu}",
                                    *u.shape, p)
                _check_dots(f"K4a engine u {name} relu_state={relu}",
                            engine_layer.read_launched_dots("fused_s5"),
                            fused_s5.launched(), True, 2)
                if (name, relu) == ("bf16", False):
                    print(f"K4a engine u bf16 output digest: {_digest(out)}",
                          flush=True)
        hs, ps, ls = 20, 12, 70
        odd_w_b = torch.randint(-127, 128, (hs, 2 * ps), generator=gen,
                                dtype=torch.int8).to(dev)
        odd_w_c = torch.randint(-127, 128, (2 * ps, hs), generator=gen,
                                dtype=torch.int8).to(dev)
        radius = torch.rand(ps, generator=gen) * 0.39 + 0.6
        angle = torch.rand(ps, generator=gen) * 6.0 - 3.0
        odd = ((radius * torch.cos(angle)).to(dev),
               (radius * torch.sin(angle)).to(dev))
        odd_kw = dict(wb_scales=(2.0 ** -8, 2.0 ** -9),
                      wc_scales=(2.0 ** -7, 2.0 ** -8),
                      block_requant=(2.0 ** -10, 2.0 ** -11, 16))
        u_odd = rnd(2, ls, hs).to(torch.bfloat16)
        args = (u_odd, odd, odd_w_b, odd_w_c, rnd(hs))
        odd_frags = (engine_layer.mma_fragments(odd_w_b),
                     engine_layer.mma_fragments(odd_w_c))
        _kernel_close(f"K4a engine H={hs} P={ps} L={ls} block 16 vs plain",
                      fused_s5.fused_s5_engine_cuda(*args, block_t=16,
                                                    relu_state=True,
                                                    frags=odd_frags,
                                                    **odd_kw),
                      fused_s5.fused_s5_engine_plain(*args, block_t=16,
                                                     relu_state=True,
                                                     **odd_kw))
        _check_mixer_passes(f"K4a engine H={hs} P={ps} L={ls}", 2, ls, hs, ps)
        # the w32a32 mode: f32 weights without scales, a 32-bit grid
        kw32 = dict(block_requant=(s_re * 2.0 ** -16, s_im * 2.0 ** -16, 32))
        args32 = (u32, lay.lam, lay.wb_f32().contiguous(),
                  lay.wc_f32().contiguous(), lay.d)
        _kernel_close("K4a engine f32 weights, 32-bit state grid vs plain",
                      fused_s5.fused_s5_engine_cuda(*args32, block_t=block,
                                                    **kw32),
                      fused_s5.fused_s5_engine_plain(*args32, block_t=block,
                                                     **kw32))
        _check_mixer_passes("K4a engine f32 weights, 32-bit state grid", B,
                            frames, h, p)
        ms = _median_ms(lambda: fused_s5.fused_s5_engine_cuda(
            u16, *ops, block_t=block, **kw))
        plain_ms = _time_ms(lambda: fused_s5.fused_s5_engine_plain(
            u16, *ops, block_t=block, **kw), 1, 0)
        # B=32: a random input of the same spread, from a generator of its
        # own
        u32b = (torch.randn((4 * B, frames, h),
                            generator=torch.Generator().manual_seed(323))
                .to(dev) * u32.std()).to(torch.bfloat16)
        _kernel_close(f"K4a engine u bf16 B={4 * B} vs plain",
                      fused_s5.fused_s5_engine_cuda(u32b, *ops,
                                                    block_t=block, **kw),
                      fused_s5.fused_s5_engine_plain(u32b, *ops,
                                                     block_t=block, **kw))
        _check_mixer_passes(f"K4a engine B={4 * B}", 4 * B, frames, h, p)
        ms32 = _median_ms(lambda: fused_s5.fused_s5_engine_cuda(
            u32b, *ops, block_t=block, **kw))
        row_flops = 2 * h * 2 * p + 2 * 2 * p * h + 22 * p + 2 * h
        w_bytes = 2 * h * 2 * p + 4 * (h + 2 * p)
        bound, by = _bound_ms(rows * h * (2 + 4) + w_bytes,
                              rows * row_flops)
        bound32, _ = _bound_ms(4 * rows * h * (2 + 4) + w_bytes,
                               4 * rows * row_flops)
        print(f"K4a engine: {ms:.3f} ms at B={B} (bound {bound:.4f}), "
              f"{ms32:.3f} ms at B={4 * B} (bound {bound32:.4f})",
              flush=True)
        records["fused_s5_engine"] = dict(
            name="fused_s5_engine", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/fused_s5.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_s5.py:204",
            max_abs_err=errs[("bf16", False)], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None, ms_b32=ms32,
            bound_ms_b32=bound32)

        # ---- K4b: one 128-frame block from a carry on the grid ----
        ub = u16[:, :STREAM_BLOCK].contiguous()
        ref, ref_c = fused_s5.fused_s5_engine_plain(
            ub, *ops, block_t=STREAM_BLOCK, carry=carry, **kw)
        out, out_c = fused_s5.fused_s5_engine_cuda(
            ub, *ops, block_t=STREAM_BLOCK, carry=carry, **kw)
        torch.cuda.synchronize()
        err = _kernel_close("K4b one 128-frame block vs plain", out, ref)
        for half, o, r, sc in zip(("re", "im"), out_c, ref_c, (s_re, s_im)):
            _codes_of(f"K4b carry out {half}", o, r, sc)
        _check_mixer_passes("K4b one 128-frame block", B, STREAM_BLOCK, h, p)
        print(f"K4b output digest: {_digest(out)}, carry "
              f"{_digest(out_c[0])} {_digest(out_c[1])}", flush=True)
        ms = _median_ms(lambda: fused_s5.fused_s5_engine_cuda(
            ub, *ops, block_t=STREAM_BLOCK, carry=carry, **kw))
        ub32 = u32b[:, :STREAM_BLOCK].contiguous()
        carry32 = tuple(c.repeat(4, 1) for c in carry)
        ms32 = _median_ms(lambda: fused_s5.fused_s5_engine_cuda(
            ub32, *ops, block_t=STREAM_BLOCK, carry=carry32, **kw))
        del u32b, ub32
        plain_ms = _time_ms(lambda: fused_s5.fused_s5_engine_plain(
            ub, *ops, block_t=STREAM_BLOCK, carry=carry, **kw), 1, 0)
        s_rows = B * STREAM_BLOCK
        bound, by = _bound_ms(s_rows * h * (2 + 4) + w_bytes + 4 * B * p * 4,
                              s_rows * row_flops)
        bound32, _ = _bound_ms(4 * (s_rows * h * (2 + 4) + 4 * B * p * 4)
                               + w_bytes, 4 * s_rows * row_flops)
        print(f"K4b: {ms:.3f} ms at B={B} (bound {bound:.5f}), {ms32:.3f} "
              f"ms at B={4 * B} (bound {bound32:.5f})", flush=True)
        records["fused_s5_engine_carry"] = dict(
            name="fused_s5_engine_carry", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/fused_s5.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_s5.py:290",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None, ms_b32=ms32, bound_ms_b32=bound32)

        # ---- chunked K4b at chunk = block == one K4a-engine call ----
        n = (frames // STREAM_BLOCK) * STREAM_BLOCK
        whole = fused_s5.fused_s5_engine_cuda(
            u16[:, :n].contiguous(), *ops, block_t=STREAM_BLOCK, **kw)
        c = tuple(torch.zeros((B, p), device=dev) for _ in range(2))
        parts = []
        for t0 in range(0, n, STREAM_BLOCK):
            y, c = fused_s5.fused_s5_engine_cuda(
                u16[:, t0:t0 + STREAM_BLOCK].contiguous(), *ops,
                block_t=STREAM_BLOCK, carry=c, **kw)
            parts.append(y)
        _check(f"K4b x {n // STREAM_BLOCK} chunks vs one K4a-engine call",
               (torch.cat(parts, dim=1) - whole).abs().max().item(), 0.0)

    # ---- the flagship engine's per-op route vs its stack route ----
    f32_engine = engine_from_frozen(cfg, *frozen, device=dev, block_t=512,
                                    act_dtype=torch.float32)
    stack = f32_engine._apply_stack(x_eng, 512)
    f32_engine._stack_ok = False
    before = ledger()["fused_s5_engine"]
    per_op = f32_engine(x_eng)
    torch.cuda.synchronize()
    assert ledger()["fused_s5_engine"] - before == len(engine.layers)
    _engine_close("flagship engine per-op route vs stack route (f32 act)",
                  per_op, stack)
    print(json.dumps({"topk_kernel_phase": {
        k: records[k] for k in ("diag_scan_requant", "fused_s5_engine",
                                "fused_s5_engine_carry")}}), flush=True)


def _timed_region(tag, fn, expect, counters):
    """One warm call after a warm-up: wall time, launches (asserted
    exactly: name -> count, a kernel not named 0), peak memory, then one
    profiled call. Returns (the warm call's result, its counts)."""
    import torch

    from sparsernns_tpu_torch.utils.profiling import profile_region
    fn()
    counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check_launches(tag, counts, expect)
    prof = profile_region(tag, fn, top=12)
    print(json.dumps(prof), flush=True)
    print(f"{tag}: {wall:.1f} ms, peak memory {peak:.0f} MiB, device "
          f"busy share {prof['device_busy_share']:.3f}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return out, counts


def topk_serving_phase(cfg, audio, feats, records, counters) -> None:
    """Phase 12: the recipe with ``topk=0.5, approx_topk=true`` at full
    width, random weights from seed 0: the float eval step (K1 x 3, no K2,
    no K4a) and a 30-chunk float stream (K1 x 3 a forward); calibrate,
    freeze and serve the w8a16 engine (bf16): offline (K4a-engine x 3, no
    K5, no K6), streaming from the engine at block 128 (K4b x 3 a
    forward); the relufied model's engine offline (K1 block requant x 3,
    no K4a) and its refusal to stream chunks."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.steps import make_ndns_eval_step
    from sparsernns_tpu_torch.utils.profiling import profile_region
    dev = torch.device("cuda")
    n_layers = cfg.n_layers
    noisy, clean_t = audio
    noisy_mag, noisy_phase, clean_mag = feats
    frames = noisy_mag.shape[-1]
    tk = dataclasses.replace(cfg, topk=0.5, approx_topk=True)
    x_eng = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()

    def timed(tag, fn, expect):
        return _timed_region(tag, fn, expect, counters)

    # ---- float top-k model: eval step and 30-chunk stream ----
    model = build_model(tk, 257, 257, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in model.encoder.layers:
            h = layer.d_model
            layer.norm.running_mean.copy_(0.1 * torch.randn(h, generator=gen))
            layer.norm.running_var.copy_(0.5 + torch.rand(h, generator=gen))
    step = make_ndns_eval_step(model)
    metrics, _ = timed(f"topk float eval step B={B}",
                       lambda: step(noisy_mag, noisy_phase, clean_mag,
                                    clean_t), {"diag_scan": n_layers})
    assert np.isfinite(metrics["loss"].item()), metrics
    with torch.no_grad():
        x_small = x_eng[:2, :200]
        cpu_model = build_model(tk, 257, 257, device="cpu", seed=0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        _topk_close("topk float forward, GPU vs CPU plain",
                    model(x_small).cpu(), cpu_model(x_small.cpu()), 1e-3)
        y_stream, _ = model.forward_stream(x_eng[:, :1000], None)
        _topk_close("topk stream forward vs offline forward",
                    y_stream, model(x_eng[:, :1000]), 1e-3)
    den = StreamingDenoiser(model, batch_size=B)
    forwards = [0]
    inner = den._forward

    def counting(frames_mag):
        forwards[0] += 1
        return inner(frames_mag)

    den._forward = counting
    counters()
    t0 = time.time()
    out = den.process_offline(noisy, chunk_samples=CHUNK)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    print(f"topk float streaming: {forwards[0]} forwards in {wall:.1f} ms "
          f"({wall / forwards[0]:.1f} ms a forward), launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    assert np.isfinite(out).all()
    assert forwards[0] >= -(-noisy.shape[1] // CHUNK) - 1, forwards
    assert counts == {**{k: 0 for k in counts},
                      "diag_scan": n_layers * forwards[0]}, counts
    del step, cpu_model

    # ---- calibrate, freeze, the top-k engine (bf16) offline ----
    cal_ds_audio = torch.from_numpy(noisy[:, :CAL_SECONDS * 16000]).to(dev)
    cal_x = (stft_splitter(cal_ds_audio)[0] - STFT_MAG_MEAN).transpose(1, 2)
    recipe = quantization_recipes[cfg.convert_quantization]

    def calibrated(run_cfg, float_model):
        t0 = time.time()
        cal_model = build_model(
            run_cfg, 257, 257, device=dev, seed=0, scan_mode="sequential",
            q_config=recipe(static_quant=True, calibrating=True))
        frozen = calibrate(cal_model, float_model.state_dict(),
                           [cal_x[:B // 2], cal_x[B // 2:]])
        print(f"calibrate 2 x {B // 2} clips of {CAL_SECONDS} s and freeze: "
              f"{time.time() - t0:.1f} s", flush=True)
        return frozen

    frozen = calibrated(tk, model)
    engine = engine_from_frozen(tk, *frozen, device=dev, block_t=512)
    assert not engine._stack_ok and engine.cfg.topk == 0.5
    mask, counts = timed(f"topk engine offline call B={B}",
                         lambda: engine(x_eng),
                         {"fused_s5_engine": n_layers})
    records["fused_s5_engine"]["launches"] = counts["fused_s5_engine"]
    assert mask.shape == (B, frames, 257) and torch.isfinite(mask).all()
    cpu_engine = engine_from_frozen(tk, *frozen, device="cpu", block_t=512)
    ref = cpu_engine(x_small.cpu())
    _topk_close("topk engine on the card vs on the CPU (plain)",
                engine(x_small).cpu(), ref,
                2e-3 * max(1.0, ref.abs().max().item()))

    # ---- streaming from the top-k engine at block 128 (K4b) ----
    stream_engine = engine_from_frozen(tk, *frozen, device=dev,
                                       block_t=STREAM_BLOCK)
    eden = StreamingDenoiser.from_engine(stream_engine, batch_size=B)
    chunk_calls, chunk_frames = [0], [0]
    inner_chunk = stream_engine.process_chunk

    def counting_chunk(x, carries=None):
        chunk_calls[0] += 1
        chunk_frames[0] += x.shape[1]
        return inner_chunk(x, carries)

    stream_engine.process_chunk = counting_chunk
    counters()
    t0 = time.time()
    out_eng = eden.process_offline(noisy, chunk_samples=CHUNK)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    records["fused_s5_engine_carry"]["launches"] = counts[
        "fused_s5_engine_carry"]
    print(f"topk engine streaming: {chunk_calls[0]} forwards of "
          f"{STREAM_BLOCK}-frame blocks in {wall:.1f} ms "
          f"({wall / chunk_calls[0]:.1f} ms a forward), launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    assert np.isfinite(out_eng).all()
    assert chunk_frames[0] == eden._frames_done >= frames - STREAM_BLOCK, (
        chunk_frames, eden._frames_done)
    assert counts == {**{k: 0 for k in counts}, "fused_s5_engine_carry":
                      n_layers * chunk_calls[0]}, counts
    pos = [0]

    def one_forward():
        eden.process(noisy[:, pos[0]:pos[0] + STREAM_BLOCK * eden.hop])
        pos[0] += STREAM_BLOCK * eden.hop

    eden.reset()
    for _ in range(4):
        one_forward()
    prof = profile_region("topk engine streaming forward (128-frame block)",
                          one_forward, top=8)
    print(json.dumps(prof), flush=True)
    del engine, stream_engine, eden, cpu_engine

    # ---- the relufied top-k model: state top-k, K1 block requant ----
    rk = dataclasses.replace(tk, relufication=True)
    r_model = build_model(rk, 257, 257, device=dev, seed=0)
    r_model.load_state_dict(model.state_dict())
    r_frozen = calibrated(rk, r_model)
    r_engine = engine_from_frozen(rk, *r_frozen, device=dev, block_t=512)
    assert r_engine._state_topk()
    r_mask, counts = timed(f"relufied topk engine offline call B={B}",
                           lambda: r_engine(x_eng),
                           {"diag_scan_requant": n_layers})
    records["diag_scan_requant"]["launches"] = counts["diag_scan_requant"]
    assert r_mask.shape == (B, frames, 257) and torch.isfinite(r_mask).all()
    r_cpu = engine_from_frozen(rk, *r_frozen, device="cpu", block_t=512)
    ref = r_cpu(x_small.cpu())
    _topk_close("relufied topk engine on the card vs on the CPU (plain)",
                r_engine(x_small).cpu(), ref,
                2e-3 * max(1.0, ref.abs().max().item()))
    try:
        r_engine.process_chunk(x_eng[:, :512])
    except NotImplementedError as exc:
        print(f"relufied topk engine process_chunk refuses: {exc}",
              flush=True)
    else:
        raise AssertionError("state top-k process_chunk must raise")


def _bs_weight(rng, k, n, zero_share, kept=None, dtype="int8"):
    """A (k, n) weight of ``dtype`` (int8, int16 or float32) whose (32,
    128) tiles are zero but for a ``1 - zero_share`` share (or the (input,
    output) tiles ``kept``)."""
    import numpy as np
    kt, nt = -(-k // 32), -(-n // 128)
    if kept is None:
        tiles = [(i, j) for i in range(kt) for j in range(nt)]
        rng.shuffle(tiles)
        kept = tiles[int(zero_share * len(tiles)):]
    w = np.zeros((k, n), dtype)
    hi = {"int8": 127, "int16": 32767}.get(dtype)
    for i, j in kept:
        blk = w[i * 32:(i + 1) * 32, j * 128:(j + 1) * 128]
        blk[...] = (rng.randn(*blk.shape) if hi is None
                    else rng.randint(-hi, hi + 1, size=blk.shape))
    return w


def _bs_work(w, m: int, x_dtype):
    """(bytes, bf16 tensor-core flops) that y = x @ w needs over its kept
    tiles only: the x columns of the input tiles that some kept tile uses,
    the kept tiles, the (m, N) f32 output; 2 flops per multiply-add of each
    kept tile's valid rows and columns, once for every pair of exact bf16
    planes the product needs (``block_sparse.n_planes`` of the tile, three
    of f32 x; pad blocks of empty output tiles do no work)."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import block_sparse as bs
    k_dim, n_dim = w.shape
    ks = w.blk_k.tolist()
    real = [(k, j) for k, j, t in zip(ks, w.blk_j.tolist(), w.data)
            if bool(t.any())]
    rows = lambda k: min(w.bk, k_dim - k * w.bk)       # noqa: E731
    cols = lambda j: min(w.bn, n_dim - j * w.bn)       # noqa: E731
    x_cols = sum(rows(k) for k in {k for k, _ in real})
    x_bytes = 2 if x_dtype == torch.bfloat16 else 4
    n_bytes = (m * x_cols * x_bytes + w.data.numel() * w.data.element_size()
               + m * n_dim * 4)
    pairs = (1 if x_bytes == 2 else 3) * bs.n_planes(x_dtype, w.data.dtype)
    return n_bytes, pairs * sum(2 * m * rows(k) * cols(j) for k, j in real)


def _graph_ms(fn, calls: int = 20, iters: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    CUDA events around its replay, over ``calls``; median of ``iters``
    (the host's launch time drops out)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return sorted(times)[len(times) // 2]


def _host_us(fn, calls: int = 1000) -> float:
    """Host time of one call, ``time.perf_counter`` over ``calls`` calls
    without a sync (where the card is slower, the launch queue's
    back-pressure is in it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def block_sparse_kernel_phase(frames: int, records) -> None:
    """Phase 13: K7 against its plain version on the card at M = B x
    frames rows, the flagship's three serving shapes (encoder 257 -> 192,
    GLU gate 192 -> 192, decoder 192 -> 257), int8 tiles with 90 % and
    50 % of the (32, 128) tiles zero, x float32 and bf16; the encoder at
    90 % with both kept tiles in output tile 0 (output tile 1 fully zero,
    K = 257: an edge tile), also with int16 and f32 tiles and at the chunk
    shape M = B x 128. Bar 1e-5 x max(1, max|ref|); an exact-grid case
    (bf16 x of small integers, small integer weights) must be exact. Each
    launch as the CUDA source recorded it against ``launch_plan``; the
    tiles' planes (made when the weight is packed) against their plain
    mirror ``tile_planes``, bit for bit. Times: device (a CUDA graph of 20
    calls), event (one call, median of 5), host µs a call (1000 calls, no
    sync), ``torch.matmul`` of x with the dequantized dense weight (TF32
    off, median of 5), the plain version once."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.cuda import block_sparse as bs
    dev = torch.device("cuda")
    m = B * frames
    rng = np.random.RandomState(13)
    gen = torch.Generator().manual_seed(13)
    x32 = {k: torch.randn((m, k), generator=gen).to(dev) for k in (192, 257)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [(name, k, n, zero, "int8", m)
            for name, k, n in (("encoder", 257, 192), ("gate", 192, 192),
                               ("decoder", 192, 257))
            for zero in (0.9, 0.5)]
    rows += [("encoder", 257, 192, 0.9, dtype, m)
             for dtype in ("int16", "float32")]
    rows += [("encoder", 257, 192, 0.9, "int8", B * STREAM_BLOCK)]
    table, worst = [], 0.0
    with torch.no_grad():
        for name, k, n, zero, dtype, rows_m in rows:
            kept = ([(0, 0), (8, 0)] if (name, zero) == ("encoder", 0.9)
                    else None)
            q = _bs_weight(rng, k, n, zero, kept, dtype)
            w = bs.pack_block_sparse(
                q, 32, 128, device=dev,
                scale={"int8": 2.0 ** -7, "int16": 2.0 ** -15}.get(dtype))
            dense = w.dequant()
            for x_name, x in (("f32", x32[k][:rows_m]),
                              ("bf16", x32[k][:rows_m].to(torch.bfloat16))):
                ref = bs.block_sparse_matmul_plain(x, w)
                out = bs.block_sparse_matmul_cuda(x, w)
                torch.cuda.synchronize()
                err = _kernel_close(
                    f"K7 {name} {k}->{n} {zero:.0%} zero {dtype} tiles, x "
                    f"{x_name}, M={rows_m} vs plain", out, ref)
                worst = max(worst, err)
                planes = bs.n_planes(x.dtype, w.data.dtype)
                plan = bs.launch_plan(rows_m, n, x.dtype == torch.bfloat16,
                                      planes, sms)
                got = bs.launched()
                assert got == dict(ctas=plan.ctas, bm=plan.bm,
                                   stages=plan.stages, smem=plan.smem), (
                    got, plan)
                assert plan.smem == bs.smem_on_card(
                    x.dtype == torch.bfloat16, planes, plan.bm, plan.stages)
                mirror = torch.stack(bs.tile_planes(
                    w.data.reshape(-1, 32, 128), x.dtype), dim=1)
                assert torch.equal(w.kernel.planes[x.dtype].view(torch.int16),
                                   mirror.view(torch.int16)), (name, dtype)

                def call(x=x, w=w):
                    return bs.block_sparse_matmul_cuda(x, w)
                row = dict(
                    shape=f"{k}->{n}", zero_tiles=zero, tiles=dtype,
                    x=x_name, m=rows_m, nnz=w.nnz, max_abs_err=err,
                    launch=got, device_ms=_graph_ms(call),
                    ms=_median_ms(call), host_us=_host_us(call),
                    plain_ms=_time_ms(lambda x=x, w=w:
                                      bs.block_sparse_matmul_plain(x, w),
                                      1, 0),
                    library_ms=_median_ms(lambda x=x, d=dense: torch.matmul(
                        x.float(), d)))
                n_bytes, tc_flops = _bs_work(w, rows_m, x.dtype)
                row["bound_ms"], row["bound_by"] = _bound_ms(
                    n_bytes, 0.0, bf16_flops=tc_flops)
                print(f"K7 {name} {k}->{n} {zero:.0%} {dtype} x {x_name} "
                      f"M={rows_m}: {row}", flush=True)
                table.append(row)
        # exact grid: every product and every sum an integer below 2^24
        xi = torch.randint(-8, 9, (m, 257), generator=gen).to(
            dev, torch.bfloat16)
        qi = _bs_weight(rng, 257, 192, 0.5)
        qi = np.clip(qi, -3, 3).astype(np.int8)
        wi = bs.pack_block_sparse(qi, 32, 128, device=dev)
        _check("K7 exact grid (bf16 integer x, small integer tiles)",
               (bs.block_sparse_matmul_cuda(xi, wi)
                - bs.block_sparse_matmul_plain(xi, wi)).abs().max().item(),
               0.0)
    print(json.dumps({"block_sparse_kernel_phase": table}), flush=True)
    # the record: the encoder at 90 % with f32 x, as the engine feeds it
    main_row = table[0]
    records["block_sparse"] = dict(
        name="block_sparse", route="cuda",
        source="sparsernns_tpu_torch/ops/cuda/csrc/block_sparse.cu",
        replaces="sparsernns_tpu/ops/pallas/block_sparse.py:143",
        max_abs_err=worst, ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"])


def _tiles_zero(w: "np.ndarray") -> tuple:
    """(zero tiles, tiles) of a (K, N) kernel in (32, 128) tiles."""
    import numpy as np
    k, n = w.shape
    kt, nt = -(-k // 32), -(-n // 128)
    pad = np.zeros((kt * 32, nt * 128), bool)
    pad[:k, :n] = w != 0
    nz = pad.reshape(kt, 32, nt, 128).any(axis=(1, 3))
    return int((~nz).sum()), kt * nt


def pruned_serving_phase(cfg, audio, feats, batch, records,
                         counters) -> None:
    """Phase 14: tile-pruned training and block-sparse serving of the
    flagship. The recipe with ``pruning="iterative-ste-block-0.9"`` at 4
    epochs of 2 steps (mask updates from step 0): three B = 32 train steps
    with the mask update before each (K2, K3a, K3b x 3 a step), then the
    update at ``update_end`` (90 %: every dense kernel at least 83 % zero
    tiles); masks applied, calibrate 2 x 4 clips of 4 s, freeze; the w8a16
    engine (bf16) offline (K7 x 5, K4a-engine x 3, no K5/K6) and
    ``process_chunk`` at block 128 (K7 x 5, K4b x 3 a chunk; float32
    mask), chunks against one whole call, the card against the CPU engine;
    an engine with dense GLU kernels and a block-sparse encoder and decoder
    on the stack route (K7 x 2, K5a x 3) against its per-op route; three
    B = 32 steps of ``recipes/ndns_sparse.json`` (``iterative-ste-mag-0.9``,
    K2/K3 on masked weights) and its weight sparsity."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.pruning import (masked_state_dict,
                                                    summarize_sparsity)
    from sparsernns_tpu_torch.train.steps import (make_mask_update_fn,
                                                  make_ndns_train_step)
    from sparsernns_tpu_torch.utils.profiling import profile_region
    from sparsernns_tpu_torch.weights import to_flax
    dev = torch.device("cuda")
    n_layers = cfg.n_layers
    noisy, _ = audio
    noisy_mag = feats[0]
    frames = noisy_mag.shape[-1]
    x_eng = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()

    def pruned_steps(tag, run_cfg):
        """Three B = 32 steps with the mask update before each; returns
        the model and its state."""
        model, state = _fresh_run(run_cfg)
        assert state.pruner is not None, run_cfg.pruning
        step = make_ndns_train_step(model)
        update = make_mask_update_fn(state.pruner)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state, _, walls = _run_steps(
            tag, state, lambda st, *b: step(update(st), *b), batch[2], 3,
            dict.fromkeys(TAIL_KERNELS, n_layers), counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = profile_region(f"{tag}, one step",
                              lambda: step(update(state), *batch[2]))
        print(json.dumps(prof), flush=True)
        print(f"{tag}: {(time.time() - t0) * 1e3:.1f} ms for 3 steps and "
              f"one profiled, peak memory {peak:.0f} MiB, device busy share "
              f"{prof['device_busy_share']:.3f}", flush=True)
        return model, state

    # ---- tile-pruned training of the flagship ----
    bcfg = dataclasses.replace(cfg, epochs=4,
                               pruning="iterative-ste-block-0.9")
    model, state = pruned_steps(f"block-pruned train B={cfg.bsz}", bcfg)
    pcfg = state.pruner.cfg
    assert (pcfg.update_start, pcfg.update_end, pcfg.update_freq) == (0, 7, 1)
    state.pruner.update_masks(model, state.masks, pcfg.update_end)
    keys = {"encoder": "['encoder']['encoder']['kernel']",
            "decoder": "['decoder']['kernel']"}
    for i in range(n_layers):
        keys[f"layers_{i}/out2"] = f"['encoder']['layers_{i}']['out2']['kernel']"
    # a kernel's mask is (out, in) like its nn.Linear weight; tiles are
    # (32, 128) of the (in, out) kernel
    zero_tiles = {name: _tiles_zero(state.masks[key].T.cpu().numpy())
                  for name, key in keys.items()}
    print(f"block-pruned zero tiles (zero, of): {zero_tiles}; weight "
          f"sparsity {summarize_sparsity(model, state.masks)['_total_sparsity']:.4f}",
          flush=True)
    for name, (zero, total) in zero_tiles.items():
        assert zero >= 0.83 * total, (name, zero, total)

    # ---- masks applied, calibrate, freeze ----
    t0 = time.time()
    cal_audio = torch.from_numpy(noisy[:, :CAL_SECONDS * 16000]).to(dev)
    cal_x = (stft_splitter(cal_audio)[0] - STFT_MAG_MEAN).transpose(1, 2)
    recipe = quantization_recipes[cfg.convert_quantization]
    cal_model = build_model(
        bcfg, 257, 257, device=dev, seed=0, scan_mode="sequential",
        q_config=recipe(static_quant=True, calibrating=True))
    frozen = calibrate(cal_model, masked_state_dict(model, state.masks),
                       [cal_x[:B // 2], cal_x[B // 2:]])
    print(f"calibrate 2 x {B // 2} clips of {CAL_SECONDS} s and freeze: "
          f"{time.time() - t0:.1f} s", flush=True)

    # ---- the block-sparse engine offline: K7 x 5, K4a-engine x 3 ----
    engine = engine_from_frozen(bcfg, *frozen, device=dev, block_t=512)
    print(f"dense_blocks (kept, tiles): {engine.dense_blocks}", flush=True)
    assert len(engine.dense_blocks) == n_layers + 2, engine.dense_blocks
    assert not engine._stack_ok and not engine._network_ok
    mask, counts = _timed_region(
        f"block-sparse engine offline call B={B}", lambda: engine(x_eng),
        {"block_sparse": n_layers + 2, "fused_s5_engine": n_layers},
        counters)
    records["block_sparse"]["launches"] = counts["block_sparse"]
    assert mask.shape == (B, frames, 257) and torch.isfinite(mask).all()
    x_small = x_eng[:2, :200]
    cpu_engine = engine_from_frozen(bcfg, *frozen, device="cpu",
                                    block_t=512)
    _engine_close("block-sparse engine on the card vs on the CPU (plain)",
                  engine(x_small).cpu(), cpu_engine(x_small.cpu()))
    _k7_code_flips(engine, x_eng)

    # ---- process_chunk at block 128: K7 x 5, K4b x 3 a chunk ----
    s_engine = engine_from_frozen(bcfg, *frozen, device=dev,
                                  block_t=STREAM_BLOCK)
    n = (frames // STREAM_BLOCK) * STREAM_BLOCK
    carries, parts = None, []
    counters()
    t0 = time.time()
    for start in range(0, n, STREAM_BLOCK):
        part, carries = s_engine.process_chunk(
            x_eng[:, start:start + STREAM_BLOCK], carries)
        parts.append(part)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    chunks = n // STREAM_BLOCK
    print(f"block-sparse engine process_chunk: {chunks} chunks of "
          f"{STREAM_BLOCK} frames in {wall:.1f} ms ({wall / chunks:.2f} ms "
          f"a chunk), launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    assert counts == {**{k: 0 for k in counts},
                      "block_sparse": (n_layers + 2) * chunks,
                      "fused_s5_engine_carry": n_layers * chunks}, counts
    assert all(p.dtype == torch.float32 for p in parts)
    bf_part, _ = s_engine.process_chunk(
        x_eng[:, :STREAM_BLOCK].to(torch.bfloat16))
    assert bf_part.dtype == torch.float32, bf_part.dtype
    _engine_close("block-sparse process_chunk chunks vs one whole call",
                  torch.cat(parts, dim=1), s_engine(x_eng[:, :n]))
    x_chunk = x_eng[:, :STREAM_BLOCK]
    _timed_region(f"block-sparse engine process_chunk B={B}",
                  lambda: s_engine.process_chunk(x_chunk),
                  {"block_sparse": n_layers + 2,
                   "fused_s5_engine_carry": n_layers}, counters)
    del engine, s_engine, cpu_engine

    # ---- dense GLU, block-sparse encoder and decoder: the stack route ----
    dense_glu = copy.deepcopy(frozen[0])
    trained, _ = to_flax(model)
    for i in range(n_layers):
        dense_glu["encoder"][f"layers_{i}"]["out2"]["kernel"] = trained[
            "encoder"][f"layers_{i}"]["out2"]["kernel"]
    st_engine = engine_from_frozen(bcfg, dense_glu, frozen[1], device=dev,
                                   block_t=512, act_dtype=torch.float32)
    assert set(st_engine.dense_blocks) == {"encoder", "decoder"}
    assert st_engine._stack_ok and not st_engine._network_ok
    stack, _ = _timed_region(
        f"block-sparse enc/dec engine, stack route B={B}",
        lambda: st_engine(x_eng),
        {"block_sparse": 2, "engine_layer": n_layers}, counters)
    st_engine._stack_ok = False
    _engine_close("block-sparse enc/dec engine: stack route vs per-op route",
                  stack, st_engine(x_eng))
    del st_engine, model, state

    # ---- the unstructured recipe: masked weights through K2 / K3 ----
    root = os.path.dirname(os.path.abspath(__file__))
    scfg = dataclasses.replace(
        cfg.with_recipe(os.path.join(root, "recipes", "ndns_sparse.json")),
        epochs=4)
    assert scfg.pruning == "iterative-ste-mag-0.9" and scfg.relufication
    s_model, s_state = pruned_steps(f"ndns_sparse train B={scfg.bsz}", scfg)
    print(f"ndns_sparse after 3 steps: weight_sparsity "
          f"{summarize_sparsity(s_model, s_state.masks)['_total_sparsity']:.4f}",
          flush=True)


def _k7_code_flips(engine, x) -> None:
    """The requant code flips that K7's rounding causes, against the same
    engine with K7's plain version (``block_sparse_matmul_plain`` on the
    card). The encoder (K7) runs on the call's input with K7 and with
    plain K7, and its outputs' codes on the stream's grid (the encoder's
    output requant where the engine has one, else the grid the first
    layer's residual requant puts the stream on) are compared. The
    offline call runs once with plain K7, recording every layer's input
    and output; then each layer runs again with K7 on the input the plain
    run gave it (its GLU dense is K7), and its residual stream's codes
    are compared with the plain run's. The encoder's codes, and all the
    codes together, must be at most 1 apart in at most 0.5 % of the
    elements (the engine's code bar); each share is printed. The whole
    call with K7 is printed beside it: there a flip upstream moves the
    later layers' inputs, so its codes are reported, not held (the mask
    is held at the engine bar against the CPU engine above)."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import block_sparse
    from sparsernns_tpu_torch.quantize import engine as engine_mod
    from sparsernns_tpu_torch.utils.trace import launch_counts as ledger
    layer_fwd = engine_mod.engine_layer_forward
    matmul = engine_mod.block_sparse_matmul
    plain_matmul = block_sparse.block_sparse_matmul_plain

    def run(plain: bool):
        calls = []

        def record(*args, **kw):
            h, carry = layer_fwd(*args, **kw)
            calls.append((args, kw, h))
            return h, carry
        engine_mod.engine_layer_forward = record
        if plain:
            engine_mod.block_sparse_matmul = plain_matmul
        try:
            mask = engine(x)
        finally:
            engine_mod.engine_layer_forward = layer_fwd
            engine_mod.block_sparse_matmul = matmul
        return calls, mask

    def codes(h, layer):
        return (h / layer.residual_requant[0]).round()

    def encode():
        return engine_mod.engine_encode(
            engine.cfg, engine.encoder_kernel, engine.encoder_bias,
            engine._input(x).to(torch.float32), engine.encoder_in_scale)

    with torch.no_grad():
        assert isinstance(engine.encoder_kernel,
                          engine_mod.BlockSparseWeight)
        grid = engine.encoder_out_requant or engine.layers[0].residual_requant
        before = ledger()["block_sparse"]
        enc = encode()
        assert ledger()["block_sparse"] == before + 1
        engine_mod.block_sparse_matmul = plain_matmul
        try:
            enc_ref = encode()
        finally:
            engine_mod.block_sparse_matmul = matmul
        diff = ((enc / grid[0]).round() - (enc_ref / grid[0]).round()).abs()
        enc_flips, enc_worst = int((diff > 0).sum()), diff.max().item()
        enc_share = enc_flips / diff.numel()
        print(f"K7 code flips, encoder (the call's input): {enc_flips} of "
              f"{diff.numel()} ({100 * enc_share:.5f} %), max "
              f"{enc_worst:.0f}", flush=True)
        (ref, ref_mask), (ours, mask) = run(True), run(False)
        assert len(ref) == len(ours) == len(engine.layers)
        flips, total, worst = enc_flips, diff.numel(), enc_worst
        for i, ((args, kw, h_ref), layer) in enumerate(zip(ref,
                                                           engine.layers)):
            h, _ = layer_fwd(*args, **kw)      # K7 on the plain input
            diff = (codes(h, layer) - codes(h_ref, layer)).abs()
            whole = (codes(ours[i][2], layer) - codes(h_ref, layer)).abs()
            n = int((diff > 0).sum())
            worst = max(worst, diff.max().item())
            flips += n
            total += diff.numel()
            print(f"K7 code flips, layer {i} (its plain input): {n} of "
                  f"{diff.numel()} ({100 * n / diff.numel():.5f} %), max "
                  f"{diff.max().item():.0f}; whole call: "
                  f"{100 * (whole > 0).float().mean().item():.4f} %, max "
                  f"{whole.max().item():.0f}", flush=True)
    share = flips / total
    print(f"K7 code flips against plain K7 on the card: {flips} of {total} "
          f"stream codes ({100 * share:.5f} %), max {worst:.0f}; whole "
          f"call's mask max |diff| {(mask - ref_mask).abs().max().item():.3e}",
          flush=True)
    assert worst <= 1 and share <= 5e-3, (worst, share)
    assert enc_worst <= 1 and enc_share <= 5e-3, (enc_worst, enc_share)


def _qat_steps(ref, t: int, bits: int, reverse: bool = False):
    """absmax/qmax of each (batch row, time block) of ``ref`` (B, L, P),
    blocks aligned as the QAT scan aligns them (from the end when
    reversed); the last, padded block takes its row's absmax."""
    import torch
    x = ref.flip(1) if reverse else ref
    b, length, _ = x.shape
    steps = torch.empty_like(x[..., :1])
    row_max = x.abs().amax(dim=(1, 2), keepdim=True)
    for j in range(0, length, t):
        blk = x[:, j:j + t] if j + t <= length else None
        steps[:, j:j + t] = (row_max if blk is None else
                             blk.abs().amax(dim=(1, 2), keepdim=True))
    steps = steps / (2.0 ** (bits - 1) - 1)
    return steps.flip(1) if reverse else steps


def _states_close(name, out, ref, steps) -> float:
    """The quantized-state bar: at most 0.5 % of the elements differ by
    more than 1e-6·max(1, |ref|), and none by more than two grid steps of
    its block (``steps``, broadcastable). Returns the largest difference."""
    diff = (out - ref).abs()
    floor = 1e-6 * ref.abs().clamp(min=1.0)
    share = (diff > floor).float().mean().item()
    excess = (diff - 2.0 * steps - floor).max().item()
    print(f"{name}: max_abs_err {diff.max().item():.3e}, share above "
          f"1e-6 x max(1, |ref|) {share:.2e} (limit 5e-3), largest excess "
          f"over two grid steps {excess:.3e} (limit 0)", flush=True)
    if share > 5e-3 or excess > 0:
        raise AssertionError(f"{name}: share {share}, excess {excess}")
    return diff.max().item()


def _qat_mixer_operands(mixer, u):
    """The QAT mixer's kernel operands of one layer, as its forward makes
    them: fake-quantized u, W_b and W_c halves (conj-sym 2 folded in), D,
    and the global state absmax of its stats pass."""
    import torch

    from sparsernns_tpu_torch.quantize.qat import fake_quant
    q = mixer.q_config
    with torch.no_grad():
        lam, b_bar = mixer.discretized()
        w_b = mixer._w_b(b_bar).contiguous()
        u_q = fake_quant(u, q.ssm_act_precision)
        return (u_q, lam, w_b, mixer._w_c().contiguous(),
                fake_quant(mixer.D, q.d_precision),
                mixer._global_state_absmax(u_q, lam, w_b))


def _region_kernels(profile) -> int:
    """Kernel launches in a profiled region, the window's opening fill
    aside (``profile_region`` asks for enough top rows to list all)."""
    return sum(k["count"] for k in profile["top_kernels"]
               if "Fill" not in k["name"])


def _check_qat_launches(name: str, plan, mixer_rows=None) -> None:
    """The last K1 qat / K4a qat call launched the plan's kernels, with its
    grids and cluster shapes, as the CUDA source recorded them."""
    from sparsernns_tpu_torch.ops.cuda import qat_scan
    got = qat_scan.launched()
    print(f"{name} launches (kernel, CTAs, cluster, shared memory bytes): "
          f"{got}", flush=True)
    want = plan.launches(mixer_rows)
    assert [g[:3] for g in got] == want, (name, got, want)
    assert len(got) <= (3 if mixer_rows is None else 5), got


def _tables_vs_torch(lam, t: int, a_bits) -> str:
    """The tables kernel's λ tables against ``lambda_power_tables`` on the
    card: "equal", or the first differing entry, its size in ulps and
    where it arises (the unquantized carry-fold table, a_bits None, tells
    the math functions' values from the fake-quant's)."""
    import numpy as np

    from sparsernns_tpu_torch.ops.cuda import qat_scan
    n_pass = max(1, (t - 1).bit_length())
    names = ("pow_re", "pow_im", "ctab_re", "ctab_im")

    def first_diff(bits):
        got = qat_scan.tables_cuda(lam, t, n_pass, bits)
        ref = qat_scan.lambda_power_tables(lam, t, n_pass, bits)
        for name, g, r in zip(names, got, ref):
            idx = (g != r).nonzero()
            if len(idx):
                i = tuple(idx[0].tolist())
                gi, ri = (np.array([x[i].item()], np.float32).view(np.int32)
                          for x in (g, r))
                return (f"{name}{list(i)} kernel {g[i].item()!r} torch "
                        f"{r[i].item()!r} ({abs(int(gi[0]) - int(ri[0]))} "
                        f"ulps, {len(idx)} of {g.numel()} entries)")
        return None

    diff = first_diff(a_bits)
    if diff is None:
        return "equal"
    raw = first_diff(None)
    return diff + ("; unquantized tables equal: the fake-quant's rounding"
                   if raw is None else f"; unquantized first: {raw} "
                   "(the CUDA math functions against PyTorch's kernels)")


def qat_kernel_phase(cfg, frames: int, gen, records) -> None:
    """Phase 15: K1 and K4a in their QAT modes against their plain
    versions at B=8, L=3751, H=192, P=128 with the w8a16 recipe's bits
    (16, 16). The λ tables kernel against ``lambda_power_tables`` (bit for
    bit, or the first differing entry and its cause). K1 at t=1024
    forward, reverse and from a carry, with the block requant (with and
    without a carry, and reverse: codes on the frozen grid), at t=256 and
    at the
    largest block the plan takes, and one odd width (L not a multiple of
    t); K4a at t=512, per-block and global scale, relu_state off and on,
    with layer 0's QAT operands of the flagship, and its states alone (W_c
    the identity, d = 0) over a B-projection that is exact in any
    summation order, at t=256 and the largest block, over int8 weights with
    per-half scales and the block requant, and one odd width. Every call's
    launches (grids, cluster shapes) from the CUDA source's record against
    the plan, the scan's residency, medians of 5 timed calls (K4a also at
    B=32) beside the plain version's time, the bound and a profile of one
    call (at most 3 kernels for K1 qat, 5 for K4a qat)."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import engine_layer, fused_s5, qat_scan
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.utils.profiling import profile_region
    dev = torch.device("cuda")
    bits = (16, 16)
    grid16 = (2.0 ** -8, 2.0 ** -9, 16)
    qcfg = dataclasses.replace(cfg, quantization="w8a16", block_t=512)
    mixer = build_model(qcfg, 257, 257, device=dev, seed=0
                        ).encoder.layers[0].mixer
    h, p = cfg.d_model, mixer.p
    t_max = qat_scan.max_block(p)
    rnd = lambda *shape, sc=1.0: (  # noqa: E731
        torch.randn(shape, generator=gen) * sc).to(dev)
    with torch.no_grad():
        lam, _ = mixer.discretized()
        lam = tuple(x.contiguous() for x in lam)

    # ---- the λ tables kernel against the PyTorch ops ----
    tables = {}
    with torch.no_grad():
        for t in (256, 512, 1024):
            for a_bits in (16, 8):
                tables[f"t={t} a_bits={a_bits}"] = _tables_vs_torch(
                    lam, t, a_bits)
    print(f"QAT tables kernel vs lambda_power_tables: {tables}", flush=True)

    # ---- K1: halves of one (B, L, 2P) projection, as the mixer gives ----
    bu_cat = rnd(B, frames, 2 * p)
    bu = (bu_cat[..., :p], bu_cat[..., p:])
    carry = (rnd(B, p), rnd(B, p))
    errs, equal = {}, {}
    with torch.no_grad():
        for tag, t, kw in (
                ("forward", 1024, {}), ("reverse", 1024, dict(reverse=True)),
                ("carry", 1024, dict(carry_init=carry)),
                ("forward", 256, {}), ("forward", t_max, {}),
                ("requant", 1024, dict(block_requant=grid16)),
                ("requant carry", 1024,
                 dict(block_requant=grid16, carry_init=carry)),
                ("requant reverse", 1024,
                 dict(block_requant=grid16, reverse=True))):
            ref = qat_scan.qat_scan_plain(lam, bu, bits, t, **kw)
            out = qat_scan.qat_scan_cuda(lam, bu, bits, t, **kw)
            torch.cuda.synchronize()
            name = f"K1 qat {tag} t={t}"
            plan = qat_scan.qat_plan(B, frames, p, t)
            _check_qat_launches(name, plan)
            if t == 1024 and (B, frames) == (8, 3751):
                assert plan.ctas >= 256, plan
            equal[name] = all(torch.equal(o, r) for o, r in zip(out, ref))
            if "requant" in tag:
                errs[name] = max(_codes_of(
                    f"{name} vs plain ({half})", o, r, s)
                    for half, o, r, s in zip(("re", "im"), out, ref, grid16))
                continue
            rev = tag == "reverse"
            blk = min(t, -(-frames // 8) * 8)
            errs[name] = max(_states_close(
                f"{name} vs plain ({half})", o, r,
                _qat_steps(r, blk, bits[1], rev))
                for half, o, r in zip(("re", "im"), out, ref))
        ps, ls = 12, 70
        radius = torch.rand(ps, generator=gen) * 0.05 + 0.94
        angle = torch.rand(ps, generator=gen) * 6.0 - 3.0
        odd_lam = ((radius * torch.cos(angle)).to(dev),
                   (radius * torch.sin(angle)).to(dev))
        odd_bu = (rnd(2, ls, ps), rnd(2, ls, ps))
        for rev in (False, True):
            ref = qat_scan.qat_scan_plain(odd_lam, odd_bu, (8, 8), 32,
                                          reverse=rev)
            out = qat_scan.qat_scan_cuda(odd_lam, odd_bu, (8, 8), 32,
                                         reverse=rev)
            for o, r in zip(out, ref):
                _states_close(f"K1 qat P={ps} L={ls} t=32 (8, 8) "
                              f"reverse={rev} vs plain", o, r,
                              _qat_steps(r, 32, 8, rev))
        print(f"K1 qat bit-equal to plain on the card: {equal}", flush=True)
        plan = qat_scan.qat_plan(B, frames, p, 1024)
        print(f"K1 qat t=1024 scan: {plan.n_clusters} clusters of "
              f"{plan.cluster} CTAs ({plan.ctas} CTAs, {plan.smem} bytes of "
              f"shared memory a CTA), at most "
              f"{qat_scan.max_active_clusters(plan)} clusters resident",
              flush=True)
        ms = _median_ms(lambda: qat_scan.qat_scan_cuda(lam, bu, bits, 1024))
        plain_ms = _median_ms(lambda: qat_scan.qat_scan_plain(
            lam, bu, bits, 1024), 1)
        ms_rev = _median_ms(lambda: qat_scan.qat_scan_cuda(
            lam, bu, bits, 1024, reverse=True))
    elems = B * frames * p
    n_pass = max(1, (1024 - 1).bit_length())
    bound, by = _bound_ms(2 * elems * 4 * 2 + 2 * p * 4,
                          8 * elems * (n_pass + 1))
    records["qat_scan"] = dict(
        name="qat_scan", route="cuda",
        source="sparsernns_tpu_torch/ops/cuda/csrc/qat_scan.cu",
        replaces="sparsernns_tpu/ops/pallas/scan_kernel.py:406",
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"K1 qat at B={B}, t=1024: forward {ms:.3f} ms, reverse "
          f"{ms_rev:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
          f"({by}), {100 * bound / ms:.1f} % of the bound", flush=True)
    prof = profile_region(
        "K1 qat t=1024, one call (the tables kernel, the scan)",
        lambda: qat_scan.qat_scan_cuda(lam, bu, bits, 1024), top=8)
    print(json.dumps(prof), flush=True)
    assert _region_kernels(prof) <= 3, prof

    # ---- K4a: layer 0's QAT operands of the flagship ----
    u_q, lam_q, w_b, w_c, d, g_amax = _qat_mixer_operands(
        mixer, rnd(B, frames, h))
    state_step = g_amax.item() / (2.0 ** (bits[1] - 1) - 1)
    col = w_c.abs().sum(dim=0).max().item()
    rows8 = engine_layer.pass_plan(B, frames, h, p, 1, encoder=False
                                   ).row_ctas
    k4a = {}
    with torch.no_grad():
        for t, scale, relu in ((512, None, False), (512, None, True),
                               (512, g_amax, False), (512, g_amax, True),
                               (256, None, False), (t_max, None, False)):
            args = (u_q, lam_q, w_b, w_c, d, bits, t, relu, scale)
            ref = fused_s5.fused_s5_qat_plain(*args)
            out = fused_s5.fused_s5_qat_cuda(*args)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            top = max(1.0, ref.abs().max().item())
            share = (diff > 1e-4 * top).float().mean().item()
            kind = "per-block" if scale is None else "global"
            tag = f"K4a qat t={t} {kind} scale relu_state={relu}"
            _check_qat_launches(tag, qat_scan.qat_plan(B, frames, p, t),
                                rows8)
            print(f"{tag} vs plain: share above 1e-4 x max(1, max|ref|) "
                  f"{share:.2e}, bit-equal {torch.equal(out, ref)}",
                  flush=True)
            # a state code the two B-projection sums round apart moves
            # the row's outputs by a state step times W_c's weights
            _check(f"{tag} vs plain", diff.max().item(),
                   2 * 4 * state_step * col + 1e-4 * top)
            k4a[(t, scale is None, relu)] = diff.max().item()
        # the states alone over an exact B-projection: the same codes
        hs = 2 * p
        u_x = (torch.randint(-16, 17, (B, frames, hs), generator=gen) / 8.0
               ).to(dev)
        wb_x = (torch.randint(-8, 9, (hs, 2 * p), generator=gen) / 32.0
                ).to(dev)
        eye = torch.eye(hs, device=dev)
        zero = torch.zeros(hs, device=dev)
        for scale in (None, torch.full((), 40.0, device=dev)):
            args = (u_x, lam_q, wb_x, eye, zero, bits, 512, False, scale)
            ref = fused_s5.fused_s5_qat_plain(*args)
            out = fused_s5.fused_s5_qat_cuda(*args)
            if scale is None:
                kind = "per-block"
                steps = torch.cat(
                    [_qat_steps(ref[..., :p], 512, 16).expand(-1, -1, p),
                     _qat_steps(ref[..., p:], 512, 16).expand(-1, -1, p)],
                    dim=-1)
            else:
                kind, steps = "global", scale.item() / 32767.0
            _states_close(f"K4a qat states, {kind} scale, exact "
                          "B-projection, vs plain", out, ref, steps)
        # int8 weights with per-half scales and the block requant: the
        # states alone (the int8 identity, unit scales) on the frozen grid,
        # then the output at random int8 weights
        i8 = lambda *s: torch.randint(-127, 128, s, generator=gen,  # noqa
                                      dtype=torch.int8).to(dev)
        wb8, wc8 = i8(h, 2 * p), i8(2 * p, h)
        sc8 = (2.0 ** -10, 2.0 ** -11)
        eye8 = torch.eye(hs, dtype=torch.int8, device=dev)
        kw = dict(wb_scales=sc8, wc_scales=(1.0, 1.0), block_requant=grid16)
        args = (rnd(B, frames, hs), lam_q, i8(hs, 2 * p), eye8, zero, bits,
                512, True)
        ref = fused_s5.fused_s5_qat_plain(*args, **kw)
        out = fused_s5.fused_s5_qat_cuda(*args, **kw)
        for half, sl, s in (("re", slice(0, p), grid16[0]),
                            ("im", slice(p, 2 * p), grid16[1])):
            _codes_of(f"K4a qat int8 scales requant relu, states ({half}) "
                      "vs plain", out[..., sl], ref[..., sl], s)
        kw = dict(wb_scales=sc8, wc_scales=sc8, block_requant=grid16)
        args = (rnd(B, frames, h), lam_q, wb8, wc8, d, bits, 512, True)
        ref = fused_s5.fused_s5_qat_plain(*args, **kw)
        out = fused_s5.fused_s5_qat_cuda(*args, **kw)
        _check_qat_launches("K4a qat int8 scales requant",
                            qat_scan.qat_plan(B, frames, p, 512), rows8)
        col8 = (wc8.abs().float() * torch.tensor(
            [sc8[0] * grid16[0]] * p + [sc8[1] * grid16[1]] * p,
            device=dev)[:, None]).sum(dim=0).max().item()
        top = max(1.0, ref.abs().max().item())
        k4a["int8"] = (out - ref).abs().max().item()
        _check("K4a qat t=512 int8 scales requant relu vs plain",
               k4a["int8"], 2 * col8 + 1e-4 * top)
        odd = (rnd(2, 45, 20), odd_lam, rnd(20, 2 * ps, sc=0.3),
               rnd(2 * ps, 20, sc=0.3), rnd(20))
        ref = fused_s5.fused_s5_qat_plain(*odd, (8, 8), 16, True)
        out = fused_s5.fused_s5_qat_cuda(*odd, (8, 8), 16, True)
        _check(f"K4a qat H=20 P={ps} L=45 t=16 (8, 8) relu vs plain",
               (out - ref).abs().max().item(),
               2e-2 * max(1.0, ref.abs().max().item()))
        plan = qat_scan.qat_plan(B, frames, p, 512)
        print(f"K4a qat t=512 scan: {plan.n_clusters} clusters of "
              f"{plan.cluster} CTAs ({plan.ctas} CTAs), at most "
              f"{qat_scan.max_active_clusters(plan, mixer=True)} resident",
              flush=True)
        ms = _median_ms(lambda: fused_s5.fused_s5_qat_cuda(
            u_q, lam_q, w_b, w_c, d, bits, 512))
        ms_glob = _median_ms(lambda: fused_s5.fused_s5_qat_cuda(
            u_q, lam_q, w_b, w_c, d, bits, 512, False, g_amax))
        plain_ms = _median_ms(lambda: fused_s5.fused_s5_qat_plain(
            u_q, lam_q, w_b, w_c, d, bits, 512), 1)
        u32 = torch.cat([u_q] * 4)
        ms32 = _median_ms(lambda: fused_s5.fused_s5_qat_cuda(
            u32, lam_q, w_b, w_c, d, bits, 512))
        ms32_glob = _median_ms(lambda: fused_s5.fused_s5_qat_cuda(
            u32, lam_q, w_b, w_c, d, bits, 512, False, g_amax))
        _check_qat_launches(
            "K4a qat t=512 B=32", qat_scan.qat_plan(4 * B, frames, p, 512),
            engine_layer.pass_plan(4 * B, frames, h, p, 1,
                                   encoder=False).row_ctas)
        del u32
    n_pass = max(1, (512 - 1).bit_length())

    def k4a_bound(batch):
        rows = batch * frames
        return _bound_ms(
            2 * rows * h * 4 + (2 * h * 2 * p + h + 2 * p) * 4,
            rows * (2 * h * 2 * p + 2 * 2 * p * h + 8 * p * (n_pass + 1)
                    + 2 * h))

    bound, by = k4a_bound(B)
    records["fused_s5_qat"] = dict(
        name="fused_s5_qat", route="cuda",
        source="sparsernns_tpu_torch/ops/cuda/csrc/qat_scan.cu",
        replaces="sparsernns_tpu/ops/pallas/fused_s5.py:204",
        max_abs_err=k4a[(512, True, False)], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None)
    bound32 = k4a_bound(4 * B)[0]
    print(f"K4a qat at B={B}, t=512: per-block {ms:.3f} ms, global scale "
          f"{ms_glob:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
          f"({by}), {100 * bound / ms:.1f} % of the bound; B={4 * B}: "
          f"per-block {ms32:.3f} ms, global {ms32_glob:.3f} ms, bound "
          f"{bound32:.4f} ms, {100 * bound32 / ms32:.1f} %", flush=True)
    prof = profile_region(
        "K4a qat t=512, one call (tables, head pass, scan, tail pass)",
        lambda: fused_s5.fused_s5_qat_cuda(u_q, lam_q, w_b, w_c, d, bits,
                                           512), top=8)
    print(json.dumps(prof), flush=True)
    assert _region_kernels(prof) <= 5, prof
    print(json.dumps({"qat_kernel_phase": {
        k: records[k] for k in ("qat_scan", "fused_s5_qat")}}), flush=True)


def qat_training_phase(cfg, audio, feats, batch, frozen, records,
                       counters) -> None:
    """Phase 16: quantization-aware training and training with top-k at
    the flagship's width. The recipe with ``quantization="w8a16"`` and
    ``block_t=512``: three B=32 steps with dropout (per step K4a qat x 3,
    K1 x 3 forward and x 3 reverse in the backward, no K2/K3), three with
    ``qat_global_scales`` (K1 x 3 more forward, the stats pass), one step
    on the card against the CPU, eight dropout-free B=8 steps that must
    lower the loss, one eval step (K4a qat x 3), a 30-chunk QAT stream
    (K1 qat x 3 a forward; three chunks against the CPU); the global-scale
    and per-block forwards against the associative QAT forward on the
    card (printed, not held); three B=32 steps of the top-k recipe (K1 x 3
    each way); and the ``w32a32`` engine's offline call (per-op route,
    K4a-engine x 3) against the CPU engine at the engine bar, timed."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.steps import (make_ndns_eval_step,
                                                  make_ndns_train_step)
    from sparsernns_tpu_torch.utils.profiling import profile_region
    n_layers, bsz = cfg.n_layers, cfg.bsz
    noisy, clean = audio
    noisy_mag, _, _ = feats
    tr_noisy, tr_clean, tr_feats = batch
    qcfg = dataclasses.replace(cfg, quantization="w8a16", block_t=512)
    per_step = {"fused_s5_qat": n_layers, "diag_scan": n_layers,
                "diag_scan_rev": n_layers}

    # ---- three B=32 QAT steps, per-block and global scales ----
    for tag, run_cfg, expect in (
            ("QAT", qcfg, per_step),
            ("QAT global scales",
             dataclasses.replace(qcfg, qat_global_scales=True),
             dict(per_step, diag_scan=2 * n_layers))):
        model, state = _fresh_run(run_cfg)
        assert model.encoder.layers[0].mixer.layer_tail_operands() is None
        step = make_ndns_train_step(model)
        torch.cuda.reset_peak_memory_stats()
        state, counts, _ = _run_steps(f"{tag} train B={bsz}", state, step,
                                      tr_feats, 3, expect, counters)
        peak = torch.cuda.max_memory_allocated()
        if tag == "QAT":
            records["fused_s5_qat"]["launches"] = counts["fused_s5_qat"]
        profile = profile_region(f"{tag} train step B={bsz}",
                                 lambda: step(state, *tr_feats), top=16)
        print(json.dumps(profile), flush=True)
        print(f"{tag} train B={bsz}: peak memory {peak / 2**20:.0f} MiB, "
              f"device busy share {profile['device_busy_share']:.3f}, "
              f"{profile['device_events']} device events a step", flush=True)
        del model, state, step

    quiet = dataclasses.replace(qcfg, p_dropout=0.0)
    _card_vs_cpu_step("QAT train step", quiet, tr_noisy, tr_clean)
    state, step, small, peak_small = _learning_steps("QAT train", quiet,
                                                     tr_feats)
    print(f"QAT train B={B}: peak memory {peak_small / 2**20:.0f} MiB",
          flush=True)
    model = state.model
    eval_step = make_ndns_eval_step(model)
    eval_step(*small)                                   # warm-up
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = eval_step(*small)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    print(f"QAT eval step B={B}: {wall:.1f} ms, loss "
          f"{metrics['loss'].item():.4f}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    assert np.isfinite(metrics["loss"].item())
    check_launches("QAT eval step", counts, {"fused_s5_qat": n_layers})
    profile = profile_region(f"QAT eval step B={B}",
                             lambda: eval_step(*small), top=12)
    print(json.dumps(profile), flush=True)
    print(f"QAT eval step B={B}: device busy share "
          f"{profile['device_busy_share']:.3f}, {profile['device_events']} "
          "device events", flush=True)
    counters()

    # ---- the 30-chunk QAT stream (K1 qat with a carry) ----
    model.eval()
    den = StreamingDenoiser(model, batch_size=B)
    counters()
    t0 = time.time()
    out = den.process_offline(noisy, chunk_samples=CHUNK)
    torch.cuda.synchronize()
    stream_s = time.time() - t0
    counts = counters()
    records["qat_scan"]["launches"] = counts["qat_scan"]
    n_chunks = -(-noisy.shape[-1] // CHUNK)
    print(f"QAT streaming: {n_chunks} chunks of {CHUNK} samples in "
          f"{stream_s * 1e3:.1f} ms, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    assert np.isfinite(out).all() and out.shape[0] == B, out.shape
    assert counts["qat_scan"] >= n_layers * (n_chunks - 1), counts
    assert counts["qat_scan"] % n_layers == 0
    assert sum(counts.values()) == counts["qat_scan"], counts
    x_tm = (noisy_mag[:2].transpose(1, 2) - STFT_MAG_MEAN).contiguous()
    cpu_model = build_model(quiet, 257, 257, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_model.eval()
    with torch.no_grad():
        outs, cache, cpu_outs, cpu_cache = [], None, [], None
        for s in range(0, 3 * 125, 125):
            y, cache = model.forward_stream(x_tm[:, s:s + 125], cache)
            outs.append(y.cpu())
            y, cpu_cache = cpu_model.forward_stream(
                x_tm[:, s:s + 125].cpu(), cpu_cache)
            cpu_outs.append(y)
    out3, ref3 = torch.cat(outs, 1), torch.cat(cpu_outs, 1)
    diff = (out3 - ref3).abs()
    top = max(1.0, ref3.abs().max().item())
    share = (diff > 1e-4 * top).float().mean().item()
    print(f"QAT stream, 3 chunks on the card vs the CPU: share above 1e-4 "
          f"x max(1, max|ref|) {share:.2e}", flush=True)
    _check("QAT stream, 3 chunks on the card vs the CPU", diff.max().item(),
           2e-2 * top)

    # ---- per-block and global-scale forwards vs the associative one ----
    with torch.no_grad():
        sd = model.state_dict()
        x2 = x_tm.to("cuda")
        ys = {}
        for name, kw in (("associative", dict(scan_mode="associative")),
                         ("per-block", {}),
                         ("global", dict(qat_global_scales=True))):
            m = build_model(dataclasses.replace(quiet, **kw), 257, 257,
                            device="cuda", seed=0)
            m.load_state_dict(sd)
            ys[name] = m.eval()(x2)
            del m
        denom = max(ys["associative"].abs().max().item(), 1e-3)
        rel = {name: (ys[name] - ys["associative"]).abs().max().item() / denom
               for name in ("per-block", "global")}
    print(f"QAT forward at the flagship (B=2, L={x2.shape[1]}) against the "
          f"associative QAT forward, max relative to its max: per-block "
          f"{rel['per-block']:.4f}, global scale {rel['global']:.4f} "
          "(recorded, not held)", flush=True)
    del state, step, model, eval_step

    # ---- top-k training: the unfused route, K1 both ways ----
    topk = dataclasses.replace(cfg, topk=0.5, approx_topk=True)
    model, state = _fresh_run(topk)
    step = make_ndns_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    state, _, _ = _run_steps(f"top-k train B={bsz}", state, step, tr_feats,
                             3, {"diag_scan": n_layers,
                                 "diag_scan_rev": n_layers}, counters)
    print(f"top-k train B={bsz}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)
    del model, state, step

    # ---- the w32a32 engine, offline on the per-op route ----
    x_eng = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    w32 = dataclasses.replace(cfg, convert_quantization="w32a32")
    eng = engine_from_frozen(w32, *frozen, device="cuda", block_t=512)
    assert not eng._stack_ok and not eng._network_ok
    _timed_region("w32a32 engine offline (per-op route)",
                  lambda: eng(x_eng), {"fused_s5_engine": n_layers},
                  counters)
    ms = _median_ms(lambda: eng(x_eng))
    print(f"w32a32 engine offline at B={B}: {ms:.3f} ms", flush=True)
    cpu_eng = engine_from_frozen(w32, *frozen, device="cpu", block_t=512)
    x_small = x_eng[:2, :200]
    _engine_close("w32a32 engine on the card vs the CPU engine",
                  eng(x_small).cpu(), cpu_eng(x_small.cpu()))


#: the integer-dot engines: tag -> (recipe, mxu16)
INT_ENGINES = {"w8a8": ("w8a8", False), "mxu16": ("w8a16", True)}


def _int_work(tag: str, h: int, p: int, n_dense: int):
    """(f32 flops, int8 ops) a frame of one layer of an integer-dot engine:
    w8a8 runs the GLU denses as int8 dots (2 ops a multiply-add) and the
    B/C projections in f32; mxu16 runs every dot on two int8 planes."""
    glu = n_dense * h * h
    bc = h * 2 * p + 2 * p * h
    rest = 8 * p + 6 * h
    if tag == "w8a8":
        return 2 * bc + rest, 2 * glu
    return rest, 2 * 2 * (bc + glu)


def _device_ms(tag, fn, reps: int = 3) -> float:
    """Device time of one call of ``fn`` (a K5 or K6 call: its row and scan
    passes) from ``torch.profiler``: the passes' device time over ``reps``
    calls in one profiled window, divided by ``reps``. The card's profiler
    sometimes records no device event in a window (also in the parent's
    windows, phase 18's busy shares of 0): such a window is profiled again,
    up to three times."""
    from sparsernns_tpu_torch.ops.cuda.engine_layer import ROW_PASS, SCAN_PASS
    from sparsernns_tpu_torch.utils.profiling import profile_region
    for _ in range(3):
        prof = profile_region(tag, lambda: [fn() for _ in range(reps)],
                              top=6)
        print(json.dumps(prof), flush=True)
        hits = [k for k in prof["top_kernels"]
                if ROW_PASS in k["name"] or SCAN_PASS in k["name"]]
        if any(ROW_PASS in k["name"] for k in hits):
            return sum(k["device_ms"] for k in hits) / reps
        print(f"{tag}: the profiler recorded no {ROW_PASS} in this window",
              flush=True)
    raise AssertionError(f"{tag}: the profiler saw no {ROW_PASS}")


def _full_glu_tree(params, n_layers: int):
    """A frozen tree with a value dense for the "full" GLU in every layer:
    the gate dense's kernel and bias rolled by one row, its grids kept."""
    import numpy as np
    full = copy.deepcopy(params)
    for i in range(n_layers):
        lay = full["encoder"][f"layers_{i}"]
        lay["out1"] = {**lay["out2"], **{
            k: np.roll(lay["out2"][k], 1, axis=0)
            for k in ("kernel", "bias")}}
    return full


def _odd_int_network(gen, tag: str, dev):
    """A two-layer integer-dot network of odd widths and random int8
    weights: H = 400 (the TPU kernels pad it to 512, so 16-bit dots over H
    take the plane-wise formula), P = 18 (the im half of the states' codes
    at an offset, tails of 2), d_in = 100, d_out = 90; ``tag`` "mxu16":
    every site on 16-bit grids; "w8a8": the denses on 8-bit grids, the
    int8 stream. Returns (enc, layers, dec, mode)."""
    import torch

    from sparsernns_tpu_torch.ops.cuda.engine_layer import Dense, LayerMode
    from sparsernns_tpu_torch.ops.intdot import weight_colsum
    from sparsernns_tpu_torch.quantize.engine import QWeight, _LayerPack
    h, p, d_in, d_out = 400, 18, 100, 90
    bits = 16 if tag == "mxu16" else 8

    def grid(e):   # a scale of 2^e at 16 bits, as coarse at fewer bits
        return (2.0 ** (e + 16 - bits), bits)

    def i8(*shape):
        w = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        return w.to(dev)

    def qweight(k, n, scale):
        w = i8(k, n)
        return QWeight(w, scale, weight_colsum(w))

    def vec(n, sc=0.1, mean=0.0):
        return (mean + sc * torch.randn(n, generator=gen)).to(dev)

    enc = Dense(qweight(d_in, h, 2.0 ** -8), vec(h), grid(-10),
                grid(-9) if tag == "mxu16" else None)
    dec = Dense(qweight(h, d_out, 2.0 ** -10), vec(d_out), grid(-9),
                grid(-9) if tag == "mxu16" else None)
    layers = []
    for _ in range(2):
        radius = torch.rand(p, generator=gen) * 0.3 + 0.6
        angle = torch.rand(p, generator=gen) * 6.0 - 3.0
        w_b, w_c = i8(h, 2 * p), i8(2 * p, h)
        s_state = grid(-8)[0]
        sites = {}
        if tag == "mxu16":
            sites = dict(mixer_in16=grid(-12), state16=True,
                         but_requant=(grid(-9)[0], grid(-9)[0], bits),
                         yt_requant=grid(-9), out2_out_requant=grid(-9))
        layers.append(_LayerPack(
            lam=((radius * torch.cos(angle)).to(dev),
                 (radius * torch.sin(angle)).to(dev)),
            w_b=w_b, w_c=w_c, d=vec(h), norm_w=vec(h, mean=1.0),
            norm_b=vec(h), out2_kernel=qweight(h, h, 2.0 ** -9),
            out2_bias=vec(h), residual_requant=grid(-9),
            state_requant=(s_state, s_state, bits),
            wb_scales=(2.0 ** -9, 2.0 ** -10),
            wc_scales=(2.0 ** -10, 2.0 ** -11), out2_in_scale=grid(-9),
            cs_wb=weight_colsum(w_b), cs_wc_re=weight_colsum(w_c[:p]),
            cs_wc_im=weight_colsum(w_c[p:]), **sites))
    mode = LayerMode(prenorm=True, relufication=True, glu="half1",
                     relu_state=True, act_dtype=torch.bfloat16)
    return enc, layers, dec, mode


def intdot_kernel_phase(cfg, model, cal_x, x_eng, frames, gen,
                        records) -> dict:
    """Phase 17: calibrate the flagship with the w8a8 recipe and with
    w8a16 (two batches of the synthetic loader), freeze, and build the
    w8a8 engine and the w8a16 engine with ``mxu16``; hold K6, K5a (the
    first launch with the encoder, a middle one, the last with the
    decoder) and K5b (one 128-frame block from a carry on the state grid)
    in their integer-dot modes against their plain versions on the card
    at B=8, L=3751 (block 512); mask: the engine bar; streams: codes at
    most 1 apart in at most 0.5 %; carries: on the grid, codes likewise),
    timed (median of 5, device time from the profiler); the variants GLU
    full / half2 (postnorm, relufied) / none and f32 activations at
    B=2, L=300, block 128 (network vs plain: the engine bar; network vs
    stack: 0); one odd-width network (H=400, P=18: the plane-wise formula,
    an odd P) per mode, K6 and the K5 stack vs plain and each other.
    Returns tag -> (run config, frozen tree), with the w8a8A8 tree."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import engine_layer, engine_network
    from sparsernns_tpu_torch.ops.cuda.engine_layer import pass_plan
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.train.loop import build_model
    dev = torch.device("cuda")
    el, en = engine_layer, engine_network
    h, n_layers = cfg.d_model, cfg.n_layers
    n_dense = {"full": 2, "half1": 1, "half2": 1, "none": 0}[cfg.glu_variant]
    rows, s_rows = B * frames, B * STREAM_BLOCK
    trees, summary = {}, {}

    def calibrated(recipe, mxu16=False):
        run_cfg = dataclasses.replace(cfg, convert_quantization=recipe,
                                      engine_mxu16=mxu16)
        cal_model = build_model(
            run_cfg, 257, 257, device=dev, seed=0, scan_mode="sequential",
            q_config=quantization_recipes[recipe](static_quant=True,
                                                  calibrating=True))
        return run_cfg, calibrate(cal_model, model.state_dict(),
                                  [cal_x[:B], cal_x[B:]])

    for tag, (recipe, mxu16) in INT_ENGINES.items():
        t0 = time.time()
        run_cfg, frozen = trees[tag] = calibrated(recipe, mxu16)
        eng = engine_from_frozen(run_cfg, *frozen, device=dev, block_t=512)
        print(f"{tag} engine (calibrate, freeze, pack {time.time() - t0:.1f}"
              f" s): mxu16 {eng.mxu16}, encoder grid "
              f"{eng.encoder_in_scale}, network route {eng._network_ok}",
              flush=True)
        assert eng._network_ok and eng.mxu16["dense"]
        if mxu16:
            assert all(eng.mxu16.values()), eng.mxu16
        mode, layers = eng.mode, eng.layers
        p = layers[0].p
        rq = [lay.residual_requant for lay in layers]
        stream_bytes = 1 if rq[0][1] <= 8 else 2
        f32_l, int_l = _int_work(tag, h, p, n_dense)
        w_bytes = (2 * h * 2 * p + n_dense * h * h + 4 * (
            3 * h + 2 * p + n_dense * h) + 4 * (2 * p + 2 * h))
        bound_io = 2 * 257 * h + 4 * (2 * h + 2 * 257)
        with torch.no_grad():
            # ---- K6, the default offline route ----
            net_args = (x_eng, eng._enc, layers, eng._dec, mode)
            ref = en.engine_network_plain(*net_args, block_t=512)
            out = en.engine_network_cuda(*net_args, block_t=512)
            torch.cuda.synchronize()
            err = _engine_close(f"K6 {tag} vs plain (mask)", out, ref)
            run = lambda: en.engine_network_cuda(  # noqa: E731
                *net_args, block_t=512)
            ms = _median_ms(run)
            dev_ms = _device_ms(f"K6 {tag} x 3", run)
            _check_passes(f"K6 {tag}", en.launched(),
                          pass_plan(B, frames, h, p, n_layers),
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
            plain_ms = _time_ms(lambda: en.engine_network_plain(
                *net_args, block_t=512), 1, 0)
            bound, by = _bound_ms(
                2 * rows * 257 * 4 + n_layers * w_bytes + bound_io,
                rows * n_layers * f32_l,
                rows * (n_layers * int_l
                        + 2 * 2 * 257 * h * (2 if mxu16 else 1)))
            records[f"engine_network_{tag}"] = dict(
                name=f"engine_network_{tag}", route="cuda",
                source="sparsernns_tpu_torch/ops/cuda/csrc/engine_network.cu",
                replaces="sparsernns_tpu/ops/pallas/fused_network.py:299",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)
            summary[f"K6 {tag}"] = dict(ms=ms, device_ms=dev_ms,
                                        bound_ms=bound, mxu16=eng.mxu16)

            # ---- K5a: first (encoder), middle, last (decoder) launch,
            # each on the plain version's input ----
            kw = dict(block_t=512)
            r0 = el.engine_layer_plain(x_eng, layers[0], mode, enc=eng._enc,
                                       **kw)
            errs = [_code_diff(f"K5a {tag} first launch (encoder) vs plain",
                               el.engine_layer_cuda(x_eng, layers[0], mode,
                                                    enc=eng._enc, **kw), r0)]
            r1 = el.engine_layer_plain(r0, layers[1], mode, in_requant=rq[0],
                                       **kw)
            errs.append(_code_diff(
                f"K5a {tag} middle launch vs plain",
                el.engine_layer_cuda(r0, layers[1], mode, in_requant=rq[0],
                                     **kw), r1))
            last = dict(in_requant=rq[1], dec=eng._dec, **kw)
            ref = el.engine_layer_plain(r1, layers[2], mode, **last)
            _engine_close(f"K5a {tag} last launch (decoder) vs plain (mask)",
                          el.engine_layer_cuda(r1, layers[2], mode, **last),
                          ref)
            mid = dict(in_requant=rq[0], **kw)
            run = lambda: el.engine_layer_cuda(  # noqa: E731
                r0, layers[1], mode, **mid)
            ms = _median_ms(run)
            dev_ms = _device_ms(f"K5a {tag} x 3", run)
            plain_ms = _time_ms(lambda: el.engine_layer_plain(
                r0, layers[1], mode, **mid), 1, 0)
            bound, by = _bound_ms(
                2 * rows * h * stream_bytes + w_bytes, rows * f32_l,
                rows * int_l)
            records[f"engine_layer_{tag}"] = dict(
                name=f"engine_layer_{tag}", route="cuda",
                source="sparsernns_tpu_torch/ops/cuda/csrc/engine_layer.cu",
                replaces="sparsernns_tpu/ops/pallas/fused_layer.py:629",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)
            summary[f"K5a {tag}"] = dict(ms=ms, device_ms=dev_ms,
                                         bound_ms=bound)

            # ---- K5b: one 128-frame block from a carry on the grid ----
            s_re, s_im, _ = layers[1].state_requant
            carry = tuple(
                (torch.round(torch.randn((B, p), generator=gen) * 200) * s)
                .to(dev) for s in (s_re, s_im))
            r_in = r0[:, :STREAM_BLOCK].contiguous()
            kwc = dict(block_t=STREAM_BLOCK, in_requant=rq[0], carry=carry)
            ref, ref_c = el.engine_layer_plain(r_in, layers[1], mode, **kwc)
            out, out_c = el.engine_layer_cuda(r_in, layers[1], mode, **kwc)
            torch.cuda.synchronize()
            err = _code_diff(f"K5b {tag} one 128-frame block vs plain", out,
                             ref)
            for half, o, r, sc in zip(("re", "im"), out_c, ref_c,
                                      (s_re, s_im)):
                _codes_of(f"K5b {tag} carry out {half}", o, r, sc)
            run = lambda: el.engine_layer_cuda(  # noqa: E731
                r_in, layers[1], mode, **kwc)
            ms = _median_ms(run)
            dev_ms = _device_ms(f"K5b {tag} x 3", run)
            plain_ms = _time_ms(lambda: el.engine_layer_plain(
                r_in, layers[1], mode, **kwc), 1, 0)
            bound, by = _bound_ms(
                2 * s_rows * h * stream_bytes + w_bytes + 4 * B * p * 4,
                s_rows * f32_l, s_rows * int_l)
            records[f"engine_layer_carry_{tag}"] = dict(
                name=f"engine_layer_carry_{tag}", route="cuda",
                source="sparsernns_tpu_torch/ops/cuda/csrc/engine_layer.cu",
                replaces="sparsernns_tpu/ops/pallas/fused_layer.py:729",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)
            summary[f"K5b {tag}"] = dict(ms=ms, device_ms=dev_ms,
                                         bound_ms=bound)

            # ---- variants at B=2, L=300, block 128 ----
            full_params = _full_glu_tree(frozen[0], n_layers)
            xs = x_eng[:2, :300]
            for var in (dict(glu_variant="full"),
                        dict(glu_variant="half2", relufication=True,
                             prenorm=False),
                        dict(glu_variant="none"),
                        dict(act_dtype=torch.float32)):
                var = dict(var)
                act = var.pop("act_dtype", torch.bfloat16)
                v_eng = engine_from_frozen(
                    dataclasses.replace(run_cfg, **var), full_params,
                    frozen[1], device=dev, block_t=128, act_dtype=act)
                assert v_eng._network_ok and v_eng.mxu16 == eng.mxu16
                v_args = (xs, v_eng._enc, v_eng.layers, v_eng._dec,
                          v_eng.mode)
                ref = en.engine_network_plain(*v_args, block_t=128)
                net = v_eng._apply_network(xs, 128)
                name = f"K6/K5a {tag} {var or ''} act {act}"
                _engine_close(f"{name} vs plain", net, ref)
                _check(f"{name} network vs stack",
                       (net - v_eng._apply_stack(xs, 128)).abs().max()
                       .item(), 0.0)

            # ---- odd widths: the plane-wise formula, an odd P ----
            enc, o_layers, dec, o_mode = _odd_int_network(gen, tag, dev)
            xo = torch.randn((2, 70, 100), generator=gen).to(dev)
            ref = en.engine_network_plain(xo, enc, o_layers, dec, o_mode,
                                          block_t=16)
            net = en.engine_network_cuda(xo, enc, o_layers, dec, o_mode,
                                         block_t=16)
            _engine_close(f"K6 {tag} H=400 P=18 vs plain", net, ref)
            r = el.engine_layer_cuda(xo, o_layers[0], o_mode, block_t=16,
                                     enc=enc)
            stk = el.engine_layer_cuda(
                r, o_layers[1], o_mode, block_t=16,
                in_requant=o_layers[0].residual_requant, dec=dec)
            _check(f"K6 {tag} H=400 P=18 network vs K5a stack",
                   (net - stk).abs().max().item(), 0.0)
            c0 = tuple(torch.zeros((2, 18), device=dev) for _ in range(2))
            kwo = dict(block_t=16, in_requant=o_layers[0].residual_requant,
                       carry=c0)
            ref, _ = el.engine_layer_plain(r[:, :32], o_layers[1], o_mode,
                                           **kwo)
            out, _ = el.engine_layer_cuda(r[:, :32], o_layers[1], o_mode,
                                          **kwo)
            _code_diff(f"K5b {tag} H=400 P=18 vs plain", out, ref)
    print(json.dumps({"intdot_kernel_phase": summary}), flush=True)
    # w8a8A8 (8-bit lambda too) runs the kernels' w8a8 modes: served in
    # phase 18
    trees["w8a8A8"] = calibrated("w8a8A8")
    return trees


def intdot_serving_phase(cfg, trees, audio, feats, records,
                         counters) -> None:
    """Phase 18: serve the integer-dot engines (w8a8, w8a8A8; w8a16 with
    mxu16) through the entry points: the offline call (K6 x 1, nothing else),
    the stack route (K5a x 3, bit-identical to K6), a ``from_engine``
    stream of the 30 s audio in 1 s chunks at block 128 (K5b x 3 a
    forward) and ``process_chunk`` at block 128 against one whole call
    (exact), the engine on the card against the engine on the CPU (the
    engine bar; w8a8A8 against the plain network on the card, the CPU
    difference printed); and the w8a8 engine of the top-k recipe (``topk=0.5,
    approx_topk=true``) offline on the per-op route: K4a-engine x 3 and
    the denses' int8 dots as float64 products of the codes, against the
    CPU engine. Each region timed, its launches asserted exactly."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.cuda import engine_network
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN,
                                                   ndns_loss_from_mask_tm)
    dev = torch.device("cuda")
    n_layers = cfg.n_layers
    noisy, clean_t = audio
    noisy_mag, noisy_phase, clean_mag = feats
    frames = noisy_mag.shape[-1]
    x_eng = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    x_small = x_eng[:2, :200]
    summary = {}

    def timed(tag, fn, expect):
        return _timed_region(tag, fn, expect, counters)

    for tag, (run_cfg, frozen) in trees.items():
        engine = engine_from_frozen(run_cfg, *frozen, device=dev,
                                    block_t=512)
        mask, counts = timed(f"{tag} engine offline call B={B}",
                             lambda: engine(x_eng), {"engine_network": 1})
        assert engine.mxu16["dense"], engine.mxu16
        launches = {"engine_network": counts["engine_network"]}
        assert mask.shape == (B, frames, 257) and torch.isfinite(mask).all()
        loss_e, snr_e, _ = ndns_loss_from_mask_tm(
            mask, noisy_mag.transpose(1, 2), noisy_phase.transpose(1, 2),
            clean_mag.transpose(1, 2), clean_t)
        assert np.isfinite(loss_e.item()) and np.isfinite(snr_e.item())
        call_ms = _median_ms(lambda: engine(x_eng))
        stack_engine = engine_from_frozen(run_cfg, *frozen, device=dev,
                                          block_t=512)
        stack_engine._network_ok = False
        mask_stack, counts = timed(f"{tag} engine stack route B={B}",
                                   lambda: stack_engine(x_eng),
                                   {"engine_layer": n_layers})
        launches["engine_layer"] = counts["engine_layer"]
        _check(f"{tag} engine network route vs stack route "
               "(bit-identical)", (mask - mask_stack).abs().max().item(),
               0.0)
        stack_ms = _median_ms(lambda: stack_engine(x_eng))
        cpu_engine = engine_from_frozen(run_cfg, *frozen, device="cpu",
                                        block_t=512)
        y_card, y_cpu = engine(x_small).cpu(), cpu_engine(x_small.cpu())
        if tag in INT_ENGINES:
            _engine_close(f"{tag} engine on the card vs on the CPU (plain)",
                          y_card, y_cpu)
        else:
            # w8a8A8 quantizes lambda's halves apart at 8 bits, which puts
            # a few channels outside the unit circle: one 8-bit code that
            # the card's and the CPU's float ops round apart at a tie
            # spreads through them. Held against the plain version on the
            # same card; the CPU difference is printed.
            with torch.no_grad():
                ref = engine_network.engine_network_plain(
                    x_small, engine._enc, engine.layers, engine._dec,
                    engine.mode, block_t=x_small.shape[1])
            _engine_close(f"{tag} engine vs the plain network on the card",
                          y_card, ref.cpu())
            mag = max(float((lay.lam[0] ** 2 + lay.lam[1] ** 2).max())
                      for lay in engine.layers) ** 0.5
            d = (y_card - y_cpu).abs()
            print(f"{tag} engine on the card vs on the CPU (plain): max "
                  f"{d.max().item():.3e}, share above 1e-5 "
                  f"{(d > 1e-5).float().mean().item():.2e}; max |lambda| "
                  f"{mag:.6f}", flush=True)

        stream_engine = engine_from_frozen(run_cfg, *frozen, device=dev,
                                           block_t=STREAM_BLOCK)
        eden = StreamingDenoiser.from_engine(stream_engine, batch_size=B)
        counters()
        t0 = time.time()
        out = eden.process_offline(noisy, chunk_samples=CHUNK)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        counts = counters()
        forwards = counts["engine_layer_carry"] // n_layers
        launches["engine_layer_carry"] = counts["engine_layer_carry"]
        for name, count in launches.items():    # w8a8A8: the w8a8 modes
            if f"{name}_{tag}" in records:
                records[f"{name}_{tag}"]["launches"] = count
        print(f"{tag} engine streaming: {-(-noisy.shape[1] // CHUNK)} "
              f"chunks in {wall:.1f} ms, {forwards} forwards of "
              f"{STREAM_BLOCK}-frame blocks, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        assert np.isfinite(out).all()
        assert forwards >= frames // STREAM_BLOCK, forwards
        assert counts == {**{k: 0 for k in counts}, "engine_layer_carry":
                          n_layers * forwards}, counts
        carries, parts = None, []
        with torch.no_grad():
            for start in range(0, frames, STREAM_BLOCK):
                part, carries = stream_engine.process_chunk(
                    x_eng[:, start:start + STREAM_BLOCK], carries)
                parts.append(part)
            _check(f"{tag} engine chunked process_chunk vs one whole call",
                   (torch.cat(parts, dim=1) - stream_engine(x_eng)).abs()
                   .max().item(), 0.0)
        chunk = x_eng[:, :STREAM_BLOCK].contiguous()
        chunk_ms = _median_ms(lambda: stream_engine.process_chunk(chunk))
        summary[tag] = dict(offline_ms=call_ms, stack_ms=stack_ms,
                            chunk_ms=chunk_ms, stream_wall_ms=wall,
                            loss=loss_e.item(), si_snr=snr_e.item(),
                            launches=launches)
        del engine, stack_engine, stream_engine, eden, cpu_engine

    # ---- w8a8 with top-k: the per-op route's int8 dots ----
    run_cfg, frozen = trees["w8a8"]
    tk = dataclasses.replace(run_cfg, topk=0.5, approx_topk=True)
    engine = engine_from_frozen(tk, *frozen, device=dev, block_t=512)
    assert not engine._stack_ok and engine.mxu16["dense"]
    mask, counts = timed(f"w8a8 topk engine offline call (per-op) B={B}",
                         lambda: engine(x_eng),
                         {"fused_s5_engine": n_layers})
    assert mask.shape == (B, frames, 257) and torch.isfinite(mask).all()
    summary["w8a8 topk per-op"] = dict(
        offline_ms=_median_ms(lambda: engine(x_eng)),
        launches={k: v for k, v in counts.items() if v})
    cpu_engine = engine_from_frozen(tk, *frozen, device="cpu", block_t=512)
    ref = cpu_engine(x_small.cpu())
    _topk_close("w8a8 topk engine on the card vs on the CPU (plain)",
                engine(x_small).cpu(), ref,
                2e-3 * max(1.0, ref.abs().max().item()))
    print(json.dumps({"intdot_serving_phase": summary}), flush=True)


def _bf16_close(name: str, out, ref, f32_bar: float,
                max_share: float = 1e-3) -> float:
    """A bf16 stream against its plain version from the same bf16 inputs:
    both compute in f32 and round once, so every element is within one
    bf16 ulp of plain (8 significant bits, at the larger magnitude of the
    two) or, near 0, where a bf16 ulp is finer than the f32 sums' order
    difference, within the f32 mode's bar ``f32_bar``; at most
    ``max_share`` of the elements differ. Prints how many elements are
    beyond one ulp. Returns the largest absolute difference."""
    import torch
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    beyond = diff > ulp
    over = int((beyond & (diff > f32_bar)).sum().item())
    share = (diff > 0).float().mean().item()
    worst = diff.max().item()
    worst_beyond = diff[beyond].max().item() if beyond.any() else 0.0
    print(f"{name}: max abs diff {worst:.3e}, elements beyond one bf16 ulp "
          f"{int(beyond.sum().item())} of {diff.numel()} (largest "
          f"{worst_beyond:.3e}, f32 bar {f32_bar:.3e}, beyond both "
          f"{over}), differing share {share:.2e} (limit {max_share:.0e})",
          flush=True)
    if over or share > max_share:
        raise AssertionError(f"{name}: {over} elements beyond one ulp and "
                             f"the f32 bar, differing share {share}")
    return worst


def tail_modes_kernel_phase(layer0, cfg, frames: int, gen, records) -> None:
    """Phase 19: K2, K3a and K3b in their non-affine mode (the normed z and
    the residual skip as two streams, g_z and g_skip back) and on bfloat16
    streams (affine and non-affine) against their plain versions at B x
    frames x H with layer 0's operands and dropout masks: the recipe's
    variant (half1, gelu), half1 with relu and layer_relu, the same with
    relu_state, and one odd width (H=20, P=12, L=70, full GLU, relu,
    layer_relu). float32: phase 7's bars. bf16: the streams
    (out, g_x, g_skip) by ``_bf16_close``, the float32 weight gradients at
    phase 7's bar. Under relu_state K3b recomputes the states, and at this
    length some lie within rounding of 0 and pass the relu the other way
    (d_lam and d_w_b move by up to 1e-2 of their max, in the affine mode
    too): there every K3b output is held at the JAX package's bar for
    that case, 2e-2 of max(1, max|ref|). Times: median of 5."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import layer_tail, layer_tail_bwd
    dev = torch.device("cuda")
    h, p = cfg.d_model, layer0.mixer.p
    streams = ("g_x", "g_skip")
    with torch.no_grad():
        lam, w_b, w_c, d, _ = layer0.mixer.layer_tail_operands()
        nw, nb = layer0.bn_affine()
        o2k, o2b = layer0.out2.weight.T.contiguous(), layer0.out2.bias
        x = torch.randn((B, frames, h), generator=gen).to(dev)
        skip = torch.randn((B, frames, h), generator=gen).to(dev)
        g = torch.randn((B, frames, h), generator=gen).to(dev)
        keep = 1.0 - cfg.p_dropout
        m1, m2 = ((torch.rand((B, 1, h), generator=gen) < keep).float().to(
            dev) / keep for _ in range(2))

        def operands(dtype, affine, x, skip, g, w, masks):
            """(x, g, positional args, keywords) of one mode."""
            lam_, w_b_, w_c_, d_, nw_, nb_, o2k_, o2b_, o1k_, o1b_ = w
            return (x.to(dtype), g.to(dtype),
                    (lam_, w_b_, w_c_, d_, nw_ if affine else None,
                     nb_ if affine else None, o2k_, o2b_, o1k_, o1b_),
                    dict(m1=masks[0], m2=masks[1],
                         skip=None if affine else skip.to(dtype)))

        def compare(tag, xs, gs, args, kw):
            """K2, K3a and every output of K3b against the plain versions;
            returns (K2 error, K3a error, K3b worst relative error)."""
            bf16 = xs.dtype == torch.bfloat16
            ref = layer_tail.layer_tail_plain(xs, *args, **kw)
            out = layer_tail.layer_tail_cuda(xs, *args, **kw)
            torch.cuda.synchronize()
            assert out.dtype == ref.dtype == xs.dtype, (out.dtype, ref.dtype)
            bar = 1e-4 * max(1.0, ref.float().abs().max().item())
            if bf16:
                err = _bf16_close(f"K2 {tag} vs plain", out, ref, bar)
            else:
                err = (out - ref).abs().max().item()
                _check(f"K2 {tag} vs plain", err, bar)
            _check_k2_passes(f"K2 {tag}", *xs.shape[:2])
            print(f"K2 {tag} output digest: {_digest(out)}", flush=True)
            hist_args = (args[0], args[1], args[4], args[5])
            hist_ref = layer_tail_bwd.layer_tail_hist_plain(xs, *hist_args)
            hist = layer_tail_bwd.layer_tail_hist_cuda(xs, *hist_args)
            torch.cuda.synchronize()
            hist_err = max((a - b).abs().max().item()
                           for a, b in zip(hist, hist_ref))
            _check(f"K3a {tag} vs plain", hist_err, 1e-5 * max(
                1.0, max(t.abs().max().item() for t in hist_ref)))
            refs = layer_tail_bwd.layer_tail_bwd_plain(xs, gs, *args, **kw)
            outs = layer_tail_bwd.layer_tail_bwd_cuda(xs, gs, *args, **kw)
            torch.cuda.synchronize()
            # under relu_state the adjoint recomputes the states, and one
            # within rounding of 0 may pass the relu the other way: the
            # JAX package's bar for that case (its tail-gradient test)
            flips = kw["relu_state"]
            rel_worst, errs = 0.0, {}
            for name, r, o in zip(BWD_OUTPUTS, refs, outs):
                if r is None:
                    assert o is None, name
                    continue
                if name == "d_lam":
                    r, o = torch.stack(r), torch.stack(o)
                assert r.shape == o.shape and r.dtype == o.dtype, name
                scale = max(1.0, r.float().abs().max().item())
                if name in streams:
                    assert o.dtype == xs.dtype, (name, o.dtype)
                    if bf16 and not flips:
                        _bf16_close(f"K3b {tag} {name} vs plain", o, r,
                                    2e-4 * scale)
                        continue
                errs[name] = ((o.float() - r.float()).abs().max().item()
                              / scale)
                rel_worst = max(rel_worst, errs[name])
            assert (refs[1] is None) == (kw["skip"] is None)
            print(f"K3b {tag}: " + ", ".join(
                f"{k} {v:.1e}" for k, v in errs.items()), flush=True)
            _check(f"K3b {tag} vs plain, worst output, relative to max(1, "
                   "max|ref|)", rel_worst, 2e-2 if flips else 2e-4)
            return err, hist_err, rel_worst

        weights = (lam, w_b, w_c, d, nw, nb, o2k, o2b, None, None)
        hs, ps, ls = 20, 12, 70
        rnd = lambda *shape, sc=1.0: (  # noqa: E731
            torch.randn(shape, generator=gen) * sc).to(dev)
        radius = torch.rand(ps, generator=gen) * 0.39 + 0.6
        angle = torch.rand(ps, generator=gen) * 6.0 - 3.0
        odd_w = (((radius * torch.cos(angle)).to(dev),
                  (radius * torch.sin(angle)).to(dev)),
                 rnd(hs, 2 * ps, sc=0.3), rnd(2 * ps, hs, sc=0.3), rnd(hs),
                 1.0 + rnd(hs, sc=0.2), rnd(hs, sc=0.1), rnd(hs, hs, sc=0.3),
                 rnd(hs, sc=0.1), rnd(hs, hs, sc=0.3), rnd(hs, sc=0.1))
        odd_streams = (rnd(2, ls, hs), rnd(2, ls, hs), rnd(2, ls, hs))
        odd_masks = (m1[:2, :, :hs].contiguous(), m2[:2, :, :hs].contiguous())
        modes = {"skip": (torch.float32, False),
                 "bf16": (torch.bfloat16, True),
                 "skip_bf16": (torch.bfloat16, False)}
        errs, times = {}, {}
        # (act, relu_state, layer_relu); the max error of a row comes from
        # the variants held at the strict bars
        variants = (("gelu", False, False), ("relu", False, True),
                    ("relu", True, True))
        for mode, (dtype, affine) in modes.items():
            worst = [0.0, 0.0, 0.0]
            for act, relu_state, layer_relu in variants:
                xs, gs, args, kw = operands(dtype, affine, x, skip, g,
                                            weights, (m1, m2))
                kw.update(act=act, glu=cfg.glu_variant,
                          relu_state=relu_state, layer_relu=layer_relu)
                tag = (f"{mode} {cfg.glu_variant}/{act}"
                       + " relu_state" * relu_state
                       + " layer_relu" * layer_relu)
                errs_v = compare(tag, xs, gs, args, kw)
                if not relu_state:
                    worst = [max(a, b) for a, b in zip(worst, errs_v)]
                if act == "gelu":
                    timed = (xs, gs, args, kw)
            xs, gs, args, kw = operands(dtype, affine, *odd_streams, odd_w,
                                        odd_masks)
            kw.update(act="relu", glu="full", relu_state=False,
                      layer_relu=True)
            compare(f"{mode} H={hs} P={ps} L={ls} full/relu layer_relu", xs,
                    gs, args, kw)
            errs[mode] = worst
            xs, gs, args, kw = timed
            hist_args = (args[0], args[1], args[4], args[5])
            fwd = _median_ms(lambda: layer_tail.layer_tail_cuda(
                xs, *args, **kw))
            hist = _median_ms(lambda: layer_tail_bwd.layer_tail_hist_cuda(
                xs, *hist_args))
            both = _median_ms(lambda: layer_tail_bwd.layer_tail_bwd_cuda(
                xs, gs, *args, **kw))
            plain = [_time_ms(fn, 1, 0) for fn in (
                lambda: layer_tail.layer_tail_plain(xs, *args, **kw),
                lambda: layer_tail_bwd.layer_tail_hist_plain(xs, *hist_args),
                lambda: layer_tail_bwd.layer_tail_bwd_plain(xs, gs, *args,
                                                            **kw))]
            times[mode] = (fwd, hist, both - hist, *plain)
            print(f"tail mode {mode}: K2 {fwd:.3f} ms, K3a {hist:.3f} ms, "
                  f"K3b {both - hist:.3f} ms (plain {plain[0]:.1f}, "
                  f"{plain[1]:.1f}, {plain[2]:.1f})", flush=True)
    # bounds: the f32 rows' arithmetic (phase 7) with the streams of each
    # mode: non-affine reads skip beside z (and K3b writes g_skip beside
    # g_x); bf16 moves two bytes an element; K3a writes every f32 state,
    # which K3b reads
    rows = B * frames
    n_dense = {"full": 2, "half1": 1, "half2": 1, "none": 0}[cfg.glu_variant]
    mm = 2 * h * 2 * p + 2 * 2 * p * h + n_dense * 2 * h * h
    w_bytes = (2 * h * 2 * p + n_dense * (h * h + h) + 3 * h + 2 * p) * 4
    n_t = -(-frames // 32)
    grads = 2 * h * 2 * p + n_dense * h * h + (6 + n_dense) * h + 2 * p
    states = rows * 2 * p * 4
    for mode, prefix in (("skip", "skip"), ("bf16", "bf16")):
        dtype, affine = modes[mode]
        el = rows * h * (2 if dtype == torch.bfloat16 else 4)
        n_in = 1 if affine else 2           # z (or x), and skip
        fwd_b = _bound_ms((n_in + 1) * el + w_bytes + 2 * B * h * 4,
                          rows * (mm + 8 * p + 8 * h))
        hist_b = _bound_ms(el + states + (h * 2 * p + 2 * p) * 4
                           + 2 * B * n_t * p * 4,
                           rows * (2 * h * 2 * p + 8 * p + 2 * h))
        bwd_b = _bound_ms(2 * (n_in + 1) * el + states + w_bytes
                          + 2 * B * h * 4 + grads * 4,
                          rows * (3 * mm - 2 * h * 2 * p + 24 * p + 40 * h))
        fwd, hist, bwd, p_fwd, p_hist, p_bwd = times[mode]
        worst = errs[mode] if mode == "skip" else [
            max(a, b) for a, b in zip(errs["bf16"], errs["skip_bf16"])]
        common = dict(route="cuda", library_ms=None)
        records[f"layer_tail_{prefix}"] = dict(
            name=f"layer_tail_{prefix}",
            source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer_train.py:293",
            max_abs_err=worst[0], ms=fwd, plain_ms=p_fwd,
            bound_ms=fwd_b[0], bound_by=fwd_b[1], **common)
        records[f"layer_tail_hist_{prefix}"] = dict(
            name=f"layer_tail_hist_{prefix}",
            source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail_bwd.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer_bwd.py:489",
            max_abs_err=worst[1], ms=hist, plain_ms=p_hist,
            bound_ms=hist_b[0], bound_by=hist_b[1], **common)
        records[f"layer_tail_bwd_{prefix}"] = dict(
            name=f"layer_tail_bwd_{prefix}",
            source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail_bwd.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer_bwd.py:557",
            max_abs_err=worst[2], ms=bwd, plain_ms=p_bwd,
            bound_ms=bwd_b[0], bound_by=bwd_b[1], **common)
    print(json.dumps({"tail_modes_kernel_phase": {
        k: v for k, v in records.items() if k.endswith(("_skip", "_bf16"))}}),
        flush=True)



def layernorm_training_phase(cfg, records, counters, batch) -> None:
    """Phase 20: the recipe with ``batchnorm=false``: prenorm LayerNorm
    layers take K2, K3a and K3b in their non-affine mode, as the JAX
    package routes them. Three B=32 steps with dropout 0.1 (K2, K3a, K3b x
    3 a step, no other kernel), one eval step (K2 x 3), one step on the
    card against the CPU, eight dropout-free B=8 steps that must lower the
    loss; in the same call three B=32 steps of the mixer route (``prenorm=
    false``, phase 10's model) beside it. Step times, busy share, peak
    memory."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.train.steps import (make_ndns_eval_step,
                                                  make_ndns_train_step)
    from sparsernns_tpu_torch.utils.profiling import profile_region
    n_layers, bsz = cfg.n_layers, cfg.bsz
    ln = dataclasses.replace(cfg, batchnorm=False)
    noisy, clean, feats = batch

    model, state = _fresh_run(ln)
    layer = model.encoder.layers[0]
    assert isinstance(layer.norm, torch.nn.LayerNorm) and layer.takes_tail()
    step = make_ndns_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    state, counts, walls = _run_steps(
        f"layernorm train B={bsz}", state, step, feats, 3,
        dict.fromkeys(TAIL_KERNELS, n_layers), counters)
    peak = torch.cuda.max_memory_allocated()
    for name, row in zip(TAIL_KERNELS, ("layer_tail_skip",
                                        "layer_tail_hist_skip",
                                        "layer_tail_bwd_skip")):
        records[row]["launches"] = counts[name]
    profile = profile_region(f"layernorm train step B={bsz}",
                             lambda: step(state, *feats))
    print(json.dumps(profile), flush=True)
    print(f"layernorm train B={bsz}: peak memory {peak / 2**20:.0f} MiB, "
          f"device busy share {profile['device_busy_share']:.3f}",
          flush=True)
    eval_step = make_ndns_eval_step(model)
    small = tuple(t[:B].contiguous() for t in feats)
    eval_step(*small)                                   # warm-up
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = eval_step(*small)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = counters()
    print(f"layernorm eval step B={B}: {wall:.1f} ms, loss "
          f"{metrics['loss'].item():.4f}, launches {counts}", flush=True)
    assert np.isfinite(metrics["loss"].item()) and model.training
    check_launches("layernorm eval step", counts,
                   {"layer_tail_train": n_layers})
    del model, state, step, eval_step

    # the mixer route in the same call, for the route question
    post = dataclasses.replace(cfg, prenorm=False)
    model, state = _fresh_run(post)
    step = make_ndns_train_step(model)
    _, _, mixer_walls = _run_steps(
        f"postnorm (mixer route) train B={bsz}", state, step, feats, 3,
        {"fused_s5": n_layers, "diag_scan": n_layers,
         "diag_scan_rev": n_layers}, counters)
    print(f"train step B={bsz}, median of the last two: LayerNorm on the "
          f"whole-layer route {np.median(walls[1:]):.1f} ms, postnorm on "
          f"the mixer route {np.median(mixer_walls[1:]):.1f} ms", flush=True)
    del model, state, step

    quiet = dataclasses.replace(ln, p_dropout=0.0)
    _card_vs_cpu_step("layernorm train step", quiet, noisy, clean)
    state, step, small, peak_small = _learning_steps("layernorm train",
                                                     quiet, feats)
    print(f"layernorm train B={B}: peak memory {peak_small / 2**20:.0f} MiB",
          flush=True)


def bf16_training_phase(cfg, records, counters, batch) -> None:
    """Phase 21: the recipe with ``train_stream_dtype="bfloat16"``: the
    stream between the layers is bf16 and K2, K3a, K3b read and write it
    (x 3 a step, no other kernel). Three B=32 steps on the bf16 stream and
    the same three on a float32 stream from the same seed (the same
    dropout draws): losses within rtol 2e-3, the JAX package's own bar
    between its two streams. Step times and peak memory of both."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    n_layers, bsz = cfg.n_layers, cfg.bsz
    feats = batch[2]
    losses, walls, peaks = {}, {}, {}
    for sd in ("float32", "bfloat16"):
        run_cfg = dataclasses.replace(cfg, train_stream_dtype=sd)
        model, state = _fresh_run(run_cfg)
        seen = []
        hook = model.encoder.layers[0].register_forward_hook(
            lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        step = make_ndns_train_step(model)
        torch.cuda.reset_peak_memory_stats()
        losses[sd] = []
        walls[sd] = []
        for i in range(3):
            counters()
            torch.cuda.synchronize()
            t0 = time.time()
            state, metrics = step(state, *feats)
            torch.cuda.synchronize()
            walls[sd].append((time.time() - t0) * 1e3)
            counts = counters()
            losses[sd].append(metrics["loss"].item())
            print(f"{sd} stream train B={bsz} step {i}: {walls[sd][-1]:.1f} "
                  f"ms, loss {losses[sd][-1]:.6f}, launches {counts}",
                  flush=True)
            check_launches(f"{sd} stream train", counts,
                           dict.fromkeys(TAIL_KERNELS, n_layers))
        peaks[sd] = torch.cuda.max_memory_allocated()
        hook.remove()
        want = torch.bfloat16 if sd == "bfloat16" else torch.float32
        assert seen and all(s == (want, want) for s in seen), (sd, seen)
        if sd == "bfloat16":
            for name, row in zip(TAIL_KERNELS, ("layer_tail_bf16",
                                                "layer_tail_hist_bf16",
                                                "layer_tail_bwd_bf16")):
                records[row]["launches"] = counts[name]
        del model, state, step
    for sd in losses:
        print(f"{sd} stream B={bsz}: steps {walls[sd]} ms (median of the "
              f"last two {np.median(walls[sd][1:]):.1f}), peak memory "
              f"{peaks[sd] / 2**20:.0f} MiB", flush=True)
    l32, l16 = np.asarray(losses["float32"]), np.asarray(losses["bfloat16"])
    assert np.isfinite(l16).all(), l16
    _check("bf16 stream losses vs float32 stream, relative",
           float((np.abs(l16 - l32) / np.abs(l32)).max()), 2e-3)


def pipeline_phase(root: str, counters, records, full_x) -> None:
    """Phase 22: ``cli.main train`` then ``cli.main convert`` over its
    checkpoint, every stage on, then ``W8A16Engine.from_artifacts`` (module
    docstring, item 22). Fails on a non-finite metric, a launch count off
    its stage's, a missed SI-SNR gate, a missing artifact, or a
    ``from_artifacts`` output that differs from the convert stage's
    engine."""
    import tempfile

    import numpy as np
    import torch

    from sparsernns_tpu_torch import cli
    from sparsernns_tpu_torch.quantize import convert as convert_mod
    from sparsernns_tpu_torch.quantize.engine import W8A16Engine
    from sparsernns_tpu_torch.train.checkpoint import (ArtifactStore,
                                                       CheckpointManager)
    from sparsernns_tpu_torch.train.loop import build_dataset
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.utils.config import RunConfig

    with open(os.path.join(root, "recipes", "ndns.json")) as f:
        recipe = json.load(f)
    recipe.update(bsz=B, epochs=PIPE_EPOCHS, synthetic_data=True,
                  synthetic_size=32, synthetic_seconds=float(PIPE_SECONDS))
    n_layers = recipe["n_layers"]
    with tempfile.TemporaryDirectory(prefix="pipeline_") as tmp:
        path = os.path.join(tmp, "recipe.json")
        with open(path, "w") as f:
            json.dump(recipe, f)
        run = os.path.join(tmp, "run")
        cfg = dataclasses.replace(RunConfig().with_recipe(path),
                                  checkpoint_dir=run)
        trainloader, valloader, testloader = build_dataset(cfg)[:3]
        steps = cfg.epochs * len(trainloader)
        evals = cfg.epochs * (len(valloader) + len(testloader))
        common = ["--recipe", path, "--checkpoint_dir", run]

        # ---- train: K2-train / K3a / K3b a step, K2 an eval batch ----
        counters()
        t0 = time.time()
        assert cli.main(["train", *common]) == 0
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for k, v in counters().items() if v}
        mngr = CheckpointManager(run)
        last = torch.load(mngr._path(mngr.latest_step()), map_location="cpu",
                          weights_only=True)["metadata"]["last_log"]
        print(f"pipeline train: {steps} steps of B={B} x {PIPE_SECONDS} s "
              f"and {evals} eval batches in {wall:.2f} s; last epoch train "
              f"loss {last['train_loss']:.4f}, val loss "
              f"{last['val_loss']:.4f}, val si_snr {last['val_si_snr']:.3f} "
              f"dB; launches {counts}", flush=True)
        assert all(np.isfinite(v) for v in last.values()), last
        assert counts == {"layer_tail_train": n_layers * (steps + evals),
                          "layer_tail_hist": n_layers * steps,
                          "layer_tail_bwd": n_layers * steps}, counts

        # ---- convert: every stage, its metrics, time and launches ----
        n_val = len(valloader)
        expect = {
            "restore": {}, "baseline": {"layer_tail_train": n_layers * n_val},
            "store_activations": {"fused_s5": n_layers},
            "naive_scan": {}, "qat": {}, "qaft": {}, "calibrate": {},
            "static_quant": {}, "engine": {"engine_network": n_val},
            "qaft_static": {}}
        stages = []

        def listen(name, seconds, results):
            launched = {k: v for k, v in counters().items() if v}
            stages.append(name)
            res = results.get(name)
            metrics = (res["history"][-1] if isinstance(res, dict)
                       and "history" in res else res)
            print(f"pipeline stage {name}: {seconds:.3f} s, "
                  f"{_stage_metrics(metrics)}, launches {launched}",
                  flush=True)
            assert launched == expect[name], (name, launched)
            if isinstance(metrics, dict):
                assert all(np.isfinite(float(v)) for v in metrics.values()
                           if not isinstance(v, (dict, list))), metrics
            captured.update(results)

        captured = {}
        convert_mod.stage_listeners.append(listen)
        stage_flags = ["--validate_baseline", "true",
                       "--store_activations", "true",
                       "--validate_naive_scan", "true",
                       "--validate_aqt", "true", "--train_aqt", "true",
                       "--calibrate_quant", "true",
                       "--validate_static_quant", "true",
                       "--validate_engine", "true",
                       "--train_static_quant", "true", "--qaft_epochs", "1"]
        counters()
        t0 = time.time()
        try:
            assert cli.main(["convert", *common, *stage_flags]) == 0
        finally:
            convert_mod.stage_listeners.remove(listen)
        print(f"pipeline convert: {time.time() - t0:.2f} s", flush=True)
        assert stages == list(expect), stages
        base = captured["baseline"]["si_snr"]
        static = captured["static_quant"]["si_snr"]
        eng = captured["engine"]["si_snr"]
        print(f"pipeline SI-SNR gates: |static - baseline| "
              f"{abs(static - base):.4f} dB (< 1), |engine - baseline| "
              f"{abs(eng - base):.4f} dB (< 1), |engine - static| "
              f"{abs(eng - static):.4f} dB (< 0.5)", flush=True)
        assert abs(static - base) < 1.0 and abs(eng - base) < 1.0
        assert abs(eng - static) < 0.5
        store = ArtifactStore(os.path.join(run, "conversion"))
        for name in ("frozen_params", "frozen_stats", "activations",
                     "activation_inputs", "qaft_params"):
            assert store.exists(name), name
        assert os.path.exists(os.path.join(run, "val_metrics.json"))

        # ---- from_artifacts: the stored tree serves the same engine ----
        noisy, clean = next(iter(valloader))
        noisy_mag = convert_mod._features(noisy, clean, "cuda")[0]
        x = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()
        served = W8A16Engine.from_artifacts(run, cfg)
        stage_engine = convert_mod.engine_from_frozen(
            cfg, captured["frozen_params"], captured["frozen_stats"])
        counters()
        t0 = time.time()
        mask = served(x)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        counts = {k: v for k, v in counters().items() if v}
        ref = stage_engine(x)
        print(f"pipeline from_artifacts: offline call B={x.shape[0]}, "
              f"L={x.shape[1]} in {wall:.2f} ms, launches {counts}, equal "
              f"to the convert stage's engine: "
              f"{bool(torch.equal(mask, ref))}", flush=True)
        assert counts == {"engine_network": 1}, counts
        assert torch.isfinite(mask).all() and torch.equal(mask, ref)

        # ---- fxp: the integer golden engine over the same artifacts ----
        fxp_pipeline_phase(cfg, common, run, captured, valloader, counters,
                           records, full_x)


#: the flagship's formats in the fixed-point recurrence: 16-bit states,
#: Lambda-bar at 2^-15, 12 guard bits (``FxpSSM.guard_bits``)
FXP_STATE_BITS, FXP_A_EXP, FXP_GUARD = 16, 15, 12


def _fxp_scan_args(gen, b: int, length: int, p: int):
    """Seeded operands of ``fxp_scan`` at the flagship's formats on the
    card: 16-bit B-bar-u codes (a quarter of the channels 8 x larger),
    |lambda| in [0.9, 0.999) and 0.9995 on that quarter, so those states
    saturate at both bounds."""
    import torch
    q = p // 4
    ang = 0.5 * torch.rand(p, generator=gen)
    mag = 0.9 + 0.099 * torch.rand(p, generator=gen)
    mag[:q] = 0.9995
    top = (1 << (FXP_STATE_BITS - 1)) - 1
    scale = float(1 << FXP_A_EXP)
    a_re = torch.round(mag * torch.cos(ang) * scale).clamp(-top, top)
    a_im = torch.round(mag * torch.sin(ang) * scale).clamp(-top, top)
    bu = 2000.0 * torch.randn((2, b, length, p), generator=gen)
    bu[..., :q] *= 8.0
    bu = torch.round(bu).clamp(-top - 1, top).to(torch.int32).to("cuda")
    shift = FXP_A_EXP - FXP_GUARD
    bounds = (-top - 1, top)
    return (bu[0], bu[1], a_re.to(torch.int32).to("cuda"),
            a_im.to(torch.int32).to("cuda"), (shift, shift), FXP_GUARD,
            bounds, bounds)


def fxp_scan_kernel_phase(frames: int, gen, records) -> None:
    """Phase 23: fxp_scan against its plain version on the card (module
    docstring, item 23)."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import fxp_scan
    p = 128
    args = _fxp_scan_args(gen, B, frames, p)
    out = fxp_scan.fxp_scan_cuda(*args)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = fxp_scan.fxp_scan_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max((o.long() - r.long()).abs().max().item()
              for o, r in zip(out, ref))
    lo, hi = args[6]
    sat = [((x == lo) | (x == hi)).float().mean().item() for x in ref]
    print(f"fxp_scan B={B} L={frames} P={p}: max code diff {err} (limit "
          f"0), saturated share re {sat[0]:.4f} im {sat[1]:.4f}, plain "
          f"{plain_ms:.1f} ms", flush=True)
    assert err == 0, "fxp_scan differs from its plain version"
    assert all(bool((x == lo).any()) and bool((x == hi).any())
               for x in ref), "no state saturated"
    ms = _median_ms(lambda: fxp_scan.fxp_scan_cuda(*args))
    # 16 bytes per (b, t, p): bu re / im in, x re / im out; about 30
    # integer operations per (b, t, p), counted at the CUDA cores' rate
    elems = B * frames * p
    bound, by = _bound_ms(16 * elems, 30 * elems)
    print(f"fxp_scan: {ms:.4f} ms (median of 5; bound {bound:.4f} by "
          f"{by}, {100 * bound / ms:.1f} %)", flush=True)
    records["fxp_scan"] = dict(
        name="fxp_scan", route="cuda",
        source="sparsernns_tpu_torch/ops/cuda/csrc/fxp_scan.cu",
        replaces="sparsernns_tpu/fxp/model.py:362-378 lax.scan "
                 "(no pallas_call)",
        launches=0, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None)


def fxp_pipeline_phase(cfg, common, run, captured, valloader, counters,
                       records, full_x) -> None:
    """Phase 22's fixed-point part: ``cli.main fxp`` in each mode over
    the run's artifacts, the gates, the CPU run of the same artifacts, the
    full-length forward (module docstring, item 22)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch import cli
    from sparsernns_tpu_torch.fxp import runner
    from sparsernns_tpu_torch.quantize import convert as convert_mod
    from sparsernns_tpu_torch.train.checkpoint import ArtifactStore
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN

    n_layers, n_val = cfg.n_layers, len(valloader)
    expect = {"inference": {"fxp_scan": n_layers * n_val},
              "verify": {"fxp_scan": n_layers}, "export": {}}
    for mode, want in expect.items():
        counters()
        t0 = time.time()
        assert cli.main(["fxp", *common, "--fxp_mode", mode]) == 0
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for k, v in counters().items() if v}
        print(f"pipeline fxp {mode}: {wall:.2f} s, launches {counts}",
              flush=True)
        assert counts == want, (mode, counts)
        if mode == "inference":
            records["fxp_scan"]["launches"] = counts["fxp_scan"]

    metrics = json.load(open(os.path.join(run, "fxp_val_metrics.json")))
    acc = metrics["Val Acc - fxp"]
    base = captured["baseline"]["si_snr"]
    static = captured["static_quant"]["si_snr"]
    print(f"pipeline fxp: val loss {metrics['Val Loss - fxp']:.4f}, SI-SNR "
          f"{acc:.4f} dB; gates |fxp - baseline| {abs(acc - base):.4f} dB "
          f"(< 1.5), |fxp - static| {abs(acc - static):.4f} dB (< 0.5)",
          flush=True)
    assert np.isfinite(metrics["Val Loss - fxp"])
    assert abs(acc - base) < 1.5 and abs(acc - static) < 0.5

    card = json.load(open(os.path.join(run, "verification", "stats.json")))
    cpu_dir = os.path.join(run, "verification_cpu")
    cpu_summary = runner.run_verification(cfg, output_dir=cpu_dir,
                                          device="cpu")
    cpu = json.load(open(os.path.join(cpu_dir, "stats.json")))
    # the encoder's output, and per layer the mixer's input and pre_GLU,
    # and the states (re, im) where the float mixer returned them (not on
    # the fused route, as in the JAX package)
    golden = ArtifactStore(os.path.join(run, "conversion")).load(
        "activations")
    with_states = any("pre_C" in key for key in golden)
    want = 1 + n_layers * (4 if with_states else 2)
    print(f"pipeline fxp verify: {len(card['blocks'])} blocks on the card, "
          f"{cpu_summary['matched_blocks']} on the CPU (want {want}), "
          f"statistics equal: {card == cpu}; worst "
          f"{card['summary']['worst_block']} rel_mean "
          f"{card['summary']['worst_rel_mean']:.3e}", flush=True)
    assert cpu_summary["matched_blocks"] == len(card["blocks"]) == want
    assert card == cpu
    export = os.path.join(run, "fxp_export")
    manifest = json.load(open(os.path.join(export, "manifest.json")))
    assert manifest["format_version"] == 1
    assert np.load(os.path.join(export, "weights.npz")).files

    # one validation batch, and the full length: card = CPU bit for bit
    card_model = runner.load_fxp_model(cfg, "cuda")[0]
    cpu_model = runner.load_fxp_model(cfg, "cpu")[0]
    noisy, clean = next(iter(valloader))
    x = (convert_mod._features(noisy, clean, "cpu")[0]
         - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    same = torch.equal(card_model(x.cuda()).data.cpu(), cpu_model(x).data)
    print(f"pipeline fxp: validation batch B={x.shape[0]}, L={x.shape[1]}: "
          f"card = CPU bit for bit: {same}", flush=True)
    assert same
    tag = f"fxp forward B={full_x.shape[0]} L={full_x.shape[1]}"
    y, _ = _timed_region(tag, lambda: card_model(full_x),
                         {"fxp_scan": n_layers}, counters)
    t0 = time.time()
    y_cpu = cpu_model(full_x.cpu())
    cpu_s = time.time() - t0
    same = torch.equal(y.data.cpu(), y_cpu.data)
    print(f"{tag}: card = CPU bit for bit: {same} (CPU {cpu_s:.1f} s)",
          flush=True)
    assert same


def _stage_metrics(metrics) -> str:
    if not isinstance(metrics, dict):
        return "no metrics"
    keys = [k for k in ("loss", "si_snr", "train_loss", "train_si_snr",
                        "val_loss", "val_si_snr", "train_scale_grad_leak",
                        "n") if k in metrics]
    return ", ".join(f"{k} {float(metrics[k]):.4f}" for k in keys)


def kernel_launches() -> dict:
    """Every kernel's launch count by record name since the last call, and
    the bidirectional mixer's route counts (the launch ledger of
    ``utils/trace.py``, a Counter: 0 for a name never counted; K1's passes,
    which its plans fix, left out), then the ledger zeroed."""
    from sparsernns_tpu_torch.utils.trace import launch_counts as ledger
    counts = ledger(reset=True)
    del counts["diag_scan_passes"]
    return counts


def check_launches(tag, counts, expect) -> None:
    """``counts`` equal to ``expect`` (name -> count; a name not in it: 0)
    in both directions: an expected launch that never came fails as an
    unexpected one does."""
    for name in set(counts) | set(expect):
        assert counts.get(name, 0) == expect.get(name, 0), (
            tag, name, counts, expect)


def engine_setup(cfg, model, noisy_mag):
    """Calibrate the float model on two synthetic batches of 8 clips of 4 s,
    freeze it and build the w8a16 engine (block 512). Returns a namespace:
    ``engine``, ``frozen`` (params, stats), ``cal_x`` (the calibration
    features), ``x_eng`` (the engine's features of the 30 s batch)."""
    import types

    import numpy as np
    import torch

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.quantize.calibrate import calibrate
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    dev = torch.device("cuda")
    t0 = time.time()
    recipe = quantization_recipes[cfg.convert_quantization]
    cal_model = build_model(
        cfg, 257, 257, device=dev, seed=0, scan_mode="sequential",
        q_config=recipe(static_quant=True, calibrating=True))
    cal_ds = SyntheticNDNS(size=2 * B, length=CAL_SECONDS * 16000, seed=7)
    cal_audio = torch.from_numpy(np.stack(
        [cal_ds[i][0] for i in range(2 * B)])).to(dev)
    cal_x = (stft_splitter(cal_audio)[0] - STFT_MAG_MEAN).transpose(1, 2)
    frozen = calibrate(cal_model, model.state_dict(),
                       [cal_x[:B], cal_x[B:]])
    engine = engine_from_frozen(cfg, *frozen, device=dev, block_t=512)
    print(f"engine set-up (calibrate 2 x {B} clips of {CAL_SECONDS} s, "
          f"freeze, pack): {time.time() - t0:.1f} s", flush=True)
    x_eng = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    assert all(lay.w_b.dtype == torch.int8 and lay.state_requant is not None
               and lay.residual_requant is not None for lay in engine.layers)
    return types.SimpleNamespace(engine=engine, frozen=frozen, cal_x=cal_x,
                                 x_eng=x_eng)


def _engine_work(cfg, p: int):
    """(f32 flops, weight bytes) a frame of one float-dot engine layer."""
    h = cfg.d_model
    n_dense = {"full": 2, "half1": 1, "half2": 1, "none": 0}[cfg.glu_variant]
    flops = (2 * h * 2 * p + 2 * 2 * p * h + n_dense * 2 * h * h + 8 * p
             + 6 * h)
    w_bytes = 2 * h * 2 * p + n_dense * h * h + 4 * (3 * h + 2 * p
                                                     + n_dense * h)
    return flops, w_bytes


def _check_dots(name: str, dots, launched, tensor_cores: bool,
                n_dense: int = 0) -> None:
    """Each launch's float-dot dense products (``read_launched_dots``):
    with int8 weights every one on the tensor cores, else every one as
    fmaf tiles; a scan runs none; ``n_dense`` in all where given."""
    print(f"{name}: dense products (tensor cores, fmaf) a launch {dots}",
          flush=True)
    assert len(dots) == len(launched), (name, dots, launched)
    for (kernel, _), (mma, fmaf) in zip(launched, dots):
        if kernel == "engine_scan_pass_kernel":
            assert (mma, fmaf) == (0, 0), (name, kernel, mma, fmaf)
        else:
            assert (fmaf if tensor_cores else mma) == 0, (name, mma, fmaf)
    if n_dense:
        assert sum(m + f for m, f in dots) == n_dense, (name, dots)


def _check_passes(name: str, got, plan, min_row_ctas: int = 1) -> None:
    """The passes a call launched, as its CUDA source recorded them, are the
    plan's, and every row pass has at least ``min_row_ctas`` CTAs."""
    from sparsernns_tpu_torch.ops.cuda.engine_layer import ROW_PASS
    print(f"{name} passes (kernel, CTAs): {got}", flush=True)
    assert got == plan.passes(), (name, got, plan.passes())
    rows = [c for k, c in got if k == ROW_PASS]
    assert rows and min(rows) >= min_row_ctas, (name, rows, min_row_ctas)


def _digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes (bf16
    read as its bits): equal digests, equal values."""
    import hashlib

    import torch
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _check_k2_passes(name: str, b: int, length: int) -> None:
    """K2's last call launched its three passes, as the CUDA source
    recorded them: the B-projection, the scan and the tail, each product
    pass at least ceil(B * L / 128) CTAs."""
    from sparsernns_tpu_torch.ops.cuda import layer_tail
    got = layer_tail.launched()
    print(f"{name} passes (kernel, CTAs): {got}", flush=True)
    assert [k for k, _ in got] == [layer_tail.BPROJ_PASS,
                                   layer_tail.SCAN_PASS,
                                   layer_tail.ROW_PASS], (name, got)
    floor = -(-b * length // 128)
    assert all(c >= floor for k, c in got if k != layer_tail.SCAN_PASS), (
        name, got, floor)


def _check_mixer_passes(name: str, b: int, length: int, h: int,
                        p: int) -> None:
    """K4a's / K4b's last call launched the passes of its plan (a head row
    pass, the scan, a tail row pass), each row pass at least
    ceil(B * L / 128) CTAs."""
    from sparsernns_tpu_torch.ops.cuda import engine_layer, fused_s5
    _check_passes(name, fused_s5.launched(),
                  engine_layer.pass_plan(b, length, h, p, 1, encoder=False),
                  -(-b * length // 128))


def _check_k1(name: str, lam, bu, carry=None, reverse=False,
              block_requant=None, block_t=None) -> float:
    """One K1 call on the card held against its plain version (the
    sequential recurrence; float modes 1e-5 of max|x|, the block requant
    ``_codes_of``'s bar, and whether it is bit-equal, as the block pass
    makes it) and bit for bit against the plain mirror of its
    plan (``diag_scan_chunked_plain``); its launches, as the CUDA source
    recorded them, against ``scan_plan`` (at B >= 8, L = 3751, P = 128
    every pass over (B, L, P) at least 132 CTAs); prints the digest of
    its output. Returns the error against plain."""
    import torch

    from sparsernns_tpu_torch.ops.cuda import diag_scan
    args = (lam, bu, carry, reverse, block_requant, block_t)
    out = diag_scan.diag_scan_cuda(*args)
    torch.cuda.synchronize()
    got = diag_scan.launched()
    b, length, p = bu[0].shape
    plan = diag_scan.scan_plan(
        b, length, p, None if block_requant is None else block_t, reverse)
    print(f"{name} launches (pass, grid, threads): {got}", flush=True)
    assert got == plan.launches(), (name, got, plan.launches())
    if b >= 8 and (length, p) == (3751, 128):
        assert all(g[0] * g[1] * g[2] >= 132 for k, g, _ in got
                   if k != diag_scan.CARRY_PASS), (name, got)
    mirror = diag_scan.diag_scan_chunked_plain(*args)
    same = all(torch.equal(o, m) for o, m in zip(out, mirror))
    print(f"{name} vs the plain mirror of its plan: bit-equal {same}",
          flush=True)
    assert same, name
    ref = diag_scan.diag_scan_plain(*args)
    if block_requant is None:
        scale = max(r.abs().max().item() for r in ref)
        err = max((o - r).abs().max().item() for o, r in zip(out, ref))
        _check(f"{name} vs plain", err, 1e-5 * scale)
    else:
        err = max(_codes_of(f"{name} vs plain ({half})", o, r, sc)
                  for half, o, r, sc in zip(("re", "im"), out, ref,
                                            block_requant[:2]))
        again = diag_scan.block_rewalks(*args)
        print(f"{name}: bit-equal to plain "
              f"{all(torch.equal(o, r) for o, r in zip(out, ref))}; block "
              f"pass warps that walked again {int(again.sum().item())} of "
              f"{again.numel()}, at most "
              f"{int(again.sum(dim=1).max().item())} in one (batch row, "
              f"slice)", flush=True)
    print(f"{name} output digest: {_digest(out[0])}-{_digest(out[1])}",
          flush=True)
    return err


def _check_k1_buffers(name: str, lam, bu_cat) -> float:
    """K1's launch options for the bidirectional mixer's buffers on one
    (B, L, 2P) projection, both directions: the states written into their
    column blocks of a (B, L, 4P) matrix, and the adjoint's (the other way
    with conj(λ), over bu as the cotangent) written into a (B, L, 2P)
    buffer and added to what another held, bit for bit against the plain
    mirror of the plan (``diag_scan_chunked_plain``); dλ's partials, once
    reduced, within 1e-5 of the sum of the terms' magnitudes of
    ``_dlam`` in float64, and the same partials on each of the three
    calls. Returns the worst dλ gap over that sum."""
    import torch

    from sparsernns_tpu_torch.ops import scan
    from sparsernns_tpu_torch.ops.cuda import diag_scan
    b, length, p2 = bu_cat.shape
    p = p2 // 2
    dev = bu_cat.device
    bu = (bu_cat[..., :p], bu_cat[..., p:])
    buf = torch.full((b, length, 4 * p), float("nan"), device=dev)
    fresh = torch.full((b, length, 2 * p), float("nan"), device=dev)
    acc = torch.randn((b, length, 2 * p),
                      generator=torch.Generator().manual_seed(b + p)).to(dev)
    worst = 0.0
    for k, reverse in enumerate((False, True)):
        cols = (buf[..., k * p:(k + 1) * p], buf[..., (k + 2) * p:(k + 3) * p])
        diag_scan.diag_scan_cuda(lam, bu, reverse=reverse, out=cols)
        want = diag_scan.diag_scan_chunked_plain(lam, bu, reverse=reverse)
        same = all(torch.equal(c, w) for c, w in zip(cols, want))
        v_want = torch.cat(diag_scan.diag_scan_chunked_plain(
            (lam[0], -lam[1]), bu, reverse=not reverse), dim=-1)
        v, parts = diag_scan.diag_scan_adjoint_cuda(lam, bu, cols, reverse)
        same_v = torch.equal(torch.cat(v, dim=-1), v_want)
        _, parts_out = diag_scan.diag_scan_adjoint_cuda(
            lam, bu, cols, reverse, out=(fresh[..., :p], fresh[..., p:]))
        acc0 = acc.clone()
        _, parts_acc = diag_scan.diag_scan_adjoint_cuda(
            lam, bu, cols, reverse, out=(acc[..., :p], acc[..., p:]),
            accumulate=True)
        same_out = torch.equal(fresh, v_want)
        same_acc = torch.equal(acc, acc0 + v_want)
        same_parts = (torch.equal(parts_out, parts)
                      and torch.equal(parts_acc, parts))
        got = torch.stack(diag_scan.reduce_dlam(parts)).double()
        v64 = tuple(t.double() for t in v)
        x64 = tuple(t.double() for t in cols)
        ref = torch.stack(scan._dlam(v64, x64, reverse))
        va = tuple(t.abs() for t in v64)
        mag = torch.stack([
            scan._dlam(va, tuple(t.abs() for t in x64), reverse)[0],
            scan._dlam(va, (x64[0].abs(), -x64[1].abs()), reverse)[1]])
        ratio = float(((got - ref).abs() / mag).max())
        worst = max(worst, ratio)
        del v64, x64, va, v_want, acc0
        print(f"{name} reverse={reverse}: states into the 4P columns "
              f"bit-equal {same}, adjoint {same_v}, into 2P {same_out}, "
              f"accumulated {same_acc}, partials the same on each call "
              f"{same_parts}", flush=True)
        assert same and same_v and same_out and same_acc and same_parts, name
        _check(f"{name} reverse={reverse} dλ vs _dlam in float64, over the "
               "sum of its terms' magnitudes", ratio, 1e-5)
    assert not torch.isnan(buf).any(), name
    return worst


def _k1_bytes(b: int, length: int, p: int, carry: bool) -> int:
    """Bytes K1 must move: bu read once, the states written once, λ, and
    the carry in."""
    return 2 * b * length * p * 4 * 2 + 2 * p * 4 + (
        2 * b * p * 4 if carry else 0)


def engine_kernel_phase(cfg, eng, gen, records) -> None:
    """Phase 4: K6 (the whole network, its row and scan passes), K5a (one
    layer over the int16-code stream) and K5b (from a non-zero carry, at
    the full length and one 128-frame block) against their plain versions
    at B = 8, L = 3751, block 512, timed; K6 and K5a at B = 32; a ragged
    call (B = 3, L = 70: 210 rows, not a multiple of the row tile, L below
    the block); every variant of the engine kernels on both routes. B = 32
    and ragged inputs come from a generator of their own, so that later
    phases draw what they drew before."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.cuda import engine_layer, engine_network
    from sparsernns_tpu_torch.ops.cuda.engine_layer import pass_plan
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.utils.profiling import profile_region
    dev = torch.device("cuda")
    engine, x_eng = eng.engine, eng.x_eng
    frozen_params, frozen_stats = eng.frozen
    mode, layers = engine.mode, engine.layers
    h, n_layers, frames = cfg.d_model, cfg.n_layers, x_eng.shape[1]
    p = layers[0].p
    rows = B * frames
    layer_flops, layer_w_bytes = _engine_work(cfg, p)
    summary = {}
    with torch.no_grad():
        # K6, the default offline route, at its own block rule
        net_args = (x_eng, engine._enc, layers, engine._dec, mode)
        ref = engine_network.engine_network_plain(*net_args, block_t=512)
        out = engine_network.engine_network_cuda(*net_args, block_t=512)
        torch.cuda.synchronize()
        # the encoder, each layer's B-, C-projection and GLU gate, the
        # decoder: every dense of the w8a16 engine on the tensor cores
        _check_dots("K6 B=8", engine_layer.read_launched_dots(
            "engine_network"), engine_network.launched(), True,
            2 + 3 * n_layers)
        err = (out - ref).abs().max().item()
        ref_scale = max(1.0, ref.abs().max().item())
        _check("K6 engine_network vs plain (mask)", err, 2e-3 * ref_scale)
        _check("K6 engine_network vs plain (mask, mean)",
               (out - ref).abs().mean().item(), 1e-4 * ref_scale)
        ms = _time_ms(lambda: engine_network.engine_network_cuda(
            *net_args, block_t=512), 3)
        plain_ms = _time_ms(lambda: engine_network.engine_network_plain(
            *net_args, block_t=512), 1, 0)
        bound, by = _bound_ms(
            2 * rows * 257 * 4 + n_layers * layer_w_bytes + 2 * 257 * h
            + 4 * (h + 257),
            rows * (2 * 257 * h + n_layers * layer_flops + 2 * h * 257))
        records["engine_network"] = dict(
            name="engine_network", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/engine_network.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_network.py:299",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)
        # the device time of its row passes and of its scans
        print(json.dumps(profile_region(
            "K6 B=8, one call", lambda: engine_network.engine_network_cuda(
                *net_args, block_t=512), top=6)), flush=True)

        # K5a: the middle layer over the int16-code stream that the plain
        # first layer writes
        r0 = engine_layer.engine_layer_plain(
            x_eng, layers[0], mode, block_t=512, enc=engine._enc)
        assert r0.dtype == torch.int16, r0.dtype
        kw = dict(block_t=512, in_requant=layers[0].residual_requant)
        ref = engine_layer.engine_layer_plain(r0, layers[1], mode, **kw)
        out = engine_layer.engine_layer_cuda(r0, layers[1], mode, **kw)
        torch.cuda.synchronize()
        err = _code_diff("K5a engine_layer vs plain (int16 codes)", out, ref)
        ms = _time_ms(lambda: engine_layer.engine_layer_cuda(
            r0, layers[1], mode, **kw), 5)
        plain_ms = _time_ms(lambda: engine_layer.engine_layer_plain(
            r0, layers[1], mode, **kw), 1, 0)
        bound, by = _bound_ms(2 * rows * h * 2 + layer_w_bytes,
                              rows * layer_flops)
        records["engine_layer"] = dict(
            name="engine_layer", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/engine_layer.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer.py:629",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)

        # K5b: the same layer from a non-zero carry, at the full length
        # and at the streaming shape (one block of 128 frames), which is
        # the one timed
        carry = tuple(0.05 * torch.randn((B, p), generator=gen).to(dev)
                      for _ in range(2))
        errs = []
        for name, r_in, bt in (("L=3751, block 512", r0, 512),
                               ("L=128, block 128", r0[:, :STREAM_BLOCK],
                                STREAM_BLOCK)):
            kw = dict(block_t=bt, in_requant=layers[0].residual_requant,
                      carry=carry)
            ref, ref_c = engine_layer.engine_layer_plain(
                r_in, layers[1], mode, **kw)
            out, out_c = engine_layer.engine_layer_cuda(
                r_in, layers[1], mode, **kw)
            torch.cuda.synchronize()
            errs.append(_code_diff(f"K5b engine_layer_carry vs plain, {name}",
                                   out, ref))
            # the engine bar: the tensor cores sum the B-projection in
            # another order than plain, and a state at a tie between two
            # codes may take the other
            for half, o, r in zip(("re", "im"), out_c, ref_c):
                _engine_close(f"K5b carry out {half}, {name}", o, r)
        ms = _time_ms(lambda: engine_layer.engine_layer_cuda(
            r_in, layers[1], mode, **kw), 20)
        plain_ms = _time_ms(lambda: engine_layer.engine_layer_plain(
            r_in, layers[1], mode, **kw), 1, 0)
        s_rows = B * STREAM_BLOCK
        bound, by = _bound_ms(
            2 * s_rows * h * 2 + layer_w_bytes + 4 * B * p * 4,
            s_rows * layer_flops)
        records["engine_layer_carry"] = dict(
            name="engine_layer_carry", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/engine_layer.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer.py:729",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)
        _check_passes("K5b one 128-frame block", engine_layer.launched(),
                      pass_plan(B, STREAM_BLOCK, h, p, 1, encoder=False))
        print(json.dumps(profile_region(
            "K5b one 128-frame block, one call",
            lambda: engine_layer.engine_layer_cuda(r_in, layers[1], mode,
                                                   **kw), top=6)),
              flush=True)

        # ---- B = 32: K6 and K5a against plain (the plain calls take
        # seconds), timed ----
        g32 = torch.Generator().manual_seed(32)
        x32 = torch.cat([x_eng] + [
            x_eng + 0.1 * torch.randn(x_eng.shape, generator=g32).to(dev)
            for _ in range(3)])
        eng.x32 = x32
        a32 = (x32, engine._enc, layers, engine._dec, mode)
        ref = engine_network.engine_network_plain(*a32, block_t=512)
        out = engine_network.engine_network_cuda(*a32, block_t=512)
        _engine_close("K6 engine_network vs plain at B=32 (mask)", out, ref)
        _check_passes("K6 B=32", engine_network.launched(),
                      pass_plan(4 * B, frames, h, p, n_layers))
        summary["K6 B=32 ms"] = _median_ms(
            lambda: engine_network.engine_network_cuda(*a32, block_t=512))
        r32 = engine_layer.engine_layer_plain(
            x32, layers[0], mode, block_t=512, enc=engine._enc)
        kw = dict(block_t=512, in_requant=layers[0].residual_requant)
        _code_diff("K5a engine_layer vs plain at B=32 (int16 codes)",
                   engine_layer.engine_layer_cuda(r32, layers[1], mode, **kw),
                   engine_layer.engine_layer_plain(r32, layers[1], mode,
                                                   **kw))
        summary["K5a B=32 ms"] = _median_ms(
            lambda: engine_layer.engine_layer_cuda(r32, layers[1], mode,
                                                   **kw))
        del ref, out, r32

        # ---- ragged: 210 rows (6 row tiles and one of 18), L < block_t;
        # K6, the K5a stack (= K6 exactly), K5a with the decoder on the
        # plain stream, K5b ----
        xr = x_eng[:3, :70].contiguous()
        ref = engine_network.engine_network_plain(
            xr, engine._enc, layers, engine._dec, mode, block_t=512)
        out = engine_network.engine_network_cuda(
            xr, engine._enc, layers, engine._dec, mode, block_t=512)
        _engine_close("K6 ragged B=3, L=70 vs plain (mask)", out, ref)
        _check_passes("K6 ragged", engine_network.launched(),
                      pass_plan(3, 70, h, p, n_layers))
        stk, in_rq = xr, None
        for i, lay in enumerate(layers):
            stk = engine_layer.engine_layer_cuda(
                stk, lay, mode, block_t=512, in_requant=in_rq,
                enc=engine._enc if i == 0 else None,
                dec=engine._dec if i == n_layers - 1 else None)
            in_rq = lay.residual_requant
        _check("K6 ragged vs the K5a stack (bit-identical)",
               (out - stk).abs().max().item(), 0.0)
        r0r = engine_layer.engine_layer_plain(xr, layers[0], mode,
                                              block_t=512, enc=engine._enc)
        kw = dict(block_t=512, in_requant=layers[0].residual_requant,
                  dec=engine._dec)
        _engine_close("K5a ragged, with the decoder, vs plain",
                      engine_layer.engine_layer_cuda(r0r, layers[1], mode,
                                                     **kw),
                      engine_layer.engine_layer_plain(r0r, layers[1], mode,
                                                      **kw))
        carry = tuple(0.05 * torch.randn((3, p), generator=g32).to(dev)
                      for _ in range(2))
        kw = dict(block_t=512, in_requant=layers[0].residual_requant,
                  carry=carry)
        ref, ref_c = engine_layer.engine_layer_plain(r0r, layers[1], mode,
                                                     **kw)
        out, out_c = engine_layer.engine_layer_cuda(r0r, layers[1], mode,
                                                    **kw)
        _code_diff("K5b ragged vs plain", out, ref)
        for half, o, r in zip(("re", "im"), out_c, ref_c):
            _engine_close(f"K5b ragged carry out {half}", o, r)
        _check_passes("K5b ragged", engine_layer.launched(),
                      pass_plan(3, 70, h, p, 1, encoder=False))

        # every variant of the engine kernels (the recipe runs half1 +
        # gelu + prenorm over int8 weights and an int16-code stream): GLU
        # kinds, relufication, postnorm, float32 activations, bf16 io,
        # int16 and float weights with a bf16 stream, at the full width on
        # a short sequence with a short last block; both routes against
        # the plain network and against each other
        full_params = copy.deepcopy(frozen_params)
        for i in range(n_layers):       # a value dense for the "full" GLU
            lay = full_params["encoder"][f"layers_{i}"]
            lay["out1"] = {k: np.roll(lay["out2"][k], 1, axis=0)
                           for k in ("kernel", "bias")}
        xs = x_eng[:2, :300]
        variants = [dict(glu_variant=g, relufication=r, prenorm=pn)
                    for g in ("full", "half1", "half2", "none")
                    for r, pn in ((False, True), (True, False))]
        variants += [dict(act_dtype=torch.float32),
                     dict(convert_quantization="w16a16"),
                     dict(convert_quantization="none"),
                     dict(io=torch.bfloat16)]
        for var in variants:
            var = dict(var)
            io = var.pop("io", torch.float32)
            act = var.pop("act_dtype", torch.bfloat16)
            v_eng = engine_from_frozen(
                dataclasses.replace(cfg, **var), full_params, frozen_stats,
                device=dev, block_t=128, act_dtype=act)
            x_in = xs.to(io)
            v_args = (x_in, v_eng._enc, v_eng.layers, v_eng._dec, v_eng.mode)
            ref = engine_network.engine_network_plain(
                *v_args, block_t=128, out_dtype=io).float()
            net = v_eng._apply_network(x_in, 128, io)
            stk = v_eng._apply_stack(x_in, 128, io)
            assert net.dtype == stk.dtype == io
            scale = max(1.0, ref.abs().max().item())
            name = f"K6/K5a {var or ''} act {act} io {io}"
            _check(f"{name} vs plain", (net.float() - ref).abs().max().item(),
                   (2e-2 if io == torch.bfloat16 else 2e-3) * scale)
            _check(f"{name} network vs stack",
                   (net.float() - stk.float()).abs().max().item(), 0.0)
            # int16 (w16a16) and f32 weights as fmaf tiles, int8 on the
            # tensor cores
            _check_dots(f"{name} K5a (last layer)",
                        engine_layer.read_launched_dots("engine_layer"),
                        engine_layer.launched(),
                        var.get("convert_quantization") not in ("w16a16",
                                                                "none"))
    print(json.dumps({"engine_kernel_phase": {
        **{k: records[k] for k in ("engine_network", "engine_layer",
                                   "engine_layer_carry")}, **summary}}),
          flush=True)


def engine_offline_phase(cfg, eng, feats, clean_t, float_metrics,
                         records) -> None:
    """Phase 5: ``engine(x)`` on the 30 s batch (K6 x 1: its passes as the
    CUDA source recorded them, every row pass at least one CTA an SM), the
    SHA-256 of its mask, median call times and peak memory at B = 8 and
    B = 32; the same through the per-layer stack (K5a x 3, bit-identical
    mask), and the engine on the card against the engine on the CPU."""
    import hashlib

    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.cuda import engine_layer, engine_network
    from sparsernns_tpu_torch.ops.cuda.engine_layer import pass_plan
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.train.losses import ndns_loss_from_mask_tm
    engine, x_eng = eng.engine, eng.x_eng
    frozen_params, frozen_stats = eng.frozen
    noisy_mag, noisy_phase, clean_mag = feats
    loss, snr = float_metrics
    h, n_layers, frames = cfg.d_model, cfg.n_layers, x_eng.shape[1]
    p = engine.layers[0].p

    def engine_metrics(mask):
        nm = noisy_mag.transpose(1, 2)
        loss_e, snr_e, _ = ndns_loss_from_mask_tm(
            mask, nm, noisy_phase.transpose(1, 2),
            clean_mag.transpose(1, 2), clean_t)
        return loss_e.item(), snr_e.item()

    kernel_launches()
    t0 = time.time()
    mask_net = engine(x_eng)
    torch.cuda.synchronize()
    eng_s = time.time() - t0
    counts = kernel_launches()
    records["engine_network"]["launches"] = counts["engine_network"]
    loss_e, snr_e = engine_metrics(mask_net)
    print(f"engine offline: call {eng_s * 1e3:.1f} ms, loss {loss_e:.4f}, "
          f"si_snr {snr_e:.3f} dB (float model: loss {loss:.4f}, si_snr "
          f"{snr:.3f} dB), K6 launches {counts['engine_network']}, K5a "
          f"{counts['engine_layer']}, K5b {counts['engine_layer_carry']}",
          flush=True)
    assert mask_net.shape == (B, frames, 257), mask_net.shape
    assert torch.isfinite(mask_net).all()
    assert np.isfinite(loss_e) and np.isfinite(snr_e)
    assert counts["engine_network"] == 1, counts
    assert counts["engine_layer"] == counts["engine_layer_carry"] == 0
    assert counts["diag_scan"] == counts["layer_tail_train"] == 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _check_passes("K6 engine offline call B=8", engine_network.launched(),
                  pass_plan(B, frames, h, p, n_layers), sms)
    digest = hashlib.sha256(
        mask_net.contiguous().cpu().numpy().tobytes()).hexdigest()
    print(f"K6 mask sha256 (engine offline call, B={B}): {digest}",
          flush=True)
    times = {}
    for bsz, x in ((B, x_eng), (4 * B, eng.x32)):
        times[f"offline call B={bsz} ms"] = _median_ms(lambda: engine(x))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine(x)
        torch.cuda.synchronize()
        times[f"offline call B={bsz} peak MiB above the inputs"] = (
            torch.cuda.max_memory_allocated() - base) / 2 ** 20
        times[f"scratch B={bsz} MiB"] = pass_plan(
            bsz, frames, h, p, n_layers).scratch_bytes() / 2 ** 20
    print(json.dumps({"engine_offline_phase": times}), flush=True)

    stack_engine = engine_from_frozen(cfg, frozen_params, frozen_stats,
                                      device=x_eng.device, block_t=512)
    stack_engine._network_ok = False
    kernel_launches()
    mask_stack = stack_engine(x_eng)
    torch.cuda.synchronize()
    counts = kernel_launches()
    records["engine_layer"]["launches"] = counts["engine_layer"]
    print(f"engine stack route: K5a launches {counts['engine_layer']}, K6 "
          f"{counts['engine_network']}, K5b {counts['engine_layer_carry']}",
          flush=True)
    assert counts["engine_layer"] == n_layers, counts
    assert counts["engine_network"] == counts["engine_layer_carry"] == 0
    _check_passes("K5a stack route, last launch", engine_layer.launched(),
                  pass_plan(B, frames, h, p, 1, encoder=False), sms)
    _check("engine network route vs stack route (bit-identical)",
           (mask_net - mask_stack).abs().max().item(), 0.0)
    cpu_engine = engine_from_frozen(cfg, frozen_params, frozen_stats,
                                    device="cpu", block_t=512)
    x_small = x_eng[:2, :200]
    # the engine bar: the card's int8 dots sum on the tensor cores in
    # another order than the CPU's, and a stream code at a tie may flip
    _engine_close("engine on the card vs engine on the CPU (plain)",
                  engine(x_small).cpu(), cpu_engine(x_small.cpu()))


def engine_streaming_phase(cfg, eng, noisy, out_shape, records) -> None:
    """Phase 6: ``StreamingDenoiser.from_engine`` at block 128 over the 30 s
    audio in 1 s chunks (K5b on every forward, nothing else; the output of
    the float stream's shape ``out_shape`` where given), the passes of one
    128-frame ``process_chunk``, and chunked ``process_chunk`` against one
    whole call (exact)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.ops.cuda import engine_layer
    from sparsernns_tpu_torch.ops.cuda.engine_layer import pass_plan
    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
    x_eng = eng.x_eng
    n_layers, frames = cfg.n_layers, x_eng.shape[1]
    n_chunks = -(-noisy.shape[1] // CHUNK)
    stream_engine = engine_from_frozen(cfg, *eng.frozen, device=x_eng.device,
                                       block_t=STREAM_BLOCK)
    eden = StreamingDenoiser.from_engine(stream_engine, batch_size=B)
    kernel_launches()
    t0 = time.time()
    out_eng = eden.process_offline(noisy, chunk_samples=CHUNK)
    torch.cuda.synchronize()
    estream_s = time.time() - t0
    counts = kernel_launches()
    records["engine_layer_carry"]["launches"] = counts["engine_layer_carry"]
    n_forwards = counts["engine_layer_carry"] // n_layers
    print(f"engine streaming: {n_chunks} chunks of {CHUNK} samples in "
          f"{estream_s * 1e3:.1f} ms, {n_forwards} forwards of "
          f"{STREAM_BLOCK}-frame blocks, K5b launches "
          f"{counts['engine_layer_carry']}, K5a {counts['engine_layer']}, "
          f"K6 {counts['engine_network']}", flush=True)
    assert out_shape is None or out_eng.shape == out_shape, out_eng.shape
    assert np.isfinite(out_eng).all()
    assert counts["engine_layer_carry"] % n_layers == 0
    assert n_forwards >= frames // STREAM_BLOCK, n_forwards
    assert counts["engine_layer"] == counts["engine_network"] == 0
    assert counts["diag_scan"] == counts["layer_tail_train"] == 0
    carries, parts = None, []
    for start in range(0, frames, STREAM_BLOCK):
        part, carries = stream_engine.process_chunk(
            x_eng[:, start:start + STREAM_BLOCK], carries)
        parts.append(part)
    _check("engine chunked process_chunk vs one whole call",
           (torch.cat(parts, dim=1) - stream_engine(x_eng)).abs().max()
           .item(), 0.0)    # the same device functions, the same blocks
    stream_engine.process_chunk(x_eng[:, :STREAM_BLOCK])
    _check_passes("K5b process_chunk, 128-frame block (last layer)",
                  engine_layer.launched(),
                  pass_plan(B, STREAM_BLOCK, cfg.d_model,
                            stream_engine.layers[-1].p, 1, encoder=False))


def _cls_batch(bsz: int, seq_len: int = 784, n_classes: int = 10):
    """The first batch of the synthetic classification set at the sMNIST
    shape (``seq_len`` steps of one input, ``n_classes`` classes), on the
    card: (inputs (B, L, 1), labels (B,) int64)."""
    import torch

    from sparsernns_tpu_torch.data.classification import \
        create_classification_dataset
    train = create_classification_dataset(
        bsz, seed=0, size=2 * bsz, seq_len=seq_len, d_input=1,
        n_classes=n_classes)[0]
    xs, ys = next(iter(train))
    return (torch.from_numpy(xs).cuda(),
            torch.from_numpy(ys).to(device="cuda", dtype=torch.int64))


def _grads_close(tag, metrics, params) -> None:
    """One train step on the card against the same step on the CPU at
    the training bars (loss and gradient norm 1e-3 relative, gradients
    2e-4 of each parameter's max(1, max|grad|), parameters 1e-5 in the
    mean): ``metrics`` and ``params`` are [card, CPU] lists of the
    step's metrics and {name: (parameter, gradient)} on the host. Adam's
    first step moves an element by about the learning rate in the
    direction of its gradient's sign, so an element whose gradient is
    rounding noise may differ by that much: the parameters are held in
    the mean, not the max."""
    (m_gpu, p_gpu), (m_cpu, p_cpu) = zip(metrics, params)
    for key in ("loss", "grad_norm"):
        if key not in m_cpu:
            continue
        ref = m_cpu[key].item()
        _check(f"{tag} on the card vs on the CPU, {key}",
               abs(m_gpu[key].item() - ref), 1e-3 * max(1.0, abs(ref)))
    _check(f"{tag} on the card vs on the CPU, gradients, relative to each "
           "parameter's max(1, max|grad|)",
           max(((p_gpu[n][1] - g).abs().max() / max(1.0, g.abs().max()))
               .item() for n, (_, g) in p_cpu.items()), 2e-4)
    _check(f"{tag} on the card vs on the CPU, parameters, mean abs "
           "difference", max((p_gpu[n][0] - q).abs().mean().item()
                             for n, (q, _) in p_cpu.items()), 1e-5)


def _host_params(model):
    return {n: (q.detach().cpu(), q.grad.cpu())
            for n, q in model.named_parameters()}


def _card_and_cpu(build, fn):
    """``fn(model, device)`` -> (metrics, model) for a model ``build(device)``
    on the card and on the CPU: ([metrics], [host parameters])."""
    import torch
    metrics, params = [], []
    for device in (torch.device("cuda"), torch.device("cpu")):
        m, model = fn(build(device), device)
        metrics.append(m)
        params.append(_host_params(model))
    return metrics, params


def classification_phase(cfg, root, records, counters) -> None:
    """Phase 24: the classification head at the flagship's width
    (module docstring, item 24)."""
    import tempfile

    import numpy as np
    import torch

    from sparsernns_tpu_torch import cli
    from sparsernns_tpu_torch.models.seq_model import RetrievalModel
    from sparsernns_tpu_torch.models.ssm import S5SSM
    from sparsernns_tpu_torch.models.ssm_init import blocked_dplr_init
    from sparsernns_tpu_torch.train.loop import build_model, create_run_state
    from sparsernns_tpu_torch.train.steps import (
        make_classification_eval_step, make_classification_train_step)
    from sparsernns_tpu_torch.utils.profiling import profile_region
    n_layers, bsz, n_cls = cfg.n_layers, 32, 10
    ccfg = dataclasses.replace(cfg, dataset="synthetic-classification",
                               bsz=bsz, mode="pool")
    xs, ys = _cls_batch(bsz)
    tail = dict.fromkeys(TAIL_KERNELS, n_layers)

    def fresh(config, device="cuda"):
        model = build_model(config, 1, n_cls, training=True, device=device,
                            seed=0)
        return model, create_run_state(config, model, steps_per_epoch=2)

    # ---- three recipe steps (dropout 0.1): K2-train, K3a, K3b x 3 each --
    model, state = fresh(ccfg)
    step = make_classification_train_step(model)
    for i in range(3):
        counters()
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = step(state, xs, ys)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        counts = counters()
        print(f"classification train B={bsz} step {i}: {wall:.1f} ms, loss "
              f"{m['loss'].item():.4f}, accuracy {m['accuracy'].item():.3f}, "
              f"grad_norm {m['grad_norm'].item():.3f}, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        assert np.isfinite(m["loss"].item()), m
        assert {k: v for k, v in counts.items() if v} == tail, counts
    prof = profile_region(f"classification train step B={bsz}",
                          lambda: step(state, xs, ys), top=12)
    print(json.dumps(prof), flush=True)
    print(f"classification train step B={bsz}: wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms, "
          f"busy share {prof['device_busy_share']:.3f}", flush=True)
    evaluate = make_classification_eval_step(model)
    counters()
    t0 = time.time()
    ev = evaluate(xs, ys)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = {k: v for k, v in counters().items() if v}
    print(f"classification eval B={bsz}: {wall:.1f} ms, loss "
          f"{ev['loss'].item():.4f}, accuracy {ev['accuracy'].item():.3f}, "
          f"launches {counts}", flush=True)
    assert counts == {"layer_tail_train": n_layers}, counts
    assert np.isfinite(ev["loss"].item()) and 0 <= ev["accuracy"].item() <= 1
    prof = profile_region(f"classification eval step B={bsz}",
                          lambda: evaluate(xs, ys), top=8)
    print(json.dumps(prof), flush=True)
    print(f"classification eval step B={bsz}: wall {prof['wall_ms']:.2f} "
          f"ms, device {prof['device_ms']:.2f} ms, busy share "
          f"{prof['device_busy_share']:.3f}", flush=True)
    del model, state, step

    # ---- one dropout-free step on the card against the CPU (B = 4) ----
    quiet = dataclasses.replace(ccfg, p_dropout=0.0)

    def one_step(pair, device):
        model, state = pair
        state, m = make_classification_train_step(model)(
            state, xs[:4].to(device), ys[:4].to(device))
        return m, model

    _grads_close("classification train step",
                 *_card_and_cpu(lambda d: fresh(quiet, d), one_step))

    # ---- eight dropout-free steps lower the loss ----
    model, state = fresh(quiet)
    step = make_classification_train_step(model)
    losses = [step(state, xs, ys)[1]["loss"].item() for _ in range(8)]
    print(f"classification dropout 0 steps: losses {losses}", flush=True)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    # ---- eval forwards on the card against the CPU ----
    model.eval()
    sd = model.state_dict()

    def eval_close(tag, make, inputs):
        with torch.no_grad():
            card = make("cuda")
            card.load_state_dict(sd)
            out = card(inputs).cpu()
            host = make("cpu")
            host.load_state_dict({k: v.cpu() for k, v in sd.items()})
            ref = host(tuple(t.cpu() for t in inputs)
                       if isinstance(inputs, tuple) else inputs.cpu())
        assert out.shape == ref.shape and torch.isfinite(out).all()
        _check(f"{tag} eval, card vs CPU", _rel_err(out, ref), 1e-4)

    small = xs[:8]
    eval_close("classification mode=last", lambda d: build_model(
        dataclasses.replace(quiet, mode="last"), 1, n_cls, device=d,
        seed=0), small)
    lengths = torch.tensor([784, 700, 512, 333, 100, 64, 9, 1],
                           device="cuda")

    def padded(d):
        m = build_model(quiet, 1, n_cls, device=d, seed=0)
        m.padded = True
        return m
    eval_close("classification padded (masked_meanpool)", padded,
               (small, lengths))
    init = blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    gen = torch.Generator().manual_seed(24)

    def retrieval(d):
        def make_mixer():
            return S5SSM(init["Lambda"], init["V"], init["Vinv"],
                         h=cfg.d_model, p=init["P"], c_init=cfg.C_init,
                         clip_eigs=cfg.clip_eigs, generator=gen,
                         scan_mode=cfg.scan_mode)
        return RetrievalModel(make_mixer, 1, 2, n_layers, cfg.d_model,
                              glu_variant=cfg.glu_variant,
                              bn_momentum=cfg.bn_momentum).to(d).eval()
    rmodel = retrieval("cuda")
    sd = rmodel.state_dict()
    counters()
    docs = torch.cat([xs[:16], xs[16:32]])
    eval_close("retrieval on 2 x 16 sequences", retrieval, docs)
    counts = {k: v for k, v in counters().items() if v}
    print(f"retrieval eval launches {counts}", flush=True)
    assert counts == {"layer_tail_train": n_layers}, counts

    # ---- cli.main train on a classification recipe ----
    with open(os.path.join(root, "recipes", "ndns.json")) as f:
        recipe = json.load(f)
    recipe.update(dataset="synthetic-classification", epochs=1, bsz=bsz,
                  synthetic_size=2 * bsz)
    with tempfile.TemporaryDirectory(prefix="cls_") as tmp:
        path = os.path.join(tmp, "recipe.json")
        with open(path, "w") as f:
            json.dump(recipe, f)
        counters()
        t0 = time.time()
        assert cli.main(["train", "--recipe", path, "--checkpoint_dir",
                         os.path.join(tmp, "run")]) == 0
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for k, v in counters().items() if v}
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            log = json.loads(f.readline())
    print(f"cli train synthetic-classification (1 epoch, 2 steps of "
          f"B={bsz} x 128 steps): {wall:.2f} s, train loss "
          f"{log['train_loss']:.4f}, val accuracy {log['val_accuracy']:.3f}, "
          f"launches {counts}", flush=True)
    assert counts["layer_tail_hist"] == counts["layer_tail_bwd"] == \
        2 * n_layers, counts


def bn_fusion_phase(cfg, batch, counters) -> None:
    """Phase 25: ``fuse_batchnorm_linear`` (module docstring, item 25)."""
    import torch

    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    n_layers = cfg.n_layers
    quiet = dataclasses.replace(cfg, p_dropout=0.0)
    _, _, feats = batch
    # three steps first, so that the running statistics have moved
    model, state = _fresh_run(quiet)
    step = make_ndns_train_step(model)
    small = tuple(t[:B].contiguous() for t in feats)
    for _ in range(3):
        state, _ = step(state, *small)
    stats = model.encoder.layers[0].norm.running_var
    assert not torch.allclose(stats, torch.ones_like(stats))
    x = (small[0] - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    folded_cfg = dataclasses.replace(quiet, fuse_batchnorm_linear=True)
    folded = build_model(folded_cfg, 257, 257, device="cuda", seed=0)
    folded.load_state_dict(model.state_dict())
    model.eval()
    with torch.no_grad():
        counters()
        torch.cuda.synchronize()
        t0 = time.time()
        y_fold = folded(x)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        counts = {k: v for k, v in counters().items() if v}
        y_plain = model(x)
        print(f"BatchNorm folded eval forward B={B} x {SECONDS} s: "
              f"{wall:.1f} ms, launches {counts}", flush=True)
        assert counts == {"diag_scan": n_layers}, counts
        _check("folded vs unfolded eval forward on the card",
               _rel_err(y_fold, y_plain), 1e-4)
        host = build_model(folded_cfg, 257, 257, device="cpu", seed=0)
        host.load_state_dict({k: v.cpu() for k, v in
                              folded.state_dict().items()})
        xs = x[:2, :500]
        _check("folded eval forward, card vs CPU",
               _rel_err(folded(xs).cpu(), host(xs.cpu())), 1e-4)


def blocked_phase(cfg, model, batch, counters) -> None:
    """Phase 26: ``scan_mode="blocked"`` (module docstring, item 26)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    from sparsernns_tpu_torch.train.steps import (make_ndns_eval_step,
                                                  make_ndns_train_step)
    from sparsernns_tpu_torch.utils.profiling import profile_region
    noisy, clean, feats = batch
    small = tuple(t[:B].contiguous() for t in feats)
    bcfg = dataclasses.replace(cfg, scan_mode="blocked", p_dropout=0.0)
    blocked = build_model(bcfg, 257, 257, device="cuda", seed=0)
    blocked.load_state_dict(model.state_dict())
    fused_eval = make_ndns_eval_step(model)
    blocked_eval = make_ndns_eval_step(blocked)
    ref = fused_eval(*small)
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    got = blocked_eval(*small)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = {k: v for k, v in counters().items() if v}
    print(f"blocked eval step B={B} x {SECONDS} s: {wall:.1f} ms, loss "
          f"{got['loss'].item():.4f} (fused {ref['loss'].item():.4f}), "
          f"si_snr {got['si_snr'].item():.3f} dB, launches {counts}",
          flush=True)
    assert not counts, counts
    for key in ("loss", "si_snr"):
        _check(f"blocked eval step {key} vs the fused route",
               abs(got[key].item() - ref[key].item()),
               1e-3 * max(1.0, abs(ref[key].item())))
    x = (small[0] - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    with torch.no_grad():
        _check("blocked eval forward vs the fused route's",
               _rel_err(blocked(x), model(x)), 1e-3)
        host = build_model(bcfg, 257, 257, device="cpu", seed=0)
        host.load_state_dict({k: v.cpu() for k, v in
                              blocked.state_dict().items()})
        xs = x[:2, :500]
        _check("blocked eval forward, card vs CPU",
               _rel_err(blocked(xs).cpu(), host(xs.cpu())), 1e-4)
    prof = profile_region(f"blocked eval step B={B}",
                          lambda: blocked_eval(*small), top=8)
    print(json.dumps(prof), flush=True)
    _card_vs_cpu_step("blocked train step", bcfg, noisy, clean)
    model_b, state = _fresh_run(bcfg)
    step = make_ndns_train_step(model_b)
    state, _ = step(state, *small)
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    state, m = step(state, *small)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = {k: v for k, v in counters().items() if v}
    print(f"blocked train step B={B} x {SECONDS} s: {wall:.1f} ms, loss "
          f"{m['loss'].item():.4f}, launches {counts}", flush=True)
    assert not counts and np.isfinite(m["loss"].item()), (counts, m)
    prof = profile_region(f"blocked train step B={B}",
                          lambda: step(state, *small), top=8)
    print(json.dumps(prof), flush=True)


def xla_route_phase(cfg, eng, counters) -> None:
    """Phase 27: the engine's ``route="xla"`` (module docstring, item
    27). Held against ``"auto"`` with float32 activations: with bf16
    ones the per-op route rounds each mixer input to bf16 where the
    whole-layer kernels do not, in the JAX package too (its xla and auto
    engines differ by 3.4e-3 at most, 6e-4 in the mean on the CPU tests'
    tree), so the bf16 engines are held card against CPU instead and
    their difference to ``"auto"`` is printed."""
    import torch

    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    from sparsernns_tpu_torch.utils.profiling import profile_region
    dev = torch.device("cuda")
    x = eng.x_eng

    def engine(route, block_t, act=torch.float32, device=dev):
        return engine_from_frozen(cfg, *eng.frozen, device=device,
                                  block_t=block_t, route=route,
                                  act_dtype=act)

    xla, auto = engine("xla", 512), engine("auto", 512)
    assert xla.route == "xla" and not xla._stack_ok and not xla._network_ok
    ref = auto(x)
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    out = xla(x)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = {k: v for k, v in counters().items() if v}
    print(f"xla engine offline B={B} x {x.shape[1]} (f32 activations): "
          f"{wall:.1f} ms, launches {counts}", flush=True)
    assert not counts, counts
    _engine_close("xla engine offline vs auto (f32 activations)", out, ref)
    prof = profile_region(f"xla engine offline B={B}", lambda: xla(x),
                          top=8)
    print(json.dumps(prof), flush=True)
    # phase 4's bf16 engine on the xla route: the card against the CPU
    xla16 = engine("xla", 512, act=torch.bfloat16)
    counters()
    out16 = xla16(x)
    assert not any(counters().values())
    diff = (out16.float() - eng.engine(x).float()).abs()
    print(f"xla engine (bf16 activations) vs auto (bf16): max "
          f"{diff.max().item():.3e}, mean {diff.mean().item():.3e} (the "
          "per-op route's bf16 mixer input, as in the JAX package)",
          flush=True)
    host = engine("xla", 512, act=torch.bfloat16, device="cpu")
    _engine_close("xla engine (bf16 activations), card vs CPU",
                  out16[:2].cpu(), host(x[:2].cpu()))
    # chunked at 128 frames against the auto engine's chunks and against
    # one whole call of a 128-frame engine
    xla128, auto128 = engine("xla", STREAM_BLOCK), engine("auto",
                                                          STREAM_BLOCK)
    outs, refs, c_x, c_a = [], [], None, None
    counters()
    t0 = time.time()
    for i in range(0, x.shape[1], STREAM_BLOCK):
        y, c_x = xla128.process_chunk(x[:, i:i + STREAM_BLOCK], c_x)
        outs.append(y)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    counts = {k: v for k, v in counters().items() if v}
    assert not counts, counts
    for i in range(0, x.shape[1], STREAM_BLOCK):
        y, c_a = auto128.process_chunk(x[:, i:i + STREAM_BLOCK], c_a)
        refs.append(y)
    chunked = torch.cat(outs, dim=1)
    n = len(outs)
    print(f"xla engine process_chunk: {n} chunks of {STREAM_BLOCK} frames "
          f"in {wall:.1f} ms ({wall / n:.2f} ms a chunk), launches {counts}",
          flush=True)
    _engine_close("xla engine chunked vs auto chunked", chunked,
                  torch.cat(refs, dim=1))
    _engine_close("xla engine chunked vs whole", chunked, xla128(x))
    chunk = x[:, :STREAM_BLOCK]
    prof = profile_region("xla engine one chunk",
                          lambda: xla128.process_chunk(chunk), top=8)
    print(json.dumps(prof), flush=True)


def tbptt_phase(cfg, feats, counters) -> None:
    """Phase 28: truncated backpropagation through time (module
    docstring, item 28)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.data import tbptt
    from sparsernns_tpu_torch.train.loop import build_model, create_run_state
    from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
    chunk_len = 375
    acfg = dataclasses.replace(cfg, scan_mode="associative", p_dropout=0.0)
    noisy_mag, _, clean_mag, _ = (t[:B] for t in feats)
    x = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    y = clean_mag.transpose(1, 2).contiguous()
    chunks = list(tbptt.tbptt_chunks(x.cpu().numpy(), y.cpu().numpy(),
                                     chunk_len))
    assert len(chunks) == x.shape[1] // chunk_len, len(chunks)
    covered = len(chunks) * chunk_len

    def fresh(device):
        model = build_model(acfg, 257, 257, training=True, device=device,
                            seed=0)
        return model, create_run_state(acfg, model, steps_per_epoch=2)

    model, state = fresh("cuda")
    model.eval()
    with torch.no_grad():
        whole = model(x[:, :covered])
        carry, outs = None, []
        for xc, _, reset in chunks:
            if reset:
                carry = tbptt.init_carry(model, xc)
            out, carry = model.forward_stream(torch.from_numpy(xc).cuda(),
                                              carry)
            outs.append(out)
    _check(f"TBPTT chunked eval forward ({len(chunks)} x {chunk_len}) vs "
           "the whole forward", _rel_err(torch.cat(outs, dim=1), whole),
           1e-4)

    def mse(pred, tgt):
        return torch.mean((pred - tgt) ** 2)

    def first_step(pair, device):
        model, state = pair
        xc, yc, _ = chunks[0]
        step = tbptt.make_tbptt_train_step(model, mse)
        state, _, m = step(state, tbptt.init_carry(model, xc),
                           torch.from_numpy(xc).to(device),
                           torch.from_numpy(yc).to(device))
        return m, model

    _grads_close("TBPTT first chunk step", *_card_and_cpu(fresh, first_step))

    model, state = fresh("cuda")
    step = tbptt.make_tbptt_train_step(model, mse)
    x0 = torch.from_numpy(chunks[0][0]).cuda()
    y0 = torch.from_numpy(chunks[0][1]).cuda()

    def chunk0_loss():
        with torch.no_grad():
            model.eval()
            out, _ = model.forward_stream(x0, None)
            model.train()
            return mse(out, y0).item()

    before = chunk0_loss()
    walls, carry = [], None
    for xc, yc, reset in chunks:
        if reset:
            carry = tbptt.init_carry(model, xc)
        counters()
        torch.cuda.synchronize()
        t0 = time.time()
        state, carry, m = step(state, carry, torch.from_numpy(xc).cuda(),
                               torch.from_numpy(yc).cuda())
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
        counts = {k: v for k, v in counters().items() if v}
        assert not counts and np.isfinite(m["loss"].item()), (counts, m)
    after = chunk0_loss()
    moved = max(c.abs().max().item() for pair in carry for c in pair)
    print(f"TBPTT pass over {len(chunks)} chunks of {chunk_len} frames at "
          f"B={B}: {np.median(walls):.1f} ms a chunk step (median; first "
          f"{walls[0]:.1f}), chunk-0 loss {before:.5f} -> {after:.5f}, "
          f"largest carry {moved:.3e}", flush=True)
    assert after < before and moved > 0, (before, after, moved)


def wav_corpus_phase(cfg, counters) -> None:
    """Phase 29: the WAV corpus and the native decoder (module docstring,
    item 29)."""
    import tempfile
    import wave

    import numpy as np
    import torch

    from sparsernns_tpu_torch.data import native
    from sparsernns_tpu_torch.data.ndns import (AUDIO_LEN, DNSAudioDataset,
                                                SyntheticNDNS, read_wav)
    from sparsernns_tpu_torch.train.loop import train
    n_layers = cfg.n_layers
    print(f"native WAV decoder available: {native.available()}", flush=True)
    assert native.available(), "g++ builds the native decoder here"

    def write(path, audio):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pcm = np.clip(np.round(audio * 32767.0), -32768, 32767)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(pcm.astype("<i2").tobytes())

    env = {}
    with tempfile.TemporaryDirectory(prefix="ndns_corpus_") as tmp:
        t0 = time.time()
        for split, pairs, seed in (("TRAIN", 16, 10), ("VALIDATION", 8, 11),
                                   ("TEST", 8, 12)):
            root = os.path.join(tmp, split.lower())
            ds = SyntheticNDNS(size=pairs, length=AUDIO_LEN, seed=seed)
            for i in range(pairs):
                noisy, clean = ds[i]
                write(os.path.join(root, "noisy",
                                   f"synthetic_fileid_{i}.wav"), noisy)
                write(os.path.join(root, "clean", f"clean_fileid_{i}.wav"),
                      clean)
            env[f"NDNS_{split}_SET"] = root
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
        print(f"WAV corpus: 32 pairs of {AUDIO_LEN // 16000} s PCM16, "
              f"{size / 1e6:.1f} MB written in {time.time() - t0:.1f} s",
              flush=True)
        ds = DNSAudioDataset(env["NDNS_TRAIN_SET"])
        noisy_paths, clean_paths = ds.batch_paths(range(B))
        t0 = time.time()
        got = native.decode_batch(noisy_paths + clean_paths, AUDIO_LEN)
        native_s = time.time() - t0
        t0 = time.time()
        ref = np.stack([read_wav(p) for p in noisy_paths + clean_paths])
        wave_s = time.time() - t0
        assert np.array_equal(got, ref), np.abs(got - ref).max()
        print(f"native decode of {2 * B} clips {native_s * 1e3:.1f} ms, "
              f"wave reader {wave_s * 1e3:.1f} ms: equal bit for bit",
              flush=True)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            run = dataclasses.replace(cfg, bsz=B, epochs=1,
                                      synthetic_data=False)
            counters()
            t0 = time.time()
            out = train(run)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        counts = {k: v for k, v in counters().items() if v}
    log = out["metadata"]["last_log"]
    steps, evals = 16 // B, 2 * (8 // B)
    print(f"train on the WAV corpus: one epoch, {steps} steps of B={B} x "
          f"30 s and {evals} eval batches in {wall:.2f} s; train loss "
          f"{log['train_loss']:.4f}, val si_snr {log['val_si_snr']:.3f} dB; "
          f"launches {counts}", flush=True)
    assert out["state"].step == steps, out["state"].step
    assert counts == {"layer_tail_train": n_layers * (steps + evals),
                      "layer_tail_hist": n_layers * steps,
                      "layer_tail_bwd": n_layers * steps}, counts


#: frames of phase 30's sequence-, tensor- and pipeline-parallel serving:
#: 3751 = 11 x 11 x 31 splits over no two seq ranks, 3744 = 32 x 117 over
#: 2 seq ranks and over 6 pipeline chunks (a cut of 7 frames); the mxu16
#: pipeline engine's time block, which divides its 624-frame chunks
PAR_FRAMES, PP_CHUNKS, PP_BLOCK = 3744, 6, 208


def _par_train(cfg, state_dict, feats, mesh, steps, counters, expect):
    """``steps`` steps of ``make_ndns_train_step`` on ``mesh`` from
    ``state_dict``, the global batch ``feats`` (this rank takes its rows):
    per step the metrics, wall ms, collective bytes and launches (each must
    equal ``expect``), and the whole parameters on the host after each."""
    import torch

    from sparsernns_tpu_torch.parallel.comms import CollectiveCounter
    from sparsernns_tpu_torch.parallel.sharding import (shard_batch,
                                                        shard_train_state,
                                                        whole_model)
    from sparsernns_tpu_torch.train.loop import build_model, create_run_state
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    model = build_model(cfg, 257, 257, training=True, device=mesh.device,
                        mesh=mesh)
    model.load_state_dict(state_dict)
    state = shard_train_state(create_run_state(cfg, model, 1, mesh), mesh)
    step = make_ndns_train_step(model)
    out = dict(metrics=[], walls=[], comms=[], launches=[], params=[])
    for _ in range(steps):
        local = shard_batch(feats, mesh)
        counters()
        torch.cuda.synchronize()
        t0 = time.time()
        with CollectiveCounter() as counter:
            state, metrics = step(state, *local)
        torch.cuda.synchronize()
        out["walls"].append((time.time() - t0) * 1e3)
        launches = {k: v for k, v in counters().items() if v}
        assert launches == expect, (launches, expect)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["comms"].append(counter.result())
        out["launches"].append(launches)
        with whole_model(state):
            out["params"].append({n: q.detach().cpu().clone()
                                  for n, q in model.named_parameters()})
    return out


def _par_serve(forward, x, counters, expect):
    """``forward(x)`` timed on the card: (output on the host, wall ms,
    collective bytes, launches, which must equal ``expect``)."""
    import torch

    from sparsernns_tpu_torch.parallel.comms import CollectiveCounter
    forward(x)                       # warm: workspaces, first launches
    counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with CollectiveCounter() as counter:
        y = forward(x)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    launches = {k: v for k, v in counters().items() if v}
    assert launches == expect, (launches, expect)
    return y.float().cpu(), wall, counter.result(), launches


def _par_features(bsz: int, samples: int):
    """The train step's features of ``bsz`` synthetic clips of ``samples``
    samples on the card (the phase-8 batch's first clips)."""
    import numpy as np
    import torch

    from sparsernns_tpu_torch.data.ndns import SyntheticNDNS
    from sparsernns_tpu_torch.train.loop import prep_ndns_batch
    ds = SyntheticNDNS(size=bsz, length=SECONDS * 16000, seed=0)
    audio = [ds[i] for i in range(bsz)]
    noisy = torch.from_numpy(np.stack([a[:samples] for a, _ in audio]))
    clean = torch.from_numpy(np.stack([c[:samples] for _, c in audio]))
    noisy, clean = noisy.cuda(), clean.cuda()
    return (*prep_ndns_batch(noisy, clean), clean)


def _par_engine(spec, mxu16: bool = False):
    """The w8a16 engine of phase 4's frozen tree (block 512), or the mxu16
    engine of the same tree at the pipeline's time block."""
    import torch

    from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
    if not mxu16:
        return engine_from_frozen(spec["cfg"], *spec["frozen"],
                                  device=torch.device("cuda"), block_t=512)
    cfg = dataclasses.replace(spec["cfg"], engine_mxu16=True)
    engine = engine_from_frozen(cfg, *spec["frozen"],
                                device=torch.device("cuda"),
                                block_t=PP_BLOCK)
    assert engine.mxu16["mixer"] or engine.mxu16["requants"], engine.mxu16
    return engine


def _par_paths(spec, mesh_of, counters):
    """Every parallel path of phase 30 on this rank's meshes (``mesh_of``:
    (data, model, seq) -> mesh): its results, as host values."""
    import torch

    from sparsernns_tpu_torch.parallel.sp_engine import (make_dp_forward,
                                                         make_sp_forward,
                                                         make_tp_forward)
    cfg = spec["cfg"]
    n = spec["world"]
    dp_mesh = mesh_of(n, 1, 1)       # makes this rank's card current
    assert torch.cuda.current_device() == dp_mesh.device.index, \
        (torch.cuda.current_device(), dp_mesh.device)
    tail = {k: 3 for k in TAIL_KERNELS}
    feats32 = _par_features(4 * B, SECONDS * 16000)
    res = {}
    res["dp_train"] = _par_train(cfg, spec["state"], feats32, dp_mesh, 3,
                                 counters, tail)
    res["tp_train"] = _par_train(cfg, spec["state"], feats32,
                                 mesh_of(1, n, 1), 2, counters, tail)
    del feats32
    scans = {"diag_scan": 3, "diag_scan_rev": 3}
    res["sp_train"] = _par_train(cfg, spec["state"],
                                 _par_features(B, SECONDS * 16000),
                                 mesh_of(1, 1, n), 2, counters, scans)
    res["sp_train_short"] = _par_train(
        cfg, spec["state"], _par_features(2, 64 * 128), mesh_of(1, 1, n),
        1, counters, scans)
    engine = _par_engine(spec)
    x8 = spec["x_eng"].cuda()
    x = x8[:, :PAR_FRAMES].contiguous()
    res["dp_serve"] = _par_serve(make_dp_forward(engine, dp_mesh), x8,
                                 counters, {"engine_network": 1})
    res["sp_serve"] = _par_serve(make_sp_forward(engine, mesh_of(1, 1, n)),
                                 x, counters, {"diag_scan": 3})
    res["tp_serve"] = _par_serve(make_tp_forward(engine, mesh_of(1, n, 1)),
                                 x, counters, {"diag_scan": 3})
    torch.cuda.synchronize()
    return res


def parallel_rank(rank: int, world: int, spec):
    """One rank of phase 30's multi-rank run (``parallel/launch.run_ranks``):
    builds nothing (the parent's build is on disk), computes on
    ``cuda:0`` when the ranks share one card, else on ``cuda:<rank>``
    (``LOCAL_RANK``), which the mesh makes the current card."""
    import torch

    from sparsernns_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if spec["share"] else "cuda"
    spec = dict(spec, world=world)
    return _par_paths(spec, lambda d, m, s: make_mesh(
        MeshConfig(data=d, model=m, seq=s), device=dev), kernel_launches)


def _fresh_copy(x):
    """A copy of ``x`` that the current stream writes only after about
    ten milliseconds of matrix products queued on it; until then it holds
    NaN."""
    import torch
    out = torch.full_like(x, float("nan"))
    a = torch.randn(4096, 4096, device=x.device)
    torch.cuda.synchronize()
    for _ in range(4):
        a = a @ a * 1e-2
    out.copy_(x)
    return out


def _par_train_close(tag, got, ref, step_pairs) -> None:
    """A parallel run's steps against the one-rank run's at PR 3's card
    bars: loss, SI-SNR and gradient norm 1e-3 relative; every parameter's
    mean abs difference 1e-5 (Adam moves an element of noise-level
    gradient by about the learning rate)."""
    for i, j in step_pairs:
        for key in ("loss", "si_snr", "grad_norm"):
            r = ref["metrics"][j][key]
            _check(f"{tag} step {i}, {key} vs one rank",
                   abs(got["metrics"][i][key] - r), 1e-3 * max(1.0, abs(r)))
        _check(f"{tag} step {i}, parameters vs one rank (mean abs)",
               max((got["params"][i][n] - q).abs().mean().item()
                   for n, q in ref["params"][j].items()), 1e-5)


def _par_cli_train() -> None:
    """The documented multi-card entry: ``cli train`` under the launcher
    (``torch.distributed.run``), two ranks, one card each over NCCL, a
    mesh of 2 data ranks at the flagship's width (1 layer, 8 synthetic
    clips of 2 s, one epoch)."""
    import tempfile

    from sparsernns_tpu_torch.parallel.launch import free_port
    from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
               "--master_port", str(free_port()), "-m",
               "sparsernns_tpu_torch.cli", "train", "--device", "cuda",
               "--mesh_data", "2", "--scan_mode", "fused", "--n_layers",
               "1", "--synthetic_data", "1", "--synthetic_size", "8",
               "--synthetic_seconds", "2.0", "--bsz", "4", "--epochs", "1",
               "--checkpoint_dir", ckpt]
        t0 = time.time()
        run = subprocess.run(cmd, cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=300)
        if run.returncode:
            print(run.stdout[-4000:], run.stderr[-8000:], file=sys.stderr)
            raise AssertionError(f"cli train on 2 cards: rc "
                                 f"{run.returncode}")
        steps = CheckpointManager(ckpt).all_steps()
        assert steps, "cli train on 2 cards wrote no checkpoint"
    print(f"phase 30 cli train under torch.distributed.run (nccl, world "
          f"2, cuda:0 and cuda:1, mesh_data 2): rc 0 in "
          f"{time.time() - t0:.1f} s, checkpoint steps {steps}", flush=True)


def parallel_phase(cfg, model, eng, counters) -> None:
    """Phase 30: the device mesh (module docstring, item 30)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sparsernns_tpu_torch.parallel.launch import free_port, run_ranks
    from sparsernns_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from sparsernns_tpu_torch.parallel.pp_engine import make_pp_forward
    from sparsernns_tpu_torch.parallel.sp_engine import (make_dp_forward,
                                                         make_sp_forward,
                                                         make_tp_forward)
    from sparsernns_tpu_torch.train.loop import build_model
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    dev = torch.device("cuda", 0)
    cfg0 = dataclasses.replace(cfg, p_dropout=0.0)
    spec = dict(cfg=cfg0, frozen=eng.frozen, x_eng=eng.x_eng.cpu(),
                state={k: v.detach().cpu()
                       for k, v in model.state_dict().items()})

    # ---- one rank over NCCL: every path on the trivial mesh ----
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh1 = make_mesh(MeshConfig(), device=dev)
        tail = {k: 3 for k in TAIL_KERNELS}
        feats32 = _par_features(4 * B, SECONDS * 16000)
        one = dict(train=_par_train(cfg0, spec["state"], feats32, mesh1, 3,
                                    counters, tail))
        del feats32
        assoc = dataclasses.replace(cfg0, scan_mode="associative")
        one["assoc"] = _par_train(assoc, spec["state"],
                                  _par_features(B, SECONDS * 16000), mesh1,
                                  2, counters, {})
        for path in ("train", "assoc"):
            r = one[path]
            print(f"phase 30 one rank (nccl, world 1) {path} steps: ms "
                  f"{[round(w, 2) for w in r['walls']]}, loss "
                  f"{[round(m['loss'], 5) for m in r['metrics']]}, comms "
                  f"{r['comms'][0]}, launches a step {r['launches'][0]}",
                  flush=True)
        engine = _par_engine(spec)
        x8 = eng.x_eng
        x = x8[:, :PAR_FRAMES].contiguous()
        with torch.no_grad():
            whole8 = engine(x8).float().cpu()
            whole = engine(x).float().cpu()
        for mode, make, inp, expect in (
                ("dp", make_dp_forward, x8, {"engine_network": 1}),
                ("sp", make_sp_forward, x, {"diag_scan": 3}),
                ("tp", make_tp_forward, x, {"diag_scan": 3})):
            one[mode] = _par_serve(make(engine, mesh1), inp, counters,
                                   expect)
            print(f"phase 30 one rank (nccl, world 1) {mode} serving: "
                  f"{one[mode][1]:.2f} ms, comms {one[mode][2]}, "
                  f"launches {one[mode][3]}", flush=True)
        assert torch.equal(one["dp"][0], whole8), "DP one rank vs engine"
        _engine_close("SP one rank vs TP one rank", one["sp"][0],
                      one["tp"][0])
        rel = ((one["sp"][0] - whole).abs().max()
               / whole.abs().max()).item()
        print(f"phase 30 per-op float body (no state requant) vs the "
              f"engine's own route (block-512 requant): {rel:.3e} of "
              "max|ref| (the JAX package's bar 0.1)", flush=True)
        _check("per-op float body vs engine route, relative", rel, 0.1)
        # the pipeline: 3 stages on the visible card(s), 6 chunks
        n_cards = torch.cuda.device_count()
        stages = [torch.device("cuda", s % n_cards) for s in range(3)]
        pp = make_pp_forward(engine, stages, chunks=PP_CHUNKS)
        one["pp"] = _par_serve(pp, x, counters,
                               {"diag_scan": 3 * PP_CHUNKS})
        from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
        cpu_pp = make_pp_forward(
            engine_from_frozen(cfg0, *eng.frozen, device="cpu",
                               block_t=512), ["cpu"] * 3, chunks=PP_CHUNKS)
        with torch.no_grad():
            _engine_close("PP float route, card vs CPU", one["pp"][0],
                          cpu_pp(x.cpu()).float())
        # the JAX package's float pipeline body keeps the mixer input f32
        # where the per-op body rounds it to the engine's bf16 activations
        rel = ((one["pp"][0] - one["sp"][0]).abs().max()
               / one["sp"][0].abs().max()).item()
        _check("PP float route vs the per-op float body, relative", rel,
               0.1)
        e16 = _par_engine(spec, mxu16=True)
        pp16 = make_pp_forward(e16, stages, chunks=PP_CHUNKS)
        one["pp16"] = _par_serve(pp16, x, counters,
                                 {"engine_layer_carry": 3 * PP_CHUNKS})
        lc = PAR_FRAMES // PP_CHUNKS
        with torch.no_grad():
            carries, chunks = None, []
            for c in range(PP_CHUNKS):
                y, carries = e16.process_chunk(x[:, c * lc:(c + 1) * lc],
                                               carries)
                chunks.append(y.float().cpu())
        assert torch.equal(one["pp16"][0], torch.cat(chunks, dim=1)), \
            "PP mxu16 route vs process_chunk"
        # an input written on the caller's stream just before the call,
        # behind a queue of work there: the stages must wait for it
        for mode, fwd in (("pp", pp), ("pp16", pp16)):
            with torch.no_grad():
                y = fwd(_fresh_copy(x)).float().cpu()
            assert torch.isfinite(y).all(), f"{mode} on a fresh input"
            if mode == "pp16":
                assert torch.equal(y, one["pp16"][0]), \
                    "PP mxu16 route on a fresh input"
            else:
                _engine_close("PP float route on a fresh input", y,
                              one["pp"][0])
        for mode in ("pp", "pp16"):
            print(f"phase 30 pipeline {mode} ({len(stages)} stages on "
                  f"{sorted(set(str(d) for d in stages))}, {PP_CHUNKS} "
                  f"chunks of {lc} frames): {one[mode][1]:.2f} ms, "
                  f"launches {one[mode][3]}", flush=True)
    finally:
        dist.destroy_process_group()
    # the sp step on the CPU at the short length (the plain scan)
    short = tuple(t.cpu() for t in _par_features(2, 64 * 128))
    cpu_model = build_model(assoc, 257, 257, training=True, device="cpu")
    cpu_model.load_state_dict(spec["state"])
    from sparsernns_tpu_torch.train.loop import create_run_state
    cpu_state = create_run_state(assoc, cpu_model, 1)
    _, cpu_m = make_ndns_train_step(cpu_model)(cpu_state, *short)
    cpu_ref = dict(metrics=[{k: float(v) for k, v in cpu_m.items()}],
                   params=[{n: q.detach().clone()
                            for n, q in cpu_model.named_parameters()}])
    print(f"phase 30 one rank: {time.time() - t0:.1f} s", flush=True)

    # ---- two ranks: one a card over NCCL, or sharing the card over gloo
    share = torch.cuda.device_count() < 2
    backend = "gloo" if share else "nccl"
    t0 = time.time()
    outs = run_ranks(parallel_rank, 2, (dict(spec, share=share),),
                     backend=backend, timeout=900, threads=2)
    print(f"phase 30 two ranks ({backend}, world 2, "
          f"{'sharing cuda:0' if share else 'one card each'}): "
          f"{time.time() - t0:.1f} s with the start of the ranks"
          + ("; a time on one card over gloo says nothing of scaling"
             if share else ""), flush=True)
    for rank, res in enumerate(outs):
        for path in ("dp_train", "tp_train", "sp_train", "sp_train_short"):
            r = res[path]
            print(f"phase 30 rank {rank} {path} ({backend}, world 2): "
                  f"step ms {[round(w, 2) for w in r['walls']]}, loss "
                  f"{[round(m['loss'], 5) for m in r['metrics']]}, comms "
                  f"{r['comms'][0]}, launches a step {r['launches'][0]}",
                  flush=True)
        for path in ("dp_serve", "sp_serve", "tp_serve"):
            _, wall, comms, launches = res[path]
            print(f"phase 30 rank {rank} {path} ({backend}, world 2): "
                  f"{wall:.2f} ms, comms {comms}, launches {launches}",
                  flush=True)
    for rank, res in enumerate(outs):
        _par_train_close(f"rank {rank} DP train (2 x 16 rows)",
                         res["dp_train"], one["train"],
                         [(0, 0), (1, 1), (2, 2)])
        _par_train_close(f"rank {rank} TP train (P 128 as 2 x 64)",
                         res["tp_train"], one["train"], [(0, 0), (1, 1)])
        _par_train_close(f"rank {rank} SP train (1876 + 1875 frames)",
                         res["sp_train"], one["assoc"], [(0, 0), (1, 1)])
        _par_train_close(f"rank {rank} SP train, 65 frames, vs the CPU",
                         res["sp_train_short"], cpu_ref, [(0, 0)])
        for path in ("dp_train", "tp_train", "sp_train"):
            for n, q in res[path]["params"][-1].items():
                assert torch.equal(q, outs[0][path]["params"][-1][n]), \
                    (path, n)
    if not share:
        _par_cli_train()
    dp = torch.cat([o["dp_serve"][0] for o in outs], dim=0)
    if torch.equal(dp, one["dp"][0]):
        print("phase 30 DP serving = one rank, bit for bit", flush=True)
    else:
        _engine_close("DP serving vs one rank", dp, one["dp"][0])
    _engine_close("SP serving vs one rank",
                  torch.cat([o["sp_serve"][0] for o in outs], dim=1),
                  one["sp"][0])
    for rank, o in enumerate(outs):
        _engine_close(f"rank {rank} TP serving vs one rank", o["tp_serve"][0],
                      one["tp"][0])
        assert o["dp_serve"][2]["total_bytes"] == 0
    h, p = cfg.d_model, model.encoder.layers[0].mixer.p
    sp_bytes = cfg.n_layers * 2 * 4 * (2 * p + 2 * B * p)
    tp_bytes = cfg.n_layers * B * PAR_FRAMES * h * 4
    assert outs[0]["sp_serve"][2]["total_bytes"] == sp_bytes
    assert outs[0]["tp_serve"][2]["total_bytes"] == tp_bytes
    print(f"phase 30 collective bytes: SP serving {sp_bytes} "
          f"({cfg.n_layers} gathers of 2 (λ^T, end) pairs, any L), TP "
          f"serving {tp_bytes} ({cfg.n_layers} all-reduces of (B, L, H) "
          f"f32), DP serving 0", flush=True)
    assert np.isfinite(outs[0]["dp_train"]["metrics"][-1]["loss"])


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
    from sparsernns_tpu_torch.utils.trace import launch_counts as ledger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))

    run_start = t0 = time.time()
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

    marks = [time.time()]

    def mark(name: str) -> None:
        marks.append(time.time())
        print(f"[{name}: {marks[-1] - marks[-2]:.1f} s]", flush=True)

    # ---------------- kernel phase ----------------
    with torch.no_grad():
        lam, w_b, w_c, d, relu_state = layer0.mixer.layer_tail_operands()
        # K1 at the streaming shape, with a non-zero carry; bu is the two
        # halves of one (B, L, 2P) projection, as the mixer gives it
        bu_cat = torch.randn((B, frames, 2 * p), generator=gen).to(dev)
        bu = (bu_cat[..., :p], bu_cat[..., p:])
        carry = tuple(torch.randn((B, p), generator=gen).to(dev)
                      for _ in range(2))
        err = _check_k1(f"K1 diag_scan carry B={B}", lam, bu, carry)
        ms = _time_ms(lambda: diag_scan.diag_scan_cuda(lam, bu, carry), 20)
        plain_ms = _time_ms(
            lambda: diag_scan.diag_scan_plain(lam, bu, carry), 1, 0)
        elems = B * frames * p
        bound, by = _bound_ms(_k1_bytes(B, frames, p, True), 8 * elems)
        # B=32 from a generator of its own, so that the later phases draw
        # what they drew before
        g32 = torch.Generator().manual_seed(323)
        bu32_cat = torch.randn((4 * B, frames, 2 * p), generator=g32).to(dev)
        bu32 = (bu32_cat[..., :p], bu32_cat[..., p:])
        carry32 = tuple(torch.randn((4 * B, p), generator=g32).to(dev)
                        for _ in range(2))
        _check_k1(f"K1 diag_scan carry B={4 * B}", lam, bu32, carry32)
        ms32 = _median_ms(lambda: diag_scan.diag_scan_cuda(lam, bu32,
                                                           carry32))
        bound32, _ = _bound_ms(_k1_bytes(4 * B, frames, p, True), 32 * elems)
        del bu32_cat, bu32, carry32
        print(f"K1 with carry: {ms:.4f} ms at B={B} (mean of 20; bound "
              f"{bound:.4f}, {100 * bound / ms:.1f} %), {ms32:.4f} ms at "
              f"B={4 * B} (median of 5; bound {bound32:.4f}, "
              f"{100 * bound32 / ms32:.1f} %)", flush=True)
        records["diag_scan"] = dict(
            name="diag_scan", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/diag_scan.cu",
            replaces="sparsernns_tpu/ops/pallas/scan_kernel.py:433",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None, ms_b32=ms32,
            bound_ms_b32=bound32)

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
        _check_k2_passes(f"K2 B={B}", B, frames)
        print(f"K2 output digest (phase 1 input, B={B}): {_digest(out)}",
              flush=True)
        ms = _time_ms(lambda: layer_tail.layer_tail_cuda(*args, **kw), 5)
        plain_ms = _time_ms(lambda: layer_tail.layer_tail_plain(*args, **kw),
                            1, 0)
        # B=32 from a generator of its own, so that the later phases draw
        # what they drew before
        x32 = torch.randn((4 * B, frames, h),
                          generator=torch.Generator().manual_seed(321)).to(dev)
        args32 = (x32, *args[1:])
        ref32 = layer_tail.layer_tail_plain(*args32, **kw)
        out32 = layer_tail.layer_tail_cuda(*args32, **kw)
        torch.cuda.synchronize()
        _check(f"K2 layer_tail B={4 * B} vs plain",
               (out32 - ref32).abs().max().item(),
               1e-4 * max(1.0, ref32.abs().max().item()))
        _check_k2_passes(f"K2 B={4 * B}", 4 * B, frames)
        ms32 = _median_ms(lambda: layer_tail.layer_tail_cuda(*args32, **kw))
        del x32, args32, ref32, out32
        rows = B * frames
        n_dense = {"full": 2, "half1": 1, "half2": 1, "none": 0}[
            cfg.glu_variant]
        flops = rows * (2 * h * 2 * p + 2 * 2 * p * h + n_dense * 2 * h * h
                        + 8 * p + 6 * h)
        weights = (2 * h * 2 * p + n_dense * (h * h + h) + 3 * h + 2 * p)
        bound, by = _bound_ms(2 * rows * h * 4 + weights * 4, flops)
        bound32, _ = _bound_ms(8 * rows * h * 4 + weights * 4, 4 * flops)
        print(f"K2: {ms:.3f} ms at B={B} (bound {bound:.4f}; mean of 5), "
              f"{ms32:.3f} ms at B={4 * B} (bound {bound32:.4f}; median of "
              "5)", flush=True)
        records["layer_tail"] = dict(
            name="layer_tail", route="cuda",
            source="sparsernns_tpu_torch/ops/cuda/csrc/layer_tail.cu",
            replaces="sparsernns_tpu/ops/pallas/fused_layer_train.py:162",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None, ms_b32=ms32,
            bound_ms_b32=bound32)

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
                _check_k2_passes(f"K2 {glu}/{act}", *xs.shape[:2])
        # the widest layer whose 64-row x1 tile fits (H=872), from a
        # generator of its own; one column more is refused
        gw = torch.Generator().manual_seed(872)
        for hw in (872, 880):
            rw = lambda *shape, sc=1.0: (  # noqa: E731
                torch.randn(shape, generator=gw) * sc).to(dev)
            args = (rw(2, 300, hw), lam, rw(hw, 2 * p, sc=hw ** -0.5),
                    rw(2 * p, hw, sc=(2 * p) ** -0.5), rw(hw),
                    1.0 + 0.1 * rw(hw), 0.1 * rw(hw),
                    rw(hw, hw, sc=hw ** -0.5), 0.1 * rw(hw),
                    rw(hw, hw, sc=hw ** -0.5), 0.1 * rw(hw))
            kw = dict(act="relu", glu="full", relu_state=True,
                      layer_relu=True)
            if hw == 880:
                try:
                    layer_tail.layer_tail_cuda(*args, **kw)
                except ValueError as e:
                    print(f"K2 H={hw} refused: {e}", flush=True)
                else:
                    raise AssertionError(f"K2 H={hw} was not refused")
                continue
            ref = layer_tail.layer_tail_plain(*args, **kw)
            out = layer_tail.layer_tail_cuda(*args, **kw)
            _check(f"K2 full/relu H={hw} vs plain",
                   (out - ref).abs().max().item(),
                   1e-4 * max(1.0, ref.abs().max().item()))
            _check_k2_passes(f"K2 H={hw}", 2, 300)
    print(json.dumps({"kernel_phase": records}), flush=True)

    mark("kernel phase")

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
    kernel_launches()
    t0 = time.time()
    metrics = step(noisy_mag, noisy_phase, clean_mag, clean_t)
    torch.cuda.synchronize()
    offline_s = time.time() - t0
    counts = kernel_launches()
    records["layer_tail"]["launches"] = counts["layer_tail_train"]
    loss, snr = metrics["loss"].item(), metrics["si_snr"].item()
    print(f"offline: eval step {offline_s * 1e3:.1f} ms, loss {loss:.4f}, "
          f"si_snr {snr:.3f} dB, K2 launches {counts['layer_tail_train']}, "
          f"K1 launches {counts['diag_scan']}", flush=True)
    assert noisy_mag.shape == (B, 257, frames), noisy_mag.shape
    assert np.isfinite(loss) and np.isfinite(snr), metrics
    assert counts["layer_tail_train"] == n_layers, counts
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

    mark("offline phase")

    # ---------------- streaming phase (K1) ----------------
    den = StreamingDenoiser(model, batch_size=B)
    kernel_launches()
    t0 = time.time()
    out_chunked = den.process_offline(noisy, chunk_samples=CHUNK)
    torch.cuda.synchronize()
    stream_s = time.time() - t0
    counts = ledger(reset=True)
    records["diag_scan"]["launches"] = counts["diag_scan"]
    n_chunks = -(-audio_len // CHUNK)
    print(f"streaming: {n_chunks} chunks of {CHUNK} samples in "
          f"{stream_s * 1e3:.1f} ms, K1 launches {counts['diag_scan']} "
          f"(kernel passes {counts['diag_scan_passes']}), K2 launches "
          f"{counts['layer_tail_train']}", flush=True)
    assert counts["diag_scan"] >= n_layers * (n_chunks - 1), counts
    # a chunk of CHUNK samples is at most SHORT_LENGTH frames: the plan
    # makes each K1 call one pass, so a chunk launches n_layers kernels
    chunk_plan = diag_scan.scan_plan(B, CHUNK // 128 + 1, p)
    assert CHUNK // 128 + 1 <= diag_scan.SHORT_LENGTH
    assert len(chunk_plan.launches()) == 1, chunk_plan
    assert counts["diag_scan_passes"] == counts["diag_scan"], counts
    assert counts["layer_tail_train"] == 0, counts
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

    mark("streaming phase")

    # ---------------- engine set-up: calibrate, freeze, build ----------
    eng = engine_setup(cfg, model, noisy_mag)
    mark("engine set-up")

    # ---------------- engine kernel phase (K5a, K5b, K6) ----------------
    engine_kernel_phase(cfg, eng, gen, records)
    mark("engine kernel phase")

    # ---------------- engine offline phase (K6, then the K5a stack) -----
    engine_offline_phase(cfg, eng, (noisy_mag, noisy_phase, clean_mag),
                         clean_t, (loss, snr), records)
    mark("engine offline phase")

    # ---------------- engine streaming phase (K5b) ----------------
    engine_streaming_phase(cfg, eng, noisy, out_chunked.shape, records)
    mark("engine streaming phase")

    # ---------------- training kernel phase (K2-train, K3a, K3b) --------
    training_kernel_phase(layer0, cfg, frames, gen, records)
    mark("training kernel phase")

    # ---------------- training phase ----------------
    counters = kernel_launches
    batch = _train_batch(cfg.bsz)
    training_phase(cfg, records, counters, batch)
    mark("training phase")

    # ---------------- mixer kernel phase (K1 reverse, K4a, gradients) ----
    mixer_kernel_phase(layer0, cfg, frames, gen, records)
    mark("mixer kernel phase")

    # ---------------- mixer-route training phase ----------------
    mixer_training_phase(cfg, records, counters, batch)

    mark("mixer-route training phase")

    # ---------------- top-k kernel phase (K1 requant, K4a engine, K4b) ---
    topk_kernel_phase(cfg, eng.engine, eng.x_eng, frames, gen, records,
                      eng.frozen)
    mark("top-k kernel phase")

    # ---------------- top-k serving phase ----------------
    topk_serving_phase(cfg, (noisy, clean_t),
                       (noisy_mag, noisy_phase, clean_mag), records,
                       counters)
    mark("top-k serving phase")

    # ---------------- block-sparse kernel phase (K7) ----------------
    block_sparse_kernel_phase(frames, records)
    mark("block-sparse kernel phase")

    # ---------------- pruned training and block-sparse serving ----------
    pruned_serving_phase(cfg, (noisy, clean_t),
                         (noisy_mag, noisy_phase, clean_mag), batch, records,
                         counters)
    mark("pruned training and block-sparse serving phase")

    # ---------------- QAT kernel phase (K1 qat, K4a qat) ----------------
    qat_kernel_phase(cfg, frames, gen, records)
    mark("QAT kernel phase")

    # ---------------- QAT and top-k training, w32a32 engine -------------
    qat_training_phase(cfg, (noisy, clean_t),
                       (noisy_mag, noisy_phase, clean_mag), batch,
                       eng.frozen, records, counters)
    mark("QAT and top-k training phase")

    # ---------------- int-dot kernel phase (K5a, K5b, K6 int modes) -----
    int_trees = intdot_kernel_phase(cfg, model, eng.cal_x, eng.x_eng,
                                    frames, gen,
                                    records)
    mark("int-dot kernel phase")

    # ---------------- int-dot serving phase (w8a8, w8a16 mxu16) ---------
    intdot_serving_phase(cfg, int_trees, (noisy, clean_t),
                         (noisy_mag, noisy_phase, clean_mag), records,
                         counters)
    mark("int-dot serving phase")

    # ---------------- tail kernel modes: non-affine, bf16 streams -------
    tail_modes_kernel_phase(layer0, cfg, frames, gen, records)
    mark("tail modes kernel phase")

    # ---------------- LayerNorm on the whole-layer route ----------------
    layernorm_training_phase(cfg, records, counters, batch)
    mark("LayerNorm training phase")

    # ---------------- bf16 stream training ----------------
    bf16_training_phase(cfg, records, counters, batch)
    mark("bf16 stream training phase")

    # ---------------- the fixed-point recurrence (fxp_scan) -------------
    fxp_scan_kernel_phase(frames, gen, records)
    mark("fxp_scan kernel phase")

    # ---------------- the conversion pipeline from a checkpoint ---------
    full_x = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2).contiguous()
    pipeline_phase(root, counters, records, full_x)
    mark("pipeline phase")

    # ---------------- the rest of the run surface ----------------
    classification_phase(cfg, root, records, counters)
    mark("classification phase")
    bn_fusion_phase(cfg, batch, counters)
    mark("BatchNorm folding phase")
    blocked_phase(cfg, model, batch, counters)
    mark("blocked scan phase")
    xla_route_phase(cfg, eng, counters)
    mark("xla route phase")
    tbptt_phase(cfg, batch[2], counters)
    mark("TBPTT phase")
    wav_corpus_phase(cfg, counters)
    mark("WAV corpus phase")

    # ---------------- the device mesh ----------------
    parallel_phase(cfg, model, eng, counters)
    mark("parallel phase")
    print(f"whole run: {time.time() - run_start:.1f} s", flush=True)

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
