"""PyTorch + CUDA port of ``sparsernns_tpu`` for the NVIDIA H100.

Slices ported so far: float NDNS serving — the offline eval forward (the
whole-layer tail kernel, ``ops/cuda/layer_tail.py``) and the streaming
forward (the diagonal-scan kernel with carry, ``ops/cuda/diag_scan.py``) —
and w8a16 engine serving: calibration, frozen scales and the
``quantize/engine.W8A16Engine`` over the whole-network kernel
(``ops/cuda/engine_network.py``) and the whole-layer kernel with an
optional carry (``ops/cuda/engine_layer.py``) — and float NDNS training:
``train/loop.train``, the train step and its microbatch form
(``train/steps.py``), the optimizer groups and schedules
(``train/optim.py``) and checkpoints (``train/checkpoint.py``), every
layer's forward and backward through the tail kernel with dropout masks
and its carry-history and reverse-time adjoint kernels
(``ops/cuda/layer_tail_bwd.py``) — and the mixer route: offline forward and
training of the models outside the whole-layer kernel (postnorm, LayerNorm,
bidirectional, ``scan_mode="pallas"``) through the S5 mixer kernel and its
gradient (``ops/cuda/fused_s5.py``) and the diagonal-scan kernel in both
directions under autograd (``ops/scan.py``) — and activation top-k
serving (``ops/topk.py``, the engine's per-op route) — and pruned training
(magnitude, state-channel and tile masks with STE, ``train/pruning.py``)
with block-sparse engine serving over the block-sparse matmul kernel
(``ops/cuda/block_sparse.py``) — and the conversion pipeline from a
training run's checkpoint (``quantize/convert.convert``, its artifacts
served by ``W8A16Engine.from_artifacts``) behind the command line
``python -m sparsernns_tpu_torch.cli train|convert|fxp`` — and the
fixed-point golden engine (``fxp/``) — and the rest of the run surface:
the classification and retrieval heads with their datasets, steps and
epoch loop, truncated backpropagation through time (``data/tbptt.py``),
BatchNorm folding, the kernel-free routes (``scan_mode="blocked"``, the
engine's ``route="xla"``), the WAV corpus with its native decoder, the
metrics sinks and the hyperparameter search (``train/tune.py``).
Module names follow the JAX package. Entry points run on ``"cuda"`` unless
the caller passes another device.
"""
