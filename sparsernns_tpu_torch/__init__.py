"""PyTorch + CUDA port of ``sparsernns_tpu`` for the NVIDIA H100.

Slices ported so far: float NDNS serving — the offline eval forward (the
whole-layer tail kernel, ``ops/cuda/layer_tail.py``) and the streaming
forward (the diagonal-scan kernel with carry, ``ops/cuda/diag_scan.py``) —
and w8a16 engine serving: calibration, frozen scales and the
``quantize/engine.W8A16Engine`` over the whole-network kernel
(``ops/cuda/engine_network.py``) and the whole-layer kernel with an
optional carry (``ops/cuda/engine_layer.py``).
Module names follow the JAX package. Entry points run on ``"cuda"`` unless
the caller passes another device.
"""
