"""PyTorch + CUDA port of ``sparsernns_tpu`` for the NVIDIA H100.

Slice ported so far: float NDNS serving — the offline eval forward (the
whole-layer tail kernel, ``ops/cuda/layer_tail.py``) and the streaming
forward (the diagonal-scan kernel with carry, ``ops/cuda/diag_scan.py``).
Module names follow the JAX package. Entry points run on ``"cuda"`` unless
the caller passes another device.
"""
