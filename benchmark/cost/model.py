"""Operations and bytes of the NDNS model and of its kernels, from shapes.

FLOPs count a multiply-add as two. Bytes count each input read once and
each output written once, float32 streams, whatever a kernel reads again;
weights are included. A kernel's least time is the larger of its FLOPs
over the peak rate and its bytes over the memory rate (``peaks.py``).

``model_forward_flops`` is the program's own count (the JAX package's):
the encoder, per layer the B- and C-projections, the complex scan
(8 per state and step), the D term with residual, norm and activation
(8 per feature and step) and the GLU gate dense with its sigmoid
(2 H^2 + 3 H per step), and the decoder. The STFT is not counted.
"""

from __future__ import annotations

from typing import NamedTuple


class Shape(NamedTuple):
    b: int          # clips
    l: int          # frames
    d_io: int       # STFT bins in and out
    h: int          # d_model
    p: int          # complex states scanned
    n_layers: int


class Cost(NamedTuple):
    flops: float
    bytes: float


def model_forward_flops(s: Shape, glu_variant: str = "half1") -> float:
    bl = s.b * s.l
    flops = 2.0 * bl * s.d_io * s.h
    per_layer = (2.0 * bl * s.h * (2 * s.p) + 8.0 * bl * s.p
                 + 2.0 * bl * (2 * s.p) * s.h + 8.0 * bl * s.h)
    if glu_variant in ("half1", "half2", "full"):
        per_layer += 2.0 * bl * s.h * s.h + 3.0 * bl * s.h
    if glu_variant == "full":
        per_layer += 2.0 * bl * s.h * s.h
    flops += s.n_layers * per_layer
    flops += 2.0 * bl * s.h * s.d_io
    return flops


def layer_forward_flops(s: Shape) -> float:
    """One half1 layer's forward, as ``model_forward_flops`` counts it."""
    bl = s.b * s.l
    return (4.0 * bl * s.h * 2 * s.p + 8.0 * bl * s.p + 8.0 * bl * s.h
            + 2.0 * bl * s.h * s.h + 3.0 * bl * s.h)


def _weights(s: Shape) -> float:
    """float32 bytes of one layer's operands (W_b, W_c, gate, vectors)."""
    return 4.0 * (2 * s.h * 2 * s.p + s.h * s.h + 2 * s.p + 6 * s.h)


def k2(s: Shape) -> Cost:
    """K2, one layer's eval forward in one call: reads the stream, writes
    the layer's output."""
    return Cost(layer_forward_flops(s),
                2 * 4.0 * s.b * s.l * s.h + _weights(s))


def k3b(s: Shape) -> Cost:
    """K3b, one layer's backward after K3a's states: the C-projection and
    the gate dense again (forward), their adjoints (input and weight
    gradients), the adjoint of the B-projection (input and weight), the
    reverse complex scan and the elementwise adjoints (about 20 per
    feature and step). Reads the stream x, its cotangent g and K3a's
    states (B, L, 2P); writes g_x. The B-projection itself is K3a's."""
    bl = s.b * s.l
    proj = 2.0 * bl * s.h * 2 * s.p
    gate = 2.0 * bl * s.h * s.h
    flops = 5 * proj + 3 * gate + 8.0 * bl * s.p + 20.0 * bl * s.h
    return Cost(flops, 4.0 * bl * (3 * s.h + 2 * s.p) + _weights(s))


def k6(s: Shape) -> Cost:
    """K6, the whole network of the w8a16 engine in one call: reads the
    features, writes the mask (float32 each); the int8 weights."""
    bl = s.b * s.l
    w8 = s.d_io * s.h * 2 + s.n_layers * (2 * s.h * 2 * s.p + s.h * s.h)
    return Cost(model_forward_flops(s), 2 * 4.0 * bl * s.d_io + w8)
