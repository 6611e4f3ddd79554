"""Operations and bytes of S5 on LRA Path-X and of its scan kernel, from
shapes.

FLOPs count a multiply-add as two, as ``cost/model.py`` counts them: the
encoder, per layer the B-projection (H -> 2P real columns), the two
complex scans (8 per state and step each), the C-projection from the
4P real columns of both directions' states, the D term with residual,
norm and activation (8 per feature and step) and the GLU gate dense with
its sigmoid (2 H^2 + 3 H per step); then the mean over time and the
decoder to the classes. Bytes count each input read once and each
output written once, in float32.
"""

from __future__ import annotations

from typing import NamedTuple

from benchmark.cost.model import Cost


class Shape(NamedTuple):
    b: int          # sequences a step
    l: int          # steps of a sequence
    d_in: int       # features a step
    h: int          # d_model
    p: int          # complex states of one direction
    n_layers: int
    classes: int


def layer_forward_flops(s: Shape) -> float:
    """One bidirectional half1 layer's forward."""
    bl = s.b * s.l
    return (2.0 * bl * s.h * 2 * s.p          # B-projection
            + 2 * 8.0 * bl * s.p              # forward and reverse scans
            + 2.0 * bl * 4 * s.p * s.h        # C-projection
            + 8.0 * bl * s.h                  # D term, residual, norm, act
            + 2.0 * bl * s.h * s.h + 3.0 * bl * s.h)   # gate


def model_forward_flops(s: Shape) -> float:
    bl = s.b * s.l
    return (2.0 * bl * s.d_in * s.h + s.n_layers * layer_forward_flops(s)
            + bl * s.h + 2.0 * s.b * s.h * s.classes)


def k1(s: Shape) -> Cost:
    """One call of K1 (``ops/cuda/diag_scan.cu``) over (B, L, P), either
    direction: reads the bu pair, writes the state pair (8 FLOPs a state
    and step)."""
    n = s.b * s.l * s.p
    return Cost(8.0 * n, 2 * 2 * 4.0 * n)
