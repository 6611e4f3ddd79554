"""The width refusal of the serving kernels K5 / K6 on the CPU: the bytes
of shared memory a row pass takes (``engine_layer.row_pass_smem``, the
Python side of ``row_pass_smem`` in ``csrc/engine_passes.cuh``) in every
mode a K5a / K5b / K6 pass launches (float-dot and int-dot, ``y_out`` or
not, the code tile inside the state tile or beside it), the cached bound
above it that lets the wrappers skip the exact count, the widest layer
each mode admits at P = 128, and the wrappers refusing a wider one before
any launch.
"""

import os

import pytest
import torch

from sparsernns_tpu_torch.ops.cuda import build, engine_layer, engine_network
from sparsernns_tpu_torch.ops.cuda.engine_layer import (
    MAX_SMEM, ROW_TILE, Dense, DenseW, LayerMode, LayerParams,
    check_row_passes, row_pass_smem, widest_row_pass)
from sparsernns_tpu_torch.ops.intdot import weight_colsum
from sparsernns_tpu_torch.quantize.engine import QWeight, _LayerPack

CSRC = os.path.join(os.path.dirname(engine_layer.__file__), "csrc",
                    "engine_passes.cuh")


def _layer(p: int, ut=0, st=0, out2=0, out1=0) -> LayerParams:
    lp = LayerParams()
    lp.p, lp.ut_mode, lp.st_mode = p, ut, st
    lp.out2.in_mode, lp.out1.in_mode = out2, out1
    return lp


def _dense(in_mode=0) -> DenseW:
    d = DenseW()
    d.w, d.in_mode = 1, in_mode     # any non-null pointer: the stage runs
    return d


def test_formula_is_the_cuda_sources():
    """The CUDA expression this module mirrors, as it stands in the
    source: a change there must change :func:`row_pass_smem` too."""
    src = open(CSRC).read()
    for line in (
            "return sizeof(float) * (size_t)kT *",
            "((a.y_out ? 1 : 2) * round4(a.mode.h) + union_width(a)) +",
            "(q_in_s(a) ? 0 : 2 * (size_t)kT * a.ldq);",
            "return imax(a.has_tail ? ldh + a.ldp : 0, a.enc.w ? "
            "round4(a.d_in) : 0);",
            "return a.has_tail && 2 * a.ldq <= 4 * a.ldp;",
            "int q_w = a.enc.w && a.enc.in_mode ? a.d_in : 0;",
            "if (a.dec.w && a.dec.in_mode) q_w = imax(q_w, h);"):
        assert line in src, line
    assert ROW_TILE == 32 and MAX_SMEM == 232448


# (pass, H, ld_bu, bytes by hand): 4 * 32 * (tiles of R, Z [, Y + S | X])
# + 2 * 32 * ldq where the code tile Q does not fit in S
CASES = {
    # float dots: no code tile
    "float encoder + head": (dict(d_in=257, head=_layer(128),
                                  enc=_dense()), 192, 256,
                             128 * (2 * 192 + 260)),
    "float tail + head": (dict(tail=_layer(128), head=_layer(128)), 192, 256,
                          128 * (3 * 192 + 256)),
    "float tail + decoder": (dict(tail=_layer(128), dec=_dense()), 192, 256,
                             128 * (3 * 192 + 256)),
    "float mixer alone (y_out)": (dict(tail=_layer(128), y_out=True), 192,
                                  256, 128 * (192 + 192 + 256)),
    # w8a8: the GLU dense and the decoder on codes; Q (192 B a row) in S
    "int tail + head, Q in S": (dict(tail=_layer(128, out2=1),
                                     head=_layer(128, out2=1)), 192, 256,
                                128 * (3 * 192 + 256)),
    "int tail + decoder, Q in S": (dict(tail=_layer(128, out2=1),
                                        dec=_dense(1)), 192, 256,
                                   128 * (3 * 192 + 256)),
    # the encoder's codes (257 -> 260 B a row) beside X: no tail, no S
    "int encoder + head, Q beside": (dict(d_in=257, head=_layer(128, out2=1),
                                          enc=_dense(1)), 192, 256,
                                     128 * (2 * 192 + 260) + 64 * 260),
    # H = 600 > 2 * ld_bu: Q (600 B) beside S (1024 B a row)
    "int tail + head, Q beside": (dict(tail=_layer(128, out2=1),
                                       head=_layer(128, out2=1)), 600, 256,
                                  128 * (3 * 600 + 256) + 64 * 600),
    # mxu16: the states' codes 2 * round4(P) wide
    "mxu16 states, Q in S": (dict(tail=_layer(128, ut=1, st=1)), 100, 256,
                             128 * (3 * 100 + 256)),
    "mxu16 y_out, Q beside": (dict(tail=_layer(300, ut=1, st=1),
                                   y_out=True), 100, 100,
                              128 * (100 + 100 + 100) + 64 * 600),
}


@pytest.mark.parametrize("name", list(CASES))
def test_row_pass_bytes(name):
    """The exact count, and the wrappers' cached bound above it (layers of
    at most ``p`` states: the state row's half or the widest layer's)."""
    kw, h, ld_bu, want = CASES[name]
    assert row_pass_smem(h, ld_bu, **kw) == want
    p = max([ld_bu // 2] + [kw[k].p for k in ("tail", "head") if k in kw])
    assert widest_row_pass(h, p, kw.get("d_in", 0)) >= want


def _widest(passes_of) -> int:
    h = 4
    while True:
        try:
            check_row_passes(h + 1, 256, passes_of())
        except ValueError:
            return h
        h += 1


@pytest.mark.parametrize("mode,limit", [("float", 520), ("w8a8", 512),
                                        ("mxu16", 512)])
def test_widest_layer_at_p128(mode, limit):
    """K6's passes of a 3-layer network at P = 128: the widest H each
    mode admits (recorded in ROADMAP's differences: K2 872, K4a 780)."""
    flags = {"float": {}, "w8a8": dict(out2=1),
             "mxu16": dict(ut=1, st=1, out2=1)}[mode]
    io = 0 if mode == "float" else 1

    def passes():
        lay = _layer(128, **flags)
        return [dict(d_in=257, enc=_dense(io), head=lay),
                dict(d_in=257, tail=lay, head=lay),
                dict(d_in=257, tail=lay, head=lay),
                dict(d_in=257, tail=lay, dec=_dense(io))]
    assert _widest(passes) == limit
    # the wrappers count exactly only where the bound does not fit: the
    # bound is above every pass's count at every width up to the limit
    for h in range(4, limit + 2):
        bound = widest_row_pass(h, 128, 257)
        assert all(bound >= row_pass_smem(h, 256, **kw) for kw in passes())
    assert min(h for h in range(4, limit + 2)
               if widest_row_pass(h, 128, 257) > MAX_SMEM) == 445
    check_row_passes(192, 256, passes())      # the flagship fits
    with pytest.raises(ValueError, match="shared memory"):
        check_row_passes(limit + 1, 256, passes())


def _float_network(h: int, p: int = 128, d_io: int = 9):
    gen = torch.Generator().manual_seed(0)

    def qweight(k, n):
        w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
        return QWeight(w, 2.0 ** -7, weight_colsum(w))

    vec = lambda n: 0.1 * torch.randn(n, generator=gen)  # noqa: E731
    layer = _LayerPack(
        lam=(0.5 * torch.ones(p), torch.zeros(p)),
        w_b=qweight(h, 2 * p).data, w_c=qweight(2 * p, h).data, d=vec(h),
        norm_w=1.0 + vec(h), norm_b=vec(h), out2_kernel=qweight(h, h),
        out2_bias=vec(h), residual_requant=(2.0 ** -9, 16),
        state_requant=(2.0 ** -7, 2.0 ** -7, 16),
        wb_scales=(2.0 ** -7, 2.0 ** -7), wc_scales=(2.0 ** -7, 2.0 ** -7))
    enc = Dense(qweight(d_io, h), vec(h))
    dec = Dense(qweight(h, d_io), vec(d_io))
    return enc, layer, dec, LayerMode(act_dtype=torch.float32)


@pytest.mark.parametrize("kernel", ["K6", "K5"])
def test_wrappers_refuse_before_any_launch(monkeypatch, kernel):
    """A layer of H = 528 at P = 128: the wrappers raise ValueError after
    packing, before the library is loaded or any scratch is taken."""
    def no_launch(*_):
        raise AssertionError("launched")
    monkeypatch.setattr(build, "entry", no_launch)
    monkeypatch.setattr(engine_network, "alloc_scratch", no_launch)
    monkeypatch.setattr(engine_layer, "alloc_scratch", no_launch)
    enc, layer, dec, mode = _float_network(528)
    x = torch.zeros(1, 4, 9)
    with pytest.raises(ValueError, match="shared memory"):
        if kernel == "K6":
            engine_network.engine_network_cuda(x, enc, [layer], dec, mode,
                                               block_t=4)
        else:
            engine_layer.engine_layer_cuda(x, layer, mode, block_t=4,
                                           enc=enc, dec=dec)
