"""The serving engine's int8 float dots on the tensor cores, on the CPU:
the exact bf16 planes of their float32 operands (K7's ``split_f32``, the
mirror of the shared ``split3``), every plane-by-code product exact in
float32, and a plain mirror of the kernel's products
(``engine_layer.tile_mma_plain``: its k order inside a step, its columns
of each n-block, K and N padded with zeros) and of the fragments it reads
(``mma_fragments``) summed in float64 equal to the
float64 dot at the engine's shapes; which networks get the fragments
(``attach_fragments``: no integer dot anywhere) and how the packs and
K4a's engine mode hand them on.
"""

import numpy as np
import pytest
import torch

from sparsernns_tpu_torch.ops.cuda import block_sparse as bs
from sparsernns_tpu_torch.ops.cuda import engine_layer as el

BF16 = torch.bfloat16


def _f32(lo: int, hi: int, n: int, seed: int) -> torch.Tensor:
    """Random f32 of both signs with exponents in [lo, hi), and zeros of
    both signs."""
    rng = np.random.RandomState(seed + 7 * (lo + 200))
    v = (np.where(rng.rand(n) < 0.5, -1.0, 1.0) * rng.uniform(1.0, 2.0, n)
         * np.exp2(rng.randint(lo, hi, n))).astype(np.float32)
    v[::97] = 0.0
    v[1::97] = -0.0
    return torch.from_numpy(v)


# the operands of the engine's float dots: the stream after the prenorm
# affine, the states on their grid times the C-side scale, gelu's x1 (down
# to 0.5 * |y| * 2^-24), the decoder's h; the bands cover all of f32 down to
# split3's exact range
BANDS = [(-110, -80), (-80, -40), (-40, -8), (-8, 8), (8, 40), (40, 120)]


@pytest.mark.parametrize("band", BANDS)
def test_three_planes_sum_to_the_operand(band):
    x = _f32(*band, 20000, 0)
    planes = bs.split_f32(x)
    assert len(planes) == 3 and all(p.dtype == BF16 for p in planes)
    total = sum(p.to(torch.float64) for p in planes)
    assert torch.equal(total, x.to(torch.float64))
    # zeros keep their sign in the top plane; the others are +0
    zeros = x == 0
    assert torch.equal(torch.signbit(planes[0][zeros]),
                       torch.signbit(x[zeros]))


@pytest.mark.parametrize("band", BANDS)
def test_every_plane_times_every_code_is_exact_in_f32(band):
    x = _f32(*band, 512, 1)
    codes = torch.arange(-128, 128, dtype=torch.int8)
    for p in bs.split_f32(x):
        prod32 = p.to(torch.float32)[:, None] * codes.to(torch.float32)
        prod64 = p.to(torch.float64)[:, None] * codes.to(torch.float64)
        assert torch.equal(prod32.to(torch.float64), prod64)


def test_k_order_is_one_permutation_for_a_and_b():
    """Each step's 16 slots take k0 .. k0 + 15 once; lane t's four slots
    (2t, 2t + 1, 2t + 8, 2t + 9) take k0 + 4t .. k0 + 4t + 3, the float4
    of A and the word of four codes' rows of B it loads."""
    for k0 in (0, 16, 256):
        ks = el.mma_k_order(k0)
        assert sorted(ks) == list(range(k0, k0 + 16))
        for t in range(4):
            assert [ks[s] for s in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
                    ] == [k0 + 4 * t + e for e in range(4)]


def test_columns_cover_each_once():
    """A group's four n-blocks take its 32 columns once; lane (g, t) holds
    mma's n = 2t, 2t + 1 of each block: columns 8t .. 8t + 7 of the group,
    and multiplies the codes of columns 4g .. 4g + 3 (n = g of each block)."""
    for group in (0, 1, 8):
        cols = [c for j in range(4) for c in el.mma_columns(group, j)]
        assert sorted(cols) == list(range(32 * group, 32 * group + 32))
        for t in range(4):
            held = sorted(el.mma_columns(group, j)[n] for j in range(4)
                          for n in (2 * t, 2 * t + 1))
            assert held == [32 * group + 8 * t + i for i in range(8)]
        for g in range(8):
            loaded = [el.mma_columns(group, j)[g] for j in range(4)]
            assert loaded == [32 * group + 4 * g + j for j in range(4)]


def _operand(rows: int, k: int, band, seed: int) -> torch.Tensor:
    """A tile of rows x k operands, each row within one exponent band of
    width 12 (so every sum of plane products is exact in float64)."""
    lo = band[0] + (np.arange(rows) % max(1, band[1] - band[0] - 12))
    rng = np.random.RandomState(seed)
    v = (np.where(rng.rand(rows, k) < 0.5, -1.0, 1.0)
         * rng.uniform(1.0, 2.0, (rows, k))
         * np.exp2(lo[:, None] + rng.randint(0, 12, (rows, k))))
    v[rng.rand(rows, k) < 0.05] = 0.0
    return torch.from_numpy(v.astype(np.float32))


# (K, N) of the w8a16 engine's products: encoder (K = 257 padded with zero
# rows), B-projection, C-projection, GLU gate, decoder (N = 257: masked
# columns), and a wide layer
SHAPES = {"encoder": (257, 192), "b_proj": (192, 256), "c_proj": (256, 192),
          "gate": (192, 192), "decoder": (192, 257), "wide": (520, 520)}


@pytest.mark.parametrize("rows", [32, 18])
@pytest.mark.parametrize("name", list(SHAPES))
def test_mirror_of_the_products_is_the_float64_dot(name, rows):
    k, n = SHAPES[name]
    gen = torch.Generator().manual_seed(k * n)
    w = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8)
    band = (-40, -8) if rows == 32 else (-8, 20)
    a = _operand(rows, k, band, k + n + rows)
    want = a.to(torch.float64) @ w.to(torch.float64)
    got = el.tile_mma_plain(a, w, torch.float64)
    assert got.shape == (rows, n)
    assert torch.equal(got, want)


def test_mirror_in_float32_is_within_rounding_of_the_dot():
    """In float32 the mirror sums the same exact products in the kernel's
    order: within a few float32 roundings of the dot, as the fmaf chain."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((32, 192), generator=gen)
    w = torch.randint(-128, 128, (192, 256), generator=gen, dtype=torch.int8)
    want = a.to(torch.float64) @ w.to(torch.float64)
    got = el.tile_mma_plain(a, w).to(torch.float64)
    scale = a.abs().to(torch.float64) @ w.abs().to(torch.float64)
    assert ((got - want).abs() <= 64 * 2.0 ** -24 * scale).all()


@pytest.mark.parametrize("k,n", [(257, 192), (192, 257), (16, 32)])
def test_fragments_are_the_codes_each_lane_multiplies(k, n):
    """``mma_fragments``: half h of register q of n-block j of lane (g, t)
    in column group G, k-step S holds the code at k = 16S + 4t + 2q + h,
    column 32G + 4g + j, zero past K and N; the codes exact in bf16."""
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8)
    f = el.mma_fragments(w)
    groups, steps = -(-n // 32), -(-k // 16)
    assert f.dtype == BF16 and f.shape == (groups, steps, 8, 4, 4, 2, 2)
    wide = torch.zeros((16 * steps, 32 * groups))
    wide[:k, :n] = w.float()
    for grp in range(groups):
        for s in range(steps):
            for g in range(8):
                for t in range(4):
                    rows = [16 * s + 4 * t + 2 * q + h for q in range(2)
                            for h in range(2)]
                    for j in range(4):
                        want = wide[rows, 32 * grp + 4 * g + j]
                        assert torch.equal(
                            f[grp, s, g, t, j].reshape(4).float(), want)
    # the k of lane t's registers is mma's k order
    ks = el.mma_k_order(0)
    for t in range(4):
        assert [4 * t + 2 * q + h for q in range(2) for h in range(2)] == \
            [ks[s] for s in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]


def test_fragments_are_made_once_per_weight():
    """``attach_fragments`` lays out each int8 weight's fragments once and
    keeps them beside it; every pack of the weight hands the kernel those
    same fragments, and a weight packed without them runs as fmaf tiles."""
    from test_torch_engine_width import _float_network
    enc, layer, dec, mode = _float_network(64, p=16)
    cpu = torch.device("cpu")
    assert el.pack_weight(layer.w_b, None, None, "w_b", (64, 32), cpu).wf \
        is None
    assert el.attach_fragments(enc, [layer], dec, mode)
    frags = layer.wb_frags
    assert torch.equal(frags, el.mma_fragments(layer.w_b))
    assert frags.shape == el.fragments_shape(64, 32)
    for _ in range(2):
        lp = el.pack_layer(layer, mode, cpu)
        assert lp.wb.wf == frags.data_ptr()
        assert lp.wc.wf == layer.wc_frags.data_ptr()
        assert lp.out2.wf == layer.out2_kernel.frags.data_ptr()
    assert el.pack_dense(enc, "encoder", (9, 64), cpu).wf == \
        enc.kernel.frags.data_ptr()
    with pytest.raises(ValueError, match="fragments"):
        el.pack_weight(layer.w_b, None, None, "w_b", (64, 32), cpu,
                       el.mma_fragments(layer.w_c))


def _variant(name: str):
    """The float network of ``test_torch_engine_width`` as the w8a16
    engine holds it, or with one integer dot (w8a8's gate or encoder on
    the codes of their input, mxu16's B-projection), or over int16 or
    float32 weights."""
    import dataclasses
    from test_torch_engine_width import _float_network
    enc, layer, dec, mode = _float_network(64, p=16)
    grid = (2.0 ** -6, 8)
    if name == "int_gate":
        layer = dataclasses.replace(layer, out2_in_scale=grid)
    elif name == "int_encoder":
        enc = enc._replace(in_spec=grid)
    elif name == "mxu16":
        from sparsernns_tpu_torch.ops.intdot import weight_colsum
        layer = dataclasses.replace(layer, mixer_in16=(2.0 ** -9, 16),
                                    cs_wb=weight_colsum(layer.w_b))
    elif name in ("int16", "f32"):
        dtype = torch.int16 if name == "int16" else torch.float32
        layer = dataclasses.replace(layer, w_b=layer.w_b.to(dtype),
                                    w_c=layer.w_c.to(dtype))
    return enc, layer, dec, mode


@pytest.mark.parametrize("name", ["w8a16", "int_gate", "int_encoder",
                                  "mxu16", "int16", "f32"])
def test_only_layers_without_integer_dots_take_the_tensor_cores(name):
    """One rule for the network (``attach_fragments``): where no dense runs
    an integer dot, every int8 float-dot weight (the encoder, B- and
    C-projection, gate, decoder) gets its fragments; one integer dot
    anywhere, in a layer or in the encoder, and none does, so every float
    dot stays fmaf chains; int16 and float32 weights never do."""
    enc, layer, dec, mode = _variant(name)
    layer.wb_frags = el.mma_fragments(layer.w_b.to(torch.int8))   # stale
    on = el.attach_fragments(enc, [layer], dec, mode)
    assert on == (name in ("w8a16", "int16", "f32"))
    lp = el.pack_layer(layer, mode, torch.device("cpu"))
    denses = [lp.wb, lp.wc, lp.out2,
              el.pack_dense(enc, "encoder", (9, 64), torch.device("cpu")),
              el.pack_dense(dec, "decoder", (64, 9), torch.device("cpu"))]
    int8_mixer = name not in ("int16", "f32")
    want = [on and int8_mixer] * 2 + [on] * 3
    assert [bool(d.wf) for d in denses] == want


def test_k4a_engine_takes_the_fragments_beside_its_weights():
    """K4a's engine mode takes a layer's fragments as ``frags``; its plain
    version, on the CPU, sums float dots whatever they hold."""
    from sparsernns_tpu_torch.ops.cuda import fused_s5
    enc, layer, dec, mode = _float_network_attached()
    u = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(1))
    kw = dict(block_t=4, wb_scales=layer.wb_scales,
              wc_scales=layer.wc_scales, block_requant=layer.state_requant)
    ops = (u, layer.lam, layer.w_b, layer.w_c, layer.d)
    assert torch.equal(
        fused_s5.fused_s5_engine(*ops, frags=(layer.wb_frags,
                                              layer.wc_frags), **kw),
        fused_s5.fused_s5_engine_plain(*ops, **kw))


def _float_network_attached():
    from test_torch_engine_width import _float_network
    enc, layer, dec, mode = _float_network(64, p=16)
    assert el.attach_fragments(enc, [layer], dec, mode)
    return enc, layer, dec, mode
