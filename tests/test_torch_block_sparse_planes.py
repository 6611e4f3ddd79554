"""K7's tensor-core design on the CPU: the exact bf16 planes, the plain
mirror of the kernel's products, and the launch plan.

The kernel (``csrc/block_sparse.cu``) multiplies the kept tiles on the
tensor cores as bf16 planes whose sum is exactly the value the function
multiplies: f32 x as three planes, int16 tiles as ``hi·256 + lo``, f32
tiles as three planes (one rounded plane of each with bf16 x, as the
Pallas kernel rounds them). Here:

- the planes' plain mirrors (``split_f32``, ``split_int16``,
  ``tile_planes``) are exact: the float64 sum of the planes is the value,
  over normals from 2^-110 to the largest finite f32 and at 0, ±1 and the
  smallest normal. Below 2^-110 (tiny normals and subnormals) the last
  plane rounds onto bf16's subnormal grid: within 2^-134. A non-finite
  value is its own top plane;
- every plane × plane product is exact in float32;
- ``block_sparse_matmul_planes`` (the kernel's products in its order: 16-
  deep k-steps, each tile plane, each x plane) is held against
  ``block_sparse_matmul_plain`` within 1e-5·max(1, |ref|) and against the
  Pallas kernel in interpret mode (as ``tests/test_block_sparse.py`` runs
  it) at the kernel's tiles, K = 257 and N = 257 edge tiles and an empty
  output tile; bit for bit on an exact grid;
- ``launch_plan`` covers every (row, output tile) once, fills the card at
  M = 30008 and states its CTAs at the chunk shape M = 1024; what the
  kernel does not take is refused when the weight is packed, before
  anything reaches a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.block_sparse import \
    block_sparse_matmul as jax_block_sparse_matmul
from sparsernns_tpu.ops.pallas.block_sparse import \
    pack_block_sparse as jax_pack
from sparsernns_tpu_torch.ops.cuda import block_sparse as bs
from sparsernns_tpu_torch.utils.trace import launch_counts

F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).tiny)   # the smallest normal
BF16 = torch.bfloat16


def _sum64(planes):
    return sum(p.to(torch.float64) for p in planes)


def _normals(lo: int, hi: int, n: int = 20000, seed: int = 0):
    """Random f32 of both signs with exponents in [lo, hi)."""
    rng = np.random.RandomState(seed + lo + 200)
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.randint(lo, hi, n)
    sign = np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    v = (sign * np.ldexp(mant, exp)).astype(np.float32)
    return torch.from_numpy(v[np.isfinite(v)])


# ------------------------------------------------ the planes

@pytest.mark.parametrize("band", [(-110, -64), (-64, -8), (-8, 8), (8, 64),
                                  (64, 128)])
def test_split_f32_is_exact_over_the_exponent_range(band):
    x = _normals(*band)
    planes = bs.split_f32(x)
    assert all(p.dtype == BF16 for p in planes)
    assert torch.equal(_sum64(planes), x.to(torch.float64))


@pytest.mark.parametrize("value", [0.0, -0.0, 1.0, -1.0, F32_MAX, -F32_MAX,
                                   F32_TINY, -F32_TINY, 2.0 ** -110,
                                   1.0 + 2.0 ** -23, -(2.0 - 2.0 ** -23)])
def test_split_f32_is_exact_at_the_edges(value):
    x = torch.tensor([value], dtype=torch.float32)
    top, mid, low = bs.split_f32(x)
    assert torch.equal(_sum64((top, mid, low)), x.to(torch.float64))
    # the top plane holds the top 8 significant bits: it never overflows
    assert torch.isfinite(top.float()).all()


@pytest.mark.parametrize("band", [(-149, -126), (-126, -110)])
def test_split_f32_below_2_pow_110_rounds_the_last_plane(band):
    """Tiny normals and subnormals: the planes' sum is within half a step of
    bf16's subnormal grid (2^-133) of x."""
    if band[0] == -149:   # subnormals: any bit pattern below the normals
        rng = np.random.RandomState(5)
        bits = rng.randint(1, 1 << 23, 5000).astype(np.int32)
        x = torch.from_numpy(bits.view(np.float32))
    else:
        x = _normals(*band, seed=3)
    err = (_sum64(bs.split_f32(x)) - x.to(torch.float64)).abs()
    assert err.max().item() <= 2.0 ** -134


def test_split_f32_of_non_finite_values():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    top, mid, low = bs.split_f32(x)
    assert torch.equal(top[:2].float(), x[:2]) and torch.isnan(top[2])
    assert not mid.float().any() and not low.float().any()


def test_split_int16_is_exact_for_every_value():
    w = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    hi, lo = bs.split_int16(w)
    assert torch.equal(hi.to(torch.int32) + lo.to(torch.int32),
                       w.to(torch.int32))
    assert lo.float().min() >= 0 and lo.float().max() <= 255
    assert torch.equal(hi.float() % 256, torch.zeros_like(hi.float()))


def _tile_values(dtype: str, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    if dtype == "int8":
        return torch.from_numpy(rng.randint(-128, 128, 4096).astype(np.int8))
    if dtype == "int16":
        return torch.from_numpy(
            rng.randint(-32768, 32768, 4096).astype(np.int16))
    return _normals(-30, 30, 4096, seed)


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("w_dtype", ["int8", "int16", "f32"])
def test_plane_products_are_exact_in_f32(w_dtype, x_dtype):
    """Every tile plane × x plane product the kernel makes is exact in
    float32, and the planes of each operand sum to the value multiplied
    (with bf16 x, the tile rounded to bf16 as the Pallas kernel takes it)."""
    w = _tile_values(w_dtype, 1)
    x = _normals(-40, 40, 4096, 2)[:w.numel()].to(x_dtype)
    w_planes = bs.tile_planes(w, x_dtype)
    x_planes = bs.x_planes(x)
    assert len(w_planes) == bs.n_planes(x_dtype, w.dtype)
    assert len(x_planes) == (1 if x_dtype == BF16 else 3)
    used = w.to(x_dtype) if x_dtype == BF16 else w
    assert torch.equal(_sum64(w_planes), used.to(torch.float64))
    assert torch.equal(_sum64(x_planes), x.to(torch.float64))
    for q in w_planes:
        for p in x_planes:
            prod32 = p.float() * q.float()
            assert torch.equal(prod32.to(torch.float64),
                               p.to(torch.float64) * q.to(torch.float64))


# ------------------------------------------------ the mirror of the kernel

def _weight(rng, k, n, zero, dtype, kept=None):
    """A (k, n) weight with (32, 128) tiles zero but for a ``1 - zero``
    share (or the (input, output) tiles ``kept``)."""
    kt, nt = -(-k // 32), -(-n // 128)
    if kept is None:
        tiles = [(i, j) for i in range(kt) for j in range(nt)]
        rng.shuffle(tiles)
        kept = tiles[int(zero * len(tiles)):]
    w = np.zeros((k, n), dtype)
    for i, j in kept:
        blk = w[i * 32:(i + 1) * 32, j * 128:(j + 1) * 128]
        if dtype == np.float32:
            blk[...] = rng.randn(*blk.shape)
        else:
            hi = np.iinfo(dtype).max
            blk[...] = rng.randint(-hi, hi + 1, size=blk.shape)
    return w


#: name: (K, N, bk, zero share, tile dtype, scale, kept (input, output)
#: tiles or None)
CASES = {
    "int8 K=257 edges": (257, 192, 32, 0.5, np.int8, 2.0 ** -7, None),
    "int8 K=257 dense": (257, 192, 32, 0.0, np.int8, 2.0 ** -6, None),
    "int8 encoder, empty output tile": (257, 192, 32, 0.9, np.int8,
                                        2.0 ** -7, [(0, 0), (8, 0)]),
    "int8 N=257 edges": (192, 257, 32, 0.5, np.int8, 2.0 ** -7, None),
    "int16 K=257": (257, 192, 32, 0.5, np.int16, 2.0 ** -15, None),
    "f32 N=257": (192, 257, 32, 0.5, np.float32, None, None),
    "f32 bk=64": (200, 256, 64, 0.5, np.float32, None, None),
}


def _case(name, x_dtype, rows=37):
    k, n, bk, zero, dtype, scale, kept = CASES[name]
    rng = np.random.RandomState(len(name))
    w = _weight(rng, k, n, zero, dtype, kept)
    x = torch.from_numpy(rng.randn(rows, k).astype(np.float32)).to(x_dtype)
    return w, x, bk, scale


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("name", list(CASES))
def test_mirror_matches_plain(name, x_dtype):
    w, x, bk, scale = _case(name, x_dtype)
    packed = bs.pack_block_sparse(w, bk, 128, scale=scale, device="cpu")
    ref = bs.block_sparse_matmul_plain(x, packed)
    out = bs.block_sparse_matmul_planes(x, packed)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    bar = 1e-5 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= bar


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("name", list(CASES))
def test_mirror_matches_pallas(name, x_dtype):
    """Against the Pallas kernel in interpret mode on the same packed
    tiles and x (bf16 x: the same bf16 values in both)."""
    w, x, bk, scale = _case(name, x_dtype, rows=26)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16 if x_dtype == BF16
                     else jnp.float32)
    ref = np.asarray(jax_block_sparse_matmul(
        jx, jax_pack(w, bk=bk, bn=128, scale=scale), bm=8))
    packed = bs.pack_block_sparse(w, bk, 128, scale=scale, device="cpu")
    out = bs.block_sparse_matmul_planes(x.reshape(2, 13, -1), packed)
    assert out.shape == (2, 13, w.shape[1])
    bar = 1e-5 * max(1.0, np.abs(ref).max())
    assert np.abs(out.reshape(26, -1).numpy() - ref).max() <= bar


@pytest.mark.parametrize("w_dtype", [np.int8, np.int16])
def test_mirror_is_bit_equal_on_an_exact_grid(w_dtype):
    """bf16 x of small integers, small integer tiles: every product and sum
    an integer below 2^24, so every order gives the same bits."""
    rng = np.random.RandomState(9)
    w = np.clip(_weight(rng, 257, 192, 0.5, w_dtype), -3, 3).astype(w_dtype)
    x = torch.from_numpy(rng.randint(-8, 9, (64, 257)).astype(
        np.float32)).to(BF16)
    packed = bs.pack_block_sparse(w, 32, 128, device="cpu")
    assert torch.equal(bs.block_sparse_matmul_planes(x, packed),
                       bs.block_sparse_matmul_plain(x, packed))


def test_mirror_keeps_nan_of_the_pad_block():
    """An inf in x gives NaN in an empty output tile (its zero pad block is
    multiplied), as in the plain version and the Pallas kernel."""
    w, x, bk, scale = _case("int8 encoder, empty output tile", torch.float32)
    x[3, 5] = float("inf")
    packed = bs.pack_block_sparse(w, bk, 128, scale=scale, device="cpu")
    out = bs.block_sparse_matmul_planes(x, packed)
    ref = bs.block_sparse_matmul_plain(x, packed)
    assert torch.isnan(out[3, 128:]).all() and torch.isnan(ref[3, 128:]).all()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))


# ------------------------------------------------ the launch plan

PLANS = [(m, n, x_bf16, planes)
         for m in (30008, 1024, 100, 1)
         for n in (192, 257)
         for x_bf16, planes in ((False, 1), (False, 2), (False, 3),
                                (True, 1))]


@pytest.mark.parametrize("m,n,x_bf16,planes", PLANS)
def test_plan_covers_every_row_and_output_tile_once(m, n, x_bf16, planes):
    plan = bs.launch_plan(m, n, x_bf16, planes)
    seen = np.zeros((m, plan.n_tiles), np.int64)
    items = []
    for cta in range(plan.ctas):
        items.extend(plan.items_of(cta))
        for item in plan.items_of(cta):
            rows, j = plan.cell(item)
            seen[rows.start:rows.stop, j] += 1
    assert items == list(range(plan.items))
    assert (seen == 1).all()
    # the ring fits the SM as the plan counts it
    assert plan.per_sm * (plan.smem + bs.SMEM_RESERVED) <= bs.SMEM_PER_SM
    assert 2 <= plan.stages <= 4
    assert 1 <= plan.per_sm <= bs.max_per_sm(plan.bm, planes)
    # a CTA's items differ by at most one
    counts = {len(plan.items_of(c)) for c in range(plan.ctas)}
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("x_bf16,planes", [(False, 1), (False, 2),
                                           (False, 3), (True, 1)])
@pytest.mark.parametrize("n", [192, 257])
def test_plan_fills_the_card(n, x_bf16, planes):
    """At M = 30008 (B = 8 × 3751) 264 CTAs of 128-row tiles, two an SM;
    at the chunk shape M = 1024 16-row tiles, one CTA an item: 128 CTAs at
    N = 192, 192 at N = 257."""
    big = bs.launch_plan(30008, n, x_bf16, planes)
    assert big.bm == 128 and big.ctas >= 132
    assert big.ctas == big.per_sm * 132 == 264
    chunk = bs.launch_plan(1024, n, x_bf16, planes)
    assert chunk.bm == 16
    assert chunk.ctas == chunk.items == {192: 128, 257: 192}[n]


def test_plan_smem_matches_the_layout():
    """Shared memory as the CUDA source lays it out: stages of staged x
    rows (160 bytes f32, 80 bf16) and 32 plane rows of 272 bytes a plane,
    then each warp's 16 epilogue rows of 160 bytes."""
    assert bs.smem_bytes(64, 3, False, 1) == 3 * (64 * 160 + 8704) + 10240
    assert bs.smem_bytes(16, 4, True, 1) == 4 * (16 * 80 + 8704) + 10240
    assert bs.smem_bytes(64, 2, False, 3) == 2 * (64 * 160 + 3 * 8704) + 10240
    # eight warps at a 128-row tile
    assert bs.smem_bytes(128, 3, False, 1) == 3 * (128 * 160 + 8704) + 20480


@pytest.mark.parametrize("bad", ["bk=16", "bk=48", "bn=64", "float64",
                                 "uint8"])
def test_pack_refuses_what_the_kernel_does_not_take(bad):
    """On a CUDA device the tile shape and dtype are checked before the
    packer moves anything (this machine has no card, so reaching the move
    would raise another error)."""
    bk, bn, dtype = 32, 128, np.int8
    if bad.startswith("bk"):
        bk = int(bad[3:])
    elif bad == "bn=64":
        bn = 64
    else:
        dtype = np.dtype(bad)
    w = np.ones((96, 256), dtype)
    with pytest.raises(ValueError, match="kernel takes"):
        bs.pack_block_sparse(w, bk, bn, device="cuda")
    # the CPU takes any tile through the plain version
    cpu = bs.pack_block_sparse(w, bk, bn, device="cpu")
    assert cpu.kernel is None


def test_a_weight_packed_on_the_cpu_is_refused_by_the_kernel():
    w = bs.pack_block_sparse(np.ones((64, 128), np.int8), 32, 128,
                             device="cpu")
    before = launch_counts()["block_sparse"]
    with pytest.raises(ValueError, match="pack it on the card"):
        bs.block_sparse_matmul_cuda(torch.ones(3, 64), w)
    assert launch_counts()["block_sparse"] == before
