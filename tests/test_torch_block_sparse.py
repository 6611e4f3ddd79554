"""The block-sparse matmul (K7) and block-sparse engine serving on the CPU
against the JAX package: the packed fields, the plain matmul against the
Pallas kernel (interpret mode, as ``tests/test_block_sparse.py`` runs it),
and engines of a tile-pruned frozen tree in both packages (which denses
pack block-sparse, which route serves, offline and chunked masks). Also the
mask dtype of ``process_chunk`` on bf16 features: float32 in both packages,
on the stack route and on the per-op route.

The engines use the frozen tree of ``tests/test_torch_quantize.py`` (H 12,
d_io 9, 2 layers, full GLU) with (4, 4) tiles zeroed: the CPU tests run the
plain matmul, which takes any tile; the kernel takes (32·n, 128) tiles.
Bars: the matmul 1e-5·max(1, |ref|); engines max 2e-3·max(1, |ref|) and
mean 1e-4·max(1, |ref|).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.ops.pallas.block_sparse import \
    block_sparse_matmul as jax_block_sparse_matmul
from sparsernns_tpu.ops.pallas.block_sparse import \
    pack_block_sparse as jax_pack
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.ops.cuda.block_sparse import (
    BlockSparseWeight, block_sparse_matmul, block_sparse_matmul_plain,
    pack_block_sparse)
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.engine import QWeight, W8A16Engine
from sparsernns_tpu_torch.utils.trace import launch_counts
from tests.test_torch_quantize import LAYERS, frozen  # noqa: F401

BLOCK = 8
TILE = (4, 4)
FIELDS = ("data", "blk_k", "blk_j", "is_first")


def _tiled(rng, k, n, bk, bn, zero_frac, dtype=np.float32):
    """A (k, n) weight with ``zero_frac`` of its (bk, bn) tiles zero."""
    if dtype == np.int8:
        w = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    else:
        w = rng.randn(k, n).astype(dtype)
    kt, nt = -(-k // bk), -(-n // bn)
    tiles = [(i, j) for i in range(kt) for j in range(nt)]
    rng.shuffle(tiles)
    for i, j in tiles[:int(zero_frac * len(tiles))]:
        w[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = 0
    return w


CASES = {
    # name: (k, n, bk, bn, zero share, dtype, scale)
    "f32 random 0.4": (48, 40, 8, 8, 0.4, np.float32, None),
    "f32 random 0.9": (64, 48, 8, 16, 0.9, np.float32, None),
    "int8 K=257 edges": (257, 192, 32, 128, 0.5, np.int8, 2.0 ** -7),
    "int8 K=257 dense": (257, 192, 32, 128, 0.0, np.int8, 2.0 ** -6),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pack_fields_equal_jax(name):
    k, n, bk, bn, frac, dtype, scale = CASES[name]
    w = _tiled(np.random.RandomState(len(name)), k, n, bk, bn, frac, dtype)
    ref = jax_pack(w, bk=bk, bn=bn, scale=scale)
    out = pack_block_sparse(w, bk=bk, bn=bn, scale=scale, device="cpu")
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    assert out.data.dtype == torch.from_numpy(w).dtype
    assert (out.shape, out.bk, out.bn, out.scale, out.n_zero_blocks) == (
        ref.shape, ref.bk, ref.bn, ref.scale, ref.n_zero_blocks)
    assert out.nnz == ref.nnz and out.density == ref.density
    # the column offsets the kernel walks
    counts = np.bincount(out.blk_j.numpy(), minlength=-(-n // bn))
    np.testing.assert_array_equal(out.col_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    deq = w.astype(np.float32) * (1.0 if scale is None else scale)
    np.testing.assert_array_equal(out.dequant().numpy(), deq)


def test_pack_fully_zero_output_tile():
    """An output tile with no kept tile gets one zero pad block (stored,
    so not counted as a saving), as in the JAX package."""
    w = np.zeros((64, 256), np.float32)
    w[:32, :128] = 1.0
    ref = jax_pack(w, bk=32, bn=128)
    out = pack_block_sparse(w, bk=32, bn=128, device="cpu")
    np.testing.assert_array_equal(out.blk_k.numpy(), [0, 0])
    np.testing.assert_array_equal(out.blk_j.numpy(), [0, 1])
    np.testing.assert_array_equal(out.col_ptr.numpy(), [0, 1, 2])
    assert out.n_zero_blocks == ref.n_zero_blocks == 2
    assert not out.data[1].any()
    y = block_sparse_matmul(torch.ones(3, 64), out)
    assert torch.equal(y[:, 128:], torch.zeros(3, 128))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matmul_matches_pallas(name, x_dtype):
    """The plain K7 against the Pallas kernel (interpret mode) on the same
    packed tiles and x (bf16 x: the same bf16 values in both)."""
    k, n, bk, bn, frac, dtype, scale = CASES[name]
    rng = np.random.RandomState(10 + len(name))
    w = _tiled(rng, k, n, bk, bn, frac, dtype)
    x = torch.from_numpy(rng.randn(2, 13, k).astype(np.float32)).to(x_dtype)
    x_np = x.float().numpy()
    jx = jnp.asarray(x_np, jnp.bfloat16 if x_dtype == torch.bfloat16
                     else jnp.float32)
    ref = np.asarray(jax_block_sparse_matmul(
        jx, jax_pack(w, bk=bk, bn=bn, scale=scale), bm=8))
    packed = pack_block_sparse(w, bk=bk, bn=bn, scale=scale, device="cpu")
    out = block_sparse_matmul(x, packed)
    assert out.dtype == torch.float32 and out.shape == (2, 13, n)
    bar = 1e-5 * max(1.0, np.abs(ref).max())
    assert np.abs(out.numpy() - ref).max() <= bar
    # and the dense product it stands for (with bf16 x, of the weight
    # rounded to bf16, as both kernels take it)
    w_used = torch.from_numpy(w).to(x_dtype).float().numpy()
    dense = x_np @ w_used * (1.0 if scale is None else scale)
    assert np.abs(out.numpy() - dense).max() <= bar


def test_cuda_wrapper_checks_without_a_card():
    """The dispatcher takes the plain version for CPU tensors, and the
    kernel's launches stay uncounted."""
    w = pack_block_sparse(_tiled(np.random.RandomState(3), 64, 128, 32,
                                 128, 0.5, np.int8), 32, 128, 2.0 ** -5,
                          device="cpu")
    x = torch.randn(5, 64)
    before = launch_counts()["block_sparse"]
    assert torch.equal(block_sparse_matmul(x, w),
                       block_sparse_matmul_plain(x, w))
    assert launch_counts()["block_sparse"] == before
    with pytest.raises(ValueError, match="features"):
        block_sparse_matmul(torch.randn(5, 63), w)


# ------------------------------------------------- block-sparse engines

DENSES = {
    "all": (("encoder", "encoder"), ("decoder",))
    + tuple((("encoder", f"layers_{i}", g)) for i in range(LAYERS)
            for g in ("out1", "out2")),
    "encdec": (("encoder", "encoder"), ("decoder",)),
}


def _pruned(frozen, which):  # noqa: F811
    """The frozen tree with 60 % of the (4, 4) tiles of the chosen dense
    kernels zeroed."""
    out = copy.deepcopy(frozen)
    rng = np.random.RandomState(21)
    for path in DENSES[which]:
        node = out["frozen_params"]
        for part in path:
            node = node[part]
        k = np.array(node["kernel"], np.float32)
        node["kernel"] = k * (_tiled(rng, *k.shape, *TILE, 0.6) != 0)
    return out


def _engines(tree, act, **kw):
    cfg_kw = dict(glu_variant="full", relufication=True, prenorm=True,
                  clip_eigs=True)
    common = dict(block_t=BLOCK, block_sparse_dense=TILE, **kw)
    je = JaxEngine(
        tree["frozen_params"], tree["frozen_stats"],
        jax_recipes["w8a16"](static_quant=True, calibrating=False),
        JaxModelConfig.infer(tree["frozen_params"], **cfg_kw),
        act_dtype={torch.float32: jnp.float32,
                   torch.bfloat16: jnp.bfloat16}[act], **common)
    te = W8A16Engine(
        tree["frozen_params"], tree["frozen_stats"],
        quantization_recipes["w8a16"](static_quant=True, calibrating=False),
        FxpModelConfig.infer(tree["frozen_params"], **cfg_kw),
        act_dtype=act, device="cpu", **common)
    return je, te


def _engine_close(out, ref):
    scale = max(1.0, np.abs(ref).max())
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 2e-3 * scale, np.abs(out - ref).max()
    assert np.abs(out - ref).mean() <= 1e-4 * scale


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", list(DENSES))
def test_block_sparse_engine_matches_jax(frozen, which, act):  # noqa: F811
    """Block-sparse packs and routes as in JAX: every dense block-sparse
    serves on the per-op route; a block-sparse encoder and decoder only
    keep the stack route (K7 outside the first and last layer launch) and
    turn the network route off. Offline and two chunks of one block
    against the JAX engine."""
    tree = _pruned(frozen, which)
    je, te = _engines(tree, act)
    assert te.dense_blocks == je.dense_blocks
    assert set(te.dense_blocks) == {"/".join(p[1:]) if p[0] == "encoder"
                                    and len(p) == 3 else p[-1]
                                    for p in DENSES[which]}
    assert (te._stack_ok, te._network_ok) == (je._stack_ok, je._network_ok)
    assert te._stack_ok == (which == "encdec") and not te._network_ok
    assert isinstance(te.encoder_kernel, BlockSparseWeight)
    assert isinstance(te.layers[0].out2_kernel,
                      BlockSparseWeight if which == "all" else QWeight)
    x = tree["batches"][0]
    _engine_close(te(x).numpy(), np.asarray(je(jnp.asarray(x))))
    jc = tc = None
    for start in (0, BLOCK):
        ref, jc = je.process_chunk(jnp.asarray(x[:, start:start + BLOCK]), jc)
        out, tc = te.process_chunk(x[:, start:start + BLOCK], tc)
        _engine_close(out.numpy(), np.asarray(ref))


def test_block_sparse_stack_route_equals_per_op(frozen):  # noqa: F811
    """With f32 activations the stack route with K7 outside its launches
    and the forced per-op route agree to the engine bar; chunked equals
    whole on the stack route."""
    _, te = _engines(_pruned(frozen, "encdec"), torch.float32)
    x = torch.from_numpy(frozen["batches"][1])
    stack = te(x)
    carries, parts = None, []
    for start in range(0, x.shape[1], BLOCK):
        part, carries = te.process_chunk(x[:, start:start + BLOCK], carries)
        parts.append(part)
    _engine_close(torch.cat(parts, dim=1).numpy(), stack.numpy())
    te._stack_ok = False
    _engine_close(te(x).numpy(), stack.numpy())


def test_min_saving_keeps_a_dense_pack(frozen):  # noqa: F811
    """Below ``block_sparse_min_saving`` a kernel packs densely, as in
    JAX; ``block_sparse_dense=None`` never packs block-sparse."""
    tree = _pruned(frozen, "encdec")
    je, te = _engines(tree, torch.float32, block_sparse_min_saving=0.99)
    assert te.dense_blocks == je.dense_blocks == {}
    assert te._network_ok and isinstance(te.decoder_kernel, QWeight)
    _, off = _engines(tree, torch.float32)
    q = quantization_recipes["w8a16"](static_quant=True, calibrating=False)
    plain = W8A16Engine(
        tree["frozen_params"], tree["frozen_stats"], q, off.cfg,
        act_dtype=torch.float32, block_t=BLOCK, block_sparse_dense=None,
        device="cpu")
    assert plain.dense_blocks == {} and plain._network_ok


@pytest.mark.parametrize("stack", [True, False])
def test_process_chunk_mask_is_float32_for_bf16_features(frozen, stack):  # noqa: F811
    """bf16 features: ``process_chunk`` returns the decoder's float32
    output on the stack route and on the forced per-op route, as the JAX
    package does; the whole-sequence call returns bf16 in both."""
    je, te = _engines(frozen, torch.bfloat16)
    assert te._stack_ok and je._stack_ok
    if not stack:
        je._stack_ok = te._stack_ok = False
    x = torch.from_numpy(frozen["batches"][0][:, :BLOCK]).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    ref, _ = je.process_chunk(jx)
    out, _ = te.process_chunk(x)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    _engine_close(out.numpy(), np.asarray(ref))
    assert te(x).dtype == torch.bfloat16 and je(jx).dtype == jnp.bfloat16
