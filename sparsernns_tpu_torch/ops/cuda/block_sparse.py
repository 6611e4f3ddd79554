"""Kernel K7: the block-sparse dense matmul, y = (x @ W) * scale over the
kept (bk, bn) tiles of W only.

Replaces ``sparsernns_tpu/ops/pallas/block_sparse.py``
``block_sparse_matmul`` and its packing (``BlockSparseWeight``,
``pack_block_sparse``). A tile-pruned checkpoint (``train/pruning.py``,
``structure="block"``) has whole all-zero (32, 128) tiles in its dense
kernels; the serving engine packs such a kernel here
(``quantize/engine.py``) and the matmul skips the zero tiles: fewer flops
and fewer bytes, by exactly the zero-tile share.

The CUDA source is ``csrc/block_sparse.cu``; its header note gives the
bound and the design. :func:`block_sparse_matmul` launches the kernel for
CUDA tensors (or raises) and takes the plain version
:func:`block_sparse_matmul_plain` only for tensors on the CPU. The kernel
takes the packed tiles of any ``bk`` that is a multiple of 32 and
``bn = 128``; it runs on the true row count (the Pallas kernel pads the
rows to its block).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.engine_layer import WTYPES

#: the JAX package's default tile
DEFAULT_BK = 128
DEFAULT_BN = 128

#: kernel launches made by :func:`block_sparse_matmul` in this process
launches = 0


@dataclasses.dataclass(frozen=True)
class BlockSparseWeight:
    """A (K, N) weight stored as its kept tiles, sorted by output tile
    (block-CSC), the JAX package's fields plus ``col_ptr``."""

    data: torch.Tensor        # (nnz, bk, bn) kept tiles: int8/int16 or f32
    blk_k: torch.Tensor       # (nnz,) int32 input tile of each block
    blk_j: torch.Tensor       # (nnz,) int32 output tile, non-decreasing
    is_first: torch.Tensor    # (nnz,) int32 1 at each output tile's first
    #: (n_tiles + 1,) int32: output tile j's blocks are
    #: data[col_ptr[j]:col_ptr[j + 1]]
    col_ptr: torch.Tensor
    shape: Tuple[int, int]
    bk: int
    bn: int
    scale: Optional[float] = None   # per-tensor pow2 scale of integer data
    n_zero_blocks: int = 0

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def density(self) -> float:
        """Share of the weight's tiles stored and computed (an empty output
        tile's pad block counts as stored)."""
        k_tiles = -(-self.shape[0] // self.bk)
        n_tiles = -(-self.shape[1] // self.bn)
        return self.nnz / (k_tiles * n_tiles)

    def dequant(self) -> torch.Tensor:
        """The dense (K, N) float32 weight, scale applied."""
        k_dim, n_dim = self.shape
        k_tiles = -(-k_dim // self.bk)
        n_tiles = -(-n_dim // self.bn)
        w = torch.zeros((k_tiles, self.bk, n_tiles, self.bn),
                        dtype=torch.float32, device=self.data.device)
        w[self.blk_k.long(), :, self.blk_j.long(), :] = self.data.to(
            torch.float32)
        w = w.reshape(k_tiles * self.bk, n_tiles * self.bn)[:k_dim, :n_dim]
        return w if self.scale is None else w * self.scale


def pack_block_sparse(w: np.ndarray, bk: int = DEFAULT_BK,
                      bn: int = DEFAULT_BN, scale: Optional[float] = None,
                      device="cuda") -> BlockSparseWeight:
    """Pack a (K, N) weight into its kept tiles on the host (numpy), then
    move them to ``device`` once. An output tile with no kept tile gets one
    zero block, as in the JAX package. ``scale``: the per-tensor dequant
    scale of integer data."""
    w = np.asarray(w)
    k_dim, n_dim = w.shape
    k_tiles, n_tiles = -(-k_dim // bk), -(-n_dim // bn)
    wp = np.zeros((k_tiles * bk, n_tiles * bn), w.dtype)
    wp[:k_dim, :n_dim] = w
    tiles = wp.reshape(k_tiles, bk, n_tiles, bn).transpose(2, 0, 1, 3)
    kept = tiles.reshape(n_tiles, k_tiles, -1).any(axis=-1)   # (j, k)

    data, kk, jj, first, col_ptr = [], [], [], [], [0]
    for j in range(n_tiles):
        ks = np.flatnonzero(kept[j])
        if ks.size == 0:        # fully zero output tile: one zero pad block
            ks = np.zeros(1, np.int64)
        data.extend(tiles[j, ks])
        kk.extend(ks.tolist())
        jj.extend([j] * ks.size)
        first.extend([1] + [0] * (ks.size - 1))
        col_ptr.append(len(kk))
    n_zero = k_tiles * n_tiles - len(kk)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return BlockSparseWeight(
        data=dev(np.stack(data)), blk_k=dev(kk, np.int32),
        blk_j=dev(jj, np.int32), is_first=dev(first, np.int32),
        col_ptr=dev(col_ptr, np.int32), shape=(k_dim, n_dim), bk=bk, bn=bn,
        scale=scale, n_zero_blocks=n_zero)


def _rows(x: torch.Tensor, w: BlockSparseWeight) -> torch.Tensor:
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"x has {x.shape[-1]} features, the weight "
                         f"{w.shape[0]} rows")
    return x.reshape(-1, x.shape[-1])


def block_sparse_matmul_plain(x: torch.Tensor, w: BlockSparseWeight
                              ) -> torch.Tensor:
    """Plain PyTorch version: a loop over the kept tiles, each
    ``x[:, k·bk:(k+1)·bk] @ tile`` added into its output column, in
    float32. As in the Pallas kernel, the tiles are first cast to the type
    of x (with bf16 x, f32 and int16 tiles round to bf16; int8 is exact)."""
    tiles = w.data.to(x.dtype) if x.dtype == torch.bfloat16 else w.data
    xm = _rows(x, w).to(torch.float32)
    k_dim, n_dim = w.shape
    k_pad = -(-k_dim // w.bk) * w.bk
    n_pad = -(-n_dim // w.bn) * w.bn
    xm = F.pad(xm, (0, k_pad - k_dim))
    y = torch.zeros((xm.shape[0], n_pad), dtype=torch.float32,
                    device=x.device)
    for tile, k, j in zip(tiles, w.blk_k.tolist(), w.blk_j.tolist()):
        y[:, j * w.bn:(j + 1) * w.bn] += (
            xm[:, k * w.bk:(k + 1) * w.bk] @ tile.to(torch.float32))
    y = y[:, :n_dim]
    if w.scale is not None:
        y = y * w.scale
    return y.reshape(*x.shape[:-1], n_dim)


def _lib():
    fn = build.load("block_sparse").block_sparse_run
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def block_sparse_matmul_cuda(x: torch.Tensor, w: BlockSparseWeight
                             ) -> torch.Tensor:
    """Launch the kernel: x (..., K) f32 or bf16 on the weight's CUDA
    device -> (..., N) float32."""
    global launches
    xm = _rows(x, w)
    dev = xm.device
    if xm.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {xm.dtype}: float32 or bfloat16")
    if w.data.dtype not in WTYPES:
        raise ValueError(f"tile dtype {w.data.dtype}")
    if w.bn != 128 or w.bk % 32:
        raise ValueError(f"tile ({w.bk}, {w.bn}): the kernel takes bk a "
                         "multiple of 32 and bn 128")
    for name in ("data", "blk_k", "col_ptr"):
        t = getattr(w, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous on {dev}, got "
                             f"{t.device}")
    xm = xm.contiguous()
    m, (k_dim, n_dim) = xm.shape[0], w.shape
    y = torch.empty((m, n_dim), dtype=torch.float32, device=dev)
    if m > 0:
        err = _lib()(
            xm.data_ptr(), int(xm.dtype == torch.bfloat16), w.data.data_ptr(),
            WTYPES[w.data.dtype], w.col_ptr.data_ptr(), w.blk_k.data_ptr(),
            1.0 if w.scale is None else float(w.scale), y.data_ptr(), m,
            k_dim, n_dim, w.bk, w.col_ptr.numel() - 1,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "block_sparse")
        launches += 1
    return y.reshape(*x.shape[:-1], n_dim)


def block_sparse_matmul(x: torch.Tensor, w: BlockSparseWeight
                        ) -> torch.Tensor:
    """y = x @ W for (..., K) activations over W's kept tiles, float32,
    dequantized when ``w.scale`` is set. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    fn = block_sparse_matmul_cuda if x.is_cuda else block_sparse_matmul_plain
    return fn(x, w)
