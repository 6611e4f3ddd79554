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
bound and the design: the kept tiles multiply on the tensor cores as exact
bf16 planes (:func:`split_f32`, :func:`split_int16`, :func:`x_planes`,
:func:`tile_planes` mirror the kernel's splits), CTAs walk (row tile,
output tile) items as :func:`launch_plan` deals them out, and
:func:`block_sparse_matmul_planes` repeats the kernel's products in its
order. :func:`pack_block_sparse` checks once, for a weight packed on the
card, what the kernel takes (tile shape, dtype), makes the tiles' planes
and keeps them with the launch's weight arguments on the
:class:`BlockSparseWeight`; a call then checks only x.
:func:`block_sparse_matmul` launches the kernel for CUDA tensors (or
raises) and takes the plain version :func:`block_sparse_matmul_plain` only
for tensors on the CPU. The kernel runs on the true row count (the Pallas
kernel pads the rows to its block).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.engine_layer import WTYPES
from sparsernns_tpu_torch.utils.trace import count, traced

#: the JAX package's default tile
DEFAULT_BK = 128
DEFAULT_BN = 128
#: the kernel's tile: bk a multiple of SLICE (the rows a step stages), bn
KERNEL_BN = 128
SLICE = 32

#: the plan's card: SMs of an H100 SXM, shared memory an SM gives its CTAs
#: and the runtime's reserve a CTA
SMS = 132
SMEM_PER_SM = 232448
SMEM_RESERVED = 1024
#: rows of a CTA's tile, largest first
ROW_TILES = (128, 64, 32, 16)


def warps_of(bm: int) -> int:
    """A CTA's warps: 8 at a 128-row tile, else 4 (the kernel's
    ``warps_of``)."""
    return 8 if bm == 128 else 4


def max_per_sm(bm: int, planes: int) -> int:
    """The CTAs an SM holds at most: the kernel's __launch_bounds__ (its
    registers): 2 of 8 warps; of 4 warps 4, 3 or 2 with 1, 2 or 3 tile
    planes."""
    return 2 if bm == 128 else {1: 4, 2: 3, 3: 2}[planes]


class _WeightArgs(ctypes.Structure):
    """The kernel's ``BsWeight``: what a launch needs of the packed weight
    for one type of x."""
    _fields_ = [("planes", ctypes.c_void_p), ("col_ptr", ctypes.c_void_p),
                ("blk_k", ctypes.c_void_p), ("n_planes", ctypes.c_int),
                ("k", ctypes.c_int), ("n", ctypes.c_int),
                ("bk", ctypes.c_int), ("n_tiles", ctypes.c_int),
                ("scale", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class KernelWeight:
    """What K7's launches need of a weight packed on the card, for each
    type of x: the kept tiles' bf16 planes ((nnz·bk/32, n_planes, 32, 128),
    made by the CUDA source's ``block_sparse_planes``; :func:`tile_planes`
    is their plain mirror) and the launch's weight arguments."""

    planes: Dict[torch.dtype, torch.Tensor]
    args: Dict[torch.dtype, _WeightArgs]


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
    #: what the kernel's launches need, set when packed on a CUDA device
    kernel: Optional[KernelWeight] = dataclasses.field(
        default=None, compare=False, repr=False)

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


def check_kernel_tile(dtype: torch.dtype, bk: int, bn: int) -> None:
    """Raise unless the kernel takes (bk, bn) tiles of ``dtype``."""
    if dtype not in WTYPES:
        raise ValueError(f"tile dtype {dtype}: the kernel takes "
                         f"{sorted(str(d) for d in WTYPES)}")
    if bn != KERNEL_BN or bk < SLICE or bk % SLICE:
        raise ValueError(f"tile ({bk}, {bn}): the kernel takes bk a multiple "
                         f"of {SLICE} and bn {KERNEL_BN}")


def n_planes(x_dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """Planes of a tile (:func:`tile_planes`) multiplied by x of
    ``x_dtype``."""
    if x_dtype == torch.bfloat16:
        return 1
    return {torch.int8: 1, torch.int16: 2, torch.float32: 3}[w_dtype]


def _kernel_weight(w: BlockSparseWeight) -> KernelWeight:
    """Check once what the kernel needs of the packed tensors (one CUDA
    device, contiguous, int32 offsets, at least one block an output tile),
    make the tiles' planes for f32 and bf16 x and the launch's arguments."""
    check_kernel_tile(w.data.dtype, w.bk, w.bn)
    dev = w.data.device
    for name in ("data", "blk_k", "col_ptr"):
        t = getattr(w, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous on {dev}, got "
                             f"{t.device}")
    if w.blk_k.dtype != torch.int32 or w.col_ptr.dtype != torch.int32:
        raise ValueError("blk_k and col_ptr must be int32")
    counts = torch.diff(w.col_ptr.cpu())
    if counts.numel() != -(-w.shape[1] // w.bn) or bool((counts < 1).any()):
        raise ValueError("every output tile needs at least one block (the "
                         "packer's pad block)")
    fn = build.entry("block_sparse", "block_sparse_planes",
                     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    planes, args = {}, {}
    for x_dtype in (torch.float32, torch.bfloat16):
        n = n_planes(x_dtype, w.data.dtype)
        buf = torch.empty((w.data.numel() // (SLICE * w.bn), n, SLICE, w.bn),
                          dtype=torch.bfloat16, device=dev)
        build.check(fn(w.data.data_ptr(), WTYPES[w.data.dtype],
                       int(x_dtype == torch.bfloat16), buf.data_ptr(),
                       w.data.numel(),
                       torch._C._cuda_getCurrentRawStream(dev.index)),
                    "block_sparse planes")
        planes[x_dtype] = buf
        args[x_dtype] = _WeightArgs(
            buf.data_ptr(), w.col_ptr.data_ptr(), w.blk_k.data_ptr(), n,
            w.shape[0], w.shape[1], w.bk, counts.numel(),
            1.0 if w.scale is None else float(w.scale))
    return KernelWeight(planes, args)


def pack_block_sparse(w: np.ndarray, bk: int = DEFAULT_BK,
                      bn: int = DEFAULT_BN, scale: Optional[float] = None,
                      device="cuda") -> BlockSparseWeight:
    """Pack a (K, N) weight into its kept tiles on the host (numpy), then
    move them to ``device`` once. An output tile with no kept tile gets one
    zero block, as in the JAX package. ``scale``: the per-tensor dequant
    scale of integer data. On a CUDA device the kernel's limits (tile shape
    and dtype) are checked here, before anything moves, and what its
    launches need (:class:`KernelWeight`) is kept on the result."""
    w = np.asarray(w)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        check_kernel_tile(torch.from_numpy(w[:0, :0]).dtype, bk, bn)
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

    packed = BlockSparseWeight(
        data=dev(np.stack(data)), blk_k=dev(kk, np.int32),
        blk_j=dev(jj, np.int32), is_first=dev(first, np.int32),
        col_ptr=dev(col_ptr, np.int32), shape=(k_dim, n_dim), bk=bk, bn=bn,
        scale=scale, n_zero_blocks=n_zero)
    if on_card:
        packed = dataclasses.replace(packed, kernel=_kernel_weight(packed))
    return packed


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


# ------------------------------------------------ the planes' mirrors

_TOP16 = -65536   # int32 0xffff0000: a float's sign, exponent, 7 bits


def split_f32(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's ``split3``: f32 ``v`` as three bf16 planes whose sum is
    ``v`` exactly, the top 8 significant bits, the next 8, the last 8 (the
    top two by truncation, the last rounded). Exact for |v| >= 2^-110 and
    for 0; below, the last plane rounds onto bf16's subnormal grid (2^-133
    a step), so the sum is within 2^-134 of v. A non-finite v is its own
    top plane (inf stays inf, NaN stays NaN), the others 0."""
    u = v.view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    top = (u & _TOP16).view(torch.float32)
    rest = torch.where(finite, v - top, torch.zeros_like(v))
    mid = (rest.view(torch.int32) & _TOP16).view(torch.float32)
    return (torch.where(finite, top, v).to(torch.bfloat16),
            mid.to(torch.bfloat16), (rest - mid).to(torch.bfloat16))


def split_int16(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int16 ``w`` as two exact bf16 planes ``hi·256`` and ``lo`` (the
    unsigned low byte, 0..255): w = hi·256 + lo."""
    wi = w.to(torch.int32)
    return ((wi >> 8) * 256).to(torch.bfloat16), (wi & 0xFF).to(
        torch.bfloat16)


def x_planes(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's planes of x: three of f32 x, bf16 x itself."""
    return (x,) if x.dtype == torch.bfloat16 else split_f32(x)


def tile_planes(tiles: torch.Tensor, x_dtype: torch.dtype
                ) -> Tuple[torch.Tensor, ...]:
    """The kernel's planes of the tiles by the type of x they multiply:
    with bf16 x one plane, the tiles rounded to bf16 (as in the Pallas
    kernel; exact for int8); with f32 x int8 one, int16 two
    (:func:`split_int16`), f32 three (:func:`split_f32`)."""
    if x_dtype == torch.bfloat16 or tiles.dtype == torch.int8:
        return (tiles.to(torch.bfloat16),)
    if tiles.dtype == torch.int16:
        return split_int16(tiles)
    return split_f32(tiles)


def block_sparse_matmul_planes(x: torch.Tensor, w: BlockSparseWeight
                               ) -> torch.Tensor:
    """Plain mirror of the kernel's products: for each output tile, each
    kept tile in block-CSC order, each 16-deep k-step, each tile plane,
    each x plane, one product of the planes added into the tile's float32
    sums, which the scale multiplies last. Every plane product is exact;
    the kernel's tensor cores round each 16-term sum their own way, so the
    mirror repeats the order, not the bits."""
    xm = _rows(x, w)
    k_dim, n_dim = w.shape
    k_pad = -(-k_dim // w.bk) * w.bk
    xp = [F.pad(p.to(torch.float32), (0, k_pad - k_dim))
          for p in x_planes(xm)]
    n_tiles = w.col_ptr.numel() - 1
    y = torch.zeros((xm.shape[0], n_tiles * w.bn), dtype=torch.float32,
                    device=x.device)
    col_ptr, blk_k = w.col_ptr.tolist(), w.blk_k.tolist()
    scale = 1.0 if w.scale is None else float(w.scale)
    for j in range(n_tiles):
        acc = torch.zeros((xm.shape[0], w.bn), dtype=torch.float32,
                          device=x.device)
        for s in range(col_ptr[j], col_ptr[j + 1]):
            wp = [q.to(torch.float32) for q in tile_planes(w.data[s],
                                                           xm.dtype)]
            k0 = blk_k[s] * w.bk
            for kk in range(0, w.bk, 16):
                for q in wp:
                    for p in xp:
                        acc += (p[:, k0 + kk:k0 + kk + 16]
                                @ q[kk:kk + 16])
        y[:, j * w.bn:(j + 1) * w.bn] = acc * scale
    return y[:, :n_dim].reshape(*x.shape[:-1], n_dim)


# ------------------------------------------------ the launch plan

def smem_bytes(bm: int, stages: int, x_bf16: bool, planes: int) -> int:
    """Dynamic shared memory of a CTA (the kernel's ``smem_bytes``): a ring
    of ``stages`` stages, each bm staged x rows (160 bytes of f32, 80 of
    bf16) and the slice's ``planes`` bf16 planes (32 rows of 136 values),
    then the warps' epilogue rows (16 of 40 floats each)."""
    stage = bm * (80 if x_bf16 else 160) + planes * SLICE * 136 * 2
    return stages * stage + warps_of(bm) * 16 * 40 * 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One K7 launch: ``ctas`` persistent CTAs of ``bm``-row tiles walk
    ``items`` = row tiles x output tiles (item = row tile·n_tiles + j),
    each CTA a contiguous range, through a ring of ``stages``."""

    m: int
    n_tiles: int
    bm: int
    stages: int
    per_sm: int
    ctas: int
    smem: int

    @property
    def items(self) -> int:
        return -(-self.m // self.bm) * self.n_tiles

    def items_of(self, cta: int) -> range:
        """The kernel's deal: CTA c takes items [c·I/G, (c+1)·I/G)."""
        return range(cta * self.items // self.ctas,
                     (cta + 1) * self.items // self.ctas)

    def cell(self, item: int) -> Tuple[range, int]:
        """(rows, output tile) of an item."""
        rt, j = divmod(item, self.n_tiles)
        return range(rt * self.bm, min((rt + 1) * self.bm, self.m)), j


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, x_bf16: bool, planes: int,
                sms: int = SMS, bm: Optional[int] = None,
                stages: Optional[int] = None) -> LaunchPlan:
    """The plan of one K7 call, a pure function of the shapes: the largest
    row tile that still gives every SM an item (else the smallest), then
    the ring depth (4 to 2 stages) that lets the most CTAs share an SM
    (at most :func:`max_per_sm`), the deeper on a tie; as many CTAs as
    the SMs hold, or one an item if fewer. ``bm`` / ``stages`` override
    the choice."""
    if m < 1:
        raise ValueError(f"empty call: M = {m}")
    n_tiles = -(-n // KERNEL_BN)
    if bm is None:
        bm = next((b for b in ROW_TILES if -(-m // b) * n_tiles >= sms),
                  ROW_TILES[-1])
    if bm not in ROW_TILES:
        raise ValueError(f"row tile {bm}: one of {ROW_TILES}")

    def fit(s: int) -> Tuple[int, int]:
        size = smem_bytes(bm, s, x_bf16, planes)
        return (min(max_per_sm(bm, planes),
                    SMEM_PER_SM // (size + SMEM_RESERVED)), s)

    per_sm, stages = fit(stages) if stages else max(fit(s) for s in (4, 3, 2))
    if per_sm < 1:
        raise ValueError(f"{stages} stages of {bm} rows do not fit an SM")
    items = -(-m // bm) * n_tiles
    return LaunchPlan(m, n_tiles, bm, stages, per_sm,
                      min(items, per_sm * sms),
                      smem_bytes(bm, stages, x_bf16, planes))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------ the launch

_RUN_ARGS = ([ctypes.POINTER(_WeightArgs), ctypes.c_void_p, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


@traced("kernel.block_sparse")
def block_sparse_matmul_cuda(x: torch.Tensor, w: BlockSparseWeight
                             ) -> torch.Tensor:
    """Launch the kernel: x (..., K) f32 or bf16 on the weight's CUDA
    device -> (..., N) float32. The weight was checked when it was
    packed; this checks x."""
    if w.kernel is None:
        raise ValueError(f"the weight was packed on {w.data.device}: pack "
                         "it on the card to launch the kernel")
    two_d = x.dim() == 2 and x.shape[1] == w.shape[0]
    xm = x if two_d else _rows(x, w)
    args = w.kernel.args.get(xm.dtype)
    if args is None:
        raise ValueError(f"x dtype {xm.dtype}: float32 or bfloat16")
    dev = xm.device
    if dev != w.data.device:
        raise ValueError(f"x on {dev}, the weight on {w.data.device}")
    if not xm.is_contiguous() or xm.data_ptr() % 16:
        xm = xm.clone(memory_format=torch.contiguous_format)
    m, (k_dim, n_dim) = xm.shape[0], w.shape
    if (m + 64) * max(k_dim, n_dim) >= 2 ** 31:
        raise ValueError(f"{m} rows: the kernel indexes x and y in int32")
    y = torch.empty((m, n_dim), dtype=torch.float32, device=dev)
    if m > 0:
        x_bf16 = xm.dtype == torch.bfloat16
        plan = launch_plan(m, n_dim, x_bf16, args.n_planes,
                           _sm_count(dev.index))
        err = build.entry("block_sparse", "block_sparse_run", _RUN_ARGS)(
            ctypes.byref(args), xm.data_ptr(), int(x_bf16),
            int(k_dim * xm.element_size() % 16 == 0), y.data_ptr(), m,
            plan.bm, plan.stages, plan.ctas,
            # the current stream's handle, without making a Stream object
            torch._C._cuda_getCurrentRawStream(dev.index))
        build.check(err, "block_sparse")
        count("block_sparse")
    return y if two_d else y.reshape(*x.shape[:-1], n_dim)


def launched() -> dict:
    """The last launch as the CUDA source recorded it: CTAs, row tile,
    stages and dynamic shared memory bytes."""
    fn = build.entry("block_sparse", "block_sparse_launched",
                     [ctypes.c_void_p], None)
    out = (ctypes.c_int * 4)()
    fn(out)
    return dict(zip(("ctas", "bm", "stages", "smem"), list(out)))


def smem_on_card(x_bf16: bool, planes: int, bm: int, stages: int) -> int:
    """The CUDA source's shared memory bytes for a launch of this kind."""
    fn = build.entry("block_sparse", "block_sparse_smem", [ctypes.c_int] * 4)
    return fn(int(x_bf16), planes, bm, stages)


def block_sparse_matmul(x: torch.Tensor, w: BlockSparseWeight
                        ) -> torch.Tensor:
    """y = x @ W for (..., K) activations over W's kept tiles, float32,
    dequantized when ``w.scale`` is set. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    fn = block_sparse_matmul_cuda if x.is_cuda else block_sparse_matmul_plain
    return fn(x, w)
