"""Kernel K1: the diagonal complex scan x_t = λ ⊙ x_{t-1} + bu_t, and
with ``reverse`` x_t = λ ⊙ x_{t+1} + bu_t.

Replaces ``sparsernns_tpu/ops/pallas/scan_kernel.py`` ``pallas_diag_scan``
in its float modes: forward with an optional ``carry_init``, reverse, and
in either direction with ``block_requant`` (forward also from a carry).
The CUDA source is ``csrc/diag_scan.cu``; its header note gives the bound
and the design. The differentiable form is ``ops/scan.py``
:class:`~sparsernns_tpu_torch.ops.scan.DiagScanFn`.

The kernel is a time-chunked scan. Time is walked in the scan's order
(forward from t = 0, reverse from t = L - 1) and cut into chunks of
:attr:`ScanPlan.chunk` rows that never straddle the end of a requant
block (:func:`scan_plan`, a pure function of the shapes). A call is three
launches: a chunk pass scans every chunk from a zero state and keeps its
end state; a carry pass chains the chunk ends in order, carry_{k+1} =
λ^{c_k} carry_k + end_k (put on the frozen grid at a block end); an output
pass walks every chunk again from its carry and writes the states. With
the block requant the last pass is a block pass instead: every block is
walked sequentially from the carry the chain predicted, and again, in
order, where the block before ended on another grid code, so that the
states are the sequential recurrence's bit for bit. A short sequence
(:data:`SHORT_LENGTH`) is one chunk and one launch.

:func:`diag_scan` launches the kernel for CUDA tensors and takes the plain
version :func:`diag_scan_plain` (the sequential recurrence) only for
tensors on the CPU. :func:`diag_scan_chunked_plain` follows the kernel's
plan in PyTorch, rounding every operation as the kernel does: the tests
hold it against the sequential recurrence and the JAX kernel on the CPU,
and the kernel against it bit for bit on the card.

Two launch options of the float modes serve the differentiable scans of
``ops/scan.py``: ``out`` writes the states into given views (the columns
of the bidirectional mixer's (B, L, 4P) matrix,
:class:`~sparsernns_tpu_torch.ops.scan.BiDiagScanFn`), and
:func:`diag_scan_adjoint`, the one adjoint of every float scan
(:class:`~sparsernns_tpu_torch.ops.scan.DiagScanFn`'s and
``BiDiagScanFn``'s backward), walks a scan's adjoint, adds its cotangent
to what ``out`` holds if asked, and sums dλ against the primal states in
the same walk (:func:`reduce_dlam`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.scan import (BlockRequant, Pair, _dlam,
                                           grid_value, sequential_diag_scan)
from sparsernns_tpu_torch.utils.trace import count, traced

#: threads of every K1 CTA: one warp
LANES = 32
#: SMs of an H100 SXM
SMS = 132
#: one-warp CTAs a chunk or output pass aims at: four an SM
TARGET_CTAS = 4 * SMS
#: a sequence of at most this many rows is one chunk: one launch
SHORT_LENGTH = 256
#: the range of a chunk's rows (powers of two)
MIN_CHUNK, MAX_CHUNK = 16, 256
#: channels a thread of the chunk and output passes owns where P allows
#: 128-bit loads
VEC = 4
CHUNK_PASS, CARRY_PASS, OUT_PASS, BLOCK_PASS = (
    "k1_chunk_pass", "k1_carry_pass", "k1_out_pass", "k1_block_pass")

_argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 11 + [ctypes.c_float] * 6
             + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 2)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one K1 call cuts time and the card. Rows are counted in the
    walk's order (step s visits t = s forward, t = L - 1 - s reverse).
    Chunks of ``chunk`` rows fill blocks of ``block`` rows from the walk's
    start, ``per_block`` chunks a block, its last one ``tail`` rows; the
    last block may be shorter. ``requant_block`` is the block requant's
    length (None without one): the carry goes onto the grid after every
    walk step s with (s + 1) % requant_block == 0. With more than one
    chunk ``block`` equals it, so a chunk never straddles a block end.
    A thread of the chunk and output passes owns ``vec`` neighbouring
    channels (128-bit loads at 4)."""

    batch: int
    length: int
    p: int
    reverse: bool
    requant_block: Optional[int]
    chunk: int
    block: int
    per_block: int
    n_chunks: int
    vec: int

    @property
    def tail(self) -> int:
        """Rows of a block's last chunk."""
        return self.block - (self.per_block - 1) * self.chunk

    @property
    def n_blocks(self) -> int:
        """Blocks of ``block`` rows along the walk."""
        return _cdiv(self.length, self.block)

    @property
    def block_pass(self) -> bool:
        """Whether the last pass is the block pass: the block requant over
        more than one chunk."""
        return self.requant_block is not None and self.n_chunks > 1

    def scratch_floats(self) -> int:
        """Floats of a call's scratch: the chunks' links, and for the
        block pass the blocks' ends and its ticket and flags."""
        n = (self.n_chunks - 1) * 2 * self.p
        if self.block_pass:
            n += self.n_blocks * (2 * self.p + _cdiv(self.p, LANES))
        return self.batch * n + 1

    @property
    def slices(self) -> int:
        """Channel slices of the chunk and output passes: one a CTA."""
        return _cdiv(self.p, LANES * self.vec)

    def chunk_rows(self, k: int) -> Tuple[int, int, bool]:
        """(first walk step, rows, whether it ends a block) of chunk k."""
        j, i = divmod(k, self.per_block)
        s0 = j * self.block + i * self.chunk
        n = min(self.chunk, self.block - i * self.chunk, self.length - s0)
        return s0, n, i == self.per_block - 1 or s0 + n == self.length

    def time_rows(self, k: int) -> range:
        """The time rows of chunk k, in the order the walk visits them."""
        s0, n, _ = self.chunk_rows(k)
        if self.reverse:
            return range(self.length - 1 - s0, self.length - 1 - s0 - n, -1)
        return range(s0, s0 + n)

    def launches(self) -> List[Tuple[str, Tuple[int, int, int], int]]:
        """(pass, grid (x, y, z), threads a CTA) of every launch of one
        call, in order: the chunk pass over (chunk, channel slice, batch
        row) for every chunk but the last, the carry pass over (32
        channels, batch row), the output pass over every chunk (with the
        block requant the block pass over (block, 32 channels, batch
        row)); one chunk: the output pass alone."""
        out = (OUT_PASS, (self.n_chunks, self.slices, self.batch), LANES)
        if self.block_pass:
            out = (BLOCK_PASS, (self.n_blocks, _cdiv(self.p, LANES),
                                self.batch), LANES)
        if self.n_chunks == 1:
            return [out]
        return [(CHUNK_PASS, (self.n_chunks - 1, self.slices, self.batch),
                 LANES),
                (CARRY_PASS, (_cdiv(self.p, LANES), self.batch, 1), LANES),
                out]


def _pick_chunk(batch: int, length: int, slices: int) -> int:
    """The longest power-of-two chunk in [MIN_CHUNK, MAX_CHUNK] whose
    passes still give :data:`TARGET_CTAS` CTAs (the shortest where none
    does)."""
    chunk = MAX_CHUNK
    while (chunk > MIN_CHUNK
           and batch * slices * _cdiv(length, chunk) < TARGET_CTAS):
        chunk //= 2
    return chunk


@functools.lru_cache(maxsize=256)
def scan_plan(batch: int, length: int, p: int,
              block_t: Optional[int] = None, reverse: bool = False,
              chunk: Optional[int] = None) -> ScanPlan:
    """The plan of one K1 call, a pure function of the shapes: the chunk
    boundaries along time, the channel slice a CTA owns and the launches.
    ``block_t``: the block requant's length (None without one).
    ``chunk`` overrides the chunk length; by default a sequence of at most
    :data:`SHORT_LENGTH` rows is one chunk, a longer one takes
    :func:`_pick_chunk`'s. A block_t that is no multiple of the chunk
    gives a shorter chunk at every block end."""
    if min(batch, length, p) < 1:
        raise ValueError(f"empty scan: B={batch}, L={length}, P={p}")
    if block_t is not None and block_t < 1:
        raise ValueError(f"block_requant needs block_t >= 1, got {block_t}")
    vec = VEC if p % VEC == 0 else 1
    rq = None if block_t is None else min(block_t, length)
    if chunk is None and length <= SHORT_LENGTH:
        return ScanPlan(batch, length, p, reverse, rq, length, length, 1, 1,
                        vec)
    if chunk is None:
        chunk = _pick_chunk(batch, length, _cdiv(p, LANES * vec))
    block = length if rq is None else rq
    per_block = _cdiv(block, chunk)
    n_blocks = _cdiv(length, block)
    last = length - (n_blocks - 1) * block
    n_chunks = (n_blocks - 1) * per_block + _cdiv(last, chunk)
    return ScanPlan(batch, length, p, reverse, rq, min(chunk, block), block,
                    per_block, n_chunks, vec)


def exact_reciprocal(s: float) -> float:
    """1 / s where s is a power of two whose reciprocal is a normal float32
    (then x * (1 / s) rounds to x / s for every x, so the kernel multiplies),
    else 0 (the kernel divides)."""
    mant, exp = math.frexp(s)
    return 2.0 ** (1 - exp) if mant == 0.5 and -125 <= 1 - exp <= 127 else 0.0


def _check_requant(block_requant, block_t) -> None:
    if block_requant is not None and (block_t is None or block_t < 1):
        raise ValueError(f"block_requant needs block_t >= 1, got {block_t}")


def diag_scan_plain(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
                    reverse: bool = False,
                    block_requant: Optional[BlockRequant] = None,
                    block_t: Optional[int] = None) -> Pair:
    """Plain PyTorch version: the sequential recurrence."""
    _check_requant(block_requant, block_t)
    return sequential_diag_scan(lam, bu, carry_init=carry_init,
                                reverse=reverse, block_requant=block_requant,
                                block_t=block_t)[0]


# ------------------------------------------------ the plan's mirror

def _step(lam: Pair, x: Pair, u: Pair) -> Pair:
    """x <- λ x + u with every product and sum rounded on its own, in the
    order of the kernel's ``scan_step_rn``."""
    lr, li = lam
    return (lr * x[0] - li * x[1]) + u[0], (lr * x[1] + li * x[0]) + u[1]


def _power(lam: Pair, e: int) -> Pair:
    """λ^e in float64 by square and multiply (bits of e from the lowest),
    rounded to float32 once, as the carry pass computes it."""
    br, bi = lam[0].double(), lam[1].double()
    rr, ri = torch.ones_like(br), torch.zeros_like(bi)
    while e:
        if e & 1:
            rr, ri = rr * br - ri * bi, rr * bi + ri * br
        e >>= 1
        if e:
            br, bi = br * br - bi * bi, br * bi + bi * br
    return rr.float(), ri.float()


def chunk_powers(lam: Pair, plan: ScanPlan) -> Tuple[Pair, Pair]:
    """(λ^chunk, λ^tail): the carry pass's two multipliers."""
    return _power(lam, plan.chunk), _power(lam, plan.tail)


def _walk_order(bu: Pair, reverse: bool) -> Pair:
    return (bu[0].flip(1), bu[1].flip(1)) if reverse else bu


def _plan_of(bu: Pair, reverse: bool, block_requant, block_t) -> ScanPlan:
    b, length, p = bu[0].shape
    return scan_plan(b, length, p,
                     None if block_requant is None else block_t, reverse)


def _grid(x: Pair, block_requant: BlockRequant) -> Pair:
    s_re, s_im, bits = block_requant
    return grid_value(x[0], s_re, bits), grid_value(x[1], s_im, bits)


def _walk(lam: Pair, bu: Pair, spans, x: Pair, out: Optional[Pair] = None,
          block_requant: Optional[BlockRequant] = None,
          requant_block: Optional[int] = None) -> Pair:
    """Step the walk-step spans [(start, rows)] of bu (in the walk's order)
    together, row i of each at once, from the states x (B, spans, P). With
    ``out`` store every state there (on the grid with the requant, the
    carry put on it after every ``requant_block`` steps). Returns the last
    states."""
    bu_re, bu_im = bu
    length, dev = bu_re.shape[1], bu_re.device
    starts = torch.tensor([s0 for s0, _ in spans], device=dev)
    lens = torch.tensor([m for _, m in spans], device=dev)
    for i in range(max(m for _, m in spans)):
        live = (i < lens)[None, :, None]
        s = torch.clamp(starts + i, max=length - 1)
        y = _step(lam, x, (bu_re[:, s], bu_im[:, s]))
        x = (torch.where(live, y[0], x[0]), torch.where(live, y[1], x[1]))
        if out is None:
            continue
        w = x
        if block_requant is not None:
            w = _grid(x, block_requant)
            at_end = live & ((s + 1) % requant_block == 0)[None, :, None]
            x = (torch.where(at_end, w[0], x[0]),
                 torch.where(at_end, w[1], x[1]))
        keep = live[0, :, 0]
        out[0][:, s[keep]] = w[0][:, keep]
        out[1][:, s[keep]] = w[1][:, keep]
    return x


def predicted_carries(lam: Pair, bu: Pair, carry_init: Optional[Pair],
                      block_requant: Optional[BlockRequant],
                      plan: ScanPlan) -> List[Pair]:
    """Passes 1-2 of the plan on bu (B, L, P) in the walk's order: the
    carry into every chunk, (B, P) pairs, the first ``carry_init`` (or
    zero). Chunk-local scans from a zero state, then carry_{k+1} =
    λ^{c_k} carry_k + end_k, on the grid after a block-ending chunk."""
    b, _, p = bu[0].shape
    zero = bu[0].new_zeros((b, p))
    x = (zero, zero) if carry_init is None else tuple(
        c.to(bu[0]) for c in carry_init)
    carries = [x]
    n = plan.n_chunks
    if n == 1:
        return carries
    rows = [plan.chunk_rows(k) for k in range(n - 1)]
    ends = _walk(lam, bu, [r[:2] for r in rows],
                 (bu[0].new_zeros((b, n - 1, p)),) * 2)
    full, tail = chunk_powers(lam, plan)
    for k, (_, m, block_end) in enumerate(rows):
        x = _step(full if m == plan.chunk else tail, x,
                  (ends[0][:, k], ends[1][:, k]))
        if block_requant is not None and block_end:
            x = _grid(x, block_requant)
        carries.append(x)
    return carries


def block_rewalks(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
                  reverse: bool = False,
                  block_requant: Optional[BlockRequant] = None,
                  block_t: Optional[int] = None) -> torch.Tensor:
    """Which warps of the block pass walk their block a second time: a
    (B, blocks, ceil(P / 32)) bool tensor, true where a channel's carry
    predicted by passes 1-2 differs from the block before's last state on
    the grid (the sequential recurrence's)."""
    plan = _plan_of(bu, reverse, block_requant, block_t)
    b, length, p = bu[0].shape
    if not plan.block_pass:
        return torch.zeros((b, plan.n_blocks, _cdiv(p, LANES)),
                           dtype=torch.bool, device=bu[0].device)
    walk_bu = _walk_order(bu, reverse)
    carries = predicted_carries(lam, walk_bu, carry_init, block_requant,
                                plan)
    states = _walk_order(sequential_diag_scan(
        lam, bu, carry_init, reverse=reverse, block_requant=block_requant,
        block_t=block_t)[0], reverse)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    off = torch.zeros((b, plan.n_blocks, p), dtype=torch.bool,
                      device=bu[0].device)
    for j in range(1, plan.n_blocks):
        pred = carries[j * plan.per_block]
        true = (states[0][:, j * plan.block - 1],
                states[1][:, j * plan.block - 1])
        off[:, j] = ((bits(pred[0]) != bits(true[0]))
                     | (bits(pred[1]) != bits(true[1])))
    pad = -p % LANES
    return torch.nn.functional.pad(off, (0, pad)).view(
        b, plan.n_blocks, -1, LANES).any(dim=-1)


def diag_scan_chunked_plain(lam: Pair, bu: Pair,
                            carry_init: Optional[Pair] = None,
                            reverse: bool = False,
                            block_requant: Optional[BlockRequant] = None,
                            block_t: Optional[int] = None,
                            plan: Optional[ScanPlan] = None) -> Pair:
    """The kernel's decomposition in PyTorch, each operation rounded as the
    kernel rounds it: chunk-local scans from a zero state, the carry chain
    over the chunk ends (on the grid at a block end), and the walk of every
    chunk again from its carry. With the block requant (and more than one
    chunk) the last pass walks every block from the carry the chain
    predicted, then, block after block, walks again from the block before's
    last state on the grid where that differs from the prediction: the
    states of the sequential recurrence. bu: (B, L, P) pair; ``plan``
    defaults to :func:`scan_plan`'s."""
    _check_requant(block_requant, block_t)
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    if plan is None:
        plan = _plan_of(bu, reverse, block_requant, block_t)
    walk_bu = _walk_order(bu, reverse)
    length = walk_bu[0].shape[1]
    out = (torch.empty_like(walk_bu[0]), torch.empty_like(walk_bu[1]))
    carries = predicted_carries(lam, walk_bu, carry_init, block_requant, plan)
    stack = lambda xs: (torch.stack([c[0] for c in xs], dim=1),  # noqa
                        torch.stack([c[1] for c in xs], dim=1))
    kw = dict(out=out, block_requant=block_requant,
              requant_block=plan.requant_block)
    if not plan.block_pass:
        rows = [plan.chunk_rows(k)[:2] for k in range(plan.n_chunks)]
        _walk(lam, walk_bu, rows, stack(carries), **kw)
        return _walk_order(out, reverse)
    # block pass: every block from its predicted carry, then in order again
    # from the block before's last state where that differs
    blocks = [(j * plan.block, min(plan.block, length - j * plan.block))
              for j in range(plan.n_blocks)]
    pred = [carries[j * plan.per_block] for j in range(plan.n_blocks)]
    last = _walk(lam, walk_bu, blocks, stack(pred), **kw)
    last = [(last[0][:, j], last[1][:, j]) for j in range(len(blocks))]
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for j in range(1, len(blocks)):
        true = last[j - 1]
        if any(bool((bits(t) != bits(c)).any())
               for t, c in zip(true, pred[j])):
            x = _walk(lam, walk_bu, [blocks[j]],
                      (true[0][:, None], true[1][:, None]), **kw)
            last[j] = (x[0][:, 0], x[1][:, 0])
    return _walk_order(out, reverse)


# ------------------------------------------------ the kernel

def _check_f32_cuda(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")


def _check_view_pair(name: str, pair: Pair, shape, vec: int,
                     device) -> None:
    """A pair the kernel reads or writes in place: float32 (B, L, P) views
    on the device with equal strides, unit stride in P and, with 128-bit
    accesses, strides and addresses a multiple of ``vec`` floats."""
    a, b = pair
    for t in pair:
        _check_f32_cuda(name, t, device)
    if a.shape != shape or b.shape != shape:
        raise ValueError(f"{name} must be {tuple(shape)} pairs, got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    if a.stride() != b.stride() or a.stride(-1) != 1:
        raise ValueError(f"{name} halves need equal strides, unit-stride "
                         "in P")
    if vec > 1 and (a.stride(0) % vec or a.stride(1) % vec
                    or a.data_ptr() % (4 * vec) or b.data_ptr() % (4 * vec)):
        raise ValueError(f"{name}: strides and addresses must be multiples "
                         f"of {vec} floats")


def reduce_dlam(partials: torch.Tensor) -> Pair:
    """dλ from the output pass's partial sums (B, n_chunks, 2, P): one sum
    over batch rows and chunks, in a fixed order (no atomics), so repeated
    runs agree bit for bit."""
    s = partials.sum(dim=(0, 1))
    return s[0], s[1]


def _aligned(bu: Pair, vec: int) -> Pair:
    """bu as the vector loads take it: element strides and addresses a
    multiple of ``vec`` floats, else fresh contiguous copies."""
    if vec == 1:
        return bu
    a, b = bu
    if (a.stride(0) % vec or a.stride(1) % vec
            or a.data_ptr() % (4 * vec) or b.data_ptr() % (4 * vec)):
        return (torch.empty(a.shape, dtype=a.dtype, device=a.device)
                .copy_(a),
                torch.empty(b.shape, dtype=b.dtype, device=b.device)
                .copy_(b))
    return bu


def _launch(lam: Pair, bu: Pair, carry_init: Optional[Pair], reverse: bool,
            block_requant: Optional[BlockRequant], block_t: Optional[int],
            out: Optional[Pair], accumulate: bool = False,
            states: Optional[Pair] = None):
    """The kernel's passes (:func:`diag_scan_cuda`, and with ``states``
    :func:`diag_scan_adjoint_cuda`): returns (the states, dλ's partials or
    None)."""
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    _check_requant(block_requant, block_t)
    if block_requant is not None and out is not None:
        raise ValueError("out is a float-mode option: the block requant "
                         "takes none")
    bu_re, bu_im = bu
    dev = bu_re.device
    if bu_re.dim() != 3 or bu_re.shape != bu_im.shape:
        raise ValueError(f"bu must be a (B, L, P) pair, got "
                         f"{tuple(bu_re.shape)} / {tuple(bu_im.shape)}")
    if bu_re.stride() != bu_im.stride() or bu_re.stride(-1) != 1:
        raise ValueError("bu halves need equal strides, unit-stride in P")
    b, l, p = bu_re.shape
    lam_re = lam[0].contiguous()
    lam_im = lam[1].contiguous()
    tensors = {"bu_re": bu_re, "bu_im": bu_im, "lam_re": lam_re,
               "lam_im": lam_im}
    c_re = c_im = None
    if carry_init is not None:
        c_re = carry_init[0].contiguous()
        c_im = carry_init[1].contiguous()
        if c_re.shape != (b, p) or c_im.shape != (b, p):
            raise ValueError(f"carry_init must be ({b}, {p}) pairs")
        tensors.update(c_re=c_re, c_im=c_im)
    for name, t in tensors.items():
        _check_f32_cuda(name, t, dev)
    if lam_re.shape != (p,) or lam_im.shape != (p,):
        raise ValueError(f"lam must be ({p},) pairs")
    if out is None:
        out_re = torch.empty((b, l, p), dtype=torch.float32, device=dev)
        out_im = torch.empty_like(out_re)
    else:
        out_re, out_im = out
    if b == 0 or l == 0 or p == 0:
        return (out_re, out_im), (None if states is None else
                                  out_re.new_zeros((b, 0, 2, p)))
    plan = scan_plan(b, l, p, None if block_requant is None else block_t,
                     reverse)
    if out is not None:
        _check_view_pair("out", out, bu_re.shape, plan.vec, dev)
    xs_re = xs_im = dlam = None
    if states is not None:
        _check_view_pair("states", states, bu_re.shape, plan.vec, dev)
        xs_re, xs_im = states
        dlam = torch.empty((b, plan.n_chunks, 2, p), dtype=torch.float32,
                           device=dev)
    bu_re, bu_im = _aligned((bu_re, bu_im), plan.vec)
    scratch = torch.empty(plan.scratch_floats(), dtype=torch.float32,
                          device=dev)
    s_re, s_im, qmax = 1.0, 1.0, 0.0
    if block_requant is not None:
        s_re, s_im, bits = block_requant
        qmax = 2.0 ** (bits - 1) - 1
    err = build.entry("diag_scan", "diag_scan_run", _argtypes)(
        bu_re.data_ptr(), bu_im.data_ptr(), bu_re.stride(0), bu_re.stride(1),
        lam_re.data_ptr(), lam_im.data_ptr(),
        c_re.data_ptr() if c_re is not None else None,
        c_im.data_ptr() if c_im is not None else None,
        scratch.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), b, l, p,
        int(reverse), plan.chunk, plan.block, plan.per_block, plan.n_chunks,
        plan.requant_block or 0, int(block_requant is not None), plan.vec,
        float(s_re), float(s_im), -(qmax + 1.0), qmax,
        exact_reciprocal(s_re), exact_reciprocal(s_im),
        out_re.stride(0), out_re.stride(1), int(accumulate),
        xs_re.data_ptr() if xs_re is not None else None,
        xs_im.data_ptr() if xs_im is not None else None,
        xs_re.stride(0) if xs_re is not None else 0,
        xs_re.stride(1) if xs_re is not None else 0,
        dlam.data_ptr() if dlam is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "diag_scan")
    count("diag_scan_passes", len(plan.launches()))
    count("diag_scan_requant" if block_requant is not None
          else "diag_scan_rev" if reverse else "diag_scan")
    return (out_re, out_im), dlam


@traced("kernel.diag_scan")
def diag_scan_cuda(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
                   reverse: bool = False,
                   block_requant: Optional[BlockRequant] = None,
                   block_t: Optional[int] = None,
                   out: Optional[Pair] = None) -> Pair:
    """Launch the kernel's passes. bu: (B, L, P) pair whose last axis is
    unit-stride (the halves of a (B, L, 2P) projection are taken as they
    are); lam: (P,) pair; carry_init: (B, P) pair or None, and None with
    ``reverse``; ``block_requant`` (s_re, s_im, bits) per ``block_t``
    steps, in either direction. Returns contiguous (B, L, P) states, or
    with ``out`` (float modes only), a (B, L, P) pair of views with equal
    strides and unit stride in P, writes them there and returns it."""
    return _launch(lam, bu, carry_init, reverse, block_requant, block_t,
                   out)[0]


@traced("kernel.diag_scan")
def diag_scan_adjoint_cuda(lam: Pair, g: Pair, states: Pair,
                           reverse: bool = False,
                           out: Optional[Pair] = None,
                           accumulate: bool = False):
    """The adjoint of the float scan ``diag_scan_cuda(lam, bu,
    reverse=reverse)`` whose states are ``states`` (B, L, P), at the
    cotangent ``g`` of those states: the kernel walks g the other way with
    conj(λ), which gives bu's cotangent v, and its output pass also sums
    v_t ⊙ conj(x) per (batch row, chunk, channel), x the state the primal
    step read (a zero at the open end). ``out`` as in
    :func:`diag_scan_cuda`; ``accumulate`` adds v to what ``out`` holds
    (one rounded float32 add; the walk carries its own v). Returns (v,
    partials (B, n_chunks, 2, P)), which :func:`reduce_dlam` sums."""
    if accumulate and out is None:
        raise ValueError("accumulate adds into out: pass out")
    return _launch((lam[0], -lam[1]), g, None, not reverse, None, None, out,
                   accumulate, states)


def diag_scan(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
              reverse: bool = False,
              block_requant: Optional[BlockRequant] = None,
              block_t: Optional[int] = None,
              out: Optional[Pair] = None) -> Pair:
    """All-prefix states of x_t = λ x_{t-1} + bu_t over bu (B, L, P), or
    with ``reverse`` of x_t = λ x_{t+1} + bu_t (no carry then). With
    ``block_requant`` every state is output on the frozen grid and the
    carry is put on it every ``block_t`` steps of the walk
    (:func:`~sparsernns_tpu_torch.ops.scan.sequential_diag_scan`). ``out``
    as in :func:`diag_scan_cuda`.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version (copied into ``out``)."""
    if bu[0].is_cuda:
        return diag_scan_cuda(lam, bu, carry_init, reverse, block_requant,
                              block_t, out)
    xs = diag_scan_plain(lam, bu, carry_init, reverse, block_requant, block_t)
    if out is None:
        return xs
    for o, x in zip(out, xs):
        o.copy_(x)
    return out


def diag_scan_adjoint(lam: Pair, g: Pair, states: Pair,
                      reverse: bool = False, out: Optional[Pair] = None,
                      accumulate: bool = False) -> Tuple[Pair, Pair]:
    """:func:`diag_scan_adjoint_cuda` with dλ summed: returns (v, dλ pair
    (P,)), dλ the sum of v_t ⊙ conj(x) over every batch row and step.
    CUDA tensors launch the kernel; CPU tensors take the plain version
    (written into ``out``, copied or added) and dλ by
    :func:`~sparsernns_tpu_torch.ops.scan._dlam`."""
    if g[0].is_cuda:
        v, parts = diag_scan_adjoint_cuda(lam, g, states, reverse, out,
                                          accumulate)
        return v, reduce_dlam(parts)
    if accumulate and out is None:
        raise ValueError("accumulate adds into out: pass out")
    v = diag_scan_plain((lam[0], -lam[1]), g, reverse=not reverse)
    dlam = _dlam(v, states, reverse)
    if out is not None:
        for o, x in zip(out, v):
            if accumulate:
                o.add_(x)
            else:
                o.copy_(x)
        v = out
    return v, dlam


def launched() -> List[Tuple[str, Tuple[int, int, int], int]]:
    """(pass, grid, threads a CTA) of every launch that the last K1 call
    made on the card, in order, as the CUDA source recorded them."""
    fn = build.entry("diag_scan", "diag_scan_launched",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int])
    cap = 4
    names = (ctypes.c_char_p * cap)()
    grids = (ctypes.c_int * (3 * cap))()
    threads = (ctypes.c_int * cap)()
    n = fn(names, grids, threads, cap)
    return [(names[i].decode(), tuple(grids[3 * i:3 * i + 3]), threads[i])
            for i in range(min(n, cap))]
