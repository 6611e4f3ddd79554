"""Kernel K1 in its QAT mode: the diagonal complex scan with in-scan
activation fake-quant, forward or reverse in time, with an optional carry
(forward) and an optional block requant.

Replaces ``sparsernns_tpu/ops/pallas/scan_kernel.py`` ``pallas_diag_scan``
with ``qat_bits=(a_bits, act_bits)`` (body ``scan_block_body``). Over time
blocks of ``t = min(block_t, ceil8(L))`` rows, L padded with zero rows to a
multiple of t (padded rows are numerics here: they enter the shifted
operands and the last block's output scale), per batch row and block:

1. doubling passes k = 0 … num_passes-1, d = 2^k: the block shifted down
   by d rows (d zero rows in front) is fake-quantized to ``act_bits`` on
   the absmax of the whole shifted (t, P) block (each half its own scale,
   or one given global absmax), and x += λ^(2^k) ⊙ shifted;
2. the carry fold: the carry row, fake-quantized on the absmax over its P
   channels, times the λ^(r+1) table, is added to every row r;
3. the whole folded block is fake-quantized on its own absmax (then, with
   ``block_requant`` (s_re, s_im, bits), every state put on that frozen
   grid); its last row is the carry into the next block.

The λ tables (:func:`lambda_power_tables`): the powers λ^(2^k) by repeated
squaring, each fake-quantized to ``a_bits`` before it is squared, and the
carry-fold table λ^(r+1), fake-quantized as a whole. The plain version
builds them with PyTorch ops, as the JAX package builds them outside its
kernel; the CUDA path with one kernel that does the same operations in the
same order. An incoming carry c is not fake-quantized: λ·c is added to the
first row of bu before the scan, as the JAX package does. ``reverse``
scans the flipped sequence, so blocks start at the end and the padding
lies before time 0; a block requant then puts the carry on its grid at the
end of every block of the flipped sequence, as the JAX kernel does.

:func:`qat_scan` launches the kernels (``csrc/qat_scan.cu``, whose header
note gives the bound and the design: the tables kernel, then one
thread-block cluster per (batch row, block), the block split by channel
over the cluster's shared memory, as :func:`qat_plan` lays it out) for
CUDA tensors and takes the plain version :func:`qat_scan_plain` only for
tensors on the CPU. :func:`qat_blocks_plain` is the part shared with the
mixer's QAT mode (``ops/cuda/fused_s5.py`` ``fused_s5_qat``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.diag_scan import _check_f32_cuda
from sparsernns_tpu_torch.ops.scan import (BlockRequant, Pair, QatBits,
                                           grid_value, lambda_powers)
from sparsernns_tpu_torch.quantize.qat import _on_grid, dyn_fake_quant
from sparsernns_tpu_torch.utils.trace import count, traced

#: (pow_re, pow_im (K, P), ctab_re, ctab_im (t, P))
Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: shared memory one CTA may ask for on the card
MAX_SMEM = 232448
#: what the scan CTA keeps in static shared memory beside its slice
#: (reduction slots, the ticket), rounded up
STATIC_SMEM = 1024
#: threads of a scan CTA; the channels of a slice divide it
THREADS = 512
#: CTAs a cluster may hold: 8 portable, 16 with the non-portable attribute
MAX_CLUSTER = 16
#: the most channels a CTA holds
MAX_CPC = 256
#: bytes of a block's slice a CTA aims at (the plan's split): 64 KB, eight
#: CTAs of 16 channels at t = 512, sixteen of 8 at t = 1024 (P = 128), two
#: CTAs an SM. On an H100 it beat 128 KB a CTA (one an SM) and matched
#: 32 KB (PERF.md §6)
CTA_BYTES = 64 * 1024
#: CTAs of the tables kernel's one cluster
TABLE_CLUSTER = 8
TABLES_KERNEL = "qat_tables_kernel"
SCAN_KERNEL = "qat_scan_kernel<scan>"
MIXER_SCAN_KERNEL = "qat_scan_kernel<mixer>"


def scan_geometry(length: int, block_t: int) -> Tuple[int, int, int]:
    """(t, L_pad, num_passes) of a sequence of ``length`` rows: the time
    block min(block_t, ceil8(L)), L padded to a multiple of it, and the
    number of doubling passes max(1, bit_length(t - 1))."""
    if block_t is None or block_t < 1:
        raise ValueError(f"the QAT scan needs block_t >= 1, got {block_t}")
    t = min(block_t, -(-max(length, 1) // 8) * 8)
    return t, -(-length // t) * t, max(1, (t - 1).bit_length())


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def scan_smem(t: int, p: int, cpc: int) -> int:
    """Shared memory of a scan CTA: its slice (t rows of cpc channels, re
    and im), the carry in (2P), the carry on its grid (2 cpc), and the
    static part."""
    return 4 * (2 * t * cpc + 2 * p + 2 * cpc) + STATIC_SMEM


@dataclasses.dataclass(frozen=True)
class QatPlan:
    """How one QAT scan call cuts the card: one cluster of ``cluster``
    CTAs per (batch row, time block of ``t`` rows), CTA ``rank`` holding
    channels [rank * cpc, (rank + 1) * cpc) of every row of its block
    (channels at or past P are zero and never stored). Clusters take a
    ticket as they start; ticket → (block j, batch row b) = divmod(ticket,
    B), so the carry a cluster waits for (b, j - 1) comes from a cluster
    with an earlier ticket."""

    batch: int
    length: int
    p: int
    t: int
    l_pad: int
    num_passes: int
    cpc: int
    cluster: int

    @property
    def n_blocks(self) -> int:
        return self.l_pad // self.t

    @property
    def n_clusters(self) -> int:
        return self.batch * self.n_blocks

    @property
    def ctas(self) -> int:
        return self.n_clusters * self.cluster

    @property
    def smem(self) -> int:
        return scan_smem(self.t, self.p, self.cpc)

    def cluster_of(self, ticket: int) -> Tuple[int, int]:
        """(batch row, block) of the cluster that took ``ticket``."""
        j, b = divmod(ticket, self.batch)
        return b, j

    def channels(self, rank: int) -> range:
        """The state channels CTA ``rank`` of a cluster holds and stores."""
        return range(min(rank * self.cpc, self.p),
                     min((rank + 1) * self.cpc, self.p))

    def table_floats(self) -> int:
        """Floats of the λ tables: pow (num_passes, P) and ctab (t, P),
        re and im."""
        return 2 * (self.num_passes + self.t) * self.p

    def launches(self, mixer_rows: Optional[int] = None
                 ) -> List[Tuple[str, int, int]]:
        """(kernel, CTAs, cluster) of every launch of one call, in order:
        K1 the tables and the scan; the mixer (``mixer_rows``: the row
        passes' CTAs, ``engine_layer.pass_plan``) the tables, the head row
        pass, the scan, the tail row pass."""
        tables = (TABLES_KERNEL, TABLE_CLUSTER, TABLE_CLUSTER)
        if mixer_rows is None:
            return [tables, (SCAN_KERNEL, self.ctas, self.cluster)]
        row = ("engine_row_pass_kernel", mixer_rows, 1)
        return [tables, row, (MIXER_SCAN_KERNEL, self.ctas, self.cluster),
                row]


def max_block(p: int) -> int:
    """The largest time block the scan takes at P = ``p``: a cluster of
    :data:`MAX_CLUSTER` CTAs, each with the fewest channels that covers P,
    within :data:`MAX_SMEM` (3592 rows at P = 128)."""
    cpc = _pow2_ceil(-(-p // MAX_CLUSTER))
    rows = (MAX_SMEM - scan_smem(0, p, cpc)) // (8 * cpc)
    return rows // 8 * 8


def qat_plan(batch: int, length: int, p: int, block_t: int,
             cta_bytes: Optional[int] = None) -> QatPlan:
    """The plan of one call, a pure function of the shapes and the split:
    the most channels a CTA (a power of two, at most :data:`MAX_CPC` and
    P rounded up to one) whose slice stays within ``cta_bytes`` (default
    :data:`CTA_BYTES`), but at least P / :data:`MAX_CLUSTER`. Raises
    ValueError before any launch where a block does not fit."""
    if min(batch, length, p) < 1:
        raise ValueError(f"empty QAT scan: B={batch}, L={length}, P={p}")
    t, l_pad, n_pass = scan_geometry(length, block_t)
    target = CTA_BYTES if cta_bytes is None else cta_bytes
    cpc = min(_pow2_floor(target // (8 * t)), _pow2_ceil(p), MAX_CPC)
    cpc = max(cpc, _pow2_ceil(-(-p // MAX_CLUSTER)))
    if cpc > MAX_CPC or scan_smem(t, p, cpc) > MAX_SMEM:
        raise ValueError(
            f"a QAT time block of {t} rows at P={p} does not fit in a "
            f"cluster of {MAX_CLUSTER} CTAs ({scan_smem(t, p, cpc)} bytes "
            f"of shared memory a CTA, the card gives {MAX_SMEM}): the "
            f"largest block at P={p} is {max_block(p)} rows")
    return QatPlan(batch, length, p, t, l_pad, n_pass, cpc, -(-p // cpc))


def _check_bits(qat_bits: QatBits) -> Tuple[Optional[int], int]:
    a_bits, act_bits = qat_bits
    if act_bits is None:
        raise ValueError("the QAT scan needs act_bits (qat_bits[1])")
    return a_bits, act_bits


def lambda_power_tables(lam: Pair, t: int, num_passes: int,
                        a_bits: Optional[int]) -> Tables:
    """The scan's λ tables: (pow_re, pow_im) (num_passes, P), row k the
    fake-quantized λ^(2^k), and (ctab_re, ctab_im) (t, P), row r the
    fake-quantized λ^(r+1). Every fake-quant is per half, on ``a_bits``."""
    lr, li = lam
    rows_re, rows_im = [], []
    for _ in range(num_passes):
        lr, li = dyn_fake_quant(lr, a_bits), dyn_fake_quant(li, a_bits)
        rows_re.append(lr)
        rows_im.append(li)
        lr, li = lr * lr - li * li, 2.0 * lr * li
    c_re, c_im = lambda_powers(lam, t)
    return (torch.stack(rows_re), torch.stack(rows_im),
            dyn_fake_quant(c_re, a_bits), dyn_fake_quant(c_im, a_bits))


def _fq(x: torch.Tensor, bits: int, dims, amax: Optional[torch.Tensor]
        ) -> torch.Tensor:
    """Fake-quant with one absmax per slice over ``dims`` (or ``amax``)."""
    if bits >= 32:
        return x
    if amax is None:
        amax = x.abs().amax(dim=dims, keepdim=True)
    return _on_grid(x, amax, bits)


def _check_requant(block_requant: Optional[BlockRequant]) -> None:
    if block_requant is not None and not 1 < int(block_requant[2]) <= 32:
        raise ValueError(f"block_requant {block_requant}: a grid of 2 to "
                         "32 bits")


def qat_blocks_plain(x: Pair, tables: Tables, t: int, act_bits: int,
                     amax: Optional[torch.Tensor] = None,
                     block_requant: Optional[BlockRequant] = None) -> Pair:
    """The QAT scan of zero-carry blocks (B, L_pad, P) pair, L_pad a
    multiple of ``t``: the doubling passes vectorised over (B, blocks), then
    a loop over the blocks for the carry fold and the output fake-quant.
    ``amax``: one global absmax for every state fake-quant.
    ``block_requant`` (s_re, s_im, bits): every state of a block, after its
    fake-quant, on that frozen grid, and the carry onward with it."""
    pow_re, pow_im, ct_re, ct_im = tables
    b, l_pad, p = x[0].shape
    nb = l_pad // t
    x_re, x_im = (a.reshape(b, nb, t, p) for a in x)
    blk = (-2, -1)
    for k in range(pow_re.shape[0]):
        d = 1 << k
        sh_re = _fq(F.pad(x_re[..., :t - d, :], (0, 0, d, 0)), act_bits, blk,
                    amax)
        sh_im = _fq(F.pad(x_im[..., :t - d, :], (0, 0, d, 0)), act_bits, blk,
                    amax)
        lr, li = pow_re[k], pow_im[k]
        x_re, x_im = (x_re + (lr * sh_re - li * sh_im),
                      x_im + (lr * sh_im + li * sh_re))
    c_re = x_re.new_zeros((b, p))
    c_im = x_im.new_zeros((b, p))
    out_re, out_im = [], []
    for j in range(nb):
        cr = _fq(c_re, act_bits, (-1,), amax)[:, None, :]
        ci = _fq(c_im, act_bits, (-1,), amax)[:, None, :]
        y_re = _fq(x_re[:, j] + (ct_re * cr - ct_im * ci), act_bits, blk,
                   amax)
        y_im = _fq(x_im[:, j] + (ct_re * ci + ct_im * cr), act_bits, blk,
                   amax)
        if block_requant is not None:
            s_re, s_im, bits = block_requant
            y_re, y_im = grid_value(y_re, s_re, bits), grid_value(y_im, s_im,
                                                                  bits)
        out_re.append(y_re)
        out_im.append(y_im)
        c_re, c_im = y_re[:, -1], y_im[:, -1]
    return torch.cat(out_re, dim=1), torch.cat(out_im, dim=1)


def _check_args(bu: Pair, carry_init: Optional[Pair], reverse: bool,
                block_requant: Optional[BlockRequant] = None):
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    _check_requant(block_requant)
    if bu[0].dim() != 3 or bu[0].shape != bu[1].shape:
        raise ValueError(f"bu must be a (B, L, P) pair, got "
                         f"{tuple(bu[0].shape)} / {tuple(bu[1].shape)}")


def qat_scan_plain(lam: Pair, bu: Pair, qat_bits: QatBits, block_t: int,
                   reverse: bool = False,
                   carry_init: Optional[Pair] = None,
                   block_requant: Optional[BlockRequant] = None) -> Pair:
    """Plain PyTorch version of :func:`qat_scan`."""
    _check_args(bu, carry_init, reverse, block_requant)
    a_bits, act_bits = _check_bits(qat_bits)
    bu_re, bu_im = bu
    length = bu_re.shape[1]
    t, l_pad, n_pass = scan_geometry(length, block_t)
    if carry_init is not None:
        lr, li = lam
        cr, ci = carry_init
        bu_re = torch.cat([bu_re[:, :1] + (lr * cr - li * ci)[:, None],
                           bu_re[:, 1:]], dim=1)
        bu_im = torch.cat([bu_im[:, :1] + (lr * ci + li * cr)[:, None],
                           bu_im[:, 1:]], dim=1)
    if reverse:
        bu_re, bu_im = bu_re.flip(1), bu_im.flip(1)
    pad = (0, 0, 0, l_pad - length)
    xs = qat_blocks_plain((F.pad(bu_re, pad), F.pad(bu_im, pad)),
                          lambda_power_tables(lam, t, n_pass, a_bits), t,
                          act_bits, block_requant=block_requant)
    xs = (xs[0][:, :length], xs[1][:, :length])
    if reverse:
        xs = (xs[0].flip(1), xs[1].flip(1))
    return xs


_RUN_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def requant_args(block_requant: Optional[BlockRequant]
                 ) -> Tuple[float, float, int]:
    """(s_re, s_im, bits) of a block requant as the kernels take it; bits
    0 for none."""
    if block_requant is None:
        return 0.0, 0.0, 0
    s_re, s_im, bits = block_requant
    return float(s_re), float(s_im), int(bits)


def call_buffers(plan: QatPlan, device) -> Tuple[torch.Tensor, ...]:
    """The scratch of one call (no kernel launched to make it): the λ
    tables, the published carries (B, blocks, 2P) and the scan's counters
    (the tables kernel zeroes them)."""
    return (torch.empty(plan.table_floats(), dtype=torch.float32,
                        device=device),
            torch.empty((plan.batch, plan.n_blocks, 2 * plan.p),
                        dtype=torch.float32, device=device),
            torch.empty(1 + plan.n_clusters, dtype=torch.int32,
                        device=device))


@traced("kernel.qat_scan")
def qat_scan_cuda(lam: Pair, bu: Pair, qat_bits: QatBits, block_t: int,
                  reverse: bool = False,
                  carry_init: Optional[Pair] = None,
                  block_requant: Optional[BlockRequant] = None) -> Pair:
    """Launch the kernels. bu: (B, L, P) pair with equal strides, unit
    stride in P; lam (P,) pair; carry_init (B, P) pair or None. Returns
    contiguous (B, L, P) states. A time block that does not fit in a
    cluster is refused (:func:`qat_plan`) before any launch."""
    _check_args(bu, carry_init, reverse, block_requant)
    a_bits, act_bits = _check_bits(qat_bits)
    bu_re, bu_im = bu
    b, length, p = bu_re.shape
    plan = qat_plan(b, length, p, block_t) if b and length and p else None
    dev = bu_re.device
    if bu_re.stride() != bu_im.stride() or bu_re.stride(-1) != 1:
        raise ValueError("bu halves need equal strides, unit-stride in P")
    lam_re, lam_im = lam[0].contiguous(), lam[1].contiguous()
    tensors = {"bu_re": bu_re, "bu_im": bu_im, "lam_re": lam_re,
               "lam_im": lam_im}
    c_ptr = [None, None]
    if carry_init is not None:
        c_re, c_im = (c.contiguous() for c in carry_init)
        if c_re.shape != (b, p) or c_im.shape != (b, p):
            raise ValueError(f"carry_init must be ({b}, {p}) pairs")
        tensors.update(c_re=c_re, c_im=c_im)
        c_ptr = [c_re.data_ptr(), c_im.data_ptr()]
    for name, t in tensors.items():
        _check_f32_cuda(name, t, dev)
    if lam_re.shape != (p,) or lam_im.shape != (p,):
        raise ValueError(f"lam must be ({p},) pairs")
    out_re = torch.empty((b, length, p), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    if plan is None:
        return out_re, out_im
    tables, cbuf, sync = call_buffers(plan, dev)
    err = build.entry("qat_scan", "qat_scan_run", _RUN_ARGS)(
        bu_re.data_ptr(), bu_im.data_ptr(), bu_re.stride(0),
        bu_re.stride(1), lam_re.data_ptr(), lam_im.data_ptr(), *c_ptr,
        tables.data_ptr(), plan.num_passes, cbuf.data_ptr(),
        sync.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), b, length, p,
        plan.t, plan.cpc, int(reverse), a_bits or 0, act_bits,
        *requant_args(block_requant),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "qat_scan")
    count("qat_scan")
    return out_re, out_im


def qat_scan(lam: Pair, bu: Pair, qat_bits: QatBits, block_t: int,
             reverse: bool = False,
             carry_init: Optional[Pair] = None,
             block_requant: Optional[BlockRequant] = None) -> Pair:
    """All-prefix states (B, L, P) of the QAT scan over bu (B, L, P):
    x_t = λ x_{t-1} + bu_t, or with ``reverse`` x_t = λ x_{t+1} + bu_t (no
    carry then; blocks counted from the end), with the in-scan fake-quant of
    ``qat_bits`` (a_bits, act_bits) over time blocks of ``block_t``, and
    with ``block_requant`` (s_re, s_im, bits) every state then on that
    frozen grid. Not differentiable (``ops/scan.py`` ``DiagScanFn`` is,
    without a carry and a requant).

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    version."""
    fn = qat_scan_cuda if bu[0].is_cuda else qat_scan_plain
    return fn(lam, bu, qat_bits, block_t, reverse, carry_init, block_requant)


def tables_cuda(lam: Pair, t: int, num_passes: int,
                a_bits: Optional[int]) -> Tables:
    """The λ tables as the tables kernel makes them on the card (the same
    tables as :func:`lambda_power_tables`); lam: (P,) float32 CUDA pair.
    For holding the kernel against the PyTorch ops: the scan's calls
    launch it themselves."""
    lam_re, lam_im = lam[0].contiguous(), lam[1].contiguous()
    dev = lam_re.device
    for name, x in (("lam_re", lam_re), ("lam_im", lam_im)):
        _check_f32_cuda(name, x, dev)
    p = lam_re.shape[0]
    tables = torch.empty(2 * (num_passes + t) * p, dtype=torch.float32,
                         device=dev)
    sync = torch.empty(1, dtype=torch.int32, device=dev)
    fn = build.entry("qat_scan", "qat_tables_run",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    build.check(fn(lam_re.data_ptr(), lam_im.data_ptr(), tables.data_ptr(),
                   sync.data_ptr(), 1, p, t, num_passes, a_bits or 0,
                   torch.cuda.current_stream(dev).cuda_stream),
                "qat_tables")
    pw = tables[:2 * num_passes * p].view(2, num_passes, p)
    ct = tables[2 * num_passes * p:].view(2, t, p)
    return pw[0], pw[1], ct[0], ct[1]


# ------------------------------------------------ the launch record

def launched() -> List[Tuple[str, int, int, int]]:
    """(kernel, CTAs, cluster, dynamic shared memory bytes) of every launch
    that the last K1 qat or K4a qat call made on the card, in order, as the
    CUDA source recorded them."""
    fn = build.entry("qat_scan", "qat_scan_launched",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int])
    cap = 8
    names = (ctypes.c_char_p * cap)()
    ctas = (ctypes.c_longlong * cap)()
    clusters = (ctypes.c_int * cap)()
    smem = (ctypes.c_int * cap)()
    n = fn(names, ctas, clusters, smem, cap)
    return [(names[i].decode(), ctas[i], clusters[i], smem[i])
            for i in range(min(n, cap))]


def max_active_clusters(plan: QatPlan, mixer: bool = False) -> int:
    """How many clusters of the plan's scan the card keeps resident at
    once (``cudaOccupancyMaxActiveClusters``)."""
    fn = build.entry("qat_scan", "qat_scan_max_clusters",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = ctypes.c_int(0)
    build.check(fn(plan.t, plan.p, plan.cpc, int(mixer), ctypes.byref(out)),
                "qat_scan_max_clusters")
    return out.value
