"""Sequence-parallel diagonal scan across ranks (counterpart of
``sparsernns_tpu/parallel/seqscan.py``).

The time axis is cut into one chunk per seq rank. Each rank scans its
chunk from a zero state (the diagonal-scan kernel on the card, its plain
version on the CPU), then takes the state entering its chunk from the
chunks before it and folds it in with the λ powers (``apply_carry``).

The JAX package finds that entering state by a Hillis-Steele prefix over
the seq axis (log2(n) rounds of ``ppermute``). Here every rank gathers the
n pairs (λ^T_r, end state_r) in one all-gather and combines the ranks
before it locally, in rank order: c ← λ^T_r ⊙ c + end_r. The sums run in
another order than the JAX package's, so the states agree to rounding,
not bit for bit. The exchange is (2P + 2·B·P) float32 a rank, whatever
the length. :class:`CarryCombine` is differentiable; its backward sums
each rank's gradient of (λ^T, end) over the ranks after it (one
reduce-scatter).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparsernns_tpu_torch.ops.scan import (Pair, apply_carry, complex_mul,
                                           diag_ssm_scan, lambda_powers)
from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh
from sparsernns_tpu_torch.parallel.sharding import seq_bounds


def _unpack(row: torch.Tensor, p: int, shape) -> Tuple[Pair, Pair]:
    n = row.numel() - 2 * p
    lam_t = (row[:p], row[p:2 * p])
    end = (row[2 * p:2 * p + n // 2].view(shape),
           row[2 * p + n // 2:].view(shape))
    return lam_t, end


class CarryCombine(torch.autograd.Function):
    """The state entering this rank's chunk, from every seq rank's
    (λ^T (P,), end state (..., P)) pair: one all-gather, then
    c_0 = 0, c_{r+1} = λ^T_r ⊙ c_r + end_r over the ranks r before this
    one."""

    @staticmethod
    def forward(ctx, lt_re, lt_im, end_re, end_im, group):
        p, shape = lt_re.shape[0], end_re.shape
        packed = torch.cat([lt_re, lt_im, end_re.reshape(-1),
                            end_im.reshape(-1)])
        rows = comms.all_gather(packed, group)
        me = comms.group_rank(group)
        chain = [(torch.zeros_like(end_re), torch.zeros_like(end_im))]
        for r in range(me):
            lam_t, end = _unpack(rows[r], p, shape)
            c = complex_mul(lam_t, chain[-1])
            chain.append((c[0] + end[0], c[1] + end[1]))
        ctx.save_for_backward(rows)
        ctx.group, ctx.p, ctx.shape = group, p, shape
        ctx.chain = chain
        return chain[-1]

    @staticmethod
    def backward(ctx, g_re, g_im):
        rows, = ctx.saved_tensors
        p, shape, chain = ctx.p, ctx.shape, ctx.chain
        grads = torch.zeros_like(rows)
        gc = (g_re, g_im)
        axes = tuple(range(len(shape) - 1))
        for r in reversed(range(len(chain) - 1)):
            lam_t, _ = _unpack(rows[r], p, shape)
            c = chain[r]
            # c_{r+1} = λ^T_r c_r + end_r: d end_r = gc, dλ^T_r = Σ gc
            # conj(c_r), d c_r = conj(λ^T_r) gc
            g_lam = (gc[0] * c[0] + gc[1] * c[1], gc[1] * c[0] - gc[0] * c[1])
            if axes:
                g_lam = (g_lam[0].sum(dim=axes), g_lam[1].sum(dim=axes))
            grads[r] = torch.cat([g_lam[0], g_lam[1], gc[0].reshape(-1),
                                  gc[1].reshape(-1)])
            gc = complex_mul((lam_t[0], -lam_t[1]), gc)
        own = comms.reduce_scatter(grads, ctx.group)
        (gl_re, gl_im), (ge_re, ge_im) = _unpack(own, p, shape)
        return gl_re, gl_im, ge_re, ge_im, None


def seq_chunk_scan(lam: Pair, bu_local: Pair, group) -> Pair:
    """The global states of this rank's time chunk, from its chunk
    ``bu_local`` (..., T_r, P) of the inputs (chunks in seq-rank order,
    any lengths): the local scan (the kernel on the card, differentiable),
    the carry from the chunks before (:class:`CarryCombine`), and
    ``apply_carry``."""
    xs = diag_ssm_scan(lam, bu_local)
    if comms.group_size(group) == 1:
        return xs
    t = bu_local[0].shape[-2]
    pw = lambda_powers(lam, t)
    carry = CarryCombine.apply(pw[0][-1], pw[1][-1], xs[0][..., -1, :],
                               xs[1][..., -1, :], group)
    return apply_carry(xs, lam, carry)


def make_sp_train_scan(mesh: Mesh):
    """The differentiable sequence-parallel scan of training:
    ``scan(lam (P,) pair, bu (B, L, P) pair)`` -> this seq rank's chunk of
    the states, (B, stop - start, P) for its frames [start, stop) of
    :func:`~sparsernns_tpu_torch.parallel.sharding.seq_bounds`. A length
    that the seq axis does not divide leaves the last chunks short, as the
    JAX package's end padding (sliced off after the scan) does."""
    group, n = mesh.group(SEQ_AXIS), mesh.size(SEQ_AXIS)
    i = mesh.index(SEQ_AXIS)

    def scan(lam: Pair, bu: Pair) -> Pair:
        if bu[0].dim() != 3:
            raise ValueError(f"sp training scan expects (B, L, P) inputs, "
                             f"got {tuple(bu[0].shape)}")
        lo, hi = seq_bounds(bu[0].shape[1], n, i)
        return seq_chunk_scan(lam, (bu[0][:, lo:hi], bu[1][:, lo:hi]),
                              group)

    return scan


def make_seq_parallel_scan(mesh: Mesh):
    """``scan(lam (P,) pair, bu (..., L, P) pair)`` -> this seq rank's
    chunk of the states, the L / n frames from L / n · index. L must be
    divisible by the seq axis (``ValueError`` otherwise)."""
    group, n = mesh.group(SEQ_AXIS), mesh.size(SEQ_AXIS)
    i = mesh.index(SEQ_AXIS)

    def scan(lam: Pair, bu: Pair) -> Pair:
        length = bu[0].shape[-2]
        if length % n:
            raise ValueError(f"L={length} not divisible by the seq axis "
                             f"({n})")
        part = length // n
        local = tuple(x.narrow(-2, i * part, part) for x in bu)
        return seq_chunk_scan(lam, local, group)

    return scan
