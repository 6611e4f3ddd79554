"""Diagonal linear-recurrence scans — the hot loop of every S5 model.

Computes ``x_t = λ ⊙ x_{t-1} + bu_t`` for a constant complex diagonal
``λ`` (shape (P,)) over the time axis of ``bu`` (..., L, P). Complex
numbers are carried as (re, im) pairs of real float32 tensors, the
layout the CUDA kernels read (counterpart of ``sparsernns_tpu/ops/scan.py``).

:func:`diag_ssm_scan` runs the hand-written diagonal-scan kernel
(``ops/cuda/diag_scan.py``), forward or reverse in time, which takes its
plain version (:func:`sequential_diag_scan`) only for a tensor on the CPU.
Without a carry the scan is differentiable (:class:`DiagScanFn`, the
counterpart of ``sparsernns_tpu/ops/pallas/scan_vjp.py``): the recurrence
is linear, so its adjoint is the same kernel run in the other direction
with conj(λ), which sums dλ in the same walk (the kernel's adjoint entry,
``ops/cuda/diag_scan.diag_scan_adjoint``). With ``qat_bits`` the forward
is the kernel's QAT mode (``ops/cuda/qat_scan.py``: per-block fake-quant
of every doubling operand, of the folded carry and of the block's
states), the backward the same float adjoint.

:class:`BiDiagScanFn` is a bidirectional float mixer's two scans in one
differentiable call that works inside the projections' buffers: both
directions write their states into the C-projection's (B, L, 4P) input,
their adjoints read its cotangent in place, write bu's gradient into one
(B, L, 2P) buffer, the second adding to the first, and sum dλ in the
kernel's output pass. The launch ledger (``utils/trace.py``) counts the
bidirectional mixers' routes: ``bidir_buffers`` each forward and each
backward of :class:`BiDiagScanFn`, ``bidir_unfused`` each forward of the
two separate scans (``models/ssm.S5SSM._apply_scan``).

:func:`associative_diag_scan` is the associative scan of the JAX package
(``jax.lax.associative_scan``'s recursion, reproduced combine for
combine), with the QAT hadamards in every combine: the quantization-aware
scan of ``scan_mode="associative"``, in plain PyTorch.

:func:`blocked_diag_scan` is the JAX package's block-parallel scan
(``scan_mode="blocked"`` and the serving engine's ``route="xla"``): per
time block one per-channel triangular matmul, a carry loop over the
blocks and the λ-power fold. The JAX package made it free of Pallas
kernels on purpose, so here it is plain PyTorch on every device, and
differentiable by autograd.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sparsernns_tpu_torch.utils.trace import count

Pair = Tuple[torch.Tensor, torch.Tensor]
#: (s_re, s_im, bits): the frozen grid of a blockwise state requant
BlockRequant = Tuple[float, float, int]
#: (a_bits, act_bits) of the in-scan activation QAT
QatBits = Tuple[Optional[int], Optional[int]]


def complex_mul(a: Pair, b: Pair, had: Callable = torch.mul) -> Pair:
    """(a_re + i a_im) * (b_re + i b_im) as 4 real products ``had``."""
    ar, ai = a
    br, bi = b
    return had(ar, br) - had(ai, bi), had(ar, bi) + had(ai, br)


def quant_codes(x: torch.Tensor, spec: Tuple[float, int]) -> torch.Tensor:
    """Integer codes (as float32) of x on a frozen (scale, bits) grid:
    round half to even, then clip."""
    s, bits = spec
    qmax = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(x / s), -(qmax + 1.0), qmax)


def grid_value(x: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    """x on a frozen symmetric grid: its ``bits``-bit codes times the
    scale."""
    return quant_codes(x, (scale, bits)) * scale


def block_end(step: int, length: int, block_t: int) -> bool:
    """Whether the walk's ``step``-th row (0-based, in the order the scan
    visits time) ends a block of the block requant: every ``block_t`` rows
    from the walk's start, and the last row. Forward the walk starts at
    t = 0, reverse at t = L - 1, so reverse blocks align from the
    sequence's end, as the JAX kernel's flip aligns them."""
    return (step + 1) % block_t == 0 or step + 1 == length


def sequential_diag_scan(lam: Pair, bu: Pair,
                         carry_init: Optional[Pair] = None,
                         state_requant: Optional[Callable[[Pair], Pair]] = None,
                         reverse: bool = False,
                         block_requant: Optional[BlockRequant] = None,
                         block_t: Optional[int] = None,
                         had_ax: Callable = torch.mul
                         ) -> Tuple[Pair, Pair]:
    """Step-by-step scan along axis -2. Returns (all states, final state).

    ``carry_init`` (..., P): the state before the first step (streaming).
    ``reverse`` walks time from the last row down (x_t = λ x_{t+1} + bu_t;
    the final state is then the one at t = 0); it takes no carry.
    ``state_requant`` is applied to the carried state after every step: the
    static-quant inference semantics, which no associative scan can
    express.

    ``block_requant`` (s_re, s_im, bits) is the serving engine's blockwise
    requant (the JAX kernel ``pallas_diag_scan``'s ``block_requant``):
    inside a time block of ``block_t`` steps the recurrence runs in float32
    from the block's carry, every state of the block is output on the
    frozen grid, and the carry into the next block (and the final state)
    is the requantized last state of the block. Blocks are counted in the
    walk's order (:func:`block_end`): forward from t = 0, reverse from
    t = L - 1.

    ``had_ax`` is the λ·x hadamard (a QAT model's fake-quantized one).
    Differentiable in λ, bu and the carry where ``state_requant`` is (the
    static-quant model's straight-through requant) and without a block
    requant: the states are stacked, not written in place."""
    bu_r, bu_i = bu
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    if block_requant is not None and (not block_t or block_t < 1):
        raise ValueError("block_requant needs block_t >= 1")
    if carry_init is None:
        x_r = torch.zeros_like(bu_r[..., 0, :])
        x_i = torch.zeros_like(bu_i[..., 0, :])
    else:
        x_r, x_i = carry_init
    out_r, out_i = [], []
    length = bu_r.shape[-2]
    for step in range(length):
        t = length - 1 - step if reverse else step
        ax_r, ax_i = complex_mul(lam, (x_r, x_i), had_ax)
        x_r = ax_r + bu_r[..., t, :]
        x_i = ax_i + bu_i[..., t, :]
        if state_requant is not None:
            x_r, x_i = state_requant((x_r, x_i))
        if block_requant is None:
            out_r.append(x_r)
            out_i.append(x_i)
            continue
        s_re, s_im, bits = block_requant
        q_r, q_i = grid_value(x_r, s_re, bits), grid_value(x_i, s_im, bits)
        out_r.append(q_r)
        out_i.append(q_i)
        if block_end(step, length, block_t):
            x_r, x_i = q_r, q_i
    if reverse:
        out_r.reverse()
        out_i.reverse()
    if not out_r:
        return (bu_r.clone(), bu_i.clone()), (x_r, x_i)
    return (torch.stack(out_r, dim=-2), torch.stack(out_i, dim=-2)), (x_r, x_i)


def lambda_powers(lam: Pair, length: int) -> Pair:
    """λ^{t+1} for t in [0, length): a (length, P) pair, in polar form
    (|λ| < 1 after clip_eigs keeps every power in range)."""
    lr, li = lam
    r = torch.sqrt(lr * lr + li * li)
    theta = torch.atan2(li, lr)
    t = torch.arange(1, length + 1, dtype=lr.dtype, device=lr.device)[:, None]
    rk = torch.exp(t * torch.log(torch.clamp(r, min=1e-30)))
    ang = t * theta
    return rk * torch.cos(ang), rk * torch.sin(ang)


def _kernel_operand(pair: Pair) -> Pair:
    """A (B, L, P) pair as the kernel takes it: equal strides, unit stride
    in P (the halves of one (B, L, 2P) tensor pass as they are)."""
    a, b = pair
    if a.stride() != b.stride() or a.stride(-1) != 1:
        return a.contiguous(), b.contiguous()
    return a, b


def _dlam(v: Pair, xs: Pair, reverse: bool) -> Pair:
    """dλ = Σ_{b,t} v_t ⊙ conj(x_{t∓1}), the neighbour the step read; the
    open end (t = 0 forward, t = L-1 reverse) read a zero state."""
    axes = tuple(range(v[0].dim() - 1))
    near, far = (slice(None, -1), slice(1, None))
    if not reverse:
        near, far = far, near
    v_r, v_i = v[0][..., near, :], v[1][..., near, :]
    x_r, x_i = xs[0][..., far, :], xs[1][..., far, :]
    return ((v_r * x_r + v_i * x_i).sum(dim=axes),
            (v_i * x_r - v_r * x_i).sum(dim=axes))


class DiagScanFn(torch.autograd.Function):
    """Differentiable scan without a carry, either direction. Call as
    ``DiagScanFn.apply(lam_re, lam_im, bu_re, bu_im, reverse[, qat_bits,
    block_t])``; returns the (B, L, P) state pair. ``qat_bits``
    (a_bits, act_bits) runs the forward in the kernel's QAT mode over time
    blocks of ``block_t`` (``ops/cuda/qat_scan.py``); None the float scan
    (``block_t`` unused). The backward is one call of the kernel's adjoint
    entry (``diag_scan_adjoint``): the float kernel once more, in the other
    direction with conj(λ), on the cotangents, gives ``v``, the gradient of
    ``bu`` (the straight-through estimator of the in-scan fake-quant), and
    sums dλ, ``v`` against the conjugate of the state each step read (the
    saved states: the quantized ones under QAT), in its output pass;
    :func:`_dlam` on the CPU."""

    @staticmethod
    def forward(ctx, lam_re, lam_im, bu_re, bu_im, reverse, qat_bits=None,
                block_t=None):
        from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
        bu = _kernel_operand((bu_re, bu_im))
        if qat_bits is None:
            xs = diag_scan((lam_re, lam_im), bu, reverse=reverse)
        else:
            from sparsernns_tpu_torch.ops.cuda.qat_scan import qat_scan
            xs = qat_scan((lam_re, lam_im), bu, qat_bits, block_t,
                          reverse=reverse)
        ctx.save_for_backward(lam_re, lam_im, *xs)
        ctx.reverse = reverse
        return xs

    @staticmethod
    def backward(ctx, g_re, g_im):
        from sparsernns_tpu_torch.ops.cuda.diag_scan import \
            diag_scan_adjoint
        lam_re, lam_im, x_re, x_im = ctx.saved_tensors
        v, (d_re, d_im) = diag_scan_adjoint(
            (lam_re, lam_im), _kernel_operand((g_re, g_im)), (x_re, x_im),
            ctx.reverse)
        return d_re, d_im, v[0], v[1], None, None, None


def _columns(buf: torch.Tensor, k: int, p: int) -> Pair:
    """Direction k's (re, im) column blocks of the bidirectional states
    matrix (..., 4P), laid out [fwd_re | rev_re | fwd_im | rev_im]."""
    return buf[..., k * p:(k + 1) * p], buf[..., (k + 2) * p:(k + 3) * p]


class BiDiagScanFn(torch.autograd.Function):
    """Both scans of a bidirectional float mixer, inside the projections'
    buffers. Call as ``BiDiagScanFn.apply(lam_re, lam_im, bu_cat)`` with
    ``bu_cat`` (B, L, 2P) = [bu_re | bu_im], the B-projection's output;
    returns the (B, L, 4P) states matrix [fwd_re | rev_re | fwd_im |
    rev_im], the C-projection's input, which the scan kernel writes column
    block by column block (``diag_scan``'s ``out``): the states and the
    matrix of the two :class:`DiagScanFn` and the concatenations, bit for
    bit. It is saved once, for dλ here and for the C-projection's weight
    gradient by autograd.

    The backward reads the matrix's cotangent in place: each direction's
    adjoint is the kernel in the other direction with conj(λ) on its column
    blocks, writing bu's gradient into one (B, L, 2P) buffer [v_re | v_im],
    the second adding its own to the first's (one rounded add, as
    autograd's: bit for bit), and summing dλ against the saved states in
    the same walk (``diag_scan_adjoint``, as :class:`DiagScanFn`'s
    backward; :func:`_dlam` on the CPU, whose plain scans write into the
    same buffers)."""

    @staticmethod
    def forward(ctx, lam_re, lam_im, bu_cat):
        from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
        p = bu_cat.shape[-1] // 2
        bu = _kernel_operand((bu_cat[..., :p], bu_cat[..., p:]))
        buf = bu_cat.new_empty(bu_cat.shape[:-1] + (4 * p,))
        for k, reverse in enumerate((False, True)):
            diag_scan((lam_re, lam_im), bu, reverse=reverse,
                      out=_columns(buf, k, p))
        ctx.save_for_backward(lam_re, lam_im, buf)
        count("bidir_buffers")
        return buf

    @staticmethod
    def backward(ctx, g):
        from sparsernns_tpu_torch.ops.cuda.diag_scan import \
            diag_scan_adjoint
        lam_re, lam_im, buf = ctx.saved_tensors
        p = buf.shape[-1] // 4
        g_bu = buf.new_empty(buf.shape[:-1] + (2 * p,))
        v = (g_bu[..., :p], g_bu[..., p:])
        d = [diag_scan_adjoint((lam_re, lam_im),
                               _kernel_operand(_columns(g, k, p)),
                               _columns(buf, k, p), reverse, out=v,
                               accumulate=k == 1)[1]
             for k, reverse in enumerate((False, True))]
        count("bidir_buffers")
        return d[0][0] + d[1][0], d[0][1] + d[1][1], g_bu


# ------------------------------------------------ associative scan

def _scan_binop(qi, qj, had_aa: Callable, had_ax: Callable):
    """The associative combine of first-order recurrences on elements
    (A_re, A_im, b_re, b_im), i earlier than j: (A_j∘A_i, A_j∘b_i + b_j),
    with the Λ·Λ products through ``had_aa`` and the Λ·state products
    through ``had_ax`` (the JAX package's ``_scan_binop``)."""
    a_out = complex_mul((qj[0], qj[1]), (qi[0], qi[1]), had_aa)
    bx = complex_mul((qj[0], qj[1]), (qi[2], qi[3]), had_ax)
    return [a_out[0], a_out[1], bx[0] + qj[2], bx[1] + qj[3]]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along axis -2; a has as many rows as b or one
    more."""
    n = b.shape[-2]
    pairs = torch.stack([a[..., :n, :], b], dim=-2)
    out = pairs.reshape(*b.shape[:-2], 2 * n, b.shape[-1])
    return torch.cat([out, a[..., n:, :]], dim=-2)


def _assoc_scan(elems, combine):
    """``jax.lax.associative_scan``'s recursion along axis -2, step for
    step: the per-tensor fake-quant inside a combine depends on which
    slices it combines, so the slices are the same ones."""
    n = elems[0].shape[-2]
    if n < 2:
        return elems
    reduced = combine([e[..., 0:-1:2, :] for e in elems],
                      [e[..., 1::2, :] for e in elems])
    odd = _assoc_scan(reduced, combine)
    rest = [e[..., 2::2, :] for e in elems]
    if n % 2 == 0:
        even = combine([e[..., :-1, :] for e in odd], rest)
    else:
        even = combine(odd, rest)
    even = [torch.cat([e[..., :1, :], r], dim=-2)
            for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def associative_diag_scan(lam: Pair, bu: Pair, reverse: bool = False,
                          had_aa: Callable = torch.mul,
                          had_ax: Callable = torch.mul) -> Pair:
    """All-prefix states along axis -2 by the associative scan, with the
    QAT hadamards ``had_aa`` / ``had_ax`` (``quantize.qat.q_had``) in every
    combine. Plain PyTorch, differentiable by autograd, as the JAX package
    runs it as XLA ops."""
    shape = bu[0].shape
    elems = [lam[0].expand(shape), lam[1].expand(shape), bu[0], bu[1]]
    if reverse:
        elems = [torch.flip(e, dims=(-2,)) for e in elems]
    out = _assoc_scan(elems, lambda a, b: _scan_binop(a, b, had_aa, had_ax))
    xs = out[2], out[3]
    if reverse:
        xs = torch.flip(xs[0], dims=(-2,)), torch.flip(xs[1], dims=(-2,))
    return xs


def apply_carry(xs: Pair, lam: Pair, carry: Pair) -> Pair:
    """Fold an incoming carry into chunk-local states:
    x_t <- x_t + λ^{t+1} ⊙ carry (t local, 0-based)."""
    pw = lambda_powers(lam, xs[0].shape[-2])
    corr = complex_mul(pw, (carry[0][..., None, :], carry[1][..., None, :]))
    return xs[0] + corr[0], xs[1] + corr[1]


# ------------------------------------------------ blocked scan

def _block_triangular(lam: Pair, block_t: int, dtype) -> Pair:
    """The per-channel lower-triangular propagator M[j, i, p] = λ_p^{j-i}
    (i ≤ j, else 0), a (T, T, P) pair of polar powers (|λ| < 1 keeps every
    entry in [0, 1]). Each power is :func:`lambda_powers`' expression for
    its exponent, so the entries are the JAX package's gather of that
    table; evaluated in place, the backward is elementwise, with no
    scatter of an index's gradient."""
    lr, li = lam[0].to(dtype), lam[1].to(dtype)
    r = torch.sqrt(lr * lr + li * li)
    theta = torch.atan2(li, lr)
    idx = torch.arange(block_t, device=lr.device)
    k = idx[:, None] - idx[None, :]                       # j - i
    mask = (k >= 0)[..., None].to(dtype)                  # (T, T, 1)
    kc = torch.clamp(k, min=0).to(dtype)[..., None]
    rk = torch.exp(kc * torch.log(torch.clamp(r, min=1e-30)))
    ang = kc * theta
    return rk * torch.cos(ang) * mask, rk * torch.sin(ang) * mask


def blocked_diag_scan(lam: Pair, bu: Pair, block_t: int = 128,
                      reverse: bool = False,
                      carry_init: Optional[Pair] = None,
                      block_requant: Optional[BlockRequant] = None) -> Pair:
    """All-prefix states along axis -2 by block-parallel matmuls (the JAX
    package's ``blocked_diag_scan``). L is cut into blocks of
    T = min(block_t, L) rows (the last one zero-padded). Within a block the
    zero-carry states are one per-channel triangular matmul
    y[j] = Σ_{i≤j} λ^{j-i} u[i]; the carry into block k+1 is
    λ^T c_k + y_k[T-1], a loop over the blocks; the carry folds back in as
    x[k, j] = y[k, j] + λ^{j+1} c_k. ``carry_init`` (..., P) is the state
    before the first row (forward only).

    ``block_requant`` (s_re, s_im, bits): every state lands on the frozen
    grid after the carry fold, and the carry into the next block is the
    requantized block-final state (the serving engine's placement).
    ``reverse`` scans the flipped sequence and takes neither a carry nor,
    as in the JAX package, the requant. Differentiable by autograd."""
    if reverse:
        if carry_init is not None:
            raise NotImplementedError("carry with reverse scan")
        flip = lambda p: (torch.flip(p[0], dims=(-2,)),  # noqa: E731
                          torch.flip(p[1], dims=(-2,)))
        return flip(blocked_diag_scan(lam, flip(bu), block_t=block_t))
    bu_re, bu_im = bu
    orig_shape = bu_re.shape
    l, p = orig_shape[-2], orig_shape[-1]
    t = min(block_t, l)
    nb = -(-l // t)
    pad = nb * t - l
    dtype = bu_re.dtype

    def prep(a):
        a = a.reshape((-1,) + tuple(orig_shape[-2:]))      # (N, L, P)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return a.reshape(-1, nb, t, p)                     # (N, nb, T, P)

    u_re, u_im = prep(bu_re), prep(bu_im)
    m_re, m_im = _block_triangular(lam, t, dtype)
    rq = None
    if block_requant is not None:
        s_re, s_im, bits = block_requant

        def rq(xr, xi):
            return grid_value(xr, s_re, bits), grid_value(xi, s_im, bits)

    def tri(m, u):  # (T, T, P) x (N, nb, T, P) -> (N, nb, T, P), over i
        return torch.einsum("jip,nkip->nkjp", m, u)

    y_re = tri(m_re, u_re) - tri(m_im, u_im)
    y_im = tri(m_re, u_im) + tri(m_im, u_re)

    lam_t = lambda_powers(lam, t)
    lam_t = (lam_t[0][-1].to(dtype), lam_t[1][-1].to(dtype))
    c_re = torch.zeros_like(u_re[:, 0, 0, :])
    c_im = torch.zeros_like(c_re)
    if carry_init is not None:
        c_re = carry_init[0].reshape(-1, p).expand(c_re.shape)
        c_im = carry_init[1].reshape(-1, p).expand(c_im.shape)
    carries_re, carries_im = [c_re], [c_im]
    for k in range(nb - 1):
        # c_{k+1} = λ^T c_k + y_k[T-1], y the zero-carry block scan
        ac = complex_mul(lam_t, (carries_re[-1], carries_im[-1]))
        nc_re, nc_im = ac[0] + y_re[:, k, -1, :], ac[1] + y_im[:, k, -1, :]
        if rq is not None:      # the carry is the requantized final state
            nc_re, nc_im = rq(nc_re, nc_im)
        carries_re.append(nc_re)
        carries_im.append(nc_im)
    cs = (torch.stack(carries_re, dim=1), torch.stack(carries_im, dim=1))

    pw = lambda_powers(lam, t)
    pw = (pw[0].to(dtype), pw[1].to(dtype))                 # (T, P)
    corr = complex_mul((pw[0][None, None], pw[1][None, None]),
                       (cs[0][:, :, None, :], cs[1][:, :, None, :]))
    x_re, x_im = y_re + corr[0], y_im + corr[1]
    if rq is not None:          # every served state lands on the grid
        x_re, x_im = rq(x_re, x_im)

    def unprep(a):
        return a.reshape(-1, nb * t, p)[:, :l, :].reshape(orig_shape)

    return unprep(x_re), unprep(x_im)


def diag_ssm_scan(lam: Pair, bu: Pair, reverse: bool = False,
                  carry_init: Optional[Pair] = None,
                  block_requant: Optional[BlockRequant] = None,
                  block_t: Optional[int] = None, mode: str = "kernel",
                  qat_bits: Optional[QatBits] = None,
                  had_aa: Callable = torch.mul,
                  had_ax: Callable = torch.mul) -> Pair:
    """All-prefix states (B, L, P): of x_t = λ x_{t-1} + bu_t, or with
    ``reverse`` of x_t = λ x_{t+1} + bu_t.

    ``mode="kernel"`` (the JAX package's ``"pallas"``) runs the
    diagonal-scan kernel. Without a carry and a requant the call is
    differentiable in λ and bu. With ``carry_init`` (forward only,
    streaming) or ``block_requant`` (either direction, per ``block_t``
    steps counted from the walk's start: the serving engine's state
    requant, see :func:`sequential_diag_scan`) it is not, as in the JAX
    package: inputs that require grad raise while grad mode is on.
    ``qat_bits`` (a_bits, act_bits) runs the kernel's QAT mode over time
    blocks of ``block_t``, with ``block_requant`` every state then on the
    frozen grid after its fake-quant.

    ``mode="associative"`` is the associative scan with the hadamards
    ``had_aa`` / ``had_ax`` (differentiable; a carry folds in with the
    λ powers afterwards, forward only). ``mode="sequential"`` walks the
    steps one by one (:func:`sequential_diag_scan`, differentiable, with
    ``had_ax``): the JAX package's naive scan. Both express QAT through
    the hadamards and ignore ``qat_bits``, as in the JAX package.

    ``mode="blocked"`` is :func:`blocked_diag_scan` (differentiable, with a
    carry forward; time blocks of ``block_t``, None: 128). It has no
    site for the QAT hadamards and refuses them, as the JAX package does,
    and takes no ``block_requant`` here (the JAX dispatcher passes none)."""
    if mode == "blocked":
        if had_aa is not torch.mul or had_ax is not torch.mul:
            raise NotImplementedError(
                "QAT hadamards are per-combine; the blocked matmul form "
                "has no per-combine site: train QAT with "
                "scan_mode='associative' or 'pallas'")
        if block_requant is not None:
            raise NotImplementedError(
                "diag_ssm_scan(mode='blocked') takes no block requant: "
                "call blocked_diag_scan")
        return blocked_diag_scan(lam, bu, reverse=reverse,
                                 carry_init=carry_init,
                                 block_t=128 if block_t is None else block_t)
    if mode == "sequential":
        if block_requant is not None:
            raise NotImplementedError("the sequential scan has no block "
                                      "requant")
        return sequential_diag_scan(lam, bu, carry_init=carry_init,
                                    reverse=reverse, had_ax=had_ax)[0]
    if mode == "associative":
        xs = associative_diag_scan(lam, bu, reverse, had_aa, had_ax)
        if carry_init is not None:
            if reverse:
                raise NotImplementedError("carry with reverse scan")
            xs = apply_carry(xs, lam, carry_init)
        return xs
    if mode != "kernel":
        raise ValueError(f"unknown scan mode {mode!r}")
    if carry_init is None and block_requant is None:
        return DiagScanFn.apply(lam[0], lam[1], bu[0], bu[1], reverse,
                                qat_bits, block_t)
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    operands = (*lam, *bu, *(carry_init or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise NotImplementedError(
            "the scan with a carry or a block requant has no gradient: call "
            "it under torch.no_grad(), or without carry_init and "
            "block_requant")
    if qat_bits is not None:
        from sparsernns_tpu_torch.ops.cuda.qat_scan import qat_scan
        return qat_scan(lam, _kernel_operand(bu), qat_bits, block_t,
                        reverse=reverse, carry_init=carry_init,
                        block_requant=block_requant)
    from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
    return diag_scan(lam, _kernel_operand(bu), carry_init=carry_init,
                     reverse=reverse, block_requant=block_requant,
                     block_t=block_t)
