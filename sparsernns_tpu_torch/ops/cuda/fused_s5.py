"""Kernel K4a: the S5 mixer in one kernel, float mode.

Replaces ``sparsernns_tpu/ops/pallas/fused_s5.py`` ``fused_s5_apply`` with
f32 weights and an f32 input: per batch row

    bu = u @ W_b
    xs = scan(λ, bu)                      (in order over time)
    y = [xs_re xs_im] @ W_c + D ⊙ u       (relu on xs if relu_state)

with the states never in device memory. The CUDA source is
``csrc/fused_s5.cu``; its header note gives the bound and the design.
:func:`fused_s5` launches the kernel for CUDA tensors and takes the plain
version :func:`fused_s5_plain` only for tensors on the CPU.

:class:`FusedS5Fn` is the differentiable form (the counterpart of
``sparsernns_tpu/ops/pallas/fused_vjp.py`` ``fused_s5_apply_diff``). Its
forward saves only its inputs. Its backward recomputes the states with the
stand-alone scan kernel (``ops/cuda/diag_scan.py``), runs that kernel in
reverse with conj(λ) on the cotangents, and leaves the products to
``torch.matmul``, as the JAX package leaves them to XLA.

Under ``relu_state`` the backward's relu mask comes from the recomputed
states. Both kernels round a scan step alike (``csrc/scan_step.cuh``), but
the recompute's B-projection is a ``torch.matmul`` with another summation
order than the kernel's, so a state within rounding of zero may land on the
other side of the relu than it did in the forward. Such a state contributes
nothing to the output on either side; its cotangent is then kept or dropped
the other way. The JAX package is in the same position (a Pallas dot in the
forward, an XLA matmul in the recompute) and holds this gradient to
rtol = atol 2e-2 against plain autograd.
"""

from __future__ import annotations

import ctypes

import torch

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
from sparsernns_tpu_torch.ops.cuda.layer_tail import check_tensors
from sparsernns_tpu_torch.ops.scan import Pair, sequential_diag_scan

#: kernel launches made by :func:`fused_s5` in this process
launches = 0

#: shared memory one block may ask for on the card, and the kernel's tile
_MAX_SMEM = 232448
_TILE = 32


def fused_s5_plain(u, lam: Pair, w_b, w_c, d, relu_state: bool = False
                   ) -> torch.Tensor:
    """Plain PyTorch version. u: (B, L, H); w_b (H, 2P); w_c (2P, H) with
    the conj-sym factor folded in; d (H,); lam (P,) pair."""
    p = w_b.shape[-1] // 2
    bu = u @ w_b
    xs, _ = sequential_diag_scan(lam, (bu[..., :p], bu[..., p:]))
    if relu_state:
        xs = (torch.relu(xs[0]), torch.relu(xs[1]))
    return torch.cat(xs, dim=-1) @ w_c + d * u


_argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    fn = build.load("fused_s5").fused_s5_fwd
    if fn.argtypes is None:
        fn.argtypes = _argtypes
        fn.restype = ctypes.c_int
    return fn


def fused_s5_cuda(u, lam: Pair, w_b, w_c, d, relu_state: bool = False
                  ) -> torch.Tensor:
    """Launch the kernel (one CTA per batch row). Same arguments as
    :func:`fused_s5_plain`; every tensor float32 on one CUDA device."""
    global launches
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, H), got {tuple(u.shape)}")
    b, l, h = u.shape
    p = w_b.shape[-1] // 2
    ops = check_tensors(
        {"u": (u, (b, l, h)), "lam_re": (lam[0], (p,)),
         "lam_im": (lam[1], (p,)), "w_b": (w_b, (h, 2 * p)),
         "w_c": (w_c, (2 * p, h)), "d": (d, (h,))}, u.device)
    smem = 4 * (_TILE * (-(-h // 4) * 4 + -(-2 * p // 4) * 4) + 2 * p)
    if smem > _MAX_SMEM:
        raise ValueError(f"H={h}, P={p}: a tile needs {smem} bytes of "
                         f"shared memory, the card gives {_MAX_SMEM}")
    y = torch.empty((b, l, h), dtype=torch.float32, device=u.device)
    if b == 0 or l == 0:
        return y
    fn = _lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(ops["u"].data_ptr(), y.data_ptr(), ops["w_b"].data_ptr(),
             ops["w_c"].data_ptr(), ops["d"].data_ptr(),
             ops["lam_re"].data_ptr(), ops["lam_im"].data_ptr(), b, l, h, p,
             int(relu_state), stream)
    build.check(err, "fused_s5")
    launches += 1
    return y


def fused_s5(u, lam: Pair, w_b, w_c, d, relu_state: bool = False
             ) -> torch.Tensor:
    """The mixer, (B, L, H) -> (B, L, H). CUDA tensors launch the kernel
    (or raise); CPU tensors take the plain version."""
    fn = fused_s5_cuda if u.is_cuda else fused_s5_plain
    return fn(u, lam, w_b, w_c, d, relu_state)


def fused_s5_bwd(u, g, lam: Pair, w_b, w_c, d, relu_state: bool = False):
    """The adjoint of :func:`fused_s5` at cotangent ``g`` (B, L, H):
    ``(d_u, (d_lam_re, d_lam_im), d_w_b, d_w_c, d_d)``. Two launches of the
    scan kernel on CUDA tensors (states again, then the reverse scan of the
    cotangents with conj λ); the products are ``torch.matmul``."""
    p = w_b.shape[-1] // 2
    bu = u @ w_b
    xs = diag_scan(lam, (bu[..., :p], bu[..., p:]))
    xs_act = torch.cat(xs, dim=-1)
    g_xs = g @ w_c.T
    if relu_state:
        mask = xs_act > 0
        xs_act = xs_act * mask
        g_xs = g_xs * mask
    v = diag_scan((lam[0], -lam[1]), (g_xs[..., :p], g_xs[..., p:]),
                  reverse=True)
    v_cat = torch.cat(v, dim=-1)
    d_u = v_cat @ w_b.T + g * d
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    d_w_b = flat(u).T @ flat(v_cat)
    d_w_c = flat(xs_act).T @ flat(g)
    d_d = (g * u).sum(dim=(0, 1))
    # dλ = Σ v_t ⊙ conj(x_{t-1}); the first step read a zero state
    x_r, x_i = xs[0][:, :-1], xs[1][:, :-1]
    v_r, v_i = v[0][:, 1:], v[1][:, 1:]
    d_lam = ((v_r * x_r + v_i * x_i).sum(dim=(0, 1)),
             (v_i * x_r - v_r * x_i).sum(dim=(0, 1)))
    return d_u, d_lam, d_w_b, d_w_c, d_d


class FusedS5Fn(torch.autograd.Function):
    """Differentiable :func:`fused_s5`. Call as ``FusedS5Fn.apply(u, lam_re,
    lam_im, w_b, w_c, d, relu_state)``. The forward saves only its inputs;
    the backward is :func:`fused_s5_bwd`."""

    @staticmethod
    def forward(ctx, u, lam_re, lam_im, w_b, w_c, d, relu_state):
        ctx.save_for_backward(u, lam_re, lam_im, w_b, w_c, d)
        ctx.relu_state = relu_state
        return fused_s5(u, (lam_re, lam_im), w_b, w_c, d, relu_state)

    @staticmethod
    def backward(ctx, g):
        u, lam_re, lam_im, w_b, w_c, d = ctx.saved_tensors
        d_u, d_lam, d_w_b, d_w_c, d_d = fused_s5_bwd(
            u, g, (lam_re, lam_im), w_b, w_c, d, ctx.relu_state)
        return d_u, d_lam[0], d_lam[1], d_w_b, d_w_c, d_d, None
