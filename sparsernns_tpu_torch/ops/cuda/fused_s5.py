"""Kernels K4a and K4b: the S5 mixer alone, as passes over the card.

Replaces ``sparsernns_tpu/ops/pallas/fused_s5.py`` ``fused_s5_apply``:
per batch row

    bu = u @ W_b                          (per-half scales on the result)
    xs = scan(λ, bu)                      (in order over time)
    y = [xs_re xs_im] @ W_c + D ⊙ u       (relu on xs if relu_state)

One CUDA source, ``csrc/fused_s5.cu`` (its header note gives the bound and
the design), runs every mode as the serving layer kernels' own passes
(``csrc/engine_passes.cuh``, with the layer around the mixer switched off):
a head row pass u -> bu, a scan over all of L per (batch row, channel), a
tail row pass -> y, the row passes over tiles of 32 rows of the flattened
B * L stream (``engine_layer.pass_plan`` with one layer and no encoder; bu
and then the states in scratch). :func:`launched` reads back the passes of
the last call on the card:

- :func:`fused_s5`: the float mode (f32 weights and input, no scales, no
  state grid), the mixer of the float models' mixer route;
- :func:`fused_s5_engine`: the serving engine's modes (int8 / int16
  weights with static per-half pow2 scales, a bf16 or f32 input, the
  blockwise state requant), and with a carry in and out the replacement
  of ``fused_s5_apply_carry`` (K4b): the mixer of the engine's per-op
  route.

:func:`fused_s5_qat` is the QAT mode (``qat_bits``, ``qat_state_scale``,
also over int8 / int16 weights with per-half scales and with the block
requant): four launches of ``csrc/qat_scan.cu``, the λ tables, the same
head row pass, the QAT scan of ``ops/cuda/qat_scan.py`` (one thread-block
cluster per (batch row, time block)) and the same tail row pass;
``qat_scan.launched`` reads them back.

Each launches the kernel for CUDA tensors and takes its plain version
(:func:`fused_s5_plain`, :func:`fused_s5_engine_plain`,
:func:`fused_s5_qat_plain`) only for tensors on the CPU.

:class:`FusedS5Fn` is the differentiable form (the counterpart of
``sparsernns_tpu/ops/pallas/fused_vjp.py`` ``fused_s5_apply_diff``). Its
forward saves only its inputs. Its backward recomputes the states with the
stand-alone scan kernel (``ops/cuda/diag_scan.py``), runs that kernel in
reverse with conj(λ) on the cotangents, and leaves the products to
``torch.matmul``, as the JAX package leaves them to XLA.

Under ``relu_state`` the backward's relu mask comes from the recomputed
states. The recompute's B-projection is a ``torch.matmul`` with another
summation order than the kernel's, and its scan another rounding of a
step, so a state within rounding of zero may land on the other side of the
relu than it did in the forward. Such a state contributes nothing to the
output on either side; its cotangent is then kept or dropped the other
way. The JAX package is in the same position (a Pallas dot in the forward,
an XLA matmul in the recompute) and holds this gradient to rtol = atol
2e-2 against plain autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sparsernns_tpu_torch.ops.cuda import build, engine_layer, qat_scan
from sparsernns_tpu_torch.ops.cuda.diag_scan import _check_f32_cuda, diag_scan
from sparsernns_tpu_torch.ops.cuda.layer_tail import check_tensors
from sparsernns_tpu_torch.ops.scan import (BlockRequant, Pair, QatBits,
                                           sequential_diag_scan)
from sparsernns_tpu_torch.utils.trace import count, traced

Scales = Optional[Tuple[float, float]]


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


_FWD_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.POINTER(engine_layer.LayerParams), ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 2)


def launched():
    """(kernel, CTAs) of every pass that the last K4a / K4b call launched
    on the card, in order, as the CUDA source recorded them."""
    return engine_layer.read_launched("fused_s5")


def check_width(h: int, p: int) -> None:
    """Raise ValueError where the tail row pass's tile (u, y and the
    states of :data:`engine_layer.ROW_TILE` rows) does not fit in a
    block's shared memory: H up to 780 at P = 128."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    smem = 4 * engine_layer.ROW_TILE * (2 * r4(h) + r4(2 * p))
    limit = engine_layer.MAX_SMEM
    if smem > limit:
        raise ValueError(f"H={h}, P={p}: a tail tile needs {smem} bytes of "
                         f"shared memory, the card gives {limit}")


def _launch(u, ops: engine_layer.MixerOps, relu_state: bool, block_t: int,
            carry: Optional[Pair]):
    """One call of the kernel's three passes on a checked (B, L, H) input
    ``u``: y, or with ``carry`` (y, new carry)."""
    dev = u.device
    b, l, h = u.shape
    p = ops.w_b.shape[-1] // 2
    check_width(h, p)
    u = u.contiguous()
    lp = engine_layer.pack_mixer(ops, dev)
    y = torch.empty((b, l, h), dtype=torch.float32, device=dev)
    ci_ptr = co_ptr = [None, None]
    co = None
    if carry is not None:
        ci = tuple(c.contiguous() for c in carry)
        ci_ptr = [engine_layer._ptr(c, "carry", (b, p), torch.float32, dev)
                  for c in ci]
        co = (torch.empty((b, p), dtype=torch.float32, device=dev),
              torch.empty((b, p), dtype=torch.float32, device=dev))
        co_ptr = [c.data_ptr() for c in co]
    if b == 0 or l == 0:
        return y if carry is None else (y, carry)
    scratch = engine_layer.alloc_scratch(
        engine_layer.pass_plan(b, l, h, p, 1, encoder=False), dev)
    err = build.entry("fused_s5", "fused_s5_fwd", _FWD_ARGS)(
        u.data_ptr(), y.data_ptr(), engine_layer.IO_TYPES[u.dtype],
        ctypes.byref(lp), int(relu_state), *ci_ptr, *co_ptr, b, l, h,
        block_t, scratch["bu"].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_s5")
    return y if carry is None else (y, co)


@traced("kernel.fused_s5")
def fused_s5_cuda(u, lam: Pair, w_b, w_c, d, relu_state: bool = False
                  ) -> torch.Tensor:
    """Enqueue the kernel's passes in its float mode. Same arguments as
    :func:`fused_s5_plain`; every tensor float32 on one CUDA device."""
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, H), got {tuple(u.shape)}")
    b, l, h = u.shape
    p = w_b.shape[-1] // 2
    t = check_tensors(
        {"u": (u, (b, l, h)), "lam_re": (lam[0], (p,)),
         "lam_im": (lam[1], (p,)), "w_b": (w_b, (h, 2 * p)),
         "w_c": (w_c, (2 * p, h)), "d": (d, (h,))}, u.device)
    ops = engine_layer.MixerOps((t["lam_re"], t["lam_im"]), t["w_b"],
                                t["w_c"], t["d"])
    y = _launch(t["u"], ops, relu_state, max(l, 1), None)
    if b and l:
        count("fused_s5")
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
    """Differentiable mixer. Call as ``FusedS5Fn.apply(u, lam_re, lam_im,
    w_b, w_c, d, relu_state[, qat_bits, qat_scale, block_t])``: with
    ``qat_bits`` None (the default) the float mode :func:`fused_s5`
    (``qat_scale`` and ``block_t`` unused), else the QAT mode :func:`fused_s5_qat`. The forward
    saves only its inputs; the backward is :func:`fused_s5_bwd` in both
    cases: the adjoint of the float mixer, whose states (and relu mask) it
    recomputes without fake-quant (the straight-through estimator, as the
    JAX package's ``fused_s5_apply_diff``). ``qat_scale`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, u, lam_re, lam_im, w_b, w_c, d, relu_state,
                qat_bits=None, qat_scale=None, block_t=None):
        ctx.save_for_backward(u, lam_re, lam_im, w_b, w_c, d)
        ctx.relu_state = relu_state
        lam = (lam_re, lam_im)
        if qat_bits is None:
            return fused_s5(u, lam, w_b, w_c, d, relu_state)
        return fused_s5_qat(u, lam, w_b, w_c, d, qat_bits, block_t,
                            relu_state, qat_scale)

    @staticmethod
    def backward(ctx, g):
        u, lam_re, lam_im, w_b, w_c, d = ctx.saved_tensors
        d_u, d_lam, d_w_b, d_w_c, d_d = fused_s5_bwd(
            u, g, (lam_re, lam_im), w_b, w_c, d, ctx.relu_state)
        return (d_u, d_lam[0], d_lam[1], d_w_b, d_w_c, d_d, None, None, None,
                None)


# ------------------------------------------------ QAT mode

def fused_s5_qat_plain(u, lam: Pair, w_b, w_c, d, qat_bits: QatBits,
                       block_t: int, relu_state: bool = False,
                       qat_scale: Optional[torch.Tensor] = None, *,
                       wb_scales: Scales = None, wc_scales: Scales = None,
                       block_requant: Optional[BlockRequant] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_s5_qat`: the B-projection
    (times the per-half ``wb_scales``), the QAT scan of its zero-padded
    blocks (``qat_scan.qat_blocks_plain``, with the block requant), relu,
    the C-side scales, the C-projection and d ⊙ u."""
    a_bits, act_bits = qat_scan._check_bits(qat_bits)
    qat_scan._check_requant(block_requant)
    b, length, _ = u.shape
    p = w_b.shape[-1] // 2
    t, l_pad, n_pass = qat_scan.scan_geometry(length, block_t)
    bu = u @ w_b.to(torch.float32)
    bu_re, bu_im = bu[..., :p], bu[..., p:]
    if wb_scales is not None:
        bu_re, bu_im = bu_re * wb_scales[0], bu_im * wb_scales[1]
    pad = (0, 0, 0, l_pad - length)
    xs = qat_scan.qat_blocks_plain(
        (torch.nn.functional.pad(bu_re, pad),
         torch.nn.functional.pad(bu_im, pad)),
        qat_scan.lambda_power_tables(lam, t, n_pass, a_bits), t, act_bits,
        qat_scale, block_requant)
    xs = torch.cat(xs, dim=-1)[:, :length]
    if relu_state:
        xs = torch.relu(xs)
    if wc_scales is not None:
        xs = torch.cat([xs[..., :p] * wc_scales[0],
                        xs[..., p:] * wc_scales[1]], dim=-1)
    return xs @ w_c.to(torch.float32) + d * u


_QAT_ARGS = ([ctypes.c_void_p, ctypes.c_void_p,
              ctypes.POINTER(engine_layer.LayerParams), ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def qat_plan(u, w_b, block_t: int
             ) -> Tuple[qat_scan.QatPlan, engine_layer.PassPlan]:
    """The QAT scan's plan of one call on ``u`` (B, L, H) and the plan of
    its row passes (``engine_layer.pass_plan`` with one layer and no
    encoder); raises before any launch where a block or the tail's tile
    does not fit."""
    b, length, h = u.shape
    p = w_b.shape[-1] // 2
    check_width(h, p)
    return (qat_scan.qat_plan(b, length, p, block_t),
            engine_layer.pass_plan(b, length, h, p, 1, encoder=False))


@traced("kernel.fused_s5_qat")
def fused_s5_qat_cuda(u, lam: Pair, w_b, w_c, d, qat_bits: QatBits,
                      block_t: int, relu_state: bool = False,
                      qat_scale: Optional[torch.Tensor] = None, *,
                      wb_scales: Scales = None, wc_scales: Scales = None,
                      block_requant: Optional[BlockRequant] = None
                      ) -> torch.Tensor:
    """Launch the kernels in the QAT mode: the λ tables, the head row pass
    (u -> bu), the QAT scan (one cluster per (batch row, block)), the tail
    row pass (relu, C-projection + d ⊙ u). Same arguments as
    :func:`fused_s5_qat_plain`; u, λ, d float32, the weights int8 / int16
    / float32, every tensor on one CUDA device, ``qat_scale`` a one-element
    float32 tensor or None."""
    a_bits, act_bits = qat_scan._check_bits(qat_bits)
    qat_scan._check_requant(block_requant)
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, H), got {tuple(u.shape)}")
    b, length, h = u.shape
    p = w_b.shape[-1] // 2
    plan, rows = qat_plan(u, w_b, block_t) if b and length else (None,) * 2
    t = check_tensors(
        {"u": (u, (b, length, h)), "lam_re": (lam[0], (p,)),
         "lam_im": (lam[1], (p,)), "d": (d, (h,))}, u.device)
    amax_ptr = None
    if qat_scale is not None:
        amax = qat_scale.reshape(()).contiguous()
        _check_f32_cuda("qat_scale", amax, u.device)
        amax_ptr = amax.data_ptr()
    ops = engine_layer.MixerOps((t["lam_re"], t["lam_im"]),
                                w_b.detach().contiguous(),
                                w_c.detach().contiguous(), t["d"], wb_scales,
                                wc_scales)
    lp = engine_layer.pack_mixer(ops, u.device)
    y = torch.empty((b, length, h), dtype=torch.float32, device=u.device)
    if plan is None:
        return y
    tables, cbuf, sync = qat_scan.call_buffers(plan, u.device)
    scratch = engine_layer.alloc_scratch(rows, u.device)
    err = build.entry("qat_scan", "fused_s5_qat_run", _QAT_ARGS)(
        t["u"].data_ptr(), y.data_ptr(), ctypes.byref(lp), int(relu_state),
        amax_ptr, tables.data_ptr(), plan.num_passes, cbuf.data_ptr(),
        sync.data_ptr(), scratch["bu"].data_ptr(), b, length, h, plan.t,
        plan.cpc, a_bits or 0, act_bits, *qat_scan.requant_args(
            block_requant),
        torch.cuda.current_stream(u.device).cuda_stream)
    build.check(err, "fused_s5_qat")
    count("fused_s5_qat")
    return y


def fused_s5_qat(u, lam: Pair, w_b, w_c, d, qat_bits: QatBits,
                 block_t: int, relu_state: bool = False,
                 qat_scale: Optional[torch.Tensor] = None, *,
                 wb_scales: Scales = None, wc_scales: Scales = None,
                 block_requant: Optional[BlockRequant] = None
                 ) -> torch.Tensor:
    """The mixer in its QAT mode, (B, L, H) -> (B, L, H): the states of
    ``bu = u @ w_b`` (times the per-half ``wb_scales`` of int8 / int16
    weights) through the QAT scan (``qat_scan.py``: per-block fake-quant
    to ``qat_bits`` (a_bits, act_bits) over time blocks of ``block_t``, L
    padded with zero rows to a multiple of the block; with
    ``block_requant`` every state then on that frozen grid), relu if
    ``relu_state``, then ``[x_re x_im] * wc_scales @ w_c + d ⊙ u``.
    ``qat_scale``: one global state absmax for every in-scan fake-quant
    (the global-scale QAT mode), else per-block scales.

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    version."""
    fn = fused_s5_qat_cuda if u.is_cuda else fused_s5_qat_plain
    return fn(u, lam, w_b, w_c, d, qat_bits, block_t, relu_state, qat_scale,
              wb_scales=wb_scales, wc_scales=wc_scales,
              block_requant=block_requant)


# ------------------------------------------------ engine modes and K4b

def engine_block(block_t: int, length: int) -> int:
    """The time block of the mixer at sequence length ``length``: the JAX
    kernel's ``min(block_t, ceil8(L))``. Only multiples of it inside the
    sequence are block ends, so it requantizes where ``block_t`` would."""
    if block_t < 1:
        raise ValueError(f"block_t {block_t}")
    return min(block_t, -(-length // 8) * 8)


def _engine_args(u, w_b, block_t: int, carry):
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, H), got {tuple(u.shape)}")
    t = engine_block(block_t, max(u.shape[1], 1))
    if carry is not None and u.shape[1] % t:
        raise ValueError(
            f"the carried mixer needs L divisible by the time block "
            f"(L={u.shape[1]}, block={t}); pad or re-chunk the input")
    if u.shape[-1] != w_b.shape[0]:
        raise ValueError(f"u width {u.shape[-1]}, W_b {tuple(w_b.shape)}")
    return t


def fused_s5_engine_plain(u, lam: Pair, w_b, w_c, d, *, block_t: int,
                          wb_scales: Scales = None, wc_scales: Scales = None,
                          block_requant: Optional[BlockRequant] = None,
                          relu_state: bool = False,
                          carry: Optional[Pair] = None,
                          frags: Optional[Pair] = None):
    """Plain PyTorch version of :func:`fused_s5_engine`: the mixer block by
    block (``engine_layer.mixer_plain``), the recurrence step by step; its
    products are float dots whatever ``frags`` holds."""
    t = _engine_args(u, w_b, block_t, carry)
    ops = engine_layer.MixerOps(lam, w_b, w_c, d, wb_scales, wc_scales,
                                block_requant)
    z = u.to(torch.float32)
    p = w_b.shape[-1] // 2
    state = carry
    if state is None:
        zero = torch.zeros((u.shape[0], p), dtype=torch.float32,
                           device=u.device)
        state = (zero, zero)
    ys = []
    for s in range(0, u.shape[1], t):
        y, state = engine_layer.mixer_plain(z[:, s:s + t], ops, relu_state,
                                            state)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else z.new_empty(z.shape)
    return y if carry is None else (y, state)


@traced("kernel.fused_s5_engine")
def fused_s5_engine_cuda(u, lam: Pair, w_b, w_c, d, *, block_t: int,
                         wb_scales: Scales = None, wc_scales: Scales = None,
                         block_requant: Optional[BlockRequant] = None,
                         relu_state: bool = False,
                         carry: Optional[Pair] = None,
                         frags: Optional[Pair] = None):
    """Enqueue the kernel's passes. Same arguments and results as
    :func:`fused_s5_engine_plain`; u float32 or bfloat16, weights int8 /
    int16 / float32, every tensor on ``u``'s CUDA device; ``frags`` the
    tensor cores' fragments of int8 ``w_b`` and ``w_c``
    (``engine_layer.attach_fragments``: the layer's ``wb_frags``,
    ``wc_frags``), which put their products on the tensor cores."""
    t = _engine_args(u, w_b, block_t, carry)
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"u dtype {u.dtype}: float32 or bfloat16")
    wb_f, wc_f = frags or (None, None)
    ops = engine_layer.MixerOps(lam, w_b, w_c, d, wb_scales, wc_scales,
                                block_requant, wb_frags=wb_f, wc_frags=wc_f)
    out = _launch(u, ops, relu_state, t, carry)
    if u.shape[0] and u.shape[1]:
        count("fused_s5_engine" if carry is None else "fused_s5_engine_carry")
    return out


def fused_s5_engine(u, lam: Pair, w_b, w_c, d, *, block_t: int,
                    wb_scales: Scales = None, wc_scales: Scales = None,
                    block_requant: Optional[BlockRequant] = None,
                    relu_state: bool = False, carry: Optional[Pair] = None,
                    frags: Optional[Pair] = None):
    """The serving engine's mixer, (B, L, H) f32 or bf16 -> (B, L, H) f32,
    or with ``carry`` ((B, P) pair) -> (y, new carry); with a carry L must
    be a multiple of the time block :func:`engine_block`. ``w_b`` (H, 2P)
    and ``w_c`` (2P, H) are int8 / int16 with the per-half scales
    ``wb_scales`` / ``wc_scales`` (the conj-sym factor folded into the
    latter), or float32 without. ``block_requant`` (s_re, s_im, bits) puts
    every state on its frozen grid and the carry on it at every block end.
    ``frags``: see :func:`fused_s5_engine_cuda`.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    fn = fused_s5_engine_cuda if u.is_cuda else fused_s5_engine_plain
    return fn(u, lam, w_b, w_c, d, block_t=block_t, wb_scales=wb_scales,
              wc_scales=wc_scales, block_requant=block_requant,
              relu_state=relu_state, carry=carry, frags=frags)
