"""How the time-parallel backward of the whole-layer tail (K3a, K3b) cuts
its work: the chunk plan of the product passes, the slices of the
weight-gradient products, the scratch between the passes, and the plain
mirror of the passes (the same arrays and partial sums as the kernels,
reduced as the CUDA wrapper reduces them) against the plain adjoint and
against the JAX package's ``fused_tail_bwd`` in interpret mode with an
explicit ``block_t``. Inputs are made with numpy from a seed and handed to
both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsernns_tpu.ops.pallas.fused_layer_bwd import fused_tail_bwd
from sparsernns_tpu_torch.ops.cuda import layer_tail_bwd as lb
from sparsernns_tpu_torch.ops.cuda.layer_tail import norm_and_residual
from sparsernns_tpu_torch.ops.scan import sequential_diag_scan

#: long enough for three chunks of 128 rows (the last one ragged) and five
#: weight-gradient slices
B, L, H, P = 2, 300, 16, 8
BLOCK_T = 64
ACT_SETS = [("gelu", False, False), ("relu", True, True)]
GLUS = ["full", "half1", "half2", "none"]
OUTPUTS = ("g_x", "g_skip", "d_lam", "d_w_b", "d_w_c", "d_d", "d_o2k",
           "d_o2b", "d_o1k", "d_o1b", "d_m1", "d_m2", "d_nw", "d_nb")
SMS = 132   # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("batch,length", [(1, 37), (3, 70), (2, 300),
                                          (8, 3751), (32, 3751)])
def test_chunks_cover_every_tile_once_in_order(batch, length):
    """The chunks of a batch row run over its steps in order, back to back;
    every 32-row history tile, the ragged last one too, lies in exactly
    one chunk; chunk ``b * chunks_per_row + i`` is the i-th of row b."""
    plan = lb.bwd_plan(batch, length)
    chunks = plan.chunks()
    assert len(chunks) == plan.n_chunks == batch * plan.chunks_per_row
    for b in range(batch):
        mine = chunks[b * plan.chunks_per_row:(b + 1) * plan.chunks_per_row]
        assert all(c[0] == b for c in mine)
        assert [c[1] for c in mine] == [0] + [c[2] for c in mine[:-1]]
        assert mine[-1][2] == length
        assert all(0 < t1 - t0 <= plan.chunk for _, t0, t1 in mine)
        for t0 in range(0, length, lb.HIST_BLOCK):
            t1 = min(t0 + lb.HIST_BLOCK, length)
            assert sum(c0 <= t0 and t1 <= c1 for _, c0, c1 in mine) == 1


@pytest.mark.parametrize("batch,length", [(1, 37), (3, 70), (2, 300),
                                          (8, 3751), (32, 3751)])
def test_slices_cover_every_row_once(batch, length):
    """The weight-gradient slices run over the B * L rows back to back, in
    whole chunks of rows, about WGRAD_SPLITS of them."""
    plan = lb.bwd_plan(batch, length)
    splits = plan.splits()
    assert len(splits) == plan.n_splits
    assert [s[0] for s in splits] == [0] + [s[1] for s in splits[:-1]]
    assert splits[-1][1] == batch * length
    assert plan.split_rows % plan.chunk == 0
    assert plan.n_splits <= lb.WGRAD_SPLITS


def test_the_grid_fills_the_card_at_b8():
    """At the recipe's length, B = 8 already gives every product pass of
    K3a and K3b a CTA per chunk and column tile, more chunks than the card
    has SMs, and the weight-gradient products more slices than B. (The
    grids that launch are read back from the CUDA source on the card.)"""
    plan = lb.bwd_plan(8, 3751)
    assert plan.n_chunks == 8 * 30 == 240 >= SMS
    assert 8 < plan.n_splits <= lb.WGRAD_SPLITS
    assert plan.split_rows == 640
    assert lb.bwd_plan(1, 3751).n_chunks == 30


@pytest.mark.parametrize("batch,length", [(8, 3751), (32, 3751), (3, 70)])
def test_the_plan_is_a_pure_function_of_b_and_l(batch, length):
    """Two calls give the same plan (so the same order of every partial
    sum); another (B, L) another one where the rows differ."""
    first, again = lb.bwd_plan(batch, length), lb.bwd_plan(batch, length)
    assert first == again and hash(first) == hash(again)
    assert first.chunks() == again.chunks()
    assert first.splits() == again.splits()
    assert lb.bwd_plan(batch + 1, length) != first
    with pytest.raises(ValueError, match="empty"):
        lb.bwd_plan(batch, 0)


@pytest.mark.parametrize("glu,extra_h", [("half1", 0), ("half2", 0),
                                         ("full", 1), ("none", -4)])
def test_scratch_at_the_recipe_batch(glu, extra_h):
    """Bytes between the passes at B = 32, L = 3751, H = 192, P = 128: the
    states and v (2P wide), four H-wide arrays and GS (2H) for half1 and
    half2; the full GLU's base one more H-wide array; no GLU neither
    y, x1d nor GS. The partial sums are small beside them."""
    plan = lb.bwd_plan(32, 3751)
    rows = 32 * 3751
    h_wide, p_wide = rows * 192 * 4, rows * 256 * 4
    assert p_wide == 122_912_768 and h_wide == 92_184_576
    shapes = lb.scratch_shapes(plan, 192, 128, glu)
    nbytes = {k: 4 * int(np.prod(v)) for k, v in shapes.items()}
    arrays = sum(nbytes.get(k, 0) for k in
                 ("S", "Y", "X1D", "F", "G", "GS", "GY", "V"))
    assert arrays == 2 * p_wide + (6 + extra_h) * h_wide
    partials = sum(nbytes.values()) - arrays
    assert 0 < partials < 0.1 * arrays
    assert shapes["vec"] == (32 * 30, len(lb.VEC_SLOTS), 192)
    assert shapes["dwc"] == (plan.n_splits, 256, 192)
    if glu == "half1":
        assert arrays == 798_932_992      # the source's header note


def passes_mirror(x, g, lam, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
                  o1k=None, o1b=None, act="gelu", glu="none",
                  relu_state=False, layer_relu=False, m1=None, m2=None,
                  skip=None):
    """Plain mirror of K3a + K3b's passes: the arrays of
    ``lb.scratch_shapes``, the partial sums per chunk, per slice and per
    batch row that the kernels write, and ``lb.reduce_partials``. Same
    arguments and result as ``lb.layer_tail_bwd_plain``, up to the order
    of the sums."""
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    plan = lb.bwd_plan(b, l)
    z, res = norm_and_residual(x, nw, nb, skip)
    bu = z @ w_b
    xs, _ = sequential_diag_scan(lam, (bu[..., :p], bu[..., p:]))
    s = torch.cat(xs, dim=-1)                            # K3a
    s_act = torch.relu(s) if relu_state else s
    y = s_act @ w_c + d * z                              # proj
    x1, dact = lb._act_and_grad(y, act)
    x1d = x1 * m1 if m1 is not None else x1
    gv = g.float()
    sums = {}
    if glu == "none":
        if layer_relu:
            gv = gv * ((x1d + res) > 0)
        g_x1d = gv
    else:
        base = {"half1": x1d, "half2": y}.get(glu)
        if base is None:
            base = x1d @ o1k + o1b                       # base
        gate = torch.sigmoid(x1d @ o2k + o2b)            # gate
        hg = base * gate
        if layer_relu:
            gv = gv * (((hg * m2 if m2 is not None else hg) + res) > 0)
        sums["m2"] = gv * hg
        g_h = gv * m2 if m2 is not None else gv
        g_base = g_h * gate
        g_s = (g_h * base) * gate * (1.0 - gate)
        sums.update(o2b=g_s, o1b=g_base)
        gs = torch.cat([g_s, g_base], dim=-1)[..., :(2 if glu == "full"
                                                     else 1) * h]
        g_x1d = g_s @ o2k.T                              # gx1d
        if glu == "half1":
            g_x1d = g_x1d + g_base
        elif glu == "full":
            g_x1d = g_x1d + g_base @ o1k.T
    sums["m1"] = g_x1d * x1
    g_y = (g_x1d * m1 if m1 is not None else g_x1d) * dact
    if glu == "half2":
        g_y = g_y + g_base
    sums["d"] = g_y * z
    g_xs = g_y @ w_c.T                                   # gxs
    if relu_state:
        g_xs = g_xs * (s > 0)
    rev = (g_xs[..., :p].flip(1), g_xs[..., p:].flip(1))  # rev
    v, _ = sequential_diag_scan((lam[0], -lam[1]), rev)
    v = (v[0].flip(1), v[1].flip(1))
    xp = [F.pad(half, (0, 0, 1, 0))[:, :-1] for half in xs]
    dlam = torch.stack([(v[0] * xp[0] + v[1] * xp[1]).sum(dim=1),
                        (v[1] * xp[0] - v[0] * xp[1]).sum(dim=1)])
    v_cat = torch.cat(v, dim=-1)
    g_zn = v_cat @ w_b.T + g_y * d                       # gz
    if skip is None:
        sums.update(nw=g_zn * res, nb=g_zn)
        g_x, g_skip = g_zn * nw + gv, None
    else:
        g_x, g_skip = g_zn, gv.to(x.dtype)
    pad = plan.chunks_per_row * plan.chunk - l
    vec = torch.zeros(plan.n_chunks, len(lb.VEC_SLOTS), h)
    for name, t in sums.items():
        vec[:, lb.VEC_SLOTS.index(name)] = F.pad(t, (0, 0, 0, pad)).view(
            b, plan.chunks_per_row, plan.chunk, h).sum(dim=2).reshape(
            plan.n_chunks, h)

    def sliced(t):
        t = t.reshape(plan.rows, -1)
        t = F.pad(t, (0, 0, 0, plan.n_splits * plan.split_rows - plan.rows))
        return t.view(plan.n_splits, plan.split_rows, -1)

    def wgrad(a, c):
        return torch.einsum("srm,srn->smn", sliced(a), sliced(c))

    parts = {"vec": vec, "dlam": dlam, "dwc": wgrad(s_act, g_y),
             "dwb": wgrad(v_cat, z)}
    if glu != "none":
        parts["dglu"] = wgrad(x1d, gs)
    return (g_x.to(x.dtype), g_skip,
            *lb.reduce_partials(plan, parts, glu, skip is None,
                             (m1 is not None, m2 is not None)))


def _operands(seed, glu, affine):
    """name -> numpy array (None where the mode or the GLU variant has no
    such operand), plus the output cotangent ``g``."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    r = rng.uniform(0.6, 0.99, P)
    th = rng.uniform(-np.pi, np.pi, P)
    mask = lambda: (rng.binomial(1, 0.8, (B, 1, H)) / 0.8  # noqa: E731
                    ).astype(np.float32)
    ops = dict(
        x=f(B, L, H), lam_re=(r * np.cos(th)).astype(np.float32),
        lam_im=(r * np.sin(th)).astype(np.float32),
        w_b=f(H, 2 * P, sc=0.3), w_c=f(2 * P, H, sc=0.3), d=f(H),
        nw=(1.0 + 0.2 * rng.randn(H)).astype(np.float32), nb=f(H, sc=0.1),
        o2k=f(H, H, sc=0.3), o2b=f(H, sc=0.1), o1k=f(H, H, sc=0.3),
        o1b=f(H, sc=0.1), m1=mask(), m2=mask(), skip=f(B, L, H))
    if affine:
        ops["skip"] = None
    else:
        ops.update(nw=None, nb=None)
    if glu == "none":
        ops.update(o2k=None, o2b=None, m2=None)
    if glu != "full":
        ops.update(o1k=None, o1b=None)
    return ops, f(B, L, H)


def _torch_call(fn, ops, g, dtype=torch.float32, **flags):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in
         ops.items()}
    for k in ("x", "skip"):
        if t[k] is not None:
            t[k] = t[k].to(dtype)
    return fn(t["x"], torch.from_numpy(g).to(dtype),
              (t["lam_re"], t["lam_im"]), t["w_b"], t["w_c"], t["d"],
              t["nw"], t["nb"], t["o2k"], t["o2b"], t["o1k"], t["o1b"],
              m1=t["m1"], m2=t["m2"], skip=t["skip"], **flags)


def _flat(outs):
    """name -> numpy array of every output that is not None."""
    res = {}
    for name, o in zip(OUTPUTS, outs):
        if o is None:
            continue
        if name == "d_lam":
            o = np.stack([np.asarray(v) for v in o])
        elif isinstance(o, torch.Tensor):
            o = o.float().numpy()
        res[name] = np.asarray(o, dtype=np.float32)
    return res


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "z_skip"])
@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", GLUS)
def test_passes_mirror_matches_plain_adjoint(glu, act, relu_state,
                                             layer_relu, affine):
    """The mirror of the passes, partial sums and all, against the plain
    adjoint: the same gradients, sums in another order. 2e-4 of max(1,
    |ref|), the bar of the card's kernels against plain."""
    ops, g = _operands(21, glu, affine)
    flags = dict(act=act, glu=glu, relu_state=relu_state,
                 layer_relu=layer_relu)
    ref = _flat(_torch_call(lb.layer_tail_bwd_plain, ops, g, **flags))
    out = _flat(_torch_call(passes_mirror, ops, g, **flags))
    assert out.keys() == ref.keys()
    assert ("g_skip" in out) != affine and ("d_nw" in out) == affine
    for name, r in ref.items():
        assert out[name].shape == r.shape, name
        np.testing.assert_allclose(out[name], r, rtol=0, err_msg=name,
                                   atol=2e-4 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "z_skip"])
@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", GLUS)
def test_passes_mirror_matches_jax_fused_tail_bwd(glu, act, relu_state,
                                                  layer_relu, affine):
    """The mirror against the JAX package's kernel backward (its two Pallas
    kernels in interpret mode, block_t 64): rtol = atol = 2e-4, the JAX
    package's bar between its adjoint kernel and its XLA backward."""
    ops, g = _operands(22, glu, affine)
    flags = dict(act=act, glu=glu, relu_state=relu_state,
                 layer_relu=layer_relu)
    out = _flat(_torch_call(passes_mirror, ops, g, **flags))
    j = {k: None if v is None else jnp.asarray(v) for k, v in ops.items()}
    ref = _flat(fused_tail_bwd(
        j["x"], j["skip"], (j["lam_re"], j["lam_im"]), j["w_b"], j["w_c"],
        j["d"], j["o2k"], j["o2b"], j["o1k"], j["o1b"], j["m1"], j["m2"],
        j["nw"], j["nb"], jnp.asarray(g), block_t=BLOCK_T, **flags))
    assert out.keys() == ref.keys()
    for name, r in ref.items():
        np.testing.assert_allclose(out[name], r.reshape(out[name].shape),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "z_skip"])
def test_passes_mirror_on_bf16_streams(affine):
    """bf16 streams: g_x and g_skip within one bf16 ulp of the plain
    adjoint's (both round once from f32 sums in different orders), the
    weight gradients at the f32 bar."""
    ops, g = _operands(23, "half1", affine)
    flags = dict(act="relu", glu="half1", relu_state=False, layer_relu=True)
    ref = _torch_call(lb.layer_tail_bwd_plain, ops, g, torch.bfloat16,
                      **flags)
    out = _torch_call(passes_mirror, ops, g,
                      torch.bfloat16, **flags)
    for name, r, o in zip(OUTPUTS, ref, out):
        if r is None:
            assert o is None, name
            continue
        if name in ("g_x", "g_skip"):
            assert o.dtype == r.dtype == torch.bfloat16, name
            ulp = torch.finfo(torch.bfloat16).eps * r.float().abs().clamp(
                min=torch.finfo(torch.bfloat16).tiny)
            bar = torch.maximum(ulp, torch.full_like(ulp, 2e-4 * max(
                1.0, r.float().abs().max().item())))
            assert ((o.float() - r.float()).abs() <= bar).all(), name
            continue
        if name == "d_lam":
            r, o = torch.stack(r), torch.stack(o)
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=0,
                                   err_msg=name,
                                   atol=2e-4 * max(1.0, r.abs().max().item()))
