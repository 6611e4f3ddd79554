"""The last two modes of the whole-layer tail kernels (K2, K3a, K3b): the
non-affine mode of a prenorm LayerNorm layer (the normed ``z`` and the raw
``skip`` as two streams, ``g_z`` and ``g_skip`` back) and bfloat16 streams
(``train_stream_dtype="bfloat16"``). The port's plain versions, layers,
models and train steps against the JAX package's at a small size: the same
numpy inputs and flax weights through both, the JAX kernels in interpret
mode with an explicit ``block_t``. Dropout is 0 where models are compared:
the two frameworks draw different masks from the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.models.seq_model import RegressionModel as JaxRegression
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import \
    blocked_dplr_init as jax_blocked_dplr_init
from sparsernns_tpu.ops.pallas.fused_layer_train import (
    fused_layer_tail, fused_layer_tail_diff)
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.models.seq_model import StackedEncoderModel
from sparsernns_tpu_torch.ops.cuda import layer_tail as lt
from sparsernns_tpu_torch.ops.cuda import layer_tail_bwd as lb
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.steps import make_ndns_train_step
from sparsernns_tpu_torch.utils.trace import launch_counts
from sparsernns_tpu_torch.weights import from_flax, to_flax
from tests.test_torch_train import (D_IO, audio_batch, jax_features, leaves,
                                    small_config, torch_features)

B, L, H, P = 2, 37, 16, 8
BLOCK_T = 16
ACT_SETS = [("gelu", False, False), ("relu", True, True)]
GLUS = ["full", "half1", "half2", "none"]
#: the inputs of LayerTailFn in its order, ``skip`` last
NAMES = ("x", "lam_re", "lam_im", "w_b", "w_c", "d", "nw", "nb", "o2k",
         "o2b", "o1k", "o1b", "m1", "m2", "skip")


def _operands(seed, glu, affine=False):
    """name -> numpy array (None where the mode or the GLU variant has no
    such operand), plus the output cotangent ``g``. Non-affine mode: ``x``
    is the normed stream z, ``skip`` the residual."""
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


def _bf16_streams(ops):
    """The streams rounded to bfloat16 (as float32 numpy, exactly)."""
    out = dict(ops)
    for k in ("x", "skip"):
        if out[k] is not None:
            out[k] = np.asarray(jnp.asarray(out[k], jnp.bfloat16),
                                np.float32)
    return out


def _torch_ops(ops, requires_grad=False, dtype=torch.float32):
    t = {}
    for k, v in ops.items():
        if v is None:
            t[k] = None
            continue
        a = torch.from_numpy(v)
        if k in ("x", "skip"):
            a = a.to(dtype)
        t[k] = a.requires_grad_(requires_grad)
    return t


def _jax_ops(ops, dtype=jnp.float32):
    return {k: None if v is None else
            jnp.asarray(v, dtype if k in ("x", "skip") else jnp.float32)
            for k, v in ops.items()}


def _plain_forward(t, act, glu, relu_state, layer_relu):
    return lt.layer_tail_plain(
        t["x"], (t["lam_re"], t["lam_im"]), t["w_b"], t["w_c"], t["d"],
        t["nw"], t["nb"], t["o2k"], t["o2b"], t["o1k"], t["o1b"], act=act,
        glu=glu, relu_state=relu_state, layer_relu=layer_relu, m1=t["m1"],
        m2=t["m2"], skip=t["skip"])


def _jax_forward(j, act, glu, relu_state, layer_relu, diff=False):
    args = (j["x"], j["skip"], (j["lam_re"], j["lam_im"]), j["w_b"],
            j["w_c"], j["d"], j["o2k"], j["o2b"], j["o1k"], j["o1b"], j["m1"],
            j["m2"], j["nw"], j["nb"])
    if diff:
        return fused_layer_tail_diff(*args, BLOCK_T, act, glu, relu_state,
                                     layer_relu)
    return fused_layer_tail(*args, block_t=BLOCK_T, act=act, glu=glu,
                            relu_state=relu_state, layer_relu=layer_relu)


def _bf16_ulp(ref):
    """One bfloat16 ulp at each element of ``ref`` (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(ref, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_within_one_ulp(out, ref, name):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    ulp = _bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))
    bad = np.abs(out - ref) > ulp
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(out - ref)[bad].max()))


@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", GLUS)
def test_non_affine_forward_matches_pallas(glu, act, relu_state,
                                           layer_relu):
    """K2's plain version in non-affine mode, with dropout masks, vs
    ``fused_layer_tail(z, skip, ...)``. atol 1e-4: f32 products summed in
    another order, values O(10)."""
    ops, _ = _operands(21, glu)
    ref = np.asarray(_jax_forward(_jax_ops(ops), act, glu, relu_state,
                                  layer_relu))
    out = _plain_forward(_torch_ops(ops), act, glu, relu_state, layer_relu)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    # the residual is skip, not the normed stream
    moved = dict(_torch_ops(ops), skip=torch.from_numpy(ops["skip"]) + 1.0)
    assert not torch.allclose(
        out, _plain_forward(moved, act, glu, relu_state, layer_relu))


def _fn_grads(t, g, act, glu, relu_state, layer_relu):
    """Gradients of sum(out * g) through LayerTailFn, by operand name, and
    the output. ``t``: torch operands that require grad."""
    before = launch_counts()
    out = lt.LayerTailFn.apply(*(t[n] for n in NAMES[:-1]), act, glu,
                               relu_state, layer_relu, t["skip"])
    live = [n for n in NAMES if t[n] is not None]
    grads = torch.autograd.grad((out.float() * g).sum(),
                                [t[n] for n in live])
    # CPU tensors launch no kernel
    assert launch_counts() == before
    return out, {n: v for n, v in zip(live, grads)}


def _jax_grads(ops, g, act, glu, relu_state, layer_relu,
               dtype=jnp.float32):
    """(out, gradients by name) of sum(out * g) through
    ``fused_layer_tail_diff``, its Pallas adjoint kernel."""
    live = [n for n in NAMES if ops[n] is not None]
    j = _jax_ops(ops, dtype)
    gj = jnp.asarray(g)

    def loss(*args):
        full = dict.fromkeys(NAMES)
        full.update(zip(live, args))
        out = _jax_forward(full, act, glu, relu_state, layer_relu,
                           diff=True)
        return jnp.sum(out.astype(jnp.float32) * gj), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(live))), has_aux=True)(
            *(j[n] for n in live))
    return out, dict(zip(live, grads))


@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", GLUS)
def test_non_affine_fn_gradients_match_jax(glu, act, relu_state, layer_relu):
    """LayerTailFn's gradient of every input in non-affine mode (z, skip, λ,
    weights, masks; none for nw / nb) vs ``jax.grad`` through
    ``fused_layer_tail_diff`` (its adjoint kernel). rtol = atol = 2e-4, the
    JAX package's own bar between its kernel and its XLA backward."""
    ops, g = _operands(22, glu)
    _, ref = _jax_grads(ops, g, act, glu, relu_state, layer_relu)
    _, out = _fn_grads(_torch_ops(ops, True), torch.from_numpy(g), act, glu,
                       relu_state, layer_relu)
    assert set(out) == set(ref) and "skip" in out and "nw" not in out
    for n, r in ref.items():
        np.testing.assert_allclose(out[n].numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4, err_msg=n)


@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", GLUS)
def test_non_affine_plain_adjoint_matches_autograd(glu, act, relu_state,
                                                   layer_relu):
    """The explicit adjoint (K3b's plain version) in non-affine mode vs
    torch.autograd through K2's plain version. 1e-5 relative to max(1,
    |ref|): the same f32 arithmetic in another association."""
    ops, g = _operands(23, glu)
    gt = torch.from_numpy(g)
    _, out = _fn_grads(_torch_ops(ops, True), gt, act, glu, relu_state,
                       layer_relu)
    t = _torch_ops(ops, True)
    live = [n for n in NAMES if t[n] is not None]
    y = _plain_forward(t, act, glu, relu_state, layer_relu)
    ref = torch.autograd.grad((y * gt).sum(), [t[n] for n in live])
    for n, r in zip(live, ref):
        r = r.numpy()
        np.testing.assert_allclose(out[n].numpy(), r, rtol=0, err_msg=n,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("affine", [False, True], ids=["z_skip", "affine"])
@pytest.mark.parametrize("glu,act,relu_state,layer_relu",
                         [("half1", "gelu", False, False),
                          ("full", "relu", True, True)])
def test_bf16_streams_match_jax(glu, act, relu_state, layer_relu, affine):
    """bf16 streams in both modes: the plain forward and LayerTailFn's
    gradients vs the JAX kernels on the same bf16 streams. The output and
    the stream gradients (``g_x``, ``g_skip``) are bf16 and within one bf16
    ulp of JAX's (both compute in f32 and round once); the weight gradients
    stay float32, rtol = atol 2e-4."""
    ops, g = _operands(24, glu, affine=affine)
    ops = _bf16_streams(ops)
    ref_out, ref = _jax_grads(ops, g, act, glu, relu_state, layer_relu,
                              dtype=jnp.bfloat16)
    assert ref_out.dtype == jnp.bfloat16
    out, grads = _fn_grads(_torch_ops(ops, True, torch.bfloat16),
                           torch.from_numpy(g), act, glu, relu_state,
                           layer_relu)
    assert out.dtype == torch.bfloat16
    _assert_within_one_ulp(out.float().detach().numpy(),
                           np.asarray(ref_out, np.float32), "out")
    for n, r in ref.items():
        o = grads[n]
        if n in ("x", "skip"):
            assert o.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, n
            _assert_within_one_ulp(o.float().numpy(),
                                   np.asarray(r, np.float32), n)
        else:
            assert o.dtype == torch.float32, n
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-4,
                                       atol=2e-4, err_msg=n)


def test_plain_history_and_wrapper_checks_of_the_new_modes():
    """K3a's plain version in non-affine mode is the affine one on the
    normed stream; the wrappers refuse a mixed mode, mixed stream dtypes
    and bf16 weights before anything launches."""
    ops, g = _operands(25, "half1", affine=True)
    t = _torch_ops(ops)
    lam = (t["lam_re"], t["lam_im"])
    z = t["x"] * t["nw"] + t["nb"]
    for a, b in zip(lb.layer_tail_hist_plain(z, lam, t["w_b"], None, None),
                    lb.layer_tail_hist_plain(t["x"], lam, t["w_b"], t["nw"],
                                             t["nb"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    args = (lam, t["w_b"], t["w_c"], t["d"])
    kw = dict(glu="half1", o2k=t["o2k"], o2b=t["o2b"])
    skip = torch.from_numpy(g)
    with pytest.raises(ValueError, match="non-affine"):
        lt.layer_tail_cuda(t["x"], *args, t["nw"], t["nb"], skip=skip, **kw)
    with pytest.raises(ValueError, match="affine mode"):
        lt.layer_tail_plain(t["x"], *args, None, None, **kw)
    with pytest.raises(ValueError, match="skip"):       # one stream dtype
        lt.layer_tail_cuda(t["x"].bfloat16(), *args, None, None,
                           skip=skip, **kw)
    with pytest.raises(ValueError, match="g"):
        lb.layer_tail_bwd_cuda(t["x"].bfloat16(), skip, *args, t["nw"],
                               t["nb"], **kw)
    with pytest.raises(ValueError, match="w_b"):        # weights stay f32
        lt.layer_tail_cuda(t["x"], lam, t["w_b"].bfloat16(), t["w_c"],
                           t["d"], t["nw"], t["nb"], **kw)
    with pytest.raises(ValueError, match="x"):
        lt.layer_tail_cuda(t["x"].half(), *args, t["nw"], t["nb"], **kw)
    with pytest.raises(ValueError, match="nw and nb"):
        lb.layer_tail_hist_cuda(t["x"], lam, t["w_b"], t["nw"], None)


# ---------------------------------------------------------------- models --


def jax_model(cfg, training: bool, stream_dtype: str = "float32",
              block_t: int = BLOCK_T):
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"],
        v=init["V"], vinv=init["Vinv"], c_init=cfg.C_init,
        discretization=cfg.discretization, clip_eigs=cfg.clip_eigs,
        relufication=cfg.relufication, scan_mode=cfg.scan_mode,
        block_t=block_t)
    return JaxRegression(
        mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_output=D_IO, dropout=cfg.p_dropout, prenorm=cfg.prenorm,
        batchnorm=cfg.batchnorm, bn_momentum=cfg.bn_momentum,
        glu_variant=cfg.glu_variant, training=training,
        relufication=cfg.relufication, stream_dtype=stream_dtype)


def paired(cfg, seed: int, training: bool = True):
    """(jax model, its variables as numpy with random BatchNorm statistics
    and a non-trivial norm affine, the port's model on the CPU with the
    same weights)."""
    jm = jax_model(cfg, training, cfg.train_stream_dtype if training
                   else "float32")
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, D_IO), jnp.float32)))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32),
        variables.get("batch_stats", {}))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.2 * rng.randn(*a.shape).astype(np.float32)
                         if path[-2].key == "norm" else a),
        variables["params"])
    tm = loop.build_model(cfg, D_IO, D_IO, training=training, device="cpu",
                          seed=seed)
    tm.load_state_dict(from_flax(params, stats))
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return jm, variables, tm


def _counting(monkeypatch):
    """Patch the tail kernels' plain versions with counting wrappers;
    returns the counts (name -> calls)."""
    counts = {"fwd": 0, "bwd": 0}

    def wrap(mod, name, key):
        orig = getattr(mod, name)

        def counted(*args, **kw):
            counts[key] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(lt, "layer_tail_plain", "fwd")
    wrap(lb, "layer_tail_bwd_plain", "bwd")
    return counts


@pytest.mark.parametrize("glu", ["half1", "full"])
def test_layernorm_layers_take_the_tail_and_match_jax(glu, monkeypatch):
    """A prenorm LayerNorm model runs every layer through LayerTailFn in
    non-affine mode, in eval and in training (forward and backward), and
    its outputs match the JAX model's (which runs its non-affine kernel):
    1e-4, the bar of the eval forward."""
    cfg = small_config(batchnorm=False, glu_variant=glu,
                       relufication=glu == "full")
    counts = _counting(monkeypatch)
    x = np.random.RandomState(31).randn(2, 37, D_IO).astype(np.float32)
    for training in (False, True):
        jm, variables, tm = paired(cfg, seed=30, training=training)
        layer = tm.encoder.layers[0]
        assert isinstance(layer.norm, torch.nn.LayerNorm)
        assert layer.takes_tail() and tm.training == training
        ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
        counts.update(fwd=0, bwd=0)
        out = tm(torch.from_numpy(x))
        assert counts == {"fwd": cfg.n_layers, "bwd": 0}, counts
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4,
                                   rtol=0)
    out.sum().backward()
    assert counts == {"fwd": cfg.n_layers, "bwd": cfg.n_layers}, counts
    assert all(p.grad is not None for p in tm.parameters())
    # streaming stays on the unfused route (the mixer with a carry)
    counts.update(fwd=0, bwd=0)
    tm.eval()
    with torch.no_grad():
        tm.forward_stream(torch.from_numpy(x[:, :10]))
    assert counts == {"fwd": 0, "bwd": 0}


def _three_steps(cfg, seed):
    """Losses of three train steps of the port and of JAX's
    ``make_ndns_train_step`` from the same weights, and the two models."""
    jm, variables, tm = paired(cfg, seed=seed)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay, total_steps=cfg.epochs,
        warmup_steps=cfg.warmup_end)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=tx,
        batch_stats=variables.get("batch_stats", {}))
    state = loop.create_run_state(cfg, tm, 1)
    jstep = jax_train_step(jm, batchnorm=cfg.batchnorm)
    step = make_ndns_train_step(tm)
    ours, theirs = [], []
    for i in range(3):
        noisy, clean = audio_batch(2, seed=40 + i)
        jstate, jm_metrics = jstep(jstate, jax.random.PRNGKey(0),
                                   *jax_features(noisy, clean))
        state, metrics = step(state, *torch_features(noisy, clean))
        ours.append(metrics["loss"].item())
        theirs.append(float(jm_metrics["loss"]))
    return np.asarray(ours), np.asarray(theirs), jstate, tm


@pytest.mark.parametrize("name,kw", [
    ("layernorm", dict(batchnorm=False)),
    ("bf16_stream", dict(train_stream_dtype="bfloat16")),
])
def test_three_train_steps_match_jax(name, kw, monkeypatch):
    """Three optimizer steps of a prenorm LayerNorm model and of a
    BatchNorm model on a bf16 stream, against JAX's train step with the
    same weights: losses rtol 2e-3 (the JAX package's own bar between its
    bf16 and f32 streams), every layer on the tail kernels each step."""
    cfg = small_config(**kw)
    counts = _counting(monkeypatch)
    ours, theirs, jstate, tm = _three_steps(cfg, seed=41)
    assert counts == {"fwd": 3 * cfg.n_layers, "bwd": 3 * cfg.n_layers}
    np.testing.assert_allclose(ours, theirs, rtol=2e-3)
    expect = torch.bfloat16 if name == "bf16_stream" else torch.float32
    tm.train()
    assert tm.encoder._stream_dtype() == expect
    params, stats = to_flax(tm)
    if cfg.batchnorm:
        # running statistics moved as JAX's (summed in f32 from the stream)
        for key, ref in leaves(jax.device_get(jstate.batch_stats)).items():
            np.testing.assert_allclose(leaves(stats)[key], ref, rtol=0,
                                       atol=1e-3, err_msg=key)


def test_bf16_stream_reaches_only_bf16_eligible_stacks():
    """The bf16 stream is a training-mode stream of stacks whose every
    layer takes the tail with BatchNorm: eval mode, LayerNorm and postnorm
    models keep float32, as the JAX package uses the stream dtype only on
    its padded-stream path; the output is float32 either way."""
    x = torch.randn(1, 8, D_IO)
    for kw, expect in ((dict(), torch.bfloat16),
                       (dict(batchnorm=False), torch.float32),
                       (dict(prenorm=False), torch.float32),
                       (dict(bidirectional=True), torch.float32)):
        tm = loop.build_model(small_config(train_stream_dtype="bfloat16",
                                           **kw), D_IO, D_IO,
                              training=True, device="cpu")
        assert tm.encoder.stream_dtype == "bfloat16"
        assert tm.encoder._stream_dtype() == expect, kw
        assert tm(x).dtype == torch.float32
        tm.eval()
        assert tm.encoder._stream_dtype() == torch.float32
    # an eval model is built on float32, as the JAX package builds it
    ev = loop.build_model(small_config(train_stream_dtype="bfloat16"), D_IO,
                          D_IO, device="cpu")
    assert ev.encoder.stream_dtype == "float32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_moments_save_the_stream_as_it_is(dtype):
    """The BatchNorm statistics of the whole-layer route: E[x] and E[x²] in
    float32 and their gradient equal autograd's through ``x.float()``, bit
    for bit, while the backward keeps only the stream itself (no f32 copy
    of a bf16 stream)."""
    from sparsernns_tpu_torch.models.layers import StreamMoments
    gen = torch.Generator().manual_seed(60)
    x = torch.randn(3, 50, 7, generator=gen).to(dtype).requires_grad_()
    g_mean, g_sq = torch.randn(7, generator=gen), torch.randn(7, generator=gen)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.dtype) or t, lambda t: t):
        mean, sq = StreamMoments.apply(x)
    assert saved == [dtype] and mean.dtype == sq.dtype == torch.float32
    grad, = torch.autograd.grad((mean * g_mean).sum() + (sq * g_sq).sum(), x)
    ref_x = x.detach().clone().requires_grad_()
    xf = ref_x.float()
    ref_mean, ref_sq = xf.mean(dim=(0, 1)), (xf * xf).mean(dim=(0, 1))
    ref, = torch.autograd.grad(
        (ref_mean * g_mean).sum() + (ref_sq * g_sq).sum(), ref_x)
    assert torch.equal(mean, ref_mean) and torch.equal(sq, ref_sq)
    assert grad.dtype == dtype and torch.equal(grad, ref)


def test_train_stream_dtype_refusals():
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="stream dtype"):
            loop.build_model(small_config(train_stream_dtype=bad), D_IO,
                             D_IO, training=True, device="cpu")
        with pytest.raises(ValueError, match="stream dtype"):
            loop.build_model(small_config(train_stream_dtype=bad), D_IO,
                             D_IO, device="cpu")
    with pytest.raises(ValueError, match="stream dtype"):
        StackedEncoderModel(lambda: None, D_IO, 0, 16,
                            stream_dtype="float64")


def test_running_statistics_match_jax_padded_path_at_constant_features():
    """JAX's whole-layer BatchNorm step (its padded-stream path) moves the
    running variance by the unclamped E[x²] − E[x]²; the port's
    ``batch_affine`` does the same. Features of constant value are the
    real case of a tile-pruned encoder (columns of the encoder's kernel all
    zero, so the layer input there is the bias): the running statistics of
    one training forward match JAX's at 1e-6. From a running variance of 0
    there, a batch variance that rounds below 0 leaves a negative running
    variance, as in JAX (a clamp would leave 0)."""
    cfg = small_config(n_layers=1)
    jm, variables, tm = paired(cfg, seed=50)
    rng = np.random.RandomState(51)
    enc = variables["params"]["encoder"]["encoder"]
    enc["kernel"] = enc["kernel"].copy()
    enc["kernel"][:, 8:] = 0.0
    enc["bias"] = rng.uniform(-3.0, 3.0, cfg.d_model).astype(np.float32)
    norm = variables["batch_stats"]["encoder"]["layers_0"]["norm"]
    norm["var"] = norm["var"].copy()
    norm["var"][8:] = 0.0
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    x = rng.randn(2, 37, D_IO).astype(np.float32)
    _, mod = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    layer = tm.encoder.layers[0]
    old = layer.norm.running_var.clone()
    seen = {}
    layer.register_forward_pre_hook(
        lambda m, args: seen.update(x=args[0].detach().clone()))
    tm(torch.from_numpy(x))
    _, stats = to_flax(tm)
    ref = leaves(mod["batch_stats"])
    for key, val in leaves(stats).items():
        np.testing.assert_allclose(val, ref[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    u = seen["x"]
    assert torch.equal(u[..., 8:], u[:1, :1, 8:].expand_as(u[..., 8:]))
    mean = u.mean(dim=(0, 1))
    var = (u * u).mean(dim=(0, 1)) - mean * mean
    mom = cfg.bn_momentum
    moved = layer.norm.running_var
    torch.testing.assert_close(moved, mom * old + (1 - mom) * var,
                               rtol=1e-6, atol=1e-12)
    negative = var[8:] < 0
    assert negative.any()           # rounding, at these seeds
    assert (moved[8:][negative] < 0).all()
