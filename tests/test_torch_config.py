"""The port's run configuration, command line and static-quant finetuning
against the JAX package's, on the CPU: every shared ``RunConfig`` default
equal, ``apply_dim_scale`` equal, the generated flags parsed to equal
configurations, the straight-through ``quant_dequant`` gradient, and three
train steps of a static-quant model (scales frozen) at the bars of the
float train steps (``tests/test_torch_train.py``: loss 1e-3 relative,
parameters rtol 1e-3 + 1e-5, here with the noise allowance of
``tests/test_torch_convert.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.cli import build_parser as jax_parser
from sparsernns_tpu.quantize import static as jax_static
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.train import loop as jax_loop
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.losses import STFT_MAG_MEAN
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu.utils.config import RunConfig as JaxConfig
from sparsernns_tpu.utils.config import \
    config_from_args as jax_config_from_args
from sparsernns_tpu_torch.cli import build_parser
from sparsernns_tpu_torch.quantize import static as t_static
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.optim import create_optimizer
from sparsernns_tpu_torch.train.state import TrainState
from sparsernns_tpu_torch.train.steps import make_ndns_train_step
from sparsernns_tpu_torch.utils.config import RunConfig, config_from_args
from sparsernns_tpu_torch.weights import flat_leaves, from_flax, to_flax
from tests.test_torch_convert import assert_params_near
from tests.test_torch_train import (D_IO, audio_batch, jax_features,
                                    torch_features)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: shared fields that differ on purpose: none
DIFFER = set()


def _shared():
    ours = {f.name for f in dataclasses.fields(RunConfig)}
    theirs = {f.name for f in dataclasses.fields(JaxConfig)}
    return sorted(ours & theirs)


def test_shared_defaults_equal_jax():
    """The port's ``RunConfig`` has exactly the JAX package's fields, each
    with its default."""
    shared = _shared()
    assert {f.name for f in dataclasses.fields(RunConfig)} == set(shared) \
        == {f.name for f in dataclasses.fields(JaxConfig)}
    assert len(shared) >= 80
    ours, theirs = RunConfig(), JaxConfig()
    for name in shared:
        if name not in DIFFER:
            assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("scale", [0.5, 1.0, 1.5, 2.0, 4.5])
@pytest.mark.parametrize("blocks", [16, 2])
def test_apply_dim_scale_equals_jax(scale, blocks):
    ours = RunConfig(dim_scale=scale, blocks=blocks).apply_dim_scale()
    theirs = JaxConfig(dim_scale=scale, blocks=blocks).apply_dim_scale()
    for name in ("d_model", "ssm_size_base", "blocks", "dim_scale"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.dim_scale == 1.0


ARGVS = [
    ["train"],
    ["convert", "--bsz", "4", "--d_model", "96", "--dim_scale", "1.5"],
    ["train", "--recipe", os.path.join(ROOT, "recipes", "ndns.json"),
     "--epochs", "3", "--synthetic_data", "true"],
    ["convert", "--validate_baseline", "yes", "--train_aqt", "1",
     "--qaft_epochs", "2", "--block_t", "64", "--quant_input", "5",
     "--grad_clip_threshold", "0.5", "--pruning", "iterative-ste-mag-0.9",
     "--calibrate_quant", "false", "--topk", "0.5"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_cli_flags_parse_as_jax(argv):
    """``config_from_args(build_parser().parse_args(argv))``, with the
    recipe overlaid and ``dim_scale`` applied as both ``main``s do, equals
    JAX's on every shared field."""
    configs = []
    for parser, from_args in ((build_parser(), config_from_args),
                              (jax_parser(), jax_config_from_args)):
        args = parser.parse_args(argv)
        cfg = from_args(args)
        if args.recipe:
            cfg = cfg.with_recipe(args.recipe)
        configs.append(cfg.apply_dim_scale())
    ours, theirs = configs
    for name in _shared():
        assert getattr(ours, name) == getattr(theirs, name), name
    assert build_parser().parse_args(argv).device == "cuda"


def test_quant_dequant_gradient_is_straight_through():
    """Identity in x, zero in the scale, as ``jax.grad`` of JAX's."""
    rng = np.random.RandomState(0)
    x = (rng.randn(64) * 3).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    scale = np.float32(2.0 ** -3)

    def f(xx, ss):
        return jnp.sum(jax_static.quant_dequant(xx, ss, 0.0, 4) * w)

    gx, gs = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(scale, requires_grad=True)
    out = t_static.quant_dequant(xt, st, 0.0, 4)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    assert float(gs) == 0.0 and (st.grad is None or float(st.grad) == 0.0)
    # the value is the quant-dequant's, clipped to the 4-bit grid
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jax_static.quant_dequant(jnp.asarray(x), scale, 0.0, 4)))


def test_merge_trained_params_into_calibrated_equals_jax():
    rng = np.random.RandomState(1)
    trained = {"a": {"kernel": rng.randn(2, 3), "bias": rng.randn(3)},
               "b": {"D": rng.randn(4)}}
    calibrated = {"a": {"kernel": np.zeros((2, 3)), "bias": np.zeros(3),
                        "quant_input": {"scale": np.ones(())}},
                  "b": {"D": np.zeros(4), "quant_d": {"scale": np.ones(())}}}
    ours = dict(flat_leaves(t_static.merge_trained_params_into_calibrated(
        trained, calibrated)))
    theirs = dict(flat_leaves(jax_static.merge_trained_params_into_calibrated(
        trained, calibrated)))
    assert set(ours) == set(theirs)
    for path, val in theirs.items():
        np.testing.assert_array_equal(ours[path], val)


def _static_config(**kw) -> RunConfig:
    base = dict(n_layers=2, d_model=16, ssm_size_base=16, blocks=2,
                p_dropout=0.0, bsz=2, epochs=4, glu_variant="half1",
                relufication=True, opt_config="noBCdecay")
    base.update(kw)
    return RunConfig(**base)


def test_three_static_quant_train_steps_match_jax():
    """A static-quant model built for training (sequential scan, frozen
    w8a16 scales from the JAX calibration of random weights on the
    features of the first two batches) takes three
    steps in both packages: loss, SI-SNR and gradient norms 1e-3 relative,
    ``scale_grad_leak`` 0, parameters rtol 1e-3 + 1e-5 but for elements
    Adam moved by noise (``assert_params_near``: here 1 of 4112 decoder
    weights, 5.4e-5 apart), every scale bit-unchanged."""
    tcfg = _static_config()
    jcfg = JaxConfig(**{k: getattr(tcfg, k) for k in (
        "n_layers", "d_model", "ssm_size_base", "blocks", "p_dropout", "bsz",
        "epochs", "glu_variant", "relufication", "opt_config")},
        block_t=16)
    length = 37
    zeros = jnp.zeros((2, length, D_IO), jnp.float32)
    fp = jax_loop.build_model(jcfg, D_IO, D_IO, training=False)
    variables = jax.device_get(fp.init(jax.random.PRNGKey(3), zeros))
    # calibrated on the features the steps see, as the pipeline does
    cal_batches = [jnp.transpose(jax_features(*audio_batch(2, seed=s))[0]
                                 - STFT_MAG_MEAN, (0, 2, 1))
                   for s in (30, 31)]
    cal = jax_loop.build_model(
        jcfg, D_IO, D_IO, training=False,
        q_config=jax_recipes["w8a16"](static_quant=True, calibrating=True),
        scan_mode="sequential")
    frozen, stats = jax.device_get(jax_calibrate(
        cal, jax.random.PRNGKey(3), zeros, variables["params"],
        variables["batch_stats"], cal_batches))

    jm = jax_loop.build_model(
        jcfg, D_IO, D_IO, training=True,
        q_config=jax_recipes["w8a16"](static_quant=True, calibrating=False),
        scan_mode="sequential")
    schedule = dict(lr=tcfg.lr, ssm_lr=tcfg.ssm_lr_base,
                    weight_decay=tcfg.weight_decay, total_steps=tcfg.epochs,
                    warmup_steps=tcfg.warmup_end)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=frozen,
        tx=jax_optim.create_optimizer(tcfg.opt_config, **schedule),
        batch_stats=stats)
    jstep = jax_train_step(jm, batchnorm=True, static_quant=True)

    tm = loop.build_model(
        tcfg, D_IO, D_IO, training=True, device="cpu",
        q_config=quantization_recipes["w8a16"](static_quant=True,
                                               calibrating=False),
        scan_mode="sequential")
    tm.load_state_dict(from_flax(frozen, stats))
    state = TrainState(model=tm, optimizer=create_optimizer(
        tm.named_parameters(), tcfg.opt_config, **schedule))
    step = make_ndns_train_step(tm, static_quant=True)
    for i in range(3):
        noisy, clean = audio_batch(2, seed=30 + i)
        jstate, jmetrics = jstep(jstate, jax.random.PRNGKey(0),
                                 *jax_features(noisy, clean))
        state, metrics = step(state, *torch_features(noisy, clean))
        for key in ("loss", "si_snr", "grad_norm", "grad_norm/encoder",
                    "grad_norm/decoder"):
            assert metrics[key].item() == pytest.approx(
                float(jmetrics[key]), rel=1e-3, abs=1e-3), (i, key)
        assert float(metrics["scale_grad_leak"]) == 0.0
        assert float(jmetrics["scale_grad_leak"]) == 0.0
    params, _ = to_flax(tm)
    ref = jax.device_get(jstate.params)
    assert_params_near(params, ref, budget=3 * tcfg.lr)
    for path, val in flat_leaves(frozen):
        if path[-1] == "scale" and "norm" not in path:
            np.testing.assert_array_equal(dict(flat_leaves(params))[path],
                                          val, str(path))


def test_finetune_masks_merge_by_jax_leaf_path():
    """The finetuning state's masks: the trained masks merged over ones for
    every leaf of the new model by ``merge_trained_params_into_calibrated``
    on the JAX leaf paths, as the JAX package's ``convert`` merges them;
    a trained mask of a leaf the model lacks is dropped."""
    from sparsernns_tpu_torch.quantize.convert import _finetune_state
    from sparsernns_tpu_torch.train.pruning import model_leaves
    cfg = _static_config()
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    leaves = model_leaves(tm)
    rng = np.random.RandomState(5)
    trained = {leaf.key: torch.from_numpy(
        (rng.rand(*leaf.param.shape) > 0.5).astype(np.float32))
        for leaf in leaves[::2]}
    trained["['gone']['kernel']"] = torch.zeros(3)
    state = TrainState(model=tm, optimizer=create_optimizer(
        tm.named_parameters(), cfg.opt_config), step=7, masks=trained)
    out = _finetune_state(cfg, tm, state, steps_per_epoch=1, fresh=True)
    assert out.step == 7
    assert set(out.masks) == {leaf.key for leaf in leaves}

    def nested(pairs):
        tree = {}
        for (*path, name), val in pairs:
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[name] = val
        return tree

    ones = nested((leaf.path, np.ones(leaf.param.shape, np.float32))
                  for leaf in leaves)
    theirs = dict(flat_leaves(jax_static.merge_trained_params_into_calibrated(
        nested([(leaf.path, trained[leaf.key].numpy())
                for leaf in leaves[::2]]
               + [(("gone", "kernel"), np.zeros(3, np.float32))]), ones)))
    for leaf in leaves:
        np.testing.assert_array_equal(out.masks[leaf.key].numpy(),
                                      theirs[leaf.path], leaf.key)
