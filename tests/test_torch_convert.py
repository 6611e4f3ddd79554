"""The port's conversion pipeline against the JAX package's, on the CPU:
``convert(cfg)`` of both packages with every stage on, each restoring the
same flax weights from its own checkpoint.

Size as ``tests/test_pipeline.py``: 2 layers, d_model 12, P 16 in 2
blocks, relufied, 4 synthetic clips of 0.5 s (61 frames), B 2, dropout 0
(the two frameworks draw different dropout masks by construction), one
epoch of each finetuning stage, ``block_t`` 32 on both sides. The module
fixture runs the JAX pipeline once. Bars: baseline, naive-scan and QAT
losses and SI-SNRs 1e-3 relative; frozen scales and packed weights
equal; static-quant and engine stages 2e-3 relative (the engine bar);
each dumped activation with a counterpart 1e-4·max(1, |ref|); finetuning
histories 1e-3 relative, final parameters rtol 1e-3 + 1e-5 (up to
0.5 % of the elements within the learning rate: Adam moves a parameter
whose gradient is at noise level by about the learning rate either way);
the scales bit-unchanged by the static finetuning, ``scale_grad_leak`` 0.
Packed codes after the QAT finetuning: at most 1 apart in at most 0.5 %.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.convert import convert as jax_convert
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu.train import loop as jax_loop
from sparsernns_tpu.train.checkpoint import ArtifactStore as JaxStore
from sparsernns_tpu.train.checkpoint import CheckpointManager as JaxManager
from sparsernns_tpu.utils.config import RunConfig as JaxConfig
from sparsernns_tpu_torch.quantize.convert import (convert,
                                                   engine_from_frozen,
                                                   stage_listeners)
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.checkpoint import (ArtifactStore,
                                                   CheckpointManager)
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import flat_leaves, from_flax

SHARED = dict(
    dataset="ndns", synthetic_data=True, synthetic_size=4,
    synthetic_seconds=0.5, n_layers=2, d_model=12, ssm_size_base=16,
    blocks=2, glu_variant="half1", clip_eigs=True, prenorm=True,
    batchnorm=True, bsz=2, epochs=2, opt_config="noBCdecay",
    relufication=True, p_dropout=0.0, convert_quantization="w8a16",
    block_t=32, validate_baseline=True, store_activations=True,
    validate_naive_scan=True, validate_aqt=True, train_aqt=True,
    calibrate_quant=True, validate_static_quant=True, validate_engine=True,
    train_static_quant=True, qaft_epochs=1)

#: JAX dump keys with no counterpart in the port: BatchNorm is computed
#: inline (no module call) and dropout is no module
NO_COUNTERPART = {
    *(f"encoder.layers_{i}.{k}" for i in range(2)
      for k in ("norm.__call__.0", "drop.__call__.0", "drop.__call__.1"))}


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """(JAX results, port results, JAX directory, port directory, the
    port's stage order): both pipelines from the same flax weights at
    step 0."""
    tmp = tmp_path_factory.mktemp("convert")
    jcfg = JaxConfig(**SHARED, jax_seed=0, checkpoint_dir=str(tmp / "jax"))
    tcfg = RunConfig(**SHARED, jax_seed=0, checkpoint_dir=str(tmp / "port"))

    trainloader, _, _, n_out, seq_len, d_in, _ = jax_loop.build_dataset(jcfg)
    jmodel = jax_loop.build_model(jcfg, d_in, n_out, training=True)
    jstate, _ = jax_loop.create_run_state(
        jcfg, jmodel, jnp.zeros((jcfg.bsz, seq_len, d_in), jnp.float32),
        len(trainloader))
    mngr = JaxManager(jcfg.checkpoint_dir)
    mngr.save(0, jstate, metadata={"best_epoch": 0})
    mngr.wait()
    mngr.close()
    jres = jax_convert(jcfg)

    params = jax.device_get(jstate.params)
    stats = jax.device_get(jstate.batch_stats)
    tmodel = loop.build_model(tcfg, d_in, n_out, training=True,
                              device="cpu")
    tmodel.load_state_dict(from_flax(params, stats))
    tstate = loop.create_run_state(tcfg, tmodel, len(trainloader))
    CheckpointManager(tcfg.checkpoint_dir).save(
        0, tstate, metadata={"best_epoch": 0})
    order = []
    stage_listeners.append(lambda name, *_: order.append(name))
    try:
        tres = convert(tcfg, device="cpu")
    finally:
        stage_listeners.clear()
    return jres, tres, jcfg.checkpoint_dir, tcfg.checkpoint_dir, order


def _close(ours: dict, theirs: dict, rel: float, what: str) -> None:
    for key in ("loss", "si_snr"):
        assert ours[key] == pytest.approx(theirs[key], rel=rel), (what, key)


@pytest.mark.parametrize("stage,rel", [("baseline", 1e-3),
                                       ("naive_scan", 1e-3),
                                       ("qat", 1e-3),
                                       ("static_quant", 2e-3),
                                       ("engine", 2e-3)])
def test_validation_stage_matches_jax(pipelines, stage, rel):
    jres, tres, *_ = pipelines
    _close(tres[stage], jres[stage], rel, stage)


def test_naive_scan_is_the_baseline(pipelines):
    """The sequential scan gives the associative scan's metrics (both
    packages build the float model with the default scan mode)."""
    _, tres, *_ = pipelines
    _close(tres["naive_scan"], tres["baseline"], 1e-5, "naive scan")
    assert RunConfig().scan_mode == JaxConfig().scan_mode == "associative"


def test_activation_dump_matches_jax(pipelines):
    """Every key the port dumps is a JAX key, each value within
    1e-4·max(1, |ref|); the JAX keys without a counterpart are exactly
    :data:`NO_COUNTERPART`. The dumped inputs are equal."""
    _, tres, jdir, tdir, _ = pipelines
    jstore = JaxStore(os.path.join(jdir, "conversion"))
    tstore = ArtifactStore(os.path.join(tdir, "conversion"))
    ref = jax.device_get(jstore.load("activations"))
    ours = tstore.load("activations")
    assert set(ours) <= set(ref)
    assert set(ref) - set(ours) == NO_COUNTERPART
    assert tres["store_activations"]["n"] == len(ours)
    for key, val in ours.items():
        want = np.asarray(ref[key])
        assert val.shape == want.shape, key
        np.testing.assert_allclose(
            val, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()),
            err_msg=key)
    ref_in = jax.device_get(jstore.load("activation_inputs"))
    ours_in = tstore.load("activation_inputs")
    for key in ("noisy", "clean"):
        np.testing.assert_array_equal(ours_in[key], np.asarray(ref_in[key]))
    np.testing.assert_allclose(ours_in["x"], np.asarray(ref_in["x"]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("stage", ["qaft", "qaft_static"])
def test_finetuning_history_matches_jax(pipelines, stage):
    """One epoch each: the same metric keys, each 1e-3 relative (the
    static stage's ``scale_grad_leak`` 0 in both)."""
    jres, tres, *_ = pipelines
    (ref,), (ours,) = jres[stage]["history"], tres[stage]["history"]
    assert set(ours) == set(ref)
    for key, want in ref.items():
        assert ours[key] == pytest.approx(float(want), rel=1e-3,
                                          abs=1e-6), key
    if stage == "qaft_static":
        assert ours["train_scale_grad_leak"] == 0.0
        assert float(ref["train_scale_grad_leak"]) == 0.0


def _scales(tree) -> dict:
    return {path: np.asarray(leaf) for path, leaf in flat_leaves(tree)
            if path[-1] == "scale" and "norm" not in path}


def assert_params_near(ours, theirs, budget: float) -> None:
    """Parameter trees after finetuning: every leaf within ``budget``
    (the most Adam moves an element in the steps taken: about the
    learning rate a step, whatever the gradient's size), and at most
    0.5 % of all elements off by more than rtol 1e-3 + 1e-5: an element
    whose gradient is at noise level, or crosses a quantization tie, moves
    by up to the learning rate in either package."""
    want, got = dict(flat_leaves(theirs)), dict(flat_leaves(ours))
    assert set(got) == set(want)
    n = off = 0
    for path, ref in want.items():
        ref = np.asarray(ref)
        diff = np.abs(np.asarray(got[path]) - ref)
        assert diff.max() <= budget, (path, float(diff.max()))
        off += int((diff > 1e-5 + 1e-3 * np.abs(ref)).sum())
        n += ref.size
    assert off <= 5e-3 * n, (off, n)


def _codes_close(ours, theirs, what: str) -> None:
    """Packed codes at most 1 apart, in at most 0.5 % of the elements."""
    diff = np.abs(np.asarray(ours, np.int64) - np.asarray(theirs, np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, (
        what, int(diff.max()), float((diff > 0).mean()))


def test_frozen_scales_and_packed_weights_equal(pipelines):
    """After QAT finetuning both calibrations freeze the same scales and
    the engines the same requant grids and weight scales. The packed int8
    weights quantize float weights that one QAT epoch moved within
    rounding of JAX's (parameters rtol 1e-3), so a weight at a rounding tie
    may take the neighbouring code: codes at most 1 apart in at most
    0.5 % (the engine's code bar; 1 of 3084 encoder codes here)."""
    _, tres, jdir, *_ = pipelines
    jstore = JaxStore(os.path.join(jdir, "conversion"))
    fp, fs = (jax.device_get(jstore.load(k))
              for k in ("frozen_params", "frozen_stats"))
    jscales = _scales(fp)
    tscales = _scales(tres["frozen_params"])
    assert set(tscales) == set(jscales) and len(jscales) > 20
    for path, want in jscales.items():
        np.testing.assert_array_equal(tscales[path], want, str(path))
    cfg = RunConfig(**SHARED)
    ours = engine_from_frozen(cfg, tres["frozen_params"],
                              tres["frozen_stats"], device="cpu")
    from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
    theirs = JaxEngine(
        fp, fs, jax_recipes["w8a16"](static_quant=True, calibrating=False),
        JaxModelConfig.infer(fp, glu_variant="half1", relufication=True,
                             prenorm=True, clip_eigs=True),
        block_t=32)
    for name in ("encoder_kernel", "decoder_kernel"):
        a, b = getattr(theirs, name), getattr(ours, name)
        assert a.scale == b.scale, name
        _codes_close(b.data.numpy(), a.data, name)
    for a, b in zip(theirs.layers, ours.layers):
        for name in ("w_b", "w_c"):
            _codes_close(getattr(b, name).numpy(), getattr(a, name), name)
        assert a.out2_kernel.scale == b.out2_kernel.scale
        _codes_close(b.out2_kernel.data.numpy(), a.out2_kernel.data, "out2")
        for name in ("wb_scales", "wc_scales", "state_requant",
                     "residual_requant"):
            assert getattr(a, name) == getattr(b, name), name


def test_static_finetuning_keeps_scales_and_matches_params(pipelines):
    """``qaft_params``: the scales bit-unchanged from the frozen tree in
    both packages, the parameters rtol 1e-3 + 1e-5 of JAX's but for
    elements Adam moved by noise (:func:`assert_params_near`; 1 of the
    192 of a C here, 5.5e-5 apart, against two steps of at most the
    learning rate 4e-3)."""
    _, tres, jdir, tdir, _ = pipelines
    jstore = JaxStore(os.path.join(jdir, "conversion"))
    ref = jax.device_get(jstore.load("qaft_params"))
    ours = ArtifactStore(os.path.join(tdir, "conversion")).load(
        "qaft_params")
    for tree, frozen in ((ours, tres["frozen_params"]),
                         (ref, jax.device_get(jstore.load("frozen_params")))):
        for path, val in _scales(frozen).items():
            np.testing.assert_array_equal(_scales(tree)[path], val,
                                          str(path))
    assert_params_near(ours, ref, budget=2 * RunConfig().lr)


def test_val_metrics_and_artifacts(pipelines):
    """``val_metrics.json`` has JAX's keys; the store holds every
    artifact; the stages ran in the JAX package's order."""
    _, tres, jdir, tdir, order = pipelines
    ref = json.load(open(os.path.join(jdir, "val_metrics.json")))
    ours = json.load(open(os.path.join(tdir, "val_metrics.json")))
    assert set(ours) == set(ref)
    store = ArtifactStore(os.path.join(tdir, "conversion"))
    for name in ("activations", "activation_inputs", "frozen_params",
                 "frozen_stats", "qaft_params"):
        assert store.exists(name), name
    assert order == ["restore", "baseline", "store_activations",
                     "naive_scan", "qat", "qaft", "calibrate",
                     "static_quant", "engine", "qaft_static"]
    assert tres["calibrated"] is True
