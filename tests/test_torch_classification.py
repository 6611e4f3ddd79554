"""The port's classification and retrieval path against the JAX package's,
on the CPU: the heads in eval and training mode (pooled, last step,
padded), ``masked_meanpool``, the retrieval head, the classification
train and eval steps, one epoch and its validation, ``train(cfg)`` on
``synthetic-classification``, the loaders, the IDX reader and sequential
MNIST, and the static-quant classifier through calibration into the
fixed-point model.

The same numpy inputs and the same flax weights (carried over by
``weights.from_flax``) go through both; the JAX models run their Pallas
kernels in interpret mode with an explicit ``block_t``. Tolerances:
forwards 1e-4·max(1,|ref|); steps at the bars of
``tests/test_torch_train.py`` (metrics 1e-3 relative, parameters rtol
1e-3 + 1e-5, running statistics 1e-5); epoch and run metrics 1e-3
relative; loaders, IDX files and the fixed-point integers exactly.
"""

import dataclasses
import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.data import classification as jcls
from sparsernns_tpu.fxp import derive as jderive
from sparsernns_tpu.models import seq_model as jseq
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import \
    blocked_dplr_init as jax_blocked_dplr_init
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.train import loop as jloop
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train import steps as jsteps
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu_torch.data import classification as tcls
from sparsernns_tpu_torch.fxp import derive as tderive
from sparsernns_tpu_torch.models import seq_model as tseq
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train import steps as tsteps
from sparsernns_tpu_torch.weights import from_flax, to_flax
from tests.test_torch_train import (assert_trees_close, leaves,
                                    small_config)

D_IN, N_CLS, L, B = 3, 4, 20, 4


def cls_config(**kw):
    base = dict(dataset="synthetic-classification", block_t=16,
                scan_mode="fused", bsz=B, synthetic_size=16, epochs=2)
    return small_config(**{**base, **kw})


def jax_head(cls, cfg, q_config=None, training=False, d_in=D_IN,
             d_out=N_CLS, **kw):
    q_config = q_config or jax_recipes["none"]()
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"],
        v=init["V"], vinv=init["Vinv"], c_init=cfg.C_init,
        discretization=cfg.discretization, clip_eigs=cfg.clip_eigs,
        relufication=cfg.relufication, q_config=q_config,
        scan_mode=("sequential" if q_config.static_quant else cfg.scan_mode),
        block_t=cfg.block_t)
    return cls(mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
               d_output=d_out, dropout=cfg.p_dropout, prenorm=cfg.prenorm,
               batchnorm=cfg.batchnorm, bn_momentum=cfg.bn_momentum,
               glu_variant=cfg.glu_variant, training=training,
               relufication=cfg.relufication, q_config=q_config, **kw)


def random_stats(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])


def init_jax(model, example, seed):
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed), example))
    return {"params": variables["params"],
            "batch_stats": random_stats(variables, seed + 100)}


def port_classifier(cfg, variables, training=False, mode="pool",
                    padded=False, d_in=D_IN):
    tm = loop.build_model(dataclasses.replace(cfg, mode=mode), d_in, N_CLS,
                          training=training, device="cpu")
    tm.padded = padded
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    return tm


def close(out, ref, bar=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    assert (err <= bar * np.maximum(1.0, np.abs(ref))).all(), err.max()


def seq_batch(seed, b=B, l=L, d=D_IN):
    return np.random.RandomState(seed).randn(b, l, d).astype(np.float32)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("mode", ["pool", "last"])
@pytest.mark.parametrize("scan_mode,glu,relu", [
    ("fused", "half1", False), ("associative", "full", True)])
def test_classifier_forward_matches_jax(scan_mode, glu, relu, mode,
                                        training):
    """Log-probabilities (and in training the running statistics)."""
    cfg = cls_config(scan_mode=scan_mode, glu_variant=glu,
                     relufication=relu)
    x = seq_batch(1)
    jm = jax_head(jseq.ClassificationModel, cfg, training=training,
                  mode=mode)
    variables = init_jax(jm, jnp.asarray(x), seed=2)
    tm = port_classifier(cfg, variables, training=training, mode=mode)
    if training:
        ref, mod = jm.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x))
    out = tm(torch.from_numpy(x))
    close(out.detach().numpy(), ref)
    assert isinstance(tm, tseq.ClassificationModel)
    np.testing.assert_allclose(np.exp(out.detach().numpy()).sum(-1), 1.0,
                               atol=1e-5)
    if training:
        assert_trees_close(to_flax(tm)[1], mod["batch_stats"], rtol=0,
                           atol=1e-6)


def test_qat_classifier_matches_jax():
    """The QAT classifier (w8a16 fake-quant, the associative scan with
    the QAT hadamards, ``QATDense`` decoder): forward 1e-4·max(1,|ref|),
    in eval and training mode."""
    cfg = cls_config(scan_mode="associative", quantization="w8a16")
    x = seq_batch(11)
    for training in (False, True):
        jm = jax_head(jseq.ClassificationModel, cfg,
                      q_config=jax_recipes["w8a16"](), training=training)
        variables = init_jax(jm, jnp.asarray(x), seed=12)
        if training:
            ref, _ = jm.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
        else:
            ref = jm.apply(variables, jnp.asarray(x))
        tm = port_classifier(cfg, variables, training=training)
        assert tm.q_config.any_quantized
        close(tm(torch.from_numpy(x)).detach().numpy(), ref)


def test_masked_meanpool_and_padded_heads_match_jax():
    """``masked_meanpool`` itself, a padded pooling classifier, a padded
    regression head (lengths ignored), and ``mode="last"`` with padded
    inputs raising in both packages."""
    x = seq_batch(3)
    lengths = np.array([20, 7, 1, 13], np.int32)
    ref = jseq.masked_meanpool(jnp.asarray(x), jnp.asarray(lengths))
    out = tseq.masked_meanpool(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)

    cfg = cls_config(scan_mode="associative")
    jm = jax_head(jseq.ClassificationModel, cfg, padded=True, mode="pool")
    variables = init_jax(jm, (jnp.asarray(x), jnp.asarray(lengths)), seed=4)
    ref = jm.apply(variables, (jnp.asarray(x), jnp.asarray(lengths)))
    tm = port_classifier(cfg, variables, padded=True)
    with torch.no_grad():
        out = tm((torch.from_numpy(x), torch.from_numpy(lengths)))
    close(out.numpy(), ref)

    jr = jax_head(jseq.RegressionModel, cfg, padded=True, d_out=5)
    rvars = init_jax(jr, (jnp.asarray(x), jnp.asarray(lengths)), seed=5)
    rref = jr.apply(rvars, (jnp.asarray(x), jnp.asarray(lengths)))
    tr = loop.build_model(dataclasses.replace(cfg, dataset="ndns"), D_IN, 5,
                          device="cpu")
    tr.padded = True
    tr.load_state_dict(from_flax(rvars["params"], rvars["batch_stats"]))
    with torch.no_grad():
        close(tr((torch.from_numpy(x), torch.from_numpy(lengths))).numpy(),
              rref)

    jl = jax_head(jseq.ClassificationModel, cfg, padded=True, mode="last")
    with pytest.raises(NotImplementedError, match="last"):
        jl.apply(variables, (jnp.asarray(x), jnp.asarray(lengths)))
    tl = port_classifier(cfg, variables, padded=True, mode="last")
    with pytest.raises(NotImplementedError, match="last"):
        tl((torch.from_numpy(x), torch.from_numpy(lengths)))
    bad = port_classifier(cfg, variables, mode="mean")
    with pytest.raises(NotImplementedError, match="mode"):
        bad(torch.from_numpy(x))


@pytest.mark.parametrize("padded,training", [(False, False), (True, False),
                                             (False, True)])
def test_retrieval_matches_jax(padded, training):
    """2 x 3 documents: both halves pooled, the four-feature MLP, the
    decoder's ``QDense_0`` / ``QDense_1`` carried by name; in training
    mode the batch statistics cover both halves."""
    cfg = cls_config(scan_mode="associative", n_layers=1)
    x = seq_batch(6, b=6)
    lengths = np.array([20, 5, 9, 20, 3, 17], np.int32)
    inp = (jnp.asarray(x), jnp.asarray(lengths)) if padded else jnp.asarray(x)
    jm = jax_head(jseq.RetrievalModel, cfg, padded=padded, training=training)
    variables = init_jax(jm, inp, seed=7)
    if training:
        ref, _ = jm.apply(variables, inp, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, inp)
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    from sparsernns_tpu_torch.models.ssm import S5SSM

    def make_mixer():
        return S5SSM(init["Lambda"], init["V"], init["Vinv"], h=cfg.d_model,
                     p=init["P"], clip_eigs=cfg.clip_eigs,
                     scan_mode="associative")

    tm = tseq.RetrievalModel(make_mixer, D_IN, N_CLS, cfg.n_layers,
                             cfg.d_model, padded=padded,
                             glu_variant=cfg.glu_variant,
                             bn_momentum=cfg.bn_momentum).train(training)
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    assert {"decoder.QDense_0.weight", "decoder.QDense_1.bias"} <= \
        set(tm.state_dict())
    tin = ((torch.from_numpy(x), torch.from_numpy(lengths)) if padded
           else torch.from_numpy(x))
    with torch.no_grad():
        out = tm(tin)
    assert out.shape == (3, N_CLS) and tm.training == training
    close(out.numpy(), ref)
    params, _ = to_flax(tm)
    assert set(leaves(params)) == set(leaves(variables["params"]))


def _paired_states(cfg, seed, steps_per_epoch=1):
    x = seq_batch(seed)
    jm = jax_head(jseq.ClassificationModel, cfg, training=True,
                  mode=cfg.mode)
    variables = init_jax(jm, jnp.asarray(x), seed=seed)
    tm = port_classifier(cfg, variables, training=True, mode=cfg.mode)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay,
        total_steps=steps_per_epoch * cfg.epochs,
        warmup_steps=steps_per_epoch * cfg.warmup_end)
    jstate = JaxTrainState.create(apply_fn=jm.apply,
                                  params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"])
    return jm, jstate, tm, loop.create_run_state(cfg, tm, steps_per_epoch)


def _labels(seed):
    return np.random.RandomState(seed).randint(0, N_CLS, B).astype(np.int32)


@pytest.mark.parametrize("scan_mode", ["fused", "associative"])
def test_classification_train_and_eval_steps_match_jax(scan_mode):
    """Three train steps (loss, accuracy and gradient norms 1e-3 relative;
    parameters rtol 1e-3 + 1e-5 and running statistics 1e-5 after them),
    then the eval step (1e-3 relative)."""
    cfg = cls_config(scan_mode=scan_mode)
    jm, jstate, tm, state = _paired_states(cfg, seed=8)
    jstep = jsteps.make_classification_train_step(jm, batchnorm=True)
    step = tsteps.make_classification_train_step(tm)
    for i in range(3):
        x, y = seq_batch(20 + i), _labels(20 + i)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(y))
        state, met = step(state, torch.from_numpy(x),
                          torch.from_numpy(y).long())
        assert set(met) == set(jmet)
        for key in jmet:
            assert met[key].item() == pytest.approx(float(jmet[key]),
                                                    rel=1e-3, abs=1e-3), key
    assert state.step == 3 == int(jstate.step)
    params, stats = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    assert_trees_close(stats, jax.device_get(jstate.batch_stats), rtol=0,
                       atol=1e-5)
    jeval = jsteps.make_classification_eval_step(
        jm.clone(training=False), batchnorm=True)
    x, y = seq_batch(30), _labels(30)
    jref = jeval(jstate, jnp.asarray(x), jnp.asarray(y))
    ours = tsteps.make_classification_eval_step(tm)(
        torch.from_numpy(x), torch.from_numpy(y).long())
    assert tm.training
    for key in ("loss", "accuracy"):
        assert ours[key].item() == pytest.approx(float(jref[key]), rel=1e-3,
                                                 abs=1e-3), key


def test_epoch_and_validation_match_jax():
    """``run_classification_epoch`` (the ``train_acc`` key) and
    ``validate_classification`` over the synthetic loaders, 1e-3
    relative."""
    cfg = cls_config(scan_mode="associative", n_layers=1)
    train, val, _, n_out, seq_len, d_in, _ = loop.build_dataset(cfg)
    jtrain, jval = jloop.build_dataset(cfg)[:2]
    steps = len(train)
    # the synthetic set is (128 steps, 1 input): models of its shape
    x0 = np.zeros((B, seq_len, d_in), np.float32)
    jm = jax_head(jseq.ClassificationModel, cfg, training=True, d_in=d_in,
                  d_out=n_out)
    variables = init_jax(jm, jnp.asarray(x0), seed=9)
    tm = port_classifier(cfg, variables, training=True, d_in=d_in)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay, total_steps=steps * cfg.epochs,
        warmup_steps=steps * cfg.warmup_end)
    jstate = JaxTrainState.create(apply_fn=jm.apply,
                                  params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"])
    state = loop.create_run_state(cfg, tm, steps)
    jstate, jlog = jloop.run_classification_epoch(
        jstate, jsteps.make_classification_train_step(jm), lambda s: s,
        jtrain, jax.random.PRNGKey(0))
    log = loop.run_classification_epoch(
        state, tsteps.make_classification_train_step(tm), train)
    assert set(log) == set(jlog) and "train_acc" in log
    for key in jlog:
        assert log[key] == pytest.approx(jlog[key], rel=1e-3, abs=1e-3), key
    jv = jloop.validate_classification(
        jstate, jsteps.make_classification_eval_step(
            jm.clone(training=False)), jval)
    v = loop.validate_classification(
        tm, tsteps.make_classification_eval_step(tm), val)
    assert set(v) == set(jv) == {"loss", "accuracy"}
    for key in jv:
        assert v[key] == pytest.approx(jv[key], rel=1e-3, abs=1e-3), key


def test_train_synthetic_classification_matches_jax(monkeypatch):
    """``train(cfg)`` on ``synthetic-classification``, two epochs, from the
    JAX run's initial weights: every epoch's loss and accuracy (train,
    validation, test) 1e-3 relative, the learning rates and eigenvalue
    logs of the epoch log equal to 1e-5, and the best-epoch metadata."""
    cfg = cls_config(scan_mode="associative", n_layers=1, epochs=2,
                     jax_seed=3, data_seed=5)
    logs = []

    class Sink:
        def log(self, metrics, step=None):
            logs.append({k: float(v) for k, v in metrics.items()})

        def log_best(self, metrics):
            pass

        def finish(self):
            pass

    monkeypatch.setattr(jloop, "make_sink", lambda *a, **k: Sink())
    jout = jloop.train(cfg)
    jlogs, logs[:] = list(logs), []
    # the JAX run's initial weights, into the port's model
    _, _, _, n_out, seq_len, d_in, _ = jloop.build_dataset(cfg)
    init = jax.device_get(jloop.build_model(cfg, d_in, n_out, True).init(
        jax.random.PRNGKey(cfg.jax_seed),
        jnp.zeros((cfg.bsz, seq_len, d_in), jnp.float32)))
    build = loop.build_model

    def build_from_jax(*args, **kw):
        model = build(*args, **kw)
        model.load_state_dict(from_flax(init["params"],
                                        init["batch_stats"]))
        return model

    monkeypatch.setattr(loop, "build_model", build_from_jax)
    monkeypatch.setattr(loop, "make_sink", lambda *a, **k: Sink())
    out = loop.train(cfg, device="cpu")
    assert len(logs) == len(jlogs) == 2
    for ours, theirs in zip(logs, jlogs):
        for key in ("train_loss", "train_acc", "val_loss", "val_accuracy",
                    "test_loss", "test_accuracy", "train_grad_norm"):
            assert ours[key] == pytest.approx(theirs[key], rel=1e-3,
                                              abs=1e-3), key
        for key, val in theirs.items():
            if "eig_" in key or key.endswith("/lr"):
                assert ours[key] == pytest.approx(val, rel=1e-5), key
    meta, jmeta = out["metadata"], jout["metadata"]
    assert meta["best_epoch"] == jmeta["best_epoch"]
    assert meta["best_si_snr"] == pytest.approx(jmeta["best_si_snr"],
                                                rel=1e-3)


def test_loaders_match_jax():
    """Items, batches and the per-epoch shuffle of the synthetic loaders
    (two shards), exactly."""
    for shard in (0, 1):
        ours = tcls.create_classification_dataset(
            3, seed=4, size=24, seq_len=16, d_input=2, n_classes=3,
            num_shards=2, shard_index=shard)
        theirs = jcls.create_classification_dataset(
            3, seed=4, size=24, seq_len=16, d_input=2, n_classes=3,
            num_shards=2, shard_index=shard)
        assert ours[3:] == theirs[3:]
        for lo, lt in zip(ours[:3], theirs[:3]):
            assert len(lo) == len(lt) == 4
            for _ in range(2):          # two epochs: the shuffle moves on
                for (xo, yo), (xt, yt) in zip(lo, lt):
                    np.testing.assert_array_equal(xo, xt)
                    np.testing.assert_array_equal(yo, yt)
                    assert yo.dtype == yt.dtype == np.int32


def _write_idx(path, arr, code):
    header = struct.pack(">HBB", 0, code, arr.ndim)
    header += struct.pack(f">{arr.ndim}I", *arr.shape)
    data = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data)


@pytest.fixture()
def mnist_dir(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "mnist"
    (root / "MNIST" / "raw").mkdir(parents=True)
    _write_idx(str(root / "train-images-idx3-ubyte"),
               rng.randint(0, 256, (30, 28, 28)).astype(np.uint8), 0x08)
    _write_idx(str(root / "train-labels-idx1-ubyte.gz"),
               rng.randint(0, 10, 30).astype(np.uint8), 0x08)
    _write_idx(str(root / "MNIST" / "raw" / "t10k-images-idx3-ubyte"),
               rng.randint(0, 256, (10, 28, 28)).astype(np.uint8), 0x08)
    _write_idx(str(root / "MNIST" / "raw" / "t10k-labels.idx1-ubyte"),
               rng.randint(0, 10, 10).astype(np.uint8), 0x08)
    return str(root)


def test_idx_reader_and_bitreversal_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    for code, arr in ((0x08, rng.randint(0, 256, (3, 4, 5)).astype(np.uint8)),
                      (0x0B, rng.randint(-99, 99, (6,)).astype(np.int16)),
                      (0x0D, rng.randn(2, 3).astype(np.float32)),
                      (0x0E, rng.randn(4).astype(np.float64))):
        for suffix in ("", ".gz"):
            path = str(tmp_path / f"a{code}{suffix}")
            _write_idx(path, arr, code)
            ours, theirs = tcls.read_idx(path), jcls.read_idx(path)
            np.testing.assert_array_equal(ours, theirs)
            np.testing.assert_array_equal(ours, arr)
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as f:
        f.write(struct.pack(">HBB", 1, 8, 1))
    for mod in (tcls, jcls):
        with pytest.raises(ValueError, match="magic"):
            mod.read_idx(bad)
    for n in (1, 2, 16, 784, 1000):
        perm = tcls.bitreversal_permutation(n)
        np.testing.assert_array_equal(perm, jcls.bitreversal_permutation(n))
        assert sorted(perm) == list(range(n))


@pytest.mark.parametrize("permute", [False, True])
def test_smnist_matches_jax(mnist_dir, permute, monkeypatch):
    """Every split (the seeded 0.1 validation split of the training
    images), every item, and the registry's ``smnist`` / ``psmnist``
    through ``SMNIST_DATA_DIR``."""
    for split in ("train", "val", "test"):
        ours = tcls.SMNIST(mnist_dir, split=split, permute=permute)
        theirs = jcls.SMNIST(mnist_dir, split=split, permute=permute)
        assert len(ours) == len(theirs) == {"train": 27, "val": 3,
                                            "test": 10}[split]
        for i in range(len(ours)):
            xo, yo = ours[i]
            xt, yt = theirs[i]
            assert xo.shape == (784, 1) and yo == yt
            np.testing.assert_array_equal(xo, xt)
    monkeypatch.setenv("SMNIST_DATA_DIR", mnist_dir)
    cfg = cls_config(dataset="psmnist" if permute else "smnist", bsz=4)
    ours, theirs = loop.build_dataset(cfg), jloop.build_dataset(cfg)
    assert ours[3:] == theirs[3:] == (10, 784, 1, 27)
    for (xo, yo), (xt, yt) in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(xo, xt)
        np.testing.assert_array_equal(yo, yt)
    monkeypatch.delenv("SMNIST_DATA_DIR")
    with pytest.raises(FileNotFoundError):
        tcls.SMNIST(split="test")


def test_static_quant_classifier_into_fxp_matches_jax():
    """A float classifier calibrated by each package (the port's
    ``quantize/calibrate.py``, JAX's) gives equal frozen trees, and the
    fixed-point model built from the port's own tree
    (``build_fxp_model(task="classification")``) gives JAX's integers on
    JAX's tree: tolerance 0."""
    cfg = cls_config(scan_mode="associative", n_layers=2, d_model=12,
                     relufication=True)
    x = (0.5 * seq_batch(40)).astype(np.float32)
    fp = jax_head(jseq.ClassificationModel, cfg)
    variables = init_jax(fp, jnp.zeros_like(jnp.asarray(x)), seed=0)
    cal_q = dict(static_quant=True, calibrating=True)
    jcal = jax_head(jseq.ClassificationModel, cfg,
                    q_config=jax_recipes["w8a16"](**cal_q))
    jparams, jstats = jax.device_get(jax_calibrate(
        jcal, jax.random.PRNGKey(0), jnp.zeros_like(jnp.asarray(x)),
        variables["params"], variables["batch_stats"], [jnp.asarray(x)]))
    float_model = port_classifier(cfg, variables)
    tcal = loop.build_model(cfg, D_IN, N_CLS, device="cpu",
                            q_config=quantization_recipes["w8a16"](**cal_q),
                            scan_mode="sequential")
    assert isinstance(tcal, tseq.ClassificationModel)
    tparams, tstats = calibrate(tcal, float_model.state_dict(),
                                [torch.from_numpy(x)])
    for ours, theirs in ((tparams, jparams), (tstats, jstats)):
        a, b = leaves(ours), leaves(theirs)
        for key, val in a.items():
            np.testing.assert_array_equal(val, b[key], err_msg=key)
    model_kw = dict(glu_variant=cfg.glu_variant, relufication=True,
                    prenorm=True, clip_eigs=True, task="classification")
    inf = dict(static_quant=True, calibrating=False)
    jm = jderive.build_fxp_model(
        jparams, jstats, jax_recipes["w8a16"](**inf),
        jderive.FxpModelConfig.infer(jparams, **model_kw))
    tm = tderive.build_fxp_model(
        tparams, tstats, quantization_recipes["w8a16"](**inf),
        tderive.FxpModelConfig.infer(tparams, **model_kw), device="cpu")
    jy, ty = jm(jnp.asarray(x)), tm(torch.from_numpy(x))
    assert ty.data.shape == (B, N_CLS)
    np.testing.assert_array_equal(ty.data.numpy(), np.asarray(jy.data))
    assert (jy.bits, jy.exp) == (ty.bits, ty.exp)
    # the static-quant port model itself, frozen, against JAX's
    jinf = jax_head(jseq.ClassificationModel, cfg,
                    q_config=jax_recipes["w8a16"](**inf))
    ref = jinf.apply({"params": jparams, "batch_stats": jstats},
                     jnp.asarray(x))
    tinf = loop.build_model(cfg, D_IN, N_CLS, device="cpu",
                            q_config=quantization_recipes["w8a16"](**inf),
                            scan_mode="sequential")
    tinf.load_state_dict(from_flax(tparams, tstats))
    with torch.no_grad():
        close(tinf(torch.from_numpy(x)).numpy(), ref)
