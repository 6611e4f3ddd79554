"""The port's conversion artifacts and its command line on the CPU: the
``ArtifactStore`` round trip, ``W8A16Engine.from_artifacts`` against the
engine of the frozen tree that ``convert`` returned (bit for bit), the
best-epoch restore from the single-slot ``<dir>/best`` (the port's
analogue of ``tests/test_pipeline.py``'s retention test), and
``cli.main`` ``train`` -> ``convert`` -> ``fxp`` (each mode) on a recipe
file.
Port only: the parity of each stage with the JAX package is
``tests/test_torch_convert.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sparsernns_tpu_torch import cli
from sparsernns_tpu_torch.quantize.convert import convert, engine_from_frozen
from sparsernns_tpu_torch.quantize.engine import W8A16Engine
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.checkpoint import (ArtifactStore,
                                                   CheckpointManager)
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import flat_leaves, to_flax

SMALL = dict(dataset="ndns", synthetic_data=True, synthetic_size=4,
             synthetic_seconds=0.5, n_layers=1, d_model=12, ssm_size_base=16,
             blocks=2, bsz=2, p_dropout=0.0, relufication=True, block_t=32)


@pytest.mark.parametrize("dtype", ["int8", "int16", "float32", "float64",
                                   "bool"])
def test_artifact_store_round_trip(tmp_path, dtype):
    """Nested dicts of numpy arrays (any dtype, 0-d too) and tensors come
    back with their dtypes, shapes and values; a missing item does not
    exist and a file is written whole."""
    rng = np.random.RandomState(0)
    arr = (rng.randn(3, 5) * 100).astype(dtype)
    tree = {"a": {"b": arr, "c": {"d": np.asarray(arr[0, 0])}},
            "e": np.float32(2.5), "t": torch.arange(4, dtype=torch.int16)}
    store = ArtifactStore(str(tmp_path / "conversion"))
    assert not store.exists("tree")
    store.save("tree", tree)
    assert store.exists("tree") and not store.exists("other")
    assert os.listdir(store.directory) == ["tree.pt"]
    back = store.load("tree")
    assert back["a"]["b"].dtype == arr.dtype
    np.testing.assert_array_equal(back["a"]["b"], arr)
    assert back["a"]["c"]["d"].shape == () and back["a"]["c"]["d"] == arr[0, 0]
    assert back["e"].dtype == np.float32 and back["e"] == 2.5
    assert torch.equal(back["t"], tree["t"])
    with pytest.raises(TypeError):
        store.save("bad", {"x": [1, 2]})


def _recipe(tmp_path, **kw) -> str:
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps({**SMALL, "epochs": 2, **kw}))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli.main train`` then ``cli.main convert`` with every stage on,
    on the CPU, into one checkpoint directory."""
    tmp = tmp_path_factory.mktemp("cli")
    recipe = _recipe(tmp)
    run = str(tmp / "run")
    common = ["--recipe", recipe, "--device", "cpu", "--checkpoint_dir", run]
    assert cli.main(["train", *common]) == 0
    stages = ["--validate_baseline", "true", "--store_activations", "true",
              "--validate_naive_scan", "true", "--validate_aqt", "true",
              "--train_aqt", "true", "--train_static_quant", "true",
              "--qaft_epochs", "1"]
    assert cli.main(["convert", *common, *stages]) == 0
    cfg = dataclasses.replace(RunConfig().with_recipe(recipe),
                              checkpoint_dir=run)
    return cfg, run


def test_cli_train_then_convert_writes_every_artifact(trained):
    cfg, run = trained
    assert CheckpointManager(run).all_steps() == [0, 1]
    store = ArtifactStore(os.path.join(run, "conversion"))
    for name in ("activations", "activation_inputs", "frozen_params",
                 "frozen_stats", "qaft_params"):
        assert store.exists(name), name
    metrics = json.load(open(os.path.join(run, "val_metrics.json")))
    assert set(metrics) == {"baseline", "store_activations", "naive_scan",
                            "qat", "qaft", "static_quant"}
    for stage in ("baseline", "naive_scan", "qat", "static_quant"):
        assert np.isfinite(metrics[stage]["si_snr"]), stage
    assert len(metrics["qaft"]["history"]) == 1


def test_from_artifacts_equals_engine_from_frozen(trained, tmp_path):
    """``from_artifacts`` serves the engine of the stored frozen tree, and
    that tree is the one ``convert`` returned in memory: the two engines
    agree bit for bit (the CLI run's store, and a second conversion of its
    latest checkpoint into a fresh directory)."""
    cfg, run = trained
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 40, 257).astype(np.float32))
    stored = ArtifactStore(os.path.join(run, "conversion"))
    engine = W8A16Engine.from_artifacts(run, cfg, device="cpu")
    same = engine_from_frozen(cfg, stored.load("frozen_params"),
                              stored.load("frozen_stats"), device="cpu")
    assert torch.equal(engine(x), same(x))
    other = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "again"),
                                validate_static_quant=False,
                                validate_engine=False)
    CheckpointManager(other.checkpoint_dir).save(
        0, _restored_state(cfg, cfg.checkpoint_dir))
    res = convert(other, device="cpu")
    assert set(res) == {"calibrated", "frozen_params", "frozen_stats"}
    again = W8A16Engine.from_artifacts(other.checkpoint_dir, other,
                                       device="cpu")
    ref = engine_from_frozen(other, res["frozen_params"],
                             res["frozen_stats"], device="cpu")
    assert torch.equal(again(x), ref(x))


def _restored_state(cfg, directory, step=None):
    """A state of ``cfg`` with checkpoint ``step`` (default the latest) of
    ``directory``."""
    trainloader, _, _, n_out, _, d_in, _ = loop.build_dataset(cfg)
    model = loop.build_model(cfg, d_in, n_out, device="cpu")
    state = loop.create_run_state(cfg, model, len(trainloader))
    return CheckpointManager(directory).restore(state, step)[0]


def test_convert_restores_the_best_epoch_from_its_slot(tmp_path):
    """A diverging run of 6 epochs (seeded: without relufication, at
    lr_factor 400, its validation loss is lowest after epoch 0): the best
    epoch is kept only in ``<dir>/best``; ``convert`` calibrates exactly
    those weights, not the latest ones."""
    cfg = RunConfig(**{**SMALL, "relufication": False}, epochs=6,
                    lr_factor=400.0,
                    checkpoint_dir=str(tmp_path / "run"),
                    validate_static_quant=False, validate_engine=False)
    best = loop.train(cfg, device="cpu")["metadata"]["best_epoch"]
    main_steps = CheckpointManager(cfg.checkpoint_dir).all_steps()
    best_dir = os.path.join(cfg.checkpoint_dir, "best")
    assert best == 0 and main_steps == [3, 4, 5]
    assert CheckpointManager(best_dir).all_steps() == [best]
    frozen = dict(flat_leaves(convert(cfg, device="cpu")["frozen_params"]))
    want, _ = to_flax(_restored_state(cfg, best_dir).model)
    latest, _ = to_flax(_restored_state(cfg, cfg.checkpoint_dir).model)
    for path, val in flat_leaves(want):
        np.testing.assert_array_equal(frozen[path], val, str(path))
    assert any(not np.array_equal(val, dict(flat_leaves(latest))[path])
               for path, val in flat_leaves(want))


@pytest.mark.parametrize("mode", ["inference", "verify", "export"])
def test_cli_fxp_over_the_conversion_artifacts(trained, tmp_path, mode):
    """``cli.main fxp`` in each mode over the CLI run's artifacts: the
    validation metrics under JAX's keys, one verified block for the
    encoder and four per layer, and the integer export."""
    cfg, run = trained
    argv = ["fxp", "--recipe", _recipe(tmp_path), "--device", "cpu",
            "--checkpoint_dir", run, "--fxp_mode", mode]
    assert cli.main(argv) == 0
    if mode == "inference":
        metrics = json.load(open(os.path.join(run, "fxp_val_metrics.json")))
        assert set(metrics) == {"Val Loss - fxp", "Val Acc - fxp",
                                "fxp_forward_seconds"}
        assert all(np.isfinite(v) for v in metrics.values())
    elif mode == "verify":
        stats = json.load(open(os.path.join(run, "verification",
                                            "stats.json")))
        assert len(stats["blocks"]) == 1 + 4 * cfg.n_layers
        assert "encoder.encoder.output" in stats["blocks"]
    else:
        path = os.path.join(run, "fxp_export")
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        assert manifest["format_version"] == 1
        assert manifest["model"]["type"] == "FxpRegressionModel"
        assert any("ssm" in k for k in np.load(
            os.path.join(path, "weights.npz")).files)
