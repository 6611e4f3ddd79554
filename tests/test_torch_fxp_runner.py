"""The port's fixed-point runner against the JAX package's, on the CPU:
the same numpy trees (a JAX ``convert`` run's frozen params and stats,
activation dump and golden inputs, at 2 layers, d_model 12, P 16 in 2
blocks, the NDNS widths) written into JAX's ``ArtifactStore`` and the
port's, then ``run_verification`` (equal ``matched_blocks``, block names
and statistics), ``export_bundle`` (equal manifest and npz arrays) and
``run_inference`` on the same synthetic validation clips (loss and
SI-SNR within 1e-3 relative, the bar of ``PERF.md`` §2; the mask on the
same features bit-equal).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp import runner as jax_runner
from sparsernns_tpu.quantize.convert import convert as jax_convert
from sparsernns_tpu.train import loop as jax_loop
from sparsernns_tpu.train.checkpoint import ArtifactStore as JaxStore
from sparsernns_tpu.train.checkpoint import CheckpointManager as JaxManager
from sparsernns_tpu.utils.config import RunConfig as JaxConfig
from sparsernns_tpu_torch.fxp import runner
from sparsernns_tpu_torch.train.checkpoint import ArtifactStore
from sparsernns_tpu_torch.utils.config import RunConfig

SHARED = dict(
    dataset="ndns", synthetic_data=True, synthetic_size=4,
    synthetic_seconds=0.5, n_layers=2, d_model=12, ssm_size_base=16,
    blocks=2, glu_variant="half1", clip_eigs=True, prenorm=True,
    batchnorm=True, bsz=2, relufication=True, p_dropout=0.0,
    convert_quantization="w8a16", block_t=32, store_activations=True,
    calibrate_quant=True, validate_static_quant=False,
    validate_engine=False)
ITEMS = ("frozen_params", "frozen_stats", "activations", "activation_inputs")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX config, port config): JAX's ``convert`` calibrates and dumps
    into its store, the same numpy trees are saved into the port's."""
    tmp = tmp_path_factory.mktemp("fxp_runner")
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
    jax_convert(jcfg)
    jstore = JaxStore(os.path.join(jcfg.checkpoint_dir, "conversion"))
    tstore = ArtifactStore(os.path.join(tcfg.checkpoint_dir, "conversion"))
    for name in ITEMS:
        tstore.save(name, jax.tree_util.tree_map(
            np.asarray, jax.device_get(jstore.load(name))))
    return jcfg, tcfg


def test_verification_equals_jax(runs):
    jcfg, tcfg = runs
    want = jax_runner.run_verification(jcfg)
    got = runner.run_verification(tcfg, device="cpu")
    assert got == want
    assert got["matched_blocks"] == 1 + 4 * SHARED["n_layers"]
    stats = [json.load(open(os.path.join(c.checkpoint_dir, "verification",
                                         "stats.json")))
             for c in (jcfg, tcfg)]
    assert stats[1] == stats[0]
    assert list(stats[1]["blocks"]) == list(stats[0]["blocks"])
    for c in (jcfg, tcfg):
        assert os.path.exists(os.path.join(c.checkpoint_dir, "verification",
                                           "README.md"))


def test_export_equals_jax(runs):
    jcfg, tcfg = runs
    paths = (jax_runner.export_bundle(jcfg),
             runner.export_bundle(tcfg, device="cpu"))
    manifests = [json.load(open(os.path.join(p, "manifest.json")))
                 for p in paths]
    assert manifests[1] == manifests[0]
    assert manifests[1]["format_version"] == 1
    want, got = (np.load(os.path.join(p, "weights.npz")) for p in paths)
    assert got.files == want.files and any("ssm" in k for k in got.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_inference_matches_jax(runs):
    """Loss and SI-SNR of the same validation clips within 1e-3 relative
    (the STFT features differ by float rounding between the packages); on
    the same features the two integer models give the same mask."""
    jcfg, tcfg = runs
    want = jax_runner.run_inference(jcfg)
    got = runner.run_inference(tcfg, device="cpu")
    assert set(got) == set(want) == {"Val Loss - fxp", "Val Acc - fxp",
                                     "fxp_forward_seconds"}
    for key in ("Val Loss - fxp", "Val Acc - fxp"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    written = json.load(open(os.path.join(tcfg.checkpoint_dir,
                                          "fxp_val_metrics.json")))
    assert written == got
    x = ArtifactStore(os.path.join(tcfg.checkpoint_dir, "conversion")).load(
        "activation_inputs")["x"]
    jm = jax_runner.load_fxp_model(jcfg)[0]
    tm = runner.load_fxp_model(tcfg, device="cpu")[0]
    np.testing.assert_array_equal(
        tm(torch.from_numpy(x)).data.numpy(),
        np.asarray(jm(jnp.asarray(x)).data))
