"""The port's activation top-k ops (``ops/topk.py``) against the JAX
package's (``sparsernns_tpu/ops/topk.py``) on the same numpy inputs: exact
equality, including ties, ``k >= n`` and leading shapes. On the CPU
``jax.lax.approx_max_k`` is exact, so both keep the same entries. Also
the recipe keys that switch top-k on, and what the port refuses."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops import topk as jax_topk
from sparsernns_tpu_torch.ops import topk
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.utils.config import RunConfig


def _both(fn_name, x, *args):
    ref = np.asarray(getattr(jax_topk, fn_name)(jnp.asarray(x), *args))
    out = getattr(topk, fn_name)(torch.from_numpy(x), *args).numpy()
    return out, ref


@pytest.mark.parametrize("shape,k", [((7, 16), 8), ((2, 5, 12), 6),
                                     ((3, 4, 2, 10), 1), ((9, 192), 96),
                                     ((4, 16), 15)])
@pytest.mark.parametrize("fn", ["top_k_sparsity", "relu_top_k_sparsity"])
def test_top_k_equals_jax(fn, shape, k):
    x = np.random.RandomState(sum(shape) + k).randn(*shape).astype(
        np.float32)
    out, ref = _both(fn, x, k)
    assert out.shape == ref.shape == x.shape
    np.testing.assert_array_equal(out, ref)
    kept = (out != 0).sum(-1)
    assert (kept <= k).all() and (kept >= (1 if "relu" in fn else k)).all()


def test_top_k_ties_keep_more_than_k():
    """Entries equal to the k-th value are all kept, in both packages."""
    x = np.array([[3.0, 1.0, 2.0, 2.0, 2.0, -1.0],
                  [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                  [-3.0, -1.0, -2.0, -2.0, 0.0, -5.0]], np.float32)
    out, ref = _both("top_k_sparsity", x, 2)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal((out != 0).sum(-1), [4, 6, 1])
    assert out[2, 2] == out[2, 3] == 0 and out[2, 1] == -1.0
    out, ref = _both("relu_top_k_sparsity", x, 2)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("k", [10, 11, 100])
def test_top_k_passes_through_at_k_ge_n(k):
    x = np.random.RandomState(k).randn(3, 10).astype(np.float32)
    out, ref = _both("top_k_sparsity", x, k)
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(ref, x)
    out, ref = _both("relu_top_k_sparsity", x, k)
    np.testing.assert_array_equal(out, np.maximum(x, 0))
    np.testing.assert_array_equal(out, ref)


def test_recipe_with_topk_loads(tmp_path):
    """``topk`` / ``approx_topk`` are recipe keys of the port's RunConfig,
    as of the JAX package's."""
    path = tmp_path / "topk.json"
    path.write_text(json.dumps({"topk": 0.5, "approx_topk": True,
                                "relufication": True}))
    cfg = RunConfig().with_recipe(str(path))
    assert cfg.topk == 0.5 and cfg.approx_topk and cfg.relufication
    assert RunConfig().topk == 1.0 and not RunConfig().approx_topk


def test_topk_model_refusals():
    """Training with top-k builds a training model (the unfused route);
    exact top-k raises, as in the JAX package."""
    cfg = dataclasses.replace(RunConfig(), n_layers=1, d_model=8,
                              ssm_size_base=8, blocks=1, topk=0.5,
                              approx_topk=True, scan_mode="fused")
    trainer = build_model(cfg, 5, 5, training=True, device="cpu")
    assert trainer.training
    assert trainer.encoder.layers[0].mixer.layer_tail_operands() is None
    model = build_model(cfg, 5, 5, device="cpu")
    assert not model.training
    assert model.encoder.layers[0].mixer.layer_tail_operands() is None
    with pytest.raises(NotImplementedError, match="exact top-k"):
        build_model(dataclasses.replace(cfg, approx_topk=False), 5, 5,
                    device="cpu")
