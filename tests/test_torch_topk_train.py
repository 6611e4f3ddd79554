"""Training with activation top-k (``topk=0.5, approx_topk=True``, with and
without relufication) on the CPU against the JAX package: the NDNS-loss
gradients and three train steps, at the size and bars of
``tests/test_torch_qat_train.py`` (gradients rtol 2e-3 + 1e-5·max|g|;
loss 1e-3 relative, parameters rtol 1e-3 + atol 1e-5). The model leaves
the whole-layer kernel for the unfused route, whose scans are the
differentiable stand-alone scan (K1 forward and reverse; its plain version
here)."""

import pytest

from tests.test_torch_qat_train import (TOPK, _grads_match, _steps_match,
                                        qat_config)


@pytest.mark.parametrize("name", list(TOPK))
def test_topk_ndns_loss_gradients_match_jax(name):
    """The four top-k sites (encoder, GLU input, states when relufied,
    layer output) under autograd on the unfused route: the threshold
    carries no gradient, as ``jnp.where``'s does not."""
    _grads_match(qat_config(**TOPK[name]), seed=12, atol_of=1e-5)


@pytest.mark.parametrize("name", list(TOPK))
def test_topk_three_train_steps_match_jax(name):
    _steps_match(qat_config(**TOPK[name]), seed=14)
