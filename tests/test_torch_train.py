"""The port's training path against the JAX package's at a small size: the
training-mode forward (batch statistics, running statistics, gradients of
the NDNS loss), the train step and its microbatch form, checkpoints and the
epoch loop. The same flax weights (carried over by ``weights.from_flax``)
and the same numpy audio go through both; the JAX model runs its Pallas
kernels in interpret mode with an explicit ``block_t``. Dropout is 0 where
numbers are compared: the two frameworks draw different masks from the
same seed by construction."""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.models.seq_model import RegressionModel as JaxRegression
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import \
    blocked_dplr_init as jax_blocked_dplr_init
from sparsernns_tpu.ops.stft import stft_splitter as jax_stft
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.losses import \
    STFT_MAG_MEAN, ndns_loss_from_mask_tm as jax_ndns_loss
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.ops.stft import stft_splitter
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
from sparsernns_tpu_torch.train.state import TrainState, count_params
from sparsernns_tpu_torch.train.steps import (make_ndns_eval_step,
                                              make_ndns_train_step)
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import from_flax, grads_to_flax, to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_IO = 257
AUDIO = 36 * 128            # 37 STFT frames


def small_config(**kw) -> RunConfig:
    base = dict(n_layers=2, d_model=16, ssm_size_base=16, blocks=2,
                p_dropout=0.0, bsz=2, epochs=4, synthetic_data=True,
                synthetic_size=4, synthetic_seconds=AUDIO / 16000)
    return dataclasses.replace(
        RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json")),
        **{**base, **kw})


def jax_training_model(cfg: RunConfig, block_t: int = 16):
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
        glu_variant=cfg.glu_variant, training=True,
        relufication=cfg.relufication)


def paired(cfg: RunConfig, seed: int = 0):
    """(jax training model, its variables with random BatchNorm statistics
    as numpy, the port's training model on the CPU with the same weights)."""
    jm = jax_training_model(cfg)
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, D_IO), jnp.float32)))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                          seed=seed)
    tm.load_state_dict(from_flax(variables["params"], stats))
    return jm, {"params": variables["params"], "batch_stats": stats}, tm


def audio_batch(batch: int, seed: int):
    rng = np.random.RandomState(seed)
    t = np.arange(AUDIO) / 16000.0
    clean = np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t
                                   + rng.uniform(0, 6))
                      for _ in range(batch)]).astype(np.float32)
    noisy = (clean + 0.1 * rng.randn(batch, AUDIO)).astype(np.float32)
    return noisy, clean


def jax_features(noisy, clean):
    nm, nph = jax_stft(jnp.asarray(noisy))
    cm, _ = jax_stft(jnp.asarray(clean))
    return nm, nph, cm, jnp.asarray(clean)


def torch_features(noisy, clean):
    nm, nph = stft_splitter(torch.from_numpy(noisy))
    cm, _ = stft_splitter(torch.from_numpy(clean))
    return nm, nph, cm, torch.from_numpy(clean)


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(ours, theirs, rtol, atol_of=None, atol=0.0):
    a, b = leaves(ours), leaves(theirs)
    assert set(a) == set(b)
    for key, ref in b.items():
        tol = atol if atol_of is None else atol_of * np.abs(ref).max()
        np.testing.assert_allclose(a[key], ref, rtol=rtol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("glu,relu,n_layers", [("half1", False, 2),
                                               ("full", True, 1)])
def test_training_forward_and_batch_stats_match_flax(glu, relu, n_layers):
    """Output 1e-4 (the bar of the eval forward), updated running
    statistics 1e-6 (one momentum step of f32 means over B·L rows)."""
    cfg = small_config(glu_variant=glu, relufication=relu,
                       n_layers=n_layers)
    jm, variables, tm = paired(cfg, seed=1)
    x = np.random.RandomState(2).randn(2, 37, D_IO).astype(np.float32)
    ref, mod = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    assert tm.training
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    _, stats = to_flax(tm)
    assert_trees_close(stats, mod["batch_stats"], rtol=0, atol=1e-6)
    # biased variance and the JAX momentum convention, not BatchNorm1d's
    layer = tm.encoder.layers[0]
    assert layer.bn_momentum == cfg.bn_momentum == 0.95
    # eval mode reads the statistics and leaves them alone
    tm.eval()
    before = layer.norm.running_mean.clone()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert torch.equal(layer.norm.running_mean, before)


def test_ndns_loss_gradients_match_flax():
    """Gradients of the NDNS loss for every parameter, through both layers'
    kernels' backward and the BatchNorm statistics. rtol 2e-3 and 1e-5 of
    each leaf's largest gradient: the Pallas adjoint sums per block of 16
    rows and the loss passes through an iSTFT and a log."""
    cfg = small_config()
    jm, variables, tm = paired(cfg, seed=3)
    noisy, clean = audio_batch(2, seed=4)
    nm, nph, cm, cl = jax_features(noisy, clean)

    def loss_fn(params):
        nm_tm = jnp.transpose(nm, (0, 2, 1))
        out, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            nm_tm - STFT_MAG_MEAN, mutable=["batch_stats"])
        return jax_ndns_loss(out, nm_tm, jnp.transpose(nph, (0, 2, 1)),
                             jnp.transpose(cm, (0, 2, 1)), cl)[0]

    ref_loss, ref = jax.value_and_grad(loss_fn)(variables["params"])
    from sparsernns_tpu_torch.train.steps import _loss
    loss, _ = _loss(tm, None, *torch_features(noisy, clean))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    assert all(p.grad is not None for p in tm.parameters())
    assert_trees_close(grads_to_flax(tm), ref, rtol=2e-3, atol_of=1e-5)


def test_dropout_mask_structure():
    """Dropout > 0 cannot be compared number by number; the structure is:
    masks of shape (B, 1, H), so constant along L, values 0 or 1/keep, two
    separate draws, other masks at every step, the same masks from the
    same generator state."""
    cfg = small_config(p_dropout=0.25)
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    layer = tm.encoder.layers[0]
    assert layer.dropout == 0.25
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    m1, m2 = layer.dropout_masks(64, "cpu", gen)
    assert m1.shape == m2.shape == (64, 1, cfg.d_model)
    keep = 0.75
    for m in (m1, m2):
        assert set(np.unique(m.numpy())) == {0.0, np.float32(1 / keep)}
        assert abs((m > 0).float().mean().item() - keep) < 0.05
    assert not torch.equal(m1, m2)
    m1_next, _ = layer.dropout_masks(64, "cpu", gen)
    assert not torch.equal(m1, m1_next)
    gen.set_state(start)
    again, _ = layer.dropout_masks(64, "cpu", gen)
    assert torch.equal(m1, again)
    # through the model: equal generator states give equal outputs
    x = torch.randn(2, 20, D_IO, generator=torch.Generator().manual_seed(6))
    gen.set_state(start)
    y1 = tm(x, gen)
    y2 = tm(x, gen)
    gen.set_state(start)
    y3 = tm(x, gen)
    assert torch.equal(y1, y3) and not torch.equal(y1, y2)
    with pytest.raises(ValueError, match="Generator"):
        tm(x)                               # dropout needs the generator
    tm.eval()
    with torch.no_grad():
        assert torch.equal(tm(x), tm(x, gen))    # eval: no dropout
    none_layer = loop.build_model(
        small_config(p_dropout=0.25, glu_variant="none"), D_IO, D_IO,
        training=True, device="cpu").encoder.layers[0]
    assert none_layer.dropout_masks(2, "cpu", gen)[1] is None


def _paired_states(cfg, seed, steps_per_epoch=1):
    jm, variables, tm = paired(cfg, seed=seed)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay,
        total_steps=steps_per_epoch * cfg.epochs,
        warmup_steps=steps_per_epoch * cfg.warmup_end)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"])
    return jm, jstate, tm, loop.create_run_state(cfg, tm, steps_per_epoch)


def test_three_train_steps_match_jax():
    """Three optimizer steps (noBCdecay, weight decay 0.04, warm-up cosine)
    on three batches. Loss 1e-3 relative per step; parameters after step 3
    rtol 1e-3 (atol 1e-5: Adam's first steps move a parameter by about the
    learning rate whatever its gradient's size, so a gradient that differs
    in the fourth digit moves it differently by that much); running
    statistics 1e-5."""
    cfg = small_config()
    jm, jstate, tm, state = _paired_states(cfg, seed=7)
    jstep = jax_train_step(jm, batchnorm=True)
    step = make_ndns_train_step(tm)
    start, _ = to_flax(tm)
    for i in range(3):
        noisy, clean = audio_batch(2, seed=20 + i)
        jstate, jm_metrics = jstep(jstate, jax.random.PRNGKey(0),
                                   *jax_features(noisy, clean))
        state, metrics = step(state, *torch_features(noisy, clean))
        for key in ("loss", "si_snr", "grad_norm", "grad_norm/encoder",
                    "grad_norm/decoder"):
            assert metrics[key].item() == pytest.approx(
                float(jm_metrics[key]), rel=1e-3, abs=1e-3), (i, key)
    assert state.step == 3 == int(jstate.step)
    params, stats = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    assert_trees_close(stats, jax.device_get(jstate.batch_stats), rtol=0,
                       atol=1e-5)
    moved = leaves(params)
    for key, val in leaves(start).items():
        assert not np.array_equal(val, moved[key]), key


def test_microbatch_step_matches_jax_microbatch_step():
    """B = 4 as 2 chunks of 2 with BatchNorm: per-chunk statistics, running
    statistics moved chunk by chunk, gradients sum / k, one update. Same
    limits as the full step."""
    cfg = small_config(n_layers=1, bsz=4, microbatch=2)
    jm, jstate, tm, state = _paired_states(cfg, seed=8)
    jstep = jax_train_step(jm, batchnorm=True, microbatch=2)
    step = make_ndns_train_step(tm, microbatch=2)
    noisy, clean = audio_batch(4, seed=30)
    jstate, jm_metrics = jstep(jstate, jax.random.PRNGKey(0),
                               *jax_features(noisy, clean))
    state, metrics = step(state, *torch_features(noisy, clean))
    for key in ("loss", "si_snr", "grad_norm"):
        assert metrics[key].item() == pytest.approx(
            float(jm_metrics[key]), rel=1e-3, abs=1e-3), key
    params, stats = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    assert_trees_close(stats, jax.device_get(jstate.batch_stats), rtol=0,
                       atol=1e-5)
    assert state.step == 1
    with pytest.raises(ValueError, match="divisible"):
        make_ndns_train_step(tm, microbatch=3)(
            state, *torch_features(noisy, clean))


def test_microbatch_step_with_batchnorm_runs_and_learns():
    cfg = small_config(n_layers=1, d_model=8, ssm_size_base=8, blocks=1,
                       bsz=4)
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    state = loop.create_run_state(cfg, tm, steps_per_epoch=25)
    step = make_ndns_train_step(tm, microbatch=2)
    feats = torch_features(*audio_batch(4, seed=40))
    init_stats = [b.clone() for b in tm.buffers()]
    losses = []
    for _ in range(4):
        state, metrics = step(state, *feats)
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert any(not torch.equal(a, b)
               for a, b in zip(init_stats, tm.buffers()))
    m = make_ndns_eval_step(tm)(*feats)
    assert np.isfinite(m["loss"].item()) and tm.training


def test_what_still_raises():
    # LayerNorm layers train on the tail kernel's non-affine mode, postnorm
    # layers on the unfused route (the kernels' plain versions here)
    for kw in (dict(batchnorm=False), dict(prenorm=False)):
        model = loop.build_model(small_config(**kw), D_IO, D_IO,
                                 training=True, device="cpu")
        out = model(torch.zeros(1, 8, D_IO))
        out.sum().backward()
        assert all(p.grad is not None for p in model.parameters())
    # the sequence-parallel scan needs a mesh with a seq axis
    with pytest.raises(ValueError, match="scan_mode='sp'"):
        loop.build_model(small_config(scan_mode="sp"), D_IO, D_IO,
                         training=True, device="cpu")
    # the associative, the sequential and the blocked scan train (plain
    # PyTorch, on the unfused route)
    for mode in ("associative", "sequential", "blocked"):
        assoc = loop.build_model(small_config(scan_mode=mode), D_IO, D_IO,
                                 training=True, device="cpu")
        assoc(torch.zeros(1, 8, D_IO)).sum().backward()
        assert all(p.grad is not None for p in assoc.parameters())
    tm = loop.build_model(small_config(), D_IO, D_IO, training=True,
                          device="cpu")
    # every pruning recipe is accepted; an unknown name is not
    pruned = loop.create_run_state(
        small_config(pruning="iterative-ste-mag-0.5"), tm, 1)
    assert pruned.pruner.cfg.final_sparsity == 0.5 and pruned.masks
    with pytest.raises(ValueError, match="pruning"):
        loop.create_run_state(small_config(pruning="magnitude-0.5"), tm, 1)
    # a mesh on a world of one rank would fake the parallel run
    with pytest.raises(ValueError, match="mesh"):
        loop.train(small_config(mesh_model=2), device="cpu")
    # synthetic_data false reads the WAV corpus where its three
    # directories are set, else the synthetic set, as in the JAX package
    env = {f"NDNS_{k}_SET": os.environ.pop(f"NDNS_{k}_SET", None)
           for k in ("TRAIN", "VALIDATION", "TEST")}
    try:
        loader = loop.build_dataset(small_config(synthetic_data=False))[0]
    finally:
        os.environ.update({k: v for k, v in env.items() if v is not None})
    assert type(loader.dataset).__name__ == "SyntheticNDNS"
    full = RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json"))
    flagship = loop.build_model(full, D_IO, D_IO, training=True,
                                device="cpu")
    assert flagship.training and count_params(flagship) > 400_000
    assert flagship.encoder.layers[0].dropout == full.p_dropout == 0.1


def test_checkpoint_round_trip(tmp_path):
    cfg = small_config(p_dropout=0.1, n_layers=1)
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    state = loop.create_run_state(cfg, tm, steps_per_epoch=2)
    step = make_ndns_train_step(tm)
    feats = torch_features(*audio_batch(2, seed=50))
    for _ in range(2):
        state, _ = step(state, *feats)
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    meta = {"next_epoch": 1, "best_val_loss": 101.5}
    mngr.save(0, state, metadata=meta)
    saved_model = {k: v.clone() for k, v in tm.state_dict().items()}
    saved_opt = copy.deepcopy(state.optimizer.state_dict())
    saved_gen = state.generator.get_state().clone()
    for _ in range(2):                          # move on past the save
        state, after = step(state, *feats)
    assert state.step == 4

    tm2 = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                           seed=99)
    fresh = loop.create_run_state(cfg, tm2, steps_per_epoch=2)
    fresh, restored_meta = mngr.restore(fresh)
    assert restored_meta == meta and fresh.step == 2
    for key, val in tm2.state_dict().items():
        assert torch.equal(val, saved_model[key]), key
    assert torch.equal(fresh.generator.get_state(), saved_gen)
    new_opt = fresh.optimizer.state_dict()
    assert new_opt["param_groups"] == saved_opt["param_groups"]
    assert set(new_opt["state"]) == set(saved_opt["state"])
    for idx, entry in saved_opt["state"].items():
        for key, val in entry.items():
            assert torch.equal(torch.as_tensor(new_opt["state"][idx][key]),
                               torch.as_tensor(val)), (idx, key)
    # the restored run repeats the original's next steps bit for bit
    step2 = make_ndns_train_step(tm2)
    for _ in range(2):
        fresh, again = step2(fresh, *feats)
    assert again["loss"].item() == after["loss"].item()

    # weights only: a fresh optimizer, step and generator
    tm3 = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                           seed=98)
    reset = loop.create_run_state(cfg, tm3, steps_per_epoch=2)
    reset = mngr.restore_params_only(reset, step=0)
    assert reset.step == 0 and not reset.optimizer.state_dict()["state"]
    for key, val in tm3.state_dict().items():
        assert torch.equal(val, saved_model[key]), key

    for s in (1, 2, 3):
        mngr.save(s, state)
    assert mngr.all_steps() == [2, 3] and mngr.latest_step() == 3
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.latest_step() is None
    assert empty.restore(reset) == (reset, None)


def test_train_two_epochs_and_resume(tmp_path):
    cfg = small_config(epochs=2, checkpoint_dir=str(tmp_path / "run"),
                       n_layers=1, p_dropout=0.1)
    out = loop.train(cfg, device="cpu")
    meta, state = out["metadata"], out["state"]
    assert isinstance(state, TrainState) and state.step == 4  # 2 x 2 batches
    assert meta["next_epoch"] == 2 and np.isfinite(meta["best_val_loss"])
    assert {"train_loss", "val_loss", "test_si_snr", "regular/lr",
            "train_grad_norm"} <= set(meta["last_log"])
    mngr = CheckpointManager(cfg.checkpoint_dir)
    assert mngr.all_steps() == [0, 1]
    best = CheckpointManager(os.path.join(cfg.checkpoint_dir, "best"))
    assert best.all_steps() == [meta["best_epoch"]]
    # a finished run resumes to nothing; one more epoch resumes at epoch 2
    again = loop.train(cfg, device="cpu")
    assert again["state"].step == 4 and again["metadata"]["next_epoch"] == 2
    more = loop.train(dataclasses.replace(cfg, epochs=3), device="cpu")
    assert more["state"].step == 6 and more["metadata"]["next_epoch"] == 3
    assert mngr.all_steps() == [0, 1, 2]
    # weights only, a fresh optimizer: the step count starts again
    reset = loop.train(dataclasses.replace(cfg, epochs=3,
                                           reset_optimizer=True),
                       device="cpu")
    assert reset["state"].step == 6     # 3 epochs from epoch 0
    plateau = loop.train(small_config(epochs=2, n_layers=1,
                                      lr_schedule="plateau",
                                      plateau_patience=0), device="cpu")
    assert "plateau_lr" in plateau["metadata"]
