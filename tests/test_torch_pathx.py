"""S5 on LRA Path-X in the port (``benchmark/configs/s5_pathx.json``: the
bidirectional classification model, BatchNorm, ``complex_normal`` C, the
mean pool to 2 classes, AdamW under BfastandCdecay), held to the
benchmark's plain reference (``benchmark/reference/pathx.py``) at the
configuration's small sizes on the CPU (``benchmark/tasks/pathx.TINY``:
2 layers, H 16, P 8, L 64, B 4), on seeded random weights drawn as the
benchmark draws them: one training-mode forward, every leaf's gradient,
three ``make_classification_train_step`` steps; and the reference's
chunked scan held to the step-by-step recurrence.

The port runs the plain sequential scan on the CPU, the reference its
chunked scan (chunks of 16 here, so that four chunks chain), so the two
agree up to float32 round-off in another order; each tolerance says how
far that reaches and how far TF32 operands, the precision below the
configuration's, move the same number."""

import dataclasses
import json
import os

import pytest
import torch

from benchmark.entries.train_step import compare
from benchmark.reference import pathx as ref
from benchmark.tasks import pathx as task
from benchmark.traffic import synthetic_pathx
from sparsernns_tpu_torch.train.loop import build_model, create_run_state
from sparsernns_tpu_torch.train.steps import make_classification_train_step
from sparsernns_tpu_torch.utils.config import RunConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CHUNK = 16
#: with one step an epoch the three steps run at the schedule's full rates
#: (the warm-up is one step), so the parameters move far above round-off
STEPS_PER_EPOCH = 1


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _case(seed: int):
    """(recipe, weights, model, inputs (B, L, 1), labels (B,)) at TINY."""
    conf = _load("configs", "s5_pathx.json")
    conf["recipe"] = {**conf["recipe"], **task.TINY["recipe"]}
    recipe = task.recipe_of(conf)
    mix = {**_load("traffic", "pathx_b32.json"), **task.TINY["mix"]}
    inputs, labels = synthetic_pathx.make_pool(mix, seed,
                                               torch.device("cpu"))
    x, y = inputs[:mix["batch"]], labels[:mix["batch"]]
    w = task.make_weights(recipe, 1, 2, conf["init"], seed, "cpu")
    cfg = dataclasses.replace(RunConfig(), **recipe)
    model = build_model(cfg, 1, 2, training=True, device="cpu")
    missing, unexpected = model.load_state_dict(w, strict=False)
    assert not unexpected
    assert all("num_batches_tracked" in k for k in missing)
    return recipe, cfg, w, model, x, y


def _params(model):
    return [n for n, _ in model.named_parameters()]


def test_the_configuration_is_the_published_one():
    """6 bidirectional layers of H 128, P 128 (ssm_size_base 256 halved by
    conj_sym), 16 blocks, complex_normal C, BatchNorm, dropout 0, B 32,
    L 16 384, through the program's kernel route; nothing reduced."""
    conf = _load("configs", "s5_pathx.json")
    recipe = task.recipe_of(conf)
    assert (recipe["n_layers"], recipe["d_model"], task.states(recipe),
            recipe["blocks"]) == (6, 128, 128, 16)
    assert recipe["bidirectional"] and recipe["batchnorm"]
    assert recipe["C_init"] == "complex_normal"
    assert recipe["p_dropout"] == 0.0 and recipe["scan_mode"] == "fused"
    assert conf["reduced"] == []
    mix = _load("traffic", "pathx_b32.json")
    assert (mix["batch"], mix["side"] ** 2) == (32, 16384)


@pytest.mark.parametrize("seed", [3, 2147483653])
def test_forward_log_probabilities_and_loss(seed):
    _, _, w, model, x, y = _case(seed)
    with torch.no_grad():
        logp = model(x)
        want = ref.forward(w, x, chunk=CHUNK)
    # float32 round-off of the two scan orders and the products: the
    # log-probabilities agree to 2.4e-7 on four seeds (TF32 operands move
    # them by 2.2e-4 and more)
    torch.testing.assert_close(logp, want, rtol=0, atol=2e-6)
    loss = -logp.gather(1, y[:, None]).mean()
    assert abs(float(loss) - float(ref.cross_entropy(want, y))) \
        <= 2e-6 * abs(float(loss))


@pytest.mark.parametrize("seed", [3, 2147483653])
def test_every_leaf_gradient(seed):
    from sparsernns_tpu_torch.train.losses import cross_entropy_loss
    _, _, w, model, x, y = _case(seed)
    names = _params(model)
    cross_entropy_loss(model(x), y).backward()
    leaves = {k: w[k].clone().requires_grad_(True) for k in names}
    loss = ref.cross_entropy(ref.forward({**w, **leaves}, x, chunk=CHUNK), y)
    grads = dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))
    norms = {k: float(g.norm()) for k, g in grads.items()}
    median = float(torch.tensor(list(norms.values())).median())
    for name, p in model.named_parameters():
        # each leaf within 1e-4 of its own gradient's norm or the median
        # leaf's, whichever is larger: float32 round-off of two summation
        # orders over B * L rows reads at most 1.5e-5 on four seeds (TF32
        # operands: 3.3e-4 and more)
        gap = float((p.grad - grads[name]).norm())
        assert gap <= 1e-4 * max(norms[name], median), (name, gap,
                                                       norms[name])


@pytest.mark.parametrize("seed", [3, 2147483653])
def test_three_train_steps_under_bfast_and_c_decay(seed):
    recipe, cfg, w, model, x, y = _case(seed)
    names = _params(model)
    init = {k: w[k].clone() for k in names}
    state = create_run_state(cfg, model, STEPS_PER_EPOCH)
    labels = {g["label"]: sorted(n for n, p in model.named_parameters()
                                 if any(p is q for q in g["params"]))
              for g in state.optimizer.param_groups}
    assert labels["ssm"] == sorted(n for n in names if ref.is_ssm(n))
    step = make_classification_train_step(model)
    batches = [(x.roll(i, 0), y.roll(i, 0)) for i in range(3)]
    losses, first = [], None
    for i, (xb, yb) in enumerate(batches):
        _, metrics = step(state, xb, yb)
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in model.named_parameters()}
    prog = dict(losses=losses, first_grad=first, init=init,
                params={n: p.detach() for n, p in model.named_parameters()})
    want = ref.train_steps(w, names, batches, recipe, STEPS_PER_EPOCH,
                           chunk=CHUNK)
    numbers, _ = compare(prog, want)
    # losses within 2e-6, first gradients within 1e-4 and the three
    # steps' change within 4e-5 by the benchmark's measure: float32
    # round-off carried through AdamW's steps reads at most 1.1e-7,
    # 1.1e-5 and 4.3e-6 on four seeds; TF32 operands at least 8.9e-5,
    # 2.5e-4 and 1.0e-4 on the same (a state left unchanged reads a
    # change gap of 1)
    assert numbers["loss_gap"] <= 2e-6, numbers
    assert numbers["grad_gap"] <= 1e-4, numbers
    assert numbers["change_gap"] <= 4e-5, numbers


def _recurrence(lam, bu, reverse):
    """x_t = lam x_{t-1} + bu_t (reverse: x_{t+1}), step by step in
    float64 complex."""
    lam = torch.complex(lam[0].double(), lam[1].double())
    u = torch.complex(bu[0].double(), bu[1].double())
    x = torch.zeros_like(u[:, 0])
    out = [None] * u.shape[1]
    steps = range(u.shape[1] - 1, -1, -1) if reverse else range(u.shape[1])
    for t in steps:
        x = lam * x + u[:, t]
        out[t] = x
    return torch.stack(out, 1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("chunk", [16, 24, 64, 100])
def test_chunked_scan_is_the_recurrence(reverse, chunk):
    """Chunks that divide L = 64 (16, 64), that do not (24), and one longer
    than L (100), both directions, against the step-by-step recurrence."""
    g = torch.Generator().manual_seed(chunk)
    p = 8
    radius = torch.exp(-torch.rand(p, generator=g) * 0.05)   # |lam| near 1
    angle = torch.rand(p, generator=g) * 0.5
    lam = (radius * torch.cos(angle), radius * torch.sin(angle))
    bu = (torch.randn((3, 64, p), generator=g),
          torch.randn((3, 64, p), generator=g))
    xs = ref.scan(lam, bu, reverse=reverse, chunk=chunk)
    want = _recurrence(lam, bu, reverse)
    # float32 states of magnitude up to ~20: within 1e-5 of the largest
    got = torch.complex(xs[0].double(), xs[1].double())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
