"""Plain PyTorch reference of S5 on LRA Path-X (arXiv:2208.04933, Table 11;
``run_lra_pathx.sh`` of github.com/lindermanlab/S5): the bidirectional
classification model in training mode, its cross entropy, the gradient
by autograd and AdamW under ``opt_config`` BfastandCdecay.

Written from the published model, in float32 with TF32 off, with no
kernel, cache or fused route; it imports nothing of the measured program.
Weights arrive as a dict of tensors under the names the benchmark gives
them (``benchmark/tasks/pathx.py``).

The model, per sequence of L steps of one feature (a 128 x 128 image
flattened row by row):

- encoder ``h = x W_e^T + b_e``;
- per layer: prenorm BatchNorm as flax computes it in training mode
  (``z = (h - mu) / sqrt(var + 1e-5) * w + b`` with the batch statistics
  over (B, L), the biased variance ``max(0, E[h^2] - E[h]^2)``); the
  bidirectional S5 mixer with zero-order hold of the clipped eigenvalues
  (``reference/ndns.discretize``): one B-projection ``bu = z B_bar^T``
  (H -> P complex), the forward states ``x_t = lam_bar x_{t-1} + bu_t``
  and the reverse states ``r_t = lam_bar r_{t+1} + bu_t``, concatenated
  to 2P complex states and projected by C of (H, 2P) complex:
  ``y = 2 Re(C [x; r]) + D z`` (conjugate symmetry; over 4P real columns;
  no state relu); ``x1 = gelu_tanh(y)``; the GLU ``half1`` gate
  ``g = x1 * sigmoid(x1 W_2^T + b_2)`` (dropout 0); residual ``h = g + h``;
- the mean over time, the decoder to 2 classes and ``log_softmax``;
- the loss: the mean cross entropy of the labels' log-probabilities.

Departure from the step-by-step recurrence: each scan is computed in
chunks of :data:`SCAN_CHUNK` steps (``reference/ndns.scan``): inside a
chunk the states are one product with the Toeplitz matrix of the powers
of lam_bar (from float64 polar form), and the chunks are chained by their
last state, one chunk after another. The reverse scan is the forward scan
of the time-reversed input, reversed. The tests hold it to the
step-by-step recurrence both ways. Each layer's forward is recomputed in
the backward (``torch.utils.checkpoint``), which gives the same values and
keeps a full-size step within one card.

AdamW under BfastandCdecay: ``Lambda_re``, ``Lambda_im``, the norms and
``log_step`` at ``ssm_lr_base`` with no weight decay; everything else (the
encoder, B, C, D, the gate dense and the decoder) at ``lr_factor *
ssm_lr_base`` with ``weight_decay``; both on the warm-up and cosine of
``reference/train.scheduled_lr``.

``prec="tf32"`` rounds every matrix product's operands to TF32
(``reference/ndns.mm``): the control of the correctness check.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import ndns
from benchmark.reference.train import BETAS, EPS, scheduled_lr

BN_EPS = 1e-5
#: steps per chunk of the chunked scans
SCAN_CHUNK = 128
#: BfastandCdecay's "ssm" group: learning rate ``ssm_lr_base``, no decay
SSM_KEYS = {"Lambda_re", "Lambda_im", "norm", "log_step"}

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    """Every float32 matrix product in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def scan(lam, bu, reverse: bool = False, prec: str = "fp32",
         chunk: int = SCAN_CHUNK):
    """States of ``x_t = lam x_{t-1} + bu_t`` (``reverse``: of
    ``x_t = lam x_{t+1} + bu_t``) from a zero state, by chunks
    (``reference/ndns.scan``). lam: (P,) pair; bu: (B, L, P) pair."""
    if not reverse:
        return ndns.scan(lam, bu, prec=prec, chunk=chunk)
    xs = ndns.scan(lam, (bu[0].flip(1), bu[1].flip(1)), prec=prec,
                   chunk=chunk)
    return xs[0].flip(1), xs[1].flip(1)


def batch_norm(w: Weights, pre: str, h: torch.Tensor) -> torch.Tensor:
    """flax's BatchNorm in training mode over (B, L)."""
    mean = h.mean((0, 1))
    var = ((h * h).mean((0, 1)) - mean * mean).clamp(min=0.0)
    return (h - mean) * (w[pre + "norm.weight"] * torch.rsqrt(var + BN_EPS)) \
        + w[pre + "norm.bias"]


def layer(w: Weights, pre: str, h: torch.Tensor, prec: str = "fp32",
          chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """One prenorm layer around the bidirectional mixer, (B, L, H)."""
    z = batch_norm(w, pre, h)
    lam, bbar = ndns.discretize(w, pre + "mixer.")
    w_b = torch.cat([bbar[0].T, bbar[1].T], dim=-1)              # (H, 2P)
    p = w_b.shape[-1] // 2
    bu = ndns.mm(z, w_b, prec)
    bu = (bu[..., :p], bu[..., p:])
    fwd = scan(lam, bu, prec=prec, chunk=chunk)
    rev = scan(lam, bu, reverse=True, prec=prec, chunk=chunk)
    xs = torch.cat([fwd[0], rev[0], fwd[1], rev[1]], dim=-1)     # (B, L, 4P)
    c = w[pre + "mixer.C"]                                       # (H, 2P, 2)
    w_c = 2.0 * torch.cat([c[..., 0].T, -c[..., 1].T], dim=0)   # (4P, H)
    y = ndns.mm(xs, w_c, prec) + w[pre + "mixer.D"] * z
    x1 = F.gelu(y, approximate="tanh")
    gate = torch.sigmoid(ndns.mm(x1, w[pre + "out2.weight"].T, prec)
                         + w[pre + "out2.bias"])
    return x1 * gate + h


def forward(w: Weights, x: torch.Tensor, prec: str = "fp32",
            chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """x (B, L, 1) -> log-probabilities (B, classes), every norm on the
    batch statistics. With gradients on, each layer is recomputed in the
    backward."""
    no_tf32()
    h = ndns.mm(x, w["encoder.encoder.weight"].T, prec) \
        + w["encoder.encoder.bias"]
    for pre in ndns.layer_prefixes(w):
        if torch.is_grad_enabled():
            h = checkpoint(layer, w, pre, h, prec, chunk, use_reentrant=False)
        else:
            h = layer(w, pre, h, prec, chunk)
    pooled = h.mean(dim=1)
    logits = ndns.mm(pooled, w["decoder.weight"].T, prec) + w["decoder.bias"]
    return F.log_softmax(logits, dim=-1)


def cross_entropy(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(1, labels[:, None].long()).mean()


def is_ssm(name: str) -> bool:
    return any(part in SSM_KEYS for part in name.split("."))


class AdamW:
    """AdamW under BfastandCdecay over a dict of leaf tensors, per
    parameter at step k (0 for the first update), with the rate ``lr_k``
    of its group: ``p <- p - lr_k * wd * p``, then
    ``m <- b1 m + (1 - b1) g``, ``v <- b2 v + (1 - b2) g^2`` and
    ``p <- p - lr_k * (m / (1 - b1^(k+1))) / (sqrt(v / (1 - b2^(k+1)))
    + eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor], recipe: dict,
                 steps_per_epoch: int):
        if recipe.get("opt_config") != "BfastandCdecay" or recipe.get(
                "grad_clip_threshold") is not None:
            raise NotImplementedError("the reference optimizer is AdamW "
                                      "BfastandCdecay without clipping")
        self.params = params
        self.ssm_lr = recipe["ssm_lr_base"]
        self.lr = recipe["lr_factor"] * recipe["ssm_lr_base"]
        self.wd = recipe["weight_decay"]
        self.total = steps_per_epoch * recipe["epochs"]
        self.warmup = steps_per_epoch * recipe["warmup_end"]
        self.lr_min = recipe["lr_min"]
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step_count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        k = self.step_count
        b1, b2 = BETAS
        for name, p in self.params.items():
            ssm = is_ssm(name)
            lr = scheduled_lr(self.ssm_lr if ssm else self.lr, k, self.total,
                              self.warmup, self.lr_min)
            wd = 0.0 if ssm else self.wd
            g = grads[name]
            p.mul_(1.0 - lr * wd)
            self.m[name].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[name] / (1.0 - b1 ** (k + 1))
            v_hat = self.v[name] / (1.0 - b2 ** (k + 1))
            p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
        self.step_count += 1


def train_steps(weights: Weights, param_names: List[str], batches,
                recipe: dict, steps_per_epoch: int, prec: str = "fp32",
                chunk: int = SCAN_CHUNK):
    """Run ``len(batches)`` steps from ``weights`` (copied). ``batches``:
    (inputs (B, L, 1), labels (B,)) each. Returns (losses, the first
    step's gradients by name, the parameters after the last step)."""
    w = {k: v.detach().clone() for k, v in weights.items()}
    params = {k: w[k] for k in param_names}
    opt = AdamW(params, recipe, steps_per_epoch)
    losses, first = [], None
    for x, labels in batches:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        logp = forward({**w, **leaves}, x, prec, chunk)
        loss = cross_entropy(logp, labels)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        for v in leaves.values():
            v.requires_grad_(False)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        del logp, loss, grads
    return losses, first, params
