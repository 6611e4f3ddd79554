"""HiPPO-LegS -> NPLR -> DPLR initialization for S5 state matrices, and
the parameter initializers of the S5 mixer and its dense layers.

Counterpart of ``sparsernns_tpu/models/ssm_init.py``. The eigendecomposition
runs in numpy on the host (it is tiny and runs once); the parameter
initializers draw from an explicit ``torch.Generator`` with the same
distributions as the initializers of the JAX package (the numbers
differ: the two frameworks' generators differ).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def make_hippo(n: int) -> np.ndarray:
    """N x N HiPPO-LegS matrix (negated)."""
    p = np.sqrt(1 + 2 * np.arange(n))
    a = p[:, None] * p[None, :]
    a = np.tril(a) - np.diag(np.arange(n))
    return -a


def make_nplr_hippo(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HiPPO plus the rank-1 term and input matrix for NPLR form."""
    hippo = make_hippo(n)
    p = np.sqrt(np.arange(n) + 0.5)
    b = np.sqrt(2 * np.arange(n) + 1.0)
    return hippo, p, b


def make_dplr_hippo(n: int):
    """DPLR decomposition of HiPPO-LegS: (Lambda, P, B, V, B_orig)."""
    a, p, b = make_nplr_hippo(n)
    s = a + p[:, None] * p[None, :]
    s_diag = np.diagonal(s)
    lambda_real = np.mean(s_diag) * np.ones_like(s_diag)
    # S is normal: diagonalize the Hermitian matrix S * -1j.
    lambda_imag, v = np.linalg.eigh(s * -1j)
    p_out = v.conj().T @ p
    b_out = v.conj().T @ b
    return lambda_real + 1j * lambda_imag, p_out, b_out, v, b


def _block_diag(blocks):
    n = len(blocks)
    r, c = blocks[0].shape
    out = np.zeros((n * r, n * c), dtype=blocks[0].dtype)
    for i, blk in enumerate(blocks):
        out[i * r:(i + 1) * r, i * c:(i + 1) * c] = blk
    return out


def blocked_dplr_init(ssm_size: int, blocks: int, conj_sym: bool = True):
    """Block-diagonal HiPPO init.

    Returns a dict with Lambda (complex (P,)), V ((ssm_size, P) complex),
    Vinv ((P, ssm_size) complex) and P, the effective state size
    (``ssm_size // 2`` with conj_sym)."""
    block_size = ssm_size // blocks
    lam, _, _, v, _ = make_dplr_hippo(block_size)
    if conj_sym:
        block_size_eff = block_size // 2
        ssm_size_eff = ssm_size // 2
    else:
        block_size_eff = block_size
        ssm_size_eff = ssm_size
    lam = lam[:block_size_eff]
    v = v[:, :block_size_eff]
    vc = v.conj().T
    lam_full = (lam * np.ones((blocks, block_size_eff))).ravel()
    return {
        "Lambda": lam_full.astype(np.complex64),
        "V": _block_diag([v] * blocks).astype(np.complex64),
        "Vinv": _block_diag([vc] * blocks).astype(np.complex64),
        "P": ssm_size_eff,
    }


# ---- torch initializers (the JAX package's distributions) ----

#: std of a unit normal truncated to [-2, 2]; variance scaling
#: divides by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, generator: Optional[torch.Generator] = None,
                 fan_in: Optional[int] = None) -> torch.Tensor:
    """LeCun normal as the JAX package draws it: a normal truncated to ±2
    std with variance 1/fan_in. ``fan_in`` defaults to the JAX rule: in
    axis -2, out axis -1, the remaining axes as receptive field."""
    if fan_in is None:
        fan_in = shape[-2] * math.prod(shape[:-2])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    out = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return out * std


def init_log_steps(p: int, dt_min: float, dt_max: float,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """(P, 1) log-timescales, log-uniform in [dt_min, dt_max]."""
    u = torch.rand((p, 1), generator=generator)
    return u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)


def init_vinv_b(vinv: np.ndarray, h: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample B (ssm_size, H) in the original basis, project by Vinv, return
    the (P, H, 2) real-pair parameter."""
    b = lecun_normal((vinv.shape[1], h), generator)
    vr = torch.from_numpy(np.ascontiguousarray(vinv.real, np.float32))
    vi = torch.from_numpy(np.ascontiguousarray(vinv.imag, np.float32))
    return torch.stack([vr @ b, vi @ b], dim=-1)


def project_cv(c: torch.Tensor, v: np.ndarray) -> torch.Tensor:
    """Project a complex C (H, ssm_size, 2) by V: cV = (cr@Vr − ci@Vi) +
    i·(cr@Vi + ci@Vr), returned as (H, P, 2)."""
    cr, ci = c[..., 0], c[..., 1]
    vr = torch.from_numpy(np.ascontiguousarray(v.real, np.float32))
    vi = torch.from_numpy(np.ascontiguousarray(v.imag, np.float32))
    return torch.stack([cr @ vr - ci @ vi, cr @ vi + ci @ vr], dim=-1)


def init_cv(v: np.ndarray, h: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample complex C as (H, ssm_size, 2) (lecun_normal), project by V,
    return the (H, P, 2) real-pair parameter."""
    return project_cv(lecun_normal((h, v.shape[0], 2), generator), v)


def trunc_standard_normal(h: int, n: int,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Per-row lecun_normal sample of C, shape (H, n, 2)."""
    return torch.cat([lecun_normal((1, n, 2), generator, fan_in=n)
                      for _ in range(h)], dim=0)
