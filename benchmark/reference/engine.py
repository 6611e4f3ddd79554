"""Plain reference of the w8a16 serving engine of the NDNS model: the
static-quantization recipe ``w8a16`` of the model in ``ndns.py``, from the
float weights and the calibration inputs, with no kernel. It works out
again everything a serving engine derives at set-up:

- calibration: the eval forward of the float model, its denses (encoder,
  GLU gate, decoder) on their 8-bit weight grid, over the calibration
  inputs; each layer's state absmax (real and imaginary part apart) over
  the first input, and its output (the residual stream) absmax over all;
  a scale is ``2^round(log2(absmax / (2^(bits-1) - 1)))``. (The first
  input runs unquantized; a later one requantizes the state every step on
  the first one's grid, which clips it to that range, so its absmax
  cannot change the state scale. Its state requant is left out of the
  residual's observation: at 16 bits it moves the absmax by a few parts
  in 10^5, short of a power of two.)
- packing: Λ̄ and B̄ by zero-order hold in float64, cast to float32;
  Λ̄ on its own 16-bit pow2 grid, D on an 8-bit one (re and im apart);
  B̄, C (with -C_im), and the dense kernels as 8-bit pow2 codes;
- the forward: encoder (codes times scale, float32 dot) rounded to
  bfloat16; per layer the BatchNorm as an affine from the running
  statistics, the B-projection, the recurrence from the carry, every
  state on its 16-bit grid at the end of each time block of 512 frames
  (the block's last state is the next block's carry), the C-projection
  with the conjugate-symmetry 2 in the scales, ``+ D z``, gelu_tanh, the
  GLU gate, the residual, and the layer output on its 16-bit grid;
  the decoder.

``act="fp8"`` rounds the encoder output to float8 e4m3 in place of
bfloat16: the control of the correctness check, the precision below the
configuration's 16-bit activations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import ndns

Weights = Dict[str, torch.Tensor]
#: the recipe's precisions: Λ̄ 16, B̄ / C / D / denses 8, activations 16
A_BITS, W_BITS, ACT_BITS = 16, 8, 16
FP8_MAX = 448.0


def pow2_scale(absmax: float, bits: int) -> float:
    s = max(absmax / (2.0 ** (bits - 1) - 1.0), 1e-6)
    return 2.0 ** round(math.log2(s))


def codes(x: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    q = 2.0 ** (bits - 1)
    return torch.clamp(torch.round(x / scale), -q, q - 1.0)


def on_grid(x: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    return codes(x, scale, bits) * scale


def quantize(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, float]:
    """(codes as float32, pow2 scale) of a weight by its own absmax."""
    s = pow2_scale(float(w.abs().max()), bits)
    return codes(w, s, bits), s


def act_round(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "fp8":
        h = h.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    else:
        h = h.to(torch.bfloat16)
    return h.to(torch.float32)


def discretize64(w: Weights, prefix: str):
    lr = torch.clamp(w[prefix + "Lambda_re"].double(), max=-1e-4)
    lam = torch.complex(lr, w[prefix + "Lambda_im"].double())
    dt = torch.exp(w[prefix + "log_step"][:, 0].double())
    lam_bar = torch.exp(lam * dt)
    b = w[prefix + "B"].double()
    b_bar = ((lam_bar - 1.0) / lam)[:, None] * torch.complex(b[..., 0],
                                                             b[..., 1])
    f = lambda a: a.float()  # noqa: E731
    return (f(lam_bar.real), f(lam_bar.imag)), (f(b_bar.real),
                                                f(b_bar.imag))


def _fq_dense(x, w: Weights, name: str):
    """The static-quant model's dense while calibrating: 8-bit weight."""
    kernel = w[name + ".weight"].T
    q, s = quantize(kernel, W_BITS)
    return x @ (q * s) + w[name + ".bias"]


@torch.no_grad()
def calibrate(w: Weights, inputs: List[torch.Tensor]) -> List[dict]:
    """Per layer {"state": (s_re, s_im), "residual": s} at 16 bits."""
    prefixes = ndns.layer_prefixes(w)
    state_max = [[0.0, 0.0] for _ in prefixes]
    res_max = [0.0 for _ in prefixes]
    for k, x in enumerate(inputs):
        h = _fq_dense(x, w, "encoder.encoder")
        for i, pre in enumerate(prefixes):
            z = (h - w[pre + "norm.running_mean"]) * (
                torch.rsqrt(w[pre + "norm.running_var"] + ndns.BN_EPS)
                * w[pre + "norm.weight"]) + w[pre + "norm.bias"]
            lam, bbar = ndns.discretize(w, pre + "mixer.")
            p = bbar[0].shape[0]
            bu = z @ torch.cat([bbar[0].T, bbar[1].T], dim=-1)
            xr, xi = ndns.scan(lam, (bu[..., :p], bu[..., p:]))
            if k == 0:
                state_max[i][0] = max(state_max[i][0], float(xr.abs().max()))
                state_max[i][1] = max(state_max[i][1], float(xi.abs().max()))
            c = w[pre + "mixer.C"]
            y = 2.0 * (torch.cat([xr, xi], -1)
                       @ torch.cat([c[..., 0].T, -c[..., 1].T], 0)) \
                + w[pre + "mixer.D"] * z
            x1 = F.gelu(y, approximate="tanh")
            h = x1 * torch.sigmoid(_fq_dense(x1, w, pre + "out2")) + h
            res_max[i] = max(res_max[i], float(h.abs().max()))
    return [{"state": (pow2_scale(sm[0], ACT_BITS),
                       pow2_scale(sm[1], ACT_BITS)),
             "residual": pow2_scale(rm, ACT_BITS)}
            for sm, rm in zip(state_max, res_max)]


def _dense(w: Weights, name: str):
    q, s = quantize(w[name + ".weight"].T, W_BITS)
    return q, s, w[name + ".bias"]


@torch.no_grad()
def pack(w: Weights, scales: List[dict]) -> dict:
    """The quantized operands of the engine."""
    layers = []
    for pre, sc in zip(ndns.layer_prefixes(w), scales):
        (lr, li), (br, bi) = discretize64(w, pre + "mixer.")
        c = w[pre + "mixer.C"]
        lam = tuple(on_grid(a, quantize(a, A_BITS)[1], A_BITS)
                    for a in (lr, li))
        bq = [quantize(a, W_BITS) for a in (br, bi)]
        cq = [quantize(a, W_BITS) for a in (c[..., 0], -c[..., 1])]
        d = w[pre + "mixer.D"]
        nw = w[pre + "norm.weight"] / torch.sqrt(
            w[pre + "norm.running_var"] + ndns.BN_EPS)
        layers.append(dict(
            lam=lam, w_b=torch.cat([bq[0][0].T, bq[1][0].T], -1),
            wb_scales=(bq[0][1], bq[1][1]),
            w_c=torch.cat([cq[0][0].T, cq[1][0].T], 0),
            wc_scales=(2.0 * cq[0][1], 2.0 * cq[1][1]),
            d=on_grid(d, quantize(d, W_BITS)[1], W_BITS),
            nw=nw, nb=w[pre + "norm.bias"] - w[pre + "norm.running_mean"] * nw,
            out2=_dense(w, pre + "out2"),
            state=sc["state"], residual=sc["residual"]))
    return dict(encoder=_dense(w, "encoder.encoder"),
                decoder=_dense(w, "decoder"), layers=layers)


def time_block(block_t: int, length: int) -> int:
    """The frames of a requant block at this length: ``block_t``, at most
    the length, cut to a multiple of 8 when shorter than it."""
    t = min(block_t, length)
    return max(t - t % 8, 8) if t < length else t


def _scan_requant(lam, bu, scale, block: int):
    """Recurrence per block from the requantized carry; every state of a
    block on the grid."""
    out_r, out_i, carry = [], [], None
    for s in range(0, bu[0].shape[1], block):
        xr, xi = ndns.scan(lam, (bu[0][:, s:s + block], bu[1][:, s:s + block]),
                           carry=carry)
        xr, xi = on_grid(xr, scale[0], ACT_BITS), on_grid(xi, scale[1],
                                                          ACT_BITS)
        out_r.append(xr)
        out_i.append(xi)
        carry = (xr[:, -1], xi[:, -1])
    return torch.cat(out_r, 1), torch.cat(out_i, 1)


@torch.no_grad()
def forward(packed: dict, x: torch.Tensor, block_t: int = 512,
            act: str = "bf16") -> torch.Tensor:
    """features (B, L, F) float32 -> mask (B, L, F)."""
    q, s, b = packed["encoder"]
    h = act_round((x @ q) * s + b, act)
    block = time_block(block_t, x.shape[1])
    for lay in packed["layers"]:
        z = h * lay["nw"] + lay["nb"]
        bu = z @ lay["w_b"]
        p = bu.shape[-1] // 2
        bu = (bu[..., :p] * lay["wb_scales"][0],
              bu[..., p:] * lay["wb_scales"][1])
        xr, xi = _scan_requant(lay["lam"], bu, lay["state"], block)
        y = torch.cat([xr * lay["wc_scales"][0], xi * lay["wc_scales"][1]],
                      -1) @ lay["w_c"] + lay["d"] * z
        x1 = F.gelu(y, approximate="tanh")
        oq, os_, ob = lay["out2"]
        g = x1 * torch.sigmoid((x1 @ oq) * os_ + ob)
        h = on_grid(g + h, lay["residual"], ACT_BITS)
    q, s, b = packed["decoder"]
    return (h @ q) * s + b


@torch.no_grad()
def denoise(packed: dict, noisy: torch.Tensor, block_t: int = 512,
            act: str = "bf16"):
    """The offline request on the engine: (mask, cleaned audio)."""
    x, mag, phase = ndns.features(noisy)
    mask = forward(packed, x, block_t, act)
    return mask, ndns.istft(mag * (1.0 + mask), phase, noisy.shape[-1])
