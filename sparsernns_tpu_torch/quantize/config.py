"""Quantization configuration (the port's own copy of
``sparsernns_tpu/quantize/config.py``: pure Python, same names and recipe
values). One config object drives the static-quant calibration and
inference model and the serving engine's packing."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class QuantScheme(enum.Enum):
    per_tensor_symmetric = "per_tensor_symmetric"
    per_tensor_affine = "per_tensor_affine"
    per_channel_symmetric = "per_channel_symmetric"
    per_channel_affine = "per_channel_affine"

    @staticmethod
    def default() -> "QuantScheme":
        return QuantScheme.per_tensor_symmetric


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Per-matrix integer precisions for the S5 stack.

    ``None`` means "keep float" for that operand. Mirrors the reference's
    semantics (quantization.py:36-94): ``a/b/c/d`` are the SSM operator
    matrices, ``non_ssm`` the encoder/decoder/GLU Dense weights,
    ``ssm_act``/``non_ssm_act`` the activation precisions inside/outside
    the SSM.

    ``static_quant``/``calibrating`` select the static-quantization paths:
    calibrating=True runs observers that record min/max ranges;
    calibrating=False uses frozen scales for quant-dequant (or integer
    weight storage in the engine kernels).
    """

    a_precision: Optional[int] = None
    b_precision: Optional[int] = None
    c_precision: Optional[int] = None
    d_precision: Optional[int] = None
    non_ssm_precision: Optional[int] = None
    ssm_act_precision: Optional[int] = None
    non_ssm_act_precision: Optional[int] = None
    static_quant: bool = False
    calibrating: bool = False
    q_scheme: QuantScheme = QuantScheme.per_tensor_symmetric

    @staticmethod
    def none() -> "QuantizationConfig":
        return QuantizationConfig()

    @staticmethod
    def uniform(weight_bits: Optional[int], act_bits: Optional[int],
                a_bits: Optional[int] = None, **kw) -> "QuantizationConfig":
        return QuantizationConfig(
            a_precision=a_bits if a_bits is not None else act_bits,
            b_precision=weight_bits,
            c_precision=weight_bits,
            d_precision=weight_bits,
            non_ssm_precision=weight_bits,
            ssm_act_precision=act_bits,
            non_ssm_act_precision=act_bits,
            **kw,
        )

    @property
    def any_quantized(self) -> bool:
        return any(
            p is not None
            for p in (
                self.a_precision, self.b_precision, self.c_precision,
                self.d_precision, self.non_ssm_precision,
                self.ssm_act_precision, self.non_ssm_act_precision,
            )
        )

    def replace(self, **kw) -> "QuantizationConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["q_scheme"] = self.q_scheme.name
        return d

    @staticmethod
    def from_dict(d: dict) -> "QuantizationConfig":
        d = dict(d)
        if isinstance(d.get("q_scheme"), str):
            d["q_scheme"] = QuantScheme[d["q_scheme"]]
        return QuantizationConfig(**d)

    def __str__(self) -> str:
        return (
            f"QuantizationConfig(a={self.a_precision} b={self.b_precision} "
            f"c={self.c_precision} d={self.d_precision} "
            f"nonssm={self.non_ssm_precision} ssm_act={self.ssm_act_precision} "
            f"nonssm_act={self.non_ssm_act_precision} "
            f"static={self.static_quant} calibrating={self.calibrating})"
        )


def _recipe(**kw):
    def make(**overrides):
        merged = dict(kw)
        merged.update(overrides)
        return QuantizationConfig(**merged)
    return make


# Same recipe names/values as the reference map (quantization.py:96-177).
quantization_recipes = {
    "none": _recipe(),
    "w8a8": _recipe(a_precision=16, b_precision=8, c_precision=8,
                    d_precision=8, non_ssm_precision=8,
                    ssm_act_precision=8, non_ssm_act_precision=8),
    "w8a8A8": _recipe(a_precision=8, b_precision=8, c_precision=8,
                      d_precision=8, non_ssm_precision=8,
                      ssm_act_precision=8, non_ssm_act_precision=8),
    "w8a16": _recipe(a_precision=16, b_precision=8, c_precision=8,
                     d_precision=8, non_ssm_precision=8,
                     ssm_act_precision=16, non_ssm_act_precision=16),
    "w16a16": _recipe(a_precision=16, b_precision=16, c_precision=16,
                      d_precision=16, non_ssm_precision=16,
                      ssm_act_precision=16, non_ssm_act_precision=16),
    "w32a32": _recipe(a_precision=32, b_precision=32, c_precision=32,
                      d_precision=32, non_ssm_precision=32,
                      ssm_act_precision=32, non_ssm_act_precision=32),
    "w4a4": _recipe(a_precision=4, b_precision=4, c_precision=4,
                    d_precision=4, non_ssm_precision=4,
                    ssm_act_precision=4, non_ssm_act_precision=4),
    "w2a2": _recipe(a_precision=2, b_precision=2, c_precision=2,
                    d_precision=2, non_ssm_precision=2,
                    ssm_act_precision=2, non_ssm_act_precision=2),
}
