"""The fixed-point golden engine (counterpart of ``sparsernns_tpu/fxp``):
integer tensors (``array.py``), the integer model (``model.py``), its
derivation from a calibrated checkpoint (``derive.py``), the verification
reporter and the runner of ``cli.py fxp`` (``runner.py``)."""

from sparsernns_tpu_torch.fxp.array import (ComplexFxpArray, FxpArray,
                                            RoundingMode, fxp_add,
                                            fxp_change_cfg, fxp_change_exp,
                                            fxp_complex_mul, fxp_from_fp,
                                            fxp_matmul, fxp_mul, fxp_relu,
                                            fxp_rshift_round, fxp_sub)

__all__ = [
    "FxpArray", "ComplexFxpArray", "RoundingMode",
    "fxp_from_fp", "fxp_add", "fxp_sub", "fxp_mul", "fxp_matmul",
    "fxp_complex_mul", "fxp_change_exp", "fxp_change_cfg",
    "fxp_rshift_round", "fxp_relu",
]
