"""DNSMOS perceptual-quality metric (counterpart of
``sparsernns_tpu/data/dnsmos.py``; optional, on the CPU with
onnxruntime): Microsoft's DNSMOS P.835 sig/bak/ovr scorer over 9.01 s
windows, with the polynomial rescaling of its raw scores. The session is
injected (anything with onnxruntime's ``.run(None, feeds)``) or built from
``DNSMOS_MODEL_PATH``; without onnxruntime or the model file every score
is None.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

SAMPLE_RATE = 16000
INPUT_LENGTH_SEC = 9.01


class DNSMOS:
    """P.835 scorer. ``model_path`` -> sig_bak_ovr.onnx."""

    def __init__(self, model_path: Optional[str] = None, session=None):
        # ``session``: a pre-built inference session (anything with
        # onnxruntime's .run(None, feeds) contract), so the windowing and
        # the rescaling run without onnxruntime or the model file
        self._session = session
        if session is not None:
            return
        model_path = model_path or os.environ.get("DNSMOS_MODEL_PATH")
        if model_path and os.path.exists(model_path):
            try:
                import onnxruntime as ort
                self._session = ort.InferenceSession(
                    model_path, providers=["CPUExecutionProvider"])
            except ImportError:
                pass

    @property
    def available(self) -> bool:
        return self._session is not None

    @staticmethod
    def _poly_fit(sig, bak, ovr):
        """Raw -> MOS rescaling polynomials (P.835 personalized=False)."""
        p_ovr = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
        p_sig = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
        p_bak = np.poly1d([-0.13166888, 1.60915514, -0.39604546])
        return p_sig(sig), p_bak(bak), p_ovr(ovr)

    def __call__(self, audio: np.ndarray) -> Dict[str, Optional[float]]:
        """audio: (T,) float32 @ 16 kHz -> {OVRL, SIG, BAK} MOS scores."""
        if self._session is None:
            return {"OVRL": None, "SIG": None, "BAK": None}
        audio = np.asarray(audio, np.float32).ravel()
        need = int(INPUT_LENGTH_SEC * SAMPLE_RATE)
        while audio.shape[0] < need:
            audio = np.concatenate([audio, audio])
        num_hops = int(np.floor(audio.shape[0] / SAMPLE_RATE) -
                       INPUT_LENGTH_SEC) + 1
        sig_l, bak_l, ovr_l = [], [], []
        for i in range(max(1, num_hops)):
            seg = audio[int(i * SAMPLE_RATE):
                        int((i + INPUT_LENGTH_SEC) * SAMPLE_RATE) + 1]
            if seg.shape[0] < need:
                break
            inp = {"input_1": seg[None, :need].astype(np.float32)}
            raw_sig, raw_bak, raw_ovr = self._session.run(None, inp)[0][0]
            sig, bak, ovr = self._poly_fit(raw_sig, raw_bak, raw_ovr)
            sig_l.append(sig)
            bak_l.append(bak)
            ovr_l.append(ovr)
        if not ovr_l:
            return {"OVRL": None, "SIG": None, "BAK": None}
        return {"OVRL": float(np.mean(ovr_l)), "SIG": float(np.mean(sig_l)),
                "BAK": float(np.mean(bak_l))}
