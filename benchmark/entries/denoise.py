"""Entry ``denoise``: an offline request of whole clips, one in flight
(closed loop). A request is the traffic's ``batch`` noisy clips, already
on the device: the STFT (``ops/stft.stft_splitter``), the model on the
features ``|X| - 0.0007`` (time-major), the mask applied as the program's
streaming denoiser applies it, ``|X| (1 + mask)``, and the iSTFT with the
noisy phase (``ops/stft.stft_mixer_tm``). It ends when its audio is ready.

The model is the configuration's ``serve``: ``float``, the program's
``RegressionModel`` in eval mode (the whole-layer kernel K2 per layer);
or ``w8a16``, the program's ``W8A16Engine`` (its whole-network kernel K6
in one call) built as the conversion pipeline builds it: the static-quant
model calibrated (``quantize/calibrate.calibrate``) on the benchmark's
calibration features, frozen, packed (``quantize/convert.
engine_from_frozen``) at the configuration's engine settings.

The check samples requests of the window from the seed, keeps their
outputs, and after the window compares each mask and cleaned audio with
the reference's on the same clips.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from benchmark.harness.seeds import rng
from benchmark.reference import engine as ref_engine
from benchmark.reference import ndns

#: requests whose outputs the check keeps, drawn from the first ``SAMPLE_OF``
SAMPLED = 2
SAMPLE_OF = 16


class Runner:
    #: the window's first step, and the fewest it runs: the sampled ones
    first_step, min_steps = 0, SAMPLE_OF
    #: requests of a traced run's profiled stretch
    traced_steps = 20

    def __init__(self, ctx):
        from sparsernns_tpu_torch.ops.stft import stft_mixer_tm, stft_splitter
        from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
        from sparsernns_tpu_torch.utils.config import RunConfig
        self.ctx = ctx
        self.splitter, self.mixer = stft_splitter, stft_mixer_tm
        self.mag_mean = STFT_MAG_MEAN
        cfg = dataclasses.replace(RunConfig(), **ctx.config["defaults"],
                                  **ctx.config["recipe"])
        self.cfg = cfg
        serve = ctx.config["serve"]
        if serve == "float":
            self.model = self._float_model(cfg)
        elif serve == "w8a16":
            self.model = self._engine(cfg)
        else:
            raise ValueError(f"serve {serve!r}")
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        self.sample = set(int(i) for i in rng(ctx.seed, "sample").choice(
            SAMPLE_OF, SAMPLED, replace=False))
        self.kept: Dict[int, tuple] = {}
        self._packed = None
        ctx.faults.apply_denoise(self)

    def _float_model(self, cfg):
        from sparsernns_tpu_torch.train.loop import build_model
        ctx = self.ctx
        model = build_model(cfg, ctx.shape.d_io, ctx.shape.d_io,
                            training=False, device=ctx.device)
        missing, unexpected = model.load_state_dict(ctx.weights, strict=False)
        if unexpected or any("num_batches_tracked" not in k for k in missing):
            raise KeyError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
        model.eval()
        return model

    def _engine(self, cfg):
        from sparsernns_tpu_torch.quantize.calibrate import calibrate
        from sparsernns_tpu_torch.quantize.config import quantization_recipes
        from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
        from sparsernns_tpu_torch.train.loop import build_model
        ctx = self.ctx
        eng = ctx.config["engine"]
        cal_model = build_model(
            cfg, ctx.shape.d_io, ctx.shape.d_io, device=ctx.device,
            scan_mode="sequential",
            q_config=quantization_recipes[cfg.convert_quantization](
                static_quant=True, calibrating=True))
        frozen = calibrate(cal_model, self._state_dict(),
                           ctx.calibration_inputs)
        del cal_model
        act = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        return engine_from_frozen(cfg, *frozen, device=ctx.device,
                                  block_t=eng["block_t"],
                                  act_dtype=act[eng["act_dtype"]],
                                  route=eng["route"])

    def _state_dict(self):
        """The float model's state as the program keeps it."""
        ctx = self.ctx
        sd = dict(ctx.weights)
        for i in range(self.cfg.n_layers):
            sd[f"encoder.layers.{i}.norm.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=ctx.device)
        return sd

    @torch.no_grad()
    def request(self, noisy: torch.Tensor):
        with record_function("bench.stft"):
            mag, phase = self.splitter(noisy)
        with record_function("bench.model"):
            x = (mag - self.mag_mean).transpose(1, 2).contiguous()
            mask = self.model(x)
        with record_function("bench.istft"):
            mag_tm = mag.transpose(1, 2)
            audio = self.mixer(mag_tm * (1.0 + mask), phase.transpose(1, 2))
            audio = audio[..., :noisy.shape[-1]]
        return mask, audio

    def step(self, i: int) -> None:
        rows = self.ctx.schedule[i]
        mask, audio = self.request(self.ctx.data["noisy"][rows])
        self.bad += (~torch.isfinite(audio).all()).to(torch.int64)
        if i in self.sample:
            self.kept[i] = (mask, audio)

    def setup(self) -> None:
        """Two requests outside the window: they build every kernel."""
        noisy = self.ctx.data["noisy"]
        for i in range(2):
            self.request(noisy[self.ctx.schedule[-1 - i]])

    def failed(self) -> int:
        return int(self.bad)

    def release(self) -> None:
        del self.model
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def packed_reference(self):
        """The reference engine's calibration and packing (made once)."""
        if self._packed is None:
            ctx = self.ctx
            scales = ref_engine.calibrate(ctx.weights, ctx.calibration_inputs)
            self._packed = ref_engine.pack(ctx.weights, scales)
        return self._packed

    def reference(self, rows, control: Optional[str] = None):
        """(mask, audio) of the reference on ``rows``; with ``control``
        the control: float in TF32, the engine with float8 activations."""
        ctx = self.ctx
        noisy = ctx.data["noisy"][rows]
        if ctx.config["serve"] == "float":
            return ndns.denoise(ctx.weights, noisy,
                                prec="tf32" if control else "fp32")
        packed = self.packed_reference()
        return ref_engine.denoise(packed, noisy,
                                  ctx.config["engine"]["block_t"],
                                  act="fp8" if control else "bf16")


def compare(pairs: List[tuple]) -> Dict[str, float]:
    """Over the sampled requests: the largest gap of a mask element over
    max(1, the largest |mask|), the root-mean-square gap of the masks over
    their root-mean-square, and the largest gap of an audio sample over
    the largest |sample|, each of the reference."""
    mmax = mrms = amax = 0.0
    for (mask, audio), (rmask, raudio) in pairs:
        d = (mask.float() - rmask)
        mmax = max(mmax, float(d.abs().max()) / max(1.0,
                                                    float(rmask.abs().max())))
        mrms = max(mrms, float(d.pow(2).mean().sqrt())
                   / float(rmask.pow(2).mean().sqrt()))
        amax = max(amax, float((audio - raudio).abs().max())
                   / float(raudio.abs().max()))
    return {"mask_max_gap": mmax, "mask_rms_gap": mrms,
            "audio_max_gap": amax}


def check(runner: Runner, control: Optional[str] = None) -> Dict[str, float]:
    ctx = runner.ctx
    pairs = []
    for i in sorted(runner.kept):
        rows = ctx.schedule[i]
        ref = runner.reference(rows)
        out = (runner.kept[i] if control is None
               else runner.reference(rows, control))
        pairs.append((out, ref))
    return compare(pairs)

