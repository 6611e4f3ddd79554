"""Streaming / stateful audio denoising — the serving path (counterpart
of ``sparsernns_tpu/serve/streaming.py``).

Inference is chunked: each layer's SSM carry is kept between chunks, so a
stream of any length runs in O(chunk) memory with the recurrence of the
offline scan. The model forward runs on the model's device (the scan
kernel with carry, ``ops/cuda/diag_scan.py``), or, built with
:meth:`StreamingDenoiser.from_engine`, through the quantized serving
engine's per-layer kernels with carries; framing and overlap-add stay
numpy on the host. The STFT analysis is uncentred (frame k covers samples
[k·hop, k·hop + nfft)); synthesis is boxcar overlap-add, with samples
emitted once no future frame can touch them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparsernns_tpu_torch.ops.stft import HOP_LENGTH, NFFT
from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
from sparsernns_tpu_torch.utils.trace import span


class StreamingDenoiser:
    """Stateful chunked inference around an eval-mode RegressionModel —
    or, via :meth:`from_engine`, around the quantized W8A16Engine; batch B
    streams B channels at once (continuous batching is a fixed B with
    per-slot reset via ``reset(slot)``)."""

    def __init__(self, model, batch_size: int = 1, hop: int = HOP_LENGTH,
                 nfft: int = NFFT, frame_multiple: int = 1):
        self.model = model
        self.engine = None
        self.batch = batch_size
        self.hop = hop
        self.nfft = nfft
        self.overlap = nfft // hop
        #: frames are consumed in multiples of this (the rest is buffered):
        #: an engine sets it to its time block, so that every forward
        #: honours the carry kernel's chunk contract
        self.frame_multiple = frame_multiple
        self.device = next(model.parameters()).device
        self.reset()

    @classmethod
    def from_engine(cls, engine, batch_size: int = 1, hop: int = HOP_LENGTH,
                    nfft: int = NFFT) -> "StreamingDenoiser":
        """Streaming denoiser over the quantized serving engine
        (``W8A16Engine.process_chunk``): the cache is the per-layer (B, P)
        carry pairs. Frames buffer to the engine's ``block_t`` so each
        forward is whole time blocks (at the default 512 frames that is
        4 s of audio per forward)."""
        self = cls.__new__(cls)
        self.model = None
        self.engine = engine
        self.batch = batch_size
        self.hop = hop
        self.nfft = nfft
        self.overlap = nfft // hop
        self.frame_multiple = int(engine.block_t)
        self.device = engine.device
        self.reset()
        return self

    @torch.no_grad()
    def _forward(self, frames_mag: np.ndarray):
        """(B, F, T) magnitudes -> ((B, F, T) mask, new cache)."""
        with span("stream.upload"):
            x = torch.from_numpy(frames_mag).to(self.device)
        with span("stream.forward"):
            x = (x - STFT_MAG_MEAN).transpose(1, 2)
            if self.engine is not None:
                out, cache = self.engine.process_chunk(x, self.cache)
            else:
                out, cache = self.model.forward_stream(x, self.cache)
        with span("stream.download"):
            return out.transpose(1, 2).float().cpu().numpy(), cache

    def reset(self, slot: Optional[int] = None):
        if slot is None:
            self.cache: Optional[list] = None
            self._pending = np.zeros((self.batch, 0), np.float32)
            self._ola = np.zeros((self.batch, 0), np.float32)
            self._ola_w = np.zeros((0,), np.float32)
            self._emit_pos = 0      # global sample index of next emit
            self._ola_start = 0     # global sample index of _ola[:, 0]
            self._frames_done = 0   # global frames processed so far
            self._in_pos = 0        # global samples ingested so far
        else:
            if self.cache is not None:
                for c_re, c_im in self.cache:
                    c_re[slot] = 0.0
                    c_im[slot] = 0.0
            self._pending[slot] = 0.0
            self._ola[slot] = 0.0

    def process(self, audio_chunk: np.ndarray) -> np.ndarray:
        """Feed (B, T) new samples; returns finalized denoised samples
        (empty until a full analysis frame is available)."""
        audio_chunk = np.atleast_2d(np.asarray(audio_chunk, np.float32))
        assert audio_chunk.shape[0] == self.batch
        self._pending = np.concatenate([self._pending, audio_chunk], axis=1)
        self._in_pos += audio_chunk.shape[1]

        n_avail = self._pending.shape[1]
        if n_avail < self.nfft:
            return np.zeros((self.batch, 0), np.float32)
        n_frames = (n_avail - self.nfft) // self.hop + 1
        n_frames -= n_frames % self.frame_multiple
        if n_frames <= 0:
            return np.zeros((self.batch, 0), np.float32)
        return self._run_frames(n_frames)

    def _run_frames(self, n_frames: int) -> np.ndarray:
        with span("stream.frames"):
            starts = np.arange(n_frames) * self.hop
            frames = np.stack(
                [self._pending[:, s:s + self.nfft] for s in starts], axis=1)
            spec = np.fft.rfft(frames, axis=-1)      # (B, T, F)
            mag = np.abs(spec).astype(np.float32).transpose(0, 2, 1)
            phase = np.angle(spec).transpose(0, 2, 1)

        mask, self.cache = self._forward(mag)
        with span("stream.ola"):
            return self._synthesize(mag, phase, mask, n_frames)

    def _synthesize(self, mag: np.ndarray, phase: np.ndarray,
                    mask: np.ndarray, n_frames: int) -> np.ndarray:
        """The masked frames' irFFT overlap-added into the synthesis
        buffer; returns the samples no future frame touches."""
        cleaned = mag * (1.0 + mask)
        spec_out = (cleaned * np.exp(1j * phase)).transpose(0, 2, 1)
        time_frames = np.fft.irfft(spec_out, axis=-1).astype(np.float32)

        # --- overlap-add into the global synthesis buffer ---
        first_global = self._frames_done * self.hop
        last_end = first_global + (n_frames - 1) * self.hop + self.nfft
        need = last_end - self._ola_start
        if need > self._ola.shape[1]:
            grow = need - self._ola.shape[1]
            self._ola = np.pad(self._ola, ((0, 0), (0, grow)))
            self._ola_w = np.pad(self._ola_w, (0, grow))
        for t in range(n_frames):
            s = first_global + t * self.hop - self._ola_start
            self._ola[:, s:s + self.nfft] += time_frames[:, t]
            self._ola_w[s:s + self.nfft] += 1.0

        self._frames_done += n_frames
        # keep the last (overlap-1) hops of input as context for the next
        # frame, drop fully-consumed samples
        self._pending = self._pending[:, n_frames * self.hop:]

        # --- emit samples no future frame (start >= next_start) touches ---
        next_start = self._frames_done * self.hop
        emit_until = next_start  # future frames cover [next_start, ...)
        if emit_until <= self._emit_pos:
            return np.zeros((self.batch, 0), np.float32)
        lo = self._emit_pos - self._ola_start
        hi = emit_until - self._ola_start
        w = np.maximum(self._ola_w[lo:hi], 1.0)
        out = self._ola[:, lo:hi] / w[None, :]
        # drop emitted region from the buffer
        self._ola = self._ola[:, hi:]
        self._ola_w = self._ola_w[hi:]
        self._ola_start = emit_until
        self._emit_pos = emit_until
        return out

    def flush(self) -> np.ndarray:
        """Emit everything accumulated (end of stream). Frames still
        buffered by the frame_multiple flooring are processed first (a
        final forward shorter than the multiple: one time block)."""
        outs = []
        if self.frame_multiple > 1 and self._pending.shape[1] >= self.nfft:
            n_frames = (self._pending.shape[1] - self.nfft) // self.hop + 1
            if n_frames > 0:
                outs.append(self._run_frames(n_frames))
        if self._ola.shape[1] == 0:
            return (np.concatenate(outs, axis=-1) if outs
                    else np.zeros((self.batch, 0), np.float32))
        w = np.maximum(self._ola_w, 1.0)
        out = self._ola / w[None, :]
        self._ola = np.zeros((self.batch, 0), np.float32)
        self._ola_w = np.zeros((0,), np.float32)
        self._ola_start = self._emit_pos = self._emit_pos + out.shape[1]
        outs.append(out)
        return np.concatenate(outs, axis=-1)

    def process_offline(self, audio: np.ndarray,
                        chunk_samples: int = 16000) -> np.ndarray:
        """Stream a whole signal chunk-by-chunk and stitch the output."""
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        outs = []
        for start in range(0, audio.shape[-1], chunk_samples):
            outs.append(self.process(audio[:, start:start + chunk_samples]))
        outs.append(self.flush())
        return np.concatenate([o for o in outs if o.size], axis=-1)


class ContinuousBatcher:
    """Continuous batching of independent audio streams over the fixed-B
    StreamingDenoiser: per-slot ADMISSION (new streams join a live batch
    on a free slot, carries reset for that slot only), per-stream output
    routing, and a waiting queue when all slots are busy.

    Semantics: all slots advance on the batch's global frame clock; a
    stream admitted at global sample time T behaves exactly like a solo
    stream whose audio is preceded by T zero samples.
    """

    def __init__(self, denoiser: StreamingDenoiser):
        self.denoiser = denoiser
        self.slots: list = [None] * denoiser.batch
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, list] = {}
        self._waiting: list = []
        self._ended: set = set()
        #: global sample index one past each stream's last REAL sample —
        #: a slot is only recycled once emission has passed it, so the
        #: per-slot reset can never destroy unprocessed tail audio
        self._content_end: Dict[str, int] = {}
        #: global sample index of each stream's FIRST real sample (its
        #: admission ingest position): emissions before it belong to the
        #: slot's previous occupant / pre-admission silence and are NOT
        #: routed to the stream — collect() is content-exact even under
        #: admission churn (emission lags ingestion, so without this
        #: clip a freshly admitted stream would receive the tail of the
        #: previous stream's denoised silence)
        self._content_start: Dict[str, int] = {}

    @property
    def n_free(self) -> int:
        return sum(s is None for s in self.slots)

    def add_stream(self, stream_id: str) -> Optional[int]:
        """Admit a stream; returns its slot, or None if queued."""
        if stream_id in self._inputs:
            raise ValueError(f"stream {stream_id!r} already active")
        self._inputs[stream_id] = np.zeros((0,), np.float32)
        self._outputs[stream_id] = []
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = stream_id
                self.denoiser.reset(slot=i)
                self._content_start[stream_id] = self.denoiser._in_pos
                return i
        self._waiting.append(stream_id)
        return None

    def feed(self, stream_id: str, samples: np.ndarray):
        self._inputs[stream_id] = np.concatenate(
            [self._inputs[stream_id], np.asarray(samples, np.float32)])

    def end_stream(self, stream_id: str):
        """No more input; the stream finishes once its buffer drains."""
        self._ended.add(stream_id)

    def step(self, chunk_samples: int) -> int:
        """Advance the global clock by ``chunk_samples``: every occupied
        slot consumes that many samples from its stream's buffer
        (zero-padded if starved), idle slots feed silence; finished
        streams release their slots to the waiting queue.

        Returns the number of REAL samples consumed across slots this
        step (excluding starvation zero-padding) — the honest payload
        measure for throughput accounting."""
        start = self.denoiser._in_pos
        real_samples = 0
        batch = np.zeros((self.denoiser.batch, chunk_samples), np.float32)
        for i, sid in enumerate(self.slots):
            if sid is None:
                continue
            buf = self._inputs[sid]
            take = min(chunk_samples, buf.shape[0])
            batch[i, :take] = buf[:take]
            self._inputs[sid] = buf[take:]
            real_samples += take
            if take:
                self._content_end[sid] = start + take
        emit0 = self.denoiser._emit_pos
        with span("stream.batch"):
            out = self.denoiser.process(batch)
        for i, sid in enumerate(self.slots):
            if sid is not None and out.shape[1]:
                # route only samples inside the stream's real content —
                # emissions past content_end are denoised trailing
                # silence, not the stream's audio
                end = self._content_end.get(sid, emit0 + out.shape[1])
                lo = max(0, self._content_start.get(sid, 0) - emit0)
                hi = min(out.shape[1], max(0, end - emit0))
                if hi > lo:
                    self._outputs[sid].append(out[i, lo:hi])
        # release drained+ended+fully-EMITTED streams, admit from the
        # queue (emission trails ingestion by the analysis window plus
        # any frame_multiple buffering; recycling earlier would zero the
        # slot's unprocessed tail)
        for i, sid in enumerate(self.slots):
            if (sid is not None and sid in self._ended
                    and self._inputs[sid].shape[0] == 0
                    and self.denoiser._emit_pos
                    >= self._content_end.get(sid, 0)):
                self.slots[i] = None
                if self._waiting:
                    nxt = self._waiting.pop(0)
                    self.slots[i] = nxt
                    self.denoiser.reset(slot=i)
                    self._content_start[nxt] = self.denoiser._in_pos
        return real_samples

    def backlog_samples(self) -> int:
        """Largest per-slot buffered sample count — how far behind the
        batch clock the most-backlogged live stream is."""
        return max((self._inputs[sid].shape[0]
                    for sid in self.slots if sid is not None), default=0)

    def step_auto(self, chunk_samples: int, max_chunks: int = 8) -> int:
        """Backlog-adaptive step: advances the clock by n * chunk_samples,
        n = clamp(backlog // chunk, 1, max_chunks), with the backlog of the
        MOST backlogged live stream (:meth:`backlog_samples`), so one
        forward serves n chunks and lightly loaded slots are padded with
        zeros. Per-stream output equals n sequential :meth:`step` calls
        with no feeds between them; only slot release and admission run
        once, at the end. Returns real samples consumed, like step()."""
        n = max(1, min(max_chunks,
                       self.backlog_samples() // max(1, chunk_samples)))
        return self.step(n * chunk_samples)

    def collect(self, stream_id: str) -> np.ndarray:
        """Denoised samples produced so far for a stream."""
        chunks = self._outputs.get(stream_id, [])
        if not chunks:
            return np.zeros((0,), np.float32)
        out = np.concatenate(chunks)
        self._outputs[stream_id] = [out]
        return out
