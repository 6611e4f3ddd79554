"""The port's StreamingDenoiser and ContinuousBatcher against the JAX
package's, on the same flax weights and the same numpy audio, and against
the port's own whole-signal output."""

import numpy as np
import pytest

from sparsernns_tpu.serve.streaming import \
    StreamingDenoiser as JaxStreamingDenoiser
from sparsernns_tpu_torch.serve.streaming import (ContinuousBatcher,
                                                  StreamingDenoiser)
from tests.test_torch_model import paired_models, small_config


@pytest.fixture(scope="module")
def models():
    return paired_models(small_config(n_layers=1), d_io=257, seed=6)


def test_streaming_chunked_matches_jax(models):
    jm, variables, tm = models
    audio = (0.3 * np.random.RandomState(7).randn(1, 5000)).astype(
        np.float32)
    ref = JaxStreamingDenoiser(jm, variables, batch_size=1).process_offline(
        audio, chunk_samples=1111)
    out = StreamingDenoiser(tm, batch_size=1).process_offline(
        audio, chunk_samples=1111)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_streaming_chunked_equals_whole(models):
    _, _, tm = models
    audio = np.random.RandomState(8).randn(2, 6000).astype(np.float32)
    whole = StreamingDenoiser(tm, batch_size=2)
    out_whole = np.concatenate([whole.process(audio), whole.flush()],
                               axis=-1)
    out_chunked = StreamingDenoiser(tm, batch_size=2).process_offline(
        audio, chunk_samples=1111)
    assert out_whole.shape == out_chunked.shape
    assert out_whole.shape[1] > 5000
    np.testing.assert_allclose(out_chunked, out_whole, atol=1e-4, rtol=0)


def test_streaming_emits_incrementally(models):
    _, _, tm = models
    rng = np.random.RandomState(9)
    d = StreamingDenoiser(tm, batch_size=1)
    assert d.process(rng.randn(1, 300).astype(np.float32)).shape[1] == 0
    assert d.process(rng.randn(1, 2000).astype(np.float32)).shape[1] > 0


def _solo(tm, signal, chunk, tail_chunks=4):
    solo = StreamingDenoiser(tm, batch_size=1)
    outs = [solo.process(signal[None, i:i + chunk])
            for i in range(0, signal.shape[0], chunk)]
    outs += [solo.process(np.zeros((1, chunk), np.float32))
             for _ in range(tail_chunks)]
    return np.concatenate([o for o in outs if o.size], axis=-1)[0]


def _batcher_run(batcher_cls, denoiser, a, b, chunk):
    """Stream a from t=0 and b from t=chunk through a 2-slot batcher."""
    cb = batcher_cls(denoiser)
    assert cb.add_stream("a") == 0
    cb.feed("a", a)
    cb.end_stream("a")
    cb.step(chunk)
    assert cb.add_stream("b") == 1
    cb.feed("b", b)
    cb.end_stream("b")
    for _ in range(6):
        cb.step(chunk)
    return cb.collect("a"), cb.collect("b")


def test_continuous_batcher_matches_jax_and_solo(models):
    """Staggered admission through one shared batch: each stream's output
    equals the JAX batcher's, and the stream admitted at t=0 equals its
    solo run (per-slot carries are independent)."""
    from sparsernns_tpu.serve.streaming import \
        ContinuousBatcher as JaxContinuousBatcher
    jm, variables, tm = models
    rng = np.random.RandomState(10)
    chunk = 1024
    a = (0.1 * rng.randn(3 * chunk)).astype(np.float32)
    b = (0.1 * rng.randn(2 * chunk)).astype(np.float32)
    out_a, out_b = _batcher_run(ContinuousBatcher,
                                StreamingDenoiser(tm, batch_size=2),
                                a, b, chunk)
    ref_a, ref_b = _batcher_run(
        JaxContinuousBatcher,
        JaxStreamingDenoiser(jm, variables, batch_size=2), a, b, chunk)
    assert out_a.shape == a.shape and out_b.shape == b.shape
    np.testing.assert_allclose(out_a, ref_a, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_b, ref_b, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_a, _solo(tm, a, chunk)[:a.shape[0]],
                               atol=1e-4, rtol=0)


def test_step_auto_sizes_from_the_max_backlog(models):
    """step_auto consumes n = clamp(max backlog // chunk, 1, max_chunks)
    chunks in one forward; the lightly loaded slot is zero-padded."""
    _, _, tm = models
    chunk = 512
    cb = ContinuousBatcher(StreamingDenoiser(tm, batch_size=2))
    cb.add_stream("long")
    cb.add_stream("short")
    cb.feed("long", np.ones(5 * chunk, np.float32) * 0.01)
    cb.feed("short", np.ones(chunk, np.float32) * 0.01)
    assert cb.backlog_samples() == 5 * chunk
    consumed = cb.step_auto(chunk, max_chunks=3)
    assert consumed == 3 * chunk + chunk       # real samples only
    assert cb.denoiser._in_pos == 3 * chunk
    assert cb.backlog_samples() == 2 * chunk
    assert cb.step_auto(chunk, max_chunks=3) == 2 * chunk
