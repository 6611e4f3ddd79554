"""Engine serving on the CPU: chunked ``process_chunk`` with carries, the
pipeline-stage split, ``StreamingDenoiser.from_engine`` and
``ContinuousBatcher`` over it against the JAX package's on the same audio,
and the reduced conversion pipeline.

The 257-bin frozen tree here comes from the PORT's calibration and is
handed to BOTH engines: frozen trees of the two packages are
interchangeable.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu.serve.streaming import \
    ContinuousBatcher as JaxContinuousBatcher
from sparsernns_tpu.serve.streaming import \
    StreamingDenoiser as JaxStreamingDenoiser
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.convert import convert, engine_from_frozen
from sparsernns_tpu_torch.serve.streaming import (ContinuousBatcher,
                                                  StreamingDenoiser)
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import from_flax
from tests.test_torch_engine import port_eng
from tests.test_torch_model import jax_model
from tests.test_torch_quantize import frozen  # noqa: F401

BLOCK = 8
CFG = dataclasses.replace(
    RunConfig(), n_layers=2, d_model=12, ssm_size_base=16, blocks=2,
    block_t=BLOCK, bsz=2, synthetic_size=8, synthetic_seconds=0.25,
    scan_mode="fused")


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine on the CPU) at 257 bins, block 8, float32
    activations, from one frozen tree."""
    variables = jax.device_get(jax_model(CFG, 257).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 257), jnp.float32)))
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    recipe = quantization_recipes[CFG.convert_quantization]
    cal_model = build_model(
        CFG, 257, 257, device="cpu", seed=0, scan_mode="sequential",
        q_config=recipe(static_quant=True, calibrating=True))
    batches = [torch.from_numpy(
        (rng.rand(2, 24, 257) * 4 - 1).astype(np.float32)) for _ in range(2)]
    params, fstats = calibrate(
        cal_model, from_flax(variables["params"], stats), batches)
    je = JaxEngine(
        params, fstats,
        jax_recipes[CFG.convert_quantization](static_quant=True,
                                              calibrating=False),
        JaxModelConfig.infer(
            params, glu_variant=CFG.glu_variant,
            relufication=CFG.relufication, prenorm=CFG.prenorm,
            clip_eigs=CFG.clip_eigs), act_dtype=jnp.float32, block_t=BLOCK)
    te = engine_from_frozen(CFG, params, fstats, device="cpu",
                            act_dtype=torch.float32)
    return je, te


def test_chunked_process_chunk_equals_whole(frozen):  # noqa: F811
    """Chunks of one block with carry flow == one whole call. The JAX
    package holds this to atol 2e-3; the port's two routes share one body
    and one set of block boundaries, and it measures 0."""
    x = torch.from_numpy(frozen["batches"][0])
    eng = port_eng(frozen, block_t=BLOCK)
    carries, parts = None, []
    for start in range(0, x.shape[1], BLOCK):
        part, carries = eng.process_chunk(x[:, start:start + BLOCK], carries)
        parts.append(part)
    assert torch.equal(torch.cat(parts, dim=1), eng(x))
    assert len(carries) == 2 and carries[0][0].shape == (2, 8)
    # two blocks a chunk: still the same block boundaries
    two, _ = eng.process_chunk(x[:, :2 * BLOCK])
    assert torch.equal(two, eng(x)[:, :2 * BLOCK])
    with pytest.raises(ValueError, match="divisible"):
        eng.process_chunk(x[:, :BLOCK + 3])


def test_chunk_matches_jax_process_chunk(frozen):  # noqa: F811
    from tests.test_torch_engine import jax_eng
    x = frozen["batches"][1]
    je, te = jax_eng(frozen, block_t=BLOCK), port_eng(frozen, block_t=BLOCK)
    jc = tc = None
    for start in (0, BLOCK):
        ref, jc = je.process_chunk(jnp.asarray(x[:, start:start + BLOCK]), jc)
        out, tc = te.process_chunk(x[:, start:start + BLOCK], tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                                   rtol=0)
    for (a_re, a_im), (b_re, b_im) in zip(tc, jc):
        np.testing.assert_allclose(a_re.numpy(), np.asarray(b_re), atol=1e-5)
        np.testing.assert_allclose(a_im.numpy(), np.asarray(b_im), atol=1e-5)


def test_stage_split_equals_unsplit_chunk(frozen):  # noqa: F811
    """Layer 0 with decode=False hands its stored stream (int16 codes) to
    layer 1 with encode=False, lo=1: bit-identical to the unsplit call."""
    x = torch.from_numpy(frozen["batches"][0][:, :BLOCK])
    eng = port_eng(frozen, block_t=BLOCK)
    carries = eng.init_stream_state(2)
    y_full, c_full = eng._apply_chunk_stack(x, carries, BLOCK)
    r, c0 = eng._apply_chunk_stack(x, carries[:1], BLOCK, lo=0, decode=False,
                                   layers=eng.layers[:1])
    assert r.dtype == torch.int16
    y_split, c1 = eng._apply_chunk_stack(r, carries[1:], BLOCK, lo=1,
                                         encode=False, layers=eng.layers[1:])
    assert torch.equal(y_full, y_split)
    for a, b in zip(c_full, c0 + c1):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_streaming_from_engine_matches_jax(engines):
    je, te = engines
    audio = (0.3 * np.random.RandomState(7).randn(2, 4096)).astype(
        np.float32)
    ref = JaxStreamingDenoiser.from_engine(je, batch_size=2).process_offline(
        audio, chunk_samples=1024)
    den = StreamingDenoiser.from_engine(te, batch_size=2)
    assert den.frame_multiple == BLOCK
    out = den.process_offline(audio, chunk_samples=1024)
    assert out.shape == ref.shape and out.shape[1] > 3500
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


def test_streaming_from_engine_buffers_to_the_block(engines):
    """Frames wait until a whole block is there; flush runs the rest as
    one short block; chunked == one chunk."""
    _, te = engines
    rng = np.random.RandomState(8)
    audio = (0.3 * rng.randn(1, 3000)).astype(np.float32)
    den = StreamingDenoiser.from_engine(te, batch_size=1)
    # 512 + 6 * 128 samples are 7 frames: fewer than a block, nothing runs
    assert den.process(audio[:, :1280]).shape[1] == 0
    assert den._frames_done == 0
    assert den.process(audio[:, 1280:1536]).shape[1] == 8 * 128
    assert den._frames_done == 8
    tail = np.concatenate([den.process(audio[:, 1536:]), den.flush()], -1)
    assert den._frames_done == (3000 - 512) // 128 + 1
    whole = StreamingDenoiser.from_engine(te, batch_size=1)
    out_whole = np.concatenate([whole.process(audio), whole.flush()], -1)
    assert 8 * 128 + tail.shape[1] == out_whole.shape[1]
    np.testing.assert_array_equal(tail, out_whole[:, 8 * 128:])


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


def test_continuous_batcher_over_engine_matches_jax(engines):
    """Staggered admission over the engine-backed denoiser: slot reset
    zeroes that slot's carries, outputs equal the JAX batcher's."""
    je, te = engines
    rng = np.random.RandomState(10)
    chunk = 1024
    a = (0.1 * rng.randn(3 * chunk)).astype(np.float32)
    b = (0.1 * rng.randn(2 * chunk)).astype(np.float32)
    out_a, out_b = _batcher_run(
        ContinuousBatcher, StreamingDenoiser.from_engine(te, batch_size=2),
        a, b, chunk)
    ref_a, ref_b = _batcher_run(
        JaxContinuousBatcher,
        JaxStreamingDenoiser.from_engine(je, batch_size=2), a, b, chunk)
    assert out_a.shape == ref_a.shape and out_b.shape == ref_b.shape
    assert out_a.shape[0] > 2 * chunk
    np.testing.assert_allclose(out_a, ref_a, atol=2e-3, rtol=0)
    np.testing.assert_allclose(out_b, ref_b, atol=2e-3, rtol=0)


def test_engine_slot_reset_zeroes_carries(engines):
    _, te = engines
    den = StreamingDenoiser.from_engine(te, batch_size=2)
    den.process((0.3 * np.random.RandomState(1).randn(2, 2048)).astype(
        np.float32))
    assert den.cache[0][0][0].abs().max() > 0
    den.reset(slot=0)
    for c_re, c_im in den.cache:
        assert c_re[0].abs().max() == 0 and c_im[0].abs().max() == 0
        assert c_re[1].abs().max() > 0


def test_convert_pipeline_stages():
    """calibrate -> freeze -> validate_static_quant -> validate_engine on
    the synthetic loader; each stage is gated by its flag."""
    model = build_model(CFG, 257, 257, device="cpu", seed=0)
    res = convert(CFG, model)
    assert res["calibrated"] is True
    mixer = res["frozen_params"]["encoder"]["layers_0"]["mixer"]
    assert float(mixer["quant_ut"]["scale"]) not in (0.0, 1.0)
    for stage in ("static_quant", "engine"):
        assert np.isfinite(res[stage]["loss"])
        assert np.isfinite(res[stage]["si_snr"])
    # the engine tracks the static-quant model on the validation set
    assert abs(res["engine"]["si_snr"] - res["static_quant"]["si_snr"]) < 0.5
    off = convert(dataclasses.replace(CFG, validate_engine=False,
                                      validate_static_quant=False), model)
    assert "engine" not in off and "static_quant" not in off
    assert convert(dataclasses.replace(CFG, calibrate_quant=False),
                   model) == {}
