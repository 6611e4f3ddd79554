"""The port's fixed-point model against the JAX package's, on the CPU:
``build_fxp_model`` on the JAX-frozen tree of
``tests/test_torch_quantize.py`` (and a w16a16 calibration of the same
weights, whose 16 x 16-bit dots take the int64 path), every packed
``FxpArray`` (data, bits, exp) and every spec equal, the export bundle
equal key by key, and the forward's output and every
``collect_intermediates`` entry equal, integers with tolerance 0. Glu
``full`` / ``half1`` / ``half2`` / ``none``, postnorm, ``approx_topk``
with ``topk`` < 1 and ``task="classification"``. Also the plain
``fxp_scan`` (the recurrence of ``FxpSSM``) against JAX's ``lax.scan``
step on saturating codes, and a bidirectional mixer's C1 / C2.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp import derive as jderive
from sparsernns_tpu.fxp import model as jmodel
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu_torch.fxp import derive as tderive
from sparsernns_tpu_torch.fxp import model as tmodel
from sparsernns_tpu_torch.ops.cuda import fxp_scan
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from tests.test_torch_quantize import B, D_IO, L, frozen, jax_model  # noqa: F401

CASES = {
    "full": ("w8a16", dict(glu_variant="full")),
    "half1": ("w8a16", dict()),
    "half2": ("w8a16", dict(glu_variant="half2")),
    "none": ("w8a16", dict(glu_variant="none")),
    "postnorm": ("w8a16", dict(prenorm=False)),
    "topk": ("w8a16", dict(topk=0.5, approx_topk=True)),
    "w16a16": ("w16a16", dict(glu_variant="full")),
    "classification": ("w8a16", dict(task="classification")),
}


@pytest.fixture(scope="module")
def trees(frozen):  # noqa: F811
    """The w8a16 frozen tree and a w16a16 calibration of the same float
    weights and batches, the way the w8a16 one was made."""
    zeros = jnp.zeros((B, L, D_IO), jnp.float32)
    cal = jax_model(jax_recipes["w16a16"](static_quant=True,
                                          calibrating=True))
    p16, s16 = jax.device_get(jax_calibrate(
        cal, jax.random.PRNGKey(0), zeros, frozen["params"],
        frozen["stats"], [jnp.asarray(b) for b in frozen["batches"]]))
    return {"w8a16": (frozen["frozen_params"], frozen["frozen_stats"]),
            "w16a16": (p16, s16), "x": frozen["batches"][0]}


def _build(params, stats, recipe, **kw):
    cfg = {**dict(glu_variant="half1", relufication=True, prenorm=True,
                  clip_eigs=True), **kw}
    jm = jderive.build_fxp_model(
        params, stats, jax_recipes[recipe](static_quant=True,
                                           calibrating=False),
        jderive.FxpModelConfig.infer(params, **cfg))
    tm = tderive.build_fxp_model(
        params, stats, quantization_recipes[recipe](static_quant=True,
                                                    calibrating=False),
        tderive.FxpModelConfig.infer(params, **cfg), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def built(trees):
    """{case: (JAX model, port model, JAX output, port output)}, the
    forward on the test batch with the intermediates on."""
    out = {}
    for case, (recipe, kw) in CASES.items():
        jm, tm = _build(*trees[recipe], recipe, **kw)
        jm.set_store_intermediates(True)
        tm.set_store_intermediates(True)
        x = trees["x"]
        out[case] = (jm, tm, jm(jnp.asarray(x)), tm(torch.from_numpy(x)))
    return out


def _same(j, t, path="model"):
    """JAX and port export trees are equal: keys in order, arrays with
    their dtypes, every other leaf."""
    if isinstance(j, dict):
        assert list(j) == list(t), path
        for k in j:
            _same(j[k], t[k], f"{path}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{path}.{i}")
    elif isinstance(j, np.ndarray) or hasattr(j, "dtype"):
        want = np.asarray(j)
        got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert j == t, (path, j, t)


def _spec_list(specs):
    return None if specs is None else [dataclasses.asdict(s) for s in specs]


@pytest.mark.parametrize("case", list(CASES))
def test_packed_weights_specs_and_export_equal_jax(built, case):
    jm, tm, _, _ = built[case]
    _same(jm.export(), tm.export())
    for jl, tl in zip(jm.encoder.layers, tm.encoder.layers):
        assert dataclasses.asdict(jl.ssm.specs) == \
            dataclasses.asdict(tl.ssm.specs)
        assert _spec_list(jl.mult_specs) == _spec_list(tl.mult_specs)
        assert jl.ssm.specs.u.bits > 0 and tl.mult_specs is not None
        for name in ("y0", "slope"):
            if jl.sigmoid is not None:
                np.testing.assert_array_equal(getattr(tl.sigmoid, name),
                                              getattr(jl.sigmoid, name))
    if CASES[case][0] == "w16a16":   # the dense dots need int64
        enc = tm.encoder.encoder
        assert enc.in_spec.bits + enc.w.bits > 30


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_intermediates_equal_jax(built, case):
    jm, tm, jy, ty = built[case]
    _same(jy.data, ty.data, "output")
    assert (jy.bits, jy.exp, jy.signed) == (ty.bits, ty.exp, ty.signed)
    ji, ti = jm.collect_intermediates(), tm.collect_intermediates()
    assert list(ji) == list(ti)
    assert len(ti) > 10
    for key in ji:
        _same(ji[key], ti[key], key)
    if CASES[case][1].get("task") == "classification":
        assert ty.data.shape == (B, D_IO)


def test_bidirectional_mixer(frozen):  # noqa: F811
    """``_discretize`` concatenates C1 / C2 along P as JAX does (four
    arrays equal); ``build_fxp_model`` packs the (2P, H) C as JAX does, and
    the forward then refuses the state width in both packages."""
    params = copy.deepcopy(frozen["frozen_params"])
    rng = np.random.RandomState(4)
    for i in range(2):
        mixer = params["encoder"][f"layers_{i}"]["mixer"]
        c = mixer.pop("C")
        mixer["C1"] = c
        mixer["C2"] = (0.5 * c + 0.01 * rng.randn(*c.shape)).astype(c.dtype)
    mixer = params["encoder"]["layers_0"]["mixer"]
    cfg = dict(glu_variant="half1", relufication=True, prenorm=True,
               clip_eigs=True)
    want = jderive._discretize(mixer, jderive.FxpModelConfig.infer(
        params, **cfg))
    got = tderive._discretize(mixer, tderive.FxpModelConfig.infer(
        params, **cfg))
    _same(want, got, "discretize")
    assert got[2][0].shape[-1] == 2 * mixer["B"].shape[0]
    jm, tm = _build(params, frozen["frozen_stats"], "w8a16")
    _same(jm.export(), tm.export())
    x = frozen["batches"][0]
    with pytest.raises(TypeError):
        jm(jnp.asarray(x))
    with pytest.raises(RuntimeError):
        tm(torch.from_numpy(x))


@pytest.mark.parametrize("bu_exp", [9, 3])   # bu aligned up, and down
def test_plain_fxp_scan_equals_jax_step_on_saturating_codes(bu_exp):
    """An integer SSM near resonance (|λ| ≈ 0.998) with a narrow state
    (10 bits) and large inputs: the states hit both clip bounds; the
    port's plain ``fxp_scan`` under ``FxpSSM`` equals JAX's ``lax.scan``
    step, states and output."""
    rng = np.random.RandomState(bu_exp)
    p, h, length = 8, 6, 200
    ang = rng.uniform(0.0, 0.3, p)
    lam = (0.998 * np.cos(ang)).astype(np.float32), \
        (0.998 * np.sin(ang)).astype(np.float32)
    b_bar = tuple((0.5 * rng.randn(p, h)).astype(np.float32)
                  for _ in range(2))
    c = tuple((0.3 * rng.randn(h, p)).astype(np.float32) for _ in range(2))
    d = (0.2 * rng.randn(h)).astype(np.float32)
    u = (3.0 * rng.randn(2, length, h)).astype(np.float32)

    def specs(mod):
        s = mod.FxpSpec
        return mod.FxpSSMSpecs(
            a=(s(16, 15), s(16, 15)), b=(s(8, 6), s(8, 7)),
            c=(s(8, 7), s(8, 7)), d=s(8, 7), u=s(16, 10),
            bu=(s(16, bu_exp), s(16, bu_exp + 1)), x=(s(10, 6), s(10, 5)),
            y=s(16, 9))

    j = jmodel.FxpSSM(lam, b_bar, c, d, specs(jmodel), relufication=False)
    t = tmodel.FxpSSM(lam, b_bar, c, d, specs(tmodel),
                      relufication=False).to("cpu")
    j.set_store_intermediates(True)
    t.set_store_intermediates(True)
    u_j = jmodel.FxpSpec(16, 10).quantize(jnp.asarray(u))
    u_t = tmodel.FxpSpec(16, 10).quantize(torch.from_numpy(u))
    jy, jxs = j(u_j)
    ty, txs = t(u_t)
    _same(jxs.real.data, txs.real.data, "states re")
    _same(jxs.imag.data, txs.imag.data, "states im")
    _same(jy.data, ty.data, "output")
    _same(j.intermediates["Bu"], t.intermediates["Bu"], "Bu")
    for part, bits in ((txs.real.data, 10), (txs.imag.data, 10)):
        assert (part == (1 << (bits - 1)) - 1).any()
        assert (part == -(1 << (bits - 1))).any()
    assert t.guard_bits() == 12


def test_fxp_scan_refuses_bad_operands():
    bu = torch.zeros((2, 5, 4), dtype=torch.int32)
    a = torch.zeros(4, dtype=torch.int32)
    bounds = (-512, 511)
    with pytest.raises(ValueError):
        fxp_scan.fxp_scan(bu, bu, a[:3], a, (3, 3), 12, bounds, bounds)
    with pytest.raises(ValueError):
        fxp_scan.fxp_scan(bu.long(), bu, a, a, (3, 3), 12, bounds, bounds)
    with pytest.raises(ValueError):
        fxp_scan.fxp_scan(bu, bu, a, a, (3, 33), 12, bounds, bounds)
    with pytest.raises(ValueError):
        fxp_scan.fxp_scan_cuda(bu, bu, a, a, (3, 3), 12, bounds, bounds)
    xr, xi = fxp_scan.fxp_scan(bu, bu, a, a, (3, 3), 12, bounds, bounds)
    assert xr.shape == bu.shape and not xr.any() and not xi.any()
