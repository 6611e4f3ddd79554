"""Kernel K2 (the whole-layer tail, eval and training forward) as passes
(``ops/cuda/layer_tail.py``, ``csrc/layer_tail.cu``), on the CPU: the cut
of a call into passes and a plain mirror of them.

- The cut, as the CUDA source makes it and the mirror takes it: the
  B-projection chunks cover every (batch row, time step) once, the scan
  grid every (batch row, channel) once, the tail tiles every row of the
  flattened B * L stream once, straddling batch rows; at least
  ceil(B * L / 128) CTAs a product pass; the scratch at most 130 MB at
  B = 32, L = 3751. On the card ``chip_smoke.py`` reads the grids that
  the source recorded at the launch.
- The mirror, written here: the B-projection chunk by chunk, the scan over
  all of L, the tail over tiles of 64 rows of the flattened stream with
  each row's own dropout masks. Bit for bit against the unchanged
  ``layer_tail_plain`` (the same arithmetic, only cut into passes), in
  every mode: affine and non-affine, f32 and bf16 streams, GLU full /
  half1 / half2 / none, gelu and relu with ``relu_state`` and
  ``layer_relu``, masks or none. Against the JAX package's
  ``fused_layer_tail`` (eval) and ``fused_layer_tail_diff`` (training
  forward, masks) in interpret mode: 1e-5 * max(1, |ref|) in the affine
  f32 eval mode, 1e-4 * max(1, |ref|) with masks or in the non-affine
  mode, on bf16 streams one bf16 ulp or, near 0, that f32 bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_layer_train import (
    fused_layer_tail, fused_layer_tail_diff)
from sparsernns_tpu_torch.ops.cuda import layer_tail as lt
from sparsernns_tpu_torch.ops.cuda.layer_tail_bwd import CHUNK
from sparsernns_tpu_torch.ops.scan import sequential_diag_scan
from sparsernns_tpu_torch.utils.trace import launch_counts

PLAN_SHAPES = [(1, 37), (3, 70), (2, 300), (8, 3751), (32, 3751)]
#: the flagship's widths
H_FLAG, P_FLAG = 192, 128
#: B = 3, L = 70: 210 rows, four tail tiles of 64 (two straddle a batch
#: row), B-projection chunks of 70 rows
B, L, H, P = 3, 70, 16, 8
BLOCK_T = 16
ACT_SETS = [("gelu", False, False), ("relu", True, True),
            ("gelu", True, False)]
GLUS = ["full", "half1", "half2", "none"]


# ------------------------------------------------------------------ cut

#: the cut of ``csrc/layer_tail.cu``: chunks of CHUNK rows of one batch row
#: and COL_TILE state columns a B-projection CTA (``kBM``, ``kBN``),
#: SCAN_CHANNELS channels of one batch row a scan CTA (``kScanT``), tail
#: tiles of ROW_TILE flattened rows (``kTail``)
COL_TILE, SCAN_CHANNELS, ROW_TILE = 64, 32, 64


def tail_tiles(batch, length):
    """(first row, end row) of the flattened stream, per tail CTA."""
    rows = batch * length
    return [(r0, min(r0 + ROW_TILE, rows)) for r0 in range(0, rows,
                                                           ROW_TILE)]


def bproj_chunks(batch, length):
    """(batch row, first step, end step) of every B-projection chunk."""
    return [(b, t0, min(t0 + CHUNK, length)) for b in range(batch)
            for t0 in range(0, length, CHUNK)]


def scan_threads(batch, p):
    """(batch row, channel) of every scan thread that walks one, CTA by
    CTA."""
    groups = -(-p // SCAN_CHANNELS)
    return [(cta // groups, q) for cta in range(batch * groups)
            for q in range((cta % groups) * SCAN_CHANNELS,
                           min((cta % groups + 1) * SCAN_CHANNELS, p))]


def passes(batch, length, p):
    """(kernel, CTAs) of the three launches of a call."""
    return [(lt.BPROJ_PASS, len(bproj_chunks(batch, length))
             * -(-2 * p // COL_TILE)),
            (lt.SCAN_PASS, batch * -(-p // SCAN_CHANNELS)),
            (lt.ROW_PASS, len(tail_tiles(batch, length)))]


@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_tail_tiles_cover_every_row_once(batch, length):
    """The tail tiles, in grid order, cover [0, B * L) exactly once; all
    but the last hold 64 rows; tiles straddle batch rows."""
    tiles = tail_tiles(batch, length)
    assert len(tiles) == -(-batch * length // 64)
    covered = np.zeros(batch * length, int)
    for r0, r1 in tiles:
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert all(r1 - r0 == 64 for r0, r1 in tiles[:-1])
    straddle = [t for t in tiles if t[0] // length != (t[1] - 1) // length]
    assert bool(straddle) == (batch > 1 and length % 64 != 0)


@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_bproj_chunks_and_scan_grid_cover_once(batch, length):
    """Every (batch row, step) lies in exactly one B-projection chunk, a
    chunk within one batch row; every (batch row, channel) is walked by
    exactly one scan thread, for P = 128 and an odd P = 18."""
    covered = np.zeros((batch, length), int)
    for b, t0, t1 in bproj_chunks(batch, length):
        assert 0 < t1 - t0 <= CHUNK == 128
        covered[b, t0:t1] += 1
    assert (covered == 1).all()
    for p in (P_FLAG, 18):
        assert sorted(scan_threads(batch, p)) == [
            (b, q) for b in range(batch) for q in range(p)]


@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_passes_and_scratch(batch, length):
    """Three launches: B-projection, scan, tail; every product pass at
    least ceil(B * L / 128) CTAs (235 at B = 8); the scratch, S (B*L, 2P)
    float32, at most 130 MB at the flagship's B = 32."""
    rows = batch * length
    got = passes(batch, length, P_FLAG)
    assert [k for k, _ in got] == [lt.BPROJ_PASS, lt.SCAN_PASS, lt.ROW_PASS]
    for kind, ctas in got:
        if kind != lt.SCAN_PASS:
            assert ctas >= -(-rows // 128)
    assert 4 * rows * 2 * P_FLAG <= 130e6
    if (batch, length) == (8, 3751):
        assert [c for _, c in got] == [960, 32, 469]


def tail_passes(x, lam, w_b, w_c, d, nw, nb, o2k=None, o2b=None, o1k=None,
                o1b=None, act="gelu", glu="none", relu_state=False,
                layer_relu=False, m1=None, m2=None, skip=None):
    """K2 as its passes, the arguments and result of ``layer_tail_plain``:
    S = z @ W_b chunk by chunk of one batch row; the states over all of L
    in place; the tail over tiles of the flattened rows, each row with its
    batch row's m1, m2."""
    b, length, h = x.shape
    p = w_b.shape[-1] // 2
    z, res = lt.norm_and_residual(x, nw, nb, skip)
    s = torch.empty((b * length, 2 * p))
    for bb, t0, t1 in bproj_chunks(b, length):
        s[bb * length + t0:bb * length + t1] = z[bb, t0:t1] @ w_b
    s = s.view(b, length, 2 * p)
    xs, _ = sequential_diag_scan(lam, (s[..., :p], s[..., p:]))
    s = torch.cat(xs, dim=-1).reshape(b * length, 2 * p)
    zf, rf = z.reshape(-1, h), res.reshape(-1, h)
    out = torch.empty((b * length, h), dtype=x.dtype)
    for r0, r1 in tail_tiles(b, length):
        batch_row = torch.arange(r0, r1) // length
        st = torch.relu(s[r0:r1]) if relu_state else s[r0:r1]
        y = st @ w_c + d * zf[r0:r1]
        x1 = lt._act(y, act)
        if m1 is not None:
            x1 = x1 * m1[batch_row, 0]
        if glu == "none":
            hv = x1
        else:
            gate = torch.sigmoid(x1 @ o2k + o2b)
            base = {"half1": x1, "half2": y}.get(glu)
            if base is None:
                base = x1 @ o1k + o1b
            hv = base * gate
            if m2 is not None:
                hv = hv * m2[batch_row, 0]
        o = hv + rf[r0:r1]
        if layer_relu:
            o = torch.relu(o)
        out[r0:r1] = o.to(x.dtype)
    return out.view(b, length, h)


def _operands(seed, glu, affine, masks, b=B, length=L, h=H, p=P):
    """name -> numpy array, None where the mode, the GLU variant or the
    absence of masks leaves an operand out."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    r = rng.uniform(0.6, 0.99, p)
    th = rng.uniform(-np.pi, np.pi, p)
    mask = lambda: (rng.binomial(1, 0.8, (b, 1, h)) / 0.8  # noqa: E731
                    ).astype(np.float32)
    ops = dict(
        x=f(b, length, h), lam_re=(r * np.cos(th)).astype(np.float32),
        lam_im=(r * np.sin(th)).astype(np.float32),
        w_b=f(h, 2 * p, sc=0.3), w_c=f(2 * p, h, sc=0.3), d=f(h),
        nw=(1.0 + 0.2 * rng.randn(h)).astype(np.float32), nb=f(h, sc=0.1),
        o2k=f(h, h, sc=0.3), o2b=f(h, sc=0.1), o1k=f(h, h, sc=0.3),
        o1b=f(h, sc=0.1), m1=mask(), m2=mask(), skip=f(b, length, h))
    if affine:
        ops["skip"] = None
    else:
        ops.update(nw=None, nb=None)
    if glu == "none":
        ops.update(o2k=None, o2b=None, m2=None)
    if glu != "full":
        ops.update(o1k=None, o1b=None)
    if not masks:
        ops.update(m1=None, m2=None)
    return ops


def _torch_args(ops, dtype):
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in ops.items()}
    for k in ("x", "skip"):
        if t[k] is not None:
            t[k] = t[k].to(dtype)
    args = (t["x"], (t["lam_re"], t["lam_im"]), t["w_b"], t["w_c"], t["d"],
            t["nw"], t["nb"], t["o2k"], t["o2b"], t["o1k"], t["o1b"])
    return args, dict(m1=t["m1"], m2=t["m2"], skip=t["skip"])


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("masks", [False, True], ids=["eval", "masks"])
@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", GLUS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "z_skip"])
def test_mirror_equals_plain(affine, dtype, glu, act, relu_state, layer_relu,
                             masks):
    """The mirrored passes equal ``layer_tail_plain`` bit for bit in every
    mode: the passes move no value, they only cut the work."""
    ops = _operands(3 + GLUS.index(glu), glu, affine, masks)
    args, kw = _torch_args(ops, DTYPES[dtype][0])
    flags = dict(act=act, glu=glu, relu_state=relu_state,
                 layer_relu=layer_relu)
    before = launch_counts()["layer_tail_train"]
    ref = lt.layer_tail(*args, **flags, **kw)
    out = tail_passes(*args, **flags, **kw)
    # CPU tensors launch nothing
    assert launch_counts()["layer_tail_train"] == before
    assert out.dtype == ref.dtype == DTYPES[dtype][0]
    assert torch.equal(out, ref)


def test_mirror_matches_plain_at_the_widest_tile():
    """The widest layer whose 64-row x1 tile fits in an H100's shared
    memory (H = 872: a row of the tile 872 floats): within 1e-6 *
    max(1, |ref|) of the plain version (at this depth the CPU's matmul
    sums a short row tile in another order)."""
    ops = _operands(5, "full", True, True, h=872, p=4)
    for k in ("w_b", "o2k", "o1k"):     # unit gain at this width
        ops[k] = ops[k] * np.float32((H / 872) ** 0.5)
    args, kw = _torch_args(ops, torch.float32)
    flags = dict(act="relu", glu="full", relu_state=True, layer_relu=True)
    out = tail_passes(*args, **flags, **kw)
    ref = lt.layer_tail_plain(*args, **flags, **kw)
    assert (out - ref).abs().max() <= 1e-6 * max(1.0, ref.abs().max())


def _bf16_ulp(ref):
    mag = np.maximum(np.abs(np.asarray(ref, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


#: (affine, stream dtype, masks) of the comparisons with JAX: the eval
#: forward, the training forward, LayerNorm's, and both on bf16 streams
JAX_MODES = [(True, "f32", False), (True, "f32", True), (False, "f32", True),
             (True, "bf16", True), (False, "bf16", False)]


@pytest.mark.parametrize("glu,act,relu_state,layer_relu",
                         [("full", "relu", True, True),
                          ("half1", "gelu", False, False),
                          ("half2", "gelu", True, False),
                          ("none", "relu", True, True)])
@pytest.mark.parametrize("affine,dtype,masks", JAX_MODES,
                         ids=["eval", "train", "z_skip_train", "bf16_train",
                              "bf16_z_skip_eval"])
def test_mirror_matches_jax(affine, dtype, masks, glu, act, relu_state,
                            layer_relu):
    """The mirrored passes against ``fused_layer_tail`` (eval) or
    ``fused_layer_tail_diff`` (with masks: the training forward) on the
    same inputs (bf16 streams rounded once, for both); 210 rows in four
    tiles, two of which straddle batch rows. f32 sums in another order:
    affine eval 1e-5, else 1e-4, of max(1, |ref|); bf16 outputs one bf16
    ulp or, near 0, the f32 bar (a sum on either side of a rounding
    boundary)."""
    ops = _operands(11 + GLUS.index(glu), glu, affine, masks)
    tdt, jdt = DTYPES[dtype]
    for k in ("x", "skip"):
        if ops[k] is not None:
            ops[k] = np.asarray(jnp.asarray(ops[k], jdt), np.float32)
    j = {k: None if v is None else
         jnp.asarray(v, jdt if k in ("x", "skip") else jnp.float32)
         for k, v in ops.items()}
    jargs = (j["x"], j["skip"], (j["lam_re"], j["lam_im"]), j["w_b"],
             j["w_c"], j["d"], j["o2k"], j["o2b"], j["o1k"], j["o1b"],
             j["m1"], j["m2"], j["nw"], j["nb"])
    if masks:
        ref = fused_layer_tail_diff(*jargs, BLOCK_T, act, glu, relu_state,
                                    layer_relu)
    else:
        ref = fused_layer_tail(*jargs, block_t=BLOCK_T, act=act, glu=glu,
                               relu_state=relu_state, layer_relu=layer_relu)
    ref = np.asarray(ref, np.float32)
    args, kw = _torch_args(ops, tdt)
    out = tail_passes(*args, act=act, glu=glu, relu_state=relu_state,
                      layer_relu=layer_relu, **kw).float().numpy()
    assert out.shape == ref.shape == (B, L, H)
    scale = max(1.0, np.abs(ref).max())
    bar = (1e-5 if affine and not masks and dtype == "f32" else 1e-4) * scale
    if dtype == "bf16":
        ulp = _bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))
        assert (np.abs(out - ref) <= np.maximum(ulp, bar)).all()
    else:
        assert np.abs(out - ref).max() <= bar
