"""The port's transform ops and transcode pipeline ≡ the JAX package's.

The same numpy inputs, made from a seed, go through
``easydarwin_tpu.ops.transform`` (K2 as ``decode_blocks_pallas`` in
interpret mode) and ``easydarwin_tpu_torch.ops.transform`` on the CPU.
Tolerances, each with its reason:

* tables and operators: bit-equal (the same numpy code);
* ``quantize``/``dequantize``/``requantize``/``encode_blocks``/
  ``requantize_downscale2x``/``decode_blocks``: bit-exact on these inputs
  (IEEE fp32 multiply, divide, round half to even on both sides; the fp32
  products sum in another order but land on the same integers here).  The
  reference's own bound for K2 is |diff| <= 1 on < 1% of pixels
  (``tests/test_transform.py``);
* a numpy mirror of the CUDA kernel's separable fp32 order (``Cᵀ·Y·C``
  in fmaf chains, which the card alone can run as written): the
  reference's tolerance, since it sums in another order than the 64×64
  product;
* the pipeline's rungs against the JAX *pipeline*: <= 1 on < 2%
  (``tests/test_models.py``: XLA's fused ladder may round differently at
  exact .5 boundaries); against JAX ``requantize``, rung by rung:
  bit-exact;
* B7's ``requant_rungs_plain`` (and the wrapper on a CPU tensor) against
  JAX ``requantize`` rung by rung, at exact .5 boundaries, at ±2047 and at
  levels where a reciprocal multiply would round the other way:
  bit-exact.
"""

import numpy as np
import pytest
import torch

from easydarwin_tpu.models.transcode_pipeline import TranscodeConfig as RefConfig
from easydarwin_tpu.models.transcode_pipeline import \
    TranscodePipeline as RefPipeline
from easydarwin_tpu.ops import transform as ref
from easydarwin_tpu_torch import convert
from easydarwin_tpu_torch.models import TranscodeConfig, TranscodePipeline
from easydarwin_tpu_torch.models.transcode_pipeline import _ladder_step
from easydarwin_tpu_torch.ops import kernel_lib
from easydarwin_tpu_torch.ops import transform as tf
from easydarwin_tpu_torch.ops.transform_kernel import (
    REQUANT_MAX_BLOCKS, REQUANT_MAX_RUNGS, decode_blocks_kernel, requant_rungs,
    requant_rungs_launch)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _smooth_pixels(rng, n):
    """Blocks of gradients plus noise (JPEG-like spectra), uint8 [n, 64]."""
    yy, xx = np.mgrid[0:8, 0:8]
    gx, gy = rng.uniform(-12, 12, (2, n, 1, 1))
    base = rng.uniform(40, 215, (n, 1, 1))
    pix = base + gx * (xx - 3.5) + gy * (yy - 3.5) + rng.normal(0, 4, (n, 8, 8))
    return np.clip(np.round(pix), 0, 255).astype(np.uint8).reshape(n, 64)


def test_dct_and_kron_operators_bit_equal():
    np.testing.assert_array_equal(tf.dct_matrix(), ref.dct_matrix())
    for a, b in zip(tf._kron_mats(), ref._kron_mats()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    inv = tf.operator("inv", torch.device("cpu"))
    np.testing.assert_array_equal(inv.numpy(), ref._kron_mats()[1])


@pytest.mark.parametrize("q", [1, 25, 50, 75, 90, 100])
def test_quality_table_bit_equal(q):
    a, b = tf.quality_table(q), ref.quality_table(q)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_zigzag_order_and_reorders_equal():
    np.testing.assert_array_equal(tf.zigzag_order(), ref.zigzag_order())
    rng = np.random.default_rng(3)
    lv = rng.integers(-500, 500, (37, 64)).astype(np.int32)
    np.testing.assert_array_equal(tf.to_zigzag(_t(lv)).numpy(),
                                  np.asarray(ref.to_zigzag(lv)))
    np.testing.assert_array_equal(tf.from_zigzag(_t(lv)).numpy(),
                                  np.asarray(ref.from_zigzag(lv)))
    np.testing.assert_array_equal(tf.to_zigzag_np(lv), ref.to_zigzag_np(lv))
    np.testing.assert_array_equal(tf.from_zigzag_np(lv),
                                  ref.from_zigzag_np(lv))
    np.testing.assert_array_equal(tf.from_zigzag_np(tf.to_zigzag_np(lv)), lv)


def test_downscale2x_operator_bit_equal():
    a, b = tf.downscale2x_operator(), ref.downscale2x_operator()
    assert a.shape == (256, 64) and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_quantize_dequantize_bit_exact():
    rng = np.random.default_rng(8)
    coef = rng.normal(0, 300, (2048, 64)).astype(np.float32)
    coef[:64] = np.round(coef[:64]) + 0.5        # exact .5 ties: half-even
    qt = ref.quality_table(60)
    np.testing.assert_array_equal(tf.quantize(_t(coef), _t(qt)).numpy(),
                                  np.asarray(ref.quantize(coef, qt)))
    lv = rng.integers(-2047, 2048, (2048, 64)).astype(np.int32)
    np.testing.assert_array_equal(tf.dequantize(_t(lv), _t(qt)).numpy(),
                                  np.asarray(ref.dequantize(lv, qt)))


@pytest.mark.parametrize("q_in,q_out", [(90, 80), (90, 25), (50, 95)])
def test_requantize_and_ladder_bit_exact(q_in, q_out):
    rng = np.random.default_rng(q_in * 100 + q_out)
    qi = ref.quality_table(q_in)
    lv = np.asarray(ref.encode_blocks(_smooth_pixels(rng, 1024), qi))
    qo = ref.quality_table(q_out)
    np.testing.assert_array_equal(
        tf.requantize(_t(lv), _t(qi), _t(qo)).numpy(),
        np.asarray(ref.requantize(lv, qi, qo)))
    for a, b in zip(tf.transcode_ladder(_t(lv), _t(qi), (q_out, 30)),
                    ref.transcode_ladder(lv, qi, (q_out, 30))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_encode_blocks_bit_exact():
    rng = np.random.default_rng(11)
    pix = np.concatenate([_smooth_pixels(rng, 2000),
                          rng.integers(0, 256, (500, 64), dtype=np.uint8)])
    for q in (95, 50, 10):
        qt = ref.quality_table(q)
        np.testing.assert_array_equal(
            tf.encode_blocks(_t(pix), _t(qt)).numpy(),
            np.asarray(ref.encode_blocks(pix, qt)))


@pytest.mark.parametrize("n", [1, 300, 4096])
def test_decode_blocks_plain_matches_jnp_and_pallas_interpret(n):
    rng = np.random.default_rng(n)
    qt = ref.quality_table(75)
    lv = np.asarray(ref.encode_blocks(_smooth_pixels(rng, n), qt))
    got = tf.decode_blocks_plain(_t(lv), _t(qt)).numpy()
    assert got.dtype == np.uint8 and got.shape == (n, 64)
    for want in (np.asarray(ref.decode_blocks(lv, qt)),
                 np.asarray(ref.decode_blocks_pallas(lv, qt,
                                                     interpret=True))):
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
        np.testing.assert_array_equal(got, want)      # and here exactly
    # the [1, 64] table shape the Pallas call takes gives the same result
    np.testing.assert_array_equal(
        tf.decode_blocks(_t(lv), _t(qt).reshape(1, 64)).numpy(), got)


def test_idct8_operator_bit_equal():
    got = tf.operator("idct8", torch.device("cpu")).numpy()
    want = ref.dct_matrix().astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (8, 8)
    np.testing.assert_array_equal(got, want)


def _fmaf(a, b, c):
    """fp32 fused multiply-add: the product of two fp32 values is exact in
    fp64, so the fp64 sum rounded once more to fp32 is ``fmaf`` (but for
    the rare double-rounding tie)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _separable_decode_mirror(levels, qt, c):
    """The kernel's arithmetic in numpy, in its order: dequantize in fp32;
    row pass Z[u][j] = Σ_v Y[u][v]·C[v][j], v ascending; column pass
    X[i][j] = Σ_u C[u][i]·Z[u][j], u ascending; each sum a chain of fmaf
    from 0; then +128, round half to even, clamp, uint8."""
    y = (levels.astype(np.float32) * qt.astype(np.float32)).reshape(-1, 8, 8)
    z = np.zeros_like(y)
    for v in range(8):
        z = _fmaf(y[:, :, v:v + 1], c[v][None, None, :], z)
    x = np.zeros_like(z)
    for u in range(8):
        x = _fmaf(c[u][None, :, None], z[:, u:u + 1, :], x)
    x = x + np.float32(128)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8).reshape(-1, 64)


def _decode_case(kind, n):
    """(levels, qtable) of one kind: JPEG-like smooth blocks at q75,
    random pixels at q75, or random levels in ±2000 at q50."""
    rng = np.random.default_rng(1000 + n)
    if kind == "levels2000":
        return (rng.integers(-2000, 2001, (n, 64)).astype(np.int32),
                ref.quality_table(50))
    qt = ref.quality_table(75)
    pix = (_smooth_pixels(rng, n) if kind == "smooth"
           else rng.integers(0, 256, (n, 64), dtype=np.uint8))
    return np.asarray(ref.encode_blocks(pix, qt)), qt


@pytest.mark.parametrize("kind", ["smooth", "pixels", "levels2000"])
@pytest.mark.parametrize("n", [1, 300, 4096])
def test_separable_mirror_matches_jnp_and_pallas_interpret(kind, n):
    """The kernel's separable fp32 order, proven on the CPU against JAX
    ``decode_blocks`` and the Pallas kernel in interpret mode at the
    reference's tolerance: |diff| <= 1 on < 1% of pixels."""
    lv, qt = _decode_case(kind, n)
    c = tf.operator("idct8", torch.device("cpu")).numpy()
    got = _separable_decode_mirror(lv, qt, c)
    assert got.dtype == np.uint8 and got.shape == (n, 64)
    for want in (np.asarray(ref.decode_blocks(lv, qt)),
                 np.asarray(ref.decode_blocks_pallas(lv, qt,
                                                     interpret=True))):
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_tensor_map_failure_reads_as_a_cuda_result():
    # ed_decode_blocks returns this base + CUresult when a TMA tensor map
    # cannot be encoded; the launch then raises with this message
    msg = kernel_lib.error_message(kernel_lib.TENSOR_MAP_ERROR + 1)
    assert msg == "cuTensorMapEncodeTiled failed with CUresult 1"


def test_requantize_downscale2x_bit_exact():
    rng = np.random.default_rng(21)
    qi = ref.quality_table(85)
    lv = np.asarray(ref.encode_blocks(_smooth_pixels(rng, 4 * 512), qi))
    quads = lv.reshape(512, 4, 64)
    qo = ref.quality_table(40)
    got = tf.requantize_downscale2x(_t(quads), _t(qi), _t(qo)).numpy()
    want = np.asarray(ref.requantize_downscale2x(quads, qi, qo))
    assert got.dtype == np.int32 and got.shape == (512, 64)
    np.testing.assert_array_equal(got, want)
    deq = (quads.reshape(512, 256) * np.tile(qi, 4)).astype(np.float32)
    np.testing.assert_allclose(tf.downscale2x_blocks(_t(deq)).numpy(),
                               np.asarray(ref.downscale2x_blocks(deq)),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("decode_pixels", [False, True])
def test_pipeline_matches_the_jax_pipeline(decode_pixels):
    qualities, src_q = (80, 50, 25), 90
    rng = np.random.default_rng(7)
    lv = np.asarray(ref.encode_blocks(_smooth_pixels(rng, 1536),
                                      ref.quality_table(src_q)))
    want = RefPipeline(RefConfig(qualities, src_q, decode_pixels))(lv)
    pipe = TranscodePipeline(TranscodeConfig(qualities, src_q,
                                             decode_pixels), device="cpu")
    got = pipe(lv)
    # the same step on tables carried over from the reference's numpy
    qt_in, qt_rungs = convert.transcode_tables_from_numpy(
        ref.quality_table(src_q),
        np.stack([ref.quality_table(q) for q in qualities]), "cpu")
    np.testing.assert_array_equal(qt_in.numpy(), pipe.qt_in.numpy())
    np.testing.assert_array_equal(qt_rungs.numpy(), pipe.qt_rungs.numpy())
    again = _ladder_step(_t(lv), qt_in=qt_in, qt_rungs=qt_rungs,
                         decode_pixels=decode_pixels)
    assert sorted(got) == sorted(again) == sorted(want)
    rungs = got["rungs"].numpy()
    assert rungs.shape == (3, 1536, 64) and rungs.dtype == np.int32
    np.testing.assert_array_equal(again["rungs"].numpy(), rungs)
    d = np.abs(rungs - np.asarray(want["rungs"]))
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    for r, q in enumerate(qualities):             # rung by rung: exact
        np.testing.assert_array_equal(rungs[r], np.asarray(ref.requantize(
            lv, ref.quality_table(src_q), ref.quality_table(q))))
    nz = got["nonzeros"].numpy()
    assert nz.dtype == np.int32
    np.testing.assert_array_equal(nz, (rungs != 0).sum(axis=(1, 2)))
    assert nz[0] >= nz[1] >= nz[2] > 0
    if decode_pixels:
        px = got["pixels"].numpy()
        d = np.abs(px.astype(int) - np.asarray(want["pixels"]).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_transcode_tables_from_numpy_validates_and_copies():
    qi = ref.quality_table(90)
    qr = np.stack([ref.quality_table(q) for q in (80, 40)])
    a, b = convert.transcode_tables_from_numpy(qi, qr, "cpu")
    assert a.dtype == b.dtype == torch.float32 and tuple(b.shape) == (2, 64)
    qr[0, 0] = 99
    assert float(b[0, 0]) == ref.quality_table(80)[0]   # a copy
    with pytest.raises(ValueError):
        convert.transcode_tables_from_numpy(qi[:63], qr, "cpu")
    with pytest.raises(ValueError):
        convert.transcode_tables_from_numpy(qi, qr[0], "cpu")
    with pytest.raises(ValueError):
        convert.transcode_tables_from_numpy(np.zeros(64), qr, "cpu")


def test_cpu_decode_counts_no_launch():
    kernel_lib.reset_launch_counts()
    qt = _t(ref.quality_table(50))
    lv = torch.zeros((10, 64), dtype=torch.int32)
    assert decode_blocks_kernel(lv, qt).shape == (10, 64)
    assert decode_blocks_kernel(lv[:0], qt).shape == (0, 64)
    TranscodePipeline(TranscodeConfig(decode_pixels=True), device="cpu")(lv)
    assert kernel_lib.LAUNCHES["ed_decode_blocks"] == 0
    assert set(kernel_lib.LAUNCHES) == {"ed_parse_packets", "ed_relay_window",
                                        "ed_ring_query", "ed_decode_blocks",
                                        "ed_gf_parity", "ed_relay_batch",
                                        "ed_relay_shard", "ed_requant_rungs",
                                        "ed_h264_requant",
                                        "ed_h264_requant_chroma"}


@pytest.mark.parametrize("levels,qtable,err", [
    (torch.zeros((4, 64), dtype=torch.float32), torch.ones(64), TypeError),
    (torch.zeros((4, 63), dtype=torch.int32), torch.ones(64), ValueError),
    (torch.zeros((4, 64), dtype=torch.int32), torch.ones(63), ValueError),
    (torch.zeros((4, 64), dtype=torch.int32),
     torch.ones(64, dtype=torch.float64), TypeError),
    (torch.zeros(64, dtype=torch.int32), torch.ones(64), ValueError),
])
def test_decode_wrapper_raises_on_a_wrong_dtype_or_shape(levels, qtable, err):
    with pytest.raises(err):
        decode_blocks_kernel(levels, qtable)
    with pytest.raises(err):
        tf.decode_blocks(levels, qtable)


def test_pipeline_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TranscodePipeline().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TranscodePipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.transcode_tables_from_numpy(np.ones(64), np.ones((1, 64)))
    pipe = TranscodePipeline(device="cpu")
    (lv,) = pipe.example_args(64)
    assert lv.shape == (64, 64) and lv.dtype == np.int32


def _requant_case(n, r, seed):
    """(levels, qt_in, qt_rungs) with levels in ±2047 (both ends present),
    random quality tables, and columns 0-3 set up for exact .5 ties: there
    qt_in is 1 and a rung's entry 2 or 4, so odd levels (or levels 2 mod 4)
    land on k + 0.5."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(-2047, 2048, (n, 64)).astype(np.int32)
    lv.flat[:2] = (2047, -2047)
    qi = ref.quality_table(int(rng.integers(50, 100)))
    qr = np.stack([ref.quality_table(int(q))
                   for q in rng.integers(5, 96, r)]).astype(np.float32)
    qi[:4] = 1
    qr[:, :2] = 2
    qr[:, 2:4] = 4
    return lv, qi, qr


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 7, 4096])
def test_requant_rungs_plain_matches_jax_requantize(n, r):
    lv, qi, qr = _requant_case(n, r, 100 * n + r)
    rungs, nonzeros = tf.requant_rungs_plain(_t(lv), _t(qi), _t(qr))
    assert rungs.dtype == nonzeros.dtype == torch.int32
    assert tuple(rungs.shape) == (r, n, 64) and tuple(nonzeros.shape) == (r,)
    again = requant_rungs(_t(lv), _t(qi), _t(qr))      # the CPU wrapper
    for k in range(r):
        want = np.asarray(ref.requantize(lv, qi, qr[k]))
        np.testing.assert_array_equal(rungs[k].numpy(), want)
        np.testing.assert_array_equal(again[0][k].numpy(), want)
        np.testing.assert_array_equal(
            tf.requantize(_t(lv), _t(qi), _t(qr[k])).numpy(), want)
        assert int(nonzeros[k]) == np.count_nonzero(want)
    np.testing.assert_array_equal(again[1].numpy(), nonzeros.numpy())
    ties = lv[:, :4].astype(np.float32) / qr[0, :4]
    if n > 1:
        assert (ties == np.floor(ties) + 0.5).any()    # the .5 ties are there
    assert kernel_lib.LAUNCHES["ed_requant_rungs"] == 0


def test_requant_rungs_divides_where_a_reciprocal_would_not():
    """Levels where round(coef * (1/q)) and round(coef / q) differ in fp32,
    found by a seeded search over quality pairs: the plain version equals
    JAX ``requantize`` there, and so does not multiply by a reciprocal."""
    rng = np.random.default_rng(2026)
    all_levels = np.arange(-2047, 2048, dtype=np.int32)
    found = 0
    for q_in, q_out in rng.integers(5, 100, (12, 2)):
        qi, qo = ref.quality_table(int(q_in)), ref.quality_table(int(q_out))
        coef = all_levels[:, None].astype(np.float32) * qi[None, :]
        true_q = np.rint(coef / qo[None, :])
        recip_q = np.rint(coef * (np.float32(1) / qo)[None, :])
        hits = true_q != recip_q                       # [4095, 64]
        if not hits.any():
            continue
        # one row per hit, its level in the hit's column, zeros elsewhere
        rows, cols = np.nonzero(hits)
        lv = np.zeros((len(rows), 64), np.int32)
        lv[np.arange(len(rows)), cols] = all_levels[rows]
        got = tf.requant_rungs_plain(_t(lv), _t(qi), _t(qo[None]))[0][0]
        got = got.numpy()[np.arange(len(rows)), cols]
        want = np.asarray(ref.requantize(lv, qi, qo))[np.arange(len(rows)),
                                                     cols]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, true_q[rows, cols])
        assert (got != recip_q[rows, cols]).all()
        found += len(rows)
    assert found > 0


def _levels(n=4, dtype=torch.int32, device="cpu"):
    return torch.zeros((n, 64), dtype=dtype, device=device)


@pytest.mark.parametrize("levels,qt_in,qt_rungs,err,match", [
    (_levels(dtype=torch.float32), torch.ones(64), torch.ones((2, 64)),
     TypeError, "levels"),
    (torch.zeros((4, 63), dtype=torch.int32), torch.ones(64),
     torch.ones((2, 64)), ValueError, "levels"),
    (_levels(), torch.ones(63), torch.ones((2, 64)), ValueError, "qtable"),
    (_levels(), torch.ones(64), torch.ones((2, 64), dtype=torch.float64),
     TypeError, "qt_rungs"),
    (_levels(), torch.ones(64), torch.ones(64), ValueError, "qt_rungs"),
    (_levels(), torch.ones(64), torch.ones((0, 64)), ValueError, "qt_rungs"),
    (_levels(), torch.ones(64), torch.ones((REQUANT_MAX_RUNGS + 1, 64)),
     ValueError, "qt_rungs"),
    (_levels(), torch.ones(64), torch.ones((2, 63)), ValueError, "qt_rungs"),
    (_levels(REQUANT_MAX_BLOCKS + 1, device="meta"),
     torch.ones(64, device="meta"), torch.ones((2, 64), device="meta"),
     ValueError, "blocks is above"),
    (_levels(), torch.ones(64), torch.ones((2, 64), device="meta"),
     ValueError, "qt_rungs is on meta"),
    (_levels(device="meta"), torch.ones(64, device="meta"),
     torch.ones((2, 64), device="meta"), ValueError,
     "no requant kernel for device meta"),
])
def test_requant_wrapper_raises_on_a_wrong_dtype_or_shape(levels, qt_in,
                                                          qt_rungs, err,
                                                          match):
    with pytest.raises(err, match=match):
        requant_rungs_launch(levels, qt_in, qt_rungs)
    assert kernel_lib.LAUNCHES["ed_requant_rungs"] == 0
