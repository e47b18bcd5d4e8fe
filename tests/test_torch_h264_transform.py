"""The port's H.264 transform core and B6 ≡ the JAX package's, on the CPU.

``easydarwin_tpu_torch.codecs.h264_transform`` is a numpy copy of the
reference module: every table and scalar function is compared exactly on
seeded inputs.  B6, ``ops.transform.h264_requant`` and
``h264_requant_chroma`` (torch int32 ops), is held bit-exact against JAX
``easydarwin_tpu.ops.transform.h264_requant[_chroma]`` and against the
scalar oracles over the whole QP grid: every ``qp_in`` in 0-51 and every
``qp_out ≡ qp_in (mod 6)`` up to 51 for luma, with levels at 0, ±1,
±``LEVEL_CLIP`` and 300 beyond it; chroma with the reference's own mixes
(the saturation-identity rows at QPc 39, the ±6000 clip contract) and
with deltas that are not multiples of 6 on every ``qpc_in % 6``.  Every
output is int32.
"""

import numpy as np
import pytest
import torch

from easydarwin_tpu.codecs import h264_transform as ref
from easydarwin_tpu.ops.transform import h264_requant as jax_luma
from easydarwin_tpu.ops.transform import h264_requant_chroma as jax_chroma
from easydarwin_tpu_torch.codecs import h264_transform as ht
from easydarwin_tpu_torch.ops import transform as tf

TABLES = ("MF", "V", "_CLS", "_CF", "ZIGZAG4", "CHROMA_QP", "_H2")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- the numpy module
@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_reference(name):
    a, b = getattr(ht, name), getattr(ref, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_constants_equal_the_reference():
    for name in ("LEVEL_CLIP", "RES_CLIP", "W_CLIP"):
        assert getattr(ht, name) == getattr(ref, name)


def test_chroma_qp_and_positions_equal_the_reference():
    for qp in range(-15, 70):
        for off in (-12, -3, 0, 5, 12):
            assert ht.chroma_qp(qp, off) == ref.chroma_qp(qp, off)
    for qp in range(52):
        np.testing.assert_array_equal(ht.mf_position(qp),
                                      ref.mf_position(qp))
        np.testing.assert_array_equal(ht.v_position(qp), ref.v_position(qp))


@pytest.mark.parametrize("seed", range(4))
def test_scalar_transforms_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        res = rng.integers(-255, 256, (4, 4))
        qp = int(rng.integers(0, 52))
        lev = ht.forward_transform_quant(res, qp)
        np.testing.assert_array_equal(lev,
                                      ref.forward_transform_quant(res, qp))
        np.testing.assert_array_equal(ht.dequant_inverse(lev, qp),
                                      ref.dequant_inverse(lev, qp))
        w = rng.integers(-20000, 20000, (4, 4))
        np.testing.assert_array_equal(ht.inverse_core(w),
                                      ref.inverse_core(w))
        dc = rng.integers(-3000, 3000, 4)
        np.testing.assert_array_equal(ht.chroma_dc_dequant(dc, qp),
                                      ref.chroma_dc_dequant(dc, qp))
        w00 = rng.integers(-200000, 200000, 4)
        np.testing.assert_array_equal(ht.chroma_dc_quant(w00, qp),
                                      ref.chroma_dc_quant(w00, qp))


@pytest.mark.parametrize("seed", range(3))
def test_scalar_requants_equal_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(60):
        lev = rng.integers(-3000, 3000, 16)
        qi = int(rng.integers(0, 40))
        qo = qi + 6 * int(rng.integers(1, 3))
        np.testing.assert_array_equal(ht.requant_levels_scalar(lev, qi, qo),
                                      ref.requant_levels_scalar(lev, qi, qo))
        dc = rng.integers(-3000, 3000, 4)
        ac = rng.integers(-300, 300, (4, 15)) * (rng.random((4, 15)) < 0.5)
        qci = int(rng.integers(0, 40))
        qco = qci + int(rng.integers(0, 12))
        for a, b in zip(ht.requant_chroma_scalar(dc, ac, qci, qco),
                        ref.requant_chroma_scalar(dc, ac, qci, qco)):
            np.testing.assert_array_equal(a, b)


def test_scalar_requant_refusals_match():
    for fn in (ht.requant_levels_scalar, ref.requant_levels_scalar):
        with pytest.raises(ValueError):
            fn(np.zeros(16), 20, 23)
        with pytest.raises(ValueError):
            fn(np.zeros(16), 20, 20)
    for fn in (ht.requant_chroma_scalar, ref.requant_chroma_scalar):
        with pytest.raises(ValueError):
            fn(np.zeros(4), np.zeros((4, 15)), 20, 19)


# ------------------------------------------------------------ B6 luma
#: levels at 0, ±1, ±LEVEL_CLIP and 300 beyond it, plus a spread
_EDGE = np.array([0, 1, -1, 2, -2, 3, -3, ht.LEVEL_CLIP, -ht.LEVEL_CLIP,
                  ht.LEVEL_CLIP + 300, -ht.LEVEL_CLIP - 300, 5, -7, 1000,
                  -1023, 64], np.int32)


def _luma_grid():
    """Every (qp_in, qp_out) with qp_out ≡ qp_in (mod 6), qp_in <= qp_out
    <= 51, each pair a row block of the edge levels and a seeded spread."""
    pairs = [(qi, qo) for qi in range(52) for qo in range(qi, 52, 6)]
    rng = np.random.default_rng(6)
    rows = []
    for _ in pairs:
        rows.append(_EDGE)
        rows.append(rng.integers(-2500, 2500, 16).astype(np.int32))
    qi = np.repeat([p[0] for p in pairs], 2).astype(np.int32)
    qo = np.repeat([p[1] for p in pairs], 2).astype(np.int32)
    return np.stack(rows), qi, qo


def test_luma_requant_equals_jax_and_the_scalar_on_the_qp_grid():
    lev, qi, qo = _luma_grid()
    got = tf.h264_requant(_t(lev), _t(qi), _t(qo))
    assert got.dtype == torch.int32 and tuple(got.shape) == lev.shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_luma(lev, qi, qo)))
    for i in np.flatnonzero(qo > qi):
        np.testing.assert_array_equal(
            got[i].numpy(), ht.requant_levels_scalar(lev[i], int(qi[i]),
                                                     int(qo[i])))
    same = qo == qi                   # k = 0: the clipped levels
    np.testing.assert_array_equal(
        got.numpy()[same], np.clip(lev[same], -ht.LEVEL_CLIP, ht.LEVEL_CLIP))


@pytest.mark.parametrize("qp_out", [6, 30, 51])
def test_luma_requant_with_a_scalar_qp_out(qp_out):
    rng = np.random.default_rng(qp_out)
    qi = (qp_out - 6 * rng.integers(1, qp_out // 6 + 1, 40)).astype(np.int32)
    lev = rng.integers(-2100, 2100, (40, 16)).astype(np.int32)
    for q in (qp_out, np.int64(qp_out), torch.tensor(qp_out)):
        got = tf.h264_requant(_t(lev), _t(qi), q)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_luma(lev, qi, np.int32(qp_out))))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int64])
def test_luma_requant_casts_other_integer_levels(dtype):
    lev, qi, qo = _luma_grid()
    got = tf.h264_requant(_t(lev).to(dtype), _t(qi).long(), _t(qo).long())
    assert got.dtype == torch.int32
    want = tf.h264_requant(_t(lev), _t(qi), _t(qo))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------- B6 chroma
def _check_chroma(dc, ac, qi, qo):
    ddc, dac = tf.h264_requant_chroma(_t(dc), _t(ac), _t(qi), _t(qo))
    assert ddc.dtype == dac.dtype == torch.int32
    assert tuple(ddc.shape) == dc.shape and tuple(dac.shape) == ac.shape
    jdc, jac = jax_chroma(dc, ac, qi, qo)
    np.testing.assert_array_equal(ddc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(dac.numpy(), np.asarray(jac))
    for i in range(dc.shape[0]):
        sdc, sac = ht.requant_chroma_scalar(dc[i], ac[i], int(qi[i]),
                                            int(qo[i]))
        np.testing.assert_array_equal(ddc[i].numpy(), sdc)
        np.testing.assert_array_equal(dac[i].numpy(), sac)
    return qo - qi


def _reference_mix(seed):
    """``tests/test_h264_codec.py``'s mix: luma steps of 6, 12 or 18
    through Table 8-15, the first 16 rows saturated at QPc 39."""
    rng = np.random.default_rng(seed)
    n = 256
    dc = rng.integers(-400, 400, (n, 4)).astype(np.int32)
    ac = (rng.integers(-90, 90, (n, 4, 15))
          * (rng.random((n, 4, 15)) < 0.4)).astype(np.int32)
    qpy = rng.integers(8, 46, n)
    dqp = rng.choice([6, 12, 18], n)
    qi = np.array([ht.chroma_qp(int(q)) for q in qpy], np.int32)
    qo = np.array([ht.chroma_qp(int(q + d)) for q, d in zip(qpy, dqp)],
                  np.int32)
    qi[:16] = 39
    qo[:16] = 39
    return dc, ac, qi, qo


@pytest.mark.parametrize("seed", [9, 10])
def test_chroma_requant_reference_mix_covers_all_three_arms(seed):
    delta = _check_chroma(*_reference_mix(seed))
    assert (delta == 0).any()
    assert ((delta > 0) & (delta % 6 == 0)).any()
    assert (delta % 6 != 0).any()


@pytest.mark.parametrize("qo", [29, 26, 39])
def test_chroma_requant_clip_contract(qo):
    rng = np.random.default_rng(13 + qo)
    n = 64
    dc = rng.integers(-6000, 6000, (n, 4)).astype(np.int32)
    ac = rng.integers(-6000, 6000, (n, 4, 15)).astype(np.int32)
    _check_chroma(dc, ac, np.full(n, 20, np.int32), np.full(n, qo, np.int32))


@pytest.mark.parametrize("mod", range(6))
def test_chroma_requant_non_multiple_deltas_on_every_qp_mod_6(mod):
    rng = np.random.default_rng(40 + mod)
    qi = np.array([q for q in range(52) if q % 6 == mod], np.int32)
    rows_qi, rows_qo = [], []
    for q in qi:
        for d in range(1, 52 - int(q)):
            if d % 6:
                rows_qi.append(q)
                rows_qo.append(q + d)
    n = len(rows_qi)
    dc = rng.integers(-2100, 2100, (n, 4)).astype(np.int32)
    ac = (rng.integers(-400, 400, (n, 4, 15))
          * (rng.random((n, 4, 15)) < 0.5)).astype(np.int32)
    dc[0] = (ht.LEVEL_CLIP, -ht.LEVEL_CLIP, 0, 1)
    ac[0, 0, :4] = (ht.LEVEL_CLIP + 300, -ht.LEVEL_CLIP - 300, -1, 1)
    delta = _check_chroma(dc, ac, np.array(rows_qi, np.int32),
                          np.array(rows_qo, np.int32))
    assert (delta % 6 != 0).all()


def test_chroma_requant_negative_multiple_of_6_is_identity_like_jax():
    rng = np.random.default_rng(77)
    dc = rng.integers(-3000, 3000, (8, 4)).astype(np.int32)
    ac = rng.integers(-3000, 3000, (8, 4, 15)).astype(np.int32)
    qi = np.full(8, 30, np.int32)
    qo = np.full(8, 24, np.int32)
    ddc, dac = tf.h264_requant_chroma(_t(dc), _t(ac), _t(qi), _t(qo))
    jdc, jac = jax_chroma(dc, ac, qi, qo)
    np.testing.assert_array_equal(ddc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(dac.numpy(), np.asarray(jac))
    np.testing.assert_array_equal(ddc.numpy(), np.clip(dc, -2047, 2047))
