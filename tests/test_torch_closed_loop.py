"""The port's closed-loop intra requant ≡ the JAX package's, on the CPU.

x264 IPPP streams (``tests/lavc_encode.encode_ippp``: CAVLC and CABAC,
one slice and three) and seeded pictures go through both packages:

* ``h264_pred``'s 4x4, 16x16 and chroma predictions on seeded planes,
  every mode, equal the reference's;
* ``decode_intra_picture`` equals the reference's on x264 I pictures, and
  where libavcodec is present both are pixel-exact against it;
* ``SliceRequantizer(6, closed_loop=True, device="cpu")`` writes every
  NAL byte-equal to the reference's ``SliceRequantizer(6,
  prefer_native=False, closed_loop=True)``, with equal stats; a slice
  past the QP-51 ceiling passes through on both;
* P slices run from a pool of 4 threads equal the serial run (only the
  closed loop's I slices keep state);
* the closed loop beats the open loop's PSNR by the reference's margin.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import lavc_encode as le
from easydarwin_tpu.codecs import h264_closed_loop as ref_cl
from easydarwin_tpu.codecs import h264_pred as ref_pred
from easydarwin_tpu.codecs import h264_requant as ref_rq
from easydarwin_tpu.codecs.h264_intra import Pps as RefPps
from easydarwin_tpu.codecs.h264_intra import Sps as RefSps
from easydarwin_tpu.utils.synth import synth_luma
from easydarwin_tpu_torch.codecs import h264_closed_loop as cl
from easydarwin_tpu_torch.codecs import h264_pred as pred
from easydarwin_tpu_torch.codecs import h264_requant as rq
from easydarwin_tpu_torch.codecs.h264_intra import (Pps, Sps, decode_iframe,
                                                    encode_iframe, psnr)

needs_x264 = pytest.mark.skipif(not le.available(),
                                reason="x264 encode shim unavailable")
try:
    from lavc_oracle import lavc_available
    _HAVE_LAVC = lavc_available()
except ImportError:
    _HAVE_LAVC = False

W = H = 192
CPU = torch.device("cpu")
#: the x264 IPPP streams ``chip_smoke.py`` phase 13d runs on the card
FIXTURES = sorted((Path(__file__).parent / "fixtures").glob("ippp_*.264"))


def _param_sets(nals, sps_cls, pps_cls):
    sps = sps_cls.parse(next(n for n in nals if n[0] & 0x1F == 7))
    pps = pps_cls.parse(next(n for n in nals if n[0] & 0x1F == 8))
    return sps, pps


def _port_picture(nals):
    sps, pps = _param_sets(nals, Sps, Pps)
    slices = [(p.hdr, p.mbs) for p in
              (rq.parse_slice_cpython(n, sps, pps)
               for n in nals if n[0] & 0x1F == 5)]
    return cl.decode_intra_picture(sps, pps, slices)


def _ref_picture(nals):
    sps, pps = _param_sets(nals, RefSps, RefPps)
    slices = [(p.hdr, p.mbs) for p in
              (ref_rq.parse_slice_nal(n, sps, pps)
               for n in nals if n[0] & 0x1F == 5)]
    return ref_cl.decode_intra_picture(sps, pps, slices)


# ---------------------------------------------------------------- h264_pred
@pytest.mark.parametrize("seed", [0, 1])
def test_predictions_equal_the_reference_for_every_mode(seed):
    """All nine 4x4 modes, the four 16x16 and chroma modes, at interior,
    edge and slice-top positions of seeded reconstruction planes."""
    rng = np.random.default_rng(seed)
    recon = rng.integers(0, 256, (64, 64)).astype(np.int64)
    chroma = rng.integers(0, 256, (32, 32)).astype(np.int64)
    n = 0
    for gx, gy, gy_min in ((5, 6, 0), (0, 3, 0), (7, 4, 4), (15, 9, 8),
                           (3, 0, 0), (12, 13, 12)):
        for mode in range(9):
            try:
                want = ref_pred.pred4x4(mode, recon, gx, gy, gy_min)
            except (ValueError, KeyError, IndexError, TypeError) as e:
                with pytest.raises(type(e)):
                    pred.pred4x4(mode, recon, gx, gy, gy_min)
                continue
            np.testing.assert_array_equal(
                pred.pred4x4(mode, recon, gx, gy, gy_min), want)
            n += 1
    for mbx, mby, first_row in ((1, 2, 0), (0, 1, 0), (3, 2, 2), (2, 0, 0)):
        for mode in range(4):
            for fn_ref, fn, plane in ((ref_pred.pred16x16, pred.pred16x16,
                                       recon),
                                      (ref_pred.pred_chroma, pred.pred_chroma,
                                       chroma)):
                try:
                    want = fn_ref(mode, plane, mbx, mby, first_row)
                except (ValueError, KeyError, IndexError, TypeError) as e:
                    with pytest.raises(type(e)):
                        fn(mode, plane, mbx, mby, first_row)
                    continue
                np.testing.assert_array_equal(
                    fn(mode, plane, mbx, mby, first_row), want)
                n += 1
    assert n >= 50
    for gx, gy in ((0, 0), (5, 7), (15, 15)):
        assert pred.block_decode_order(gx, gy, 16) == \
            ref_pred.block_decode_order(gx, gy, 16)


@needs_x264
@pytest.mark.parametrize("cabac,slices,qp", [
    (False, 1, 22), (True, 1, 30), (False, 3, 26), (True, 3, 26)],
    ids=["cavlc", "cabac", "cavlc-3slices", "cabac-3slices"])
def test_intra_decoder_equals_the_reference_and_lavc(cabac, slices, qp):
    nals = le.encode_ippp(W, H, 1, qp=qp, cabac=cabac, slices=slices,
                          extra="no-deblock=1")
    assert sum(1 for n in nals if n[0] & 0x1F == 5) == slices
    mine = _port_picture(nals)
    for a, b in zip(mine, _ref_picture(nals)):
        np.testing.assert_array_equal(a, b)
    if _HAVE_LAVC:
        from lavc_oracle import LavcH264Decoder
        ref = LavcH264Decoder().decode(
            [n for n in nals if (n[0] & 0x1F) in (7, 8, 5)], W, H)
        assert ref is not None
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the closed-loop rung
def _run(engine, nals):
    out = [engine.transform_nal(n) for n in nals]
    st = engine.stats
    return out, (st.slices_requantized, st.slices_passed_through, st.blocks,
                 st.bytes_in, st.bytes_out)


@needs_x264
@pytest.mark.parametrize("cabac,slices", [(False, 1), (True, 1), (False, 3),
                                          (True, 3)],
                         ids=["cavlc", "cabac", "cavlc-3slices",
                              "cabac-3slices"])
def test_closed_loop_bytes_equal_the_reference_on_ippp(cabac, slices):
    nals = le.encode_ippp(W, H, 4, qp=26, cabac=cabac, slices=slices,
                          extra="no-deblock=1")
    mine, st = _run(rq.SliceRequantizer(6, closed_loop=True, device=CPU),
                    nals)
    want, ref_st = _run(ref_rq.SliceRequantizer(6, prefer_native=False,
                                                closed_loop=True), nals)
    assert len(mine) == len(want)
    for i, (a, b) in enumerate(zip(mine, want)):
        assert a == b, i
    assert st == ref_st
    assert st[0] == 4 * slices and st[1] == 0
    # the loop changed the I slices beyond the open loop's level shift
    opened, _ = _run(rq.SliceRequantizer(6, device=CPU), nals)
    idr = [i for i, n in enumerate(nals) if n[0] & 0x1F == 5]
    assert any(mine[i] != opened[i] for i in idr)
    assert all(mine[i] == opened[i] for i, n in enumerate(nals)
               if n[0] & 0x1F == 1)


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_closed_loop_on_the_committed_fixtures_equals_the_reference(path):
    """The fixtures chip_smoke.py's phase 13d holds the card to: 1 IDR and
    7 P pictures at 176x144; every NAL equal to the reference's."""
    nals = le.split_annexb(path.read_bytes())
    assert [n[0] & 0x1F for n in nals].count(1) == 7
    mine, st = _run(rq.SliceRequantizer(6, closed_loop=True, device=CPU),
                    nals)
    want, ref_st = _run(ref_rq.SliceRequantizer(6, prefer_native=False,
                                                closed_loop=True), nals)
    assert mine == want and st == ref_st and st[:2] == (8, 0)


@needs_x264
def test_closed_loop_p_slices_from_a_pool_equal_the_serial_run():
    nals = le.encode_ippp(W, H, 8, qp=26, cabac=True, extra="no-deblock=1")
    serial, _ = _run(rq.SliceRequantizer(6, closed_loop=True, device=CPU),
                     nals)
    eng = rq.SliceRequantizer(6, closed_loop=True, device=CPU)
    sps, pps = _param_sets(nals, Sps, Pps)
    out: dict[int, bytes] = {}
    # the I slices in order on this thread, the P slices on 4 workers
    for i, n in enumerate(nals):
        if n[0] & 0x1F == 5:
            out[i] = eng.requant_with(n, sps, pps)[0]
    with ThreadPoolExecutor(4) as pool:
        futs = {i: pool.submit(eng.requant_with, n, sps, pps)
                for i, n in enumerate(nals) if n[0] & 0x1F == 1}
        for i, f in futs.items():
            out[i] = f.result()[0]
    assert len(futs) == 7
    for i, n in enumerate(nals):
        assert out.get(i, n) == serial[i], i


def test_closed_loop_refuses_past_the_qp_ceiling_as_the_reference():
    y = synth_luma(64)
    nals = encode_iframe(y, 48)
    mine, st = _run(rq.SliceRequantizer(6, closed_loop=True, device=CPU),
                    nals)
    want, ref_st = _run(ref_rq.SliceRequantizer(6, prefer_native=False,
                                                closed_loop=True), nals)
    assert mine == want == nals
    assert st == ref_st and st[1] == 1


@needs_x264
@pytest.mark.skipif(not _HAVE_LAVC, reason="system libavcodec unavailable")
@pytest.mark.parametrize("cabac", [False, True])
def test_closed_loop_beats_open_loop_on_x264_iframe(cabac):
    from lavc_oracle import LavcH264StreamDecoder

    nals = le.encode_ippp(W, H, 1, qp=26, cabac=cabac, extra="no-deblock=1")
    orig = LavcH264StreamDecoder().decode_stream(le.split_aus(nals), W, H)
    scores, sizes = {}, {}
    for mode in ("open", "closed"):
        eng = rq.SliceRequantizer(6, closed_loop=mode == "closed",
                                  device=CPU)
        out = [eng.transform_nal(n) for n in nals]
        assert eng.stats.slices_passed_through == 0
        dec = LavcH264StreamDecoder().decode_stream(le.split_aus(out), W, H)
        scores[mode] = psnr(orig[0][0], dec[0][0])
        sizes[mode] = sum(len(n) for n in out)
        # the port's own decoder reads the same picture as libavcodec
        np.testing.assert_array_equal(_port_picture(out)[0], dec[0][0])
    assert scores["closed"] > scores["open"] + 4.0
    assert sizes["closed"] < 1.15 * sizes["open"]


def test_closed_rung_approaches_the_reencode_bound():
    img = synth_luma(96)
    eng = rq.SliceRequantizer(6, closed_loop=True, device=CPU)
    closed = psnr(img, decode_iframe([eng.transform_nal(x)
                                      for x in encode_iframe(img, 24)]))
    bound = psnr(img, decode_iframe(encode_iframe(img, 30)))
    assert bound - closed < 3.0


def test_requantizer_contracts():
    """``closed_loop=True`` constructs (and is stateless until its first
    I slice); a host transform beside a device, and a delta that is not
    a multiple of 6, still raise."""
    eng = rq.SliceRequantizer(6, closed_loop=True)
    assert eng.closed_loop and eng._cl_orig is None
    with pytest.raises(ValueError):
        rq.SliceRequantizer(6, device=CPU, requant_fn=rq._scalar_batch)
    with pytest.raises(ValueError):
        rq.SliceRequantizer(7, closed_loop=True)
