"""The port's native H.264 walk ≡ the reference's walk and Python path.

The walk (``easydarwin_tpu_torch/csrc/h264_walk.cpp``) is built here by
g++ into the port's host core.  On seeded all-intra pictures (96×96,
4:2:0, CAVLC and CABAC, 1 and 3 slices) and x264 IPPP streams (P slices,
I_16x16, sub-8x8 partitions, two and three reference pictures; skipped
without the x264 shim, as ``test_h264_inter.py`` is), for deltas 6, 12
and 18:

* the port's fused walk (``native.h264_requant_slice``) is byte-equal to
  the reference's (``easydarwin_tpu.native``) and to the JAX package's
  Python requantizer;
* the split walk's C parse fills the gather of the port's CPython
  ``gather_slice`` and of the JAX package's, array for array;
* one C parse, B6's plain torch chains on its rows for every delta
  (``FusedRequantDispatch`` on the CPU), then one C write a delta gives
  the fused walk's bytes;
* garbage, truncated slices and a High 8x8 PPS get the reference walk's
  -1/-2 classes, and ``SliceRequantizer`` passes them through (or takes
  the CPython path) with the reference's stats, ``native_slices`` too; a
  rung the write refuses (-1) is recoded in CPython, as the reference
  falls back; a short output buffer is -3 in both halves;
* the library is a ``ctypes.CDLL`` (its calls give the GIL up), and
  ``tools/gen_h264_tables_torch.py`` writes ``h264_tables.h`` byte for
  byte.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import lavc_encode as le
from easydarwin_tpu import native as ref_native
from easydarwin_tpu.codecs import h264_requant as rq_ref
from easydarwin_tpu.codecs.h264_intra import Pps as RefPps
from easydarwin_tpu.codecs.h264_intra import Sps as RefSps
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.codecs import h264_requant as rq
from easydarwin_tpu_torch.codecs.h264_intra import Pps, Sps, encode_iframe

ROOT = Path(__file__).resolve().parents[1]
DELTAS = (6, 12, 18)
CPU = torch.device("cpu")
GATHER = ("rows", "qps", "cdc", "cac", "cqp")


def _planes(seed: int, n: int = 96):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    y = (128 + 50 * np.sin(xx / rng.uniform(5, 12) + seed)
         + 40 * np.cos(yy / rng.uniform(5, 12)) + rng.normal(0, 5, xx.shape))
    cb = 128 + 30 * np.sin(xx[::2, ::2] / 7) + rng.normal(0, 3, (n // 2,) * 2)
    cr = 128 + 30 * np.cos(yy[::2, ::2] / 9) + rng.normal(0, 3, (n // 2,) * 2)
    return [np.clip(np.round(p), 0, 255).astype(np.uint8)
            for p in (y, cb, cr)]


def _intra(seed, entropy, slices, qp=24):
    y, cb, cr = _planes(seed)
    return encode_iframe(y, qp, cb=cb, cr=cr, slices=slices,
                         entropy=entropy, idr_pic_id=seed % 2)


def _slices(nals):
    """(NAL, port SPS/PPS, reference SPS/PPS) of each coded slice."""
    ps = rps = None
    out = []
    for n in nals:
        t = n[0] & 0x1F
        if t == 7:
            sps, rsps = Sps.parse(n), RefSps.parse(n)
        elif t == 8:
            ps, rps = (sps, Pps.parse(n)), (rsps, RefPps.parse(n))
        elif t in (1, 5):
            out.append((n, ps, rps))
    return out


def _stats(st):
    return (st.slices_requantized, st.slices_passed_through, st.blocks,
            st.bytes_in, st.bytes_out, st.native_slices)


def _fused(nal, sps, pps, delta):
    return native.h264_requant_slice(nal, delta_qp=delta,
                                     **rq._walk_args(sps, pps))


def _check_slices(nals, deltas):
    """Every check of the module docstring's first three points on every
    slice of ``nals``; returns the slices the walk requantized."""
    done = 0
    for nal, (sps, pps), (rsps, rpps) in _slices(nals):
        parsed = rq.parse_slice_nal(nal, sps, pps)
        assert isinstance(parsed, rq.WalkedSlice)
        gather = rq.gather_slice(parsed)
        py_parsed = rq.parse_slice_cpython(nal, sps, pps)
        py = rq.gather_slice(py_parsed)
        ref = rq_ref.gather_slice(rq_ref.parse_slice_nal(nal, rsps, rpps))
        for name in GATHER:
            mine = getattr(gather, name)
            assert mine.dtype == np.int64
            np.testing.assert_array_equal(mine, getattr(py, name), name)
            np.testing.assert_array_equal(mine, getattr(ref, name), name)
        assert gather.n_blocks == py.n_blocks == ref.n_blocks
        assert gather.max_qp == py.max_qp == ref.max_qp
        assert parsed.qp_in_base == py_parsed.qp_in_base
        # one parse, B6's plain chains for every delta, one write a delta
        dispatch = rq.FusedRequantDispatch(
            [gather], deltas, chroma_qp_offset=pps.chroma_qp_offset,
            device=CPU)
        for i, d in enumerate(deltas):
            fused = _fused(nal, sps, pps, d)
            want = ref_native.h264_requant_slice(
                nal, delta_qp=d, **rq._walk_args(rsps, rpps))
            assert fused == want
            py_out = rq_ref.SliceRequantizer(d, prefer_native=False)
            py_out.sps, py_out.pps = rsps, rpps
            if fused is None:            # the QP-51 ceiling
                assert d + gather.max_qp > 51 or d + parsed.qp_in_base > 51
                with pytest.raises(ValueError):
                    rq.recode_parsed(parsed, gather, dispatch, 0, i)
                continue
            assert py_out.transform_nal(nal) == fused[0]
            st = rq.RequantStats()
            got, blocks = rq.recode_parsed(parsed, gather, dispatch, 0, i,
                                           stats=st)
            assert got == fused[0] and st.native_slices == 1
            assert blocks == fused[2] == gather.n_blocks
            assert fused[1] == parsed.walk.info["mbs"]
            done += 1
    return done


# ------------------------------------------------------------ intra slices
@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("delta", DELTAS)
def test_walk_equals_the_reference_on_intra_slices(entropy, slices, delta):
    nals = _intra(7 * slices + delta, entropy, slices)
    assert _check_slices(nals, DELTAS) == slices * len(DELTAS)
    # the ceiling: at QP 40 the +12 and +18 rungs pass QP 51
    hi = _intra(3 + delta, entropy, slices, qp=40)
    assert _check_slices(hi, DELTAS) == slices
    # and the stream through both packages' SliceRequantizer
    mine, ref = rq.SliceRequantizer(delta), rq_ref.SliceRequantizer(delta)
    for n in nals + hi:
        assert mine.transform_nal(n) == ref.transform_nal(n)
    assert _stats(mine.stats) == _stats(ref.stats)
    assert mine.stats.native_slices == slices * (2 if delta == 6 else 1)


# ---------------------------------------------------------------- x264 P
X264 = [("", 1, 1), ("", 3, 2), ("analyse=none", 3, 3),
        ("analyse=p8x8,p4x4", 1, 2)]


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
@pytest.mark.parametrize("extra,slices,refs", X264)
def test_walk_equals_the_reference_on_x264_p_slices(cabac, extra, slices,
                                                     refs):
    if not le.available():
        pytest.skip("x264 encode shim unavailable")
    nals = le.encode_ippp(192, 192, 4, qp=26, cabac=cabac, slices=slices,
                          ref=refs, extra=extra)
    assert _check_slices(nals, DELTAS) == 4 * slices * 3
    for d in (6, 12):
        mine, ref = rq.SliceRequantizer(d, device=CPU), \
            rq_ref.SliceRequantizer(d)
        for n in nals:
            assert mine.transform_nal(n) == ref.transform_nal(n)
        assert _stats(mine.stats) == _stats(ref.stats)
        assert mine.stats.native_slices == 4 * slices


# ------------------------------------------------- what the walk refuses
def _raw_fused(lib, nal, sps, pps, delta, cap=None):
    """A fused walk entry point's own return (the binding folds -1 and
    -2 into None)."""
    a = rq._walk_args(sps, pps)
    entry = (lib.ed_h264_requant_slice_cabac if a.pop("cabac")
             else lib.ed_h264_requant_slice)
    src = (ctypes.c_uint8 * max(1, len(nal))).from_buffer_copy(
        nal or b"\0")
    cap = len(nal) * 4 + 4096 if cap is None else cap
    out = (ctypes.c_uint8 * cap)()
    mbs, blocks = ctypes.c_int32(), ctypes.c_int32()
    return entry(src, len(nal), out, cap, a["width_mbs"], a["height_mbs"],
                 a["log2_max_frame_num"], a["poc_type"],
                 a["log2_max_poc_lsb"], a["pic_init_qp"], a["pps_id"],
                 int(a["deblocking_control"]), int(a["bottom_field_poc"]),
                 delta, a["chroma_qp_offset"], a["num_ref_l0_default"],
                 int(a["weighted_pred"]), ctypes.byref(mbs),
                 ctypes.byref(blocks))


def _split_class(nal, sps, pps, delta):
    """The split walk's return for one rung: the parse's, else the
    write's over the rows the fused walk's shift would give (B6's plain
    chains)."""
    walk = native.h264_parse_slice(nal, **rq._walk_args(sps, pps))
    if isinstance(walk, int):
        return walk
    gather = rq.gather_slice(rq.WalkedSlice(nal, walk, rq.SliceGather(
        walk.rows, walk.qps, None, None, walk.cqp, walk.cdc, walk.cac,
        walk.info["blocks"], walk.info["max_qp"]), walk.info["qp"], sps,
        pps))
    dispatch = rq.FusedRequantDispatch([gather], (delta,), device=CPU,
                                       chroma_qp_offset=pps.chroma_qp_offset)
    if gather.max_qp + delta > 51:
        return native.WALK_UNSUPPORTED
    out = walk.write(delta, dispatch.luma_rows(0, 0),
                     *dispatch.chroma_rows(0, 0))
    return out if isinstance(out, int) else 0


def _bad_inputs(entropy):
    nals = _intra(31, entropy, 1)
    good = nals[2]
    rng = np.random.default_rng(5 if entropy == "cavlc" else 6)
    bad = [good[:1], good[:2], good[:5], good[:len(good) // 3],
           good[:len(good) // 2], good[:-7]]
    for _ in range(6):
        bad.append(bytes([good[0]]) + rng.integers(0, 256, 60,
                                                   dtype=np.uint8).tobytes())
    bad.append(bytes([0x61]) + good[1:])         # nal_unit_type 1, IDR body
    bad.append(good[:9] + bytes(40))
    return nals[:2], bad


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_garbage_and_truncated_slices_get_the_reference_classes(entropy):
    ps, bad = _bad_inputs(entropy)
    sps, pps = Sps.parse(ps[0]), Pps.parse(ps[1])
    lib, ref_lib = native._need(), ref_native._load()
    classes = set()
    for nal in bad:
        want = _raw_fused(ref_lib, nal, sps, pps, 6)
        assert _raw_fused(lib, nal, sps, pps, 6) == want
        if want < 0:
            assert _split_class(nal, sps, pps, 6) == want, (len(nal), want)
            classes.add(want)
    assert classes == {native.WALK_UNSUPPORTED, native.WALK_MALFORMED}
    # through both packages' SliceRequantizer: pass-through, same stats
    mine, ref = rq.SliceRequantizer(6), rq_ref.SliceRequantizer(6)
    for n in ps + bad:
        assert mine.transform_nal(n) == ref.transform_nal(n)
    assert _stats(mine.stats) == _stats(ref.stats)
    assert mine.stats.slices_passed_through > 0


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
def test_high_8x8_slices_take_the_cpython_path(cabac):
    if not le.available():
        pytest.skip("x264 encode shim unavailable")
    nals = le.encode_ippp(64, 64, 3, qp=26, cabac=cabac, profile="high",
                          extra="8x8dct=1")
    pps = Pps.parse(next(n for n in nals if n[0] & 0x1F == 8))
    assert pps.transform_8x8_mode
    mine, ref = rq.SliceRequantizer(6, device=CPU), rq_ref.SliceRequantizer(6)
    for n in nals:
        if n[0] & 0x1F in (1, 5):
            sps = Sps.parse(next(m for m in nals if m[0] & 0x1F == 7))
            assert isinstance(rq.parse_slice_nal(n, sps, pps),
                              rq.ParsedSlice)
        assert mine.transform_nal(n) == ref.transform_nal(n)
    assert _stats(mine.stats) == _stats(ref.stats)
    assert mine.stats.native_slices == 0
    assert mine.stats.slices_requantized == 3


def test_a_rung_the_write_refuses_is_recoded_in_cpython():
    """Slice QP 48 over macroblocks at 38: the +6 rung's slice QP passes
    51, so the fused walk and the write answer -1; the reference then
    takes its Python path, and so does the port, over the same B6 rows."""
    nals = _intra(17, "cavlc", 1, qp=38)
    sps, pps = Sps.parse(nals[0]), Pps.parse(nals[1])
    parsed = rq.parse_slice_cpython(nals[2], sps, pps)
    parsed.hdr.qp = parsed.qp_in_base = 48
    nal = rq._write_slice_bytes(parsed, parsed.mbs, 48)
    assert _raw_fused(native._need(), nal, sps, pps, 6) \
        == native.WALK_UNSUPPORTED
    walked = rq.parse_slice_nal(nal, sps, pps)
    assert isinstance(walked, rq.WalkedSlice)
    assert walked.gather.max_qp == 38 and walked.qp_in_base == 48
    mine, ref = rq.SliceRequantizer(6, device=CPU), rq_ref.SliceRequantizer(6)
    for n in nals[:2] + [nal]:
        assert mine.transform_nal(n) == ref.transform_nal(n)
    assert _stats(mine.stats) == _stats(ref.stats)
    assert mine.stats.slices_requantized == 1
    assert mine.stats.native_slices == 0


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_short_buffers_are_overflow_in_both_halves(entropy):
    nals = _intra(23, entropy, 1)
    sps, pps = Sps.parse(nals[0]), Pps.parse(nals[1])
    lib = native._need()
    assert _raw_fused(lib, nals[2], sps, pps, 6, cap=8) \
        == native.WALK_OVERFLOW
    walk = native.h264_parse_slice(nals[2], **rq._walk_args(sps, pps))
    entry = (lib.ed_h264_write_slice_cabac if entropy == "cabac"
             else lib.ed_h264_write_slice)
    out = np.zeros(8, dtype=np.uint8)
    i64 = native._I64P
    rc = entry(walk._ptr, 6, walk.rows.ctypes.data_as(i64),
               walk.rows.shape[0], walk.cdc.ctypes.data_as(i64),
               walk.cac.ctypes.data_as(i64), walk.cqp.shape[0],
               native._u8(out), 8)
    assert rc == native.WALK_OVERFLOW
    # the other entropy mode's write, and rows of the wrong count, are
    # refused before anything is written
    other = (lib.ed_h264_write_slice if entropy == "cabac"
             else lib.ed_h264_write_slice_cabac)
    assert other(walk._ptr, 6, walk.rows.ctypes.data_as(i64),
                 walk.rows.shape[0], walk.cdc.ctypes.data_as(i64),
                 walk.cac.ctypes.data_as(i64), walk.cqp.shape[0],
                 native._u8(out), 8) == native.WALK_BAD_ARGS
    with pytest.raises(ValueError):
        walk.write(6, walk.rows[1:], walk.cdc, walk.cac)


# ------------------------------------------------------------ the library
def test_the_walk_library_releases_the_gil():
    lib = native._need()
    assert type(lib) is ctypes.CDLL
    assert not lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert native._abi_ok(lib)
    assert lib.ed_h264_walk_info_fields() == len(native.WALK_INFO_FIELDS)


def test_table_generator_reproduces_the_header():
    path = ROOT / "tools" / "gen_h264_tables_torch.py"
    spec = importlib.util.spec_from_file_location("gen_h264_tables_torch",
                                                  path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    header = ROOT / "easydarwin_tpu_torch" / "csrc" / "h264_tables.h"
    assert gen.emit() == header.read_text(encoding="utf-8")
    assert Path(gen.HEADER) == header


def test_a_missing_walk_raises_and_never_runs_cpython(monkeypatch):
    """No fallback: without the library the requantizers refuse to be
    made, and the walk's entry points raise (nothing passes through or
    takes the CPython parse quietly)."""
    from easydarwin_tpu_torch.hls import requant as hls_rq
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "load_error", "g++ failed (1)")
    nals = _intra(29, "cavlc", 1)
    sps, pps = Sps.parse(nals[0]), Pps.parse(nals[1])
    for make in (lambda: rq.SliceRequantizer(6),
                 lambda: hls_rq.RequantLadder(device=CPU),
                 lambda: rq.parse_slice_nal(nals[2], sps, pps),
                 lambda: _fused(nals[2], sps, pps, 6)):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            make()


def test_concurrent_writes_on_one_parse_equal_the_serial_ones():
    """The handle is read-only after the parse: 32 writes of three rungs
    on 16 threads (a short switch interval) give the serial bytes."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    nals = _intra(41, "cabac", 1)
    sps, pps = Sps.parse(nals[0]), Pps.parse(nals[1])
    parsed = rq.parse_slice_nal(nals[2], sps, pps)
    dispatch = rq.FusedRequantDispatch([parsed.gather], DELTAS, device=CPU)
    want = [rq.recode_parsed(parsed, parsed.gather, dispatch, 0, i)[0]
            for i in range(len(DELTAS))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(
                lambda j: rq.recode_parsed(parsed, parsed.gather, dispatch,
                                           0, j % 3)[0], range(32)))
    finally:
        sys.setswitchinterval(old)
    assert got == [want[j % 3] for j in range(32)]
