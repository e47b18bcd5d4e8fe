"""The port's H.264 codecs ≡ the JAX package's, on the CPU.

``easydarwin_tpu_torch.codecs`` (bits, CAVLC, intra, CABAC and its
tables) is a copy of the reference's numpy/pure-Python codecs: the same
seeded inputs go through both and every output is compared bit for bit:

* Exp-Golomb and emulation-prevention round trips on fuzzed values;
* CAVLC residual blocks for every nC class;
* ``encode_iframe`` bytes (96×96, CAVLC and CABAC, 1 and 3 slices, with
  and without chroma, at several QPs);
* the parsed macroblock model of those slices (types, QPs, CBPs and every
  level array), through ``SliceCodec`` and ``CabacSliceCodec``, and the
  slices written back unchanged;
* P slices from the system x264 (``tests/lavc_encode.py``, skipped only
  where that shim is missing, as the reference's own tests do): parsed
  and re-written by both packages to the same bytes (CAVLC: the source's
  own, its codes being canonical), CAVLC and CABAC;
* the CABAC context tables.
"""

import numpy as np
import pytest

import lavc_encode as le
from easydarwin_tpu.codecs import h264_bits as rb
from easydarwin_tpu.codecs import h264_cabac as rcabac
from easydarwin_tpu.codecs import h264_cabac_tables as rtab
from easydarwin_tpu.codecs import h264_cavlc as rcavlc
from easydarwin_tpu.codecs import h264_intra as ri
from easydarwin_tpu_torch.codecs import h264_bits as pb
from easydarwin_tpu_torch.codecs import h264_cabac as pcabac
from easydarwin_tpu_torch.codecs import h264_cabac_tables as ptab
from easydarwin_tpu_torch.codecs import h264_cavlc as pcavlc
from easydarwin_tpu_torch.codecs import h264_intra as pi

N = 96


def _picture(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    y = (128 + 50 * np.sin(xx / rng.uniform(5, 12))
         + 40 * np.cos(yy / rng.uniform(5, 12)) + rng.normal(0, 5, xx.shape))
    cb = 128 + 30 * np.sin(xx[::2, ::2] / 7) + rng.normal(0, 3, (n // 2,) * 2)
    cr = 128 + 30 * np.cos(yy[::2, ::2] / 9) + rng.normal(0, 3, (n // 2,) * 2)
    return [np.clip(np.round(p), 0, 255).astype(np.uint8)
            for p in (y, cb, cr)]


# ------------------------------------------------------------------- bits
@pytest.mark.parametrize("seed", range(3))
def test_expgolomb_and_rbsp_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    ues = rng.integers(0, 70000, 200)
    ses = rng.integers(-40000, 40000, 200)
    out = []
    for mod in (rb, pb):
        bw = mod.BitWriter()
        for u, s in zip(ues, ses):
            bw.ue(int(u))
            bw.se(int(s))
            bw.write_bits(int(u) & 0x1F, 5)
        bw.rbsp_trailing()
        data = bw.to_bytes()
        br = mod.BitReader(data)
        back = [(br.ue(), br.se(), br.read_bits(5)) for _ in ues]
        assert back == [(int(u), int(s), int(u) & 0x1F)
                        for u, s in zip(ues, ses)]
        out.append(data)
    assert out[0] == out[1]
    raw = bytes(rng.choice([0, 0, 0, 1, 2, 3, 0x55],
                           2000).astype(np.uint8))
    assert pb.rbsp_to_nal(raw) == rb.rbsp_to_nal(raw)
    nal = pb.rbsp_to_nal(raw)
    assert pb.nal_to_rbsp(nal) == rb.nal_to_rbsp(nal) == raw


# ------------------------------------------------------------------ CAVLC
@pytest.mark.parametrize("nc", [-1, 0, 2, 4, 8])
def test_cavlc_blocks_equal_the_reference(nc):
    rng = np.random.default_rng(100 + nc)
    size = 4 if nc == -1 else 16
    for _ in range(150):
        coeffs = (rng.integers(-12, 13, size)
                  * (rng.random(size) < 0.4)).astype(np.int64)
        if rng.random() < 0.1:
            coeffs[int(rng.integers(size))] = int(rng.integers(-2000, 2000))
        bws = []
        for mod, bits in ((rcavlc, rb), (pcavlc, pb)):
            bw = bits.BitWriter()
            mod.encode_residual(bw, [int(c) for c in coeffs], nc, size)
            bw.rbsp_trailing()
            bws.append(bw.to_bytes())
        assert bws[0] == bws[1]
        got = pcavlc.decode_residual(pb.BitReader(bws[1]), nc, size)
        assert got == rcavlc.decode_residual(rb.BitReader(bws[0]), nc, size)
        assert got == [int(c) for c in coeffs]


def test_cabac_tables_equal_the_reference():
    names = [n for n in dir(rtab) if n.isupper()]
    assert names
    for n in names:
        assert np.array_equal(np.asarray(getattr(ptab, n)),
                              np.asarray(getattr(rtab, n))), n


# -------------------------------------------------------- intra encode/parse
CASES = [(e, sl, chroma, qp) for e in ("cavlc", "cabac") for sl in (1, 3)
         for chroma in (True, False) for qp in (18, 30)]


def _encode(mod, seed, entropy, slices, chroma, qp):
    y, cb, cr = _picture(seed)
    kw = {"cb": cb, "cr": cr} if chroma else {}
    return mod.encode_iframe(y, qp, slices=slices, entropy=entropy,
                             idr_pic_id=seed % 2, **kw)


def _parse(mod, cabac_mod, nals):
    sps, pps = mod.Sps.parse(nals[0]), mod.Pps.parse(nals[1])
    out = []
    for nal in nals[2:]:
        if pps.entropy_cabac:
            hdr, _first, mbs, _q = cabac_mod.CabacSliceCodec(
                sps, pps).parse_slice(nal)
        else:
            codec = mod.SliceCodec(sps, pps)
            br = (pb if mod is pi else rb).BitReader(
                (pb if mod is pi else rb).nal_to_rbsp(nal[1:]))
            hdr = codec.parse_slice_header(br, nal[0])
            mbs = codec.parse_mbs(br, hdr.qp, hdr.first_mb, hdr)
        out.append((hdr, mbs))
    return sps, pps, out


def _mb_fields(mb) -> dict:
    d = {"type": type(mb).__name__}
    fields = getattr(mb, "__dict__", None) or {
        k: getattr(mb, k) for k in getattr(mb, "__slots__", ())}
    for k, v in fields.items():
        d[k] = v.tolist() if isinstance(v, np.ndarray) else v
    return d


@pytest.mark.parametrize("entropy,slices,chroma,qp", CASES)
def test_encode_iframe_bytes_and_parse_equal(entropy, slices, chroma, qp):
    seed = 7 * slices + qp
    a = _encode(ri, seed, entropy, slices, chroma, qp)
    b = _encode(pi, seed, entropy, slices, chroma, qp)
    assert b == a
    assert len(b) == 2 + slices
    _s, _p, ref = _parse(ri, rcabac, a)
    sps, pps, got = _parse(pi, pcabac, b)
    assert len(got) == len(ref) == slices
    for (rh, rmbs), (h, mbs) in zip(ref, got):
        assert vars(h) == vars(rh)
        assert [_mb_fields(m) for m in mbs] == [_mb_fields(m) for m in rmbs]
    # the parsed slices write back to the same bytes
    for nal, (h, mbs) in zip(b[2:], got):
        if pps.entropy_cabac:
            out = pcabac.CabacSliceCodec(sps, pps).write_slice(
                h, h.first_mb, mbs, h.qp)
        else:
            codec = pi.SliceCodec(sps, pps)
            bw = pb.BitWriter()
            codec.write_slice_header(bw, h, h.qp)
            codec.write_mbs(bw, mbs, h.qp, h.first_mb, h)
            bw.rbsp_trailing()
            out = bytes([nal[0]]) + pb.rbsp_to_nal(bw.to_bytes())
        assert out == nal


def test_sps_pps_round_trip_equal():
    for w, h, cabac, off in ((6, 6, False, 0), (11, 9, True, 2),
                             (120, 68, True, -3)):
        for mod in (ri, pi):
            sps = mod.Sps(w, h, profile_idc=77 if cabac else 66)
            pps = mod.Pps(pic_init_qp=26, entropy_cabac=cabac,
                          chroma_qp_offset=off)
            if mod is ri:
                want = (sps.build(), pps.build())
        got = (sps.build(), pps.build())
        assert got == want
        assert vars(pi.Sps.parse(got[0])) == vars(ri.Sps.parse(want[0]))
        assert vars(pi.Pps.parse(got[1])) == vars(ri.Pps.parse(want[1]))


# ------------------------------------------------------- x264 P slices
def _x264(cabac: bool, slices: int = 1):
    if not le.available():
        pytest.skip("x264 encode shim unavailable")
    return le.encode_ippp(192, 192, 6, qp=28, cabac=cabac, slices=slices)


@pytest.mark.parametrize("cabac,slices", [(False, 1), (True, 1),
                                          (False, 2)])
def test_x264_p_slices_parse_and_write_equal(cabac, slices):
    nals = _x264(cabac, slices)
    sps_n = next(n for n in nals if n[0] & 0x1F == 7)
    pps_n = next(n for n in nals if n[0] & 0x1F == 8)
    n_p = 0
    for nal in nals:
        if nal[0] & 0x1F not in (1, 5):
            continue
        outs = []
        for mod, cmod, bits in ((ri, rcabac, rb), (pi, pcabac, pb)):
            sps, pps = mod.Sps.parse(sps_n), mod.Pps.parse(pps_n)
            if pps.entropy_cabac:
                hdr, _f, mbs, _q = cmod.CabacSliceCodec(
                    sps, pps).parse_slice(nal)
                data = cmod.CabacSliceCodec(sps, pps).write_slice(
                    hdr, hdr.first_mb, mbs, hdr.qp)
            else:
                codec = mod.SliceCodec(sps, pps)
                br = bits.BitReader(bits.nal_to_rbsp(nal[1:]))
                hdr = codec.parse_slice_header(br, nal[0])
                mbs = codec.parse_mbs(br, hdr.qp, hdr.first_mb, hdr)
                bw = bits.BitWriter()
                codec.write_slice_header(bw, hdr, hdr.qp)
                codec.write_mbs(bw, mbs, hdr.qp, hdr.first_mb, hdr)
                bw.rbsp_trailing()
                data = bytes([nal[0]]) + bits.rbsp_to_nal(bw.to_bytes())
            outs.append((data, [_mb_fields(m) for m in mbs]))
            n_p += hdr.is_p
        assert outs[0] == outs[1]
        if not cabac:                 # CAVLC codes are canonical
            assert outs[1][0] == nal
    assert n_p > 0
