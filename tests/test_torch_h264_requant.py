"""The port's H.264 requant rung ≡ the JAX package's, on the CPU.

The same seeded pictures (96×96, CAVLC and CABAC, 1 and 3 slices, 4:2:0
chroma) and x264 P slices go through the reference's requant (its Python
path and its device arm, JAX B6 on the CPU) and the port's: the host
scalar oracles and the device arm on ``device="cpu"`` (B6's plain torch
chains through ``ops.h264_kernel``).  Every output is compared bit for
bit:

* ``SliceRequantizer`` for deltas 6, 12 and 18, with its stats;
* ``requant_multi`` and ``FusedRequantDispatch``'s rows over several
  slices at once, against the reference's device dispatch;
* the QP-51 ceiling (per rendition, and a wholly-over-ceiling delta kept
  out of the tile) and the pass-through of what the rung cannot parse;
* B6's kernel wrappers on CPU tensors against JAX B6, and their checks;
* ``closed_loop=True`` raises naming A7c; an exception in the ladder's
  device dispatch is counted in ``device_errors``, never as a
  passed-through slice; with ``native.available()`` patched True the
  ladder still takes the device arm (the egress core is not a requant
  walk).
"""

import asyncio
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import lavc_encode as le
from easydarwin_tpu.codecs import h264_requant as rq_ref
from easydarwin_tpu.codecs.h264_intra import Pps as RefPps
from easydarwin_tpu.codecs.h264_intra import Sps as RefSps
from easydarwin_tpu.ops import transform as jax_tf
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.codecs import h264_requant as rq
from easydarwin_tpu_torch.codecs.h264_intra import Pps, Sps, encode_iframe
from easydarwin_tpu_torch.hls import requant as hls_rq
from easydarwin_tpu_torch.ops import h264_kernel as hk
from easydarwin_tpu_torch.ops import kernel_lib
from easydarwin_tpu_torch.protocol import nalu

DELTAS = (6, 12, 18)
CPU = torch.device("cpu")


def _planes(seed: int, n: int = 96):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    y = (128 + 50 * np.sin(xx / rng.uniform(5, 12) + seed)
         + 40 * np.cos(yy / rng.uniform(5, 12)) + rng.normal(0, 5, xx.shape))
    cb = 128 + 30 * np.sin(xx[::2, ::2] / 7) + rng.normal(0, 3, (n // 2,) * 2)
    cr = 128 + 30 * np.cos(yy[::2, ::2] / 9) + rng.normal(0, 3, (n // 2,) * 2)
    return [np.clip(np.round(p), 0, 255).astype(np.uint8)
            for p in (y, cb, cr)]


def _nals(seed, entropy="cavlc", slices=1, qp=24):
    y, cb, cr = _planes(seed)
    return encode_iframe(y, qp, cb=cb, cr=cr, slices=slices,
                         entropy=entropy, idr_pic_id=seed % 2)


def _ref_engine(delta, device=False):
    """The reference's Python engine: its device arm (JAX B6) or its
    scalar path, never its native walk."""
    if device:
        return rq_ref.SliceRequantizer(delta, requant_fn=rq_ref.device_batch,
                                       chroma_fn=rq_ref.device_batch_chroma)
    return rq_ref.SliceRequantizer(delta, prefer_native=False)


def _stats(st):
    return (st.slices_requantized, st.slices_passed_through, st.blocks,
            st.bytes_in, st.bytes_out)


# -------------------------------------------------------- SliceRequantizer
@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("delta", DELTAS)
def test_slice_requantizer_equals_the_reference(entropy, slices, delta):
    nals = _nals(11 * slices + delta, entropy, slices)
    ref, ref_dev = _ref_engine(delta), _ref_engine(delta, device=True)
    host, dev = rq.SliceRequantizer(delta), rq.SliceRequantizer(delta,
                                                                device=CPU)
    for n in nals:
        want = ref.transform_nal(n)
        assert ref_dev.transform_nal(n) == want
        assert host.transform_nal(n) == want
        assert dev.transform_nal(n) == want
    assert _stats(host.stats) == _stats(dev.stats) == _stats(ref.stats)
    assert host.stats.slices_requantized == slices
    assert host.stats.bytes_out < host.stats.bytes_in


def test_x264_p_slices_requant_equal_the_reference():
    if not le.available():
        pytest.skip("x264 encode shim unavailable")
    for cabac in (False, True):
        nals = le.encode_ippp(192, 192, 6, qp=26, cabac=cabac)
        for delta in (6, 12):
            ref, got = _ref_engine(delta), rq.SliceRequantizer(delta,
                                                               device=CPU)
            for n in nals:
                assert got.transform_nal(n) == ref.transform_nal(n)
            assert _stats(got.stats) == _stats(ref.stats)
            assert got.stats.slices_requantized >= 6


def test_ceiling_and_pass_through_equal_the_reference():
    # QP 40: +12 would pass QP 51, +6 would not
    hi = _nals(3, qp=40)
    sps, pps = Sps.parse(hi[0]), Pps.parse(hi[1])
    rsps, rpps = RefSps.parse(hi[0]), RefPps.parse(hi[1])
    got = rq.requant_multi(hi[2], sps, pps, (6, 12), device=CPU)
    want = rq_ref.requant_multi(hi[2], rsps, rpps, (6, 12))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [_stats(g[1]) for g in got] == [_stats(w[1]) for w in want]
    assert got[0][0] != hi[2] and got[1][0] == hi[2]
    assert got[1][1].slices_passed_through == 1
    # a corrupted slice passes through, counted, on both packages
    bad = hi[2][:12] + bytes(40)
    for eng in (rq.SliceRequantizer(6), rq.SliceRequantizer(6, device=CPU)):
        for n in hi[:2]:
            eng.transform_nal(n)
        ref = _ref_engine(6)
        for n in hi[:2]:
            ref.transform_nal(n)
        assert eng.transform_nal(bad) == ref.transform_nal(bad) == bad
        assert _stats(eng.stats) == _stats(ref.stats)
        assert eng.stats.slices_passed_through == 1


# ------------------------------------------------- fused dispatch and B6
def _gathers(mod, cases):
    out = []
    for seed, entropy, slices, qp in cases:
        nals = _nals(seed, entropy, slices, qp)
        sps, pps = mod_ps(mod, nals)
        for n in nals[2:]:
            p = mod.parse_slice_nal(n, sps, pps)
            out.append((p, mod.gather_slice(p)))
    return out


def mod_ps(mod, nals):
    if mod is rq:
        return Sps.parse(nals[0]), Pps.parse(nals[1])
    return RefSps.parse(nals[0]), RefPps.parse(nals[1])


CASES = [(5, "cavlc", 3, 24), (6, "cabac", 1, 30), (7, "cabac", 3, 44),
         (8, "cavlc", 1, 18)]


def test_fused_dispatch_rows_equal_the_reference_device_arm():
    mine, ref = _gathers(rq, CASES), _gathers(rq_ref, CASES)
    deltas = (6, 12, 18)
    d_ref = rq_ref.FusedRequantDispatch([g for _, g in ref], deltas,
                                        use_device=True)
    d_dev = rq.FusedRequantDispatch([g for _, g in mine], deltas,
                                    device=CPU)
    d_host = rq.FusedRequantDispatch([g for _, g in mine], deltas)
    assert d_dev.luma_launched and d_dev.chroma_launched
    assert not d_host.luma_launched
    for s in range(len(mine)):
        for i in range(len(deltas)):
            try:
                want = d_ref.luma_rows(s, i)
            except ValueError:         # the wholly-over-ceiling delta
                for d in (d_dev, d_host):
                    with pytest.raises(ValueError):
                        d.luma_rows(s, i)
                continue
            for d in (d_dev, d_host):
                np.testing.assert_array_equal(d.luma_rows(s, i), want)
                for a, b in zip(d.chroma_rows(s, i), d_ref.chroma_rows(s, i)):
                    np.testing.assert_array_equal(a, b)
            # and the recode over them (or the slice's own ceiling)
            try:
                exp = rq_ref.recode_parsed(ref[s][0], ref[s][1], d_ref, s, i)
            except ValueError:
                with pytest.raises(ValueError):
                    rq.recode_parsed(mine[s][0], mine[s][1], d_dev, s, i)
                continue
            assert rq.recode_parsed(mine[s][0], mine[s][1], d_dev, s,
                                    i) == exp


@pytest.mark.parametrize("seed", range(3))
def test_b6_wrappers_on_the_cpu_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    lev = (rng.integers(-3000, 3000, (n, 16))
           * (rng.random((n, 16)) < 0.4)).astype(np.int32)
    qi = rng.integers(0, 52, n).astype(np.int32)
    qo = (qi + 6 * rng.integers(0, (51 - qi) // 6 + 1)).astype(np.int32)
    want = np.asarray(jax_tf.h264_requant(lev, qi, qo))
    got = hk.h264_requant_kernel(torch.from_numpy(lev), torch.from_numpy(qi),
                                 torch.from_numpy(qo))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dc = rng.integers(-3000, 3000, (n, 4)).astype(np.int32)
    ac = (rng.integers(-300, 300, (n, 4, 15))
          * (rng.random((n, 4, 15)) < 0.4)).astype(np.int32)
    qci = rng.integers(0, 40, n).astype(np.int32)
    qco = np.minimum(qci + rng.integers(0, 19, n), 51).astype(np.int32)
    wd, wa = jax_tf.h264_requant_chroma(dc, ac, qci, qco)
    gd, ga = hk.h264_requant_chroma_kernel(
        torch.from_numpy(dc), torch.from_numpy(ac), torch.from_numpy(qci),
        torch.from_numpy(qco))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    # a scalar QP broadcasts over the rows
    one = hk.h264_requant_kernel(torch.from_numpy(lev), 20, 32)
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        jax_tf.h264_requant(lev, np.full(n, 20, np.int32),
                            np.full(n, 32, np.int32))))


def test_b6_wrappers_refuse_bad_inputs_without_a_launch():
    kernel_lib.reset_launch_counts()
    lev = torch.zeros((4, 16), dtype=torch.int32)
    q = torch.zeros(4, dtype=torch.int32)
    for fn in (lambda: hk.h264_requant_kernel(lev.long(), q, q),
               lambda: hk.h264_requant_kernel(lev[:, :15], q, q),
               lambda: hk.h264_requant_kernel(lev, q.long(), q),
               lambda: hk.h264_requant_kernel(lev, q[:3], q),
               lambda: hk.h264_requant_chroma_kernel(
                   torch.zeros((4, 4), dtype=torch.int32),
                   torch.zeros((3, 4, 15), dtype=torch.int32), q, q)):
        with pytest.raises((TypeError, ValueError)):
            fn()
    empty = hk.h264_requant_kernel(lev[:0], q[:0], q[:0])
    assert tuple(empty.shape) == (0, 16)
    assert kernel_lib.LAUNCHES["ed_h264_requant"] == 0
    assert kernel_lib.LAUNCHES["ed_h264_requant_chroma"] == 0


def test_device_batch_equals_the_reference():
    rng = np.random.default_rng(4)
    lev = rng.integers(-200, 200, (50, 16)).astype(np.int64)
    qi = rng.integers(12, 40, 50).astype(np.int64)
    qo = qi + 6
    np.testing.assert_array_equal(rq.device_batch(lev, qi, qo, device=CPU),
                                  rq_ref.device_batch(lev, qi, qo))
    dc = rng.integers(-200, 200, (50, 4)).astype(np.int64)
    ac = rng.integers(-50, 50, (50, 4, 15)).astype(np.int64)
    qci = rng.integers(10, 39, 50).astype(np.int64)
    qco = qci + rng.integers(0, 9, 50)
    for a, b in zip(rq.device_batch_chroma(dc, ac, qci, qco, device=CPU),
                    rq_ref.device_batch_chroma(dc, ac, qci, qco)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- the rung's contracts
def test_closed_loop_raises_naming_a7c():
    with pytest.raises(ValueError, match="A7c"):
        rq.SliceRequantizer(6, closed_loop=True)
    with pytest.raises(ValueError):
        rq.SliceRequantizer(6, device=CPU, requant_fn=rq._scalar_batch)
    with pytest.raises(ValueError):
        rq.SliceRequantizer(7)


def _ladder_units(seed=9, entropy="cavlc", slices=3):
    nals = _nals(seed, entropy, slices)
    pkts, seq = [], 0
    for j, n in enumerate(nals):
        p = nalu.packetize_h264(n, seq=seq, timestamp=0, ssrc=1,
                                marker_on_last=j == len(nals) - 1)
        seq += len(p)
        pkts += p
    return nals, pkts


def test_ladder_takes_the_device_arm_when_native_is_loaded(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: True)
    nals, pkts = _ladder_units()
    lad = hls_rq.RequantLadder(device=CPU, target_duration=0.1)
    outs = {d: lad.add_rendition(d) for d in (6, 12)}
    for p in pkts:
        lad.send_bytes(p, is_rtcp=False)
    assert lad.dispatches == 1 and lad.dispatches_chroma == 1
    assert lad.device_errors == 0 and lad.aus == 1
    for d, out in outs.items():
        assert out.requant.device == CPU
        assert out.requant.stats.slices_requantized == 3


def test_device_error_is_counted_never_passed_through(monkeypatch, capsys):
    nals, pkts = _ladder_units()

    class Broken(rq.DevicePass):
        def result(self):
            raise RuntimeError("readback failed")

    monkeypatch.setattr(rq, "DevicePass", Broken)
    lad = hls_rq.RequantLadder(device=CPU, target_duration=0.1)
    got = []
    out = lad.add_rendition(6)
    monkeypatch.setattr(out, "_on_unit", got.append)
    for p in pkts:
        lad.send_bytes(p, is_rtcp=False)
    assert lad.device_errors == 1 and lad.dispatches == 0
    st = out.requant.stats
    assert st.slices_passed_through == 0 and st.slices_requantized == 0
    assert [au.nals for au in got] == [nals[2:]]  # the source, flagged
    assert "readback failed" in capsys.readouterr().err


def test_requant_stats_merge_under_threads():
    shared = rq.RequantStats()

    def job(_i):
        local = rq.RequantStats()
        for _ in range(25):
            d = rq.RequantStats()
            d.slices_requantized, d.blocks, d.bytes_out = 1, 2, 5
            local.merge(d)
        shared.merge(local)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            list(pool.map(job, range(64)))
    finally:
        sys.setswitchinterval(old)
    assert (shared.slices_requantized, shared.blocks, shared.bytes_out) \
        == (1600, 3200, 8000)


def test_pool_sizing_equals_the_reference():
    from easydarwin_tpu.hls import requant as ref_hls
    for kw in ({"affinity": 1, "quota": 4.0, "cpu_count": 8, "env": ""},
               {"affinity": 96, "quota": 2.0, "cpu_count": 96, "env": ""},
               {"affinity": 8, "quota": None, "cpu_count": 8, "env": ""},
               {"affinity": 4, "quota": 0.5, "cpu_count": 4, "env": ""},
               {"affinity": 4, "quota": None, "cpu_count": 4, "env": "3"}):
        assert hls_rq.pool_sizing(**kw) == ref_hls.pool_sizing(**kw)


def test_dispatch_pass_owns_its_buffers():
    """Two passes in flight at once keep their own staging: harvesting
    them in either order gives each its own rows."""
    rng = np.random.default_rng(2)
    a = rng.integers(-100, 100, (20, 16))
    b = rng.integers(-100, 100, (30, 16))
    qa, qb = np.full(20, 20), np.full(30, 26)
    pa = rq.DevicePass("luma", [a, qa, np.array([6])], CPU)
    pb = rq.DevicePass("luma", [b, qb, np.array([12])], CPU)
    np.testing.assert_array_equal(pb.result()[0],
                                  rq._scalar_batch(b, qb, qb + 12))
    np.testing.assert_array_equal(pa.result()[0],
                                  rq._scalar_batch(a, qa, qa + 6))


def test_ladder_inline_and_pooled_bytes_equal():
    """The synchronous inline pipeline and the pooled one (under a
    running loop) give the same segments, rendition for rendition."""
    frames = []
    seq = 0
    for f in range(6):
        nals = _nals(40 + f, "cabac", 2)
        pk = []
        for j, n in enumerate(nals):
            p = nalu.packetize_h264(n, seq=seq, timestamp=f * 9000, ssrc=1,
                                    marker_on_last=j == len(nals) - 1)
            seq += len(p)
            pk += p
        frames.append(pk)

    def run_inline():
        lad = hls_rq.RequantLadder(device=CPU, target_duration=0.05)
        outs = {d: lad.add_rendition(d) for d in DELTAS}
        for pk in frames:
            for p in pk:
                lad.send_bytes(p, is_rtcp=False)
        return lad, outs

    async def run_pooled():
        lad = hls_rq.RequantLadder(device=CPU, target_duration=0.05)
        outs = {d: lad.add_rendition(d) for d in DELTAS}
        for pk in frames:
            for p in pk:
                lad.send_bytes(p, is_rtcp=False)
        for _ in range(1000):
            if lad.pending == 0:
                break
            await asyncio.sleep(0.01)
        return lad, outs

    lad_a, a = run_inline()
    lad_b, b = asyncio.run(run_pooled())
    assert lad_b.pending == 0 and lad_b.shed == 0 and lad_b.aus == 6
    for d in DELTAS:
        assert a[d].segments and [s.data for s in a[d].segments] \
            == [s.data for s in b[d].segments]
        assert _stats(a[d].requant.stats) == _stats(b[d].requant.stats)
    assert lad_a.dispatches == lad_b.dispatches == 6
