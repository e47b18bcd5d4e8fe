"""The ``obs`` call sites of the VOD, DVR, store and HLS-requant tiers,
against the reference package's, on the CPU.

Each case runs the same work through the port and through the reference
(the segment cache's pinned LRU scenario, a paced hot play, a DVR
recording and its finalize, the store of the finished asset with
restores, a scrub and repairs, and an HLS requant ladder) and holds the
change of every non-timing family the tier bumps in the port's registry
to the change of the same family in the reference's: the counters by
label, and the gauges' values after the run.
"""

import time

import numpy as np
import pytest

from easydarwin_tpu import obs as ref_obs
from easydarwin_tpu.vod import cache as ref_cache
from easydarwin_tpu.vod import session as ref_session
from easydarwin_tpu.vod.mp4 import open_shared as ref_open_shared
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu_torch import obs
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.storage.service import shard_name
from easydarwin_tpu_torch.vod.cache import SegmentCache
from easydarwin_tpu_torch.vod.mp4 import open_shared
from easydarwin_tpu_torch.vod.session import VodPacerGroup

from test_torch_vod_cache import SMALL, _cache_trace
from test_torch_storage_service import PATH, _copy_store, _record
from easydarwin_tpu_torch.utils.vod_clips import write_clip


def _values(mod, names):
    """Every labelled value of the families ``names`` of ``mod``'s
    registry: {(family, labels): value}."""
    out = {}
    for name in names:
        fam = getattr(mod, name)
        for key, v in fam._values.items():
            out[(name, key)] = v
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _both(names, run):
    """Run ``run(ref)`` for the port then the reference; the change of
    the families ``names`` in each package's registry."""
    out = []
    for ref, mod in ((False, obs), (True, ref_obs)):
        before = _values(mod, names)
        run(ref)
        out.append(_delta(before, _values(mod, names)))
    return out


VOD_CACHE = ("VOD_CACHE_HITS", "VOD_CACHE_MISSES", "VOD_CACHE_EVICTIONS")


def test_cache_counters_equal_the_reference(tmp_path):
    clip = write_clip(tmp_path / "clip.mp4", SMALL, seed=11)
    port, ref = _both(VOD_CACHE, lambda ref: _cache_trace(
        ref_cache.SegmentCache if ref else SegmentCache,
        ref_open_shared if ref else open_shared, clip,
        device=False if ref else "cpu"))
    assert port == ref
    assert {k[0] for k in port} == set(VOD_CACHE)
    assert obs.VOD_CACHE_BYTES.value() == ref_obs.VOD_CACHE_BYTES.value() == 0


def _hot_play(path, *, ref: bool) -> int:
    """A warm-cache paced play on the host path; returns its packets."""
    f = (ref_open_shared if ref else open_shared)(path)
    if ref:
        cache = ref_cache.SegmentCache(window_samples=8, device=False)
        pacer = ref_session.VodPacerGroup(cache, lookahead_ms=250)
        outs = {1: RefOutput(ssrc=1), 2: RefOutput(ssrc=2)}
    else:
        cache = SegmentCache(window_samples=8, device="cpu")
        pacer = VodPacerGroup(cache, lookahead_ms=250)
        outs = {1: CollectingOutput(ssrc=1), 2: CollectingOutput(ssrc=2)}
    cache.warm_asset(f)
    sess = pacer.open(f, outs, speed=2000.0,
                      now_ms=int(time.monotonic() * 1000))
    deadline = time.time() + 20
    while not sess.done and time.time() < deadline:
        t = int(time.monotonic() * 1000)
        for st, _e in pacer.tick(t):
            st.reflect(t)
        time.sleep(0.001)
    assert sess.done
    pacer.close()
    cache.close()
    f.close()
    return sum(len(o.rtp_packets) for o in outs.values())


def test_paced_play_counters_equal_the_reference(tmp_path):
    clip = write_clip(tmp_path / "clip.mp4", SMALL, seed=11)
    sent = {}

    def run(ref):
        sent[ref] = _hot_play(clip, ref=ref)

    port, ref = _both(("VOD_PACKETS",), run)
    assert port == ref
    assert port[("VOD_PACKETS", ("hot",))] == sent[False] \
        == sent[True] > 0
    assert obs.VOD_SESSIONS.value() == ref_obs.VOD_SESSIONS.value() == 0


DVR = ("DVR_WINDOWS_SPILLED", "DVR_RETENTION_EVICTIONS",
       "VOD_CACHE_HITS", "VOD_CACHE_MISSES")


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Both packages' recordings of the same pushes (the families'
    changes while recording), and their stores of the finished asset."""
    from easydarwin_tpu.storage import StorageService as RefStorage
    from easydarwin_tpu_torch.storage import StorageService
    root = tmp_path_factory.mktemp("tiers")
    dvrs, stores = {}, {}
    names = DVR + ("STORAGE_SHARDS",)

    def run(ref):
        name = "ref" if ref else "port"
        dvrs[name] = _record(root / name / "dvr", ref=ref, k=8)
        if ref:
            st = RefStorage(str(root / name / "shards"), "node-a", k=4,
                            m=2, use_device=False)
        else:
            st = StorageService(str(root / name / "shards"), "node-a",
                                k=4, m=2, device="cpu")
        stores[name] = (st, st.store_asset(PATH, dvrs[name]), dvrs[name])

    deltas = _both(names, run)
    return deltas, stores


def test_dvr_spill_counters_equal_the_reference(recorded):
    (port, ref), _stores = recorded
    assert port == ref
    spilled = port[("DVR_WINDOWS_SPILLED", ())]
    assert spilled > 0
    assert obs.DVR_SPILL_BYTES.value() == ref_obs.DVR_SPILL_BYTES.value()


def test_store_shard_counters_equal_the_reference(recorded):
    (port, ref), stores = recorded
    shards = {k: v for k, v in port.items() if k[0] == "STORAGE_SHARDS"}
    assert shards == {k: v for k, v in ref.items()
                      if k[0] == "STORAGE_SHARDS"}
    st = stores["port"][0]
    assert sum(shards.values()) == st.shards_local > 0


STORE = ("STORAGE_RECONSTRUCTS", "STORAGE_SCRUB_ERRORS", "STORAGE_REPAIRS",
         "STORAGE_REPAIR_BYTES", "STORAGE_SHARDS")


@pytest.mark.parametrize("lost", [(1,), (0, 3), (0, 1, 4)])
def test_restore_counters_equal_the_reference(recorded, tmp_path, lost):
    _deltas, stores = recorded
    import os

    def run(ref):
        name = "ref" if ref else "port"
        src, man, _dvr = stores[name]
        st = _copy_store(src, tmp_path / name, ref=ref)
        for tid, trec in man["tracks"].items():
            for idx in lost:
                p = st._shard_path(PATH, shard_name(int(tid), 0, idx))
                if os.path.isfile(p):
                    os.unlink(p)
        for tid, trec in man["tracks"].items():
            for win in trec["wins"][:4]:
                st.restore_window(PATH, int(tid), win)

    port, ref = _both(STORE, run)
    assert port == ref
    key = ("STORAGE_RECONSTRUCTS",
           ("failed" if len(lost) > 2 else "ok",))
    assert port[key] > 0


def test_scrub_and_repair_counters_equal_the_reference(recorded, tmp_path):
    _deltas, stores = recorded

    def run(ref):
        name = "ref" if ref else "port"
        st = _copy_store(stores[name][0], tmp_path / name, ref=ref)
        pname, dname = shard_name(1, 1, 4), shard_name(1, 1, 2)
        p = st._shard_path(PATH, pname)
        good = open(p, "rb").read()
        with open(p, "r+b") as fh:
            fh.seek(3)
            fh.write(bytes([good[3] ^ 0xFF]))
        st._scrub_cursor = []
        st.scrub_tick(batch=10 ** 6)
        st.repair_now(PATH, pname)
        import os
        os.unlink(st._shard_path(PATH, dname))
        st._stripe_cache.clear()
        st.repair_now(PATH, dname)

    port, ref = _both(STORE, run)
    assert port == ref
    assert port[("STORAGE_SCRUB_ERRORS", ())] == 1
    assert port[("STORAGE_REPAIRS", ("parity",))] == 1
    assert port[("STORAGE_REPAIRS", ("data",))] == 1


REQUANT = ("REQUANT_AUS", "REQUANT_SLICES", "REQUANT_RENDITIONS",
           "REQUANT_SHED", "REQUANT_REASSEMBLY_MISMATCH")


@pytest.mark.parametrize("slices", [1, 2])
def test_requant_ladder_counters_equal_the_reference(slices):
    from easydarwin_tpu.hls import requant as ref_rq
    from easydarwin_tpu.protocol import nalu as ref_nalu
    from easydarwin_tpu_torch.hls import requant as rq
    from test_torch_hls import _pictures
    pics = _pictures(4, "cavlc", slices, seed=9)
    pkts, seq = [], 0
    for f, nals in enumerate(pics):
        for j, nal in enumerate(nals):
            p = ref_nalu.packetize_h264(nal, seq=seq, timestamp=f * 9000,
                                        ssrc=1,
                                        marker_on_last=j == len(nals) - 1)
            seq += len(p)
            pkts += p

    def run(ref):
        lad = (ref_rq.RequantLadder(use_device=False, target_duration=0.05)
               if ref else rq.RequantLadder(device="cpu",
                                            target_duration=0.05))
        for d in (6, 12):
            lad.add_rendition(d)
        for p in pkts:
            lad.write_rtp(p)

    port, ref = _both(REQUANT, run)
    assert port == ref
    assert port[("REQUANT_AUS", ())] == 4
    assert port[("REQUANT_RENDITIONS", ())] == 8
    assert port[("REQUANT_SLICES", ())] == 4 * slices * 2


def test_requant_stage_seconds_and_ledger_class_are_filed():
    from easydarwin_tpu.protocol import nalu as ref_nalu
    from easydarwin_tpu_torch.hls import requant as rq
    from test_torch_hls import _pictures
    pics = _pictures(2, "cavlc", 1, seed=3)
    lad = rq.RequantLadder(device="cpu", target_duration=0.05)
    lad.add_rendition(6)
    n0 = {s: obs.REQUANT_STAGE_SECONDS.count(stage=s)
          for s in rq.REQUANT_STAGES}
    seq = 0
    for f, nals in enumerate(pics):
        for j, nal in enumerate(nals):
            for p in ref_nalu.packetize_h264(
                    nal, seq=seq, timestamp=f * 9000, ssrc=1,
                    marker_on_last=j == len(nals) - 1):
                seq += 1
                lad.write_rtp(p)
    for s in rq.REQUANT_STAGES:
        assert obs.REQUANT_STAGE_SECONDS.count(stage=s) > n0[s], s
    assert np.isfinite(obs.REQUANT_STAGE_SECONDS.total_sum())
