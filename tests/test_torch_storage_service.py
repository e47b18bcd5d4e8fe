"""The port's erasure-coded store (``storage.service.StorageService``) on the
CPU, against the JAX package's, and the kernel caches the store's worker
threads share with the pump.

The reference's store runs with host parity (``use_device=False``), the
port's on ``device="cpu"`` (B4's plain torch version): the same finalized
DVR asset (recorded by each package's ``DvrManager`` from the same pushes
on a pinned clock) must give the same shard files and manifest, byte for
byte, and ``restore_window`` must give the same blobs (the recorded ones)
with 0, 1 and 2 shards of every stripe lost, in every pattern of data and
parity losses; at 3 losses both return None and count a reconstruct
failure.  The scrub's crc quarantine, ``repair_now`` of a parity and a
data shard, and the host-oracle case (a parity shard tampered together
with its manifest crc) behave alike.  The trimmed ``HashRing`` ranks as
the reference's.
"""

import json
import os
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from easydarwin_tpu.cluster.placement import HashRing as RefHashRing
from easydarwin_tpu.dvr import service as ref_service
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu.storage import StorageService as RefStorage
from easydarwin_tpu.vod import cache as ref_cache
from easydarwin_tpu.vod.session import VodPacerGroup as RefPacer
from easydarwin_tpu_torch.cluster.placement import HashRing, shard_key
from easydarwin_tpu_torch.dvr import service
from easydarwin_tpu_torch.ops import fec_kernel, kernel_lib
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.storage import StorageService
from easydarwin_tpu_torch.storage.service import shard_name
from easydarwin_tpu_torch.vod import cache
from easydarwin_tpu_torch.vod.session import VodPacerGroup

from test_torch_dvr import T0, VIDEO_SDP, _files, _frames

AV_SDP = (VIDEO_SDP
          + "m=audio 0 RTP/AVP 97\r\na=rtpmap:97 MPEG4-GENERIC/8000\r\n"
            "a=control:trackID=2\r\n")
PATH = "/live/st"


def _record(root, *, ref: bool, n_frames: int = 160, k: int = 16):
    """Record ``n_frames`` of video (and an audio packet a frame) on a
    pinned clock, finalize, and return the manager."""
    if ref:
        c = ref_cache.SegmentCache(budget_bytes=8 << 20, device=False)
        reg = RefRegistry()
        pacer = RefPacer(c)
        dvr = ref_service.DvrManager(str(root), c, pacer, reg,
                                     window_pkts=k)
    else:
        c = cache.SegmentCache(budget_bytes=8 << 20, device="cpu")
        reg = SessionRegistry()
        pacer = VodPacerGroup(c)
        dvr = service.DvrManager(str(root), c, pacer, reg, window_pkts=k)
    sess = reg.find_or_create(PATH, AV_SDP)
    assert dvr.arm(sess, AV_SDP)
    rng = np.random.default_rng(29)
    for i, pkts in enumerate(_frames(n_frames, size=900)):
        t = T0 + 33 * i
        for p in pkts:
            sess.push(1, p, t_ms=t)
        body = rng.integers(0, 256, int(rng.integers(20, 300)),
                            dtype=np.uint8).tobytes()
        sess.push(2, bytes((0x80, 0xE1)) + (i & 0xFFFF).to_bytes(2, "big")
                  + (i * 1024).to_bytes(4, "big") + b"\0\0\0\x09" + body,
                  t_ms=t)
        dvr.tick(t)
    assert dvr.finalize(PATH)["windows"] > 0
    return dvr


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both packages' stores of the same asset, k = 4, m = 2."""
    root = tmp_path_factory.mktemp("stores")
    out = {}
    for name, ref in (("ref", True), ("port", False)):
        dvr = _record(root / name / "dvr", ref=ref)
        if ref:
            st = RefStorage(str(root / name / "shards"), "node-a", k=4, m=2,
                            use_device=False)
        else:
            st = StorageService(str(root / name / "shards"), "node-a", k=4,
                                m=2, device="cpu")
        man = st.store_asset(PATH, dvr)
        out[name] = (st, man, dvr)
    return out


def test_shards_and_manifest_equal_the_reference(stores):
    st, man, _ = stores["port"]
    rst, rman, _ = stores["ref"]
    assert man == rman
    assert _files(st.root) == _files(rst.root)
    stripes = sum(len(t["stripes"]) for t in man["tracks"].values())
    windows = sum(len(t["wins"]) for t in man["tracks"].values())
    # a data shard a window (a short last stripe pads with nothing) and
    # m = 2 parity shards a stripe
    assert st.shards_local == rst.shards_local == windows + 2 * stripes
    assert st.stored_assets == 1 and st.codec.device_passes == stripes
    assert st.codec.oracle_mismatches == 0
    assert sorted(st.pending_claims()) == sorted(rst.pending_claims())
    assert st.meta_doc(PATH) == rst.meta_doc(PATH)


def _blob(dvr, tid, win):
    return dvr.window_blob(PATH, tid, win)


#: lost shard patterns of one stripe: none, one data, one parity, two
#: data, a data and a parity, both parity
LOSSES = [(), (1,), (4,), (0, 3), (2, 5), (4, 5)]


def _copy_store(src, dst, *, ref: bool):
    import shutil
    shutil.copytree(src.root, dst)
    if ref:
        return RefStorage(str(dst), "node-a", k=4, m=2, use_device=False)
    return StorageService(str(dst), "node-a", k=4, m=2, device="cpu")


@pytest.mark.parametrize("lost", LOSSES, ids=lambda x: "-".join(map(str, x))
                         or "none")
def test_restore_window_equals_the_reference(stores, tmp_path, lost):
    got = {}
    for name in ("ref", "port"):
        src, man, dvr = stores[name]
        st = _copy_store(src, tmp_path / name, ref=name == "ref")
        for tid, trec in man["tracks"].items():
            for s in range(len(trec["stripes"])):
                for idx in lost:
                    p = st._shard_path(PATH, shard_name(int(tid), s, idx))
                    if os.path.isfile(p):
                        os.unlink(p)
        blobs = {}
        for tid, trec in man["tracks"].items():
            for win in trec["wins"]:
                blobs[(tid, win)] = st.restore_window(PATH, int(tid), win)
                assert blobs[(tid, win)] == _blob(dvr, int(tid), win)
        got[name] = (blobs, st.reconstructs, st.reconstruct_failures)
    assert got["port"] == got["ref"]
    data_lost = sum(1 for i in lost if i < 4)
    assert (got["port"][1] > 0) == (data_lost > 0)
    assert got["port"][2] == 0


def test_three_losses_fail_loudly_like_the_reference(stores, tmp_path):
    got = {}
    for name in ("ref", "port"):
        src, man, dvr = stores[name]
        st = _copy_store(src, tmp_path / name, ref=name == "ref")
        for idx in (0, 1, 4):
            os.unlink(st._shard_path(PATH, shard_name(1, 0, idx)))
        res = [st.restore_window(PATH, 1, w)
               for w in man["tracks"]["1"]["wins"][:4]]
        got[name] = (res, st.reconstruct_failures)
    assert got["port"] == got["ref"]
    res, failures = got["port"]
    assert res[0] is None and res[1] is None and failures == 2
    assert res[2] == _blob(stores["port"][2], 1,
                           stores["port"][1]["tracks"]["1"]["wins"][2])
    assert stores["port"][0].stats()["reconstruct_failures"] == 0


def test_scrub_quarantine_and_repair_equal_the_reference(stores, tmp_path):
    got = {}
    for name in ("ref", "port"):
        src, _man, _dvr = stores[name]
        st = _copy_store(src, tmp_path / name, ref=name == "ref")
        pname, dname = shard_name(1, 1, 4), shard_name(1, 1, 2)
        p = st._shard_path(PATH, pname)
        good = open(p, "rb").read()
        with open(p, "r+b") as fh:
            fh.seek(3)
            fh.write(bytes([good[3] ^ 0xFF]))
        st._scrub_cursor = []
        scrubbed = st.scrub_tick(batch=10 ** 6)
        quarantined = (st.scrub_errors, os.path.isfile(p),
                       (PATH, pname) in st._repair_queue)
        repaired = st.repair_now(PATH, pname)
        dgood = open(st._shard_path(PATH, dname), "rb").read()
        os.unlink(st._shard_path(PATH, dname))
        st._stripe_cache.clear()
        drepaired = st.repair_now(PATH, dname)
        got[name] = (scrubbed, quarantined, repaired, st.repairs,
                     st.repair_bytes, _files(st.root),
                     open(p, "rb").read() == good,
                     open(st._shard_path(PATH, dname), "rb").read()
                     == dgood, drepaired)
    assert got["port"] == got["ref"]
    scrubbed, quarantined, repaired, repairs = got["port"][:4]
    assert scrubbed == stores["port"][0].shards_local
    assert quarantined == (1, False, True) and repairs == 2
    assert got["port"][6] and got["port"][7]


def test_scrub_host_oracle_equals_the_reference(stores, tmp_path):
    got = {}
    for name in ("ref", "port"):
        src, _man, _dvr = stores[name]
        st = _copy_store(src, tmp_path / name, ref=name == "ref")
        man = json.loads(json.dumps(st.manifest(PATH)))
        pname = shard_name(1, 0, 5)
        p = st._shard_path(PATH, pname)
        bad = bytearray(open(p, "rb").read())
        bad[0] ^= 0x55
        with open(p, "wb") as fh:
            fh.write(bytes(bad))
        man["tracks"]["1"]["stripes"][0]["pcrcs"][1] = \
            zlib.crc32(bytes(bad)) & 0xFFFFFFFF
        st._write_manifest(PATH, man)
        st._scrub_cursor = []
        st.scrub_tick(batch=10 ** 6)
        got[name] = (st.scrub_errors, os.path.isfile(p))
    assert got["port"] == got["ref"] == (1, False)


def test_a_clean_scrub_reports_no_error(stores, tmp_path):
    st = _copy_store(stores["port"][0], tmp_path / "port", ref=False)
    assert st.scrub_tick(batch=10 ** 6) == stores["port"][0].shards_local
    assert st.scrub_errors == 0
    assert st.stats()["scrubbed"] == stores["port"][0].shards_local


def test_a_failed_worker_job_is_counted(tmp_path):
    st = StorageService(str(tmp_path / "s"), "n", k=4, m=2, device="cpu")

    class _Broken:
        def meta_doc(self, path):
            raise RuntimeError("meta unreadable")

    fut = st.store_async(PATH, _Broken())
    with pytest.raises(RuntimeError):
        fut.result()
    st.close()
    assert st.worker_errors == 1 and st.stats()["worker_errors"] == 1


def test_hash_ring_ranks_as_the_reference():
    nodes = [f"n{i}" for i in range(7)]
    caps = {n: 1.0 + i for i, n in enumerate(nodes)}
    for kw in ({}, {"capacities": caps}):
        ring, rring = HashRing(nodes, **kw), RefHashRing(nodes, **kw)
        assert ring.vnode_counts() == rring.vnode_counts()
        for s in range(40):
            key = f"/live/pl/t1/s{s}"
            assert ring.rank(key) == rring.rank(key)
            assert ring.owner(key) == rring.owner(key)
    assert shard_key("/live/a", "t1/s0.2") == "Shard:live/a/t1/s0.2"


# ================================================ the locked kernel caches
def _race(n, fn):
    """``fn()`` from ``n`` threads released together (with a short switch
    interval, so a lost update would show); their results."""
    bar = threading.Barrier(n)
    out = [None] * n

    def run(i):
        bar.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return out


def _slow(calls, make):
    def fn(*args):
        calls.append(args)
        threading.Event().wait(0.02)      # widen the race window
        return make(*args)
    return fn


@pytest.mark.parametrize("cache_name", ["tables", "scratch", "library"])
def test_kernel_caches_fill_once_from_many_threads(monkeypatch,
                                                   cache_name):
    calls: list = []
    dev = torch.device("cpu")
    if cache_name == "tables":
        monkeypatch.setattr(fec_kernel, "_TABLES", {})
        monkeypatch.setattr(fec_kernel, "_upload", _slow(
            calls, lambda t, d: torch.from_numpy(t).to(d)))
        got = _race(16, lambda: fec_kernel._tables(dev))
        table = fec_kernel._TABLES
    elif cache_name == "scratch":
        monkeypatch.setattr(kernel_lib, "_SCRATCH", {})
        monkeypatch.setattr(kernel_lib, "_stream_id", lambda d: 0)
        monkeypatch.setattr(kernel_lib, "_zeros", _slow(
            calls, lambda w, d: torch.zeros(w, dtype=torch.int32)))
        got = _race(16, lambda: kernel_lib.scratch("ed_relay_batch", 4,
                                                   dev))
        table = kernel_lib._SCRATCH
    else:
        monkeypatch.setattr(kernel_lib, "_LIB", None)
        monkeypatch.setattr(kernel_lib, "_load", _slow(calls, object))
        got = _race(16, kernel_lib.library)
        table = {"lib": kernel_lib._LIB}
    assert len(calls) == 1 and len(table) == 1
    assert all(g is got[0] for g in got)
