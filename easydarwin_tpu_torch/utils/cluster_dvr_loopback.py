"""The cluster's DVR peer fill, the erasure store's dead-owner replay and
the EasyCMS flow, on three servers in this process over one Redis.

``cluster_dvr(device, folder, seed=...)`` clears its node folders under
``folder`` and starts three
``StreamingServer``s (``NODES``: A, B and C) on ``device`` over one
``InMemoryRedis``, each with ``cluster_enabled`` at the lease settings
of the reference's dead-owner test (``LEASE_TTL_S``, ``HEARTBEAT_S``),
``dvr_enabled`` and ``storage_enabled`` with ``k`` data and ``m``
parity shards a stripe.  Then:

1. **Store.**  Two H.264 paths (SPS and PPS ahead of every IDR, FU-A at
   MTU 1,400, payload bytes from the seed) are pushed to A and
   finalized.  A's store encodes each asset's parity (B4) on its worker
   and pushes the shards it does not keep to B and C over
   ``shardpush``; ``store_ms`` is each finalize to A's store returning
   with every shard placed.
2. **Remote replay.**  B, which never saw the streams, replays the
   first as ``<path>.dvr``: its DESCRIBE bootstraps the asset through
   A's ``dvrmeta`` and every window comes over A's ``dvrwindow``.
3. **Dead owner.**  One data shard of the second asset that C holds is
   deleted (a stripe whose reconstruct is then a B4 product, before
   and after the repair of A's shards: ``_doomed_shard``), then A
   stops.  C, which has not replayed the asset, replays it: its DESCRIBE asks B's
   ``dvrmeta``, which B answers from its shard manifest (B has no DVR
   asset of that path), and each window C does not hold is rebuilt from
   the surviving shards (B4 on the server's device).  The survivors'
   repair of A's shards runs beside it.
4. **CMS.**  A ``SimDevice`` with two channels registers with a
   ``CmsServer`` over the same Redis; a ``CmsClient`` asks for both
   channels, the CMS places them on the least-loaded media server (both
   on one, at equal load), the device pushes them there and a player
   plays each (two streams with players: the megabatch engages).

Every replay and CMS player must start with the SPS, keep one SSRC,
have a gapless seq and carry the pushed payloads in push order (from
byte 12); no window may be repacked (``vod.cache.pack_window.calls``),
and no server may count a pump or device error, a wire or prime
mismatch, or a codec oracle mismatch.  The kernel launches of each step
are the deltas of ``kernel_lib.LAUNCHES`` around it (one process).

It returns the figures ``chip_smoke.py`` phase 17b prints.  Async; call
it under ``asyncio.run``.  Every socket wait has its own timeout.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import time

import numpy as np

from ..cluster import protocol as ep
from ..cluster.cms import CmsServer
from ..cluster.device import CmsClient, SimDevice
from ..cluster.redis_client import InMemoryRedis
from ..ops import kernel_lib
from ..protocol import nalu, rtp
from ..relay.fec import coeff_for_indices, gf_matmul, gf_solve
from ..server import ServerConfig, StreamingServer
from ..storage.service import shard_name
from ..vod.cache import pack_window
from .client import RtspClient
from .loopback import check

NODES = ("dvr-a", "dvr-b", "dvr-c")
#: the reference's dead-owner test's lease settings
LEASE_TTL_S = 2.0
HEARTBEAT_S = 0.3
SPS = bytes((0x67, 0x42, 0x00, 0x1F)) + bytes(range(8))
PPS = bytes((0x68, 0xCE, 0x3C, 0x80, 1, 2, 3, 4))
VIDEO_SDP = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=dvr\r\n"
             "c=IN IP4 0.0.0.0\r\nt=0 0\r\n"
             "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=fmtp:96 packetization-mode=1\r\n"
             "a=control:trackID=1\r\n")
#: the recorded paths: B replays the first, C the second (whose first
#: stripe the ring ranks C, B, A: data shard 0 and parity row 1 on C,
#: data shard 1 on B, parity row 0 on A, so ``_doomed_shard`` finds one
#: at any recording length)
PATHS = ("/cluster/rec", "/cluster/stripe")
SERIAL = "nvr0017"
#: seconds a step may wait for what it polls, and a socket call for its
#: answer (RTSP requests have the client's own 5 s)
STEP_S = 15.0
SOCKET_S = 5.0


def node_config(folder: str, node: str, *, k: int, m: int,
                window_pkts: int) -> ServerConfig:
    d = os.path.join(folder, node)
    cfg = ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        wan_ip="127.0.0.1", reflect_interval_ms=5,
        access_log_enabled=False, log_folder=os.path.join(d, "logs"),
        movie_folder=os.path.join(d, "movies"), server_id=node,
        cluster_enabled=True, cluster_lease_ttl_sec=LEASE_TTL_S,
        cluster_heartbeat_sec=HEARTBEAT_S,
        # a pinned score: no boot self-bench, and one ring for every node
        cluster_capacity_score=4096.0,
        dvr_enabled=True, dvr_window_pkts=window_pkts,
        storage_enabled=True, storage_data_shards=k,
        storage_parity_shards=m)
    cfg.stream.bucket_delay_ms = 0
    return cfg


def h264_frames(rng, n_frames: int, *, gop: int, nal_bytes: int,
                seq0: int = 0, ssrc: int = 7) -> list[list[bytes]]:
    """``n_frames`` frames at 25 a second: SPS and PPS ahead of each IDR
    (the relay's GOP head), every NAL's body from ``rng``."""
    out, seq = [], seq0
    for i in range(n_frames):
        ts = i * 3600
        pkts = []
        if i % gop == 0:
            for ps in (SPS, PPS):
                pkts += nalu.packetize_h264(ps, seq=seq, timestamp=ts,
                                            ssrc=ssrc, marker_on_last=False)
                seq += 1
        body = rng.integers(0, 256, nal_bytes, dtype=np.uint8).tobytes()
        nal = bytes((0x65 if i % gop == 0 else 0x41,)) + body
        fr = nalu.packetize_h264(nal, seq=seq, timestamp=ts, ssrc=ssrc,
                                 mtu=1400)
        seq += len(fr)
        out.append(pkts + fr)
    return out


async def _until(pred, timeout_s: float, what: str,
                 step_s: float = 0.005) -> float:
    """Poll ``pred`` (a plain callable) until it holds; the seconds."""
    t0 = time.monotonic()
    while not pred():
        check(time.monotonic() - t0 < timeout_s,
              f"{what} not within {timeout_s} s")
        await asyncio.sleep(step_s)
    return time.monotonic() - t0


async def _connect(host: str, port: int) -> RtspClient:
    c = RtspClient()
    await asyncio.wait_for(c.connect(host, port), SOCKET_S)
    return c


async def _push(port: int, path: str, frames, frame_s: float) -> RtspClient:
    c = await _connect("127.0.0.1", port)
    await c.push_start(f"rtsp://127.0.0.1:{port}{path}", VIDEO_SDP)
    for pkts in frames:
        for p in pkts:
            c.push_packet(0, p)
        await asyncio.wait_for(c.writer.drain(), SOCKET_S)
        await asyncio.sleep(frame_s)
    return c


async def _play(port: int, path: str, n: int, timeout_s: float) -> dict:
    """One interleaved player of ``path``: its first ``n`` packets, the
    ms from the DESCRIBE to the first one, and the client (open)."""
    c = await _connect("127.0.0.1", port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    t0 = time.monotonic()
    await c.play_start(uri)
    got, first_ms = [], None
    deadline = time.monotonic() + timeout_s
    while len(got) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            got.append(await c.recv_interleaved(0, timeout=left))
        except asyncio.TimeoutError:
            break
        if first_ms is None:
            first_ms = (time.monotonic() - t0) * 1e3
    return {"client": c, "uri": uri, "packets": got, "first_ms": first_ms}


def check_stream(got: list[bytes], pushed: list[bytes], what: str) -> dict:
    """SPS first, one SSRC, a gapless seq, and the payloads (from byte
    12) a run of the pushed ones in push order."""
    check(len(got) > 0, f"{what}: no packet")
    p0 = rtp.RtpPacket.parse(got[0])
    check(p0.payload[0] & 0x1F == 7, f"{what}: the first packet is NAL "
          f"{p0.payload[0] & 0x1F}, not the SPS")
    ssrcs = {rtp.peek_ssrc(d) for d in got}
    check(len(ssrcs) == 1, f"{what}: {len(ssrcs)} SSRCs")
    seqs = [rtp.peek_seq(d) for d in got]
    gaps = sum(1 for a, b in zip(seqs, seqs[1:]) if (b - a) & 0xFFFF != 1)
    check(gaps == 0, f"{what}: {gaps} seq gaps")
    bodies = [p[12:] for p in pushed]
    try:
        i0 = bodies.index(got[0][12:])
    except ValueError:
        i0 = -1
    check(i0 >= 0 and [d[12:] for d in got] == bodies[i0:i0 + len(got)],
          f"{what}: the payloads are not the pushed ones in order")
    return {"packets": len(got), "first_index": i0}


def _solve_is_b4(k: int, m: int, lost: set, lens: list) -> bool:
    """Whether the store's reconstruct of a stripe that lost the shard
    indices ``lost`` is a B4 product: the combined coefficients of its
    solve are not all 0/1 (``StripeCodec.reconstruct``'s test)."""
    need = [i for i in range(k) if i in lost and lens[i] > 0]
    idxs = [p for p in range(m) if k + p not in lost][:len(need)]
    if not need or len(idxs) < len(need):
        return False
    comb = gf_solve(coeff_for_indices(need, idxs),
                    np.eye(len(need), dtype=np.uint8))
    if comb is None:
        return False
    known = [i for i in range(k) if i not in lost and lens[i] > 0]
    if known:
        comb = np.concatenate(
            [comb, gf_matmul(comb, coeff_for_indices(known, idxs))], axis=1)
    return int(comb.max(initial=0)) > 1


def _doomed_shard(man: dict, asset: str, owner: str, victim: str) -> str:
    """The first data shard of a stripe, held by ``victim``, whose
    stripe, once it and every shard of ``owner`` are gone, keeps ``k``
    survivors and is rebuilt by a B4 product (a single loss through the
    XOR row is solved on the host), both before and after the
    survivors' repair of ``owner``'s shards: a lost data shard of
    ``owner`` comes back, a lost parity shard does not while the
    victim's data shard is missing.  The first, so that the replay's
    first read of the stripe rebuilds it (a restore rebuilds the window
    it was asked for, wherever that window's shard lives)."""
    k, m = int(man["k"]), int(man["m"])
    holders = man["holders"]
    for tid, trec in sorted(man["tracks"].items()):
        for s, srec in enumerate(trec["stripes"]):
            names = [shard_name(int(tid), s, i) for i in range(k + m)]
            lens = [int(x) for x in srec["lens"]]
            if holders.get(names[0]) != victim or lens[0] == 0:
                continue
            lost = {i for i, n in enumerate(names)
                    if holders.get(n) == owner} | {0}
            repaired = {i for i in lost if i == 0 or i >= k}
            if (len(lost) <= m and _solve_is_b4(k, m, lost, lens)
                    and _solve_is_b4(k, m, repaired, lens)):
                return names[0]
    raise AssertionError(f"no data shard on {victim} of {asset} whose "
                         f"stripe needs a B4 reconstruct")


#: the server counters every node must end its run with at 0
ZERO_COUNTERS = ("pump_errors", "device_errors", "mismatches",
                 "prime_failures", "codec_oracle_mismatches",
                 "worker_errors")


def _counters(app) -> dict:
    """One server's error, mismatch and store counters, from its
    ``stats()`` as they stand now."""
    st = app.stats()
    sto = st["storage"]
    return {"pump_errors": st["pump_errors"],
            "device_errors": st["resilience"]["device_errors"],
            "mismatches": st["megabatch"]["mismatches"],
            "window_calls": st["megabatch"]["window_calls"],
            "prime_failures": st["vod"]["prime_failures"],
            "device_primes": st["vod"]["device_primes"],
            "codec_oracle_mismatches": sto["oracle_mismatches"],
            "worker_errors": sto["worker_errors"],
            "reconstructs": sto["reconstructs"],
            "reconstruct_failures": sto["reconstruct_failures"],
            "repairs": sto["repairs"],
            "store_ms_per_call": sto["store_ms_per_call"],
            "parity_product_ms": sto["parity_product_ms"],
            "parity_check_ms": sto["parity_check_ms"],
            "device_passes": sto["device_passes"]}


def _launches(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in kernel_lib.LAUNCHES.items()
            if n - before.get(k, 0)}


async def cluster_dvr(device: str, folder: str, *, seed: int = 23,
                      frames: int = 120, gop: int = 25,
                      nal_bytes: int = 2500, frame_s: float = 0.004,
                      window_pkts: int = 64, k: int = 2, m: int = 2,
                      players: int = 2, cms_frames: int = 60) -> dict:
    rng = np.random.default_rng(seed)
    # a node that finds an earlier run's skeleton bootstraps nothing
    for sub in (*NODES, "snaps"):
        shutil.rmtree(os.path.join(folder, sub), ignore_errors=True)
    redis = InMemoryRedis()
    apps = [StreamingServer(node_config(folder, n, k=k, m=m,
                                        window_pkts=window_pkts),
                            device=device, redis_client=redis)
            for n in NODES]
    app_a, app_b, app_c = apps
    started: list = []
    clients: list = []
    cms = dev = None
    res: dict = {"nodes": list(NODES), "k": k, "m": m}
    try:
        for app in apps:
            await app.start()
            started.append(app)
        await _until(lambda: all(len(a.cluster.last_nodes) == len(NODES)
                                 for a in apps), STEP_S,
                     "every lease live on every node")

        # ---- 1. store: two paths pushed to A and finalized -------------
        pushed = {}
        srcs = [h264_frames(rng, frames, gop=gop, nal_bytes=nal_bytes,
                            ssrc=0x5100 + i) for i in range(len(PATHS))]
        pushers = await asyncio.gather(*(
            _push(app_a.rtsp.port, p, fr, frame_s)
            for p, fr in zip(PATHS, srcs)))
        clients += pushers
        for p, fr in zip(PATHS, srcs):
            pushed[p] = [pkt for pkts in fr for pkt in pkts]
        await _until(lambda: all(
            app_a.registry.find(p) is not None
            and app_a.registry.find(p).streams[1].rtp_ring.head
            == len(pushed[p]) for p in PATHS), STEP_S,
            "A received every pushed packet")
        l0 = dict(kernel_lib.LAUNCHES)
        res["store_ms"] = {}
        res["windows"] = {}
        for i, p in enumerate(PATHS):
            t0 = time.monotonic()
            fin = app_a.dvr.finalize(p)
            check(fin is not None and fin["windows"] > 0,
                  f"A finalized {p}: {fin}")
            res["windows"][p] = fin["windows"]
            await _until(lambda: app_a.storage.stored_assets == i + 1,
                         STEP_S, f"A's store of {p}")
            res["store_ms"][p] = (time.monotonic() - t0) * 1e3
        res["store_launches"] = _launches(l0)
        for c in pushers:
            await c.close()
            clients.remove(c)
        st_a = app_a.storage.stats()
        check(st_a["push_failures"] == 0 and st_a["shards_pushed"] > 0,
              f"A's store pushed {st_a['shards_pushed']} shards, "
              f"{st_a['push_failures']} failed")
        for app in (app_b, app_c):
            check(app.storage.manifest(PATHS[1]) is not None,
                  f"{app.config.server_id} holds no manifest of "
                  f"{PATHS[1]}")
        res["shards"] = {a.config.server_id: a.storage.shards_local
                         for a in apps}

        # ---- 2. remote replay on B -------------------------------------
        n_rec = {p: res["windows"][p] * window_pkts for p in PATHS}
        packs0 = pack_window.calls
        l0 = dict(kernel_lib.LAUNCHES)
        plays = await asyncio.gather(*(
            _play(app_b.rtsp.port, PATHS[0] + ".dvr", n_rec[PATHS[0]],
                  STEP_S) for _ in range(players)))
        clients += [pl["client"] for pl in plays]
        res["remote"] = {
            "first_ms": [pl["first_ms"] for pl in plays],
            "players": [check_stream(pl["packets"], pushed[PATHS[0]],
                                     f"B's replay {i}")
                        for i, pl in enumerate(plays)],
            "launches": _launches(l0)}
        for i, pl in enumerate(plays):
            check(len(pl["packets"]) == n_rec[PATHS[0]],
                  f"B's replay {i}: {len(pl['packets'])} of "
                  f"{n_rec[PATHS[0]]} packets")
        check(PATHS[0] in app_b._dvr_meta_peers,
              "B's bootstrap did not go through A's dvrmeta")
        for pl in plays:
            await pl["client"].teardown(pl["uri"])
            await pl["client"].close()
            clients.remove(pl["client"])

        # ---- 3. dead owner: a shard lost on C, A stopped, C replays ----
        man = app_a.storage.manifest(PATHS[1])
        doomed = _doomed_shard(man, PATHS[1], NODES[0], NODES[2])
        os.unlink(app_c.storage._shard_path(PATHS[1], doomed))
        res["deleted_shard"] = doomed
        l0 = dict(kernel_lib.LAUNCHES)
        c_products0 = app_c.storage.codec.product_ns["reconstruct"]
        res["servers"] = {NODES[0]: _counters(app_a)}
        await app_a.stop()
        started.remove(app_a)
        check(app_b.dvr.meta_doc(PATHS[1]) is None,
              "B has a DVR asset of the dead owner's path")
        plays = await asyncio.gather(*(
            _play(app_c.rtsp.port, PATHS[1] + ".dvr", n_rec[PATHS[1]],
                  STEP_S) for _ in range(players)))
        clients += [pl["client"] for pl in plays]
        res["dead_owner"] = {
            "first_ms": [pl["first_ms"] for pl in plays],
            "players": [check_stream(pl["packets"], pushed[PATHS[1]],
                                     f"C's replay {i}")
                        for i, pl in enumerate(plays)],
            "launches": _launches(l0)}
        for i, pl in enumerate(plays):
            check(len(pl["packets"]) == n_rec[PATHS[1]],
                  f"C's replay {i}: {len(pl['packets'])} of "
                  f"{n_rec[PATHS[1]]} packets")
        check(PATHS[1] in app_c._dvr_meta_peers,
              "C's bootstrap did not go through B's dvrmeta")
        st_c = app_c.storage.stats()
        res["dead_owner"]["reconstruct"] = {
            "reconstructs": st_c["reconstructs"],
            "gathers": st_c["gathers"],
            "gather_ms": st_c["gather_ms_per_reconstruct"],
            "launch_readback_ms": st_c["product_ms_per_reconstruct"],
            "crc_ms": st_c["check_ms_per_reconstruct"]}
        res["dead_owner"]["c_product_ms"] = (
            app_c.storage.codec.product_ns["reconstruct"]
            - c_products0) / 1e6
        check(st_c["reconstructs"] > 0,
              "C's replay reconstructed no window")
        check(res["dead_owner"]["c_product_ms"] > 0,
              "C's reconstruct ran no B4 product")
        res["pack_window_calls"] = pack_window.calls - packs0
        check(res["pack_window_calls"] == 0,
              f"{res['pack_window_calls']} windows repacked")
        for pl in plays:
            await pl["client"].teardown(pl["uri"])
            await pl["client"].close()
            clients.remove(pl["client"])

        # ---- 4. the CMS: a device's two channels to a media server -----
        cms = CmsServer(redis, bind_ip="127.0.0.1",
                        snap_dir=os.path.join(folder, "snaps"))
        await cms.start()
        cms_src = {ch: h264_frames(rng, cms_frames, gop=gop,
                                   nal_bytes=nal_bytes, ssrc=0x6200 + ch)
                   for ch in (0, 1)}
        pushing = []

        async def on_push(body):
            ch = int(body["Channel"])
            c = await _connect(body["IP"], int(body["Port"]))
            await c.push_start(body["URL"], VIDEO_SDP)
            pushing.append((ch, c))
            return True

        dev = SimDevice(SERIAL, channels=[{"Channel": "0"},
                                          {"Channel": "1"}],
                        on_push=on_push)
        await asyncio.wait_for(dev.connect("127.0.0.1", cms.port), SOCKET_S)
        client = CmsClient("127.0.0.1", cms.port)
        t0 = time.monotonic()
        acks = [await asyncio.wait_for(client.get_stream(SERIAL, str(ch)),
                                       2 * SOCKET_S) for ch in (0, 1)]
        for a in acks:
            check(a.error == ep.ERR_OK, f"get stream: {a.error} {a.body}")
        urls = [a.body["URL"] for a in acks]
        media = [a for a in (app_b, app_c)
                 if all(f":{a.rtsp.port}/" in u for u in urls)]
        check(len(media) == 1, f"the CMS placed the channels on "
              f"different servers: {urls}")
        media = media[0]
        clients += [c for _ch, c in pushing]
        l0 = dict(kernel_lib.LAUNCHES)
        # each channel's player joins before its first packet, so it
        # gets the channel's every packet from the first SPS on
        cplays = []
        for u in urls:
            c = await _connect("127.0.0.1", media.rtsp.port)
            clients.append(c)
            await c.play_start(u)
            cplays.append(c)

        async def feed(ch, c):
            for pkts in cms_src[ch]:      # a camera's pace
                for p in pkts:
                    c.push_packet(0, p)
                await asyncio.wait_for(c.writer.drain(), SOCKET_S)
                await asyncio.sleep(frame_s)

        async def collect(c, n):
            got, first_ms = [], None
            deadline = time.monotonic() + STEP_S
            while len(got) < n and time.monotonic() < deadline:
                try:
                    got.append(await c.recv_interleaved(
                        0, timeout=max(deadline - time.monotonic(), 0.01)))
                except asyncio.TimeoutError:
                    break
                if first_ms is None:
                    first_ms = (time.monotonic() - t0) * 1e3
            return got, first_ms

        chans = [int(u.rsplit("/", 1)[1].split(".")[0]) for u in urls]
        cms_pushed = {ch: [p for pkts in cms_src[ch] for p in pkts]
                      for ch in chans}
        by_ch = dict(pushing)
        outs = await asyncio.gather(
            *(collect(c, len(cms_pushed[ch]))
              for c, ch in zip(cplays, chans)),
            *(feed(ch, by_ch[ch]) for ch in chans))
        res["cms"] = {"media": media.config.server_id, "urls": urls,
                      "get_stream_to_first_ms": [o[1] for o in
                                                 outs[:len(chans)]],
                      "players": [], "launches": _launches(l0)}
        for i, ch in enumerate(chans):
            got = outs[i][0]
            check(len(got) == len(cms_pushed[ch]),
                  f"CMS player {i}: {len(got)} of {len(cms_pushed[ch])} "
                  f"packets")
            res["cms"]["players"].append(check_stream(
                got, cms_pushed[ch], f"CMS player {i}"))
        ptz = await asyncio.wait_for(client.ptz(SERIAL, "left"), SOCKET_S)
        check(ptz.error == ep.ERR_OK, f"PTZ: {ptz.error}")
        await _until(lambda: bool(dev.ctrl_log), 5.0, "the PTZ forward")

        # ---- the servers' counters -------------------------------------
        for app in (app_b, app_c):
            res["servers"][app.config.server_id] = _counters(app)
        for node, s in res["servers"].items():
            for key in ZERO_COUNTERS:
                check(s[key] == 0, f"{node}: {key} {s[key]}")
        return res
    finally:
        for c in clients:
            await c.close()
        if dev is not None:
            await dev.close()
        if cms is not None:
            await cms.stop()
        for app in started:
            await app.stop()
