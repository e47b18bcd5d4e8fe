"""The reference's reliability-tier and serving-path config keys, end to
end over loopback: CLI servers started with ``-c`` on a TOML written in
the reference's key names.

``keys_off`` (the keys off) starts one server with
``megabatch_enabled = false``, ``tcp_engine_enabled = false``,
``fec_device = false``, ``fec_window = 8``, ``fec_payload_type = 110``,
``rtx_payload_type = 109``, ``timeout_sweep_sec = 2`` and the store on
the host (``dvr_enabled``, ``storage_enabled``,
``storage_device = false``).  Its traffic:

* ``paths`` live paths of ``loopback.push_play_lossy`` at once, each with
  ``players`` (plain UDP, interleaved TCP and FEC players dropping media
  at a seeded rate), every player's span held to the oracle;
* beside them one more path (``DVR_PATH``) pushed for ``dvr_s`` seconds,
  finalized over REST ``stoprecord`` and stored; then its spill files and
  ``lost`` data shards of each stripe are deleted, and one UDP player
  replays ``<path>.dvr`` from npt 0, so every window of the replay comes
  through the store's reconstruct; the replay must equal the pushed
  packets of the spilled windows, a datagram missing only as far as the
  host's UDP ``RcvbufErrors`` rose.

``keys_gates`` (the gates) starts one server with
``reliable_udp = false``, ``fec_enabled = false`` and
``megabatch_min_streams = 3``: two paths of plain UDP players that ask
for ``x-FEC`` or ``x-Retransmit``, then, once both play, a third path.
It scrapes ``megabatch_passes_total`` from ``/metrics`` while two paths
play and after the third joined, and, once the traffic is over, sets
each key of ``KEY_VALUES`` through REST ``setbaseconfig`` and reads it
back through ``getbaseconfig`` (``reliable_udp`` and ``fec_enabled``
set to true, the others to ``KEY_VALUES``).

Both return the harness results and the server's exit stats; the caller
holds the kernel launches (``chip_smoke.py`` phase 18).  Async; call them
under ``asyncio.run``.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import time

import numpy as np

from . import synth
from .dvr_loopback import _delete_for_reconstruct
from .loopback import (VIDEO_SDP, CliServer, MiniClient, check,
                       http_get_json, metric_totals, push_play_lossy,
                       udp_rcvbuf_errors)
from .surface_loopback import envelope, rest

#: the finalized, stored and reconstructed path of ``keys_off``
DVR_PATH = "/keys/dvr"
#: spill window of ``keys_off``'s DVR (the server's default)
DVR_WINDOW_PKTS = 64

#: ``keys_off``'s TOML keys (besides the folders)
OFF_KEYS = {"megabatch_enabled": False, "tcp_engine_enabled": False,
            "fec_device": False, "fec_window": 8, "fec_payload_type": 110,
            "rtx_payload_type": 109, "timeout_sweep_sec": 2,
            "dvr_enabled": True, "storage_enabled": True,
            "storage_device": False}
#: ``keys_gates``'s TOML keys
GATE_KEYS = {"reliable_udp": False, "fec_enabled": False,
             "megabatch_min_streams": 3}

#: a value of each of the fifteen keys, none its default
KEY_VALUES = {"reliable_udp": False, "fec_enabled": False, "fec_window": 12,
              "fec_max_overhead": 0.2, "fec_kind": "xor",
              "fec_payload_type": 120, "rtx_payload_type": 121,
              "rtx_budget_per_sec": 32.0, "rtx_burst": 16,
              "fec_device": False, "megabatch_enabled": False,
              "megabatch_min_streams": 4, "tcp_engine_enabled": False,
              "storage_device": False, "timeout_sweep_sec": 7}


def write_toml(path: str, keys: dict) -> str:
    """``keys`` as a TOML file at ``path``; returns the path."""
    lines = []
    for k, v in keys.items():
        if isinstance(v, bool):
            lines.append(f"{k} = {'true' if v else 'false'}")
        elif isinstance(v, (int, float)):
            lines.append(f"{k} = {v}")
        else:
            lines.append(f"{k} = {json.dumps(str(v))}")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def off_players(plain: int, tcp: int, fec: int,
                drop: float = 0.08) -> list[dict]:
    """One path's players of ``keys_off``, the kinds interleaved."""
    kinds = ["plain"] * plain + ["tcp"] * tcp + ["fec"] * fec
    order = sorted(range(len(kinds)), key=lambda i: (i % 4, i))
    return [dict(kind=kinds[i], drop=drop) if kinds[i] == "fec"
            else dict(kind=kinds[i]) for i in order]


def gate_players(n: int) -> list[dict]:
    """One path's plain UDP players of ``keys_gates``, asking for FEC and
    for retransmission in turn."""
    asks = ({"x-fec": "parity"}, {"x-retransmit": "our-retransmit"})
    return [dict(kind="plain", ask=asks[i % 2]) for i in range(n)]


def _lossy(port: int, seed: int, players: list[dict], path: str,
           gops: int, deadline_s: float, joined=None):
    return push_play_lossy(
        port, np.random.default_rng(seed), players=players, gops=gops,
        frames=30, packets_per_frame=13, body_len=(1270, 1300),
        rr_every_s=0.5, deadline_s=deadline_s, path=path, joined=joined)


async def _dvr_store_and_rebuild(port: int, rest_port: int, folder: str,
                                 seed: int, dvr_s: float, lost: int,
                                 settle_s: float) -> dict:
    """``keys_off``'s DVR path: push, finalize, store, delete the spill
    and ``lost`` data shards a stripe, replay through the reconstruct."""
    rng = np.random.default_rng(seed)
    uri = f"rtsp://127.0.0.1:{port}{DVR_PATH}"
    ppf, fps = 13, 30
    n_frames = int(dvr_s * fps)
    sent = synth.paced_gop(rng, seq0=0xFFE0, ts0=0xFFFF0000,
                           ssrc=0xD0D00001, frames=n_frames,
                           packets_per_frame=ppf, body_len=(1270, 1300),
                           fu_a=True)
    pusher = MiniClient()
    await pusher.connect(port)
    await pusher.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                         VIDEO_SDP.encode())
    await pusher.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await pusher.request("RECORD", uri)
    t0 = time.monotonic()
    for f in range(n_frames):
        delay = t0 + f / fps - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        for pkt in sent[f * ppf:(f + 1) * ppf]:
            pusher.push(pkt)
    await asyncio.sleep(0.3)
    status, body = await http_get_json(
        rest_port, f"/api/v1/stoprecord?path={DVR_PATH}")
    check(status == 200, f"stoprecord -> {status} {body}")
    windows = int(body["EasyDarwin"]["Body"]["DvrWindows"])
    check(windows > 0, "the DVR path spilled no window")
    deadline = time.monotonic() + settle_s
    store = {}
    while time.monotonic() < deadline:
        _s, store = await http_get_json(rest_port, "/api/v1/storagestats")
        if store.get("assets"):
            break
        await asyncio.sleep(0.1)
    check(store.get("assets", 0) >= 1, f"the asset was not stored: {store}")
    await pusher.close()
    deleted = _delete_for_reconstruct(folder, lost, DVR_PATH)
    check(deleted["shards_deleted"] >= lost and deleted["spill_files"] >= 1,
          f"nothing to reconstruct: {deleted}")
    rcvbuf0 = udp_rcvbuf_errors()
    n = windows * DVR_WINDOW_PKTS
    player = MiniClient()
    try:
        await player.connect(port)
        ports = await player.udp_ports()
        await player.request("DESCRIBE", uri + ".dvr")
        await player.request("SETUP", uri + ".dvr/trackID=1", {
            "transport": f"RTP/AVP;unicast;client_port={ports}"})
        await player.request("PLAY", uri + ".dvr",
                             {"range": "npt=0-", "speed": "4"})
        deadline = time.monotonic() + settle_s
        while time.monotonic() < deadline and (
                not player.frames
                or player.frames[-1][12:] != sent[n - 1][12:]):
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.2)
    finally:
        await player.close()
    got = [d[12:] for d in player.frames]
    where = {p[12:]: i for i, p in enumerate(sent[:n])}
    idx = [where.get(g, -1) for g in got]
    check(all(i >= 0 for i in idx), "the replay carried a packet that was "
          "not pushed")
    check(idx == sorted(set(idx)), "the replay's packets are out of order "
          "or repeated")
    missing = n - len(idx)
    rcvbuf = udp_rcvbuf_errors() - rcvbuf0
    check(idx and idx[-1] == n - 1 and missing <= rcvbuf,
          f"the replay holds {len(idx)} of the {n} spilled packets "
          f"(host UDP RcvbufErrors +{rcvbuf})")
    return {"windows": windows, "packets": n, "replayed": len(idx),
            "deleted": deleted, "udp_rcvbuf_errors": rcvbuf}


async def keys_off(device: str, folder: str, seed: int, *, paths: int = 4,
                   players: list[dict] | None = None, gops: int = 5,
                   dvr_s: float = 2.0, lost: int = 2,
                   deadline_s: float = 30.0) -> dict:
    """The keys-off run of the module docstring; returns each path's
    harness result, the DVR path's figures, the server's preamble and its
    exit stats."""
    shutil.rmtree(folder, ignore_errors=True)
    movies = os.path.abspath(os.path.join(folder, "movies"))
    os.makedirs(movies)
    toml = write_toml(os.path.join(folder, "keys_off.toml"), {
        **OFF_KEYS, "movie_folder": movies,
        "log_folder": os.path.abspath(os.path.join(folder, "logs"))})
    players = players or off_players(8, 4, 4)
    async with CliServer(device, config=toml) as srv:
        try:
            res = await asyncio.gather(
                *[_lossy(srv.rtsp_port, seed + i, players, f"/keys/a{i}",
                         gops, deadline_s) for i in range(paths)],
                _dvr_store_and_rebuild(srv.rtsp_port, srv.rest_port,
                                       movies, seed + 100, dvr_s, lost,
                                       deadline_s))
        except AssertionError as e:
            raise AssertionError(
                f"{e}; the server's exit stats: {await srv.stop()}") from e
        stats = await srv.stop()
        preamble = list(srv.preamble)
    return {"paths": res[:paths], "dvr": res[paths], "preamble": preamble,
            "server_stats": stats}


async def keys_gates(device: str, folder: str, seed: int, *,
                     players: int = 4, gops: int = 6,
                     deadline_s: float = 30.0) -> dict:
    """The gates run of the module docstring; returns the three paths'
    harness results, the megabatch passes scraped with two paths playing
    and at the end, the keys set and read back, and the exit stats."""
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    toml = write_toml(os.path.join(folder, "keys_gates.toml"), {
        **GATE_KEYS,
        "log_folder": os.path.abspath(os.path.join(folder, "logs"))})
    specs = gate_players(players)
    async with CliServer(device, config=toml) as srv:
        try:
            joined = [asyncio.Event(), asyncio.Event()]
            two = [_lossy(srv.rtsp_port, seed + i, specs, f"/keys/b{i}",
                          gops, deadline_s, joined[i]) for i in range(2)]
            scrape = {}

            async def third():
                for ev in joined:
                    await ev.wait()
                # both paths play; the third's pusher has no player yet
                await asyncio.sleep(0.5)
                scrape["two_paths"] = await metric_totals(
                    srv.rest_port, ("megabatch_passes_total",))
                return await _lossy(srv.rtsp_port, seed + 2, specs,
                                    "/keys/b2", gops - 2, deadline_s)

            res = await asyncio.gather(*two, third())
            scrape["three_paths"] = await metric_totals(
                srv.rest_port, ("megabatch_passes_total",))
            keys = await _set_and_read_back(srv.rest_port, {
                **KEY_VALUES, "reliable_udp": True, "fec_enabled": True})
        except AssertionError as e:
            raise AssertionError(
                f"{e}; the server's exit stats: {await srv.stop()}") from e
        stats = await srv.stop()
    return {"paths": list(res), "megabatch_passes": {
        k: v["megabatch_passes_total"] for k, v in scrape.items()},
        "keys": keys, "server_stats": stats}


async def _set_and_read_back(rest_port: int, values: dict) -> dict:
    """``setbaseconfig`` of each key of ``values`` alone (each must
    answer 200), then one ``getbaseconfig`` that must read them all."""
    for k, v in values.items():
        envelope("setbaseconfig", *await rest(
            rest_port, "setbaseconfig",
            body=json.dumps({"Config": {k: v}}).encode()))
    cfg = envelope("getbaseconfig", *await rest(
        rest_port, "getbaseconfig"))["Config"]
    wrong = {k: cfg.get(k) for k, v in values.items() if cfg.get(k) != v}
    check(not wrong, f"getbaseconfig reads back {wrong}, not "
          f"{ {k: values[k] for k in wrong} }")
    return {k: cfg[k] for k in values}


def unmapped_keys(preamble: list[str]) -> list[str]:
    """The keys a server's ``unmapped:`` line listed (none: [])."""
    for line in preamble:
        m = re.search(r"unmapped: .*?(\[.*\])", line)
        if m is not None:
            return json.loads(m.group(1))
    return []


__all__ = ["keys_off", "keys_gates", "KEY_VALUES", "OFF_KEYS", "GATE_KEYS",
           "DVR_PATH", "write_toml", "off_players", "gate_players",
           "unmapped_keys"]
