"""The observed relay: the live relay under load with its ``obs`` surface
scraped, and the parsers that read what the scrapes return.

``observed_relay`` starts one CLI server (``loopback.CliServer``, with
``EDTPU_PROFILE`` set as asked) and pushes three paths at once: two
``push_play_av`` sources (H.264 + AAC with SRs) played by UDP, TCP,
meta-info and lossy-report players, and one ``push_play_lossy`` source
played by FEC players, so the wake's pass is the megabatch over three or
more streams and the batch-header rung and the FEC tier run beside it.
Each harness holds every packet to its oracle.  While they run, a
scraper reads ``/metrics`` and the ledger, profile, audience and events
documents each ``scrape_every_s``.  When the traffic has ended and the
pump has gone quiet (``quiet_s``: the last in-flight pass harvested) the
final scrape reads ``/metrics``, ``/api/v1/{ledger,profile,audience,
events,fleet}``, ``/debug/profile``, ``admin command=top``,
``getserverinfo`` and GET ``/`` and ``/stats`` on both ports, and
``tools/blame_report.py --url`` runs against the server.  Returns the
harnesses' results, the scrapes, the report and the server's exit stats.

``exposition`` parses a Prometheus text exposition into its families and
samples; ``pprof_summary`` decodes the gzipped pprof profile far enough
to name its strings and sum its samples.
"""

from __future__ import annotations

import asyncio
import gzip
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import loopback

ROOT = Path(__file__).resolve().parents[2]
AV_PATHS = ("/live/obs1", "/live/obs2")
FEC_PATH = "/live/obs3"
#: the documents the scraper reads each round, and the final scrape's
DOCS = ("ledger", "profile", "audience", "events")
FINAL_DOCS = DOCS + ("fleet",)


def av_players(n_udp: int, n_tcp: int, n_meta: int) -> tuple[list, list]:
    """The two AV paths' players, in join order: the UDP, TCP and
    meta-info/lossy-report players split evenly, interleaved (half the
    meta players meta-info, half lossy)."""
    specs = ([dict(transport="udp")] * n_udp + [dict(transport="tcp")]
             * n_tcp + [dict(transport="udp", meta=i % 2 == 0,
                             lossy=i % 2 == 1) for i in range(n_meta)])
    order = sorted(range(len(specs)), key=lambda i: (i % 4, i))
    mixed = [specs[i] for i in order]
    return mixed[0::2], mixed[1::2]


async def _get(port: int, target: str,
               timeout: float = 30.0) -> tuple[int, dict, bytes]:
    """One GET: (status, headers, body by its Content-Length)."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        w.write(f"GET {target} HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n"
                .encode())
        head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), timeout)
        lines = head[:-4].decode("latin-1").split("\r\n")
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (ln.partition(":") for ln in lines[1:])}
        body = await asyncio.wait_for(
            r.readexactly(int(hdrs.get("content-length", 0))), timeout)
    finally:
        w.close()
    return int(lines[0].split()[1]), hdrs, body


async def scrape(rest_port: int) -> dict:
    """``/metrics`` and the scraper's documents, with the host ms each
    took."""
    out = {}
    t0 = time.perf_counter()
    st, _h, body = await _get(rest_port, "/metrics")
    out["metrics"] = (st, body.decode())
    for cmd in DOCS:
        st, _h, body = await _get(rest_port, f"/api/v1/{cmd}")
        out[cmd] = (st, len(body))
    out["ms"] = (time.perf_counter() - t0) * 1e3
    return out


async def final_scrape(rtsp_port: int, rest_port: int) -> dict:
    """Everything the checks read once the traffic has ended."""
    out = await scrape(rest_port)
    docs = {}
    for cmd in FINAL_DOCS:
        st, _h, body = await _get(rest_port, f"/api/v1/{cmd}")
        docs[cmd] = (st, [json.loads(ln) for ln in body.splitlines()]
                     if cmd == "events" else json.loads(body))
    out["docs"] = docs
    st, _h, body = await _get(rest_port, "/debug/profile")
    out["pprof"] = (st, body)
    st, _h, body = await _get(rest_port, "/api/v1/admin?command=top")
    out["top"] = (st, json.loads(body))
    st, _h, body = await _get(rest_port, "/api/v1/getserverinfo")
    out["info"] = (st, json.loads(body)["EasyDarwin"]["Body"])
    out["pages"] = {}
    for name, port in (("rtsp", rtsp_port), ("rest", rest_port)):
        for target in ("/", "/stats"):
            st, hdrs, body = await _get(port, target)
            out["pages"][f"{name} {target}"] = (
                st, hdrs.get("content-type", ""), len(body))
    return out


def blame_report(rest_port: int) -> tuple[int, str, str | None]:
    """``tools/blame_report.py --url`` against the server: (exit code,
    stdout, the top offender it names)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "blame_report.py"), "--url",
         f"http://127.0.0.1:{rest_port}"], capture_output=True, text=True,
        timeout=60)
    m = re.search(r"^top offender: (\S+)", out.stdout, re.M)
    return out.returncode, out.stdout, m.group(1) if m else None


async def observed_relay(device: str, seed: int, *, profile: bool = True,
                         udp: int = 16, tcp: int = 16, meta: int = 8,
                         fec: int = 8, gops: int = 7, frames: int = 30,
                         packets_per_frame: int = 13, body_len=(1270, 1300),
                         scrape_every_s: float = 1.0, quiet_s: float = 1.5,
                         deadline_s: float = 60.0) -> dict:
    """One observed run (the module docstring); the same ``seed`` gives
    the same traffic."""
    p1, p2 = av_players(udp, tcp, meta)
    fec_specs = [dict(kind="fec", drop=0.08)] * fec
    was = os.environ.get("EDTPU_PROFILE")
    os.environ["EDTPU_PROFILE"] = "1" if profile else "0"
    try:
        srv = loopback.CliServer(device)
        await srv.__aenter__()
    finally:
        if was is None:
            os.environ.pop("EDTPU_PROFILE", None)
        else:
            os.environ["EDTPU_PROFILE"] = was
    try:
        scrapes = []
        done = asyncio.Event()

        async def scraper() -> None:
            while not done.is_set():
                try:
                    await asyncio.wait_for(done.wait(), scrape_every_s)
                except asyncio.TimeoutError:
                    s = await scrape(srv.rest_port)
                    scrapes.append({"ms": s["ms"],
                                    "metrics_bytes": len(s["metrics"][1]),
                                    **{k: s[k] for k in DOCS}})

        task = asyncio.create_task(scraper())
        t0 = time.monotonic()
        kw = dict(gops=gops, frames=frames,
                  packets_per_frame=packets_per_frame, body_len=body_len,
                  deadline_s=deadline_s)
        try:
            av1, av2, lossy = await asyncio.gather(
                loopback.push_play_av(srv.rtsp_port,
                                      np.random.default_rng(seed),
                                      players=p1, path=AV_PATHS[0], **kw),
                loopback.push_play_av(srv.rtsp_port,
                                      np.random.default_rng(seed + 1),
                                      players=p2, path=AV_PATHS[1], **kw),
                loopback.push_play_lossy(srv.rtsp_port,
                                         np.random.default_rng(seed + 2),
                                         players=fec_specs,
                                         path=FEC_PATH, **kw))
        finally:
            done.set()
            await task
        traffic_s = time.monotonic() - t0
        await asyncio.sleep(quiet_s)
        final = await final_scrape(srv.rtsp_port, srv.rest_port)
        report = await asyncio.to_thread(blame_report, srv.rest_port)
        stats = await srv.stop()
    finally:
        await srv.__aexit__(None, None, None)
    return {"profile": profile, "av": [av1, av2], "lossy": lossy,
            "players": len(p1) + len(p2) + fec, "scrapes": scrapes,
            "final": final, "blame": report, "server_stats": stats,
            "traffic_s": traffic_s}


# ---------------------------------------------------------------- parsers
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def exposition(text: str) -> tuple[dict, list]:
    """A text exposition → ({family: kind}, [(sample name, {label:
    value}, value)])."""
    fams, samples = {}, []
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            fams[name] = kind
            continue
        if not ln or ln.startswith("#"):
            continue
        m = _SAMPLE_RE.match(ln)
        if m is None:
            raise ValueError(f"not a sample line: {ln!r}")
        labels = dict(_LABEL_RE.findall(m.group(3) or ""))
        samples.append((m.group(1), labels, float(m.group(4))))
    return fams, samples


def family_of(sample: str, fams: dict) -> str | None:
    """The family a sample line belongs to (a histogram's ``_bucket``,
    ``_sum`` and ``_count`` lines are its family's)."""
    if sample in fams:
        return sample
    for suffix in ("_bucket", "_sum", "_count"):
        if sample.endswith(suffix) and sample[:-len(suffix)] in fams:
            return sample[:-len(suffix)]
    return None


def phase_stats(samples: list) -> dict:
    """``relay_phase_seconds`` → {(engine, phase): [count, sum]}."""
    out: dict = {}
    for name, labels, v in samples:
        if name in ("relay_phase_seconds_count", "relay_phase_seconds_sum"):
            cell = out.setdefault((labels["engine"], labels["phase"]),
                                  [0, 0.0])
            cell[0 if name.endswith("_count") else 1] = v
    return out


def sample_value(samples: list, name: str, **labels) -> float:
    """The sum of the samples named ``name`` whose labels include
    ``labels``."""
    return sum(v for n, lab, v in samples
               if n == name and all(lab.get(k) == x
                                    for k, x in labels.items()))


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unexpected wire type {wire}")
        yield num, wire, v


def pprof_summary(blob: bytes) -> dict:
    """The gzipped pprof ``Profile`` → its string table, sample count and
    the summed values of its samples (count, ns)."""
    raw = gzip.decompress(blob)
    strings, samples, totals = [], 0, [0, 0]
    for num, _wire, v in _fields(raw):
        if num == 6:
            strings.append(v.decode())
        elif num == 2:
            samples += 1
            for snum, swire, sv in _fields(v):
                if snum == 2:               # packed values
                    vals, j = [], 0
                    while j < len(sv):
                        x, j = _varint(sv, j)
                        vals.append(x)
                    totals = [a + b for a, b in zip(totals, vals)]
    return {"strings": strings, "samples": samples, "span_count": totals[0],
            "span_ns": totals[1]}
