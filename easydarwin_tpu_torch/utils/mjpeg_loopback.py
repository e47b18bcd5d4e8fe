"""End-to-end check of the live MJPEG transcode ladder over loopback.

``ladder_play`` plays one MJPEG pusher (ANNOUNCE → SETUP record → RECORD),
starts a ladder over HTTP (``GET /api/v1/starttranscode``), PLAYs every
rung with its own interleaved TCP player, pushes paced RTP/JPEG frames
made from a seed, and reassembles what each player receives with the
port's ``JpegDepacketizer``.  Every delivered rung frame is entropy-decoded
with ``protocol.jpeg_entropy`` and its levels held against the CPU
requantization oracle for the source frame it came from (paired by RTP
timestamp, not by count; the worker drops frames when it is behind).  Then
``gettranscodes`` and ``stoptranscode``.  Any failure raises
``AssertionError``.

``serve_mjpeg_ladder`` runs it against ``python -m easydarwin_tpu_torch``
on free ports and checks the server's exit stats.
"""

from __future__ import annotations

import asyncio
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models import mjpeg_ladder as ml
from ..ops import transform as tf
from ..protocol import jpeg_entropy as je
from ..protocol import mjpeg
from .loopback import CliServer, MiniClient, check, http_get_json

MJPEG_SDP = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=mjpeg\r\n"
             "c=IN IP4 0.0.0.0\r\nt=0 0\r\na=control:*\r\n"
             "m=video 0 RTP/AVP 26\r\na=rtpmap:26 JPEG/90000\r\n"
             "a=control:trackID=1\r\n")
#: RTP/JPEG clock
CLOCK_HZ = 90_000
#: first source timestamp and seq: both wrap during a run
TS0 = 0xFFFFC000
SEQ0 = 0xFFF0


@dataclass
class SourceFrame:
    levels: list[np.ndarray]        # [Y, Cb, Cr] zigzag int16
    packets: list[bytes]


def _blocks(plane: np.ndarray, sub: int) -> np.ndarray:
    """A plane → its 8×8 blocks in 4:2:0 MCU order: ``sub`` = 2 for luma
    (the 4 blocks of each 16×16 MCU in raster order), 1 for chroma."""
    h, w = plane.shape
    gh, gw = h // (8 * sub), w // (8 * sub)
    b = plane.reshape(gh, sub, 8, gw, sub, 8).transpose(0, 3, 1, 4, 2, 5)
    return b.reshape(-1, 64)


def frame_levels(rng: np.random.Generator, width: int, height: int,
                 q: int, index: int) -> list[np.ndarray]:
    """One 4:2:0 frame of smooth moving gradients plus noise, DCT'd and
    quantized with the RTP/JPEG tables of quality ``q`` → zigzag levels
    ``[Y, Cb, Cr]`` (int16)."""
    if width % 16 or height % 16:
        raise ValueError("frame dims must be multiples of 16")
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    luma = (128 + 80 * np.sin(2 * np.pi * (xx + 6 * index) / width)
            * np.cos(np.pi * yy / height) + rng.normal(0, 6, xx.shape))
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    cb = 128 + 50 * (cx / width - 0.5) + rng.normal(0, 3, cx.shape)
    cr = 128 + 50 * (cy / height - 0.5) + rng.normal(0, 3, cx.shape)
    qt = mjpeg.make_qtables(q)
    out = []
    for plane, sub, qz in ((luma, 2, qt[:64]), (cb, 1, qt[64:]),
                           (cr, 1, qt[64:])):
        pix = np.clip(np.round(plane), 0, 255).astype(np.uint8)
        q_nat = tf.from_zigzag_np(np.frombuffer(qz, np.uint8)
                                  .astype(np.float32))
        lv = tf.encode_blocks(torch.from_numpy(_blocks(pix, sub)),
                              torch.from_numpy(q_nat)).numpy()
        out.append(np.clip(tf.to_zigzag_np(lv), -1023, 1023)
                   .astype(np.int16))
    return out


def make_frames(rng: np.random.Generator, *, width: int, height: int,
                n: int, q: int, fps: int, ssrc: int = 0x4D4A5047
                ) -> list[SourceFrame]:
    frames, seq = [], SEQ0
    for k in range(n):
        levels = frame_levels(rng, width, height, q, k)
        ts = (TS0 + k * (CLOCK_HZ // fps)) & 0xFFFFFFFF
        pkts = mjpeg.packetize_jpeg(je.encode_scan(levels, 1), width=width,
                                    height=height, seq=seq, timestamp=ts,
                                    ssrc=ssrc, type_=1, q=q)
        seq = (seq + len(pkts)) & 0xFFFF
        frames.append(SourceFrame(levels, pkts))
    return frames


def rung_oracle(levels: list[np.ndarray], width: int, height: int,
                q_src: int, q: int, scale: int):
    """The rung's levels for one source frame, by the port's CPU
    ``requantize`` / ``requantize_downscale2x`` → ([Y, Cb, Cr], w, h)."""
    cpu = torch.device("cpu")
    qt_in, qt_out = mjpeg.make_qtables(q_src), mjpeg.make_qtables(q)
    qy_in, qc_in, qy, qc = (np.frombuffer(b, np.uint8).astype(np.int32)
                            for b in (qt_in[:64], qt_in[64:], qt_out[:64],
                                      qt_out[64:]))
    y32 = levels[0].astype(np.int32)
    chroma32 = np.concatenate(levels[1:]).astype(np.int32)
    n = len(levels[1])
    if scale == 1:
        y2 = ml.requantize_rung(y32, qy_in, qy, cpu)
        c2 = ml.requantize_rung(chroma32, qc_in, qc, cpu)
        w2, h2 = width, height
    else:
        quads = ml.frame_quads(1, width, height, y32, chroma32, n)
        y2, c2, n, w2, h2 = ml.downscale_rung(qy, qc, quads, qy_in, qc_in,
                                              width, height, cpu)
    return [y2, c2[:n], c2[n:]], w2, h2


def _body(doc: dict) -> dict:
    return doc["EasyDarwin"]["Body"]


async def ladder_play(rtsp_port: int, rest_port: int,
                      rng: np.random.Generator, *, width: int, height: int,
                      n_frames: int, fps: int = 10,
                      rungs: tuple[str, ...] = ("40", "20s2"),
                      q_src: int = 80, deadline_s: float = 60.0,
                      path: str = "/cam") -> dict:
    frames = make_frames(rng, width=width, height=height, n=n_frames,
                         q=q_src, fps=fps)
    ticks = CLOCK_HZ // fps
    specs = [ml.parse_rung(r) for r in rungs]
    rung_paths = [path + ml.rung_suffix(q, s) for q, s in specs]
    base = f"rtsp://127.0.0.1:{rtsp_port}"
    pusher = MiniClient()
    await pusher.connect(rtsp_port)
    await pusher.request("ANNOUNCE", base + path,
                         {"content-type": "application/sdp"},
                         MJPEG_SDP.encode())
    await pusher.request("SETUP", base + path + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await pusher.request("RECORD", base + path)
    # the ladder and the rung players attach before the first frame, so
    # the ladder's rewrite rebases on frame 0 and each player's on the
    # first rung frame, which is frame 0's (the worker never drops the
    # first frame): a rung timestamp minus the player's RTP-Info rtptime
    # is k·ticks for source frame k
    status, doc = await http_get_json(
        rest_port, f"/api/v1/starttranscode?path={path}&rungs={','.join(rungs)}")
    check(status == 200, f"starttranscode -> {status} {doc}")
    check(_body(doc)["Rungs"] == rung_paths, f"rungs {_body(doc)}")
    players = []
    for rp in rung_paths:
        p = MiniClient()
        await p.connect(rtsp_port)
        await p.request("DESCRIBE", base + rp)
        await p.request("SETUP", base + rp + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
        resp = await p.request("PLAY", base + rp)
        rtptime = int(re.search(r"rtptime=(\d+)",
                                resp.headers["rtp-info"]).group(1))
        players.append((p, rtptime))
    for fr in frames:
        for pkt in fr.packets:
            pusher.push(pkt)
        await asyncio.sleep(1 / fps)
    # wait until every frame was transcoded or dropped and every player
    # holds each transcoded frame
    deadline = time.monotonic() + deadline_s
    lad = None
    while time.monotonic() < deadline:
        status, doc = await http_get_json(rest_port, "/api/v1/gettranscodes")
        (lad,) = _body(doc)["Transcodes"]
        done = lad["frames_in"] + lad["frames_dropped"] == n_frames
        delivered = [r["frames"] for r in lad["rungs"]]
        received = [frames_of(p.frames) for p, _ in players]
        if (done and all(d == lad["frames_in"] for d in delivered)
                and [len(r) for r in received] == delivered):
            break
        await asyncio.sleep(0.1)
    check(lad is not None and lad["decode_errors"] == 0,
          f"ladder decode errors: {lad}")
    check(lad["frames_in"] + lad["frames_dropped"] == n_frames,
          f"frames in {lad['frames_in']} + dropped {lad['frames_dropped']} "
          f"!= pushed {n_frames}")
    check(lad["frames_in"] >= 1, "no frame was transcoded")
    res = {"frames_pushed": n_frames, "frames_in": lad["frames_in"],
           "frames_dropped": lad["frames_dropped"],
           "decode_errors": lad["decode_errors"],
           "width": width, "height": height,
           "host_ms_per_frame": {k: 1e3 * v / lad["frames_in"]
                                 for k, v in lad["seconds"].items()},
           "host_ms_last_frame": {k: 1e3 * v for k, v in
                                  lad["last_frame_seconds"].items()},
           "rungs": []}
    for (q, scale), rp, (p, rtptime), st in zip(specs, rung_paths, players,
                                                 lad["rungs"]):
        got = frames_of(p.frames)
        check(len(got) == st["frames"] == lad["frames_in"],
              f"{rp}: player has {len(got)} frames, ladder delivered "
              f"{st['frames']}, transcoded {lad['frames_in']}")
        worst, bad, total, seen = 0, 0, 0, []
        for hdr, scan, ts in got:
            rel = (ts - rtptime) & 0xFFFFFFFF
            check(rel % ticks == 0 and rel // ticks < n_frames,
                  f"{rp}: timestamp {ts} pairs with no source frame")
            k = rel // ticks
            seen.append(k)
            want, w2, h2 = rung_oracle(frames[k].levels, width, height,
                                       q_src, q, scale)
            check((hdr.width, hdr.height, hdr.q) == (w2, h2, q),
                  f"{rp} frame {k}: header {hdr}")
            out = je.decode_scan(scan, hdr.width, hdr.height, hdr.type)
            for a, b in zip(out, want):
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                worst = max(worst, int(d.max()) if d.size else 0)
                bad += int((d > 0).sum())
                total += d.size
        check(seen == sorted(set(seen)),
              f"{rp}: frames repeat or go backwards: {seen}")
        frac = bad / max(total, 1)
        if scale == 1:     # IEEE multiply, divide and round: bit-exact
            check(worst == 0, f"{rp}: levels differ from the oracle "
                  f"(max {worst})")
        else:              # fp32 product sums in another order
            check(worst <= 1 and frac < 0.01,
                  f"{rp}: levels off the oracle (max {worst}, {frac:.4%})")
        res["rungs"].append({"path": rp, "frames": len(got),
                             "source_frames": seen, "max_abs_err": worst,
                             "mismatch_frac": frac})
    status, doc = await http_get_json(
        rest_port, f"/api/v1/stoptranscode?path={path}")
    check(status == 200 and _body(doc)["Transcode"] == path,
          f"stoptranscode -> {status} {doc}")
    status, doc = await http_get_json(rest_port, "/api/v1/gettranscodes")
    check(_body(doc)["Transcodes"] == [], "ladder still listed after stop")
    for p, _ in players:
        await p.close()
    await pusher.close()
    return res


def frames_of(packets: list[bytes]) -> list:
    """Complete frames (header, scan, timestamp) in a packet list."""
    dep = mjpeg.JpegDepacketizer()
    out = []
    for pkt in packets:
        parts = dep.push_parts(pkt)
        if parts is not None:
            out.append(parts)
    return out


async def serve_mjpeg_ladder(device: str, rng: np.random.Generator,
                             **kw) -> dict:
    """``ladder_play`` against the CLI server on ``device``; adds the
    server's exit stats."""
    async with CliServer(device) as srv:
        res = await ladder_play(srv.rtsp_port, srv.rest_port, rng, **kw)
        res["server_stats"] = await srv.stop()
        return res
