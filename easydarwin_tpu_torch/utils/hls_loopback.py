"""End-to-end check of HLS with the H.264 requant ladder over loopback.

``hls_play`` pushes ``HlsSource``s to a running server, each over one
interleaved TCP connection (ANNOUNCE → SETUP → RECORD): all-intra H.264
made by the port's ``encode_iframe`` from a seed (CAVLC or CABAC, one or
three slices a picture, 4:2:0 chroma), a few pictures a source encoded
once and cycled as GOPs of ``gop`` pictures (the first an IDR, the rest
non-IDR I pictures), FU-A packetized at MTU 1,400, and for an audio
source an AAC track (``utils.synth.aac_packet``) on channels 2-3.  Each
source gets REST ``starthls`` with the requant rungs (``q6,q12``); some
also get a ``master.m3u8`` GET (``master`` single-slice sources), which
adds the temporal rungs ``r1`` and ``r2``.  When every rendition has its
segments the harness fetches every playlist, ``init.mp4`` and segment,
revalidates one playlist with ``If-None-Match`` (a 304), and checks:

* every sample of the source rendition is the pushed picture of its RTP
  timestamp, NAL for NAL;
* every q-rung sample equals the host scalar oracle's output for the
  pushed NALs (``SliceRequantizer(delta)`` on the CPU, computed before
  the run in worker processes);
* ``r2`` carries exactly the IDR pictures, ``r1`` every IDR and fewer
  pictures than the source (whole pictures, as every sample is checked);
* a segment has one ``traf`` (video) or, for an audio source, two
  (video, then AAC: the frames that arrived since the last cut), and
  every rendition of an audio source has segments with both;
* ``gethlsstreams`` lists every path with no passed-through slice and no
  shed AU.

``serve_hls`` runs it against ``python -m easydarwin_tpu_torch`` and
adds the server's exit stats: device errors, shed AUs and reassembly
mismatches must be 0, and with the ladders on a card the B6 launches
must equal their dispatches (none with ``hls_device="cpu"``, where B6
runs the plain torch chains).  Any failure raises ``AssertionError``.
"""

from __future__ import annotations

import asyncio
import multiprocessing
import re
import struct
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..protocol import nalu, rtp
from .loopback import (AV_SDP, TIER_COUNTERS, VIDEO_SDP, CliServer,
                       MiniClient, check, http_get_json)
from .synth import aac_packet

#: media time of one pushed picture (90 kHz): one second, so a GOP of 3
#: is 3 s and the segmenter's 2 s target cuts one segment a GOP
FRAME_TICKS = 90_000
#: AAC frames a second at 48 kHz (1,024 samples each)
AAC_TICKS = 1024
AAC_RATE = 48_000
AAC_DRAIN_RATE = 2
PICTURE_QP = 26


@dataclass(frozen=True)
class HlsSource:
    index: int
    entropy: str            # "cavlc" | "cabac"
    slices: int
    audio: bool

    @property
    def path(self) -> str:
        return f"/live/hls{self.index}"


def config5_sources(n: int = 16) -> list[HlsSource]:
    """BASELINE config 5's sources: half CAVLC, half CABAC; a quarter of
    them with 3 slices a picture and another quarter with an AAC track,
    each quarter split evenly between the entropy layers."""
    return [HlsSource(i, "cavlc" if i % 2 == 0 else "cabac",
                      3 if i % 8 in (1, 2) else 1, i % 8 in (3, 4))
            for i in range(n)]


def _planes(rng: np.random.Generator, width: int, height: int, k: int):
    """One seeded 4:2:0 picture: drifting sinusoids plus noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    a, b = rng.uniform(5, 12, 2)
    luma = (128 + 50 * np.sin(xx / a + k / 2) + 40 * np.cos(yy / b - k / 3)
            + rng.normal(0, 4, xx.shape))
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    cb = 128 + 30 * np.sin(cx / 11 + k) + rng.normal(0, 2, cx.shape)
    cr = 128 + 30 * np.cos(cy / 13 - k) + rng.normal(0, 2, cx.shape)
    return [np.clip(np.round(p), 0, 255).astype(np.uint8)
            for p in (luma, cb, cr)]


def encode_source(seed: int, src: HlsSource, width: int, height: int,
                  pictures: int, deltas: tuple[int, ...]) -> dict:
    """One source's pictures and their oracle: ``sps``/``pps``, the slice
    NALs of each picture (picture 0 an IDR, the others non-IDR I
    pictures with frame_num k and POC 2k) and ``oracle[delta][k]``, the
    host scalar requant of picture k's slices.  Runs in a worker
    process (numpy and the port's codecs only)."""
    from ..codecs import h264_requant as rq
    from ..codecs.h264_intra import Pps, Sps, encode_iframe
    rng = np.random.default_rng([seed, src.index])
    pics, sps_nal, pps_nal = [], None, None
    for k in range(pictures):
        y, cb, cr = _planes(rng, width, height, k)
        nals = encode_iframe(y, PICTURE_QP, cb=cb, cr=cr,
                             slices=src.slices, entropy=src.entropy)
        sps_nal, pps_nal = nals[0], nals[1]
        slices = nals[2:]
        if k:
            sps, pps = Sps.parse(sps_nal), Pps.parse(pps_nal)
            slices = [as_non_idr(n, sps, pps, k) for n in slices]
        pics.append(slices)
    oracle = {}
    for d in deltas:
        eng = rq.SliceRequantizer(d)
        eng.transform_nal(sps_nal)
        eng.transform_nal(pps_nal)
        oracle[d] = [[eng.transform_nal(n) for n in p] for p in pics]
        check(eng.stats.slices_passed_through == 0,
              f"source {src.index}: the oracle passed slices through")
    return {"sps": sps_nal, "pps": pps_nal, "pictures": pics,
            "oracle": oracle}


def as_non_idr(nal: bytes, sps, pps, k: int) -> bytes:
    """An IDR slice rewritten as the non-IDR I slice of picture ``k`` of
    its GOP (nal_unit_type 1, frame_num k, POC 2k, no reference marking
    change): a new slice header before the same macroblock layer, bit for
    bit (CAVLC: the bits up to the stop bit, then new trailing bits;
    CABAC: alignment ones, then the same arithmetic-coded bytes).  No
    macroblock is decoded, so a 1080p picture takes milliseconds."""
    from ..codecs.h264_bits import BitReader, BitWriter, nal_to_rbsp, \
        rbsp_to_nal
    from ..codecs.h264_intra import SliceCodec
    rbsp = nal_to_rbsp(nal[1:])
    br = BitReader(rbsp)
    codec = SliceCodec(sps, pps)
    hdr = codec.parse_slice_header(br, nal[0])
    hdr.nal_type = 1
    hdr.frame_num = k % (1 << sps.log2_max_frame_num)
    hdr.poc_lsb = (2 * k) % (1 << sps.log2_max_poc_lsb)
    hdr.adaptive_marking = None
    bw = BitWriter()
    codec.write_slice_header(bw, hdr, hdr.qp)
    if pps.entropy_cabac:
        while bw.bit_length % 8:
            bw.write_bit(1)              # cabac_alignment_one_bit
        body = bw.to_bytes() + rbsp[(br.pos + 7) // 8:]
    else:
        whole = int.from_bytes(rbsp, "big")
        stop = len(rbsp) * 8 - 1 - ((whole & -whole).bit_length() - 1)
        n = stop - br.pos                # macroblock bits before the stop
        bits = (whole >> (len(rbsp) * 8 - stop)) & ((1 << n) - 1)
        head = bw.bit_length
        bw.write_bits(0, -head % 8)
        hv = int.from_bytes(bw.to_bytes(), "big") >> (-head % 8)
        pad = -(head + n + 1) % 8
        value = ((((hv << n) | bits) << 1) | 1) << pad
        body = value.to_bytes((head + n + 1 + pad) // 8, "big")
    return bytes([(nal[0] & 0x60) | 1]) + rbsp_to_nal(body)


def encode_picture(seed: int, entropy: str, slices: int, width: int,
                   height: int, j: int) -> list[bytes]:
    """Picture ``j`` of one entropy mode and slice count as SPS, PPS and
    its IDR slice NALs.  Runs in a worker process."""
    from ..codecs.h264_intra import encode_iframe
    rng = np.random.default_rng([seed, slices, entropy == "cabac", j])
    y, cb, cr = _planes(rng, width, height, j)
    return encode_iframe(y, PICTURE_QP, cb=cb, cr=cr, slices=slices,
                         entropy=entropy)


def prepare_shared(sources: list[HlsSource], seed: int, *, width: int,
                   height: int, gop: int, distinct: int,
                   deltas: tuple[int, ...], workers: int) -> list[dict]:
    """``encode_source``'s result for every source from ``distinct``
    pictures a kind (entropy mode and slice count), each encoded once on
    ``workers`` spawned processes and shared by the sources of its kind;
    a GOP's picture k is distinct picture ``k % distinct``, rewritten as a
    non-IDR picture when k > 0.  The oracle is the native fused walk
    (``native.h264_requant_slice``) on each slice.  For sizes whose
    CPython encode takes seconds a picture."""
    from .. import native
    from ..codecs import h264_requant as rq
    from ..codecs.h264_intra import Pps, Sps
    kinds = sorted({(s.entropy, s.slices) for s in sources})
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = {(kind, j): ex.submit(encode_picture, seed, *kind, width,
                                     height, j)
                for kind in kinds for j in range(distinct)}
        coded = {key: f.result() for key, f in futs.items()}
    by_kind = {}
    for kind in kinds:
        sps_nal, pps_nal = coded[(kind, 0)][:2]
        sps, pps = Sps.parse(sps_nal), Pps.parse(pps_nal)
        pics = []
        for k in range(gop):
            nals = coded[(kind, k % distinct)]
            check(nals[:2] == [sps_nal, pps_nal],
                  f"{kind}: pictures with different parameter sets")
            pics.append([as_non_idr(n, sps, pps, k) if k else n
                         for n in nals[2:]])
        oracle = {}
        for d in deltas:
            oracle[d] = []
            for p in pics:
                outs = [native.h264_requant_slice(n, delta_qp=d,
                                                  **rq._walk_args(sps, pps))
                        for n in p]
                check(all(o is not None for o in outs),
                      f"{kind}: the fused walk refused a slice at +{d}")
                oracle[d].append([o[0] for o in outs])
        by_kind[kind] = {"sps": sps_nal, "pps": pps_nal, "pictures": pics,
                         "oracle": oracle}
    return [by_kind[(s.entropy, s.slices)] for s in sources]


def prepare_sources(sources: list[HlsSource], seed: int, *, width: int,
                    height: int, pictures: int, deltas: tuple[int, ...],
                    workers: int) -> list[dict]:
    """``encode_source`` for every source on ``workers`` spawned
    processes."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = [ex.submit(encode_source, seed, s, width, height, pictures,
                          deltas) for s in sources]
        return [f.result() for f in futs]


# ------------------------------------------------------------ HTTP and fMP4
async def http_get(port: int, target: str, headers: dict | None = None
                   ) -> tuple[int, dict, bytes]:
    """One GET → (status, lower-cased headers, body bytes)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(f"GET {target} HTTP/1.1\r\nHost: 127.0.0.1\r\n{extra}"
                     "\r\n".encode())
        head = (await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30)
                ).decode("latin-1")
        lines = head.split("\r\n")
        hdrs = {}
        for ln in lines[1:]:
            k, sep, v = ln.partition(":")
            if sep:
                hdrs[k.strip().lower()] = v.strip()
        n = int(hdrs.get("content-length", "0"))
        body = await asyncio.wait_for(reader.readexactly(n), 30) if n else b""
        return int(lines[0].split()[1]), hdrs, body
    finally:
        writer.close()


def _boxes(data: bytes, start: int = 0, end: int | None = None):
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        check(size >= 8 and pos + size <= end, f"bad box at {pos}")
        yield kind, pos, size
        pos += size


def segment_samples(data: bytes) -> tuple[dict, int]:
    """A media segment → ``({track_id: [(dts, sample bytes, sync)]},
    traf count)``."""
    kinds = [k for k, _, _ in _boxes(data)]
    check(kinds == [b"styp", b"moof", b"mdat"], f"segment boxes {kinds}")
    (_, moof, msize), = [b for b in _boxes(data) if b[0] == b"moof"]
    tracks, trafs = {}, 0
    for kind, pos, size in _boxes(data, moof + 8, moof + msize):
        if kind != b"traf":
            continue
        trafs += 1
        tid = dts = None
        samples = []
        for k2, p2, _s2 in _boxes(data, pos + 8, pos + size):
            if k2 == b"tfhd":
                tid = struct.unpack_from(">I", data, p2 + 12)[0]
            elif k2 == b"tfdt":
                dts = struct.unpack_from(">Q", data, p2 + 12)[0]
            elif k2 == b"trun":
                n, off = struct.unpack_from(">Ii", data, p2 + 12)
                at = moof + off
                for i in range(n):
                    dur, sz, fl = struct.unpack_from(">III", data,
                                                     p2 + 20 + 12 * i)
                    samples.append((dts, data[at:at + sz],
                                    fl == 0x02000000))
                    at += sz
                    dts += dur
        tracks[tid] = samples
    return tracks, trafs


def stap_a(*nals: bytes, seq: int, timestamp: int, ssrc: int) -> bytes:
    """One RTP packet aggregating ``nals`` (RFC 6184 STAP-A)."""
    payload = bytes((max(n[0] & 0x60 for n in nals) | nalu.NAL_STAP_A,))
    for n in nals:
        payload += struct.pack(">H", len(n)) + n
    return rtp.RtpPacket(payload_type=96, seq=seq, timestamp=timestamp,
                         ssrc=ssrc, payload=payload).to_bytes()


def avcc_nals(sample: bytes) -> list[bytes]:
    out, pos = [], 0
    while pos < len(sample):
        n = struct.unpack_from(">I", sample, pos)[0]
        out.append(sample[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def _body(doc: dict) -> dict:
    return doc["EasyDarwin"]["Body"]


# ------------------------------------------------------------ the harness
async def hls_play(rtsp_port: int, rest_port: int, sources: list[HlsSource],
                   prepared: list[dict], rng: np.random.Generator, *,
                   frames: int, fps: float, gop: int = 3,
                   deltas: tuple[int, ...] = (6, 12),
                   master: int = 4, deadline_s: float = 120.0,
                   allow_shed: bool = False) -> dict:
    """Push ``frames`` pictures of each source at ``fps`` a second (media
    time ``FRAME_TICKS`` a picture), with the HLS entries started before
    the first picture, and check everything of the module docstring once
    every rendition holds the segments of its first ``frames // gop``
    GOPs.  Audio sources keep pushing AAC until then.  With
    ``allow_shed`` a ladder may shed AUs: a q-rung then waits only for
    its ladder to drain, and its samples must be pushed pictures in
    order, each equal to its oracle, with none past the source's."""
    base = f"rtsp://127.0.0.1:{rtsp_port}"
    ts0 = [int(t) for t in rng.integers(0, 1 << 32, len(sources))]
    seq0 = [int(s) for s in rng.integers(0, 1 << 16, len(sources))]
    pushers = []
    for src in sources:
        p = MiniClient()
        await p.connect(rtsp_port)
        uri = base + src.path
        await p.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                        (AV_SDP if src.audio else VIDEO_SDP).encode())
        for tid in ((1, 2) if src.audio else (1,)):
            await p.request("SETUP", f"{uri}/trackID={tid}", {
                "transport": f"RTP/AVP/TCP;unicast;interleaved={2 * tid - 2}"
                             f"-{2 * tid - 1};mode=record"})
        await p.request("RECORD", uri)
        pushers.append(p)
    rungs = ",".join(f"q{d}" for d in deltas)
    for src in sources:
        status, doc = await http_get_json(
            rest_port, f"/api/v1/starthls?path={src.path}&rungs={rungs}")
        check(status == 200 and _body(doc)["Master"]
              == f"/hls{src.path}/master.m3u8", f"starthls -> {status} {doc}")
    names = {i: ["", *(f"q{d}" for d in deltas)] for i in range(len(sources))}
    # master.m3u8 (and so the temporal rungs) on single-slice sources: the
    # relay's thinning counts every NAL start as a frame start, so at
    # level 1 it would drop single slices of a multi-slice picture
    for i in [i for i, s in enumerate(sources) if s.slices == 1][:master]:
        status, _h, body = await http_get(
            rest_port, f"/hls{sources[i].path}/master.m3u8")
        check(status == 200, f"master.m3u8 of {sources[i].path} -> {status}")
        names[i] = ["", "r1", "r2", *(f"q{d}" for d in deltas)]
        listed = re.findall(r"^(?:(\w+)/)?index\.m3u8$", body.decode(), re.M)
        check(sorted(listed) == sorted(names[i]),
              f"master of {sources[i].path} lists {listed}")

    # push: pictures at fps, AAC in real time for the audio sources
    seqs = list(seq0)
    aseq = [0] * len(sources)
    audio_sent = [0] * len(sources)
    t_start = time.monotonic()

    def push_picture(i: int, k: int) -> None:
        pre = prepared[i]
        nals = pre["pictures"][k % gop]
        ts = (ts0[i] + k * FRAME_TICKS) & 0xFFFFFFFF
        if k % gop == 0:
            # SPS and PPS in one STAP-A ahead of the IDR, as cameras send
            # them: a packet the relay classifies as a GOP head
            pushers[i].push(stap_a(pre["sps"], pre["pps"], seq=seqs[i],
                                   timestamp=ts, ssrc=0x5000 + i), 0)
            seqs[i] = (seqs[i] + 1) & 0xFFFF
        for j, nal in enumerate(nals):
            for pkt in nalu.packetize_h264(nal, seq=seqs[i], timestamp=ts,
                                           ssrc=0x5000 + i,
                                           marker_on_last=j == len(nals) - 1):
                pushers[i].push(pkt, 0)
                seqs[i] = (seqs[i] + 1) & 0xFFFF

    def push_audio(due: int) -> None:
        """AAC frames up to ``due`` for every audio source."""
        for i, src in enumerate(sources):
            while src.audio and audio_sent[i] < due:
                ts = (ts0[i] + audio_sent[i] * AAC_TICKS) & 0xFFFFFFFF
                pushers[i].push(aac_packet(rng, aseq[i], ts,
                                           ssrc=0xA000 + i), 2)
                aseq[i] = (aseq[i] + 1) & 0xFFFF
                audio_sent[i] += 1

    # audio follows the video's media time while pictures are pushed, then
    # runs on at AAC_DRAIN_RATE times real time, so segments cut while
    # the ladders drain hold audio too
    for k in range(frames):
        for i in range(len(sources)):
            push_picture(i, k)
        push_audio(int((k + 1) * FRAME_TICKS / 90_000 * AAC_RATE
                       / AAC_TICKS))
        while time.monotonic() < t_start + (k + 1) / fps:
            await asyncio.sleep(0.02)
    t_pushed = time.monotonic()
    # an output attached before the push fast-starts at the relay's
    # newest keyframe packet, which may be the first IDR slice, past its
    # SPS and PPS: the segmenter then starts at the second GOP.  Done:
    # every ladder drained and every rendition of a source cut as many
    # segments, at least the GOPs after the first one less the last
    want_segs = (frames - 1) // gop - 1
    check(want_segs >= 1, "push at least three GOPs and an IDR after them")
    deadline = time.monotonic() + deadline_s
    streams = []
    t_drain = time.monotonic()
    pushed_aac = max(audio_sent)
    while True:
        push_audio(pushed_aac + int((time.monotonic() - t_drain)
                                    * AAC_DRAIN_RATE * AAC_RATE / AAC_TICKS))
        status, doc = await http_get_json(rest_port,
                                          "/api/v1/gethlsstreams")
        streams = _body(doc)["Streams"]

        def done(r, s):
            if allow_shed and r["name"].startswith("q"):
                return r["segments"] >= 1 and r["pending_units"] == 0
            return (r["segments"] >= want_segs
                    and r.get("pending_units", 0) == 0
                    and (allow_shed or len({q["segments"] for q
                                            in s["renditions"]}) == 1))
        if all(done(r, s) for s in streams for r in s["renditions"]):
            break
        check(time.monotonic() < deadline,
              f"renditions did not reach {want_segs} segments: {streams}")
        await asyncio.sleep(0.2)
    t_done = time.monotonic()
    check(sorted(s["path"] for s in streams)
          == sorted(s.path for s in sources),
          f"gethlsstreams lists {[s['path'] for s in streams]}")
    for s in streams:
        for r in s["renditions"]:
            if r["name"].startswith("q"):
                check(r["passed_through_slices"] == 0
                      and (allow_shed or r["shed_units"] == 0)
                      and r["requantized_slices"] > 0,
                      f"{s['path']} {r['name']}: {r}")

    # fetch and check every rendition
    res = {"sources": len(sources), "frames": frames, "gop": gop,
           "segments": 0, "av_segments": 0, "bytes": {}, "video_bytes": {},
           "samples": 0,
           "audio_samples": 0,
           "push_s": t_pushed - t_start, "drain_s": t_done - t_pushed}
    etag_probe = None
    for i, src in enumerate(sources):
        pre = prepared[i]
        for name in names[i]:
            base_url = f"/hls{src.path}/" + (f"{name}/" if name else "")
            status, hdrs, pl = await http_get(rest_port,
                                              base_url + "index.m3u8")
            check(status == 200 and b"#EXT-X-MAP" in pl,
                  f"{base_url}index.m3u8 -> {status}")
            if etag_probe is None:
                etag_probe = (base_url + "index.m3u8", hdrs["etag"])
            status, _h, init = await http_get(rest_port, base_url
                                              + "init.mp4")
            check(status == 200 and init[4:8] == b"ftyp",
                  f"{base_url}init.mp4 -> {status}")
            check((init.count(b"mp4a") > 0) == src.audio,
                  f"{base_url}init.mp4: audio track {src.audio} expected")
            segs = re.findall(r"^seg(\d+)\.m4s$", pl.decode(), re.M)
            shed_ok = allow_shed and name.startswith("q")
            check(len(segs) >= (1 if shed_ok else want_segs),
                  f"{base_url}: {len(segs)} segments")
            got_frames = []
            av_segs = 0
            for seq in segs:
                status, _h, seg = await http_get(rest_port,
                                                 f"{base_url}seg{seq}.m4s")
                check(status == 200, f"{base_url}seg{seq}.m4s -> {status}")
                tracks, trafs = segment_samples(seg)
                res["segments"] += 1
                res["bytes"][name] = res["bytes"].get(name, 0) + len(seg)
                check(sorted(tracks) in ([1], [1, 2]) and trafs
                      == len(tracks) and (src.audio or trafs == 1),
                      f"{base_url}seg{seq}: tracks {sorted(tracks)}")
                if trafs == 2:
                    # the segmenter muxes the AAC frames that arrived
                    # since the last cut: one cut right after another
                    # (a burst of pictures in one wake) may hold none
                    av_segs += 1
                    res["av_segments"] += 1
                    res["audio_samples"] += len(tracks[2])
                for dts, sample, sync in tracks[1]:
                    rel = (dts - ts0[i]) & 0xFFFFFFFF
                    check(rel % FRAME_TICKS == 0 and rel // FRAME_TICKS
                          < frames, f"{base_url}: sample at {dts} pairs "
                          "with no pushed picture")
                    k = rel // FRAME_TICKS
                    if name.startswith("q"):
                        want = pre["oracle"][int(name[1:])][k % gop]
                    else:
                        want = pre["pictures"][k % gop]
                    check(avcc_nals(sample) == want,
                          f"{base_url} frame {k}: NALs differ from the "
                          + ("oracle" if name.startswith("q") else "push"))
                    check(sync == (k % gop == 0),
                          f"{base_url} frame {k}: sync flag {sync}")
                    got_frames.append(k)
                    res["samples"] += 1
                    res["video_bytes"][name] = (
                        res["video_bytes"].get(name, 0) + len(sample))
            check(av_segs > 0 or not src.audio,
                  f"{base_url}: no segment carries the AAC track")
            if shed_ok:
                # a shed AU is missing from its rung: the rest in order
                check(got_frames == sorted(set(got_frames)) and got_frames[0]
                      % gop == 0, f"{base_url}: frames {got_frames}")
                continue
            check(got_frames and got_frames[0] in (0, gop),
                  f"{base_url}: segments start at frame {got_frames[:1]}")
            span = range(got_frames[0], got_frames[-1] + 1)
            idrs = [k for k in span if k % gop == 0]
            if name == "r1":
                # level 1 drops every second frame start that is not a
                # keyframe's (the count runs over the output's packets)
                check(set(idrs) <= set(got_frames)
                      and len(got_frames) < len(span),
                      f"{base_url}: frames {got_frames} are not a level-1 "
                      f"thinning of {list(span)}")
            else:
                want_frames = idrs if name == "r2" else list(span)
                check(got_frames == want_frames, f"{base_url}: frames "
                      f"{got_frames}, expected {want_frames}")
    # one revalidation: the playlist's current ETag answers 304, no body
    target, etag = etag_probe
    status, hdrs, body = await http_get(rest_port, target,
                                        {"If-None-Match": etag})
    check(status == 304 and body == b"" and hdrs.get("etag") == etag,
          f"revalidation of {target} -> {status} ({len(body)} bytes)")
    status, _h, _b = await http_get(rest_port, target, {"If-None-Match":
                                                        '"stale"'})
    check(status == 200, f"a stale ETag of {target} -> {status}")
    res["revalidated"] = target
    res["streams"] = streams
    for p in pushers:
        await p.close()
    return res


async def serve_hls(device: str, rng: np.random.Generator, *,
                    sources: list[HlsSource], width: int, height: int,
                    frames: int, fps: float, seed: int, gop: int = 3,
                    deltas: tuple[int, ...] = (6, 12),
                    master: int = 4, workers: int = 4,
                    deadline_s: float = 120.0,
                    hls_device: str | None = None,
                    prepared: list[dict] | None = None,
                    allow_shed: bool = False) -> dict:
    """Prepare the sources (``prepare_sources``, unless ``prepared`` is
    given), run ``hls_play`` against the CLI server on ``device`` (its
    requant rungs on ``hls_device``, default ``device``) and check its
    exit stats; shed AUs are an error unless ``allow_shed``."""
    t0 = time.monotonic()
    if prepared is None:
        prepared = prepare_sources(sources, seed, width=width, height=height,
                                   pictures=gop, deltas=deltas,
                                   workers=workers)
    prep_s = time.monotonic() - t0
    args = () if hls_device is None else ("--hls-device", hls_device)
    async with CliServer(device, *args) as srv:
        res = await hls_play(srv.rtsp_port, srv.rest_port, sources,
                             prepared, rng, frames=frames, fps=fps, gop=gop,
                             deltas=deltas, master=master,
                             deadline_s=deadline_s, allow_shed=allow_shed)
        stats = await srv.stop(counters=TIER_COUNTERS)
    hls = stats["hls"]
    check(hls["device_errors"] == 0, f"B6 device errors: {hls}")
    check(allow_shed or hls["shed"] == 0, f"shed AUs: {hls}")
    check(hls["mismatches"] == 0, f"reassembly mismatches: {hls}")
    # the pushers left before the stop: a maintenance sweep in between
    # retires their entries, so every path is either live or retired
    check(hls["paths"] + hls["paths_retired"] == len(sources),
          f"HLS paths at exit: {hls}")
    check(hls["dispatches"] + hls["no_ps_aus"] == hls["aus"] > 0,
          f"ladder dispatches vs AUs: {hls}")
    # every requantized slice went through the native walk's write
    for s in res["streams"]:
        for r in s["renditions"]:
            if r["name"].startswith("q"):
                check(r["native_slices"] == r["requantized_slices"],
                      f"{s['path']} {r['name']}: slices off the walk {r}")
    check(stats["hls_not_modified"] >= 1, "no 304 counted")
    launches = stats["kernel_launches"]
    if (hls_device or device) != "cuda":
        check(launches["ed_h264_requant"]
              == launches["ed_h264_requant_chroma"] == 0,
              f"B6 launched with the ladder on the CPU: {launches}")
    elif device == "cuda":
        check(launches["ed_h264_requant"] == hls["dispatches"],
              f"ed_h264_requant launches {launches['ed_h264_requant']} != "
              f"dispatches {hls['dispatches']}")
        check(launches["ed_h264_requant_chroma"]
              == hls["dispatches_chroma"],
              f"ed_h264_requant_chroma launches "
              f"{launches['ed_h264_requant_chroma']} != dispatches with "
              f"chroma {hls['dispatches_chroma']}")
    res.update(prepare_s=prep_s, width=width, height=height, fps=fps,
               server_stats=stats)
    return res

