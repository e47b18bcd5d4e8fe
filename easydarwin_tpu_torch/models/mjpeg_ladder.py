"""Live MJPEG bitrate ladder: one ingest → N lower-quality live rungs.

The served half of config 5.  RTP/JPEG (RFC 2435) frames are
depacketized, entropy-decoded to quantized DCT coefficients
(``protocol.jpeg_entropy``, host), **requantized on the device in one
batched op per rung and component** (``ops.transform.requantize``, or
``requantize_downscale2x`` for a half-resolution ``s2`` rung),
entropy-re-encoded, and re-packetized as derived live RTSP streams
``{path}@q{Q}[s2]`` that players PLAY through the normal relay fan-out.

The ladder is a ``RelayOutput`` tap on the source's video stream: the
fan-out engine hands it every packet, header-rewritten like any
subscriber's, through ``send_rewritten`` → ``send_bytes``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import transform as tf
from ..protocol import jpeg_entropy as je
from ..protocol import mjpeg
from ..protocol import sdp as sdp_mod
from ..relay.output import RelayOutput, WriteResult
from ..relay.session import SessionRegistry

#: host phases of one transcoded frame, in ``MjpegLadderOutput.seconds``
PHASES = ("entropy_decode", "device_requant", "entropy_encode")


def _rung_sdp(path: str) -> str:
    return ("v=0\r\no=- 0 0 IN IP4 0.0.0.0\r\n"
            f"s={path}\r\nt=0 0\r\na=control:*\r\n"
            "m=video 0 RTP/AVP 26\r\na=rtpmap:26 JPEG/90000\r\n"
            "a=control:trackID=1\r\n")


def parse_rung(spec) -> tuple[int, int]:
    """Rung spec → (quality, scale).  ``40`` or ``"40"`` = quality-only;
    ``"40s2"`` = quality 40 at half resolution (DCT-domain downscale)."""
    if isinstance(spec, int):
        return spec, 1
    s = str(spec).strip().lower()
    scale = 1
    if "s" in s:
        s, _, sc = s.partition("s")
        scale = int(sc)
        if scale not in (1, 2):
            raise ValueError(f"unsupported rung scale s{sc}")
    return int(s), scale


def rung_suffix(q: int, scale: int) -> str:
    return f"@q{q}" + ("s2" if scale == 2 else "")


@functools.lru_cache(maxsize=64)
def _quad_index(jt: int, gw: int, gh: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(y_idx, c_idx): for each output block (in output-MCU order), the 4
    source blocks [tl, tr, bl, br] (in input-MCU order) whose 2×2 tile it
    downsamples.  Component block-grid geometry per RTP/JPEG type."""
    gw2, gh2 = gw // 2, gh // 2
    if jt == 1:                         # 4:2:0: Y grid [2gh, 2gw]
        def yin(by, bx):
            return (by // 2 * gw + bx // 2) * 4 + (by % 2) * 2 + (bx % 2)

        def yout(by, bx):
            return (by // 2 * gw2 + bx // 2) * 4 + (by % 2) * 2 + (bx % 2)
        yh, yw = 2 * gh2, 2 * gw2
    else:                               # 4:2:2: Y grid [gh, 2gw]
        def yin(by, bx):
            return (by * gw + bx // 2) * 2 + (bx % 2)

        def yout(by, bx):
            return (by * gw2 + bx // 2) * 2 + (bx % 2)
        yh, yw = gh2, 2 * gw2
    n_y = yh * yw
    y_idx = np.zeros((n_y, 4), np.int32)
    for by in range(yh):
        for bx in range(yw):
            y_idx[yout(by, bx)] = [yin(2 * by, 2 * bx),
                                   yin(2 * by, 2 * bx + 1),
                                   yin(2 * by + 1, 2 * bx),
                                   yin(2 * by + 1, 2 * bx + 1)]
    c_idx = np.zeros((gh2 * gw2, 4), np.int32)
    for my in range(gh2):
        for mx in range(gw2):
            c_idx[my * gw2 + mx] = [(2 * my) * gw + 2 * mx,
                                    (2 * my) * gw + 2 * mx + 1,
                                    (2 * my + 1) * gw + 2 * mx,
                                    (2 * my + 1) * gw + 2 * mx + 1]
    return y_idx, c_idx


def _table(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int quant table (any order) → f32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(values, np.float32)).to(device)


class _Rung:
    def __init__(self, q: int, scale: int, session):
        self.q = q
        self.scale = scale
        self.session = session
        self.qtables = mjpeg.make_qtables(q)
        self.qy = np.frombuffer(self.qtables[:64], np.uint8).astype(np.int32)
        self.qc = np.frombuffer(self.qtables[64:], np.uint8).astype(np.int32)
        self.seq = 1
        self.frames = 0
        self.bytes_out = 0
        self.skipped = 0        # frames whose dims don't support the scale


def requantize_rung(levels: np.ndarray, q_in: np.ndarray, q_out: np.ndarray,
                    device: torch.device) -> np.ndarray:
    """Zigzag levels [N, 64] of one component group requantized from
    table ``q_in`` to ``q_out`` on ``device``, clamped to the
    baseline-codable range (|AC| <= 1023 keeps the Huffman category <= 10
    and |DC diff| <= 2046 < 2047, so an up-quality rung can never produce
    unencodable coefficients) → int16."""
    out = tf.requantize(torch.from_numpy(levels).to(device),
                        _table(q_in, device), _table(q_out, device))
    return np.clip(out.cpu().numpy(), -1023, 1023).astype(np.int16)


def frame_quads(jt, w, h, y32, chroma32, n_chroma):
    """Zigzag→natural reorder + 2×2 quad gathers for one frame, or None
    when the dims cannot halve MCU-aligned (input MCU grid must be even in
    both axes)."""
    gw, gh = je.mcu_grid(w, h, jt)
    mw, mh = (16, 16) if jt == 1 else (16, 8)
    if gw % 2 or gh % 2 or w % (2 * mw) or h % (2 * mh):
        return None
    y_idx, c_idx = _quad_index(jt, gw, gh)
    c_nat = tf.from_zigzag_np(chroma32)
    cb_q = c_nat[:n_chroma][c_idx].reshape(-1, 4, 64)
    cr_q = c_nat[n_chroma:][c_idx].reshape(-1, 4, 64)
    return {
        "y": tf.from_zigzag_np(y32)[y_idx].reshape(-1, 4, 64),
        "c": np.concatenate([cb_q, cr_q], axis=0),
        "n_chroma_out": len(cb_q),
    }


def downscale_rung(rung_qy, rung_qc, quads, qy_in, qc_in, w, h,
                   device: torch.device):
    """Half-resolution rung: the DCT-domain downscale operator, ONE
    [N, 256] @ [256, 64] fp32 product per component batch, on ``device``.
    Returns (y2, c2, n_chroma_out, w2, h2) with zigzag int16 levels."""
    def one(q4, q_in, q_out):
        out = tf.requantize_downscale2x(
            torch.from_numpy(q4).to(device),
            _table(tf.from_zigzag_np(q_in), device),
            _table(tf.from_zigzag_np(q_out), device))
        return tf.to_zigzag_np(np.clip(out.cpu().numpy(), -1023, 1023)
                               .astype(np.int16))
    return (one(quads["y"], qy_in, rung_qy), one(quads["c"], qc_in, rung_qc),
            quads["n_chroma_out"], w // 2, h // 2)


class MjpegLadderOutput(RelayOutput):
    """Attaches to a live MJPEG stream as a relay output (the recorder
    pattern) and feeds the rung sessions."""

    def __init__(self, source_path: str, registry: SessionRegistry,
                 rungs: tuple[tuple[int, int], ...], *, on_frame=None,
                 executor: concurrent.futures.ThreadPoolExecutor | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(ssrc=0)
        self.source_path = source_path
        self.registry = registry
        self.device = resolve_device(device)
        self.on_frame = on_frame            # pump-wake hook
        # The entropy codec is CPython bit twiddling (hundreds of ms for a
        # VGA frame): it must never run on the event loop.  With a running
        # loop + executor, frames are transcoded on the worker thread (its
        # device ops run on that thread's current stream; ``.cpu()`` of
        # each result is the synchronisation point) and the freshly
        # packetized rungs are pushed back via call_soon_threadsafe; when
        # behind, older pending frames are dropped (MJPEG frames are
        # independent).  Without a loop the path stays synchronous.
        self._executor = executor
        self._lock = threading.Lock()
        self._pending = None                # newest undecoded frame parts
        self._busy = False
        self.frames_dropped = 0
        self.depacketizer = mjpeg.JpegDepacketizer()
        self.rungs = []
        for q, scale in rungs:
            path = source_path + rung_suffix(q, scale)
            sess = registry.find_or_create(path, _rung_sdp(path))
            sess.owner = self
            self.rungs.append(_Rung(q, scale, sess))
        self.frames_in = 0
        self.decode_errors = 0
        self.last_error = ""                # last swallowed frame exception
        self.source_session = None          # set by the service on attach
        #: host seconds spent per phase over all transcoded frames, and in
        #: the newest one
        self.seconds = dict.fromkeys(PHASES, 0.0)
        self.last_frame_seconds = dict.fromkeys(PHASES, 0.0)
        #: RFC 2435 §4.2: in-band tables (Q 128..254) may ride only in the
        #: first frame — receivers cache them per Q value
        self._qt_cache: dict[int, bytes] = {}

    # thinning/rewrite are meaningless for a transcoder tap
    def write_rtp(self, packet: bytes) -> WriteResult:
        return self.send_bytes(packet, is_rtcp=False)

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return WriteResult.OK
        parts = self.depacketizer.push_parts(data)
        if parts is not None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None
            if loop is None or self._executor is None:
                self._run_frame(parts, loop=None)
            else:
                self._enqueue(parts, loop)
        # counted here AND by the engine that called send_rewritten, as
        # the reference ladder is
        self.packets_sent += 1
        self.bytes_sent += len(data)
        return WriteResult.OK

    def _enqueue(self, parts, loop) -> None:
        """Hand a complete frame to the worker; newest frame wins."""
        with self._lock:
            if self._pending is not None:
                self.frames_dropped += 1
            self._pending = parts
            if self._busy:
                return
            self._busy = True
        try:
            self._executor.submit(self._drain, loop)
        except RuntimeError:        # executor shut down: degrade to inline
            self._drain(None)

    def _drain(self, loop) -> None:
        while True:
            with self._lock:
                parts = self._pending
                self._pending = None
                if parts is None:
                    self._busy = False
                    return
            try:
                self._run_frame(parts, loop=loop)
            except Exception as e:  # _busy MUST reset via the loop above
                self.decode_errors += 1
                self.last_error = repr(e)

    def _run_frame(self, parts, *, loop) -> None:
        try:
            deliveries = self._transcode_frame(*parts)
        except Exception as e:  # a bad frame must never kill fan-out
            self.decode_errors += 1
            self.last_error = repr(e)   # surfaced via stats()
            return
        if deliveries is None:
            return
        if loop is None:
            self._deliver(deliveries)
        else:
            try:
                loop.call_soon_threadsafe(self._deliver, deliveries)
            except RuntimeError:        # loop closed mid-shutdown: drop
                return

    def _deliver(self, deliveries) -> None:
        """Push freshly packetized rungs into their sessions (event-loop
        thread when threaded; rung sessions are not thread-safe)."""
        try:
            for rung, pkts in deliveries:
                rung.frames += 1
                rung.bytes_out += sum(len(p) for p in pkts)
                for p in pkts:
                    rung.session.push(1, p)
            if self.on_frame is not None:
                self.on_frame(self.source_path)
        except Exception as e:  # downstream push must never kill fan-out
            self.decode_errors += 1
            self.last_error = repr(e)

    def _transcode_frame(self, header: mjpeg.JpegHeader, scan: bytes,
                         timestamp: int) -> list | None:
        """Decode + requantize + re-encode one frame.  Returns the
        per-rung packet lists for ``_deliver`` (session pushes happen on
        the event-loop thread, not here)."""
        jt = header.type & 1
        w, h = header.width, header.height
        if not w or not h:
            return None
        if header.qtables:
            qt_in = header.qtables
            self._qt_cache[header.q] = qt_in
        elif header.q >= 128:
            qt_in = self._qt_cache.get(header.q)
            if qt_in is None:       # tables not seen yet: cannot requantize
                self.decode_errors += 1
                return None
        else:
            qt_in = mjpeg.make_qtables(header.q if 1 <= header.q <= 99
                                       else 99)
        if len(qt_in) < 128:
            qt_in = (qt_in + qt_in)[:128]
        qy_in = np.frombuffer(qt_in[:64], np.uint8).astype(np.int32)
        qc_in = np.frombuffer(qt_in[64:128], np.uint8).astype(np.int32)
        ri = header.restart_interval if 64 <= header.type <= 127 else 0
        split = dict.fromkeys(PHASES, 0.0)
        t0 = time.perf_counter()
        y, cb, cr = je.decode_scan(scan, w, h, jt, ri)
        split["entropy_decode"] = time.perf_counter() - t0
        self.frames_in += 1
        y32 = y.astype(np.int32)
        chroma32 = np.concatenate([cb, cr], axis=0).astype(np.int32)
        n = len(cb)
        # frame-invariant downscale inputs (zigzag→natural reorder + quad
        # gathers) are computed ONCE, shared across every s2 rung
        quads = None
        if any(r.scale == 2 for r in self.rungs):
            quads = frame_quads(jt, w, h, y32, chroma32, n)
        deliveries = []
        for rung in self.rungs:
            t0 = time.perf_counter()
            if rung.scale == 2:
                if quads is None:
                    rung.skipped += 1       # dims don't halve MCU-aligned
                    continue
                y2, c2, n2, w2, h2 = downscale_rung(
                    rung.qy, rung.qc, quads, qy_in, qc_in, w, h, self.device)
            else:
                # the device does all blocks of the frame in two batched
                # calls
                y2 = requantize_rung(y32, qy_in, rung.qy, self.device)
                c2 = requantize_rung(chroma32, qc_in, rung.qc, self.device)
                n2, w2, h2 = n, w, h
            t1 = time.perf_counter()
            new_scan = je.encode_scan([y2, c2[:n2], c2[n2:]], jt)
            pkts = mjpeg.packetize_jpeg(
                new_scan, width=w2, height=h2, seq=rung.seq,
                timestamp=timestamp,
                ssrc=0x54C0DE ^ rung.q ^ (rung.scale << 8),
                type_=jt, q=rung.q)
            split["device_requant"] += t1 - t0
            split["entropy_encode"] += time.perf_counter() - t1
            rung.seq = (rung.seq + len(pkts)) & 0xFFFF
            deliveries.append((rung, pkts))
        for k, v in split.items():
            self.seconds[k] += v
        self.last_frame_seconds = split
        return deliveries

    def stats(self) -> dict:
        return {
            "path": self.source_path,
            "frames_in": self.frames_in,
            "frames_dropped": self.frames_dropped,
            "decode_errors": self.decode_errors,
            "last_error": self.last_error,
            "seconds": dict(self.seconds),
            "last_frame_seconds": dict(self.last_frame_seconds),
            "rungs": [{"q": r.q, "scale": r.scale, "path": r.session.path,
                       "frames": r.frames, "bytes_out": r.bytes_out,
                       "skipped": r.skipped} for r in self.rungs],
        }


class MjpegTranscodeService:
    """start/stop ladders on live MJPEG paths (REST: starttranscode /
    stoptranscode / gettranscodes)."""

    def __init__(self, registry: SessionRegistry, *, on_frame=None,
                 device: str | torch.device = "cuda"):
        self.registry = registry
        self.on_frame = on_frame
        self.device = resolve_device(device)
        self.ladders: dict[str, MjpegLadderOutput] = {}
        # a dedicated worker: a ladder's _drain is a long-lived loop of
        # GIL-holding CPython entropy coding (hundreds of ms per frame,
        # refilled faster than it drains on a live stream)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mjpeg-ladder")

    def start(self, path: str, rungs=(40, 20)):
        """``rungs``: quality ints or ``"Qs2"`` strings (half-resolution
        DCT-domain downscale rungs)."""
        specs = tuple(dict.fromkeys(parse_rung(r) for r in rungs))  # dedup
        bad = [q for q, _s in specs if not 1 <= q <= 99]
        if bad or not specs:
            raise ValueError(f"rung qualities must be 1..99, got {bad}")
        sess = self.registry.find(path)
        if sess is None:
            raise KeyError(path)
        video = next((tid for tid, st in sess.streams.items()
                      if st.info.codec in ("JPEG", "MJPEG", "MJPG")), None)
        if video is None:
            raise ValueError(f"{path} has no MJPEG video track")
        key = sess.path
        if key in self.ladders:
            raise ValueError(f"transcode already active on {key}")
        for q, s in specs:      # a rung path must not steal a live session
            if self.registry.find(key + rung_suffix(q, s)) is not None:
                raise ValueError(
                    f"{key}{rung_suffix(q, s)} is already a live session")
        out = MjpegLadderOutput(key, self.registry, specs,
                                on_frame=self.on_frame,
                                executor=self._executor, device=self.device)
        out.source_session = sess
        sess.streams[video].add_output(out)
        self.ladders[key] = out
        return out

    def stop(self, path: str) -> dict:
        key = sdp_mod._norm(path)
        out = self.ladders.pop(key, None)
        if out is None:
            raise KeyError(path)
        return self._retire(key, out)

    def _retire(self, key: str, out: MjpegLadderOutput) -> dict:
        st = out.stats()
        src = self.registry.find(key)
        if src is not None and src is out.source_session:
            for tid in list(src.streams):
                src.streams[tid].remove_output(out)
        for rung in out.rungs:
            # rung sessions are ours unless something replaced/adopted them
            if (self.registry.find(rung.session.path) is rung.session
                    and rung.session.owner is out):
                self.registry.remove(rung.session.path)
        return st

    def sweep(self) -> int:
        """Retire ladders whose source session is gone or was replaced
        (pusher disconnect tears its session down; a re-announce makes a
        NEW session this ladder is not attached to)."""
        dead = [k for k, o in self.ladders.items()
                if self.registry.find(k) is not o.source_session]
        for k in dead:
            self._retire(k, self.ladders.pop(k))
        return len(dead)

    def list_ladders(self) -> list[dict]:
        return [o.stats() for o in self.ladders.values()]

    def stop_all(self) -> None:
        for key in list(self.ladders):
            try:
                self.stop(key)
            except KeyError:
                pass
        self._executor.shutdown(wait=False)
