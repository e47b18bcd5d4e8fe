"""Recording: live relay → MP4 file.

``RtspRecordModule``'s role (``RtspRecordSession.h`` + ``EasyMP4Writer``)
as a relay sink: ``RecorderOutput`` *is* a ``RelayOutput``, so it rides the
same bucketed fan-out, bookmark/WouldBlock and thinning machinery as any
subscriber (the engine's loop rung renders its headers), and the recorder
never touches sockets.  Started and stopped over REST
(``/api/v1/startrecord`` / ``stoprecord``).  Each orphan the start-up
sweep finds is a ``record.orphan`` event (``obs``).
"""

from __future__ import annotations

import base64
import os
import time

from ..obs import EVENTS
from ..protocol.sdp import _norm
from ..relay.output import RelayOutput, WriteResult
from ..relay.session import RelaySession
from .depacketize import H264Depacketizer
from .mp4_writer import Mp4Writer

VIDEO_CLOCK = 90000

#: crash-safety suffix: ``Mp4Writer`` only writes moov at close, so a
#: recorder that dies mid-write leaves an unplayable file — all writing
#: happens under this suffix and ``finish()`` atomically renames the
#: completed file into place.  A leftover ``.tmp`` at boot is an orphan
#: from a crashed recorder (``sweep_orphans``).
TMP_SUFFIX = ".tmp"


def sweep_orphans(folder: str) -> list[str]:
    """Report recorder tmp files a crashed process left behind.  They are
    never deleted or served —
    an operator decides whether the truncated mdat is worth salvaging;
    re-recording to the same path overwrites the tmp anyway.  The walk
    recurses: ``startrecord`` accepts nested ``file=`` paths, so an
    orphan can sit anywhere under the movie folder (the ``.dvr`` spill
    tree is skipped — it holds no MP4s and may be large)."""
    orphans: list[str] = []
    try:
        for root, dirs, names in os.walk(folder):
            dirs[:] = sorted(d for d in dirs if d != ".dvr")
            for name in sorted(names):
                if name.endswith(".mp4" + TMP_SUFFIX):
                    full = os.path.join(root, name)
                    orphans.append(full)
                    EVENTS.emit("record.orphan", level="warn", file=full)
    except OSError:
        pass
    return orphans


class RecorderOutput(RelayOutput):
    """Relay sink that depacketizes H.264 and muxes into an MP4."""

    def __init__(self, path: str):
        super().__init__(ssrc=0xEDB0)
        self.path = path
        self.depack = H264Depacketizer()
        self.writer: Mp4Writer | None = None
        self._video_track: int | None = None
        self._last_ts: int | None = None
        self._t0: int | None = None
        self.samples = 0
        self.started_at = time.time()

    # RelayOutput interface — packets arrive already seq/ts-rebased
    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return WriteResult.OK
        self.depack.push(data)
        for au in self.depack.pop_units():
            self._write_unit(au)
        return WriteResult.OK

    def _write_unit(self, au) -> None:
        if self.writer is None:
            if not (self.depack.sps and self.depack.pps and au.is_idr):
                return                    # wait for config + first IDR
            # write under .tmp; finish() renames — a crash mid-record
            # never leaves a moov-less file at the published path
            self.writer = Mp4Writer(self.path + TMP_SUFFIX)
            self._video_track = self.writer.add_h264_track(
                self.depack.sps, self.depack.pps, 0, 0,
                timescale=VIDEO_CLOCK)
            self._t0 = au.timestamp
            self._last_ts = None
        if self._last_ts is not None:
            dur = (au.timestamp - self._last_ts) & 0xFFFFFFFF
            if 0 < dur < VIDEO_CLOCK * 10:
                self.writer.tracks[self._video_track].durations[-1] = dur
        self.writer.write_sample(self._video_track, au.to_avcc(),
                                 VIDEO_CLOCK // 30, sync=au.is_idr)
        self._last_ts = au.timestamp
        self.samples += 1

    def finish(self) -> dict:
        for au in self.depack.flush():
            self._write_unit(au)
        if self.writer is not None:
            self.writer.close()           # moov lands in the tmp file
            os.replace(self.path + TMP_SUFFIX, self.path)
        return {"path": self.path, "samples": self.samples,
                "duration_sec": time.time() - self.started_at,
                "malformed": self.depack.malformed}


class RecordingManager:
    """Attach/detach recorders on live relay sessions (REST-facing)."""

    def __init__(self):
        self.active: dict[str, tuple[RelaySession, int, RecorderOutput]] = {}

    def start(self, session: RelaySession, file_path: str) -> RecorderOutput:
        if session.path in self.active:
            raise ValueError(f"already recording {session.path}")
        video_tracks = [tid for tid, st in session.streams.items()
                        if st.info.media_type == "video"]
        if not video_tracks:
            raise ValueError("no video track to record")
        tid = video_tracks[0]
        rec = RecorderOutput(file_path)
        # seed parameter sets from the SDP's sprop (out-of-band config),
        # so recording works even when the pusher never repeats SPS/PPS
        fmtp = session.streams[tid].info.fmtp
        if "sprop-parameter-sets=" in fmtp:
            props = fmtp.split("sprop-parameter-sets=")[1].split(";")[0]
            try:
                nals = [base64.b64decode(x + "==") for x in props.split(",")]
                for n in nals:
                    if n and (n[0] & 0x1F) == 7:
                        rec.depack.sps = n
                    elif n and (n[0] & 0x1F) == 8:
                        rec.depack.pps = n
            except (ValueError, TypeError):
                pass
        session.streams[tid].add_output(rec)
        self.active[session.path] = (session, tid, rec)
        return rec

    def stop(self, path: str) -> dict:
        key = _norm(path)
        if key not in self.active:
            raise KeyError(f"not recording {key}")
        session, tid, rec = self.active.pop(key)
        session.streams[tid].remove_output(rec)
        return rec.finish()

    def stop_all(self) -> list[dict]:
        return [self.stop(p) for p in list(self.active)]
