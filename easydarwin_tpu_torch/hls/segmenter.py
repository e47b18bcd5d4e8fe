"""Live fMP4 HLS segmenter.

One ``HlsOutput`` per rendition of a published stream: a relay sink that
depacketizes the relayed H.264, cuts segments on IDR boundaries near the
target duration, and keeps a sliding window of in-memory CMAF fragments:

* init segment: ``ftyp`` + ``moov`` (with ``mvex/trex``: sample tables
  live in the fragments),
* media segments: ``styp`` + ``moof`` (mfhd/tfhd/tfdt/trun) + ``mdat``,
  with the AAC track as a second ``traf`` when the source has one,
* playlist: live sliding-window ``#EXT-X-MAP`` m3u8.

``HlsService`` publishes paths: the source rendition, temporal rungs
``rN`` (the relay's frame thinning pinned at level N) and requant rungs
``qN`` (``hls.requant``: one ``RequantLadder`` a path, B6 on the
service's device).  The REST layer serves ``/hls/<path>[/<rung>]/<file>``
through ``HlsService.serve``.  A copy of the reference's
``hls/segmenter.py`` (byte-equal segments), with the requant rungs on an
explicit device.
"""

from __future__ import annotations

import struct
from collections import deque
from dataclasses import dataclass

import torch

from ..protocol.aac import AAC_SAMPLES_PER_FRAME, AacConfig
from ..relay.output import RelayOutput, WriteResult
from ..vod.depacketize import AccessUnit, H264Depacketizer
from ..vod.mp4_writer import box, full_box

VIDEO_CLOCK = 90000


def _esds(cfg: AacConfig) -> bytes:
    """MP4 elementary-stream descriptor for AAC-LC: ES_Descriptor →
    DecoderConfig (objectType 0x40 audio/ISO 14496-3, streamType 5) →
    DecoderSpecificInfo = AudioSpecificConfig from the SDP (or
    synthesized from rate/channels)."""
    asc = cfg.asc or cfg.default_asc()
    dsi = bytes((0x05, len(asc))) + asc
    dcd = bytes((0x04, 13 + len(dsi), 0x40, 0x15, 0, 0, 0)) + \
        struct.pack(">II", 128000, 128000) + dsi
    sl = bytes((0x06, 1, 0x02))
    es = bytes((0x03, 3 + len(dcd) + len(sl))) + \
        struct.pack(">HB", 2, 0) + dcd + sl
    return full_box(b"esds", 0, 0, es)


def _audio_trak(cfg: AacConfig) -> bytes:
    esds = _esds(cfg)
    entry = struct.pack(">I4s", 36 + len(esds), b"mp4a") + bytes(6) + \
        struct.pack(">H", 1) + bytes(8) + \
        struct.pack(">HHI", cfg.channels, 16, 0) + \
        struct.pack(">I", cfg.sample_rate << 16) + esds
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stbl = box(b"stbl", stsd,
               full_box(b"stts", 0, 0, bytes(4)),
               full_box(b"stsc", 0, 0, bytes(4)),
               full_box(b"stsz", 0, 0, bytes(8)),
               full_box(b"stco", 0, 0, bytes(4)))
    url = full_box(b"url ", 0, 1)
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1), url))
    minf = box(b"minf", full_box(b"smhd", 0, 0, bytes(4)), dinf, stbl)
    mdhd = full_box(b"mdhd", 0, 0,
                    struct.pack(">IIII", 0, 0, cfg.sample_rate, 0),
                    struct.pack(">HH", 0x55C4, 0))
    hdlr = full_box(b"hdlr", 0, 0, bytes(4), b"soun", bytes(12),
                    b"easydarwin-tpu\x00")
    mdia = box(b"mdia", mdhd, hdlr, minf)
    tkhd = full_box(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 2, 0, 0),
                    bytes(8), struct.pack(">hhhH", 0, 0, 0x0100, 0),
                    struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                0x40000000),
                    struct.pack(">II", 0, 0))
    return box(b"trak", tkhd, mdia)


def _init_segment(sps: bytes, pps: bytes,
                  audio: AacConfig | None = None) -> bytes:
    avcc = box(b"avcC",
               bytes((1, sps[1] if len(sps) > 1 else 66,
                      sps[2] if len(sps) > 2 else 0,
                      sps[3] if len(sps) > 3 else 30, 0xFF, 0xE1)),
               struct.pack(">H", len(sps)), sps, bytes((1,)),
               struct.pack(">H", len(pps)), pps)
    entry = struct.pack(">I4s", 86 + len(avcc), b"avc1") + bytes(6) + \
        struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", 0, 0) + \
        struct.pack(">II", 0x00480000, 0x00480000) + bytes(4) + \
        struct.pack(">H", 1) + bytes(32) + struct.pack(">Hh", 0x18, -1) + avcc
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stbl = box(b"stbl", stsd,
               full_box(b"stts", 0, 0, bytes(4)),
               full_box(b"stsc", 0, 0, bytes(4)),
               full_box(b"stsz", 0, 0, bytes(8)),
               full_box(b"stco", 0, 0, bytes(4)))
    url = full_box(b"url ", 0, 1)
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1), url))
    minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)), dinf, stbl)
    mdhd = full_box(b"mdhd", 0, 0,
                    struct.pack(">IIII", 0, 0, VIDEO_CLOCK, 0),
                    struct.pack(">HH", 0x55C4, 0))
    hdlr = full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12),
                    b"easydarwin-tpu\x00")
    mdia = box(b"mdia", mdhd, hdlr, minf)
    tkhd = full_box(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0, 0),
                    bytes(8), struct.pack(">hhhH", 0, 0, 0, 0),
                    struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                0x40000000),
                    struct.pack(">II", 0, 0))
    trak = box(b"trak", tkhd, mdia)
    trexes = [full_box(b"trex", 0, 0,
                       struct.pack(">IIIII", 1, 1, 0, 0, 0))]
    traks = [trak]
    if audio is not None:
        traks.append(_audio_trak(audio))
        trexes.append(full_box(b"trex", 0, 0,
                               struct.pack(">IIIII", 2, 1, 0, 0, 0)))
    mvex = box(b"mvex", *trexes)
    mvhd = full_box(b"mvhd", 0, 0,
                    struct.pack(">IIII", 0, 0, VIDEO_CLOCK, 0),
                    struct.pack(">IH", 0x00010000, 0x0100), bytes(10),
                    struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                0x40000000), bytes(24),
                    struct.pack(">I", 3))
    return box(b"ftyp", b"iso6", struct.pack(">I", 0), b"iso6cmfc") + \
        box(b"moov", mvhd, *traks, mvex)


def _traf(track_id: int, base_dts: int,
          samples: list[tuple[bytes, int, bool]], data_offset: int
          ) -> bytes:
    tfhd = full_box(b"tfhd", 0, 0x020000,      # default-base-is-moof
                    struct.pack(">I", track_id))
    tfdt = full_box(b"tfdt", 1, 0, struct.pack(">Q", base_dts))
    flags = 0x000001 | 0x000100 | 0x000200 | 0x000400
    rows = b""
    for data, dur, sync in samples:
        sflags = 0x02000000 if sync else 0x01010000
        rows += struct.pack(">III", dur, len(data), sflags)
    trun = full_box(b"trun", 0, flags,
                    struct.pack(">Ii", len(samples), data_offset), rows)
    return box(b"traf", tfhd, tfdt, trun)


def _traf_len(n_samples: int) -> int:
    return 8 + 16 + 20 + (8 + 4 + 4 + 4 + 12 * n_samples)


def _media_segment(seq: int, base_dts: int,
                   samples: list[tuple[bytes, int, bool]],
                   audio_samples: list[tuple[bytes, int, bool]] = (),
                   audio_base_dts: int = 0) -> bytes:
    """samples: [(avcc_data, duration, is_sync)]; audio rides as a
    second traf (track 2) sharing the mdat, video bytes first."""
    video_bytes = b"".join(s[0] for s in samples)
    audio_bytes = b"".join(s[0] for s in audio_samples)
    mfhd = full_box(b"mfhd", 0, 0, struct.pack(">I", seq))
    moof_len = 8 + len(mfhd) + _traf_len(len(samples)) + \
        (_traf_len(len(audio_samples)) if audio_samples else 0)
    v_off = moof_len + 8
    trafs = [_traf(1, base_dts, samples, v_off)]
    if audio_samples:
        trafs.append(_traf(2, audio_base_dts, list(audio_samples),
                           v_off + len(video_bytes)))
    moof = box(b"moof", mfhd, *trafs)
    assert len(moof) == moof_len
    return box(b"styp", b"msdh", struct.pack(">I", 0), b"msdhmsix") + \
        moof + box(b"mdat", video_bytes + audio_bytes)


@dataclass
class Segment:
    seq: int
    duration_sec: float
    data: bytes


class HlsOutput(RelayOutput):
    """Relay sink producing a sliding window of CMAF segments."""

    def __init__(self, *, target_duration: float = 2.0, window: int = 6,
                 audio: AacConfig | None = None):
        super().__init__(ssrc=0x415)
        # identity rewrite: every rendition of one path keeps the SOURCE
        # timestamps, so variant timelines (tfdt) stay aligned and ABR
        # switching between rungs never jumps in presentation time
        self.rewrite.base_src_seq = 0
        self.rewrite.base_src_ts = 0
        self.rewrite.out_seq_start = 0
        self.rewrite.out_ts_start = 0
        self.target_duration = target_duration
        self.window = window
        self.depack = H264Depacketizer()
        self.init_segment: bytes | None = None
        self.segments: list[Segment] = []
        self.media_seq = 0            # seq of segments[0]
        self._pending: list[AccessUnit] = []
        self._seg_start_ts: int | None = None
        self._last_ts: int | None = None
        #: AAC track (None = video-only).  Audio AUs ride UNCHANGED
        #: through every rendition: thinning and requant are video-axis
        #: transforms
        self.audio = audio
        # deque: overflow shedding pops from the FRONT per AU, and
        # list.pop(0) is O(P) per shed (the VOD pacer deque fix shape)
        self._audio_pending: deque[tuple[bytes, int]] = deque()
        self._audio_dts = 0           # running tfdt, audio timescale
        self._audio_last_dur = AAC_SAMPLES_PER_FRAME
        self._audio_prev_ts: int | None = None
        self.audio_samples_muxed = 0
        self.audio_dropped = 0
        # rolling bitrate observation for the master playlist
        self._obs_bytes = 0
        self._obs_sec = 0.0
        # serving-side caches: the playlist text is rebuilt only when a
        # segment is cut/evicted (keyed by window identity), and segment
        # bodies are served by reference (no per-request copy)
        self._playlist_cache: tuple | None = None  # (key, base, text)
        self.playlist_builds = 0
        #: per-OUTPUT generation token baked into every ETag: media_seq
        #: and segment numbering restart from 0 on a server restart or
        #: stream re-publish, so counter-only tags would let a surviving
        #: player revalidate stale bytes with a false 304
        import secrets as _secrets
        self.etag_gen = _secrets.token_hex(4)

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return WriteResult.OK
        self.depack.push(data)
        for au in self.depack.pop_units():
            self._on_unit(au)
        return WriteResult.OK

    def _on_unit(self, au: AccessUnit) -> None:
        if self.init_segment is None:
            if not (self.depack.sps and self.depack.pps and au.is_idr):
                return
            self.init_segment = _init_segment(self.depack.sps,
                                              self.depack.pps, self.audio)
        if self._seg_start_ts is None:
            if not au.is_idr:
                return                    # segments must start on IDR
            self._seg_start_ts = au.timestamp
        elapsed = ((au.timestamp - self._seg_start_ts) & 0xFFFFFFFF) / VIDEO_CLOCK
        if au.is_idr and self._pending and elapsed >= self.target_duration:
            self._cut()
            self._seg_start_ts = au.timestamp
        self._pending.append(au)
        self._last_ts = au.timestamp

    def on_audio(self, data: bytes, ts: int) -> None:
        """One AAC AU from the session's audio track (RTP ts = sample
        units).  Buffered until the video-driven cut; audio received
        before the first video segment opens is dropped (nothing to
        sync it against yet)."""
        if self.audio is None or self._seg_start_ts is None:
            return
        if self._audio_prev_ts is None and not self._audio_pending \
                and self._audio_dts == 0:
            # anchor the audio tfdt timeline to the video position NOW,
            # mapped into the audio timescale: video tfdt carries raw
            # source RTP timestamps (random origin per RFC 3550), so a
            # zero-based audio track would present up to 2^32/90k sec
            # away from it.  First-AU arrival jitter bounds the residual
            # offset to ~a frame; an SR-correlated mapping can tighten
            # it later.
            ref = self._last_ts if self._last_ts is not None \
                else self._seg_start_ts
            self._audio_dts = ref * self.audio.sample_rate // VIDEO_CLOCK
        self._audio_pending.append((data, ts))
        # bounded like every other buffer here: cuts are video-driven,
        # so a stalled video track must shed audio, not hoard it
        max_aus = 2 + int((self.window + 2) * self.target_duration
                          * self.audio.sample_rate
                          // AAC_SAMPLES_PER_FRAME)
        while len(self._audio_pending) > max_aus:
            self._audio_pending.popleft()
            self.audio_dropped += 1

    def _drain_audio(self) -> tuple[list, int]:
        """All buffered AUs → (samples, base_dts).  The audio timeline is
        self-paced from AU timestamp deltas (RTP clock == sample rate),
        zero-based at the first segment — sync error vs video is bounded
        by one audio frame + ingest jitter, and both tracks' tfdt then
        advance in lockstep."""
        if not self._audio_pending:
            return [], self._audio_dts
        aus = list(self._audio_pending)
        self._audio_pending.clear()
        if self._audio_prev_ts is not None:
            # the previous batch's final AU got a GUESSED duration; the
            # real one is this batch's first ts minus its ts — reconcile
            # so a gap straddling a cut cannot drift the tfdt timeline
            gap = (aus[0][1] - self._audio_prev_ts) & 0xFFFFFFFF
            if 0 < gap <= self.audio.sample_rate * 10:
                self._audio_dts += gap - self._audio_last_dur
        base = self._audio_dts
        samples = []
        for i, (data, ts) in enumerate(aus):
            if i + 1 < len(aus):
                dur = (aus[i + 1][1] - ts) & 0xFFFFFFFF
                if not 0 < dur <= self.audio.sample_rate * 10:
                    dur = self._audio_last_dur
            else:
                dur = self._audio_last_dur
            self._audio_last_dur = dur if 0 < dur <= \
                self.audio.sample_rate * 10 else AAC_SAMPLES_PER_FRAME
            samples.append((data, dur, True))    # every AAC frame syncs
            self._audio_dts += dur
        self._audio_prev_ts = aus[-1][1]
        self.audio_samples_muxed += len(samples)
        return samples, base

    def _cut(self) -> None:
        if not self._pending:
            return
        base = self._pending[0].timestamp
        samples = []
        for i, au in enumerate(self._pending):
            if i + 1 < len(self._pending):
                dur = (self._pending[i + 1].timestamp - au.timestamp) \
                    & 0xFFFFFFFF
            else:
                dur = VIDEO_CLOCK // 30
            if not 0 < dur < VIDEO_CLOCK * 10:
                dur = VIDEO_CLOCK // 30
            samples.append((au.to_avcc(), dur, au.is_idr))
        total = sum(d for _, d, _ in samples) / VIDEO_CLOCK
        seq = self.media_seq + len(self.segments)
        audio_samples, audio_base = self._drain_audio()
        seg = Segment(seq, total, _media_segment(seq, base, samples,
                                                 audio_samples,
                                                 audio_base))
        self.segments.append(seg)
        self._obs_bytes += len(seg.data)
        self._obs_sec += total
        self._pending = []
        while len(self.segments) > self.window:
            self.segments.pop(0)
            self.media_seq += 1

    # -- serving -----------------------------------------------------------
    def playlist_key(self) -> tuple:
        """Identity of the current sliding window — the playlist text
        (and its ETag) is a pure function of this."""
        return (self.media_seq, len(self.segments),
                self.segments[-1].seq if self.segments else -1)

    def playlist(self, base_url: str = "") -> str:
        """The live m3u8 — rebuilt only when the window changed (a
        per-request rebuild was O(window) string work on every GET of
        every player; the cache returns the SAME str object, which the
        regression tests pin)."""
        key = (self.playlist_key(), base_url)
        cached = self._playlist_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        lines = ["#EXTM3U", "#EXT-X-VERSION:7",
                 f"#EXT-X-TARGETDURATION:{int(self.target_duration + 1)}",
                 f"#EXT-X-MEDIA-SEQUENCE:{self.media_seq}",
                 f'#EXT-X-MAP:URI="{base_url}init.mp4"']
        for s in self.segments:
            lines.append(f"#EXTINF:{s.duration_sec:.3f},")
            lines.append(f"{base_url}seg{s.seq}.m4s")
        text = "\n".join(lines) + "\n"
        self._playlist_cache = (key, text)
        self.playlist_builds += 1
        return text

    def get_segment(self, seq: int) -> bytes | None:
        """Served BY REFERENCE — a cut segment is immutable, so every
        GET shares the one bytes object (zero per-request copies)."""
        for s in self.segments:
            if s.seq == seq:
                return s.data
        return None

    def codec_string(self) -> str:
        """RFC 6381 codec tags from the SPS bytes (+ AAC-LC when the
        entry carries audio)."""
        sps = self.depack.sps
        video = f"avc1.{sps[1]:02X}{sps[2]:02X}{sps[3]:02X}" \
            if sps and len(sps) >= 4 else "avc1.42E01E"
        return video + ",mp4a.40.2" if self.audio is not None else video

    def observed_bandwidth(self) -> int:
        """Peak-ish bits/s over the segments produced so far (0 = none)."""
        if self._obs_sec <= 0:
            return 0
        return int(self._obs_bytes * 8 / self._obs_sec)


class HlsAudioTap(RelayOutput):
    """RelayOutput on the session's AUDIO track: depacketizes RFC 3640
    AAC and fans each AU into every rendition of the entry (renditions
    added later see audio immediately — the dict reference is live)."""

    def __init__(self, cfg: AacConfig, renditions: dict):
        super().__init__(ssrc=0x416)
        self.rewrite.base_src_seq = 0
        self.rewrite.base_src_ts = 0
        self.rewrite.out_seq_start = 0
        self.rewrite.out_ts_start = 0
        from ..protocol.aac import AacDepacketizer
        self.depack = AacDepacketizer(cfg)
        self.renditions = renditions

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return WriteResult.OK
        for au, ts in self.depack.push(data):
            for out in self.renditions.values():
                out.on_audio(au, ts)
        return WriteResult.OK


#: SDP codec names this HLS muxer can carry as an fMP4 audio track
_AAC_CODECS = ("MPEG4-GENERIC",)


class _HlsEntry:
    """One published path: the full-rate rendition plus temporal rungs."""

    def __init__(self, sess, track_id: int,
                 audio_track: int | None = None,
                 audio_cfg: AacConfig | None = None):
        self.sess = sess
        self.track_id = track_id
        self.audio_track = audio_track
        self.audio_cfg = audio_cfg
        #: rendition name → HlsOutput; "" = source frame rate, "rN" =
        #: thinning level N (1 = half rate, 2 = keyframes only), "qN" =
        #: requant rung (a LadderRendition fed by ``requant_ladder``)
        self.renditions: dict[str, HlsOutput] = {}
        self.audio_tap: HlsAudioTap | None = None
        #: ONE RequantLadder serves every q-rung of the entry: the AU is
        #: depacketized and entropy-decoded once, slices fan across the
        #: shared pool, and all renditions ride one fused transform
        #: dispatch (hls/requant.py)
        self.requant_ladder = None

    def stream(self, track_id: int):
        return self.sess.streams[track_id]


#: default ladder for master.m3u8: temporal rungs only (frame-granular
#: thinning, NO re-encode: level 1 halves the frame rate, level 2 keeps
#: GOP heads only).  The transform-domain REQUANT rung "qN" (same frame
#: rate, truly lower bitrate: hls/requant.py) is OPT-IN via starthls
#: rungs=q6 or an explicit /q6/ URL: its host-side entropy recode is
#: costly on large pictures, so it is not advertised on every
#: master.m3u8 GET.
DEFAULT_RUNGS = (1, 2)
MAX_RUNG_LEVEL = 2
MAX_REQUANT_DELTA = 18
#: BANDWIDTH fallbacks per rendition before any segment is observed
_NOMINAL_BW = {"": 2_000_000, "r1": 1_200_000, "r2": 400_000,
               "q6": 1_000_000, "q12": 500_000}


def _fold_counters(tot: dict, counts: dict) -> None:
    """Add one ladder's ``counters()`` into ``tot``: a ``*_max`` key
    keeps the larger peak, every other key sums."""
    for k, v in counts.items():
        tot[k] = (max(tot.get(k, 0), v) if k.endswith("_max")
                  else tot.get(k, 0) + v)


class HlsService:
    """Manages per-path HLS entries (full rendition, temporal and requant
    rungs) and serves master/rendition playlists and segments.

    BASELINE config-5's mux half: one live H.264 push → multi-rendition
    ``master.m3u8``.  Temporal rungs reuse the relay's frame-granular
    thinning (``relay.quality.ThinningFilter``) pinned at a fixed level;
    requant rungs share one ``RequantLadder`` a path, whose B6 pass runs
    on ``device`` (the server's: ``ed_h264_requant[_chroma]`` on a card,
    the plain torch chains on the CPU)."""

    def __init__(self, registry, *, device: str | torch.device = "cuda",
                 target_duration: float = 2.0, window: int = 6):
        self.registry = registry
        self.device = torch.device(device)
        self.target_duration = target_duration
        self.window = window
        self.outputs: dict[str, _HlsEntry] = {}
        #: counters of ladders whose entries were retired
        self._retired: dict = {}
        #: entries retired (stopped, or their source session went away)
        self.paths_retired = 0

    def _rendition(self, entry: _HlsEntry, name: str) -> HlsOutput:
        out = entry.renditions.get(name)
        if out is None:
            if name.startswith("q"):
                # every q-rung of a path shares ONE RequantLadder (the
                # session output): one depacketize + one entropy decode
                # per AU no matter how wide the ladder is
                from .requant import RequantLadder
                if entry.requant_ladder is None:
                    entry.requant_ladder = RequantLadder(
                        device=self.device,
                        target_duration=self.target_duration,
                        window=self.window, audio=entry.audio_cfg)
                    entry.stream(entry.track_id).add_output(
                        entry.requant_ladder)
                out = entry.requant_ladder.add_rendition(int(name[1:]))
            else:
                out = HlsOutput(target_duration=self.target_duration,
                                window=self.window, audio=entry.audio_cfg)
                if name:
                    out.thinning.controller.level = int(name[1:])
                entry.stream(entry.track_id).add_output(out)
            entry.renditions[name] = out
            if entry.audio_track is not None and entry.audio_tap is None:
                entry.audio_tap = HlsAudioTap(entry.audio_cfg,
                                              entry.renditions)
                entry.stream(entry.audio_track).add_output(entry.audio_tap)
        return out

    def _retire(self, key: str, entry: _HlsEntry) -> None:
        from .requant import LadderRendition
        self.paths_retired += 1
        for out in entry.renditions.values():
            if not isinstance(out, LadderRendition):
                entry.stream(entry.track_id).remove_output(out)
        if entry.requant_ladder is not None:
            entry.stream(entry.track_id).remove_output(entry.requant_ladder)
            _fold_counters(self._retired, entry.requant_ladder.counters())
        if entry.audio_tap is not None and entry.audio_track is not None:
            entry.stream(entry.audio_track).remove_output(entry.audio_tap)

    def _fresh_entry(self, key: str) -> _HlsEntry | None:
        """Current entry for ``key`` — retiring it first if the source
        session was replaced (publisher reconnect) so viewers never get a
        frozen playlist bound to a dead session."""
        entry = self.outputs.get(key)
        if entry is not None and self.registry.find(key) is not entry.sess:
            self.outputs.pop(key)
            self._retire(key, entry)
            entry = None
        return entry

    def start(self, path: str, rungs: tuple[int, ...] = (),
              *, include_source: bool = True) -> HlsOutput | None:
        """Publish ``path`` over HLS; returns the full-rate rendition (or
        None with ``include_source=False``).  ``rungs`` adds temporal
        renditions (thinning levels 1..MAX_RUNG_LEVEL); out-of-range
        levels raise ValueError rather than advertising a dead variant."""
        from ..protocol.sdp import _norm
        key = _norm(path)
        names = []
        for r in rungs:
            if isinstance(r, str) and r.startswith("q"):
                delta = int(r[1:])
                if not (6 <= delta <= MAX_REQUANT_DELTA and delta % 6 == 0):
                    raise ValueError(
                        f"requant rungs must be q6..q{MAX_REQUANT_DELTA} "
                        "in steps of 6")
                names.append(f"q{delta}")
            else:
                level = int(r)
                if not 1 <= level <= MAX_RUNG_LEVEL:
                    raise ValueError(
                        f"rung levels must be 1..{MAX_RUNG_LEVEL}")
                names.append(f"r{level}")
        entry = self._fresh_entry(key)
        if entry is None:
            sess = self.registry.find(key)
            if sess is None:
                raise KeyError(key)
            vids = [tid for tid, st in sess.streams.items()
                    if st.info.media_type == "video"]
            if not vids:
                raise ValueError("no video track")
            audio_tid = audio_cfg = None
            for tid, st in sess.streams.items():
                if st.info.media_type == "audio" \
                        and st.info.codec in _AAC_CODECS:
                    audio_tid = tid
                    chans = 2
                    bits = st.info.payload_name.split("/")
                    if len(bits) >= 3 and bits[2].isdigit():
                        chans = int(bits[2])
                    audio_cfg = AacConfig.from_sdp(
                        st.info.fmtp, st.info.clock_rate, chans)
                    break
            entry = self.outputs[key] = _HlsEntry(sess, vids[0],
                                                  audio_tid, audio_cfg)
        out = self._rendition(entry, "") if include_source else None
        for name in names:
            self._rendition(entry, name)
        return out

    def stop(self, path: str) -> None:
        from ..protocol.sdp import _norm
        key = _norm(path)
        entry = self.outputs.pop(key, None)
        if entry is not None:
            self._retire(key, entry)

    def sweep(self) -> int:
        """Retire entries whose source session is gone or was replaced."""
        dead = [k for k, e in self.outputs.items()
                if self.registry.find(k) is not e.sess]
        for k in dead:
            self._retire(k, self.outputs.pop(k))
        return len(dead)

    def list_streams(self) -> list[dict]:
        def info(name, out):
            d = {
                "name": name or "source",
                "uri": (f"{name}/index.m3u8" if name else "index.m3u8"),
                "segments": len(out.segments),
                "bandwidth": out.observed_bandwidth(),
            }
            rq = getattr(out, "requant", None)
            if rq is not None:          # requant rung: surface honesty
                d["requantized_slices"] = rq.stats.slices_requantized
                d["passed_through_slices"] = rq.stats.slices_passed_through
                d["shed_units"] = out.shed
                d["pending_units"] = out.pending
            return d
        return [{
            "path": key,
            "renditions": [info(n, o)
                           for n, o in sorted(entry.renditions.items())],
        } for key, entry in self.outputs.items()]

    def stats(self) -> dict:
        """The requant ladders' counters over every path the service
        ran (``RequantLadder.counters``: summed, the ``*_max`` peaks
        the largest), with the host seconds of each stage
        (``REQUANT_STAGES``) and of an AU's latency turned into ms an AU
        and the dispatch leg's submit and wait halves into ms a
        dispatch; ``device`` is where B6 runs and ``pool_workers`` the
        requant pool's size (the shed gate is twice it, at least 4);
        ``paths`` are the live entries, ``paths_retired`` those retired."""
        from .requant import REQUANT_STAGES, RequantLadder, pool_workers
        tot = dict.fromkeys(RequantLadder.COUNTERS, 0)
        _fold_counters(tot, self._retired)
        for entry in self.outputs.values():
            if entry.requant_ladder is not None:
                _fold_counters(tot, entry.requant_ladder.counters())
        aus = max(tot["aus"], 1)
        tot["latency_ms_per_au"] = tot["latency_s"] * 1e3 / aus
        tot["stage_ms_per_au"] = {
            st: tot.get(f"{st}_s", 0.0) * 1e3 / aus for st in REQUANT_STAGES}
        n = max(tot.get("transform_device_n", 0), 1)
        tot["transform_ms_per_dispatch"] = {
            "submit": tot["transform_submit_s"] * 1e3 / n,
            "wait": tot["transform_wait_s"] * 1e3 / n}
        tot["paths"] = len(self.outputs)
        tot["paths_retired"] = self.paths_retired
        tot["device"] = str(self.device)
        tot["pool_workers"] = pool_workers()
        return tot

    def master_playlist(self, entry: _HlsEntry) -> str:
        lines = ["#EXTM3U", "#EXT-X-VERSION:7"]
        for name in sorted(entry.renditions, key=lambda n: (n != "", n)):
            out = entry.renditions[name]
            bw = out.observed_bandwidth() or _NOMINAL_BW.get(name, 800_000)
            lines.append(f"#EXT-X-STREAM-INF:BANDWIDTH={bw},"
                         f'CODECS="{out.codec_string()}"')
            lines.append(f"{name}/index.m3u8" if name else "index.m3u8")
        return "\n".join(lines) + "\n"

    def serve(self, url_path: str
              ) -> tuple[str, bytes | str, str | None] | None:
        """Resolve ``/hls/<stream-path>[/rN]/<file>`` → (content_type,
        body, etag).  ``master.m3u8`` auto-starts the default temporal
        ladder; a rendition playlist auto-starts just that rendition.
        ``etag`` (None = uncacheable) lets the REST layer short-circuit
        repeat GETs with 304 — playlists carry a weak window-identity
        tag, segments a strong one (a cut segment is immutable)."""
        if not url_path.startswith("/hls/"):
            return None
        rest = url_path[5:]
        if "/" not in rest:
            return None
        stream_path, fname = rest.rsplit("/", 1)
        rendition = ""
        parts = stream_path.rsplit("/", 1)
        from ..protocol.sdp import _norm as _n
        if (len(parts) == 2 and len(parts[1]) >= 2
                and parts[1][0] in "rq" and parts[1][1:].isdigit()
                # a stream genuinely PUBLISHED at .../r2 or .../q6 keeps
                # its full path; the suffix is a rendition only when no
                # such session exists
                and self.registry.find(_n("/" + stream_path.strip("/")))
                is None):
            stream_path, rendition = parts
        from ..protocol.sdp import _norm
        key = _norm("/" + stream_path.strip("/"))
        try:
            if fname == "master.m3u8":
                # idempotent: upgrades an existing single-variant entry
                # to the default ladder too
                self.start(key, DEFAULT_RUNGS)
            elif rendition and (self._fresh_entry(key) is None
                                or rendition not in
                                self.outputs[key].renditions):
                rung = rendition if rendition[0] == "q" \
                    else int(rendition[1:])
                self.start(key, (rung,), include_source=False)
            elif self._fresh_entry(key) is None:
                self.start(key)
        except (KeyError, ValueError):
            return None
        entry = self.outputs.get(key)
        if entry is None:
            return None
        if fname == "master.m3u8":
            return ("application/vnd.apple.mpegurl",
                    self.master_playlist(entry), None)
        out = entry.renditions.get(rendition)
        if out is None:
            return None
        gen = out.etag_gen
        if fname in ("index.m3u8", "playlist.m3u8"):
            pk = out.playlist_key()
            return ("application/vnd.apple.mpegurl", out.playlist(),
                    f'W/"pl-{gen}-{pk[0]}-{pk[1]}-{pk[2]}"')
        if fname == "init.mp4":
            if out.init_segment is None:
                return None
            return ("video/mp4", out.init_segment,
                    f'"init-{gen}-{len(out.init_segment)}"')
        if fname.startswith("seg") and fname.endswith(".m4s"):
            try:
                seq = int(fname[3:-4])
            except ValueError:
                return None
            data = out.get_segment(seq)
            if data is None:
                return None
            return ("video/iso.segment", data,
                    f'"seg-{gen}-{seq}-{len(data)}"')
        return None
