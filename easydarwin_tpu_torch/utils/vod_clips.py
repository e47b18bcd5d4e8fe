"""Seeded MP4 clips for the VOD tier's tests and its chip smoke.

A clip is H.264 (an IDR every ``gop`` frames, P frames between, each
sample one NAL of seeded random bytes) and, optionally, AAC (one access
unit of ``audio_frame_bytes`` a 1024-sample frame), muxed by
``vod.mp4_writer.Mp4Writer`` or any class with its interface, so the same
sample plan can be written by another muxer and the files compared.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..vod.mp4_writer import Mp4Writer

#: baseline-profile parameter sets (their bytes only reach the SDP and the
#: IDR samples; no decoder reads these clips)
SPS = bytes((0x67, 0x42, 0x00, 0x28, 0xAA, 0xBB, 0xCC, 0xDD, 0xEE, 0xFF))
PPS = bytes((0x68, 0xCE, 0x3C, 0x80, 0x11, 0x22, 0x33, 0x44))
#: AudioSpecificConfig of AAC-LC, 44.1 kHz, stereo
AAC_CONFIG = bytes((0x12, 0x10))
VIDEO_CLOCK = 90000


@dataclass(frozen=True)
class ClipSpec:
    width: int = 640
    height: int = 480
    fps: int = 30
    frames: int = 30
    gop: int = 10                   # an IDR every ``gop`` frames
    idr_bytes: int = 2000           # sample sizes (AVCC, length included)
    p_bytes: int = 80
    audio_rate: int = 0             # 0: no audio track
    audio_frame_bytes: int = 372


#: clip A of the chip smoke: 1080p30 H.264 for 30 s, an IDR of 120,000
#: bytes every 30 frames and P frames of 25,000 bytes (about 7 Mbps), and
#: AAC at 44.1 kHz in 372-byte frames
CLIP_A = ClipSpec(width=1920, height=1080, fps=30, frames=900, gop=30,
                  idr_bytes=120_000, p_bytes=25_000, audio_rate=44_100,
                  audio_frame_bytes=372)
#: clip B: 2160p30 for 10 s, an IDR of 600,000 bytes and P frames of
#: 150,000 bytes (about 40 Mbps), video only
CLIP_B = ClipSpec(width=3840, height=2160, fps=30, frames=300, gop=30,
                  idr_bytes=600_000, p_bytes=150_000)


def clip_samples(spec: ClipSpec, seed: int):
    """The clip's samples: ``(video, audio)``, each a list of ``(data,
    duration, sync)`` in the track's timescale."""
    rng = np.random.default_rng(seed)
    dur = VIDEO_CLOCK // spec.fps
    video = []
    for i in range(spec.frames):
        idr = i % spec.gop == 0
        size = spec.idr_bytes if idr else spec.p_bytes
        nal = bytes((0x65 if idr else 0x41,)) + rng.integers(
            0, 256, size - 5, dtype=np.uint8).tobytes()
        video.append((len(nal).to_bytes(4, "big") + nal, dur, idr))
    audio = []
    if spec.audio_rate:
        n = spec.frames * spec.audio_rate // (spec.fps * 1024)
        for _ in range(n):
            audio.append((rng.integers(0, 256, spec.audio_frame_bytes,
                                       dtype=np.uint8).tobytes(), 1024,
                          True))
    return video, audio


def write_clip(path: str, spec: ClipSpec, seed: int,
               writer_cls=Mp4Writer) -> str:
    """Mux the clip of ``spec`` and ``seed`` into ``path``."""
    video, audio = clip_samples(spec, seed)
    w = writer_cls(str(path))
    v = w.add_h264_track(SPS, PPS, spec.width, spec.height,
                         timescale=VIDEO_CLOCK)
    a = (w.add_aac_track(AAC_CONFIG, spec.audio_rate, 2)
         if spec.audio_rate else None)
    for data, dur, sync in video:
        w.write_sample(v, data, dur, sync=sync)
    for data, dur, sync in audio:
        w.write_sample(a, data, dur, sync=sync)
    w.close()
    return str(path)
