"""CLI entry: ``python -m easydarwin_tpu_torch [-p PORT] [--service-port N]
[--device cuda|cpu] [--movie-folder DIR] [--vod-cache-*] [--dvr-*]
[--storage-*] [--hls-device cuda|cpu]``.

Serves the live relay: pushers ANNOUNCE/SETUP/RECORD over interleaved TCP
or UDP (``client_port``; their RTP drained in native recvmmsg batches),
players DESCRIBE/SETUP/PLAY over interleaved TCP or UDP
(``client_port``).  The REST API on the service port
starts MJPEG transcode ladders (``/api/v1/starttranscode?path=/cam&
rungs=40,20s2``) whose rungs play as ``/cam@q40`` and ``/cam@q20s2``, and
records a live path to an MP4 (``startrecord?path=/cam&file=cam.mp4``,
``stoprecord?path=/cam``).  A path no pusher serves plays the file of
that name under ``--movie-folder`` (``rtsp://host:port/clip.mp4``),
through the card-resident segment cache unless ``--vod-cache-enabled 0``.
With ``--dvr-enabled 1`` every pushed session records to
``<movie-folder>/.dvr``: a live player can PAUSE and PLAY with a Range
into the past (with ``Speed`` to catch up), and a finished recording
plays as ``rtsp://host:port/<path>.dvr``; ``--storage-enabled 1``
erasure-codes each finished recording into ``<movie-folder>/.shards``
(``--storage-data-shards`` k, ``--storage-parity-shards`` m).  A pushed
H.264 path publishes over HLS: ``/api/v1/starthls?path=/cam&rungs=q6,q12``
(or a GET of ``/hls/cam/master.m3u8``, which adds the temporal rungs r1
and r2) on the service port, then ``/hls/cam/[<rung>/]index.m3u8``,
``init.mp4`` and ``seg<N>.m4s``; the requant rungs run B6 on ``--device``
(or ``--hls-device``).
Prints one ``listening:`` line once both listeners are bound (port 0 picks
a free port) and runs until SIGINT/SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from .server import ServerConfig, StreamingServer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="easydarwin_tpu_torch",
        description="RTSP live relay, file playback and MJPEG transcode "
                    "ladder with their device work on a CUDA card")
    p.add_argument("-p", "--rtsp-port", type=int, default=10554,
                   help="RTSP listen port (0 = any free port)")
    p.add_argument("--service-port", type=int, default=10008,
                   help="REST API listen port (0 = any free port)")
    p.add_argument("--bind-ip", default="0.0.0.0", help="bind address")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the megabatch pass and the transcode ladder "
                        "run (default: cuda)")
    p.add_argument("--reflect-interval-ms", type=int, default=20,
                   help="pump tick when no ingest wakes it")
    d = ServerConfig()
    p.add_argument("--movie-folder", default=d.movie_folder,
                   help="files played by path, and where recordings go")
    p.add_argument("--vod-cache-enabled", type=int, choices=(0, 1),
                   default=int(d.vod_cache_enabled),
                   help="serve files through the segment cache and the "
                        "group pacer (0: one FileSession a player)")
    p.add_argument("--vod-cache-bytes", type=int, default=d.vod_cache_bytes,
                   help="the cache's byte budget (host + device)")
    p.add_argument("--vod-cache-window-samples", type=int,
                   default=d.vod_cache_window_samples,
                   help="samples packed per cache window")
    p.add_argument("--vod-cache-lookahead-ms", type=int,
                   default=d.vod_cache_lookahead_ms,
                   help="how far ahead the pacer fills a player's ring")
    p.add_argument("--vod-cache-device", type=int, choices=(0, 1),
                   default=int(d.vod_cache_device),
                   help="keep windows resident on the device and prime "
                        "joins there")
    p.add_argument("--dvr-enabled", type=int, choices=(0, 1),
                   default=int(d.dvr_enabled),
                   help="record every pushed session for pause, rewind "
                        "and <path>.dvr replay (needs the segment cache)")
    p.add_argument("--dvr-window-pkts", type=int, default=d.dvr_window_pkts,
                   help="packets a spill window")
    p.add_argument("--dvr-retention-bytes", type=int,
                   default=d.dvr_retention_bytes,
                   help="spill byte budget a track")
    p.add_argument("--dvr-retention-sec", type=float,
                   default=d.dvr_retention_sec,
                   help="spill duration cap a track")
    p.add_argument("--storage-enabled", type=int, choices=(0, 1),
                   default=int(d.storage_enabled),
                   help="erasure-code every finished DVR recording "
                        "(needs --dvr-enabled 1)")
    p.add_argument("--storage-data-shards", type=int,
                   default=d.storage_data_shards,
                   help="k: data shards a stripe")
    p.add_argument("--storage-parity-shards", type=int,
                   default=d.storage_parity_shards,
                   help="m: parity shards a stripe")
    p.add_argument("--storage-scrub-interval-sec", type=float,
                   default=d.storage_scrub_interval_sec,
                   help="seconds between scrubs of the local shards")
    p.add_argument("--hls-device", choices=("cuda", "cpu"), default=None,
                   help="where the HLS requant rungs run B6 (default: "
                        "--device)")
    return p


async def amain(args) -> int:
    cfg = ServerConfig(rtsp_port=args.rtsp_port,
                       service_port=args.service_port, bind_ip=args.bind_ip,
                       reflect_interval_ms=args.reflect_interval_ms,
                       movie_folder=args.movie_folder,
                       vod_cache_enabled=bool(args.vod_cache_enabled),
                       vod_cache_bytes=args.vod_cache_bytes,
                       vod_cache_window_samples=args.vod_cache_window_samples,
                       vod_cache_lookahead_ms=args.vod_cache_lookahead_ms,
                       vod_cache_device=bool(args.vod_cache_device),
                       dvr_enabled=bool(args.dvr_enabled),
                       dvr_window_pkts=args.dvr_window_pkts,
                       dvr_retention_bytes=args.dvr_retention_bytes,
                       dvr_retention_sec=args.dvr_retention_sec,
                       storage_enabled=bool(args.storage_enabled),
                       storage_data_shards=args.storage_data_shards,
                       storage_parity_shards=args.storage_parity_shards,
                       storage_scrub_interval_sec=(
                           args.storage_scrub_interval_sec),
                       hls_device=args.hls_device)
    app = StreamingServer(cfg, device=args.device)
    await app.start()
    print(f"easydarwin-tpu-torch listening: rtsp://{cfg.bind_ip}:"
          f"{app.rtsp.port} service http://{cfg.bind_ip}:{app.rest.port}"
          f"/api/v1 device={app.device}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await app.stop()
    print("stats " + json.dumps(app.stats()), flush=True)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    raise SystemExit(main())
