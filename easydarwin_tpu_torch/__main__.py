"""CLI entry: ``python -m easydarwin_tpu_torch [-c FILE] [-x] [-w]
[-p PORT] [--service-port N] [--device cuda|cpu] [--movie-folder DIR]
[--vod-cache-*] [--dvr-*] [--storage-*] [--hls-device cuda|cpu]
[--auth-enabled 0|1] [--rest-username U] [--rest-password P]
[--log-folder DIR] [-S N] [--status-file PATH] [--module-folder DIR]``.

``-c FILE`` loads the config from a TOML file of ``ServerConfig`` keys or
from the reference's ``easydarwin.xml`` (told apart by content); the
flags given apply over it, and the keys the port could not apply are
printed (``unmapped:``).  ``-x`` boots, prints, stops and exits 0 (a
config check); ``-w`` runs the server as a child of the watchdog
(``server.supervisor``), which relaunches it when REST ``restart`` makes
it exit with the restart code.

Serves the live relay: pushers ANNOUNCE/SETUP/RECORD over interleaved TCP
or UDP (``client_port``; their RTP drained in native recvmmsg batches),
players DESCRIBE/SETUP/PLAY over interleaved TCP, UDP (``client_port``)
or an RTSP-over-HTTP tunnel on the RTSP port.  A path may also be fed by
a pull relay (REST ``startpullrelay?path=/p&url=rtsp://...``) or by a
``<path>.sdp`` broadcast under ``--movie-folder`` (its UDP or multicast
ports bound at the first SETUP).  An HTTP GET of ``<file>.mp3`` on the
RTSP port streams the file as icy MP3.  The REST API on the service port
answers the core commands (``login``, ``getserverinfo``,
``getrtsplivesessions``, ``getbaseconfig``, ``setbaseconfig``,
``restart``, ``getdevicestream``, the pull relays), starts MJPEG
transcode ladders (``/api/v1/starttranscode?path=/cam&
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
``-S N`` prints the status columns every N seconds, ``--status-file
PATH`` writes the JSON status snapshot there every
``status_file_interval_sec``, and ``--module-folder DIR`` loads the
``*.py`` plugin modules of DIR at start.
Prints one ``listening:`` line once both listeners are bound (port 0 picks
a free port) and runs until SIGINT/SIGTERM, or REST ``restart``.  SIGHUP
re-reads the prefs as the reference does: ``update()`` on the running
server's config, which runs its ``on_change`` listeners (auth and the
logs made again, every module's ``reread_prefs``); the server keeps
serving.  The handlers are in place before the listening line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys

from .server import ServerConfig, StreamingServer
from .server.config import load_config
from .server.supervisor import EXIT_RESTART, run_supervised

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="easydarwin_tpu_torch",
        description="RTSP live relay, file playback and MJPEG transcode "
                    "ladder with their device work on a CUDA card")
    d = ServerConfig()
    p.add_argument("-c", "--config",
                   help="config file: TOML of ServerConfig keys, or the "
                        "reference's easydarwin.xml")
    p.add_argument("-x", "--exit-after-boot", action="store_true",
                   help="boot, print the listening line, stop (a config "
                        "check)")
    p.add_argument("-w", "--watchdog", action="store_true",
                   help="run under the watchdog, which relaunches the "
                        "server on REST restart or a crash")
    p.add_argument("-p", "--rtsp-port", type=int, default=d.rtsp_port,
                   help="RTSP listen port (0 = any free port)")
    p.add_argument("--service-port", type=int, default=d.service_port,
                   help="REST API listen port (0 = any free port)")
    p.add_argument("--bind-ip", default=d.bind_ip, help="bind address")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the megabatch pass and the transcode ladder "
                        "run (default: cuda)")
    p.add_argument("--reflect-interval-ms", type=int,
                   default=d.reflect_interval_ms,
                   help="pump tick when no ingest wakes it")
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
    # keys of the port that no easydarwin.xml pref carries
    p.add_argument("--auth-enabled", type=int, choices=(0, 1),
                   default=int(d.auth_enabled),
                   help="REST auth: Basic on every command, a login token "
                        "(X-Token) on every command that changes state")
    p.add_argument("--rest-username", default=d.rest_username,
                   help="the REST user")
    p.add_argument("--rest-password", default=d.rest_password,
                   help="the REST user's password")
    p.add_argument("--log-folder", default=d.log_folder,
                   help="where access.log and error.log roll")
    p.add_argument("-S", "--stats-interval", dest="stats_interval_sec",
                   type=int, metavar="N", default=d.stats_interval_sec,
                   help="print the status columns every N seconds "
                        "(0: off)")
    p.add_argument("--status-file", dest="status_file_path",
                   default=d.status_file_path,
                   help="write a JSON status snapshot here on an interval")
    p.add_argument("--module-folder", default=d.module_folder,
                   help="a folder of *.py plugin modules loaded at start")
    return p


def config_from_args(argv=None) -> tuple[ServerConfig, list[str]]:
    """The config file of ``-c`` (else the defaults) with the flags the
    command line gives applied over it, and the file's unmapped keys."""
    p = build_parser()
    args = p.parse_args(argv)
    cfg, unmapped = (load_config(args.config) if args.config
                     else (ServerConfig(), []))
    # parse again with every default unset: what is set was given
    unset = object()
    p.set_defaults(**{a.dest: unset for a in p._actions})
    keys = ServerConfig.keys()
    for dest, v in vars(p.parse_args(argv)).items():
        if dest in keys and v is not unset:
            setattr(cfg, dest,
                    bool(v) if isinstance(getattr(cfg, dest), bool) else v)
    return cfg, unmapped


async def amain(cfg: ServerConfig, device: str,
                exit_after_boot: bool = False) -> int:
    app = StreamingServer(cfg, device=device)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    # SIGHUP re-reads the prefs of the config the running server holds
    loop.add_signal_handler(signal.SIGHUP, lambda: app.config.update())
    await app.start()
    print(f"easydarwin-tpu-torch listening: rtsp://{cfg.bind_ip}:"
          f"{app.rtsp.port} service http://{cfg.bind_ip}:{app.rest.port}"
          f"/api/v1 device={app.device}", flush=True)
    if exit_after_boot:
        await app.stop()
        return 0
    waits = [asyncio.create_task(stop.wait()),
             asyncio.create_task(app.restart_event.wait())]
    await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
    for w in waits:
        w.cancel()
    restarting = app.restart_event.is_set() and not stop.is_set()
    await app.stop()
    print("stats " + json.dumps(app.stats()), flush=True)
    return EXIT_RESTART if restarting else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.watchdog:
        child = [sys.executable, "-m", "easydarwin_tpu_torch"] + [
            a for a in (sys.argv[1:] if argv is None else argv)
            if a not in ("-w", "--watchdog")]
        return run_supervised(child)
    cfg, unmapped = config_from_args(argv)
    if unmapped:
        print(f"unmapped: {len(unmapped)} keys of {args.config} are not "
              f"served by this port: {json.dumps(unmapped)}", flush=True)
    return asyncio.run(amain(cfg, args.device, args.exit_after_boot))


if __name__ == "__main__":
    raise SystemExit(main())
