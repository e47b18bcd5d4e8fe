"""CLI entry: ``python -m easydarwin_tpu_torch [-p PORT] [--device cuda|cpu]``.

Serves the live relay: pushers ANNOUNCE/SETUP/RECORD over TCP-interleaved
RTSP, players DESCRIBE/SETUP/PLAY.  Prints one ``listening:`` line once the
listener is bound (port 0 picks a free port) and runs until SIGINT/SIGTERM.
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
        description="RTSP live relay with its device pass on a CUDA card")
    p.add_argument("-p", "--rtsp-port", type=int, default=10554,
                   help="RTSP listen port (0 = any free port)")
    p.add_argument("--bind-ip", default="0.0.0.0", help="bind address")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the megabatch pass runs (default: cuda)")
    p.add_argument("--reflect-interval-ms", type=int, default=20,
                   help="pump tick when no ingest wakes it")
    return p


async def amain(args) -> int:
    cfg = ServerConfig(rtsp_port=args.rtsp_port, bind_ip=args.bind_ip,
                       reflect_interval_ms=args.reflect_interval_ms)
    app = StreamingServer(cfg, device=args.device)
    await app.start()
    print(f"easydarwin-tpu-torch listening: rtsp://{cfg.bind_ip}:"
          f"{app.rtsp.port} device={app.device}", flush=True)
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
