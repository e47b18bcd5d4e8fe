"""The port's server end to end on the CPU, and what the port imports.

* a loopback push → play through ``python -m easydarwin_tpu_torch
  --device cpu``: 1 source × 2 interleaved TCP players (the per-stream
  device ring, the native framed-writev rung), 2 sources × 2 UDP players
  (the megabatch, the native sendmmsg scatter) and 1 source × 3 UDP
  players joining one by one; every relayed packet held to what was
  pushed (``utils.loopback``);
* a UDP SETUP names the shared egress ports, and is refused without
  ``client_port`` or from a pusher; the outputs' native hooks;
* importing the port, its server, its CLI, the transcode modules and
  the REST API leaves ``jax`` and ``easydarwin_tpu`` out of
  ``sys.modules``;
* the CLI's device defaults to the card, and without one it raises.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from easydarwin_tpu_torch import __main__ as cli
from easydarwin_tpu_torch.protocol import rtsp
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server.transports import (InterleavedOutput,
                                                    SharedUdpEgress, UdpOutput)
from easydarwin_tpu_torch.utils import loopback

ROOT = Path(__file__).resolve().parents[1]


async def test_loopback_push_play_through_the_cli_on_cpu():
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(2026), n_push=1, n_play=2,
        deadline_s=10)
    assert res["players"] == 2 and res["packets_per_player"] == 80
    stats = res["server_stats"]
    assert stats["packets_in"] == 80
    assert stats["packets_out"] == 2 * 80      # fast start replays GOP 1
    # one stream: the megabatch idles, the engine queries its own ring
    assert stats["megabatch"]["installs"] == 0
    assert stats["device_param_refreshes"] > 0
    assert stats["native_loaded"] and stats["native_sent"] > 0
    assert stats["send_errors"] == 0
    # CPU tensors take the plain versions: no kernel was launched
    assert stats["kernel_launches"] == {"ed_parse_packets": 0,
                                        "ed_relay_window": 0,
                                        "ed_ring_query": 0,
                                        "ed_decode_blocks": 0}


async def test_udp_players_through_the_cli_on_cpu():
    """UDP SETUP (``client_port``) is served: 2 sources engage the
    megabatch, and every datagram leaves through the native scatter."""
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(7), n_push=2, n_play=2,
        transport="udp", deadline_s=10)
    assert res["players"] == 4 and res["delivered"] == 4 * 80
    stats = res["server_stats"]
    assert stats["packets_out"] == 4 * 80
    assert stats["native_sent"] == stats["packets_out"]
    assert stats["native_passes"] > 0 and stats["send_errors"] == 0
    assert stats["megabatch"]["installs"] > 0
    assert stats["megabatch"]["native_gather"]


async def test_staggered_udp_joins_on_one_stream_through_the_cli_on_cpu():
    """Players joining one every third frame of one source: each join is
    a per-stream ring query, and each player starts at its keyframe."""
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(8), n_push=1, n_play=3,
        transport="udp", gops=6, join_every=3, deadline_s=10)
    assert res["players"] == 3
    stats = res["server_stats"]
    assert stats["device_param_refreshes"] >= 3
    assert stats["native_sent"] == stats["packets_out"] == res["delivered"]
    assert stats["megabatch"]["installs"] == 0


async def test_udp_setup_replies_with_the_shared_egress_ports_in_process():
    """A player's UDP SETUP is answered with the shared egress pair's ports
    as ``server_port``; a UDP SETUP without ``client_port``, or a
    pusher's, gets 461."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    await app.start()
    clients = [loopback.MiniClient(), loopback.MiniClient()]
    try:
        pusher, player = clients
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        with pytest.raises(AssertionError, match="-> 461"):
            await pusher.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP;unicast;client_port=5000-5001;"
                             "mode=record"})
        await player.connect(app.rtsp.port)
        await player.request("DESCRIBE", uri)
        with pytest.raises(AssertionError, match="-> 461"):
            await player.request("SETUP", uri + "/trackID=1",
                                 {"transport": "RTP/AVP;unicast"})
        resp = await player.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP;unicast;client_port=5000-5001"})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        egress = app.rtsp.shared_egress
        assert t.server_port == (egress.rtp_port, egress.rtcp_port)
        assert t.client_port == (5000, 5001) and t.ssrc is not None
    finally:
        for c in clients:
            if c._task is not None:
                await c.close()
        await app.stop()


def test_output_hooks_default_to_the_python_loop():
    """The engine's native hooks default to None / -1 / False; a UDP
    output names its RTP address, an interleaved one its socket."""
    out = CollectingOutput()
    assert (out.native_addr, out.stream_fd) == (None, -1)
    assert not out.engine_writable() and not out.push_tail(b"x")
    udp = UdpOutput(SharedUdpEgress("127.0.0.1"), "127.0.0.1", 5000, 5001)
    assert udp.native_addr == ("127.0.0.1", 5000) and udp.stream_fd == -1
    a, b = socket.socketpair()
    try:
        tr = _Transport(a)
        il = InterleavedOutput(tr, 0, 1)
        assert il.stream_fd == a.fileno() and il.engine_writable()
        tr.buffered = 1
        assert not il.engine_writable()
        assert il.push_tail(b"tail") and tr.written == [b"tail"]
    finally:
        a.close()
        b.close()


class _Transport:
    """The few ``asyncio.WriteTransport`` calls an interleaved output
    makes."""

    def __init__(self, sock):
        self.sock, self.buffered, self.written = sock, 0, []

    def get_extra_info(self, name):
        return self.sock if name == "socket" else None

    def is_closing(self):
        return False

    def get_write_buffer_size(self):
        return self.buffered

    def write(self, data):
        self.written.append(data)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import easydarwin_tpu_torch, easydarwin_tpu_torch.__main__\n"
            "import easydarwin_tpu_torch.convert, easydarwin_tpu_torch.server\n"
            "import easydarwin_tpu_torch.ops.parse_kernel\n"
            "import easydarwin_tpu_torch.ops.device_ring\n"
            "import easydarwin_tpu_torch.native\n"
            "import easydarwin_tpu_torch.server.transports\n"
            "import easydarwin_tpu_torch.ops.transform_kernel\n"
            "import easydarwin_tpu_torch.models.transcode_pipeline\n"
            "import easydarwin_tpu_torch.models.mjpeg_ladder\n"
            "import easydarwin_tpu_torch.server.rest\n"
            "import easydarwin_tpu_torch.utils.loopback\n"
            "import easydarwin_tpu_torch.utils.mjpeg_loopback\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'easydarwin_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_device_defaults_to_the_card():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda"
    assert cli.build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "mps"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["-p", "0", "--bind-ip", "127.0.0.1"])
