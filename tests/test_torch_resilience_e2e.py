"""The resilience tier on a running server, on the CPU.

* A restart from the checkpoint: server A relays a pushed stream to a UDP
  player and an interleaved-TCP player and stops; server B starts on the
  same log folder, restores the session and the UDP subscriber, the TCP
  player re-attaches with its old Session id, and the pusher
  re-ANNOUNCEs.  Each player sees one SSRC and a contiguous rewritten seq
  across the restart (the reference's ``tests/test_resilience_e2e.py``,
  with the TCP half its checkpoint re-attach adds).
* A chaos run at a small size (``utils.chaos_loopback.chaos_relay``, the
  harness of ``chip_smoke.py``'s chaos phase): the faults fire and are
  counted by site, the ladder degrades and every stream recovers to the
  megabatch rung after the disarm, the device errors counted are the
  injected ones, and every player's packets are pushed ones.
"""

import asyncio

import pytest

from easydarwin_tpu_torch import obs
from easydarwin_tpu_torch.utils.chaos_loopback import (chaos_relay,
                                                       restart_resume)


@pytest.fixture(autouse=True)
def _fresh_ledger():
    """The servers here run in this process: the process-wide wake
    ledger they fill is reset after each test, so no later test in the
    process reads their wakes (the audience store reads its top class)."""
    yield
    obs.LEDGER.reset()


def test_restart_resumes_udp_and_tcp_subscribers(tmp_path):
    res = asyncio.run(restart_resume("cpu", str(tmp_path), packets=40))
    assert res["restored_sessions"] == 1 and res["restored_outputs"] == 1
    assert res["rr_proved"]
    for who in ("udp", "tcp"):
        assert min(res[f"{who}_packets"]) >= 20, res


def test_restart_writes_and_restores_counters(tmp_path):
    writes = obs.RESILIENCE_CKPT_WRITES.value()
    restores = obs.RESILIENCE_CKPT_RESTORES.value()
    res = asyncio.run(restart_resume("cpu", str(tmp_path), seed=6,
                                     packets=24))
    assert obs.RESILIENCE_CKPT_WRITES.value() >= writes + 2
    assert obs.RESILIENCE_CKPT_RESTORES.value() == restores + 1
    assert res["checkpoint"]["restores"] == 1
    assert (tmp_path / "ckpt" / "relay.json").exists()


def test_chaos_run_degrades_and_recovers(tmp_path):
    res = asyncio.run(chaos_relay(
        "cpu", 21, streams=3, players=2, fault_s=2.5, recover_sec=0.5,
        confirm_s=0.6, log_folder=str(tmp_path)))
    assert res["faults"]["device_dispatch"] > 0
    assert res["transitions"]["down"] > 0
    assert res["device_errors"] <= res["faults"]["device_dispatch"]
    assert res["recover_s"] <= res["recover_bound_s"]
    assert res["window_calls"]["fault"] > 0
    assert res["window_calls"]["after"] > 0
    assert res["mismatches"] == 0
    assert res["delivered"] > 0


def test_chaos_run_degrades_on_a_slow_pump(tmp_path, monkeypatch):
    """A loaded host: every pump pass starts 60 ms late, so the pump
    makes few device dispatches a second.  The chaos plan's device faults
    still come closer together than ``recover_sec``, so the ladder still
    degrades and every stream still recovers."""
    import time

    from easydarwin_tpu_torch.server import StreamingServer
    reflect_all = StreamingServer.reflect_all

    def slow(self):
        time.sleep(0.06)
        return reflect_all(self)

    monkeypatch.setattr(StreamingServer, "reflect_all", slow)
    res = asyncio.run(chaos_relay(
        "cpu", 21, streams=3, players=2, fault_s=2.5, recover_sec=0.5,
        confirm_s=0.6, log_folder=str(tmp_path)))
    assert res["transitions"]["down"] > 0
    assert res["recover_s"] <= res["recover_bound_s"]
    assert res["window_calls"]["fault"] > 0
    assert res["window_calls"]["after"] > 0
    assert res["mismatches"] == 0


def _two_streams(app, rng, broken=False):
    """Two live streams of three outputs each and their scalar twins."""
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream
    from easydarwin_tpu_torch.utils import loopback

    class Broken(CollectingOutput):
        def send_bytes(self, data, *, is_rtcp):
            raise OSError("broken output")

    streams = [next(iter(app.registry.find_or_create(
        path, loopback.VIDEO_SDP).streams.values()))
        for path in ("/live/a", "/live/b")]
    twins = {id(s): RelayStream(s.info, s.settings) for s in streams}
    for stream in streams:
        for i in range(3):
            kw = dict(ssrc=int(rng.integers(1 << 32)),
                      out_seq_start=int(rng.integers(1 << 16)),
                      out_ts_start=int(rng.integers(1 << 32)))
            cls = Broken if broken and stream is streams[0] and i == 0 \
                else CollectingOutput
            stream.add_output(cls(**kw))
            twins[id(stream)].add_output(CollectingOutput(**kw))
    return streams, twins


def _wakes(app, streams, twins, pkts, n, pause_s=0.0):
    import time
    from easydarwin_tpu_torch.relay.session import now_ms
    for wake in range(n):
        t = now_ms()
        for pkt in pkts[8 * wake:8 * (wake + 1)]:
            for s in (*streams, *twins.values()):
                s.push_rtp(pkt, t)
        app.reflect_all()
        t = now_ms()
        for twin in twins.values():
            twin.reflect(t)
        time.sleep(pause_s)


def test_scheduler_errors_move_streams_down_the_ladder(monkeypatch):
    import numpy as np
    from easydarwin_tpu_torch.resilience import LEVEL_DEVICE, InjectedFault
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    from easydarwin_tpu_torch.utils import synth
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, resilience_max_retries=1,
        resilience_backoff_ms=1.0), device="cpu")
    rng = np.random.default_rng(61)
    streams, twins = _two_streams(app, rng)

    def down(*_a):
        raise InjectedFault("megabatch.dispatch")

    monkeypatch.setattr(app.megabatch, "begin_wake", down)
    pkts = synth.paced_gop(rng, seq0=65530, ts0=0xFFFFF000, ssrc=0x51,
                           frames=12, packets_per_frame=4)
    _wakes(app, streams, twins, pkts, 6, pause_s=0.005)
    # two scheduler faults (a retry, then the drop), then the device rung:
    # the scheduler is no longer asked, each engine serves its stream
    assert app.device_errors == app.device_errors_injected == 2
    assert app.pump_errors == 0
    for s in streams:
        assert app.ladder.level(s.session_path) == LEVEL_DEVICE
        assert [o.rtp_packets for o in s.outputs] == \
            [o.rtp_packets for o in twins[id(s)].outputs]
        assert all(o.rtp_packets for o in s.outputs)
    assert app.stats()["device_param_refreshes"] >= 2
    assert app.stats()["resilience"]["ladder"]["degrades"] == 2


@pytest.mark.parametrize("site", ["scheduler", "engine"])
def test_a_real_device_error_moves_no_rung(site, monkeypatch):
    """A real (not injected) exception of the scheduler or of an engine's
    device work is counted and is a pump error, but moves no rung: no
    stream is served around it by the host scalar path.  A failed
    scheduler leaves the wake's streams to their own engines; a failed
    engine step sends nothing for its stream."""
    import numpy as np
    from easydarwin_tpu_torch.ops import device_ring
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    from easydarwin_tpu_torch.utils import synth
    # the engine site: two streams below a gate of 3, so each engine runs
    # on its own device ring, whose append fails
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, resilience_max_retries=0,
        megabatch_min_streams=2 if site == "scheduler" else 3),
        device="cpu")
    rng = np.random.default_rng(62)
    streams, twins = _two_streams(app, rng)

    def down(*_a):
        raise RuntimeError("launch failed")

    if site == "scheduler":
        monkeypatch.setattr(app.megabatch, "begin_wake", down)
    else:
        monkeypatch.setattr(device_ring, "append_rows", down)
    pkts = synth.paced_gop(rng, seq0=300, ts0=0, ssrc=0x53, frames=12,
                           packets_per_frame=4)
    _wakes(app, streams, twins, pkts, 4)
    assert app.device_errors == app.pump_errors > 0
    assert app.device_errors_injected == 0
    assert app.ladder.status() == {}
    for s in streams:
        got = [o.rtp_packets for o in s.outputs]
        if site == "scheduler":
            assert got == [o.rtp_packets for o in twins[id(s)].outputs]
        else:
            assert got == [[]] * len(got)


def test_a_broken_output_moves_no_rung():
    import numpy as np
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    from easydarwin_tpu_torch.utils import synth
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       resilience_max_retries=0),
                          device="cpu")
    rng = np.random.default_rng(7)
    streams, twins = _two_streams(app, rng, broken=True)
    pkts = synth.paced_gop(rng, seq0=100, ts0=0, ssrc=0x52, frames=12,
                           packets_per_frame=4)
    _wakes(app, streams, twins, pkts, 4)
    assert app.pump_errors == 4 and app.device_errors == 0
    assert app.ladder.status() == {}
    good = streams[1]
    assert [o.rtp_packets for o in good.outputs] == \
        [o.rtp_packets for o in twins[id(good)].outputs]


def test_rtx_giveup_and_rr_spoof_reach_the_ladder_and_controllers():
    import struct
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.resilience import INJECTOR, FaultPlan
    from easydarwin_tpu_torch.resilience import LEVEL_DEVICE
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       resilience_max_retries=0),
                          device="cpu")
    app.rtsp.on_rtx_giveup("/live/nacked")
    assert app.ladder.level("/live/nacked") == LEVEL_DEVICE
    out = CollectingOutput(ssrc=0xABCD)
    seen = []
    out.on_receiver_report = seen.append
    class Conn:                         # a player connection's RTCP view
        player_tracks = {1: out}
        relay = path = None
        last_activity = 0.0

    conn = Conn()
    rr = struct.pack("!BBHIIIIIII", 0x81, 201, 7, 0x77, 0xABCD,
                     64 << 24, 0, 0, 0, 0)
    try:
        app.rtsp.on_client_rtcp(rr, conn=conn)
        INJECTOR.arm(FaultPlan(seed=1, rr_loss_spoof=0.5))
        app.rtsp.on_client_rtcp(rr, conn=conn)
        assert INJECTOR.counts()["rr_loss_spoof"] == 1
    finally:
        INJECTOR.disarm()
    assert seen == [64 / 256.0, 0.5]


def test_parked_tcp_records_age_out_as_orphans():
    import time
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       rtsp_timeout_sec=5), device="cpu")
    n0 = obs.RESILIENCE_CKPT_TCP_ORPHANS.value()
    app._park_tcp_record("/live/t", 1, {"kind": "tcp"})    # no session id
    assert obs.RESILIENCE_CKPT_TCP_ORPHANS.value() == n0 + 1
    app._park_tcp_record("/live/t", 1, {"kind": "tcp", "session_id": "s1"})
    app._park_tcp_record("/live/t", 1, {"kind": "tcp", "session_id": "s2"})
    assert app.claim_tcp_restore("/live/t", 1, "s1")["session_id"] == "s1"
    assert app.claim_tcp_restore("/live/t", 1, "s1") is None
    app._sweep_restored()
    assert len(app._pending_tcp) == 1          # s2 still within the timeout
    rec, _t0 = app._pending_tcp[("/live/t", 1, "s2")]
    app._pending_tcp[("/live/t", 1, "s2")] = (rec, time.monotonic() - 6)
    app._sweep_restored()
    assert app._pending_tcp == {}
    assert obs.RESILIENCE_CKPT_TCP_ORPHANS.value() == n0 + 2
