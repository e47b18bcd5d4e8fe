"""The gates the reference's reliability-tier and serving-path keys set in
the port, held against the reference on the CPU:

* ``reliable_udp`` and ``fec_enabled``: a UDP SETUP's ``x-Retransmit``
  and ``x-FEC`` replies, the output's wrap and its FEC state equal the
  reference's under each key on and off (with configured parity and RTX
  payload types), read at each SETUP;
* ``fec_device = false``: a window's parity is the host product, the
  reference's parity bytes, with no device pass; ``storage_device =
  false``: a stripe's parity and a two-shard reconstruct are the
  reference's, with no device pass;
* ``megabatch_enabled`` and ``megabatch_min_streams``: the scheduler
  engages on exactly the wakes the reference's does as streams join, and
  every output's wire equals ``RelayStream.reflect``; off, the VOD
  pacer's device prime is off too;
* ``tcp_engine_enabled = false``: interleaved outputs are served by the
  batch-header rung (none by the TCP rung), their wire equal to the
  reference's reflect and to the engine's TCP rung;
* ``timeout_sweep_sec``: under a patched monotonic clock a silent player
  is closed at the first sweep past ``rtsp_timeout_sec``, on the same
  second in both packages.
"""

import asyncio
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.server import app as ref_app_mod
from easydarwin_tpu.server import rtsp as ref_rtsp_mod
from easydarwin_tpu.server.config import ServerConfig as RefConfig
from easydarwin_tpu.server.rtsp import RtspConnection as RefConnection
from easydarwin_tpu.storage.codec import StripeCodec as RefCodec
from easydarwin_tpu_torch.models import relay_pipeline
from easydarwin_tpu_torch.protocol import rtsp
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.reliable import ReliableUdpOutput
from easydarwin_tpu_torch.relay.stream import RelayStream
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server import rtsp as rtsp_mod
from easydarwin_tpu_torch.server.rtsp import (attach_fec,
                                              negotiate_retransmit)
from easydarwin_tpu_torch.storage import StorageService
from easydarwin_tpu_torch.storage.codec import StripeCodec
from easydarwin_tpu_torch.utils import loopback, synth

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fec import _fec_output, _media, _push, _split  # noqa: E402
from test_torch_fec import _stream as _fec_stream  # noqa: E402
from test_torch_relay import _MixedTwins, _deframe, _packets  # noqa: E402

#: (reliable_udp, fec_enabled, fec_payload_type, rtx_payload_type)
_GATES = [(True, True, 127, 126), (True, True, 110, 109),
          (False, True, 110, 109), (True, False, 127, 126),
          (False, False, 127, 126)]
_ASKS = [{"x-fec": "parity"}, {"x-retransmit": "our-retransmit"},
         {"x-retransmit": "our-retransmit;window=64"},
         {"x-fec": "parity", "x-retransmit": "our-retransmit"}]


def _gate_kw(rel, fec_on, pt, rtx) -> dict:
    return dict(reliable_udp=rel, fec_enabled=fec_on, fec_payload_type=pt,
                rtx_payload_type=rtx, fec_device=False)


def _reference(headers: dict, is_tcp: bool, kw: dict):
    """The reference's reply headers and output for one SETUP."""
    conn = types.SimpleNamespace(server=types.SimpleNamespace(
        config=RefConfig(**kw)))
    req = types.SimpleNamespace(headers=headers)
    t = rtsp.TransportSpec(protocol="RTP/AVP", is_tcp=is_tcp)
    out = RefOutput(ssrc=1)
    out, extra = RefConnection._negotiate_retransmit(conn, req, out, t)
    extra = dict(extra)
    extra.update(RefConnection._attach_fec(conn, req, out, t))
    return extra, out


@pytest.mark.parametrize("gate", _GATES)
def test_setup_helpers_follow_the_keys_as_the_reference(gate):
    kw = _gate_kw(*gate)
    cfg = ServerConfig(**kw)
    tiers = dict.fromkeys(("retransmit_granted", "retransmit_refused",
                           "fec_granted", "fec_refused"), 0)
    for headers in _ASKS:
        for is_tcp in (False, True):
            want, ref_out = _reference(headers, is_tcp, kw)
            t = rtsp.TransportSpec(protocol="RTP/AVP", is_tcp=is_tcp)
            out = CollectingOutput(ssrc=1)
            out, got = negotiate_retransmit(
                headers.get("x-retransmit", ""), out, t, cfg, tiers)
            got = dict(got)
            got.update(attach_fec(headers.get("x-fec", ""), out, t, cfg,
                                  "cpu", tiers))
            assert got == want, (headers, is_tcp)
            assert isinstance(out, ReliableUdpOutput) == \
                hasattr(ref_out, "resender")
            ref_fec_state = getattr(ref_out, "fec", None)
            assert (out.fec is None) == (ref_fec_state is None)
            if out.fec is not None:
                for name in ("window", "payload_type", "rtx_payload_type",
                             "use_device"):
                    assert getattr(out.fec.cfg, name) == \
                        getattr(ref_fec_state.cfg, name), name
                assert out.fec.cfg.device is None
    rel, fec_on = gate[:2]
    assert (tiers["retransmit_granted"] > 0) == rel
    assert (tiers["retransmit_refused"] > 0) == (not rel)
    assert (tiers["fec_refused"] > 0) == (not fec_on)


async def test_udp_setups_follow_the_keys_at_each_setup(tmp_path):
    """Through a server: each SETUP's grants equal the reference's under
    the config as it stands at that SETUP (a ``setbaseconfig``-style
    ``update`` between SETUPs takes effect at the next one)."""
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        log_folder=str(tmp_path / "logs"),
        **_gate_kw(*_GATES[1])), device="cpu")
    await app.start()
    pusher = loopback.MiniClient()
    players = []
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        for gate in _GATES[1:]:
            kw = _gate_kw(*gate)
            app.config.update(**kw)
            for headers in _ASKS:
                player = loopback.MiniClient()
                players.append(player)
                await player.connect(app.rtsp.port)
                await player.request("DESCRIBE", uri)
                resp = await player.request("SETUP", uri + "/trackID=1", {
                    "transport": "RTP/AVP;unicast;client_port="
                                 f"{await player.udp_ports()}", **headers})
                got = {k: v for k, v in resp.headers.items()
                       if k in ("x-fec", "x-retransmit")}
                want, ref_out = _reference(headers, False, kw)
                assert got == {k.lower(): v for k, v in want.items()}, \
                    (gate, headers)
                conn = next(c for c in app.rtsp.connections
                            if c.session_id == player.session)
                out = conn.player_tracks[1]
                assert isinstance(out, ReliableUdpOutput) == \
                    hasattr(ref_out, "resender")
                assert (out.fec is None) == \
                    (getattr(ref_out, "fec", None) is None)
                if out.fec is not None:
                    assert (out.fec.cfg.payload_type,
                            out.fec.cfg.rtx_payload_type) == gate[2:]
        tiers = app.stats()["loss_tiers"]
        assert tiers["fec_refused"] > 0 and tiers["retransmit_refused"] > 0
    finally:
        for c in (pusher, *players):
            if c._task is not None:
                await c.close()
        await app.stop()


# ------------------------------------------------------- host parity paths
def _no_device(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a device pass ran with the device key off")
    monkeypatch.setattr(relay_pipeline, "fec_parity_window_step", refuse)


@pytest.mark.parametrize("window", [8, 16])
def test_fec_device_off_sends_the_reference_host_parity(window,
                                                        monkeypatch):
    _no_device(monkeypatch)
    rng = np.random.default_rng(window + 40)
    cfg = ServerConfig(fec_window=window, fec_device=False,
                       fec_payload_type=110, rtx_payload_type=109)
    ref_cfg = RefConfig(fec_window=window, fec_device=False,
                        fec_payload_type=110, rtx_payload_type=109)
    port, ref = _fec_stream(), _fec_stream(port=False)
    outs = []
    for idx, ssrc, seq0 in ((1, 0xA1, 40_000), (4, 0xC3, 17)):
        p = _fec_output(cfg.fec_config("cpu"), overhead_idx=idx, ssrc=ssrc,
                        seq0=seq0)
        r = _fec_output(ref_cfg.fec_config(), overhead_idx=idx, ssrc=ssrc,
                        seq0=seq0, port=False)
        port.add_output(p)
        ref.add_output(r)
        outs.append((p, r))
    pkts = _media(rng, 160, seq0=65_500)
    _push(port, pkts)
    _push(ref, pkts)
    for p, r in outs:
        assert p.rtp_packets == r.rtp_packets
        _m, par, _x = _split(p.rtp_packets, p.fec.cfg)
        assert par and all((x[1] & 0x7F) == 110 for x in par)
    assert port.fec.device_passes == ref.fec.device_passes == 0
    assert port.fec.host_passes > 0 and port.fec.oracle_mismatches == 0
    assert port.fec.windows_emitted == ref.fec.windows_emitted


def _blobs(k: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=400 + 37 * i,
                         dtype=np.uint8).tobytes() for i in range(k)]


@pytest.mark.parametrize("k,m,lost", [(4, 2, (0, 1)), (4, 2, (1, 3)),
                                      (5, 3, (0, 2))])
def test_storage_device_off_is_the_reference_host_codec(k, m, lost,
                                                        monkeypatch):
    _no_device(monkeypatch)
    blobs = _blobs(k, k + m)
    port = StripeCodec(k, m, device="cpu", use_device=False)
    ref = RefCodec(k, m, use_device=False)
    parity = port.parity(blobs)
    assert parity == ref.parity(blobs)
    lens = [len(b) for b in blobs]
    crcs = [zlib.crc32(b) & 0xFFFFFFFF for b in blobs]
    present = {i: b for i, b in enumerate(blobs) if i not in lost}
    present.update({k + p: blob for p, blob in enumerate(parity)})
    got = port.reconstruct(dict(present), lens, asset="t", crcs=crcs)
    assert got == ref.reconstruct(dict(present), lens, asset="t")
    assert got == {i: blobs[i] for i in lost}
    assert port.device_passes == 0 and port.device is None
    assert port.host_products == 2 and port.oracle_mismatches == 0
    # a corrupt survivor fails the crc32 check on the host path too
    bad = dict(present)
    bad[k + 1] = bytes(x ^ 1 for x in bad[k + 1])
    with pytest.raises(Exception, match="host product fails its check"):
        port.reconstruct(bad, lens, asset="t", crcs=crcs)


def test_the_server_builds_the_store_as_its_key_says(tmp_path):
    for on in (True, False):
        app = StreamingServer(ServerConfig(
            rtsp_port=0, service_port=0, movie_folder=str(tmp_path / "m"),
            dvr_enabled=True, storage_enabled=True, storage_device=on),
            device="cpu")
        assert app.storage.codec.use_device is on
        assert (app.storage.codec.device is None) is (not on)
        assert app.storage.stats()["host_products"] == 0
        app.storage.close()
    st = StorageService(str(tmp_path / "s"), "n", k=2, m=1, device="cpu",
                        use_device=False)
    assert st.codec.use_device is False
    st.close()


# ------------------------------------------------------ the megabatch gate
class _RefEngine:
    """The reference engine's stand-in: its scalar oracle (the gate under
    test is the scheduler's, not the engine's device path)."""

    megabatch_owned = False

    def step(self, stream, t):
        return stream.reflect(t)


class _RefScheduler:
    def __init__(self):
        self.engaged: list[int] = []

    def begin_wake(self, pairs, t):
        self.engaged.append(len(pairs))

    def end_wake(self, pairs, t):
        pass

    def idle_wake(self):
        pass


def _add_stream(registry, path, rng, twins):
    stream = next(iter(registry.find_or_create(
        path, loopback.VIDEO_SDP).streams.values()))
    twin = RelayStream(stream.info, stream.settings) if twins is not None \
        else None
    for _ in range(2):
        kw = dict(ssrc=int(rng.integers(1 << 32)),
                  out_seq_start=int(rng.integers(1 << 16)),
                  out_ts_start=int(rng.integers(1 << 32)))
        if twins is None:
            stream.add_output(RefOutput(**kw))
        else:
            stream.add_output(CollectingOutput(**kw))
            twin.add_output(CollectingOutput(**kw))
    if twins is not None:
        twins[id(stream)] = (stream, twin)
    return stream


@pytest.mark.parametrize("enabled,min_streams",
                         [(True, 3), (False, 2), (True, 2), (False, 3)])
def test_the_megabatch_engages_exactly_when_the_reference_does(
        enabled, min_streams, monkeypatch):
    from easydarwin_tpu_torch.relay.session import now_ms
    kw = dict(rtsp_port=0, service_port=0, megabatch_enabled=enabled,
              megabatch_min_streams=min_streams)
    app = StreamingServer(ServerConfig(**kw), device="cpu")
    ref = ref_app_mod.StreamingServer(RefConfig(
        **kw, tpu_fanout=True, tpu_min_outputs=1))
    ref.megabatch = _RefScheduler()
    monkeypatch.setattr(ref, "_engine_for", lambda _s: _RefEngine())
    engaged = []
    real = app.megabatch.begin_wake

    def begin(pairs, t):
        engaged.append(len(pairs))
        return real(pairs, t)

    monkeypatch.setattr(app.megabatch, "begin_wake", begin)
    rng = np.random.default_rng(min_streams + 10 * enabled)
    twins: dict = {}
    pkts = synth.paced_gop(rng, seq0=65_000, ts0=0, ssrc=0x77, frames=12,
                           packets_per_frame=4)
    port_seq, ref_seq = [], []
    for wake in range(12):
        if wake in (0, 3, 6, 9):               # a stream joins each 3 wakes
            path = f"/live/m{wake}"
            _add_stream(app.registry, path, rng, twins)
            _add_stream(ref.registry, path, rng, None)
        t = now_ms()
        for stream, twin in twins.values():
            for pkt in pkts[4 * wake:4 * (wake + 1)]:
                stream.push_rtp(pkt, t)
                twin.push_rtp(pkt, t)
        n0, r0 = len(engaged), len(ref.megabatch.engaged)
        app.reflect_all()
        ref._reflect_all()
        port_seq.append(engaged[n0:])
        ref_seq.append(ref.megabatch.engaged[r0:])
        t = now_ms()
        for _s, twin in twins.values():
            twin.reflect(t)
        for _s, eng in app._pairs():
            assert eng.tcp_fast_enabled is True
    assert port_seq == ref_seq
    assert any(port_seq) == (enabled and min_streams <= 4)
    if enabled:
        first = next(i for i, e in enumerate(port_seq) if e)
        assert first == 3 * (min_streams - 1)
    for stream, twin in twins.values():
        got = [o.rtp_packets for o in stream.outputs]
        assert got == [o.rtp_packets for o in twin.outputs]
        assert all(got)
    st = app.stats()
    assert st["megabatch"]["mismatches"] == 0 and st["missing_params"] == 0
    if not enabled:
        assert st["megabatch"]["passes"] == 0
        assert st["device_param_refreshes"] >= 4
        assert set(st["param_refreshes_by_path"]) == \
            {f"/live/m{w}" for w in (0, 3, 6, 9)}


def test_megabatch_off_turns_the_vod_device_prime_off(tmp_path):
    for on in (True, False):
        app = StreamingServer(ServerConfig(
            rtsp_port=0, service_port=0, movie_folder=str(tmp_path),
            megabatch_enabled=on), device="cpu")
        assert (app.vod_pacer.scheduler() is app.megabatch) is on
        assert (app.vod_pacer.scheduler() is None) is (not on)


# ------------------------------------------------------------ the TCP rung
@pytest.mark.parametrize("owned", [True, False],
                         ids=["megabatch", "per_stream_query"])
def test_tcp_engine_off_serves_interleaved_outputs_on_the_batch_rung(owned):
    wires = {}
    for tcp_fast in (True, False):
        tw = _MixedTwins(["udp", "tcp", "col", "tcp", "udp"], 31)
        eng = FanoutEngine(egress_fd=tw.egress.fileno(), device="cpu")
        eng.tcp_fast_enabled = tcp_fast
        sched = MegabatchScheduler(device="cpu")
        pairs = [(tw.port, eng)]
        feed = _packets(tw.rng, 160)
        t = 1000
        try:
            tw.push(feed[:30], t)
            for wake in range(12):
                tw.push(feed[30 + wake * 9:30 + (wake + 1) * 9], t)
                if wake == 5:
                    tw.add("tcp")
                if owned:
                    sched.begin_wake(pairs, t)
                eng.step(tw.port, t)
                if owned:
                    sched.end_wake(pairs, t)
                tw.ref.reflect(t)
                tw.collect()
                tw.assert_same(wake)
                t += 20
            tcp_pkts = sum(o.packets_sent for kind, o, _r, _s in tw.outs
                           if kind == "tcp")
            assert tcp_pkts > 0
            if tcp_fast:
                assert eng.tcp_sent == tcp_pkts and eng.batch_sent == 0
            else:
                assert eng.tcp_sent == 0 and eng.batch_sent == tcp_pkts
                assert eng.batch_passes > 0
                split = eng.split_flat(eng._flat_outputs(tw.port))
                assert split[1] == [] and {o for o, _b in split[3]} == {
                    o for kind, o, _r, _s in tw.outs if kind == "tcp"}
            assert eng.missing_params == 0 and eng.send_errors == 0
            if owned:
                assert sched.mismatches == 0
            # each connection's RTP frames (its SRs, held to each run's
            # own oracle above, carry that run's wall clock)
            wires[tcp_fast] = [
                [d for c, d in _deframe(bytes(s[1])) if c == o.rtp_channel]
                for kind, o, _r, s in tw.outs if kind == "tcp"]
        finally:
            tw.close()
    assert wires[True] == wires[False]


def test_the_pump_sets_the_tcp_rung_from_the_key():
    rng = np.random.default_rng(5)
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       tcp_engine_enabled=False),
                          device="cpu")
    twins: dict = {}
    _add_stream(app.registry, "/live/t", rng, twins)
    app.reflect_all()
    assert [e.tcp_fast_enabled for _s, e in app._pairs()] == [False]
    app.config.update(tcp_engine_enabled=True)
    app.reflect_all()
    assert [e.tcp_fast_enabled for _s, e in app._pairs()] == [True]


# ------------------------------------------------------------- the sweep
class _Silent:
    """A player connection silent since ``t0``; the sweep that closes it
    notes the fake clock's time (``reaped_at``) as it sets the reason."""

    def __init__(self, clock, t0: float):
        self.clock = clock
        self.is_pusher = False
        self.relay = None
        self.last_activity = t0
        self._reason = None
        self.reaped_at = None
        self.closed = False

    @property
    def abnormal_reason(self):
        return self._reason

    @abnormal_reason.setter
    def abnormal_reason(self, v):
        if self.reaped_at is None:
            self.reaped_at = self.clock[0]
        self._reason = v

    async def close(self):
        self.closed = True


def _fake_time(clock):
    import time as real
    ns = types.SimpleNamespace(**{n: getattr(real, n) for n in dir(real)
                                  if not n.startswith("_")})
    ns.monotonic = lambda: clock[0]
    return ns


@pytest.mark.parametrize("sweep,timeout", [(15, 20), (2, 5), (1, 2)])
async def test_a_silent_player_is_reaped_at_the_first_sweep_past_its_limit(
        sweep, timeout, monkeypatch):
    kw = dict(rtsp_port=0, service_port=0, rtsp_timeout_sec=timeout,
              timeout_sweep_sec=sweep)
    horizon = 3 * (timeout + sweep)
    # the reference: its sweep loop sleeping timeout_sweep_sec on the clock
    clock = [1000.0]
    monkeypatch.setattr(ref_rtsp_mod, "time", _fake_time(clock))
    ref = ref_app_mod.StreamingServer(RefConfig(**kw))
    ref_conn = _Silent(clock, clock[0])
    ref.rtsp.connections.add(ref_conn)
    real_sleep = asyncio.sleep

    async def fake_sleep(s):
        clock[0] += s
        if clock[0] - 1000.0 > horizon or ref_conn.reaped_at is not None:
            ref._running = False
        await real_sleep(0)

    monkeypatch.setattr(ref_app_mod, "asyncio", types.SimpleNamespace(
        sleep=fake_sleep))
    ref._running = True
    await ref._sweep_loop()
    await real_sleep(0)
    # the port: the pump's once-a-second maintenance on the same clock
    clock[0] = 1000.0
    monkeypatch.setattr(rtsp_mod, "time", _fake_time(clock))
    app = StreamingServer(ServerConfig(**kw), device="cpu")
    conn = _Silent(clock, clock[0])
    app.rtsp.connections.add(conn)
    app._arm_sweep(clock[0])                   # as ``start`` does
    sweeps = []
    real_sweep = app.rtsp.sweep_timeouts

    def sweep_spy():
        sweeps.append(clock[0] - 1000.0)
        return real_sweep()

    monkeypatch.setattr(app.rtsp, "sweep_timeouts", sweep_spy)
    while clock[0] - 1000.0 <= horizon and conn.reaped_at is None:
        clock[0] += 1.0                        # the pump's 1 s block
        app._maintenance(clock[0])
        await real_sleep(0)
    want = (timeout // sweep + 1) * sweep      # first sweep past the limit
    assert ref_conn.reaped_at - 1000.0 == want
    assert conn.reaped_at - 1000.0 == want
    assert ref_conn.closed and conn.closed
    assert sweeps == [sweep * i for i in range(1, len(sweeps) + 1)]
    assert conn.abnormal_reason.startswith("timeout: idle")
