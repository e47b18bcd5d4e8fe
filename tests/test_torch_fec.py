"""The port's FEC tier (``easydarwin_tpu_torch.relay.fec``, B4) against the
reference (``easydarwin_tpu.relay.fec``) on the CPU, bit for bit:

* the GF(256) tables, the host product, the Vandermonde rows and the
  solver;
* B4's plain version (``models.relay_pipeline.fec_parity_window_step`` on
  CPU tensors) against the reference's XLA pass at the wire shapes and the
  stripe geometry, with zero rows and zero coefficients; its shape checks;
* the parity and RTX packets' bytes, and ``FecRateController``'s steps on
  the same RR and NADU series;
* ``StreamFec`` on the same pushed stream: the same parity bytes through
  ``RelayStream.reflect``, through ``FanoutEngine`` and in the reference,
  and the same RTX bytes, budget and give-ups for the same NACKs;
* ``FecReceiver`` recovers every dropped packet from parity and from RTX;
  a FEC output keeps its media on the native UDP rung;
* the reference's own cases: a late joiner, a duplicate-seq window, a
  thinned output, the parity cache's hard bound, a payload-type
  collision, and host fallback on an injected device mismatch.

Every output is an integer, so every tolerance is 0.  Output SSRCs, seq
and timestamp origins and the SR wall-clock base are pinned on both
packages.
"""

import socket
import struct

import numpy as np
import pytest
import torch

from easydarwin_tpu.models.relay_pipeline import \
    fec_parity_window_step as ref_parity_step
from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay import fec as ref_fec
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.models.relay_pipeline import \
    fec_parity_window_step
from easydarwin_tpu_torch.ops import fec_kernel, kernel_lib
from easydarwin_tpu_torch.protocol import sdp
from easydarwin_tpu_torch.relay import fec
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings

SDP_TXT = ("v=0\r\ns=f\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
           "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
#: one pinned wall clock for both packages' SR NTP times
WALL = 1_760_000_000.25


def _cfg(**kw) -> fec.FecConfig:
    return fec.FecConfig(device="cpu", **kw)


def _stream(port: bool = True, **settings):
    if port:
        st = RelayStream(sdp.parse(SDP_TXT).streams[0],
                         StreamSettings(bucket_delay_ms=0, **settings))
    else:
        st = RefStream(ref_sdp.parse(SDP_TXT).streams[0],
                       RefSettings(bucket_delay_ms=0, **settings))
    st._wall_base = WALL
    st.reporter_ssrc = 0x1234
    return st


def _fec_output(cfg=None, *, overhead_idx=2, ssrc=0xAABBCCDD, seq0=100,
                ts0=7000, port: bool = True):
    if port:
        out = CollectingOutput(ssrc=ssrc, out_seq_start=seq0,
                               out_ts_start=ts0)
        out.fec = fec.FecOutputState(cfg or _cfg(window=8))
    else:
        out = RefOutput(ssrc=ssrc, out_seq_start=seq0, out_ts_start=ts0)
        out.fec = ref_fec.FecOutputState(cfg or ref_fec.FecConfig(window=8))
    out.fec.controller._idx = overhead_idx
    return out


def _media(rng, n: int, *, seq0=0, pay_len=(40, 300)) -> list[bytes]:
    """``n`` H.264-ish RTP packets of seeded payloads, seqs from ``seq0``
    (wrapping)."""
    out = []
    for i in range(n):
        body = rng.integers(0, 256, int(rng.integers(*pay_len)),
                            dtype=np.uint8).tobytes()
        nal = 0x65 if i % 24 == 0 else 0x41
        out.append(struct.pack("!BBHII", 0x80, 96, (seq0 + i) & 0xFFFF,
                               (i * 3000) & 0xFFFFFFFF, 0xB)
                   + bytes((nal,)) + body)
    return out


def _push(st, pkts, *, t0=1000, step=10, reflect=True, engine=None) -> int:
    t = t0
    for pkt in pkts:
        st.push_rtp(pkt, t)
        t += step
        if engine is not None:
            engine.step(st, t)
        elif reflect:
            st.reflect(t)
    return t


def _split(pkts, cfg):
    media = [p for p in pkts if (p[1] & 0x7F) == 96]
    par = [p for p in pkts if (p[1] & 0x7F) == cfg.payload_type]
    rtx = [p for p in pkts if (p[1] & 0x7F) == cfg.rtx_payload_type]
    return media, par, rtx


# ------------------------------------------------------------ GF arithmetic
def test_gf_tables_and_host_math_equal_the_reference():
    assert np.array_equal(fec.GF_LOG, ref_fec.GF_LOG)
    assert np.array_equal(fec.GF_EXP512, ref_fec.GF_EXP512)
    assert np.array_equal(fec.GF_EXP, ref_fec.GF_EXP)
    rng = np.random.default_rng(3)
    for _ in range(200):
        a, b = (int(x) for x in rng.integers(0, 256, 2))
        n = int(rng.integers(0, 600))
        assert fec.gf_mul(a, b) == ref_fec.gf_mul(a, b)
        assert fec.gf_pow(a, n) == ref_fec.gf_pow(a, n)
        if a:
            assert fec.gf_inv(a) == ref_fec.gf_inv(a)
    coeff = rng.integers(0, 256, (5, 12)).astype(np.uint8)
    coeff[:, 3] = 0
    rows = rng.integers(0, 256, (12, 333)).astype(np.uint8)
    rows[7] = 0
    assert np.array_equal(fec.gf_matmul(coeff, rows),
                          ref_fec.gf_matmul(coeff, rows))
    deltas = [0, 1, 4, 9, 30, 47]
    for n_parity in (1, 3, 8):
        assert np.array_equal(fec.coeff_rows(deltas, n_parity),
                              ref_fec.coeff_rows(deltas, n_parity))
    assert np.array_equal(fec.coeff_for_indices(deltas, [0, 2, 5]),
                          ref_fec.coeff_for_indices(deltas, [0, 2, 5]))
    data = rng.integers(0, 256, (10, 40)).astype(np.uint8)
    par = fec.gf_matmul(fec.coeff_rows(range(10), 4), data)
    miss, known = [1, 4, 8, 9], [0, 2, 3, 5, 6, 7]
    synd = par ^ fec.gf_matmul(fec.coeff_for_indices(known, range(4)),
                               data[known])
    a = fec.coeff_for_indices(miss, range(4))
    got = fec.gf_solve(a, synd)
    assert np.array_equal(got, ref_fec.gf_solve(a, synd))
    assert np.array_equal(got, data[miss])
    assert fec.gf_solve(np.array([[1, 1], [1, 1]], np.uint8),
                        np.eye(2, dtype=np.uint8)) is None


# ---------------------------------------------------------- B4's plain version
@pytest.mark.parametrize("k,b,r", [(8, 256, 1), (16, 512, 4), (48, 2048, 8),
                                   (16, 2048, 2), (4, 65_536, 2)])
def test_parity_plain_equals_the_reference_pass(k, b, r):
    rng = np.random.default_rng(11 + k + r)
    rows = rng.integers(0, 256, (k, b)).astype(np.uint8)
    rows[k // 2] = 0                          # a zero (padding) row
    rows[0, ::7] = 0                          # zero bytes inside a row
    coeff = np.zeros((r, k), np.uint8)
    coeff[:, :max(k - 2, 1)] = fec.coeff_rows(range(max(k - 2, 1)), r)
    if r > 1:
        coeff[1, 0] = 0                       # a zero coefficient
    want = np.asarray(ref_parity_step(rows, coeff))
    got = fec_parity_window_step(torch.from_numpy(rows),
                                 torch.from_numpy(coeff))
    assert got.dtype == torch.uint8 and got.shape == (r, b)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, fec.gf_matmul(coeff, rows))


@pytest.mark.parametrize("k,b,r,dtype", [
    (65, 256, 1, torch.uint8), (16, 256, 9, torch.uint8),
    (16, 300, 2, torch.uint8), (16, 0, 2, torch.uint8),
    (16, 256, 2, torch.int32)])
def test_parity_shapes_outside_the_kernel_range_raise(k, b, r, dtype):
    rows = torch.zeros((k, b), dtype=dtype)
    coeff = torch.ones((r, k), dtype=torch.uint8)
    kernel_lib.reset_launch_counts()
    with pytest.raises(ValueError):
        fec_parity_window_step(rows, coeff)
    with pytest.raises(ValueError):
        fec_parity_window_step(torch.zeros((16, 256), dtype=torch.uint8),
                               torch.ones((2, 15), dtype=torch.uint8))
    assert kernel_lib.LAUNCHES["ed_gf_parity"] == 0


# ----------------------------------------------------------- wire formats
@pytest.mark.parametrize("seed", range(4))
def test_parity_and_rtx_packets_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    deltas = sorted(set(int(x) for x in rng.integers(0, 48, 12)))
    kw = dict(fec_pt=int(rng.integers(96, 128)),
              fec_seq=int(rng.integers(1 << 17)),
              ts=int(rng.integers(1 << 33)), ssrc=int(rng.integers(1 << 32)),
              snbase=int(rng.integers(1 << 16)), deltas=deltas,
              idx=int(rng.integers(8)), kind=int(rng.integers(2)),
              payload=rng.bytes(int(rng.integers(0, 1400))))
    pkt = fec.build_parity_packet(**kw)
    assert pkt == ref_fec.build_parity_packet(**kw)
    assert fec.parse_parity_packet(pkt) == ref_fec.parse_parity_packet(pkt)
    assert fec.parse_parity_packet(pkt)["deltas"] == deltas
    assert fec.parse_parity_packet(pkt[:20]) is None
    orig = (struct.pack("!BBHII", 0x80, 96 | (0x80 * (seed % 2)),
                        int(rng.integers(1 << 16)),
                        int(rng.integers(1 << 32)),
                        int(rng.integers(1 << 32)))
            + rng.bytes(int(rng.integers(1, 1300))))
    rtx_seq = int(rng.integers(1 << 16))
    rtx = fec.build_rtx_packet(orig, rtx_pt=126, rtx_seq=rtx_seq)
    assert rtx == ref_fec.build_rtx_packet(orig, rtx_pt=126, rtx_seq=rtx_seq)
    assert fec.restore_rtx_packet(rtx, media_pt=96) == \
        ref_fec.restore_rtx_packet(rtx, media_pt=96) == \
        (struct.unpack_from("!H", orig, 2)[0], orig)


# ------------------------------------------------------------ closed loop
def test_rate_controller_steps_like_the_reference():
    rng = np.random.default_rng(9)
    for max_overhead in (0.30, 0.10, 0.0):
        port = fec.FecRateController(max_overhead)
        ref = ref_fec.FecRateController(max_overhead)
        for _ in range(400):
            if rng.random() < 0.2:
                delay = int(rng.choice([0xFFFF, 40, 149, 151, 2000]))
                free = int(rng.choice([0, 10, 23, 24, 500]))
                a, b = port.on_nadu(delay, free), ref.on_nadu(delay, free)
            else:
                frac = float(rng.choice([0.0, 0.004, 0.01, 0.03, 0.08,
                                         0.15, 0.25, 0.6]))
                a = port.on_receiver_report(frac)
                b = ref.on_receiver_report(frac)
            assert a == b
            for window in (8, 16, 48):
                for kind in (fec.KIND_XOR, fec.KIND_RS):
                    assert port.parity_rows(window, kind=kind) == \
                        ref.parity_rows(window, kind=kind)
        assert (port.steps_up, port.steps_down) == (ref.steps_up,
                                                    ref.steps_down)
        assert port.steps_up > 0 or max_overhead == 0.0
    # 8% sustained climbs to the 10% rung that covers it, and holds
    c = fec.FecRateController()
    for _ in range(15):
        c.on_receiver_report(20 / 256)
    assert c.overhead == 0.10 and c.parity_rows(16) == 2


def test_config_validation_like_the_reference():
    for kw in (dict(window=64), dict(window=1), dict(kind="raid6"),
               dict(payload_type=200),
               dict(payload_type=126, rtx_payload_type=126)):
        with pytest.raises(ValueError):
            fec.FecConfig(**kw).validate()
        with pytest.raises(ValueError):
            ref_fec.FecConfig(**kw).validate()
    port, ref = fec.FecConfig(), ref_fec.FecConfig()
    for name in ("window", "max_overhead", "kind", "payload_type",
                 "rtx_payload_type", "rtx_budget_per_sec", "rtx_burst",
                 "kind_code"):
        assert getattr(port, name) == getattr(ref, name)
    assert port.device == "cuda"


# ---------------------------------------------- StreamFec, three ways
_OUTS = ((1, 0xA1, 40_000, 11), (2, 0xB2, 65_530, 22),
         (4, 0xC3, 17, 33))


def _twins(window: int):
    """A port stream for ``reflect``, one for ``FanoutEngine`` and a
    reference stream, each with one FEC output per row of ``_OUTS``
    (overhead rung, SSRC, seq origin, ts origin)."""
    streams = [_stream(), _stream(), _stream(port=False)]
    outs = [[], [], []]
    for idx, ssrc, seq0, ts0 in _OUTS:
        for j, st in enumerate(streams):
            port = j < 2
            cfg = _cfg(window=window) if port else \
                ref_fec.FecConfig(window=window)
            out = _fec_output(cfg, overhead_idx=idx, ssrc=ssrc, seq0=seq0,
                              ts0=ts0, port=port)
            st.add_output(out)
            outs[j].append(out)
    return streams, outs


@pytest.mark.parametrize("window", [8, 16])
def test_stream_fec_emits_the_reference_parity_and_rtx(window):
    rng = np.random.default_rng(window)
    (port, engined, ref), (p_outs, e_outs, r_outs) = _twins(window)
    pkts = _media(rng, 150, seq0=65_500)
    eng = FanoutEngine(device="cpu")
    t = _push(port, pkts)
    _push(engined, pkts, engine=eng)
    _push(ref, pkts)
    for p, e, r in zip(p_outs, e_outs, r_outs):
        assert p.rtp_packets == r.rtp_packets
        assert e.rtp_packets == r.rtp_packets
        assert p.rtcp_packets == r.rtcp_packets
        _media_p, par, _ = _split(p.rtp_packets, p.fec.cfg)
        assert par and p.fec.parity_sent == r.fec.parity_sent == len(par)
    for name in ("windows_emitted", "windows_skipped", "device_passes",
                 "oracle_mismatches"):
        assert getattr(port.fec, name) == getattr(ref.fec, name), name
    assert port.fec.device_passes > 0 and port.fec.oracle_mismatches == 0
    assert port.fec.parity_sent == sum(o.fec.parity_sent for o in p_outs)
    # NACKs: replays, the token bucket and give-ups
    for p, r in zip(p_outs, r_outs):
        p.rtp_packets.clear()
        r.rtp_packets.clear()
    for j, (p, r) in enumerate(zip(p_outs, r_outs)):
        seq0 = _OUTS[j][2]
        nacks = [(seq0 + 20 + i) & 0xFFFF for i in range(0, 120, 3)]
        nacks += [(seq0 + 70_000) & 0xFFFF]     # never ingested: skipped
        for now in (t, t, t + 100):
            a = port.fec.replay_nacked(p, nacks, now)
            b = ref.fec.replay_nacked(r, nacks, now)
            assert a == b
        assert p.rtp_packets == r.rtp_packets and p.rtp_packets
        assert (p.fec.rtx_sent, p.fec.rtx_giveups) == \
            (r.fec.rtx_sent, r.fec.rtx_giveups)
        assert p.fec.rtx_giveups > 0            # the burst of 32 ran out
    assert port.fec.rtx_giveups == sum(o.fec.rtx_giveups for o in p_outs)
    assert port.fec.rtx_sent == sum(o.fec.rtx_sent for o in p_outs)


def test_receiver_recovers_every_drop_from_parity_and_rtx():
    rng = np.random.default_rng(5)
    st = _stream()
    cfg = _cfg(window=8)
    out = _fec_output(cfg, overhead_idx=4)       # 30%: 3 rows per 8
    st.add_output(out)
    t = _push(st, _media(rng, 64))
    media, par, _ = _split(out.rtp_packets, cfg)
    assert len(media) == 64 and st.fec.windows_emitted == 8
    port_rx = fec.FecReceiver(media_pt=96, fec_pt=cfg.payload_type,
                              rtx_pt=cfg.rtx_payload_type)
    ref_rx = ref_fec.FecReceiver(media_pt=96, fec_pt=cfg.payload_type,
                                 rtx_pt=cfg.rtx_payload_type)
    dropped = {}
    for p in media:
        seq = struct.unpack_from("!H", p, 2)[0]
        if seq % 8 in (1, 4, 6) or seq % 16 == 3:  # 3-4 losses a window
            dropped[seq] = p
            continue
        for rx in (port_rx, ref_rx):
            assert rx.on_packet(p) == "media"
    for p in par:
        for rx in (port_rx, ref_rx):
            assert rx.on_packet(p) == "fec"
    assert port_rx.recovered == ref_rx.recovered
    unrecovered = [s for s in dropped if port_rx.have(s) is None]
    assert unrecovered and len(port_rx.recovered) >= 8
    out.rtp_packets.clear()
    assert st.fec.replay_nacked(out, unrecovered, t) == len(unrecovered)
    for p in _split(out.rtp_packets, cfg)[2]:
        assert port_rx.on_packet(p) == "rtx"
    for seq, orig in dropped.items():
        assert port_rx.have(seq) == orig, seq
    kept = next(p for p in media
                if struct.unpack_from("!H", p, 2)[0] not in dropped)
    assert port_rx.on_packet(kept) == "dup"
    assert port_rx.on_packet(b"\x00" * 20) == "junk"


def test_fec_output_keeps_media_on_the_native_udp_rung():
    """Media through the engine's native scatter to a real socket, parity
    through ``send_bytes``: the recovered bytes equal the wire capture."""
    assert native.available()
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.setblocking(False)
    recv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        st = _stream()
        cfg = _cfg(window=8)
        out = _fec_output(cfg, overhead_idx=4)
        out.native_addr = recv.getsockname()
        st.add_output(out)
        eng = FanoutEngine(egress_fd=send.fileno(), device="cpu")
        wire = []
        t = 1000
        for pkt in _media(np.random.default_rng(3), 48, pay_len=(60, 65)):
            st.push_rtp(pkt, t)
            t += 10
            eng.step(st, t)
            while True:
                try:
                    wire.append(recv.recv(65536))
                except BlockingIOError:
                    break
        assert len(wire) == 48 and eng.native_sent == 48
        media, par, _ = _split(out.rtp_packets, cfg)
        assert media == [] and len(par) >= 15
        assert st.fec.oracle_mismatches == 0
        rx = fec.FecReceiver(media_pt=96, fec_pt=cfg.payload_type,
                             rtx_pt=cfg.rtx_payload_type)
        dropped = {}
        for p in wire:
            seq = struct.unpack_from("!H", p, 2)[0]
            if seq % 8 in (2, 5):
                dropped[seq] = p
                continue
            rx.on_packet(p)
        for p in par:
            rx.on_packet(p)
        assert dropped
        for seq, orig in dropped.items():
            assert rx.recovered.get(seq) == orig, seq
    finally:
        recv.close()
        send.close()


# -------------------------------------------------- the reference's cases
def test_late_joiner_windows_start_after_join():
    rng = np.random.default_rng(1)
    pkts = _media(rng, 40)
    st = _stream()
    _push(st, pkts[:20], reflect=False)
    out = _fec_output()
    st.add_output(out)
    assert out.fec.next_window * 8 >= 20
    _push(st, pkts[20:], t0=2000)
    _, par, _ = _split(out.rtp_packets, out.fec.cfg)
    assert par
    for p in par:
        d = fec.parse_parity_packet(p)
        # every protected seq is one the output sent: its seq space starts
        # at 100 with the fast-start packet
        assert d is not None and d["snbase"] >= 100


def test_window_with_duplicate_seqs_is_skipped():
    st = _stream()
    out = _fec_output()
    st.add_output(out)
    _push(st, [struct.pack("!BBHII", 0x80, 96, 5, 0, 0xB) + bytes(30)] * 16)
    _, par, _ = _split(out.rtp_packets, out.fec.cfg)
    assert par == [] and st.fec.windows_skipped >= 1


def test_thinned_output_sends_no_parity_and_no_rtx():
    rng = np.random.default_rng(2)
    st = _stream()
    thinned = _fec_output(overhead_idx=2)
    thinned.thinning.controller.level = 2     # keyframes only
    st.add_output(thinned)
    _push(st, _media(rng, 32))
    assert _split(thinned.rtp_packets, thinned.fec.cfg)[1] == []
    st2 = _stream()
    out = _fec_output(overhead_idx=0)
    st2.add_output(out)
    _push(st2, _media(rng, 16))
    out.thinning.controller.level = 1
    out.rtp_packets.clear()
    assert st2.fec.replay_nacked(out, [103, 104], 50_000) == 0
    assert out.rtp_packets == [] and out.fec.rtx_giveups == 0


def test_parity_cache_hard_bound_survives_a_stalled_subscriber():
    rng = np.random.default_rng(4)
    pkts = _media(rng, 264)
    st = _stream()
    fast = _fec_output(overhead_idx=2)
    stalled = _fec_output(overhead_idx=2, ssrc=2, seq0=7)
    st.add_output(fast)
    st.add_output(stalled)
    t = _push(st, pkts[:8])                   # both primed + window 0
    stalled.block_next = 10 ** 9              # WOULD_BLOCK for ever
    _push(st, pkts[8:], t0=t)
    assert len(st.fec._cache) <= st.fec.CACHE_WINDOWS
    assert len(st.fec._cached_rows) <= st.fec.CACHE_WINDOWS
    assert _split(fast.rtp_packets, fast.fec.cfg)[1]


def test_payload_type_collision_leaves_the_stream_unprotected():
    st = _stream()
    st.info.payload_type = 127
    out = _fec_output()
    st.add_output(out)
    assert out.fec is None
    assert st.fec is None or st.fec.outputs == []


def test_an_injected_device_mismatch_raises_and_is_counted(monkeypatch):
    rng = np.random.default_rng(6)
    pkts = _media(rng, 32)
    st = _stream()
    out = _fec_output(overhead_idx=2)
    st.add_output(out)

    def bad_plain(rows, coeff):               # a deliberately wrong pass
        return torch.ones((coeff.shape[0], rows.shape[1]),
                          dtype=torch.uint8)

    monkeypatch.setattr(fec_kernel, "gf_parity_plain", bad_plain)
    with pytest.raises(fec.FecOracleError):
        _push(st, pkts[:16])
    assert st.fec.oracle_mismatches == 1
    _media_p, par, _ = _split(out.rtp_packets, out.fec.cfg)
    assert par == []                          # no unchecked row went out
    # the pass stays on the kernel: once it is right again the held
    # window goes out, oracle-true, and recovery works
    monkeypatch.undo()
    passes = st.fec.device_passes
    _push(st, pkts[16:], t0=5000)
    assert st.fec.device_passes > passes
    assert st.fec.oracle_mismatches == 1
    media, par, _ = _split(out.rtp_packets, out.fec.cfg)
    rx = fec.FecReceiver(media_pt=96)
    for p in media[1:]:
        rx.on_packet(p)
    for p in par:
        rx.on_packet(p)
    seq = struct.unpack_from("!H", media[0], 2)[0]
    assert rx.recovered.get(seq) == media[0]


def test_stream_registration_and_removal():
    st = _stream()
    out = _fec_output()
    plain = CollectingOutput(ssrc=2, out_seq_start=2)
    st.add_output(out)
    st.add_output(plain)                      # no .fec: not registered
    assert st.fec.outputs == [out] and st.tickable_outputs == []
    st.remove_output(out)
    assert st.fec.outputs == []
    drained = st.fec.drain_counters()
    assert set(drained) == set(fec.StreamFec.COUNTERS)
