#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``easydarwin_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``easydarwin_tpu_torch/csrc`` and
drives the port's live-relay and transcode paths on the card, phase by
phase; any failed phase raises and the script exits non-zero.

1. build     nvcc the kernel library, one nvcc per source started together
             (seconds printed)
2. card      the card's name and power limit (nvidia-smi), and the fp32
             matmul settings (TF32 must be off)
3. K1        ``ed_parse_packets`` vs the plain parse, bit-exact, on 600
             fuzzed rows, the main path's 256, 4,096 (16×256), 1,024, 1,
             63 and 4,097 rows, rows of 97 and 100 bytes, and a view whose
             first byte is not 16-byte aligned (``prefix[1:]``, W = 97)
4. window    the library's launch geometry against the Python plans, then
             ``ed_relay_window`` vs the plain window pass, every bucket
             bit-exact: the phase-6 wake ([8,16,100] + [8,32,100], each
             ×[8,256,6]) as ONE grouped launch, a mixed group (prime
             [1,16,100]×[1,8,6], ragged 5 of 8 at [8,64,100]×[8,16,6],
             MAX_STAGE_ROWS [16,1024,100]×[16,8,6]), config 4
             [16,256,100]×[16,256,6], ragged P = 13, W = 104, and 33
             buckets (two launches)
4b. ring     ``ed_ring_query`` vs ``device_ring.query_params_plain`` on the
             same card ring, bit-exact: C = 4,096 at S = 64 and S = 256,
             heads that wrapped the ring several times, a partly filled
             ring, a ring with no keyframe (−1), fuzzed rows with runts and
             length-0 rows, C = 1,000 and C = 100 (S = 300, more
             subscribers than the grid has threads); three back-to-back
             queries on one ring and two rings queried in turn on one
             stream; the ring's arrival counter back at 0 after each
4c. gf      ``ed_gf_parity`` (B4) vs ``gf_parity_plain`` on the card,
             bit-exact: the wire shape [16,2048]x[2,16] (and R = 1, 8;
             B = 256; K = 48, 64), 40 fuzzed K <= 64, R <= 8, B <= 4,096
             with zero rows, bytes and coefficients, and the stripe
             [4,1 MiB]x[2,4]; the wire and stripe shapes also vs the host
             ``gf_matmul``; K = 65, R = 9, B = 300 and an odd address raise
             without a launch; ``StripeCodec(4, 2)`` parity and a two-loss,
             crc-checked reconstruct of 4 × 1 MiB blobs on the card equal
             the host product (2 device passes, 0 mismatches)
5. K2        ``ed_decode_blocks`` vs ``decode_blocks_plain`` at N = 1, 300,
             48,960 (one 1080p 4:2:0 frame), 48,961, T·stages + 1 (one
             past a full ring of tiles), CTAs·T·stages + 1 (every CTA
             wraps its ring, the last tile ragged) and 783,360 (config 5:
             16 sources × one 1080p frame): |diff| <= 1 on < 1% of
             pixels; N = 0 returns empty without a launch
6. scheduler the main path in-process: MegabatchScheduler + FanoutEngine
             over 16 streams × 256 subscribers in 2 buckets for 36 wakes,
             every wire byte held against RelayStream.reflect, plus the
             RelayPipeline(use_pallas_parse=True) step each wake;
             ``ed_relay_window`` launches = the scheduler's window_calls,
             at most one per dispatching and one per priming wake
6b. native   config 4 with native egress, in-process: phase 6's traffic
             for 9 wakes (a join at wake 6, the last delay bucket's first
             sends at wake 8) to 16 × 256 ``UdpOutput``s on one shared
             egress socket (one loopback receiver a subscriber as far as
             RLIMIT_NOFILE allows): the engines' ``native_sent`` equals the
             scalar oracle's count, every received datagram equals the
             oracle's bytes for its (SSRC, seq), and a datagram not
             received is allowed only where the host's UDP RcvbufErrors
             rose by as many; the wake split (begin_wake / steps /
             end_wake) beside phase 6's
7. server    ``python -m easydarwin_tpu_torch --device cuda`` on loopback:
             2 pushers × 4 TCP players, every packet checked; the players
             went through ``ed_stream_send`` (``native_sent`` > 0)
7b. config2  BASELINE config 2 through the CLI server: one pusher of paced
             1080p30 H.264 (13 packets of about 1.3 KB a frame, an IDR
             every 30 frames, 5 s), 64 UDP players joining one a frame;
             every datagram checked, ``ed_ring_query`` launched,
             ``ed_relay_window`` not (the megabatch idles at one stream),
             ``native_sent`` > 0 and the egress core loaded; the first
             join's wake printed apart from the p50 and the max (the
             server warms the card in ``start``)
7c. rtcp     BASELINE config 2 with RTCP through the CLI server: one pusher
             of paced 1080p30 H.264 (FU-A, 13 packets of about 1.3 KB a
             frame, an IDR every 30 frames, 7 s) and an AAC track (one
             packet of 200-400 bytes each 21.3 ms), an SR + SDES per track
             each second; 64 UDP players of both tracks joining one a
             frame, each sending an RR a second: 48 plain, 8 with
             x-RTP-Meta-Info tt;sq;md, 8 that report 35% loss once (one
             thinning level).  Every SR on its output's SSRC, timeline
             and the host clock; plain datagrams equal to the oracle;
             meta-info md and sq equal to the oracle's packet; thinned
             video a frame-whole level-1 subset of the oracle, audio
             whole; the pusher's upstream RRs; the server's
             ed_parse_packets > 0 (B9, the batch-header rung, on the
             card), native_sent covering the plain players, batch_sent
             covering the meta-info packets
7d. lossy   BASELINE config 2 with the reliability tier through the CLI
             server: phase 7b's pusher for 8 s, 64 UDP players joining one
             a frame: 40 plain; 16 with x-FEC: parity that drop media at
             8% (seeded), send an RR each 0.5 s reporting 20/256 and a
             generic NACK for each packet parity did not rebuild; 8 with
             x-Retransmit: our-retransmit that drop at 5% and ack each
             datagram they keep with a 'qtak' APP.  Every player's span
             byte-equal to the oracle; FEC oracle mismatches 0 (a
             mismatch raises in the pump), device passes = the server's
             ed_gf_parity launches, RTX and reliable give-ups 0; per FEC
             player the packets rebuilt by parity and by RTX; the wake
             p50, max and first join; the host ms per FEC window split
             into staging + H2D, kernel + D2H and the host oracle
8. pipeline  the config-5 TranscodePipeline (qualities 80/50/25 from 90,
             decode_pixels) for 8 steps of 783,360 blocks on the card:
             8 K2 launches, one step held against the same pipeline on the
             CPU
9. ladder    the live MJPEG ladder through the CLI server: one VGA 4:2:0
             source, 6 frames at 10 fps, REST starttranscode rungs 40 and
             20s2, one TCP player per rung; every delivered rung frame
             decodes and matches the CPU requantization oracle of its
             source frame; the host split per frame is printed
10. kernels  launches on the main path (phases 6-9), the launch floor
             (one graph node of an empty kernel), ptxas registers, shared
             memory and spills, CUDA-event times at the main path's shapes
             (K1 256 rows, the window's phase-6 wake group, the ring query
             at config 2's C = 4,096 × S = 64, K2 config 5)
             and at earlier runs' config-4 shapes (K1 4,096 rows, window
             [16,256,100]×[16,256,6], and the same bytes as
             [64,64,100]×[64,64,6] with no cluster) beside the plain
             versions', the bound, the achieved GB/s and share of the
             bound and, for K2, cuBLAS's fp32 product alone; the kernels
             line carries the main path's shapes.  The ring query at
             C = 4,096 with S = 64 and 256, the engine's whole join query on the host (state upload, launch,
             readback, oracle: ``FanoutEngine._device_params``), and the
             ring queried again after the graph replays, bit-exact;
             ``relay_batch_step`` (B9: K1 + torch ops) on the card against
             the same call on CPU tensors, bit-exact on every key, at
             phase 7c's shape and at config 4's (P = 256, S = 256), timed
             beside its bound and its CPU time; ``ed_gf_parity`` at the
             wire shape (the kernels line) and the stripe beside its bound
             and its plain version; B7, the ladder's requant at config 5,
             in a graph beside its byte bound

The kernel launch counts are set to 0 just before phase 6 and read just
after phase 9 (the server processes report their own at exit, without
their start-up warm-up); the comparisons and timings of phases 3, 4, 4b,
4c, 5 and 10 run outside that window.
Detail goes to ``chiprun_out/chip_smoke.json``.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth and the 32-bit
#: non-tensor rate, which is the rate the kernels' integer work and K2's
#: fp32 work (no tensor cores at full fp32) run at
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: BASELINE config 5: 16 sources × one 1080p 4:2:0 frame (1920×1088:
#: 32,640 Y + 2 × 8,160 C blocks)
FRAME_1080P_BLOCKS = 48_960
CONFIG5_SOURCES = 16
CONFIG5_BLOCKS = CONFIG5_SOURCES * FRAME_1080P_BLOCKS
#: K2's tolerance against its plain version, the reference's own
#: (tests/test_transform.py): |diff| <= 1 on < 1% of pixels
K2_MAX_DIFF, K2_MAX_FRAC = 1, 0.01
#: integer operations ``parse_row`` does per packet, counted from the
#: source (field assembly ≈ 20, header size 3, NAL resolution ≈ 15,
#: classification ≈ 12)
OPS_PER_PACKET = 50
#: per packet in the window pass: the parse, the le32 decode and the max
OPS_PER_WINDOW_ROW = OPS_PER_PACKET + 8
#: per subscriber in the window pass: two subtractions, a mask, 4 stores
OPS_PER_SUBSCRIBER = 7

#: where the port runs; the phases that drive it (5, 6) read this
DEVICE = "cuda"
HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def call_ms(fn, reps: int, inner: int) -> float:
    """Median per-call time by CUDA events around ``inner`` back-to-back
    direct calls (host enqueue included: a launch-bound call measures the
    host), after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    samples.sort()
    return samples[len(samples) // 2]


def graph_ms(fn, reps: int = 21, inner: int = 100) -> float:
    """Median per-call device time by CUDA events around one replay of a
    CUDA graph holding ``inner`` calls: the host's enqueue cost is out of
    the measurement, so a microsecond kernel is timed at device speed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    samples.sort()
    return samples[len(samples) // 2]


# ------------------------------------------------------------ phases 3-4
def fuzz_rows(rng, n: int, width: int = 96):
    """``n`` fuzzed packets staged as [n, width] prefixes (columns past 96
    hold random bytes) + [n] lengths."""
    import numpy as np
    from easydarwin_tpu_torch.utils import synth
    pre, ln = synth.stage([synth.random_packet(rng) for _ in range(n)])
    extra = rng.integers(0, 256, (n, width - 96), dtype=np.uint8)
    return np.ascontiguousarray(np.concatenate([pre, extra], axis=1)), ln


def compare_parse(prefix, length) -> int:
    """Kernel vs plain parse on the same CUDA tensors; returns the max
    absolute difference over the nine fields (must be 0)."""
    import torch
    from easydarwin_tpu_torch.ops.parse import FIELDS, parse_packets
    from easydarwin_tpu_torch.ops.parse_kernel import parse_packets_kernel
    k = parse_packets_kernel(prefix, length)
    p = parse_packets(prefix, length)
    torch.cuda.synchronize()
    worst = 0
    for f in FIELDS:
        a, b = k[f].cpu().numpy(), p[f].cpu().numpy()
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"K1 {f}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        d = int(abs(a.astype("int64") - b.astype("int64")).max()) if a.size else 0
        check(d == 0, f"K1 field {f} differs from the plain parse (max {d})")
        worst = max(worst, d)
    return worst


def phase_k1(rng) -> dict:
    """K1 against the plain parse at the main path's 256 rows, the old
    config-4 4,096, ragged row counts around the 64-row tile, rows of 97
    and 100 bytes, and a view whose first byte is not 16-byte aligned."""
    import torch
    res = {}
    for name, n, width in (("fuzz600", 600, 96), ("main_path_256", 256, 96),
                           ("config4_16x256", 16 * 256, 96),
                           ("max_stage_rows_1024", 1024, 96), ("p1", 1, 96),
                           ("p63", 63, 96), ("p4097", 4097, 96),
                           ("w97", 600, 97), ("w100", 600, 100)):
        pre, ln = fuzz_rows(rng, n, width)
        res[name] = compare_parse(torch.from_numpy(pre).cuda(),
                                  torch.from_numpy(ln).cuda())
        log(f"[k1] {name}: [{n},{width}] bit-exact vs plain parse")
    pre, ln = fuzz_rows(rng, 601, 97)
    view = torch.from_numpy(pre).cuda()[1:]
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "the unaligned K1 case is not unaligned")
    res["w97_view_offset_97"] = compare_parse(
        view, torch.from_numpy(ln[1:].copy()).cuda())
    log(f"[k1] w97_view_offset_97: prefix[1:] of [601,97] (first byte at "
        f"{view.data_ptr() % 16} mod 16) bit-exact vs plain parse")
    return res


def window_inputs(rng, b_real: int, b_pad: int, p: int, s_real: int,
                  s_pad: int, w: int = 100):
    """Fused rows + state for a bucket: b_real streams of p fuzzed/paced
    rows (ragged lengths, zero padding rows) and random rewrite state
    that wraps seq and ts; padding streams and subscribers stay zero;
    columns past the le32 length (w > 100) hold random bytes."""
    import numpy as np
    from easydarwin_tpu_torch.ops import fanout
    from easydarwin_tpu_torch.utils import synth
    win = np.zeros((b_pad, p, w), np.uint8)
    win[:, :, 100:] = rng.integers(0, 256, (b_pad, p, w - 100), dtype=np.uint8)
    for i in range(b_real):
        n = int(rng.integers(1, p + 1))      # ragged: live rows then pad
        pkts = [synth.random_packet(rng) for _ in range(n)]
        pre, ln = synth.stage(pkts)
        win[i, :n, :100] = fanout.pack_window(pre, ln)
    st = np.zeros((b_pad, s_pad, 6), np.uint32)
    st[:b_real, :s_real] = rng.integers(0, 1 << 32, size=(b_real, s_real, 6),
                                        dtype=np.uint64).astype(np.uint32)
    return win, st


def window_group(rng, specs) -> list:
    """CUDA (window, state) pairs, one per (b_real, b_pad, P, s_real,
    s_pad[, W]) bucket spec."""
    import torch
    pairs = []
    for spec in specs:
        win, st = window_inputs(rng, *spec)
        pairs.append((torch.from_numpy(win).cuda(),
                      torch.from_numpy(st).cuda()))
    return pairs


#: the scheduler's wake in phase 6: 8 streams of 6 and 8 of 20 new packets
#: a wake, padded to 16 and 32 rows, each with 256 subscribers
WAKE_GROUP = ((8, 8, 16, 256, 256), (8, 8, 32, 256, 256))


def compare_windows(pairs) -> tuple[int, int]:
    """One grouped kernel call vs the plain pass per bucket; returns (max
    difference over every bucket, must be 0; launches the call made)."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    before = kernel_lib.LAUNCHES["ed_relay_window"]
    outs = fanout.relay_affine_step_windows(pairs)
    launched = kernel_lib.LAUNCHES["ed_relay_window"] - before
    worst = 0
    for (dw, ds), out in zip(pairs, outs):
        k = out.cpu().numpy()
        p = fanout.relay_affine_step_window_plain(dw, ds).cpu().numpy()
        check(k.dtype == np.uint32 and k.shape == p.shape, "window dtype/shape")
        d = int(np.abs(k.astype(np.int64) - p.astype(np.int64)).max())
        check(d == 0, f"window kernel differs from the plain pass (max {d}) "
              f"at {tuple(dw.shape)}x{tuple(ds.shape)}")
        worst = max(worst, d)
    torch.cuda.synchronize()
    return worst, launched


def relay_geometry() -> dict:
    """The relay kernels' constants as the library has them, held against
    the Python launch plans that mirror them."""
    import ctypes
    from easydarwin_tpu_torch.ops import fanout, kernel_lib, parse_kernel
    from easydarwin_tpu_torch.ops import device_ring
    names = ("max_buckets", "max_cluster", "window_threads", "tile_rows",
             "smem_limit", "ring_tile_rows")
    vals = [ctypes.c_int() for _ in names]
    rc = kernel_lib.library().ed_relay_geometry(
        *(ctypes.byref(v) for v in vals))
    check(rc == 0, f"ed_relay_geometry: {rc}")
    geo = dict(zip(names, (v.value for v in vals)))
    check((geo["max_buckets"], geo["max_cluster"], geo["tile_rows"],
           geo["smem_limit"], geo["ring_tile_rows"]) == (
               fanout.WINDOW_MAX_BUCKETS, fanout.WINDOW_MAX_CLUSTER,
               parse_kernel.PARSE_TILE_ROWS, kernel_lib.DYN_SMEM_LIMIT,
               device_ring.RING_TILE_ROWS),
          f"the library's relay geometry {geo} differs from the Python plans")
    return geo


def phase_window(rng) -> dict:
    """Every bucket of each grouped call bit-exact against the plain pass:
    the phase-6 wake as one launch, a mixed group (prime, ragged, the
    MAX_STAGE_ROWS bucket: cluster size 8), config 4, ragged P = 13,
    W = 104, and a group of more buckets than one launch takes."""
    from easydarwin_tpu_torch.ops import fanout
    res = {}
    split = ((1, 1, 16 if i % 2 else 32, 3, 8)
             for i in range(fanout.WINDOW_MAX_BUCKETS + 1))
    for name, specs, launches in (
            ("wake_group", WAKE_GROUP, 1),
            ("mixed_group", ((1, 1, 16, 8, 8), (5, 8, 64, 13, 16),
                             (16, 16, 1024, 8, 8)), 1),
            ("config4", ((16, 16, 256, 256, 256),), 1),
            ("ragged_p13", ((3, 4, 13, 5, 8),), 1),
            ("w104", ((4, 4, 32, 6, 8, 104), (2, 2, 256, 3, 8, 104)), 1),
            ("split_33", tuple(split), 2)):
        pairs = window_group(rng, specs)
        res[name], launched = compare_windows(pairs)
        check(launched == launches, f"window {name}: {launched} launches, "
              f"expected {launches}")
        shapes = ", ".join(f"[{tuple(w.shape)}x{tuple(s.shape)}]"
                           for w, s in pairs[:3])
        more = f" (+{len(pairs) - 3} more)" if len(pairs) > 3 else ""
        log(f"[window] {name}: {shapes}{more}: {launched} launch(es), "
            f"every bucket bit-exact vs plain pass")
    return res


# ------------------------------------------------------------- phase 4b
#: the per-stream ring's capacity (``relay/ring.py DEFAULT_CAPACITY``) and
#: config 2's subscribers
RING_C, CONFIG2_SUBS = 4096, 64


def fuzzed_ring(rng, capacity: int, n_total: int, keyframes: bool = True):
    """A card ring after ``n_total`` appends of 512-row batches: fuzzed
    packets with one row in 12 of length 0 and one in 25 a runt, or (no
    ``keyframes``) P-frame packets only."""
    import numpy as np
    from easydarwin_tpu_torch.ops import device_ring as dr
    from easydarwin_tpu_torch.utils import synth
    if keyframes:
        pool = [synth.random_packet(rng) for _ in range(2048)]
    else:
        pool = [synth.h264_packet(i, 3000 * i, 1, ssrc=7, body=bytes(60))
                for i in range(2048)]
    pre, ln = synth.stage(pool)
    ln[rng.random(len(ln)) < 1 / 12] = 0
    ln[rng.random(len(ln)) < 1 / 25] = 7
    ring = dr.init_ring(capacity, device=DEVICE)
    done = 0
    while done < n_total:
        n = min(512, capacity, n_total - done)
        pick = rng.integers(0, len(pool), n)
        dr.append(ring, pre[pick], ln[pick],
                  rng.integers(0, 1 << 20, n).astype(np.int32), n)
        done += n
    return ring


def ring_state(rng, n_subs: int):
    import numpy as np
    import torch
    st = rng.integers(0, 1 << 32, size=(n_subs, 6), dtype=np.uint64)
    return torch.from_numpy(st.astype(np.uint32)).to(DEVICE)


def ring_diff(ring, st, k) -> int:
    """Max |kernel − plain| over one query's words (must be 0)."""
    import numpy as np
    from easydarwin_tpu_torch.ops import device_ring as dr
    p = dr.query_params_plain(ring, st).cpu().numpy()
    k = k.cpu().numpy()
    words = 4 * st.shape[0] + 1
    check(k.dtype == np.uint32 and k.shape == p.shape == (words,),
          f"ring query {k.dtype}{k.shape} vs {p.shape}")
    return int(np.abs(k.astype(np.int64) - p.astype(np.int64)).max())


def counter_at_zero(ring) -> None:
    import torch
    torch.cuda.synchronize()
    check(int(ring.scratch[-1]) == 0,
          f"the ring's arrival counter is {int(ring.scratch[-1])} after a "
          f"query, not 0")


def phase_ring_query(rng) -> dict:
    """``ed_ring_query`` vs its plain version on the same card ring;
    queries back to back on one ring and in turn on two."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import device_ring as dr
    from easydarwin_tpu_torch.ops import kernel_lib
    res = {}
    rings = {}
    for name, cap, n_subs, n_total, keyframes in (
            ("wrapped5_s64", RING_C, 64, 5 * RING_C + 123, True),
            ("wrapped3_s256", RING_C, 256, 3 * RING_C + 7, True),
            ("partly_filled_s256", RING_C, 256, 1000, True),
            ("no_keyframe_s64", RING_C, 64, RING_C + 300, False),
            ("c1000_s64", 1000, 64, 3 * 1000 + 17, True),
            ("c100_s300", 100, 300, 7 * 100 + 3, True)):
        ring = fuzzed_ring(rng, cap, n_total, keyframes)
        st = ring_state(rng, n_subs)
        rings[name] = (ring, st)
        before = kernel_lib.LAUNCHES["ed_ring_query"]
        k = dr.query_params(ring, st)
        check(kernel_lib.LAUNCHES["ed_ring_query"] == before + 1,
              f"ring {name}: not one ed_ring_query launch")
        d = ring_diff(ring, st, k)
        check(d == 0, f"ed_ring_query differs from the plain query in "
              f"{name} (max {d})")
        counter_at_zero(ring)
        newest = int(k.cpu().numpy()[-1].astype(np.int32))
        if keyframes:
            check(ring.head - cap <= newest < ring.head,
                  f"ring {name}: newest keyframe {newest} outside the "
                  f"window of head {ring.head}")
        else:
            check(newest == -1, f"ring {name}: newest keyframe {newest}")
        res[name] = d
        log(f"[ring] {name}: C={cap} S={n_subs} head={ring.head} newest "
            f"keyframe {newest}: bit-exact vs the plain query, counter back "
            f"at 0")
    # three queries back to back on one ring, nothing between them
    ring, st = rings["wrapped5_s64"]
    outs = [dr.query_params(ring, st) for _ in range(3)]
    res["back_to_back_3"] = max(ring_diff(ring, st, k) for k in outs)
    check(res["back_to_back_3"] == 0, "back-to-back ring queries differ")
    counter_at_zero(ring)
    # two rings queried in turn on one stream
    other, st2 = rings["c1000_s64"]
    outs = [(r, s, dr.query_params(r, s))
            for r, s in ((ring, st), (other, st2)) * 2]
    res["two_rings_in_turn"] = max(ring_diff(r, s, k) for r, s, k in outs)
    check(res["two_rings_in_turn"] == 0, "rings queried in turn differ")
    counter_at_zero(ring)
    counter_at_zero(other)
    log("[ring] three back-to-back queries on one ring and two rings "
        "queried in turn on one stream: bit-exact, counters back at 0")
    torch.cuda.synchronize()
    return res


# ------------------------------------------------------------- phase 4c
#: B4's wire shape: a 16-packet window of 1080p rows (pow2 of ≈1.3 KB is
#: 2,048 bytes) and 2 parity rows (10% overhead); the stripe codec's: 4
#: blobs of 1 MiB and 2 parity shards
GF_WIRE = (16, 2048, 2)
GF_STRIPE = (4, 1 << 20, 2)
#: per (parity row, row, column) product: the log add, the antilog
#: gather, the zero mask and the XOR; per (row, column): the log gather
#: and the zero test
OPS_PER_GF_PRODUCT = 4
OPS_PER_GF_BYTE = 2


def gf_inputs(rng, k: int, b: int, r: int):
    """Fuzzed ``rows [k, b]`` and ``coeff [r, k]`` uint8 on the card, with
    a zero row, zero bytes and zero coefficients."""
    import numpy as np
    import torch
    rows = rng.integers(0, 256, (k, b), dtype=np.uint8)
    coeff = rng.integers(0, 256, (r, k), dtype=np.uint8)
    rows[int(rng.integers(k))] = 0
    rows[rng.random((k, b)) < 0.05] = 0
    coeff[rng.random((r, k)) < 0.2] = 0
    if k > 1:
        coeff[:, int(rng.integers(k))] = 0
    return torch.from_numpy(rows).cuda(), torch.from_numpy(coeff).cuda()


def gf_bound(k: int, b: int, r: int) -> tuple[int, int]:
    """(bytes, operations) one ``ed_gf_parity`` call must move and do:
    rows and coefficients read once, parity written once."""
    return (k * b + r * k + r * b,
            OPS_PER_GF_PRODUCT * r * k * b + OPS_PER_GF_BYTE * k * b)


def phase_gf(rng) -> dict:
    """``ed_gf_parity`` vs ``gf_parity_plain`` on the card, bit-exact, at
    the wire shapes, 40 fuzzed (K <= 64, R <= 8, B <= 4,096) and the
    stripe; shapes out of range raise without a launch; the stripe codec's
    parity and a two-loss reconstruct of 4 × 1 MiB blobs on the card equal
    the host product."""
    import zlib
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops.fec_kernel import gf_parity, gf_parity_plain
    from easydarwin_tpu_torch.relay.fec import coeff_rows, gf_matmul
    from easydarwin_tpu_torch.storage.codec import StripeCodec
    shapes = [GF_WIRE, (16, 2048, 1), (16, 2048, 8), (16, 256, 2),
              (48, 2048, 8), (64, 4096, 8), (1, 256, 1)]
    shapes += [(int(rng.integers(1, 65)), 256 * int(rng.integers(1, 17)),
                int(rng.integers(1, 9))) for _ in range(40)]
    shapes.append(GF_STRIPE)
    err = 0
    for k, b, r in shapes:
        rows, coeff = gf_inputs(rng, k, b, r)
        before = kernel_lib.LAUNCHES["ed_gf_parity"]
        got = gf_parity(rows, coeff)
        check(kernel_lib.LAUNCHES["ed_gf_parity"] == before + 1,
              f"gf [{k},{b}]x[{r},{k}]: not one launch")
        want = gf_parity_plain(rows, coeff)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        check(got.dtype == torch.uint8 and torch.equal(got, want),
              f"ed_gf_parity [{k},{b}]x[{r},{k}] differs from the plain "
              f"version")
        if (k, b, r) in (GF_WIRE, GF_STRIPE):
            host = gf_matmul(coeff.cpu().numpy(), rows.cpu().numpy())
            err = max(err, int(np.abs(got.cpu().numpy().astype(np.int32)
                                      - host).max()))
            check(np.array_equal(got.cpu().numpy(), host),
                  f"ed_gf_parity [{k},{b}]x[{r},{k}] differs from gf_matmul")
    log(f"[gf] ed_gf_parity bit-exact vs gf_parity_plain at {len(shapes)} "
        f"shapes: wire {GF_WIRE} (and R 1, 8; B 256), 40 fuzzed with zero "
        f"rows, bytes and coefficients, stripe {GF_STRIPE}; the wire and "
        f"stripe shapes also vs the host gf_matmul")
    before = kernel_lib.LAUNCHES["ed_gf_parity"]
    u8 = dict(dtype=torch.uint8, device="cuda")
    for rows, coeff, what in (
            (torch.zeros((65, 256), **u8), torch.ones((2, 65), **u8),
             "K = 65"),
            (torch.zeros((16, 256), **u8), torch.ones((9, 16), **u8),
             "R = 9"),
            (torch.zeros((16, 300), **u8), torch.ones((2, 16), **u8),
             "B = 300"),
            (torch.zeros(16 * 2048 + 1, **u8)[1:].view(16, 2048),
             torch.ones((2, 16), **u8), "rows at an odd address")):
        try:
            gf_parity(rows, coeff)
        except ValueError:
            continue
        raise AssertionError(f"ed_gf_parity took {what}")
    check(kernel_lib.LAUNCHES["ed_gf_parity"] == before,
          "an out-of-range shape launched")
    log("[gf] K = 65, R = 9, B = 300 and rows at an odd address raise "
        "without a launch")
    # the stripe codec on the card: 4 blobs of ≈1 MiB, two lost
    blobs = [rng.integers(0, 256, GF_STRIPE[1] - 41 * i,
                          dtype=np.uint8).tobytes() for i in range(4)]
    codec = StripeCodec(4, 2, device="cuda")
    before = kernel_lib.LAUNCHES["ed_gf_parity"]
    parity = codec.parity(blobs)
    lens = [len(x) for x in blobs]
    stripe = np.zeros((4, max(lens)), np.uint8)
    for i, x in enumerate(blobs):
        stripe[i, :len(x)] = np.frombuffer(x, np.uint8)
    host = gf_matmul(coeff_rows(range(4), 2), stripe)
    check(parity == [host[p].tobytes() for p in range(2)],
          "StripeCodec.parity on the card differs from gf_matmul")
    crcs = [zlib.crc32(x) & 0xFFFFFFFF for x in blobs]
    got = codec.reconstruct({2: blobs[2], 3: blobs[3], 4: parity[0],
                             5: parity[1]}, lens, asset="chip", crcs=crcs)
    check(got == {0: blobs[0], 1: blobs[1]},
          "StripeCodec two-loss reconstruct is not the lost blobs")
    check(codec.oracle_mismatches == 0 and codec.device_passes == 2
          and kernel_lib.LAUNCHES["ed_gf_parity"] == before + 2,
          f"stripe codec: {codec.oracle_mismatches} mismatches, "
          f"{codec.device_passes} device passes")
    log("[gf] StripeCodec(4, 2) on the card: parity of 4 x 1 MiB blobs "
        "equals the host product, a two-loss reconstruct (crc-checked) "
        "returns the lost blobs; 2 device passes, 0 oracle mismatches")
    return {"shapes": len(shapes), "max_abs_err": err,
            "stripe_device_passes": codec.device_passes}


# -------------------------------------------------------------- phase 5
def frame_pixels_1080p(gen, index: int):
    """One 1920×1088 4:2:0 frame of smooth moving gradients plus noise,
    made on the card from ``gen`` → uint8 blocks [48,960, 64] in MCU
    order (4 Y blocks per 16×16 MCU, then Cb, then Cr)."""
    import math
    import torch
    h, w = 1088, 1920
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    luma = (128 + 80 * torch.sin(2 * math.pi * (xx + 37 * index) / w
                                 * (1 + index % 3))
            * torch.cos(math.pi * yy / h)
            + 6 * torch.randn((h, w), device="cuda", generator=gen))
    cy, cx = yy[::2], xx[:, ::2]
    cb = (128 + 60 * (cx / w - 0.5) + 20 * torch.sin(cy / 37 + index)
          + 3 * torch.randn((h // 2, w // 2), device="cuda", generator=gen))
    cr = (128 + 60 * (cy / h - 0.5) + 20 * torch.cos(cx / 53 - index)
          + 3 * torch.randn((h // 2, w // 2), device="cuda", generator=gen))

    def blocks(plane, sub):
        ph, pw = plane.shape
        b = plane.reshape(ph // (8 * sub), sub, 8, pw // (8 * sub), sub, 8)
        return b.permute(0, 3, 1, 4, 2, 5).reshape(-1, 64)
    pix = torch.cat([blocks(luma, 2), blocks(cb, 1), blocks(cr, 1)])
    return torch.clamp(torch.round(pix), 0, 255).to(torch.uint8)


def config5_levels(seed: int, source_quality: int = 90):
    """The config-5 batch: 16 sources × one 1080p frame, ``encode_blocks``
    at the source quality → int32 [783,360, 64] on the card."""
    import torch
    from easydarwin_tpu_torch.ops import transform as tf
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qt = torch.from_numpy(tf.quality_table(source_quality)).cuda()
    lv = torch.cat([tf.encode_blocks(frame_pixels_1080p(gen, i), qt)
                    for i in range(CONFIG5_SOURCES)])
    check(lv.shape == (CONFIG5_BLOCKS, 64), f"config-5 batch {lv.shape}")
    return lv.contiguous(), qt


def k2_diff(a, b) -> tuple[int, float]:
    """(max |diff|, share of pixels that differ) of two uint8 tensors."""
    import torch
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    if d.numel() == 0:
        return 0, 0.0
    return int(d.max()), float((d > 0).double().mean())


def phase_k2(levels, qt, ring: dict) -> dict:
    """K2 vs its plain version on the card at 1, 300, one 1080p frame,
    sizes aimed at the ring's tail and wrap-around, and the config-5
    batch; N = 0 must not launch."""
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops.transform import decode_blocks_plain
    from easydarwin_tpu_torch.ops.transform_kernel import decode_blocks_kernel
    res = {}
    ring_rows = ring["tile_blocks"] * ring["stages"]
    for n in (1, 300, FRAME_1080P_BLOCKS, FRAME_1080P_BLOCKS + 1,
              ring_rows + 1, ring["ctas"] * ring_rows + 1, CONFIG5_BLOCKS):
        lv = levels[:n]
        k = decode_blocks_kernel(lv, qt)
        p = decode_blocks_plain(lv, qt)
        torch.cuda.synchronize()
        check(k.dtype == torch.uint8 and k.shape == (n, 64),
              f"K2 N={n}: {k.dtype}{tuple(k.shape)}")
        worst, frac = k2_diff(k, p)
        check(worst <= K2_MAX_DIFF and frac < K2_MAX_FRAC,
              f"K2 N={n}: max diff {worst} on {frac:.4%} of pixels")
        res[f"n{n}"] = {"max_abs_err": worst, "mismatch_frac": frac}
        log(f"[k2] N={n}: max |diff| {worst} on {frac:.6%} of pixels vs "
            f"decode_blocks_plain")
    before = kernel_lib.LAUNCHES["ed_decode_blocks"]
    empty = decode_blocks_kernel(levels[:0], qt)
    check(empty.shape == (0, 64) and empty.dtype == torch.uint8,
          f"K2 N=0 gave {tuple(empty.shape)}")
    check(kernel_lib.LAUNCHES["ed_decode_blocks"] == before,
          "K2 launched for N=0")
    log("[k2] N=0: empty [0,64] uint8, no launch")
    return res


# -------------------------------------------------------------- phase 6
def phase_scheduler(rng) -> dict:
    """16 streams × 256 subscribers through MegabatchScheduler +
    FanoutEngine, each wire byte against the scalar oracle run on an
    identical copy; RelayPipeline(use_pallas_parse=True) on stream 0's
    newest 256 packets every wake, against the ring's host classification."""
    import numpy as np
    from easydarwin_tpu_torch.models.relay_pipeline import (
        RelayPipeline, RelayPipelineConfig)
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.ring import PacketFlags
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
    from easydarwin_tpu_torch.utils import synth
    from easydarwin_tpu_torch.utils.loopback import VIDEO_SDP

    n_streams, n_subs, wakes = 16, 256, 36
    info = sdp.parse(VIDEO_SDP).streams[0]
    settings = StreamSettings(bucket_delay_ms=10)
    sub_rng = np.random.default_rng(int(rng.integers(1 << 31)))
    params = [[(int(sub_rng.integers(1 << 32)), int(sub_rng.integers(1 << 16)),
                int(sub_rng.integers(1 << 32))) for _ in range(n_subs + 8)]
              for _ in range(n_streams)]

    def make(i, j):
        ssrc, seq0, ts0 = params[i][j]
        return CollectingOutput(ssrc=ssrc, out_seq_start=seq0,
                                out_ts_start=ts0)

    dev = [RelayStream(info, settings) for _ in range(n_streams)]
    ora = [RelayStream(info, settings) for _ in range(n_streams)]
    for i in range(n_streams):
        for j in range(n_subs):
            dev[i].add_output(make(i, j))
            ora[i].add_output(make(i, j))
    # two shape buckets: 6 vs 20 new packets per wake pad to 16 vs 32 rows
    burst = [6 if i < n_streams // 2 else 20 for i in range(n_streams)]
    feeds = []
    for i in range(n_streams):
        pkts = []
        while len(pkts) < burst[i] * wakes:
            pkts += synth.paced_gop(rng, seq0=0xFFF0 + len(pkts) + 97 * i,
                                    ts0=0xFFFF0000 + 3000 * len(pkts),
                                    ssrc=0x1000 + i, frames=10,
                                    packets_per_frame=4)
        feeds.append(pkts)
    engines = [FanoutEngine() for _ in range(n_streams)]
    sched = MegabatchScheduler(device=DEVICE)
    pipe = RelayPipeline(RelayPipelineConfig(use_pallas_parse=True),
                         device=DEVICE)
    t = 1000
    delivered = 0
    #: host milliseconds per wake: begin_wake (harvest + prime), the
    #: engine steps (header render + wire writes), end_wake (stage +
    #: dispatch), and the whole wake
    parts = {"begin": [], "steps": [], "end": [], "wake": []}
    #: wakes whose begin_wake primed / whose end_wake dispatched
    priming = dispatching = 0
    launches0 = kernel_lib.LAUNCHES["ed_relay_window"]
    for w in range(wakes):
        for i in range(n_streams):
            for pkt in feeds[i][w * burst[i]:(w + 1) * burst[i]]:
                dev[i].push_rtp(pkt, t)
                ora[i].push_rtp(pkt, t)
        if w == 12:   # membership change on stream 3: 4 leave, 4 join
            for k in range(4):
                for s in (dev[3], ora[3]):
                    s.remove_output(s.outputs[k])
                dev[3].add_output(make(3, n_subs + k))
                ora[3].add_output(make(3, n_subs + k))
        pairs = list(zip(dev, engines))
        calls0 = sched.window_calls
        t0 = time.perf_counter()
        sched.begin_wake(pairs, t)
        t1 = time.perf_counter()
        calls1 = sched.window_calls
        for s, e in pairs:
            e.step(s, t)
        t2 = time.perf_counter()
        sched.end_wake(pairs, t)
        t3 = time.perf_counter()
        check(calls1 - calls0 <= 1 and sched.window_calls - calls1 <= 1,
              f"wake {w}: more than one window call in begin_wake or "
              f"end_wake")
        priming += calls1 - calls0
        dispatching += sched.window_calls - calls1
        for k, a, b in (("begin", t0, t1), ("steps", t1, t2), ("end", t2, t3),
                        ("wake", t0, t3)):
            parts[k].append((b - a) * 1e3)
        for s in ora:
            s.reflect(t)
        for i in range(n_streams):
            for a, b in zip(dev[i].outputs, ora[i].outputs):
                check(a.rtp_packets == b.rtp_packets,
                      f"wake {w} stream {i}: engine bytes differ from the "
                      f"scalar oracle")
                delivered += len(a.rtp_packets)
                a.rtp_packets.clear()
                b.rtp_packets.clear()
        # the K1 pipeline step over stream 0's newest 256 packets
        ring = dev[0].rtp_ring
        ids = np.arange(max(ring.tail, ring.head - 256), ring.head)
        slots = ids % ring.capacity
        prefix = np.zeros((256, 96), np.uint8)
        length = np.zeros(256, np.int32)
        prefix[:len(ids)] = ring.data[slots, :96]
        length[:len(ids)] = ring.length[slots]
        age = np.zeros(256, np.int32)
        age[:len(ids)] = t - ring.arrival[slots]
        out = pipe(prefix, length, age, np.zeros((8, 6), np.uint32),
                   np.zeros(8, np.int32))
        kf = out["keyframe_first"].cpu().numpy()[:len(ids)]
        host_kf = (ring.flags[slots] & PacketFlags.KEYFRAME_FIRST) != 0
        check(np.array_equal(kf, host_kf), f"wake {w}: K1 keyframe flags "
              f"differ from the ring's host classification")
        seq = out["seq"].cpu().numpy()[:len(ids)]
        check(np.array_equal(seq.astype(np.int64), ring.seq[slots]),
              f"wake {w}: K1 seq differs from the ring")
        t += 20
    sched.drain()
    st = sched.stats()
    window_launches = kernel_lib.LAUNCHES["ed_relay_window"] - launches0
    check(window_launches == st["window_calls"] == priming + dispatching,
          f"ed_relay_window launched {window_launches} times for "
          f"{st['window_calls']} window calls ({priming} priming + "
          f"{dispatching} dispatching wakes)")
    check(st["mismatches"] == 0, f"scheduler oracle mismatches: {st}")
    check(all(e.missing_params == 0 for e in engines),
          "an engine found no installed params")
    check(delivered > 0, "nothing was delivered")
    res = {"delivered_packets": delivered, "scheduler": st,
           "window_launches": window_launches, "priming_wakes": priming,
           "dispatching_wakes": dispatching}
    for k, v in parts.items():
        v.sort()
        res[f"{k}_host_ms_p50"] = v[len(v) // 2]
        res[f"{k}_host_ms_max"] = v[-1]
    log(f"[scheduler] {delivered} packets to {n_streams}x{n_subs} outputs "
        f"over {wakes} wakes, bit-equal to the scalar oracle; "
        f"passes={st['passes']} prime_passes={st['prime_passes']} "
        f"mismatches={st['mismatches']}; ed_relay_window launches "
        f"{window_launches} = window_calls {st['window_calls']} for "
        f"{dispatching} dispatching + {priming} priming wakes; host ms p50 "
        f"begin/steps/end "
        f"{res['begin_host_ms_p50']:.3f}/{res['steps_host_ms_p50']:.3f}/"
        f"{res['end_host_ms_p50']:.3f}")
    return res


# ------------------------------------------------------------- phase 6b
def udp_rcvbuf_errors() -> int:
    """The host's UDP ``RcvbufErrors`` counter (``/proc/net/snmp``):
    datagrams a full receive buffer dropped."""
    with open("/proc/net/snmp") as f:
        rows = [line.split() for line in f if line.startswith("Udp:")]
    return int(dict(zip(rows[0][1:], rows[1][1:]))["RcvbufErrors"])


def phase_config4_native(rng, phase6: dict, *, wakes: int = 9) -> dict:
    """Phase 6's traffic to 16 × 256 ``UdpOutput``s on one egress socket
    through the engines' native scatter, against the scalar oracle: the
    engines' count, then datagram by datagram (keyed by SSRC and seq); the
    wake split beside phase 6's Python loop on collecting outputs."""
    import resource
    import socket
    import numpy as np
    from easydarwin_tpu_torch import native
    from easydarwin_tpu_torch.protocol import rtp, sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
    from easydarwin_tpu_torch.server.transports import (SharedUdpEgress,
                                                        UdpOutput)
    from easydarwin_tpu_torch.utils import synth
    from easydarwin_tpu_torch.utils.loopback import VIDEO_SDP

    check(native.available(),
          f"the egress core did not build or load: {native.load_error}")
    n_streams, n_subs = 16, 256
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    room = (1 << 20 if hard == resource.RLIM_INFINITY else hard) - 512
    n_rx = max(1, min(n_streams * (n_subs + 4), room))
    receivers = []
    for _ in range(n_rx):
        r = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        r.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        r.bind(("127.0.0.1", 0))
        r.setblocking(False)
        receivers.append(r)
    ports = [r.getsockname()[1] for r in receivers]
    egress = SharedUdpEgress("127.0.0.1")
    egress.rtp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    egress.rtp_sock.setblocking(False)
    egress.rtp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
    info = sdp.parse(VIDEO_SDP).streams[0]
    settings = StreamSettings(bucket_delay_ms=10)
    base = int(rng.integers(1 << 32))
    made = [0]

    def make():
        j = made[0]
        made[0] += 1
        kw = dict(ssrc=(base + 7919 * j) & 0xFFFFFFFF,    # distinct SSRCs
                  out_seq_start=int(rng.integers(1 << 16)),
                  out_ts_start=int(rng.integers(1 << 32)))
        port = ports[j % n_rx]
        return (UdpOutput(egress, "127.0.0.1", port, port + 1, **kw),
                CollectingOutput(**kw))

    dev = [RelayStream(info, settings) for _ in range(n_streams)]
    ora = [RelayStream(info, settings) for _ in range(n_streams)]
    for i in range(n_streams):
        for _ in range(n_subs):
            a, b = make()
            dev[i].add_output(a)
            ora[i].add_output(b)
    burst = [6 if i < n_streams // 2 else 20 for i in range(n_streams)]
    feeds = []
    for i in range(n_streams):
        pkts = []
        while len(pkts) < burst[i] * wakes:
            pkts += synth.paced_gop(rng, seq0=0xFFF0 + len(pkts) + 97 * i,
                                    ts0=0xFFFF0000 + 3000 * len(pkts),
                                    ssrc=0x1000 + i, frames=10,
                                    packets_per_frame=4)
        feeds.append(pkts)
    engines = [FanoutEngine(egress_fd=egress.fileno(), device=DEVICE)
               for _ in range(n_streams)]
    sched = MegabatchScheduler(device=DEVICE)
    native0 = native.get_stats()
    rcvbuf0 = udp_rcvbuf_errors()
    pending: dict = {}
    parts = {"begin": [], "steps": [], "end": [], "wake": []}
    mismatched = received = expected = catch_up = 0
    t = 1000
    w = 0
    while w < wakes or (catch_up < 4 and any(
            a.bookmark != b.bookmark for s, o in zip(dev, ora)
            for a, b in zip(s.outputs, o.outputs))):
        # after the last wake, wakes with no new packets at the same time
        # let an engine that met EAGAIN replay what it held
        catch_up += w >= wakes
        for i in range(n_streams if w < wakes else 0):
            for pkt in feeds[i][w * burst[i]:(w + 1) * burst[i]]:
                dev[i].push_rtp(pkt, t)
                ora[i].push_rtp(pkt, t)
        if w == 6:    # membership change on stream 3: 4 leave, 4 join
            for k in range(4):
                dev[3].remove_output(dev[3].outputs[k])
                ora[3].remove_output(ora[3].outputs[k])
                a, b = make()
                dev[3].add_output(a)
                ora[3].add_output(b)
        pairs = list(zip(dev, engines))
        t0 = time.perf_counter()
        sched.begin_wake(pairs, t)
        t1 = time.perf_counter()
        for s, e in pairs:
            e.step(s, t)
        t2 = time.perf_counter()
        sched.end_wake(pairs, t)
        t3 = time.perf_counter()
        for k, a, b in (("begin", t0, t1), ("steps", t1, t2), ("end", t2, t3),
                        ("wake", t0, t3)):
            parts[k].append((b - a) * 1e3)
        # outside the timed part: the oracle's bytes, then every receiver
        for s in ora:
            s.reflect(t)
            for o in s.outputs:
                for pkt in o.rtp_packets:
                    pending[(o.rewrite.ssrc, rtp.peek_seq(pkt))] = pkt
                expected += len(o.rtp_packets)
                o.rtp_packets.clear()
        for r in receivers:
            while True:
                try:
                    got = r.recv(65536)
                except BlockingIOError:
                    break
                received += 1
                want = pending.pop((rtp.peek_ssrc(got), rtp.peek_seq(got)),
                                   None)
                if want != got:
                    mismatched += 1
        w += 1
        t += 20 if w < wakes else 0
    sched.drain()
    for r in receivers:
        r.close()
    egress.close()
    st = sched.stats()
    sent = sum(e.native_sent for e in engines)
    stats = {k: v - native0[k] for k, v in native.get_stats().items()}
    rcvbuf_errors = udp_rcvbuf_errors() - rcvbuf0
    check(sent == expected, f"the engines sent {sent} datagrams, the scalar "
          f"oracle {expected} (EAGAIN stops {stats['eagain_stops']}, hard "
          f"errors {stats['hard_errors']})")
    check(mismatched == 0, f"{mismatched} received datagrams differ from the "
          f"scalar oracle")
    check(len(pending) <= rcvbuf_errors,
          f"{len(pending)} datagrams not received, but the host's UDP "
          f"RcvbufErrors rose by {rcvbuf_errors}")
    check(st["mismatches"] == 0, f"scheduler oracle mismatches: {st}")
    check(all(e.missing_params == 0 for e in engines),
          "an engine found no params")
    res = {"streams": n_streams, "subscribers": n_subs, "wakes": wakes,
           "catch_up_wakes": catch_up, "receivers": n_rx,
           "rlimit_nofile": [soft, hard],
           "expected_datagrams": expected, "received_datagrams": received,
           "mismatched_datagrams": mismatched, "lost_datagrams": len(pending),
           "udp_rcvbuf_errors": rcvbuf_errors, "native_sent": sent,
           "native_stats": stats, "scheduler": st,
           "send_errors": sum(e.send_errors for e in engines)}
    for k, v in parts.items():
        v.sort()
        res[f"{k}_host_ms_p50"] = v[len(v) // 2]
        res[f"{k}_host_ms_max"] = v[-1]
    log(f"[native] config 4 to {n_streams}x{n_subs} UdpOutputs on one egress "
        f"socket through the native scatter, {n_rx} receivers, {wakes} wakes "
        f"(+{catch_up} catch-up): native_sent {sent} = the oracle's "
        f"{expected}; {received} datagrams received, {mismatched} differ "
        f"from the oracle, {len(pending)} not received (UDP RcvbufErrors "
        f"+{rcvbuf_errors}); sendmmsg calls "
        f"{stats['sendmmsg_calls']}, GSO supers {stats['gso_supers']}, "
        f"EAGAIN stops {stats['eagain_stops']}, hard errors "
        f"{stats['hard_errors']}; host ms p50/max begin "
        f"{res['begin_host_ms_p50']:.3f}/{res['begin_host_ms_max']:.3f} steps "
        f"{res['steps_host_ms_p50']:.3f}/{res['steps_host_ms_max']:.3f} end "
        f"{res['end_host_ms_p50']:.3f}/{res['end_host_ms_max']:.3f} wake "
        f"{res['wake_host_ms_p50']:.3f}/{res['wake_host_ms_max']:.3f}; "
        f"phase 6 (Python loop, CollectingOutput) begin "
        f"{phase6['begin_host_ms_p50']:.3f}/{phase6['begin_host_ms_max']:.3f} "
        f"steps {phase6['steps_host_ms_p50']:.3f}/"
        f"{phase6['steps_host_ms_max']:.3f} end "
        f"{phase6['end_host_ms_p50']:.3f}/{phase6['end_host_ms_max']:.3f} wake "
        f"{phase6['wake_host_ms_p50']:.3f}/{phase6['wake_host_ms_max']:.3f}")
    return res


# -------------------------------------------------------------- phase 7
def phase_server(rng) -> dict:
    """2 pushers × 4 interleaved TCP players through the CLI server; the
    players went through the native framed writev (``ed_stream_send``)."""
    from easydarwin_tpu_torch.utils import loopback
    res = asyncio.run(asyncio.wait_for(loopback.serve_and_check(
        DEVICE, rng, n_push=2, n_play=4, deadline_s=30), 180))
    st = res["server_stats"]
    check(st["native_loaded"], "the server's egress core did not load")
    check(st["native_sent"] > 0, "no TCP player went through ed_stream_send")
    log(f"[server] {res['players']} players x {res['packets_per_player']} "
        f"packets: payload bit-equal, seq/ts rebased per RTP-Info, one SSRC "
        f"each; {st['native_sent']} of {st['packets_out']} packets through "
        f"ed_stream_send; server launches {st['kernel_launches']}")
    return res


# ------------------------------------------------------------- phase 7b
def phase_config2(rng) -> dict:
    """BASELINE config 2 through the CLI server: one 1080p30 source, 64
    UDP players joining one a frame, for about 5 s."""
    from easydarwin_tpu_torch.utils import loopback
    res = asyncio.run(asyncio.wait_for(loopback.serve_and_check(
        DEVICE, rng, n_push=1, n_play=CONFIG2_SUBS, transport="udp", gops=5,
        frames=30, packets_per_frame=13, body_len=(1270, 1300),
        frame_interval_s=1 / 30, join_every=1, deadline_s=30), 240))
    st = res["server_stats"]
    launches = st["kernel_launches"]
    check(st["native_loaded"], "the server's egress core did not load")
    check(launches["ed_ring_query"] > 0, "config 2 launched no ed_ring_query")
    check(launches["ed_relay_window"] == 0,
          "config 2 engaged the megabatch (ed_relay_window launched)")
    check(st["native_sent"] > 0, "no UDP player went through the scatter")
    check(st["send_errors"] == 0 and st["missing_params"] == 0,
          f"config 2 send errors / missing params: {st}")
    log(f"[config2] 1 source x {res['players']} UDP players, "
        f"{res['packets_per_player']} packets pushed, {res['delivered']} "
        f"datagrams delivered, every one checked; native_sent "
        f"{st['native_sent']} of {st['packets_out']}, per-stream queries "
        f"{st['device_param_refreshes']}, launches {launches}; wake host ms "
        f"p50 {st['wake_ms_p50']:.3f} max {st['wake_ms_max']:.3f}")
    log(f"[config2] first join's wake (the server warmed the card in "
        f"start): {st['wake_ms_first']:.3f} host ms")
    return res


# ------------------------------------------------------------- phase 7c
#: phase 7c's players, in join order: six plain, one meta-info, one lossy
RTCP_PLAYERS = [dict(transport="udp", meta=i % 8 == 6, lossy=i % 8 == 7)
                for i in range(CONFIG2_SUBS)]


def phase_rtcp(rng) -> dict:
    """BASELINE config 2 with RTCP: one 1080p30 H.264 + AAC source, 64 UDP
    players (48 plain, 8 meta-info, 8 lossy) sending RRs, for 7 s."""
    from easydarwin_tpu_torch.utils import loopback
    res = asyncio.run(asyncio.wait_for(loopback.serve_and_check(
        DEVICE, rng, harness=loopback.push_play_av, players=RTCP_PLAYERS,
        gops=7, frames=30, packets_per_frame=13, body_len=(1270, 1300),
        deadline_s=30), 300))
    st = res["server_stats"]
    launches = st["kernel_launches"]
    check(st["native_loaded"], "the server's egress core did not load")
    check(launches["ed_parse_packets"] > 0,
          "the batch-header rung launched no ed_parse_packets")
    check(st["native_sent"] >= res["plain_udp_packets"],
          f"native_sent {st['native_sent']} does not cover the plain "
          f"players' {res['plain_udp_packets']} datagrams")
    check(st["batch_sent"] >= res["delivered"]["meta"] > 0,
          f"batch_sent {st['batch_sent']} does not cover the meta-info "
          f"players' {res['delivered']['meta']} packets")
    check(st["native_sent"] + st["batch_sent"] == st["packets_out"],
          f"a packet left on another rung: {st}")
    check(st["send_errors"] == 0 and st["missing_params"] == 0,
          f"rtcp send errors / missing params: {st}")
    check(st["rtcp"]["rr"] > 0, f"no RR reached an output: {st['rtcp']}")
    thin = res["thinned"]
    log(f"[rtcp] 1 source (H.264 + AAC) x {res['players']} UDP players: "
        f"{res['video_packets']} video + {res['audio_packets']} audio "
        f"packets pushed; delivered {res['delivered']}, every packet held "
        f"to the oracle; SRs {res['srs']}; thinned video (got, span) "
        f"{thin}; upstream RRs {res['upstream_rrs']}; native_sent "
        f"{st['native_sent']}, batch_sent {st['batch_sent']} in "
        f"{st['batch_passes']} passes ({st['batch_rows']} rows), RTCP in "
        f"{st['rtcp']}; launches {launches} (ed_ring_query and "
        f"ed_relay_window both printed, not held)")
    log(f"[rtcp] wake host ms p50 {st['wake_ms_p50']:.3f} max "
        f"{st['wake_ms_max']:.3f}, first join's {st['wake_ms_first']:.3f}")
    return res


# ------------------------------------------------------------- phase 7d
#: phase 7d's players, in join order: five plain, two FEC, one reliable
LOSSY_PLAYERS = [dict(kind="plain") if i % 8 < 5
                 else dict(kind="fec", drop=0.08) if i % 8 < 7
                 else dict(kind="reliable", drop=0.05)
                 for i in range(CONFIG2_SUBS)]


def phase_lossy(rng) -> dict:
    """BASELINE config 2 with the reliability tier through the CLI
    server: phase 7b's pusher for 8 s, 64 UDP players joining one a frame
    (40 plain, 16 FEC dropping 8% of media, 8 reliable dropping 5%)."""
    from easydarwin_tpu_torch.utils import loopback
    res = asyncio.run(asyncio.wait_for(loopback.serve_and_check(
        DEVICE, rng, harness=loopback.push_play_lossy, players=LOSSY_PLAYERS,
        gops=8, frames=30, packets_per_frame=13, body_len=(1270, 1300),
        rr_every_s=0.5, deadline_s=60), 400))
    st = res["server_stats"]
    fec, rel = st["fec"], st["reliable"]
    launches = st["kernel_launches"]
    check(st["native_loaded"], "the server's egress core did not load")
    check(fec["oracle_mismatches"] == 0,
          f"FEC parity disagreed with the host oracle: {fec}")
    check(fec["device_passes"] > 0
          and fec["device_passes"] == launches["ed_gf_parity"],
          f"FEC device passes {fec['device_passes']} != the server's "
          f"ed_gf_parity launches {launches['ed_gf_parity']}")
    check(fec["rtx_giveups"] == 0 and rel["giveups"] == 0,
          f"give-ups: RTX {fec['rtx_giveups']}, reliable {rel['giveups']}")
    check(fec["parity_sent"] > 0 and fec["rtx_sent"] > 0,
          f"no parity or no RTX: {fec}")
    check(all(p["parity"] > 0 for p in res["fec_players"]),
          "a FEC player rebuilt nothing from parity")
    check(rel["resends"] > 0 and rel["acks"] > 0, f"reliable: {rel}")
    check(st["send_errors"] == 0 and st["missing_params"] == 0,
          f"lossy send errors / missing params: {st}")
    check(st["batch_sent"] >= res["delivered"]["reliable"],
          "the reliable players' packets left on another rung")
    log(f"[lossy] 1 source x {res['players']} UDP players: "
        f"{res['packets_pushed']} packets pushed in {res['push_s']:.1f} s, "
        f"the last span complete {res['settle_s']:.1f} s later; delivered "
        f"{res['delivered']}, every player's span byte-equal to the oracle; "
        f"FEC {fec['parity_sent']} parity packets in "
        f"{fec['windows_emitted']} windows ({fec['windows_skipped']} "
        f"skipped), {fec['device_passes']} device passes = "
        f"{launches['ed_gf_parity']} ed_gf_parity launches, 0 oracle "
        f"mismatches, RTX {fec['rtx_sent']} sent, 0 give-ups; reliable "
        f"{rel['resends']} resends, {rel['acks']} acks, 0 give-ups; RTCP "
        f"{st['rtcp']}; launches {launches}")
    for p in res["fec_players"]:
        log(f"[lossy] FEC player {p['index']}: {p['packets']} packets, "
            f"{p['dropped']} dropped, {p['parity']} rebuilt from parity, "
            f"{p['rtx']} by RTX ({p['nacks']} NACKs of {p['nacked_seqs']} "
            f"seqs)")
    for p in res["reliable_players"]:
        log(f"[lossy] reliable player {p['index']}: {p['packets']} packets, "
            f"{p['dropped']} dropped, {p['duplicates']} duplicates, "
            f"{p['acks']} acks")
    log(f"[lossy] wake host ms p50 {st['wake_ms_p50']:.3f} max "
        f"{st['wake_ms_max']:.3f}, first join's {st['wake_ms_first']:.3f}; "
        f"host ms per FEC window (device pass): staging + H2D "
        f"{fec['stage_ms_per_window']:.6f}, kernel + D2H "
        f"{fec['kernel_ms_per_window']:.6f}, host oracle "
        f"{fec['oracle_ms_per_window']:.6f}")
    return res


# -------------------------------------------------------------- phase 8
def phase_pipeline(levels) -> dict:
    """The config-5 TranscodePipeline for 8 steps of 783,360 blocks on the
    card (K2 on the pixel leg), step 0 held against the CPU pipeline."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.models import TranscodeConfig, TranscodePipeline
    from easydarwin_tpu_torch.ops import kernel_lib
    cfg = TranscodeConfig(qualities=(80, 50, 25), source_quality=90,
                          decode_pixels=True)
    pipe = TranscodePipeline(cfg, device=DEVICE)
    before = kernel_lib.LAUNCHES["ed_decode_blocks"]
    step_ms, first = [], None
    for s in range(8):
        t0 = time.perf_counter()
        out = pipe(levels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            first = {k: v.cpu() for k, v in out.items()}
    launched = kernel_lib.LAUNCHES["ed_decode_blocks"] - before
    check(launched == 8, f"pipeline launched K2 {launched} times in 8 steps")
    ref = TranscodePipeline(cfg, device="cpu")(levels.cpu())
    rung_d = (first["rungs"].to(torch.int64) - ref["rungs"].to(torch.int64)
              ).abs()
    rung_max = int(rung_d.max())
    rung_frac = float((rung_d > 0).double().mean())
    # bit-exact is expected (IEEE divide and round half to even on both);
    # the reference's own bound for its fused ladder is <= 1 on < 2%
    check(rung_max <= 1 and rung_frac < 0.02,
          f"pipeline rungs off the CPU run: max {rung_max}, {rung_frac:.4%}")
    check(torch.equal(first["nonzeros"], ref["nonzeros"]) or rung_max > 0,
          "pipeline nonzeros differ from the CPU run with equal rungs")
    pix_max, pix_frac = k2_diff(first["pixels"], ref["pixels"])
    check(pix_max <= K2_MAX_DIFF and pix_frac < K2_MAX_FRAC,
          f"pipeline pixels off the CPU run: max {pix_max}, {pix_frac:.4%}")
    nz = first["nonzeros"].tolist()
    check(nz[0] >= nz[1] >= nz[2] > 0, f"nonzeros not monotone: {nz}")
    res = {"blocks": CONFIG5_BLOCKS, "steps": 8, "k2_launches": launched,
           "step_ms": step_ms, "step_ms_p50": float(np.median(step_ms)),
           "rungs_max_abs_err": rung_max, "rungs_mismatch_frac": rung_frac,
           "rungs_bit_exact": rung_max == 0,
           "nonzeros": nz, "nonzeros_equal": bool(
               torch.equal(first["nonzeros"], ref["nonzeros"])),
           "pixels_max_abs_err": pix_max, "pixels_mismatch_frac": pix_frac}
    log(f"[pipeline] 8 steps x {CONFIG5_BLOCKS} blocks, {launched} K2 "
        f"launches, step p50 {res['step_ms_p50']:.3f} ms (host clock, "
        f"synchronized); vs CPU: rungs max {rung_max} on {rung_frac:.6%}, "
        f"pixels max {pix_max} on {pix_frac:.6%}, nonzeros {nz}")
    return res


# -------------------------------------------------------------- phase 9
def phase_ladder(rng) -> dict:
    """The live MJPEG ladder through the CLI server on the card.  VGA is a
    cut forced by the CPython entropy codec (seconds per 1080p frame)."""
    from easydarwin_tpu_torch.utils import mjpeg_loopback
    res = asyncio.run(asyncio.wait_for(mjpeg_loopback.serve_mjpeg_ladder(
        DEVICE, rng, width=640, height=480, n_frames=6, fps=10,
        rungs=("40", "20s2"), deadline_s=120), 300))
    split, last = res["host_ms_per_frame"], res["host_ms_last_frame"]
    rungs = "; ".join(f"{r['path']} {r['frames']} frames from source "
                      f"{r['source_frames']} max |diff| {r['max_abs_err']}"
                      for r in res["rungs"])
    log(f"[ladder] VGA 4:2:0 (cut from 1080p: the host entropy codec is "
        f"CPython) {res['frames_pushed']} frames pushed, "
        f"{res['frames_in']} transcoded, {res['frames_dropped']} dropped "
        f"(newest wins), decode_errors {res['decode_errors']}; {rungs}; "
        f"host ms per frame (mean; newest frame): entropy decode "
        f"{split['entropy_decode']:.3f}; {last['entropy_decode']:.3f}, "
        f"device requant {split['device_requant']:.3f}; "
        f"{last['device_requant']:.3f}, entropy encode "
        f"{split['entropy_encode']:.3f}; {last['entropy_encode']:.3f}")
    return res


# ------------------------------------------------------------- phase 10
def ptxas_report(build_log: str) -> dict:
    """Registers, shared memory and spills of each kernel from the build's
    ``-Xptxas -v`` lines, keyed by the kernel's name."""
    import re
    names = ("parse_packets_kernel", "relay_window_kernel",
             "ring_query_kernel", "launch_floor_kernel",
             "decode_blocks_kernel", "gf_parity_kernel")
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            out[cur]["static_smem_bytes"] = int(m.group(2) or 0)
    return out


def launch_floor_ms() -> float:
    """One graph node of an empty kernel: the card's floor for a launch."""
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    lib = kernel_lib.library()

    def floor():
        rc = lib.ed_launch_floor(torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"ed_launch_floor: {kernel_lib.error_message(rc)}")
    return graph_ms(floor, inner=100)


def phase_kernels(rng, launches: dict, errs: dict, levels, qt
                  ) -> list[dict]:
    """Each kernel alone (entry point on preallocated outputs) and its
    plain version, by CUDA events around graph replays, at the main path's
    shapes (K1: 256 rows; window: the phase-6 wake group, one launch) and
    at the config-4 shapes of earlier runs (K1: 4,096 rows; window:
    [16,256,100]x[16,256,6], and its bytes as [64,64,100]x[64,64,6], which
    needs no cluster); K2 at config 5 beside cuBLAS's fp32 product alone.
    The wrappers' direct-call times go to the detail."""
    import ctypes
    import torch
    from easydarwin_tpu_torch.ops import device_ring as dr
    from easydarwin_tpu_torch.ops import fanout, fec_kernel, kernel_lib
    from easydarwin_tpu_torch.ops import transform as tf
    from easydarwin_tpu_torch.ops.parse import parse_packets
    from easydarwin_tpu_torch.ops.parse_kernel import parse_packets_kernel
    from easydarwin_tpu_torch.ops.transform_kernel import decode_blocks_kernel
    relay_src = "easydarwin_tpu_torch/csrc/relay_kernels.cu"
    cases = []

    def k1_case(rows: int, main: bool):
        pre, ln = fuzz_rows(rng, rows)
        dp, dl = torch.from_numpy(pre).cuda(), torch.from_numpy(ln).cuda()
        words = torch.empty((rows, 4), dtype=torch.int32, device="cuda")
        flags = torch.empty((rows, 5), dtype=torch.int32, device="cuda")
        cases.append((
            "ed_parse_packets", f"[{rows},96]", main, relay_src,
            "easydarwin_tpu/ops/parse_pallas.py:84",
            lambda: kernel_lib.launch(
                "ed_parse_packets", dp.data_ptr(), rows, 96, dl.data_ptr(),
                words.data_ptr(), flags.data_ptr()),
            lambda: parse_packets_kernel(dp, dl),
            lambda: parse_packets(dp, dl), None,
            dp.numel() + 4 * rows + (16 + 20) * rows,
            OPS_PER_PACKET * rows, 100))

    def window_case(specs, main: bool):
        pairs = window_group(rng, specs)
        outs = [torch.empty((w.shape[0], 4 * s.shape[1] + 1),
                            dtype=torch.int32, device="cuda")
                for w, s in pairs]
        shapes = [(*w.shape, s.shape[1]) for w, s in pairs]
        (plan,) = fanout.window_launch_plan(
            shapes, [w.data_ptr() for w, _ in pairs])
        descs = fanout.window_descriptors(plan, pairs, outs)
        nbytes = sum(w.numel() + 4 * s.numel() + 4 * o.numel()
                     for (w, s), o in zip(pairs, outs))
        ops = sum(OPS_PER_WINDOW_ROW * b * p + OPS_PER_SUBSCRIBER * b * n_s
                  for b, p, _w, n_s in shapes)
        cases.append((
            "ed_relay_window",
            " + ".join(f"[{b},{p},{w}]x[{b},{n_s},6]"
                       for b, p, w, n_s in shapes) + f" (C={plan.cluster})",
            main, relay_src, "easydarwin_tpu/ops/fanout.py:183",
            lambda: kernel_lib.launch("ed_relay_window",
                                      ctypes.addressof(descs), len(descs),
                                      plan.cluster),
            lambda: fanout.relay_affine_step_windows(pairs),
            lambda: [fanout.relay_affine_step_window_plain(w, s)
                     for w, s in pairs], None, nbytes, ops, 100))

    replayed = []

    def ring_case(n_subs: int, main: bool):
        ring = fuzzed_ring(rng, RING_C, 2 * RING_C + 100)
        st = ring_state(rng, n_subs)
        out = torch.empty(4 * n_subs + 1, dtype=torch.int32, device="cuda")
        replayed.append((f"S={n_subs}", ring, st))
        cases.append((
            "ed_ring_query", f"C={RING_C} S={n_subs}", main, relay_src,
            "easydarwin_tpu/ops/device_ring.py:66",
            lambda: kernel_lib.launch(
                "ed_ring_query", ring.rows.data_ptr(), RING_C, dr.ROW_STRIDE,
                ring.head, st.data_ptr(), n_subs, ring.scratch.data_ptr(),
                out.data_ptr()),
            lambda: dr.query_params(ring, st),
            lambda: dr.query_params_plain(ring, st), None,
            ring.rows.numel() + 4 * st.numel() + 4 * out.numel(),
            OPS_PER_WINDOW_ROW * RING_C + OPS_PER_SUBSCRIBER * n_subs, 100))

    k1_case(256, True)
    k1_case(16 * 256, False)
    ring_case(CONFIG2_SUBS, True)
    ring_case(256, False)
    window_case(WAKE_GROUP, True)
    window_case(((16, 16, 256, 256, 256),), False)
    # config 4's bytes and 64 CTAs again, as 64 streams of 64 rows: one CTA
    # a stream row, so no cluster exchange
    window_case(((64, 64, 64, 64, 64),), False)
    def gf_case(shape, main: bool):
        k, b, r = shape
        rows, coeff = gf_inputs(rng, k, b, r)
        tables = fec_kernel._tables(rows.device)
        out = torch.empty((r, b), dtype=torch.uint8, device="cuda")
        nbytes, ops = gf_bound(k, b, r)
        cases.append((
            "ed_gf_parity", f"[{k},{b}]x[{r},{k}]", main,
            "easydarwin_tpu_torch/csrc/fec_kernels.cu",
            "easydarwin_tpu/models/relay_pipeline.py:280",
            lambda: kernel_lib.launch(
                "ed_gf_parity", rows.data_ptr(), k, b, coeff.data_ptr(), r,
                tables.data_ptr(), out.data_ptr()),
            lambda: fec_kernel.gf_parity(rows, coeff),
            lambda: fec_kernel.gf_parity_plain(rows, coeff), None,
            nbytes, ops, 100 if main else 20))

    gf_case(GF_WIRE, True)
    gf_case(GF_STRIPE, False)
    n = levels.shape[0]
    inv = tf.operator("inv", levels.device)    # the library's operator
    idct8 = tf.operator("idct8", levels.device)
    pixels = torch.empty((n, 64), dtype=torch.uint8, device="cuda")
    deq = tf.dequantize(levels, qt)            # the library's input
    # the separable IDCT: a row and a column pass of 8 x 64 fp32
    # multiply-adds per block (the dense 64x64 product would be 4x this)
    cases.append((
        "ed_decode_blocks", f"[{n},64]", True,
        "easydarwin_tpu_torch/csrc/transform_kernels.cu",
        "easydarwin_tpu/ops/transform.py:172",
        lambda: kernel_lib.launch(
            "ed_decode_blocks", levels.data_ptr(), n, qt.data_ptr(),
            idct8.data_ptr(), pixels.data_ptr()),
        lambda: decode_blocks_kernel(levels, qt),
        lambda: tf.decode_blocks_plain(levels, qt),
        lambda: torch.matmul(deq, inv.T),      # product alone
        4 * levels.numel() + 4 * 64 + 4 * idct8.numel() + pixels.numel(),
        2 * (2 * 8 * 64) * n, 20))
    out = []
    for (name, shape, main, src, src_line, kernel, wrapper, plain, library,
         nbytes, ops, inner) in cases:
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        ms = graph_ms(kernel, inner=inner)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": src_line, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": graph_ms(plain, inner=min(inner, 20)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None
            else graph_ms(library, inner=inner),
            # detail only (not part of the kernels line)
            "_shape": shape, "_main_path": main,
            "_bytes": nbytes, "_ops": ops,
            "_gb_per_s": nbytes / ms / 1e6,
            "_bound_share": max(t_bytes, t_ops) / ms,
            "_wrapper_graph_ms": graph_ms(wrapper, inner=inner),
            "_wrapper_call_ms": call_ms(wrapper, reps=21, inner=inner),
            "_plain_call_ms": call_ms(plain, reps=11, inner=10),
        })
    # the graph replays above left each ring's counter at 0: a query now
    # is still bit-exact
    for label, ring, st in replayed:
        d = ring_diff(ring, st, dr.query_params(ring, st))
        check(d == 0, f"ed_ring_query after graph replays ({label}) differs "
              f"from the plain query (max {d})")
        counter_at_zero(ring)
        log(f"[kernels] ed_ring_query at C={RING_C} {label} after the graph "
            f"replays: bit-exact, counter back at 0")
    return out


#: per coefficient of B7's requant: the dequant multiply, then per rung
#: the divide, the round, the int conversion and the nonzero count
OPS_PER_B7_COEF, OPS_PER_B7_RUNG_COEF = 1, 4


def phase_b7(levels) -> dict:
    """B7, the config-5 ladder's requant (torch ops, no hand kernel): one
    ``_ladder_step`` without pixels (dequantize, three rungs, nonzero
    counts) at 783,360 blocks in a CUDA graph, beside its bound."""
    from easydarwin_tpu_torch.models.transcode_pipeline import (
        TranscodeConfig, TranscodePipeline, _ladder_step)
    pipe = TranscodePipeline(TranscodeConfig(qualities=(80, 50, 25),
                                             source_quality=90),
                             device=DEVICE)
    r = pipe.qt_rungs.shape[0]
    n = levels.numel()
    nbytes = (4 * n + 4 * pipe.qt_in.numel() + 4 * pipe.qt_rungs.numel()
              + 4 * r * n + 4 * r)
    ops = OPS_PER_B7_COEF * n + OPS_PER_B7_RUNG_COEF * r * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    ms = graph_ms(lambda: _ladder_step(levels, qt_in=pipe.qt_in,
                                       qt_rungs=pipe.qt_rungs,
                                       decode_pixels=False), inner=5)
    res = {"name": "B7 _ladder_step (no pixels)", "route": "torch ops",
           "shape": f"[{levels.shape[0]},64] x {r} rungs", "ms": ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops, "bound_share": max(t_bytes, t_ops)
           / ms, "library_ms": None}
    log(f"[b7] the ladder's requant at config 5 ({res['shape']}): "
        f"{ms:.6f} ms in a graph, bound {res['bound_ms']:.6f} ms by "
        f"{res['bound_by']} ({nbytes} bytes), {res['bound_share']:.1%} of "
        f"the bound")
    return res


#: per (output, packet) header of B9: the seq and ts adds and masks, 10
#: byte extractions, the eligibility compare and the mask
OPS_PER_BATCH_HEADER = 16


def phase_batch_step(rng, shapes, launches: int) -> list[dict]:
    """``relay_batch_step`` (B9) on CUDA tensors against the same call on
    CPU tensors, every key bit-exact, at each ``(label, P, S)``: fuzzed
    rows with runts and zero-length padding rows, random rewrite state,
    16 outputs a delay bucket.  Times: one call in a CUDA graph (K1 and
    the torch ops, no host), a direct call on the card (host enqueue
    included), and the CPU call on the host clock."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import fanout
    from easydarwin_tpu_torch.utils import synth
    out = []
    for label, p, s in shapes:
        n = p - p // 8                          # the rest is zero padding
        pre, ln = synth.stage([synth.random_packet(rng) for _ in range(n)])
        prefix = np.zeros((p, 96), np.uint8)
        length = np.zeros(p, np.int32)
        prefix[:n], length[:n] = pre, ln
        age = rng.integers(0, 400, p).astype(np.int32)
        state = rng.integers(0, 1 << 32, (s, 6), dtype=np.uint64
                             ).astype(np.uint32)
        buckets = (np.arange(s) // 16).astype(np.int32)
        cpu = [torch.from_numpy(a) for a in (prefix, length, age, state,
                                              buckets)]
        dev = [t.cuda() for t in cpu]
        want = fanout.relay_batch_step(*cpu, 73)
        got = fanout.relay_batch_step(*dev, 73)
        for k, v in want.items():
            check(got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v),
                  f"relay_batch_step {label}: {k} differs on the card")
        samples = []
        for _ in range(21):
            t0 = time.perf_counter()
            fanout.relay_batch_step(*cpu, 73)
            samples.append((time.perf_counter() - t0) * 1e3)
        samples.sort()
        nbytes = (prefix.nbytes + length.nbytes + age.nbytes + state.nbytes
                  + buckets.nbytes + 12 * s * p + s * p + 2 * p + 4)
        ops = OPS_PER_PACKET * p + OPS_PER_BATCH_HEADER * s * p
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        row = {"name": "relay_batch_step", "route": "K1 + torch ops",
               "shape": f"{label}: P={p} S={s}", "max_abs_err": 0,
               "launches": launches,
               "ms": graph_ms(lambda: fanout.relay_batch_step(*dev, 73),
                              inner=20),
               "call_ms": call_ms(lambda: fanout.relay_batch_step(*dev, 73),
                                  reps=11, inner=10),
               "plain_cpu_ms": samples[len(samples) // 2],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None, "bytes": nbytes, "ops": ops}
        log(f"[b9] relay_batch_step at {row['shape']}: bit-exact against "
            f"the CPU call on every key; {row['ms']:.6f} ms in a graph, "
            f"{row['call_ms']:.6f} ms a direct call, bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}, CPU "
            f"{row['plain_cpu_ms']:.6f} ms; {launches} main-path passes "
            f"(one K1 launch each)")
        out.append(row)
    return out


def join_query_ms(rng, n_subs: int = CONFIG2_SUBS) -> dict:
    """The engine's whole join query on the host clock: output state
    packed and uploaded, ONE ed_ring_query, the packed row read back and
    held against the host oracle (``FanoutEngine._device_params`` with its
    cache dropped), over a C = 4,096 ring of paced 1080p-sized packets."""
    import numpy as np
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
    from easydarwin_tpu_torch.utils import synth
    from easydarwin_tpu_torch.utils.loopback import VIDEO_SDP
    stream = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                         StreamSettings(bucket_size=n_subs))
    pkts = []
    while len(pkts) < RING_C + 500:
        pkts += synth.paced_gop(rng, seq0=len(pkts), ts0=3000 * len(pkts),
                                ssrc=0x77, frames=30, packets_per_frame=13,
                                body_len=(1270, 1300))
    t = 1000
    for pkt in pkts:
        stream.push_rtp(pkt, t)
    for _ in range(n_subs):
        stream.add_output(CollectingOutput(
            ssrc=int(rng.integers(1 << 32)),
            out_seq_start=int(rng.integers(1 << 16)),
            out_ts_start=int(rng.integers(1 << 32))))
    eng = FanoutEngine(device=DEVICE)
    flat = eng._flat_outputs(stream)
    eng._prime(stream, flat, t)
    eng._ring_sync(stream.rtp_ring, t)
    order = eng.fast_outputs(stream)
    samples = []
    for _ in range(53):
        eng._params_key = None                 # a join: no cached params
        t0 = time.perf_counter()
        params = eng._device_params(order, stream.rtp_ring, t)
        samples.append((time.perf_counter() - t0) * 1e3)
        check(params is not None, "the join query disagreed with the oracle")
    samples = sorted(samples[3:])
    return {"subscribers": n_subs, "ring_rows": RING_C,
            "host_ms_p50": samples[len(samples) // 2],
            "host_ms_min": samples[0], "host_ms_max": samples[-1],
            "newest_keyframe": eng.last_newest_keyframe,
            "queries": eng.device_param_refreshes}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops.transform_kernel import ring_geometry

    os.makedirs(OUT_DIR, exist_ok=True)
    rng = np.random.default_rng(20261016)
    detail: dict = {}

    b = kernel_lib.build()
    kernel_lib.library()
    log(f"[build] {b.path.name} built in {b.seconds:.3f} s")
    detail["build"] = {"seconds": b.seconds, "log": b.log}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[card] {smi}")
    detail["card"] = smi

    matmul = {"cuda.matmul.allow_tf32":
              torch.backends.cuda.matmul.allow_tf32,
              "float32_matmul_precision":
              torch.get_float32_matmul_precision(),
              "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"[card] fp32 matmul settings {matmul}")
    check(not matmul["cuda.matmul.allow_tf32"]
          and matmul["float32_matmul_precision"] == "highest",
          "fp32 matmuls would run in TF32")
    detail["matmul_settings"] = matmul

    detail["k1"] = phase_k1(rng)
    detail["relay_geometry"] = relay_geometry()
    log(f"[window] library geometry {detail['relay_geometry']} = the Python "
        f"launch plans")
    detail["window"] = phase_window(rng)
    detail["ring"] = phase_ring_query(rng)
    detail["gf"] = phase_gf(rng)
    levels, qt = config5_levels(int(rng.integers(1 << 31)))
    detail["k2_ring"] = ring_geometry()
    log(f"[k2] ring: {detail['k2_ring']}")
    detail["k2"] = phase_k2(levels, qt, detail["k2_ring"])

    kernel_lib.reset_launch_counts()           # the main path starts here
    detail["scheduler"] = phase_scheduler(rng)
    detail["native"] = phase_config4_native(rng, detail["scheduler"])
    detail["server"] = phase_server(rng)
    detail["config2"] = phase_config2(rng)
    detail["rtcp"] = phase_rtcp(rng)
    detail["lossy"] = phase_lossy(rng)
    detail["pipeline"] = phase_pipeline(levels)
    detail["ladder"] = phase_ladder(rng)
    in_proc = dict(kernel_lib.LAUNCHES)
    servers = [detail[p]["server_stats"]["kernel_launches"]
               for p in ("server", "config2", "rtcp", "lossy", "ladder")]
    launches = {k: in_proc[k] + sum(s.get(k, 0) for s in servers)
                for k in in_proc}
    log(f"[main path] kernel launches {launches} (in-process {in_proc}, "
        f"servers {servers})")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    errs = {"ed_parse_packets": max(detail["k1"].values()),
            "ed_relay_window": max(detail["window"].values()),
            "ed_ring_query": max(detail["ring"].values()),
            "ed_decode_blocks": max(v["max_abs_err"]
                                    for v in detail["k2"].values()),
            "ed_gf_parity": detail["gf"]["max_abs_err"]}
    detail["launch_floor_ms"] = launch_floor_ms()
    log(f"[kernels] launch floor: {detail['launch_floor_ms']:.6f} ms per "
        f"graph node (ed_launch_floor, an empty kernel)")
    detail["ptxas"] = ptxas_report(detail["build"]["log"])
    for name, rep in detail["ptxas"].items():
        log(f"[kernels] ptxas {name}: {rep}")
    timed = phase_kernels(rng, launches, errs, levels, qt)
    detail["kernels"] = timed
    detail["join_query"] = join = join_query_ms(rng)
    ring_ms = next(k["ms"] for k in timed if k["name"] == "ed_ring_query"
                   and k["_main_path"])
    log(f"[kernels] the engine's join query (pack + upload + ed_ring_query "
        f"+ readback + oracle, _device_params) at C={RING_C} "
        f"S={join['subscribers']}: host ms p50 {join['host_ms_p50']:.6f} "
        f"(min {join['host_ms_min']:.6f}, max {join['host_ms_max']:.6f}); "
        f"the kernel's {ring_ms:.6f} ms is "
        f"{ring_ms / join['host_ms_p50']:.2%} of it")
    rtcp_st = detail["rtcp"]["server_stats"]
    b9_p = -(-rtcp_st["batch_rows"] // max(rtcp_st["batch_passes"], 1))
    b9_s = sum(1 for pl in RTCP_PLAYERS if pl["meta"] or pl["lossy"])
    detail["batch_step"] = phase_batch_step(
        rng, (("phase 7c", b9_p, b9_s), ("config 4", 256, 256)),
        rtcp_st["batch_passes"])
    detail["b7"] = phase_b7(levels)
    kernels = [{k: v for k, v in t.items() if not k.startswith("_")}
               for t in timed if t["_main_path"]]
    for k in timed:
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.6f} ms")
        where = "main path" if k["_main_path"] else "earlier runs' shape"
        log(f"[kernels] {k['name']} at {k['_shape']} ({where}): "
            f"{k['ms']:.6f} ms, {k['ms'] / detail['launch_floor_ms']:.2f}x "
            f"the launch floor (plain "
            f"{k['plain_ms']:.6f} ms, bound {k['bound_ms']:.6f} ms by "
            f"{k['bound_by']}{lib}), {k['_gb_per_s']:.1f} GB/s, "
            f"{k['_bound_share']:.1%} of the bound, wrapper "
            f"{k['_wrapper_graph_ms']:.6f} "
            f"ms in a graph, {k['_wrapper_call_ms']:.6f} ms per direct "
            f"call; {k['launches']} main-path launches")
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
