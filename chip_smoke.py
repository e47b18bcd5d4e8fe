#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``easydarwin_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``easydarwin_tpu_torch/csrc`` and
drives the port's live-relay, transcode, file-playback (VOD), DVR and HLS
paths, the megabatch mesh, the pump's timer wheel, per-player UDP pairs
and the closed-loop requant on the card, phase by phase; any failed
phase raises and the script exits non-zero.

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
             B = 256; K = 48, 64; K = 64 R = 8 B = 256; K = 33, odd
             across a warp), 40 fuzzed K <= 64, R <= 8, B <= 4,096 with
             zero rows, bytes and coefficients, five 256 KiB stripes
             (with the stripe [4,1 MiB]x[2,4], each of the stripe
             kernel's instantiations; two shapes on the lane kernel) and
             the stripe; the wire and stripe shapes also vs the host
             ``gf_matmul``; K = 65, R = 9, B = 300 and an odd address raise
             without a launch; ``StripeCodec(4, 2)`` parity and a two-loss,
             crc-checked reconstruct of 4 × 1 MiB blobs on the card equal
             the host product (2 device passes, 0 mismatches); a k = 65
             stripe (past the kernel's 64 rows): ``fec_parity_window_step``
             as two launches XORed, byte-equal to the plain version and
             ``gf_matmul``, and ``StripeCodec(65, 2)`` parity and a
             two-loss reconstruct equal to the host product
4d. b9      ``ed_relay_batch`` (B9) vs ``relay_batch_step_plain`` on the
             same card tensors and vs the call on CPU tensors, every key
             bit-exact: phase 7c's pass (P = 47, S = 16), P = S = 256, the
             tile's edges, the output group's (S = G - 1, G, G + 1 and
             2G + 1 at P = 47; P = 64, 65, 128 and 129 at S = 16) and
             the fold's (P = 512, the last pass of 8 tiles folded in one
             word's fields, and 513), the widest row (W = 735, the
             kernel's shared-memory opt-in), 20 fuzzed passes (runts,
             padding only, zero rows, W 96-128, delay 0) and an
             unaligned view; one launch a pass, its
             scratch back at 0 after one-tile and multi-tile passes; the
             library's tile, limits and scratch = ``ops.fanout``'s; P,
             S = 65,537, W = 95, wrong dtypes, a strided prefix and meta
             tensors raise without a launch
5. K2        ``ed_decode_blocks`` vs ``decode_blocks_plain`` at N = 1, 300,
             48,960 (one 1080p 4:2:0 frame), 48,961, T·stages + 1 (one
             past a full ring of tiles), CTAs·T·stages + 1 (every CTA
             wraps its ring, the last tile ragged) and 783,360 (config 5:
             16 sources × one 1080p frame): |diff| <= 1 on < 1% of
             pixels; N = 0 returns empty without a launch
5b. b7      ``ed_requant_rungs`` (B7) vs ``requant_rungs_plain`` on the
             card, rungs and nonzeros bit-exact: config 5 (783,360 blocks,
             3 rungs) and 11 fuzzed N (1 to 300,001: ragged rows and
             several trips of the grid's stride) at R = 1..8 with .5 ties and levels at ±2047, one also
             vs the CPU; the library's limits = ``ops.transform_kernel``'s;
             N = 0 returns zeros without a launch; one launch's R = 9,
             levels off 16 bytes and wrong dtypes raise without one;
             ``requant_rungs`` with R = 9 at config 5 is two launches
             (8 + 1 rungs), bit-exact with its nonzeros summed
5c. b6      B6 as ``ed_h264_requant`` and ``ed_h264_requant_chroma``
             (``ops.h264_kernel``) at config-5 width, 16 × one 1080p frame
             of 8,160 macroblocks: luma [2,088,960, 16], chroma DC
             [261,120, 4] and AC [261,120, 4, 15], a seeded QP mix over all
             three chroma arms with levels beyond ±LEVEL_CLIP; one launch
             each, bit-exact with the plain torch chains (``ops.transform.
             h264_requant[_chroma]``) on the card and on the CPU, 4,096
             sampled rows of each equal to the scalar oracles; the chroma
             kernel also with every row identity, exact shift or general,
             and with arms uniform within each 8-row chunk; N = 1, 2, 3,
             127, 129, 421, 7, 9, 10, 11, 63, 65, 229 (around the luma
             CTA's 128 rows, the chroma warp's 8-row chunk with QP tails
             of 1-3 words, and its CTA's 64 rows) and 36 fuzzed sizes,
             each from a random row, bit-exact too; N = 0, misaligned
             rows, int64 levels or QPs and mismatched DC/AC rows launch
             nothing.  Then the ladder's form, the leg (``RequantLeg``:
             int64 rows narrowed and tiled over the targets into pinned
             staging, uploaded, ONE launch, read back, in one call that
             keeps the GIL) at phase 13's AU and at sizes around a CTA,
             luma at 1-3 deltas and chroma with 1 and 2 rows a QP and
             rows n % 4 = 1, 2, 3 (the card buffer's QP vectors padded
             to 16 bytes), bit-exact with the plain chains on the tiled
             rows, one launch a leg; two legs in flight harvested in
             reverse order;
             the host µs of a leg alone at phase 13's AU
6. scheduler the main path in-process: MegabatchScheduler + FanoutEngine
             over 16 streams × 256 subscribers in 2 buckets for 36 wakes,
             every wire byte held against RelayStream.reflect, plus the
             RelayPipeline(use_pallas_parse=True) step each wake;
             ``ed_relay_window`` launches = the scheduler's window_calls,
             at most one per dispatching and one per priming wake; after
             each wake, outside its time, the walk the server's pump makes
             to arm its timer wheel (every stream's ``next_deadline_ms``);
             phases 7, 7b, 7f and 7g print the pump's own (``schedule_ms``)
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
             ed_relay_batch launches = its batch passes (B9, the
             batch-header rung, on the card), native_sent covering the
             plain players, batch_sent covering the meta-info packets; the
             batch leg's host ms a pass (staging + H2D, kernel + D2H)
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
7e. udp push BASELINE config 2 pushed over RTP/UDP through the CLI server:
             phase 7b's traffic from a pusher that SETUPs with client_port
             and mode=record, sends its packets to the server's port pair
             and an SR a second to its RTCP port; every datagram held to
             the oracle, the server's native ingest (``ed_udp_ingest``)
             took every packet pushed in fewer drains, 0 oversize, 0 send
             errors, the pusher received the relay's RRs; the wake p50,
             max and first join and the ns a packet inside the drain
8. pipeline  the config-5 TranscodePipeline (qualities 80/50/25 from 90,
             decode_pixels) for 8 steps of 783,360 blocks on the card:
             8 K2 and 8 ed_requant_rungs launches, one step held against
             the same pipeline on the CPU (rungs and nonzeros equal)
9. ladder    the live MJPEG ladder through the CLI server: one VGA 4:2:0
             source, 6 frames at 10 fps, REST starttranscode rungs 40 and
             20s2, one TCP player per rung; every delivered rung frame
             decodes and matches the CPU requantization oracle of its
             source frame; the host split per frame is printed
10. kernels  launches on the paths (phases 6-9, 11-11c, 12 and 13), the
             launch floor
             (one graph node of an empty kernel), ptxas registers, shared
             memory and spills, CUDA-event times at the main path's shapes
             (K1 256 rows, the window's phase-6 wake group, the ring query
             at config 2's C = 4,096 × S = 64, K2 config 5, B9 at phase
             7c's pass, B7 and B6 at config 5)
             and at earlier runs' config-4 shapes (K1 4,096 rows, window
             [16,256,100]×[16,256,6], and the same bytes as
             [64,64,100]×[64,64,6] with no cluster) beside the plain
             versions', the bound, the achieved GB/s and share of the
             bound and, for K2, cuBLAS's fp32 product alone; the kernels
             line carries the main path's shapes.  The ring query at
             C = 4,096 with S = 64 and 256, the engine's whole join query on the host (state upload, launch,
             readback, oracle: ``FanoutEngine._device_params``), and the
             ring, B9 and B7 called again after the graph replays,
             bit-exact; ``relay_batch_step`` (B9: one ``ed_relay_batch``
             launch) on the card against the same call on CPU tensors,
             bit-exact on every key, at phase 7c's shape and at config 4's
             (P = 256, S = 256): the kernel in a graph, the direct call,
             the plain version (K1 + torch ops) in a graph, the bound, the
             CPU call and the engine's batch leg (7c's and 7d's servers,
             and alone in this process at the same shape, its headers
             held against the CPU call) ([b9] lines);
             ``ed_gf_parity`` at the wire shape (the kernels line) and the
             stripe, on one input set and rotating through 12 (75 MB, more
             than L2 holds), beside the launch floor, its bound and its
             plain version, and the FEC leg alone
             (``StreamFec._device_parity`` at the wire shape, every pass
             held against the host ``gf_matmul``) with the kernel's share
             of it ([b4] lines); B7's
             ``ed_requant_rungs`` at config 5 beside the plain torch chain
             and its byte bound; B6's two kernels at phase 5c's shapes
             (the kernels line), the chroma kernel also with every row
             general and at phase 13's AU (396 rows), beside their plain
             chains, the launch floor and both sides of the bound (bytes
             at 3.35 TB/s, integer operations at the card's int32 lane
             rate: 64 lanes an SM × the SMs × ``clocks.max.sm``),
             bit-exact again after the graph replays, and phase 13's
             dispatch leg ([b6] lines); B8's ``ed_relay_shard`` (its one
             launch over phase 6c's two shards, into one result) at
             config 4's shape and the example batch's, beside B8's entry
             point ``sharded_relay_step``, its plain version (B9's plain
             chain a source) and its byte bound ([b8] lines).  The
             designs B8 and B9 replaced are timed against them by
             ``tools/b8_shard_probe.py`` and ``tools/b9_batch_probe.py``

4e. window vod ``ed_relay_window`` vs the plain window pass, bit-exact,
             at the VOD prime's shapes, past the 48 KB a CTA had before the
             kernel's opt-in to Hopper's large shared memory:
             [1,2048,100]x[1,64,6], [4,4096,100]x[4,16,6],
             [1,8192,100]x[1,8,6], [1,16384,100]x[1,8,6], 2,048 and 8,192
             rows in one launch, and [1,32768,100] as two pieces of 16,384
             in one launch; the ptxas static shared memory and each plan's
             cluster and dynamic shared memory
11. vod      VOD in-process: clips A (1080p30 H.264, 30 s, IDR 120,000 B
             every 30 frames, P 25,000 B; AAC 44.1 kHz, 372 B frames) and B
             (2160p30, 10 s, IDR 600,000 B, P 150,000 B) written by the
             port's Mp4Writer from the seed; a warm SegmentCache resident on
             the card, VodPacerGroup, MegabatchScheduler and one
             FanoutEngine a stream, 64 players of clip A joining one a
             frame and 8 of clip B, 8 s over loopback UDP: every datagram
             equal to the cold FileSession packetizers' packet, device
             primes = the joins, prime failures 0, uploads <= the windows
             touched, scheduler mismatches 0 and streams coalesced; the
             resident bytes and the prime's host ms per join (stack,
             launch + readback, oracle)
11b. vod srv ``python -m easydarwin_tpu_torch --device cuda --movie-folder``
             serving clip A to 32 UDP players from npt 0, 16 with Range
             npt=10-, 8 with Scale 2, 8 that PAUSE at 3 s and PLAY with
             Range npt=3-, 4 interleaved TCP, one with x-Retransmit (acking
             each datagram) and one asking for x-FEC (not granted); every
             packet, the DESCRIBE SDP, Range and RTP-Info held to the cold
             path; the wake p50, max and first join
11c. record  a server of its own: phase 7b's traffic pushed for 5 s (SDP with
             sprop-parameter-sets) with REST startrecord and stoprecord;
             the MP4 byte-equal to what the port's RecorderOutput writes
             on the CPU from the same packets, its tables read back

12. dvr     DVR, time-shift and the erasure-coded store through the CLI
             server (``--dvr-enabled 1 --storage-enabled 1``, 64-packet
             windows, k = 4, m = 2; ``utils.dvr_loopback.dvr_session``):
             config 2's pusher (1080p30 H.264, 13 packets of about 1.3 KB a
             frame, an IDR every 30 frames) with phase 7c's AAC track over
             interleaved TCP for 12 s, 64 UDP players of both tracks joining
             one a frame: 48 at the live edge, 8 that PAUSE at 3 s and PLAY
             with no Range and Speed 2 at 5 s, 8 that PLAY with Range npt=1-
             and Speed 4 at 6 s (both kinds catch up and rejoin the live
             stream); REST stoprecord, 4 players replaying ``/live/dvr.dvr``
             from npt 0 at Speed 4; the store awaited; one scrub over every
             shard in this process; then every spill.bin and 2 shards of
             each stripe deleted and a second server (a cold cache) replays
             the asset to 4 players through the reconstruct.  Every
             datagram is the rewrite of the pushed packet of its payload,
             one SSRC a track, source ids rising (a range player's restart
             once, at a GOP head), a loss only where RcvbufErrors rose; 32
             catch-up joins (16 players x 2 tracks); 0 vod, finalize,
             spill, push, reconstruct, worker, repair and scrub errors and
             0 oracle mismatches; one stored asset of a data shard a window
             and 2 parity shards a stripe; ed_gf_parity launches = the
             store's device passes in each server; the spill, finalize,
             store and reconstruct host ms, the wake p50 and max, the
             time-shift streams through begin_wake and the first join of
             a ``.dvr`` replay.  ``ed_gf_parity`` is then held against
             ``gf_parity_plain`` at the run's stripe shapes (``[gf]``), and
             phase 10 times it there ([b4] lines)

13. hls     HLS with the H.264 requant ladder through the CLI server
             (``utils.hls_loopback.serve_hls``): BASELINE config 5's 16
             sources over interleaved TCP, all-intra H.264 from the port's
             ``encode_iframe`` (8 CAVLC, 8 CABAC; 4 of 3 slices a picture;
             4 with an AAC track), 176x144 pictures (the cut made for the
             CPython walk, kept so that the figures compare), GOPs of 3
             pictures cycled, 24
             pictures a source at 0.4 a second (6.4 AUs a second offered,
             60 s; more AUs a path than the shed gate of max(4, 2 x
             workers) pending); REST starthls rungs=q6,q12 on
             every source and master.m3u8 on 4 single-slice ones (r1, r2);
             every playlist, init.mp4 and segment fetched: each sample equal
             to the pushed picture or to the host scalar oracle
             (``SliceRequantizer(delta)`` on the CPU), r2 the IDRs and r1 a
             level-1 thinning, A/V segments with two trafs, a 304 on
             revalidation, gethlsstreams with 16 paths; 0 device errors,
             passed-through slices, shed AUs and mismatches; the server's
             ed_h264_requant launches = its ladders' dispatches and
             ed_h264_requant_chroma launches = the dispatches with chroma;
             the ladder's host ms an AU by stage, an AU's latency (mean,
             max), the most AUs pending, and the pump's wake p50 and max;
             every requantized slice written by the native walk
             (``native_slices``).  After phase 13, the tiers' counter
             families over phases 11-13 (``vod_cache_hits_total``,
             ``vod_cache_misses_total``, ``dvr_windows_spilled_total``,
             ``storage_reconstructs_total``, ``requant_aus_total``,
             ``requant_slices_total``, ``requant_renditions_total``): this
             process's change plus each CLI server's ``/metrics`` scraped
             at its stop; each must be non-zero
13c. hls 1080p phase 13 at config 5's pictures, 1920x1088 (8,160
             macroblocks): the same server, sources, rungs and rate for
             30 s (12 pictures a source); 2 pictures of each kind (entropy
             mode x slice count) encoded once by the CPython
             ``encode_iframe`` on 8 processes and cycled (the seconds
             printed), a GOP's later pictures rewritten as non-IDR; every
             q-rung sample equal to the port's fused walk on the pushed
             slices; 0 device errors, mismatches and passed-through
             slices, launches = dispatches; shed, latency, host ms an AU
             by stage, the most AUs pending and the wake reported beside
             phase 13's figures on the CPython walk (shed is not refused)
13b. walk    the decision measurement on 13c's 12 distinct AUs: host ms
             an AU of (a) the fused walk once a rung (q6, q12) and (b) the
             split walk (one C parse a slice, B6's leg for the AU, one C
             write a slice a rung), on one thread (median of 3) and on a
             pool of the requant pool's size (48 AU jobs an engine); (b)'s
             bytes equal (a)'s and the oracle's everywhere

6c. mesh    B8 on a mesh of two shards on the one card (passed in: the
             server's ``make_megabatch_mesh`` keeps None on one card):
             ``parallel.mesh.sharded_relay_step`` at ``example_batch(4, 8,
             32)`` and config 4's 16 × 256 × 256, with rows of 0 and 1-11
             bytes, in the layouts (2,1,1), (1,2,1) and (1,1,2),
             bit-exact with its plain version on a CPU mesh; then phase 6's
             config-4 traffic (16 × 256, 12 wakes, 4 leave and 4 join at
             wake 6) through the scheduler's mesh path, every packet equal
             to the one-device scheduler's run; window launches = window
             calls (one a shard a wake); then B8 once at each shape, one
             ``ed_relay_shard`` a device a call (both shards in it)
7f. wheel   the pump's timer wheel: an in-process server with a 200 ms
             reflect interval and 30 ms bucket delay, one H.264 source
             (4 packets a frame, a frame each 100 ms, 3 s) to 16 UDP
             players, 6 a bucket; each bucket's release delay (arrival
             minus push) p50 and max, buckets 1 and 2 within their delay
             plus a few ms; the pump's wakes by ingest, by time and on a
             wheel deadline
7g. pairs   BASELINE config 2 (phase 7b's source, 3 s) to 64 UDP players
             with ``shared_udp_egress=False`` on an in-process server:
             each player on a pool pair of its own, every datagram held
             to the oracle, all through the engine's loop rung; its host
             µs a datagram beside phase 7b's µs a datagram in
             ``sendmmsg`` on the shared pair
13d. closed ``SliceRequantizer(6, closed_loop=True)`` over the committed
             x264 IPPP fixtures (``tests/fixtures/ippp_176x144_*.264``,
             1 IDR + 7 P, CAVLC and CABAC): every NAL equal to the CPU
             run, one ``ed_h264_requant`` a P slice with residual rows and
             one ``ed_h264_requant_chroma`` a P slice with chroma rows,
             host ms an AU of the I (the host loop) and P (the split walk
             around B6) pictures, the I picture's PSNR to the source
             closed against open loop (the port's intra decoder)
14. surface the reference's server surface through two CLI servers on the
             card at BASELINE config 2's traffic
             (``utils.surface_loopback.serve_surface``): origin A from
             ``-c a.toml`` (``max_connections_per_ip = 3``), edge B from
             ``-c easydarwin.xml`` in the reference's format (Digest
             on every path, the access log) with REST auth and the log
             folder as flags (no XML pref carries them); 7b's source
             (1080p30 H.264, 13 packets of about 1.3 KB a frame, an IDR
             every 30 frames, 5 s) pushed to A's /cam1 and /cam2 and
             sent as UDP to the port a ``bcast.sdp`` under B's movie
             folder names; B logs in and startpullrelays A's paths into
             /pull1 and /pull2 with X-Token; 64 players join B one a
             frame: 16 over RTSP-over-HTTP tunnels and 16 interleaved on
             /pull1, 16 UDP on /pull2, 8 UDP and 8 TCP on /bcast, each
             answering the Digest challenge.  Every packet held to
             its source from byte 12 (seq contiguous from RTP-Info, own
             SSRC); every core REST command's envelope, 403 without
             X-Token, 401 on a bad login, getbaseconfig without
             rest_password, setbaseconfig read back, the live sessions;
             A refusing a fourth connection from one address; the icy
             GET of song.mp3 equal to the file between its metadata
             blocks; a W3C line in B's access log for each closed player;
             B's ed_relay_window launches > 0, pump errors, scheduler
             mismatches and error-log lines 0.  B's wake p50/p99 beside
             7b's, each kind's first join, the ms from startpullrelay to
             the pull's first packet and its host µs a forwarded packet,
             the card's name and power limit
15. observed the relay with its ``obs`` stack scraped, through one CLI
             server (``utils.obs_loopback.observed_relay``): 7c's source
             (1080p30 H.264 + AAC with SRs, 13 packets of about 1.3 KB a
             frame, an IDR every 30 frames, 5 s) pushed to two paths, 7d's
             to a third; 16 UDP, 16 TCP, 8 meta-info/lossy-report (the
             B9 rung) and 8 FEC (B4) players, every packet held to its
             source; ``/metrics`` and the ledger, profile, audience and
             events documents scraped each second, then ``/metrics``,
             those and the fleet's, ``/debug/profile``, ``admin
             command=top``, ``getserverinfo`` and GET ``/`` and
             ``/stats`` on both ports, and ``tools/blame_report.py
             --url``.  The same traffic runs four times,
             ``EDTPU_PROFILE=0``, ``=1``, ``=1``, ``=0`` (so the host's
             drift over the phase falls on both sides); on the last
             profiled run every scraped family is one
             of the port's inventory and ``relay_phase_seconds`` keeps to
             ``PHASES`` × ``ENGINES``, the report names a work class, the
             ``device_step`` count of engine ``megabatch`` equals the
             server's ``ed_relay_window`` launches and (after phase 10)
             its mean lies between that kernel's time and that time plus
             a launch allowance, ``tpu_h2d_bytes_total`` and
             ``tpu_d2h_bytes_total`` equal the bytes the relay tiers'
             copies moved (``ops.staging.COPIED``), the three
             ``getserverinfo`` keys answer, the pprof profile parses; the
             profiled runs' pump host µs a packet relayed (every pass's
             host ms over the packets they sent) and the server process's
             CPU µs a packet (every thread), each mean to mean, are at
             most 1.5× those of the runs without.  The wake p50s are
             printed beside them: they follow how the packets fell into
             wakes, and two runs of one setting differ by up to 1.5×
16. chaos   the resilience tier on the card, in-process
             (``utils.chaos_loopback``): a server with
             ``resilience_fault_plan`` armed from its start
             (``CHAOS_PLAN``: ingest drop and corrupt at 1%, EAGAIN and
             ENOBUFS every 97th and 131st egress send call) and
             ``resilience_recover_sec`` 1 s serves 8 pushed H.264 streams
             (half over TCP, half over UDP) × 8 UDP players through the
             megabatch; once all play, the plan is armed again with
             device errors at the ``megabatch.dispatch`` and
             ``fanout.device_params`` sites, one at the first draw past
             each half second (``device_fault_plan``: the ladder then
             degrades whatever the host's dispatch rate), for
             ``CHAOS_FAULT_S``; ``fault_injected_total`` by site equals
             the injector's counts, the ladder degrades, ``ed_relay_window``
             launches while the faults fire with 0 oracle mismatches;
             after the disarm every stream is back on the megabatch rung
             within 4 rungs × 1 s + 2 s and ``ed_relay_window`` launches
             again; the device errors the pump counted are no more than
             the faults injected and none is a real one; every player's
             packets are pushed ones, one SSRC, increasing seqs.  Then a
             restart from the checkpoint: server A stops, server B
             restores on its log folder, the pusher re-ANNOUNCEs, and a UDP
             and an interleaved-TCP player (re-attached with its old
             Session id) each see one SSRC and a contiguous seq
17. cluster the cluster tier on the card (``utils.cluster_loopback.
             cluster_kill``): the port's ``MiniRedisServer`` in this
             process and two CLI servers (``--device cuda -c
             node-{a,b}.toml``, ``cluster_enabled``, their own
             ``server_id``s, the reference soak's lease settings: TTL 2 s,
             heartbeat 0.5 s); 3 H.264 pushers and a UDP player each on
             A, an interleaved player of the first path on B, served
             through a ``RemotePull`` from A (payloads equal to the pushed
             ones from byte 12, in order; B's ``x-freshness`` chain two
             hops); SIGKILL of A; B's fenced claims on every path within
             10 s; B's ``/api/v1/fleet`` lists both nodes, A stale; the
             paths re-pushed to B (each pusher's last 64 packets first);
             the UDP players, which never re-SETUP, keep their SSRC, and
             each one's seq minus its payload's push index is one
             constant (no rebase) with no index missing; on B
             ``cluster_migrations_total`` >= 3, ``megabatch_passes_total``
             grows after the adoption (``ed_relay_window`` launches = the
             scheduler's window calls > 0), 0 oracle mismatches, 0 pump
             and device errors, no pass on the host scalar path, every
             path on a device rung and no pull failure charged to the
             ladder (the pull's failures after the kill are counted and
             stay off it).  The
             ``[cluster]`` line gives kill → adopt seconds, the seq gap,
             B's wake host ms p50/p99, the capacity score and the card;
             the phase takes at most ``CLUSTER_LIMIT_S``
17b. cluster-dvr  the cluster's DVR and store wire and EasyCMS on the
             card (``utils.cluster_dvr_loopback.cluster_dvr`` at
             ``CLUSTER_DVR_SIZE``): three servers in this process over
             one in-process Redis, ``dvr_enabled`` and
             ``storage_enabled`` (k = 2, m = 2), the lease settings of
             the reference's dead-owner test.  Two H.264 recordings
             pushed to A and finalized, A's store encoding their parity
             (``ed_gf_parity``) and pushing shards to B and C; B, which
             never saw them, replays the first through A's ``dvrmeta``
             and ``dvrwindow``; a data shard of the second deleted on C
             (one whose stripe then needs a B4 solve) and A stopped, C
             replays it through B's ``dvrmeta`` answer from its manifest
             and the store's reconstruct; a ``SimDevice`` registers two
             channels with a ``CmsServer``, a ``CmsClient`` gets both,
             the CMS places them on one media server, the device pushes
             there and a player plays each.  Every replay and CMS player
             starts with the SPS, keeps one SSRC, has a gapless seq and
             the pushed payloads; no window repacked; ``ed_relay_window``
             launched in B's replay, C's replay and on the media server,
             ``ed_gf_parity`` at A's store and in C's replay step, C's
             own reconstruct running a B4 product; on each of A (read
             before it stops), B and C 0 wire and prime mismatches, codec
             oracle mismatches, pump, device and storage worker errors.
             The ``[cluster-dvr]`` lines give finalize → every shard
             placed ms, each replay's first-datagram ms, the
             reconstruct's host ms by leg, the CMS's get stream → first
             packet ms, the launches by step and the card; the phase
             takes at most ``CLUSTER_DVR_LIMIT_S``
18. keys    the reference's reliability-tier and serving-path keys
             (``utils.keys_loopback``), two CLI servers one after the
             other, each ``-c`` on a TOML of the reference's key names.
             Run A, the keys off (``megabatch_enabled``,
             ``tcp_engine_enabled`` and ``fec_device`` false,
             ``fec_window`` 8, ``fec_payload_type`` 110,
             ``rtx_payload_type`` 109, ``timeout_sweep_sec`` 2, and
             ``dvr_enabled``, ``storage_enabled`` with
             ``storage_device`` false): 7d's source (1080p30, 13 packets
             of about 1.3 KB a frame, 5 s) on 4 paths, each to 8 plain
             UDP, 4 interleaved TCP and 4 FEC players dropping 8% of
             media, every span byte-equal to the oracle; beside them a
             path recorded for 2 s, finalized, stored, its spill and 2
             data shards a stripe deleted, and replayed through the
             reconstruct, equal to the pushed packets.  0
             ``ed_relay_window``, ``ed_ring_query`` on every path (the
             server's ring queries by path), ``ed_relay_batch`` > 0 with
             the TCP players' packets on the batch rung and none on the
             TCP rung, 0 ``ed_gf_parity`` with the FEC tier's and the
             store's products on the host, parity on PT 110 and RTX on
             109, 0 oracle mismatches and give-ups.  Run B, the gates
             (``reliable_udp`` and ``fec_enabled`` false,
             ``megabatch_min_streams`` 3): two paths of UDP players
             asking for x-FEC or x-Retransmit, then a third; no grant
             and no wrapped output, ``megabatch_passes_total`` 0 while two
             paths play and > 0 after the third joined (with
             ``ed_relay_window`` launches), and REST ``setbaseconfig`` of
             each of the fifteen keys answered 200 and read back by
             ``getbaseconfig``; the phase takes at most ``KEYS_LIMIT_S``

``python3 chip_smoke.py --hls-control`` runs phases 1, 2, 5c's leg check
and phases 13 and 13c twice each instead, each checked in full: the
ladders' B6 on the card, then on the CPU's plain torch chains (the
server's ``--hls-device cpu``); the runs' drain, latency, stages and wake
go to one JSON line before the last and to
``chiprun_out/hls_control.json``.

Before the last lines, ``[uring]`` gives ``ed_uring_probe``'s answer on
this host: its capability bits by name, or the errno's name.

The kernel launch counts are set to 0 just before phase 6 and read just
after phase 9 (the server processes report their own at exit, without
their start-up warm-up), then set to 0 again just before phase 11 and
read just after phase 11c (the VOD path), again just before phase 12
and just after it (the DVR path), just before phase 13 and just after it
(the HLS path), and just before phase 13c and just after it (the 1080p
HLS path; these two launch B6).  Phase 13b runs after them: its B6 legs
are not the main path's.  Then each of phase 6c's scheduler mesh
path (after its one-device comparison run), 7f, 7g and 13d is its own
path, with the counts set to 0 just before it and read just after, as
are phase 14 (its two servers report their own), phase 15 (its
two runs' server), phase 16 (its servers run in-process), phase 17
(the adopter's exit stats: the killed node reports none) and phase 17b
(its servers run in-process) and phase 18 (its two servers report their
own), and so is B8's own path in phase 6c: its two calls through
``sharded_relay_step``.  No serving code calls B8 (the server's mesh path
is the scheduler's, one ``ed_relay_window`` a shard), so its kernel
``ed_relay_shard`` is launched on that path alone, and its row in the
kernels line says so under ``caller``.  The kernels line's launches are
the sixteen paths' sum.  The comparisons and
timings of phases 3, 4, 4b, 4c, 4d, 4e, 5, 5b, 5c and 10 run outside
those windows.  Phase 10's window rows also time the VOD prime's calls
of phase 11.
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
#: the kernels only the HLS path (phase 13) launches
HLS_KERNELS = ("ed_h264_requant", "ed_h264_requant_chroma")
#: kernels that no serving path launches, each with what calls it (its
#: launches are those of its own path in phase 6c)
MODULE_KERNELS = {
    "ed_relay_shard": "no serving caller: B8, parallel.mesh."
                      "sharded_relay_step, called directly (phase 6c; the "
                      "tests), one launch a device a call; the server's "
                      "mesh path launches ed_relay_window a shard"}
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
    geo = dict(zip(names, kernel_lib.geometry("ed_relay_geometry",
                                              len(names))))
    check((geo["max_buckets"], geo["max_cluster"], geo["tile_rows"],
           geo["smem_limit"], geo["ring_tile_rows"]) == (
               fanout.WINDOW_MAX_BUCKETS, fanout.WINDOW_MAX_CLUSTER,
               parse_kernel.PARSE_TILE_ROWS, kernel_lib.DYN_SMEM_LIMIT,
               device_ring.RING_TILE_ROWS),
          f"the library's relay geometry {geo} differs from the Python plans")
    shard = ("shard_tile_rows", "shard_subs_per_cta", "shard_max_shards",
             "shard_max_slots", "shard_launch_bytes")
    geo.update(zip(shard, kernel_lib.geometry("ed_relay_shard_geometry",
                                              len(shard))))
    check(tuple(geo[k] for k in shard) == (
        fanout.SHARD_TILE_ROWS, fanout.SHARD_SUBS_PER_CTA,
        fanout.SHARD_MAX_SHARDS, fanout.SHARD_MAX_SLOTS,
        ctypes.sizeof(fanout.ShardLaunchStruct)),
          f"the library's shard geometry {geo} differs from the Python plan")
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


# ------------------------------------------------------------- phase 4e
#: ``ed_relay_window`` at the VOD prime's shapes: (name, bucket specs as
#: (b_real, b_pad, P, s_real, s_pad)); 32,768 rows run as two pieces of
#: 16,384 (``fanout.split_wide_windows``) in the same one launch
VOD_WINDOWS = (
    ("1x2048_S64", ((1, 1, 2048, 64, 64),)),
    ("4x4096_S16", ((4, 4, 4096, 16, 16),)),
    ("1x8192_S8", ((1, 1, 8192, 8, 8),)),
    ("1x16384_S8", ((1, 1, 16384, 8, 8),)),
    ("mixed_2048_8192", ((1, 1, 2048, 8, 8), (2, 2, 8192, 8, 8))),
    ("1x32768_in_pieces", ((1, 1, 32768, 8, 8),)),
)


def phase_window_vod(rng, ptxas: dict) -> dict:
    """``ed_relay_window`` bit-exact against the plain pass at the VOD
    prime's shapes, past the 48 KB a CTA had before the kernel's opt-in to
    Hopper's large shared memory; each with its launch plan's cluster and
    shared memory."""
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    static = ptxas.get("relay_window_kernel", {}).get("static_smem_bytes")
    res = {"static_smem_bytes": static,
           "smem_limit": kernel_lib.WINDOW_SMEM_LIMIT}
    log(f"[window vod] relay_window_kernel: ptxas static smem {static} B; "
        f"dynamic limit after the opt-in {kernel_lib.WINDOW_SMEM_LIMIT} B "
        f"(48 KB before it: {kernel_lib.DYN_SMEM_LIMIT} B)")
    for name, specs in VOD_WINDOWS:
        pairs = window_group(rng, specs)
        pieces, cuts = fanout.split_wide_windows(pairs)
        (plan,) = fanout.window_launch_plan(
            [(*w.shape, s.shape[1]) for w, s in pieces],
            [w.data_ptr() for w, _ in pieces])
        worst, launched = compare_windows(pairs)
        check(launched == 1, f"window {name}: {launched} launches")
        res[name] = {"max_abs_err": worst, "cluster": plan.cluster,
                     "smem_bytes": plan.smem_bytes,
                     "pieces": [n for n, _p in cuts]}
        log(f"[window vod] {name}: "
            + " + ".join(f"[{tuple(w.shape)}x{tuple(s.shape)}]"
                         for w, s in pairs)
            + f" as {' + '.join(str(tuple(w.shape)) for w, _ in pieces)}: "
            f"C={plan.cluster}, {plan.smem_bytes} B dynamic smem a CTA, "
            f"1 launch, bit-exact vs the plain pass")
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
#: the least B the stripe kernel takes (``kGfStripeMinB``)
GF_STRIPE_MIN_B = 1 << 18
#: ``ed_gf_parity``'s integer ops, counted from its source: per (parity
#: row, row, 4-byte word) product two prmt, two masked XORs and the XOR
#: into the sum; per (row, word) the selectors and masks; per (parity
#: row, word) the byte-order prmt
OPS_PER_GF_PRODUCT_WORD = 5
OPS_PER_GF_WORD = 10
OPS_PER_GF_OUT_WORD = 1
#: input sets the stripe's HBM row rotates through: 12 × 6.3 MB = 75 MB,
#: more than the card's 50 MB L2, so no call finds its inputs there
GF_STRIPE_SETS = 12


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
            (OPS_PER_GF_PRODUCT_WORD * r * k + OPS_PER_GF_WORD * k
             + OPS_PER_GF_OUT_WORD * r) * (b // 4))


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
              (48, 2048, 8), (64, 4096, 8), (1, 256, 1), (64, 256, 8),
              (33, 2048, 4), (33, 256, 3)]
    shapes += [(int(rng.integers(1, 65)), 256 * int(rng.integers(1, 17)),
                int(rng.integers(1, 9))) for _ in range(40)]
    # the stripe kernel at its smallest B (with GF_STRIPE, each of its
    # instantiations: K <= 4 or 8, R = 1 or 2), and stripe-sized shapes
    # that take the lane kernel
    shapes += [(3, GF_STRIPE_MIN_B, 1), (6, GF_STRIPE_MIN_B, 1),
               (8, GF_STRIPE_MIN_B, 2), (4, GF_STRIPE_MIN_B, 4),
               (16, GF_STRIPE_MIN_B, 2)]
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
        f"shapes: wire {GF_WIRE} (and R 1, 8; B 256), K = 64 R = 8 B = 256, "
        f"K = 33, 40 fuzzed with zero rows, bytes and coefficients, five "
        f"256 KiB stripes (K 3, 6, 8 on the stripe kernel; R = 4 and K = "
        f"16 on the lane kernel), stripe {GF_STRIPE}; the wire and stripe "
        f"shapes also vs the host gf_matmul")
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
    k65 = gf_wide_stripe(rng)
    err = max(err, k65["max_abs_err"])
    return {"shapes": len(shapes), "max_abs_err": err,
            "stripe_device_passes": codec.device_passes, "k65": k65}


#: a stripe past ``ed_gf_parity``'s 64 rows: 65 blobs of 16 KiB, 2 parity
GF_WIDE = (65, 1 << 14, 2)


def gf_wide_stripe(rng) -> dict:
    """A k = 65 stripe on the card: ``fec_parity_window_step`` runs it as
    two ``ed_gf_parity`` launches (64 rows, then 1) whose products are
    XORed, byte-equal to the plain version and the host ``gf_matmul``;
    ``StripeCodec(65, 2)`` parity and a two-loss reconstruct on the card
    equal the host product."""
    import zlib
    import numpy as np
    import torch
    from easydarwin_tpu_torch.models.relay_pipeline import \
        fec_parity_window_step
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops.fec_kernel import gf_parity_plain
    from easydarwin_tpu_torch.relay.fec import coeff_rows, gf_matmul
    from easydarwin_tpu_torch.storage.codec import StripeCodec
    k, b, r = GF_WIDE
    rows, coeff = gf_inputs(rng, k, b, r)
    before = kernel_lib.LAUNCHES["ed_gf_parity"]
    got = fec_parity_window_step(rows, coeff)
    check(kernel_lib.LAUNCHES["ed_gf_parity"] == before + 2,
          f"gf k = {k}: not two launches")
    want = gf_parity_plain(rows, coeff)
    host = gf_matmul(coeff.cpu().numpy(), rows.cpu().numpy())
    err = max(int((got.int() - want.int()).abs().max()),
              int(np.abs(got.cpu().numpy().astype(np.int32) - host).max()))
    check(err == 0, f"ed_gf_parity k = {k}: the XORed launches differ "
                    f"from the plain version or gf_matmul")
    blobs = [rng.integers(0, 256, b - 37 * i, dtype=np.uint8).tobytes()
             for i in range(k)]
    codec = StripeCodec(k, r, device="cuda")
    before = kernel_lib.LAUNCHES["ed_gf_parity"]
    parity = codec.parity(blobs)
    lens = [len(x) for x in blobs]
    stripe = np.zeros((k, max(lens)), np.uint8)
    for i, x in enumerate(blobs):
        stripe[i, :len(x)] = np.frombuffer(x, np.uint8)
    host = gf_matmul(coeff_rows(range(k), r), stripe)
    check(parity == [host[p].tobytes() for p in range(r)],
          f"StripeCodec({k}, {r}).parity on the card differs from gf_matmul")
    present = {i: x for i, x in enumerate(blobs) if i not in (0, k - 1)}
    present.update({k + p: x for p, x in enumerate(parity)})
    crcs = [zlib.crc32(x) & 0xFFFFFFFF for x in blobs]
    got = codec.reconstruct(present, lens, asset="chip", crcs=crcs)
    check(got == {0: blobs[0], k - 1: blobs[k - 1]},
          f"StripeCodec({k}, {r}) two-loss reconstruct is not the lost "
          f"blobs")
    launches = kernel_lib.LAUNCHES["ed_gf_parity"] - before
    check(codec.oracle_mismatches == 0 and launches == 4,
          f"stripe k = {k}: {codec.oracle_mismatches} mismatches, "
          f"{launches} launches")
    torch.cuda.synchronize()
    log(f"[gf] k = {k} (C3): fec_parity_window_step [{k},{b}]x[{r},{k}] is "
        f"two ed_gf_parity launches XORed, byte-equal to gf_parity_plain "
        f"and gf_matmul; StripeCodec({k}, {r}) parity and a two-loss "
        f"reconstruct on the card equal the host product ({launches} "
        f"launches, 0 oracle mismatches)")
    return {"shape": [k, b, r], "max_abs_err": err,
            "codec_launches": launches}


# ------------------------------------------------------------- phase 4d
#: B9's kinds of fuzzed pass: random packets with runts and a padding
#: tail, padding only (newest keyframe −1), runts only (mask all False),
#: rows of zero bytes with real lengths
B9_KINDS = ("fuzz", "padding", "runts", "zero_rows")


def b9_arrays(rng, p: int, s: int, width: int = 96, kind: str = "fuzz"):
    """One batch pass as numpy: ``prefix [p, width]`` (columns past 96
    random), ``length``, ``age`` (int32), ``state [s, 6]`` uint32 (random,
    so seq and ts wrap) and ``buckets`` (16 outputs a delay bucket)."""
    import numpy as np
    from easydarwin_tpu_torch.utils import synth
    prefix = rng.integers(0, 256, (p, width), dtype=np.uint8)
    length = np.zeros(p, np.int32)
    n = p if kind in ("runts", "zero_rows") else p - p // 8
    if kind == "runts":
        pkts = [bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                                   dtype=np.uint8)) for _ in range(n)]
    else:
        pkts = [synth.random_packet(rng) for _ in range(n)]
    pre, ln = synth.stage(pkts)
    prefix[:n, :96], length[:n] = pre, ln
    prefix[n:] = 0
    if kind == "padding":
        prefix[:] = 0
        length[:] = 0
    elif kind == "zero_rows":
        prefix[:, :96] = 0
    age = rng.integers(-50, 400, p).astype(np.int32)
    state = rng.integers(0, 1 << 32, (s, 6), dtype=np.uint64
                         ).astype(np.uint32)
    buckets = (np.arange(s) // 16).astype(np.int32)
    return prefix, length, age, state, buckets


def b9_diff(got: dict, want: dict, what: str) -> int:
    """Every key of two B9 results equal in dtype and shape; returns the
    max absolute difference (must be 0)."""
    import torch
    check(sorted(got) == sorted(want), f"{what}: keys {sorted(got)}")
    worst = 0
    for k, v in want.items():
        g = got[k].cpu()
        v = v.cpu()
        check(g.dtype == v.dtype and g.shape == v.shape,
              f"{what}: {k} is {g.dtype}{tuple(g.shape)}, plain "
              f"{v.dtype}{tuple(v.shape)}")
        d = int((g.to(torch.int64) - v.to(torch.int64)).abs().max()
                ) if g.numel() else 0
        check(d == 0, f"{what}: {k} differs (max {d})")
        worst = max(worst, d)
    return worst


def batch_scratch_at_zero(what: str = "ed_relay_batch") -> None:
    """Every word of ``ed_relay_batch``'s scratch on this stream is 0."""
    import torch
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    torch.cuda.synchronize()
    words = kernel_lib.scratch("ed_relay_batch", fanout.BATCH_SCRATCH_WORDS,
                               torch.device("cuda", 0)).cpu().tolist()
    check(not any(words), f"{what} left its scratch at {words}")


def phase_b9(rng) -> dict:
    """``ed_relay_batch`` (B9) against ``relay_batch_step_plain`` on the
    same card tensors and against the call on CPU tensors, every key
    bit-exact: phase 7c's pass (P = 47, S = 16), P = S = 256, the tile's
    edges, the output group's (S = G - 1, G, G + 1, 2G + 1 at P = 47) and
    more tiles' (P = 64, 65, 128, 129 at S = 16), the fold's (P = 512,
    513), the widest row (W = 735), a view whose first byte is not 16-byte
    aligned and 20 fuzzed passes (runts, padding only, zero rows, rows of
    97-128 bytes, delay 0); its scratch back at 0 after every pass;
    out-of-range shapes raise without a launch; one launch a pass."""
    import torch
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    geo = kernel_lib.geometry("ed_relay_batch_geometry", 5)
    check(geo == (fanout.BATCH_TILE_ROWS, fanout.BATCH_SUBS_PER_CTA,
                  fanout.BATCH_MAX_PKTS, fanout.BATCH_MAX_SUBS,
                  fanout.BATCH_SCRATCH_WORDS),
          f"ed_relay_batch_geometry {geo} differs from ops.fanout's")
    g = fanout.BATCH_SUBS_PER_CTA
    cases = [("7c", 47, 16, 96, "fuzz", 73),
             ("config4", 256, 256, 96, "fuzz", 73),
             ("p1_s1", 1, 1, 96, "fuzz", 73),
             ("p65_s17", 65, 17, 96, "fuzz", 73),
             ("p600_s70_w100", 600, 70, 100, "fuzz", 40),
             ("p130_s9_w735", 130, 9, 735, "fuzz", 73)]
    # the output group's edges at 7c's P, then more tiles at 7c's S
    cases += [(f"p47_s{s}", 47, s, 96, "fuzz", 73)
              for s in (g - 1, g, g + 1, 2 * g + 1)]
    cases += [(f"p{p}_s16", p, 16, 96, "fuzz", 73)
              for p in (64, 65, 128, 129)]
    # the last pass whose keyframe folds in one word of tile fields, and
    # the first past it (the CAS fold)
    cases += [(f"p{p}_s5", p, 5, 96, "fuzz", 73) for p in (512, 513)]
    for i in range(20):
        cases.append((f"fuzz{i}", int(rng.integers(1, 700)),
                      int(rng.integers(1, 80)),
                      int(rng.choice([96, 97, 100, 128])),
                      B9_KINDS[i % len(B9_KINDS)],
                      int(rng.choice([0, 73, 500]))))
    res = {}
    for label, p, s, w, kind, delay in cases:
        arrays = b9_arrays(rng, p, s, w, kind)
        cpu = [torch.from_numpy(a) for a in arrays]
        dev = [t.cuda() for t in cpu]
        before = kernel_lib.LAUNCHES["ed_relay_batch"]
        got = fanout.relay_batch_step(*dev, delay)
        check(kernel_lib.LAUNCHES["ed_relay_batch"] == before + 1,
              f"b9 {label}: not one launch")
        plain = fanout.relay_batch_step_plain(*dev, delay)
        host = fanout.relay_batch_step(*cpu, delay)
        torch.cuda.synchronize()
        what = f"ed_relay_batch {label} (P={p} S={s} W={w} {kind})"
        res[label] = max(b9_diff(got, plain, what + " vs plain"),
                         b9_diff(got, host, what + " vs CPU"))
        # one tile writes newest at once; more meet in the 64-bit word
        batch_scratch_at_zero(what)
    # rows at an address that is not 16-byte aligned: head and tail bytes
    arrays = b9_arrays(rng, 301, 9, 97)
    view = torch.from_numpy(arrays[0]).cuda()[1:]
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "the unaligned B9 case is not unaligned")
    dev = ([view] + [torch.from_numpy(a[1:].copy()).cuda()
                     for a in arrays[1:3]]
           + [torch.from_numpy(a).cuda() for a in arrays[3:]])
    res["w97_view"] = b9_diff(fanout.relay_batch_step(*dev, 73),
                              fanout.relay_batch_step_plain(*dev, 73),
                              "ed_relay_batch prefix[1:] of [301,97]")
    batch_scratch_at_zero()
    log(f"[b9] ed_relay_batch bit-exact on every key vs "
        f"relay_batch_step_plain on the card and vs the CPU call at "
        f"{len(cases)} passes (7c P=47 S=16, P=S=256, tile edges, group "
        f"edges S={g - 1},{g},{g + 1},{2 * g + 1} at P=47, P=64,65,128,129 "
        f"at S=16, P=512,513, W=735, 20 fuzzed: runts, padding only, zero "
        f"rows, W 96-128, delay 0) and an unaligned view; one launch a "
        f"pass; scratch back at 0 after each; geometry {geo} = "
        f"ops.fanout's")
    before = kernel_lib.LAUNCHES["ed_relay_batch"]
    good = [torch.from_numpy(a).cuda() for a in b9_arrays(rng, 8, 3)]
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in good]
    for args, what in (
            ([torch.empty((fanout.BATCH_MAX_PKTS + 1, 96), dtype=torch.uint8,
                          device="cuda")] + [
                torch.zeros(fanout.BATCH_MAX_PKTS + 1, dtype=torch.int32,
                            device="cuda")] * 2 + good[3:],
             f"P = {fanout.BATCH_MAX_PKTS + 1}"),
            (good[:3] + [torch.zeros((fanout.BATCH_MAX_SUBS + 1, 6),
                                     dtype=torch.uint32, device="cuda"),
                         torch.zeros(fanout.BATCH_MAX_SUBS + 1,
                                     dtype=torch.int32, device="cuda")],
             f"S = {fanout.BATCH_MAX_SUBS + 1}"),
            ([good[0][:, :95].contiguous()] + good[1:], "W = 95"),
            ([good[0]] + [good[1].long()] + good[2:], "int64 lengths"),
            (good[:3] + [good[3].view(torch.int32)] + good[4:],
             "int32 state"),
            ([torch.zeros((8, 100), dtype=torch.uint8,
                          device="cuda")[:, :96]] + good[1:],
             "a strided prefix"),
            (meta, "meta tensors")):
        try:
            fanout.relay_batch_step(*args, 73)
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"ed_relay_batch took {what}")
    check(kernel_lib.LAUNCHES["ed_relay_batch"] == before,
          "an out-of-range B9 pass launched")
    log("[b9] P = 65,537, S = 65,537, W = 95, int64 lengths, int32 state, "
        "a strided prefix and meta tensors raise without a launch")
    return res


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


# ------------------------------------------------------------- phase 5b
def config5_tables():
    """The config-5 ladder's tables on the card (qualities 80/50/25 from
    90): ``(qt_in [64], qt_rungs [3, 64])``."""
    from easydarwin_tpu_torch.models import TranscodeConfig, TranscodePipeline
    pipe = TranscodePipeline(TranscodeConfig(qualities=(80, 50, 25),
                                             source_quality=90),
                             device=DEVICE)
    return pipe.qt_in, pipe.qt_rungs


def b7_diff(got, want, what: str) -> int:
    """Rungs and nonzeros of two B7 results equal in dtype and shape;
    returns the max absolute difference (must be 0)."""
    import torch
    worst = 0
    for name, g, w in (("rungs", got[0], want[0]),
                       ("nonzeros", got[1], want[1])):
        check(g.dtype == w.dtype == torch.int32 and g.shape == w.shape,
              f"{what}: {name} {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        d = int((g.cpu().to(torch.int64) - w.cpu().to(torch.int64)).abs()
                .max()) if g.numel() else 0
        check(d == 0, f"{what}: {name} differs (max {d})")
        worst = max(worst, d)
    return worst


def phase_b7_check(rng, levels) -> dict:
    """``ed_requant_rungs`` (B7) against ``requant_rungs_plain`` on the
    card, rungs and nonzeros bit-exact: config 5 (783,360 blocks, 3 rungs),
    N around the 16-chunk rows and the grid's stride at R = 1..8 with
    random tables, levels in ±2047 and .5 ties, one case also against the
    CPU; out-of-range calls raise without a launch, N = 0 returns zeros
    without one."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops import transform as tf
    from easydarwin_tpu_torch.ops import transform_kernel as tk
    geo = kernel_lib.geometry("ed_requant_geometry", 3)
    check(geo == (tk.REQUANT_MAX_RUNGS, tk.REQUANT_MAX_BLOCKS,
                  tk.REQUANT_MAX_CTAS),
          f"ed_requant_geometry {geo} differs from ops.transform_kernel's")
    qt_in, qt_rungs = config5_tables()
    res = {"config5": b7_diff(tk.requant_rungs(levels, qt_in, qt_rungs),
                              tf.requant_rungs_plain(levels, qt_in, qt_rungs),
                              "ed_requant_rungs config 5")}
    sizes = (1, 7, 15, 16, 17, 255, 256, 4097, 65_535, 65_541, 300_001)
    for i, n in enumerate(sizes):
        r = 1 + i % tk.REQUANT_MAX_RUNGS
        lv = rng.integers(-2047, 2048, (n, 64)).astype(np.int32)
        lv.flat[:2] = (2047, -2047)
        qi = tf.quality_table(int(rng.integers(50, 100)))
        qr = np.stack([tf.quality_table(int(q))
                       for q in rng.integers(5, 96, r)])
        qi[:4] = 1                              # .5 ties in columns 0-3
        qr[:, :2], qr[:, 2:4] = 2, 4
        args = [torch.from_numpy(a).cuda() for a in (lv, qi, qr)]
        before = kernel_lib.LAUNCHES["ed_requant_rungs"]
        got = tk.requant_rungs(*args)
        check(kernel_lib.LAUNCHES["ed_requant_rungs"] == before + 1,
              f"b7 N={n} R={r}: not one launch")
        what = f"ed_requant_rungs N={n} R={r}"
        res[f"n{n}_r{r}"] = b7_diff(got, tf.requant_rungs_plain(*args), what)
        if n == 4097:
            res["cpu"] = b7_diff(got, tf.requant_rungs_plain(
                *[torch.from_numpy(a) for a in (lv, qi, qr)]), what + " CPU")
    torch.cuda.synchronize()
    ticket = int(kernel_lib.scratch("ed_requant_rungs",
                                    tk.REQUANT_SCRATCH_WORDS,
                                    levels.device)[0])
    check(ticket == 0, f"ed_requant_rungs left its ticket at {ticket}")
    log(f"[b7] ed_requant_rungs bit-exact (rungs and nonzeros) vs "
        f"requant_rungs_plain at config 5 ([{levels.shape[0]},64] x 3) and "
        f"{len(sizes)} fuzzed N x R (1..8), one also vs the CPU; ticket "
        f"back at 0; geometry {geo} = ops.transform_kernel's")
    # C4: nine rungs, past the kernel's eight: two launches (8 + 1)
    qt9 = torch.from_numpy(np.stack([tf.quality_table(q) for q in (
        90, 80, 70, 60, 50, 40, 30, 20, 10)])).cuda()
    before = kernel_lib.LAUNCHES["ed_requant_rungs"]
    got = tk.requant_rungs(levels, qt_in, qt9)
    launched = kernel_lib.LAUNCHES["ed_requant_rungs"] - before
    check(launched == 2, f"b7 R = 9: {launched} launches, not two")
    res["r9"] = b7_diff(got, tf.requant_rungs_plain(levels, qt_in, qt9),
                        "ed_requant_rungs R = 9")
    log(f"[b7] R = 9 (C4) at config 5: two ed_requant_rungs launches (8 + 1 "
        f"rungs), rungs and summed nonzeros bit-exact vs requant_rungs_plain")
    before = kernel_lib.LAUNCHES["ed_requant_rungs"]
    empty = tk.requant_rungs(levels[:0], qt_in, qt_rungs)
    check(empty[0].shape == (3, 0, 64) and int(empty[1].abs().sum()) == 0,
          "B7 N = 0 is not empty rungs and zero counts")
    odd = torch.zeros(64 * 64 + 1, dtype=torch.int32,
                      device="cuda")[1:].view(64, 64)
    for args, what in (
            ((levels[:64], qt_in, torch.ones((9, 64), device="cuda")),
             "R = 9"),
            ((odd, qt_in, qt_rungs), "levels at an address off 16 bytes"),
            ((levels[:64].float(), qt_in, qt_rungs), "float levels"),
            ((levels[:64], qt_in, qt_rungs.double()), "float64 tables")):
        try:
            tk.requant_rungs_launch(*args)
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"ed_requant_rungs took {what}")
    check(kernel_lib.LAUNCHES["ed_requant_rungs"] == before,
          "an out-of-range B7 call launched")
    log("[b7] N = 0 returns empty rungs and zero counts, R = 9, levels off "
        "16 bytes, float levels and float64 tables raise, all without a "
        "launch")
    return res


# ------------------------------------------------------------- phase 5c
#: config 5's H.264 ladder at full width: 16 sources × one 1080p frame,
#: 120 × 68 = 8,160 macroblocks a frame, 16 luma 4×4 blocks and two
#: chroma components a macroblock
H264_MBS = 16 * 120 * 68
H264_LUMA_ROWS = 16 * H264_MBS
H264_CHROMA_ROWS = 2 * H264_MBS
#: rows held against the scalar oracles, a sample of each kind
H264_SAMPLE = 4096
#: rows a CTA of ``ed_h264_requant`` takes (``kThreads`` in
#: ``csrc/h264_kernels.cu``), and rows a warp's chunk and a CTA's eight
#: warps of ``ed_h264_requant_chroma`` take at once (``kChromaChunkRows``,
#: ``kChromaWarps``): phase 5c's edge sizes sit around them
B6_LUMA_CTA_ROWS = 128
B6_CHROMA_CHUNK_ROWS = 8
B6_CHROMA_CTA_ROWS = 64
#: phase 5c's chroma inputs besides the seeded mix: every row one arm, and
#: arms uniform within each chunk (as the ladder lays rows out: a run of
#: rows shares one target)
B6_CHROMA_ARMS = ("identity", "shift", "general", "chunks")


def h264_inputs(rng) -> dict:
    """B6's seeded inputs at config-5 width as numpy: luma levels [N, 16]
    with per-block ``qp_in`` 0-51 and ``qp_out = qp_in + 6k``; chroma DC
    [M, 4] and AC [M, 4, 15] with QPc through Table 8-15 from a luma QP
    and a step of 0, 6, 12 or 18, so all three arms occur (identity,
    exact shift, general round trip).  Some levels lie beyond
    ±``LEVEL_CLIP``."""
    import numpy as np
    from easydarwin_tpu_torch.codecs.h264_transform import (CHROMA_QP,
                                                            LEVEL_CLIP)
    n, m = H264_LUMA_ROWS, H264_CHROMA_ROWS
    lev = (rng.integers(-60, 61, (n, 16))
           * (rng.random((n, 16)) < 0.3)).astype(np.int32)
    wide = rng.random((n, 16)) < 0.002
    lev[wide] = rng.integers(-LEVEL_CLIP - 400, LEVEL_CLIP + 401,
                             int(wide.sum()))
    qi = rng.integers(0, 52, n).astype(np.int32)
    qo = (qi + 6 * rng.integers(0, (51 - qi) // 6 + 1)).astype(np.int32)
    dc = rng.integers(-600, 601, (m, 4)).astype(np.int32)
    ac = (rng.integers(-90, 91, (m, 4, 15))
          * (rng.random((m, 4, 15)) < 0.3)).astype(np.int32)
    wide = rng.random((m, 4, 15)) < 0.002
    ac[wide] = rng.integers(-LEVEL_CLIP - 400, LEVEL_CLIP + 401,
                            int(wide.sum()))
    dc[::97] = rng.integers(-LEVEL_CLIP - 400, LEVEL_CLIP + 401, (4,))
    qpy = rng.integers(0, 52, m)
    step = rng.choice([0, 6, 12, 18], m)
    qci = CHROMA_QP[qpy].astype(np.int32)
    qco = CHROMA_QP[np.minimum(qpy + step, 51)].astype(np.int32)
    return {"lev": lev, "qi": qi, "qo": qo, "dc": dc, "ac": ac,
            "qci": qci, "qco": qco}


def chroma_arm_qps(x: dict, arm: str):
    """``(qpc_in, qpc_out)`` for phase 5c's chroma rows with every row in
    one arm (``identity``: the same QP; ``shift``: +6, +12 or +18;
    ``general``: +1 to +5), or with arms uniform within each chunk of
    ``B6_CHROMA_CHUNK_ROWS`` (``chunks``: chunk i's delta is the i-th of
    0, 6, 3, 12, 5, 18, 1, cyclically)."""
    import numpy as np
    qi = x["qci"]
    i = np.arange(qi.shape[0])
    delta = {"identity": np.zeros_like(i), "shift": 6 * (1 + i % 3),
             "general": 1 + i % 5,
             "chunks": np.array([0, 6, 3, 12, 5, 18, 1])[
                 i // B6_CHROMA_CHUNK_ROWS % 7]}[arm]
    return qi, (qi + delta).astype(np.int32)


def chroma_arms(qi, qo) -> dict:
    """Rows of each chroma arm among ``(qpc_in, qpc_out)``."""
    import numpy as np
    delta = np.asarray(qo, np.int64) - np.asarray(qi, np.int64)
    return {"identity": int((delta == 0).sum()),
            "shift": int(((delta != 0) & (delta % 6 == 0)).sum()),
            "general": int((delta % 6 != 0).sum())}


def h264_bound(rows: int, row_bytes: int) -> int:
    """Bytes one B6 call must move: its levels read and written once and
    its two int32 QP vectors read once."""
    return rows * (2 * row_bytes + 8)


def phase_h264(rng) -> dict:
    """B6 at config-5 width on the card: ``ed_h264_requant`` over
    [2,088,960, 16] and ``ed_h264_requant_chroma`` over DC [261,120, 4]
    and AC [261,120, 4, 15] (``ops.h264_kernel``), each ONE launch,
    bit-exact with the plain torch chains (``ops.transform``) on the same
    card tensors and with the chains on the CPU; 4,096 sampled rows of
    each also equal to the scalar oracles; the chroma kernel also on
    ``B6_CHROMA_ARMS``'s four inputs.  Then N = 1, sizes around the luma
    CTA's rows and the chroma chunk's and CTA's (the chroma QP tail of 1,
    2 and 3 words) and 36 fuzzed ones, each from a random row (so QP
    views off 16 bytes, which the chroma wrapper copies), N = 0 without a
    launch, and misaligned or wrongly typed inputs raising without one."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.codecs import h264_transform as ht
    from easydarwin_tpu_torch.ops import h264_kernel as hk
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops import transform as tf
    x = h264_inputs(rng)
    cuda = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
    cpu = {k: torch.from_numpy(v) for k, v in x.items()}

    def run(d, fn_l, fn_c):
        return (fn_l(d["lev"], d["qi"], d["qo"]),
                *fn_c(d["dc"], d["ac"], d["qci"], d["qco"]))

    def diff(got, want) -> int:
        return max(int((a.cpu().long() - b.cpu().long()).abs().max())
                   if a.numel() else 0 for a, b in zip(got, want))

    before = dict(kernel_lib.LAUNCHES)
    t0 = time.perf_counter()
    kern = run(cuda, hk.h264_requant_kernel, hk.h264_requant_chroma_kernel)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for name in ("ed_h264_requant", "ed_h264_requant_chroma"):
        check(kernel_lib.LAUNCHES[name] == before[name] + 1,
              f"{name}: not one launch at config 5")
    for t in kern:
        check(t.dtype == torch.int32 and t.is_cuda, f"B6 output {t.dtype}")
    plain = run(cuda, tf.h264_requant, tf.h264_requant_chroma)
    host = run(cpu, tf.h264_requant, tf.h264_requant_chroma)
    err = diff(kern, plain)
    check(err == 0, f"B6 kernels differ from the plain chains (max {err})")
    err_cpu = diff(kern, host)
    check(err_cpu == 0, f"B6 kernels differ from the CPU (max {err_cpu})")
    arms = chroma_arms(x["qci"], x["qco"])
    check(min(arms.values()) > 0, f"B6 chroma arms not all covered: {arms}")
    clipped = int((np.abs(x["lev"]) > ht.LEVEL_CLIP).sum()
                  + (np.abs(x["ac"]) > ht.LEVEL_CLIP).sum())
    check(clipped > 0, "no level beyond LEVEL_CLIP")
    luma, dc, ac = (t.cpu() for t in kern)
    for i in rng.choice(H264_LUMA_ROWS, H264_SAMPLE, replace=False):
        qi, qo = int(x["qi"][i]), int(x["qo"][i])
        want = (ht.requant_levels_scalar(x["lev"][i], qi, qo) if qo > qi
                else np.clip(x["lev"][i], -ht.LEVEL_CLIP, ht.LEVEL_CLIP))
        check(np.array_equal(luma[i].numpy(), want),
              f"ed_h264_requant row {i} differs from the scalar oracle")
    for i in rng.choice(H264_CHROMA_ROWS, H264_SAMPLE, replace=False):
        sdc, sac = ht.requant_chroma_scalar(x["dc"][i], x["ac"][i],
                                            int(x["qci"][i]),
                                            int(x["qco"][i]))
        check(np.array_equal(dc[i].numpy(), sdc)
              and np.array_equal(ac[i].numpy(), sac),
              f"ed_h264_requant_chroma row {i} differs from the scalar "
              "oracle")
    log(f"[b6] ed_h264_requant [{H264_LUMA_ROWS},16] and "
        f"ed_h264_requant_chroma DC [{H264_CHROMA_ROWS},4] AC "
        f"[{H264_CHROMA_ROWS},4,15], one launch each: bit-exact with the "
        f"plain torch chains on the card and with the CPU; chroma arms "
        f"{arms}; {clipped} levels beyond +-{ht.LEVEL_CLIP}; "
        f"{H264_SAMPLE} sampled rows of each equal to the scalar oracles; "
        f"first call {first_ms:.3f} host ms (both, synchronized)")
    # the chroma kernel on inputs of one arm, and of arms uniform within
    # each chunk, on the card and on the CPU
    by_arm = {}
    for arm in B6_CHROMA_ARMS:
        qi, qo = chroma_arm_qps(x, arm)
        cq = (torch.from_numpy(qi).cuda(), torch.from_numpy(qo).cuda())
        got = hk.h264_requant_chroma_kernel(cuda["dc"], cuda["ac"], *cq)
        worst_arm = max(diff(got, tf.h264_requant_chroma(cuda["dc"],
                                                         cuda["ac"], *cq)),
                        diff(got, tf.h264_requant_chroma(
                            cpu["dc"], cpu["ac"], torch.from_numpy(qi),
                            torch.from_numpy(qo))))
        by_arm[arm] = {"arms": chroma_arms(qi, qo),
                       "max_abs_err": worst_arm}
        err = max(err, worst_arm)
    check(all(v["max_abs_err"] == 0 for v in by_arm.values()),
          f"ed_h264_requant_chroma differs on one-arm inputs: {by_arm}")
    log(f"[b6] ed_h264_requant_chroma at config 5 with every row identity, "
        f"exact shift or general, and with arms uniform within each "
        f"{B6_CHROMA_CHUNK_ROWS}-row chunk "
        f"({by_arm['chunks']['arms']}): bit-exact with the plain chains on "
        f"the card and the CPU")
    # edge sizes: one row, ragged sizes around the luma CTA's rows, the
    # chroma chunk's (QP tails of 1-3 words) and the chroma CTA's, each
    # from the config-5 inputs at a random row (so every arm and clip
    # recurs)
    lt, ck, ct = B6_LUMA_CTA_ROWS, B6_CHROMA_CHUNK_ROWS, B6_CHROMA_CTA_ROWS
    sizes = [1, 2, 3, lt - 1, lt + 1, 3 * lt + 37, ck - 1, ck + 1, ck + 2,
             ck + 3, ct - 1, ct + 1, 3 * ct + 37]
    sizes += [int(n) for n in rng.integers(2, 5000, 36)]
    worst = 0
    for n in sizes:
        lo = int(rng.integers(0, H264_CHROMA_ROWS - n))
        sub = {k: v[lo:lo + n] for k, v in cuda.items()}
        sub_cpu = {k: v[lo:lo + n] for k, v in cpu.items()}
        got = run(sub, hk.h264_requant_kernel,
                  hk.h264_requant_chroma_kernel)
        worst = max(worst, diff(got, run(sub, tf.h264_requant,
                                         tf.h264_requant_chroma)),
                    diff(got, run(sub_cpu, tf.h264_requant,
                                  tf.h264_requant_chroma)))
    check(worst == 0, f"B6 kernels at the edge sizes differ (max {worst})")
    log(f"[b6] {len(sizes)} edge sizes (N = "
        f"{', '.join(map(str, sizes[:-36]))} and 36 fuzzed below 5,000): "
        f"bit-exact with the plain chains on the card and the CPU")
    # refusals: nothing is launched
    before = dict(kernel_lib.LAUNCHES)
    empty = run({k: v[:0] for k, v in cuda.items()},
                hk.h264_requant_kernel, hk.h264_requant_chroma_kernel)
    check([tuple(t.shape) for t in empty] == [(0, 16), (0, 4), (0, 4, 15)],
          f"B6 at N = 0: {[tuple(t.shape) for t in empty]}")
    raw = torch.zeros(16 * 9 + 1, dtype=torch.int32, device="cuda")
    bad = [
        lambda: hk.h264_requant_kernel(raw[1:1 + 16 * 8].view(8, 16),
                                       cuda["qi"][:8], cuda["qo"][:8]),
        lambda: hk.h264_requant_kernel(cuda["lev"][:8].long(),
                                       cuda["qi"][:8], cuda["qo"][:8]),
        lambda: hk.h264_requant_kernel(cuda["lev"][:8], cuda["qi"][:8].long(),
                                       cuda["qo"][:8]),
        lambda: hk.h264_requant_chroma_kernel(
            raw[1:1 + 4 * 8].view(8, 4), cuda["ac"][:8], cuda["qci"][:8],
            cuda["qco"][:8]),
        lambda: hk.h264_requant_chroma_kernel(
            cuda["dc"][:8], cuda["ac"][:7], cuda["qci"][:8],
            cuda["qco"][:8])]
    for i, fn in enumerate(bad):
        try:
            fn()
        except (TypeError, ValueError):
            continue
        raise AssertionError(f"B6 bad input {i} did not raise")
    # the chroma entry point refuses a QP vector off 16 bytes (its bulk
    # copies could not take it; the wrapper copies such a view first)
    outs = (torch.empty((8, 4), dtype=torch.int32, device="cuda"),
            torch.empty((8, 4, 15), dtype=torch.int32, device="cuda"))
    try:
        kernel_lib.launch("ed_h264_requant_chroma", cuda["dc"].data_ptr(),
                          cuda["ac"].data_ptr(), cuda["qci"][1:].data_ptr(),
                          cuda["qco"].data_ptr(), 8, outs[0].data_ptr(),
                          outs[1].data_ptr())
    except RuntimeError:
        pass
    else:
        raise AssertionError("ed_h264_requant_chroma took a QP vector off "
                             "16 bytes")
    check(dict(kernel_lib.LAUNCHES) == before,
          "an empty or refused B6 call launched")
    log("[b6] N = 0 returns empty outputs; misaligned rows, int64 levels "
        "or QPs and mismatched DC/AC rows raise, and the chroma entry "
        "point refuses a QP vector off 16 bytes; none launches")
    leg = b6_leg_check(rng, x)
    return {"luma_rows": H264_LUMA_ROWS, "chroma_rows": H264_CHROMA_ROWS,
            "arms": arms, "levels_beyond_clip": clipped, "max_abs_err": err,
            "max_abs_err_cpu": err_cpu, "one_arm": by_arm,
            "edge_sizes": sizes,
            "edge_max_abs_err": worst, "first_call_ms": first_ms,
            "leg": leg}, cuda


#: the ladder's leg checks: (rows, targets) of the luma leg and (QPs, rows
#: a QP, targets) of the chroma leg; phase 13's AU (176x144: 99
#: macroblocks, up to 1,683 luma rows and 99 chroma QPs, at 2 deltas),
#: sizes around a CTA's rows, and chroma rows n % 4 = 1, 2 and 3 (the
#: card buffer's QP vectors then need their padding to stay 16-byte
#: aligned)
B6_LEG_LUMA = ((1, 1), (127, 2), (129, 3), (1683, 2), (4097, 2),
               (65_536, 2))
B6_LEG_CHROMA = ((1, 1, 1), (1, 2, 1), (63, 2, 2), (99, 2, 2), (333, 1, 2),
                 (4097, 2, 3), (77, 1, 1), (5, 1, 2), (333, 1, 3),
                 (43, 2, 3))
#: host legs timed alone at phase 13's AU
B6_LEG_REPS = 50


def b6_leg_check(rng, x: dict) -> dict:
    """The ladder's form of B6 (``ops.h264_kernel.RequantLeg``: numpy
    rows narrowed and tiled over the targets into pinned staging,
    uploaded, ONE launch, read back, in one call that keeps the GIL) at
    ``B6_LEG_*``'s sizes from phase 5c's inputs, each bit-exact with the
    plain chains on the same rows tiled on the card and one launch a leg;
    two legs in flight harvested in reverse order; the host µs of a leg
    alone at phase 13's AU (the constructor, then ``result``)."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import h264_kernel as hk
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops import transform as tf
    dev = torch.device(DEVICE)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    def luma(r, t):
        lo = int(rng.integers(0, H264_LUMA_ROWS - r))
        rows = x["lev"][lo:lo + r].astype(np.int64)
        qi = x["qi"][lo:lo + r].astype(np.int64)
        steps = 6 * rng.integers(-1, 4, t)
        want = tf.h264_requant(cu(np.tile(rows, (t, 1))), cu(np.tile(qi, t)),
                               cu((qi[None] + steps[:, None]).reshape(-1)))
        return [rows, qi, steps], [want]

    def chroma(m, g, t):
        lo = int(rng.integers(0, H264_CHROMA_ROWS - m * g))
        dc = x["dc"][lo:lo + m * g].astype(np.int64)
        ac = x["ac"][lo:lo + m * g].astype(np.int64)
        qi = x["qci"][lo:lo + m].astype(np.int64)
        offs = [lo] + [int(o) for o in
                       rng.integers(0, H264_CHROMA_ROWS - m, t - 1)]
        qo = np.stack([x["qco"][o:o + m] for o in offs]).astype(np.int64)
        want = tf.h264_requant_chroma(
            cu(np.tile(dc, (t, 1))), cu(np.tile(ac, (t, 1, 1))),
            cu(np.repeat(np.tile(qi, t), g)), cu(np.repeat(qo.reshape(-1), g)))
        return [dc, ac, qi, qo], list(want)

    cases = ([("luma", luma(*c), 1, c) for c in B6_LEG_LUMA]
             + [("chroma", chroma(*c), c[1], c) for c in B6_LEG_CHROMA])
    worst = 0
    for kind, (args, want), g, shape in cases:
        name = "ed_h264_requant" + ("" if kind == "luma" else "_chroma")
        before = kernel_lib.LAUNCHES[name]
        got = hk.RequantLeg(kind, args, dev, group=g).result()
        check(kernel_lib.LAUNCHES[name] == before + 1,
              f"{kind} leg {shape}: not one launch")
        for a, b in zip(got, want):
            check(a.shape == tuple(b.shape), f"{kind} leg {shape}: shape "
                  f"{a.shape} != {tuple(b.shape)}")
            worst = max(worst, int(np.abs(a - b.cpu().numpy()).max()))
    check(worst == 0, f"B6 legs differ from the plain chains (max {worst})")
    # two legs in flight, harvested in reverse order (each owns buffers)
    (la, wa), (lb, wb) = luma(1683, 2), luma(999, 3)
    pa = hk.RequantLeg("luma", la, dev)
    pb = hk.RequantLeg("luma", lb, dev)
    check(np.array_equal(pb.result()[0], wb[0].cpu().numpy())
          and np.array_equal(pa.result()[0], wa[0].cpu().numpy()),
          "two B6 legs in flight mixed their rows")
    # a leg alone at phase 13's AU: the host µs of each half
    (ll, _), (lc, _) = luma(1683, 2), chroma(99, 2, 2)
    sub, res = [], []
    for _ in range(B6_LEG_REPS):
        t0 = time.perf_counter()
        legs = (hk.RequantLeg("luma", ll, dev),
                hk.RequantLeg("chroma", lc, dev, group=2))
        t1 = time.perf_counter()
        for leg in legs:
            leg.result()
        sub.append((t1 - t0) * 1e6)
        res.append((time.perf_counter() - t1) * 1e6)
    alone = {"submit_us_p50": float(np.median(sub)),
             "result_us_p50": float(np.median(res))}
    log(f"[b6] the ladder's leg (RequantLeg: stage, upload, one launch, "
        f"readback in one GIL-keeping call) at {len(cases)} sizes "
        f"(luma {B6_LEG_LUMA}, chroma {B6_LEG_CHROMA}: (rows or QPs, "
        f"rows a QP, targets)): bit-exact with the plain chains on the "
        f"tiled rows, one launch a leg; two in flight harvested in "
        f"reverse order; alone at phase 13's AU (luma 1683 x 2, chroma "
        f"99 x 2 x 2), median of {B6_LEG_REPS}: both legs' constructors "
        f"{alone['submit_us_p50']:.1f} host us, their results "
        f"{alone['result_us_p50']:.1f}")
    return {"max_abs_err": worst, "alone": alone}


#: integer operations a B6 luma level (clip 2, abs, add, shift, sign
#: multiply) and a row (k and the offset)
OPS_PER_B6_LUMA_LEVEL, OPS_PER_B6_LUMA_ROW = 6, 8
#: integer operations a B6 chroma row by its arm, counted from
#: ``csrc/h264_kernels.cu``: identity, the clip of 64 levels (128); exact
#: shift, the clip and the rounded shift (abs, add, shift, sign: 448);
#: general, the clip 128, DC Hadamard and dequant 16, AC dequant 60, the
#: four blocks' inverse core 320, the round and clip 256, the forward core
#: 320, its clip 128, AC requant 480 (multiply, abs, add, shift, sign 2,
#: clip 2) and the DC requant 48 (1,756); and a row's arm, shifts and
#: offsets (16)
OPS_PER_B6_CHROMA_ARM = {"identity": 128, "shift": 448, "general": 1756}
OPS_PER_B6_CHROMA_ROW = 16
#: INT32 lanes an SM has a clock on Hopper (16 in each of its four
#: partitions; NVIDIA's Hopper white paper): B6's integer work runs at
#: these lanes' rate, not the 32-bit float rate
INT32_LANES_PER_SM = 64
_INT32_RATE: list = []


def int32_ops_per_s() -> float:
    """The card's int32 lane rate: ``INT32_LANES_PER_SM`` × its SMs × the
    highest SM clock ``nvidia-smi --query-gpu=clocks.max.sm`` reads."""
    if not _INT32_RATE:
        import torch
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _INT32_RATE.append(INT32_LANES_PER_SM * sms * mhz * 1e6)
    return _INT32_RATE[0]


def b6_bound(kind: str, rows: int, arms: dict | None = None
             ) -> tuple[int, tuple[int, float]]:
    """(bytes, (operations, int32 operations a second)) of one B6 call at
    ``rows`` rows; for chroma, ``arms`` gives the rows of each arm (the
    work depends on them)."""
    if kind == "luma":
        return (h264_bound(rows, 16 * 4),
                (rows * (16 * OPS_PER_B6_LUMA_LEVEL + OPS_PER_B6_LUMA_ROW),
                 int32_ops_per_s()))
    ops = rows * OPS_PER_B6_CHROMA_ROW + sum(
        OPS_PER_B6_CHROMA_ARM[a] * n for a, n in arms.items())
    return h264_bound(rows, 64 * 4), (ops, int32_ops_per_s())


#: phase 13's AU of chroma rows: 99 QPs x 2 rows (Cb, Cr) x 2 targets
B6_AU_CHROMA_ROWS = 396


def b6_cases(x: dict) -> list:
    """Phase 10's B6 rows at phase 5c's config-5 inputs: each kernel's
    entry point on preallocated outputs, its wrapper and its plain chain
    (``phase_kernels``'s case tuple); the chroma kernel also with every
    row general and at phase 13's AU (the first 396 rows of the mix)."""
    import torch
    from easydarwin_tpu_torch.ops import h264_kernel as hk
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops import transform as tf
    src = "easydarwin_tpu_torch/csrc/h264_kernels.cu"
    n = x["lev"].shape[0]
    out = torch.empty_like(x["lev"])
    lb, lo = b6_bound("luma", n)

    def chroma(dc, ac, qi, qo, label: str, main: bool, inner: int):
        m = dc.shape[0]
        dc_out, ac_out = torch.empty_like(dc), torch.empty_like(ac)
        cb, co = b6_bound("chroma", m, chroma_arms(qi.cpu().numpy(),
                                                   qo.cpu().numpy()))
        return ("ed_h264_requant_chroma", f"DC [{m},4] AC [{m},4,15]{label}",
                main, src, "easydarwin_tpu/ops/transform.py:315",
                lambda: kernel_lib.launch(
                    "ed_h264_requant_chroma", dc.data_ptr(), ac.data_ptr(),
                    qi.data_ptr(), qo.data_ptr(), m, dc_out.data_ptr(),
                    ac_out.data_ptr()),
                lambda: hk.h264_requant_chroma_kernel(dc, ac, qi, qo),
                lambda: tf.h264_requant_chroma(dc, ac, qi, qo), None,
                cb, co, inner)

    qi, qo = chroma_arm_qps({"qci": x["qci"].cpu().numpy()}, "general")
    au = slice(0, B6_AU_CHROMA_ROWS)
    return [
        ("ed_h264_requant", f"[{n},16]", True, src,
         "easydarwin_tpu/ops/transform.py:264",
         lambda: kernel_lib.launch(
             "ed_h264_requant", x["lev"].data_ptr(), x["qi"].data_ptr(),
             x["qo"].data_ptr(), n, out.data_ptr()),
         lambda: hk.h264_requant_kernel(x["lev"], x["qi"], x["qo"]),
         lambda: tf.h264_requant(x["lev"], x["qi"], x["qo"]), None,
         lb, lo, 20),
        chroma(x["dc"], x["ac"], x["qci"], x["qco"], "", True, 20),
        chroma(x["dc"], x["ac"], torch.from_numpy(qi).cuda(),
               torch.from_numpy(qo).cuda(), " every row general", False, 20),
        chroma(x["dc"][au], x["ac"][au], x["qci"][au], x["qco"][au],
               " (phase 13's AU)", False, 100)]


def phase_b6(x: dict, timed: list, floor_ms: float, hls: dict) -> dict:
    """B6 at config 5 from phase 10's rows (the kernels in a graph, the
    plain chains, the bounds and the launch floor), and the kernels again
    after the graph replays, bit-exact with the plain chains; beside them
    phase 13's dispatch leg (host ms an AU)."""
    import torch
    from easydarwin_tpu_torch.ops import h264_kernel as hk
    from easydarwin_tpu_torch.ops import transform as tf
    got = (hk.h264_requant_kernel(x["lev"], x["qi"], x["qo"]),
           *hk.h264_requant_chroma_kernel(x["dc"], x["ac"], x["qci"],
                                          x["qco"]))
    want = (tf.h264_requant(x["lev"], x["qi"], x["qo"]),
            *tf.h264_requant_chroma(x["dc"], x["ac"], x["qci"], x["qco"]))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "B6 kernels after the graph replays differ from the plain chains")
    res = {"transform_device_ms_per_au":
           hls["stage_ms_per_au"]["transform_device"], "rows": []}
    for k in timed:
        if k["name"] not in HLS_KERNELS:
            continue
        row = {"name": k["name"], "shape": k["_shape"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "bytes_ms": k["_bytes_ms"],
               "ops_ms": k["_ops_ms"], "ops_per_s": k["_ops_rate"],
               "bound_share": k["_bound_share"],
               "gb_per_s": k["_gb_per_s"], "call_ms": k["_wrapper_call_ms"],
               "plain_call_ms": k["_plain_call_ms"],
               "floors": k["ms"] / floor_ms, "launches": k["launches"]}
        res["rows"].append(row)
        if k["_main_path"]:
            res[k["name"]] = row
        log(f"[b6] {k['name']} at {k['_shape']}: {k['ms']:.6f} ms in a "
            f"graph ({k['ms'] / floor_ms:.2f}x the {floor_ms:.6f} ms launch "
            f"floor), bound {k['bound_ms']:.6f} ms by {k['bound_by']} "
            f"(bytes {k['_bytes_ms']:.6f} ms at {PEAK_BYTES_PER_S:.3g} B/s, "
            f"operations {k['_ops_ms']:.6f} ms at {k['_ops_rate']:.4g} int32 "
            f"op/s; {k['_bound_share']:.1%} of the bound, "
            f"{k['_gb_per_s']:.1f} GB/s); plain torch chain "
            f"{k['plain_ms']:.6f} ms in a graph "
            f"({k['plain_ms'] / k['ms']:.1f}x the kernel), "
            f"{k['_plain_call_ms']:.6f} ms a direct call; the wrapper "
            f"{k['_wrapper_call_ms']:.6f} ms a direct call; "
            f"{k['launches']} launches on the HLS path")
    log(f"[b6] phase 13's dispatch leg (pinned upload, both launches, "
        f"readback, event wait): "
        f"{res['transform_device_ms_per_au']:.3f} host ms an AU; the "
        f"kernels equal the plain chains after the graph replays")
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
    #: dispatch), and the whole wake; then, outside the wake, the walk the
    #: server's pump makes after each pass to arm the timer wheel (every
    #: stream's ``next_deadline_ms``, over every held-back output)
    parts = {"begin": [], "steps": [], "end": [], "wake": [], "schedule": []}
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
        for s in dev:
            s.next_deadline_ms(t, allow_due=not s.last_pass_stalled)
        t4 = time.perf_counter()
        for k, a, b in (("begin", t0, t1), ("steps", t1, t2), ("end", t2, t3),
                        ("wake", t0, t3), ("schedule", t3, t4)):
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
        f"{res['end_host_ms_p50']:.3f}; the pump's deadline walk over the "
        f"{n_streams} streams after a wake (not in the wake) p50 "
        f"{res['schedule_host_ms_p50']:.4f} max "
        f"{res['schedule_host_ms_max']:.4f}")
    return res


# ------------------------------------------------------------- phase 6b
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
    from easydarwin_tpu_torch.utils.loopback import (VIDEO_SDP,
                                                     udp_rcvbuf_errors)

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
        f"ed_stream_send; server launches {st['kernel_launches']}; "
        f"{schedule_line(st)}")
    return res


def schedule_line(st: dict) -> str:
    """The pump's wheel work after each pass (advance, and every stream's
    next deadline armed), which ``wake_ms`` leaves out."""
    p = st["pump"]
    if p["schedule_ms_p50"] is None:
        return "pump schedule host ms: no wake"
    return (f"pump schedule host ms p50 {p['schedule_ms_p50']:.4f} max "
            f"{p['schedule_ms_max']:.4f}")


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
        f"p50 {st['wake_ms_p50']:.3f} max {st['wake_ms_max']:.3f}; "
        f"{schedule_line(st)}")
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
    check(launches["ed_relay_batch"] > 0
          and launches["ed_relay_batch"] == st["batch_passes"],
          f"the batch-header rung's {st['batch_passes']} passes made "
          f"{launches['ed_relay_batch']} ed_relay_batch launches")
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
        f"{st['wake_ms_max']:.3f}, first join's {st['wake_ms_first']:.3f}; "
        f"batch-header rung host ms a pass: staging + H2D "
        f"{st['batch_stage_ms_per_pass']:.6f}, kernel + D2H "
        f"{st['batch_kernel_ms_per_pass']:.6f}")
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
    rcvbuf0 = loopback.udp_rcvbuf_errors()
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
        f"{rel['resends']} resends, {rel['acks']} acks, 0 give-ups, RTO at "
        f"most {rel['rto_ms_max']:.1f} ms; RTCP {st['rtcp']} (socket_drops: "
        f"datagrams the server's RTCP socket lost); host UDP RcvbufErrors "
        f"+{loopback.udp_rcvbuf_errors() - rcvbuf0}; launches {launches}")
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


# ------------------------------------------------------------- phase 7e
def phase_udp_push(rng) -> dict:
    """BASELINE config 2 pushed over RTP/UDP: phase 7b's traffic from a
    pusher that SETUPs with ``client_port`` and ``mode=record`` and sends
    its packets and SRs to the server's port pair; the server drains its
    RTP socket natively (recvmmsg batches straight into the ring)."""
    from easydarwin_tpu_torch.utils import loopback
    res = asyncio.run(asyncio.wait_for(loopback.serve_and_check(
        DEVICE, rng, n_push=1, n_play=CONFIG2_SUBS, transport="udp",
        push_transport="udp", gops=5, frames=30, packets_per_frame=13,
        body_len=(1270, 1300), frame_interval_s=1 / 30, join_every=1,
        deadline_s=30), 240))
    st = res["server_stats"]
    ing = st["ingest"]
    check(st["native_loaded"], "the server's egress core did not load")
    check(ing["native_pkts"] == res["packets_pushed"]
          and ing["datagram_pkts"] == 0,
          f"the native drain served {ing['native_pkts']} of "
          f"{res['packets_pushed']} packets pushed: {ing}")
    check(ing["oversize"] == 0 and ing["errors"] == 0
          and ing["native_batches"] > 0, f"native ingest: {ing}")
    check(st["send_errors"] == 0 and st["missing_params"] == 0,
          f"udp push send errors / missing params: {st}")
    check(min(res["upstream_rrs"]) >= 1, "the pusher received no RR")
    res["ingest_ns_per_packet"] = ing["ingest_ns"] / max(ing["recv_packets"],
                                                         1)
    log(f"[udp push] config 2 pushed over RTP/UDP: 1 source x "
        f"{res['players']} UDP players, {res['packets_pushed']} packets "
        f"pushed, {res['delivered']} datagrams delivered, every one held to "
        f"the oracle; native ingest {ing['native_pkts']} packets in "
        f"{ing['native_batches']} drains ({ing['recvmmsg_calls']} recvmmsg "
        f"calls), 0 oversize, 0 errors, "
        f"{res['ingest_ns_per_packet']:.1f} ns a packet inside "
        f"ed_udp_ingest; the pusher got {res['upstream_rrs'][0]} RRs; "
        f"native_sent {st['native_sent']} of {st['packets_out']}; launches "
        f"{st['kernel_launches']}")
    log(f"[udp push] wake host ms p50 {st['wake_ms_p50']:.3f} max "
        f"{st['wake_ms_max']:.3f}, first join's {st['wake_ms_first']:.3f}")
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
    before_b7 = kernel_lib.LAUNCHES["ed_requant_rungs"]
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
    b7_launched = kernel_lib.LAUNCHES["ed_requant_rungs"] - before_b7
    check(b7_launched == 8,
          f"pipeline launched ed_requant_rungs {b7_launched} times in 8 steps")
    ref = TranscodePipeline(cfg, device="cpu")(levels.cpu())
    rung_d = (first["rungs"].to(torch.int64) - ref["rungs"].to(torch.int64)
              ).abs()
    rung_max = int(rung_d.max())
    rung_frac = float((rung_d > 0).double().mean())
    # ed_requant_rungs rounds every product and quotient as the CPU does
    check(rung_max == 0,
          f"pipeline rungs off the CPU run: max {rung_max}, {rung_frac:.4%}")
    check(torch.equal(first["nonzeros"], ref["nonzeros"]),
          "pipeline nonzeros differ from the CPU run")
    pix_max, pix_frac = k2_diff(first["pixels"], ref["pixels"])
    check(pix_max <= K2_MAX_DIFF and pix_frac < K2_MAX_FRAC,
          f"pipeline pixels off the CPU run: max {pix_max}, {pix_frac:.4%}")
    nz = first["nonzeros"].tolist()
    check(nz[0] >= nz[1] >= nz[2] > 0, f"nonzeros not monotone: {nz}")
    res = {"blocks": CONFIG5_BLOCKS, "steps": 8, "k2_launches": launched,
           "b7_launches": b7_launched,
           "step_ms": step_ms, "step_ms_p50": float(np.median(step_ms)),
           "rungs_max_abs_err": rung_max, "rungs_mismatch_frac": rung_frac,
           "rungs_bit_exact": rung_max == 0,
           "nonzeros": nz, "nonzeros_equal": bool(
               torch.equal(first["nonzeros"], ref["nonzeros"])),
           "pixels_max_abs_err": pix_max, "pixels_mismatch_frac": pix_frac}
    log(f"[pipeline] 8 steps x {CONFIG5_BLOCKS} blocks, {launched} K2 and "
        f"{b7_launched} ed_requant_rungs launches, step p50 {res['step_ms_p50']:.3f} ms (host clock, "
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


# ------------------------------------------------------------- phase 11
#: the VOD clips under ``build/`` (git-ignored): clip A 1080p30 30 s with
#: AAC, clip B 2160p30 10 s (``utils.vod_clips``)
VOD_DIR = os.path.join(HERE, "build", "vod_clips")
#: players of phase 11: 64 on clip A joining one a frame, 8 on clip B
#: joining one each 8 frames; seconds of play
VOD_A_PLAYERS, VOD_B_PLAYERS, VOD_RUN_S = 64, 8, 8.0


def vod_clips(seed: int) -> dict:
    """Write clips A and B from ``seed``; returns their paths."""
    from easydarwin_tpu_torch.utils import vod_clips as vc
    os.makedirs(VOD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    paths = {"A": vc.write_clip(os.path.join(VOD_DIR, "clipA.mp4"),
                                vc.CLIP_A, seed),
             "B": vc.write_clip(os.path.join(VOD_DIR, "clipB.mp4"),
                                vc.CLIP_B, seed + 1)}
    log(f"[vod] clips written from seed {seed} in "
        f"{time.perf_counter() - t0:.3f} s: A "
        f"{os.path.getsize(paths['A'])} B (1080p30 30 s + AAC), B "
        f"{os.path.getsize(paths['B'])} B (2160p30 10 s)")
    return paths


def phase_vod(clips: dict) -> dict:
    """VOD in-process on the card: a warm ``SegmentCache`` resident on the
    card, the group pacer, the megabatch scheduler and one engine a
    stream over loopback UDP; every join primed on the card; every
    datagram held to the cold path."""
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.utils import vod_loopback as vl
    before = kernel_lib.LAUNCHES["ed_relay_window"]
    res = vl.vod_in_process(
        DEVICE, [vl.VodClip(clips["A"], VOD_A_PLAYERS, 1),
                 vl.VodClip(clips["B"], VOD_B_PLAYERS, 8)],
        run_s=VOD_RUN_S)
    res["ed_relay_window"] = kernel_lib.LAUNCHES["ed_relay_window"] - before
    pacer, cache, sched = res["pacer"], res["cache"], res["scheduler"]
    check(res["datagrams"] > 0, "no VOD datagram arrived")
    check(res["lost"] <= res["udp_rcvbuf_errors"],
          f"{res['lost']} datagrams not received, but the host's UDP "
          f"RcvbufErrors rose by {res['udp_rcvbuf_errors']}")
    check(res["native_sent"] == res["sent"],
          f"native_sent {res['native_sent']} != the outputs' {res['sent']}")
    check(pacer["device_primes"] == res["joins"],
          f"{pacer['device_primes']} device primes for {res['joins']} "
          f"joins with fast outputs")
    check(pacer["prime_failures"] == 0, f"prime failures: {pacer}")
    check(cache["device_uploads"] <= res["windows_touched"],
          f"{cache['device_uploads']} uploads for "
          f"{res['windows_touched']} windows touched")
    check(sched["mismatches"] == 0 and sched["streams_coalesced"] > 0,
          f"scheduler: {sched}")
    check(res["send_errors"] == 0, "VOD send errors")
    check(res["ed_relay_window"] >= sched["window_calls"] > 0,
          f"ed_relay_window launches {res['ed_relay_window']}, window "
          f"calls {sched['window_calls']}")
    joins = max(pacer["device_primes"], 1)
    calls = max(pacer["prime_calls"], 1)
    split = {leg: pacer[f"prime_{leg}_ms_per_call"] * calls / joins
             for leg in ("stack", "launch", "oracle")}
    res["prime_host_ms_per_join"] = split
    log(f"[vod] {res['players']} players ({VOD_A_PLAYERS} of clip A "
        f"one a frame, {VOD_B_PLAYERS} of clip B), {VOD_RUN_S:g} s: "
        f"{res['datagrams']} datagrams, every one equal to the cold path's; "
        f"{res['lost']} not received (UDP RcvbufErrors "
        f"+{res['udp_rcvbuf_errors']}); native_sent {res['native_sent']}; "
        f"{cache['windows']} windows warmed in {res['warm_s']:.3f} s, "
        f"{cache['device_uploads']} uploaded for {res['windows_touched']} "
        f"touched, {cache['device_bytes']} B resident on the card; "
        f"device primes {pacer['device_primes']} = joins {res['joins']}, "
        f"prime failures 0, prime calls {pacer['prime_calls']}; scheduler "
        f"window calls {sched['window_calls']}, coalesced "
        f"{sched['streams_coalesced']}, mismatches 0; ed_relay_window "
        f"launches {res['ed_relay_window']}")
    eg = res.get("egress", {})
    if eg.get("send_packets"):
        per = eg["send_ns"] / eg["send_packets"] / 1e3
        log(f"[vod] inside sendmmsg: {per:.3f} us a datagram over "
            f"{eg['send_packets']} datagrams in "
            f"{eg['sendmmsg_calls']} calls, "
            f"{eg['send_ns'] / 1e6 / res['wake_ms_sum']:.1%} of the wakes' "
            f"{res['wake_ms_sum']:.1f} host ms")
    log(f"[vod] the prime's host ms per join: stack "
        f"{split['stack']:.6f}, launch + readback {split['launch']:.6f}, "
        f"oracle {split['oracle']:.6f}; its window calls by shape "
        f"{res['prime_shapes']}; wake host ms p50 {res['wake_ms_p50']:.3f} "
        f"max {res['wake_ms_max']:.3f}")
    return res


# ------------------------------------------------------- phases 11b, 11c
#: phase 11b's players of clip A, in join order: 32 from npt 0, 16 with
#: Range npt=10-, 8 with Scale 2, 8 that PAUSE at 3 s and PLAY with Range
#: npt=3-, 4 interleaved TCP, one with x-Retransmit, one asking for x-FEC
VOD_SERVER_KINDS = (["plain"] * 32 + ["range"] * 16 + ["scale"] * 8
                    + ["pause"] * 8 + ["tcp"] * 4 + ["retransmit", "fec"])


def phase_vod_server(clips: dict, rng) -> dict:
    """Clip A from ``python -m easydarwin_tpu_torch --device cuda
    --movie-folder`` to phase 11b's players, every packet held to the cold
    path; then phase 11c: phase 7b's traffic pushed for 5 s with REST
    startrecord/stoprecord, the file equal to the CPU recorder's."""
    from easydarwin_tpu_torch.utils import loopback, synth, vod_clips
    from easydarwin_tpu_torch.utils import vod_loopback as vl

    async def run():
        async with loopback.CliServer(DEVICE, "--movie-folder",
                                      VOD_DIR) as srv:
            rcvbuf0 = loopback.udp_rcvbuf_errors()
            play = await vl.play_vod(srv.rtsp_port, VOD_DIR, "clipA.mp4",
                                     VOD_SERVER_KINDS, run_s=VOD_RUN_S)
            play["udp_rcvbuf_errors"] = loopback.udp_rcvbuf_errors() - rcvbuf0
            play_stats = await srv.stop(counters=loopback.TIER_COUNTERS)
        # the recorder on a server of its own, so each phase's wake
        # figures are its own
        async with loopback.CliServer(DEVICE, "--movie-folder",
                                      VOD_DIR) as srv:
            pkts = []
            for g in range(5):
                pkts += synth.paced_gop(
                    rng, seq0=0xFFE0 + len(pkts),
                    ts0=0xFFFF0000 + 3000 * len(pkts) // 13,
                    ssrc=0xC0DE0000, frames=30, packets_per_frame=13,
                    body_len=(1270, 1300))
            rec = await vl.record_via_rest(
                srv.rtsp_port, srv.rest_port, VOD_DIR, pkts,
                sps=vod_clips.SPS, pps=vod_clips.PPS, frame_s=1 / 30,
                packets_per_frame=13)
            rec["server_stats"] = await srv.stop()
            return play, rec, play_stats

    play, rec, st = asyncio.run(asyncio.wait_for(run(), 300))
    vod = st["vod"]
    launches = st["kernel_launches"]
    check(st["vod_errors"] == 0, f"server VOD pacer errors: {st}")
    check(vod["prime_failures"] == 0 and vod["device_primes"] > 0,
          f"server VOD primes: {vod}")
    check(launches["ed_relay_window"] > 0,
          "the VOD server launched no ed_relay_window")
    lost = sum(r["lost"] for k, r in play["by_kind"].items() if k != "tcp")
    check(lost <= play["udp_rcvbuf_errors"],
          f"{lost} VOD datagrams not received, but the host's UDP "
          f"RcvbufErrors rose by {play['udp_rcvbuf_errors']}")
    tcp_gaps = play["by_kind"]["tcp"]["lost"]
    check(tcp_gaps <= st["tcp_shed_pkts"],
          f"{tcp_gaps} packets missing in the TCP players' streams, but the "
          f"server's TCP rung shed {st['tcp_shed_pkts']}")
    log(f"[vod server] clip A to {play['players']} players "
        + ", ".join(f"{k} {r['players']}" for k, r in
                    play["by_kind"].items())
        + f": {sum(r['datagrams'] for r in play['by_kind'].values())} "
        f"packets, every one equal to the cold path's, {lost} lost in "
        f"UDP (RcvbufErrors +{play['udp_rcvbuf_errors']}), {tcp_gaps} in "
        f"TCP (the TCP rung shed {st['tcp_shed_pkts']}); DESCRIBE, Range "
        f"and RTP-Info as the cold path computes; no x-FEC grant; the "
        f"reliable player's acks {play['by_kind']['retransmit']['acks']}, "
        f"resends received {play['by_kind']['retransmit']['duplicates']}; "
        f"device primes "
        f"{vod['device_primes']}, prime failures 0, hot packets "
        f"{vod['hot_pkts']}, cold {vod['cold_pkts']}; launches {launches}")
    eg = st.get("egress", {})
    if eg.get("send_packets"):
        log(f"[vod server] inside sendmmsg: "
            f"{eg['send_ns'] / eg['send_packets'] / 1e3:.3f} us a datagram "
            f"over {eg['send_packets']} datagrams, "
            f"{eg['send_ns'] / 1e9:.3f} s in all")
    log(f"[vod server] wake host ms p50 {st['wake_ms_p50']:.3f} max "
        f"{st['wake_ms_max']:.3f}, first join {st['wake_ms_first']:.3f} "
        f"({st['wakes']} wakes, {st['megabatch']['wakes']} through the "
        f"megabatch, {st['packets_out']} packets out); "
        f"the prime's host ms per call: stack "
        f"{vod['prime_stack_ms_per_call']:.6f}, launch + readback "
        f"{vod['prime_launch_ms_per_call']:.6f}, oracle "
        f"{vod['prime_oracle_ms_per_call']:.6f} ({vod['prime_calls']} calls)")
    log(f"[record] phase 7b's traffic for 5 s recorded over REST: "
        f"{rec['samples']} samples ({rec['sync_samples']} sync), "
        f"{rec['bytes']} B, byte-equal to the CPU RecorderOutput's file, "
        f"tables read back through Mp4File")
    vod_launches = {k: n + rec["server_stats"]["kernel_launches"].get(k, 0)
                    for k, n in st["kernel_launches"].items()}
    return {"play": play, "record": rec, "server_stats": st,
            "kernel_launches": vod_launches}


def tier_totals() -> dict:
    """This process's totals of the tiers' counter families."""
    from easydarwin_tpu_torch import obs
    from easydarwin_tpu_torch.utils.loopback import TIER_COUNTERS
    return {n: obs.REGISTRY.get(n).total() for n in TIER_COUNTERS}


def tier_check(before: dict, servers: list) -> dict:
    """The tiers' counter families over phases 11-13: this process's
    change since ``before`` plus each CLI server's scrape at its stop
    (``servers``: their exit stats); fails on a family still at 0."""
    now = tier_totals()
    got = {n: now[n] - before[n] + sum(st["counters"][n] for st in servers)
           for n in now}
    zero = [n for n, v in got.items() if not v]
    check(not zero, f"tier counter families at 0 over phases 11-13: {zero}")
    log(f"[tiers] counter families over phases 11-13 (this process and "
        f"{len(servers)} servers): {got}")
    return got


# ------------------------------------------------------------- phase 12
#: phase 12's movie folder (its .dvr and .shards trees), written anew
DVR_DIR = os.path.join(HERE, "build", "dvr_phase")
#: phase 12's players of the live path, in join order: live, pause, range
DVR_PLAYERS = (48, 8, 8)
#: the spill window (packets) and the stripe geometry: the defaults
DVR_WINDOW_PKTS, STORAGE_K, STORAGE_M = 64, 4, 2


def dvr_manifest(folder: str) -> dict:
    """The stored asset's manifest, read from phase 12's shard tree."""
    from easydarwin_tpu_torch.utils.dvr_loopback import PATH
    with open(os.path.join(folder, ".shards", PATH.strip("/"),
                           "manifest.json")) as f:
        return json.load(f)


def phase_dvr(rng) -> dict:
    """DVR, time-shift and the store through the CLI server on the card
    (``utils.dvr_loopback.dvr_session``), every datagram held to the
    pushed packets; the counters that must be 0, the catch-up joins, the
    store and the scrub; returns the launches of both servers and the
    stripe shapes B4 ran at."""
    from easydarwin_tpu_torch.ops.staging import pow2
    from easydarwin_tpu_torch.utils import dvr_loopback as dl
    res = asyncio.run(asyncio.wait_for(dl.dvr_session(
        DEVICE, DVR_DIR, rng, kinds=dl.phase_players(*DVR_PLAYERS),
        window_pkts=DVR_WINDOW_PKTS), 600))
    a, b = res["server_a"], res["server_b"]
    man = dvr_manifest(DVR_DIR)
    stripes = sum(len(t["stripes"]) for t in man["tracks"].values())
    windows = sum(len(t["wins"]) for t in man["tracks"].values())
    n_shift = DVR_PLAYERS[1] + DVR_PLAYERS[2]
    check(a["dvr"]["catchup_joins"] == 2 * n_shift,
          f"catch-up joins {a['dvr']['catchup_joins']}, not {n_shift} "
          f"players x 2 tracks")
    for name, st in (("A", a), ("B", b)):
        zero = {"vod_errors": st["vod_errors"],
                "finalize_errors": st["dvr"]["finalize_errors"],
                "spill_errors": st["dvr"]["spill_errors"],
                **{k: st["storage"][k] for k in (
                    "push_failures", "reconstruct_failures",
                    "oracle_mismatches", "worker_errors", "repair_errors",
                    "scrub_errors")}}
        check(not any(zero.values()), f"server {name}: nonzero {zero}")
        check(st["kernel_launches"]["ed_relay_window"] > 0,
              f"server {name} launched no ed_relay_window")
        check(st["dvr_megabatch_streams"] > 0,
              f"server {name}: no time-shift stream went through "
              f"begin_wake")
        check(st["kernel_launches"]["ed_gf_parity"]
              == st["storage"]["device_passes"] > 0,
              f"server {name}: ed_gf_parity launches "
              f"{st['kernel_launches']['ed_gf_parity']} != the store's "
              f"device passes {st['storage']['device_passes']}")
    sa, sb = a["storage"], b["storage"]
    check(sa["assets"] == 1, f"stored assets {sa['assets']}")
    check(sa["shards_local"] == windows + STORAGE_M * stripes,
          f"shards_local {sa['shards_local']} != {windows} data + "
          f"{STORAGE_M} x {stripes} parity")
    check(sa["device_passes"] == stripes,
          f"store device passes {sa['device_passes']} != {stripes} stripes")
    scrub = res["scrub"]
    check(scrub["errors"] == 0 and scrub["scrubbed"] == scrub["files"]
          == sa["shards_local"], f"scrub {scrub}")
    check(sb["reconstructs"] > 0 and sb["gathers"] > 0,
          f"server B reconstructed nothing: {sb}")
    check(res["by_kind"]["reconstruct"]["players"] > 0, "no reconstruct "
          "player")
    fin = a["dvr"]["finalized_assets"][0]
    for tid, tr in sorted(fin["tracks"].items()):
        log(f"[dvr] track {tid}: {tr['windows']} spill windows, "
            f"{tr['bytes']} B ({tr['skipped']} skipped, {tr['evictions']} "
            f"evicted), {tr['spill_ns'] / 1e6:.3f} host ms spilling")
    log(f"[dvr] spill tick: {a['dvr']['spill_ms_per_spill_tick']:.6f} host "
        f"ms a tick that spilled ({a['dvr']['spill_ticks']} of "
        f"{a['dvr']['ticks']} ticks; {a['dvr']['tick_ms_per_tick']:.6f} ms "
        f"a tick over all); finalize {fin['finalize_ms']:.3f} ms")
    log(f"[dvr] store_asset: {sa['store_ms_per_call']:.3f} ms for "
        f"{stripes} stripes of k={STORAGE_K} m={STORAGE_M} ({windows} "
        f"windows, {sa['shards_local']} shards): {sa['device_passes']} B4 "
        f"launches, {sa['parity_product_ms']:.3f} ms in the products "
        f"(upload, launch, readback), {sa['parity_check_ms']:.3f} ms in "
        f"the host checks")
    log(f"[dvr] reconstruct (server B, {res['deleted']['shards_deleted']} "
        f"shards of {res['deleted']['stripes']} stripes and "
        f"{res['deleted']['spill_files']} spill files deleted): "
        f"{sb['gathers']} gathers, per reconstruct gather "
        f"{sb['gather_ms_per_reconstruct']:.6f} ms, launch + readback "
        f"{sb['product_ms_per_reconstruct']:.6f} ms, crc "
        f"{sb['check_ms_per_reconstruct']:.6f} ms; {sb['device_passes']} "
        f"B4 launches, {sb['reconstructs']} windows served")
    for name, st in (("A", a), ("B", b)):
        log(f"[dvr] server {name}: wake host ms p50 {st['wake_ms_p50']:.3f} "
            f"max {st['wake_ms_max']:.3f} ({st['wakes']} wakes, "
            f"{st['megabatch']['wakes']} through the megabatch); "
            f"{st['dvr_megabatch_streams']} time-shift streams through "
            f"begin_wake; launches {st['kernel_launches']}")
    log(f"[dvr] first join of a .dvr replay: "
        + ", ".join(f"{x:.3f}" for x in res["replay_first_ms"])
        + " ms (PLAY reply to first datagram); through the reconstruct: "
        + ", ".join(f"{x:.3f}" for x in res["reconstruct_first_ms"]) + " ms")
    log(f"[dvr] players: " + ", ".join(
        f"{k} {v['players']} ({v['datagrams']} datagrams, {v['lost']} "
        f"lost)" for k, v in res["by_kind"].items())
        + f"; every datagram equal to the pushed packet's rewrite; "
        f"{res['lost']} lost (UDP RcvbufErrors +{res['udp_rcvbuf_errors']});"
        f" {a['dvr']['catchup_joins']} catch-up joins ({n_shift} players x "
        f"2 tracks); {res['video_packets']} video and "
        f"{res['audio_packets']} audio packets pushed in "
        f"{res['push_s']:.3f} s; scrub of {scrub['scrubbed']} shards: 0 "
        f"errors")
    widths = sorted({pow2(max(s["width"] for s in t["stripes"]), 256)
                     for t in man["tracks"].values()})
    shapes = [(STORAGE_K, w, pow2(STORAGE_M, 1)) for w in widths]
    launches = {k: a["kernel_launches"][k] + b["kernel_launches"].get(k, 0)
                for k in a["kernel_launches"]}
    res.pop("server_a")
    res.pop("server_b")
    return {"result": res, "server_a": a, "server_b": b,
            "stripes": stripes, "windows": windows, "shapes": shapes,
            "kernel_launches": launches}


# ------------------------------------------------------------- phase 13
#: config 5's H.264 ladder through HLS: 16 sources, the picture size it
#: was cut to for the CPython walk (kept, so that its figures compare
#: with the earlier runs'; phase 13c runs config 5's pictures), pictures
#: a source and the push rate (16 x HLS_FPS AUs a second; more pictures a
#: path than the ladder's shed gate, ``max(4, 2 * workers)`` AUs pending,
#: so that a ladder falling behind would shed), the requant rungs and the
#: master GETs (single-slice sources, which also get r1 and r2)
HLS_SOURCES, HLS_WIDTH, HLS_HEIGHT = 16, 176, 144
HLS_FRAMES, HLS_FPS, HLS_GOP = 24, 0.4, 3
HLS_DELTAS = (6, 12)
HLS_MASTER = 4
#: processes encoding the sources and running the host scalar oracle
HLS_PREP_WORKERS = 6


def phase_hls(rng, hls_device: str | None = None) -> dict:
    """HLS with the requant ladder through the CLI server on the card
    (``utils.hls_loopback.serve_hls``; with ``hls_device="cpu"`` the
    ladders run B6 as the plain torch chains on the CPU): every segment
    sample held to the pushed pictures or to the host scalar oracle, 0
    device errors, 0 passed-through slices, 0 shed AUs with more AUs a
    path than the shed gate, a 304, 16 paths listed, and the server's B6
    launches equal to its ladders' dispatches."""
    from easydarwin_tpu_torch.utils import hls_loopback as hl
    sources = hl.config5_sources(HLS_SOURCES)
    where = "the card" if hls_device is None else hls_device
    log(f"[hls] {HLS_WIDTH}x{HLS_HEIGHT} pictures "
        f"({(HLS_WIDTH // 16) * (HLS_HEIGHT // 16)} macroblocks; the "
        f"CPython walk's cut, kept to compare, phase 13c runs config 5's "
        f"8,160); the "
        f"native walk parses and writes; {HLS_FRAMES} pictures a "
        f"source at {HLS_FPS} a second ({HLS_SOURCES * HLS_FPS:g} AUs a "
        f"second offered), GOPs of {HLS_GOP}; B6 on {where}")
    load0, cpu0, t0 = os.getloadavg(), time.process_time(), time.monotonic()
    res = asyncio.run(asyncio.wait_for(hl.serve_hls(
        DEVICE, rng, sources=sources, width=HLS_WIDTH, height=HLS_HEIGHT,
        frames=HLS_FRAMES, fps=HLS_FPS, gop=HLS_GOP, deltas=HLS_DELTAS,
        master=HLS_MASTER, seed=int(rng.integers(1 << 31)),
        workers=HLS_PREP_WORKERS, hls_device=hls_device), 600))
    res["host"] = {"loadavg_before": load0, "loadavg_after": os.getloadavg(),
                   "cpus": len(os.sched_getaffinity(0)),
                   "smoke_cpu_s": time.process_time() - cpu0,
                   "smoke_wall_s": time.monotonic() - t0}
    st = res["server_stats"]
    hls = st["hls"]
    check(len(res["streams"]) == HLS_SOURCES,
          f"gethlsstreams lists {len(res['streams'])} paths")
    passed = sum(r.get("passed_through_slices", 0)
                 for s in res["streams"] for r in s["renditions"])
    check(passed == 0, f"{passed} slices passed through")
    gate = max(4, 2 * hls["pool_workers"])
    check(HLS_FRAMES > gate, f"{HLS_FRAMES} AUs a path cannot reach the "
          f"shed gate of {gate} pending")
    check(hls["shed"] == 0, f"{hls['shed']} AUs shed")
    stages = hls["stage_ms_per_au"]
    n_cabac = sum(s.entropy == "cabac" for s in sources)
    log(f"[hls] {HLS_SOURCES} sources ({n_cabac} "
        f"CABAC, {sum(s.slices > 1 for s in sources)} of 3 slices, "
        f"{sum(s.audio for s in sources)} with AAC) pushed over interleaved "
        f"TCP in {res['push_s']:.3f} s, the ladders drained "
        f"{res['drain_s']:.3f} s after; {res['segments']} segments "
        f"({res['av_segments']} A/V), {res['samples']} video samples each "
        f"equal to the push or the scalar oracle, "
        f"{res['audio_samples']} AAC samples; bytes by rendition "
        f"{res['bytes']}, of them video samples {res['video_bytes']}; 304 "
        f"on {res['revalidated']}")
    log(f"[hls] ladders (B6 on {hls['device']}): {hls['aus']} AUs, "
        f"{hls['dispatches']} dispatches "
        f"({hls['dispatches_chroma']} with chroma), device errors "
        f"{hls['device_errors']}, shed {hls['shed']} (gate {gate} pending "
        f"with {hls['pool_workers']} workers; at most "
        f"{hls['pending_max']} pending), mismatches "
        f"{hls['mismatches']}; an AU's latency (depacketized to emitted) "
        f"{hls['latency_ms_per_au']:.3f} ms mean, "
        f"{hls['latency_s_max'] * 1e3:.3f} max; host ms an AU by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + "; the dispatch leg's host ms a dispatch: submit (gather, "
        f"staging, enqueue) {hls['transform_ms_per_dispatch']['submit']:.3f},"
        f" wait (the readbacks' events) "
        f"{hls['transform_ms_per_dispatch']['wait']:.3f}")
    log(f"[hls] launches: ed_h264_requant "
        f"{st['kernel_launches']['ed_h264_requant']}, "
        f"ed_h264_requant_chroma "
        f"{st['kernel_launches']['ed_h264_requant_chroma']} (= the "
        f"dispatches on the card, 0 on the CPU); the pump's wake ms p50 "
        f"{st['wake_ms_p50']:.3f} max "
        f"{st['wake_ms_max']:.3f} while the ladders ran; sources prepared "
        f"in {res['prepare_s']:.3f} s")
    host = res["host"]
    log(f"[hls] host: the server used {st['cpu_s']:.3f} CPU s in "
        f"{st['wall_s']:.3f} s; this process {host['smoke_cpu_s']:.3f} CPU "
        f"s in {host['smoke_wall_s']:.3f} s (the sources' encoding and the "
        f"oracle run in {HLS_PREP_WORKERS} other processes); load average "
        f"{host['loadavg_before']} before, {host['loadavg_after']} after, "
        f"{host['cpus']} CPUs")
    return res


# ----------------------------------------------------- phases 13b and 13c
#: config 5's pictures: 1920x1088 (8,160 macroblocks), phase 13's sources,
#: rungs, rate and GOPs for HLS_1080_SECONDS; HLS_1080_DISTINCT pictures
#: of each kind (entropy mode x slice count) encoded once by the CPython
#: ``encode_iframe`` on HLS_1080_WORKERS processes and cycled
HLS_1080_WIDTH, HLS_1080_HEIGHT = 1920, 1088
HLS_1080_SECONDS = 30
HLS_1080_DISTINCT = 2
HLS_1080_WORKERS = 8
#: phase 13's figures at 176x144 on the CPython walk (an NVIDIA H100
#: 80GB HBM3 at 700 W, the last run before the native walk)
HLS_CPYTHON_WALK = {"shed": 0, "latency_s_mean": 0.97, "wake_ms_p50": 87.8,
            "transform_device_ms_per_au": 37.1}
#: phase 13b: one-thread repeats of each AU, and the pool's AU jobs a
#: distinct AU
WALK_REPS = 3
WALK_POOL_ROUNDS = 4


def prepare_1080(rng) -> tuple[list, list[dict], float]:
    """Phase 13c's sources and their pictures and fused-walk oracle
    (``hls_loopback.prepare_shared``), and the seconds it took."""
    from easydarwin_tpu_torch.utils import hls_loopback as hl
    sources = hl.config5_sources(HLS_SOURCES)
    t0 = time.monotonic()
    prepared = hl.prepare_shared(
        sources, int(rng.integers(1 << 31)), width=HLS_1080_WIDTH,
        height=HLS_1080_HEIGHT, gop=HLS_GOP, distinct=HLS_1080_DISTINCT,
        deltas=HLS_DELTAS, workers=HLS_1080_WORKERS)
    seconds = time.monotonic() - t0
    kinds = len({(s.entropy, s.slices) for s in sources})
    sizes = sorted({len(b"".join(p)) for pre in prepared
                    for p in pre["pictures"]})
    log(f"[hls 1080p] {kinds * HLS_1080_DISTINCT} pictures of "
        f"{HLS_1080_WIDTH}x{HLS_1080_HEIGHT} ({kinds} kinds x "
        f"{HLS_1080_DISTINCT}) encoded by the CPython encode_iframe on "
        f"{HLS_1080_WORKERS} processes in {seconds:.3f} s, with the fused "
        f"walk's oracle; AU bytes {sizes[0]} to {sizes[-1]}")
    return sources, prepared, seconds


def walk_aus(sources, prepared) -> list[dict]:
    """Phase 13c's distinct AUs: each kind's GOP pictures with its
    parameter sets and the fused walk's bytes for every rung."""
    from easydarwin_tpu_torch.codecs.h264_intra import Pps, Sps
    aus, seen = [], set()
    for src, pre in zip(sources, prepared):
        kind = (src.entropy, src.slices)
        if kind in seen:
            continue
        seen.add(kind)
        sps, pps = Sps.parse(pre["sps"]), Pps.parse(pre["pps"])
        for k, nals in enumerate(pre["pictures"]):
            aus.append({"kind": f"{src.entropy}/{src.slices}", "k": k,
                        "sps": sps, "pps": pps, "nals": nals,
                        "want": {d: pre["oracle"][d][k]
                                 for d in HLS_DELTAS}})
    return aus


def fused_au(au: dict) -> tuple[dict, float]:
    """(a): the fused walk once per rung on every slice of ``au``."""
    from easydarwin_tpu_torch import native
    from easydarwin_tpu_torch.codecs import h264_requant as rq
    args = rq._walk_args(au["sps"], au["pps"])
    t0 = time.perf_counter()
    outs = {d: [native.h264_requant_slice(n, delta_qp=d, **args)[0]
                for n in au["nals"]] for d in HLS_DELTAS}
    return outs, (time.perf_counter() - t0) * 1e3


def split_au(au: dict, device) -> tuple[dict, dict]:
    """(b): one C parse a slice, B6's leg for every slice and rung (one
    ``ed_h264_requant`` launch, one ``ed_h264_requant_chroma``), then one
    C write a slice a rung; host ms by step."""
    from easydarwin_tpu_torch.codecs import h264_requant as rq
    sps, pps = au["sps"], au["pps"]
    t0 = time.perf_counter()
    parsed = [rq.parse_slice_nal(n, sps, pps) for n in au["nals"]]
    gathers = [rq.gather_slice(p) for p in parsed]
    t1 = time.perf_counter()
    dispatch = rq.FusedRequantDispatch(
        gathers, HLS_DELTAS, chroma_qp_offset=pps.chroma_qp_offset,
        device=device)
    dispatch._harvested()
    t2 = time.perf_counter()
    outs = {d: [rq.recode_parsed(p, g, dispatch, s, i)[0]
                for s, (p, g) in enumerate(zip(parsed, gathers))]
            for i, d in enumerate(HLS_DELTAS)}
    t3 = time.perf_counter()
    check(all(isinstance(p, rq.WalkedSlice) for p in parsed),
          f"{au['kind']}: a slice left the native walk")
    return outs, {"parse": (t1 - t0) * 1e3, "b6_leg": (t2 - t1) * 1e3,
                  "write": (t3 - t2) * 1e3, "total": (t3 - t0) * 1e3}


def phase_walk_decision(sources, prepared, device: str | None = None
                        ) -> dict:
    """Phase 13b: on phase 13c's distinct 1080p AUs, the host ms an AU of
    (a) the fused walk once per rung and (b) the split walk around B6's
    leg on ``device``, on one thread and then on a pool of the requant
    pool's size; (b)'s bytes equal (a)'s and the oracle's."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from easydarwin_tpu_torch.hls.requant import pool_workers
    device = device or DEVICE
    dev = torch.device(device)
    aus = walk_aus(sources, prepared)
    one = {"fused": [], "split": [], "steps": []}
    for au in aus:
        fa, fb, steps = [], [], []
        for _ in range(WALK_REPS):
            outs_a, ms_a = fused_au(au)
            outs_b, st_b = split_au(au, dev)
            check(outs_a == au["want"] and outs_b == outs_a,
                  f"{au['kind']} picture {au['k']}: the split's bytes "
                  f"differ from the fused walk's")
            fa.append(ms_a)
            fb.append(st_b["total"])
            steps.append(st_b)
        one["fused"].append(float(np.median(fa)))
        one["split"].append(float(np.median(fb)))
        one["steps"].append({k: float(np.median([s[k] for s in steps]))
                             for k in steps[0]})
    workers = pool_workers()
    jobs = aus * WALK_POOL_ROUNDS
    pool = {}
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for name, fn in (("fused", fused_au),
                         ("split", lambda a: split_au(a, dev))):
            t0 = time.perf_counter()
            res = list(ex.map(fn, jobs))
            wall = time.perf_counter() - t0
            for au, (outs, _ms) in zip(jobs, res):
                check(outs == au["want"], f"{au['kind']} picture {au['k']}"
                      f": {name} under the pool differs from the oracle")
            per = [ms if name == "fused" else ms["total"] for _o, ms in res]
            pool[name] = {"aus_per_s": len(jobs) / wall,
                          "ms_per_au_mean": float(np.mean(per)),
                          "wall_s": wall}
    steps = {k: float(np.mean([s[k] for s in one["steps"]]))
             for k in one["steps"][0]}
    by_kind = {}
    for au, a, b in zip(aus, one["fused"], one["split"]):
        by_kind.setdefault(au["kind"], []).append((a, b))
    res = {"aus": len(aus), "reps": WALK_REPS, "rungs": list(HLS_DELTAS),
           "one_thread": {"fused_ms_per_au": float(np.mean(one["fused"])),
                          "split_ms_per_au": float(np.mean(one["split"])),
                          "split_steps_ms_per_au": steps,
                          "by_kind": {k: {"fused": float(np.mean(
                              [a for a, _ in v])), "split": float(np.mean(
                                  [b for _, b in v]))}
                              for k, v in by_kind.items()}},
           "pool": {"workers": workers, "jobs": len(jobs), **pool}}
    o = res["one_thread"]
    log(f"[walk] 13b: {len(aus)} distinct {HLS_1080_WIDTH}x"
        f"{HLS_1080_HEIGHT} AUs, rungs {list(HLS_DELTAS)}, B6 on "
        f"{device}: one thread (median of {WALK_REPS}) (a) fused walk "
        f"{o['fused_ms_per_au']:.3f} ms an AU, (b) split "
        f"{o['split_ms_per_au']:.3f} ms (parse {steps['parse']:.3f}, B6 "
        f"leg {steps['b6_leg']:.3f}, writes {steps['write']:.3f}); by kind "
        + ", ".join(f"{k} (a) {v['fused']:.3f} (b) {v['split']:.3f}"
                    for k, v in o["by_kind"].items())
        + f"; (b) - (a) = {o['split_ms_per_au'] - o['fused_ms_per_au']:.3f}"
        f" ms; bytes equal")
    log(f"[walk] 13b under a pool of {workers} threads, {len(jobs)} AU "
        f"jobs an engine: (a) {pool['fused']['aus_per_s']:.3f} AUs/s, "
        f"{pool['fused']['ms_per_au_mean']:.3f} ms an AU; (b) "
        f"{pool['split']['aus_per_s']:.3f} AUs/s, "
        f"{pool['split']['ms_per_au_mean']:.3f} ms an AU; bytes equal")
    return res


def phase_hls_1080(rng, sources, prepared,
                   hls_device: str | None = None) -> dict:
    """Phase 13c: phase 13's server and sources at config 5's pictures
    for HLS_1080_SECONDS: every sample held to the push or to the fused
    walk's bytes, 0 device errors, 0 mismatches, 0 passed-through slices,
    every requantized slice written by the native walk and the server's
    B6 launches equal to its ladders' dispatches; shed AUs are reported,
    not refused."""
    from easydarwin_tpu_torch.utils import hls_loopback as hl
    frames = int(HLS_1080_SECONDS * HLS_FPS)
    where = "the card" if hls_device is None else hls_device
    t0 = time.monotonic()
    res = asyncio.run(asyncio.wait_for(hl.serve_hls(
        DEVICE, rng, sources=sources, width=HLS_1080_WIDTH,
        height=HLS_1080_HEIGHT, frames=frames, fps=HLS_FPS, gop=HLS_GOP,
        deltas=HLS_DELTAS, master=HLS_MASTER, seed=0,
        hls_device=hls_device, prepared=prepared, allow_shed=True,
        deadline_s=240.0), 600))
    res["wall_s"] = time.monotonic() - t0
    st = res["server_stats"]
    hls = st["hls"]
    passed = sum(r.get("passed_through_slices", 0)
                 for s in res["streams"] for r in s["renditions"])
    check(passed == 0, f"{passed} slices passed through")
    stages = hls["stage_ms_per_au"]
    log(f"[hls 1080p] {HLS_SOURCES} sources at {HLS_1080_WIDTH}x"
        f"{HLS_1080_HEIGHT}, {frames} pictures a source at {HLS_FPS} a "
        f"second, B6 on {where}: pushed in {res['push_s']:.3f} s, drained "
        f"{res['drain_s']:.3f} s after; {res['segments']} segments, "
        f"{res['samples']} video samples each equal to the push or the "
        f"fused walk (video sample bytes by rendition "
        f"{res['video_bytes']}); {hls['aus']} AUs, {hls['dispatches']} "
        f"dispatches "
        f"({hls['dispatches_chroma']} with chroma), device errors "
        f"{hls['device_errors']}, mismatches {hls['mismatches']}, passed "
        f"through 0; shed {hls['shed']} (at most {hls['pending_max']} "
        f"pending, gate {max(4, 2 * hls['pool_workers'])}); an AU's "
        f"latency {hls['latency_ms_per_au']:.3f} ms mean, "
        f"{hls['latency_s_max'] * 1e3:.3f} max; host ms an AU by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; the pump's wake ms p50 {st['wake_ms_p50']:.3f} max "
        f"{st['wake_ms_max']:.3f}; launches ed_h264_requant "
        f"{st['kernel_launches']['ed_h264_requant']}, "
        f"ed_h264_requant_chroma "
        f"{st['kernel_launches']['ed_h264_requant_chroma']}")
    w = HLS_CPYTHON_WALK
    log(f"[hls 1080p] beside phase 13 on the CPython walk (176x144): "
        f"shed {w['shed']}, latency {w['latency_s_mean']} s mean, wake p50 "
        f"{w['wake_ms_p50']} ms, transform_device "
        f"{w['transform_device_ms_per_au']} ms an AU")
    return res


def hls_control() -> int:
    """``--hls-control``: the build, the card, phase 5c's leg check, then
    phase 13 and phase 13c each twice in one process, with the ladders'
    B6 on the card and then on the CPU's plain torch chains
    (``--hls-device cpu``), each checked in full; one JSON line of the
    runs' drain, latency, stage and wake figures before the last line."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    rng = np.random.default_rng(20261017)
    b = kernel_lib.build()
    kernel_lib.library()
    log(f"[build] {b.path.name} built in {b.seconds:.3f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[card] {smi}")
    b6_leg_check(rng, h264_inputs(rng))
    sources, prepared, _enc_s = prepare_1080(rng)
    runs = {}
    for name, where, phase in (
            ("card", None, lambda w: phase_hls(rng, w)),
            ("cpu", "cpu", lambda w: phase_hls(rng, w)),
            ("card_1080p", None,
             lambda w: phase_hls_1080(rng, sources, prepared, w)),
            ("cpu_1080p", "cpu",
             lambda w: phase_hls_1080(rng, sources, prepared, w))):
        res = phase(where)
        st = res["server_stats"]
        hls = st["hls"]
        runs[name] = {
            "push_s": res["push_s"], "drain_s": res["drain_s"],
            "aus": hls["aus"], "shed": hls["shed"],
            "pending_max": hls["pending_max"],
            "latency_ms_mean": hls["latency_ms_per_au"],
            "latency_ms_max": hls["latency_s_max"] * 1e3,
            "stage_ms_per_au": hls["stage_ms_per_au"],
            "transform_ms_per_dispatch": hls["transform_ms_per_dispatch"],
            "wake_ms_p50": st["wake_ms_p50"], "wake_ms_max": st["wake_ms_max"],
            "server_cpu_s": st["cpu_s"], "server_wall_s": st["wall_s"],
            "host": res.get("host"),
            "launches": {k: st["kernel_launches"][k] for k in HLS_KERNELS}}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "hls_control.json"), "w") as f:
        json.dump(runs, f, indent=1)
    print(json.dumps({"hls_control": runs}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------- phase 6c
#: the mesh of phase 6c: two shards on the one card, passed in explicitly
#: (the server's ``make_megabatch_mesh`` keeps None on one card)
MESH_LAYOUTS = ({"src": 2}, {"src": 1, "sub": 2}, {"src": 1, "win": 2})
MESH_WAKES = 12


def b8_batch(n_src: int, n_sub: int, n_pkt: int, seed: int,
             width: int = 96):
    """``parallel.mesh.example_batch`` with a seeded share of its rows cut
    to 0 and to 1-11 bytes (the reference's mask counts the short ones)
    and seeded ages across the delay buckets."""
    import numpy as np
    from easydarwin_tpu_torch.parallel import mesh
    batch = list(mesh.example_batch(n_src=n_src, n_sub=n_sub, n_pkt=n_pkt,
                                    width=width, seed=seed))
    rng = np.random.default_rng(seed)
    length = batch[1]
    cut = rng.random(length.shape)
    length[cut < 0.1] = rng.integers(1, 12, length.shape)[cut < 0.1]
    length[cut > 0.95] = 0
    batch[2] = rng.integers(0, 400, length.shape).astype(np.int32)
    return batch


def b8_outputs(n: int, s: int, p: int, device="cuda"):
    """Empty headers, mask, newest keyframes and total of one B8 call."""
    import torch
    return (torch.empty((n, s, p, 12), dtype=torch.uint8, device=device),
            torch.empty((n, s, p), dtype=torch.bool, device=device),
            torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.int64, device=device))


_B8_PROBE = None


def b8_probe():
    """``tools/b8_shard_probe.py`` as a module: its ``layout_shards``
    lays out phase 10's B8 case."""
    global _B8_PROBE
    if _B8_PROBE is None:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "b8_shard_probe", os.path.join(HERE, "tools", "b8_shard_probe.py"))
        _B8_PROBE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_B8_PROBE)
    return _B8_PROBE


def b8_diff(got, want, what: str) -> int:
    """Max |difference| of B8's four outputs; any is a failure."""
    err = 0
    for name, a, b in zip(("headers", "mask", "newest_keyframe",
                           "total_eligible"), got, want):
        a = a.cpu().numpy().astype("int64")
        b = b.cpu().numpy().astype("int64")
        check(a.shape == b.shape, f"{what}: {name} {a.shape} vs {b.shape}")
        d = int(abs(a - b).max()) if a.size else 0
        check(d == 0, f"{what}: {name} differs from the plain version "
              f"(max {d})")
        err = max(err, d)
    return err


def config4_feeds(rng, n_streams: int, bursts, wakes: int):
    from easydarwin_tpu_torch.utils import synth
    feeds = []
    for i in range(n_streams):
        pkts = []
        while len(pkts) < bursts[i] * wakes:
            pkts += synth.paced_gop(rng, seq0=0xFFF0 + len(pkts) + 97 * i,
                                    ts0=0xFFFF0000 + 3000 * len(pkts),
                                    ssrc=0x1000 + i, frames=10,
                                    packets_per_frame=4)
        feeds.append(pkts)
    return feeds


def config4_run(feeds, bursts, params, sched, wakes: int) -> list:
    """Phase 6's config-4 traffic (16 × 256 collecting outputs, 4 leave
    and 4 join stream 3 at wake 6) through ``sched`` and one engine a
    stream; returns each wake's packets by stream and output."""
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
    from easydarwin_tpu_torch.utils.loopback import VIDEO_SDP

    info = sdp.parse(VIDEO_SDP).streams[0]
    n_subs = len(params[0]) - 4

    def make(i, j):
        ssrc, seq0, ts0 = params[i][j]
        return CollectingOutput(ssrc=ssrc, out_seq_start=seq0,
                                out_ts_start=ts0)

    streams = [RelayStream(info, StreamSettings(bucket_delay_ms=10))
               for _ in feeds]
    for i, s in enumerate(streams):
        for j in range(n_subs):
            s.add_output(make(i, j))
    engines = [FanoutEngine(device=DEVICE) for _ in streams]
    out, t = [], 1000
    for w in range(wakes):
        for i, s in enumerate(streams):
            for pkt in feeds[i][w * bursts[i]:(w + 1) * bursts[i]]:
                s.push_rtp(pkt, t)
        if w == 6:
            for k in range(4):
                streams[3].remove_output(streams[3].outputs[k])
                streams[3].add_output(make(3, n_subs + k))
        pairs = list(zip(streams, engines))
        sched.begin_wake(pairs, t)
        for s, e in pairs:
            e.step(s, t)
        sched.end_wake(pairs, t)
        wake = []
        for s in streams:
            wake.append([list(o.rtp_packets) for o in s.outputs])
            for o in s.outputs:
                o.rtp_packets.clear()
        out.append(wake)
        t += 20
    sched.drain()
    check(all(e.missing_params == 0 for e in engines),
          "an engine found no installed params")
    return out


def phase_mesh(rng) -> dict:
    """B8 on a mesh of two shards on the one card: ``sharded_relay_step``
    at ``example_batch(4, 8, 32)`` and config 4's 16 × 256 × 256 (rows of
    1-11 bytes and of 0 among them) in the layouts (2,1,1), (1,2,1) and
    (1,1,2), bit-exact with the same step's plain version on a CPU mesh;
    then, with the launch counts at 0, the scheduler's mesh path on config
    4's traffic, wire bytes equal to the one-device scheduler's run before
    it (the mesh path: ``path_launches``); then, with the counts at 0
    again, B8 once at each shape through its entry point (B8's own path:
    no serving code calls it, ``b8_launches``)."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.parallel import mesh
    from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler

    card = torch.device(DEVICE)
    check(torch.cuda.device_count() != 1 or mesh.make_megabatch_mesh() is None,
          "make_megabatch_mesh built a mesh on one card")
    shapes = {"example (4, 8, 32)": (4, 8, 32),
              "config 4 (16, 256, 256)": (16, 256, 256)}
    batches = {k: b8_batch(*v, seed=i + 5)
               for i, (k, v) in enumerate(shapes.items())}
    # off the kernel's 64-row tile and 4-output columns, on 100-byte rows
    checked = {**batches, "ragged (4, 18, 130) w100":
               b8_batch(4, 18, 130, seed=7, width=100)}
    err = 0
    for axes in MESH_LAYOUTS:
        on_card = mesh.make_relay_mesh([card, card], **axes)
        on_cpu = mesh.make_relay_mesh(["cpu", "cpu"], **axes)
        for name, batch in checked.items():
            want = mesh.sharded_relay_step_plain(on_cpu)(*batch)
            got = mesh.sharded_relay_step(on_card)(*batch)
            err = max(err, b8_diff(got, want, f"B8 {axes} at {name}"))
            # the inputs on the card: each shard reads its strided block
            got = mesh.sharded_relay_step(on_card)(
                *(torch.from_numpy(a).to(card) for a in batch))
            err = max(err, b8_diff(got, want, f"B8 {axes} at {name}, "
                                   f"inputs on the card"))
    log(f"[mesh] sharded_relay_step on [{card}, {card}] in the layouts "
        f"{MESH_LAYOUTS} at {list(checked)}, inputs from the host and on "
        f"the card: bit-exact with its plain version on a CPU mesh (short "
        f"rows in the mask)")
    n_streams, n_subs = 16, 256
    bursts = [6 if i < n_streams // 2 else 20 for i in range(n_streams)]
    sub_rng = np.random.default_rng(int(rng.integers(1 << 31)))
    params = [[(int(sub_rng.integers(1 << 32)), int(sub_rng.integers(1 << 16)),
                int(sub_rng.integers(1 << 32))) for _ in range(n_subs + 4)]
              for _ in range(n_streams)]
    feeds = config4_feeds(rng, n_streams, bursts, MESH_WAKES)
    one = config4_run(feeds, bursts, params,
                      MegabatchScheduler(device=DEVICE), MESH_WAKES)

    kernel_lib.reset_launch_counts()           # the mesh path starts here
    sched = MegabatchScheduler(device=DEVICE,
                               mesh=mesh.make_megabatch_mesh(0, [card, card]))
    sharded = config4_run(feeds, bursts, params, sched, MESH_WAKES)
    path = dict(kernel_lib.LAUNCHES)
    st = sched.stats()
    delivered = 0
    for w, (a, b) in enumerate(zip(sharded, one)):
        check(a == b, f"wake {w}: the mesh path's wire bytes differ from "
              f"the one-device scheduler's")
        delivered += sum(len(p) for s in a for p in s)
    check(delivered > 0, "the mesh path delivered nothing")
    check(st["sharded_passes"] > 0 and st["mismatches"] == 0
          and st["mesh_dispatch_errors"] == 0, f"mesh scheduler: {st}")
    check(path["ed_relay_window"] == st["window_calls"] > 0,
          f"ed_relay_window launched {path['ed_relay_window']} times for "
          f"{st['window_calls']} window calls")
    log(f"[mesh] config 4 through the scheduler's mesh path ({MESH_WAKES} "
        f"wakes, 4 leave and 4 join at wake 6): {delivered} packets, every "
        f"one equal to the one-device scheduler's; sharded passes "
        f"{st['sharded_passes']}, window calls {st['window_calls']} (one a "
        f"shard a wake), prime passes {st['prime_passes']}, mismatches 0; "
        f"path launches {path}")

    kernel_lib.reset_launch_counts()           # B8's own path starts here
    b8 = mesh.sharded_relay_step(mesh.make_relay_mesh([card, card], src=2))
    for batch in batches.values():
        b8(*batch)
    if card.type == "cuda":
        torch.cuda.synchronize()
    b8_path = dict(kernel_lib.LAUNCHES)
    check(b8_path["ed_relay_shard"] == len(batches)
          and sum(b8_path.values()) == b8_path["ed_relay_shard"],
          f"B8's two calls over two shards of one card made launches "
          f"{b8_path}, not one ed_relay_shard a device a call")
    log(f"[mesh] B8 (sharded_relay_step; no serving code calls it) once at "
        f"each shape over two shards of one card: launches {b8_path} (one "
        f"ed_relay_shard a device a call)")
    return {"max_abs_err": err, "scheduler": st, "delivered": delivered,
            "path_launches": path, "b8_launches": b8_path}


def b8_bound(n: int, s: int, p: int) -> tuple[int, int]:
    """(bytes, operations) of one B8 call over [n, p] rows and [n, s]
    outputs: rows, lengths, ages, state and buckets read once; headers,
    mask, the newest keyframes and the sum written once; B9's operations
    a source."""
    nbytes = (96 * n * p + 8 * n * p + 28 * n * s + 13 * n * s * p + 4 * n
              + 8)
    return nbytes, n * (OPS_PER_PACKET * p + OPS_PER_BATCH_HEADER * s * p)


# ------------------------------------------------------------- phase 7f
WHEEL_TICK_MS, WHEEL_DELAY_MS, WHEEL_BUCKET = 200, 30, 6
WHEEL_PLAYERS, WHEEL_FRAMES, WHEEL_FRAME_S = 16, 30, 0.1


def phase_wheel(rng) -> dict:
    """The pump's timer wheel on the card: an in-process server with a
    200 ms reflect interval and a 30 ms bucket delay serves one H.264
    source (4 packets a frame, a frame each 100 ms) to 16 UDP players, 6
    a bucket; each bucket's release delay (arrival at the player minus
    the push) and the pump's wakes by cause."""
    return asyncio.run(asyncio.wait_for(_wheel_run(rng), 120))


async def _wheel_run(rng) -> dict:
    import numpy as np
    from easydarwin_tpu_torch.relay.stream import StreamSettings
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    from easydarwin_tpu_torch.utils import loopback, synth

    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        reflect_interval_ms=WHEEL_TICK_MS,
        stream=StreamSettings(bucket_size=WHEEL_BUCKET,
                              bucket_delay_ms=WHEEL_DELAY_MS)),
        device=DEVICE)
    await app.start()
    clients = []
    pushed: dict[bytes, float] = {}
    seq = int(rng.integers(1 << 16))

    def frame(k: int, key: bool) -> list[bytes]:
        nonlocal seq
        pkts = []
        for i in range(4):
            body = seq.to_bytes(4, "big") + bytes(int(rng.integers(200, 900)))
            pkts.append(synth.h264_packet(seq, 3000 * k, 5 if key and i == 0
                                          else 1, ssrc=0x7F00, body=body))
            seq += 1
        return pkts

    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/wheel"
        pusher = loopback.MiniClient()
        clients.append(pusher)
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        await pusher.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
        await pusher.request("RECORD", uri)
        for p in frame(0, True):
            pusher.push(p)
        players = []
        for _ in range(WHEEL_PLAYERS):
            pl = loopback.MiniClient()
            clients.append(pl)
            await pl.connect(app.rtsp.port)
            ports = await pl.udp_ports(stamp=True)
            await pl.request("DESCRIBE", uri)
            await pl.request("SETUP", uri + "/trackID=1", {
                "transport": f"RTP/AVP;unicast;client_port={ports}"})
            await pl.request("PLAY", uri)
            players.append(pl)
        await asyncio.sleep(0.5)
        before = app.stats()["pump"]
        for k in range(1, WHEEL_FRAMES + 1):
            t = time.monotonic()
            for p in frame(k, k % 10 == 0):
                pusher.push(p)
                pushed[p[12:]] = t
            await asyncio.sleep(WHEEL_FRAME_S)
        await asyncio.sleep(0.4)
        after = app.stats()
        check(after["resilience"]["device_errors"] == 0,
              f"7f device errors: {after['resilience']}")
    finally:
        for c in clients:
            await c.close()
        await app.stop()
    lags: dict[int, list] = {}
    worst: dict[int, tuple] = {}
    for i, pl in enumerate(players):
        got = [((t_rx - pushed[d[12:]]) * 1e3, pushed[d[12:]])
               for t_rx, d in pl.frames if d[12:] in pushed]
        check(len(got) == len(pushed), f"player {i} received {len(got)} of "
              f"{len(pushed)} measured packets")
        b = i // WHEEL_BUCKET
        lags.setdefault(b, []).extend(lag for lag, _t in got)
        worst[b] = max([*got, worst.get(b, (-1.0, 0.0))])
    pump = {k: after["pump"][k] - before[k]
            for k in ("time_wakes", "wheel_wakes", "event_wakes")}
    res = {"buckets": {}, "pump": pump, "wake_ms_p50": after["wake_ms_p50"],
           "server_stats": after}
    for b, v in sorted(lags.items()):
        v = np.sort(np.asarray(v))
        # the slowest release's push, on the monotonic clock
        res["buckets"][b] = {"p50_ms": float(v[len(v) // 2]),
                             "max_ms": float(v[-1]),
                             "min_ms": float(v[0]), "packets": len(v),
                             "max_pushed_at": worst[b][1]}
        log(f"[wheel] bucket {b} (delay {b * WHEEL_DELAY_MS} ms): release "
            f"delay p50 {v[len(v) // 2]:.3f} ms, min {v[0]:.3f}, max "
            f"{v[-1]:.3f} over {len(v)} datagrams")
        if b:
            check(v[len(v) // 2] <= b * WHEEL_DELAY_MS + 15
                  and v[-1] < b * WHEEL_DELAY_MS + 60,
                  f"bucket {b}'s releases are not within their delay plus "
                  f"a few ms: p50 {v[len(v) // 2]:.3f} max {v[-1]:.3f}")
    check(pump["wheel_wakes"] >= WHEEL_FRAMES,
          f"the wheel woke the pump {pump['wheel_wakes']} times for "
          f"{WHEEL_FRAMES} frames")
    log(f"[wheel] pump wakes over {WHEEL_FRAMES} frames at "
        f"{1 / WHEEL_FRAME_S:.0f} a second (tick {WHEEL_TICK_MS} ms): "
        f"{pump['event_wakes']} by ingest, {pump['time_wakes']} timed out "
        f"({pump['wheel_wakes']} of them on a wheel deadline); wake host "
        f"ms p50 {after['wake_ms_p50']:.3f}; {schedule_line(after)}; "
        f"launches {after['kernel_launches']}")
    return res


# ------------------------------------------------------------- phase 7g
def phase_udp_pairs(rng, shared: dict) -> dict:
    """BASELINE config 2 with ``shared_udp_egress=False`` on an in-process
    server (the CLI has no flag for it): one 1080p30 source, 64 UDP
    players joining one a frame, each on a port pair of its own, 3 s;
    every datagram held to the oracle; the engine's loop rung's host µs a
    datagram beside phase 7b's shared pair (µs a datagram inside
    ``sendmmsg``, from the same run)."""
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    from easydarwin_tpu_torch.utils import loopback

    async def run():
        app = StreamingServer(ServerConfig(
            rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
            shared_udp_egress=False), device=DEVICE)
        await app.start()
        try:
            check(app.rtsp.shared_egress is None,
                  "the server made a shared egress pair")
            res = await loopback.push_play(
                app.rtsp.port, rng, n_push=1, n_play=CONFIG2_SUBS,
                transport="udp", gops=3, frames=30, packets_per_frame=13,
                body_len=(1270, 1300), frame_interval_s=1 / 30, join_every=1,
                deadline_s=30)
            res["server_stats"] = app.stats()
            return res
        finally:
            await app.stop()

    res = asyncio.run(asyncio.wait_for(run(), 240))
    st = res["server_stats"]
    check(st["pump_errors"] == 0 and st["send_errors"] == 0
          and st["missing_params"] == 0
          and st["resilience"]["device_errors"] == 0, f"7g server: {st}")
    check(st["native_sent"] == 0 and st["loop_sent"] == st["packets_out"]
          == res["delivered"], f"7g: {st['loop_sent']} sent by the loop, "
          f"{st['native_sent']} by the scatter, {res['delivered']} delivered")
    eg = shared["egress"]
    shared_us = eg["send_ns"] / max(eg["send_packets"], 1) / 1e3
    res["loop_us_per_datagram"] = st["loop_us_per_packet"]
    res["shared_sendmmsg_us_per_datagram"] = shared_us
    log(f"[pairs] 1 source x {res['players']} UDP players on pairs of "
        f"their own, {res['delivered']} datagrams, every one checked; the "
        f"loop rung {st['loop_us_per_packet']:.3f} host µs a datagram "
        f"(header render + send through the pair's socket) against the "
        f"shared pair's {shared_us:.3f} µs a datagram inside sendmmsg "
        f"(phase 7b, {eg['send_packets']} datagrams); wake host ms p50 "
        f"{st['wake_ms_p50']:.3f} (7b {shared['wake_ms_p50']:.3f}); "
        f"{schedule_line(st)}; launches {st['kernel_launches']}")
    return res


# ------------------------------------------------------------- phase 13d
CLOSED_LOOP_FIXTURES = ("tests/fixtures/ippp_176x144_cavlc.264",
                        "tests/fixtures/ippp_176x144_cabac.264")


def split_annexb(data: bytes) -> list[bytes]:
    """An Annex-B stream's NAL payloads (start codes stripped)."""
    nals, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        j = data.find(b"\x00\x00\x01", i + 3)
        end = j if j >= 0 else len(data)
        while end > i + 3 and data[end - 1] == 0:
            end -= 1
        nals.append(data[i + 3:end])
        i = j
    return [n for n in nals if n]


def phase_closed_loop() -> dict:
    """``SliceRequantizer(6, closed_loop=True)`` on the card over the
    committed x264 IPPP fixtures (176x144, 1 IDR and 7 P pictures, CAVLC
    and CABAC): every NAL byte-equal to the run with ``device="cpu"``;
    the P slices' B6 launches one ``ed_h264_requant`` a P slice with
    residual rows and one ``ed_h264_requant_chroma`` a P slice with
    chroma residual (the I slice runs the host loop); host ms an AU of
    the I and the P pictures; the I picture's PSNR against the source
    (the port's intra decoder), closed loop against open loop."""
    import numpy as np
    from easydarwin_tpu_torch.codecs import h264_requant as rq
    from easydarwin_tpu_torch.codecs.h264_closed_loop import (
        decode_intra_picture)
    from easydarwin_tpu_torch.codecs.h264_intra import Pps, Sps, psnr
    from easydarwin_tpu_torch.ops import kernel_lib

    def idr_picture(nals, sps, pps):
        return decode_intra_picture(sps, pps, [
            (p.hdr, p.mbs) for p in (rq.parse_slice_cpython(n, sps, pps)
                                     for n in nals if n[0] & 0x1F == 5)])

    res = {}
    for path in CLOSED_LOOP_FIXTURES:
        kind = os.path.basename(path).rsplit("_", 1)[1].split(".")[0]
        with open(os.path.join(HERE, path), "rb") as f:
            nals = split_annexb(f.read())
        sps = Sps.parse(next(n for n in nals if n[0] & 0x1F == 7))
        pps = Pps.parse(next(n for n in nals if n[0] & 0x1F == 8))
        want_luma = want_chroma = 0
        for n in nals:
            if n[0] & 0x1F == 1:
                g = rq.gather_slice(rq.parse_slice_nal(n, sps, pps))
                if g.max_qp + 6 <= 51:
                    want_luma += g.rows.shape[0] > 0
                    want_chroma += g.cqp.shape[0] > 0
        runs = {}
        for dev in (DEVICE, "cpu"):
            eng = rq.SliceRequantizer(6, closed_loop=True, device=dev)
            before = {k: kernel_lib.LAUNCHES[k] for k in HLS_KERNELS}
            out, ms = [], {"I": [], "P": []}
            for n in nals:
                t0 = time.perf_counter()
                out.append(eng.transform_nal(n))
                if n[0] & 0x1F in (1, 5):
                    ms["I" if n[0] & 0x1F == 5 else "P"].append(
                        (time.perf_counter() - t0) * 1e3)
            runs[dev] = (out, ms, {k: kernel_lib.LAUNCHES[k] - before[k]
                                   for k in HLS_KERNELS}, eng.stats)
        out, ms, launches, st = runs[DEVICE]
        check(out == runs["cpu"][0], f"{kind}: the card's closed-loop NALs "
              f"differ from the CPU run's")
        check(st.slices_passed_through == 0 and st.slices_requantized == 8,
              f"{kind}: {st}")
        check(launches == {"ed_h264_requant": want_luma,
                           "ed_h264_requant_chroma": want_chroma},
              f"{kind}: B6 launches {launches}, P slices with luma rows "
              f"{want_luma} and with chroma rows {want_chroma}")
        eng_open = rq.SliceRequantizer(6, device=DEVICE)
        opened = [eng_open.transform_nal(n) for n in nals]
        src = idr_picture(nals, sps, pps)
        scores = {}
        for name, stream in (("closed", out), ("open", opened)):
            pic = idr_picture(stream, sps, pps)
            scores[name] = float(np.mean([psnr(a, b)
                                          for a, b in zip(src, pic)]))
        check(scores["closed"] > scores["open"],
              f"{kind}: closed loop {scores['closed']:.2f} dB is not above "
              f"the open loop's {scores['open']:.2f} dB")
        res[kind] = {"launches": launches, "host_ms_i": ms["I"],
                     "host_ms_p_mean": float(np.mean(ms["P"])),
                     "psnr_db": scores,
                     "bytes": {"in": st.bytes_in, "out": st.bytes_out}}
        log(f"[closed] {kind} 176x144 IPPP (1 + 7): every NAL equal to the "
            f"CPU run; B6 launches {launches} (one a P slice's dispatch); "
            f"host ms an AU: I {ms['I'][0]:.3f} (the closed loop), P mean "
            f"{np.mean(ms['P']):.3f} (the split walk around B6); the I "
            f"picture's PSNR to the source {scores['closed']:.3f} dB closed "
            f"vs {scores['open']:.3f} dB open (Y, Cb, Cr mean); bytes "
            f"{st.bytes_in} -> {st.bytes_out}")
    return res


# ------------------------------------------------------------- phase 14
SURFACE_DIR = os.path.join(HERE, "build", "surface_phase")
#: the phase's limit in seconds (servers started, traffic, checks, stop)
SURFACE_LIMIT_S = 90.0


def phase_surface(rng, smi: str, config2: dict) -> dict:
    """The reference's server surface through two CLI servers at 7b's
    traffic (``utils.surface_loopback``); its server B's figures beside
    phase 7b's."""
    import shutil
    from easydarwin_tpu_torch.utils import surface_loopback
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    t0 = time.monotonic()
    res = asyncio.run(asyncio.wait_for(surface_loopback.serve_surface(
        DEVICE, rng, SURFACE_DIR), SURFACE_LIMIT_S + 30))
    seconds = time.monotonic() - t0
    b, a = res["b_stats"], res["a_stats"]
    for name, st in (("A", a), ("B", b)):
        check(st["send_errors"] == 0 and st["missing_params"] == 0,
              f"server {name} send errors / missing params: {st}")
    check(b["kernel_launches"]["ed_relay_window"] > 0,
          "server B launched no ed_relay_window")
    check(seconds <= SURFACE_LIMIT_S,
          f"phase 14 took {seconds:.1f} s, over {SURFACE_LIMIT_S} s")
    ref = config2["server_stats"]
    join = res["first_join_ms"]
    log(f"[surface] {res['players']} players on B (16 tunneled + 16 TCP on "
        f"/pull1, 16 UDP on /pull2, 8 UDP + 8 TCP on /bcast; each behind "
        f"Digest), {res['packets_per_source']} packets a source, "
        f"{res['delivered']} delivered, every one checked; A's 4th "
        f"connection from one address {res['per_ip']['fourth']}; icy "
        f"{res['icy']['bytes']} bytes equal to the file between "
        f"{res['icy']['meta_blocks']} metadata blocks; {res['access_log_plays']}"
        f" W3C PLAY lines on B; launches A {a['kernel_launches']} B "
        f"{b['kernel_launches']}; {seconds:.1f} s")
    log(f"[surface] B wake host ms p50 {b['wake_ms_p50']:.3f} p99 "
        f"{b['wake_ms_p99']:.3f} (phase 7b: p50 {ref['wake_ms_p50']:.3f} "
        f"p99 {ref['wake_ms_p99']:.3f}); first join ms: tunnel "
        f"{join['tunnel']['first']:.1f} (p50 {join['tunnel']['p50']:.1f}), "
        f"TCP {join['tcp']['first']:.1f} (p50 {join['tcp']['p50']:.1f}), "
        f"UDP {join['udp']['first']:.1f} (p50 {join['udp']['p50']:.1f}); "
        f"startpullrelay to the pull's first packet "
        f"{res['pull_first_packet_ms']:.1f} ms; the pull's host "
        f"{res['pull_forward_us']:.2f} µs a forwarded packet; card {smi}")
    res["seconds"] = seconds
    return res


#: phase 15: its limit in seconds a pair of runs (started, scraped,
#: stopped), its players, its source's GOPs and the traffic's seed (every
#: run), and its runs' profiling, in order: off, on, on, off
OBS_LIMIT_S = 90.0
OBS_RUNS = (False, True, True, False)
OBS_PLAYERS = dict(udp=16, tcp=16, meta=8, fec=8)
OBS_GOPS = 5
OBS_SEED = 20261019
#: the most the profiled runs' mean host µs a packet relayed (the pump's
#: passes, ``pass_ms_total`` over ``packets_out``), and their mean CPU µs
#: a packet (the server process's ``cpu_s``), may be over the others'
OBS_OVERHEAD_MAX = 1.5
#: the most ``device_step``'s mean may be over the window kernel's own
#: time (phase 10): the host's time inside the launch call, between the
#: two events, where the card waits for the kernel to arrive (a few µs:
#: the entry point records both events around its own launch,
#: ``csrc/launch_timing.h``, so no wait for the GIL falls between them),
#: with room
OBS_LAUNCH_ALLOWANCE_MS = 0.05


def phase_observed(smi: str) -> dict:
    """Phase 15: the observed relay four times on the same traffic,
    profiling off, on, on, off (``utils.obs_loopback``), and every check
    of the module docstring but the device time's, which needs phase 10
    (``observed_device_check``)."""
    from easydarwin_tpu_torch import obs
    from easydarwin_tpu_torch.utils import obs_loopback as ol
    t0 = time.monotonic()
    runs = {False: [], True: []}
    for profile in OBS_RUNS:
        runs[profile].append(asyncio.run(asyncio.wait_for(
            ol.observed_relay(DEVICE, OBS_SEED, profile=profile,
                              gops=OBS_GOPS, **OBS_PLAYERS), OBS_LIMIT_S)))
    seconds = time.monotonic() - t0
    limit_s = OBS_LIMIT_S * len(OBS_RUNS) / 2
    on, off = runs[True][-1], runs[False][-1]
    p50 = {k: [r["server_stats"]["wake_ms_p50"] for r in v]
           for k, v in runs.items()}
    p99 = {k: [r["server_stats"]["wake_ms_p99"] for r in v]
           for k, v in runs.items()}
    per_packet, cpu_packet = (
        {k: [r["server_stats"][key] * scale
             / max(r["server_stats"]["packets_out"], 1) for r in v]
         for k, v in runs.items()}
        for key, scale in (("pass_ms_total", 1e3), ("cpu_s", 1e6)))
    st, final = on["server_stats"], on["final"]
    fams, samples = ol.exposition(final["metrics"][1])
    inventory = {f.name: f.kind for f in obs.REGISTRY.families()}
    check(final["metrics"][0] == 200 and fams,
          f"/metrics answered {final['metrics'][0]}")
    strays = {n: k for n, k in fams.items() if inventory.get(n) != k}
    check(not strays, f"families outside the inventory: {strays}")
    orphans = {n for n, _l, _v in samples if ol.family_of(n, fams) is None}
    check(not orphans, f"samples of no family: {sorted(orphans)[:5]}")
    phases = ol.phase_stats(samples)
    bad = [k for k in phases if k[0] not in obs.ENGINES
           or k[1] not in obs.PHASES]
    check(not bad, f"relay_phase_seconds outside PHASES x ENGINES: {bad}")
    rc, report, top = on["blame"]
    check(rc == 0 and top in obs.WORK_CLASSES,
          f"blame_report --url exited {rc}, top offender {top!r}:\n"
          f"{report}")
    launches = st["kernel_launches"]
    dev_n, dev_s = phases.get(("megabatch", "device_step"), (0, 0.0))
    check(launches["ed_relay_window"] > 0
          and dev_n == launches["ed_relay_window"],
          f"device_step count {dev_n} != the server's ed_relay_window "
          f"launches {launches['ed_relay_window']}")
    copied = st["copied_bytes"]
    got = {d: ol.sample_value(samples, f"tpu_{d}_bytes_total")
           for d in ("h2d", "d2h")}
    check(got == copied and copied["h2d"] > 0 and copied["d2h"] > 0,
          f"tpu_*_bytes_total {got} != the bytes the relay tiers' copies "
          f"moved {copied}")
    info = final["info"][1]
    keys = ("IngestToWireP99Ms", "LedgerTopWaitClass", "LedgerLastWakeMs")
    check(all(info.get(k) not in (None, "") for k in keys),
          f"getserverinfo obs keys: {[(k, info.get(k)) for k in keys]}")
    check(info["LedgerTopWaitClass"] in obs.WORK_CLASSES,
          f"LedgerTopWaitClass {info['LedgerTopWaitClass']!r}")
    prof = ol.pprof_summary(final["pprof"][1])
    check(final["pprof"][0] == 200 and prof["samples"] > 0
          and "samples" in prof["strings"]
          and "megabatch.dispatch" in prof["strings"],
          f"/debug/profile: {final['pprof'][0]}, {prof['samples']} samples")
    check(all(p[0] == 200 for p in final["pages"].values()),
          f"pages: {final['pages']}")
    check(final["top"][0] == 200 and "phases" in final["top"][1],
          f"admin command=top answered {final['top'][0]}")
    for name, (status, _doc) in final["docs"].items():
        check(status == 200, f"/api/v1/{name} answered {status}")
    check(all(s[d][0] == 200 for s in on["scrapes"] for d in ol.DOCS)
          and on["scrapes"], f"a scrape failed: {on['scrapes']}")
    def mean(xs):
        return sum(xs) / len(xs)

    ratio = mean(per_packet[True]) / mean(per_packet[False])
    cpu_ratio = mean(cpu_packet[True]) / mean(cpu_packet[False])
    p50_ratio = mean(p50[True]) / mean(p50[False])
    check(ratio <= OBS_OVERHEAD_MAX,
          f"the pump's host µs a packet relayed with obs "
          f"{per_packet[True]} are {ratio:.2f}x those without "
          f"({per_packet[False]}), mean to mean")
    check(cpu_ratio <= OBS_OVERHEAD_MAX,
          f"the server's CPU µs a packet relayed with obs "
          f"{cpu_packet[True]} are {cpu_ratio:.2f}x those without "
          f"({cpu_packet[False]}), mean to mean")
    check(seconds <= limit_s,
          f"phase 15 took {seconds:.1f} s, over {limit_s} s")
    path = {k: sum(r["server_stats"]["kernel_launches"].get(k, 0)
                   for v in runs.values() for r in v)
            for k in launches}
    delivered = [r["delivered"] for r in on["av"]] \
        + [on["lossy"]["delivered"]]
    log(f"[observed] {on['players']} players on 3 paths ({OBS_PLAYERS}), "
        f"delivered {delivered}, every packet "
        f"held; {len(fams)} families scraped, all in the inventory; "
        f"{len(on['scrapes'])} scrapes during the run, host ms "
        f"{[round(x['ms'], 1) for x in on['scrapes']]}; blame_report "
        f"names {top}; getserverinfo {[(k, info[k]) for k in keys]}; "
        f"pprof {prof['samples']} stacks of {prof['span_count']} spans; "
        f"launches {launches}")
    log(f"[observed] device_step (megabatch) {dev_n} samples = "
        f"{launches['ed_relay_window']} ed_relay_window launches, mean "
        f"{dev_s / max(dev_n, 1) * 1e3:.6f} ms; tpu_h2d_bytes_total "
        f"{got['h2d']:.0f} and tpu_d2h_bytes_total {got['d2h']:.0f} = the "
        f"copies' {copied['h2d']} and {copied['d2h']}")
    log(f"[observed] runs {OBS_RUNS} in turn: the pump's host µs a packet "
        f"relayed with EDTPU_PROFILE=1 {per_packet[True]}, with =0 "
        f"{per_packet[False]}: ratio of the means {ratio:.3f}; the "
        f"server's CPU µs a packet {cpu_packet[True]} against "
        f"{cpu_packet[False]}: {cpu_ratio:.3f} (limit {OBS_OVERHEAD_MAX} "
        f"each); wake host ms with =1 p50 {p50[True]} p99 "
        f"{p99[True]}, with =0 p50 {p50[False]} p99 {p99[False]} (ratio of "
        f"the mean p50s {p50_ratio:.3f}); phases (count, mean ms) "
        f"{ {f'{e}/{p}': (int(c), round(v / max(c, 1) * 1e3, 6)) for (e, p), (c, v) in sorted(phases.items())} }; "
        f"{seconds:.1f} s; card {smi}")
    return {"seconds": seconds, "ratio": ratio, "cpu_ratio": cpu_ratio,
            "p50_ratio": p50_ratio,
            "us_per_packet": {"on": per_packet[True],
                              "off": per_packet[False]},
            "cpu_us_per_packet": {"on": cpu_packet[True],
                                  "off": cpu_packet[False]},
            "path_launches": path,
            "device_step": {"count": dev_n, "mean_ms":
                            dev_s / max(dev_n, 1) * 1e3},
            "wake_ms": {"on": {"p50": p50[True], "p99": p99[True]},
                        "off": {"p50": p50[False], "p99": p99[False]}},
            "bytes": {"metrics": got, "copied": copied}, "blame_top": top,
            "info": {k: info[k] for k in keys}, "phases": {
                f"{e}/{p}": v for (e, p), v in phases.items()},
            "scrapes": on["scrapes"], "pages": final["pages"],
            "server_stats": {"on": st, "off": off["server_stats"]},
            "blame_report": report}


#: phase 16: its limit in seconds, its seed, how long the faults fire and
#: the ladder's recover time
CHAOS_LIMIT_S = 90.0
CHAOS_SEED = 20261021
CHAOS_FAULT_S = 5.0
CHAOS_RECOVER_S = 1.0
CHAOS_DIR = os.path.join(HERE, "build", "chaos_phase")

def phase_chaos(smi: str) -> dict:
    """Phase 16: the chaos run and the restart from the checkpoint (the
    module docstring)."""
    import shutil
    from easydarwin_tpu_torch.utils import chaos_loopback as cl
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    t0 = time.monotonic()
    res = asyncio.run(asyncio.wait_for(cl.chaos_relay(
        DEVICE, CHAOS_SEED, streams=8, players=8, fault_s=CHAOS_FAULT_S,
        recover_sec=CHAOS_RECOVER_S,
        log_folder=os.path.join(CHAOS_DIR, "logs")), CHAOS_LIMIT_S))
    t_chaos = time.monotonic() - t0
    wl = res["window_launches"]
    check(wl["fault"] > 0 and wl["after"] > 0,
          f"ed_relay_window launches while the faults fired / after the "
          f"recovery: {wl}")
    check(wl == res["window_calls"],
          f"ed_relay_window launches {wl} != the scheduler's window calls "
          f"{res['window_calls']}")
    restart = asyncio.run(asyncio.wait_for(cl.restart_resume(
        DEVICE, os.path.join(CHAOS_DIR, "restart"), seed=CHAOS_SEED,
        packets=60), CHAOS_LIMIT_S))
    t_restart = time.monotonic() - t0 - t_chaos
    seconds = time.monotonic() - t0
    check(seconds <= CHAOS_LIMIT_S,
          f"phase 16 took {seconds:.1f} s, over {CHAOS_LIMIT_S} s")
    rung_s = {k: round(v, 3) for k, v in res["rung_s"].items()}
    log(f"[chaos] plan {res['plan']}: {res['streams']} streams × "
        f"{res['players'] // res['streams']} UDP players for "
        f"{CHAOS_FAULT_S} s; faults by site {res['faults']} (= "
        f"fault_injected_total {res['fault_injected_total']}; the egress "
        f"core's own count {res['egress_native_faults']}); device errors "
        f"counted {res['device_errors']} (injected "
        f"{res['device_errors_injected']}); transitions {res['transitions']};"
        f" stream-seconds by rung {rung_s}")
    log(f"[chaos] recovered to the megabatch rung {res['recover_s']:.3f} s "
        f"after the disarm (bound {res['recover_bound_s']:.1f} s); "
        f"ed_relay_window launches while faulted {wl['fault']}, after the "
        f"recovery {wl['after']} (in {1.0:.1f} s); oracle mismatches "
        f"{res['mismatches']}; wake host ms while faulted p50 "
        f"{res['wake_ms_p50']:.3f} p99 {res['wake_ms_p99']:.3f} over "
        f"{res['wakes_faulted']} wakes; {res['pushed']} packets pushed, "
        f"{res['delivered']} delivered and checked; {t_chaos:.1f} s")
    log(f"[chaos] restart: restored {restart['restored_sessions']} session "
        f"/ {restart['restored_outputs']} UDP output, 1 TCP record "
        f"re-attached; packets before / after: UDP {restart['udp_packets']}"
        f", TCP {restart['tcp_packets']}, one SSRC and a contiguous seq "
        f"each; the restored subscriber's RR proved it: "
        f"{restart['rr_proved']}; {t_restart:.1f} s")
    log(f"[chaos] phase {seconds:.1f} s; card {smi}")
    return {"chaos": res, "restart": restart, "seconds": seconds,
            "chaos_s": t_chaos, "restart_s": t_restart}


#: phase 17: its limit in seconds, its seed and its folder (node configs,
#: logs)
CLUSTER_LIMIT_S = 60.0
CLUSTER_SEED = 20261022
CLUSTER_DIR = os.path.join(HERE, "build", "cluster_phase")


def phase_cluster(smi: str) -> dict:
    """Phase 17: two CLI servers over the in-process Redis, a pull, the
    owner's SIGKILL and the migration (the module docstring)."""
    import shutil
    from easydarwin_tpu_torch.utils import cluster_loopback as cl
    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    t0 = time.monotonic()
    res = asyncio.run(asyncio.wait_for(cl.cluster_kill(
        DEVICE, CLUSTER_DIR, seed=CLUSTER_SEED), CLUSTER_LIMIT_S))
    seconds = time.monotonic() - t0
    check(seconds <= CLUSTER_LIMIT_S,
          f"phase 17 took {seconds:.1f} s, over {CLUSTER_LIMIT_S} s")
    check(res["adopt_s"] <= cl.ADOPT_BUDGET_S and res["seq_gap"] == 0
          and res["seq_offsets"] == 1 and res["host_steps"] == 0,
          f"adoption {res['adopt_s']:.3f} s, seq gap {res['seq_gap']}, "
          f"seq offsets {res['seq_offsets']}, host passes "
          f"{res['host_steps']}")
    srv = res.pop("server_stats")
    res["server_counters"] = {
        "pump_errors": srv["pump_errors"],
        "device_errors": srv["resilience"]["device_errors"],
        "mismatches": srv["megabatch"]["mismatches"],
        "cluster": srv["cluster"]}
    log(f"[cluster] {res['paths']} paths pushed to A, a UDP player each, "
        f"one pulled on B: {res['pull_packets'][0]} packets through the "
        f"pull before the kill (payloads = the pushed ones, in order), "
        f"freshness chain {res['freshness_hops']} hops; SIGKILL of A → B's "
        f"claims on every path in {res['adopt_s']:.3f} s; fleet on B "
        f"{res['fleet']}; migrations {res['migrations']:.0f}, pull retries "
        f"{res['pull_retries']:.0f}")
    log(f"[cluster] UDP players (packets before / after the kill) "
        f"{res['udp_packets']}, one SSRC each, seq gap {res['seq_gap']}, "
        f"one seq offset from the push index ({res['resent_or_dup']} "
        f"packets of the pushers' tails repeated); B: pull errors "
        f"{res['pull_errors']} (none charged to the ladder), host passes "
        f"{res['host_steps']}, ladder degrades {res['ladder_degrades']} "
        f"(each to the device rung at most); megabatch passes before the "
        f"kill "
        f"{res['megabatch_passes']['before_kill']:.0f}, after the adoption "
        f"{res['megabatch_passes']['after_adoption']:.0f}, window calls "
        f"{res['window_calls']}; wake host ms p50 "
        f"{res['wake_ms_p50']:.3f} p99 {res['wake_ms_p99']:.3f}; capacity "
        f"score {res['capacity_score']:.0f} (self-bench "
        f"{res['capacity_pps']:.1f} pkt/s); phase {seconds:.1f} s; card "
        f"{smi}")
    res["seconds"] = seconds
    return res


#: phase 17b: its limit in seconds, its seed, its folder (the three
#: nodes' movie and log folders, the CMS's snapshots) and its size: two
#: 4 s recordings of a 25 fps H.264 camera at 4 Mbit/s (20,000-byte
#: frames, 15 FU-A packets each, pushed at the camera's pace: a replay
#: is paced by the recording's arrival times), 64-packet windows, k = 2
#: and m = 2, two players a replay, and a two-channel device's 2 s a
#: channel
CLUSTER_DVR_LIMIT_S = 60.0
CLUSTER_DVR_SEED = 20261023
CLUSTER_DVR_DIR = os.path.join(HERE, "build", "cluster_dvr_phase")
CLUSTER_DVR_SIZE = dict(frames=100, gop=25, nal_bytes=20_000, frame_s=0.04,
                        window_pkts=64, k=2, m=2, players=2, cms_frames=50)


def phase_cluster_dvr(smi: str) -> dict:
    """Phase 17b: the cluster's DVR peer fill, the dead owner's replay
    from the store and the CMS flow, on three servers in this process
    (the module docstring)."""
    import shutil
    from easydarwin_tpu_torch.utils import cluster_dvr_loopback as cdl
    shutil.rmtree(CLUSTER_DVR_DIR, ignore_errors=True)
    t0 = time.monotonic()
    res = asyncio.run(asyncio.wait_for(cdl.cluster_dvr(
        DEVICE, CLUSTER_DVR_DIR, seed=CLUSTER_DVR_SEED, **CLUSTER_DVR_SIZE),
        CLUSTER_DVR_LIMIT_S))
    seconds = time.monotonic() - t0
    shutil.rmtree(CLUSTER_DVR_DIR, ignore_errors=True)
    check(seconds <= CLUSTER_DVR_LIMIT_S,
          f"phase 17b took {seconds:.1f} s, over {CLUSTER_DVR_LIMIT_S} s")
    steps = {"store on A": res["store_launches"],
             "B's remote replay": res["remote"]["launches"],
             "C's dead-owner replay": res["dead_owner"]["launches"],
             f"the CMS's media server {res['cms']['media']}":
                 res["cms"]["launches"]}
    for step, kernel in (("B's remote replay", "ed_relay_window"),
                         ("C's dead-owner replay", "ed_relay_window"),
                         (f"the CMS's media server {res['cms']['media']}",
                          "ed_relay_window"),
                         ("store on A", "ed_gf_parity"),
                         ("C's dead-owner replay", "ed_gf_parity")):
        check(steps[step].get(kernel, 0) > 0,
              f"{kernel} was not launched in phase 17b's {step}")
    rec = res["dead_owner"]["reconstruct"]
    srv = res["servers"]
    log(f"[cluster-dvr] {len(res['windows'])} recordings on A "
        f"({', '.join(f'{p}: {w} windows' for p, w in res['windows'].items())}"
        f"), k = {res['k']}, m = {res['m']}: finalize → every shard placed "
        f"{', '.join(f'{v:.3f}' for v in res['store_ms'].values())} ms "
        f"(A's store {srv['dvr-a']['store_ms_per_call']:.3f} ms a call, "
        f"parity products {srv['dvr-a']['parity_product_ms']:.3f} ms and "
        f"their host checks {srv['dvr-a']['parity_check_ms']:.3f} ms in "
        f"all); shards by node {res['shards']}")
    log(f"[cluster-dvr] B's remote replay (dvrmeta + dvrwindow from A): "
        f"first datagram {', '.join(f'{v:.3f}' for v in res['remote']['first_ms'])}"
        f" ms after the DESCRIBE, {res['remote']['players'][0]['packets']} "
        f"packets a player; C's dead-owner replay (A stopped, shard "
        f"{res['deleted_shard']} deleted on C, dvrmeta from B's manifest): "
        f"first datagram "
        f"{', '.join(f'{v:.3f}' for v in res['dead_owner']['first_ms'])} "
        f"ms, {res['dead_owner']['players'][0]['packets']} packets a "
        f"player; C's reconstructs {rec['reconstructs']} over "
        f"{rec['gathers']} gathers, host ms a reconstruct: gather "
        f"{rec['gather_ms']:.3f}, launch and readback "
        f"{rec['launch_readback_ms']:.3f}, crc {rec['crc_ms']:.3f}; C's "
        f"B4 reconstruct products "
        f"{res['dead_owner']['c_product_ms']:.3f} ms in all; "
        f"repairs B {srv['dvr-b']['repairs']}, C "
        f"{srv['dvr-c']['repairs']}; every replay SPS first, one SSRC, "
        f"gapless, the pushed payloads; pack_window calls "
        f"{res['pack_window_calls']}")
    log(f"[cluster-dvr] CMS: 2 channels on {res['cms']['media']}, get "
        f"stream → first packet "
        f"{', '.join(f'{v:.3f}' for v in res['cms']['get_stream_to_first_ms'])}"
        f" ms, {res['cms']['players'][0]['packets']} packets a player, SPS "
        f"first, one SSRC, gapless; launches by step {steps}; phase "
        f"{seconds:.1f} s; card {smi}")
    zeros = {node: {k: s[k] for k in cdl.ZERO_COUNTERS}
             for node, s in srv.items()}
    log(f"[cluster-dvr] counters by node (A's read before it stopped): "
        f"{zeros}")
    res["seconds"] = seconds
    return res


# ------------------------------------------------------------- phase 18
KEYS_LIMIT_S = 90.0
KEYS_SEED = 20261026
KEYS_DIR = os.path.join(HERE, "build", "keys_phase")
#: run A: paths, and each path's plain UDP, interleaved TCP and FEC
#: players (the FEC ones drop 7d's share of media)
KEYS_PATHS = 4
KEYS_PLAYERS = (8, 4, 4)
KEYS_DROP = 0.08


def phase_keys(smi: str) -> dict:
    """Phase 18: the reference's keys off (run A) and its gates (run B),
    one CLI server each (the module docstring)."""
    import shutil
    from easydarwin_tpu_torch.utils import keys_loopback as kl
    t0 = time.monotonic()
    off = asyncio.run(asyncio.wait_for(kl.keys_off(
        DEVICE, os.path.join(KEYS_DIR, "a"), KEYS_SEED, paths=KEYS_PATHS,
        players=kl.off_players(*KEYS_PLAYERS, drop=KEYS_DROP), gops=5,
        dvr_s=2.0, lost=2), KEYS_LIMIT_S))
    t_a = time.monotonic() - t0
    gates = asyncio.run(asyncio.wait_for(kl.keys_gates(
        DEVICE, os.path.join(KEYS_DIR, "b"), KEYS_SEED + 7, players=4,
        gops=6), KEYS_LIMIT_S - t_a))
    seconds = time.monotonic() - t0
    shutil.rmtree(KEYS_DIR, ignore_errors=True)
    check(seconds <= KEYS_LIMIT_S,
          f"phase 18 took {seconds:.1f} s, over {KEYS_LIMIT_S} s")

    # -- run A: the keys off
    st = off["server_stats"]
    la, fec, store = st["kernel_launches"], st["fec"], st["storage"]
    check(kl.unmapped_keys(off["preamble"]) == [],
          f"run A's TOML left keys unmapped: {off['preamble']}")
    check(la["ed_relay_window"] == 0 and st["megabatch"]["passes"] == 0
          and st["megabatch"]["prime_passes"] == 0,
          f"megabatch_enabled = false, yet ed_relay_window launched "
          f"{la['ed_relay_window']} times ({st['megabatch']})")
    by_path = st["param_refreshes_by_path"]
    live = [f"/keys/a{i}" for i in range(KEYS_PATHS)]
    check(all(by_path.get(p, 0) > 0 for p in live)
          and la["ed_ring_query"] >= sum(by_path.values()),
          f"ring queries by path {by_path}, ed_ring_query launches "
          f"{la['ed_ring_query']}")
    delivered = {k: sum(r["delivered"][k] for r in off["paths"])
                 for k in ("plain", "tcp", "fec")}
    check(la["ed_relay_batch"] > 0 and st["tcp_sent"] == 0
          and st["batch_sent"] >= delivered["tcp"] > 0,
          f"tcp_engine_enabled = false: batch rung {st['batch_sent']} "
          f"packets ({la['ed_relay_batch']} ed_relay_batch launches), TCP "
          f"rung {st['tcp_sent']}, the TCP players' spans "
          f"{delivered['tcp']}")
    fec_players = [p for r in off["paths"] for p in r["fec_players"]]
    pts = {}
    for p in fec_players:
        for pt, n in p["pts"].items():
            pts[int(pt)] = pts.get(int(pt), 0) + n
    check(la["ed_gf_parity"] == 0 and fec["device_passes"] == 0
          and fec["host_passes"] > 0 and fec["parity_sent"] > 0,
          f"fec_device = false: ed_gf_parity {la['ed_gf_parity']}, FEC "
          f"{fec}")
    check(set(pts) <= {96, 109, 110} and pts.get(110, 0) > 0
          and all(p["pts"].get(110, 0) > 0 for p in fec_players)
          and (fec["rtx_sent"] == 0 or pts.get(109, 0) > 0),
          f"FEC payload types on the wire {pts} (want parity on 110, RTX "
          f"on 109)")
    check(fec["rtx_sent"] > 0 and fec["oracle_mismatches"] == 0
          and fec["rtx_giveups"] == 0 and st["loss_tiers"]["fec_granted"]
          == len(fec_players),
          f"run A's FEC tier: {fec}, grants {st['loss_tiers']}")
    check(store["device_passes"] == 0 and store["host_products"] > 0
          and store["reconstructs"] > 0
          and store["reconstruct_failures"] == 0
          and store["oracle_mismatches"] == 0
          and store["worker_errors"] == 0,
          f"storage_device = false: the store {store}")
    check(st["send_errors"] == 0 and st["missing_params"] == 0,
          f"run A send errors / missing params: {st}")
    dvr = off["dvr"]
    log(f"[keys] run A (megabatch_enabled, tcp_engine_enabled, fec_device "
        f"false; fec_window 8, PTs 110/109, timeout_sweep_sec 2; "
        f"storage_device false): {KEYS_PATHS} paths x "
        f"{sum(KEYS_PLAYERS)} players, every span byte-equal to the oracle, "
        f"delivered {delivered}; ed_relay_window 0, ed_ring_query "
        f"{la['ed_ring_query']} (ring queries by path {by_path}), "
        f"ed_relay_batch {la['ed_relay_batch']} (batch rung "
        f"{st['batch_sent']} packets, TCP rung {st['tcp_sent']}), "
        f"ed_gf_parity 0; FEC {fec['parity_sent']} parity in "
        f"{fec['windows_emitted']} windows, {fec['host_passes']} host "
        f"products at {fec['host_ms_per_window']:.6f} ms a window, RTX "
        f"{fec['rtx_sent']}, PTs on the wire {pts}, 0 mismatches, 0 "
        f"give-ups; the store: {dvr['windows']} windows recorded, "
        f"{dvr['deleted']} deleted, the replay {dvr['replayed']} of "
        f"{dvr['packets']} packets through {store['reconstructs']} "
        f"reconstructs, {store['host_products']} host products "
        f"({store['product_ms_per_reconstruct']:.3f} ms a reconstruct), "
        f"0 device passes; launches {la}; {t_a:.1f} s; card {smi}")

    # -- run B: the gates
    st = gates["server_stats"]
    lb, tiers = st["kernel_launches"], st["loss_tiers"]
    asked = [g for r in gates["paths"] for g in r["grants"]]
    check(asked and all(g["grants"] == {} for g in asked),
          f"reliable_udp / fec_enabled false, yet granted: "
          f"{[g for g in asked if g['grants']]}")
    check(tiers["retransmit_granted"] == 0 and tiers["fec_granted"] == 0
          and tiers["retransmit_refused"] > 0 and tiers["fec_refused"] > 0
          and st["batch_sent"] == 0 and st["fec"]["parity_sent"] == 0
          and st["reliable"]["acks"] == 0,
          f"an output was wrapped: loss tiers {tiers}, batch rung "
          f"{st['batch_sent']}, FEC {st['fec']}, reliable {st['reliable']}")
    mb = gates["megabatch_passes"]
    check(mb["two_paths"] == 0 and mb["three_paths"] > 0
          and st["megabatch"]["passes"] > 0 and lb["ed_relay_window"] > 0
          and lb["ed_relay_window"] == st["megabatch"]["window_calls"]
          and lb["ed_ring_query"] > 0 and lb["ed_gf_parity"] == 0,
          f"megabatch_min_streams = 3: passes {mb}, {st['megabatch']}, "
          f"launches {lb}")
    log(f"[keys] run B (reliable_udp, fec_enabled false, "
        f"megabatch_min_streams 3): {len(asked)} players asked for x-FEC or "
        f"x-Retransmit, none granted ({tiers}); megabatch_passes_total "
        f"{mb['two_paths']:.0f} while two paths played, "
        f"{mb['three_paths']:.0f} after the third joined; launches {lb}; "
        f"setbaseconfig 200 and getbaseconfig read back for "
        f"{len(gates['keys'])} keys; {seconds - t_a:.1f} s; card {smi}")
    log(f"[keys] phase 18 {seconds:.3f} s (limit {KEYS_LIMIT_S} s); card "
        f"{smi}")
    return {"off": off, "gates": gates, "seconds": seconds,
            "launches_a": la, "launches_b": lb,
            "path_launches": {k: la[k] + lb.get(k, 0) for k in la}}


def observed_device_check(observed: dict, timed: list) -> None:
    """Phase 15's device time against phase 10: the ``device_step`` mean
    (the timing events around the ``ed_relay_window`` launch) at least
    the kernel's own time in a graph and at most that time plus
    ``OBS_LAUNCH_ALLOWANCE_MS``."""
    kernel = min(k["ms"] for k in timed if k["name"] == "ed_relay_window"
                 and k["_main_path"])
    mean = observed["device_step"]["mean_ms"]
    top = kernel + OBS_LAUNCH_ALLOWANCE_MS
    check(kernel <= mean <= top,
          f"device_step mean {mean:.6f} ms outside [kernel {kernel:.6f}, "
          f"kernel + launch allowance {top:.6f}] ms")
    log(f"[observed] device_step mean {mean:.6f} ms between the kernel's "
        f"{kernel:.6f} ms (phase 10) and that plus the "
        f"{OBS_LAUNCH_ALLOWANCE_MS} ms launch allowance")
    observed["kernel_ms"] = kernel


def gf_storage_check(rng, shapes) -> int:
    """``ed_gf_parity`` (the wrapper) vs ``gf_parity_plain`` on the same
    card tensors at phase 12's stripe shapes; the largest difference."""
    import torch
    from easydarwin_tpu_torch.ops import fec_kernel
    err = 0
    for k, b, r in shapes:
        rows, coeff = gf_inputs(rng, k, b, r)
        got = fec_kernel.gf_parity(rows, coeff)
        want = fec_kernel.gf_parity_plain(rows, coeff)
        d = int((got.int() - want.int()).abs().max())
        check(d == 0, f"ed_gf_parity at the stripe [{k},{b}]x[{r},{k}] "
              f"differs from the plain version (max {d})")
        err = max(err, d)
        torch.cuda.synchronize()
    log(f"[gf] ed_gf_parity at phase 12's stripe shapes "
        + ", ".join(f"[{k},{b}]x[{r},{k}]" for k, b, r in shapes)
        + ": bit-exact vs gf_parity_plain")
    return err


# ------------------------------------------------------------- phase 10
#: the library's kernels, as ``ptxas_report`` names them
KERNEL_NAMES = ("parse_packets_kernel", "relay_window_kernel",
                "ring_query_kernel", "launch_floor_kernel",
                "decode_blocks_kernel", "gf_parity_lanes_kernel",
                "gf_parity_stripe_kernel",
                "requant_rungs_kernel", "h264_requant_chroma_kernel",
                "h264_requant_kernel", "relay_shard_kernel")


def kernel_key(mangled: str, names=KERNEL_NAMES) -> str | None:
    """The first of ``names`` in a mangled symbol, with its template's
    integer and bool arguments (``gf_parity_lanes_kernel<1,2>``,
    ``relay_shard_kernel<64,16,1,1>``); None if none."""
    import re
    name = next((n for n in names if n in mangled), None)
    if name:
        args = re.findall(r"L[ib](\d+)E", mangled.split(name, 1)[1])
        if args:
            name += f"<{','.join(args)}>"
    return name


def ptxas_report(build_log: str, names=KERNEL_NAMES) -> dict:
    """Registers, shared memory and spills of each kernel from the build's
    ``-Xptxas -v`` lines, keyed by ``kernel_key``."""
    import re
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = kernel_key(m.group(1), names)
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[cur]["stack_frame"] = int(m.group(1))
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


def card_state() -> dict:
    """What shares the card when phase 10 starts timing: the processes
    on it, its clocks, power and throttle reasons (``nvidia-smi``, read
    only), this process's live threads, and the launches made within a
    second by nothing of phase 10 (another thread still at work)."""
    import threading
    from easydarwin_tpu_torch.ops import kernel_lib

    def smi(*query):
        return subprocess.run(
            ["nvidia-smi", *query, "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()

    before = dict(kernel_lib.LAUNCHES)
    time.sleep(1.0)
    stray = {k: n - before[k] for k, n in kernel_lib.LAUNCHES.items()
             if n != before[k]}
    return {"apps": smi("--query-compute-apps=pid,process_name,used_memory"),
            "gpu": smi("--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                       "power.draw,clocks_throttle_reasons.active"),
            "threads": sorted(t.name for t in threading.enumerate()),
            "launches_in_a_second": stray}


def launch_floor_ms() -> float:
    """One graph node of an empty kernel: the card's floor for a launch."""
    import torch
    from easydarwin_tpu_torch.ops import kernel_lib
    lib = kernel_lib.library()

    def floor():
        rc = lib.ed_launch_floor(torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"ed_launch_floor: {kernel_lib.error_message(rc)}")
    return graph_ms(floor, inner=100)


def prime_window_specs(prime_shapes: dict, top: int = 3) -> list:
    """The window bucket specs of phase 11's ``top`` most frequent prime
    calls (``vod_in_process``'s ``prime_shapes`` keys, ``[B,P,W]x[B,S,6]``
    joined by `` + ``), and clip A's and clip B's one-join windows (2,048
    and 8,192 rows) where those are not among them."""
    import re
    specs = []
    for key, _n in sorted(prime_shapes.items(), key=lambda kv: -kv[1]):
        specs.append(tuple(
            (int(b), int(b), int(p), int(n), int(n), int(w))
            for b, p, w, n in re.findall(
                r"\[(\d+),(\d+),(\d+)\]x\[\d+,(\d+),6\]", key)))
    specs = specs[:top]
    for p in (2048, 8192):
        one = ((1, 1, p, 8, 8, 100),)
        if one not in specs:
            specs.append(one)
    return specs


def phase_kernels(rng, launches: dict, errs: dict, levels, qt,
                  b9_shape: tuple[int, int],
                  vod_specs=(), stripe_shapes=(), b6=()) -> list[dict]:
    """Each kernel alone (entry point on preallocated outputs) and its
    plain version, by CUDA events around graph replays, at the main path's
    shapes (K1: 256 rows; window: the phase-6 wake group, one launch, and
    the VOD prime's calls of phase 11, ``vod_specs``; B9:
    phase 7c's pass ``b9_shape``; B7: config 5) and at the config-4 shapes
    of earlier runs (K1: 4,096 rows; window: [16,256,100]x[16,256,6], and
    its bytes as [64,64,100]x[64,64,6], which needs no cluster; B9: P = S =
    256); K2 at config 5 beside cuBLAS's fp32 product alone.  The
    wrappers' direct-call times go to the detail."""
    import ctypes
    import itertools
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import device_ring as dr
    from easydarwin_tpu_torch.ops import fanout, fec_kernel, kernel_lib
    from easydarwin_tpu_torch.ops import transform as tf
    from easydarwin_tpu_torch.ops.parse import parse_packets
    from easydarwin_tpu_torch.ops.parse_kernel import parse_packets_kernel
    from easydarwin_tpu_torch.ops import transform_kernel as tk
    from easydarwin_tpu_torch.ops.transform_kernel import decode_blocks_kernel
    relay_src = "easydarwin_tpu_torch/csrc/relay_kernels.cu"
    cases = []
    #: case index → where its shape comes from, when not the main path's
    #: wake or an earlier run's shape
    where_of = {}
    #: the outputs a launch descriptor points at, which no lambda holds:
    #: kept for the phase, or the timed launches write into blocks the
    #: allocator has handed on (B8's once wrote over B7's tables)
    held = []

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
        held.append(outs)
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
    for spec in vod_specs:
        where_of[len(cases)] = "phase 11's VOD prime"
        window_case(spec, False)
    def gf_case(shape, main: bool, n_sets: int = 1):
        # with n_sets > 1 each call takes the next input set, so a graph of
        # calls walks more bytes than L2 holds
        k, b, r = shape
        sets = [(*gf_inputs(rng, k, b, r),
                 torch.empty((r, b), dtype=torch.uint8, device="cuda"))
                for _ in range(n_sets)]
        tables = fec_kernel._tables(sets[0][0].device)
        turn = itertools.count()

        def pick():
            return sets[next(turn) % n_sets]

        def kernel():
            rows, coeff, out = pick()
            kernel_lib.launch("ed_gf_parity", rows.data_ptr(), k, b,
                              coeff.data_ptr(), r, tables.data_ptr(),
                              out.data_ptr())

        nbytes, ops = gf_bound(k, b, r)
        cases.append((
            "ed_gf_parity", f"[{k},{b}]x[{r},{k}]"
            + (f" over {n_sets} input sets" if n_sets > 1 else ""), main,
            "easydarwin_tpu_torch/csrc/fec_kernels.cu",
            "easydarwin_tpu/models/relay_pipeline.py:280", kernel,
            lambda: fec_kernel.gf_parity(*pick()[:2]),
            lambda: fec_kernel.gf_parity_plain(*pick()[:2]), None,
            nbytes, ops, 100 if main else 20))

    gf_case(GF_WIRE, True)
    gf_case(GF_STRIPE, False)
    gf_case(GF_STRIPE, False, GF_STRIPE_SETS)
    for shape in stripe_shapes:
        where_of[len(cases)] = "phase 12's store and reconstruct"
        gf_case(shape, False)

    def batch_case(p: int, s: int, main: bool):
        dev = [torch.from_numpy(a).cuda() for a in b9_arrays(rng, p, s)]
        prefix, length, age, state, buckets = dev
        headers = torch.empty((s, p, 12), dtype=torch.uint8, device="cuda")
        mask = torch.empty((s, p), dtype=torch.bool, device="cuda")
        flags = torch.empty((2, p), dtype=torch.bool, device="cuda")
        newest = torch.empty((), dtype=torch.int32, device="cuda")
        nbytes, ops = b9_bound(p, s)
        cases.append((
            "ed_relay_batch", f"P={p} S={s}", main, relay_src,
            "easydarwin_tpu/ops/fanout.py:212",
            lambda: kernel_lib.launch(
                "ed_relay_batch", prefix.data_ptr(), p, 96, length.data_ptr(),
                age.data_ptr(), state.data_ptr(), buckets.data_ptr(), s, 73,
                headers.data_ptr(), mask.data_ptr(), flags[0].data_ptr(),
                flags[1].data_ptr(),
                kernel_lib.scratch("ed_relay_batch",
                                   fanout.BATCH_SCRATCH_WORDS,
                                   prefix.device).data_ptr(),
                newest.data_ptr()),
            lambda: fanout.relay_batch_step(*dev, 73),
            lambda: fanout.relay_batch_step_plain(*dev, 73), None,
            nbytes, ops, 100))

    batch_case(*b9_shape, True)
    batch_case(256, 256, False)

    def b8_case(n: int, s: int, p: int, main: bool):
        # B8 over phase 6c's mesh: two shards on the card in ONE
        # ed_relay_shard, into one result
        from easydarwin_tpu_torch.parallel import mesh as pm
        card = torch.device("cuda")
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in b8_batch(n, s, p, seed=n + s + p)]
        m = pm.make_relay_mesh([card, card], src=2)
        step = pm.sharded_relay_step(m)
        plain = pm.sharded_relay_step_plain(m)
        outs = b8_outputs(n, s, p)
        (launch,) = fanout.shard_launch_plan(
            b8_probe().layout_shards(dev, {"src": 2}, *outs[:3]))
        desc = fanout.shard_descriptors(launch, 73, outs[3])
        held.append(outs)
        scratch = kernel_lib.scratch("ed_relay_shard",
                                     fanout.SHARD_SCRATCH_WORDS, card)
        where_of[len(cases)] = ("phase 6c's mesh of two shards on the card "
                                "(B8's own path: no serving caller)")
        cases.append((
            "ed_relay_shard", f"[{n},{p},96]x[{n},{s},6] over 2 shards",
            main, relay_src, "easydarwin_tpu/parallel/mesh.py:80",
            lambda: kernel_lib.launch("ed_relay_shard",
                                      ctypes.addressof(desc),
                                      scratch.data_ptr()),
            lambda: step(*dev), lambda: plain(*dev),
            None, *b8_bound(n, s, p), 20))

    b8_case(16, 256, 256, True)
    b8_case(4, 8, 32, False)
    qt_in, qt_rungs = config5_tables()
    n_rungs = qt_rungs.shape[0]
    rungs = torch.empty((n_rungs, levels.shape[0], 64), dtype=torch.int32,
                        device="cuda")
    nonzeros = torch.empty(n_rungs, dtype=torch.int32, device="cuda")
    nbytes, ops = b7_bound(levels.shape[0], n_rungs)
    cases.append((
        "ed_requant_rungs", f"[{levels.shape[0]},64] x {n_rungs} rungs", True,
        "easydarwin_tpu_torch/csrc/transform_kernels.cu",
        "easydarwin_tpu/models/transcode_pipeline.py:61",
        lambda: kernel_lib.launch(
            "ed_requant_rungs", levels.data_ptr(), levels.shape[0],
            qt_in.data_ptr(), qt_rungs.data_ptr(), n_rungs, rungs.data_ptr(),
            kernel_lib.scratch("ed_requant_rungs", tk.REQUANT_SCRATCH_WORDS,
                               levels.device).data_ptr(),
            nonzeros.data_ptr()),
        lambda: tk.requant_rungs(levels, qt_in, qt_rungs),
        lambda: tf.requant_rungs_plain(levels, qt_in, qt_rungs), None,
        nbytes, ops, 5))
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
    for case in b6:                            # B6: config 5 (phase 5c)
        if not case[2]:
            where_of[len(cases)] = "B6 chroma beside the main path's input"
        cases.append(case)
    out = []
    for i, (name, shape, main, src, src_line, kernel, wrapper, plain,
            library, nbytes, ops, inner) in enumerate(cases):
        # a case may give its operations' own rate: (count, per second)
        ops, rate = ops if isinstance(ops, tuple) else (ops, PEAK_OPS_PER_S)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        ms = graph_ms(kernel, inner=inner)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": src_line, "launches": launches[name],
            **({"caller": MODULE_KERNELS[name]} if name in MODULE_KERNELS
               else {}),
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": graph_ms(plain, inner=min(inner, 20)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None
            else graph_ms(library, inner=inner),
            # detail only (not part of the kernels line)
            "_shape": shape, "_main_path": main,
            "_where": where_of.get(i, "main path" if main
                                   else "earlier runs' shape"),
            "_bytes": nbytes, "_ops": ops, "_ops_rate": rate,
            "_bytes_ms": t_bytes, "_ops_ms": t_ops,
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
    # so did the B9 and B7 tickets: a call now is still bit-exact
    batch_scratch_at_zero()
    dev = [torch.from_numpy(a).cuda() for a in b9_arrays(rng, *b9_shape)]
    b9_diff(fanout.relay_batch_step(*dev, 73),
            fanout.relay_batch_step_plain(*dev, 73),
            "ed_relay_batch after the graph replays")
    # against tables made now: a launch that wrote over the phase's
    # tables fails here
    b7_diff(tk.requant_rungs(levels, qt_in, qt_rungs),
            tf.requant_rungs_plain(levels, *config5_tables()),
            "ed_requant_rungs after the graph replays")
    log("[kernels] ed_relay_batch and ed_requant_rungs after the graph "
        "replays: bit-exact, tickets back at 0")
    return out


#: per coefficient of B7's requant: the dequant multiply, then per rung
#: the divide, the round, the int conversion and the nonzero count
OPS_PER_B7_COEF, OPS_PER_B7_RUNG_COEF = 1, 4


def b7_bound(n_blocks: int, n_rungs: int) -> tuple[int, int]:
    """(bytes, operations) of one B7 call: levels and tables read once,
    rungs and counts written once."""
    n = 64 * n_blocks
    return (4 * n + 4 * 64 * (1 + n_rungs) + 4 * n_rungs * n + 4 * n_rungs,
            OPS_PER_B7_COEF * n + OPS_PER_B7_RUNG_COEF * n_rungs * n)


def phase_b7(timed: list, pipeline: dict) -> dict:
    """B7 at config 5: ``ed_requant_rungs`` in a graph beside the plain
    chain (``requant_rungs_plain``, torch ops: the design it replaced)
    and the byte bound, and phase 8's step."""
    k = next(t for t in timed if t["name"] == "ed_requant_rungs")
    res = {"shape": k["_shape"], "ms": k["ms"], "plain_ms": k["plain_ms"],
           "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
           "bound_share": k["_bound_share"], "gb_per_s": k["_gb_per_s"],
           "call_ms": k["_wrapper_call_ms"],
           "pipeline_step_ms_p50": pipeline["step_ms_p50"]}
    log(f"[b7] the ladder's requant at config 5 ({k['_shape']}): "
        f"ed_requant_rungs {k['ms']:.6f} ms in a graph ({k['_gb_per_s']:.1f} "
        f"GB/s, {k['_bound_share']:.1%} of the {k['bound_ms']:.6f} ms bound "
        f"by {k['bound_by']}), {k['_wrapper_call_ms']:.6f} ms a direct call; "
        f"the plain torch chain (the design it replaced) "
        f"{k['plain_ms']:.6f} ms in a "
        f"graph; phase 8's step p50 {pipeline['step_ms_p50']:.3f} ms")
    return res


def fec_leg_ms(rng, passes: int = 50) -> dict:
    """The FEC tier's device leg alone, in this process and away from any
    server's load: ``StreamFec._device_parity`` over one 16-packet window
    of paced 1080p-sized packets at the wire shape (pinned staging, the
    upload, ONE ed_gf_parity, the parity copied back and its event waited
    on), each pass held against the host ``gf_matmul``, whose time is the
    oracle's; host ms a pass from the tier's own two counters."""
    import numpy as np
    from easydarwin_tpu_torch.ops import staging
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fec import (FecConfig, StreamFec,
                                                coeff_rows, gf_matmul)
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
    from easydarwin_tpu_torch.utils import synth
    from easydarwin_tpu_torch.utils.loopback import VIDEO_SDP
    stream = RelayStream(sdp.parse(VIDEO_SDP).streams[0], StreamSettings())
    for i, pkt in enumerate(synth.paced_gop(
            rng, seq0=65500, ts0=0, ssrc=0x77, frames=30,
            packets_per_frame=13, body_len=(1270, 1300))):
        stream.push_rtp(pkt, 5000 + i // 13 * 33)
    fec = StreamFec(stream, FecConfig(device=DEVICE))
    k, b, r = GF_WIRE
    slots, deltas, _seqs, lens, max_len = fec._window_rows(5)
    b_pad = staging.pow2(max_len, 256)
    check(fec.cfg.window == k and b_pad == b,
          f"the leg's window is [{fec.cfg.window},{b_pad}], not the wire "
          f"shape {GF_WIRE}")
    coeff = coeff_rows(deltas, r)
    oracle_ns = 0
    for i in range(passes + 3):
        if i == 3:                              # after the warm-up
            fec.stage_ns = fec.kernel_ns = oracle_ns = 0
        rows, parity = fec._device_parity(slots, lens, coeff, b_pad)
        t0 = time.perf_counter_ns()
        want = gf_matmul(coeff, rows)
        oracle_ns += time.perf_counter_ns() - t0
        check(np.array_equal(parity, want),
              "the FEC leg's parity differs from the host gf_matmul")
    return {"window": [k, b_pad], "parity_rows": r, "passes": passes,
            "stage_ms_per_pass": fec.stage_ns / passes / 1e6,
            "kernel_ms_per_pass": fec.kernel_ns / passes / 1e6,
            "oracle_ms_per_pass": oracle_ns / passes / 1e6}


def phase_b4(rng, timed: list, floor_ms: float, lossy: dict) -> dict:
    """B4 at the wire shape and the stripe: ``ed_gf_parity`` in a graph
    beside the launch floor, its bound and the plain version; the stripe
    on one input set (in L2) and rotating through ``GF_STRIPE_SETS``
    (from HBM); the FEC leg alone (``fec_leg_ms``), with the kernel's
    share of it, and in phase 7d's server."""
    rows = {k["_shape"]: k for k in timed if k["name"] == "ed_gf_parity"}
    leg = fec_leg_ms(rng)
    server = lossy["server_stats"]["fec"]
    res = {"launch_floor_ms": floor_ms, "leg_alone": leg,
           "leg_7d": {k: server[k] for k in (
               "device_passes", "stage_ms_per_window",
               "kernel_ms_per_window", "oracle_ms_per_window")},
           "rows": [{"shape": k["_shape"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "bound_share": k["_bound_share"],
                     "gb_per_s": k["_gb_per_s"],
                     "call_ms": k["_wrapper_call_ms"],
                     "launches": k["launches"]} for k in rows.values()]}
    for k in res["rows"]:
        log(f"[b4] ed_gf_parity at {k['shape']}: {k['ms']:.6f} ms in a "
            f"graph ({k['ms'] / floor_ms:.2f}x the {floor_ms:.6f} ms launch "
            f"floor; {k['bound_share']:.1%} of the {k['bound_ms']:.6f} ms "
            f"bound by {k['bound_by']}, {k['gb_per_s']:.1f} GB/s), "
            f"{k['call_ms']:.6f} ms a direct call, plain (log/antilog "
            f"gathers in torch ops) {k['plain_ms']:.6f} ms; {k['launches']} "
            f"main-path launches")
    wire = rows[f"[{GF_WIRE[0]},{GF_WIRE[1]}]x[{GF_WIRE[2]},{GF_WIRE[0]}]"]
    leg_ms = leg["stage_ms_per_pass"] + leg["kernel_ms_per_pass"]
    res["kernel_share_of_leg"] = wire["ms"] / leg_ms
    log(f"[b4] the FEC leg alone at the wire shape ({leg['passes']} passes "
        f"of StreamFec._device_parity): staging + H2D "
        f"{leg['stage_ms_per_pass']:.6f} ms, kernel + D2H "
        f"{leg['kernel_ms_per_pass']:.6f} ms a pass, the host oracle "
        f"{leg['oracle_ms_per_pass']:.6f}; the kernel's {wire['ms']:.6f} ms "
        f"is {res['kernel_share_of_leg']:.2%} of the device leg; in phase "
        f"7d's server {server['stage_ms_per_window']:.6f} + "
        f"{server['kernel_ms_per_window']:.6f} ms a window, oracle "
        f"{server['oracle_ms_per_window']:.6f}")
    return res


#: per (output, packet) header of B9: the seq and ts adds and masks, 10
#: byte extractions, the eligibility compare and the mask
OPS_PER_BATCH_HEADER = 16


def b9_bound(p: int, s: int) -> tuple[int, int]:
    """(bytes, operations) of one B9 pass: 96-byte rows, lengths, ages,
    state and buckets read once; headers, mask, the two flag rows and the
    newest keyframe written once."""
    return (96 * p + 8 * p + 28 * s + 13 * s * p + 2 * p + 4,
            OPS_PER_PACKET * p + OPS_PER_BATCH_HEADER * s * p)


def batch_leg_ms(rng, n_pkts: int, n_subs: int) -> dict:
    """The engine's batch leg alone, in this process and away from any
    server's load: ``FanoutEngine._batch_headers`` over the newest
    ``n_pkts`` packets of a ring of paced 1080p-sized packets for
    ``n_subs`` outputs (pinned staging, one upload, ONE ed_relay_batch,
    the headers copied back and their event waited on), held against the
    CPU call; host ms a pass from the engine's own two counters."""
    import numpy as np
    import torch
    from easydarwin_tpu_torch.ops import fanout
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
    from easydarwin_tpu_torch.utils import synth
    from easydarwin_tpu_torch.utils.loopback import VIDEO_SDP
    stream = RelayStream(sdp.parse(VIDEO_SDP).streams[0], StreamSettings())
    t = 5000
    for i, pkt in enumerate(synth.paced_gop(
            rng, seq0=65500, ts0=0xFFFFF000, ssrc=0x77, frames=30,
            packets_per_frame=13, body_len=(1270, 1300))):
        stream.push_rtp(pkt, t + i // 13 * 33)
    ring = stream.rtp_ring
    now = t + 30 * 33
    ids = np.arange(ring.head - n_pkts, ring.head)
    idx = ids % ring.capacity
    lengths = ring.length[idx].astype(np.int32)
    ages = (now - ring.arrival[idx]).astype(np.int32)
    batch = [(CollectingOutput(ssrc=int(rng.integers(1 << 32)),
                               out_seq_start=int(rng.integers(1 << 16)),
                               out_ts_start=int(rng.integers(1 << 32))),
              i // 4) for i in range(n_subs)]
    for out, _ in batch:
        out.rewrite.base_src_seq = int(ring.seq[idx[0]])
        out.rewrite.base_src_ts = int(ring.timestamp[idx[0]])
    eng = FanoutEngine(device=DEVICE)
    want = fanout.relay_batch_step(*[torch.from_numpy(a) for a in (
        ring.data[idx, :96], lengths, ages,
        fanout.pack_output_state([o for o, _ in batch]),
        np.array([b for _, b in batch], np.int32))], 60)["headers"].numpy()
    for i in range(53):
        if i == 3:                              # after the warm-up
            eng.batch_stage_ns = eng.batch_kernel_ns = 0
        got = eng._batch_headers(ring, idx, lengths, ages, batch, 60)
        check(np.array_equal(got, want),
              "the engine's batch leg differs from the CPU call")
    return {"packets": n_pkts, "outputs": n_subs, "passes": 50,
            "stage_ms_per_pass": eng.batch_stage_ns / 50 / 1e6,
            "kernel_ms_per_pass": eng.batch_kernel_ns / 50 / 1e6}


def phase_batch_step(rng, shapes, timed: list, servers: dict
                     ) -> list[dict]:
    """B9 at each ``(label, P, S)``: ``relay_batch_step`` on CUDA tensors
    (one ``ed_relay_batch`` launch) against the same call on CPU tensors,
    every key bit-exact; beside phase 10's times of the kernel in a graph,
    the direct call and the plain version in a graph, the bound, the CPU
    call on the host clock and the engine's batch leg on the host clock
    (host ms a pass in phases 7c and 7d's servers, and ``batch_leg_ms`` at
    this shape in this process)."""
    import torch
    from easydarwin_tpu_torch.ops import fanout
    legs = {name: {"passes": st["batch_passes"],
                   "stage_ms_per_pass": st["batch_stage_ms_per_pass"],
                   "kernel_ms_per_pass": st["batch_kernel_ms_per_pass"]}
            for name, st in servers.items()}
    out = []
    for label, p, s in shapes:
        legs["in-process"] = batch_leg_ms(rng, p, s)
        leg_txt = "; ".join(
            f"{name} {v['stage_ms_per_pass']:.6f} staging + H2D, "
            f"{v['kernel_ms_per_pass']:.6f} kernel + D2H over {v['passes']} "
            f"passes" for name, v in legs.items())
        cpu = [torch.from_numpy(a) for a in b9_arrays(rng, p, s)]
        dev = [t.cuda() for t in cpu]
        want = fanout.relay_batch_step(*cpu, 73)
        b9_diff(fanout.relay_batch_step(*dev, 73), want,
                f"relay_batch_step {label} on the card vs the CPU")
        samples = []
        for _ in range(21):
            t0 = time.perf_counter()
            fanout.relay_batch_step(*cpu, 73)
            samples.append((time.perf_counter() - t0) * 1e3)
        samples.sort()
        k = next(t for t in timed if t["name"] == "ed_relay_batch"
                 and t["_shape"] == f"P={p} S={s}")
        row = {"shape": f"{label}: P={p} S={s}", "ms": k["ms"],
               "call_ms": k["_wrapper_call_ms"],
               "wrapper_graph_ms": k["_wrapper_graph_ms"],
               "plain_ms": k["plain_ms"], "plain_cpu_ms": samples[10],
               "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
               "launches": k["launches"], "engine_leg_host_ms": dict(legs)}
        log(f"[b9] relay_batch_step at {row['shape']}: bit-exact against "
            f"the CPU call on every key; ed_relay_batch {row['ms']:.6f} ms "
            f"in a graph, {row['call_ms']:.6f} ms a direct call, plain "
            f"(K1 + torch ops) {row['plain_ms']:.6f} ms in a graph, bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}, CPU "
            f"{row['plain_cpu_ms']:.6f} ms; {row['launches']} main-path "
            f"launches; the engine's batch leg, host ms a pass: {leg_txt}")
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
    if sys.argv[1:] == ["--hls-control"]:
        return hls_control()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    import numpy as np
    from easydarwin_tpu_torch import native
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops.transform_kernel import ring_geometry

    os.makedirs(OUT_DIR, exist_ok=True)
    rng = np.random.default_rng(20261016)
    detail: dict = {}
    t_script = time.monotonic()

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

    detail["ptxas"] = ptxas_report(detail["build"]["log"])
    detail["k1"] = phase_k1(rng)
    detail["relay_geometry"] = relay_geometry()
    log(f"[window] library geometry {detail['relay_geometry']} = the Python "
        f"launch plans")
    detail["window"] = phase_window(rng)
    detail["window_vod"] = phase_window_vod(rng, detail["ptxas"])
    detail["ring"] = phase_ring_query(rng)
    detail["gf"] = phase_gf(rng)
    detail["b9"] = phase_b9(rng)
    levels, qt = config5_levels(int(rng.integers(1 << 31)))
    detail["k2_ring"] = ring_geometry()
    log(f"[k2] ring: {detail['k2_ring']}")
    detail["k2"] = phase_k2(levels, qt, detail["k2_ring"])
    detail["b7_check"] = phase_b7_check(rng, levels)
    detail["b6"], b6_inputs = phase_h264(rng)

    kernel_lib.reset_launch_counts()           # the main path starts here
    detail["scheduler"] = phase_scheduler(rng)
    detail["native"] = phase_config4_native(rng, detail["scheduler"])
    detail["server"] = phase_server(rng)
    detail["config2"] = phase_config2(rng)
    detail["rtcp"] = phase_rtcp(rng)
    detail["lossy"] = phase_lossy(rng)
    detail["udp_push"] = phase_udp_push(rng)
    detail["pipeline"] = phase_pipeline(levels)
    detail["ladder"] = phase_ladder(rng)
    in_proc = dict(kernel_lib.LAUNCHES)
    servers = [detail[p]["server_stats"]["kernel_launches"]
               for p in ("server", "config2", "rtcp", "lossy", "udp_push",
                         "ladder")]
    launches = {k: in_proc[k] + sum(s.get(k, 0) for s in servers)
                for k in in_proc}
    log(f"[main path] kernel launches {launches} (in-process {in_proc}, "
        f"servers {servers})")
    for k, n in launches.items():
        check(n > 0 or k in HLS_KERNELS or k in MODULE_KERNELS,
              f"kernel {k} was not launched on the main path")

    clips = vod_clips(int(rng.integers(1 << 31)))
    kernel_lib.reset_launch_counts()           # the VOD path starts here
    tiers0 = tier_totals()
    detail["vod"] = phase_vod(clips)
    detail["vod_server"] = phase_vod_server(clips, rng)
    vod_in_proc = dict(kernel_lib.LAUNCHES)
    vod_srv = detail["vod_server"]["kernel_launches"]
    vod_launches = {k: vod_in_proc[k] + vod_srv.get(k, 0)
                    for k in vod_in_proc}
    log(f"[vod path] kernel launches {vod_launches} (in-process "
        f"{vod_in_proc}, server {vod_srv})")
    check(vod_launches["ed_relay_window"] > 0,
          "ed_relay_window was not launched on the VOD path")
    detail["vod_path_launches"] = vod_launches
    launches = {k: n + vod_launches[k] for k, n in launches.items()}

    kernel_lib.reset_launch_counts()           # the DVR path starts here
    detail["dvr"] = phase_dvr(rng)
    dvr_in_proc = dict(kernel_lib.LAUNCHES)
    dvr_launches = {k: dvr_in_proc[k] + detail["dvr"]["kernel_launches"]
                    .get(k, 0) for k in dvr_in_proc}
    log(f"[dvr path] kernel launches {dvr_launches} (in-process "
        f"{dvr_in_proc}, servers {detail['dvr']['kernel_launches']})")
    for k in ("ed_relay_window", "ed_gf_parity"):
        check(dvr_launches[k] > 0, f"{k} was not launched on the DVR path")
    detail["dvr_path_launches"] = dvr_launches
    launches = {k: n + dvr_launches[k] for k, n in launches.items()}
    stripe_shapes = detail["dvr"]["shapes"]

    kernel_lib.reset_launch_counts()           # the HLS path starts here
    detail["hls"] = phase_hls(rng)
    hls_in_proc = dict(kernel_lib.LAUNCHES)
    hls_srv = detail["hls"]["server_stats"]["kernel_launches"]
    hls_launches = {k: hls_in_proc[k] + hls_srv.get(k, 0)
                    for k in hls_in_proc}
    log(f"[hls path] kernel launches {hls_launches} (in-process "
        f"{hls_in_proc}, server {hls_srv})")
    for k in HLS_KERNELS:
        check(hls_launches[k] > 0, f"{k} was not launched on the HLS path")
    detail["hls_path_launches"] = hls_launches
    launches = {k: n + hls_launches[k] for k, n in launches.items()}
    detail["tiers"] = tier_check(tiers0, [
        detail["vod_server"]["server_stats"], detail["dvr"]["server_a"],
        detail["dvr"]["server_b"], detail["hls"]["server_stats"]])

    t_1080 = time.monotonic()
    sources_1080, prepared_1080, enc_s = prepare_1080(rng)
    kernel_lib.reset_launch_counts()     # the 1080p HLS path starts here
    detail["hls_1080p"] = phase_hls_1080(rng, sources_1080, prepared_1080)
    h1080_in_proc = dict(kernel_lib.LAUNCHES)
    h1080_srv = detail["hls_1080p"]["server_stats"]["kernel_launches"]
    h1080_launches = {k: h1080_in_proc[k] + h1080_srv.get(k, 0)
                      for k in h1080_in_proc}
    log(f"[hls 1080p path] kernel launches {h1080_launches} (in-process "
        f"{h1080_in_proc}, server {h1080_srv})")
    for k in HLS_KERNELS:
        check(h1080_launches[k] > 0,
              f"{k} was not launched on the 1080p HLS path")
    detail["hls_1080p"]["encode_s"] = enc_s
    detail["hls_1080p_path_launches"] = h1080_launches
    launches = {k: n + h1080_launches[k] for k, n in launches.items()}
    detail["walk_decision"] = phase_walk_decision(sources_1080,
                                                  prepared_1080)
    del prepared_1080
    new_phases_s = time.monotonic() - t_1080

    t_mesh = time.monotonic()
    detail["mesh"] = phase_mesh(rng)           # the mesh path, then B8's
    for part in ("path_launches", "b8_launches"):
        launches = {k: n + detail["mesh"][part][k]
                    for k, n in launches.items()}
    for name, run, kernels in (
            ("wheel", lambda: phase_wheel(rng), ("ed_ring_query",)),
            ("pairs", lambda: phase_udp_pairs(
                rng, detail["config2"]["server_stats"]), ("ed_ring_query",)),
            ("closed_loop", phase_closed_loop, HLS_KERNELS)):
        kernel_lib.reset_launch_counts()       # each path starts here
        detail[name] = run()
        path = dict(kernel_lib.LAUNCHES)
        log(f"[{name} path] kernel launches {path}")
        for k in kernels:
            check(path[k] > 0, f"{k} was not launched on the {name} path")
        detail[f"{name}_path_launches"] = path
        launches = {k: n + path.get(k, 0) for k, n in launches.items()}
    mesh_phases_s = time.monotonic() - t_mesh

    kernel_lib.reset_launch_counts()           # the surface path starts here
    detail["surface"] = phase_surface(rng, smi, detail["config2"])
    surface_path = {k: n + detail["surface"]["a_stats"]["kernel_launches"]
                    .get(k, 0) + detail["surface"]["b_stats"]
                    ["kernel_launches"].get(k, 0)
                    for k, n in kernel_lib.LAUNCHES.items()}
    log(f"[surface path] kernel launches {surface_path}")
    detail["surface_path_launches"] = surface_path
    launches = {k: n + surface_path.get(k, 0) for k, n in launches.items()}

    kernel_lib.reset_launch_counts()       # the observed path starts here
    detail["observed"] = phase_observed(smi)
    observed_path = {k: n + detail["observed"]["path_launches"].get(k, 0)
                     for k, n in kernel_lib.LAUNCHES.items()}
    log(f"[observed path] kernel launches {observed_path}")
    check(observed_path["ed_relay_window"] > 0,
          "ed_relay_window was not launched on the observed path")
    detail["observed_path_launches"] = observed_path
    launches = {k: n + observed_path.get(k, 0) for k, n in launches.items()}

    kernel_lib.reset_launch_counts()         # the chaos path starts here
    detail["chaos"] = phase_chaos(smi)
    chaos_path = dict(kernel_lib.LAUNCHES)
    log(f"[chaos path] kernel launches {chaos_path}")
    check(chaos_path["ed_relay_window"] > 0,
          "ed_relay_window was not launched on the chaos path")
    detail["chaos_path_launches"] = chaos_path
    launches = {k: n + chaos_path.get(k, 0) for k, n in launches.items()}

    kernel_lib.reset_launch_counts()       # the cluster path starts here
    detail["cluster"] = phase_cluster(smi)
    cluster_path = {k: n + detail["cluster"]["kernel_launches"].get(k, 0)
                    for k, n in kernel_lib.LAUNCHES.items()}
    log(f"[cluster path] kernel launches {cluster_path}")
    check(cluster_path["ed_relay_window"] > 0,
          "ed_relay_window was not launched on the cluster path")
    detail["cluster_path_launches"] = cluster_path
    launches = {k: n + cluster_path.get(k, 0) for k, n in launches.items()}

    kernel_lib.reset_launch_counts()   # the cluster's DVR path starts here
    detail["cluster_dvr"] = phase_cluster_dvr(smi)
    cluster_dvr_path = dict(kernel_lib.LAUNCHES)
    log(f"[cluster-dvr path] kernel launches {cluster_dvr_path}")
    for k in ("ed_relay_window", "ed_gf_parity"):
        check(cluster_dvr_path[k] > 0,
              f"{k} was not launched on the cluster's DVR path")
    detail["cluster_dvr_path_launches"] = cluster_dvr_path
    launches = {k: n + cluster_dvr_path.get(k, 0)
                for k, n in launches.items()}

    kernel_lib.reset_launch_counts()           # the keys' path starts here
    detail["keys"] = phase_keys(smi)
    keys_path = {k: n + detail["keys"]["path_launches"].get(k, 0)
                 for k, n in kernel_lib.LAUNCHES.items()}
    log(f"[keys path] kernel launches {keys_path}")
    for k in ("ed_ring_query", "ed_relay_batch", "ed_relay_window"):
        check(keys_path[k] > 0, f"{k} was not launched on the keys' path")
    detail["keys_path_launches"] = keys_path
    launches = {k: n + keys_path.get(k, 0) for k, n in launches.items()}

    errs = {"ed_parse_packets": max(detail["k1"].values()),
            "ed_relay_window": max(
                [*detail["window"].values()]
                + [v["max_abs_err"] for v in detail["window_vod"].values()
                   if isinstance(v, dict)]),
            "ed_ring_query": max(detail["ring"].values()),
            "ed_decode_blocks": max(v["max_abs_err"]
                                    for v in detail["k2"].values()),
            "ed_gf_parity": max(detail["gf"]["max_abs_err"],
                                gf_storage_check(rng, stripe_shapes)),
            "ed_relay_batch": max(detail["b9"].values()),
            "ed_requant_rungs": max(detail["b7_check"].values()),
            "ed_h264_requant": max(detail["b6"]["max_abs_err"],
                                   detail["b6"]["max_abs_err_cpu"],
                                   detail["b6"]["edge_max_abs_err"],
                                   detail["b6"]["leg"]["max_abs_err"])}
    errs["ed_h264_requant_chroma"] = errs["ed_h264_requant"]
    errs["ed_relay_shard"] = detail["mesh"]["max_abs_err"]
    detail["launch_floor_ms"] = launch_floor_ms()
    log(f"[kernels] launch floor: {detail['launch_floor_ms']:.6f} ms per "
        f"graph node (ed_launch_floor, an empty kernel)")
    for name, rep in detail["ptxas"].items():
        log(f"[kernels] ptxas {name}: {rep}")
    detail["card_state"] = state = card_state()
    log(f"[kernels] before the timings: processes on the card "
        f"{state['apps']!r}; clocks, temperature, power, throttle "
        f"{state['gpu']!r}; {len(state['threads'])} threads "
        f"{state['threads']}; launches by other threads in a second "
        f"{state['launches_in_a_second']}")
    rtcp_st = detail["rtcp"]["server_stats"]
    b9_p = -(-rtcp_st["batch_rows"] // max(rtcp_st["batch_passes"], 1))
    b9_s = sum(1 for pl in RTCP_PLAYERS if pl["meta"] or pl["lossy"])
    timed = phase_kernels(rng, launches, errs, levels, qt, (b9_p, b9_s),
                          prime_window_specs(detail["vod"]["prime_shapes"]),
                          stripe_shapes, b6_cases(b6_inputs))
    detail["kernels"] = timed
    observed_device_check(detail["observed"], timed)
    detail["join_query"] = join = join_query_ms(rng)
    ring_ms = next(k["ms"] for k in timed if k["name"] == "ed_ring_query"
                   and k["_main_path"])
    log(f"[kernels] the engine's join query (pack + upload + ed_ring_query "
        f"+ readback + oracle, _device_params) at C={RING_C} "
        f"S={join['subscribers']}: host ms p50 {join['host_ms_p50']:.6f} "
        f"(min {join['host_ms_min']:.6f}, max {join['host_ms_max']:.6f}); "
        f"the kernel's {ring_ms:.6f} ms is "
        f"{ring_ms / join['host_ms_p50']:.2%} of it")
    detail["batch_step"] = phase_batch_step(
        rng, (("phase 7c", b9_p, b9_s), ("config 4", 256, 256)), timed,
        {"7c": rtcp_st, "7d": detail["lossy"]["server_stats"]})
    detail["b7"] = phase_b7(timed, detail["pipeline"])
    detail["b4"] = phase_b4(rng, timed, detail["launch_floor_ms"],
                            detail["lossy"])
    detail["b6_timing"] = phase_b6(b6_inputs, timed,
                                   detail["launch_floor_ms"],
                                   detail["hls"]["server_stats"]["hls"])
    del b6_inputs
    caps = native.uring_probe()
    detail["uring"] = {"probe": caps, "answer": native.describe_uring(caps)}
    kernels = [{k: v for k, v in t.items() if not k.startswith("_")}
               for t in timed if t["_main_path"]]
    for k in timed:
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.6f} ms")
        log(f"[kernels] {k['name']} at {k['_shape']} ({k['_where']}): "
            f"{k['ms']:.6f} ms, {k['ms'] / detail['launch_floor_ms']:.2f}x "
            f"the launch floor (plain "
            f"{k['plain_ms']:.6f} ms, bound {k['bound_ms']:.6f} ms by "
            f"{k['bound_by']}{lib}), {k['_gb_per_s']:.1f} GB/s, "
            f"{k['_bound_share']:.1%} of the bound, wrapper "
            f"{k['_wrapper_graph_ms']:.6f} "
            f"ms in a graph, {k['_wrapper_call_ms']:.6f} ms per direct "
            f"call; {k['launches']} main-path launches")
    script_s = time.monotonic() - t_script
    detail["seconds"] = {"script": script_s, "phases_13b_13c": new_phases_s,
                         "phases_6c_7f_7g_13d": mesh_phases_s,
                         "phase_14": detail["surface"]["seconds"],
                         "phase_15": detail["observed"]["seconds"],
                         "phase_16": detail["chaos"]["seconds"],
                         "phase_17": detail["cluster"]["seconds"],
                         "phase_17b": detail["cluster_dvr"]["seconds"],
                         "phase_18": detail["keys"]["seconds"]}
    log(f"[time] the script {script_s:.3f} s from its build; phases 13c "
        f"and 13b (the 1080p pictures' encode included) {new_phases_s:.3f}"
        f" s of it, phases 6c, 7f, 7g and 13d {mesh_phases_s:.3f} s, phase "
        f"14 {detail['surface']['seconds']:.3f} s, phase 15 "
        f"{detail['observed']['seconds']:.3f} s, phase 16 "
        f"{detail['chaos']['seconds']:.3f} s, phase 17 "
        f"{detail['cluster']['seconds']:.3f} s, phase 17b "
        f"{detail['cluster_dvr']['seconds']:.3f} s, phase 18 "
        f"{detail['keys']['seconds']:.3f} s, the rest "
        f"{script_s - new_phases_s - mesh_phases_s - sum(detail[p]['seconds'] for p in ('surface', 'observed', 'chaos', 'cluster', 'cluster_dvr', 'keys')):.3f} s; "
        f"card {smi}")
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(f"[uring] ed_uring_probe on this host: {caps} "
        f"({detail['uring']['answer']})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
