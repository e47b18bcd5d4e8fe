"""The port's fan-out ops, window pass, batch-header step (B9), pipeline
and staging ≡ the JAX package's, bit-exact, on the same numpy inputs (CPU
tensors: the plain PyTorch versions the kernel wrappers run off the
card)."""

from collections import Counter

import numpy as np
import pytest
import torch

from easydarwin_tpu.models import relay_pipeline as ref_pipe
from easydarwin_tpu.ops import fanout as ref_fanout
from easydarwin_tpu.ops import staging as ref_staging
from easydarwin_tpu.ops.parse import parse_packets as ref_parse
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.ring import PacketRing as RefRing
from easydarwin_tpu_torch import convert
from easydarwin_tpu_torch.models import relay_pipeline as pipe
from easydarwin_tpu_torch.ops import fanout, kernel_lib, staging
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.utils import synth


def _state(rng, b, s):
    """Random rewrite state: uint32 everywhere, so seq0 < base_seq and
    ts0 < base_ts (the wrap cases) are common."""
    return rng.integers(0, 1 << 32, size=(b, s, 6),
                        dtype=np.uint64).astype(np.uint32)


def _bucket(rng, b_real=5, b_pad=8, p=16, s_real=5, s_pad=8, w=100):
    """A ragged bucket: b_real streams with 1..p live rows, zero padding
    rows and streams; the last stream carries no keyframe at all.  Columns
    past the le32 length (``w`` > 100) hold random bytes."""
    win = np.zeros((b_pad, p, w), np.uint8)
    win[:, :, 100:] = rng.integers(0, 256, (b_pad, p, w - 100), dtype=np.uint8)
    for i in range(b_real):
        n = int(rng.integers(1, p + 1))
        if i == b_real - 1:
            pkts = [synth.h264_packet(j, 90 * j, 1, ssrc=7, body=b"x" * 30)
                    for j in range(n)]
        else:
            pkts = [synth.random_packet(rng) for _ in range(n)]
        pre, ln = synth.stage(pkts)
        win[i, :n, :100] = fanout.pack_window(pre, ln)
    st = np.zeros((b_pad, s_pad, 6), np.uint32)
    st[:b_real, :s_real] = _state(rng, b_real, s_real)
    return win, st


def test_window_pass_matches_megabatch_window_step():
    rng = np.random.default_rng(42)
    for _ in range(3):
        win, st = _bucket(rng)
        ref = np.asarray(ref_pipe.megabatch_window_step(win.copy(), st))
        out = pipe.megabatch_window_step(torch.from_numpy(win),
                                         convert.state_from_numpy(st, "cpu"))
        assert out.dtype == torch.uint32
        np.testing.assert_array_equal(out.numpy(), ref)
        kf = out.numpy()[:, -1].astype(np.int32)
        assert kf[4] == -1 and kf[5:].tolist() == [-1, -1, -1]
        np.testing.assert_array_equal(
            fanout.relay_affine_step_window(torch.from_numpy(win),
                                            torch.from_numpy(st)).numpy(),
            np.asarray(ref_fanout.relay_affine_step_window(win, st)))


#: grouped wakes as (b_real, b_pad, P, s_real, s_pad, W) buckets: the
#: scheduler's config-4 wake (6 vs 20 new packets a stream), a prime beside
#: a ragged bucket and a MAX_STAGE_ROWS one, ragged P, wide rows
WINDOW_GROUPS = {
    "wake_16_32": [(8, 8, 16, 256, 256, 100), (8, 8, 32, 256, 256, 100)],
    "mixed": [(1, 1, 16, 8, 8, 100), (5, 8, 64, 13, 16, 100),
              (16, 16, 1024, 8, 8, 100)],
    "ragged_p13": [(3, 4, 13, 5, 8, 100)],
    "w104": [(4, 4, 32, 6, 8, 104), (2, 2, 16, 3, 8, 104)],
}


@pytest.mark.parametrize("group", sorted(WINDOW_GROUPS))
def test_grouped_window_passes_match_reference(group):
    rng = np.random.default_rng(sorted(WINDOW_GROUPS).index(group) + 70)
    buckets = [_bucket(rng, *spec) for spec in WINDOW_GROUPS[group]]
    outs = pipe.megabatch_window_steps(
        [(torch.from_numpy(w), torch.from_numpy(s)) for w, s in buckets])
    assert len(outs) == len(buckets)
    for (win, st), out in zip(buckets, outs):
        ref = np.asarray(ref_pipe.megabatch_window_step(win.copy(), st))
        assert out.dtype == torch.uint32
        np.testing.assert_array_equal(out.numpy(), ref)


def _bucket_of_cluster(first_cluster, cluster_id):
    """The kernel's scan: the last bucket whose first cluster is <= id."""
    k = 0
    while k + 1 < len(first_cluster) and cluster_id >= first_cluster[k + 1]:
        k += 1
    return k


def test_window_launch_plan_covers_every_row_once():
    shapes = [(8, 16, 100, 256), (8, 32, 100, 256), (1, 16, 100, 8),
              (8, 64, 100, 16), (16, 1024, 100, 8), (4, 13, 100, 5),
              (0, 16, 100, 8), (4, 32, 104, 8)]
    addrs = [0x10000, 0x20003, 0x3000F, 0x40001, 0x50000, 0x60007, 0x70000,
             0x80009]
    (plan,) = fanout.window_launch_plan(shapes, addrs)
    assert plan.cluster == fanout.cluster_size(1024) == 8
    assert 6 not in plan.buckets                 # no stream row, no CTA
    rows, subs = Counter(), Counter()
    clusters = set()
    for cta in plan.ctas():
        b_n, p, w, s = shapes[cta.bucket]
        lo, hi = cta.rows
        assert cta.head + cta.interior + cta.tail == (hi - lo) * w
        assert cta.addr == addrs[cta.bucket] + (cta.stream * p + lo) * w
        if cta.interior:
            assert (cta.addr + cta.head) % 16 == 0 and cta.interior % 16 == 0
            assert cta.head < 16 and cta.tail < 16
        else:
            assert cta.head <= 30 and cta.tail == 0
        assert (cta.addr % 16) + (hi - lo) * w <= plan.smem_bytes
        k = _bucket_of_cluster(plan.first_cluster, cta.cluster_id)
        assert plan.buckets[k] == cta.bucket
        clusters.add(cta.cluster_id)
        rows.update((cta.bucket, cta.stream, q) for q in range(lo, hi))
        subs.update((cta.bucket, cta.stream, q) for q in range(*cta.subs))
    assert plan.smem_bytes <= kernel_lib.DYN_SMEM_LIMIT
    assert clusters == set(range(sum(b for b, _p, _w, _s in shapes)))
    live = [i for i, sh in enumerate(shapes) if sh[0]]
    assert rows == Counter((i, b, q) for i in live
                           for b in range(shapes[i][0])
                           for q in range(shapes[i][1]))
    assert subs == Counter((i, b, q) for i in live
                           for b in range(shapes[i][0])
                           for q in range(shapes[i][3]))
    # a small launch keeps one CTA per stream row
    assert fanout.window_launch_plan(shapes[:2], addrs[:2])[0].cluster == 1
    # more buckets than the kernel takes: split, in order
    many = [(1, 16, 100, 8)] * (2 * fanout.WINDOW_MAX_BUCKETS + 1)
    plans = fanout.window_launch_plan(many, [1600 * i + 5 for i in range(65)])
    assert [len(pl.buckets) for pl in plans] == [32, 32, 1]
    assert [i for pl in plans for i in pl.buckets] == list(range(65))
    assert all(pl.first_cluster == tuple(range(len(pl.buckets)))
               for pl in plans)
    with pytest.raises(ValueError):              # 512 rows a CTA: too wide
        fanout.window_launch_plan([(1, 4096, 100, 8)], [0])


def test_window_length_column_wraps_like_int32_cast():
    win = np.zeros((1, 2, 100), np.uint8)
    win[0, 0, 96:100] = [0xFF, 0xFF, 0xFF, 0xFF]    # 0xFFFFFFFF → -1
    win[0, 1, 96:100] = [20, 0, 0, 0]
    got = fanout.window_lengths(torch.from_numpy(win))
    assert got.tolist() == [[-1, 20]]
    st = np.zeros((1, 8, 6), np.uint32)
    np.testing.assert_array_equal(
        fanout.relay_affine_step_window(torch.from_numpy(win),
                                        torch.from_numpy(st)).numpy(),
        np.asarray(ref_fanout.relay_affine_step_window(win, st)))


def test_window_pass_rejects_bad_shapes():
    with pytest.raises(ValueError):
        fanout.relay_affine_step_window(torch.zeros((2, 4, 99), dtype=torch.uint8),
                                        torch.zeros((2, 8, 6), dtype=torch.uint32))
    with pytest.raises(ValueError):
        fanout.relay_affine_step_window(torch.zeros((2, 4, 100), dtype=torch.uint8),
                                        torch.zeros((3, 8, 6), dtype=torch.uint32))


def test_affine_step_single_and_packed_match_reference():
    rng = np.random.default_rng(8)
    pkts = [synth.random_packet(rng) for _ in range(3 * 32)]
    pre, ln = synth.stage(pkts)
    st = _state(rng, 3, 8)
    ref = ref_fanout.relay_affine_step(pre[:32], ln[:32], st[0])
    out = fanout.relay_affine_step(torch.from_numpy(pre[:32]),
                                   torch.from_numpy(ln[:32]),
                                   torch.from_numpy(st[0]))
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(v),
                                      err_msg=k)
    ref_p = np.asarray(ref_fanout.relay_affine_step_packed(
        pre.reshape(3, 32, 96), ln.reshape(3, 32), st))
    out_p = fanout.relay_affine_step_packed(
        torch.from_numpy(pre.reshape(3, 32, 96)),
        torch.from_numpy(ln.reshape(3, 32)), torch.from_numpy(st))
    np.testing.assert_array_equal(out_p.numpy(), ref_p)
    for a, b in zip(fanout.unpack_affine(out_p.numpy(), 8),
                    ref_fanout.unpack_affine(ref_p, 8)):
        np.testing.assert_array_equal(a, b)


def test_fanout_headers_and_eligibility_match_reference():
    rng = np.random.default_rng(3)
    pkts = [synth.random_packet(rng) for _ in range(40)]
    pkts = [p for p in pkts if len(p) >= 12]
    pre, ln = synth.stage(pkts)
    rf = ref_parse(pre, ln)
    st = _state(rng, 1, 11)[0]
    ref = np.asarray(ref_fanout.fanout_headers(pre[:, :2], rf["seq"],
                                               rf["timestamp"], st))
    out = fanout.fanout_headers(torch.from_numpy(pre[:, :2]),
                                torch.from_numpy(np.array(rf["seq"])),
                                torch.from_numpy(np.array(rf["timestamp"])),
                                torch.from_numpy(st))
    np.testing.assert_array_equal(out.numpy(), ref)
    age = rng.integers(0, 400, 40).astype(np.int32)
    buckets = np.arange(6, dtype=np.int32)
    np.testing.assert_array_equal(
        fanout.eligibility(torch.from_numpy(age), torch.from_numpy(buckets),
                           73).numpy(),
        np.asarray(ref_fanout.eligibility(age, buckets, 73)))


def test_pack_output_state_and_pack_window_match_reference():
    rng = np.random.default_rng(2)
    kw = [dict(ssrc=int(rng.integers(1 << 32)),
               out_seq_start=int(rng.integers(1 << 16)),
               out_ts_start=int(rng.integers(1 << 32))) for _ in range(6)]
    ref_outs = [RefOutput(**k) for k in kw]
    outs = [CollectingOutput(**k) for k in kw]
    for i, (a, b) in enumerate(zip(ref_outs, outs)):
        if i % 2:
            a.rewrite.base_src_seq = b.rewrite.base_src_seq = 65000 + i
            a.rewrite.base_src_ts = b.rewrite.base_src_ts = 4_000_000_000 + i
        if i == 3:
            a.interleave_chan = b.interleave_chan = 6
    np.testing.assert_array_equal(fanout.pack_output_state(outs),
                                  ref_fanout.pack_output_state(ref_outs))
    pre, ln = synth.stage([synth.random_packet(rng) for _ in range(10)])
    np.testing.assert_array_equal(fanout.pack_window(pre, ln),
                                  ref_fanout.pack_window(pre, ln))


@pytest.mark.parametrize("mode", ["affine", "headers"])
def test_pipeline_with_k1_matches_reference_pipeline(mode):
    rng = np.random.default_rng(17 if mode == "affine" else 18)
    P, S = 32, 8
    pkts = [synth.random_packet(rng) for _ in range(P - 4)]
    pre, ln = synth.stage(pkts)
    pre = np.concatenate([pre, np.zeros((4, 96), np.uint8)])
    ln = np.concatenate([ln, np.zeros(4, np.int32)])
    age = rng.integers(0, 12_000, P).astype(np.int32)
    st = _state(rng, 1, S)[0]
    buckets = rng.integers(0, 4, S).astype(np.int32)
    cfg = dict(use_pallas_parse=True, mode=mode)
    ref = ref_pipe.RelayPipeline(ref_pipe.RelayPipelineConfig(**cfg))(
        pre, ln, age, st, buckets)
    out = pipe.RelayPipeline(pipe.RelayPipelineConfig(**cfg), device="cpu")(
        pre, ln, age, st, buckets)
    assert set(out) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(v),
                                      err_msg=k)


def test_scatter_affine_segments_matches_reference():
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 1 << 32, size=(4, 4 * 8 + 1),
                          dtype=np.uint64).astype(np.uint32)
    packed[2, -1] = 0xFFFFFFFF
    ref = ref_pipe.scatter_affine_segments(packed, [8, 3, 5])
    out = pipe.scatter_affine_segments(torch.from_numpy(packed), [8, 3, 5])
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
        assert a[4] == b[4]
    assert out[2][4] == -1


def _rings(capacity=64, n=100, seed=9):
    rng = np.random.default_rng(seed)
    ref = RefRing(capacity, is_video=True)
    for i in range(n):
        body = bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                  dtype=np.uint8))
        if i % 17 == 5:
            pkt = body[:7]                                  # runt
        else:
            pkt = synth.h264_packet(i, 3000 * i, 5 if i % 30 == 0 else 1,
                                    ssrc=1, body=body)
        ref.push(pkt, 1000 + i)
    port = convert.ring_from_arrays(ref.data, ref.length, ref.arrival,
                                    ref.seq, ref.timestamp, ref.flags,
                                    ref.head, ref.tail, ref.capacity)
    return ref, port


def test_gather_window_bytes_match_reference_across_the_ring_seam():
    ref, port = _rings()
    for start, count, rows in ((ref.tail, 40, 64), (ref.head - 10, 10, 16),
                               (0, 1024, 64), (ref.head, 5, 16)):
        a = np.full((rows, staging.ROW_STRIDE), 0xAB, np.uint8)
        b = np.full((rows, staging.ROW_STRIDE), 0xCD, np.uint8)
        na = ref_staging.gather_window(ref, start, count, a)
        nb = staging.gather_window(port, start, count, b)
        assert na == nb
        np.testing.assert_array_equal(a, b)


def test_staging_helpers_match_reference():
    for n, lo in ((0, 16), (1, 16), (17, 16), (300, 8), (5, 1)):
        assert staging.pow2(n, lo) == ref_staging.pow2(n, lo)
    for n, k in ((1, 1), (5, 2), (16, 4), (7, 8)):
        assert staging.rows_per_shard(n, k) == ref_staging.rows_per_shard(n, k)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (5, 120), dtype=np.uint8)
    ln = rng.integers(0, 2060, 5).astype(np.int32)
    np.testing.assert_array_equal(
        staging.pack_rows(data, ln, np.full((8, 100), 7, np.uint8)),
        ref_staging.pack_rows(data, ln, np.full((8, 100), 7, np.uint8)))


def _b9_inputs(case, rng):
    """(prefix, length, age, state, buckets, delay) for one B9 case: the
    reference's own end-to-end shape (32 whole packets, 8 outputs from
    rebase 0, 4 a bucket), a window padded to a power of two with
    length-0 rows (as the reference's batch-header rung pads it), and
    fuzzed rows with runts and truncated packets."""
    if case == "reference_shape":
        pkts = [p for p in (synth.random_packet(rng) for _ in range(64))
                if len(p) >= 12][:32]
        outs = [RefOutput(ssrc=i) for i in range(8)]
        for o in outs:
            o.rewrite.base_src_seq = o.rewrite.base_src_ts = 0
        state = ref_fanout.pack_output_state(outs)
        pre, ln = synth.stage(pkts)
        return (pre, ln, np.full(len(pkts), 100, np.int32), state,
                (np.arange(8) // 4).astype(np.int32), 73)
    n = 21 if case == "pow2_padded" else 48
    pkts = [synth.random_packet(rng) for _ in range(n)]
    if case == "fuzzed_runts":
        runts = (b"\x80\x60\x00", b"", b"\x80" * 11, b"\x80" * 12, bytes(3))
        for i in range(0, n, 5):
            pkts[i] = runts[i // 5 % len(runts)]
    pre, ln = synth.stage(pkts)
    p = staging.pow2(n, 16) if case == "pow2_padded" else n
    prefix = np.zeros((p, 96), np.uint8)
    length = np.zeros(p, np.int32)
    prefix[:n], length[:n] = pre, ln
    age = rng.integers(0, 400, p).astype(np.int32)
    return (prefix, length, age, _state(rng, 1, 13)[0],
            (np.arange(13) % 4).astype(np.int32), 73)


@pytest.mark.parametrize("case", ["reference_shape", "pow2_padded",
                                  "fuzzed_runts"])
def test_relay_batch_step_matches_reference(case):
    args = _b9_inputs(case, np.random.default_rng(len(case)))
    ref = ref_fanout.relay_batch_step(*args)
    got = fanout.relay_batch_step(*[torch.from_numpy(np.asarray(a))
                                    for a in args[:5]], args[5])
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert kernel_lib.LAUNCHES["ed_parse_packets"] == 0   # the CPU parse
