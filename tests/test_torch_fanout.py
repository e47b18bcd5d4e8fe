"""The port's fan-out ops, window pass, batch-header step (B9), pipeline
and staging ≡ the JAX package's, bit-exact, on the same numpy inputs (CPU
tensors: the plain PyTorch versions the kernel wrappers run off the
card); B9's wrapper raises on what ``ed_relay_batch`` does not take, on
either device."""

import ast
import re
from collections import Counter
from pathlib import Path

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
    # 512 rows a CTA: past 48 KB, inside the kernel's large-smem opt-in
    (wide,) = fanout.window_launch_plan([(1, 4096, 100, 8)], [0])
    assert kernel_lib.DYN_SMEM_LIMIT < wide.smem_bytes \
        <= kernel_lib.WINDOW_SMEM_LIMIT
    with pytest.raises(ValueError):              # 4,096 rows a CTA: too wide
        fanout.window_launch_plan([(1, 32768, 100, 8)], [0])


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
    assert kernel_lib.LAUNCHES["ed_relay_batch"] == 0


#: ``ed_relay_batch``'s output group (``BATCH_SUBS_PER_CTA``)
_G = fanout.BATCH_SUBS_PER_CTA
#: B9's edges: (P, S, W, delay) a case
_B9_EDGES = {"s1_p1": (1, 1, 96, 73), "p65": (65, 5, 96, 73),
             "p200": (200, 21, 96, 40), "all_padding": (48, 7, 96, 73),
             "all_runts": (48, 7, 96, 73), "wrap": (80, 9, 96, 73),
             "delay0": (70, 18, 96, 0), "w100": (90, 6, 100, 73),
             # the output group's edges at phase 7c's P
             "p47_s_g_minus_1": (47, _G - 1, 96, 73),
             "p47_s_g": (47, _G, 96, 73),
             "p47_s_g_plus_1": (47, _G + 1, 96, 73),
             "p47_s_2g_plus_1": (47, 2 * _G + 1, 96, 73),
             # the tiles' edges at phase 7c's S, and the last pass whose
             # keyframe folds in one word of 64-row tiles' fields (8 tiles)
             "p64_s16": (64, 16, 96, 73), "p65_s16": (65, 16, 96, 73),
             "p128_s16": (128, 16, 96, 73), "p129_s16": (129, 16, 96, 73),
             "p512_s5": (512, 5, 96, 73), "p513_s5": (513, 5, 96, 73)}


def _b9_edge_inputs(case, rng):
    """(prefix, length, age, state, buckets, delay) for one edge of B9:
    one output and one packet, P off the 64-row tile (65, 200), a window
    of padding rows only (no keyframe: −1), runts only (an all-False
    mask), seq and ts that wrap (every base above the packet's value),
    a zero bucket delay, 100-byte rows, the kernel's output group's edges
    (S = G − 1, G, G + 1, 2G + 1) and its tiles' (P = 64, 65, 128, 129,
    512, 513)."""
    p, s, w, delay = _B9_EDGES[case]
    if case == "all_runts":
        pkts = [bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                                   dtype=np.uint8)) for _ in range(p)]
    elif case == "s1_p1":
        pkts = [synth.h264_packet(3, 900, 5, ssrc=9, body=b"k" * 40)]
    else:
        pkts = [synth.random_packet(rng) for _ in range(p)]
    pre, ln = synth.stage(pkts)
    prefix = rng.integers(0, 256, (p, w), dtype=np.uint8)
    prefix[:, :96] = pre
    length = ln.astype(np.int32)
    if case == "all_padding":
        prefix[:] = 0
        length[:] = 0
    state = _state(rng, 1, s)[0]
    if case == "wrap":
        state[:, 1] = 0xFFFF        # base_seq above every seq
        state[:, 2] = 0xFFFFFFF0    # base_ts above every ts
        state[:, 3] = rng.integers(0, 0x100, s)
        state[:, 4] = rng.integers(0, 0x100, s)
    age = rng.integers(-50, 400, p).astype(np.int32)
    buckets = rng.integers(0, 4, s).astype(np.int32)
    return prefix, length, age, state, buckets, delay


@pytest.mark.parametrize("case", list(_B9_EDGES))
def test_relay_batch_step_plain_matches_reference_at_the_edges(case):
    args = _b9_edge_inputs(case, np.random.default_rng(sum(map(ord, case))))
    ref = ref_fanout.relay_batch_step(*args)
    tensors = [torch.from_numpy(np.asarray(a)) for a in args[:5]]
    plain = fanout.relay_batch_step_plain(*tensors, args[5])
    got = fanout.relay_batch_step(*tensors, args[5])
    assert sorted(plain) == sorted(got) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        for res in (plain, got):
            assert res[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(res[k].numpy(), v, err_msg=k)
    if case == "all_padding":
        assert int(got["newest_keyframe"]) == -1
    if case == "all_runts":
        assert not got["mask"].any()
    assert kernel_lib.LAUNCHES["ed_relay_batch"] == 0      # the CPU version


def _kernel_constants(prefix: str) -> dict[str, int]:
    """The ``constexpr int`` constants of ``csrc/relay_kernels.cu`` whose
    names start with ``prefix``, evaluated (literals, ``<<``, ``*``,
    ``/``, ``+``, ``-`` and earlier constants)."""
    src = (Path(fanout.__file__).resolve().parents[1] / "csrc"
           / "relay_kernels.cu").read_text()
    known: dict[str, int] = {}

    def ev(node):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return known[node.id]
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            ops = {ast.LShift: lambda: a << b, ast.Mult: lambda: a * b,
                   ast.FloorDiv: lambda: a // b, ast.Add: lambda: a + b,
                   ast.Sub: lambda: a - b}
            return ops[type(node.op)]()
        raise ValueError(ast.dump(node))

    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        known[name] = ev(ast.parse(expr.replace("/", "//"),
                                   mode="eval").body)
    return {k: v for k, v in known.items() if k.startswith(prefix)}


def test_batch_constants_match_the_kernel_source():
    got = _kernel_constants("kBatch")
    assert got == {"kBatchTileRows": fanout.BATCH_TILE_ROWS,
                   "kBatchSubsPerCta": fanout.BATCH_SUBS_PER_CTA,
                   "kBatchMaxPkts": fanout.BATCH_MAX_PKTS,
                   "kBatchMaxSubs": fanout.BATCH_MAX_SUBS,
                   "kBatchScratchWords": fanout.BATCH_SCRATCH_WORDS}


def _b9_tensors(p=8, s=3, w=96):
    return [torch.zeros((p, w), dtype=torch.uint8),
            torch.zeros(p, dtype=torch.int32), torch.zeros(p, dtype=torch.int32),
            torch.zeros((s, 6), dtype=torch.uint32),
            torch.zeros(s, dtype=torch.int32)]


def _b9_bad(i, t):
    args = _b9_tensors()
    args[i] = t
    return args


@pytest.mark.parametrize("args,err,match", [
    (_b9_tensors(w=95), ValueError, "W>=96"),
    (_b9_tensors(w=800), ValueError, "too wide"),
    (_b9_bad(0, torch.zeros((8, 96), dtype=torch.int8)), TypeError, "uint8"),
    (_b9_tensors(p=0), ValueError, "P = 0"),
    (_b9_tensors(s=0), ValueError, "S = 0"),
    ([t.to("meta") for t in _b9_tensors(p=fanout.BATCH_MAX_PKTS + 1)],
     ValueError, "packets is outside"),
    ([t.to("meta") for t in _b9_tensors(s=fanout.BATCH_MAX_SUBS + 1)],
     ValueError, "outputs is outside"),
    (_b9_bad(1, torch.zeros(7, dtype=torch.int32)), ValueError, "length"),
    (_b9_bad(1, torch.zeros(8, dtype=torch.int64)), TypeError, "length"),
    (_b9_bad(2, torch.zeros((8, 1), dtype=torch.int32)), ValueError,
     "age_ms"),
    (_b9_bad(2, torch.zeros(8, dtype=torch.float32)), TypeError, "age_ms"),
    (_b9_bad(3, torch.zeros((3, 5), dtype=torch.uint32)), ValueError,
     "out_state"),
    (_b9_bad(3, torch.zeros((3, 6), dtype=torch.int32)), TypeError,
     "out_state"),
    (_b9_bad(4, torch.zeros(4, dtype=torch.int32)), ValueError,
     "bucket_of_output"),
    (_b9_bad(4, torch.zeros(3, dtype=torch.int64)), TypeError,
     "bucket_of_output"),
    (_b9_bad(4, torch.zeros(3, dtype=torch.int32, device="meta")),
     ValueError, "bucket_of_output is on meta"),
])
def test_relay_batch_step_raises_on_a_wrong_shape_or_dtype(args, err, match):
    with pytest.raises(err, match=match):
        fanout.relay_batch_step(*args, 73)
    assert kernel_lib.LAUNCHES["ed_relay_batch"] == 0


def test_relay_batch_step_raises_on_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no batch-step kernel for device "
                                         "meta"):
        fanout.relay_batch_step(*[t.to("meta") for t in _b9_tensors()], 73)


def test_batch_upload_round_trips_every_input():
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 256, (37, 96), dtype=np.uint8)
    length = rng.integers(-5, 2000, 37).astype(np.int32)
    age = rng.integers(-1 << 31, 1 << 31, 37, dtype=np.int64).astype(np.int32)
    state = _state(rng, 1, 11)[0]
    buckets = rng.integers(0, 9, 11).astype(np.int32)
    buf = np.full(8192, 0xAB, np.uint8)
    n = fanout.pack_batch_upload(buf, prefix, length, age, state, buckets)
    assert n == fanout.batch_upload_layout(37, 11)[-1] == 37 * 104 + 11 * 28
    views = fanout.batch_upload_views(torch.from_numpy(buf)[:n], 37, 11)
    for got, want in zip(views, (prefix, length, age, state, buckets)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
