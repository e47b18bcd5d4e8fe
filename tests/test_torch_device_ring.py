"""The port's device ring ≡ the JAX package's ``ops.device_ring``.

The same numpy inputs go through the reference's ``append``/``query`` and
the port's (plain version, ``device="cpu"``); every integer result is
bit-exact.  ``query_params_plain`` (what ``ed_ring_query`` computes) is
held against the reference's query, and a Python mirror of the kernel's
plan — tile CTAs that also emit their share of the subscribers, partial
maxima in the ring's scratch, one fold by the last CTA to arrive, which
puts the arrival counter back to 0 — against ``query_params_plain``.
"""

import numpy as np
import pytest
import torch

from easydarwin_tpu.ops import device_ring as ref_dr
from easydarwin_tpu.ops.fanout import pack_output_state as ref_pack_state
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu_torch.ops import device_ring as dr
from easydarwin_tpu_torch.ops.fanout import unpack_affine
from easydarwin_tpu_torch.ops.parse import parse_packets
from easydarwin_tpu_torch.utils import synth

#: integer results of the reference's query the port must reproduce
KEYS = ("seq", "timestamp", "keyframe_first", "frame_first", "frame_last",
        "newest_keyframe", "seq_off", "ts_off", "ssrc", "chan", "abs_id",
        "valid", "newest_keyframe_abs", "age_ms")


def mk_batch(seqs, nal_types, width=96):
    """The reference test's batch: [B, 96] headers with a NAL byte."""
    pre = np.zeros((len(seqs), width), dtype=np.uint8)
    pre[:, 0] = 0x80
    pre[:, 1] = 96
    for i, (s, t) in enumerate(zip(seqs, nal_types)):
        pre[i, 2] = s >> 8
        pre[i, 3] = s & 0xFF
        pre[i, 12] = (3 << 5) | t
    return pre, np.full(len(seqs), 64, dtype=np.int32)


def _state(rng, n):
    return ref_pack_state([RefOutput(ssrc=int(rng.integers(1 << 32)),
                                     out_seq_start=int(rng.integers(1 << 16)),
                                     out_ts_start=int(rng.integers(1 << 32)))
                           for _ in range(n)])


def _both(capacity, batches, out_state, now_ms):
    """Append ``batches`` of (prefix, length, arrival, n_new) to both
    rings and query both; returns (reference dict, port dict, port ring)."""
    ref = ref_dr.init_ring(capacity)
    port = dr.init_ring(capacity, device="cpu")
    for pre, ln, arr, n in batches:
        ref = ref_dr.append(ref, pre, ln, arr, np.int32(n))
        port = dr.append(port, pre, ln, arr, n)
    assert port.head == int(ref.head)
    st = np.asarray(out_state, np.uint32)
    q_ref = ref_dr.query(ref, st, np.int32(now_ms))
    q = dr.query(port, torch.from_numpy(st.copy()), now_ms)
    return q_ref, q, port


def _assert_same(q_ref, q):
    for k in KEYS:
        a = np.asarray(q[k].numpy()).astype(np.int64)
        b = np.asarray(q_ref[k]).astype(np.int64)
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_append_and_query_basic():
    pre, ln = mk_batch([1, 2, 3], [5, 1, 1])
    st = ref_pack_state([RefOutput(ssrc=7)])
    q_ref, q, port = _both(8, [(pre, ln, np.full(3, 100, np.int32), 3)], st,
                           150)
    _assert_same(q_ref, q)
    assert port.head == 3 and int(q["newest_keyframe_abs"]) == 0
    assert int(q["valid"].sum()) == 3


def test_wraparound_absolute_ids():
    batches = []
    for batch in range(3):                 # 9 packets through a 4-slot ring
        pre, ln = mk_batch([10 * batch + i for i in range(3)],
                           [5 if batch == 2 and i == 0 else 1
                            for i in range(3)])
        batches.append((pre, ln, np.full(3, 100 * batch, np.int32), 3))
    q_ref, q, port = _both(4, batches, ref_pack_state([RefOutput(ssrc=1)]),
                           1000)
    _assert_same(q_ref, q)
    valid = q["valid"].numpy()
    assert sorted(q["abs_id"].numpy()[valid].tolist()) == [5, 6, 7, 8]
    assert int(q["newest_keyframe_abs"]) == 6


def test_partial_batch_append():
    pre, ln = mk_batch([1, 2, 3, 4], [1, 1, 1, 1])
    q_ref, q, port = _both(8, [(pre, ln, np.full(4, 5, np.int32), 2)],
                           ref_pack_state([RefOutput(ssrc=1)]), 10)
    _assert_same(q_ref, q)
    assert port.head == 2 and int(q["valid"].sum()) == 2


def test_incremental_equals_bulk():
    pre, ln = mk_batch(list(range(20)), [5 if i % 7 == 0 else 1
                                         for i in range(20)])
    st = ref_pack_state([RefOutput(ssrc=3)])
    inc = [(pre[i:i + 4], ln[i:i + 4], np.full(4, i, np.int32), 4)
           for i in range(0, 20, 4)]
    q_ref, q, _ = _both(32, inc, st, 100)
    _assert_same(q_ref, q)
    _q_ref, q_bulk, _ = _both(32, [(pre, ln, np.full(20, 0, np.int32), 20)],
                              st, 100)
    valid = q["valid"].numpy()
    for k in ("seq", "keyframe_first", "abs_id"):
        np.testing.assert_array_equal(q[k].numpy()[valid],
                                      q_bulk[k].numpy()[valid], err_msg=k)


def _fuzz_batches(rng, n_batches, batch):
    """Fuzzed packets (every NAL shape, runts, truncations) plus length-0
    rows, in batches with partial admission."""
    out = []
    for b in range(n_batches):
        pkts = [synth.random_packet(rng) for _ in range(batch)]
        pre, ln = synth.stage(pkts)
        ln[rng.random(batch) < 0.1] = 0                  # length-0 rows
        ln[rng.random(batch) < 0.05] = 7                 # runts
        n = int(rng.integers(batch // 2, batch + 1))
        arr = rng.integers(0, 1 << 20, batch).astype(np.int32)
        out.append((pre, ln, arr, n))
    return out


@pytest.mark.parametrize("capacity,n_batches,batch", [
    (64, 2, 20),            # partly filled
    (64, 12, 24),           # wrapped several times
    (128, 9, 48),           # wrapped, a batch crossing the seam
])
def test_fuzzed_ring_matches_reference(capacity, n_batches, batch):
    rng = np.random.default_rng(capacity * 1000 + n_batches)
    st = _state(rng, 5)
    q_ref, q, port = _both(capacity, _fuzz_batches(rng, n_batches, batch),
                           st, 1 << 21)
    _assert_same(q_ref, q)
    packed = dr.query_params_plain(port, torch.from_numpy(st.copy()))
    seq_off, ts_off, ssrc, chan, kf = unpack_affine(
        packed.numpy()[None], st.shape[0])
    for k, v in (("seq_off", seq_off), ("ts_off", ts_off), ("ssrc", ssrc),
                 ("chan", chan)):
        np.testing.assert_array_equal(v[0], np.asarray(q_ref[k]), err_msg=k)
    assert int(kf[0]) == int(q_ref["newest_keyframe_abs"])


def test_no_keyframe_gives_minus_one():
    pre, ln = mk_batch(list(range(10)), [1] * 10)
    port = dr.append(dr.init_ring(16, device="cpu"), pre, ln,
                     np.zeros(10, np.int32), 10)
    st = torch.from_numpy(ref_pack_state([RefOutput(ssrc=9)]))
    packed = dr.query_params_plain(port, st)
    assert int(packed.view(torch.int32)[-1]) == -1
    empty = dr.query_params_plain(dr.init_ring(16, device="cpu"), st)
    assert int(empty.view(torch.int32)[-1]) == -1


def _mirror(state, out_state, addr, scratch, order):
    """``ed_ring_query`` computed the kernel's way from its plan: the tile
    CTAs run in ``order``; each writes its subscribers' columns, parses
    its rows, stores its max abs id into ``scratch[tile]`` and draws an
    arrival from ``scratch[-1]``; the CTA that draws n_tiles − 1 folds the
    partials into the last word and stores 0 back into the counter.
    Returns the words and how often each was written."""
    n = out_state.shape[0]
    plan = dr.ring_query_plan(state.capacity, n, addr)
    n_tiles = plan["grid"]
    assert plan["threads"] == dr.RING_TILE_ROWS
    assert scratch.shape == (plan["scratch_words"],) == (n_tiles + 1,)
    assert scratch[-1] == 0
    rows = state.rows.numpy()
    st = out_state.numpy().astype(np.int64)
    out = np.zeros(4 * n + 1, np.int64)
    writes = np.zeros(4 * n + 1, np.int64)
    for k in order:
        lo, hi, head_b, interior, tail = plan["tiles"][k]
        assert head_b + interior + tail == (hi - lo) * dr.ROW_STRIDE
        assert 0 < hi - lo <= dr.RING_TILE_ROWS
        for s in range(*plan["emit"][k]):
            out[s] = (st[s, 3] - st[s, 1]) & 0xFFFF
            out[n + s] = (st[s, 4] - st[s, 2]) & 0xFFFFFFFF
            out[2 * n + s] = st[s, 0]
            out[3 * n + s] = st[s, 5]
            writes[[s, n + s, 2 * n + s, 3 * n + s]] += 1
        tile = torch.from_numpy(rows[lo:hi])
        length = torch.from_numpy(rows[lo:hi, 96:100].copy().view("<i4")[:, 0])
        kf = parse_packets(tile[:, :96], length)["keyframe_first"].numpy()
        best = -1
        for t in range(hi - lo):
            m = (state.head - (lo + t) - 1) % state.capacity
            a = state.head - m - 1
            if length[t] > 0 and a >= 0 and kf[t]:
                best = max(best, a)
        scratch[k] = best
        arrival = int(scratch[-1])
        scratch[-1] += 1
        if arrival == n_tiles - 1:
            out[-1] = int(scratch[:n_tiles].max())
            writes[-1] += 1
            scratch[-1] = 0
    return out & 0xFFFFFFFF, writes


def _fuzzed_ring(rng, capacity):
    port = dr.init_ring(capacity, device="cpu")
    for pre, ln, arr, n in _fuzz_batches(rng, 3 * capacity // 64 + 2, 64):
        dr.append(port, pre, ln, arr, n)
    return port


@pytest.mark.parametrize("capacity,n_subs,addr", [
    (4096, 64, 0), (4096, 256, 0), (4096, 70, 3), (100, 1, 7),
    (1000, 64, 0),          # a capacity that is not a multiple of the tile
    (100, 300, 5),          # more subscribers than the grid has threads
    (128, 3, 0),            # exactly one tile
    (129, 2, 9),            # one row past a tile: a one-row last CTA
    (4096, 0, 0),           # no subscribers: only the newest keyframe
])
def test_kernel_tile_plan_mirror_equals_plain(capacity, n_subs, addr):
    rng = np.random.default_rng(capacity + n_subs + addr)
    port = _fuzzed_ring(rng, capacity)
    st = torch.from_numpy(_state(rng, n_subs))
    plan = dr.ring_query_plan(capacity, n_subs, addr)
    assert [t[0] for t in plan["tiles"]] == list(
        range(0, capacity, dr.RING_TILE_ROWS))
    assert plan["tiles"][-1][1] == capacity
    assert [lo for lo, _ in plan["emit"]] == [0] + [hi for _, hi
                                                    in plan["emit"][:-1]]
    assert plan["emit"][-1][1] == n_subs
    plain = dr.query_params_plain(port, st).numpy().astype(np.int64)
    scratch = port.scratch.numpy()
    order = rng.permutation(plan["grid"])       # CTAs arrive in any order
    got, writes = _mirror(port, st, addr, scratch, order)
    np.testing.assert_array_equal(got, plain)
    assert (writes == 1).all()                  # every word written once
    assert scratch[-1] == 0                     # the counter reset itself


def test_two_queries_in_a_row_find_the_counter_at_zero():
    """Two queries of one ring with appends between them: each equals the
    plain query, and each leaves the ring's arrival counter at 0 for the
    next."""
    rng = np.random.default_rng(606)
    port = _fuzzed_ring(rng, 1000)
    st = torch.from_numpy(_state(rng, 40))
    assert port.scratch.shape == (dr.ring_tiles(1000) + 1,)
    for query in range(2):
        if query:
            for pre, ln, arr, n in _fuzz_batches(rng, 3, 64):
                dr.append(port, pre, ln, arr, n)
        plain = dr.query_params_plain(port, st).numpy().astype(np.int64)
        order = rng.permutation(dr.ring_tiles(1000))
        got, writes = _mirror(port, st, 0, port.scratch.numpy(), order)
        np.testing.assert_array_equal(got, plain)
        assert (writes == 1).all() and int(port.scratch[-1]) == 0


def test_append_rejects_what_the_ring_cannot_hold():
    ring = dr.init_ring(4, device="cpu")
    with pytest.raises(ValueError):
        dr.append_rows(ring, torch.zeros((5, dr.ROW_STRIDE), dtype=torch.uint8),
                       torch.zeros(5, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        dr.append_rows(ring, torch.zeros((2, 96), dtype=torch.uint8),
                       torch.zeros(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        dr.query_params(ring, torch.zeros((3, 5), dtype=torch.uint32))
