"""The port's mesh path (B8, A9) ≡ the JAX package's, on the CPU.

* ``parallel.mesh.sharded_relay_step`` over 8 CPU shards equals the JAX
  ``sharded_relay_step`` on the conftest's 8 forced host devices, in the
  layouts (8,1,1), (4,2,1), (2,2,2), (1,8,1) and (1,1,8), with rows of
  length 0 and 1–11 among the packets (the reference's mask counts the
  short ones; B9's alone would not), and the ``win`` keyframe offset;
* ``ops.fanout.relay_shard_step`` (B8's shard step) folds into shared
  outputs as the reference's step, and refuses a wrong view;
* mesh construction: the factories' checks, ``make_megabatch_mesh``
  returns None on one device, the cluster mesh's span and summary equal
  the reference's, ``init_from_env`` does nothing without a fleet;
* the mesh path's window call a device, over its block of stream rows,
  equals the one-device pass and JAX's;
* the megabatch scheduler's mesh path writes the same wire bytes as the
  per-stream path (and as the reference's per-stream path), with mixed
  shapes, a join and a teardown, and with an uneven stream count; a
  failed mesh dispatch is counted and raised;
* the gloo path: two processes, each running its shards of a cluster
  mesh, all-reduce the keyframe max and the eligible sum to the JAX
  result (one test, 60 s).
"""

import ctypes
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from easydarwin_tpu import native as ref_native
from easydarwin_tpu.models import relay_pipeline as ref_pipeline
from easydarwin_tpu.ops import staging as ref_staging
from easydarwin_tpu.parallel import distributed as ref_distributed
from easydarwin_tpu.parallel import mesh as ref_mesh
from easydarwin_tpu.relay.fanout import TpuFanoutEngine as RefEngine
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.models import relay_pipeline
from easydarwin_tpu_torch.ops import fanout, kernel_lib, staging
from easydarwin_tpu_torch.ops.fanout import STATE_COLS
from easydarwin_tpu_torch.parallel import distributed, mesh
from easydarwin_tpu_torch.protocol import sdp
from easydarwin_tpu_torch.relay import megabatch
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from test_megabatch import VIDEO_SDP, _Wire, vid_pkt
from test_megabatch import _mk_stream as _ref_mk_stream

ROOT = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 (virtual) JAX devices")
needs_native = pytest.mark.skipif(
    not (native.available() and ref_native.available()),
    reason="an egress core is not built")


def _short_rows_batch(n_src, n_sub, n_pkt, seed):
    """The reference's example batch with a seeded share of its rows cut
    to 0 and to 1–11 bytes."""
    batch = list(mesh.example_batch(n_src=n_src, n_sub=n_sub, n_pkt=n_pkt))
    rng = np.random.default_rng(seed)
    length = batch[1]
    cut = rng.random(length.shape)
    length[cut < 0.15] = rng.integers(1, 12, length.shape)[cut < 0.15]
    length[cut > 0.93] = 0
    batch[2] = rng.integers(0, 400, length.shape).astype(np.int32)
    return batch


@needs_devices
@pytest.mark.parametrize("axes", [
    dict(src=8), dict(src=4, sub=2), dict(src=2, sub=2, win=2),
    dict(src=1, sub=8), dict(src=1, sub=1, win=8)],
    ids=["8-1-1", "4-2-1", "2-2-2", "1-8-1", "1-1-8"])
def test_sharded_relay_step_equals_jax(axes):
    batch = _short_rows_batch(8, 32, 64, seed=sum(axes.values()))
    assert ((batch[1] > 0) & (batch[1] < 12)).any()
    ref = ref_mesh.make_relay_mesh(**axes)
    want = jax.block_until_ready(ref_mesh.sharded_relay_step(ref, 40)(
        *ref_mesh.shard_args(ref, *batch)))
    got = mesh.sharded_relay_step(mesh.make_relay_mesh(CPU8, **axes), 40)(
        *batch)
    names = ("headers", "mask", "newest_keyframe", "total_eligible")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    # the short rows are in the mask, as the reference counts them
    short = (batch[1] > 0) & (batch[1] < 12)
    assert got[1].numpy()[:, :, short[0]].any() or not short[0].any()


@needs_devices
def test_win_axis_keyframe_offset():
    """The keyframe index is global across win shards, not shard-local."""
    prefix, length, age, out_state, buckets = mesh.example_batch(
        n_src=1, n_sub=4, n_pkt=64)
    prefix[:, :, 12] = (3 << 5) | 1
    prefix[0, 61, 12] = (3 << 5) | 5
    args = (prefix, length, age, out_state, buckets)
    ref = ref_mesh.make_relay_mesh(src=1, win=8)
    _h, _m, want, _t = ref_mesh.sharded_relay_step(ref)(
        *ref_mesh.shard_args(ref, *args))
    _h, _m, kf, _t = mesh.sharded_relay_step(
        mesh.make_relay_mesh(CPU8, src=1, win=8))(*args)
    assert int(kf[0]) == int(np.asarray(want)[0]) == 61


def _blocks_of(batch, devices=CPU8, **axes):
    """The port's step over ``devices`` laid out as ``axes``, and the JAX
    result of the same layout on the forced host devices."""
    ref = ref_mesh.make_relay_mesh(**axes)
    want = [np.asarray(a) for a in ref_mesh.sharded_relay_step(ref, 40)(
        *ref_mesh.shard_args(ref, *batch))]
    return mesh.sharded_relay_step(mesh.make_relay_mesh(devices, **axes),
                                   40), want


def _shard_outputs(n, s, p, newest=-1, eligible=0):
    return (torch.zeros((n, s, p, 12), dtype=torch.uint8),
            torch.zeros((n, s, p), dtype=torch.bool),
            torch.full((n,), newest, dtype=torch.int32),
            torch.full((), eligible, dtype=torch.int64))


_VIEWS = ("prefix", "length", "age_ms", "out_state", "bucket_of_output",
          "headers", "mask", "newest")


@needs_devices
def test_relay_shard_step_folds_into_shared_outputs_as_the_reference():
    """Two shards of one source block (the two halves along ``win``, each
    a strided view of the whole batch, sharing the block's ``newest``) in
    one call, writing into views of one result, give JAX's (1,1,2) step;
    ``newest`` and ``eligible`` are written, not folded into, so what
    they held before is gone."""
    batch = [torch.from_numpy(a) for a in _short_rows_batch(4, 8, 64, 9)]
    prefix, length, age, state, buckets = batch
    ref = ref_mesh.make_relay_mesh(src=1, win=2, devices=jax.devices()[:2])
    want = [np.asarray(a) for a in ref_mesh.sharded_relay_step(ref, 40)(
        *ref_mesh.shard_args(ref, *(b.numpy() for b in batch)))]
    headers, mask, newest, total = _shard_outputs(4, 8, 64, newest=1000,
                                                  eligible=5)
    shards = [fanout.ShardBlock(
        prefix[:, ps], length[:, ps], age[:, ps], state, buckets,
        headers[:, :, ps], mask[:, :, ps], newest, kf_base=32 * k)
        for k, ps in enumerate((slice(0, 32), slice(32, 64)))]
    fanout.relay_shard_step(shards, 40, total)
    for name, a, b in zip(("headers", "mask", "newest"),
                          (headers, mask, newest), want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert int(total) == int(want[3])
    assert kernel_lib.LAUNCHES["ed_relay_shard"] == 0    # the CPU version


def _shard_args(**bad):
    n, s, p = 2, 3, 8
    blk = dict(prefix=torch.zeros((n, p, 96), dtype=torch.uint8),
               length=torch.zeros((n, p), dtype=torch.int32),
               age_ms=torch.zeros((n, p), dtype=torch.int32),
               out_state=torch.zeros((n, s, STATE_COLS), dtype=torch.uint32),
               bucket_of_output=torch.zeros((n, s), dtype=torch.int32),
               kf_base=0)
    outs = _shard_outputs(n, s, p)
    blk.update(zip(("headers", "mask", "newest"), outs[:3]))
    eligible = bad.pop("eligible", outs[3])
    blk.update(bad)
    return dict(shards=[fanout.ShardBlock(**blk)], bucket_delay_ms=40,
                eligible=eligible)


@pytest.mark.parametrize("bad,err,match", [
    (dict(prefix=torch.zeros((2, 8, 95), dtype=torch.uint8)), ValueError,
     "W>=96"),
    (dict(prefix=torch.zeros((2, 96, 8), dtype=torch.uint8).transpose(1, 2)),
     ValueError, "prefix's inner strides"),
    (dict(length=torch.zeros((8, 2), dtype=torch.int32).T), ValueError,
     "length's inner strides"),
    (dict(age_ms=torch.zeros((2, 8), dtype=torch.int64)), TypeError,
     "age_ms"),
    (dict(out_state=torch.zeros((2, 3, 5), dtype=torch.uint32)), ValueError,
     "out_state"),
    (dict(headers=torch.zeros((2, 3, 8, 12), dtype=torch.int32)), TypeError,
     "headers"),
    (dict(headers=torch.zeros(2 * 3 * 8 * 12 + 1, dtype=torch.uint8)[1:]
          .view(2, 3, 8, 12)), ValueError, "4-byte aligned"),
    (dict(mask=torch.zeros((2, 3, 7), dtype=torch.bool)), ValueError,
     "mask must be"),
    (dict(newest=torch.zeros(2, dtype=torch.int64)), TypeError, "newest"),
    (dict(eligible=torch.zeros(1, dtype=torch.int64)), ValueError,
     "eligible must be"),
    (dict(kf_base=-1), ValueError, "kf_base"),
    (dict(bucket_of_output=torch.zeros((2, 3), dtype=torch.int32,
                                       device="meta")),
     ValueError, "bucket_of_output is on meta"),
])
def test_relay_shard_step_raises_on_a_wrong_view(bad, err, match):
    with pytest.raises(err, match=match):
        fanout.relay_shard_step(**_shard_args(**bad))
    assert kernel_lib.LAUNCHES["ed_relay_shard"] == 0


def test_relay_shard_step_raises_on_mixed_shards():
    """No shard, shards of two geometries, and a source block of more
    shards than a launch's descriptors are refused."""
    args = _shard_args()
    blk, eligible = args["shards"][0], args["eligible"]
    with pytest.raises(ValueError, match="no shard"):
        fanout.relay_shard_step([], 40, eligible)
    other = fanout.ShardBlock(*(getattr(blk, f)[:1] for f in _VIEWS))
    with pytest.raises(ValueError, match="two geometries"):
        fanout.relay_shard_step([blk, other], 40, eligible)
    with pytest.raises(ValueError, match="shards of one source block"):
        fanout.relay_shard_step([blk] * (fanout.SHARD_MAX_SHARDS + 1), 40,
                                eligible)
    assert kernel_lib.LAUNCHES["ed_relay_shard"] == 0


def test_relay_shard_step_raises_on_a_device_without_a_kernel():
    args = _shard_args()
    meta = fanout.ShardBlock(*(getattr(args["shards"][0], f).to("meta")
                               for f in _VIEWS))
    with pytest.raises(ValueError, match="no shard-step kernel for device "
                                         "meta"):
        fanout.relay_shard_step([meta], 40, args["eligible"].to("meta"))


@needs_devices
@pytest.mark.parametrize("axes", [
    dict(src=8), dict(src=4, sub=2), dict(src=2, sub=2, win=2),
    dict(src=1, sub=8), dict(src=1, sub=1, win=8)],
    ids=["8-1-1", "4-2-1", "2-2-2", "1-8-1", "1-1-8"])
def test_one_shard_step_call_a_device(axes, monkeypatch):
    """The eight shards of ``CPU8`` share one device: a step makes ONE
    call of the shard step, whose plan is ONE launch of eight
    descriptors; a source block's ``sub`` and ``win`` shards share its
    fold slots."""
    calls, plans = [], []
    step_fn, plan_fn = fanout.relay_shard_step, fanout.shard_launch_plan

    def counted(shards, *args):
        calls.append(len(shards))
        return step_fn(shards, *args)

    def planned(shards):
        plans.append(plan_fn(shards))
        return plans[-1]

    monkeypatch.setattr(fanout, "relay_shard_step", counted)
    monkeypatch.setattr(fanout, "shard_launch_plan", planned)
    batch = _short_rows_batch(8, 32, 64, seed=3)
    step, want = _blocks_of(batch, **axes)
    for a, b in zip(step(*batch), want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert calls == [8]
    (launch,) = plans[-1]
    parts = 8 // axes["src"]
    assert len(launch.shards) == 8 and not launch.accumulate
    assert launch.parts == (parts,) * 8 and launch.n_sources == 8
    assert launch.slot0 == tuple(8 // axes["src"] * (k // parts)
                                 for k in range(8))
    assert launch.n_items == 8 * (8 // axes["src"]) * fanout.shard_items(
        64 // axes.get("win", 1), 32 // axes.get("sub", 1))


@pytest.mark.parametrize("axes", [dict(src=32), dict(src=16, win=2)],
                         ids=["32-1-1", "16-1-2"])
def test_shards_past_a_launch_split_into_launches(axes):
    """32 shards on one device pass a launch's 16 descriptors: the plan
    makes two launches, each with whole source blocks (a block's ``win``
    shards together), the second adding to ``eligible``; the result
    equals one shard's."""
    batch = _short_rows_batch(32, 8, 64, seed=11)
    devices = [torch.device("cpu")] * 32
    got = mesh.sharded_relay_step(mesh.make_relay_mesh(devices, **axes),
                                  40)(*batch)
    want = mesh.sharded_relay_step(mesh.make_relay_mesh(CPU8[:1]), 40)(
        *batch)
    for name, a, b in zip(("headers", "mask", "newest", "total"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    win = axes.get("win", 1)
    nb, pb = 32 // axes["src"], 64 // win
    headers, mask, newest, _total = _shard_outputs(32, 8, 64)
    prefix, length, age, state, buckets = map(torch.from_numpy, batch)
    shards = []
    for i in range(axes["src"]):
        rs = slice(i * nb, (i + 1) * nb)
        for k in range(win):
            ps = slice(k * pb, (k + 1) * pb)
            shards.append(fanout.ShardBlock(
                prefix[rs, ps], length[rs, ps], age[rs, ps], state[rs],
                buckets[rs], headers[rs, :, ps], mask[rs, :, ps],
                newest[rs], kf_base=k * pb))
    plan = fanout.shard_launch_plan(shards)
    assert [len(lp.shards) for lp in plan] == [16, 16]
    assert [lp.accumulate for lp in plan] == [False, True]
    for lp in plan:
        blocks = {b.newest.data_ptr() for b in lp.shards}
        assert lp.n_sources == len(blocks) * nb
        assert lp.parts == (win,) * 16


def test_a_block_past_a_launchs_slots_is_cut_along_its_sources():
    """A block of 4,100 sources passes a launch's 4,096 fold slots: the
    plan cuts it into views of 4,096 and 4 sources (two launches); the
    packed descriptors name each view's own pointers, strides and
    CTAs."""
    n, p, s = 4100, 4, 2
    headers, mask, newest, total = _shard_outputs(n, s, p)
    blk = fanout.ShardBlock(
        torch.zeros((n, p, 100), dtype=torch.uint8),
        torch.zeros((n, p), dtype=torch.int32),
        torch.zeros((n, p), dtype=torch.int32),
        torch.zeros((n, s, STATE_COLS), dtype=torch.uint32),
        torch.zeros((n, s), dtype=torch.int32), headers, mask, newest)
    plan = fanout.shard_launch_plan([blk])
    assert [lp.n_sources for lp in plan] == [4096, 4]
    assert [lp.accumulate for lp in plan] == [False, True]
    tail = plan[1].shards[0]
    assert tail.newest.data_ptr() == newest[4096:].data_ptr()
    desc = fanout.shard_descriptors(plan[1], 40, total)
    d = desc.shard[0]
    assert ctypes.sizeof(fanout.ShardDescStruct) == 160
    assert ctypes.sizeof(desc) == 2616
    assert (d.prefix, d.headers, d.mask) == (
        blk.prefix[4096].data_ptr(), headers[4096].data_ptr(),
        mask[4096].data_ptr())
    assert (d.prefix_src, d.headers_src, d.headers_sub, d.mask_sub) == (
        p * 100, s * p * 12, p * 12, p)
    assert (d.n_src, d.slot0, d.parts, d.first_item) == (4, 0, 1, 0)
    assert (desc.n_shards, desc.n_items, desc.n_sources, desc.accumulate,
            desc.n_tiles, desc.n_groups, desc.row_stride) == (
        1, 4, 4, 1, 1, 1, 100)
    assert desc.eligible == total.data_ptr() and desc.delay_ms == 40


@needs_devices
@pytest.mark.parametrize("axes", [dict(src=2, sub=2, win=2),
                                  dict(src=4, win=2)],
                         ids=["2-2-2", "4-1-2"])
def test_unaligned_win_spans_equal_jax(axes):
    """P = 130 over two ``win`` shards at W = 100: each output's header
    span starts 1,560 bytes after the last (8 past a 16-byte boundary)
    and the second shard's 780 bytes into it, so no span is 16-byte
    aligned, and its mask span 65 bytes in: equal to JAX."""
    batch = _short_rows_batch(4, 18, 130, seed=13)
    batch[0] = np.concatenate(
        [batch[0], np.random.default_rng(13).integers(
            0, 256, (4, 130, 4), dtype=np.uint8)], axis=2)
    step, want = _blocks_of(batch, **axes)
    for name, a, b in zip(("headers", "mask", "newest", "total"),
                          step(*batch), want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _chunk_model(head_words: int, rows: int, words: np.ndarray):
    """``relay_shard_kernel``'s header stores in numpy: the span of
    ``rows`` packets (``words`` [rows, 3]) starts ``head_words`` words past
    a 16-byte boundary; each of its kSlots chunks renders packets j and
    j + 1 and picks four words by its phase, a whole chunk as one store
    and a partial one word by word.  Returns the words written at each
    position past the boundary."""
    n_words = 3 * rows
    out = np.full(4 * (rows * 12 // 16 + 2), -1, np.int64)
    slots = 64 * 12 // 16 + 1
    for c in range(slots):
        i0 = 4 * c - head_words
        if i0 >= n_words:
            continue
        j = (i0 + 3) // 3 - 1
        ph = i0 - 3 * j
        w = [words[min(max(j + q, 0), rows - 1)] for q in (0, 1)]
        six = [*w[0], *w[1]]
        four = six[ph:ph + 4]
        for k in range(4):
            if 0 <= i0 + k < n_words:
                out[4 * c + k] = four[k]
    return out


@pytest.mark.parametrize("head_words", [0, 1, 2, 3])
def test_shard_header_chunks_cover_every_word_once(head_words):
    """The kernel's chunk arithmetic (``header_chunk`` and its caller) in
    numpy, at every alignment a 4-byte-aligned span can have and every
    tile height: each word of the span is written with packet i // 3's
    part i % 3, and nothing outside it."""
    for rows in range(1, 65):
        words = np.arange(3 * rows).reshape(rows, 3) + 1000
        out = _chunk_model(head_words, rows, words)
        span = out[head_words:head_words + 3 * rows]
        np.testing.assert_array_equal(span, words.reshape(-1))
        assert (out[:head_words] == -1).all()
        assert (out[head_words + 3 * rows:] == -1).all()


def test_example_batch_is_the_reference_batch():
    for a, b in zip(mesh.example_batch(4, 8, 32, seed=3),
                    ref_mesh.example_batch(4, 8, 32, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_mesh_factories_validate():
    with pytest.raises(ValueError):
        mesh.make_relay_mesh(CPU8, src=3, sub=2, win=2)
    m = mesh.make_relay_mesh(CPU8, sub=2)
    assert m.shape == {"src": 4, "sub": 2, "win": 1} and m.size == 8
    step = mesh.sharded_relay_step(mesh.make_relay_mesh(CPU8, src=8))
    with pytest.raises(ValueError, match="divisible"):
        step(*mesh.example_batch(n_src=4))


def test_megabatch_mesh_is_none_on_one_device():
    assert mesh.make_megabatch_mesh(1, CPU8) is None
    assert mesh.make_megabatch_mesh(0, CPU8[:1]) is None
    m = mesh.make_megabatch_mesh(3, CPU8)
    assert m.shape == {"src": 3, "sub": 1, "win": 1}
    assert mesh.make_megabatch_mesh(0, CPU8).size == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.make_megabatch_mesh()
    # a server on the CPU or with megabatch_devices=1 keeps one device
    for n in (0, 1, 8):
        app = StreamingServer(ServerConfig(megabatch_devices=n),
                              device="cpu")
        assert app.megabatch_mesh is None and app.stats()["mesh"] is None
        assert app.megabatch.stats()["mesh_devices"] == 0


@needs_devices
def test_cluster_mesh_span_and_summary_equal_the_reference():
    got = distributed.make_cluster_mesh(sub=2, win=2, devices=CPU8)
    want = ref_distributed.make_cluster_mesh(sub=2, win=2)
    assert got.shape == {"src": 2, "sub": 2, "win": 2}
    assert distributed.process_span(got) == \
        ref_distributed.process_span(want)
    assert distributed.mesh_summary(got) == ref_distributed.mesh_summary(want)
    with pytest.raises(ValueError):
        distributed.make_cluster_mesh(sub=3, devices=CPU8)
    h, _m, kf, _t = mesh.sharded_relay_step(got)(
        *mesh.example_batch(n_src=2, n_sub=4, n_pkt=32))
    assert tuple(h.shape) == (2, 4, 32, 12) and int(kf[0]) >= 0


def test_init_from_env_noop_without_fleet(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_from_env() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_from_env(num_processes=2)


def test_rows_per_shard_equals_the_reference():
    for n in range(0, 40):
        for d in (1, 2, 3, 8):
            assert staging.rows_per_shard(n, d) == \
                ref_staging.rows_per_shard(n, d)


@needs_devices
def test_per_device_window_steps_equal_one_device_and_jax():
    rng = np.random.default_rng(4)
    win = rng.integers(0, 256, (16, 32, staging.ROW_STRIDE), np.uint8)
    win[:, :, 96:100] = 0
    lens = rng.integers(0, 140, (16, 32)).astype("<i4")
    win[:, :, 96:100] = lens.view(np.uint8).reshape(16, 32, 4)
    state = rng.integers(0, 2**16, (16, 8, STATE_COLS)).astype(np.uint32)
    m = mesh.make_megabatch_mesh(8, CPU8)
    got = []
    for k, dev in enumerate(m.flat()):
        with relay_pipeline.on_device(dev):
            (res,) = relay_pipeline.megabatch_window_steps(
                [(torch.from_numpy(win[2 * k:2 * k + 2]),
                  torch.from_numpy(state[2 * k:2 * k + 2]))])
        got.append(res.numpy())
    got = np.concatenate(got)
    (one,) = relay_pipeline.megabatch_window_steps(
        [(torch.from_numpy(win), torch.from_numpy(state))])
    np.testing.assert_array_equal(got, one.numpy())
    want = np.asarray(ref_pipeline.megabatch_window_step(
        jax.device_put(win), state))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- the scheduler's mesh path
def _mk_stream(n_outputs: int, addrs, seed: int) -> RelayStream:
    """The reference test's stream (same outputs from the same seed), as
    a port stream."""
    ref = _ref_mk_stream(n_outputs, addrs, seed)
    st = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                     StreamSettings(bucket_delay_ms=0))
    for o in ref.outputs:
        out = CollectingOutput(ssrc=o.rewrite.ssrc,
                               out_seq_start=o.rewrite.out_seq_start,
                               out_ts_start=o.rewrite.out_ts_start)
        out.native_addr = o.native_addr
        st.add_output(out)
    return st


def _scenario(kind, wire: _Wire, send_fd: int, *, make_stream=_mk_stream,
              engine=None, scheduler=None):
    """Mixed shapes, bucket growth, a mid-run join and a mid-run stream
    teardown (the reference's mesh scenario).  ``kind``: None = per-stream
    stepping, else the scheduler ``scheduler(kind)`` makes."""
    engine = engine or (lambda: FanoutEngine(egress_fd=send_fd,
                                             device="cpu"))
    shapes = [(5, 3, 0), (9, 4, 100), (17, 5, 200)]  # (S, burst, seed)
    streams = [make_stream(s, wire.addrs, seed) for s, _, seed in shapes]
    engines = [engine() for _ in streams]
    sched = None if kind is None else scheduler(kind)
    live = [streams[0]]
    t, seq = 1000, 0
    for wake in range(24):
        if wake == 4:
            live.append(streams[1])
        if wake == 8:
            live.append(streams[2])
        if wake == 12:
            o = type(streams[0].outputs[0])(ssrc=0xABCD, out_seq_start=77)
            o.native_addr = wire.addrs[0]
            streams[0].add_output(o)
        if wake == 18:
            live.remove(streams[1])
        pairs = [(s, engines[streams.index(s)]) for s in live]
        for s in live:
            _S, burst, _seed = shapes[streams.index(s)]
            for _ in range(burst):
                s.push_rtp(vid_pkt(seq, seq * 90,
                                   nal_type=5 if seq % 25 == 0 else 1), t)
                seq += 1
        if sched is not None:
            sched.begin_wake(pairs, t)
        for s, eng in pairs:
            eng.megabatch_owned = sched is not None
            eng.step(s, t)
        if sched is not None:
            sched.end_wake(pairs, t)
        wire.drain()
        t += 20
    if sched is not None:
        sched.drain()
    wire.drain()
    return engines, sched


def _port_scheduler(m):
    return MegabatchScheduler(device="cpu", mesh=m)


@needs_native
def test_mesh_wire_bytes_equal_the_per_stream_path_and_the_reference():
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    wires = [_Wire(6) for _ in range(4)]
    try:
        _scenario(None, wires[0], send.fileno(),
                  make_stream=_ref_mk_stream,
                  engine=lambda: RefEngine(egress_fd=send.fileno()))
        _scenario(None, wires[1], send.fileno())
        _e, one = _scenario(False, wires[2], send.fileno(),
                            scheduler=lambda _k: _port_scheduler(None))
        m = mesh.make_megabatch_mesh(8, CPU8)
        engines, sched = _scenario(m, wires[3], send.fileno(),
                                   scheduler=_port_scheduler)
        for w in wires[1:]:
            assert [len(r) for r in w.rx] == [len(r) for r in wires[0].rx]
            for ra, rb in zip(wires[0].rx, w.rx):
                assert ra == rb
        assert sum(len(r) for r in wires[3].rx) > 0
        assert sched.sharded_passes > 0 and one.sharded_passes == 0
        assert sched.mismatches == 0 and sched.mesh_dispatch_errors == 0
        assert sum(e.device_param_refreshes for e in engines) == 0
        st = sched.stats()
        assert st["mesh_devices"] == 8 and st["window_calls"] > 0
    finally:
        for w in wires:
            w.close()
        send.close()


@needs_native
def test_mesh_uneven_stream_count_pads_and_masks():
    """5 streams over 2 shards: rows_per 4 puts 4 streams on shard 0 and
    1 (+3 zero rows) on shard 1; the wire equals the per-stream path's;
    both shards ran real rows; a bucket of padding only is not launched."""
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    wire_a, wire_b = _Wire(5), _Wire(5)

    def run(m, wire):
        streams = [_mk_stream(4, wire.addrs, 10 + i) for i in range(5)]
        engines = [FanoutEngine(egress_fd=send.fileno(), device="cpu")
                   for _ in streams]
        sched = None if m is None else _port_scheduler(m)
        t, seq = 1000, 0
        for _wake in range(10):
            for s in streams:
                for _ in range(3):
                    s.push_rtp(vid_pkt(seq, seq * 90), t)
                    seq += 1
            pairs = list(zip(streams, engines))
            if sched is not None:
                sched.begin_wake(pairs, t)
            for s, eng in pairs:
                eng.megabatch_owned = sched is not None
                eng.step(s, t)
            if sched is not None:
                sched.end_wake(pairs, t)
            wire.drain()
            t += 20
        if sched is not None:
            sched.drain()
        wire.drain()
        return sched

    calls = []
    real = megabatch.MegabatchScheduler._dispatch_shards

    def spy(self, buckets, devs):
        calls.append([len(e) for e, _p, _s in buckets])
        assert len(devs) == 2
        return real(self, buckets, devs)

    try:
        run(None, wire_a)
        m = mesh.make_megabatch_mesh(2, CPU8)
        megabatch.MegabatchScheduler._dispatch_shards = spy
        try:
            sched = run(m, wire_b)
        finally:
            megabatch.MegabatchScheduler._dispatch_shards = real
        for ra, rb in zip(wire_a.rx, wire_b.rx):
            assert ra == rb
        assert sum(len(r) for r in wire_b.rx) > 0
        assert sched.sharded_passes > 0 and sched.mismatches == 0
        assert [5] in calls
        # one window call a shard with real rows: both shards each wake
        assert sched.window_calls >= 2 * len(calls)
    finally:
        wire_a.close()
        wire_b.close()
        send.close()


def test_mesh_throughput_harness_runs_both_modes_on_two_cpu_shards():
    """``measure_mesh_throughput`` drives the mesh and the one-device
    scheduler in turns over real UDP egress: both send, the mesh side
    sharded, no wire mismatch."""
    from easydarwin_tpu_torch.parallel.megabench import (
        measure_mesh_throughput)
    out = measure_mesh_throughput(2, n_streams=4, n_sub=4, burst=4,
                                  seconds=0.3, devices=CPU8[:2],
                                  device="cpu")
    assert out["n_devices"] == 2 and out["wakes"] > 0
    assert out["packets_per_sec"] > 0 < out["single_device_packets_per_sec"]
    assert out["sharded_passes"] > 0 and out["wire_mismatches"] == 0
    assert "note" not in out
    one = measure_mesh_throughput(1, n_streams=2, n_sub=2, burst=2,
                                  seconds=0.1, devices=CPU8[:2],
                                  device="cpu")
    assert one["n_devices"] == 1 and one["sharded_passes"] == 0
    assert one["scaling_efficiency"] == 1.0 and "note" in one


def test_a_failed_mesh_dispatch_is_counted_and_raised(monkeypatch):
    m = mesh.make_megabatch_mesh(2, CPU8)
    sched = _port_scheduler(m)

    def boom(_pairs):
        raise RuntimeError("shard launch failed")

    st = _mk_stream(3, [("127.0.0.1", 9)], 1)
    for k in range(4):
        st.push_rtp(vid_pkt(k, k * 90, 5 if k == 0 else 1), 1000)
    eng = FanoutEngine(device="cpu")
    pairs = [(st, eng)]
    sched.begin_wake(pairs, 1000)              # the prime pass, one device
    monkeypatch.setattr(sched, "_window_steps", boom)
    with pytest.raises(RuntimeError, match="shard launch failed"):
        sched.end_wake(pairs, 1000)
    assert sched.stats()["mesh_dispatch_errors"] == 1


# ------------------------------------------------------------- gloo, 2 ranks
_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from easydarwin_tpu_torch.parallel import distributed, mesh
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert distributed.init_from_env(f"127.0.0.1:{port}", 2, rank,
                                     device="cpu")
    m = distributed.make_cluster_mesh(win=2, devices=["cpu", "cpu"])
    span = distributed.process_span(m)
    batch = np.load(out + ".in.npz")
    h, mk, kf, tot = mesh.sharded_relay_step(m, 40)(
        *(batch[k] for k in ("prefix", "length", "age", "state",
                             "buckets")))
    np.savez(f"{out}.{rank}.npz", headers=h.numpy(), mask=mk.numpy(),
             newest=kf.numpy(), total=tot.numpy())
    print(json.dumps(span))
    torch.distributed.destroy_process_group()
""")


@needs_devices
def test_gloo_two_ranks_all_reduce_to_the_jax_result(tmp_path):
    """Two processes over gloo, each with two CPU shards of a (2, 1, 2)
    cluster mesh: each runs its own src row; the keyframe max and the
    eligible sum are all-reduced; every process's blocks and the reduced
    scalars equal the JAX mesh's on the same batch.  The two processes
    have 60 s."""
    batch = _short_rows_batch(2, 8, 32, seed=9)
    base = str(tmp_path / "b8")
    np.savez(base + ".in.npz", prefix=batch[0], length=batch[1],
             age=batch[2], state=batch[3], buckets=batch[4])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(port), base], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        span = json.loads(out.strip().splitlines()[-1])
        assert span["num_processes"] == 2 and span["local_devices"] == 2
        assert span["non_src_axis_crosses_hosts"] is False
    ref = ref_mesh.make_relay_mesh(jax.devices()[:4], src=2, win=2)
    want = [np.asarray(a) for a in ref_mesh.sharded_relay_step(ref, 40)(
        *ref_mesh.shard_args(ref, *batch))]
    for r in range(2):
        got = np.load(f"{base}.{r}.npz")
        np.testing.assert_array_equal(got["newest"], want[2])
        assert int(got["total"]) == int(want[3])
        np.testing.assert_array_equal(got["headers"][r], want[0][r])
        np.testing.assert_array_equal(got["mask"][r], want[1][r])
        assert not got["headers"][1 - r].any()      # the other rank's row
