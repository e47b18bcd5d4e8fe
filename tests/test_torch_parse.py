"""The port's packet parse and GOP reductions ≡ the JAX package's, bit-exact.

Same numpy inputs (the fuzz corpus from a seeded Generator) go through
``easydarwin_tpu.ops.parse.parse_packets`` (jnp), the Pallas kernel in
interpret mode, and the port's plain PyTorch parse on the CPU — which is
also what the K1 wrapper runs for a CPU tensor.
"""

import numpy as np
import pytest
import torch

from easydarwin_tpu.ops import gop as ref_gop
from easydarwin_tpu.ops import parse as ref_parse
from easydarwin_tpu.ops.parse_pallas import parse_packets_pallas
from easydarwin_tpu.protocol import nalu as ref_nalu
from easydarwin_tpu_torch.ops import gop, parse
from easydarwin_tpu_torch.ops import kernel_lib
from easydarwin_tpu_torch.ops.parse_kernel import (PARSE_TILE_ROWS,
                                                   parse_packets_kernel,
                                                   parse_tile_plan)
from easydarwin_tpu_torch.protocol import mjpeg, nalu, rtp
from easydarwin_tpu_torch.utils import synth


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _fuzz(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return synth.stage([synth.random_packet(rng) for _ in range(n)])


def _assert_fields_equal(out, ref, check_dtype=True):
    for key in parse.FIELDS:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
        if check_dtype:
            assert out[key].dtype == ref[key].dtype, key


def test_parse_matches_jnp_and_pallas_fuzzed():
    pre, ln = _fuzz(777, 600)                 # 600 rows cross the 256 tile pad
    ref = _np(ref_parse.parse_packets(pre, ln))
    pallas = _np(parse_packets_pallas(pre, ln, interpret=True))
    out = _np(parse.parse_packets(torch.from_numpy(pre), torch.from_numpy(ln)))
    _assert_fields_equal(out, ref)
    # the Pallas kernel returns seq as uint32; compare values
    _assert_fields_equal(out, pallas, check_dtype=False)


def test_k1_wrapper_runs_plain_version_on_cpu_tensors():
    pre, ln = _fuzz(5, 300)
    ref = _np(ref_parse.parse_packets(pre, ln))
    out = _np(parse_packets_kernel(torch.from_numpy(pre), torch.from_numpy(ln)))
    _assert_fields_equal(out, ref)


@pytest.mark.parametrize("width", [96, 97, 100])
@pytest.mark.parametrize("n_rows", [1, 63, 64, 256, 4097])
def test_k1_tile_plan_covers_every_row_once(n_rows, width):
    for addr in (0x10000, 0x10001, 0x1000F, 0x10000 + width):
        tiles = parse_tile_plan(n_rows, width, addr)
        assert len(tiles) == -(-n_rows // PARSE_TILE_ROWS)
        covered = []
        for lo, hi, head, interior, tail in tiles:
            assert 0 < hi - lo <= PARSE_TILE_ROWS
            covered += range(lo, hi)
            assert head + interior + tail == (hi - lo) * width
            start = addr + lo * width
            assert interior > 0 and (start + head) % 16 == 0
            assert interior % 16 == 0 and head < 16 and tail < 16
            assert (start % 16) + (hi - lo) * width <= \
                PARSE_TILE_ROWS * width + kernel_lib.BULK_ALIGN
        assert covered == list(range(n_rows))
    with pytest.raises(ValueError):
        parse_tile_plan(64, 1024, 0)


@pytest.mark.parametrize("codec,is_video", [("mjpeg", True), ("mjpeg", False),
                                            ("h264", False), ("JPEG", True)])
def test_parse_codecs_and_audio_match_reference(codec, is_video):
    pre, ln = _fuzz(11, 200)
    ref = _np(ref_parse.parse_packets(pre, ln, is_video=is_video, codec=codec))
    out = _np(parse.parse_packets(torch.from_numpy(pre), torch.from_numpy(ln),
                                  is_video=is_video, codec=codec))
    _assert_fields_equal(out, ref)


def test_parse_against_scalar_oracle():
    rng = np.random.default_rng(99)
    pkts = [synth.random_packet(rng) for _ in range(256)]
    pre, ln = synth.stage(pkts)
    out = _np(parse.parse_packets(torch.from_numpy(pre), torch.from_numpy(ln)))
    for i, pkt in enumerate(pkts):
        if len(pkt) >= 12:
            assert out["seq"][i] == rtp.peek_seq(pkt)
            assert out["timestamp"][i] == rtp.peek_timestamp(pkt)
            assert out["payload_start"][i] == rtp.header_size_cc_only(pkt)
        assert bool(out["keyframe_first"][i]) == nalu.is_keyframe_first_packet(pkt)
        assert nalu.is_keyframe_first_packet(pkt) == \
            ref_nalu.is_keyframe_first_packet(pkt)
        assert bool(out["frame_first"][i]) == nalu.is_frame_first_packet(pkt)
        assert bool(out["frame_last"][i]) == nalu.is_frame_last_packet(pkt)


def test_mjpeg_oracle_matches_device_classifier():
    rng = np.random.default_rng(4)
    pkts = [synth.random_packet(rng) for _ in range(128)]
    pre, ln = synth.stage(pkts)
    out = parse.parse_packets(torch.from_numpy(pre), torch.from_numpy(ln),
                              codec="mjpeg")
    got = out["frame_first"].numpy()
    assert got.tolist() == [mjpeg.is_frame_first_packet(p) for p in pkts]


def test_parse_rejects_narrow_prefix_and_unknown_codec():
    with pytest.raises(ValueError):
        parse.parse_packets(torch.zeros((4, 95), dtype=torch.uint8),
                            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        parse.normalize_codec("vp8")
    assert parse.normalize_codec(" AVC ") == ref_parse.normalize_codec(" AVC ")


def test_u32_boundary_helpers_roundtrip():
    v = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, -1, 1 << 33],
                     dtype=torch.int64)
    u = parse.u32_from_i64(v)
    assert u.dtype == torch.uint32
    assert parse.i64_from_u32(u).tolist() == [x & 0xFFFFFFFF for x in v.tolist()]


def test_gop_reductions_match_reference():
    rng = np.random.default_rng(21)
    for n in (1, 48, 48, 48, 48, 48):      # one jit shape besides n=1
        kf = rng.random(n) < 0.15
        valid = rng.random(n) < 0.9
        last = rng.random(n) < 0.3
        age = rng.integers(0, 20_000, n).astype(np.int32)
        t = [torch.from_numpy(a) for a in (kf, valid, last, age)]
        assert int(gop.newest_keyframe(t[0], t[1])) == \
            int(ref_gop.newest_keyframe(kf, valid))
        np.testing.assert_array_equal(
            gop.gop_window_mask(t[0], t[1], t[2]).numpy(),
            np.asarray(ref_gop.gop_window_mask(kf, valid, last)))
        assert int(gop.fast_start_indices(t[0], t[1], t[3], 10_000)) == \
            int(ref_gop.fast_start_indices(kf, valid, age, 10_000))


def test_gop_batched_rows_reduce_independently():
    kf = torch.tensor([[False, True, True], [False, False, False]])
    valid = torch.tensor([[True, True, False], [True, True, True]])
    assert gop.newest_keyframe(kf, valid).tolist() == [1, -1]
