"""The port's quality adaptation ≡ the JAX package's.

* ``QualityController`` takes the same levels, thins and thickens over
  seeded sequences of RR loss fractions and NADU buffer reports;
* ``ThinningFilter.admit`` keeps and drops the same packets of a pushed
  GOP at every level, with the same ``passthrough()`` on the way;
* an output's ``on_receiver_report`` and ``on_nadu`` move its filter as
  the reference's do.
"""

import numpy as np
import pytest

from easydarwin_tpu.relay import quality as ref_quality
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.ring import PacketRing as RefRing
from easydarwin_tpu_torch.relay import quality
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.ring import PacketRing
from easydarwin_tpu_torch.utils import synth


def test_constants_match_the_reference():
    for name in ("MAX_LEVEL", "LOSS_THIN_NOW", "LOSS_THIN_SLOW",
                 "NUM_LOSSES_TO_THIN", "LOSS_THICK_BELOW",
                 "NUM_CLEAN_TO_THICK", "NADU_DELAY_UNKNOWN",
                 "NADU_UNDERRUN_NOW_MS", "NADU_DELAY_LOW_MS",
                 "NADU_DELAY_COMFY_MS", "NADU_FREE_LOW_64B"):
        assert getattr(quality, name) == getattr(ref_quality, name), name


def _state(c):
    return (c.level, c._lossy_reports, c._clean_reports, c.thins,
            c.thickens)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_levels_match_over_seeded_reports(seed):
    rng = np.random.default_rng(seed)
    port, ref = quality.QualityController(), ref_quality.QualityController()
    levels = set()
    for i in range(400):
        if (i // 50) % 2:               # a clean stretch: thicken back
            rr = rng.random() < 0.5
            assert (port.on_receiver_report(0.01) if rr
                    else port.on_nadu(1500, 300)) == \
                (ref.on_receiver_report(0.01) if rr
                 else ref.on_nadu(1500, 300))
        elif rng.random() < 0.6:
            frac = float(rng.choice([0.0, 0.01, 0.03, 0.05, 0.1, 0.2, 0.3,
                                     0.35, 0.9, rng.random()]))
            assert port.on_receiver_report(frac) == \
                ref.on_receiver_report(frac)
        else:
            delay = int(rng.choice([0xFFFF, 0, 40, 41, 149, 150, 999, 1000,
                                    int(rng.integers(0, 3000))]))
            free = int(rng.choice([0, 1, 23, 24, 100,
                                   int(rng.integers(0, 1 << 16))]))
            assert port.on_nadu(delay, free) == ref.on_nadu(delay, free)
        assert _state(port) == _state(ref)
        levels.add(port.level)
    assert levels == set(range(quality.MAX_LEVEL + 1))


def _gop_flags(rng, ring_cls, fu_a: bool):
    """The ring classification of two GOPs of paced H.264 (single-NAL or
    FU-A frames) and an audio packet every third slot."""
    video, audio = ring_cls(256, is_video=True), ring_cls(256)
    pkts = []
    for g in range(2):
        pkts += synth.paced_gop(rng, seq0=100 * g, ts0=0, ssrc=1, frames=8,
                                packets_per_frame=3, body_len=(20, 60),
                                fu_a=fu_a)
    flags = []
    for i, p in enumerate(pkts):
        video.push(p, 0)
        flags.append(int(video.flags[i]))
        if i % 3 == 0:
            audio.push(synth.aac_packet(rng, i, 1024 * i, ssrc=2), 0)
            flags.append(int(audio.flags[len(audio) - 1]))
    return flags


@pytest.mark.parametrize("fu_a", [False, True], ids=["single_nal", "fu_a"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_thinning_admits_the_same_packets_at_every_level(level, fu_a):
    rng = np.random.default_rng(level)
    flags = _gop_flags(rng, PacketRing, fu_a)
    assert flags == _gop_flags(np.random.default_rng(level), RefRing, fu_a)
    port, ref = quality.ThinningFilter(), ref_quality.ThinningFilter()
    port.controller.level = ref.controller.level = level
    for i, f in enumerate(flags):
        if i == len(flags) // 2 and level:   # back to level 0 mid-GOP
            port.controller.level = ref.controller.level = 0
        assert port.admit(f) == ref.admit(f), i
        assert port.passthrough() == ref.passthrough(), i
        assert (port._frame_index, port._dropping_frame, port.dropped) == \
            (ref._frame_index, ref._dropping_frame, ref.dropped)
    assert (port.dropped > 0) == (level > 0)


def test_output_feedback_moves_its_filter_like_the_reference():
    port, ref = CollectingOutput(ssrc=1), RefOutput(ssrc=1)
    assert port.thinning.passthrough() and port.meta_field_ids is None
    feed = [("rr", 0.5), ("nadu", (30, 100)), ("rr", 0.0), ("nadu",
            (0xFFFF, 0)), ("rr", 0.12), ("rr", 0.12), ("rr", 0.12)]
    feed += [("rr", 0.0)] * 14 + [("nadu", (2000, 500))] * 7
    for what, arg in feed:
        if what == "rr":
            got, want = (port.on_receiver_report(arg),
                         ref.on_receiver_report(arg))
        else:
            got, want = port.on_nadu(*arg), ref.on_nadu(*arg)
        assert got == want == port.thinning.controller.level
        assert port.thinning.passthrough() == ref.thinning.passthrough()
    assert port.thinning.controller.thins == ref.thinning.controller.thins
