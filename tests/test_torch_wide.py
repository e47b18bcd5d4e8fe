"""Shapes past one kernel launch's limits ≡ the JAX package's, on the CPU.

The port's kernels keep their limits (B4: K <= 64 rows; B7: R <= 8 rungs
and N <= 2^24 blocks), but the functions callers use do not: the
reference bounds neither.  ``models.relay_pipeline.fec_parity_window_step``
runs K in groups of 64 rows and XORs the partial products (addition in
GF(256) is XOR), and ``ops.transform_kernel.requant_rungs`` runs R in
groups of 8 and N in chunks, concatenating the rungs and summing the
nonzero counts.  Every comparison is exact: GF(256) bytes, and the
rungs against JAX ``requantize`` rung by rung (the JAX pipeline's fused
rungs differ from its own ``requantize`` on a few levels in ten
thousand, so that is the oracle the port is held to).
"""

import zlib

import numpy as np
import pytest
import torch

from easydarwin_tpu.models.relay_pipeline import \
    fec_parity_window_step as ref_parity_step
from easydarwin_tpu.models.transcode_pipeline import \
    TranscodeConfig as RefConfig
from easydarwin_tpu.models.transcode_pipeline import \
    TranscodePipeline as RefPipeline
from easydarwin_tpu.ops import transform as ref_tf
from easydarwin_tpu.storage.codec import StripeCodec as RefCodec
from easydarwin_tpu_torch.models import TranscodeConfig, TranscodePipeline
from easydarwin_tpu_torch.models.relay_pipeline import fec_parity_window_step
from easydarwin_tpu_torch.ops import fec_kernel, kernel_lib
from easydarwin_tpu_torch.ops import transform_kernel as tk
from easydarwin_tpu_torch.relay.fec import coeff_rows
from easydarwin_tpu_torch.storage.codec import StripeCodec


def _blobs(k, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=300 + (7 * i) % 97,
                         dtype=np.uint8).tobytes() for i in range(k)]


# ------------------------------------------------------------------ C3 · B4
@pytest.mark.parametrize("k", [65, 100, 130])
def test_stripe_parity_past_64_shards_equals_the_reference(k):
    blobs = _blobs(k, k)
    port = StripeCodec(k, 2, device="cpu")
    parity = port.parity(blobs)
    assert parity == RefCodec(k, 2, use_device=False).parity(blobs)
    assert port.device_passes == 1 and port.oracle_mismatches == 0


@pytest.mark.parametrize("k", [65, 100, 130])
def test_stripe_two_loss_reconstruct_past_64_shards(k):
    blobs = _blobs(k, 1000 + k)
    port = StripeCodec(k, 3, device="cpu")
    ref = RefCodec(k, 3, use_device=False)
    parity = port.parity(blobs)
    lens = [len(b) for b in blobs]
    crcs = [zlib.crc32(b) & 0xFFFFFFFF for b in blobs]
    lost = (3, k - 2)
    present = {i: b for i, b in enumerate(blobs) if i not in lost}
    present.update({k + p: blob for p, blob in enumerate(parity)})
    for with_crcs in (crcs, None):
        got = port.reconstruct(present, lens, asset="t", crcs=with_crcs)
        assert got == ref.reconstruct(present, lens, asset="t",
                                      crcs=with_crcs)
        assert got == {i: blobs[i] for i in lost}
    assert port.oracle_mismatches == 0


@pytest.mark.parametrize("k,b,r", [(65, 256, 2), (128, 512, 8),
                                   (130, 768, 3)])
def test_parity_step_past_64_rows_equals_jax(k, b, r):
    rng = np.random.default_rng(k * b + r)
    rows = rng.integers(0, 256, (k, b), dtype=np.uint8)
    rows[5] = 0                                   # a zero row
    coeff = coeff_rows(range(k), r)
    coeff[0, 70 % k] = 0                          # a zero coefficient
    got = fec_parity_window_step(torch.from_numpy(rows),
                                 torch.from_numpy(coeff))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (r, b)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_parity_step(rows, coeff)))
    assert kernel_lib.LAUNCHES["ed_gf_parity"] == 0


def test_parity_step_groups_are_kernel_sized(monkeypatch):
    """K = 130 makes three calls of the kernel's wrapper, each inside its
    limits, and the kernel's own wrapper still refuses K = 65."""
    calls = []
    real = fec_kernel.gf_parity

    def spy(rows, coeff):
        calls.append((tuple(rows.shape), tuple(coeff.shape),
                      coeff.is_contiguous()))
        return real(rows, coeff)
    monkeypatch.setattr(fec_kernel, "gf_parity", spy)
    rows = torch.zeros((130, 256), dtype=torch.uint8)
    coeff = torch.from_numpy(coeff_rows(range(130), 2))
    fec_parity_window_step(rows, coeff)
    assert calls == [((64, 256), (2, 64), True), ((64, 256), (2, 64), True),
                     ((2, 256), (2, 2), True)]
    with pytest.raises(ValueError, match="K=65"):
        real(torch.zeros((65, 256), dtype=torch.uint8),
             torch.ones((2, 65), dtype=torch.uint8))
    with pytest.raises(ValueError, match="coeff is"):
        fec_parity_window_step(rows, coeff[:, :129].contiguous())


# ------------------------------------------------------------------ C4 · B7
def _levels(n, seed):
    rng = np.random.default_rng(seed)
    lv = rng.integers(-300, 301, (n, 64)).astype(np.int32)
    lv.flat[:2] = (2047, -2047)
    return lv


@pytest.mark.parametrize("r", [9, 17])
def test_requant_rungs_past_8_equal_jax_requantize(r):
    lv = _levels(257, r)
    qi = ref_tf.quality_table(90)
    qr = np.stack([ref_tf.quality_table(q)
                   for q in np.linspace(95, 5, r).astype(int)])
    rungs, nonzeros = tk.requant_rungs(torch.from_numpy(lv),
                                       torch.from_numpy(qi),
                                       torch.from_numpy(qr))
    assert rungs.dtype == nonzeros.dtype == torch.int32
    assert tuple(rungs.shape) == (r, 257, 64)
    for k in range(r):
        want = np.asarray(ref_tf.requantize(lv, qi, qr[k]))
        np.testing.assert_array_equal(rungs[k].numpy(), want)
        assert int(nonzeros[k]) == np.count_nonzero(want)
    assert kernel_lib.LAUNCHES["ed_requant_rungs"] == 0


@pytest.mark.parametrize("r", [9, 17])
def test_transcode_pipeline_past_8_rungs_gives_the_reference(r):
    qualities = tuple(int(q) for q in np.linspace(90, 10, r))
    port = TranscodePipeline(TranscodeConfig(qualities=qualities),
                             device="cpu")
    ref = RefPipeline(RefConfig(qualities=qualities))
    (lv,) = port.example_args(300)
    out = port(lv)
    assert tuple(out["rungs"].shape) == (r, 300, 64)
    ref_out = ref(lv)
    assert tuple(np.asarray(ref_out["rungs"]).shape) == (r, 300, 64)
    qi = ref_tf.quality_table(90)
    for k, q in enumerate(qualities):
        want = np.asarray(ref_tf.requantize(lv, qi,
                                            ref_tf.quality_table(q)))
        np.testing.assert_array_equal(out["rungs"][k].numpy(), want)
        assert int(out["nonzeros"][k]) == np.count_nonzero(want)


def test_requant_chunks_equal_one_call_and_sum_counts(monkeypatch):
    lv = torch.from_numpy(_levels(2500, 5))
    qi = torch.from_numpy(ref_tf.quality_table(80))
    qr = torch.from_numpy(np.stack([ref_tf.quality_table(q)
                                    for q in (70, 40, 20)]))
    whole = tk.requant_rungs(lv, qi, qr)
    calls = []
    real = tk.requant_rungs_launch

    def spy(levels, qt_in, qt_rungs):
        calls.append((levels.shape[0], qt_rungs.shape[0]))
        return real(levels, qt_in, qt_rungs)
    monkeypatch.setattr(tk, "REQUANT_MAX_BLOCKS", 1000)
    monkeypatch.setattr(tk, "REQUANT_MAX_RUNGS", 2)
    monkeypatch.setattr(tk, "requant_rungs_launch", spy)
    chunked = tk.requant_rungs(lv, qi, qr)
    assert calls == [(1000, 2), (1000, 2), (500, 2), (1000, 1), (1000, 1),
                     (500, 1)]
    np.testing.assert_array_equal(chunked[0].numpy(), whole[0].numpy())
    np.testing.assert_array_equal(chunked[1].numpy(), whole[1].numpy())
    assert int(whole[1].sum()) == int((whole[0] != 0).sum())


def test_requant_one_launch_keeps_its_limits():
    lv = torch.zeros((4, 64), dtype=torch.int32)
    nine = torch.ones((tk.REQUANT_MAX_RUNGS + 1, 64))
    with pytest.raises(ValueError, match="qt_rungs"):
        tk.requant_rungs_launch(lv, torch.ones(64), nine)
    rungs, nonzeros = tk.requant_rungs(lv, torch.ones(64), nine)
    assert tuple(rungs.shape) == (9, 4, 64) and int(nonzeros.sum()) == 0
    rungs, nonzeros = tk.requant_rungs(lv[:0], torch.ones(64), nine)
    assert tuple(rungs.shape) == (9, 0, 64) and int(nonzeros.sum()) == 0
    for bad in (torch.ones((0, 64)), torch.ones(64), torch.ones((9, 63))):
        with pytest.raises(ValueError, match="qt_rungs"):
            tk.requant_rungs(lv, torch.ones(64), bad)
    assert kernel_lib.LAUNCHES["ed_requant_rungs"] == 0
