"""The port's stripe codec (``easydarwin_tpu_torch.storage.codec``) against
the reference (``easydarwin_tpu.storage.codec``) on the CPU: the same
parity shards on the same blobs, the same blobs back after one and two
losses (through the XOR fast path, the host product and B4's pass with
the crc32 check), a divergence counted and raised, and a loud failure
beyond the parity budget.  Every byte is compared exactly."""

import zlib

import numpy as np
import pytest

from easydarwin_tpu.storage.codec import StripeCodec as RefCodec
from easydarwin_tpu_torch.storage import codec as codec_mod
from easydarwin_tpu_torch.storage.codec import StorageError, StripeCodec


def _blobs(n, *, base=317, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=base + 41 * i,
                         dtype=np.uint8).tobytes() for i in range(n)]


@pytest.mark.parametrize("k,m", [(4, 2), (5, 4), (6, 3), (2, 1)])
def test_parity_equals_the_reference(k, m):
    blobs = _blobs(k, seed=k)
    port = StripeCodec(k, m, device="cpu")
    ref = RefCodec(k, m, use_device=False)
    parity = port.parity(blobs)
    assert parity == ref.parity(blobs)
    assert len(parity) == m
    assert all(len(p) == max(map(len, blobs)) for p in parity)
    acc = np.zeros(len(parity[0]), np.uint8)
    for b in blobs:                           # row 0 is the XOR row
        acc[:len(b)] ^= np.frombuffer(b, np.uint8)
    assert parity[0] == acc.tobytes()
    assert port.device_passes == 1
    assert port.oracle_mismatches == 0
    short = blobs[:k - 1] + [b""]
    assert port.parity(short) == ref.parity(short)


@pytest.mark.parametrize("lost", [(1,), (0, 1), (0, 3), (2,)])
@pytest.mark.parametrize("with_crcs", [True, False])
def test_reconstruct_equals_the_reference(lost, with_crcs):
    k, m = 4, 2
    blobs = _blobs(k)
    port = StripeCodec(k, m, device="cpu")
    ref = RefCodec(k, m, use_device=False)
    parity = port.parity(blobs)
    lens = [len(b) for b in blobs]
    crcs = [zlib.crc32(b) & 0xFFFFFFFF for b in blobs] if with_crcs \
        else None
    present = {i: b for i, b in enumerate(blobs) if i not in lost}
    for p, blob in enumerate(parity):
        if len(lost) == 1 and p == 0 and lost == (2,):
            continue                          # force a true RS solve
        present[k + p] = blob
    passes = port.device_passes
    got = port.reconstruct(present, lens, asset="t", crcs=crcs)
    assert got == ref.reconstruct(present, lens, asset="t", crcs=crcs)
    assert got == {i: blobs[i] for i in lost}
    wide = len(lost) > 1 or lost == (2,)
    assert port.device_passes == passes + int(wide)
    assert port.oracle_mismatches == 0


def test_single_loss_takes_the_xor_fast_path(monkeypatch):
    k, m = 4, 2
    codec = StripeCodec(k, m, device="cpu")
    blobs = _blobs(k)
    parity = codec.parity(blobs)

    def boom(*_a, **_k):
        raise AssertionError("a single loss must take the XOR fast path")
    monkeypatch.setattr(StripeCodec, "_wide_matmul", boom)
    present = {0: blobs[0], 2: blobs[2], 3: blobs[3], k: parity[0]}
    assert codec.reconstruct(present, [len(b) for b in blobs]) == \
        {1: blobs[1]}


def test_a_crc_divergence_is_counted_and_raised():
    k, m = 4, 2
    codec = StripeCodec(k, m, device="cpu")
    blobs = _blobs(k)
    parity = codec.parity(blobs)
    lens = [len(b) for b in blobs]
    crcs = [zlib.crc32(b) & 0xFFFFFFFF for b in blobs]
    present = {2: blobs[2], 3: blobs[3], k: parity[0], k + 1: parity[1]}
    with pytest.raises(StorageError, match="reconstruction"):
        codec.reconstruct(present, lens, crcs=[c ^ 1 for c in crcs])
    assert codec.oracle_mismatches == 1
    # nothing latched: the next products still run on the device
    passes = codec.device_passes
    assert codec.reconstruct(present, lens, crcs=crcs) == \
        {0: blobs[0], 1: blobs[1]}
    assert codec.parity(blobs) == parity
    assert codec.device_passes == passes + 2


def test_a_device_parity_mismatch_is_counted_and_raised(monkeypatch):
    codec = StripeCodec(4, 2, device="cpu")
    blobs = _blobs(4)
    monkeypatch.setattr(codec, "_device_product",
                        lambda coeff, rows: np.ones(
                            (coeff.shape[0], rows.shape[1]), np.uint8))
    with pytest.raises(StorageError, match="parity"):
        codec.parity(blobs)
    assert codec.oracle_mismatches == 1


def test_loud_failure_beyond_the_parity_budget(monkeypatch):
    k, m = 4, 2
    codec = StripeCodec(k, m, device="cpu")
    blobs = _blobs(k)
    parity = codec.parity(blobs)
    lens = [len(b) for b in blobs]
    with pytest.raises(StorageError):
        codec.reconstruct({3: blobs[3], k: parity[0], k + 1: parity[1]},
                          lens, asset="t")   # 3 missing > m = 2
    with pytest.raises(StorageError):
        codec.reconstruct({0: blobs[0]}, lens[:3])
    with pytest.raises(StorageError):
        codec.parity(blobs[:3])
    with pytest.raises(ValueError):
        StripeCodec(4, 9, device="cpu")
    monkeypatch.setattr(codec_mod, "gf_solve", lambda *a, **kw: None)
    with pytest.raises(StorageError, match="singular"):
        codec.reconstruct({1: blobs[1], 2: blobs[2], 3: blobs[3],
                           k: parity[0]}, lens)


def test_the_device_default_is_the_card():
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StripeCodec(4, 2)
    assert StripeCodec(4, 2, device="cpu").device == torch.device("cpu")
