"""GF(256) stripe codec: ``k`` window blobs → ``m`` parity shards, and back.

A copy of the reference's ``storage/codec.py`` without its ``obs``
counters and events, on the port's B4.  A stripe is ``k`` blobs
zero-padded on the byte axis to the widest; the ``m`` parity shards are
the Vandermonde rows ``C[p, i] = α^(i·p)`` (``relay.fec.coeff_rows`` over
``0..k-1``) times that ``[k, B]`` matrix, computed by
``models.relay_pipeline.fec_parity_window_step`` (the wire FEC's pass)
and checked row by row against the host product ``relay.fec.gf_matmul``:
a mismatch counts ``oracle_mismatches`` and raises ``StorageError``, so
no unchecked byte is returned.

Reconstruction solves for the missing rows: the survivors' contributions
are folded into one combined coefficient matrix (``gf_solve`` of the
small Vandermonde system, LOWEST parity indices first), applied as pure
XOR when every coefficient is 0 or 1 (a single loss through the XOR row)
and as one wide B4 product otherwise, checked against the manifest's
crc32s when it has them and against the host product when it does not.
More missing shards than surviving parity, a singular subset or a result
that fails its check raises ``StorageError``.

Unlike the reference, a failed device launch is not caught: it raises,
and no product moves to the host.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .. import resolve_device
from ..ops.staging import pow2
from ..relay.fec import coeff_for_indices, coeff_rows, gf_matmul, gf_solve


class StorageError(RuntimeError):
    """A stripe that cannot be encoded or byte-exactly reconstructed."""


class StripeCodec:
    """Encode/reconstruct one ``k + m`` stripe of window blobs, the wide
    products on ``device``."""

    def __init__(self, k: int, m: int, *,
                 device: str | torch.device = "cuda"):
        if not (1 <= k and 1 <= m <= 8):
            raise ValueError(f"bad stripe geometry k={k} m={m}")
        self.k = int(k)
        self.m = int(m)
        self.device = resolve_device(device)
        self.oracle_mismatches = 0
        self.device_passes = 0

    def _device_product(self, coeff: np.ndarray,
                        rows: np.ndarray) -> np.ndarray:
        """One B4 pass of pow2-padded ``coeff × rows`` on the device."""
        from ..models.relay_pipeline import fec_parity_window_step
        out = fec_parity_window_step(
            torch.from_numpy(rows).to(self.device),
            torch.from_numpy(coeff).to(self.device))
        self.device_passes += 1
        return out.cpu().numpy()

    def _mismatch(self, what: str) -> StorageError:
        """Count a product that failed its check; the error to raise."""
        self.oracle_mismatches += 1
        return StorageError(f"{what}: the device product fails its check")

    # ------------------------------------------------------------- encode
    def parity(self, blobs: list[bytes]) -> list[bytes]:
        """The ``m`` parity shard payloads over ``k`` data blobs (a short
        stripe pads with ``b""``), each the stripe width ``B = max(len)``
        (the padding's parity is 0, so trimming is free)."""
        if len(blobs) != self.k:
            raise StorageError(
                f"stripe wants {self.k} blobs, got {len(blobs)}")
        width = max([len(b) for b in blobs] + [1])
        b_pad = pow2(width, 256)
        rows = np.zeros((self.k, b_pad), np.uint8)
        for i, b in enumerate(blobs):
            if b:
                rows[i, :len(b)] = np.frombuffer(b, np.uint8)
        r_pad = pow2(self.m, 1)
        coeff = coeff_rows(range(self.k), r_pad)
        parity = self._device_product(coeff, rows)
        if not np.array_equal(parity, gf_matmul(coeff, rows)):
            raise self._mismatch("stripe parity")
        return [parity[p, :width].tobytes() for p in range(self.m)]

    # -------------------------------------------------------- reconstruct
    def reconstruct(self, present: dict[int, bytes], lens: list[int], *,
                    asset: str = "?",
                    crcs: list[int] | None = None) -> dict[int, bytes]:
        """Byte-exact blobs for every MISSING data index of one stripe.

        ``present`` maps shard index → payload: the surviving data shards
        (``idx < k``, exact blob bytes) and parity rows (``idx >= k``,
        stripe-width bytes); ``lens`` are the k blob lengths.  Returns
        ``{data_idx: blob}`` for each missing index; raises
        ``StorageError`` when the surviving parity cannot solve it.  With
        ``crcs`` (the blobs' crc32s) the wide product's result is checked
        against them, else against the host product."""
        k = self.k
        if len(lens) != k:
            raise StorageError(f"{asset}: manifest lens {len(lens)} != k")
        missing = [i for i in range(k) if i not in present]
        need = [i for i in missing if lens[i] > 0]
        out = {i: b"" for i in missing if lens[i] == 0}
        if not need:
            return out
        pav = sorted(i - k for i in present if i >= k)
        if len(need) > len(pav):
            raise StorageError(
                f"{asset}: {len(need)} data shards missing, only "
                f"{len(pav)} parity rows survive")
        # the LOWEST surviving parity indices: consecutive-from-0 rows are
        # a true Vandermonde system; an arbitrary subset can be singular
        n = len(need)
        idxs = pav[:n]
        ainv = gf_solve(coeff_for_indices(need, idxs),
                        np.eye(n, dtype=np.uint8))
        if ainv is None:
            raise StorageError(
                f"{asset}: singular parity subset {idxs} for {need}")
        # survivors stacked [chosen parity rows ∥ surviving data rows];
        # D_need = [A⁻¹ | A⁻¹·C_known] · stack
        width = max([len(v) for i, v in present.items() if i >= k]
                    + [max(lens)])
        known = [i for i in range(k) if i in present and lens[i] > 0]
        ccomb = ainv
        if known:
            ccomb = np.concatenate(
                [ainv, gf_matmul(ainv, coeff_for_indices(known, idxs))],
                axis=1)
        bufs = [present[p + k] for p in idxs] \
            + [present[i] for i in known]
        if int(ccomb.max(initial=0)) <= 1:
            # a single loss solved through the XOR row: every combined
            # coefficient is 0/1, so the apply is XOR over the survivors
            solved = np.zeros((n, width), np.uint8)
            for r in range(n):
                for i in np.flatnonzero(ccomb[r]):
                    b = bufs[i]
                    solved[r, :len(b)] ^= np.frombuffer(b, np.uint8)
        else:
            surv = np.zeros((len(bufs), width), np.uint8)
            for j, b in enumerate(bufs):
                surv[j, :len(b)] = np.frombuffer(b, np.uint8)
            solved = self._wide_matmul(ccomb, surv, need, lens, crcs)
        for j, i in enumerate(need):
            out[i] = solved[j, :lens[i]].tobytes()
        return out

    def _wide_matmul(self, ccomb: np.ndarray, surv: np.ndarray,
                     need: list[int], lens: list[int],
                     crcs: list[int] | None) -> np.ndarray:
        """``ccomb × surv`` on the device, checked against the crc32s
        when there are any and against the host product otherwise."""
        rows = np.zeros((pow2(surv.shape[0], 1), pow2(surv.shape[1], 256)),
                        np.uint8)
        rows[:surv.shape[0], :surv.shape[1]] = surv
        coeff = np.zeros((pow2(ccomb.shape[0], 1), rows.shape[0]), np.uint8)
        coeff[:ccomb.shape[0], :ccomb.shape[1]] = ccomb
        dev = self._device_product(coeff, rows)[:ccomb.shape[0],
                                                 :surv.shape[1]]
        if crcs:
            ok = all((zlib.crc32(dev[j, :lens[i]].tobytes()) & 0xFFFFFFFF)
                     == int(crcs[i]) for j, i in enumerate(need))
        else:
            ok = np.array_equal(dev, gf_matmul(ccomb, surv))
        if not ok:
            raise self._mismatch("stripe reconstruction")
        return dev


__all__ = ["StripeCodec", "StorageError"]
