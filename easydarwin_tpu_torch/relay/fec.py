"""Lossy-UDP reliability tier: FEC parity windows and NACK → RTX replay.

A copy of the reference's ``relay/fec.py``, with the device pass on the
port's B4 (``ed_gf_parity``) and the reference's ``obs`` counters:
``fec_parity_packets_total{kind}``, the per-stream
``fec_overhead_ratio`` gauge (dropped with ``drop_overhead_gauge`` when a
player leaves), ``rtx_sent_total``, ``rtx_giveup_total`` (and one
``rtx.giveup`` event an output, at its first), the audience store's RTX
and FEC credits, ``fec_recovered_total`` and ``fec_solve_singular_total``
of the receiver model, and each device pass's
``tpu_pass_seconds{stage="fec_parity"}`` (from timing events around the
launch on a card) and its bytes in ``tpu_h2d_bytes_total`` and
``tpu_d2h_bytes_total``:

* **FEC parity as a GF(256) product.**  The fixed-slot ring is a dense
  ``[window, slot]`` uint8 matrix, so a window's parity is one product:
  XOR parity is the all-ones coefficient row, Reed-Solomon parity the
  Vandermonde rows ``C[p, i] = α^(d_i · p)`` (``coeff_rows``), through
  log/antilog tables.  The device computes parity over the RAW ring rows
  once per (stream, window) (``models.relay_pipeline.
  fec_parity_window_step``); the per-subscriber pieces, the rewritten
  12-byte headers and the 2-byte lengths, are host numpy.  The host
  product ``gf_matmul`` runs on every window: a device row that differs
  counts ``oracle_mismatches`` and raises ``FecOracleError``, so the wire
  never carries an unchecked row and the kernel is never silently off.
* **Parity packets** are RED/ULPFEC-shaped: an RTP header (its own
  ``fec_pt`` and seq space, the output's SSRC), a 12-byte FEC header
  (``snbase``, a 48-bit mask of protected seq offsets, count, parity
  index, kind) and the parity over ``len(2) ∥ header(12) ∥ payload`` of
  each protected wire packet.  They leave through ``out.send_bytes``.
* **NACK/RTX.**  The ring is the retransmission buffer: a generic NACK's
  lost OUTPUT seqs resolve through the inverse affine rewrite to live ring
  ids, and each replay is an RFC 4588 retransmission (PT ``rtx_pt``, a
  fresh RTX seq, the original seq as the first two payload bytes), paid
  from a per-output token bucket; an empty bucket is a counted give-up.
* **Closed loop.**  ``FecRateController`` walks each subscriber's
  overhead (0–30%, ``OVERHEAD_LADDER``) from its RR ``fraction_lost`` with
  the thinning controller's hysteresis; NADU buffer distress walks it
  down (parity is bitrate; such a receiver recovers through RTX).

``FecReceiver`` is the receiver model the tests and the loopback players
use: it rebuilds dropped packets byte for byte from parity (Gaussian
elimination over GF(256)) and from RTX replays.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs, resolve_device
from ..ops import staging

# ------------------------------------------------------------ GF(256) tables
#: the RS polynomial x^8+x^4+x^3+x^2+1 (0x11D), generator 2
_GF_POLY = 0x11D

GF_EXP = np.zeros(255, np.uint8)
_x = 1
for _i in range(255):
    GF_EXP[_i] = _x
    _x <<= 1
    if _x & 0x100:
        _x ^= _GF_POLY
GF_LOG = np.zeros(256, np.int32)
for _i in range(255):
    GF_LOG[int(GF_EXP[_i])] = _i
# log[0] stays 0 as a sentinel: every consumer masks zero operands
#: antilog table doubled, so ``log(a) + log(b)`` (at most 508) indexes it
#: without a modulo; 512 entries
GF_EXP512 = np.concatenate([GF_EXP, GF_EXP, GF_EXP[:2]]).astype(np.int32)


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) + int(GF_LOG[b])) % 255])


def gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(GF_EXP[(255 - int(GF_LOG[a])) % 255])


def gf_matmul(coeff: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """GF(256) matrix product with XOR accumulation, the host oracle:
    ``coeff [R, K] × rows [K, B] → [R, B]`` uint8, one gather and one XOR
    reduction per parity row."""
    coeff = np.asarray(coeff, np.uint8)
    rows = np.asarray(rows, np.uint8)
    lc = GF_LOG[coeff]                        # [R, K]
    lr = GF_LOG[rows]                         # [K, B]
    rows_zero = rows == 0                     # [K, B]
    out = np.empty((coeff.shape[0], rows.shape[1]), np.uint8)
    for p in range(coeff.shape[0]):
        t = GF_EXP512[lc[p][:, None] + lr].astype(np.uint8)
        t[rows_zero] = 0
        t[coeff[p] == 0, :] = 0
        np.bitwise_xor.reduce(t, axis=0, out=out[p])
    return out


def coeff_rows(deltas, n_parity: int) -> np.ndarray:
    """The Vandermonde coefficient matrix ``C[p, i] = α^(d_i · p)``.

    ``deltas`` are the protected packets' seq offsets from ``snbase``
    (distinct, < ``MASK_BITS``): with the offset as the evaluation point
    the receiver rebuilds the matrix from the FEC header's mask alone.
    Row 0 is all ones (the XOR row); distinct points make every square
    submatrix a Vandermonde determinant, so any ``m <= n_parity``
    erasures solve."""
    d = np.asarray(list(deltas), np.int64)
    p = np.arange(n_parity, dtype=np.int64)
    return GF_EXP512[(np.outer(p, d)) % 255].astype(np.uint8)


def gf_solve(a: np.ndarray, b: np.ndarray,
             caller: str = "unlabeled") -> np.ndarray | None:
    """Solve ``A · x = b`` over GF(256) (A ``[m, m]``, b ``[m, B]``) by
    Gaussian elimination; None when A is singular (which an arbitrary
    parity-index subset can be, never the consecutive-from-0 rows of
    ``coeff_rows``), counted under ``caller``."""
    a = np.array(a, np.uint8)
    b = np.array(b, np.uint8)
    m = a.shape[0]
    for col in range(m):
        piv = next((r for r in range(col, m) if a[r, col]), None)
        if piv is None:
            obs.FEC_SOLVE_SINGULAR.inc(caller=caller)
            return None
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            b[[col, piv]] = b[[piv, col]]
        inv = gf_inv(int(a[col, col]))
        a[col] = gf_matmul(np.array([[inv]], np.uint8), a[col][None, :])[0]
        b[col] = gf_matmul(np.array([[inv]], np.uint8), b[col][None, :])[0]
        for r in range(m):
            if r != col and a[r, col]:
                f = np.array([[a[r, col]]], np.uint8)
                a[r] ^= gf_matmul(f, a[col][None, :])[0]
                b[r] ^= gf_matmul(f, b[col][None, :])[0]
    return b


def coeff_for_indices(deltas, parity_idxs) -> np.ndarray:
    """``C[j, i] = α^(d_i · p_j)`` for the parity rows a receiver uses:
    the encoder matrix restricted to them."""
    d = np.asarray(list(deltas), np.int64)
    p = np.asarray(list(parity_idxs), np.int64)
    return GF_EXP512[np.outer(p, d) % 255].astype(np.uint8)


# ------------------------------------------------------------- wire format
#: FEC header: snbase u16 | mask 6B | count u8 | index u8 | kind u8 | rsvd
FEC_HDR_LEN = 12
#: offsets the protected-seq mask can hold (RFC 5109's 48-bit shape)
MASK_BITS = 48
KIND_XOR, KIND_RS = 0, 1
KIND_NAMES = {KIND_XOR: "xor", KIND_RS: "rs"}


def _mask_from_deltas(deltas) -> bytes:
    bits = 0
    for d in deltas:
        bits |= 1 << (MASK_BITS - 1 - d)
    return bits.to_bytes(6, "big")


def _deltas_from_mask(mask: bytes) -> list[int]:
    bits = int.from_bytes(mask, "big")
    return [d for d in range(MASK_BITS) if bits & (1 << (MASK_BITS - 1 - d))]


def build_parity_packet(*, fec_pt: int, fec_seq: int, ts: int, ssrc: int,
                        snbase: int, deltas, idx: int, kind: int,
                        payload: bytes) -> bytes:
    hdr = struct.pack("!BBHII", 0x80, fec_pt & 0x7F, fec_seq & 0xFFFF,
                      ts & 0xFFFFFFFF, ssrc & 0xFFFFFFFF)
    fec = struct.pack("!H", snbase & 0xFFFF) + _mask_from_deltas(deltas) \
        + bytes((len(list(deltas)) & 0xFF, idx & 0xFF, kind & 0xFF, 0))
    return hdr + fec + payload


def parse_parity_packet(data: bytes) -> dict | None:
    if len(data) < 12 + FEC_HDR_LEN:
        return None
    snbase = struct.unpack_from("!H", data, 12)[0]
    deltas = _deltas_from_mask(data[14:20])
    count, idx, kind = data[20], data[21], data[22]
    if len(deltas) != count or kind not in KIND_NAMES:
        return None
    return {"seq": struct.unpack_from("!H", data, 2)[0],
            "snbase": snbase, "deltas": deltas, "idx": idx,
            "kind": kind, "payload": data[12 + FEC_HDR_LEN:]}


def build_rtx_packet(orig_wire: bytes, *, rtx_pt: int, rtx_seq: int) -> bytes:
    """RFC 4588 retransmission of one rewritten wire packet: the header
    copied (marker kept), PT swapped to the RTX type, a fresh RTX seq, and
    the original OUTPUT seq as the first two payload bytes."""
    hdr = bytearray(orig_wire[:12])
    osn = bytes(hdr[2:4])
    hdr[1] = (hdr[1] & 0x80) | (rtx_pt & 0x7F)
    struct.pack_into("!H", hdr, 2, rtx_seq & 0xFFFF)
    return bytes(hdr) + osn + orig_wire[12:]


def restore_rtx_packet(data: bytes, *, media_pt: int) -> tuple[int, bytes]:
    """(original seq, original wire bytes) of an RTX packet."""
    osn = struct.unpack_from("!H", data, 12)[0]
    hdr = bytearray(data[:12])
    hdr[1] = (hdr[1] & 0x80) | (media_pt & 0x7F)
    struct.pack_into("!H", hdr, 2, osn)
    return osn, bytes(hdr) + data[14:]


# --------------------------------------------------------------- rate control
#: the per-subscriber overhead ladder the controller walks
OVERHEAD_LADDER = (0.0, 0.05, 0.10, 0.20, 0.30)
LOSS_FEC_NOW = 0.20          # one report at/above → step up immediately
LOSS_FEC_SLOW = 0.02         # this many...
NUM_LOSSY_TO_STEP = 3        # ...consecutive reports above SLOW → step up
LOSS_FEC_CLEAN = 0.005       # reports below this...
NUM_CLEAN_TO_STEP = 6        # ...this many times → step down
#: NADU buffer distress thresholds (the gauges quality.py reads)
NADU_DELAY_UNKNOWN = 0xFFFF
NADU_DISTRESS_DELAY_MS = 150
NADU_DISTRESS_FREE_64B = 24
#: parity rows per window, at most (8 of the 48 mask slots)
MAX_PARITY_ROWS = 8


class FecRateController:
    """Per-subscriber closed-loop FEC overhead: ``QualityController``'s
    hysteresis over ``OVERHEAD_LADDER``.  Loss walks the overhead up until
    the rung covers the observed loss (the rest is RTX's); clean reports
    decay it one rung at a time; NADU buffer distress walks it down."""

    def __init__(self, max_overhead: float = OVERHEAD_LADDER[-1]):
        self.max_overhead = max(0.0, min(max_overhead,
                                         OVERHEAD_LADDER[-1]))
        self._idx = 0
        self._lossy = 0
        self._clean = 0
        self.steps_up = 0
        self.steps_down = 0
        self.last_fraction_lost = 0.0

    @property
    def overhead(self) -> float:
        return min(OVERHEAD_LADDER[self._idx], self.max_overhead)

    def parity_rows(self, window: int, *, kind: int = KIND_RS) -> int:
        r = int(np.ceil(self.overhead * window))
        if kind == KIND_XOR:
            r = min(r, 1)
        return min(r, MAX_PARITY_ROWS)

    def on_receiver_report(self, fraction_lost: float) -> float:
        self.last_fraction_lost = float(fraction_lost)
        if fraction_lost >= LOSS_FEC_NOW:
            self._step(+1)
            self._lossy = self._clean = 0
            return self.overhead
        if fraction_lost >= LOSS_FEC_SLOW:
            self._lossy += 1
            self._clean = 0
            # climb only while the rung undershoots the observed loss
            if self._lossy >= NUM_LOSSY_TO_STEP \
                    and fraction_lost > self.overhead:
                self._step(+1)
                self._lossy = 0
        elif fraction_lost <= LOSS_FEC_CLEAN:
            self._clean += 1
            self._lossy = 0
            if self._clean >= NUM_CLEAN_TO_STEP:
                self._step(-1)
                self._clean = 0
        else:
            self._lossy = self._clean = 0
        return self.overhead

    def on_nadu(self, playout_delay_ms: int, free_buffer_64b: int) -> float:
        """Buffer distress shifts the split toward RTX: one rung down per
        run of distressed reports."""
        delay_known = playout_delay_ms != NADU_DELAY_UNKNOWN
        distressed = ((delay_known
                       and playout_delay_ms < NADU_DISTRESS_DELAY_MS)
                      or free_buffer_64b == 0
                      or 0 < free_buffer_64b < NADU_DISTRESS_FREE_64B)
        if distressed:
            self._lossy = 0
            self._clean += 1
            if self._clean >= NUM_LOSSY_TO_STEP:
                self._step(-1)
                self._clean = 0
        return self.overhead

    def _step(self, d: int) -> None:
        new = max(0, min(len(OVERHEAD_LADDER) - 1, self._idx + d))
        while new > 0 and OVERHEAD_LADDER[new] > self.max_overhead:
            new -= 1
        if new > self._idx:
            self.steps_up += 1
        elif new < self._idx:
            self.steps_down += 1
        self._idx = new


@dataclass(frozen=True)
class FecConfig:
    """The tier's tunables (the server's ``fec_*`` keys), and the device
    of its parity pass."""

    window: int = 16              # media packets per FEC window
    max_overhead: float = 0.30    # parity budget ceiling (ratio of window)
    kind: str = "rs"              # "rs" | "xor" (xor caps parity at 1 row)
    payload_type: int = 127       # parity packets' RTP PT
    rtx_payload_type: int = 126   # RTX replays' RTP PT
    rtx_budget_per_sec: float = 64.0   # token refill per output
    rtx_burst: int = 32                # token bucket depth
    device: str = "cuda"          # where the parity pass runs

    @property
    def kind_code(self) -> int:
        return KIND_XOR if self.kind == "xor" else KIND_RS

    def validate(self) -> "FecConfig":
        if not 2 <= self.window <= MASK_BITS:
            raise ValueError(f"fec_window must be 2..{MASK_BITS}, "
                             f"got {self.window}")
        if self.kind not in ("rs", "xor"):
            raise ValueError(f"fec_kind must be rs|xor, got {self.kind!r}")
        for name, pt in (("fec_payload_type", self.payload_type),
                         ("rtx_payload_type", self.rtx_payload_type)):
            if not 0 <= pt <= 127:
                raise ValueError(f"{name} must be 0..127, got {pt}")
        if self.payload_type == self.rtx_payload_type:
            # receivers would parse parity as RTX, or the other way round
            raise ValueError(
                f"fec_payload_type and rtx_payload_type must differ "
                f"(both {self.payload_type})")
        return self


class FecOutputState:
    """Per-subscriber tier state riding on an output as ``out.fec``: the
    controller, the parity and RTX seq spaces and the RTX token bucket.
    Attached at SETUP; registered with the stream's ``StreamFec`` at
    PLAY."""

    def __init__(self, cfg: FecConfig):
        self.cfg = cfg
        self.controller = FecRateController(cfg.max_overhead)
        self.fec_seq = 0
        self.rtx_seq = 0
        self.next_window: int | None = None    # set at stream registration
        self.parity_sent = 0
        self.rtx_sent = 0
        self.rtx_giveups = 0
        #: the first give-up's event was emitted (one an output)
        self._giveup_reported = False
        self._tokens = float(cfg.rtx_burst)
        self._last_refill_ms: int | None = None

    def refill(self, now_ms: int) -> None:
        if self._last_refill_ms is None:
            self._last_refill_ms = now_ms
            return
        dt = max(now_ms - self._last_refill_ms, 0) / 1000.0
        self._last_refill_ms = now_ms
        self._tokens = min(self._tokens + dt * self.cfg.rtx_budget_per_sec,
                           float(self.cfg.rtx_burst))

    def take_rtx_token(self, now_ms: int) -> bool:
        self.refill(now_ms)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class FecOracleError(RuntimeError):
    """A window's device parity differs from the host product."""


class StreamFec:
    """Per-stream FEC engine: window accounting, ONE device parity pass per
    (window, stream) shared by every subscriber, the host oracle, and
    per-output parity emission.

    Windows sit on the absolute-id grid (window ``w`` covers ring ids
    ``[w·k, (w+1)·k)``), so every subscriber of a stream shares the same
    protected sets.  ``tick`` runs at the head of ``relay_rtcp``, which
    ends every engine's pass.  The device pass stages the window's rows
    in a ``staging.PinnedStage``, uploads them on the current stream,
    launches B4 there and copies the parity back, then waits on that
    stream's event; ``stage_ns``, ``kernel_ns`` and ``oracle_ns`` sum the
    host time of the three legs."""

    #: windows of cached parity kept: covers tick()'s per-output catch-up
    #: budget (8), so a backlog of several subscribers reuses the passes
    CACHE_WINDOWS = 8

    def __init__(self, stream, cfg: FecConfig):
        self.stream = stream
        self.cfg = cfg.validate()
        self._states: list[tuple[object, FecOutputState]] = []
        #: window id → (slots, deltas, seqs, lens, max_len, parity), or
        #: None for a skipped window
        self._cache: dict[int, tuple | None] = {}
        self._cached_rows: dict[int, int] = {}     # window → parity rows
        self.oracle_mismatches = 0
        self.windows_emitted = 0
        self.windows_skipped = 0
        self.device_passes = 0
        self.stage_ns = 0
        self.kernel_ns = 0
        self.oracle_ns = 0
        self.parity_sent = 0
        self.rtx_sent = 0
        self.rtx_giveups = 0
        self._device: torch.device | None = None
        self._stage: staging.PinnedStage | None = None

    #: the counters ``drain_counters`` hands over
    COUNTERS = ("parity_sent", "windows_emitted", "windows_skipped",
                "device_passes", "oracle_mismatches", "rtx_sent",
                "rtx_giveups", "stage_ns", "kernel_ns", "oracle_ns")

    def drain_counters(self) -> dict:
        """The counters, reset to 0: a server folds a departing stream's figures into its totals once."""
        out = {k: getattr(self, k) for k in self.COUNTERS}
        for k in self.COUNTERS:
            setattr(self, k, 0)
        return out

    # -- registration -------------------------------------------------
    def add_output(self, out) -> None:
        f = getattr(out, "fec", None)
        if f is None:
            return
        if self.stream.info.payload_type in (f.cfg.payload_type,
                                             f.cfg.rtx_payload_type):
            # the media PT collides with the parity/RTX PT: receivers
            # would parse parity as media, so this stream stays
            # unprotected (config validation cannot know per-SDP PTs)
            out.fec = None
            return
        if f.next_window is None:
            # the first FULL window after the join: parity describes only
            # packets the output sent
            k = self.cfg.window
            f.next_window = (self.stream.rtp_ring.head + k - 1) // k
        self._states.append((out, f))

    def remove_output(self, out) -> None:
        self._states = [(o, f) for o, f in self._states if o is not out]

    @property
    def outputs(self) -> list:
        return [o for o, _ in self._states]

    # -- the per-pass hook ---------------------------------------------
    def tick(self, now_ms: int) -> int:
        """Move every subscriber's window cursor past the windows it has
        sent whole, emitting their parity; returns parity packets sent.
        At most 8 windows a subscriber a call."""
        if not self._states:
            return 0
        ring = self.stream.rtp_ring
        k = self.cfg.window
        sent = 0
        max_ratio = 0.0
        for out, f in self._states:
            max_ratio = max(max_ratio, f.controller.overhead)
            if out.bookmark is None or f.next_window is None:
                continue
            if not out.thinning.passthrough():
                # a thinned output dropped frames on purpose: parity over
                # packets it never sent would "recover" them; hold the
                # cursor at the live edge until it is passthrough again
                f.next_window = max(f.next_window, ring.head // k)
                continue
            for _ in range(8):             # per-pass window budget
                w = f.next_window
                end = (w + 1) * k
                if end > ring.head or out.bookmark < end:
                    break
                if w * k >= ring.tail:
                    sent += self._emit_window(out, f, w, now_ms)
                f.next_window = w + 1
        for w in [w for w in self._cache
                  if w < min((f.next_window or 0)
                             for _o, f in self._states)
                  - self.CACHE_WINDOWS]:
            self._cache.pop(w, None)
            self._cached_rows.pop(w, None)
        if self.stream.session_path is not None:
            # set every pass: a departed player's close drops the gauge of
            # the whole path, and a surviving FEC player sets it again
            obs.FEC_OVERHEAD_RATIO.set(
                round(max_ratio, 4), path=self.stream.session_path,
                track=str(self.stream.info.track_id))
        return sent

    # -- window parity --------------------------------------------------
    def _window_rows(self, w: int):
        """(slots, deltas, seqs, lens, max_len) of window ``w``'s
        protected packets, or None when the window cannot be protected
        (empty, seq offsets past the mask, duplicate seqs)."""
        ring = self.stream.rtp_ring
        k = self.cfg.window
        ids = np.arange(w * k, (w + 1) * k)
        ids = ids[(ids >= ring.tail) & (ids < ring.head)]
        if len(ids) == 0:
            return None
        slots = (ids % ring.capacity).astype(np.int64)
        lens = ring.length[slots]
        keep = lens >= 12
        if not keep.any():
            return None
        slots, lens = slots[keep], lens[keep]
        seqs = ring.seq[slots].astype(np.int64)
        deltas = (seqs - seqs[0]) & 0xFFFF
        if deltas.max() >= MASK_BITS or len(set(deltas.tolist())) != len(deltas):
            self.windows_skipped += 1
            return None
        return slots, deltas.tolist(), seqs, lens, int(lens.max())

    def _evict(self) -> None:
        # a HARD bound, oldest first: tick()'s min(next_window) prune does
        # not move while one subscriber is stalled
        while len(self._cache) > self.CACHE_WINDOWS:
            oldest = min(self._cache)
            self._cache.pop(oldest, None)
            self._cached_rows.pop(oldest, None)

    def _window_parity(self, w: int, n_parity: int):
        """B4's parity over window ``w``'s ring rows, host oracle checked
        (a differing row raises ``FecOracleError``), cached per window
        (recomputed only when a subscriber needs more parity rows than
        cached)."""
        if w in self._cache and self._cached_rows.get(w, 0) >= n_parity:
            return self._cache[w]
        meta = self._window_rows(w)
        if meta is None:
            self._cache[w] = None
            self._cached_rows[w] = MAX_PARITY_ROWS
            self._evict()
            return None
        slots, deltas, seqs, lens, max_len = meta
        k = self.cfg.window
        # the byte axis pow2-padded (the one rounding rule, ops.staging)
        b_pad = staging.pow2(max_len, 256)
        r_pad = staging.pow2(n_parity, 1)
        coeff = np.zeros((r_pad, k), np.uint8)
        coeff[:, :len(deltas)] = coeff_rows(deltas, r_pad)
        rows, parity = self._device_parity(slots, lens, coeff, b_pad)
        t0 = time.perf_counter_ns()
        same = np.array_equal(parity, gf_matmul(coeff, rows))
        self.oracle_ns += time.perf_counter_ns() - t0
        if not same:
            self.oracle_mismatches += 1
            raise FecOracleError(
                f"window {w}: device parity differs from the host product")
        entry = (slots, deltas, seqs, lens, max_len, parity)
        self._cache[w] = entry
        self._cached_rows[w] = r_pad
        self._evict()
        return entry

    def _device_parity(self, slots, lens, coeff, b_pad: int):
        """(host rows, device parity) of one window: the rows staged into
        pinned memory, uploaded on the current stream, B4 launched there,
        the parity copied back, and that stream's event waited on."""
        from ..models.relay_pipeline import fec_parity_window_step
        if self._device is None:
            self._device = resolve_device(self.cfg.device)
            self._stage = staging.PinnedStage(self._device.type == "cuda")
        dev, st = self._device, self._stage
        t0 = time.perf_counter_ns()
        rows_t = st.buffer("rows", (self.cfg.window, b_pad))
        coeff_t = st.buffer("coeff", coeff.shape)
        rows = rows_t.numpy()
        staging.stage_fec_rows(self.stream.rtp_ring, slots, lens, rows)
        coeff_t.numpy()[:] = coeff
        d_rows = staging.upload(rows_t, dev)
        d_coeff = staging.upload(coeff_t, dev)
        t1 = time.perf_counter_ns()
        out_t = st.buffer("parity", (coeff.shape[0], b_pad))
        with staging.DeviceTimer(dev, obs.PROFILER.enabled) as timer:
            parity = fec_parity_window_step(d_rows, d_coeff)
        staging.readback(parity, out_t)
        st.record()
        if st.event is not None:
            st.event.synchronize()       # the wait: kernel and copy done
        self.device_passes += 1
        t2 = time.perf_counter_ns()
        self.stage_ns += t1 - t0
        self.kernel_ns += t2 - t1
        if obs.PROFILER.enabled:
            obs.TPU_PASS_SECONDS.observe(timer.ns() / 1e9,
                                         stage="fec_parity")
        obs.TPU_H2D_BYTES.inc(rows.nbytes + coeff.nbytes)
        obs.TPU_D2H_BYTES.inc(out_t.numel())
        return rows, out_t.numpy().copy()

    def _emit_window(self, out, f: FecOutputState, w: int,
                     now_ms: int) -> int:
        kind = self.cfg.kind_code
        r = f.controller.parity_rows(self.cfg.window, kind=kind)
        if r <= 0:
            return 0
        entry = self._window_parity(w, r)
        if entry is None:
            return 0
        win_slots, deltas, seqs, lens, max_len, parity = entry
        m = len(deltas)
        coeff = coeff_rows(deltas, r)
        # per subscriber: the rewritten 12-byte headers and the 2-byte
        # wire lengths (host numpy, O(window × 12))
        ring = self.stream.rtp_ring
        rw = out.rewrite
        if rw.base_src_seq < 0:
            return 0                       # rebase never latched: unsent
        hdrs = np.zeros((m, 12), np.uint8)
        src_rows = ring.data[win_slots, :12]
        hdrs[:, 0:2] = src_rows[:, 0:2]
        out_seqs = (seqs - rw.base_src_seq + rw.out_seq_start) & 0xFFFF
        hdrs[:, 2:4] = out_seqs.astype(">u2")[:, None].view(np.uint8)
        ts = ring.timestamp[win_slots].astype(np.int64)
        out_ts = (ts - rw.base_src_ts + rw.out_ts_start) & 0xFFFFFFFF
        hdrs[:, 4:8] = out_ts.astype(">u4")[:, None].view(np.uint8)
        hdrs[:, 8:12] = np.frombuffer(
            struct.pack("!I", rw.ssrc & 0xFFFFFFFF), np.uint8)
        len_rows = np.asarray(lens, np.uint16).astype(">u2")[:, None] \
            .view(np.uint8).reshape(m, 2)
        hdr_par = gf_matmul(coeff, hdrs)
        len_par = gf_matmul(coeff, len_rows)
        snbase = int(out_seqs[0])
        sent = 0
        from .output import WriteResult
        for p in range(r):
            payload = (len_par[p].tobytes() + hdr_par[p].tobytes()
                       + parity[p, 12:max_len].tobytes())
            pkt = build_parity_packet(
                fec_pt=self.cfg.payload_type, fec_seq=f.fec_seq,
                ts=int(out_ts[-1]), ssrc=rw.ssrc, snbase=snbase,
                deltas=deltas, idx=p, kind=kind, payload=payload)
            if out.send_bytes(pkt, is_rtcp=False) is WriteResult.OK:
                f.fec_seq = (f.fec_seq + 1) & 0xFFFF
                f.parity_sent += 1
                sent += 1
        if sent:
            self.parity_sent += sent
            self.windows_emitted += 1
            obs.FEC_PARITY_PACKETS.inc(sent, kind=KIND_NAMES[kind])
        return sent

    # -- NACK / RTX -------------------------------------------------------
    def replay_nacked(self, out, seqs, now_ms: int,
                      on_giveup=None) -> int:
        """Resolve NACKed OUTPUT seqs to live ring ids through the inverse
        affine rewrite and replay them as RTX packets; returns replays
        sent.  An empty token bucket is a give-up (``rtx_giveups``, and
        ``on_giveup(session_path)``); a seq no longer in the ring is
        skipped."""
        f = getattr(out, "fec", None)
        if f is None:
            return 0
        if not out.thinning.passthrough():
            # a thinned output's seq holes are deliberate frame drops:
            # replaying them would undo thinning and drain the bucket
            return 0
        ring = self.stream.rtp_ring
        rw = out.rewrite
        if rw.base_src_seq < 0:
            return 0
        sent = 0
        from .output import WriteResult
        for s_out in seqs:
            src_seq = (int(s_out) - rw.out_seq_start
                       + rw.base_src_seq) & 0xFFFF
            pid = _find_ring_id(ring, src_seq)
            if pid is None:
                continue                   # evicted / never ingested
            if not f.take_rtx_token(now_ms):
                f.rtx_giveups += 1
                self.rtx_giveups += 1
                obs.RTX_GIVEUP.inc()
                if not f._giveup_reported:
                    f._giveup_reported = True
                    obs.EVENTS.emit("rtx.giveup", level="warn",
                                    stream=self.stream.session_path,
                                    trace_id=self.stream.trace_id,
                                    giveups=f.rtx_giveups)
                if on_giveup is not None:
                    on_giveup(self.stream.session_path)
                continue
            slot = ring.slot(pid)
            wire = bytearray(ring.data[slot, :ring.length[slot]].tobytes())
            struct.pack_into("!H", wire, 2, s_out & 0xFFFF)
            struct.pack_into(
                "!I", wire, 4,
                (int(ring.timestamp[slot]) - rw.base_src_ts
                 + rw.out_ts_start) & 0xFFFFFFFF)
            struct.pack_into("!I", wire, 8, rw.ssrc & 0xFFFFFFFF)
            pkt = build_rtx_packet(bytes(wire),
                                   rtx_pt=self.cfg.rtx_payload_type,
                                   rtx_seq=f.rtx_seq)
            if out.send_bytes(pkt, is_rtcp=False) is WriteResult.OK:
                f.rtx_seq = (f.rtx_seq + 1) & 0xFFFF
                f.rtx_sent += 1
                sent += 1
                obs.RTX_SENT.inc()
        self.rtx_sent += sent
        if sent:
            obs.AUDIENCE.note_credit(out, rtx=sent)
        return sent


def drop_overhead_gauge(path: str, track_id) -> None:
    """Remove a departed stream's FEC overhead gauge."""
    obs.FEC_OVERHEAD_RATIO.remove(path=path or "-", track=str(track_id))


def _find_ring_id(ring, src_seq: int) -> int | None:
    """The live absolute ring id whose packet carries RTP seq ``src_seq``
    (one vectorized compare over the ring's seq column)."""
    for s in np.flatnonzero(ring.seq == src_seq):
        s = int(s)
        if ring.head <= 0:
            return None
        pid = ring.head - 1 - ((ring.head - 1 - s) % ring.capacity)
        if ring.valid(pid) and ring.length[s] >= 12:
            return pid
    return None


# ----------------------------------------------------------- receiver model
class FecReceiver:
    """Receiver model: byte-exact reconstruction from parity and RTX.

    Every received datagram goes through ``on_packet``: media keyed by its
    UNWRAPPED output seq, parity grouped per window, RTX replays restored
    to their original wire bytes."""

    def __init__(self, *, media_pt: int = 96, fec_pt: int = 127,
                 rtx_pt: int = 126):
        self.media_pt = media_pt
        self.fec_pt = fec_pt
        self.rtx_pt = rtx_pt
        self.media: dict[int, bytes] = {}      # ext seq → wire bytes
        self.recovered: dict[int, bytes] = {}  # via FEC solve
        self.rtx_restored: dict[int, bytes] = {}
        #: (snbase_ext, mask-deltas tuple) → {idx: payload}
        self._groups: dict[tuple, dict] = {}
        self._ext_hi: int | None = None
        self.duplicates = 0
        self.junk = 0

    # -- seq unwrap ----------------------------------------------------
    def _unwrap(self, seq: int) -> int:
        if self._ext_hi is None:
            self._ext_hi = seq
            return seq
        base = self._ext_hi & 0xFFFF
        delta = (seq - base) & 0xFFFF
        if delta < 0x8000:
            ext = self._ext_hi + delta
            self._ext_hi = max(self._ext_hi, ext)
        else:
            ext = self._ext_hi - ((base - seq) & 0xFFFF)
        return ext

    # -- ingest ----------------------------------------------------------
    def on_packet(self, data: bytes) -> str:
        if len(data) < 12 or data[0] >> 6 != 2:
            self.junk += 1
            return "junk"
        pt = data[1] & 0x7F
        if pt == self.fec_pt:
            p = parse_parity_packet(data)
            if p is None:
                self.junk += 1
                return "junk"
            self._on_parity(p)
            return "fec"
        if pt == self.rtx_pt:
            if len(data) < 14:
                self.junk += 1
                return "junk"
            osn, wire = restore_rtx_packet(data, media_pt=self.media_pt)
            ext = self._unwrap(osn)
            if ext in self.media or ext in self.rtx_restored:
                self.duplicates += 1
                return "dup"
            self.rtx_restored[ext] = wire
            self._try_recover()
            return "rtx"
        if pt == self.media_pt:
            seq = struct.unpack_from("!H", data, 2)[0]
            ext = self._unwrap(seq)
            if ext in self.media:
                self.duplicates += 1
                return "dup"
            self.media[ext] = data
            self._try_recover()
            return "media"
        self.junk += 1
        return "junk"

    def _on_parity(self, p: dict) -> None:
        sn_ext = self._unwrap(p["snbase"])
        key = (sn_ext, tuple(p["deltas"]))
        self._groups.setdefault(key, {})[p["idx"]] = p["payload"]
        self._try_recover()

    # -- reconstruction --------------------------------------------------
    def have(self, ext_seq: int) -> bytes | None:
        return (self.media.get(ext_seq)
                or self.rtx_restored.get(ext_seq)
                or self.recovered.get(ext_seq))

    def missing(self, lo: int, hi: int) -> list[int]:
        """Ext seqs in [lo, hi] with no media, RTX or recovered bytes."""
        return [s for s in range(lo, hi + 1) if self.have(s) is None]

    def _try_recover(self) -> int:
        solved = 0
        for key in list(self._groups):
            sn_ext, deltas = key
            parities = self._groups[key]
            prot = [sn_ext + d for d in deltas]
            miss = [s for s in prot if self.have(s) is None]
            if not miss:
                self._groups.pop(key, None)
                continue
            if len(miss) > len(parities):
                continue                   # not solvable yet
            # the LOWEST parity indices first: consecutive-from-0 rows are
            # a true Vandermonde system; an arbitrary subset can be
            # singular, and then the group waits for more rows
            rows_len = len(next(iter(parities.values())))
            if any(len(v) != rows_len for v in parities.values()):
                continue                   # corrupt group
            idxs = sorted(parities)[:len(miss)]
            synd = np.array([np.frombuffer(parities[p], np.uint8)
                             for p in idxs])
            # XOR out every received protected row's contribution
            known_d, known_rows = [], []
            for s, d in zip(prot, deltas):
                wire = self.have(s)
                if wire is None:
                    continue
                row = np.zeros(rows_len, np.uint8)
                row[0:2] = np.frombuffer(
                    struct.pack("!H", len(wire)), np.uint8)
                n = min(len(wire), rows_len - 2)
                row[2:2 + n] = np.frombuffer(wire[:n], np.uint8)
                known_d.append(d)
                known_rows.append(row)
            if known_rows:
                c = coeff_for_indices(known_d, idxs)
                synd ^= gf_matmul(c, np.stack(known_rows))
            miss_d = [d for s, d in zip(prot, deltas)
                      if self.have(s) is None]
            a = coeff_for_indices(miss_d, idxs)
            rows = gf_solve(a, synd, caller="fec_receiver")
            if rows is None:
                continue
            ok = True
            out = {}
            for s, row in zip(miss, rows):
                ln = int(row[0]) << 8 | int(row[1])
                if not 12 <= ln <= rows_len - 2:
                    ok = False
                    break
                out[s] = row[2:2 + ln].tobytes()
            if not ok:
                continue
            for s, wire in out.items():
                self.recovered[s] = wire
                solved += 1
                obs.FEC_RECOVERED.inc()
            self._groups.pop(key, None)
        return solved


__all__ = [
    "FecConfig", "FecOracleError", "FecOutputState", "FecRateController",
    "FecReceiver", "StreamFec", "build_parity_packet", "parse_parity_packet",
    "build_rtx_packet", "restore_rtx_packet", "coeff_rows",
    "coeff_for_indices", "gf_matmul", "gf_solve", "gf_mul", "gf_pow",
    "gf_inv", "OVERHEAD_LADDER", "KIND_XOR", "KIND_RS", "MASK_BITS",
    "MAX_PARITY_ROWS",
]
