"""Transform-domain H.264 requantization: the HLS bitrate rung's core.

Open-loop transcoding in the transform domain: parse every macroblock's
residual levels, requantize them at a higher QP (B6: batched on the
device through ``ops.h264_kernel``, or through the scalar oracles on the
host) and re-encode the slice with the new QP and recomputed CBP/nC
contexts.  SPS/PPS pass through untouched (QP lives in the slice
header).  Prediction drift is accepted and resets at every IDR, which in
the all-intra camera configs this ladder targets means every frame.

Scope: I and P slices in both entropy layers, CAVLC and CABAC
(``h264_cabac``, chosen by the PPS's entropy_coding_mode_flag),
including multi-slice pictures (each slice requants independently from
its ``first_mb_in_slice``), with luma AND 4:2:0 chroma residuals (luma
steps by the exact +6k shift; chroma follows the Table 8-15 QPc mapping
with the identity / exact-shift / integer-round-trip dispatch of
``h264_transform.requant_chroma_scalar``).  P slices requant their
residuals only: motion syntax and the skip map ride through verbatim.
I_16x16 needs QPY >= 12.  Streams outside the profile (B slices,
weighted prediction, scaling matrices, low-QP I_16x16) PASS THROUGH
unchanged and are counted: the rung never corrupts what it cannot parse.

The pipeline is parse → gather → ONE fused B6 dispatch → recode, the
same for one rendition (``SliceRequantizer``) and for a ladder
(``requant_multi``, ``hls.requant.RequantLadder``).  The parse and the
recode are the native split walk (``native.h264_parse_slice`` and
``SliceWalk.write``, ``csrc/h264_walk.cpp``): one C parse a slice fills
the gather ``gather_slice`` would, B6 requantizes it, and one C write a
rendition re-encodes it, all without the GIL.  High-profile 8x8 slices
(``transform_8x8_mode``) and slices the walk answers -1 take the CPython
parse and recode (``parse_slice_cpython``), with B6 the same; a slice the
walk finds malformed (-2) passes through.  The walk's fused form
(``native.h264_requant_slice``) is its oracle, never the serving path.
A missing walk library raises.

``SliceRequantizer(closed_loop=True)`` re-derives each I slice's
residuals against the OUTPUT picture's reconstruction
(``h264_closed_loop``: the CPython parse, the host loop, the CPython
write), so requantization error stops compounding along intra
prediction chains; its P slices keep the split walk around B6.

On a card the dispatch (``FusedRequantDispatch`` with ``device``) makes
one pinned upload, one ``ed_h264_requant`` launch and one readback for
the luma rows, and the same with ``ed_h264_requant_chroma`` when the
batch has chroma residual, each in ONE host call that keeps the GIL
(``ops.h264_kernel.RequantLeg``); the readbacks land in pinned buffers
that the pass holds until the CUDA event that ``_harvested`` waits on.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from .h264_bits import BitReader, BitWriter, nal_to_rbsp, rbsp_to_nal
from .h264_intra import (MacroblockI16x16, MacroblockPSkip, Pps,
                         SliceCodec, SliceHeader, Sps)
from .h264_transform import (CHROMA_QP, requant_chroma_scalar,
                             requant_levels_scalar)


@dataclass
class RequantStats:
    slices_requantized: int = 0
    slices_passed_through: int = 0
    blocks: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    native_slices: int = 0              # written by the C walk
    # slice jobs of one AU complete on different pool workers: each
    # accumulates a local delta, and the fold into a shared target holds
    # the target's lock, so concurrent merges never drop counts
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def merge(self, d: "RequantStats") -> None:
        """Fold a worker's delta in (thread-safe: concurrent merges into
        the same target serialize on its lock)."""
        with self._lock:
            self.slices_requantized += d.slices_requantized
            self.slices_passed_through += d.slices_passed_through
            self.blocks += d.blocks
            self.bytes_in += d.bytes_in
            self.bytes_out += d.bytes_out
            self.native_slices += d.native_slices


def _peek_is_p(nal: bytes) -> bool:
    """slice_type of a coded-slice NAL (2nd ue of the header) % 5 == 0."""
    try:
        br = BitReader(nal_to_rbsp(nal[1:9]))
        br.ue()                          # first_mb_in_slice
        return br.ue() % 5 == 0
    except (ValueError, EOFError, IndexError):
        return False


def _check_ceiling(parsed: "ParsedSlice", delta_qp: int) -> None:
    """Raise when a parsed slice's largest per-MB QP would pass 51 at
    ``delta_qp`` (mb.qp is absolute; P_Skip MBs carry none)."""
    if max((mb.qp for mb in parsed.mbs
            if not isinstance(mb, MacroblockPSkip)),
           default=parsed.qp_in_base) + delta_qp > 51:
        raise ValueError("qp already at ladder ceiling")


def _scalar_batch(levels: np.ndarray, qp_in: np.ndarray,
                  qp_out: np.ndarray) -> np.ndarray:
    out = np.empty_like(levels)
    for i in range(levels.shape[0]):
        out[i] = requant_levels_scalar(levels[i], int(qp_in[i]),
                                       int(qp_out[i]))
    return out


def _scalar_batch_chroma(dc: np.ndarray, ac: np.ndarray,
                         qpc_in: np.ndarray, qpc_out: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    out_dc = np.empty_like(dc)
    out_ac = np.empty_like(ac)
    for i in range(dc.shape[0]):
        out_dc[i], out_ac[i] = requant_chroma_scalar(
            dc[i], ac[i], int(qpc_in[i]), int(qpc_out[i]))
    return out_dc, out_ac


# ========================================================= the device arm
def _tiled(kind: str, arrays: list[np.ndarray], group: int
           ) -> list[np.ndarray]:
    """``DevicePass``'s inputs tiled over the targets: the row arrays
    and the per-row QPs the kernels take."""
    if kind == "luma":
        rows, qi, deltas = arrays
        t = deltas.shape[0]
        return [np.tile(rows, (t, 1)), np.tile(qi, t),
                (qi[None, :] + deltas[:, None]).reshape(-1)]
    dc, ac, qi, qo = arrays
    t = qo.shape[0]
    return [np.tile(dc, (t, 1)), np.tile(ac, (t, 1, 1)),
            np.repeat(np.tile(qi, t), group), np.repeat(qo.reshape(-1), group)]


def _wrapped(kind: str, arrays: list[np.ndarray], device: torch.device
             ) -> list[np.ndarray]:
    """One kernel wrapper call (``ops.h264_kernel``) on ``device`` over
    row arrays and per-row QPs: ONE launch on a card, the plain torch
    chain on the CPU; int64 numpy out."""
    from ..ops.h264_kernel import (h264_requant_chroma_kernel,
                                   h264_requant_kernel)
    views = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                              ).to(device) for a in arrays]
    outs = (h264_requant_kernel(*views) if kind == "luma"
            else h264_requant_chroma_kernel(*views))
    if kind == "luma":
        outs = (outs,)
    return [o.cpu().numpy().astype(np.int64) for o in outs]


class DevicePass:
    """One B6 call in flight: rows requantized to each of ``t`` targets.
    ``arrays`` are the untiled inputs: luma ``[rows [r, 16], qp_in [r],
    deltas [t]]`` (target i is ``qp_in + deltas[i]``); chroma ``[dc [m *
    group, 4], ac [m * group, 4, 15], qp_in [m], qp_out [t, m]]``
    (``group`` rows a QP: the ladder's 2 are a macroblock's Cb and Cr).
    The outputs tile the rows over the targets.  On a card it is ONE
    ``ops.h264_kernel.RequantLeg``: staged, uploaded, launched once and
    read back into pinned buffers of its own in one call that keeps the
    GIL, behind a CUDA event that ``result`` waits on (never on the whole
    device), so passes of several access units may be in flight at once.
    Elsewhere the inputs are tiled here and go through the kernel
    wrappers, which run the plain torch chains on CPU tensors.
    ``result`` returns int64 numpy arrays; an upload, launch or readback
    error raises out of the constructor or ``result``."""

    def __init__(self, kind: str, arrays: list[np.ndarray],
                 device: torch.device, *, group: int = 1):
        from ..ops.h264_kernel import RequantLeg
        self._leg = self._out = None
        if device.type == "cuda":
            self._leg = RequantLeg(kind, arrays, device, group=group)
        else:
            self._out = _wrapped(kind, _tiled(kind, arrays, group), device)

    def result(self) -> list[np.ndarray]:
        if self._out is None:
            self._out = self._leg.result()
        return self._out


def device_batch(levels: np.ndarray, qp_in: np.ndarray, qp_out: np.ndarray,
                 *, device: str | torch.device) -> np.ndarray:
    """Batch luma requant on ``device`` (bit-exact with the scalar path):
    one ``ed_h264_requant`` launch on a card."""
    return _wrapped("luma", [levels, qp_in, qp_out], torch.device(device))[0]


def device_batch_chroma(dc: np.ndarray, ac: np.ndarray, qpc_in: np.ndarray,
                        qpc_out: np.ndarray, *, device: str | torch.device
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Batch chroma requant on ``device`` (bit-exact with the scalar
    path): one ``ed_h264_requant_chroma`` launch on a card."""
    d, a = _wrapped("chroma", [dc, ac, qpc_in, qpc_out], torch.device(device))
    return d, a


# ===================================================== shared-parse fan-out
# The ABR-ladder cost model: parse a slice ONCE, requantize the same
# parsed MB arrays to N ``delta_qp`` targets, and re-encode N slices.
#
#   parse_slice_nal()  →  WalkedSlice     (one per slice, shared: the C
#                         parse; ParsedSlice on the CPython path)
#   gather_slice()     →  SliceGather     (level rows + QPs, shared)
#   FusedRequantDispatch(gathers × deltas): ONE transform dispatch for
#       every (slice, rendition) of an AU; on a device it is
#       asynchronous, so the card computes while pool workers parse the
#       next AU
#   recode_parsed()    →  bytes           (per rendition: one C write, or
#                                          the CPython recode of cloned MBs)
#
# ``SliceRequantizer._requant_slice`` runs the SAME pipeline with a
# single delta and no clone, so the serial path and the fan-out path are
# one code path.


@dataclass
class ParsedSlice:
    """One entropy-decoded slice: everything recode needs, engine-agnostic
    (the MB model is shared by the CAVLC and CABAC layers)."""

    nal0: int                           # original NAL header byte
    hdr: SliceHeader
    mbs: list
    qp_in_base: int                     # slice-header QP (pre-shift)
    cabac: bool
    sps: Sps
    pps: Pps


@dataclass
class WalkedSlice:
    """One slice parsed by the native split walk: the C handle with the
    slice's syntax (``native.SliceWalk``) and the gather it filled.  Each
    rendition's recode is one C write from it."""

    nal: bytes
    walk: "native.SliceWalk"
    gather: "SliceGather"
    qp_in_base: int                     # slice-header QP (pre-shift)
    sps: Sps
    pps: Pps


@dataclass
class SliceGather:
    """The batched-requant surface of one parsed slice: every residual
    row with its per-row QP, plus the write-back routing map.  Built
    once per slice and shared read-only across renditions."""

    rows: np.ndarray                    # [R, 16] luma/8x8 level rows
    qps: np.ndarray                     # [R] absolute source QPY per row
    row_map: list | None                # (mb_index, kind, blk) per row
    centries: list | None               # mb indices with chroma residual
    # (the walk's gather keeps both maps in its C handle: None here)
    cqp: np.ndarray                     # [C] source QPY of those MBs
    cdc: np.ndarray                     # [C*2, 4] chroma DC rows
    cac: np.ndarray                     # [C*2, 4, 15] chroma AC rows
    n_blocks: int                       # luma + chroma block count
    max_qp: int                         # slice ceiling input (7.4.5 max)


def _walk_args(sps: Sps, pps: Pps) -> dict:
    """The SPS and PPS fields the native walk takes."""
    return dict(width_mbs=sps.width_mbs, height_mbs=sps.height_mbs,
                log2_max_frame_num=sps.log2_max_frame_num,
                poc_type=sps.poc_type, log2_max_poc_lsb=sps.log2_max_poc_lsb,
                pic_init_qp=pps.pic_init_qp, pps_id=pps.pps_id,
                deblocking_control=pps.deblocking_control,
                bottom_field_poc=pps.bottom_field_poc,
                chroma_qp_offset=pps.chroma_qp_offset,
                cabac=pps.entropy_cabac,
                num_ref_l0_default=pps.num_ref_l0_default,
                weighted_pred=pps.weighted_pred)


def parse_slice_nal(nal: bytes, sps: Sps, pps: Pps
                    ) -> "WalkedSlice | ParsedSlice":
    """Entropy-decode one coded-slice NAL: the native walk's parse and
    gather (a ``WalkedSlice``), or for a High 8x8 PPS and a slice the walk
    answers -1 the CPython parse (a ``ParsedSlice``).  Raises ValueError
    on anything outside the requant profile, and on a slice the walk
    finds malformed: the caller passes the slice through."""
    if not pps.transform_8x8_mode:
        walk = native.h264_parse_slice(nal, **_walk_args(sps, pps))
        if not isinstance(walk, int):
            gather = SliceGather(walk.rows, walk.qps, None, None, walk.cqp,
                                 walk.cdc, walk.cac, walk.info["blocks"],
                                 walk.info["max_qp"])
            return WalkedSlice(nal, walk, gather, walk.info["qp"], sps,
                               pps)
        if walk == native.WALK_MALFORMED:
            raise ValueError("malformed slice")
    return parse_slice_cpython(nal, sps, pps)


def parse_slice_cpython(nal: bytes, sps: Sps, pps: Pps) -> ParsedSlice:
    """The CPython parse into the shared MB model (CAVLC or CABAC per the
    PPS).  Raises ValueError on anything outside the requant profile."""
    if pps.entropy_cabac:
        from .h264_cabac import CabacSliceCodec
        hdr, _first, mbs, _qps = CabacSliceCodec(sps, pps).parse_slice(nal)
    else:
        codec = SliceCodec(sps, pps)
        br = BitReader(nal_to_rbsp(nal[1:]))
        hdr = codec.parse_slice_header(br, nal[0])
        mbs = codec.parse_mbs(br, hdr.qp, hdr.first_mb, hdr)
    if pps.entropy_cabac and pps.transform_8x8_mode \
            and hdr.first_mb + len(mbs) < sps.width_mbs * sps.height_mbs:
        # CABAC + 8x8: a slice whose parse ends before the picture does
        # is either a genuine multi-slice picture or a sparse-content
        # context desync this engine still has on cat-5 streams — both
        # must PASS THROUGH rather than emit a truncated slice
        raise ValueError("CABAC 8x8 slice ended before picture end")
    return ParsedSlice(nal[0], hdr, mbs, hdr.qp, pps.entropy_cabac,
                       sps, pps)


def gather_slice(parsed: "WalkedSlice | ParsedSlice") -> SliceGather:
    """Collect every residual row of a parsed slice with its per-MB
    source QP (the +6k step is uniform, so the TARGET QP is derived per
    rendition at dispatch time).  I_16x16 MBs contribute a DC row + 16
    zero-padded 15-coeff AC rows (the op is elementwise, padding stays
    zero); a row map routes results back to the right structure.  A
    walked slice's gather was filled by its C parse, in the same order
    (its levels clipped to ±2047 at the parse, which B6 does first)."""
    if isinstance(parsed, WalkedSlice):
        return parsed.gather
    mbs = parsed.mbs
    all_levels = []
    qps: list[int] = []
    row_map: list[tuple[int, str, int]] = []
    for i, mb in enumerate(mbs):
        if isinstance(mb, MacroblockPSkip):
            continue                   # no residual, nothing to shift
        if getattr(mb, "transform_8x8", False):
            # 8x8 levels shift by the same exact +6k step (the 8x8
            # tables share the qp%6 periodicity); batch as 16 rows
            all_levels.append(mb.levels8.reshape(16, 16))
            row_map.extend((i, "l8", b) for b in range(16))
            qps.extend([mb.qp] * 16)
            continue
        if isinstance(mb, MacroblockI16x16):
            all_levels.append(mb.dc_levels[None, :])
            row_map.append((i, "dc", 0))
            qps.append(mb.qp)
            ac = np.zeros((16, 16), dtype=np.int64)
            ac[:, :15] = mb.ac_levels
            all_levels.append(ac)
            row_map.extend((i, "ac", b) for b in range(16))
            qps.extend([mb.qp] * 16)
        else:
            all_levels.append(mb.levels)
            row_map.extend((i, "l4", b) for b in range(16))
            qps.extend([mb.qp] * 16)
    if all_levels:                     # an all-skip P slice has no rows;
        # its header QP still shifts (deblocking strength follows the
        # slice QP even for skipped MBs)
        rows = np.concatenate(all_levels, axis=0)
    else:
        rows = np.zeros((0, 16), dtype=np.int64)
    n_blocks = rows.shape[0]

    centries = [i for i, mb in enumerate(mbs) if mb.chroma_cbp]
    if centries:
        cdc = np.stack([mbs[i].chroma_dc for i in centries]).reshape(-1, 4)
        cac = np.stack([mbs[i].chroma_ac
                        for i in centries]).reshape(-1, 4, 15)
        cqp = np.array([mbs[i].qp for i in centries], dtype=np.int64)
        n_blocks += 8 * len(centries)
    else:
        cdc = np.zeros((0, 4), dtype=np.int64)
        cac = np.zeros((0, 4, 15), dtype=np.int64)
        cqp = np.zeros((0,), dtype=np.int64)
    return SliceGather(rows, np.asarray(qps, dtype=np.int64), row_map,
                       centries, cqp, cdc, cac, n_blocks,
                       max((mb.qp for mb in mbs
                            if not isinstance(mb, MacroblockPSkip)),
                           default=parsed.qp_in_base))


class FusedRequantDispatch:
    """ONE transform dispatch covering every (slice, rendition) pair of
    an access unit: the luma rows and chroma rows of all gathers are
    tiled across the delta axis and requantized in a single call each.
    With ``device`` the calls are ``DevicePass``es (on a card: one
    ``ed_h264_requant`` launch, and one ``ed_h264_requant_chroma`` launch
    when the AU has chroma residual); the card computes while the pool's
    other workers parse, and ``_harvested`` blocks only on their events.
    Without ``device`` it runs ``requant_fn``/``chroma_fn`` (default the
    scalar oracles) on the host.  Bit-exact vs per-slice-per-delta calls:
    the op is elementwise per row, so tiling never changes values."""

    def __init__(self, gathers: "list[SliceGather]",
                 deltas: "tuple[int, ...]", *, requant_fn=None,
                 chroma_fn=None, chroma_qp_offset: int = 0,
                 device: str | torch.device | None = None):
        self.deltas = tuple(deltas)
        self._lock = threading.Lock()
        self._np_rows = None
        self._np_chroma = None
        #: the launches this dispatch made: luma, chroma (0 or 1 each)
        self.luma_launched = self.chroma_launched = False
        # a delta every slice of this batch would reject at the QP-51
        # ceiling is excluded from the tile entirely (a permanently
        # over-ceiling rung must not tax every AU with transform work the
        # recode discards); a delta only SOME slices reject stays tiled
        floor_qp = min((g.max_qp for g in gathers), default=0)
        self._tile_pos = {}
        for i, d in enumerate(self.deltas):
            if floor_qp + d <= 51:
                self._tile_pos[i] = len(self._tile_pos)
        active = [self.deltas[i] for i in sorted(self._tile_pos)]
        nd = len(active)
        self._offsets = np.cumsum([0] + [g.rows.shape[0]
                                         for g in gathers])
        self._coffsets = np.cumsum([0] + [g.cqp.shape[0]
                                          for g in gathers])
        r_total = int(self._offsets[-1])
        c_total = int(self._coffsets[-1])
        self._r_total, self._c_total = r_total, c_total
        self._pending_rows = None
        self._pending_chroma = None
        dev = None if device is None else torch.device(device)
        # one gather is taken as it is: every numpy copy above a few
        # hundred elements gives up the GIL, which the requant pool's
        # Python threads then hold for milliseconds
        def cat(arrays):
            return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)

        if r_total and nd:
            rows = cat([g.rows for g in gathers])
            qps = cat([g.qps for g in gathers])
            steps = np.array(active, dtype=np.int64)
            if dev is not None:
                # the card (or the CPU's plain chains) tiles over the deltas
                self._pending_rows = DevicePass("luma", [rows, qps, steps],
                                                dev)
                self.luma_launched = True
            else:
                self._pending_rows = (requant_fn or _scalar_batch)(
                    *_tiled("luma", [rows, qps, steps], 1))
        if c_total and nd:
            cdc = cat([g.cdc for g in gathers])
            cac = cat([g.cac for g in gathers])
            # Table 8-15 over clip3(0, 51, QPY + offset), as chroma_qp
            cqp = cat([g.cqp for g in gathers]) + chroma_qp_offset
            qin = CHROMA_QP[np.clip(cqp, 0, 51)]
            qout = CHROMA_QP[np.clip(cqp[None, :] + np.array(
                active, dtype=np.int64)[:, None], 0, 51)]
            if dev is not None:
                self._pending_chroma = DevicePass(
                    "chroma", [cdc, cac, qin, qout], dev, group=2)
                self.chroma_launched = True
            else:
                self._pending_chroma = (chroma_fn or _scalar_batch_chroma)(
                    *_tiled("chroma", [cdc, cac, qin, qout], 2))

    def _harvested(self):
        """Block (once) on the fused results and cache the numpy views."""
        with self._lock:
            if self._np_rows is None:
                rows, chroma = self._pending_rows, self._pending_chroma
                if isinstance(rows, DevicePass):
                    rows = rows.result()[0]
                if isinstance(chroma, DevicePass):
                    chroma = tuple(chroma.result())
                # int64 already (the device arm and the scalar oracles):
                # no copy, which would give up the GIL
                self._np_rows = (np.zeros((0, 16), dtype=np.int64)
                                 if rows is None
                                 else np.asarray(rows, dtype=np.int64))
                if chroma is not None:
                    d, a = chroma
                    self._np_chroma = (np.asarray(d, dtype=np.int64),
                                       np.asarray(a, dtype=np.int64))
                else:
                    self._np_chroma = (
                        np.zeros((0, 4), dtype=np.int64),
                        np.zeros((0, 4, 15), dtype=np.int64))
                self._pending_rows = self._pending_chroma = None
        return self._np_rows, self._np_chroma

    def _pos(self, delta_idx: int) -> int:
        pos = self._tile_pos.get(delta_idx)
        if pos is None:
            # unreachable through recode_parsed (its ceiling check
            # raises first), kept as the same contract for any caller
            raise ValueError("qp already at ladder ceiling")
        return pos

    def luma_rows(self, slice_idx: int, delta_idx: int) -> np.ndarray:
        rows, _ = self._harvested()
        base = self._pos(delta_idx) * self._r_total
        return rows[base + int(self._offsets[slice_idx]):
                    base + int(self._offsets[slice_idx + 1])]

    def chroma_rows(self, slice_idx: int, delta_idx: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        _, (d, a) = self._harvested()
        lo = 2 * (self._pos(delta_idx) * self._c_total
                  + int(self._coffsets[slice_idx]))
        hi = 2 * (self._pos(delta_idx) * self._c_total
                  + int(self._coffsets[slice_idx + 1]))
        return (d[lo:hi].reshape(-1, 2, 4),
                a[lo:hi].reshape(-1, 2, 4, 15))


def _clone_mb(mb):
    """Copy one parsed MB so a rendition's requant write-back never
    touches the shared parse (arrays the recode mutates are copied;
    verbatim-carried syntax — pred modes, motion — is shared)."""
    if isinstance(mb, MacroblockPSkip):
        return mb                       # stateless marker
    c = copy.copy(mb)
    for f in ("levels", "levels8", "dc_levels", "ac_levels",
              "chroma_dc", "chroma_ac"):
        v = getattr(c, f, None)
        if isinstance(v, np.ndarray):
            setattr(c, f, v.copy())
    return c


def _writeback_rows(mbs: list, gather: SliceGather,
                    requanted: np.ndarray,
                    cdc2: np.ndarray, cac2: np.ndarray) -> None:
    """Route fused-requant rows back into the MB structures (the inverse
    of ``gather_slice``'s flattening)."""
    for r, (i, kind, b) in enumerate(gather.row_map):
        mb = mbs[i]
        if kind == "dc":
            mb.dc_levels = requanted[r]
        elif kind == "ac":
            mb.ac_levels[b] = requanted[r, :15]
        elif kind == "l8":
            mb.levels8[b >> 2, (b & 3) * 16:(b & 3) * 16 + 16] = \
                requanted[r]
        else:
            mb.levels[b] = requanted[r]
    for j, i in enumerate(gather.centries):
        mbs[i].chroma_dc = cdc2[j]
        mbs[i].chroma_ac = cac2[j]


def _finalize_mbs(mbs: list, delta_qp: int) -> None:
    """Recompute CBP/CBP-equivalents from the requanted levels and shift
    every MB's absolute QP; the writer re-derives deltas vs the previous
    CODED MB, so a cleared-CBP MB's QP correctly stops influencing the
    chain."""
    for mb in mbs:
        if isinstance(mb, MacroblockPSkip):
            continue
        ccbp = (2 if np.any(mb.chroma_ac) else
                1 if np.any(mb.chroma_dc) else 0)
        if isinstance(mb, MacroblockI16x16):
            mb.luma_cbp15 = bool(np.any(mb.ac_levels))
            mb.chroma_cbp = ccbp
        elif getattr(mb, "transform_8x8", False):
            cbp = 0
            for g in range(4):
                if np.any(mb.levels8[g]):
                    cbp |= 1 << g
            mb.cbp = cbp | (ccbp << 4)
        else:                          # I_NxN and inter share the CBP
            cbp = 0                    # recompute shape
            for g in range(4):
                if np.any(mb.levels[4 * g:4 * g + 4]):
                    cbp |= 1 << g
            mb.cbp = cbp | (ccbp << 4)
        mb.qp = mb.qp + delta_qp


def _write_slice_bytes(parsed: ParsedSlice, mbs: list,
                       qp_out_base: int) -> bytes:
    """Serialize the requanted MBs back into a slice NAL (fresh codec
    per call: the writers are stateless beyond SPS/PPS, so renditions
    recode concurrently)."""
    if parsed.cabac:
        from .h264_cabac import CabacSliceCodec
        return CabacSliceCodec(parsed.sps, parsed.pps).write_slice(
            parsed.hdr, parsed.hdr.first_mb, mbs, qp_out_base)
    codec = SliceCodec(parsed.sps, parsed.pps)
    bw = BitWriter()
    codec.write_slice_header(bw, parsed.hdr, qp_out_base)
    codec.write_mbs(bw, mbs, qp_out_base, parsed.hdr.first_mb,
                    parsed.hdr)
    bw.rbsp_trailing()
    return bytes([parsed.nal0]) + rbsp_to_nal(bw.to_bytes())


def recode_parsed(parsed: "WalkedSlice | ParsedSlice", gather: SliceGather,
                  dispatch: FusedRequantDispatch, slice_idx: int,
                  delta_idx: int, *, clone: bool = True,
                  stats: RequantStats | None = None) -> tuple[bytes, int]:
    """One rendition's serial entropy re-encode over the shared parse:
    for a walked slice ONE C write from its handle and the fused-requant
    rows (``stats.native_slices`` counts it); otherwise clone the MB
    arrays, write the rows back, recompute CBP + the shifted QP chain and
    serialize in Python.  Raises ValueError when this rendition's target
    QP would pass the ladder ceiling, or the slice cannot be recoded (the
    caller passes the slice through for THAT rendition only)."""
    delta_qp = dispatch.deltas[delta_idx]
    if gather.max_qp + delta_qp > 51:    # the gather carries the slice's
        # per-MB QP maximum (mb.qp is absolute; P_Skip MBs carry none)
        raise ValueError("qp already at ladder ceiling")
    requanted = dispatch.luma_rows(slice_idx, delta_idx)
    cdc2, cac2 = dispatch.chroma_rows(slice_idx, delta_idx)
    if isinstance(parsed, WalkedSlice):
        out = parsed.walk.write(delta_qp, requanted, cdc2, cac2)
        if isinstance(out, bytes):
            if stats is not None:
                stats.native_slices += 1
            return out, gather.n_blocks
        if out != native.WALK_UNSUPPORTED:
            raise ValueError("the walk could not recode the slice")
        # outside the walk for this rung (the slice QP or an mb_qp_delta
        # out of range): the CPython recode over the same B6 rows, in the
        # same order
        walked = gather
        parsed = parse_slice_cpython(parsed.nal, parsed.sps, parsed.pps)
        gather = gather_slice(parsed)
        if gather.rows.shape != walked.rows.shape \
                or gather.cqp.shape != walked.cqp.shape:
            raise ValueError("the CPython parse disagrees with the walk's")
        clone = False
    mbs = [_clone_mb(mb) for mb in parsed.mbs] if clone else parsed.mbs
    _writeback_rows(mbs, gather, requanted, cdc2, cac2)
    _finalize_mbs(mbs, delta_qp)
    return (_write_slice_bytes(parsed, mbs,
                               parsed.qp_in_base + delta_qp),
            gather.n_blocks)


def requant_multi(nal: bytes, sps: Sps | None, pps: Pps | None,
                  deltas: "tuple[int, ...]", *, requant_fn=None,
                  chroma_fn=None, device: str | torch.device | None = None
                  ) -> "list[tuple[bytes, RequantStats]]":
    """Shared-parse rendition fan-out over one NAL: parse once, requant
    and recode to every ``delta_qp`` in ``deltas`` with ONE fused
    transform dispatch (on ``device`` when given).  Returns (output,
    stats delta) per rendition, byte-identical to N independent
    ``SliceRequantizer``s; stateless, so pool workers run slices of one
    stream concurrently."""
    t = nal[0] & 0x1F
    if t not in (1, 5) or sps is None or pps is None:
        return [(nal, RequantStats()) for _ in deltas]
    try:
        parsed = parse_slice_nal(nal, sps, pps)
        gather = gather_slice(parsed)
    except (ValueError, EOFError, KeyError, IndexError):
        out = []
        for _ in deltas:
            d = RequantStats()
            d.bytes_in += len(nal)
            d.slices_passed_through += 1
            d.bytes_out += len(nal)
            out.append((nal, d))
        return out
    dispatch = FusedRequantDispatch(
        [gather], tuple(deltas), requant_fn=requant_fn,
        chroma_fn=chroma_fn, chroma_qp_offset=pps.chroma_qp_offset,
        device=device)
    out = []
    for i in range(len(dispatch.deltas)):
        d = RequantStats()
        d.bytes_in += len(nal)
        try:
            out_nal, n_blocks = recode_parsed(parsed, gather, dispatch,
                                              0, i, stats=d)
            d.slices_requantized += 1
            d.blocks += n_blocks
        except (ValueError, EOFError, KeyError, IndexError):
            out_nal = nal
            d.slices_passed_through += 1
        d.bytes_out += len(out_nal)
        out.append((out_nal, d))
    return out


class SliceRequantizer:
    """Per-stream requantizer: latches SPS/PPS from the NAL flow and
    rewrites coded slices ``delta_qp`` steps coarser through the parse →
    B6 → recode pipeline (the native walk's parse and write where it
    covers the slice).  ``requant_fn``/``chroma_fn`` run the transform
    on the host (default: the scalar oracles); ``device`` runs it as a
    ``DevicePass`` there instead (the two are exclusive).

    ``closed_loop=True``: I slices are requantized in the closed loop
    (``h264_closed_loop``) on the host, against a reconstruction of the
    output picture that spans the picture's slices; P slices keep the
    open-loop split walk around B6 on ``device``.  The closed loop's
    calls are STATEFUL: a closed-loop I slice reads and writes the
    picture's reconstructions (reset at each slice with
    ``first_mb == 0``), so run a stream's I slices in order on one
    thread.  P slices, and every slice without the closed loop, touch no
    instance state."""

    def __init__(self, delta_qp: int, *, requant_fn=None, chroma_fn=None,
                 device: str | torch.device | None = None,
                 closed_loop: bool = False):
        if delta_qp < 6 or delta_qp % 6:
            # +6k steps are EXACT level shifts (table periodicity); other
            # deltas would need transform-normalization terms
            raise ValueError("delta_qp must be a positive multiple of 6")
        if device is not None and (requant_fn or chroma_fn):
            raise ValueError("requant_fn/chroma_fn run on the host; pass "
                             "them or device, not both")
        native.require()
        self.delta_qp = delta_qp
        self.requant_fn = requant_fn or _scalar_batch
        self.chroma_fn = chroma_fn or _scalar_batch_chroma
        self.device = None if device is None else torch.device(device)
        self.closed_loop = closed_loop
        #: the closed loop's reconstructions of the source and the output
        #: picture (``h264_closed_loop.PictureRecon``), across its slices
        self._cl_orig = None
        self._cl_out = None
        self.sps: Sps | None = None
        self.pps: Pps | None = None
        self.stats = RequantStats()

    # -- per-NAL entry -----------------------------------------------------
    def transform_nal(self, nal: bytes) -> bytes:
        t = nal[0] & 0x1F
        if t == 7:
            try:
                self.sps = Sps.parse(nal)
            except (ValueError, EOFError, IndexError):
                self.sps = None
            return nal
        if t == 8:
            try:
                self.pps = Pps.parse(nal)
            except (ValueError, EOFError, IndexError):
                self.pps = None
            return nal
        out, delta = self.requant_with(nal, self.sps, self.pps)
        self.stats.merge(delta)
        return out

    def requant_with(self, nal: bytes, sps: Sps | None, pps: Pps | None
                     ) -> tuple[bytes, RequantStats]:
        """Requant one slice NAL against EXPLICIT parameter sets,
        returning the output and a stats delta.  Without the closed loop,
        and for P slices with it, no instance state is read or written,
        so pool workers can run AUs concurrently; a closed-loop I slice
        updates the picture's reconstructions (the class docstring)."""
        delta = RequantStats()
        t = nal[0] & 0x1F
        if t not in (1, 5) or sps is None or pps is None:
            return nal, delta
        delta.bytes_in += len(nal)
        try:
            if self.closed_loop and not _peek_is_p(nal):
                out, n_blocks = self._closed_loop_nal(nal, sps, pps)
            else:
                out, n_blocks = self._requant_slice(nal, sps, pps, delta)
            delta.slices_requantized += 1
            delta.blocks += n_blocks
        except (ValueError, EOFError, KeyError, IndexError):
            out = nal
            delta.slices_passed_through += 1
        delta.bytes_out += len(out)
        return out, delta

    def _requant_slice(self, nal: bytes, sps: Sps, pps: Pps,
                       stats: RequantStats) -> tuple[bytes, int]:
        """Single-rendition requant: the SAME parse → gather → fused
        dispatch → recode pipeline the ladder fan-out runs, with one
        delta and no MB clone."""
        parsed = parse_slice_nal(nal, sps, pps)
        gather = gather_slice(parsed)
        # past the QP-51 ceiling the dispatch tiles nothing and the
        # recode raises
        dispatch = FusedRequantDispatch(
            [gather], (self.delta_qp,), requant_fn=self.requant_fn,
            chroma_fn=self.chroma_fn,
            chroma_qp_offset=pps.chroma_qp_offset, device=self.device)
        return recode_parsed(parsed, gather, dispatch, 0, 0,
                             clone=False, stats=stats)

    def _closed_loop_nal(self, nal: bytes, sps: Sps, pps: Pps
                         ) -> tuple[bytes, int]:
        """One I slice through the closed loop: the CPython parse, the QP
        ceiling (checked before the loop, which never reaches a recode
        that would refuse it), the loop over its MBs, the CBP and QP
        chain, the CPython write."""
        parsed = parse_slice_cpython(nal, sps, pps)
        _check_ceiling(parsed, self.delta_qp)
        if parsed.hdr.is_p:
            raise ValueError("the closed loop takes I slices only")
        n_blocks = self._closed_loop_slice(sps, pps, parsed.hdr, parsed.mbs)
        _finalize_mbs(parsed.mbs, self.delta_qp)
        return (_write_slice_bytes(parsed, parsed.mbs,
                                   parsed.qp_in_base + self.delta_qp),
                n_blocks)

    def _closed_loop_slice(self, sps: Sps, pps: Pps, hdr, mbs) -> int:
        """Closed-loop intra requant of one slice's MBs (their levels
        change in place); returns the block count for the stats."""
        from .h264_closed_loop import PictureRecon, requant_mb_closed
        if hdr.first_mb % sps.width_mbs:
            raise ValueError("closed loop needs MB-row-aligned slices")
        if hdr.first_mb == 0 or self._cl_orig is None:
            self._cl_orig = PictureRecon(sps.width_mbs, sps.height_mbs)
            self._cl_out = PictureRecon(sps.width_mbs, sps.height_mbs)
        n_blocks = 0
        for i, mb in enumerate(mbs, start=hdr.first_mb):
            requant_mb_closed(self._cl_orig, self._cl_out, sps, pps, i,
                              mb, hdr.first_mb, self.delta_qp)
            n_blocks += (17 if isinstance(mb, MacroblockI16x16) else 16)
            n_blocks += 8 if mb.chroma_cbp else 0
        return n_blocks
