"""Minimal H.264 baseline INTRA codec (CAVLC, I_4x4, 4:2:0), with the
I/P slice walk the requant rung shares.

Purpose: (a) generate REAL CAVLC- and CABAC-coded H.264 for the HLS
tests and ``chip_smoke.py`` (``encode_iframe``), and (b) provide the
slice and macroblock model the transform-domain requant rung
(``h264_requant``) parses into and writes from.

Scope: I slices of I_4x4 and I_16x16 macroblocks, DC-mode prediction,
CAVLC with full 4:2:0 chroma residuals (chroma DC 2×2 Hadamard + AC
blocks, Table 9-5 nC=−1 coding, 8.3.4.1 mode-0 chroma prediction), and
the P-slice syntax the requant rung carries verbatim.  The requant rung
passes streams it cannot parse through unchanged and says so in its
stats.  A copy of the reference's ``codecs/h264_intra.py``; numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import h264_cavlc as cavlc
from .h264_bits import BitReader, BitWriter, nal_to_rbsp, rbsp_to_nal
from .h264_transform import (_CF, ZIGZAG4, chroma_dc_dequant,
                             chroma_dc_quant, chroma_qp, dequant_inverse,
                             forward_transform_quant, inverse_core,
                             v_position)

#: Table 9-4 codeNum → coded_block_pattern for Intra_4x4 (ue-mapped CBP).
CBP_INTRA_FROM_CODE = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]
CBP_INTRA_TO_CODE = {cbp: i for i, cbp in enumerate(CBP_INTRA_FROM_CODE)}

#: Table 9-4 codeNum → coded_block_pattern, INTER column (cross-checked
#: against libavcodec's ff_h264_golomb_to_inter_cbp rodata).
CBP_INTER_FROM_CODE = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]
CBP_INTER_TO_CODE = {cbp: i for i, cbp in enumerate(CBP_INTER_FROM_CODE)}

#: P macroblock partitioning (Table 7-13): mb_type → number of
#: partitions whose ref_idx/mvd ride in mb_pred (P_8x8* handled apart).
P_MB_PARTS = {0: 1, 1: 2, 2: 2}
#: P sub_mb_type → number of sub-partition mvds (Table 7-17).
P_SUB_PARTS = (1, 2, 2, 4)

#: profile_idc values whose SPS carries the chroma_format / bit-depth /
#: scaling-matrix fields (7.3.2.1.1's "if( profile_idc == 100 || ... )"
#: list): High, High 10, High 4:2:2, High 4:4:4 Predictive, CAVLC 4:4:4,
#: Scalable (83/86), Multiview (118/128/138), and the MFC/stereo codes.
_HIGH_FAMILY = frozenset(
    (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135))

#: luma4x4BlkIdx → (x4, y4) inside the macroblock (spec 6.4.3 scan)
BLK_XY = [(2 * ((i >> 2) & 1) + (i & 1), 2 * ((i >> 3) & 1)
           + ((i >> 1) & 1)) for i in range(16)]


@dataclass
class Sps:
    width_mbs: int
    height_mbs: int
    sps_id: int = 0
    log2_max_frame_num: int = 4
    poc_type: int = 2
    log2_max_poc_lsb: int = 4           # meaningful for poc_type 0 only
    profile_idc: int = 66               # 66 CAVLC baseline / 77 CABAC:
                                        # A.2.1 forbids CABAC in baseline

    def build(self) -> bytes:
        bw = BitWriter()
        bw.write_bits(self.profile_idc, 8)
        # baseline asserts constraint_set0/1; Main asserts set1 only
        bw.write_bits(0xC0 if self.profile_idc == 66 else 0x40, 8)
        bw.write_bits(30, 8)            # level_idc 3.0
        bw.ue(self.sps_id)
        bw.ue(self.log2_max_frame_num - 4)
        bw.ue(self.poc_type)
        if self.poc_type == 0:
            bw.ue(self.log2_max_poc_lsb - 4)
        bw.ue(1)                        # max_num_ref_frames
        bw.write_bit(0)                 # gaps_in_frame_num
        bw.ue(self.width_mbs - 1)
        bw.ue(self.height_mbs - 1)
        bw.write_bit(1)                 # frame_mbs_only
        bw.write_bit(1)                 # direct_8x8_inference
        bw.write_bit(0)                 # frame_cropping
        bw.write_bit(0)                 # vui_parameters_present
        bw.rbsp_trailing()
        return b"\x67" + rbsp_to_nal(bw.to_bytes())

    @classmethod
    def parse(cls, nal: bytes) -> "Sps":
        br = BitReader(nal_to_rbsp(nal[1:]))
        profile = br.read_bits(8)
        # 7.3.2.1.1: every profile in _HIGH_FAMILY carries the
        # chroma_format/bit_depth/scaling fields after sps_id — not just
        # 100.  Gating on the full set keeps e.g. a High-10 SPS from
        # being silently misparsed (its chroma_format read as
        # log2_max_frame_num) instead of cleanly rejected.
        if profile not in (66, 77, 88) and profile not in _HIGH_FAMILY:
            raise ValueError(f"unsupported profile {profile}")
        br.read_bits(8)                 # constraint flags
        br.read_bits(8)                 # level
        sps_id = br.ue()
        if profile in _HIGH_FAMILY:
            # the High family is in scope as long as it stays 4:2:0
            # 8-bit with FLAT scaling (non-flat matrices change the
            # requant math; reject → the rung passes the stream through)
            if br.ue() != 1:
                raise ValueError("chroma_format != 4:2:0")
            if br.ue() != 0 or br.ue() != 0:
                raise ValueError("bit depth > 8")
            if br.read_bit():
                raise ValueError("transform bypass unsupported")
            if br.read_bit():
                raise ValueError("scaling matrices unsupported")
        log2_mfn = br.ue() + 4
        poc_type = br.ue()
        log2_poc = 4
        if poc_type == 0:
            log2_poc = br.ue() + 4
        elif poc_type == 1:
            raise ValueError("poc_type 1 unsupported")
        br.ue()                         # max_num_ref_frames
        br.read_bit()
        w = br.ue() + 1
        h = br.ue() + 1
        fmo = br.read_bit()             # frame_mbs_only
        if not fmo:
            raise ValueError("interlace unsupported")
        return cls(w, h, sps_id, log2_mfn, poc_type, log2_poc)


@dataclass
class Pps:
    pps_id: int = 0
    sps_id: int = 0
    pic_init_qp: int = 26
    deblocking_control: bool = True
    bottom_field_poc: bool = False
    chroma_qp_offset: int = 0           # chroma_qp_index_offset (7.4.2.2)
    entropy_cabac: bool = False         # entropy_coding_mode_flag
    num_ref_l0_default: int = 0         # num_ref_idx_l0_default_active_minus1
    num_ref_l1_default: int = 0
    weighted_pred: bool = False         # P-slice explicit weighting
    transform_8x8_mode: bool = False    # High-profile 8x8 transform

    def build(self) -> bytes:
        bw = BitWriter()
        bw.ue(self.pps_id)
        bw.ue(self.sps_id)
        bw.write_bit(1 if self.entropy_cabac else 0)
        bw.write_bit(0)                 # bottom_field_pic_order
        bw.ue(0)                        # num_slice_groups_minus1
        bw.ue(self.num_ref_l0_default)
        bw.ue(self.num_ref_l1_default)
        bw.write_bit(1 if self.weighted_pred else 0)
        bw.write_bits(0, 2)             # weighted_bipred_idc
        bw.se(self.pic_init_qp - 26)
        bw.se(0)                        # pic_init_qs
        bw.se(self.chroma_qp_offset)
        bw.write_bit(1 if self.deblocking_control else 0)
        bw.write_bit(0)                 # constrained_intra_pred
        bw.write_bit(0)                 # redundant_pic_cnt_present
        if self.transform_8x8_mode:     # High-profile extension
            bw.write_bit(1)
            bw.write_bit(0)             # no scaling matrices
            bw.se(self.chroma_qp_offset)
        bw.rbsp_trailing()
        return b"\x68" + rbsp_to_nal(bw.to_bytes())

    @classmethod
    def parse(cls, nal: bytes) -> "Pps":
        br = BitReader(nal_to_rbsp(nal[1:]))
        pps_id = br.ue()
        sps_id = br.ue()
        cabac = bool(br.read_bit())     # entropy_coding_mode_flag
        bottom_poc = bool(br.read_bit())
        if br.ue() != 0:
            raise ValueError("slice groups unsupported")
        nref0 = br.ue()                 # num_ref_idx_l*_default_active_minus1
        nref1 = br.ue()
        wpred = bool(br.read_bit())     # weighted_pred (P requant rejects
        br.read_bits(2)                 # explicit weight tables at slice
        qp = br.se() + 26               # parse — pass-through)
        br.se()
        chroma_off = br.se()
        deblock = bool(br.read_bit())
        br.read_bit()                   # constrained_intra_pred
        if br.read_bit():               # redundant_pic_cnt_present: the
            # P slice header would carry redundant_pic_cnt — reject so
            # the rung passes such streams through instead of misparsing
            raise ValueError("redundant_pic_cnt unsupported")
        t8 = False
        if br.more_rbsp_data():         # High-profile PPS extension
            t8 = bool(br.read_bit())    # transform_8x8_mode_flag
            if br.read_bit():
                raise ValueError("scaling matrices unsupported")
            if br.se() != chroma_off:   # second_chroma_qp_index_offset:
                # the requant maps both components through ONE offset
                raise ValueError("split Cb/Cr qp offsets unsupported")
        return cls(pps_id, sps_id, qp, deblock, bottom_poc, chroma_off,
                   cabac, nref0, nref1, wpred, t8)


@dataclass
class SliceHeader:
    """Round-trippable I/P-slice header fields (subset of 7.3.3)."""

    nal_type: int = 5
    nal_ref_idc: int = 3
    slice_type: int = 7
    first_mb: int = 0                   # first_mb_in_slice (multi-slice)
    frame_num: int = 0
    idr_pic_id: int = 0
    poc_lsb: int = 0
    no_output_prior: int = 0
    long_term_ref: int = 0
    qp: int = 26
    deblock_idc: int = 1
    deblock_alpha: int = 0
    deblock_beta: int = 0
    # -- P-slice fields (7.3.3 + 7.3.3.1/7.3.3.3), round-tripped raw --
    num_ref_override: bool = False      # num_ref_idx_active_override_flag
    num_ref_l0_minus1: int = 0          # valid when num_ref_override
    ref_list_mod: "list[tuple[int, int]] | None" = None   # l0 (idc, val)
    adaptive_marking: "list[tuple[int, tuple[int, ...]]] | None" = None
    cabac_init_idc: int = 0

    @property
    def is_p(self) -> bool:
        return self.slice_type % 5 == 0

    def num_ref_l0(self, pps: "Pps") -> int:
        """Active l0 reference count for this slice."""
        return (self.num_ref_l0_minus1 if self.num_ref_override
                else pps.num_ref_l0_default) + 1


def _zero_chroma() -> tuple[np.ndarray, np.ndarray]:
    return (np.zeros((2, 4), dtype=np.int64),
            np.zeros((2, 4, 15), dtype=np.int64))


@dataclass
class MacroblockI4x4:
    """Parsed I_NxN macroblock: everything needed to re-encode.  With
    ``transform_8x8`` (High profile), ``pred_modes`` holds FOUR intra8x8
    mode pairs and the residual lives in ``levels8`` ([4, 64] 8x8-zigzag
    levels) instead of ``levels``."""

    pred_modes: list[tuple[int, int]]   # (use_predicted, rem_mode) × 16/4
    chroma_mode: int
    cbp: int                            # FULL 6-bit CBP (luma | chroma<<4)
    qp: int                             # ABSOLUTE QPY of this MB (spec
    levels: np.ndarray                  # 7.4.5: mb_qp_delta accumulates
                                        # across MBs; the writer re-derives
                                        # deltas) · [16, 16] zigzag levels
    chroma_dc: np.ndarray = field(default_factory=lambda: _zero_chroma()[0])
    chroma_ac: np.ndarray = field(default_factory=lambda: _zero_chroma()[1])
    transform_8x8: bool = False
    levels8: "np.ndarray | None" = None

    @property
    def chroma_cbp(self) -> int:
        return self.cbp >> 4


@dataclass
class MacroblockI16x16:
    """Parsed I_16x16 macroblock (mb_type 1..24): DC Hadamard block +
    optional 15-coeff AC blocks, plus 4:2:0 chroma residuals."""

    pred_mode: int                      # intra16x16 pred mode 0..3
    chroma_mode: int
    luma_cbp15: bool                    # True = AC blocks coded (CBP 15)
    qp: int
    dc_levels: np.ndarray               # [16] zigzag DC levels
    ac_levels: np.ndarray               # [16, 15] zigzag AC levels
    chroma_cbp: int = 0                 # 0 none / 1 DC only / 2 DC+AC
    chroma_dc: np.ndarray = field(default_factory=lambda: _zero_chroma()[0])
    chroma_ac: np.ndarray = field(default_factory=lambda: _zero_chroma()[1])

    @property
    def mb_type(self) -> int:
        return (1 + self.pred_mode + 4 * self.chroma_cbp
                + (12 if self.luma_cbp15 else 0))


class MacroblockPSkip:
    """P_Skip marker: occupies an MB position with no syntax of its own
    (CAVLC folds runs of these into mb_skip_run; CABAC codes one
    mb_skip_flag each).  The requant rung never touches skipped MBs."""

    __slots__ = ()
    qp = None                           # no QP chain participation
    chroma_cbp = 0


@dataclass
class MacroblockInter:
    """Parsed P macroblock (mb_type 0..4): motion syntax is carried
    VERBATIM (the transform-domain rung never re-derives prediction),
    residual levels are the requant surface.

    ``refs``/``mvds`` are in exact bitstream order (mb_pred /
    sub_mb_pred 7.3.5.1-2): all ref_idx_l0 first, then every mvd pair;
    ``sub_types`` is None unless mb_type is P_8x8 / P_8x8ref0."""

    mb_type: int                        # 0..4 (Table 7-13)
    sub_types: "list[int] | None"       # 4 × sub_mb_type for P_8x8*
    refs: list[int]                     # ref_idx_l0 per partition
    mvds: "list[tuple[int, int]]"       # (mvd_x, mvd_y) per (sub)partition
    cbp: int                            # FULL 6-bit CBP
    qp: int                             # ABSOLUTE QPY (7.4.5 chain)
    levels: np.ndarray                  # [16, 16] zigzag luma levels
    chroma_dc: np.ndarray = field(default_factory=lambda: _zero_chroma()[0])
    chroma_ac: np.ndarray = field(default_factory=lambda: _zero_chroma()[1])
    transform_8x8: bool = False
    levels8: "np.ndarray | None" = None

    @property
    def chroma_cbp(self) -> int:
        return self.cbp >> 4

    @property
    def allows_8x8(self) -> bool:
        """7.3.5's noSubMbPartSizeLessThan8x8Flag for P types."""
        return self.mb_type <= 2 or all(t == 0 for t in self.sub_types)


class SliceCodec:
    """Shared slice walk: parse ⇄ serialize I slices of I_4x4 and
    I_16x16 macroblocks."""

    def __init__(self, sps: Sps, pps: Pps):
        self.sps = sps
        self.pps = pps

    # -- slice header ------------------------------------------------------
    def parse_slice_header(self, br: BitReader, nal_byte: int
                           ) -> "SliceHeader":
        """Parses the full I/P-slice header (H.264 7.3.3) so the requant
        writer can ROUND-TRIP every field — frame_num, idr_pic_id, POC
        lsb, ref-list modifications, dec_ref_pic_marking — not just the
        QP.  Leaves ``br`` at the first MB."""
        nal_type = nal_byte & 0x1F
        nal_ref_idc = (nal_byte >> 5) & 3
        h = SliceHeader(nal_type=nal_type, nal_ref_idc=nal_ref_idc)
        h.first_mb = br.ue()
        if h.first_mb >= self.sps.width_mbs * self.sps.height_mbs:
            raise ValueError("first_mb_in_slice beyond the picture")
        h.slice_type = br.ue()
        if h.slice_type % 5 not in (0, 2):
            raise ValueError(
                f"slice type {h.slice_type} unsupported (I/P scope)")
        br.ue()                          # pps id (ours)
        h.frame_num = br.read_bits(self.sps.log2_max_frame_num)
        if nal_type == 5:
            h.idr_pic_id = br.ue()
        if self.sps.poc_type == 0:
            if self.pps.bottom_field_poc:
                raise ValueError("bottom-field POC unsupported")
            h.poc_lsb = br.read_bits(self.sps.log2_max_poc_lsb)
        if h.is_p:
            if self.pps.weighted_pred:
                # explicit pred_weight_table in the header — out of the
                # requant scope, pass the stream through
                raise ValueError("weighted prediction unsupported")
            h.num_ref_override = bool(br.read_bit())
            if h.num_ref_override:
                h.num_ref_l0_minus1 = br.ue()
            if br.read_bit():            # ref_pic_list_modification_flag
                h.ref_list_mod = []
                while True:
                    idc = br.ue()
                    if idc == 3:
                        break
                    if idc > 3:
                        raise ValueError("bad modification idc")
                    h.ref_list_mod.append((idc, br.ue()))
        if nal_ref_idc != 0:             # dec_ref_pic_marking (7.3.3.3)
            if nal_type == 5:
                h.no_output_prior = br.read_bit()
                h.long_term_ref = br.read_bit()
            elif br.read_bit():          # adaptive marking: MMCO loop,
                h.adaptive_marking = []  # round-tripped raw (7.4.3.3)
                while True:
                    op = br.ue()
                    if op == 0:
                        break
                    if op in (1, 2, 4, 6):
                        h.adaptive_marking.append((op, (br.ue(),)))
                    elif op == 3:
                        h.adaptive_marking.append((op, (br.ue(), br.ue())))
                    elif op == 5:
                        h.adaptive_marking.append((op, ()))
                    else:
                        raise ValueError("bad MMCO op")
        if self.pps.entropy_cabac and h.is_p:
            h.cabac_init_idc = br.ue()
            if h.cabac_init_idc > 2:
                raise ValueError("cabac_init_idc out of range")
        h.qp = self.pps.pic_init_qp + br.se()        # + slice_qp_delta
        if self.pps.deblocking_control:
            idc = br.ue()
            h.deblock_idc = idc
            if idc != 1:
                h.deblock_alpha = br.se()
                h.deblock_beta = br.se()
        return h

    def write_slice_header(self, bw: BitWriter, h: "SliceHeader",
                           qp: int) -> None:
        bw.ue(h.first_mb)                # first_mb_in_slice
        bw.ue(h.slice_type)
        bw.ue(self.pps.pps_id)
        bw.write_bits(h.frame_num, self.sps.log2_max_frame_num)
        if h.nal_type == 5:
            bw.ue(h.idr_pic_id)
        if self.sps.poc_type == 0:
            bw.write_bits(h.poc_lsb, self.sps.log2_max_poc_lsb)
        if h.is_p:
            bw.write_bit(1 if h.num_ref_override else 0)
            if h.num_ref_override:
                bw.ue(h.num_ref_l0_minus1)
            bw.write_bit(1 if h.ref_list_mod is not None else 0)
            if h.ref_list_mod is not None:
                for idc, val in h.ref_list_mod:
                    bw.ue(idc)
                    bw.ue(val)
                bw.ue(3)
        if h.nal_ref_idc != 0:           # dec_ref_pic_marking
            if h.nal_type == 5:
                bw.write_bit(h.no_output_prior)
                bw.write_bit(h.long_term_ref)
            else:
                bw.write_bit(1 if h.adaptive_marking is not None else 0)
                if h.adaptive_marking is not None:
                    for op, args in h.adaptive_marking:
                        bw.ue(op)
                        for a in args:
                            bw.ue(a)
                    bw.ue(0)
        if self.pps.entropy_cabac and h.is_p:
            bw.ue(h.cabac_init_idc)
        bw.se(qp - self.pps.pic_init_qp)
        if self.pps.deblocking_control:
            bw.ue(h.deblock_idc)
            if h.deblock_idc != 1:
                bw.se(h.deblock_alpha)
                bw.se(h.deblock_beta)

    # -- macroblock layer --------------------------------------------------
    def _fresh_totals(self):
        """(luma, chroma) nC context grids for one slice walk: per-4x4
        TotalCoeff, −1 = unavailable.  Chroma grid is [2, h2, w2] (Cb,
        Cr planes of 2×2 blocks per MB)."""
        w4 = self.sps.width_mbs * 4
        h4 = self.sps.height_mbs * 4
        luma = np.full((h4, w4), -1, dtype=np.int32)
        chroma = np.full((2, self.sps.height_mbs * 2,
                          self.sps.width_mbs * 2), -1, dtype=np.int32)
        return luma, chroma

    def _mark_skip_nc(self, mb_idx: int, totals: np.ndarray,
                      tot_c: np.ndarray) -> None:
        """A P_Skip MB's blocks count TotalCoeff 0 in 9.2.1 neighbor
        contexts (available, no residual)."""
        mb_x = (mb_idx % self.sps.width_mbs) * 4
        mb_y = (mb_idx // self.sps.width_mbs) * 4
        totals[mb_y:mb_y + 4, mb_x:mb_x + 4] = 0
        cx, cy = (mb_idx % self.sps.width_mbs) * 2, \
            (mb_idx // self.sps.width_mbs) * 2
        tot_c[:, cy:cy + 2, cx:cx + 2] = 0

    def _read_ref(self, br: BitReader, n_ref: int) -> int:
        if n_ref == 1:
            return 0                    # not coded, inferred (7.4.5.1)
        if n_ref == 2:
            return 1 - br.read_bit()    # te(v) with cMax 1: inverted bit
        return br.ue()

    def _write_ref(self, bw: BitWriter, ref: int, n_ref: int) -> None:
        if n_ref == 1:
            return
        if n_ref == 2:
            bw.write_bit(1 - ref)
        else:
            bw.ue(ref)

    def _parse_inter_mb(self, br: BitReader, mb_type: int, mb_idx: int,
                        cur_qp: int, n_ref: int, totals: np.ndarray,
                        tot_c: np.ndarray
                        ) -> "tuple[MacroblockInter, int]":
        """mb_pred/sub_mb_pred (7.3.5.1-2) for P types 0..4, then the
        shared residual walk.  Motion syntax is carried verbatim."""
        sub_types = None
        refs: list[int] = []
        mvds: list[tuple[int, int]] = []
        if mb_type in (0, 1, 2):
            nparts = P_MB_PARTS[mb_type]
            for _ in range(nparts):
                refs.append(self._read_ref(br, n_ref))
            for _ in range(nparts):
                mvds.append((br.se(), br.se()))
        elif mb_type in (3, 4):
            sub_types = [br.ue() for _ in range(4)]
            if any(t > 3 for t in sub_types):
                raise ValueError("bad P sub_mb_type")
            if mb_type == 3:
                for _ in range(4):
                    refs.append(self._read_ref(br, n_ref))
            for st in sub_types:        # P_8x8ref0: refs inferred 0
                for _ in range(P_SUB_PARTS[st]):
                    mvds.append((br.se(), br.se()))
        else:
            raise ValueError(f"P mb_type {mb_type} unsupported")
        cbp = CBP_INTER_FROM_CODE[br.ue()]
        mb = MacroblockInter(mb_type, sub_types, refs, mvds, cbp, cur_qp,
                             np.zeros((16, 16), dtype=np.int64))
        if (cbp & 15) and self.pps.transform_8x8_mode and mb.allows_8x8:
            mb.transform_8x8 = bool(br.read_bit())
        if cbp:
            cur_qp += br.se()           # mb_qp_delta accumulates (7.4.5)
            if not 0 <= cur_qp <= 51:
                raise ValueError("QPY out of range")
            mb.qp = cur_qp
        if mb.transform_8x8:
            mb.levels8 = np.zeros((4, 64), dtype=np.int64)
            self._residuals8(br, mb_idx, cbp & 15, mb.levels8, totals,
                             decode=True)
        else:
            self._residuals(br, mb_idx, cbp & 15, mb.levels, totals,
                            decode=True)
        self._residuals_chroma(br, mb_idx, cbp >> 4, mb.chroma_dc,
                               mb.chroma_ac, tot_c, decode=True)
        return mb, cur_qp

    def _write_inter_mb(self, bw: BitWriter, mb: "MacroblockInter",
                        mb_idx: int, prev_qp: int, n_ref: int,
                        totals: np.ndarray, tot_c: np.ndarray) -> None:
        bw.ue(mb.mb_type)
        if mb.mb_type in (0, 1, 2):
            for r in mb.refs:
                self._write_ref(bw, r, n_ref)
        else:
            for st in mb.sub_types:
                bw.ue(st)
            if mb.mb_type == 3:
                for r in mb.refs:
                    self._write_ref(bw, r, n_ref)
        for mx, my in mb.mvds:
            bw.se(mx)
            bw.se(my)
        bw.ue(CBP_INTER_TO_CODE[mb.cbp])
        if (mb.cbp & 15) and self.pps.transform_8x8_mode \
                and mb.allows_8x8:
            bw.write_bit(1 if mb.transform_8x8 else 0)
        if mb.cbp:
            delta = mb.qp - prev_qp
            if not -26 <= delta <= 25:
                raise ValueError("mb_qp_delta out of range")
            bw.se(delta)
        if mb.transform_8x8 and mb.levels8 is not None:
            self._residuals8(bw, mb_idx, mb.cbp & 15, mb.levels8,
                             totals, decode=False)
        else:
            self._residuals(bw, mb_idx, mb.cbp & 15, mb.levels, totals,
                            decode=False)
        self._residuals_chroma(bw, mb_idx, mb.cbp >> 4, mb.chroma_dc,
                               mb.chroma_ac, tot_c, decode=False)

    def parse_mbs(self, br: BitReader, slice_qp: int, first_mb: int = 0,
                  hdr: "SliceHeader | None" = None) -> "list":
        """Walk the slice's MBs from ``first_mb`` until the RBSP stop bit
        (7.3.4 moreDataFlag for CAVLC).  nC contexts start fresh — MBs of
        other slices are unavailable neighbors (6.4.9), which the grids'
        untouched −1 cells encode exactly.  With a P ``hdr``, each
        iteration consumes the leading mb_skip_run and inter MB types;
        intra mb_types arrive offset by 5 (Table 7-13)."""
        n_mbs = self.sps.width_mbs * self.sps.height_mbs
        totals, tot_c = self._fresh_totals()
        mbs = []
        cur_qp = slice_qp
        is_p = hdr is not None and hdr.is_p
        n_ref = hdr.num_ref_l0(self.pps) if is_p else 1
        mb_idx = first_mb
        while mb_idx < n_mbs:
            if mbs and not br.more_rbsp_data():
                break                   # end of this slice's MB data
            if is_p:
                run = br.ue()           # mb_skip_run
                if mb_idx + run > n_mbs:
                    raise ValueError("skip run overruns picture")
                for _ in range(run):
                    self._mark_skip_nc(mb_idx, totals, tot_c)
                    mbs.append(MacroblockPSkip())
                    mb_idx += 1
                if not br.more_rbsp_data():
                    break               # slice ends on a skip run
                if mb_idx >= n_mbs:
                    raise ValueError("MB data past picture end")
            mb_type = br.ue()
            if is_p and mb_type < 5:
                mb, cur_qp = self._parse_inter_mb(
                    br, mb_type, mb_idx, cur_qp, n_ref, totals, tot_c)
                mbs.append(mb)
                mb_idx += 1
                continue
            if is_p:
                mb_type -= 5            # intra types ride offset by 5
            if mb_type == 0:
                t8 = bool(self.pps.transform_8x8_mode and br.read_bit())
                modes = []
                for _ in range(4 if t8 else 16):
                    flag = br.read_bit()
                    rem = 0 if flag else br.read_bits(3)
                    modes.append((flag, rem))
                chroma_mode = br.ue()
                cbp = CBP_INTRA_FROM_CODE[br.ue()]
                if cbp:
                    cur_qp += br.se()   # mb_qp_delta ACCUMULATES (7.4.5)
                    if not 0 <= cur_qp <= 51:
                        raise ValueError("QPY out of range")
                levels = np.zeros((16, 16), dtype=np.int64)
                mb = MacroblockI4x4(modes, chroma_mode, cbp, cur_qp,
                                    levels, transform_8x8=t8)
                if t8:
                    mb.levels8 = np.zeros((4, 64), dtype=np.int64)
                    self._residuals8(br, mb_idx, cbp, mb.levels8,
                                     totals, decode=True)
                else:
                    self._residuals(br, mb_idx, cbp, levels, totals,
                                    decode=True)
                self._residuals_chroma(br, mb_idx, cbp >> 4,
                                       mb.chroma_dc, mb.chroma_ac,
                                       tot_c, decode=True)
                mbs.append(mb)
            elif 1 <= mb_type <= 24:
                pred = (mb_type - 1) % 4
                chroma_cbp = ((mb_type - 1) // 4) % 3
                luma15 = mb_type >= 13
                chroma_mode = br.ue()
                cur_qp += br.se()       # always coded for I_16x16
                if not 12 <= cur_qp <= 51:
                    # <12: DC dequant uses a rounding form that breaks the
                    # exact +6k shift argument — pass through
                    raise ValueError("QPY out of I_16x16 requant range")
                mb16 = MacroblockI16x16(
                    pred, chroma_mode, luma15, cur_qp,
                    np.zeros(16, dtype=np.int64),
                    np.zeros((16, 15), dtype=np.int64), chroma_cbp)
                self._residuals16(br, mb_idx, mb16, totals, decode=True)
                self._residuals_chroma(br, mb_idx, chroma_cbp,
                                       mb16.chroma_dc, mb16.chroma_ac,
                                       tot_c, decode=True)
                mbs.append(mb16)
            else:
                raise ValueError(
                    f"mb_type {mb_type} unsupported (I/P scope)")
            mb_idx += 1
        return mbs

    def write_mbs(self, bw: BitWriter, mbs: "list", slice_qp: int,
                  first_mb: int = 0,
                  hdr: "SliceHeader | None" = None) -> None:
        totals, tot_c = self._fresh_totals()
        prev_qp = slice_qp               # deltas are vs the PREVIOUS MB's
        is_p = hdr is not None and hdr.is_p  # QP (7.4.5), not slice QP
        n_ref = hdr.num_ref_l0(self.pps) if is_p else 1
        run = 0
        for mb_idx, mb in enumerate(mbs, start=first_mb):
            if isinstance(mb, MacroblockPSkip):
                self._mark_skip_nc(mb_idx, totals, tot_c)
                run += 1
                continue
            if is_p:
                bw.ue(run)               # mb_skip_run before every coded
                run = 0                  # MB of a P slice (7.3.4)
            if isinstance(mb, MacroblockInter):
                self._write_inter_mb(bw, mb, mb_idx, prev_qp, n_ref,
                                     totals, tot_c)
                if mb.cbp:
                    prev_qp = mb.qp
                continue
            if isinstance(mb, MacroblockI16x16):
                bw.ue(mb.mb_type + (5 if is_p else 0))
                bw.ue(mb.chroma_mode)
                delta = mb.qp - prev_qp
                if not -26 <= delta <= 25:
                    raise ValueError("mb_qp_delta out of range")
                bw.se(delta)             # always coded for I_16x16
                prev_qp = mb.qp
                self._residuals16(bw, mb_idx, mb, totals, decode=False)
                self._residuals_chroma(bw, mb_idx, mb.chroma_cbp,
                                       mb.chroma_dc, mb.chroma_ac,
                                       tot_c, decode=False)
                continue
            bw.ue(5 if is_p else 0)      # mb_type I_NxN
            if self.pps.transform_8x8_mode:
                bw.write_bit(1 if mb.transform_8x8 else 0)
            for flag, rem in mb.pred_modes:
                bw.write_bit(flag)
                if not flag:
                    bw.write_bits(rem, 3)
            bw.ue(mb.chroma_mode)
            bw.ue(CBP_INTRA_TO_CODE[mb.cbp])
            if mb.cbp:
                delta = mb.qp - prev_qp
                if not -26 <= delta <= 25:
                    raise ValueError("mb_qp_delta out of range")
                bw.se(delta)
                prev_qp = mb.qp
            # cbp == 0: no qp_delta syntax — the MB has no residual so its
            # QP is irrelevant; prev_qp carries to the next coded MB
            if mb.transform_8x8 and mb.levels8 is not None:
                self._residuals8(bw, mb_idx, mb.cbp & 15, mb.levels8,
                                 totals, decode=False)
            else:
                self._residuals(bw, mb_idx, mb.cbp, mb.levels, totals,
                                decode=False)
            self._residuals_chroma(bw, mb_idx, mb.cbp >> 4,
                                   mb.chroma_dc, mb.chroma_ac,
                                   tot_c, decode=False)
        if is_p and run:
            bw.ue(run)                   # slice ends on a skip run

    def _nc_at(self, totals: np.ndarray, gx: int, gy: int) -> int:
        w4 = totals.shape[1]
        nA = totals[gy, gx - 1] if gx > 0 else -1
        nB = totals[gy - 1, gx] if gy > 0 else -1
        if nA >= 0 and nB >= 0:
            return int(nA + nB + 1) >> 1
        if nA >= 0:
            return int(nA)
        if nB >= 0:
            return int(nB)
        return 0

    def _residuals16(self, bio, mb_idx: int, mb: "MacroblockI16x16",
                     totals: np.ndarray, *, decode: bool) -> None:
        """I_16x16 residual walk: one 16-coeff DC block (nC from the
        luma4x4BlkIdx-0 neighbors), then — when luma CBP is 15 — sixteen
        15-coeff AC blocks.  Per-4x4 context totals store the AC
        TotalCoeff (DC excluded), matching 9.2.1's nN derivation."""
        mb_x = (mb_idx % self.sps.width_mbs) * 4
        mb_y = (mb_idx // self.sps.width_mbs) * 4
        nC = self._nc_at(totals, mb_x, mb_y)
        if decode:
            mb.dc_levels[:] = cavlc.decode_residual(bio, nC, 16)
        else:
            cavlc.encode_residual(bio, [int(v) for v in mb.dc_levels], nC,
                                  16)
        for blk in range(16):
            x4, y4 = BLK_XY[blk]
            gx, gy = mb_x + x4, mb_y + y4
            if not mb.luma_cbp15:
                totals[gy, gx] = 0
                if decode:
                    mb.ac_levels[blk] = 0
                continue
            nC = self._nc_at(totals, gx, gy)
            if decode:
                mb.ac_levels[blk] = cavlc.decode_residual(bio, nC, 15)
                totals[gy, gx] = int(np.count_nonzero(mb.ac_levels[blk]))
            else:
                cavlc.encode_residual(
                    bio, [int(v) for v in mb.ac_levels[blk]], nC, 15)
                totals[gy, gx] = int(np.count_nonzero(mb.ac_levels[blk]))

    def _residuals(self, bio, mb_idx: int, cbp: int, levels: np.ndarray,
                   totals: np.ndarray, *, decode: bool) -> None:
        """Walk the 16 luma blocks in spec order, maintaining the nC
        context grid; decode into ``levels`` or encode from it."""
        mb_x = (mb_idx % self.sps.width_mbs) * 4
        mb_y = (mb_idx // self.sps.width_mbs) * 4
        for blk in range(16):
            x4, y4 = BLK_XY[blk]
            gx, gy = mb_x + x4, mb_y + y4
            if not (cbp >> (blk >> 2)) & 1:
                totals[gy, gx] = 0
                levels[blk] = 0
                continue
            nA = totals[gy, gx - 1] if gx > 0 else -1
            nB = totals[gy - 1, gx] if gy > 0 else -1
            if nA >= 0 and nB >= 0:
                nC = (nA + nB + 1) >> 1
            elif nA >= 0:
                nC = int(nA)
            elif nB >= 0:
                nC = int(nB)
            else:
                nC = 0
            if decode:
                lv = cavlc.decode_residual(bio, nC)
                levels[blk] = lv
                totals[gy, gx] = sum(1 for v in lv if v)
            else:
                lv = [int(v) for v in levels[blk]]
                cavlc.encode_residual(bio, lv, nC)
                totals[gy, gx] = sum(1 for v in lv if v)

    def _residuals8(self, bio, mb_idx: int, cbp: int,
                    levels8: np.ndarray, totals: np.ndarray, *,
                    decode: bool) -> None:
        """8x8-transform luma residuals, CAVLC style (7.3.5.3.2): each
        coded 8x8 block rides as FOUR interleaved 4x4 blocks — sub j
        carries 8x8-zigzag positions j, j+4, ... — with the ordinary
        per-4x4 nC context grid."""
        mb_x = (mb_idx % self.sps.width_mbs) * 4
        mb_y = (mb_idx // self.sps.width_mbs) * 4
        for blk in range(16):
            i8, j = blk >> 2, blk & 3
            x4, y4 = BLK_XY[blk]
            gx, gy = mb_x + x4, mb_y + y4
            if not (cbp >> i8) & 1:
                totals[gy, gx] = 0
                if decode:
                    levels8[i8, j::4] = 0
                continue
            nC = self._nc_at(totals, gx, gy)
            if decode:
                lv = cavlc.decode_residual(bio, nC)
                levels8[i8, j::4] = lv
                totals[gy, gx] = sum(1 for v in lv if v)
            else:
                lv = [int(v) for v in levels8[i8, j::4]]
                cavlc.encode_residual(bio, lv, nC)
                totals[gy, gx] = sum(1 for v in lv if v)

    def _residuals_chroma(self, bio, mb_idx: int, chroma_cbp: int,
                          cdc: np.ndarray, cac: np.ndarray,
                          tot_c: np.ndarray, *, decode: bool) -> None:
        """4:2:0 chroma residual walk (7.3.5.3.3 order): both components'
        DC blocks first (nC = −1, 4 coeffs), then per component the four
        AC blocks when chroma CBP is 2.  ``tot_c[comp]`` keeps each
        chroma AC block's TotalCoeff for 9.2.1 neighbor contexts (an
        uncoded block counts 0, off-picture is unavailable)."""
        mb_x = (mb_idx % self.sps.width_mbs) * 2
        mb_y = (mb_idx // self.sps.width_mbs) * 2
        if chroma_cbp:
            for comp in range(2):
                if decode:
                    cdc[comp] = cavlc.decode_residual(bio, -1, 4)
                else:
                    cavlc.encode_residual(
                        bio, [int(v) for v in cdc[comp]], -1, 4)
        elif decode:
            cdc[:] = 0
        for comp in range(2):
            grid = tot_c[comp]
            for blk in range(4):
                gx, gy = mb_x + (blk & 1), mb_y + (blk >> 1)
                if chroma_cbp != 2:
                    grid[gy, gx] = 0
                    if decode:
                        cac[comp, blk] = 0
                    continue
                nA = grid[gy, gx - 1] if gx > 0 else -1
                nB = grid[gy - 1, gx] if gy > 0 else -1
                if nA >= 0 and nB >= 0:
                    nC = int(nA + nB + 1) >> 1
                elif nA >= 0:
                    nC = int(nA)
                elif nB >= 0:
                    nC = int(nB)
                else:
                    nC = 0
                if decode:
                    cac[comp, blk] = cavlc.decode_residual(bio, nC, 15)
                else:
                    cavlc.encode_residual(
                        bio, [int(v) for v in cac[comp, blk]], nC, 15)
                grid[gy, gx] = int(np.count_nonzero(cac[comp, blk]))


# ----------------------------------------------------------------- encoder

def _dc_pred(recon: np.ndarray, gx: int, gy: int, gy_min: int = 0) -> int:
    """4×4 DC prediction from reconstructed neighbors (mode 2).
    ``gy_min`` is the slice's first 4×4-block row: neighbors above it
    belong to another slice and are unavailable (6.4.9); slices split on
    MB-row boundaries, so left neighbors are always same-slice."""
    x0, y0 = gx * 4, gy * 4
    left = recon[y0:y0 + 4, x0 - 1] if x0 > 0 else None
    top = recon[y0 - 1, x0:x0 + 4] if gy > gy_min else None
    if left is not None and top is not None:
        return int((int(left.sum()) + int(top.sum()) + 4) >> 3)
    if left is not None:
        return int((int(left.sum()) + 2) >> 2)
    if top is not None:
        return int((int(top.sum()) + 2) >> 2)
    return 128


def _chroma_dc_pred_mb(recon: np.ndarray, mbx: int, mby: int,
                       mby_min: int = 0) -> np.ndarray:
    """[8,8] mode-0 (DC) chroma prediction for one MB per 8.3.4.1: each
    4×4 sub-block predicts from the MB-adjacent row above / column left
    at its own offsets, with the corner blocks averaging both and the
    off-diagonal blocks preferring top (x>0) or left (y>0).  ``mby_min``
    is the slice's first MB row (rows above are another slice)."""
    x0, y0 = mbx * 8, mby * 8
    pred = np.empty((8, 8), dtype=np.int64)
    for by in range(2):
        for bx in range(2):
            top = (recon[y0 - 1, x0 + bx * 4:x0 + bx * 4 + 4]
                   if mby > mby_min else None)
            left = (recon[y0 + by * 4:y0 + by * 4 + 4, x0 - 1]
                    if mbx > 0 else None)
            if (bx, by) == (1, 0):        # top-right block prefers top
                one = top if top is not None else left
                val = 128 if one is None else (int(one.sum()) + 2) >> 2
            elif (bx, by) == (0, 1):      # bottom-left prefers left
                one = left if left is not None else top
                val = 128 if one is None else (int(one.sum()) + 2) >> 2
            elif top is not None and left is not None:   # corners: both
                val = (int(top.sum()) + int(left.sum()) + 4) >> 3
            elif left is not None:
                val = (int(left.sum()) + 2) >> 2
            elif top is not None:
                val = (int(top.sum()) + 2) >> 2
            else:
                val = 128
            pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = val
    return pred


def _encode_chroma_comp(plane: np.ndarray, recon: np.ndarray, mbx: int,
                        mby: int, qpc: int, mby_min: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Quantize one MB's chroma component: ([4] DC levels, [4,15] AC)."""
    pred = _chroma_dc_pred_mb(recon, mbx, mby, mby_min)
    x0, y0 = mbx * 8, mby * 8
    res = plane[y0:y0 + 8, x0:x0 + 8].astype(np.int64) - pred
    w00 = np.empty(4, dtype=np.int64)
    ac = np.zeros((4, 15), dtype=np.int64)
    for b in range(4):
        bx, by = b & 1, b >> 1
        blk = res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
        w00[b] = (_CF @ blk @ _CF.T)[0, 0]
        ac[b] = forward_transform_quant(blk, qpc)[ZIGZAG4[1:]]
    return chroma_dc_quant(w00, qpc), ac


def _recon_chroma_comp(recon: np.ndarray, mbx: int, mby: int,
                       dc: np.ndarray, ac: np.ndarray, qpc: int,
                       mby_min: int = 0) -> None:
    """Reconstruct one MB's chroma component exactly as a decoder does
    (8.5.11 DC chain + 8.5.12 AC dequant + inverse core transform)."""
    pred = _chroma_dc_pred_mb(recon, mbx, mby, mby_min)
    if not (np.any(dc) or np.any(ac)):   # no residual: pure prediction
        x0, y0 = mbx * 8, mby * 8
        recon[y0:y0 + 8, x0:x0 + 8] = pred
        return
    dcc = chroma_dc_dequant(dc, qpc)
    vq = v_position(qpc)
    x0, y0 = mbx * 8, mby * 8
    for b in range(4):
        bx, by = b & 1, b >> 1
        lev = np.zeros(16, dtype=np.int64)
        lev[ZIGZAG4[1:]] = ac[b]
        w = (lev * vq) << (qpc // 6)
        w[0] = dcc[b]
        res = inverse_core(w.reshape(4, 4))
        recon[y0 + by * 4:y0 + by * 4 + 4,
              x0 + bx * 4:x0 + bx * 4 + 4] = np.clip(
            pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res, 0, 255)


def encode_iframe(luma: np.ndarray, qp: int, *, frame_num: int = 0,
                  idr_pic_id: int = 0, cb: np.ndarray | None = None,
                  cr: np.ndarray | None = None,
                  sps: Sps | None = None, pps: Pps | None = None,
                  include_ps: bool = True, slices: int = 1,
                  entropy: str = "cavlc") -> list[bytes]:
    """uint8 [H, W] luma (H, W multiples of 16) → NAL payloads
    ([SPS, PPS,] IDR slice(s)), DC-predicted I_4x4 with a real
    reconstruction loop (prediction always from reconstructed samples,
    as a conformant decoder will see them).  Optional ``cb``/``cr``
    [H/2, W/2] planes get real 4:2:0 chroma residuals (mode-0 predicted,
    DC+AC coded); omitted planes keep chroma CBP 0.  ``slices`` splits
    the picture into that many MB-row-aligned slices (the low-latency
    encoder shape), each with slice-scoped prediction and nC contexts."""
    h, w = luma.shape
    if h % 16 or w % 16:
        raise ValueError("dimensions must be multiples of 16")
    sps = sps or Sps(w // 16, h // 16,
                     profile_idc=77 if entropy == "cabac" else 66)
    pps = pps or Pps(pic_init_qp=qp, entropy_cabac=(entropy == "cabac"))
    if not 1 <= slices <= sps.height_mbs:
        raise ValueError("slices must be in 1..height_mbs")
    codec = SliceCodec(sps, pps)
    recon = np.zeros((h, w), dtype=np.int64)
    do_chroma = cb is not None and cr is not None
    qpc = chroma_qp(qp, pps.chroma_qp_offset)
    recon_c = np.zeros((2, h // 2, w // 2), dtype=np.int64)
    zz = ZIGZAG4
    slice_rows = np.array_split(np.arange(sps.height_mbs), slices)
    out_nals: list[bytes] = []
    for rows in slice_rows:
        first_row = int(rows[0])
        first_mb = first_row * sps.width_mbs
        gy_min = first_row * 4           # slice boundary for prediction
        mbs: list[MacroblockI4x4] = []
        for mb_idx in range(first_mb,
                            (int(rows[-1]) + 1) * sps.width_mbs):
            mb_x = (mb_idx % sps.width_mbs) * 4
            mb_y = (mb_idx // sps.width_mbs) * 4
            levels = np.zeros((16, 16), dtype=np.int64)
            nz_blocks = np.zeros(16, dtype=bool)
            for blk in range(16):
                x4, y4 = BLK_XY[blk]
                gx, gy = mb_x + x4, mb_y + y4
                pred = _dc_pred(recon, gx, gy, gy_min)
                src = luma[gy * 4:gy * 4 + 4,
                           gx * 4:gx * 4 + 4].astype(np.int64)
                res = src - pred
                lv_raster = forward_transform_quant(res, qp)
                levels[blk] = lv_raster[zz]
                nz_blocks[blk] = bool(np.any(lv_raster))
                rec_res = dequant_inverse(lv_raster, qp)
                recon[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = np.clip(
                    pred + rec_res, 0, 255)
            cbp = 0
            for g in range(4):
                if nz_blocks[4 * g:4 * g + 4].any():
                    cbp |= 1 << g
            # CBP-cleared blocks carry no residual: the decoder
            # reconstructs them as pure prediction, so mirror that here
            for blk in range(16):
                if not (cbp >> (blk >> 2)) & 1 and nz_blocks[blk]:
                    levels[blk] = 0
            mb = MacroblockI4x4([(1, 0)] * 16, 0, cbp, qp, levels)
            if do_chroma:
                mbx = mb_idx % sps.width_mbs
                mby = mb_idx // sps.width_mbs
                for comp, plane in enumerate((cb, cr)):
                    mb.chroma_dc[comp], mb.chroma_ac[comp] = \
                        _encode_chroma_comp(plane, recon_c[comp], mbx,
                                            mby, qpc, first_row)
                ccbp = (2 if np.any(mb.chroma_ac) else
                        1 if np.any(mb.chroma_dc) else 0)
                mb.cbp = cbp | (ccbp << 4)
                for comp in range(2):
                    _recon_chroma_comp(recon_c[comp], mbx, mby,
                                       mb.chroma_dc[comp],
                                       mb.chroma_ac[comp], qpc, first_row)
            mbs.append(mb)
        hdr = SliceHeader(frame_num=frame_num, idr_pic_id=idr_pic_id,
                          qp=qp, first_mb=first_mb)
        if pps.entropy_cabac:
            from .h264_cabac import CabacSliceCodec
            out_nals.append(CabacSliceCodec(sps, pps).write_slice(
                hdr, first_mb, mbs, qp))
        else:
            bw = BitWriter()
            codec.write_slice_header(bw, hdr, qp)
            codec.write_mbs(bw, mbs, qp, first_mb)
            bw.rbsp_trailing()
            out_nals.append(bytes([0x65]) + rbsp_to_nal(bw.to_bytes()))
    if include_ps:
        return [sps.build(), pps.build()] + out_nals
    return out_nals


# ----------------------------------------------------------------- decoder

def decode_iframe_yuv(nals: list[bytes]
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NAL payloads → uint8 (Y [H,W], Cb, Cr [H/2,W/2]) planes (DC-mode
    I_4x4 scope, full 4:2:0 chroma, MB-row-aligned multi-slice)."""
    sps = pps = None
    slice_nals = []
    for nal in nals:
        t = nal[0] & 0x1F
        if t == 7:
            sps = Sps.parse(nal)
        elif t == 8:
            pps = Pps.parse(nal)
        elif t in (1, 5):
            slice_nals.append(nal)
    if sps is None or pps is None or not slice_nals:
        raise ValueError("need SPS+PPS+slice")
    codec = SliceCodec(sps, pps)
    h, w = sps.height_mbs * 16, sps.width_mbs * 16
    recon = np.zeros((h, w), dtype=np.int64)
    recon_c = np.zeros((2, h // 2, w // 2), dtype=np.int64)
    inv_zz = np.argsort(ZIGZAG4)
    for slice_nal in slice_nals:
        if pps.entropy_cabac:
            from .h264_cabac import CabacSliceCodec
            hdr, _first, mbs, _qps = CabacSliceCodec(
                sps, pps).parse_slice(slice_nal)
        else:
            br = BitReader(nal_to_rbsp(slice_nal[1:]))
            hdr = codec.parse_slice_header(br, slice_nal[0])
            mbs = codec.parse_mbs(br, hdr.qp, hdr.first_mb)
        if hdr.first_mb % sps.width_mbs:
            raise ValueError("decoder scope is MB-row-aligned slices")
        first_row = hdr.first_mb // sps.width_mbs
        for mb_idx, mb in enumerate(mbs, start=hdr.first_mb):
            if isinstance(mb, MacroblockI16x16):
                raise ValueError("decoder scope is I_4x4 only")
            mb_x = (mb_idx % sps.width_mbs) * 4
            mb_y = (mb_idx // sps.width_mbs) * 4
            cur_qp = mb.qp
            for blk in range(16):
                flag, _rem = mb.pred_modes[blk]
                if not flag:
                    # an explicit rem mode can never be DC when every
                    # context mode is DC (rem skips the predicted mode)
                    raise ValueError("non-DC intra mode out of scope")
                x4, y4 = BLK_XY[blk]
                gx, gy = mb_x + x4, mb_y + y4
                pred = _dc_pred(recon, gx, gy, first_row * 4)
                lv = mb.levels[blk][inv_zz]
                res = dequant_inverse(lv, cur_qp)
                recon[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = np.clip(
                    pred + res, 0, 255)
            if mb.chroma_mode != 0:
                raise ValueError("non-DC chroma mode out of scope")
            qpc = chroma_qp(cur_qp, pps.chroma_qp_offset)
            for comp in range(2):
                _recon_chroma_comp(recon_c[comp], mb_idx % sps.width_mbs,
                                   mb_idx // sps.width_mbs,
                                   mb.chroma_dc[comp], mb.chroma_ac[comp],
                                   qpc, first_row)
    return (recon.astype(np.uint8), recon_c[0].astype(np.uint8),
            recon_c[1].astype(np.uint8))


def decode_iframe(nals: list[bytes]) -> np.ndarray:
    """NAL payloads → uint8 [H, W] luma (DC-mode I_4x4 scope)."""
    return decode_iframe_yuv(nals)[0]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(255.0 * 255.0 / mse)
