"""CABAC entropy layer for the H.264 requant rung (I and P slices,
4:2:0).

The spec's arithmetic coding engine (9.3.3.2 decode, 9.3.4 encode) and
the I/P slice syntax layer (mb_type, skip flags, pred modes, ref_idx,
mvd (UEG3), CBP, mb_qp_delta, residual_block_cabac for ctxBlockCat
0-4) over the SAME macroblock model as the CAVLC path
(``h264_intra.MacroblockI4x4 / I16x16 / Inter / PSkip``), so the +6k
requant shift and the CBP/QP-chain recompute are shared byte for byte.

Scope (mirrors the CAVLC rung; outside it the caller passes through):
frame I and P slices, 4:2:0 8-bit, flat scaling, no I_PCM, no MBAFF, no
B slices, no weighted prediction.  High-profile 8x8 transform is
decoded (cat-5 residuals, ctx 399 flags); the requant gate refuses any
CABAC 8x8 slice whose parse ends before the picture (pass-through,
never truncation).  A copy of the reference's ``codecs/h264_cabac.py``.
"""

from __future__ import annotations

import numpy as np

from .h264_bits import BitReader, BitWriter, nal_to_rbsp, rbsp_to_nal
from .h264_cabac_tables import (CTX_INIT_I, CTX_INIT_P0, CTX_INIT_P1,
                                CTX_INIT_P2, LAST_MAP_8X8, RANGE_LPS,
                                SIG_MAP_8X8, TRANS_IDX_LPS,
                                TRANS_IDX_MPS)
from .h264_intra import (BLK_XY, MacroblockI16x16, MacroblockI4x4,
                         MacroblockInter, MacroblockPSkip, Pps,
                         SliceCodec, SliceHeader, Sps)

#: init table per slice type: I column, or inter column by cabac_init_idc
CTX_INIT_P = (CTX_INIT_P0, CTX_INIT_P1, CTX_INIT_P2)

#: P partition geometry in 8x8 units: mb_type → (x8, y8, w8, h8) rows
_P_PARTS8 = {0: ((0, 0, 2, 2),),
             1: ((0, 0, 2, 1), (0, 1, 2, 1)),
             2: ((0, 0, 1, 2), (1, 0, 1, 2))}
#: P sub-partition geometry in 4x4 units RELATIVE to the 8x8:
#: sub_mb_type → (x4, y4, w4, h4) rows
_P_SUB4 = {0: ((0, 0, 2, 2),),
           1: ((0, 0, 2, 1), (0, 1, 2, 1)),
           2: ((0, 0, 1, 2), (1, 0, 1, 2)),
           3: ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1))}

# ctxIdx bases (frame coding; verified against the system libavcodec's
# compiled offset tables — see tools/gen_cabac_tables.py)
_CBF_BASE = 85           # + 4*ctxBlockCat + inc
_SIG_BASE = (105, 120, 134, 149, 152)      # significant_coeff_flag
_LAST_BASE = (166, 181, 195, 210, 213)     # last_significant_coeff_flag
_ABS_BASE = (227, 237, 247, 257, 266)      # coeff_abs_level_minus1
_TERMINATE = 276                           # end_of_slice / I_PCM bin
_T8_BASE = 399                             # transform_size_8x8_flag
_SIG8 = 402                                # cat 5 (8x8 luma) residual
_LAST8 = 417
_ABS8 = 426


def _init_states(slice_qp: int, table=CTX_INIT_I) -> np.ndarray:
    """pStateIdx/valMPS per ctxIdx from the (m, n) pairs (9.3.1.1);
    ``table`` is the intra column or CTX_INIT_P[cabac_init_idc]."""
    qp = min(max(slice_qp, 0), 51)
    mn = np.asarray(table, dtype=np.int64).reshape(1024, 2)
    pre = np.clip(((mn[:, 0] * qp) >> 4) + mn[:, 1], 1, 126)
    st = np.where(pre <= 63, (63 - pre) << 1, ((pre - 64) << 1) | 1)
    return st.astype(np.uint8)


class CabacDecoder:
    """9.3.3.2 arithmetic decoding engine over an RBSP byte buffer."""

    def __init__(self, rbsp: bytes, bitpos: int, slice_qp: int,
                 table=CTX_INIT_I):
        # cabac_alignment_one_bit: slice_data starts byte-aligned
        while bitpos & 7:
            bitpos += 1
        self.d = rbsp
        self.pos = bitpos
        self.nbits = len(rbsp) * 8
        self.state = _init_states(slice_qp, table)
        self.range = 510
        self.offset = 0
        self.overrun = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()
        if self.offset >= 510:
            raise ValueError("invalid CABAC init offset")

    def _bit(self) -> int:
        if self.pos >= self.nbits:
            # reads past the RBSP are 0 by rule; a bounded overrun is
            # normal (renorm looks ahead), unbounded means corruption
            self.overrun += 1
            if self.overrun > 64:
                raise ValueError("CABAC read far past slice end")
            return 0
        b = (self.d[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def decision(self, ctx: int) -> int:
        s = self.state[ctx]
        p = s >> 1
        mps = s & 1
        lps = RANGE_LPS[4 * p + ((self.range >> 6) & 3)]
        self.range -= lps
        if self.offset >= self.range:
            binv = mps ^ 1
            self.offset -= self.range
            self.range = lps
            if p == 0:
                mps ^= 1
            self.state[ctx] = (TRANS_IDX_LPS[p] << 1) | mps
        else:
            binv = mps
            self.state[ctx] = (TRANS_IDX_MPS[p] << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return binv

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


class CabacEncoder:
    """9.3.4 arithmetic encoding engine producing RBSP bits."""

    def __init__(self, slice_qp: int, table=CTX_INIT_I):
        self.state = _init_states(slice_qp, table)
        self.low = 0
        self.range = 510
        self.first = True
        self.outstanding = 0
        self.bits: list[int] = []

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False      # 9.3.4.1: leading bit not written
        else:
            self.bits.append(b)
        while self.outstanding:
            self.bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    def decision(self, ctx: int, binv: int) -> None:
        s = self.state[ctx]
        p = s >> 1
        mps = s & 1
        lps = RANGE_LPS[4 * p + ((self.range >> 6) & 3)]
        self.range -= lps
        if binv != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                mps ^= 1
            self.state[ctx] = (TRANS_IDX_LPS[p] << 1) | mps
        else:
            self.state[ctx] = (TRANS_IDX_MPS[p] << 1) | mps
        self._renorm()

    def bypass(self, binv: int) -> None:
        self.low <<= 1
        if binv:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def terminate(self, binv: int) -> None:
        self.range -= 2
        if binv:
            self.low += self.range
            self.range = 2
            self._renorm()
            # EncodeFlush (9.3.4.6): the final written bit doubles as
            # rbsp_stop_one_bit
            self._put((self.low >> 9) & 1)
            self.bits.append((self.low >> 8) & 1)
            self.bits.append(1)
        else:
            self._renorm()


# ------------------------------------------------------------ syntax layer


class _NeighborState:
    """Per-slice context grids for neighbor-dependent ctxIdxInc (all
    derivations are slice-scoped: outside → mbAddrN unavailable, and for
    intra coding an unavailable coded_block_flag neighbor counts as 1)."""

    def __init__(self, width_mbs: int, height_mbs: int):
        self.w, self.h = width_mbs, height_mbs
        self.mb_seen = np.zeros(width_mbs * height_mbs, dtype=bool)
        self.is_i4x4 = np.zeros(width_mbs * height_mbs, dtype=bool)
        self.chroma_mode = np.zeros(width_mbs * height_mbs, dtype=np.int32)
        self.cbp_luma = np.zeros(width_mbs * height_mbs, dtype=np.int32)
        self.cbp_chroma = np.zeros(width_mbs * height_mbs, dtype=np.int32)
        self.dc_cbf = np.zeros(width_mbs * height_mbs, dtype=np.int8)
        # cbf grids start at -1 = "no block of THIS slice here": a top
        # neighbor inside another slice must read as unavailable (intra
        # default 1), not as an all-zero coded block — zero-init here
        # desynced every slice after the first against libavcodec
        self.luma_cbf = np.full((4 * height_mbs, 4 * width_mbs), -1,
                                dtype=np.int8)
        self.chroma_cbf = np.full((2, 2 * height_mbs, 2 * width_mbs), -1,
                                  dtype=np.int8)
        self.cdc_cbf = np.zeros((2, width_mbs * height_mbs),
                                dtype=np.int8)
        self.last_dqp_nz = False
        # -- P-slice caches --
        self.skip = np.zeros(width_mbs * height_mbs, dtype=bool)
        # per-8x8: 1 iff an inter partition with refIdx>0 covers it
        # (intra/skip/unavailable contribute 0 to the ref ctx, 9.3.3.1.1.6)
        self.refgt0 = np.zeros((2 * height_mbs, 2 * width_mbs),
                               dtype=np.int8)
        # per-4x4 |mvd| by component (intra/skip cells stay 0)
        self.absmvd = np.zeros((2, 4 * height_mbs, 4 * width_mbs),
                               dtype=np.int32)
        # per-MB transform_size_8x8_flag (ctx 399 neighbors)
        self.t8 = np.zeros(width_mbs * height_mbs, dtype=np.int8)

    def _mb_ok(self, mb: int, dx: int, dy: int) -> int:
        x, y = mb % self.w + dx, mb // self.w + dy
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return -1
        n = y * self.w + x
        return n if self.mb_seen[n] else -1

    def mb_type_inc(self, mb: int) -> int:
        inc = 0
        for dx, dy in ((-1, 0), (0, -1)):
            n = self._mb_ok(mb, dx, dy)
            if n >= 0 and not self.is_i4x4[n]:
                inc += 1
        return inc

    def chroma_pred_inc(self, mb: int) -> int:
        # 9.3.3.1.1.8: ctxIdxInc = condTermFlagA + condTermFlagB — BOTH
        # neighbors contribute 1 (unlike the A + 2B pattern of cbf/cbp).
        # The A+2B form here decoded our own streams fine (our encoder
        # only emits chroma mode 0) but silently truncated x264 slices
        # at the first MB with two nonzero-mode neighbors.
        inc = 0
        for dx, dy in ((-1, 0), (0, -1)):
            n = self._mb_ok(mb, dx, dy)
            if n >= 0 and self.chroma_mode[n] != 0:
                inc += 1
        return inc

    def cbp_luma_inc(self, mb: int, b8: int, cur_bits: int) -> int:
        """9.3.3.1.1.4: inc = a + 2*b, condTerm = (neighbor 8x8's CBP
        bit == 0); the left/top neighbor of an edge 8x8 lives in the
        adjacent MB, inner ones in the current (partially-built) CBP."""
        x8, y8 = b8 & 1, b8 >> 1
        a = b = 1        # unavailable neighbor → bit treated as CODED (0)
        if x8 == 1:
            a = 0 if (cur_bits >> (b8 - 1)) & 1 else 1
        else:
            n = self._mb_ok(mb, -1, 0)
            if n >= 0:
                a = 0 if (self.cbp_luma[n] >> (b8 + 1)) & 1 else 1
            else:
                a = 0
        if y8 == 1:
            b = 0 if (cur_bits >> (b8 - 2)) & 1 else 1
        else:
            n = self._mb_ok(mb, 0, -1)
            if n >= 0:
                b = 0 if (self.cbp_luma[n] >> (b8 + 2)) & 1 else 1
            else:
                b = 0
        return a + 2 * b

    def cbp_chroma_inc(self, mb: int, binidx: int) -> int:
        inc = 0
        for i, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            n = self._mb_ok(mb, dx, dy)
            if n < 0:
                continue
            v = self.cbp_chroma[n]
            cond = (v != 0) if binidx == 0 else (v == 2)
            if cond:
                inc += 1 if i == 0 else 2
        return inc

    def dqp_inc(self) -> int:
        return 1 if self.last_dqp_nz else 0

    def t8_inc(self, mb: int) -> int:
        """9.3.3.1.1.10: neighbors' transform_size_8x8_flag values."""
        inc = 0
        for dx, dy in ((-1, 0), (0, -1)):
            n = self._mb_ok(mb, dx, dy)
            if n >= 0 and self.t8[n]:
                inc += 1
        return inc

    def _cbf_at(self, grid, y: int, x: int, h: int, w: int,
                dflt: int) -> int:
        # outside the slice/picture: default 1 when the CURRENT MB is
        # intra, 0 when inter (9.3.3.1.1.9)
        if x < 0 or y < 0 or x >= w or y >= h:
            return dflt
        v = grid[y, x]
        return dflt if v < 0 else int(v)

    def luma_cbf_inc(self, gx: int, gy: int, intra: bool = True) -> int:
        h, w = self.luma_cbf.shape
        d = 1 if intra else 0
        return (self._cbf_at(self.luma_cbf, gy, gx - 1, h, w, d)
                + 2 * self._cbf_at(self.luma_cbf, gy - 1, gx, h, w, d))

    def chroma_cbf_inc(self, comp: int, gx: int, gy: int,
                       intra: bool = True) -> int:
        h, w = self.chroma_cbf.shape[1:]
        g = self.chroma_cbf[comp]
        d = 1 if intra else 0
        return (self._cbf_at(g, gy, gx - 1, h, w, d)
                + 2 * self._cbf_at(g, gy - 1, gx, h, w, d))

    # -- P-slice ctxIdxInc helpers ------------------------------------
    def skip_inc(self, mb: int) -> int:
        """9.3.3.1.1.1: condTermFlagN = mbN available and NOT skipped."""
        inc = 0
        for dx, dy in ((-1, 0), (0, -1)):
            n = self._mb_ok(mb, dx, dy)
            if n >= 0 and not self.skip[n]:
                inc += 1
        return inc

    def ref_inc(self, bx: int, by: int) -> int:
        """9.3.3.1.1.6 over the per-8x8 refIdx>0 cache."""
        h, w = self.refgt0.shape
        a = self.refgt0[by, bx - 1] if bx > 0 else 0
        b = self.refgt0[by - 1, bx] if by > 0 else 0
        return int(a) + 2 * int(b)

    def mvd_inc(self, comp: int, x4: int, y4: int) -> int:
        """9.3.3.1.1.7: bin0 ctx from |mvdA| + |mvdB| of the component."""
        h, w = self.absmvd.shape[1:]
        a = self.absmvd[comp, y4, x4 - 1] if x4 > 0 else 0
        b = self.absmvd[comp, y4 - 1, x4] if y4 > 0 else 0
        s = int(a) + int(b)
        return (1 if s > 2 else 0) + (1 if s > 32 else 0)

    def mark_skip(self, mb: int) -> None:
        """P_Skip: available neighbor with zero residual, refIdx 0 and
        no mvd; resets the dqp chain (7.4.5 prevMbSkipped)."""
        w = self.w
        mbx, mby = (mb % w) * 4, (mb // w) * 4
        self.mb_seen[mb] = True
        self.skip[mb] = True
        self.is_i4x4[mb] = False
        self.t8[mb] = 0
        self.chroma_mode[mb] = 0
        self.cbp_luma[mb] = 0
        self.cbp_chroma[mb] = 0
        self.dc_cbf[mb] = 0
        self.cdc_cbf[:, mb] = 0
        self.luma_cbf[mby:mby + 4, mbx:mbx + 4] = 0
        cx, cy = (mb % w) * 2, (mb // w) * 2
        self.chroma_cbf[:, cy:cy + 2, cx:cx + 2] = 0
        self.refgt0[cy:cy + 2, cx:cx + 2] = 0
        self.absmvd[:, mby:mby + 4, mbx:mbx + 4] = 0
        self.last_dqp_nz = False

    def dc_cbf_inc(self, mb: int) -> int:
        inc = 0
        for i, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            n = self._mb_ok(mb, dx, dy)
            v = 1 if n < 0 else int(self.dc_cbf[n])
            if v:
                inc += 1 if i == 0 else 2
        return inc


class CabacSliceCodec:
    """Parse ⇄ serialize CABAC I slices into the shared MB model."""

    def __init__(self, sps: Sps, pps: Pps):
        self.sps = sps
        self.pps = pps
        self.inner = SliceCodec(sps, pps)   # header round-trip reuse

    # ------------------------------------------------------------ parse
    def parse_slice(self, nal: bytes
                    ) -> tuple[SliceHeader, int, list, np.ndarray]:
        """→ (header, first_mb, mbs, per-mb qp).  Raises ValueError on
        anything outside the supported profile subset."""
        rbsp = nal_to_rbsp(nal[1:])
        br = BitReader(rbsp)
        hdr = self.inner.parse_slice_header(br, nal[0])
        is_p = hdr.is_p
        table = CTX_INIT_P[hdr.cabac_init_idc] if is_p else CTX_INIT_I
        dec = CabacDecoder(rbsp, br.pos, hdr.qp, table)
        w = self.sps.width_mbs
        n_mbs = w * self.sps.height_mbs
        n_ref = hdr.num_ref_l0(self.pps) if is_p else 1
        nb = _NeighborState(w, self.sps.height_mbs)
        mbs: list = []
        qps: list[int] = []
        cur_qp = hdr.qp
        mb = hdr.first_mb
        if mb >= n_mbs:
            raise ValueError("first_mb out of range")
        while True:
            if mb >= n_mbs:
                raise ValueError("slice overruns picture")
            if is_p and dec.decision(11 + nb.skip_inc(mb)):
                nb.mark_skip(mb)
                mbs.append(MacroblockPSkip())
                qps.append(cur_qp)
            else:
                cur_qp, parsed = self._parse_mb(dec, nb, mb, cur_qp,
                                                is_p, n_ref)
                mbs.append(parsed)
                qps.append(cur_qp)
            mb += 1
            if dec.terminate():
                break
        return hdr, hdr.first_mb, mbs, np.asarray(qps)

    def _parse_mb(self, dec: CabacDecoder, nb: _NeighborState, mb: int,
                  cur_qp: int, is_p: bool = False, n_ref: int = 1):
        if is_p:
            # Table 9-34 P prefix (layout mirrored from the libavcodec
            # decode we differential-test against): bin@14 == 0 → inter,
            # == 1 → intra mb_type rides ctx 17-20 with no neighbor inc
            if dec.decision(14) == 0:
                if dec.decision(15) == 0:
                    mb_type = 3 * dec.decision(16)       # 16x16 / 8x8
                else:
                    mb_type = 2 - dec.decision(17)       # 8x16 / 16x8
                return self._parse_inter(dec, nb, mb, cur_qp, mb_type,
                                         n_ref)
            if dec.decision(17) == 0:
                return self._parse_i4x4(dec, nb, mb, cur_qp)
            if dec.terminate():
                raise ValueError("I_PCM unsupported")
            return self._parse_i16(dec, nb, mb, cur_qp,
                                   (18, 19, 19, 20, 20))
        if dec.decision(3 + nb.mb_type_inc(mb)) == 0:
            return self._parse_i4x4(dec, nb, mb, cur_qp)
        if dec.terminate():
            raise ValueError("I_PCM unsupported")
        return self._parse_i16(dec, nb, mb, cur_qp, (6, 7, 8, 9, 10))

    def _parse_i16(self, dec: CabacDecoder, nb: _NeighborState, mb: int,
                   cur_qp: int, ctxs: tuple):
        """I_16x16 tail after the mb_type prefix bins; ``ctxs`` =
        (luma15, chroma!=0, chroma==2, pred hi, pred lo) ctxIdx — the
        two slice families share bin structure but not contexts."""
        w = self.sps.width_mbs
        mbx, mby = (mb % w) * 4, (mb // w) * 4
        luma15 = dec.decision(ctxs[0])
        chroma_cbp = 0
        if dec.decision(ctxs[1]):
            chroma_cbp = 2 if dec.decision(ctxs[2]) else 1
        pred = (dec.decision(ctxs[3]) << 1) | dec.decision(ctxs[4])

        nb.mb_seen[mb] = True
        nb.is_i4x4[mb] = False
        nb.t8[mb] = 0
        nb.cbp_luma[mb] = 15 if luma15 else 0
        nb.cbp_chroma[mb] = chroma_cbp

        chroma_mode = self._parse_chroma_mode(dec, nb, mb)
        delta = self._parse_dqp(dec, nb)
        cur_qp += delta
        if not 12 <= cur_qp <= 51:
            # <12: DC dequant uses a rounding form that breaks the exact
            # +6k shift argument — pass through (same rule as CAVLC)
            raise ValueError("QPY out of I_16x16 requant range")

        dc = np.zeros(16, dtype=np.int64)
        cbf = dec.decision(_CBF_BASE + 0 + nb.dc_cbf_inc(mb))
        nb.dc_cbf[mb] = cbf
        if cbf:
            self._residual(dec, 0, dc, 16)
        ac = np.zeros((16, 15), dtype=np.int64)
        for b in range(16):
            x4, y4 = BLK_XY[b]
            gx, gy = mbx + x4, mby + y4
            if luma15:
                cbf = dec.decision(_CBF_BASE + 4 + nb.luma_cbf_inc(gx, gy))
                nb.luma_cbf[gy, gx] = cbf
                if cbf:
                    self._residual(dec, 1, ac[b], 15)
            else:
                nb.luma_cbf[gy, gx] = 0
        cdc, cac = self._parse_chroma(dec, nb, mb, chroma_cbp)
        out = MacroblockI16x16(pred, chroma_mode, bool(luma15), cur_qp,
                               dc, ac, chroma_cbp, cdc, cac)
        return cur_qp, out

    def _parse_i4x4(self, dec: CabacDecoder, nb: _NeighborState, mb: int,
                    cur_qp: int):
        w = self.sps.width_mbs
        mbx, mby = (mb % w) * 4, (mb // w) * 4
        t8 = False
        if self.pps.transform_8x8_mode:
            t8 = bool(dec.decision(_T8_BASE + nb.t8_inc(mb)))
        nb.t8[mb] = 1 if t8 else 0
        modes = []
        for _ in range(4 if t8 else 16):
            if dec.decision(68):
                modes.append((1, 0))
            else:
                rem = (dec.decision(69) | (dec.decision(69) << 1)
                       | (dec.decision(69) << 2))
                modes.append((0, rem))
        nb.mb_seen[mb] = True
        nb.is_i4x4[mb] = True
        chroma_mode = self._parse_chroma_mode(dec, nb, mb)

        cbp = 0
        for b8 in range(4):
            if dec.decision(73 + nb.cbp_luma_inc(mb, b8, cbp)):
                cbp |= 1 << b8
        chroma_cbp = 0
        if dec.decision(77 + nb.cbp_chroma_inc(mb, 0)):
            chroma_cbp = 2 if dec.decision(81 + nb.cbp_chroma_inc(mb, 1)) \
                else 1
        nb.cbp_luma[mb] = cbp
        nb.cbp_chroma[mb] = chroma_cbp

        if cbp or chroma_cbp:
            delta = self._parse_dqp(dec, nb)
            cur_qp += delta
            if not 0 <= cur_qp <= 51:
                raise ValueError("qp out of range")
        else:
            nb.last_dqp_nz = False
        nb.dc_cbf[mb] = 0

        levels = np.zeros((16, 16), dtype=np.int64)
        levels8 = None
        if t8:
            # 8x8 luma residual (cat 5): no per-block cbf — the CBP bit
            # is the coded flag, and neighbor cbf cells inherit it
            levels8 = np.zeros((4, 64), dtype=np.int64)
            for b8 in range(4):
                x8, y8 = (b8 & 1) * 2, (b8 >> 1) * 2
                bit = (cbp >> b8) & 1
                if bit:
                    self._residual(dec, 5, levels8[b8], 64)
                nb.luma_cbf[mby + y8:mby + y8 + 2,
                            mbx + x8:mbx + x8 + 2] = bit
        else:
            for b in range(16):
                x4, y4 = BLK_XY[b]
                gx, gy = mbx + x4, mby + y4
                if (cbp >> (b >> 2)) & 1:
                    cbf = dec.decision(
                        _CBF_BASE + 8 + nb.luma_cbf_inc(gx, gy))
                    nb.luma_cbf[gy, gx] = cbf
                    if cbf:
                        self._residual(dec, 2, levels[b], 16)
                else:
                    nb.luma_cbf[gy, gx] = 0
        cdc, cac = self._parse_chroma(dec, nb, mb, chroma_cbp)
        out = MacroblockI4x4(modes, chroma_mode, cbp | (chroma_cbp << 4),
                             cur_qp, levels, cdc, cac,
                             transform_8x8=t8, levels8=levels8)
        return cur_qp, out

    # -------------------------------------------------- P inter parse
    def _parse_sub_type(self, dec: CabacDecoder) -> int:
        """P sub_mb_type binarization (Table 9-34, ctx 21-23)."""
        if dec.decision(21):
            return 0                     # P_L0_8x8
        if not dec.decision(22):
            return 1                     # P_L0_8x4
        return 2 if dec.decision(23) else 3

    def _write_sub_type(self, enc: CabacEncoder, st: int) -> None:
        enc.decision(21, 1 if st == 0 else 0)
        if st == 0:
            return
        enc.decision(22, 0 if st == 1 else 1)
        if st != 1:
            enc.decision(23, 1 if st == 2 else 0)

    def _parse_ref(self, dec: CabacDecoder, nb: _NeighborState,
                   bx: int, by: int) -> int:
        ctx = 54 + nb.ref_inc(bx, by)
        ref = 0
        while dec.decision(ctx):
            ref += 1
            if ref > 31:
                raise ValueError("ref_idx overflow")
            ctx = 58 if ref == 1 else 59
        return ref

    def _write_ref_cabac(self, enc: CabacEncoder, nb: _NeighborState,
                         bx: int, by: int, ref: int) -> None:
        ctx = 54 + nb.ref_inc(bx, by)
        for i in range(ref):
            enc.decision(ctx, 1)
            ctx = 58 if i == 0 else 59
        enc.decision(ctx, 0)

    def _parse_mvd(self, dec: CabacDecoder, base: int, inc: int) -> int:
        """UEG3 mvd binarization (9.3.2.3): TU prefix cMax 9 over ctx
        base+{inc,3,4,5,6,6,...}, EG3 bypass suffix, bypass sign."""
        if not dec.decision(base + inc):
            return 0
        mag = 1
        ctxofs = 3
        while mag < 9 and dec.decision(base + ctxofs):
            mag += 1
            if ctxofs < 6:
                ctxofs += 1
        if mag == 9:
            k = 3
            while dec.bypass():
                mag += 1 << k
                k += 1
                if k > 24:
                    raise ValueError("mvd escape overflow")
            while k:
                k -= 1
                mag += dec.bypass() << k
        return -mag if dec.bypass() else mag

    def _write_mvd(self, enc: CabacEncoder, base: int, inc: int,
                   v: int) -> None:
        mag = abs(int(v))
        if mag == 0:
            enc.decision(base + inc, 0)
            return
        enc.decision(base + inc, 1)
        ctxofs = 3
        n = 1
        while n < min(mag, 9):
            enc.decision(base + ctxofs, 1)
            if ctxofs < 6:
                ctxofs += 1
            n += 1
        if mag < 9:
            enc.decision(base + ctxofs, 0)
        else:
            rem = mag - 9
            k = 3
            while rem >= (1 << k):
                enc.bypass(1)
                rem -= 1 << k
                k += 1
            enc.bypass(0)
            for i in range(k - 1, -1, -1):
                enc.bypass((rem >> i) & 1)
        enc.bypass(1 if v < 0 else 0)

    def _mvd_pair_parse(self, dec, nb, x4: int, y4: int, w4: int,
                        h4: int) -> tuple:
        mx = self._parse_mvd(dec, 40, nb.mvd_inc(0, x4, y4))
        my = self._parse_mvd(dec, 47, nb.mvd_inc(1, x4, y4))
        nb.absmvd[0, y4:y4 + h4, x4:x4 + w4] = abs(mx)
        nb.absmvd[1, y4:y4 + h4, x4:x4 + w4] = abs(my)
        return mx, my

    def _mvd_pair_write(self, enc, nb, x4: int, y4: int, w4: int,
                        h4: int, pair) -> None:
        mx, my = pair
        self._write_mvd(enc, 40, nb.mvd_inc(0, x4, y4), mx)
        self._write_mvd(enc, 47, nb.mvd_inc(1, x4, y4), my)
        nb.absmvd[0, y4:y4 + h4, x4:x4 + w4] = abs(int(mx))
        nb.absmvd[1, y4:y4 + h4, x4:x4 + w4] = abs(int(my))

    def _mvd_geometry(self, mb_type: int, sub_types,
                      mbx: int, mby: int):
        """(x4, y4, w4, h4) per coded mvd, in bitstream order."""
        if mb_type == 3:
            out = []
            for i8, st in enumerate(sub_types):
                ox, oy = (i8 & 1) * 2, (i8 >> 1) * 2
                out.extend((mbx + ox + sx, mby + oy + sy, sw, sh)
                           for sx, sy, sw, sh in _P_SUB4[st])
            return out
        return [(mbx + px * 2, mby + py * 2, pw * 2, ph * 2)
                for px, py, pw, ph in _P_PARTS8[mb_type]]

    def _parse_inter(self, dec: CabacDecoder, nb: _NeighborState,
                     mb: int, cur_qp: int, mb_type: int, n_ref: int):
        w = self.sps.width_mbs
        mbx, mby = (mb % w) * 4, (mb // w) * 4
        bx, by = (mb % w) * 2, (mb // w) * 2
        nb.mb_seen[mb] = True
        nb.is_i4x4[mb] = False
        nb.chroma_mode[mb] = 0
        sub_types = None
        if mb_type == 3:
            sub_types = [self._parse_sub_type(dec) for _ in range(4)]
            parts8 = ((0, 0, 1, 1), (1, 0, 1, 1),
                      (0, 1, 1, 1), (1, 1, 1, 1))
        else:
            parts8 = _P_PARTS8[mb_type]
        refs = []
        for px, py, pw, ph in parts8:
            if n_ref == 1:
                r = 0                    # inferred, not coded
            else:
                r = self._parse_ref(dec, nb, bx + px, by + py)
                if r >= n_ref:
                    raise ValueError("ref_idx out of range")
            refs.append(r)
            nb.refgt0[by + py:by + py + ph,
                      bx + px:bx + px + pw] = 1 if r > 0 else 0
        mvds = [self._mvd_pair_parse(dec, nb, x4, y4, w4, h4)
                for x4, y4, w4, h4 in
                self._mvd_geometry(mb_type, sub_types, mbx, mby)]

        cbp = 0
        for b8 in range(4):
            if dec.decision(73 + nb.cbp_luma_inc(mb, b8, cbp)):
                cbp |= 1 << b8
        chroma_cbp = 0
        if dec.decision(77 + nb.cbp_chroma_inc(mb, 0)):
            chroma_cbp = 2 if dec.decision(
                81 + nb.cbp_chroma_inc(mb, 1)) else 1
        nb.cbp_luma[mb] = cbp
        nb.cbp_chroma[mb] = chroma_cbp
        t8 = False
        if (cbp and self.pps.transform_8x8_mode
                and (mb_type <= 2
                     or all(t == 0 for t in (sub_types or [])))):
            t8 = bool(dec.decision(_T8_BASE + nb.t8_inc(mb)))
        nb.t8[mb] = 1 if t8 else 0
        if cbp or chroma_cbp:
            cur_qp += self._parse_dqp(dec, nb)
            if not 0 <= cur_qp <= 51:
                raise ValueError("QPY out of range")
        else:
            nb.last_dqp_nz = False
        nb.dc_cbf[mb] = 0
        levels = np.zeros((16, 16), dtype=np.int64)
        levels8 = None
        if t8:
            levels8 = np.zeros((4, 64), dtype=np.int64)
            for b8 in range(4):
                x8, y8 = (b8 & 1) * 2, (b8 >> 1) * 2
                bit = (cbp >> b8) & 1
                if bit:
                    self._residual(dec, 5, levels8[b8], 64)
                nb.luma_cbf[mby + y8:mby + y8 + 2,
                            mbx + x8:mbx + x8 + 2] = bit
        else:
            for b in range(16):
                x4, y4 = BLK_XY[b]
                gx, gy = mbx + x4, mby + y4
                if (cbp >> (b >> 2)) & 1:
                    cbf = dec.decision(
                        _CBF_BASE + 8
                        + nb.luma_cbf_inc(gx, gy, intra=False))
                    nb.luma_cbf[gy, gx] = cbf
                    if cbf:
                        self._residual(dec, 2, levels[b], 16)
                else:
                    nb.luma_cbf[gy, gx] = 0
        cdc, cac = self._parse_chroma(dec, nb, mb, chroma_cbp,
                                      intra=False)
        out = MacroblockInter(mb_type, sub_types, refs, mvds,
                              cbp | (chroma_cbp << 4), cur_qp, levels,
                              cdc, cac, transform_8x8=t8,
                              levels8=levels8)
        return cur_qp, out

    def _parse_chroma_mode(self, dec, nb, mb) -> int:
        if not dec.decision(64 + nb.chroma_pred_inc(mb)):
            mode = 0
        elif not dec.decision(67):
            mode = 1
        else:
            mode = 2 if not dec.decision(67) else 3
        nb.chroma_mode[mb] = mode
        return mode

    def _parse_dqp(self, dec, nb) -> int:
        val = 0
        ctx = 60 + nb.dqp_inc()
        while dec.decision(ctx):
            val += 1
            if val > 104:                    # 2*52: corrupt stream
                raise ValueError("mb_qp_delta overflow")
            ctx = 62 if val == 1 else 63
        nb.last_dqp_nz = val != 0
        return (val + 1) // 2 if val & 1 else -(val // 2)

    def _parse_chroma(self, dec, nb, mb, chroma_cbp, intra: bool = True):
        w = self.sps.width_mbs
        cx, cy = (mb % w) * 2, (mb // w) * 2
        cdc = np.zeros((2, 4), dtype=np.int64)
        cac = np.zeros((2, 4, 15), dtype=np.int64)
        if chroma_cbp:
            for comp in range(2):
                cbf = dec.decision(
                    _CBF_BASE + 12 + self._cdc_inc(nb, comp, mb, intra))
                self._cdc_set(nb, comp, mb, cbf)
                if cbf:
                    self._residual(dec, 3, cdc[comp], 4)
        else:
            for comp in range(2):
                self._cdc_set(nb, comp, mb, 0)
        for comp in range(2):
            for b in range(4):
                gx, gy = cx + (b & 1), cy + (b >> 1)
                if chroma_cbp == 2:
                    cbf = dec.decision(
                        _CBF_BASE + 16
                        + nb.chroma_cbf_inc(comp, gx, gy, intra))
                    nb.chroma_cbf[comp, gy, gx] = cbf
                    if cbf:
                        self._residual(dec, 4, cac[comp, b], 15)
                else:
                    nb.chroma_cbf[comp, gy, gx] = 0
        return cdc, cac

    # chroma DC cbf neighbor state lives per component per MB
    def _cdc_inc(self, nb, comp, mb, intra: bool = True) -> int:
        inc = 0
        d = 1 if intra else 0
        for i, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            n = nb._mb_ok(mb, dx, dy)
            v = d if n < 0 else int(nb.cdc_cbf[comp, n])
            if v:
                inc += 1 if i == 0 else 2
        return inc

    def _cdc_set(self, nb, comp, mb, v) -> None:
        nb.cdc_cbf[comp, mb] = v

    def _residual(self, dec: CabacDecoder, cat: int, out, maxc: int
                  ) -> None:
        """residual_block_cabac (7.3.5.3.3) with cbf already consumed;
        ``out`` is a zigzag/scan-ordered level row.  cat 5 (luma 8x8)
        selects the Table 9-43 position-mapped sig/last contexts."""
        if cat == 5:
            sigpos = []
            i = 0
            while i < 63:
                if dec.decision(_SIG8 + SIG_MAP_8X8[i]):
                    sigpos.append(i)
                    if dec.decision(_LAST8 + LAST_MAP_8X8[i]):
                        break
                i += 1
            else:
                sigpos.append(63)
            abs_base = _ABS8
        else:
            sig_base = _SIG_BASE[cat]
            last_base = _LAST_BASE[cat]
            sigpos = []
            i = 0
            while i < maxc - 1:
                if dec.decision(sig_base + i):
                    sigpos.append(i)
                    if dec.decision(last_base + i):
                        break
                i += 1
            else:
                # no last flag fired: the final scan position is
                # implicitly significant (cbf guarantees >= 1 coeff)
                sigpos.append(maxc - 1)
            abs_base = _ABS_BASE[cat]
        n_eq1 = n_gt1 = 0
        for pos in reversed(sigpos):
            ctx0 = abs_base + (0 if n_gt1 else min(4, 1 + n_eq1))
            mag = 0
            if dec.decision(ctx0):
                mag = 1
                ctxn = abs_base + 5 + min(4, n_gt1)
                while mag < 14 and dec.decision(ctxn):
                    mag += 1
                if mag == 14:                # UEG0 bypass suffix
                    k = 0
                    while dec.bypass():
                        k += 1
                        if k > 31:
                            raise ValueError("level escape overflow")
                    add = 0
                    for _ in range(k):
                        add = (add << 1) | dec.bypass()
                    mag += (1 << k) - 1 + add
            level = mag + 1
            if dec.bypass():
                level = -level
            out[pos] = level
            if mag == 0:
                n_eq1 += 1
            else:
                n_gt1 += 1

    # ------------------------------------------------------------ write
    def write_slice(self, hdr: SliceHeader, first_mb: int, mbs: list,
                    qp_out_base: int) -> bytes:
        """Serialize MBs (their .qp already holds the OUTPUT absolute
        QP) into a complete NAL with the header's QP set to
        ``qp_out_base``."""
        bw = BitWriter()
        self.inner.write_slice_header(bw, hdr, qp_out_base)
        while bw.bit_length % 8:
            bw.write_bit(1)                  # cabac_alignment_one_bit
        is_p = hdr.is_p
        table = CTX_INIT_P[hdr.cabac_init_idc] if is_p else CTX_INIT_I
        enc = CabacEncoder(qp_out_base, table)
        w = self.sps.width_mbs
        n_ref = hdr.num_ref_l0(self.pps) if is_p else 1
        nb = _NeighborState(w, self.sps.height_mbs)
        prev_qp = qp_out_base
        for idx, m in enumerate(mbs):
            mb = first_mb + idx
            if is_p:
                skip = isinstance(m, MacroblockPSkip)
                enc.decision(11 + nb.skip_inc(mb), 1 if skip else 0)
                if skip:
                    nb.mark_skip(mb)
                    enc.terminate(1 if idx == len(mbs) - 1 else 0)
                    continue
            # the QP chain advances only at MBs that CODE a delta (an
            # all-zero I_4x4 MB communicates nothing; the next coded MB
            # must delta from the last coded QP, 7.4.5)
            prev_qp = self._write_mb(enc, nb, mb, m, prev_qp, is_p,
                                     n_ref)
            enc.terminate(1 if idx == len(mbs) - 1 else 0)
        for b in enc.bits:
            bw.write_bit(b)
        while bw.bit_length % 8:
            bw.write_bit(0)                  # rbsp_alignment_zero_bit
        nal_byte = (hdr.nal_ref_idc << 5) | hdr.nal_type
        return bytes([nal_byte]) + rbsp_to_nal(bw.to_bytes())

    def _write_mb(self, enc: CabacEncoder, nb: _NeighborState, mb: int,
                  m, prev_qp: int, is_p: bool = False,
                  n_ref: int = 1) -> int:
        w = self.sps.width_mbs
        mbx, mby = (mb % w) * 4, (mb // w) * 4
        cx, cy = (mb % w) * 2, (mb // w) * 2
        if isinstance(m, MacroblockInter):
            return self._write_inter(enc, nb, mb, m, prev_qp, n_ref)
        if isinstance(m, MacroblockI4x4):
            if is_p:
                enc.decision(14, 1)          # intra prefix in P
                enc.decision(17, 0)          # I_NxN
            else:
                enc.decision(3 + nb.mb_type_inc(mb), 0)
            nb.mb_seen[mb] = True
            nb.is_i4x4[mb] = True
            if self.pps.transform_8x8_mode:
                enc.decision(_T8_BASE + nb.t8_inc(mb),
                             1 if m.transform_8x8 else 0)
            nb.t8[mb] = 1 if m.transform_8x8 else 0
            for flag, rem in m.pred_modes:
                enc.decision(68, flag)
                if not flag:
                    enc.decision(69, rem & 1)
                    enc.decision(69, (rem >> 1) & 1)
                    enc.decision(69, (rem >> 2) & 1)
            self._write_chroma_mode(enc, nb, mb, m.chroma_mode)
            cbp = m.cbp & 15
            chroma_cbp = m.chroma_cbp
            built = 0
            for b8 in range(4):
                bit = (cbp >> b8) & 1
                enc.decision(73 + nb.cbp_luma_inc(mb, b8, built), bit)
                built |= bit << b8
            enc.decision(77 + nb.cbp_chroma_inc(mb, 0),
                         1 if chroma_cbp else 0)
            if chroma_cbp:
                enc.decision(81 + nb.cbp_chroma_inc(mb, 1),
                             1 if chroma_cbp == 2 else 0)
            nb.cbp_luma[mb] = cbp
            nb.cbp_chroma[mb] = chroma_cbp
            coded_qp = prev_qp
            if cbp or chroma_cbp:
                self._write_dqp(enc, nb, m.qp - prev_qp)
                coded_qp = m.qp
            else:
                nb.last_dqp_nz = False
            nb.dc_cbf[mb] = 0
            if m.transform_8x8:
                for b8 in range(4):
                    x8, y8 = (b8 & 1) * 2, (b8 >> 1) * 2
                    bit = (cbp >> b8) & 1
                    if bit:
                        self._write_residual(enc, 5, m.levels8[b8], 64)
                    nb.luma_cbf[mby + y8:mby + y8 + 2,
                                mbx + x8:mbx + x8 + 2] = bit
            else:
                for b in range(16):
                    x4, y4 = BLK_XY[b]
                    gx, gy = mbx + x4, mby + y4
                    if (cbp >> (b >> 2)) & 1:
                        row = m.levels[b]
                        cbf = 1 if np.any(row) else 0
                        enc.decision(
                            _CBF_BASE + 8 + nb.luma_cbf_inc(gx, gy), cbf)
                        nb.luma_cbf[gy, gx] = cbf
                        if cbf:
                            self._write_residual(enc, 2, row, 16)
                    else:
                        nb.luma_cbf[gy, gx] = 0
            self._write_chroma(enc, nb, mb, chroma_cbp, m.chroma_dc,
                               m.chroma_ac, cx, cy)
            return coded_qp
        # I_16x16
        if is_p:
            enc.decision(14, 1)              # intra prefix in P
            enc.decision(17, 1)              # not I_4x4
            ctxs = (18, 19, 19, 20, 20)
        else:
            enc.decision(3 + nb.mb_type_inc(mb), 1)
            ctxs = (6, 7, 8, 9, 10)
        nb.mb_seen[mb] = True
        nb.is_i4x4[mb] = False
        nb.t8[mb] = 0
        enc.terminate(0)
        enc.decision(ctxs[0], 1 if m.luma_cbp15 else 0)
        enc.decision(ctxs[1], 1 if m.chroma_cbp else 0)
        if m.chroma_cbp:
            enc.decision(ctxs[2], 1 if m.chroma_cbp == 2 else 0)
        enc.decision(ctxs[3], (m.pred_mode >> 1) & 1)
        enc.decision(ctxs[4], m.pred_mode & 1)
        nb.cbp_luma[mb] = 15 if m.luma_cbp15 else 0
        nb.cbp_chroma[mb] = m.chroma_cbp
        self._write_chroma_mode(enc, nb, mb, m.chroma_mode)
        self._write_dqp(enc, nb, m.qp - prev_qp)
        cbf = 1 if np.any(m.dc_levels) else 0
        enc.decision(_CBF_BASE + 0 + nb.dc_cbf_inc(mb), cbf)
        nb.dc_cbf[mb] = cbf
        if cbf:
            self._write_residual(enc, 0, m.dc_levels, 16)
        for b in range(16):
            x4, y4 = BLK_XY[b]
            gx, gy = mbx + x4, mby + y4
            if m.luma_cbp15:
                row = m.ac_levels[b]
                cbf = 1 if np.any(row) else 0
                enc.decision(_CBF_BASE + 4 + nb.luma_cbf_inc(gx, gy), cbf)
                nb.luma_cbf[gy, gx] = cbf
                if cbf:
                    self._write_residual(enc, 1, row, 15)
            else:
                nb.luma_cbf[gy, gx] = 0
        self._write_chroma(enc, nb, mb, m.chroma_cbp, m.chroma_dc,
                           m.chroma_ac, cx, cy)
        return m.qp                          # I_16x16 always codes dqp

    def _write_inter(self, enc: CabacEncoder, nb: _NeighborState,
                     mb: int, m: MacroblockInter, prev_qp: int,
                     n_ref: int) -> int:
        w = self.sps.width_mbs
        mbx, mby = (mb % w) * 4, (mb // w) * 4
        bx, by = (mb % w) * 2, (mb // w) * 2
        cx, cy = bx, by
        nb.mb_seen[mb] = True
        nb.is_i4x4[mb] = False
        nb.chroma_mode[mb] = 0
        if m.mb_type == 4:
            raise ValueError("P_8x8ref0 is CAVLC-only")
        enc.decision(14, 0)
        if m.mb_type in (0, 3):
            enc.decision(15, 0)
            enc.decision(16, 1 if m.mb_type == 3 else 0)
        else:
            enc.decision(15, 1)
            enc.decision(17, 1 if m.mb_type == 1 else 0)
        if m.mb_type == 3:
            for st in m.sub_types:
                self._write_sub_type(enc, st)
            parts8 = ((0, 0, 1, 1), (1, 0, 1, 1),
                      (0, 1, 1, 1), (1, 1, 1, 1))
        else:
            parts8 = _P_PARTS8[m.mb_type]
        for (px, py, pw, ph), r in zip(parts8, m.refs or
                                       [0] * len(parts8)):
            if n_ref > 1:
                self._write_ref_cabac(enc, nb, bx + px, by + py, r)
            nb.refgt0[by + py:by + py + ph,
                      bx + px:bx + px + pw] = 1 if r > 0 else 0
        for (x4, y4, w4, h4), pair in zip(
                self._mvd_geometry(m.mb_type, m.sub_types, mbx, mby),
                m.mvds):
            self._mvd_pair_write(enc, nb, x4, y4, w4, h4, pair)

        cbp = m.cbp & 15
        chroma_cbp = m.chroma_cbp
        built = 0
        for b8 in range(4):
            bit = (cbp >> b8) & 1
            enc.decision(73 + nb.cbp_luma_inc(mb, b8, built), bit)
            built |= bit << b8
        enc.decision(77 + nb.cbp_chroma_inc(mb, 0),
                     1 if chroma_cbp else 0)
        if chroma_cbp:
            enc.decision(81 + nb.cbp_chroma_inc(mb, 1),
                         1 if chroma_cbp == 2 else 0)
        nb.cbp_luma[mb] = cbp
        nb.cbp_chroma[mb] = chroma_cbp
        t8 = bool(m.transform_8x8) and cbp != 0
        if (cbp and self.pps.transform_8x8_mode and m.allows_8x8):
            enc.decision(_T8_BASE + nb.t8_inc(mb), 1 if t8 else 0)
        nb.t8[mb] = 1 if t8 else 0
        coded_qp = prev_qp
        if cbp or chroma_cbp:
            self._write_dqp(enc, nb, m.qp - prev_qp)
            coded_qp = m.qp
        else:
            nb.last_dqp_nz = False
        nb.dc_cbf[mb] = 0
        if t8:
            for b8 in range(4):
                x8, y8 = (b8 & 1) * 2, (b8 >> 1) * 2
                bit = (cbp >> b8) & 1
                if bit:
                    self._write_residual(enc, 5, m.levels8[b8], 64)
                nb.luma_cbf[mby + y8:mby + y8 + 2,
                            mbx + x8:mbx + x8 + 2] = bit
        else:
            for b in range(16):
                x4, y4 = BLK_XY[b]
                gx, gy = mbx + x4, mby + y4
                if (cbp >> (b >> 2)) & 1:
                    row = m.levels[b]
                    cbf = 1 if np.any(row) else 0
                    enc.decision(
                        _CBF_BASE + 8
                        + nb.luma_cbf_inc(gx, gy, intra=False), cbf)
                    nb.luma_cbf[gy, gx] = cbf
                    if cbf:
                        self._write_residual(enc, 2, row, 16)
                else:
                    nb.luma_cbf[gy, gx] = 0
        self._write_chroma(enc, nb, mb, chroma_cbp, m.chroma_dc,
                           m.chroma_ac, cx, cy, intra=False)
        return coded_qp

    def _write_chroma_mode(self, enc, nb, mb, mode) -> None:
        enc.decision(64 + nb.chroma_pred_inc(mb), 0 if mode == 0 else 1)
        if mode > 0:
            enc.decision(67, 0 if mode == 1 else 1)
            if mode > 1:
                enc.decision(67, 0 if mode == 2 else 1)
        nb.chroma_mode[mb] = mode

    def _write_dqp(self, enc, nb, delta: int) -> None:
        if not -26 <= delta <= 25:
            # 7.4.5 bound; requant can fold an uncoded MB's delta into
            # the next coded one — out of range must pass through, not
            # emit a nonconforming slice (caller catches ValueError)
            raise ValueError("mb_qp_delta out of range")
        val = 2 * delta - 1 if delta > 0 else -2 * delta
        ctx = 60 + nb.dqp_inc()
        for i in range(val):
            enc.decision(ctx, 1)
            ctx = 62 if i == 0 else 63
        enc.decision(ctx, 0)
        nb.last_dqp_nz = delta != 0

    def _write_chroma(self, enc, nb, mb, chroma_cbp, cdc, cac, cx, cy,
                      intra: bool = True) -> None:
        if chroma_cbp:
            for comp in range(2):
                cbf = 1 if np.any(cdc[comp]) else 0
                enc.decision(
                    _CBF_BASE + 12 + self._cdc_inc(nb, comp, mb, intra),
                    cbf)
                self._cdc_set(nb, comp, mb, cbf)
                if cbf:
                    self._write_residual(enc, 3, cdc[comp], 4)
        else:
            for comp in range(2):
                self._cdc_set(nb, comp, mb, 0)
        for comp in range(2):
            for b in range(4):
                gx, gy = cx + (b & 1), cy + (b >> 1)
                if chroma_cbp == 2:
                    row = cac[comp, b]
                    cbf = 1 if np.any(row) else 0
                    enc.decision(
                        _CBF_BASE + 16
                        + nb.chroma_cbf_inc(comp, gx, gy, intra),
                        cbf)
                    nb.chroma_cbf[comp, gy, gx] = cbf
                    if cbf:
                        self._write_residual(enc, 4, row, 15)
                else:
                    nb.chroma_cbf[comp, gy, gx] = 0

    def _write_residual(self, enc: CabacEncoder, cat: int, row, maxc: int
                        ) -> None:
        sigpos = [i for i in range(maxc) if row[i]]
        assert sigpos
        last = sigpos[-1]
        if cat == 5:
            for i in range(63):
                if i > last:
                    break
                sig = 1 if row[i] else 0
                enc.decision(_SIG8 + SIG_MAP_8X8[i], sig)
                if sig:
                    enc.decision(_LAST8 + LAST_MAP_8X8[i],
                                 1 if i == last else 0)
            abs_base = _ABS8
        else:
            sig_base = _SIG_BASE[cat]
            last_base = _LAST_BASE[cat]
            for i in range(maxc - 1):
                if i > last:
                    break
                sig = 1 if row[i] else 0
                enc.decision(sig_base + i, sig)
                if sig:
                    enc.decision(last_base + i, 1 if i == last else 0)
            abs_base = _ABS_BASE[cat]
        n_eq1 = n_gt1 = 0
        for pos in reversed(sigpos):
            level = int(row[pos])
            mag = abs(level) - 1
            ctx0 = abs_base + (0 if n_gt1 else min(4, 1 + n_eq1))
            if mag == 0:
                enc.decision(ctx0, 0)
            else:
                enc.decision(ctx0, 1)
                ctxn = abs_base + 5 + min(4, n_gt1)
                for _ in range(min(mag, 14) - 1):
                    enc.decision(ctxn, 1)
                if mag < 14:
                    enc.decision(ctxn, 0)
                else:                        # UEG0 bypass suffix:
                    # value v → k = floor(log2(v+1)): k one-bits, a
                    # zero, then k suffix bits of (v+1-2^k)
                    rem = mag - 14
                    k = (rem + 1).bit_length() - 1
                    for _ in range(k):
                        enc.bypass(1)
                    enc.bypass(0)
                    suffix = rem + 1 - (1 << k)
                    for i in range(k - 1, -1, -1):
                        enc.bypass((suffix >> i) & 1)
            enc.bypass(1 if level < 0 else 0)
            if mag == 0:
                n_eq1 += 1
            else:
                n_gt1 += 1
