"""Closed-loop intra requantization: reconstruct while requantizing so
spatial drift stops compounding.

Open-loop transform-domain requant shifts each block's levels and lets
every downstream intra prediction read slightly-wrong neighbors; the
error cascades across the picture.  The closed loop instead walks MBs
in decode order keeping TWO reconstructions — the original stream's
(the target) and the output stream's — and for every block re-derives
the residual against prediction from the OUTPUT reconstruction before
quantizing at the new QP:

    target  = dec(orig levels, qp_in)  + pred(recon_orig)
    levels' = Q(target − pred(recon_out), qp_out)
    recon_out ← pred(recon_out) + dec(levels', qp_out)

Full 8.3 intra prediction (``h264_pred``) covers every mode a real
encoder emits; the MB model is the shared one, so CAVLC and CABAC
slices both close the loop.  Scope: I slices (IDR pictures), 4:2:0,
4x4 transform, MB-row-aligned multi-slice; P slices stay open-loop
(their prediction is temporal: closing it would need full motion
compensation).  The loop is host numpy: it reconstructs pixels, which
B6's level requant never sees.

Verification (``tests/test_torch_closed_loop.py``): the decoder half is
pixel-exact against libavcodec and the reference on x264 streams, and
the loop's output bytes equal the reference's.  A copy of the
reference's ``codecs/h264_closed_loop.py``; numpy only.
"""

from __future__ import annotations

import numpy as np

from .h264_intra import BLK_XY, MacroblockI4x4
from .h264_pred import derive_i4x4_modes, pred4x4, pred16x16, pred_chroma
from .h264_transform import (LEVEL_CLIP, MF, V, ZIGZAG4, _CF,
                             chroma_dc_dequant, chroma_dc_quant, chroma_qp,
                             dequant_inverse, forward_transform_quant,
                             inverse_core, mf_position, v_position)

_INV_ZZ = np.argsort(ZIGZAG4)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                [1, -1, -1, 1], [1, -1, 1, -1]], dtype=np.int64)


def luma_dc_dequant(dc_zz: np.ndarray, qp: int) -> np.ndarray:
    """[16] zigzag I_16x16 DC levels → [4,4] dcY (8.5.10; exact shift
    form, valid for QPY ≥ 12 — the requant rung's documented window)."""
    if qp < 12:
        raise ValueError("I_16x16 DC dequant window is QPY >= 12")
    c = np.clip(dc_zz.astype(np.int64), -LEVEL_CLIP,
                LEVEL_CLIP)[_INV_ZZ].reshape(4, 4)
    f = _H4 @ c @ _H4
    return (f * int(V[qp % 6][0])) << (qp // 6 - 2)


def luma_dc_quant(w00: np.ndarray, qp: int) -> np.ndarray:
    """[4,4] per-block DC coefficients → [16] zigzag quantized DC
    levels (JM forward: 4x4 Hadamard with /2, MF with doubled deadzone
    and qbits+1 — the exact inverse pairing of ``luma_dc_dequant``)."""
    f = (_H4 @ w00.astype(np.int64) @ _H4) >> 1
    qbits = 15 + qp // 6
    off = (1 << qbits) // 3
    lev = np.sign(f) * ((np.abs(f) * int(MF[qp % 6][0]) + 2 * off)
                        >> (qbits + 1))
    return np.clip(lev.reshape(16), -LEVEL_CLIP, LEVEL_CLIP)[ZIGZAG4]


class PictureRecon:
    """One picture's reconstruction planes (Y, Cb, Cr)."""

    def __init__(self, width_mbs: int, height_mbs: int):
        h, w = height_mbs * 16, width_mbs * 16
        self.y = np.zeros((h, w), dtype=np.int64)
        self.c = np.zeros((2, h // 2, w // 2), dtype=np.int64)
        # per-4x4 actual intra mode (−1 = not intra-4x4): feeds 8.3.1.1
        self.blk_modes = np.full((height_mbs * 4, width_mbs * 4), -1,
                                 dtype=np.int32)


def _recon_i16_luma(recon: np.ndarray, pred: np.ndarray, mb: int,
                    w_mbs: int, dc_zz: np.ndarray, ac: np.ndarray,
                    qp: int) -> None:
    """I_16x16 luma reconstruction at ``qp`` (8.5.10 DC chain + AC)."""
    mbx, mby = (mb % w_mbs) * 16, (mb // w_mbs) * 16
    dcy = luma_dc_dequant(dc_zz, qp)
    vq = v_position(qp)
    for b in range(16):
        x4, y4 = BLK_XY[b]
        w = np.zeros(16, dtype=np.int64)
        w[ZIGZAG4[1:]] = np.clip(ac[b], -LEVEL_CLIP, LEVEL_CLIP)
        w *= vq
        w <<= qp // 6
        w[0] = dcy[y4, x4]
        res = inverse_core(w.reshape(4, 4))
        ys, xs = mby + y4 * 4, mbx + x4 * 4
        recon[ys:ys + 4, xs:xs + 4] = np.clip(
            pred[y4 * 4:y4 * 4 + 4, x4 * 4:x4 * 4 + 4] + res, 0, 255)


def _recon_chroma(recon_c: np.ndarray, pred: np.ndarray, mb: int,
                  w_mbs: int, comp: int, cdc: np.ndarray,
                  cac: np.ndarray, qpc: int) -> None:
    mbx, mby = (mb % w_mbs) * 8, (mb // w_mbs) * 8
    dcc = chroma_dc_dequant(cdc, qpc)
    vq = v_position(qpc)
    for b in range(4):
        bx, by = b & 1, b >> 1
        w = np.zeros(16, dtype=np.int64)
        w[ZIGZAG4[1:]] = np.clip(cac[b], -LEVEL_CLIP, LEVEL_CLIP)
        w = (w * vq) << (qpc // 6)
        w[0] = dcc[b]
        res = inverse_core(w.reshape(4, 4))
        recon_c[comp, mby + by * 4:mby + by * 4 + 4,
                mbx + bx * 4:mbx + bx * 4 + 4] = np.clip(
            pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res, 0, 255)


def decode_mb(pic: PictureRecon, sps, pps, mb_idx: int, mb,
              first_mb: int) -> None:
    """Reconstruct one parsed intra MB into ``pic`` (any pred mode)."""
    w_mbs = sps.width_mbs
    mbx, mby = mb_idx % w_mbs, mb_idx // w_mbs
    first_row = first_mb // w_mbs
    qpc = chroma_qp(mb.qp, pps.chroma_qp_offset)
    if getattr(mb, "transform_8x8", False):
        raise ValueError("closed loop covers 4x4-transform intra only")
    if isinstance(mb, MacroblockI4x4):
        modes = derive_i4x4_modes(mb.pred_modes, pic.blk_modes, mb_idx,
                                  w_mbs, first_mb)
        for b in range(16):
            x4, y4 = BLK_XY[b]
            gx, gy = mbx * 4 + x4, mby * 4 + y4
            pred = pred4x4(modes[b], pic.y, gx, gy, first_row * 4)
            res = dequant_inverse(mb.levels[b][_INV_ZZ], mb.qp)
            pic.y[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = np.clip(
                pred + res, 0, 255)
    else:
        # 8.3.1.1: an AVAILABLE intra MB that is not I_4x4 contributes
        # mode 2 (DC) to Min(A, B) — only truly unavailable neighbors
        # force the DC-predicted flag
        pic.blk_modes[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        pred = pred16x16(mb.pred_mode, pic.y, mbx, mby, first_row)
        _recon_i16_luma(pic.y, pred, mb_idx, w_mbs, mb.dc_levels,
                        mb.ac_levels, mb.qp)
    for comp in range(2):
        predc = pred_chroma(mb.chroma_mode, pic.c[comp], mbx, mby,
                            first_row)
        _recon_chroma(pic.c, predc, mb_idx, w_mbs, comp,
                      mb.chroma_dc[comp], mb.chroma_ac[comp], qpc)


def requant_mb_closed(orig: PictureRecon, out: PictureRecon, sps, pps,
                      mb_idx: int, mb, first_mb: int,
                      delta_qp: int) -> None:
    """Closed-loop requant of one intra MB: decode into ``orig`` at the
    source QP, then re-derive residuals against ``out``'s
    reconstruction and quantize at QP+delta, updating ``mb``'s levels
    and ``out`` in place.  CBP/luma15 recompute stays with the caller
    (shared with the open-loop writers)."""
    w_mbs = sps.width_mbs
    mbx, mby = mb_idx % w_mbs, mb_idx // w_mbs
    first_row = first_mb // w_mbs
    qp_out = mb.qp + delta_qp
    decode_mb(orig, sps, pps, mb_idx, mb, first_mb)   # target pixels
    qpc_out = chroma_qp(qp_out, pps.chroma_qp_offset)
    if isinstance(mb, MacroblockI4x4):
        modes = derive_i4x4_modes(mb.pred_modes, out.blk_modes, mb_idx,
                                  w_mbs, first_mb)
        for b in range(16):
            x4, y4 = BLK_XY[b]
            gx, gy = mbx * 4 + x4, mby * 4 + y4
            target = orig.y[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4]
            pred = pred4x4(modes[b], out.y, gx, gy, first_row * 4)
            lev_raster = forward_transform_quant(
                target.astype(np.int64) - pred, qp_out)
            mb.levels[b] = lev_raster[ZIGZAG4]
            res = dequant_inverse(lev_raster, qp_out)
            out.y[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = np.clip(
                pred + res, 0, 255)
    else:
        out.blk_modes[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        pred = pred16x16(mb.pred_mode, out.y, mbx, mby, first_row)
        target = orig.y[mby * 16:mby * 16 + 16, mbx * 16:mbx * 16 + 16]
        res = target.astype(np.int64) - pred
        w00 = np.empty((4, 4), dtype=np.int64)
        mf = mf_position(qp_out)
        qbits = 15 + qp_out // 6
        f_off = (1 << qbits) // 3
        for b in range(16):
            x4, y4 = BLK_XY[b]
            blk = res[y4 * 4:y4 * 4 + 4, x4 * 4:x4 * 4 + 4]
            w = _CF @ blk @ _CF.T
            w00[y4, x4] = w[0, 0]
            lev = np.sign(w) * ((np.abs(w) * mf.reshape(4, 4) + f_off)
                                >> qbits)
            lev = np.clip(lev.reshape(16), -LEVEL_CLIP, LEVEL_CLIP)
            mb.ac_levels[b] = lev[ZIGZAG4[1:]]
        mb.dc_levels = luma_dc_quant(w00, qp_out)
        _recon_i16_luma(out.y, pred, mb_idx, w_mbs, mb.dc_levels,
                        mb.ac_levels, qp_out)
    for comp in range(2):
        target = orig.c[comp, mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8]
        predc = pred_chroma(mb.chroma_mode, out.c[comp], mbx, mby,
                            first_row)
        res = target.astype(np.int64) - predc
        w00 = np.empty(4, dtype=np.int64)
        ac = np.zeros((4, 15), dtype=np.int64)
        for b in range(4):
            bx, by = b & 1, b >> 1
            blk = res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            w00[b] = (_CF @ blk @ _CF.T)[0, 0]
            ac[b] = forward_transform_quant(blk, qpc_out)[ZIGZAG4[1:]]
        mb.chroma_dc[comp] = chroma_dc_quant(w00, qpc_out)
        mb.chroma_ac[comp] = ac
        _recon_chroma(out.c, predc, mb_idx, w_mbs, comp,
                      mb.chroma_dc[comp], mb.chroma_ac[comp], qpc_out)


def decode_intra_picture(sps, pps, parsed_slices
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-mode intra decoder over parsed (hdr, mbs) slices → uint8
    (Y, Cb, Cr).  The libavcodec-verified half of the closed loop."""
    pic = PictureRecon(sps.width_mbs, sps.height_mbs)
    for hdr, mbs in parsed_slices:
        if hdr.first_mb % sps.width_mbs:
            raise ValueError("closed-loop scope is MB-row-aligned slices")
        for i, mb in enumerate(mbs, start=hdr.first_mb):
            decode_mb(pic, sps, pps, i, mb, hdr.first_mb)
    return (pic.y.astype(np.uint8), pic.c[0].astype(np.uint8),
            pic.c[1].astype(np.uint8))
