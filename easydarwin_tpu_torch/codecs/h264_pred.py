"""Full H.264 intra prediction (spec 8.3): all nine 4x4 luma modes,
the four 16x16 luma modes, and the four 8x8 chroma modes, over
reconstructed sample planes.

This is the piece that turns the transform-domain requant rung into a
CLOSED-LOOP transcoder for intra slices: prediction runs from the
OUTPUT-side reconstruction, so requantization error stops compounding
across prediction chains.  The same functions drive the full-mode intra
DECODER used to obtain the target pixels, pixel-exact against
libavcodec on x264 streams (``tests/test_torch_closed_loop.py``).

Availability follows 6.4.9 with slice-scoped neighbors; the decode-order
rule for top-right samples uses the macroblock raster × 8.3.1
luma4x4BlkIdx order.  Scope: frame MBs, MB-row-aligned slices.  A copy
of the reference's ``codecs/h264_pred.py``; numpy only.
"""

from __future__ import annotations

import numpy as np

from .h264_intra import BLK_XY

#: (x4, y4) inside the MB → luma4x4BlkIdx (inverse of BLK_XY)
_BLK_ORDER = {xy: i for i, xy in enumerate(BLK_XY)}


def block_decode_order(gx: int, gy: int, w4: int) -> int:
    """Global decode-order index of the 4x4 block at (gx, gy)."""
    mb = (gy // 4) * (w4 // 4) + gx // 4
    return mb * 16 + _BLK_ORDER[(gx % 4, gy % 4)]


def _topright4(recon: np.ndarray, gx: int, gy: int, gy_min: int,
               w4: int) -> np.ndarray:
    """p[4..7, -1] for the 4x4 block at (gx, gy): real samples when the
    top-right block is available AND earlier in decode order, else the
    8.3.1.2 substitution p[3, -1] repeated."""
    top = recon[gy * 4 - 1, gx * 4:gx * 4 + 4]
    if (gx + 1 < w4 and gy > gy_min
            and block_decode_order(gx + 1, gy - 1, w4)
            < block_decode_order(gx, gy, w4)):
        return recon[gy * 4 - 1, gx * 4 + 4:gx * 4 + 8]
    return np.full(4, top[3], dtype=recon.dtype)


def pred4x4(mode: int, recon: np.ndarray, gx: int, gy: int,
            gy_min: int) -> np.ndarray:
    """[4,4] prediction for one luma 4x4 block (modes 0-8, 8.3.1.2).
    ``gy_min`` = the slice's first 4x4 row (above it: unavailable)."""
    w4 = recon.shape[1] // 4
    x0, y0 = gx * 4, gy * 4
    avail_l = gx > 0
    avail_t = gy > gy_min
    left = recon[y0:y0 + 4, x0 - 1].astype(np.int64) if avail_l else None
    top = recon[y0 - 1, x0:x0 + 4].astype(np.int64) if avail_t else None
    if mode == 2:                        # DC
        if avail_l and avail_t:
            v = (int(left.sum()) + int(top.sum()) + 4) >> 3
        elif avail_l:
            v = (int(left.sum()) + 2) >> 2
        elif avail_t:
            v = (int(top.sum()) + 2) >> 2
        else:
            v = 128
        return np.full((4, 4), v, dtype=np.int64)
    if mode == 0:                        # Vertical
        if not avail_t:
            raise ValueError("V prediction without top")
        return np.tile(top, (4, 1))
    if mode == 1:                        # Horizontal
        if not avail_l:
            raise ValueError("H prediction without left")
        return np.tile(left.reshape(4, 1), (1, 4))
    if mode == 3:                        # Diagonal-Down-Left
        if not avail_t:
            raise ValueError("DDL without top")
        tr = _topright4(recon, gx, gy, gy_min, w4).astype(np.int64)
        p = np.concatenate([top, tr])    # p[0..7, -1]
        out = np.empty((4, 4), dtype=np.int64)
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    out[y, x] = (p[6] + 3 * p[7] + 2) >> 2
                else:
                    i = x + y
                    out[y, x] = (p[i] + 2 * p[i + 1] + p[i + 2] + 2) >> 2
        return out
    # modes 4-8 need the corner sample p[-1,-1]
    if mode in (4, 5, 6) and not (avail_l and avail_t):
        raise ValueError("diagonal prediction without both neighbors")
    corner = int(recon[y0 - 1, x0 - 1]) if (avail_l and avail_t) else 0
    if mode == 4:                        # Diagonal-Down-Right
        out = np.empty((4, 4), dtype=np.int64)
        for y in range(4):
            for x in range(4):
                if x > y:
                    i = x - y
                    a = top[i - 2] if i >= 2 else corner
                    b = top[i - 1] if i >= 1 else corner
                    c = top[i]
                    out[y, x] = (a + 2 * b + c + 2) >> 2
                elif x < y:
                    i = y - x
                    a = left[i - 2] if i >= 2 else corner
                    b = left[i - 1] if i >= 1 else corner
                    c = left[i]
                    out[y, x] = (a + 2 * b + c + 2) >> 2
                else:
                    out[y, x] = (top[0] + 2 * corner + left[0] + 2) >> 2
        return out
    if mode == 5:                        # Vertical-Right (8.3.1.2.5)
        out = np.empty((4, 4), dtype=np.int64)
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    out[y, x] = ((top[i - 1] if i >= 1 else corner)
                                 + top[i] + 1) >> 1
                elif z >= 0:
                    out[y, x] = ((top[i - 2] if i >= 2 else corner)
                                 + 2 * (top[i - 1] if i >= 1 else corner)
                                 + top[i] + 2) >> 2
                elif z == -1:
                    out[y, x] = (left[0] + 2 * corner + top[0] + 2) >> 2
                else:                    # zVR ≤ −2: left column upward
                    j = y - 2 * x - 1
                    out[y, x] = (left[j]
                                 + 2 * (left[j - 1] if j >= 1 else corner)
                                 + (left[j - 2] if j >= 2 else corner)
                                 + 2) >> 2
        return out
    if mode == 6:                        # Horizontal-Down
        out = np.empty((4, 4), dtype=np.int64)
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    out[y, x] = ((left[i - 1] if i >= 1 else corner)
                                 + left[i] + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    out[y, x] = ((left[i - 2] if i >= 2 else corner)
                                 + 2 * (left[i - 1] if i >= 1 else corner)
                                 + left[i] + 2) >> 2
                elif z == -1:
                    out[y, x] = (top[0] + 2 * corner + left[0] + 2) >> 2
                else:                    # zHD ≤ −2: top row leftward
                    j = x - 2 * y - 1
                    out[y, x] = (top[j]
                                 + 2 * (top[j - 1] if j >= 1 else corner)
                                 + (top[j - 2] if j >= 2 else corner)
                                 + 2) >> 2
        return out
    if mode == 7:                        # Vertical-Left
        if not avail_t:
            raise ValueError("VL without top")
        tr = _topright4(recon, gx, gy, gy_min, w4).astype(np.int64)
        p = np.concatenate([top, tr])
        out = np.empty((4, 4), dtype=np.int64)
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    out[y, x] = (p[i] + p[i + 1] + 1) >> 1
                else:
                    out[y, x] = (p[i] + 2 * p[i + 1] + p[i + 2] + 2) >> 2
        return out
    if mode == 8:                        # Horizontal-Up
        if not avail_l:
            raise ValueError("HU without left")
        out = np.empty((4, 4), dtype=np.int64)
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z < 5 and z % 2 == 0:
                    i = y + (x >> 1)
                    out[y, x] = (left[i] + left[i + 1] + 1) >> 1
                elif z < 5:
                    i = y + (x >> 1)
                    out[y, x] = (left[i] + 2 * left[i + 1]
                                 + left[i + 2] + 2) >> 2
                elif z == 5:
                    out[y, x] = (left[2] + 3 * left[3] + 2) >> 2
                else:
                    out[y, x] = left[3]
        return out
    raise ValueError(f"intra4x4 mode {mode} out of range")


def pred16x16(mode: int, recon: np.ndarray, mbx: int, mby: int,
              mby_min: int) -> np.ndarray:
    """[16,16] I_16x16 prediction (8.3.3): 0 V, 1 H, 2 DC, 3 Plane."""
    x0, y0 = mbx * 16, mby * 16
    avail_l = mbx > 0
    avail_t = mby > mby_min
    left = (recon[y0:y0 + 16, x0 - 1].astype(np.int64)
            if avail_l else None)
    top = (recon[y0 - 1, x0:x0 + 16].astype(np.int64)
           if avail_t else None)
    if mode == 0:
        if not avail_t:
            raise ValueError("I16 V without top")
        return np.tile(top, (16, 1))
    if mode == 1:
        if not avail_l:
            raise ValueError("I16 H without left")
        return np.tile(left.reshape(16, 1), (1, 16))
    if mode == 2:
        if avail_l and avail_t:
            v = (int(left.sum()) + int(top.sum()) + 16) >> 5
        elif avail_l:
            v = (int(left.sum()) + 8) >> 4
        elif avail_t:
            v = (int(top.sum()) + 8) >> 4
        else:
            v = 128
        return np.full((16, 16), v, dtype=np.int64)
    if mode == 3:                        # Plane (8.3.3.4)
        if not (avail_l and avail_t):
            raise ValueError("I16 plane without both neighbors")
        corner = int(recon[y0 - 1, x0 - 1])
        hsrc = np.concatenate([[corner], top]).astype(np.int64)
        vsrc = np.concatenate([[corner], left]).astype(np.int64)
        hsum = sum((x + 1) * (int(hsrc[9 + x]) - int(hsrc[7 - x]))
                   for x in range(8))
        vsum = sum((y + 1) * (int(vsrc[9 + y]) - int(vsrc[7 - y]))
                   for y in range(8))
        b = (5 * hsum + 32) >> 6
        c = (5 * vsum + 32) >> 6
        a = 16 * (int(left[15]) + int(top[15]))
        yy, xx = np.mgrid[0:16, 0:16]
        return np.clip((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5,
                       0, 255).astype(np.int64)
    raise ValueError(f"intra16x16 mode {mode} out of range")


def pred_chroma(mode: int, recon: np.ndarray, mbx: int, mby: int,
                mby_min: int) -> np.ndarray:
    """[8,8] chroma prediction (8.3.4): 0 DC, 1 H, 2 V, 3 Plane."""
    x0, y0 = mbx * 8, mby * 8
    avail_l = mbx > 0
    avail_t = mby > mby_min
    if mode == 0:                        # DC, per 4x4 sub-block rules
        from .h264_intra import _chroma_dc_pred_mb
        return _chroma_dc_pred_mb(recon, mbx, mby, mby_min)
    left = recon[y0:y0 + 8, x0 - 1].astype(np.int64) if avail_l else None
    top = recon[y0 - 1, x0:x0 + 8].astype(np.int64) if avail_t else None
    if mode == 1:
        if not avail_l:
            raise ValueError("chroma H without left")
        return np.tile(left.reshape(8, 1), (1, 8))
    if mode == 2:
        if not avail_t:
            raise ValueError("chroma V without top")
        return np.tile(top, (8, 1))
    if mode == 3:                        # Plane (8.3.4.4)
        if not (avail_l and avail_t):
            raise ValueError("chroma plane without both neighbors")
        corner = int(recon[y0 - 1, x0 - 1])
        hsrc = np.concatenate([[corner], top]).astype(np.int64)
        vsrc = np.concatenate([[corner], left]).astype(np.int64)
        hsum = sum((x + 1) * (int(hsrc[5 + x]) - int(hsrc[3 - x]))
                   for x in range(4))
        vsum = sum((y + 1) * (int(vsrc[5 + y]) - int(vsrc[3 - y]))
                   for y in range(4))
        b = (17 * hsum + 16) >> 5
        c = (17 * vsum + 16) >> 5
        a = 16 * (int(left[7]) + int(top[7]))
        yy, xx = np.mgrid[0:8, 0:8]
        return np.clip((a + b * (xx - 3) + c * (yy - 3) + 16) >> 5,
                       0, 255).astype(np.int64)
    raise ValueError(f"chroma mode {mode} out of range")


def derive_i4x4_modes(mb_modes, blk_modes: np.ndarray, mb_idx: int,
                      w_mbs: int, first_mb: int) -> list[int]:
    """Resolve one I_4x4 MB's coded (prev_flag, rem) pairs into actual
    modes (8.3.1.1 most-probable-mode), updating ``blk_modes`` — the
    per-4x4 global mode grid (−1 = unavailable/not-intra-4x4; I_16x16
    and inter MBs read as DC=2 via the availability rule)."""
    mbx, mby = (mb_idx % w_mbs) * 4, (mb_idx // w_mbs) * 4
    first_row4 = (first_mb // w_mbs) * 4
    out = []
    for b in range(16):
        x4, y4 = BLK_XY[b]
        gx, gy = mbx + x4, mby + y4
        ma = blk_modes[gy, gx - 1] if gx > 0 else -1
        mb_ = blk_modes[gy - 1, gx] if gy > first_row4 else -1
        if ma < 0 or mb_ < 0:
            pred = 2                     # dcPredModePredictedFlag
        else:
            pred = min(int(ma), int(mb_))
        flag, rem = mb_modes[b]
        mode = pred if flag else (rem if rem < pred else rem + 1)
        blk_modes[gy, gx] = mode
        out.append(mode)
    return out
