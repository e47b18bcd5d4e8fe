"""H.264 4×4 integer transform + QP quantization (host reference).

A copy of the reference's ``codecs/h264_transform.py``, numpy only.  The
spec's core transform (8.5.12) and the JM-convention forward quantizer
are all integer, so the device requant (``ops.transform.h264_requant``
and ``h264_requant_chroma``, torch int32 ops) is BIT-EXACT against
``requant_levels_scalar`` and ``requant_chroma_scalar``.

Position classes for the 4×4 MF/V multipliers:
  A = {(0,0),(0,2),(2,0),(2,2)}, B = {(1,1),(1,3),(3,1),(3,3)}, C = rest.
"""

from __future__ import annotations

import numpy as np

#: forward quant multipliers MF[qp % 6][class] (class order A, B, C)
MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559]], dtype=np.int64)

#: dequant multipliers V[qp % 6][class]
V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23]], dtype=np.int64)

#: position → class index (row-major 4×4)
_CLS = np.array([
    0, 2, 0, 2,
    2, 1, 2, 1,
    0, 2, 0, 2,
    2, 1, 2, 1], dtype=np.int64)

#: 4×4 zigzag scan (raster index per scan position)
ZIGZAG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                   dtype=np.int64)

_CF = np.array([[1, 1, 1, 1],
                [2, 1, -1, -2],
                [1, -1, -1, 1],
                [1, -2, 2, -1]], dtype=np.int64)

#: max |level| the requant paths accept — keeps the int32 device math
#: overflow-free (|l|·V·MF ≤ 2047·29·13107 < 2^31)
LEVEL_CLIP = 2047

#: Table 8-15: QPc as a function of qPI (identity below 30, then the
#: compressing tail).  This non-linearity is WHY chroma needs a general
#: requant: a luma +6k step maps to a chroma delta that is usually not
#: a multiple of 6, so the exact-shift argument does not apply.
CHROMA_QP = np.array(
    list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                       37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    dtype=np.int64)

#: clips shared with the device chroma path so int64 (numpy) and int32
#: (torch) stay bit-exact: residuals after the
#: inverse transform clip to ±RES_CLIP (⇒ |W| ≤ 36·4095), forward
#: coefficients to ±W_CLIP (131071·13107 + 2·2^23 < 2^31).  Real
#: residuals are within ±255, so the clips never bind on real streams.
RES_CLIP = 4095
W_CLIP = 131071

_H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    """QPc for a macroblock: Table 8-15 over clip3(0, 51, QPY + offset)."""
    return int(CHROMA_QP[int(np.clip(qp_y + offset, 0, 51))])


def mf_position(qp: int) -> np.ndarray:
    """[16] per-position forward multiplier for ``qp``."""
    return MF[qp % 6][_CLS]


def v_position(qp: int) -> np.ndarray:
    """[16] per-position dequant multiplier for ``qp``."""
    return V[qp % 6][_CLS]


def forward_transform_quant(residual: np.ndarray, qp: int) -> np.ndarray:
    """[4,4] int residual → [16] quantized levels (raster order).

    W = Cf·X·Cfᵀ; level = sign(W)·((|W|·MF + f) >> (15 + qp//6)) with the
    intra rounding offset f = 2^(15+qp//6)/3 (JM convention)."""
    x = residual.astype(np.int64)
    w = _CF @ x @ _CF.T
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf = mf_position(qp).reshape(4, 4)
    lev = np.sign(w) * ((np.abs(w) * mf + f) >> qbits)
    return np.clip(lev.reshape(16), -LEVEL_CLIP, LEVEL_CLIP)


def inverse_core(w: np.ndarray) -> np.ndarray:
    """[4,4] dequantized coefficients → [4,4] residual (8.5.12's inverse
    core transform with the final +32 >> 6)."""
    def ih(row):
        a, b, c, d = row
        e0 = a + c
        e1 = a - c
        e2 = (b >> 1) - d
        e3 = b + (d >> 1)
        return np.array([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dtype=np.int64)

    tmp = np.stack([ih(w[i]) for i in range(4)])
    cols = np.stack([ih(tmp[:, j]) for j in range(4)], axis=1)
    return ((cols + 32) >> 6).astype(np.int64)


def dequant_inverse(levels: np.ndarray, qp: int) -> np.ndarray:
    """[16] levels (raster) → [4,4] int residual (spec 8.5.12 rounding)."""
    lev = levels.astype(np.int64).reshape(4, 4)
    w = lev * v_position(qp).reshape(4, 4)
    w = w << (qp // 6)
    return inverse_core(w)


def requant_levels_scalar(levels: np.ndarray, qp_in: int, qp_out: int
                          ) -> np.ndarray:
    """Transform-domain requant, THE scalar oracle: [..., 16] levels at
    ``qp_in`` → levels at ``qp_out = qp_in + 6k``.

    Qstep doubles every 6 QP with identical ``qp % 6`` multiplier rows,
    so a +6k requant is EXACTLY a rounded k-bit right shift of each
    level — no transform-normalization terms enter at all (MF and V bake
    in different forward/inverse scalings, so a V·MF product form is
    wrong; this form is exact by the table periodicity).  The intra
    deadzone bias 2^k/3 mirrors the forward quantizer's f offset:
      l' = sign(l)·((|l| + 2^k/3) >> k).
    """
    k = (qp_out - qp_in) // 6
    if qp_out - qp_in != 6 * k or k <= 0:
        raise ValueError("requant ladder steps must be +6 QP multiples")
    lev = np.clip(np.asarray(levels, dtype=np.int64),
                  -LEVEL_CLIP, LEVEL_CLIP)
    f = (1 << k) // 3
    out = np.sign(lev) * ((np.abs(lev) + f) >> k)
    return out.astype(np.int64)


# ------------------------------------------------------------------- chroma

def chroma_dc_dequant(dc_levels: np.ndarray, qpc: int) -> np.ndarray:
    """[4] parsed 2×2 chroma DC levels (raster) → [4] dcC per 8.5.11:
    dcC = ((H2·c·H2) · LevelScale(QPc%6,0,0)) << (QPc/6) >> 5 — the spec's
    LevelScale carries a ×16, so in this module's V convention the net
    shift is >> 1 (exact for every QPc, both forms being 2-adic)."""
    c = np.clip(dc_levels.astype(np.int64), -LEVEL_CLIP,
                LEVEL_CLIP).reshape(2, 2)
    f = _H2 @ c @ _H2
    return (((f * V[qpc % 6][0]) << (qpc // 6)) >> 1).reshape(4)


def chroma_dc_quant(w00: np.ndarray, qpc: int) -> np.ndarray:
    """[4] forward-transform DC coefficients (raster 2×2 of the MB
    component's blocks) → [4] quantized chroma DC levels (JM forward:
    2×2 Hadamard, then MF with doubled deadzone and qbits+1 shift)."""
    f2 = _H2 @ np.clip(w00.astype(np.int64), -W_CLIP,
                       W_CLIP).reshape(2, 2) @ _H2
    f2 = np.clip(f2, -W_CLIP, W_CLIP)
    qbits = 15 + qpc // 6
    off = (1 << qbits) // 3
    lev = np.sign(f2) * ((np.abs(f2) * MF[qpc % 6][0] + 2 * off)
                         >> (qbits + 1))
    return np.clip(lev, -LEVEL_CLIP, LEVEL_CLIP).reshape(4)


def requant_chroma_scalar(dc: np.ndarray, ac: np.ndarray, qpc_in: int,
                          qpc_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Chroma requant for ONE macroblock component, the scalar oracle for
    ``ops.transform.h264_requant_chroma`` (bit-exact, same clips).

    dc: [4] chroma DC levels (2×2 raster); ac: [4, 15] per-block zigzag
    AC tails.  Three-way per-MB dispatch on delta = qpc_out − qpc_in:

    * 0 — identity (Table 8-15 saturation; the levels still decode right
      because QPc is unchanged).
    * +6k — the same exact level shift as luma (the DC chain also scales
      by exactly 2 per +6: same %6 row, one more left shift).
    * otherwise — open-loop integer round trip, each block reconstructed
      exactly as a decoder would (8.5.11 DC + 8.5.12 AC dequant, inverse
      core transform) and re-encoded with the JM forward quantizer at
      qpc_out.  Valid for ANY delta, which chroma needs (module note on
      CHROMA_QP)."""
    dc = np.clip(np.asarray(dc, dtype=np.int64), -LEVEL_CLIP, LEVEL_CLIP)
    ac = np.clip(np.asarray(ac, dtype=np.int64), -LEVEL_CLIP, LEVEL_CLIP)
    delta = qpc_out - qpc_in
    if delta < 0:
        raise ValueError("chroma requant only steps down (qpc_out >= in)")
    if delta == 0:
        return dc.copy(), ac.copy()
    if delta % 6 == 0:
        k = delta // 6
        f = (1 << k) // 3
        sh = lambda x: np.sign(x) * ((np.abs(x) + f) >> k)  # noqa: E731
        return sh(dc), sh(ac)
    dcc = chroma_dc_dequant(dc, qpc_in)
    vq = v_position(qpc_in)
    mfq = mf_position(qpc_out)
    qbits = 15 + qpc_out // 6
    off = (1 << qbits) // 3
    out_ac = np.empty_like(ac)
    w00 = np.empty(4, dtype=np.int64)
    for b in range(4):
        lev = np.zeros(16, dtype=np.int64)
        lev[ZIGZAG4[1:]] = ac[b]
        w = (lev * vq) << (qpc_in // 6)
        w[0] = dcc[b]
        x = np.clip(inverse_core(w.reshape(4, 4)), -RES_CLIP, RES_CLIP)
        big_w = np.clip(_CF @ x @ _CF.T, -W_CLIP, W_CLIP).reshape(16)
        w00[b] = big_w[0]
        q = np.sign(big_w) * ((np.abs(big_w) * mfq + off) >> qbits)
        out_ac[b] = np.clip(q, -LEVEL_CLIP, LEVEL_CLIP)[ZIGZAG4[1:]]
    return chroma_dc_quant(w00, qpc_out), out_ac
