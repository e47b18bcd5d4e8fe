"""Transform-domain ops for the transcode ladder (BASELINE config 5).

The 8×8 DCT/IDCT is ONE batched ``[N, 64] @ [64, 64]`` product through the
Kronecker identity ``vec(Cᵀ·X·C) = (Cᵀ ⊗ Cᵀ)·vec(X)``; quantization follows
the JPEG convention (base table × quality scale).  Entropy coding stays on
the host (``protocol.jpeg_entropy``); the device owns the dense
transform/quant math.

``requantize`` and the pipeline's ladder step are B7: on a CUDA tensor
``requant_rungs`` (``ops.transform_kernel``) launches the hand-written
``ed_requant_rungs``; on a CPU tensor it runs ``requant_rungs_plain``.

``decode_blocks`` (dequant → IDCT → +128 → round → clip → uint8) is kernel
K2: on a CUDA tensor it launches the hand-written ``ed_decode_blocks``
(``ops.transform_kernel``), which applies the IDCT in its separable form
``Cᵀ·Y·C`` with the 8×8 ``operator("idct8")``; on a CPU tensor it runs
``decode_blocks_plain``, the same function in plain PyTorch through the
64×64 Kronecker operator, as the reference does.

``h264_requant`` and ``h264_requant_chroma`` are B6, the H.264 4×4
transform-domain requant: plain torch int32 ops on the tensors' device,
bit-exact with the scalar oracles of ``codecs.h264_transform`` (no hand
kernel: no path the port serves runs them yet).

Every product in the DCT ops is fp32.  ``torch.round`` rounds half to even, as
``jnp.round`` does.  The downscale ``[N, 256] @ [256, 64]`` is a plain
``torch.matmul`` (the JAX package left it to XLA at
``precision="highest"``); the port never enables TF32, so it runs in full
fp32 on the card too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ----------------------------------------------------------------- DCT bases


def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix C: y = C @ x."""
    C = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        a = np.sqrt(1 / 8) if k == 0 else np.sqrt(2 / 8)
        for n in range(8):
            C[k, n] = a * np.cos(np.pi * (2 * n + 1) * k / 16)
    return C


@functools.lru_cache(maxsize=None)
def _kron_mats() -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) 64×64 operators on row-major vec'd blocks.

    forward: vec(C X Cᵀ) = (C ⊗ C) vec(X)   (2-D DCT of spatial block X)
    inverse: vec(Cᵀ Y C) = (Cᵀ ⊗ Cᵀ) vec(Y)
    """
    C = dct_matrix()
    fwd = np.kron(C, C)
    inv = np.kron(C.T, C.T)
    return (fwd.astype(np.float32), inv.astype(np.float32))


@functools.lru_cache(maxsize=None)
def operator(name: str, device: torch.device) -> torch.Tensor:
    """A fixed fp32 operator as a tensor on ``device``, made once per
    device: ``"fwd"``/``"inv"`` (64×64), ``"down2x"`` (256×64) or
    ``"idct8"``, the 8×8 DCT matrix C that K2 applies as ``Cᵀ·Y·C``."""
    arr = {"fwd": lambda: _kron_mats()[0], "inv": lambda: _kron_mats()[1],
           "down2x": downscale2x_operator,
           "idct8": lambda: dct_matrix().astype(np.float32)}[name]()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def dct_blocks(x: torch.Tensor) -> torch.Tensor:
    """[N, 64] spatial → [N, 64] coefficients (row-major 8×8 blocks)."""
    return x @ operator("fwd", x.device).T


def idct_blocks(y: torch.Tensor) -> torch.Tensor:
    """[N, 64] coefficients → [N, 64] spatial."""
    return y @ operator("inv", y.device).T


# -------------------------------------------------------------- quantization

#: JPEG Annex K luminance base table, row-major.
JPEG_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.float32)


def quality_table(quality: int) -> np.ndarray:
    """JPEG quality (1-100) → effective quant table [64]."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    qt = np.floor((JPEG_LUMA_QT * scale + 50) / 100)
    return np.clip(qt, 1, 255).astype(np.float32)


def quantize(coef: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """[N,64] float coefficients → int32 levels (round half to even)."""
    return torch.round(coef / qtable[None, :]).to(torch.int32)


def dequantize(levels: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    return levels.to(torch.float32) * qtable[None, :]


# ------------------------------------------------------------------- zigzag

@functools.lru_cache(maxsize=None)
def zigzag_order() -> np.ndarray:
    """[64] indices mapping raster order → zigzag scan order."""
    # odd diagonals run down-left (i ascending), even ones up-right
    order = sorted(((i + j, i if (i + j) % 2 else j, i, j)
                    for i in range(8) for j in range(8)))
    return np.array([i * 8 + j for (_, _, i, j) in order], dtype=np.int32)


def to_zigzag(levels: torch.Tensor) -> torch.Tensor:
    idx = torch.from_numpy(zigzag_order().astype(np.int64))
    return levels[:, idx.to(levels.device)]


def from_zigzag(z: torch.Tensor) -> torch.Tensor:
    idx = torch.from_numpy(np.argsort(zigzag_order()).astype(np.int64))
    return z[:, idx.to(z.device)]


def to_zigzag_np(natural: np.ndarray) -> np.ndarray:
    """Host-side ``to_zigzag`` ([..., 64] natural → zigzag) — the entropy
    codec and ladder reorder on the host, off the device round-trip."""
    return natural[..., zigzag_order()]


def from_zigzag_np(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    out[..., zigzag_order()] = z
    return out


# ----------------------------------------------------- encode / decode paths

def encode_blocks(pixels: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """uint8 [N,64] spatial blocks → int32 quantized coefficient levels."""
    x = pixels.to(torch.float32) - 128.0
    return quantize(dct_blocks(x), qtable)


def decode_blocks_plain(levels: torch.Tensor,
                        qtable: torch.Tensor) -> torch.Tensor:
    """K2 in plain PyTorch: int32 [N,64] levels · f32 qtable ([64] or
    [1,64]) → uint8 [N,64] spatial blocks (dequant+IDCT+shift+clip)."""
    x = idct_blocks(dequantize(levels, qtable.reshape(64))) + 128.0
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def decode_blocks(levels: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """int32 levels → uint8 [N,64] spatial blocks.  A CUDA tensor launches
    ``ed_decode_blocks``; a CPU tensor runs ``decode_blocks_plain``."""
    from .transform_kernel import decode_blocks_kernel  # imports this module
    return decode_blocks_kernel(levels, qtable)


def requant_rungs_plain(levels: torch.Tensor, qt_in: torch.Tensor,
                        qt_rungs: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """B7 in plain PyTorch: int32 ``[N, 64]`` levels dequantized once with
    ``qt_in`` (64 entries) and requantized with each row of ``qt_rungs``
    ``[R, 64]`` → ``rungs [R, N, 64]`` int32 and ``nonzeros [R]`` int32 (the
    rate proxy).  IEEE fp32 multiply and divide, round half to even."""
    coef = dequantize(levels, qt_in.reshape(64))          # shared intermediate
    rungs = torch.round(coef[None] / qt_rungs[:, None, :]).to(torch.int32)
    return rungs, (rungs != 0).sum(dim=(1, 2), dtype=torch.int32)


def requantize(levels: torch.Tensor, qtable_in: torch.Tensor,
               qtable_out: torch.Tensor) -> torch.Tensor:
    """Transform-domain bitrate step-down: dequant with the source table,
    requant with a coarser one (no IDCT round-trip).  The one-rung case of
    ``requant_rungs``: a CUDA tensor launches ``ed_requant_rungs``."""
    from .transform_kernel import requant_rungs  # imports this module
    return requant_rungs(levels, qtable_in, qtable_out.reshape(1, 64))[0][0]


def transcode_ladder(levels: torch.Tensor, qtable_in: torch.Tensor,
                     qualities: tuple[int, ...]) -> list[torch.Tensor]:
    """One decode-side coefficient block set → N ladder rungs."""
    dev = levels.device
    return [requantize(levels, qtable_in,
                       torch.from_numpy(quality_table(q)).to(dev))
            for q in qualities]


# ------------------------------------------------- DCT-domain 2x downscale

@functools.lru_cache(maxsize=None)
def downscale2x_operator() -> np.ndarray:
    """[256, 64] linear map: a 2×2 quad of dequantized 8×8 DCT blocks →
    the 8×8 DCT block of the half-resolution tile (DCT ∘ avgpool2 ∘ IDCT
    over the 16×16 tile the quad reconstructs).  Quad layout is row-major:
    [top-left, top-right, bottom-left, bottom-right], each block vec'd
    row-major (natural order, not zigzag)."""
    _, inv = _kron_mats()                      # [64, 64] coeff → spatial
    eye = np.eye(256, dtype=np.float64)
    quads = eye.reshape(256, 2, 2, 8, 8)       # [in, qy, qx, 8, 8]
    blocks = quads.reshape(256, 4, 64) @ inv.astype(np.float64).T
    blocks = blocks.reshape(256, 2, 2, 8, 8)
    tile = np.zeros((256, 16, 16))
    for qy in range(2):
        for qx in range(2):
            tile[:, qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8] = \
                blocks[:, qy, qx]
    pooled = tile.reshape(256, 8, 2, 8, 2).mean(axis=(2, 4))
    fwd, _ = _kron_mats()
    out = pooled.reshape(256, 64) @ fwd.astype(np.float64).T
    return out.astype(np.float32)              # [256, 64]


def downscale2x_blocks(quads: torch.Tensor) -> torch.Tensor:
    """[N, 256] dequantized coefficient quads → [N, 64] half-res
    coefficients (natural order)."""
    return torch.matmul(quads, operator("down2x", quads.device))


def requantize_downscale2x(quads: torch.Tensor, qtable_in: torch.Tensor,
                           qtable_out: torch.Tensor) -> torch.Tensor:
    """Quantized quad levels [N, 4, 64] (or [N, 256]) → quantized
    half-res levels [N, 64]: dequant (input table broadcast over the 4
    blocks), one [N, 256] @ [256, 64] fp32 product, requant."""
    deq = quads.reshape(-1, 4, 64).to(torch.float32) * qtable_in[None, None, :]
    out = downscale2x_blocks(deq.reshape(-1, 256))
    return torch.round(out / qtable_out[None, :]).to(torch.int32)


# ------------------------------------------------- H.264 4x4 requant (int32)
@functools.lru_cache(maxsize=None)
def _h264_tables(device: torch.device) -> dict[str, torch.Tensor]:
    """B6's tables on ``device``, made once per device, all int32 (an
    int64 operand would promote the whole expression) but the AC scan
    index: ``vpos``/``mfpos`` [6, 16] per-position V and MF of each
    ``qp % 6``, ``v0``/``mf0`` [6] their class-A column, ``ac_idx`` the
    raster positions of zigzag scan positions 1-15."""
    from ..codecs.h264_transform import MF, V, ZIGZAG4, _CLS

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return {"vpos": i32(V[:, _CLS]), "mfpos": i32(MF[:, _CLS]),
            "v0": i32(V[:, 0]), "mf0": i32(MF[:, 0]),
            "ac_idx": torch.from_numpy(ZIGZAG4[1:].copy()).to(device)}


def _qp(qp, like: torch.Tensor) -> torch.Tensor:
    """A QP vector (or scalar) as int32 on ``like``'s device."""
    return torch.as_tensor(qp, device=like.device).to(torch.int32)


def _floordiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """``1 << k`` elementwise, int32."""
    return torch.bitwise_left_shift(torch.ones_like(k), k)


def _shift_round(x: torch.Tensor, k: torch.Tensor,
                 f: torch.Tensor) -> torch.Tensor:
    """``sign(x)·((|x| + f) >> k)``: the exact +6k requant of a level."""
    return torch.sign(x) * ((x.abs() + f) >> k)


def h264_requant(levels: torch.Tensor, qp_in, qp_out) -> torch.Tensor:
    """H.264 4×4 transform-domain requant, bit-exact with
    ``codecs.h264_transform.requant_levels_scalar``: a +6k QP step is a
    rounded k-bit right shift of each level,
    ``l' = sign(l)·((|l| + 2^k/3) >> k)``, ``k = (qp_out − qp_in) // 6``.

    ``levels`` int [N, 16] (any scan order: the op is elementwise),
    ``qp_in`` [N] per-block source QP, ``qp_out`` [N] or a scalar with
    ``qp_out ≡ qp_in (mod 6)`` → int32 [N, 16] on ``levels``' device.
    Levels clip to ±``LEVEL_CLIP`` first, the shared overflow contract."""
    from ..codecs.h264_transform import LEVEL_CLIP
    lev = levels.to(torch.int32).clamp(-LEVEL_CLIP, LEVEL_CLIP)
    k = _floordiv(_qp(qp_out, lev) - _qp(qp_in, lev), 6)[:, None]
    return _shift_round(lev, k, _floordiv(_pow2(k), 3))


def _h2x2(v: torch.Tensor) -> torch.Tensor:
    """Elementwise 2×2 Hadamard (H2·c·H2) of [..., 4] raster quads."""
    a, b, c, d = v.unbind(-1)
    return torch.stack([a + b + c + d, a - b + c - d,
                        a + b - c - d, a - b - c + d], dim=-1)


def _inv_core_1d(a, b, c, d):
    e0, e1 = a + c, a - c
    e2, e3 = (b >> 1) - d, b + (d >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def _fwd_core_1d(x0, x1, x2, x3):
    t0, t1, t2, t3 = x0 + x3, x1 + x2, x1 - x2, x0 - x3
    return t0 + t1, 2 * t3 + t2, t0 - t1, t3 - 2 * t2


def _rows_cols(w: torch.Tensor, fn) -> torch.Tensor:
    """A 4-point butterfly over the rows, then the columns, of
    [..., 4, 4]."""
    r = torch.stack(fn(*w.unbind(-1)), dim=-1)
    return torch.stack(fn(*r.unbind(-2)), dim=-2)


def h264_requant_chroma(dc: torch.Tensor, ac: torch.Tensor, qpc_in,
                        qpc_out) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched chroma requant, bit-exact with
    ``codecs.h264_transform.requant_chroma_scalar`` (same clips, int32
    throughout: the scalar module's clips keep every product inside it).

    ``dc`` int [N, 4] chroma DC levels (2×2 raster) a macroblock
    component, ``ac`` int [N, 4, 15] each block's zigzag AC tail,
    ``qpc_in``/``qpc_out`` [N] → ``(dc', ac')`` int32.  Each row takes one
    of three arms by ``delta = qpc_out − qpc_in``, all computed dense and
    selected with ``torch.where``, with no branch: identity (0), the
    exact shift (a multiple of 6), or dequant (8.5.11 DC + 8.5.12 AC) →
    inverse core → forward core → requant at ``qpc_out``.  A negative
    multiple of 6 takes the shift arm at k = 0, the identity."""
    from ..codecs.h264_transform import LEVEL_CLIP, RES_CLIP, W_CLIP
    t = _h264_tables(dc.device)
    n = dc.shape[0]
    dc = dc.to(torch.int32).clamp(-LEVEL_CLIP, LEVEL_CLIP)
    ac = ac.to(torch.int32).clamp(-LEVEL_CLIP, LEVEL_CLIP)
    qi, qo = _qp(qpc_in, dc).expand(n), _qp(qpc_out, dc).expand(n)
    delta = qo - qi

    # the exact-shift arm
    k = _floordiv(delta, 6).clamp(min=0)
    f6 = _floordiv(_pow2(k), 3)
    dc_shift = _shift_round(dc, k[:, None], f6[:, None])
    ac_shift = _shift_round(ac, k[:, None, None], f6[:, None, None])

    # the general arm: dequant → inverse core → forward core → requant
    si, so = _floordiv(qi, 6), _floordiv(qo, 6)
    mi, mo = torch.remainder(qi, 6).long(), torch.remainder(qo, 6).long()
    dcc = ((_h2x2(dc) * t["v0"][mi][:, None]) << si[:, None]) >> 1
    lev = torch.zeros((n, 4, 16), dtype=torch.int32, device=dc.device)
    lev[:, :, t["ac_idx"]] = ac
    w = (lev * t["vpos"][mi][:, None, :]) << si[:, None, None]
    w[:, :, 0] = dcc
    x = _rows_cols(w.reshape(n, 4, 4, 4), _inv_core_1d)
    x = ((x + 32) >> 6).clamp(-RES_CLIP, RES_CLIP)
    big = _rows_cols(x, _fwd_core_1d).clamp(-W_CLIP, W_CLIP).reshape(n, 4, 16)
    qbits = 15 + so
    off = _floordiv(_pow2(qbits), 3)
    q = _shift_round(big * t["mfpos"][mo][:, None, :], qbits[:, None, None],
                     off[:, None, None])
    ac_gen = q.clamp(-LEVEL_CLIP, LEVEL_CLIP)[:, :, t["ac_idx"]]
    f2 = _h2x2(big[:, :, 0]).clamp(-W_CLIP, W_CLIP)
    dc_gen = _shift_round(f2 * t["mf0"][mo][:, None], (qbits + 1)[:, None],
                          2 * off[:, None]).clamp(-LEVEL_CLIP, LEVEL_CLIP)

    same = (delta == 0)[:, None]
    shift = (torch.remainder(delta, 6) == 0)[:, None]
    dc_out = torch.where(same, dc, torch.where(shift, dc_shift, dc_gen))
    ac_out = torch.where(same[:, :, None], ac,
                         torch.where(shift[:, :, None], ac_shift, ac_gen))
    return dc_out, ac_out
