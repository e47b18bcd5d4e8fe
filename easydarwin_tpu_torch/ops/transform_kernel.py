"""K2 and B7 on the card: ``ed_decode_blocks`` and ``ed_requant_rungs``.

The counterpart of the reference's Pallas kernel
(``easydarwin_tpu/ops/transform.py:decode_blocks_pallas``), written by
hand in CUDA C++ (``csrc/transform_kernels.cu``).  Same contract as
``ops.transform.decode_blocks_plain``: ``levels [N, 64]`` int32 ·
``qtable`` f32 with 64 entries → ``[N, 64]`` uint8 =
``clip(round(Cᵀ·(levels∘qt)·C + 128), 0, 255)`` per 8×8 block.  The
kernel's operator argument is ``C``, the 8×8 DCT matrix
(``operator("idct8")``): one thread per block does a row pass and a column
pass in fp32 ``fmaf``.  The plain version computes the same map as the
reference does, one product with the 64×64 Kronecker operator ``inv``; the
two sum in another order, so they may differ by 1 on a few pixels in a
hundred thousand, inside the reference's tolerance (≤ 1 on < 1%).

The Pallas version pads N to its 256-block tile; the CUDA kernel reads
through a TMA tensor map whose out-of-bounds rows fill with zeros and are
never stored, so nothing is padded here.

B7, the ladder's requant (``requant_rungs``), replaces the reference's
``_ladder_step`` without pixels and its ``requantize``: ``[N, 64]`` int32
levels, ``qt_in`` and ``qt_rungs [R, 64]`` → ``rungs [R, N, 64]`` int32
and ``nonzeros [R]``, bit-exact with ``requant_rungs_plain`` (the kernel
rounds each product and quotient as it does, and never multiplies by a
reciprocal).

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import kernel_lib
from .transform import decode_blocks_plain, operator, requant_rungs_plain

#: ``ed_requant_rungs``'s limits (``kRq*`` in ``csrc/transform_kernels.cu``;
#: chip_smoke.py checks them against ``ed_requant_geometry``): 1 to 8 rungs,
#: at most 2^24 blocks (their 2^30 levels keep every count in int32), and
#: the most CTAs of the persistent grid (one wave), which size the fold's
#: scratch
REQUANT_MAX_RUNGS = 8
REQUANT_MAX_BLOCKS = 1 << 24
REQUANT_MAX_CTAS = 2048
REQUANT_SCRATCH_WORDS = 1 + REQUANT_MAX_CTAS * REQUANT_MAX_RUNGS


def check_decode_args(levels: torch.Tensor, qtable: torch.Tensor) -> None:
    """What the kernel (and so both versions) takes: int32 ``[N, 64]``
    levels and an f32 table of 64 entries (``[64]`` or ``[1, 64]``) on the
    same device."""
    if levels.dtype != torch.int32:
        raise TypeError(f"levels must be torch.int32, got {levels.dtype}")
    if levels.dim() != 2 or levels.shape[1] != 64:
        raise ValueError(f"levels must be [N, 64], got {tuple(levels.shape)}")
    if qtable.dtype != torch.float32:
        raise TypeError(f"qtable must be torch.float32, got {qtable.dtype}")
    if tuple(qtable.shape) not in ((64,), (1, 64)):
        raise ValueError(f"qtable must be [64] or [1, 64], got "
                         f"{tuple(qtable.shape)}")
    if qtable.device != levels.device:
        raise ValueError(f"qtable is on {qtable.device}, levels on "
                         f"{levels.device}")


def decode_blocks_kernel(levels: torch.Tensor,
                         qtable: torch.Tensor) -> torch.Tensor:
    """Fused dequant → IDCT → +128 → round → clip → uint8 of ``[N, 64]``
    int32 levels."""
    check_decode_args(levels, qtable)
    if levels.device.type == "cpu":
        return decode_blocks_plain(levels, qtable)
    if levels.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {levels.device}")
    dev = levels.device
    kernel_lib.require(levels, "levels", torch.int32, 2, dev)
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (TMA reads them)")
    qt = qtable.reshape(64)
    if not qt.is_contiguous():
        raise ValueError("qtable must be contiguous")
    n = levels.shape[0]
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    if n:
        idct8 = operator("idct8", dev)
        kernel_lib.launch("ed_decode_blocks", levels.data_ptr(), n,
                          qt.data_ptr(), idct8.data_ptr(), out.data_ptr())
    return out


def ring_geometry() -> dict:
    """The kernel's tile and ring on the current card: ``tile_blocks``
    (blocks per tile = consumer threads), ``stages`` and ``ctas`` (the
    most CTAs a launch uses).  Needs the card."""
    return dict(zip(("tile_blocks", "stages", "ctas"),
                    kernel_lib.geometry("ed_decode_blocks_geometry", 3)))


def check_requant_args(levels: torch.Tensor, qt_in: torch.Tensor,
                       qt_rungs: torch.Tensor) -> None:
    """What ``ed_requant_rungs`` takes, on either device: int32 ``[N, 64]``
    levels with N <= ``REQUANT_MAX_BLOCKS``, an f32 ``qt_in`` of 64 entries
    (``[64]`` or ``[1, 64]``) and f32 ``qt_rungs [R, 64]`` with
    1 <= R <= ``REQUANT_MAX_RUNGS``, all on one device."""
    check_decode_args(levels, qt_in)
    if levels.shape[0] > REQUANT_MAX_BLOCKS:
        raise ValueError(f"N = {levels.shape[0]} blocks is above "
                         f"{REQUANT_MAX_BLOCKS}")
    if qt_rungs.dtype != torch.float32:
        raise TypeError(f"qt_rungs must be torch.float32, got "
                        f"{qt_rungs.dtype}")
    if (qt_rungs.dim() != 2 or qt_rungs.shape[1] != 64
            or not 1 <= qt_rungs.shape[0] <= REQUANT_MAX_RUNGS):
        raise ValueError(f"qt_rungs must be [R, 64] with 1 <= R <= "
                         f"{REQUANT_MAX_RUNGS}, got {tuple(qt_rungs.shape)}")
    if qt_rungs.device != levels.device:
        raise ValueError(f"qt_rungs is on {qt_rungs.device}, levels on "
                         f"{levels.device}")


def requant_rungs(levels: torch.Tensor, qt_in: torch.Tensor,
                  qt_rungs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every ladder rung of ``[N, 64]`` int32 levels: ``rungs [R, N, 64]``
    int32 and ``nonzeros [R]`` int32, for any R >= 1 and N.  R runs in
    groups of at most ``REQUANT_MAX_RUNGS`` and N in chunks of at most
    ``REQUANT_MAX_BLOCKS``, one ``requant_rungs_launch`` each: the rungs
    are concatenated and the per-rung nonzero counts summed."""
    check_decode_args(levels, qt_in)
    if (qt_rungs.dim() != 2 or qt_rungs.shape[1] != 64
            or qt_rungs.shape[0] < 1):
        raise ValueError(f"qt_rungs must be [R, 64] with R >= 1, got "
                         f"{tuple(qt_rungs.shape)}")
    n, r = levels.shape[0], qt_rungs.shape[0]
    if n <= REQUANT_MAX_BLOCKS and r <= REQUANT_MAX_RUNGS:
        return requant_rungs_launch(levels, qt_in, qt_rungs)
    rungs = torch.empty((r, n, 64), dtype=torch.int32, device=levels.device)
    nonzeros = torch.zeros(r, dtype=torch.int32, device=levels.device)
    for g in range(0, r, REQUANT_MAX_RUNGS):
        tables = qt_rungs[g:g + REQUANT_MAX_RUNGS]
        for c in range(0, max(n, 1), REQUANT_MAX_BLOCKS):
            part, nz = requant_rungs_launch(
                levels[c:c + REQUANT_MAX_BLOCKS], qt_in, tables)
            rungs[g:g + REQUANT_MAX_RUNGS, c:c + REQUANT_MAX_BLOCKS] = part
            nonzeros[g:g + REQUANT_MAX_RUNGS] += nz
    return rungs, nonzeros


def requant_rungs_launch(levels: torch.Tensor, qt_in: torch.Tensor,
                         qt_rungs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One ``ed_requant_rungs`` launch (the plain version on a CPU
    tensor), inside the kernel's limits (``check_requant_args``)."""
    check_requant_args(levels, qt_in, qt_rungs)
    if levels.device.type == "cpu":
        return requant_rungs_plain(levels, qt_in, qt_rungs)
    if levels.device.type != "cuda":
        raise ValueError(f"no requant kernel for device {levels.device}")
    dev = levels.device
    kernel_lib.require(levels, "levels", torch.int32, 2, dev)
    kernel_lib.require(qt_rungs, "qt_rungs", torch.float32, 2, dev)
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (16-byte loads)")
    qt = qt_in.reshape(64)
    if not qt.is_contiguous():
        raise ValueError("qt_in must be contiguous")
    n, r = levels.shape[0], qt_rungs.shape[0]
    rungs = torch.empty((r, n, 64), dtype=torch.int32, device=dev)
    if n == 0:
        return rungs, torch.zeros(r, dtype=torch.int32, device=dev)
    nonzeros = torch.empty(r, dtype=torch.int32, device=dev)
    kernel_lib.launch(
        "ed_requant_rungs", levels.data_ptr(), n, qt.data_ptr(),
        qt_rungs.data_ptr(), r, rungs.data_ptr(),
        kernel_lib.scratch("ed_requant_rungs", REQUANT_SCRATCH_WORDS,
                           dev).data_ptr(),
        nonzeros.data_ptr())
    return rungs, nonzeros
