"""K2 on the card: the fused block decode kernel ``ed_decode_blocks``.

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
never stored, so nothing is padded here.  On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_lib
from .transform import decode_blocks_plain, operator


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
    vals = [ctypes.c_int() for _ in range(3)]
    rc = kernel_lib.library().ed_decode_blocks_geometry(
        *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"ed_decode_blocks_geometry failed: "
                           f"{kernel_lib.error_message(rc)}")
    return dict(zip(("tile_blocks", "stages", "ctas"),
                    (v.value for v in vals)))
