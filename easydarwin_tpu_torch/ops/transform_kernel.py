"""K2 on the card: the fused block decode kernel ``ed_decode_blocks``.

The counterpart of the reference's Pallas kernel
(``easydarwin_tpu/ops/transform.py:decode_blocks_pallas``), written by
hand in CUDA C++ (``csrc/transform_kernels.cu``).  Same contract as
``ops.transform.decode_blocks_plain``: ``levels [N, 64]`` int32 ·
``qtable`` f32 with 64 entries → ``[N, 64]`` uint8 =
``clip(round(levels·qt @ invᵀ + 128), 0, 255)``, with ``inv`` the 64×64
Kronecker IDCT operator.

The Pallas version pads N to its 256-block tile; the CUDA kernel masks
the ragged edge itself, so nothing is padded here.  On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

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
        raise ValueError("levels must be 16-byte aligned (rows load as int4)")
    qt = qtable.reshape(64)
    if not qt.is_contiguous():
        raise ValueError("qtable must be contiguous")
    n = levels.shape[0]
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    if n:
        inv = operator("inv", dev)
        kernel_lib.launch("ed_decode_blocks", levels.data_ptr(), n,
                          qt.data_ptr(), inv.data_ptr(), out.data_ptr())
    return out
