"""K1 on the card: the packet parse/classify kernel ``ed_parse_packets``.

The counterpart of the reference's Pallas kernel
(``easydarwin_tpu/ops/parse_pallas.py:parse_packets_pallas``), written by
hand in CUDA C++ (``csrc/relay_kernels.cu``).  Same contract as
``ops.parse.parse_packets``: ``words [P,4]`` (seq, timestamp, ssrc,
payload_start) and ``flags [P,5]`` (nal_type, keyframe_first, frame_first,
frame_last, marker); the wrapper splits them into the nine fields with the
plain version's dtypes.  Each CTA takes a tile of ``PARSE_TILE_ROWS`` rows
into shared memory by one bulk copy (``parse_tile_plan``), one thread per
packet parses its row there.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import kernel_lib
from .parse import check_prefix, parse_packets

#: rows (and threads) per CTA (``kTileRows`` in the source)
PARSE_TILE_ROWS = 64


def _check_stride(row_stride: int) -> None:
    if PARSE_TILE_ROWS * row_stride + kernel_lib.BULK_ALIGN > \
            kernel_lib.DYN_SMEM_LIMIT:
        raise ValueError(f"row stride {row_stride} too wide for a "
                         f"{PARSE_TILE_ROWS}-row tile in shared memory")


def parse_tile_plan(n_rows: int, row_stride: int, addr: int
                    ) -> list[tuple[int, int, int, int, int]]:
    """K1's tiles over ``n_rows`` rows of ``row_stride`` bytes from byte
    ``addr``: ``(row_lo, row_hi, head, interior, tail)`` per CTA, as the
    kernel computes them.  A stride whose tile would need more than
    ``kernel_lib.DYN_SMEM_LIMIT`` bytes of shared memory raises."""
    _check_stride(row_stride)
    tiles = []
    for lo in range(0, n_rows, PARSE_TILE_ROWS):
        hi = min(lo + PARSE_TILE_ROWS, n_rows)
        tiles.append((lo, hi, *kernel_lib.bulk_split(addr + lo * row_stride,
                                                     (hi - lo) * row_stride)))
    return tiles


def parse_packets_kernel(prefix: torch.Tensor, length: torch.Tensor
                         ) -> dict[str, torch.Tensor]:
    """H.264 parse of ``[P, W>=96]`` uint8 rows + ``[P]`` int32 lengths."""
    if prefix.device.type == "cpu":
        return parse_packets(prefix, length)
    if prefix.device.type != "cuda":
        raise ValueError(f"no parse kernel for device {prefix.device}")
    dev = prefix.device
    check_prefix(prefix)
    kernel_lib.require(prefix, "prefix", torch.uint8, 2, dev)
    kernel_lib.require(length, "length", torch.int32, 1, dev)
    n, width = prefix.shape
    if length.shape[0] != n:
        raise ValueError(f"length has {length.shape[0]} rows, prefix {n}")
    _check_stride(width)
    words = torch.empty((n, 4), dtype=torch.int32, device=dev)
    flags = torch.empty((n, 5), dtype=torch.int32, device=dev)
    if n:
        kernel_lib.launch("ed_parse_packets", prefix.data_ptr(), n, width,
                          length.data_ptr(), words.data_ptr(),
                          flags.data_ptr())
    # the kernel writes uint32 bits: the fields are column views (the two
    # 32-bit unsigned ones re-viewed as uint32) and one comparison turns
    # the four flag columns into bools
    flag = flags[:, 1:] != 0
    return {
        "seq": words[:, 0],
        "timestamp": words[:, 1].view(torch.uint32),
        "ssrc": words[:, 2].view(torch.uint32),
        "marker": flag[:, 3],
        "payload_start": words[:, 3],
        "nal_type": flags[:, 0],
        "keyframe_first": flag[:, 0],
        "frame_first": flag[:, 1],
        "frame_last": flag[:, 2],
    }
