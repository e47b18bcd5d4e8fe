"""Config-5 transcode pipeline: transform-domain bitrate ladder.

One step takes a batch of quantized 8×8 coefficient blocks (the
entropy-decoded intra blocks of an MJPEG source; entropy coding stays on
the host) and produces every ladder rung:

* per rung: requantized levels (no IDCT round-trip) and nonzero counts
  (the rate proxy driving rung selection): B7, on the card ONE launch of
  the hand-written ``ed_requant_rungs``;
* optionally decoded pixels at the source table (preview/JPEG snaps): on
  the card that leg is kernel K2, ``ed_decode_blocks``.

The reference's ``vmap`` over rungs is a written-out rung axis here:
``rungs [R, N, 64]`` int32 and ``nonzeros [R]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..convert import transcode_tables_from_numpy
from ..ops import transform as tf
from ..ops.transform_kernel import requant_rungs


@dataclass(frozen=True)
class TranscodeConfig:
    qualities: tuple[int, ...] = (80, 50, 25)
    source_quality: int = 90
    decode_pixels: bool = False


class TranscodePipeline:
    def __init__(self, config: TranscodeConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or TranscodeConfig()
        self.device = resolve_device(device)
        self.qt_in, self.qt_rungs = transcode_tables_from_numpy(
            tf.quality_table(self.config.source_quality),
            np.stack([tf.quality_table(q) for q in self.config.qualities]),
            self.device)

    def __call__(self, levels) -> dict:
        """levels: [N, 64] int32 quantized coefficients (numpy or tensor)
        → rung outputs on the pipeline's device."""
        if not isinstance(levels, torch.Tensor):
            levels = torch.from_numpy(np.array(levels, np.int32))
        levels = levels.to(device=self.device, dtype=torch.int32).contiguous()
        return _ladder_step(levels, qt_in=self.qt_in, qt_rungs=self.qt_rungs,
                            decode_pixels=self.config.decode_pixels)

    def example_args(self, n_blocks: int = 512):
        rng = np.random.default_rng(0)
        pixels = rng.integers(0, 256, size=(n_blocks, 64), dtype=np.uint8)
        levels = tf.encode_blocks(torch.from_numpy(pixels).to(self.device),
                                  self.qt_in)
        return (levels.cpu().numpy(),)


def _ladder_step(levels: torch.Tensor, *, qt_in: torch.Tensor,
                 qt_rungs: torch.Tensor, decode_pixels: bool) -> dict:
    # B7: every rung and its nonzero count; ed_requant_rungs on the card
    rung_levels, nonzeros = requant_rungs(levels, qt_in, qt_rungs)
    out = {"rungs": rung_levels, "nonzeros": nonzeros}
    if decode_pixels:
        # the same function as idct(dequantize(levels)) + 128 → round →
        # clip → u8; K2 on the card
        out["pixels"] = tf.decode_blocks(levels, qt_in)
    return out
