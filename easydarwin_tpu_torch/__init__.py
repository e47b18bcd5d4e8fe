"""easydarwin_tpu_torch — the PyTorch/CUDA port of easydarwin_tpu's device tier.

The live RTP relay runs here on an NVIDIA H100: the megabatch scheduler
stages every stream's new ring packets into fused ``[B, P, 96+4]`` rows,
and one launch of a hand-written CUDA kernel per wake, over every shape
bucket (``csrc/relay_kernels.cu``), parses them and emits the
per-subscriber affine rewrite.  The config-5
transcode path runs here too: ``models.TranscodePipeline`` requantizes
coefficient blocks into every ladder rung and decodes pixels with the
hand-written K2 (``csrc/transform_kernels.cu``), and the live MJPEG ladder
(``models.mjpeg_ladder``) is started over REST.  The HLS tier
(``hls``) publishes pushed H.264 as fMP4 with temporal and requant rungs;
the requant rungs' B6 pass is two hand-written kernels
(``csrc/h264_kernels.cu``).  Every plain PyTorch
function beside a kernel computes the same result and is what a CPU tensor
runs.

Device rule: every entry point takes ``device``; the default is ``"cuda"``
and it raises when no card is present.  Callers that want the CPU ask for
it (``device="cpu"``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` without a card
    raises instead of quietly running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
