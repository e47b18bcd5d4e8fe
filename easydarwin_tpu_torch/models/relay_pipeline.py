"""The relay pipeline: one configurable device step, and the megabatch pass.

Two parse backends (the hand-written K1 kernel, or the plain PyTorch parse
— bit-identical) and two output modes:

* ``affine`` (production): O(S+P) rewrite parameters, egress renders;
* ``headers``: full [S, P, 12] rendered headers on the device.

``megabatch_window_steps`` is the cross-stream stacked pass the scheduler
(``relay.megabatch``) dispatches once per wake over every shape bucket
(``megabatch_window_step`` is its group of one), and
``scatter_affine_segments`` splits a bucket's result back into per-stream
params.  ``fec_parity_window_step`` is the FEC tier's GF(256) parity pass
(B4), shared by the wire FEC (``relay.fec``) and the stripe codec
(``storage.codec``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops import fanout as fanout_ops
from ..ops import fec_kernel
from ..ops import gop as gop_ops
from ..ops.parse import normalize_codec, parse_packets, u32_from_i64
from ..ops.parse_kernel import parse_packets_kernel


@dataclass(frozen=True)
class RelayPipelineConfig:
    bucket_delay_ms: int = 73
    use_pallas_parse: bool = False   # True: the K1 kernel on the card
    mode: str = "affine"         # "affine" | "headers"
    codec: str = "h264"          # "h264" | "mjpeg" (per-stream classifier)


class RelayPipeline:
    """Callable step over one source's window: ``(prefix [P, W] uint8,
    length [P], age_ms [P], out_state [S, 6] uint32, buckets [S])`` →
    dict of tensors on ``device``."""

    def __init__(self, config: RelayPipelineConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or RelayPipelineConfig()
        self.device = resolve_device(device)

    _NP = {torch.uint8: np.uint8, torch.int32: np.int32,
           torch.uint32: np.uint32}

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a, self._NP[dtype]))
        return a.to(device=self.device, dtype=dtype).contiguous()

    def __call__(self, prefix, length, age_ms, out_state, buckets):
        c = self.config
        return _pipeline_step(
            self._tensor(prefix, torch.uint8),
            self._tensor(length, torch.int32),
            self._tensor(age_ms, torch.int32),
            self._tensor(out_state, torch.uint32),
            self._tensor(buckets, torch.int32),
            use_pallas=c.use_pallas_parse, mode=c.mode,
            bucket_delay_ms=c.bucket_delay_ms, codec=c.codec)


def _pipeline_step(prefix, length, age_ms, out_state, buckets, *,
                   use_pallas: bool, mode: str, bucket_delay_ms: int,
                   codec: str = "h264"):
    # K1 is the H.264 hot path; MJPEG classification is a handful of
    # torch ops, so it always takes the plain parse (on either device)
    if normalize_codec(codec) != "h264":
        fields = parse_packets(prefix, length, codec=codec)
    else:
        parse_fn = parse_packets_kernel if use_pallas else parse_packets
        fields = parse_fn(prefix, length)
    valid = length > 0
    kf = fields["keyframe_first"] & valid
    out = {
        "seq": u32_from_i64(fields["seq"].to(torch.int64)),
        "timestamp": fields["timestamp"],
        "keyframe_first": kf,
        "frame_last": fields["frame_last"],
        "newest_keyframe": gop_ops.newest_keyframe(kf, valid),
        "fast_start": gop_ops.fast_start_indices(kf, valid, age_ms, 10_000),
        "mask": (fanout_ops.eligibility(age_ms, buckets, bucket_delay_ms)
                 & (length >= 12)[None, :]),
    }
    if mode == "affine":
        (out["seq_off"], out["ts_off"], out["ssrc"],
         out["chan"]) = fanout_ops.affine_params(out_state)
    else:
        out["headers"] = fanout_ops.fanout_headers(
            prefix[:, :2], fields["seq"], fields["timestamp"], out_state)
    return out


def megabatch_window_step(window: torch.Tensor,
                          out_state: torch.Tensor) -> torch.Tensor:
    """Stacked relay device pass over a leading stream axis.

    ``window``: [B, P, 96+4] uint8 (``ops.staging`` fused rows, pow2-padded
    in every dimension) · ``out_state``: [B, S, STATE_COLS] uint32 →
    packed egress params [B, 4·S + 1] uint32
    (``seq_off[S] ∥ ts_off[S] ∥ ssrc[S] ∥ chan[S] ∥ newest_keyframe``).
    On the card this is one ``ed_relay_window`` launch."""
    return fanout_ops.relay_affine_step_window(window, out_state)


def megabatch_window_steps(pairs) -> list[torch.Tensor]:
    """``megabatch_window_step`` over every ``(window, out_state)`` bucket
    of a wake, one result per bucket.  On the card this is ONE
    ``ed_relay_window`` launch (for up to ``WINDOW_MAX_BUCKETS``
    buckets)."""
    return fanout_ops.relay_affine_step_windows(pairs)


def scatter_affine_segments(packed, n_subs):
    """Split one stacked packed result back into per-stream affine param
    sets.

    ``packed``: the [B, 4·S_pad + 1] result (any array-like) · ``n_subs``:
    per-stream REAL subscriber counts (extra rows beyond ``len(n_subs)``
    are bucket padding and ignored).  Returns one
    ``(seq_off[1, n], ts_off[1, n], ssrc[1, n], chan[1, n], newest_kf)``
    tuple per stream; ``newest_kf`` is the newest-keyframe slot index
    within the staged rows (−1 = none; the uint32 sentinel wraps back
    here)."""
    arr = np.asarray(packed)
    s_pad = (arr.shape[1] - 1) // 4
    out = []
    for row, n in zip(arr, n_subs):
        out.append((
            np.ascontiguousarray(row[None, 0:n]),
            np.ascontiguousarray(row[None, s_pad:s_pad + n]),
            np.ascontiguousarray(row[None, 2 * s_pad:2 * s_pad + n]),
            np.ascontiguousarray(row[None, 3 * s_pad:3 * s_pad + n]),
            int(row[4 * s_pad].astype(np.int32))))
    return out


def fec_parity_window_step(rows: torch.Tensor,
                           coeff: torch.Tensor) -> torch.Tensor:
    """GF(256) parity: ``rows [K, B]`` uint8 (a window's ring rows or a
    stripe's blobs, zero-padded, B a multiple of 256) × ``coeff [R, K]``
    uint8 (``relay.fec.coeff_rows``) → ``[R, B]`` uint8.  Zero rows and
    zero coefficients contribute nothing, so padding is free.  On the card
    one ``ed_gf_parity`` launch; on a CPU tensor the plain version."""
    return fec_kernel.gf_parity(rows, coeff)
