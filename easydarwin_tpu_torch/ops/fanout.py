"""Per-subscriber fan-out as batched tensor work, and the megabatch window
pass.

The per-subscriber rewrite is *affine*: ``seq' = seq + (out_seq_start −
base_src_seq) mod 2¹⁶``, ``ts' = ts + (out_ts_start − base_src_ts) mod
2³²``, SSRC constant per output.  So the device returns O(S) offsets per
stream instead of O(S·P) headers, and the host egress applies them while
it writes the wire.

``relay_affine_step_window`` is the megabatch's one device pass per shape
bucket: on a CUDA tensor it launches the hand-written ``ed_relay_window``
kernel (K1's parse fused with the keyframe reduction and the affine emit);
on a CPU tensor it runs ``relay_affine_step_window_plain``, the same
function in plain PyTorch.

All arithmetic on 32-bit quantities runs in int64 masked to 16/32 bits;
values become uint32 only at the output boundary (``u32_from_i64``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel_lib
from .gop import newest_keyframe
from .parse import PARSE_PREFIX, i64_from_u32, parse_packets, u32_from_i64

#: columns of the per-output state matrix: ssrc, base_src_seq,
#: base_src_ts, out_seq_start, out_ts_start, chan (the RTSP-interleave
#: channel byte for TCP outputs; CHAN_NONE for datagram subscribers)
STATE_COLS = 6
#: chan column sentinel for outputs with no interleave framing
CHAN_NONE = 0xFFFFFFFF
#: bytes appended to each packet prefix to carry its length (le32)
WINDOW_EXTRA = 4


def pack_output_state(outputs) -> np.ndarray:
    """Host helper: RelayOutput list → [S, STATE_COLS] uint32 state."""
    st = np.zeros((len(outputs), STATE_COLS), dtype=np.uint32)
    for i, o in enumerate(outputs):
        rw = o.rewrite
        ch = getattr(o, "interleave_chan", None)
        st[i] = (rw.ssrc, max(rw.base_src_seq, 0), max(rw.base_src_ts, 0),
                 rw.out_seq_start, rw.out_ts_start,
                 CHAN_NONE if ch is None else (ch & 0xFF))
    return st


def affine_params(out_state: torch.Tensor):
    """``[..., S, STATE_COLS]`` state → per-output ``(seq_off, ts_off,
    ssrc, chan)`` uint32 — the one definition of the affine rewrite in
    terms of the state layout."""
    st = i64_from_u32(out_state)
    return (u32_from_i64((st[..., 3] - st[..., 1]) & 0xFFFF),
            u32_from_i64(st[..., 4] - st[..., 2]),
            u32_from_i64(st[..., 0]),
            u32_from_i64(st[..., 5]))


def _be_bytes(v: torch.Tensor, n: int) -> list[torch.Tensor]:
    return [(v >> (8 * (n - 1 - i))) & 0xFF for i in range(n)]


def fanout_headers(b01: torch.Tensor, seq: torch.Tensor, ts: torch.Tensor,
                   out_state: torch.Tensor) -> torch.Tensor:
    """Rendered headers: b01 [P, 2] uint8 (source bytes 0-1) · seq/ts [P]
    · out_state [S, STATE_COLS] → [S, P, 12] uint8.  Bytes 0-1 are the
    source's, so ``header ∥ packet[12:]`` equals ``rtp.rewrite_header``."""
    seq = i64_from_u32(seq)
    ts = i64_from_u32(ts)
    st = i64_from_u32(out_state)
    S, P = st.shape[0], seq.shape[0]
    new_seq = (seq[None, :] - st[:, 1:2] + st[:, 3:4]) & 0xFFFF
    new_ts = (ts[None, :] - st[:, 2:3] + st[:, 4:5]) & 0xFFFFFFFF
    ssrc = st[:, 0:1].expand(S, P)
    b = b01.to(torch.int64)
    cols = ([b[None, :, 0].expand(S, P), b[None, :, 1].expand(S, P)]
            + _be_bytes(new_seq, 2) + _be_bytes(new_ts, 4)
            + _be_bytes(ssrc, 4))
    return torch.stack(cols, dim=-1).to(torch.uint8)


def eligibility(age_ms: torch.Tensor, bucket_of_output: torch.Tensor,
                bucket_delay_ms: int) -> torch.Tensor:
    """[S, P] bool: packet p may be sent to output s this pass (bucket b
    waits b × bucket_delay_ms).  ``age_ms`` is ``now − arrival``."""
    min_age = bucket_of_output.to(torch.int64) * int(bucket_delay_ms)
    return age_ms[None, :].to(torch.int64) >= min_age[:, None]


def relay_affine_step(prefix: torch.Tensor, length: torch.Tensor,
                      out_state: torch.Tensor) -> dict[str, torch.Tensor]:
    """One source: per-packet parsed fields plus per-output affine params
    (O(S+P) results instead of O(S·P) headers)."""
    fields = parse_packets(prefix, length)
    valid = length > 0
    kf = fields["keyframe_first"] & valid
    seq_off, ts_off, ssrc, chan = affine_params(out_state)
    return {
        "seq": u32_from_i64(fields["seq"].to(torch.int64)),
        "timestamp": fields["timestamp"],
        "keyframe_first": kf,
        "frame_first": fields["frame_first"],
        "frame_last": fields["frame_last"],
        "newest_keyframe": newest_keyframe(kf, valid),
        "seq_off": seq_off,
        "ts_off": ts_off,
        "ssrc": ssrc,
        "chan": chan,
    }


def relay_affine_step_packed(prefix: torch.Tensor, length: torch.Tensor,
                             out_state: torch.Tensor) -> torch.Tensor:
    """``relay_affine_step`` over a leading source axis, packed into ONE
    uint32 array ``[N_SRC, 4·S + 1]``:
    ``seq_off[S] ∥ ts_off[S] ∥ ssrc[S] ∥ chan[S] ∥ newest_keyframe``
    (the −1 sentinel rides as 0xFFFFFFFF)."""
    n, p, w = prefix.shape
    fields = parse_packets(prefix.reshape(n * p, w), length.reshape(n * p))
    valid = length > 0
    kf = fields["keyframe_first"].reshape(n, p) & valid
    newest = newest_keyframe(kf, valid).to(torch.int64)
    cols = [i64_from_u32(c) for c in affine_params(out_state)]
    return u32_from_i64(torch.cat(cols + [newest[:, None]], dim=-1))


def pack_window(prefix, length) -> np.ndarray:
    """Host helper: [..., P, 96] prefixes + [..., P] lengths → ONE uint8
    array [..., P, 100] (length rides as 4 trailing little-endian bytes)."""
    prefix = np.asarray(prefix, np.uint8)
    length = np.ascontiguousarray(length, "<u4")
    lb = length[..., None].view(np.uint8)
    return np.concatenate([prefix, lb], axis=-1)


def window_lengths(window: torch.Tensor) -> torch.Tensor:
    """Decode the le32 length column of ``[B, P, 96+4]`` rows as int32
    values (in int64), wrapping exactly as a uint32 → int32 cast does."""
    lb = window[..., PARSE_PREFIX:PARSE_PREFIX + WINDOW_EXTRA].to(torch.int64)
    v = lb[..., 0] | (lb[..., 1] << 8) | (lb[..., 2] << 16) | (lb[..., 3] << 24)
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def _check_window(window: torch.Tensor, out_state: torch.Tensor) -> None:
    if window.dim() != 3 or window.shape[2] < PARSE_PREFIX + WINDOW_EXTRA:
        raise ValueError(f"window must be [B, P, >={PARSE_PREFIX + WINDOW_EXTRA}]"
                         f", got {tuple(window.shape)}")
    if (out_state.dim() != 3 or out_state.shape[0] != window.shape[0]
            or out_state.shape[2] != STATE_COLS):
        raise ValueError(f"out_state must be [B, S, {STATE_COLS}] with "
                         f"B={window.shape[0]}, got {tuple(out_state.shape)}")


def relay_affine_step_window_plain(window: torch.Tensor,
                                   out_state: torch.Tensor) -> torch.Tensor:
    """The window pass in plain PyTorch (runs on either device)."""
    _check_window(window, out_state)
    return relay_affine_step_packed(window[:, :, :PARSE_PREFIX],
                                    window_lengths(window), out_state)


def relay_affine_step_window(window: torch.Tensor,
                             out_state: torch.Tensor) -> torch.Tensor:
    """The megabatch window pass: ``window`` [B, P, 96+4] uint8 (fused
    ``pack_window`` rows) · ``out_state`` [B, S, STATE_COLS] uint32 →
    [B, 4·S + 1] uint32.  A CUDA tensor launches ``ed_relay_window``; a
    CPU tensor runs the plain version."""
    if window.device.type == "cpu":
        return relay_affine_step_window_plain(window, out_state)
    if window.device.type != "cuda":
        raise ValueError(f"no window kernel for device {window.device}")
    _check_window(window, out_state)
    dev = window.device
    kernel_lib.require(window, "window", torch.uint8, 3, dev)
    kernel_lib.require(out_state, "out_state", torch.uint32, 3, dev)
    b, p, w = window.shape
    s = out_state.shape[1]
    out = torch.empty((b, 4 * s + 1), dtype=torch.int32, device=dev)
    if b:
        kernel_lib.launch("ed_relay_window", window.data_ptr(), b, p, w,
                          out_state.data_ptr(), s, out.data_ptr())
    return out.view(torch.uint32)


def unpack_affine(packed, n_sub: int):
    """Host-side views into the packed egress params:
    ``(seq_off, ts_off, ssrc, chan, newest_keyframe)``; the keyframe
    column is re-cast to int32 so the −1 sentinel survives."""
    return (packed[:, :n_sub], packed[:, n_sub:2 * n_sub],
            packed[:, 2 * n_sub:3 * n_sub],
            packed[:, 3 * n_sub:4 * n_sub],
            packed[:, 4 * n_sub].astype("int32"))
