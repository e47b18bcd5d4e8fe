"""B6 on the card: ``ed_h264_requant`` and ``ed_h264_requant_chroma``.

The H.264 ladder's transform-domain requant, written by hand in CUDA C++
(``csrc/h264_kernels.cu``).  It replaces the reference's XLA-fused int32
pass (``easydarwin_tpu/ops/transform.py:264 h264_requant``, ``:315
h264_requant_chroma``); the plain versions are the torch chains
``ops.transform.h264_requant`` and ``h264_requant_chroma``, with which the
kernels agree bit for bit on every int32 input:

* ``h264_requant_kernel(levels [N, 16], qp_in [N], qp_out [N])`` →
  ``[N, 16]``: the exact +6k shift of each level after the clip to
  ±``LEVEL_CLIP``;
* ``h264_requant_chroma_kernel(dc [N, 4], ac [N, 4, 15], qpc_in [N],
  qpc_out [N])`` → ``(dc', ac')``: the identity, exact-shift or general
  round-trip arm of each row.

All int32.  A QP may be a scalar or a tensor of one element, which is
broadcast over the rows.  On a CPU tensor each wrapper runs the plain
version; on a CUDA tensor it launches its kernel on the current stream or
raises.

``RequantLeg`` is the HLS ladder's form of the same two kernels, for
numpy rows on the host: ONE call into the library (``ed_h264_requant_leg``
or ``ed_h264_requant_chroma_leg``, bound through ``ctypes.PyDLL`` so it
keeps the GIL) narrows and tiles the rows into pinned staging, uploads
them, launches the kernel once, reads the outputs back into pinned memory
and records an event; ``result`` waits on that event and widens the
outputs to int64 in one more such call.  The ladder runs it on pool
workers beside threads that parse in Python: a chain of torch calls
doing the same would give up the GIL at each step and wait to take it
back.  Its buffers come from a pool and go back only after their event.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import kernel_lib
from .transform import h264_requant, h264_requant_chroma

#: how long ``RequantLeg.result`` spins on its event with the GIL kept
#: before it waits without it (a leg's copies and launch at the ladder's
#: sizes take tens of microseconds)
LEG_SPIN_US = 2000
#: the least words a leg buffer is made with (they grow by powers of two)
LEG_MIN_WORDS = 1 << 16


def _qp_vector(qp, n: int, like: torch.Tensor) -> torch.Tensor:
    """A per-row QP as a contiguous int32 ``[n]`` tensor on ``like``'s
    device (a scalar or one-element QP is broadcast)."""
    q = (qp.to(like.device) if isinstance(qp, torch.Tensor)
         else torch.as_tensor(qp, dtype=torch.int32, device=like.device))
    if q.dtype != torch.int32:
        raise TypeError(f"QPs must be torch.int32, got {q.dtype}")
    if q.numel() == 1:
        return q.reshape(1).expand(n).contiguous()
    if tuple(q.shape) != (n,):
        raise ValueError(f"QPs must be [{n}] or a scalar, got "
                         f"{tuple(q.shape)}")
    return q.contiguous()


def _check_rows(t: torch.Tensor, name: str, tail: tuple) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail:
        raise ValueError(f"{name} must be [N, {', '.join(map(str, tail))}], "
                         f"got {tuple(t.shape)}")


def _check_cuda(t: torch.Tensor, name: str) -> None:
    """The kernels read and write whole rows as 16-byte words."""
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def h264_requant_kernel(levels: torch.Tensor, qp_in, qp_out) -> torch.Tensor:
    """Luma requant of int32 ``[N, 16]`` levels: ONE ``ed_h264_requant``
    launch on a CUDA tensor (none for N = 0)."""
    _check_rows(levels, "levels", (16,))
    n = levels.shape[0]
    qi, qo = _qp_vector(qp_in, n, levels), _qp_vector(qp_out, n, levels)
    if levels.device.type == "cpu":
        return h264_requant(levels, qi, qo)
    if levels.device.type != "cuda":
        raise ValueError(f"no B6 kernel for device {levels.device}")
    _check_cuda(levels, "levels")
    out = torch.empty((n, 16), dtype=torch.int32, device=levels.device)
    if n:
        kernel_lib.launch("ed_h264_requant", levels.data_ptr(),
                          qi.data_ptr(), qo.data_ptr(), n, out.data_ptr())
    return out


def h264_requant_chroma_kernel(dc: torch.Tensor, ac: torch.Tensor, qpc_in,
                               qpc_out) -> tuple[torch.Tensor, torch.Tensor]:
    """Chroma requant of int32 DC ``[N, 4]`` and AC ``[N, 4, 15]`` rows:
    ONE ``ed_h264_requant_chroma`` launch on CUDA tensors (none for
    N = 0)."""
    _check_rows(dc, "dc", (4,))
    _check_rows(ac, "ac", (4, 15))
    n = dc.shape[0]
    if ac.shape[0] != n or ac.device != dc.device:
        raise ValueError(f"ac {tuple(ac.shape)} on {ac.device} does not "
                         f"match dc {tuple(dc.shape)} on {dc.device}")
    qi, qo = _qp_vector(qpc_in, n, dc), _qp_vector(qpc_out, n, dc)
    if dc.device.type == "cpu":
        return h264_requant_chroma(dc, ac, qi, qo)
    if dc.device.type != "cuda":
        raise ValueError(f"no B6 kernel for device {dc.device}")
    _check_cuda(dc, "dc")
    _check_cuda(ac, "ac")
    # the kernel bulk-copies each chunk's QPs too: a view off 16 bytes is
    # copied to a fresh (aligned) tensor
    qi, qo = (q if q.data_ptr() % 16 == 0 else q.clone() for q in (qi, qo))
    dc_out = torch.empty((n, 4), dtype=torch.int32, device=dc.device)
    ac_out = torch.empty((n, 4, 15), dtype=torch.int32, device=dc.device)
    if n:
        kernel_lib.launch("ed_h264_requant_chroma", dc.data_ptr(),
                          ac.data_ptr(), qi.data_ptr(), qo.data_ptr(), n,
                          dc_out.data_ptr(), ac_out.data_ptr())
    return dc_out, ac_out


# ------------------------------------------------------------ the ladder's leg
def _align4(words: int) -> int:
    return (words + 3) & ~3


def chroma_leg_layout(n: int) -> dict[str, int]:
    """Word offsets of the chroma leg's card buffer at ``n`` rows, as
    ``ed_h264_requant_chroma_leg`` lays it out: ``dc`` [n, 4], ``ac``
    [n, 4, 15], ``qpc_in`` [n], ``qpc_out`` [n] (the staged inputs, which
    end at ``in_words``), then ``dc_out`` and ``ac_out``, which end at
    ``words``.  Every segment starts on a 16-byte boundary, as the
    kernel's bulk copies need."""
    qo = 64 * n + _align4(n)
    out = _align4(qo + n)
    return {"dc": 0, "ac": 4 * n, "qpc_in": 64 * n, "qpc_out": qo,
            "in_words": qo + n, "dc_out": out, "ac_out": out + 4 * n,
            "words": out + 64 * n}


class _LegBuffers:
    """One leg's pinned staging, card buffer, pinned readback and CUDA
    event; handed to a later leg only after this one's event completed."""

    def __init__(self, device: torch.device, words: tuple[int, int, int]):
        cap = [max(LEG_MIN_WORDS, 1 << (w - 1).bit_length()) for w in words]
        self.words = tuple(cap)
        self.stage = torch.empty(cap[0], dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(cap[1], dtype=torch.int32, device=device)
        self.back = torch.empty(cap[2], dtype=torch.int32, pin_memory=True)
        event = ctypes.c_void_p()
        rc = kernel_lib.library().ed_event_create(ctypes.byref(event))
        if rc != 0:
            raise RuntimeError(f"ed_event_create failed: "
                               f"{kernel_lib.error_message(rc)}")
        # the event lives as long as the process: buffers are never freed
        self.event = event.value

    def fits(self, words: tuple[int, int, int]) -> bool:
        return all(w <= c for w, c in zip(words, self.words))


#: free leg buffers by device; a leg takes one that fits or makes one
_FREE: dict[torch.device, list[_LegBuffers]] = {}
_FREE_LOCK = threading.Lock()


def _take(device: torch.device, words: tuple[int, int, int]) -> _LegBuffers:
    with _FREE_LOCK:
        free = _FREE.setdefault(device, [])
        for i, buf in enumerate(free):
            if buf.fits(words):
                return free.pop(i)
    return _LegBuffers(device, words)


def _give(device: torch.device, buf: _LegBuffers) -> None:
    with _FREE_LOCK:
        _FREE.setdefault(device, []).append(buf)


def _rows64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


class RequantLeg:
    """ONE B6 pass of numpy rows on a card, tiled over target QPs (module
    notes): ``kind`` ``"luma"`` takes ``[rows [r, 16], qp_in [r], deltas
    [t]]`` and gives ``[t * r, 16]``, tile i requantized from ``qp_in``
    to ``qp_in + deltas[i]``; ``"chroma"`` takes ``[dc [m * g, 4], ac
    [m * g, 4, 15], qp_in [m], qp_out [t, m]]`` with ``group`` g rows a
    QP and gives ``(dc' [n, 4], ac' [n, 4, 15])``, n = t * m * g, tile i
    requantized from ``qp_in`` to ``qp_out[i]`` (the chroma QP is no
    linear step of the luma one).
    The constructor stages, uploads, launches and enqueues the readback
    (one launch, counted); ``result`` waits on the event and returns
    int64 arrays.  A CUDA error raises from either."""

    def __init__(self, kind: str, arrays: list, device: torch.device, *,
                 group: int = 1):
        if device.type != "cuda":
            raise ValueError(f"RequantLeg runs on a card, not {device}")
        self.device = device
        arrays = [_rows64(a) for a in arrays]
        if kind == "luma":
            rows, qi, deltas = arrays
            r, t = rows.shape[0], deltas.shape[0]
            if rows.shape[1:] != (16,) or qi.shape != (r,) \
                    or deltas.shape != (t,):
                raise ValueError(f"luma leg shapes {[a.shape for a in arrays]}")
            n = r * t
            words = (18 * n, _align4(18 * n) + 16 * n, 16 * n)
            self._shapes = [(n, 16)]
            name, kernel = "ed_h264_requant_leg", "ed_h264_requant"
            lead = (rows.ctypes.data, qi.ctypes.data, deltas.ctypes.data, r,
                    t)
        elif kind == "chroma":
            dc, ac, qi, qo = arrays
            m, t = qi.shape[0], qo.shape[0]
            rows = m * group
            if dc.shape != (rows, 4) or ac.shape != (rows, 4, 15) \
                    or qo.shape != (t, m):
                raise ValueError(f"chroma leg shapes "
                                 f"{[a.shape for a in arrays]}")
            n = rows * t
            lay = chroma_leg_layout(n)
            words = (lay["in_words"], lay["words"], 64 * n)
            self._shapes = [(n, 4), (n, 4, 15)]
            name, kernel = ("ed_h264_requant_chroma_leg",
                            "ed_h264_requant_chroma")
            lead = (dc.ctypes.data, ac.ctypes.data, qi.ctypes.data,
                    qo.ctypes.data, m, group, t)
        else:
            raise ValueError(f"unknown leg kind {kind!r}")
        self._words = words[2]
        self._out: list[np.ndarray] | None = None
        self._buf = None
        if n == 0:
            self._out = [np.zeros(s, dtype=np.int64) for s in self._shapes]
            return
        buf = _take(device, words)
        # on an error the buffers may still be read by an enqueued copy:
        # they are dropped, never handed to another leg
        kernel_lib.launch_held(name, kernel, *lead, buf.stage.data_ptr(),
                               buf.dev.data_ptr(), buf.back.data_ptr(),
                               buf.event, device=device)
        self._buf = buf

    def result(self) -> list[np.ndarray]:
        """The outputs (int64), after the leg's event; the leg's buffers
        go back to the pool."""
        if self._out is None:
            buf = self._buf
            flat = np.empty(self._words, dtype=np.int64)
            lib = kernel_lib.held()
            args = (buf.event, buf.back.data_ptr(), self._words,
                    flat.ctypes.data)
            rc = lib.ed_h264_leg_finish(*args, LEG_SPIN_US)
            if rc == kernel_lib.CUDA_ERROR_NOT_READY:
                # still running after the spin: wait without the GIL
                rc = kernel_lib.library().ed_event_synchronize(buf.event)
                if rc == 0:
                    rc = lib.ed_h264_leg_finish(*args, 0)
            if rc != 0:
                self._buf = None
                raise RuntimeError(f"B6 leg readback failed: "
                                   f"{kernel_lib.error_message(rc)}")
            self._buf = None
            _give(self.device, buf)
            out, at = [], 0
            for shape in self._shapes:
                size = int(np.prod(shape))
                out.append(flat[at:at + size].reshape(shape))
                at += size
            self._out = out
        return self._out
