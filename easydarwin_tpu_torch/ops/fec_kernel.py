"""B4 on the card: the GF(256) parity product ``ed_gf_parity``.

The counterpart of the reference's XLA pass
``easydarwin_tpu/models/relay_pipeline.py:280 fec_parity_window_step``,
written by hand in CUDA C++ (``csrc/fec_kernels.cu``): ``rows [K, B]``
uint8 (a FEC window's ring rows, or a stripe's blobs) times
``coeff [R, K]`` uint8 (Vandermonde rows, ``relay.fec.coeff_rows``) →
``[R, B]`` uint8 over GF(256) with the polynomial 0x11D, XORed over K;
the XOR row is the all-ones coefficient row, so one pass serves both
kinds.  The kernel multiplies through nibble product tables
(``GF_NIB``: ``c·x = c·(x & 0x0F) ⊕ c·(x & 0xF0)``, two 16-byte tables
per coefficient) held in registers, not log/antilog gathers.

``gf_parity_plain`` is the plain PyTorch version: int64 table gathers
(``rows.long()`` indices) and a loop of uint8 ``^=`` over K.  On a CPU
tensor the wrapper runs it; on a CUDA tensor it launches the kernel or
raises.  The shapes the kernel serves (``check_shape``) are checked on
both devices: K <= 64, R <= 8 and B a positive multiple of 256.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..relay.fec import GF_EXP512, GF_LOG
from . import kernel_lib

#: the kernel's limits: rows a window, parity rows, and the byte-axis unit
#: (B / 4 words fill whole CTAs of 64 threads; B is pow2-padded to at
#: least 256)
MAX_K = 64
MAX_R = 8
B_UNIT = 256


def _nibble_tables() -> np.ndarray:
    """``[256, 2, 16]`` uint8: ``[c, 0, i] = c·i`` and ``[c, 1, i] =
    c·(i << 4)``, the products of every coefficient by every low and high
    nibble (row 0 and column 0 are zeros)."""
    c = np.arange(256)[:, None]
    x = np.concatenate([np.arange(16), np.arange(16) << 4])[None, :]
    prod = GF_EXP512[GF_LOG[c] + GF_LOG[x]]
    prod[(c == 0) | (x == 0)] = 0
    return prod.astype(np.uint8).reshape(256, 2, 16)


#: the kernel's table: one coefficient's low-nibble then high-nibble
#: products, 32 bytes, at ``32 · c`` (8 KB)
GF_NIB = _nibble_tables()

#: per device: the kernel's ``GF_NIB``, and the plain version's (log
#: int64, antilog uint8) pair; made once, so both are graph-capturable
_TABLES: dict[torch.device, torch.Tensor] = {}
_PLAIN_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_TABLES_LOCK = threading.Lock()


def check_shape(rows: torch.Tensor, coeff: torch.Tensor) -> None:
    """Raise unless ``rows [K, B]`` and ``coeff [R, K]`` are uint8 and in
    the kernel's range."""
    for t, name in ((rows, "rows"), (coeff, "coeff")):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D uint8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    k, b = rows.shape
    r = coeff.shape[0]
    if coeff.shape[1] != k:
        raise ValueError(f"coeff is {tuple(coeff.shape)} for {k} rows")
    if not (1 <= k <= MAX_K and 1 <= r <= MAX_R and b > 0
            and b % B_UNIT == 0):
        raise ValueError(f"GF parity shape K={k} B={b} R={r} out of range "
                         f"(K <= {MAX_K}, R <= {MAX_R}, B a multiple of "
                         f"{B_UNIT})")


def gf_parity_plain(rows: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """``coeff [R, K] × rows [K, B] → [R, B]`` uint8 in plain torch ops."""
    dev = rows.device
    tables = _PLAIN_TABLES.get(dev)
    if tables is None:
        tables = _PLAIN_TABLES[dev] = (
            torch.as_tensor(GF_LOG, dtype=torch.int64).to(dev),
            torch.as_tensor(GF_EXP512, dtype=torch.uint8).to(dev))
    log, exp = tables
    lr = log[rows.long()]                       # [K, B]
    lc = log[coeff.long()]                      # [R, K]
    rows_nz = rows != 0
    coeff_nz = coeff != 0
    out = torch.zeros((coeff.shape[0], rows.shape[1]), dtype=torch.uint8,
                      device=dev)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    for k in range(rows.shape[0]):
        prod = exp[lc[:, k, None] + lr[None, k, :]]
        nz = coeff_nz[:, k, None] & rows_nz[None, k, :]
        out ^= torch.where(nz, prod, zero)
    return out


def _tables(device: torch.device) -> torch.Tensor:
    """``GF_NIB`` on ``device``, uploaded once (the pump and the storage
    workers may ask at the same time)."""
    t = _TABLES.get(device)
    if t is None:
        with _TABLES_LOCK:
            t = _TABLES.get(device)
            if t is None:
                t = _TABLES[device] = _upload(GF_NIB, device)
    return t


def _upload(table: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(table).to(device)


def gf_parity(rows: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """GF(256) parity rows: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    check_shape(rows, coeff)
    if rows.device.type == "cpu":
        return gf_parity_plain(rows, coeff)
    if rows.device.type != "cuda":
        raise ValueError(f"no GF parity kernel for device {rows.device}")
    dev = rows.device
    kernel_lib.require(rows, "rows", torch.uint8, 2, dev)
    kernel_lib.require(coeff, "coeff", torch.uint8, 2, dev)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary")
    k, b = rows.shape
    r = coeff.shape[0]
    out = torch.empty((r, b), dtype=torch.uint8, device=dev)
    kernel_lib.launch("ed_gf_parity", rows.data_ptr(), k, b,
                      coeff.data_ptr(), r, _tables(dev).data_ptr(),
                      out.data_ptr())
    return out
