"""Baseline JPEG entropy codec: scan bytes ⇄ quantized DCT coefficients.

The host half of the config-5 transcode ladder.  RTP/JPEG (RFC 2435)
streams are baseline JFIF scans coded with the *standard* Huffman tables
(the same ``_DC/_AC_CODELENS/SYMBOLS`` tables ``protocol.mjpeg`` writes
into reconstructed JFIF headers), so a scan entropy-decodes into
``[n_blocks, 64]`` coefficient-level arrays, is requantized on the device
(``ops.transform.requantize`` over all blocks at once), and is
entropy-re-encoded at each ladder rung.  Entropy coding is serial bit
twiddling and stays on the host.

Levels are kept in **zigzag order** end-to-end: the JFIF DQT tables ride
in zigzag order too, so requantization pairs level ``i`` with table entry
``i`` without reordering.
"""

from __future__ import annotations

import numpy as np

from .mjpeg import (_AC_CHROMA_CODELENS, _AC_CHROMA_SYMBOLS, _AC_CODELENS,
                    _AC_SYMBOLS, _DC_CHROMA_CODELENS, _DC_CHROMA_SYMBOLS,
                    _DC_CODELENS, _DC_SYMBOLS)


class JpegEntropyError(ValueError):
    pass


# -- canonical Huffman table construction ------------------------------------

def _build_decode(codelens: bytes, symbols: bytes) -> dict[tuple[int, int], int]:
    """(bit-length, code) → symbol for canonical Huffman tables."""
    table = {}
    code = 0
    k = 0
    for nbits, count in enumerate(codelens, start=1):
        for _ in range(count):
            table[(nbits, code)] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _build_encode(codelens: bytes, symbols: bytes) -> dict[int, tuple[int, int]]:
    """symbol → (code, bit-length)."""
    out = {}
    for (nbits, code), sym in _build_decode(codelens, symbols).items():
        out[sym] = (code, nbits)
    return out


_DC_DECODE = _build_decode(_DC_CODELENS, _DC_SYMBOLS)
_AC_DECODE = _build_decode(_AC_CODELENS, _AC_SYMBOLS)
_DC_ENCODE = _build_encode(_DC_CODELENS, _DC_SYMBOLS)
_AC_ENCODE = _build_encode(_AC_CODELENS, _AC_SYMBOLS)
_DC_CHROMA_DECODE = _build_decode(_DC_CHROMA_CODELENS, _DC_CHROMA_SYMBOLS)
_AC_CHROMA_DECODE = _build_decode(_AC_CHROMA_CODELENS, _AC_CHROMA_SYMBOLS)
_DC_CHROMA_ENCODE = _build_encode(_DC_CHROMA_CODELENS, _DC_CHROMA_SYMBOLS)
_AC_CHROMA_ENCODE = _build_encode(_AC_CHROMA_CODELENS, _AC_CHROMA_SYMBOLS)

#: per-component (DC decode, AC decode) — comp 0 luma, comps 1-2 chroma
_DECODE_TABLES = ((_DC_DECODE, _AC_DECODE),
                  (_DC_CHROMA_DECODE, _AC_CHROMA_DECODE),
                  (_DC_CHROMA_DECODE, _AC_CHROMA_DECODE))
_ENCODE_TABLES = ((_DC_ENCODE, _AC_ENCODE),
                  (_DC_CHROMA_ENCODE, _AC_CHROMA_ENCODE),
                  (_DC_CHROMA_ENCODE, _AC_CHROMA_ENCODE))

#: blocks per MCU by RTP/JPEG type & 1 — type 0 = 4:2:2 (Y Y Cb Cr),
#: type 1 = 4:2:0 (Y Y Y Y Cb Cr); component index per block
_MCU_COMPS = {0: (0, 0, 1, 2), 1: (0, 0, 0, 0, 1, 2)}
#: MCU pixel footprint (w, h) per type
_MCU_SIZE = {0: (16, 8), 1: (16, 16)}


def mcu_grid(width: int, height: int, jtype: int) -> tuple[int, int]:
    mw, mh = _MCU_SIZE[jtype & 1]
    return (width + mw - 1) // mw, (height + mh - 1) // mh


class _BitReader:
    """MSB-first reader over an entropy-coded segment with 0xFF00
    unstuffing; stops at markers (restart or EOI)."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self) -> None:
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                # trailing virtual 1s (decoders pad; EOB codes resolve)
                self.acc = (self.acc << 8) | 0xFF
                self.nbits += 8
                continue
            b = self.data[self.pos]
            if b == 0xFF:
                nxt = self.data[self.pos + 1] if self.pos + 1 < len(self.data) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:   # restart marker: caller resyncs
                    self.acc = (self.acc << 8) | 0xFF
                    self.nbits += 8
                    continue
                else:                        # EOI or foreign marker
                    self.acc = (self.acc << 8) | 0xFF
                    self.nbits += 8
                    continue
            else:
                self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1
        return v

    def huffman(self, table: dict[tuple[int, int], int]) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bits(1)
            sym = table.get((length, code))
            if sym is not None:
                return sym
        raise JpegEntropyError("invalid Huffman code")

    def align_and_skip_restart(self) -> None:
        """Byte-align and consume an RSTn marker (between DRI intervals)."""
        self.acc = 0
        self.nbits = 0
        d = self.data
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1


def _extend(v: int, t: int) -> int:
    return v - ((1 << t) - 1) if v < (1 << (t - 1)) else v


def decode_scan(scan: bytes, width: int, height: int, jtype: int,
                restart_interval: int = 0) -> list[np.ndarray]:
    """Entropy-decode a baseline scan → per-component zigzag level arrays.

    Returns ``[Y, Cb, Cr]`` where Y is ``[4*n_mcus or 2*n_mcus, 64]`` and
    Cb/Cr are ``[n_mcus, 64]`` int16 (type 1 = 4:2:0, type 0 = 4:2:2)."""
    jt = jtype & 1
    comps = _MCU_COMPS[jt]
    gw, gh = mcu_grid(width, height, jt)
    n_mcus = gw * gh
    n_y = comps.count(0)
    out = [np.zeros((n_mcus * n_y, 64), np.int16),
           np.zeros((n_mcus, 64), np.int16),
           np.zeros((n_mcus, 64), np.int16)]
    idx = [0, 0, 0]
    pred = [0, 0, 0]
    r = _BitReader(scan)
    for mcu in range(n_mcus):
        if restart_interval and mcu and mcu % restart_interval == 0:
            r.align_and_skip_restart()
            pred = [0, 0, 0]
        for comp in comps:
            dc_tab, ac_tab = _DECODE_TABLES[comp]
            blk = out[comp][idx[comp]]
            idx[comp] += 1
            t = r.huffman(dc_tab)
            diff = _extend(r.bits(t), t) if t else 0
            pred[comp] += diff
            blk[0] = pred[comp]
            k = 1
            while k < 64:
                rs = r.huffman(ac_tab)
                rl, size = rs >> 4, rs & 0xF
                if rs == 0x00:              # EOB
                    break
                if rs == 0xF0:              # ZRL
                    k += 16
                    continue
                k += rl
                if k > 63:
                    raise JpegEntropyError("AC run past block end")
                blk[k] = _extend(r.bits(size), size)
                k += 1
    return out


class _BitWriter:
    __slots__ = ("out", "acc", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, v: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)       # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            pad = 8 - self.nbits
            self.bits((1 << pad) - 1, pad)  # pad with 1s
        return bytes(self.out)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def encode_scan(levels: list[np.ndarray], jtype: int) -> bytes:
    """Per-component zigzag level arrays → entropy-coded scan bytes
    (standard tables, no restart markers)."""
    jt = jtype & 1
    comps = _MCU_COMPS[jt]
    n_mcus = len(levels[1])
    idx = [0, 0, 0]
    pred = [0, 0, 0]
    w = _BitWriter()
    for _mcu in range(n_mcus):
        for comp in comps:
            dc_enc, ac_enc = _ENCODE_TABLES[comp]
            blk = levels[comp][idx[comp]]
            idx[comp] += 1
            dc = int(blk[0])
            diff = dc - pred[comp]
            pred[comp] = dc
            t = _category(diff)
            code, nb = dc_enc[t]
            w.bits(code, nb)
            if t:
                w.bits(diff if diff >= 0 else diff + (1 << t) - 1, t)
            # AC: run-length of zeros + category
            last_nz = 63
            while last_nz > 0 and blk[last_nz] == 0:
                last_nz -= 1
            k = 1
            while k <= last_nz:
                run = 0
                while blk[k] == 0:
                    run += 1
                    k += 1
                while run >= 16:
                    code, nb = ac_enc[0xF0]
                    w.bits(code, nb)        # ZRL
                    run -= 16
                v = int(blk[k])
                s = _category(v)
                code, nb = ac_enc[(run << 4) | s]
                w.bits(code, nb)
                w.bits(v if v >= 0 else v + (1 << s) - 1, s)
                k += 1
            if last_nz < 63:
                code, nb = ac_enc[0x00]
                w.bits(code, nb)            # EOB
    return w.flush()
