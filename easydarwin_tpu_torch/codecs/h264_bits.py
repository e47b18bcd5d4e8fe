"""H.264 bitstream primitives: MSB-first bit I/O, Exp-Golomb codes, and
RBSP ⇄ NAL emulation-prevention (03) handling.  A copy of the
reference's ``codecs/h264_bits.py`` (pure Python)."""

from __future__ import annotations


class BitReader:
    """MSB-first reader over bytes (RBSP payload, no emulation bytes)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                    # bit position
        self._stop_bit: int | None = None   # cached rbsp_stop_one_bit pos

    @property
    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    def read_bit(self) -> int:
        if self.pos >= len(self.data) * 8:
            raise EOFError("past end of RBSP")
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def peek_bits(self, n: int) -> int:
        """Up to ``n`` bits without consuming; short reads near the end
        are zero-padded (VLC peek convenience)."""
        save = self.pos
        v = 0
        got = 0
        try:
            for _ in range(n):
                v = (v << 1) | self.read_bit()
                got += 1
        except EOFError:
            v <<= (n - got)
        self.pos = save
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def ue(self) -> int:
        """Unsigned Exp-Golomb."""
        zeros = 0
        while self.read_bit() == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad ue(v)")
        return (1 << zeros) - 1 + (self.read_bits(zeros) if zeros else 0)

    def se(self) -> int:
        """Signed Exp-Golomb."""
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0

    def more_rbsp_data(self) -> bool:
        """True while data before the rbsp_stop_one_bit remains (the stop
        bit is the LAST set bit of the RBSP; its position is found once
        and cached — the multi-slice MB walk queries this per MB)."""
        if self._stop_bit is None:
            self._stop_bit = -1
            for i in range(len(self.data) - 1, -1, -1):
                b = self.data[i]
                if b:
                    low = b & -b                     # lowest set bit
                    self._stop_bit = i * 8 + 7 - low.bit_length() + 1
                    break
        return self.pos < self._stop_bit


class BitWriter:
    """MSB-first writer."""

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    @property
    def bit_length(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def write_bit(self, b: int) -> None:
        self._cur = (self._cur << 1) | (b & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def ue(self, v: int) -> None:
        if v < 0:
            raise ValueError("ue(v) needs v >= 0")
        k = v + 1
        n = k.bit_length()
        self.write_bits(0, n - 1)
        self.write_bits(k, n)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp_trailing(self) -> None:
        """rbsp_stop_one_bit + alignment zeros."""
        self.write_bit(1)
        while self._nbits:
            self.write_bit(0)

    def to_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("unaligned bitstream (call rbsp_trailing)")
        return bytes(self._bytes)


def nal_to_rbsp(nal_payload: bytes) -> bytes:
    """Strip emulation-prevention bytes (00 00 03 xx → 00 00 xx)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(nal_payload)
    while i < n:
        b = nal_payload[i]
        if zeros >= 2 and b == 0x03 and i + 1 < n \
                and nal_payload[i + 1] <= 0x03:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def rbsp_to_nal(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes where 00 00 0[0-3] occurs."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 0x03:
            out.append(0x03)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)
