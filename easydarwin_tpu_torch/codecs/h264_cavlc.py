"""H.264 CAVLC residual coding (baseline profile, 4×4 luma blocks).

Both directions: the HLS requant rung decodes every residual block,
requantizes the levels on the device (B6), and re-encodes at the new
QP.  Tables are the spec's (ITU-T H.264 Tables 9-5, 9-7/9-8, 9-10).
``nC == -1`` selects the 4:2:0 chroma-DC column of Table 9-5 (with Table
9-9(a) total_zeros) so the rung covers chroma residuals too.  A copy of
the reference's ``codecs/h264_cavlc.py``."""

from __future__ import annotations

from .h264_bits import BitReader, BitWriter

# --------------------------------------------------------------- coeff_token
# {(total_coeff, trailing_ones): (n_bits, value)} per nC class.
_CT_NC0 = {   # 0 <= nC < 2
    (0, 0): (1, 0b1),
    (1, 0): (6, 0b000101), (1, 1): (2, 0b01),
    (2, 0): (8, 0b00000111), (2, 1): (6, 0b000100), (2, 2): (3, 0b001),
    (3, 0): (9, 0b000000111), (3, 1): (8, 0b00000110),
    (3, 2): (7, 0b0000101), (3, 3): (5, 0b00011),
    (4, 0): (10, 0b0000000111), (4, 1): (9, 0b000000110),
    (4, 2): (8, 0b00000101), (4, 3): (6, 0b000011),
    (5, 0): (11, 0b00000000111), (5, 1): (10, 0b0000000110),
    (5, 2): (9, 0b000000101), (5, 3): (7, 0b0000100),
    (6, 0): (13, 0b0000000001111), (6, 1): (11, 0b00000000110),
    (6, 2): (10, 0b0000000101), (6, 3): (8, 0b00000100),
    (7, 0): (13, 0b0000000001011), (7, 1): (13, 0b0000000001110),
    (7, 2): (11, 0b00000000101), (7, 3): (9, 0b000000100),
    (8, 0): (13, 0b0000000001000), (8, 1): (13, 0b0000000001010),
    (8, 2): (13, 0b0000000001101), (8, 3): (10, 0b0000000100),
    (9, 0): (14, 0b00000000001111), (9, 1): (14, 0b00000000001110),
    (9, 2): (13, 0b0000000001001), (9, 3): (11, 0b00000000100),
    (10, 0): (14, 0b00000000001011), (10, 1): (14, 0b00000000001010),
    (10, 2): (14, 0b00000000001101), (10, 3): (13, 0b0000000001100),
    (11, 0): (15, 0b000000000001111), (11, 1): (15, 0b000000000001110),
    (11, 2): (14, 0b00000000001001), (11, 3): (14, 0b00000000001100),
    (12, 0): (15, 0b000000000001011), (12, 1): (15, 0b000000000001010),
    (12, 2): (15, 0b000000000001101), (12, 3): (14, 0b00000000001000),
    (13, 0): (16, 0b0000000000001111), (13, 1): (15, 0b000000000000001),
    (13, 2): (15, 0b000000000001001), (13, 3): (15, 0b000000000001100),
    (14, 0): (16, 0b0000000000001011), (14, 1): (16, 0b0000000000001110),
    (14, 2): (16, 0b0000000000001101), (14, 3): (15, 0b000000000001000),
    (15, 0): (16, 0b0000000000000111), (15, 1): (16, 0b0000000000001010),
    (15, 2): (16, 0b0000000000001001), (15, 3): (16, 0b0000000000001100),
    (16, 0): (16, 0b0000000000000100), (16, 1): (16, 0b0000000000000110),
    (16, 2): (16, 0b0000000000000101), (16, 3): (16, 0b0000000000001000),
}
_CT_NC2 = {   # 2 <= nC < 4
    (0, 0): (2, 0b11),
    (1, 0): (6, 0b001011), (1, 1): (2, 0b10),
    (2, 0): (6, 0b000111), (2, 1): (5, 0b00111), (2, 2): (3, 0b011),
    (3, 0): (7, 0b0000111), (3, 1): (6, 0b001010),
    (3, 2): (6, 0b001001), (3, 3): (4, 0b0101),
    (4, 0): (8, 0b00000111), (4, 1): (6, 0b000110),
    (4, 2): (6, 0b000101), (4, 3): (4, 0b0100),
    (5, 0): (8, 0b00000100), (5, 1): (7, 0b0000110),
    (5, 2): (7, 0b0000101), (5, 3): (5, 0b00110),
    (6, 0): (9, 0b000000111), (6, 1): (8, 0b00000110),
    (6, 2): (8, 0b00000101), (6, 3): (6, 0b001000),
    (7, 0): (11, 0b00000001111), (7, 1): (9, 0b000000110),
    (7, 2): (9, 0b000000101), (7, 3): (6, 0b000100),
    (8, 0): (11, 0b00000001011), (8, 1): (11, 0b00000001110),
    (8, 2): (11, 0b00000001101), (8, 3): (7, 0b0000100),
    (9, 0): (12, 0b000000001111), (9, 1): (11, 0b00000001010),
    (9, 2): (11, 0b00000001001), (9, 3): (9, 0b000000100),
    (10, 0): (12, 0b000000001011), (10, 1): (12, 0b000000001110),
    (10, 2): (12, 0b000000001101), (10, 3): (11, 0b00000001100),
    (11, 0): (12, 0b000000001000), (11, 1): (12, 0b000000001010),
    (11, 2): (12, 0b000000001001), (11, 3): (11, 0b00000001000),
    (12, 0): (13, 0b0000000001111), (12, 1): (13, 0b0000000001110),
    (12, 2): (13, 0b0000000001101), (12, 3): (12, 0b000000001100),
    (13, 0): (13, 0b0000000001011), (13, 1): (13, 0b0000000001010),
    (13, 2): (13, 0b0000000001001), (13, 3): (13, 0b0000000001100),
    (14, 0): (13, 0b0000000000111), (14, 1): (14, 0b00000000001011),
    (14, 2): (13, 0b0000000000110), (14, 3): (13, 0b0000000001000),
    (15, 0): (14, 0b00000000001001), (15, 1): (14, 0b00000000001000),
    (15, 2): (14, 0b00000000001010), (15, 3): (13, 0b0000000000001),
    (16, 0): (14, 0b00000000000111), (16, 1): (14, 0b00000000000110),
    (16, 2): (14, 0b00000000000101), (16, 3): (14, 0b00000000000100),
}
_CT_NC4 = {   # 4 <= nC < 8
    (0, 0): (4, 0b1111),
    (1, 0): (6, 0b001111), (1, 1): (4, 0b1110),
    (2, 0): (6, 0b001011), (2, 1): (5, 0b01111), (2, 2): (4, 0b1101),
    (3, 0): (6, 0b001000), (3, 1): (5, 0b01100),
    (3, 2): (5, 0b01110), (3, 3): (4, 0b1100),
    (4, 0): (7, 0b0001111), (4, 1): (5, 0b01010),
    (4, 2): (5, 0b01011), (4, 3): (4, 0b1011),
    (5, 0): (7, 0b0001011), (5, 1): (5, 0b01000),
    (5, 2): (5, 0b01001), (5, 3): (4, 0b1010),
    (6, 0): (7, 0b0001001), (6, 1): (6, 0b001110),
    (6, 2): (6, 0b001101), (6, 3): (4, 0b1001),
    (7, 0): (7, 0b0001000), (7, 1): (6, 0b001010),
    (7, 2): (6, 0b001001), (7, 3): (4, 0b1000),
    (8, 0): (8, 0b00001111), (8, 1): (7, 0b0001110),
    (8, 2): (7, 0b0001101), (8, 3): (5, 0b01101),
    (9, 0): (8, 0b00001011), (9, 1): (8, 0b00001110),
    (9, 2): (7, 0b0001010), (9, 3): (6, 0b001100),
    (10, 0): (9, 0b000001111), (10, 1): (8, 0b00001010),
    (10, 2): (8, 0b00001101), (10, 3): (7, 0b0001100),
    (11, 0): (9, 0b000001011), (11, 1): (9, 0b000001110),
    (11, 2): (8, 0b00001001), (11, 3): (8, 0b00001100),
    (12, 0): (9, 0b000001000), (12, 1): (9, 0b000001010),
    (12, 2): (9, 0b000001101), (12, 3): (8, 0b00001000),
    (13, 0): (10, 0b0000001101), (13, 1): (9, 0b000000111),
    (13, 2): (9, 0b000001001), (13, 3): (9, 0b000001100),
    (14, 0): (10, 0b0000001001), (14, 1): (10, 0b0000001100),
    (14, 2): (10, 0b0000001011), (14, 3): (10, 0b0000001010),
    (15, 0): (10, 0b0000000101), (15, 1): (10, 0b0000001000),
    (15, 2): (10, 0b0000000111), (15, 3): (10, 0b0000000110),
    (16, 0): (10, 0b0000000001), (16, 1): (10, 0b0000000100),
    (16, 2): (10, 0b0000000011), (16, 3): (10, 0b0000000010),
}


#: Table 9-5's nC == −1 column: chroma DC (4:2:0, maxNumCoeff 4).
_CT_CDC = {
    (0, 0): (2, 0b01),
    (1, 0): (6, 0b000111), (1, 1): (1, 0b1),
    (2, 0): (6, 0b000100), (2, 1): (6, 0b000110), (2, 2): (3, 0b001),
    (3, 0): (6, 0b000011), (3, 1): (7, 0b0000011),
    (3, 2): (7, 0b0000010), (3, 3): (6, 0b000101),
    (4, 0): (6, 0b000010), (4, 1): (8, 0b00000011),
    (4, 2): (8, 0b00000010), (4, 3): (7, 0b0000000),
}


def _invert(table):
    return {(n, v): key for key, (n, v) in table.items()}


_CT_TABLES = (_CT_NC0, _CT_NC2, _CT_NC4)
_CT_DECODE = tuple(_invert(t) for t in _CT_TABLES)
_CT_CDC_DECODE = _invert(_CT_CDC)


def _ct_class(nC: int) -> int:
    if nC < 2:
        return 0
    if nC < 4:
        return 1
    if nC < 8:
        return 2
    return 3          # 6-bit FLC


def write_coeff_token(bw: BitWriter, nC: int, total: int, t1s: int) -> None:
    if nC < 0:                          # chroma DC (4:2:0)
        n, v = _CT_CDC[(total, t1s)]
        bw.write_bits(v, n)
        return
    cls = _ct_class(nC)
    if cls == 3:
        v = 0b000011 if total == 0 else (((total - 1) << 2) | t1s)
        bw.write_bits(v, 6)
        return
    n, v = _CT_TABLES[cls][(total, t1s)]
    bw.write_bits(v, n)


def read_coeff_token(br: BitReader, nC: int) -> tuple[int, int]:
    if nC < 0:
        table = _CT_CDC_DECODE
        max_bits = 8
    else:
        cls = _ct_class(nC)
        if cls == 3:
            v = br.read_bits(6)
            if v == 0b000011:
                return 0, 0
            return (v >> 2) + 1, v & 3
        table = _CT_DECODE[cls]
        max_bits = 17
    n = 0
    v = 0
    while n < max_bits:
        v = (v << 1) | br.read_bit()
        n += 1
        hit = table.get((n, v))
        if hit is not None:
            return hit
    raise ValueError("bad coeff_token")


# --------------------------------------------------------------- total_zeros
# Table 9-7/9-8: _TZ[total_coeff-1][total_zeros] = (bits, value)
_TZ = [
    # tc=1
    [(1, 1), (3, 0b011), (3, 0b010), (4, 0b0011), (4, 0b0010),
     (5, 0b00011), (5, 0b00010), (6, 0b000011), (6, 0b000010),
     (7, 0b0000011), (7, 0b0000010), (8, 0b00000011), (8, 0b00000010),
     (9, 0b000000011), (9, 0b000000010), (9, 0b000000001)],
    # tc=2
    [(3, 0b111), (3, 0b110), (3, 0b101), (3, 0b100), (3, 0b011),
     (4, 0b0101), (4, 0b0100), (4, 0b0011), (4, 0b0010), (5, 0b00011),
     (5, 0b00010), (6, 0b000011), (6, 0b000010), (6, 0b000001),
     (6, 0b000000)],
    # tc=3
    [(4, 0b0101), (3, 0b111), (3, 0b110), (3, 0b101), (4, 0b0100),
     (4, 0b0011), (3, 0b100), (3, 0b011), (4, 0b0010), (5, 0b00011),
     (5, 0b00010), (6, 0b000001), (5, 0b00001), (6, 0b000000)],
    # tc=4
    [(5, 0b00011), (3, 0b111), (4, 0b0101), (4, 0b0100), (3, 0b110),
     (3, 0b101), (3, 0b100), (4, 0b0011), (3, 0b011), (4, 0b0010),
     (5, 0b00010), (5, 0b00001), (5, 0b00000)],
    # tc=5
    [(4, 0b0101), (4, 0b0100), (4, 0b0011), (3, 0b111), (3, 0b110),
     (3, 0b101), (3, 0b100), (3, 0b011), (4, 0b0010), (5, 0b00001),
     (4, 0b0001), (5, 0b00000)],
    # tc=6
    [(6, 0b000001), (5, 0b00001), (3, 0b111), (3, 0b110), (3, 0b101),
     (3, 0b100), (3, 0b011), (3, 0b010), (4, 0b0001), (3, 0b001),
     (6, 0b000000)],
    # tc=7
    [(6, 0b000001), (5, 0b00001), (3, 0b101), (3, 0b100), (3, 0b011),
     (2, 0b11), (3, 0b010), (4, 0b0001), (3, 0b001), (6, 0b000000)],
    # tc=8
    [(6, 0b000001), (4, 0b0001), (5, 0b00001), (3, 0b011), (2, 0b11),
     (2, 0b10), (3, 0b010), (3, 0b001), (6, 0b000000)],
    # tc=9
    [(6, 0b000001), (6, 0b000000), (4, 0b0001), (2, 0b11), (2, 0b10),
     (3, 0b001), (2, 0b01), (5, 0b00001)],
    # tc=10
    [(5, 0b00001), (5, 0b00000), (3, 0b001), (2, 0b11), (2, 0b10),
     (2, 0b01), (4, 0b0001)],
    # tc=11
    [(4, 0b0000), (4, 0b0001), (3, 0b001), (3, 0b010), (1, 0b1),
     (3, 0b011)],
    # tc=12
    [(4, 0b0000), (4, 0b0001), (2, 0b01), (1, 0b1), (3, 0b001)],
    # tc=13
    [(3, 0b000), (3, 0b001), (1, 0b1), (2, 0b01)],
    # tc=14
    [(2, 0b00), (2, 0b01), (1, 0b1)],
    # tc=15
    [(1, 0b0), (1, 0b1)],
]
_TZ_DECODE = [{(n, v): tz for tz, (n, v) in enumerate(row)} for row in _TZ]

#: Table 9-9(a): total_zeros for chroma DC (4:2:0, maxNumCoeff 4);
#: rows are TotalCoeff 1..3 (TotalCoeff 4 ⇒ no zeros, nothing coded).
_TZ_CDC = [
    [(1, 1), (2, 0b01), (3, 0b001), (3, 0b000)],
    [(1, 1), (2, 0b01), (2, 0b00)],
    [(1, 1), (1, 0b0)],
]
_TZ_CDC_DECODE = [{(n, v): tz for tz, (n, v) in enumerate(row)}
                  for row in _TZ_CDC]


def write_total_zeros(bw: BitWriter, total_coeff: int, tz: int,
                      max_coeff: int = 16) -> None:
    row = (_TZ_CDC if max_coeff == 4 else _TZ)[total_coeff - 1]
    n, v = row[tz]
    bw.write_bits(v, n)


def read_total_zeros(br: BitReader, total_coeff: int,
                     max_coeff: int = 16) -> int:
    table = (_TZ_CDC_DECODE if max_coeff == 4
             else _TZ_DECODE)[total_coeff - 1]
    n = 0
    v = 0
    while n < 10:
        v = (v << 1) | br.read_bit()
        n += 1
        hit = table.get((n, v))
        if hit is not None:
            return hit
    raise ValueError("bad total_zeros")


# ---------------------------------------------------------------- run_before
# Table 9-10: _RB[min(zeros_left,7)-1][run] = (bits, value); zeros_left>6
# extends with unary runs 7..14.
_RB = [
    [(1, 1), (1, 0)],
    [(1, 1), (2, 0b01), (2, 0b00)],
    [(2, 0b11), (2, 0b10), (2, 0b01), (2, 0b00)],
    [(2, 0b11), (2, 0b10), (2, 0b01), (3, 0b001), (3, 0b000)],
    [(2, 0b11), (2, 0b10), (3, 0b011), (3, 0b010), (3, 0b001),
     (3, 0b000)],
    [(2, 0b11), (3, 0b000), (3, 0b001), (3, 0b011), (3, 0b010),
     (3, 0b101), (3, 0b100)],
    [(3, 0b111), (3, 0b110), (3, 0b101), (3, 0b100), (3, 0b011),
     (3, 0b010), (3, 0b001)],
]
_RB_DECODE = [{(n, v): r for r, (n, v) in enumerate(row)} for row in _RB]


def write_run_before(bw: BitWriter, zeros_left: int, run: int) -> None:
    idx = min(zeros_left, 7) - 1
    if zeros_left > 6 and run > 6:
        # unary extension: run 7 → 0001, 8 → 00001, ...
        bw.write_bits(1, run - 3)
        return
    n, v = _RB[idx][run]
    bw.write_bits(v, n)


def read_run_before(br: BitReader, zeros_left: int) -> int:
    idx = min(zeros_left, 7) - 1
    table = _RB_DECODE[idx]
    n = 0
    v = 0
    while n < 3:
        v = (v << 1) | br.read_bit()
        n += 1
        hit = table.get((n, v))
        if hit is not None:
            return hit
    if zeros_left > 6 and v == 0:
        # unary extension
        run = 6
        while br.read_bit() == 0:
            run += 1
            if run > 14:
                raise ValueError("bad run_before")
        return run + 1
    raise ValueError("bad run_before")


# ----------------------------------------------------------- residual block

def decode_residual(br: BitReader, nC: int, max_coeff: int = 16
                    ) -> list[int]:
    """One CAVLC residual block → levels in ZIGZAG order [max_coeff]."""
    total, t1s = read_coeff_token(br, nC)
    if total > max_coeff:
        raise ValueError("TotalCoeff exceeds block size")
    levels = [0] * max_coeff
    if total == 0:
        return levels
    # trailing-one signs, highest frequency first
    vals: list[int] = []
    for _ in range(t1s):
        vals.append(-1 if br.read_bit() else 1)
    suffix_len = 1 if total > 10 and t1s < 3 else 0
    for i in range(total - t1s):
        prefix = 0
        while br.read_bit() == 0:
            prefix += 1
            if prefix > 32:
                raise ValueError("bad level_prefix")
        if prefix <= 14:
            suffix_size = suffix_len
            if prefix == 14 and suffix_len == 0:
                suffix_size = 4
            level_code = (min(prefix, 15) << suffix_len) \
                + (br.read_bits(suffix_size) if suffix_size else 0)
        else:
            suffix_size = prefix - 3
            level_code = (15 << suffix_len) + br.read_bits(suffix_size)
            if suffix_len == 0:
                level_code += 15
            if prefix >= 16:
                level_code += (1 << (prefix - 3)) - 4096
        if i == 0 and t1s < 3:
            level_code += 2
        if level_code % 2 == 0:
            vals.append((level_code + 2) >> 1)
        else:
            vals.append(-((level_code + 1) >> 1))
        if suffix_len == 0:
            suffix_len = 1
        if abs(vals[-1]) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    total_zeros = 0
    if total < max_coeff:
        total_zeros = read_total_zeros(br, total, max_coeff)
    # place coefficients, highest scan position first
    zeros_left = total_zeros
    pos = total + total_zeros - 1
    for i, v in enumerate(vals):
        levels[pos] = v
        if i == len(vals) - 1:
            break
        run = read_run_before(br, zeros_left) if zeros_left > 0 else 0
        zeros_left -= run
        pos -= 1 + run
    return levels


def encode_residual(bw: BitWriter, levels: list[int], nC: int,
                    max_coeff: int = 16) -> None:
    """Levels in ZIGZAG order [max_coeff] → CAVLC bits (inverse of
    ``decode_residual``; fuzz-tested as a bijection)."""
    nz = [(i, v) for i, v in enumerate(levels[:max_coeff]) if v != 0]
    total = len(nz)
    if total == 0:
        write_coeff_token(bw, nC, 0, 0)
        return
    # trailing ones: up to 3 |v|==1 at the end of the scan
    t1s = 0
    for _, v in reversed(nz):
        if abs(v) == 1 and t1s < 3:
            t1s += 1
        else:
            break
    write_coeff_token(bw, nC, total, t1s)
    rev = list(reversed(nz))              # highest frequency first
    for _, v in rev[:t1s]:
        bw.write_bit(1 if v < 0 else 0)
    suffix_len = 1 if total > 10 and t1s < 3 else 0
    for i, (_, v) in enumerate(rev[t1s:]):
        level_code = (abs(v) - 1) * 2 + (1 if v < 0 else 0)
        if i == 0 and t1s < 3:
            level_code -= 2
        if suffix_len == 0:
            if level_code < 14:
                bw.write_bits(1, level_code + 1)          # prefix, stop 1
            elif level_code < 30:
                bw.write_bits(1, 15)                      # prefix 14
                bw.write_bits(level_code - 14, 4)
            else:
                lc = level_code - 30
                size = 12
                prefix = 15
                while lc >= (1 << size):
                    lc -= (1 << size)
                    prefix += 1
                    size += 1
                bw.write_bits(0, prefix)
                bw.write_bit(1)
                bw.write_bits(lc, size)
        else:
            if level_code < (15 << suffix_len):
                prefix = level_code >> suffix_len
                bw.write_bits(1, prefix + 1)
                bw.write_bits(level_code & ((1 << suffix_len) - 1),
                              suffix_len)
            else:
                lc = level_code - (15 << suffix_len)
                size = 12
                prefix = 15
                while lc >= (1 << size):
                    lc -= (1 << size)
                    prefix += 1
                    size += 1
                bw.write_bits(0, prefix)
                bw.write_bit(1)
                bw.write_bits(lc, size)
        if suffix_len == 0:
            suffix_len = 1
        if abs(v) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    highest = nz[-1][0]
    total_zeros = highest + 1 - total
    if total < max_coeff:
        write_total_zeros(bw, total, total_zeros, max_coeff)
    zeros_left = total_zeros
    for i in range(len(rev) - 1):
        pos = rev[i][0]
        nxt = rev[i + 1][0]
        run = pos - nxt - 1
        if zeros_left > 0:
            write_run_before(bw, zeros_left, run)
            zeros_left -= run
        # zeros_left == 0: nothing coded, runs are implicitly 0


def total_coeffs(levels: list[int]) -> int:
    return sum(1 for v in levels if v != 0)
