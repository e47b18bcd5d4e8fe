"""Generate easydarwin_tpu_torch/csrc/h264_tables.h from the port's
Python CAVLC/CABAC/transform tables: one source of truth, so the native
walk (csrc/h264_walk.cpp) never drifts from the Python path's spec
tables.  Run: python tools/gen_h264_tables_torch.py (the generated
header is committed; regenerate after a table changes)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from easydarwin_tpu_torch.codecs import h264_cavlc as cavlc  # noqa: E402
from easydarwin_tpu_torch.codecs import h264_transform as ht  # noqa: E402
from easydarwin_tpu_torch.codecs.h264_intra import (  # noqa: E402
    CBP_INTER_FROM_CODE, CBP_INTRA_FROM_CODE)
from easydarwin_tpu_torch.codecs import h264_cabac_tables as ct  # noqa: E402

HEADER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "easydarwin_tpu_torch", "csrc",
    "h264_tables.h")


def emit():
    out = ["// GENERATED by tools/gen_h264_tables_torch.py from",
           "// easydarwin_tpu_torch/codecs/h264_cavlc.py — do not edit.",
           "#pragma once", "#include <stdint.h>", ""]
    # coeff_token: [cls][tc][t1] = (bits << 24) | value  (0 = absent)
    out.append("static const uint32_t kCoeffToken[3][17][4] = {")
    for table in cavlc._CT_TABLES:
        rows = []
        for tc in range(17):
            cells = []
            for t1 in range(4):
                e = table.get((tc, t1))
                cells.append("0" if e is None else
                             f"0x{(e[0] << 24) | e[1]:08X}")
            rows.append("{" + ", ".join(cells) + "}")
        out.append("  {" + ",\n   ".join(rows) + "},")
    out.append("};\n")
    # total_zeros: [tc-1][tz] = (bits << 24) | value
    out.append("static const uint32_t kTotalZeros[15][16] = {")
    for row in cavlc._TZ:
        cells = [f"0x{(n << 24) | v:08X}" for n, v in row]
        cells += ["0"] * (16 - len(cells))
        out.append("  {" + ", ".join(cells) + "},")
    out.append("};\n")
    # run_before: [min(zl,7)-1][run] = (bits << 24) | value
    out.append("static const uint32_t kRunBefore[7][7] = {")
    for row in cavlc._RB:
        cells = [f"0x{(n << 24) | v:08X}" for n, v in row]
        cells += ["0"] * (7 - len(cells))
        out.append("  {" + ", ".join(cells) + "},")
    out.append("};\n")
    out.append("static const uint8_t kCbpIntraFromCode[48] = {")
    out.append("  " + ", ".join(str(v) for v in CBP_INTRA_FROM_CODE))
    out.append("};\n")
    inv = [0] * 48
    for code, cbp in enumerate(CBP_INTRA_FROM_CODE):
        inv[cbp] = code
    out.append("static const uint8_t kCbpIntraToCode[48] = {")
    out.append("  " + ", ".join(str(v) for v in inv))
    out.append("};\n")
    out.append("static const uint8_t kCbpInterFromCode[48] = {")
    out.append("  " + ", ".join(str(v) for v in CBP_INTER_FROM_CODE))
    out.append("};\n")
    inv = [0] * 48
    for code, cbp in enumerate(CBP_INTER_FROM_CODE):
        inv[cbp] = code
    out.append("static const uint8_t kCbpInterToCode[48] = {")
    out.append("  " + ", ".join(str(v) for v in inv))
    out.append("};\n")
    # chroma DC (4:2:0, nC == -1): coeff_token Table 9-5 column +
    # total_zeros Table 9-9(a)
    out.append("static const uint32_t kCoeffTokenCdc[5][4] = {")
    for tc in range(5):
        cells = []
        for t1 in range(4):
            e = cavlc._CT_CDC.get((tc, t1))
            cells.append("0" if e is None else
                         f"0x{(e[0] << 24) | e[1]:08X}")
        out.append("  {" + ", ".join(cells) + "},")
    out.append("};\n")
    out.append("static const uint32_t kTotalZerosCdc[3][4] = {")
    for row in cavlc._TZ_CDC:
        cells = [f"0x{(n << 24) | v:08X}" for n, v in row]
        cells += ["0"] * (4 - len(cells))
        out.append("  {" + ", ".join(cells) + "},")
    out.append("};\n")
    # chroma requant constants (h264_transform is the source of truth)
    out.append("static const int32_t kChromaQp[52] = {")
    out.append("  " + ", ".join(str(int(v)) for v in ht.CHROMA_QP))
    out.append("};\n")
    out.append("static const int32_t kVPos[6][16] = {")
    for m in range(6):
        out.append("  {" + ", ".join(str(int(v))
                                     for v in ht.v_position(m)) + "},")
    out.append("};\n")
    out.append("static const int32_t kMFPos[6][16] = {")
    for m in range(6):
        out.append("  {" + ", ".join(str(int(v))
                                     for v in ht.mf_position(m)) + "},")
    out.append("};\n")
    out.append("static const int32_t kZigzag4[16] = {")
    out.append("  " + ", ".join(str(int(v)) for v in ht.ZIGZAG4))
    out.append("};\n")
    # CABAC constants (codecs/h264_cabac_tables.py is the source of
    # truth)
    out.append("static const int8_t kCabacCtxInitI[1024][2] = {")
    for i in range(0, 1024, 6):
        out.append("  " + " ".join(
            "{%d, %d}," % (ct.CTX_INIT_I[2 * j], ct.CTX_INIT_I[2 * j + 1])
            for j in range(i, min(i + 6, 1024))))
    out.append("};\n")
    for t, tbl in enumerate((ct.CTX_INIT_P0, ct.CTX_INIT_P1,
                             ct.CTX_INIT_P2)):
        out.append(f"static const int8_t kCabacCtxInitP{t}[1024][2] = {{")
        for i in range(0, 1024, 6):
            out.append("  " + " ".join(
                "{%d, %d}," % (tbl[2 * j], tbl[2 * j + 1])
                for j in range(i, min(i + 6, 1024))))
        out.append("};\n")
    out.append("static const int8_t (*const kCabacCtxInitP[3])[2] = {")
    out.append("  kCabacCtxInitP0, kCabacCtxInitP1, kCabacCtxInitP2};\n")
    out.append("static const uint8_t kCabacRangeLps[64][4] = {")
    for pp in range(64):
        out.append("  {" + ", ".join(
            str(ct.RANGE_LPS[4 * pp + q]) for q in range(4)) + "},")
    out.append("};\n")
    out.append("static const uint8_t kCabacTransMps[64] = {")
    out.append("  " + ", ".join(str(v) for v in ct.TRANS_IDX_MPS))
    out.append("};\n")
    out.append("static const uint8_t kCabacTransLps[64] = {")
    out.append("  " + ", ".join(str(v) for v in ct.TRANS_IDX_LPS))
    out.append("};\n")
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    with open(HEADER, "w", encoding="utf-8") as f:
        f.write(emit())
    print(f"wrote {HEADER}")
