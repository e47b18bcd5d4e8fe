/* h264_walk — the native H.264 slice walk of easydarwin_tpu_torch's HLS
 * requant ladder.
 *
 * Plain C interface, compiled into the same library as egress_core.cpp
 * and bound with ctypes (never PyDLL: every call runs without the GIL) by
 * easydarwin_tpu_torch/native.py.  Two forms of one walk over a CAVLC or
 * CABAC I or P slice (I_4x4, I_16x16 with QPY >= 12, P inter types and
 * skips, 4:2:0 chroma, any first_mb_in_slice):
 *
 *  - the FUSED walk decodes, requantizes (+6k shift, Table 8-15 chroma)
 *    and re-encodes each macroblock in one pass, one rung a call;
 *  - the SPLIT walk parses a slice once into a handle that keeps its
 *    syntax, hands its residual rows out in the order and row map of
 *    codecs/h264_requant.py gather_slice (the rows B6 requantizes on the
 *    card), and writes one rung from the handle and that rung's rows.
 *
 * For every slice and rung the split's bytes equal the fused walk's.
 * Returns: -1 a feature outside the walk (the caller takes the Python
 * path), -2 a malformed bitstream (the caller passes the slice through),
 * -3 the output buffer is too small, -4 arguments that do not match the
 * handle.
 */
#ifndef EASYDARWIN_TPU_TORCH_H264_WALK_H
#define EASYDARWIN_TPU_TORCH_H264_WALK_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* The fused walk: the output NAL's length written to out, or < 0.
 * *mbs_out is the slice's macroblock count and *blocks_out the residual
 * blocks (17 an I_16x16 MB, 16 another coded MB, 8 more with chroma). */
int32_t ed_h264_requant_slice(
    const uint8_t *nal, int32_t nal_len, uint8_t *out, int32_t out_cap,
    int32_t width_mbs, int32_t height_mbs, int32_t log2_max_frame_num,
    int32_t poc_type, int32_t log2_max_poc_lsb, int32_t pic_init_qp,
    int32_t pps_id, int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t delta_qp, int32_t chroma_qp_offset,
    int32_t num_ref_l0_default, int32_t weighted_pred, int32_t *mbs_out,
    int32_t *blocks_out);

int32_t ed_h264_requant_slice_cabac(
    const uint8_t *nal, int32_t nal_len, uint8_t *out, int32_t out_cap,
    int32_t width_mbs, int32_t height_mbs, int32_t log2_max_frame_num,
    int32_t poc_type, int32_t log2_max_poc_lsb, int32_t pic_init_qp,
    int32_t pps_id, int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t delta_qp, int32_t chroma_qp_offset,
    int32_t num_ref_l0_default, int32_t weighted_pred, int32_t *mbs_out,
    int32_t *blocks_out);

/* One parsed slice: its header, every macroblock's syntax (types,
 * prediction modes, QPs, the motion syntax and skip runs verbatim) and
 * its residual levels.  Read-only after the parse, so the writes of
 * several rungs may run on one handle at once. */
typedef struct ed_h264_walk ed_h264_walk;

/* info_out fields, in order (ed_h264_walk_info_fields() of them) */
enum {
  ED_H264_WALK_ROWS = 0,      /* R: luma rows [R, 16] */
  ED_H264_WALK_CENTRIES,      /* C: macroblocks with chroma residual */
  ED_H264_WALK_BLOCKS,        /* R + 8 C */
  ED_H264_WALK_MAX_QP,        /* the largest coded MB's QPY (slice QP if none) */
  ED_H264_WALK_MBS,           /* macroblocks in the slice */
  ED_H264_WALK_QP,            /* the slice header's QPY */
  ED_H264_WALK_INFO_FIELDS
};

/* Parse one slice NAL (the fused walk's arguments but delta_qp).  0 and
 * *walk_out set, or -1 / -2 with *walk_out NULL. */
int32_t ed_h264_parse_slice(
    const uint8_t *nal, int32_t nal_len, int32_t width_mbs,
    int32_t height_mbs, int32_t log2_max_frame_num, int32_t poc_type,
    int32_t log2_max_poc_lsb, int32_t pic_init_qp, int32_t pps_id,
    int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t chroma_qp_offset, int32_t num_ref_l0_default,
    int32_t weighted_pred, ed_h264_walk **walk_out, int32_t *info_out);

int32_t ed_h264_parse_slice_cabac(
    const uint8_t *nal, int32_t nal_len, int32_t width_mbs,
    int32_t height_mbs, int32_t log2_max_frame_num, int32_t poc_type,
    int32_t log2_max_poc_lsb, int32_t pic_init_qp, int32_t pps_id,
    int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t chroma_qp_offset, int32_t num_ref_l0_default,
    int32_t weighted_pred, ed_h264_walk **walk_out, int32_t *info_out);

/* The gather into caller-owned int64 buffers: rows [R, 16], qps [R],
 * cdc [2C, 4], cac [2C, 4, 15] (Cb then Cr of each entry), cqp [C].
 * 0, or -4 on a NULL handle. */
int32_t ed_h264_walk_gather(const ed_h264_walk *walk, int64_t *rows,
                            int64_t *qps, int64_t *cdc, int64_t *cac,
                            int64_t *cqp);

/* One rung: re-encode the handle's slice delta_qp steps coarser from its
 * requantized rows (int64, the gather's shapes), recomputing CBP, nC or
 * the CABAC contexts and the QP chain.  The NAL's length, or < 0. */
int32_t ed_h264_write_slice(const ed_h264_walk *walk, int32_t delta_qp,
                            const int64_t *rows, int32_t n_rows,
                            const int64_t *cdc, const int64_t *cac,
                            int32_t n_centries, uint8_t *out,
                            int32_t out_cap);

int32_t ed_h264_write_slice_cabac(const ed_h264_walk *walk,
                                  int32_t delta_qp, const int64_t *rows,
                                  int32_t n_rows, const int64_t *cdc,
                                  const int64_t *cac, int32_t n_centries,
                                  uint8_t *out, int32_t out_cap);

void ed_h264_walk_free(ed_h264_walk *walk);

/* ED_H264_WALK_INFO_FIELDS: the count the Python bridge checks at load */
int32_t ed_h264_walk_info_fields(void);

#ifdef __cplusplus
}
#endif
#endif
