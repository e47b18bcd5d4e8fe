"""Host-side codec tier of the H.264 ladder: bitstream I/O
(``h264_bits``), CAVLC and CABAC entropy coding, the intra encoder and
the I/P slice model (``h264_intra``), the integer transform and QP
quantization (``h264_transform``, the scalar oracles of B6), and the
transform-domain requant pipeline (``h264_requant``: parse → B6 on the
device → recode)."""
