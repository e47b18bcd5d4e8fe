"""Host-side codec tier: the H.264 4×4 integer transform and QP
quantization (``h264_transform``), the scalar oracles of the device
requant (``ops.transform.h264_requant`` and ``h264_requant_chroma``)."""
