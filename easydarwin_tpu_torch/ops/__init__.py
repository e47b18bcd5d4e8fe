"""Device tier: plain PyTorch functions on tensors and the CUDA kernels
beside them.

    parse.parse_packets          RTP fixed header + H.264/MJPEG classify
    parse_kernel                 K1 on the card (``ed_parse_packets``)
    gop.newest_keyframe          IDR bookmark scan
    fanout.relay_affine_step_windows
                                 the megabatch window pass over a wake's
                                 buckets; on the card one launch of the
                                 fused kernel ``ed_relay_window``
    staging.gather_window        host packing of ring windows into rows
    transform                    DCT/quant/zigzag/downscale math of the
                                 transcode ladder; ``decode_blocks`` is K2
    transform_kernel             K2 on the card (``ed_decode_blocks``)

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; on a CUDA tensor it never falls back.
"""
