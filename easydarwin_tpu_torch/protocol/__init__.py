"""Wire protocols the live relay path needs: RTP, RTCP, x-RTP-Meta-Info,
H.264/MJPEG payload classification, SDP and RTSP (trimmed copies of the
reference's host code)."""
