"""Wire protocols the live relay path needs: RTP, H.264/MJPEG payload
classification, SDP and RTSP (trimmed copies of the reference's host code)."""
