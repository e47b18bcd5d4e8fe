"""HLS tier: the live fMP4 segmenter with its temporal rungs, the H.264
requant ladder (B6 on the server's device), and the service the REST
layer serves ``/hls/`` from."""

from .segmenter import HlsOutput, HlsService  # noqa: F401
