"""Host-side helpers: synthetic RTP traffic made from a seed."""
