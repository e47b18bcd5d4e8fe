"""Erasure-coded storage: the GF(256) stripe codec (``codec.StripeCodec``)
on the FEC tier's parity pass."""
