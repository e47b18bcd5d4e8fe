"""Erasure-coded storage of finalized DVR assets: ``k`` data + ``m``
parity window shards a stripe.  ``codec`` holds the GF(256) stripe math
(B4 on the device, checked against the host product, and the Gaussian
reconstruct); ``service`` holds the node's shard store, scrub and
repair."""

from .codec import StorageError, StripeCodec
from .service import (MANIFEST_VERSION, SHARD_KEY_PREFIX, StorageService,
                      shard_key, shard_name)

__all__ = ["StorageError", "StripeCodec", "StorageService",
           "SHARD_KEY_PREFIX", "MANIFEST_VERSION", "shard_key",
           "shard_name"]
