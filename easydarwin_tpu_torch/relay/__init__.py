"""The live relay: packet rings, subscriber outputs, per-track streams,
sessions, the fan-out engine and the cross-stream megabatch scheduler."""
