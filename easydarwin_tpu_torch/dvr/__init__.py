"""DVR and time-shift: live ring windows spill to disk in the packed
serving format (``spill``); pause, rewind and catch-up on live streams
and replay of finished recordings are served by the shared VOD pacer
from those windows (``timeshift``), managed and wired into the server by
``service``."""

from .service import DVR_SUFFIX, DvrAsset, DvrManager  # noqa: F401
from .spill import (SpilledTrack, SpillWriter,  # noqa: F401
                    WindowRows, WindowSpiller, decode_blob, encode_blob,
                    snapshot_window)
from .timeshift import TimeShiftSession  # noqa: F401

__all__ = ["DvrManager", "DvrAsset", "DVR_SUFFIX", "SpillWriter",
           "SpilledTrack", "WindowSpiller", "WindowRows",
           "TimeShiftSession", "snapshot_window", "encode_blob",
           "decode_blob"]
