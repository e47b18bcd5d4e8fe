"""VOD tier: MP4 reading and writing, RTP packetization, paced file
sessions, the card-resident segment cache and the recorder.

Modules:

* ``mp4``         box parser → ``Mp4File`` with flat per-track sample
                  tables (stsd/stts/stsc/stsz/stco/stss/ctts).
* ``mp4_writer``  a faststart-free muxer (ftyp+mdat+moov) for recording
                  and test fixtures.
* ``packetizer``  sample → RTP: H.264 AVCC → single NAL / FU-A (RFC 6184),
                  AAC → mpeg4-generic (RFC 3640), hint-track samples, and
                  the file's DESCRIBE SDP.
* ``depacketize`` RTP → H.264 access units (the recorder's input).
* ``record``      live relay → MP4 (``RecorderOutput``, ``RecordingManager``).
* ``cache``       ``SegmentCache``: packed fixed-slot windows, an LRU over
                  host and card bytes, rows resident on the card.
* ``session``     ``FileSession`` (the cold path) and ``PacedVodSession``/
                  ``VodPacerGroup`` (cache-fed relay streams served through
                  the live megabatch engine, joins primed on the card).
"""

from .cache import SegmentCache  # noqa: F401
from .mp4 import Mp4File  # noqa: F401
from .session import FileSession, PacedVodSession, VodPacerGroup  # noqa: F401
