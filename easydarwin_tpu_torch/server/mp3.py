"""MP3 over icy (Shoutcast-style) HTTP on the RTSP port.

An HTTP GET of an ``.mp3`` path under the movie folder answers an icy
stream paced at the file's bitrate, with ``icy-metaint`` StreamTitle
blocks when the client sent ``Icy-MetaData: 1``.  The title comes from
the file's ID3v2 TIT2/TPE1 frames (``Artist - Title``), else the file
name.  A GET of ``<dir>.m3u`` answers an ``audio/x-mpegurl`` listing of
the directory's ``.mp3`` files.  Every path is confined under the movie
folder (``utils.paths.under_root``).
"""

from __future__ import annotations

import asyncio
import os

from ..utils.paths import under_root

#: MPEG1 Layer III bitrate table (kbps), index 1..14
_BITRATES = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
             320, 0)
_SAMPLE_RATES = (44100, 48000, 32000, 0)

#: audio bytes between two metadata blocks
META_INT = 8192
#: bytes read a pacing step
CHUNK = 4096


def parse_id3_title(data: bytes) -> str | None:
    """ID3v2.3/2.4 TIT2 (+TPE1) → ``Artist - Title`` (None = no tag).

    Latin-1, UTF-16 with BOM, UTF-16BE and UTF-8 text, syncsafe v2.4
    frame sizes; anything malformed gives None (the caller falls back to
    the file name)."""
    if len(data) < 10 or data[:3] != b"ID3":
        return None
    ver = data[3]
    tag_size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) | \
        ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
    end = min(10 + tag_size, len(data))
    pos = 10
    fields: dict[str, str] = {}
    while pos + 10 <= end:
        fid = data[pos:pos + 4]
        if not fid.strip(b"\x00"):
            break
        raw = data[pos + 4:pos + 8]
        if ver >= 4:                     # v2.4: syncsafe frame size
            fsize = ((raw[0] & 0x7F) << 21) | ((raw[1] & 0x7F) << 14) | \
                ((raw[2] & 0x7F) << 7) | (raw[3] & 0x7F)
        else:
            fsize = int.from_bytes(raw, "big")
        body = data[pos + 10:pos + 10 + fsize]
        pos += 10 + fsize
        if fid not in (b"TIT2", b"TPE1") or not body:
            continue
        enc, text = body[0], body[1:]
        try:
            if enc == 0:
                val = text.decode("latin-1")
            elif enc == 1:
                val = text.decode("utf-16")
            elif enc == 2:
                val = text.decode("utf-16-be")
            else:
                val = text.decode("utf-8")
        except UnicodeDecodeError:
            continue
        fields[fid.decode()] = val.rstrip("\x00").strip()
    title = fields.get("TIT2")
    if not title:
        return None
    artist = fields.get("TPE1")
    return f"{artist} - {title}" if artist else title


def parse_mp3_bitrate(data: bytes) -> int:
    """The first MPEG1 Layer III frame header's bitrate in kbps (128 when
    there is none)."""
    for i in range(len(data) - 4):
        b0, b1, b2 = data[i], data[i + 1], data[i + 2]
        if b0 == 0xFF and (b1 & 0xE0) == 0xE0:
            version = (b1 >> 3) & 0x03
            layer = (b1 >> 1) & 0x03
            if version == 3 and layer == 1:          # MPEG1 Layer III
                bi = (b2 >> 4) & 0x0F
                sr = _SAMPLE_RATES[(b2 >> 2) & 0x03]
                if 0 < bi < 15 and sr:
                    return _BITRATES[bi]
    return 128


def meta_block(title: str) -> bytes:
    """One icy metadata block: a length byte (16-byte units) and the
    ``StreamTitle`` text padded with NULs to that length."""
    text = f"StreamTitle='{title}';".encode()
    pad = (-len(text)) % 16
    return bytes(((len(text) + pad) // 16,)) + text + b"\x00" * pad


def interleave_meta(chunk: bytes, meta: bytes, since: int) -> tuple[bytes, int]:
    """``chunk`` with ``meta`` after every ``META_INT``-th audio byte,
    counting ``since`` bytes already sent after the last block; returns
    the bytes and the new count."""
    out = bytearray()
    pos = 0
    while pos < len(chunk):
        take = min(META_INT - since, len(chunk) - pos)
        out += chunk[pos:pos + take]
        pos += take
        since += take
        if since == META_INT:
            out += meta
            since = 0
    return bytes(out), since


class Mp3Service:
    def __init__(self, movie_folder: str):
        self.movie_folder = movie_folder
        #: icy streams started, and audio bytes written to them
        self.streams_served = 0
        self.bytes_served = 0

    def playlist(self, path: str) -> str | None:
        """``/dir`` or ``/dir.m3u`` → an m3u listing of the directory's
        .mp3 files; None when it is not a directory under the folder."""
        rel = path.lstrip("/")
        if rel.lower().endswith(".m3u"):
            rel = rel[:-4]
        cand = os.path.normpath(os.path.join(self.movie_folder, rel))
        root = os.path.normpath(self.movie_folder)
        if not os.path.isdir(cand) or not under_root(self.movie_folder,
                                                     cand):
            return None
        names = sorted(n for n in os.listdir(cand)
                       if n.lower().endswith(".mp3"))
        base = "/" + os.path.relpath(cand, root).replace(os.sep, "/")
        if base == "/.":
            base = ""
        lines = ["#EXTM3U"]
        for n in names:
            with open(os.path.join(cand, n), "rb") as f:
                title = parse_id3_title(f.read(128 * 1024)) \
                    or os.path.splitext(n)[0]
            lines.append(f"#EXTINF:-1,{title}")
            lines.append(f"{base}/{n}")
        return "\n".join(lines) + "\n"

    def resolve(self, path: str) -> str | None:
        if not path.lower().endswith(".mp3"):
            return None
        cand = os.path.normpath(
            os.path.join(self.movie_folder, path.lstrip("/")))
        if not os.path.isfile(cand) \
                or not under_root(self.movie_folder, cand):
            return None
        return cand

    async def stream(self, writer: asyncio.StreamWriter, path: str,
                     headers: dict, *, pace: bool = True) -> None:
        """Write the icy response, then the file paced at its bitrate,
        until its end or the client leaves."""
        fp = self.resolve(path)
        if fp is None:
            writer.write(b"HTTP/1.0 404 Not Found\r\n\r\n")
            return
        want_meta = headers.get("icy-metadata", "0").strip() == "1"
        with open(fp, "rb") as probe:
            head_bytes = probe.read(128 * 1024)
        title = parse_id3_title(head_bytes) \
            or os.path.splitext(os.path.basename(fp))[0]
        head = ["ICY 200 OK", "icy-name: easydarwin-tpu",
                "Content-Type: audio/mpeg", "icy-pub: 0"]
        if want_meta:
            head.append(f"icy-metaint:{META_INT}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        self.streams_served += 1
        bytes_per_sec = parse_mp3_bitrate(head_bytes[:CHUNK]) * 1000 // 8
        meta = meta_block(title) if want_meta else b""
        since = 0
        with open(fp, "rb") as f:
            while chunk := f.read(CHUNK):
                if want_meta:
                    out, since = interleave_meta(chunk, meta, since)
                    writer.write(out)
                else:
                    writer.write(chunk)
                self.bytes_served += len(chunk)
                try:
                    await writer.drain()
                except ConnectionError:
                    return
                if pace:
                    await asyncio.sleep(len(chunk) / bytes_per_sec)
