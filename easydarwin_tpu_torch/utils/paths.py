"""Filesystem path-confinement helpers shared by the media roots.

The VOD/MP3 tiers map request paths under a configured folder.  A
prefix ``startswith`` test over ``normpath`` output accepts two whole
classes of escapes: sibling directories sharing the prefix string
(``/srv/movies2`` passes a ``/srv/movies`` root) and symlinks inside
the root pointing outside it.  The one correct test is
``os.path.commonpath`` over ``realpath``-resolved paths.
"""

from __future__ import annotations

import os


def under_root(root: str, candidate: str) -> bool:
    """True iff ``candidate`` resolves to a path inside ``root``
    (symlinks followed on both sides; the root itself counts)."""
    root_r = os.path.realpath(root)
    cand_r = os.path.realpath(candidate)
    try:
        return os.path.commonpath([cand_r, root_r]) == root_r
    except ValueError:                  # different drives / mixed abs-rel
        return False


def confined_subpath(root: str, relative: str) -> str | None:
    """Join an untrusted ``relative`` under ``root`` and confine it:
    the normalized path, or None when it escapes (``..`` traversal,
    symlink, sibling-prefix) or resolves to the root itself.  The one
    guard shared by every surface that maps request strings to files
    (``startrecord`` targets, DVR asset directories)."""
    cand = os.path.normpath(os.path.join(root, relative.lstrip("/\\")))
    if not under_root(root, cand) \
            or os.path.realpath(cand) == os.path.realpath(root):
        return None
    return cand


__all__ = ["under_root", "confined_subpath"]
