"""Reflective typed attribute store — the QTSS dictionary system.

Reference: every server object in the reference is a typed reflective
dictionary (``Server.tproj/QTSSDictionary.cpp:59`` ff.,
``QTSSDictionaryMap``): attributes carry a numeric id, a name, a
declared type and an access flag; modules and the admin module read and
write objects exclusively through get/set-by-id.  That indirection is
what made the reference's admin tree, module API and stats web UI
uniform.

This port keeps the shape but drops the C boilerplate: an
``AttrStore`` holds specs (id, name, type, writable) plus GETTERS into
live object state — values are never copied into the store, so every
read reflects the object as it is now.  ``get``/``set`` accept either
the attribute name or ``@<id>``; sets validate writability and coerce
through the declared type.  ``add_instance_attr`` is the
``QTSS_AddInstanceAttribute`` analogue: modules (or anything else) can
attach new attributes to a live object at runtime, and the admin tree
picks them up on the next query.

The admin tree (``server/admin.py``) and ``/stats`` read through these
stores, which flips SURVEY row 16 from hand-built dicts to the
reference's reflective design.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class AttrSpec:
    attr_id: int
    name: str
    type: str                           # str | int | bool | float | json
    writable: bool = False


_COERCE: dict[str, Callable[[str], Any]] = {
    "int": int,
    "float": float,
    "bool": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "str": str,
    "json": lambda v: v,
}


class AttrStore:
    """One object's typed attribute dictionary."""

    def __init__(self, kind: str):
        self.kind = kind                # qtssServerObjectType analogue
        self._specs: dict[int, AttrSpec] = {}
        self._by_name: dict[str, int] = {}
        self._getters: dict[int, Callable[[], Any]] = {}
        self._setters: dict[int, Callable[[Any], None]] = {}
        self._next_id = 0

    # -- registration ------------------------------------------------
    def add_attr(self, name: str, getter: Callable[[], Any], *,
                 type: str = "str", writable: bool = False,
                 setter: Callable[[Any], None] | None = None) -> int:
        """Register an attribute; returns its id (stable for the
        object's lifetime, assigned in registration order like the
        reference's qtssAttrId enums)."""
        if name in self._by_name:
            raise ValueError(f"attribute exists: {name}")
        if type not in _COERCE:
            raise ValueError(f"unknown attr type: {type}")
        if writable and setter is None:
            raise ValueError("writable attribute needs a setter")
        attr_id = self._next_id
        self._next_id += 1
        self._specs[attr_id] = AttrSpec(attr_id, name, type, writable)
        self._by_name[name] = attr_id
        self._getters[attr_id] = getter
        if setter is not None:
            self._setters[attr_id] = setter
        return attr_id

    # the QTSS_AddInstanceAttribute analogue: same mechanics, kept as a
    # separate name so module code reads like the reference API
    add_instance_attr = add_attr

    # -- access ------------------------------------------------------
    def _resolve(self, id_or_name: "int | str") -> int:
        if isinstance(id_or_name, int):
            if id_or_name not in self._specs:
                raise KeyError(f"{self.kind}: no attr id {id_or_name}")
            return id_or_name
        s = str(id_or_name)
        if s.startswith("@"):           # "@3" — set/get-by-id paths
            try:
                return self._resolve(int(s[1:]))
            except ValueError:
                raise KeyError(f"{self.kind}: bad attr ref {s}") from None
        if s not in self._by_name:
            raise KeyError(f"{self.kind}: no attr {s}")
        return self._by_name[s]

    def spec(self, id_or_name: "int | str") -> AttrSpec:
        return self._specs[self._resolve(id_or_name)]

    def get(self, id_or_name: "int | str") -> Any:
        return self._getters[self._resolve(id_or_name)]()

    def set(self, id_or_name: "int | str", value: Any) -> Any:
        """Type-coerced write; refuses read-only attributes (the
        reference returned QTSS_ReadOnly)."""
        attr_id = self._resolve(id_or_name)
        spec = self._specs[attr_id]
        if not spec.writable:
            raise PermissionError(f"{self.kind}.{spec.name} is read-only")
        coerced = _COERCE[spec.type](value) if isinstance(value, str) \
            else value
        self._setters[attr_id](coerced)
        return coerced

    def describe(self) -> list[dict]:
        """Attribute metadata (the admin tree's ?parameters view)."""
        return [{"id": s.attr_id, "name": s.name, "type": s.type,
                 "access": "rw" if s.writable else "r"}
                for s in self._specs.values()]

    def as_dict(self) -> dict[str, Any]:
        out = {}
        for attr_id, spec in self._specs.items():
            try:
                out[spec.name] = self._getters[attr_id]()
            except Exception as e:      # a live getter must not take the
                out[spec.name] = f"(error: {e})"   # whole tree down
        return out


# ---------------------------------------------------------------- factories

def server_store(app) -> AttrStore:
    """qtssServerObjectType: live server attributes (RTSPPort, uptime,
    session counts — the qtssSvr* set the stats module reads)."""
    st = AttrStore("server")
    info = app.server_info                     # live call, not snapshot
    for key in ("ServerName", "Version", "UpTimeSec", "RTSPPort",
                "ServicePort", "Connections", "PushSessions",
                "Requests", "PacketsIn", "TpuFanout"):
        st.add_attr(key, (lambda k=key: info().get(k)))
    return st


def config_store(config) -> AttrStore:
    """qtssPrefsObjectType: every pref writable through the validated
    ``ServerConfig.update`` path (RereadPrefs semantics)."""
    st = AttrStore("prefs")
    for name, value in config.to_dict().items():
        typ = ("bool" if isinstance(value, bool) else
               "int" if isinstance(value, int) else
               "float" if isinstance(value, float) else "str")
        st.add_attr(
            name,
            (lambda n=name: "(redacted)" if n == "rest_password"
             else config.to_dict().get(n)),
            type=typ, writable=True,
            setter=lambda v, n=name: config.update(**{n: v}))
    return st


def session_store(app, sess) -> AttrStore:
    """qtssClientSessionObjectType: one relay session's live state."""
    st = AttrStore("session")
    st.add_attr("Path", lambda: sess.path)
    st.add_attr("Url", lambda: (
        f"rtsp://{app.config.wan_ip}:"
        f"{app.rtsp.port or app.config.rtsp_port}{sess.path}"))
    st.add_attr("Outputs", lambda: sess.num_outputs, type="int")
    st.add_attr("AgeSec", lambda: _age_sec(sess), type="int")
    st.add_attr("Streams", lambda: sess.stats()["streams"], type="json")
    return st


def _age_sec(sess) -> int:
    from ..relay.session import now_ms
    return int((now_ms() - sess.created_ms) // 1000)


def metrics_store() -> AttrStore:
    """Reflective view over the obs metric registry: one attribute per
    registered family, getters read the LIVE family value (counters as
    numbers, histograms as {count,sum,p50,p99}, labelled families as
    name→value maps).  ``server/metrics/<family>`` and ``@<id>`` admin
    queries therefore see exactly what a ``/metrics`` scrape sees."""
    import time as _time

    from .. import obs
    st = AttrStore("metrics")
    last_collect = [0.0]

    def _live(fam):
        # refresh external sources (ed_stats) at most once per 50 ms: an
        # as_dict() tree sweep reads ~26 getters back-to-back and must
        # not re-snapshot the native counters for every one of them
        now = _time.monotonic()
        if now - last_collect[0] > 0.05:
            last_collect[0] = now
            obs.REGISTRY.collect()
        return fam.as_value()

    for fam in obs.REGISTRY.families():
        st.add_attr(fam.name, (lambda f=fam: _live(f)), type="json")
    return st


def stream_store(sess, track_id: int) -> AttrStore:
    """qtssRTPStreamObjectType: per-track live counters (the per-stream
    set the RTPStream dictionary exposed)."""
    st = AttrStore("stream")
    st.add_attr("TrackID", lambda: track_id, type="int")

    def _live(key):
        return sess.stats()["streams"].get(track_id, {}).get(key)

    for key in ("media", "codec", "packets_in", "bytes_in",
                "packets_out", "keyframes", "queue", "oversize_dropped"):
        st.add_attr(key, (lambda k=key: _live(k)), type="json")
    return st
