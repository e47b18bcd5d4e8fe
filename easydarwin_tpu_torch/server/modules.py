"""Module/role system — the QTSS plugin architecture, re-designed.

Reference parity: ``APIStubLib/QTSS.h`` roles + ``QTSSModule`` registration
+ ``QTSServer::BuildModuleRoleArrays`` dispatch (``QTSServer.cpp:285``).
The reference's reflective attribute dictionaries (``QTSSDictionary``) exist
to let C plugins poke server state without headers; in Python the natural
equivalent is plain objects + typed hook points, so the role pipeline is
kept and the dictionary indirection is dropped.

Roles (named after their QTSS counterparts):

* ``initialize(server)`` / ``shutdown(server)``
* ``reread_prefs(config)``                    — QTSS_RereadPrefs_Role
* ``rtsp_filter(conn, req) -> RtspResponse|None``   — QTSS_RTSPFilter_Role:
  may answer the request outright (used by web-stats-style modules)
* ``rtsp_route(conn, req) -> None``           — QTSS_RTSPRoute_Role
* ``authorize(conn, req) -> bool|None``       — QTSS_RTSPAuthorize_Role:
  False forbids, True allows, None = no opinion
* ``rtsp_postprocess(conn, req, resp)``       — QTSS_RTSPPostProcessor_Role
* ``session_closing(conn)``                   — QTSS_ClientSessionClosing_Role
* ``incoming_rtp(session, track_id, packet)`` — QTSS_RTSPIncomingData_Role

Modules are registered in priority order; filter/authorize short-circuit
like the reference's role arrays.
"""

from __future__ import annotations

from ..protocol import rtsp


class Module:
    """Subclass and override the roles you register for."""

    name = "module"

    def attributes(self) -> dict:
        """Module-added attributes for the admin dictionary tree — the
        static half of the QTSS dictionary system
        (``QTSS_AddStaticAttribute``; modules exposed live counters and
        state through it, browseable under ``modules/<name>``).  Return
        a flat or nested dict of JSON-able values."""
        return {}

    def add_instance_attr(self, name: str, getter, *, type: str = "str",
                          writable: bool = False, setter=None) -> int:
        """The ``QTSS_AddInstanceAttribute`` analogue: attach a typed
        attribute to THIS module instance at runtime.  It appears in
        the admin tree under ``modules/<name>/instance_attrs`` on the
        next query, with get/set-by-id via the reflective store."""
        from .dictionary import AttrStore
        if not hasattr(self, "attr_store"):
            self.attr_store = AttrStore(f"module:{self.name}")
        return self.attr_store.add_instance_attr(
            name, getter, type=type, writable=writable, setter=setter)

    def initialize(self, server) -> None:
        pass

    def shutdown(self, server) -> None:
        pass

    def reread_prefs(self, config) -> None:
        pass

    def rtsp_filter(self, conn, req: rtsp.RtspRequest):
        return None

    def rtsp_route(self, conn, req: rtsp.RtspRequest) -> None:
        return None

    def authorize(self, conn, req: rtsp.RtspRequest):
        return None

    def rtsp_postprocess(self, conn, req: rtsp.RtspRequest,
                         resp: rtsp.RtspResponse) -> None:
        return None

    def session_closing(self, conn) -> None:
        return None

    def incoming_rtp(self, session, track_id: int, packet: bytes) -> None:
        return None


class ModuleRegistry:
    def __init__(self):
        self.modules: list[Module] = []

    def register(self, module: Module) -> None:
        self.modules.append(module)

    def unregister(self, module: Module) -> None:
        if module in self.modules:
            self.modules.remove(module)

    # -- dispatch (role arrays) -------------------------------------------
    def run_initialize(self, server) -> None:
        for m in self.modules:
            m.initialize(server)

    def run_shutdown(self, server) -> None:
        for m in self.modules:
            m.shutdown(server)

    def run_reread_prefs(self, config) -> None:
        for m in self.modules:
            m.reread_prefs(config)

    def run_filter(self, conn, req):
        """First module answering wins (QTSSModule kRTSPFilter semantics)."""
        for m in self.modules:
            resp = m.rtsp_filter(conn, req)
            if resp is not None:
                return resp
        return None

    def run_route(self, conn, req) -> None:
        for m in self.modules:
            m.rtsp_route(conn, req)

    def run_authorize(self, conn, req) -> bool:
        """False if any module forbids (all abstaining → allowed)."""
        for m in self.modules:
            v = m.authorize(conn, req)
            if v is False:
                return False
            if v is True:
                return True
        return True

    def run_postprocess(self, conn, req, resp) -> None:
        for m in self.modules:
            m.rtsp_postprocess(conn, req, resp)

    def run_session_closing(self, conn) -> None:
        for m in self.modules:
            m.session_closing(conn)

    def run_incoming_rtp(self, session, track_id, packet) -> None:
        for m in self.modules:
            m.incoming_rtp(session, track_id, packet)


# -- dynamic loading (QTSServer::LoadModules / OSCodeFragment parity) --------

def load_modules_from(folder: str, *, on_error=None) -> list[Module]:
    """Scan ``folder`` for ``*.py`` plugin files and instantiate their
    modules, the way ``QTSServer::LoadModules`` (``QTSServer.cpp:283``)
    dlopens every file in ``module_folder`` via ``OSCodeFragment``.

    A plugin file may provide, in order of precedence:

    * ``EDTPU_MODULES`` — a list of ``Module`` instances or classes;
    * ``register() -> Module | list[Module]`` — a factory;
    * top-level ``Module`` subclasses (each is instantiated).

    A broken plugin is skipped (the reference logs and continues too);
    ``on_error(filename, exc)`` observes failures.
    """
    import importlib.util
    import os
    import sys

    loaded: list[Module] = []
    if not folder or not os.path.isdir(folder):
        return loaded
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(folder, fname)
        name = "edtpu_plugin_" + fname[:-3]
        try:
            spec = importlib.util.spec_from_file_location(name, path)
            py = importlib.util.module_from_spec(spec)
            sys.modules[name] = py          # importlib recipe: before exec
            try:
                spec.loader.exec_module(py)
            except BaseException:
                sys.modules.pop(name, None)
                raise
            loaded.extend(_modules_in(py))
        except Exception as e:              # plugin bugs must not kill boot
            if on_error is not None:
                on_error(fname, e)
    return loaded


def _modules_in(py) -> list[Module]:
    def inst(x):
        return x() if isinstance(x, type) else x

    if hasattr(py, "EDTPU_MODULES"):
        return [inst(m) for m in py.EDTPU_MODULES]
    if hasattr(py, "register") and callable(py.register):
        out = py.register()
        return [inst(m) for m in (out if isinstance(out, list) else [out])]
    # fallback: leaf Module subclasses *defined in this file* — imported
    # classes and intermediate bases must not be double-registered
    cands = [cls for cls in vars(py).values()
             if isinstance(cls, type) and issubclass(cls, Module)
             and cls is not Module and cls.__module__ == py.__name__]
    return [cls() for cls in cands
            if not any(cls is not o and issubclass(o, cls) for o in cands)]
