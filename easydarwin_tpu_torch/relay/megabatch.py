"""Cross-stream megabatch relay scheduler (single device).

Coalesces every stream's device work into **one shape-bucketed stacked
pass per wake**:

* **collect** — each stream contributes the ring packets not yet staged
  and its outputs' rewrite state;
* **bucket** — streams are grouped by pow2-padded (window, subscriber)
  shape;
* **stage** — each bucket's windows are gathered into ONE pinned host
  buffer in the fused ``pack_window`` layout and copied to the device with
  ``non_blocking=True``.  Buffers are **double-buffered** per bucket
  shape: the buffer dispatched at wake N goes back to the pool only at
  harvest, after the pass's CUDA event — recorded behind its H2D copy,
  the kernel and the D2H copy — has completed, so the host never
  rewrites an upload the copy engine may still be reading;
* **dispatch** — ONE ``megabatch_window_steps`` call per wake over every
  bucket (one ``ed_relay_window`` launch on the card); each bucket's
  result is copied into its pinned host buffer with ``non_blocking=True``
  and one CUDA event, recorded behind them all, stands for the wake;
* **harvest** (next wake) — a pass whose event ``query()`` reports done is
  scattered back into per-stream affine params (``scatter_affine_segments``)
  and installed into each engine's ``megabatch_params``.

Streams whose membership or rebase state changed are served by a
synchronous **prime** pass in ``begin_wake``, on fresh zero windows (one
call for all its subscriber buckets): the affine params depend only on
rewrite state, never on packet bytes.  ``window_calls`` counts the calls.

Every installed segment is checked against the host arithmetic oracle
(``relay.fanout.host_affine_params``); a disagreement is counted in
``mismatches`` and the segment discarded, so a device/host divergence can
never reach the wire.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native, resolve_device
from ..models.relay_pipeline import (megabatch_window_steps,
                                     scatter_affine_segments)
from ..ops import staging
from ..ops.fanout import STATE_COLS, pack_output_state
from ..ops.staging import pow2
from .fanout import params_agree, params_key


class _Staging:
    """One bucket's host upload: window rows + subscriber state, pinned
    when the device is a card, with numpy views for the gather."""

    __slots__ = ("win", "state", "win_np", "state_np")

    def __init__(self, b_pad: int, p_pad: int, s_pad: int, pin: bool):
        self.win = torch.zeros((b_pad, p_pad, staging.ROW_STRIDE),
                               dtype=torch.uint8, pin_memory=pin)
        self.state = torch.zeros((b_pad, s_pad, STATE_COLS),
                                 dtype=torch.uint32, pin_memory=pin)
        self.win_np = self.win.numpy()
        self.state_np = self.state.numpy()


class _InFlight:
    """One dispatched stacked pass awaiting harvest."""

    __slots__ = ("host", "event", "entries", "buf", "dispatch_ns")

    def __init__(self, host, event, entries, buf, dispatch_ns):
        #: pinned host copy of the [B, 4·S+1] result (valid once ``event``
        #: has completed)
        self.host = host
        #: CUDA event recorded after the wake's D2H copies (shared by every
        #: bucket of the wake); None on the CPU, where the pass has run
        self.event = event
        #: per-row (stream, engine, key, n_fast, base_pid)
        self.entries = entries
        #: the staging this pass was uploaded from, held until harvest
        self.buf = buf
        self.dispatch_ns = dispatch_ns

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class MegabatchScheduler:
    """One per server; the pump calls ``begin_wake`` before the per-stream
    engine steps and ``end_wake`` after them."""

    #: never stage more than this many packets per stream per pass (a burst
    #: beyond it restages from the newest tail)
    MAX_STAGE_ROWS = 1024
    #: outstanding stacked passes before staging pauses
    MAX_INFLIGHT = 2
    #: an in-flight pass older than this is force-fetched
    FORCE_FETCH_NS = 2_000_000_000

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        #: staging gathers through the egress core's ``ed_stage_gather``
        #: when it builds (``ops.staging.gather_window``)
        self.native_gather = native.available()
        #: staging buffers kept per hot shape (the double buffer)
        self._pool_cap = 2
        self._tracked: dict[int, int] = {}     # id(stream) → staged head
        #: id(stream) → (params_key, packed out_state rows)
        self._state_cache: dict[int, tuple] = {}
        #: id(stream) → (fast, key) from this wake's prime scan
        self._wake_fast: dict[int, tuple] = {}
        self._inflight: list[_InFlight] = []
        self._free: dict[tuple, list[_Staging]] = {}
        self.wakes = 0
        self.passes = 0
        self.prime_passes = 0
        #: megabatch_window_steps calls (one device launch each on the card)
        self.window_calls = 0
        self.streams_coalesced = 0
        self.harvests = 0
        self.installs = 0
        self.mismatches = 0
        self.deferred_wakes = 0

    # ------------------------------------------------------------- wake API
    def begin_wake(self, pairs, now_ms: int) -> None:
        """Mark the engines owned (they skip their own ring appends this
        wake), harvest any finished stacked pass, then prime params for
        streams whose membership or rebase state changed — ONE stacked
        pass for every such stream."""
        self.wakes += 1
        for _stream, eng in pairs:
            eng.megabatch_owned = True
        self._harvest()
        self._prime_stale(pairs, now_ms)

    def idle_wake(self) -> None:
        """A wake with no megabatch streams: keep harvesting what is in
        flight, and drop the per-stream cursors once nothing is."""
        if self._inflight:
            self._harvest()
        if not self._inflight and self._tracked:
            self._tracked.clear()
            self._state_cache.clear()

    def end_wake(self, pairs, now_ms: int) -> None:
        """Collect, bucket, stage and dispatch the next stacked pass."""
        # prune dead streams BEFORE any early return: a torn-down stream's
        # id() can be recycled by a new RelayStream
        live = {id(s) for s, _ in pairs}
        for sid in [k for k in self._tracked if k not in live]:
            del self._tracked[sid]
            self._state_cache.pop(sid, None)
        if len(self._inflight) >= self.MAX_INFLIGHT:
            self.deferred_wakes += 1       # saturated: dispatch next wake
            return
        work = self._collect(pairs)
        if not work:
            return
        buckets: dict[tuple, list] = {}
        for item in work:
            _stream, _eng, fast, _key, _base, n_new = item
            shape = (pow2(max(n_new, 1), 16), pow2(len(fast), 8))
            buckets.setdefault(shape, []).append(item)
        self._dispatch([(entries, p_pad, s_pad) for (p_pad, s_pad), entries
                        in sorted(buckets.items())])

    # ------------------------------------------------------------- prime
    def _prime_stale(self, pairs, now_ms: int) -> None:
        """Synchronous stacked param pass for key-stale streams.

        Runs the engine's own deterministic bookmark/rebase latch first
        (idempotent — the engine's step re-runs it as a no-op with the same
        wake timestamp), so the key computed here is the key the engine
        checks moments later in the same wake."""
        stale = []
        self._wake_fast.clear()
        for stream, eng in pairs:
            flat = eng._flat_outputs(stream)
            eng._prime(stream, flat, now_ms)
            fast = eng.fast_from_flat(flat)
            key = params_key(fast) if fast else None
            self._wake_fast[id(stream)] = (fast, key)
            if not fast or not self._needs_params(eng, key):
                continue
            stale.append((eng, fast, key))
        if not stale:
            return
        buckets: dict[int, list] = {}
        for item in stale:
            buckets.setdefault(pow2(len(item[1]), 8), []).append(item)
        groups, inputs = [], []
        for s_pad, items in sorted(buckets.items()):
            b_pad = pow2(len(items), 1)
            # fresh zeros on the device, never a recycled buffer: a stale
            # le32 length row would resurrect an old wake's packets into
            # the keyframe scan
            win = torch.zeros((b_pad, 16, staging.ROW_STRIDE),
                              dtype=torch.uint8, device=self.device)
            state = np.zeros((b_pad, s_pad, STATE_COLS), np.uint32)
            for i, (_eng, fast, _key) in enumerate(items):
                state[i, :len(fast)] = pack_output_state(fast)
            groups.append(items)
            inputs.append((win, torch.from_numpy(state).to(self.device)))
        for items, res in zip(groups, self._window_steps(inputs)):
            segs = scatter_affine_segments(
                res.cpu().numpy(), [len(f) for (_e, f, _k) in items])
            for (eng, _fast, key), seg in zip(items, segs):
                self._install_segment(eng, key, seg)
            self.prime_passes += 1
            self._note_pass(len(items))

    def _window_steps(self, inputs) -> list:
        """The one device call of a dispatch or a prime."""
        self.window_calls += 1
        return megabatch_window_steps(inputs)

    @staticmethod
    def _needs_params(eng, key) -> bool:
        mb = eng.megabatch_params
        return key != eng._params_key and not (mb is not None and mb[0] == key)

    # ------------------------------------------------------------- collect
    def _collect(self, pairs) -> list:
        work = []
        for stream, eng in pairs:
            ring = stream.rtp_ring
            cached = self._wake_fast.get(id(stream))
            if cached is not None:
                fast, key = cached
            else:                          # end_wake without a prime scan
                fast = eng.fast_outputs(stream)
                key = params_key(fast) if fast else None
            if not fast:
                self._tracked[id(stream)] = ring.head
                continue
            base = self._tracked.get(id(stream))
            floor = max(ring.tail, ring.head - self.MAX_STAGE_ROWS)
            if base is None or base > ring.head or base < floor:
                base = floor               # new/recycled/fell-behind
            n_new = ring.head - base
            if n_new <= 0 and not self._needs_params(eng, key):
                continue                   # idle stream: zero device work
            work.append((stream, eng, fast, key, base, n_new))
        return work

    # ------------------------------------------------------------ dispatch
    def _buffer(self, b_pad: int, p_pad: int, s_pad: int) -> _Staging:
        pool = self._free.get((b_pad, p_pad, s_pad))
        if pool:
            return pool.pop()
        return _Staging(b_pad, p_pad, s_pad, self._pin)

    def _recycle(self, buf: _Staging) -> None:
        key = (buf.win.shape[0], buf.win.shape[1], buf.state.shape[1])
        pool = self._free.setdefault(key, [])
        if len(pool) < self._pool_cap:     # double buffer per shape; a
            pool.append(buf)               # cold shape's extras are freed

    def _install_segment(self, eng, key, seg, base=None) -> bool:
        """Oracle-check one scattered segment and install it as the
        engine's params — the ONE definition the harvest and the prime go
        through.  Returns False (and counts the mismatch) on device/host
        divergence."""
        params, kf = seg[:4], seg[4]
        if not params_agree(params, key):
            self.mismatches += 1
            eng.megabatch_params = None
            return False
        eng.megabatch_params = (key, params)
        self.installs += 1
        if base is not None and kf >= 0:
            eng.last_newest_keyframe = max(eng.last_newest_keyframe,
                                           base + kf)
        return True

    def _note_pass(self, n_streams: int) -> None:
        self.passes += 1
        self.streams_coalesced += n_streams

    def _packed_state(self, stream, fast, key) -> np.ndarray:
        cached = self._state_cache.get(id(stream))
        if cached is not None and cached[0] == key:
            return cached[1]
        packed = pack_output_state(fast)
        self._state_cache[id(stream)] = (key, packed)
        return packed

    def _dispatch(self, buckets) -> None:
        """Stage every ``(entries, p_pad, s_pad)`` bucket and upload it,
        then ONE window call for the wake; each bucket's result goes to
        its pinned host buffer, and one event stands behind them all."""
        staged = []
        for entries, p_pad, s_pad in buckets:
            buf = self._buffer(pow2(len(entries), 1), p_pad, s_pad)
            buf.state_np[:] = 0
            recs = []
            for i, (stream, eng, fast, key, base, n_new) in enumerate(entries):
                staging.gather_window(stream.rtp_ring, base, n_new,
                                      buf.win_np[i])
                buf.state_np[i, :len(fast)] = self._packed_state(stream, fast,
                                                                 key)
                self._tracked[id(stream)] = base + n_new
                recs.append((stream, eng, key, len(fast), base))
            buf.win_np[len(entries):] = 0  # bucket padding rows
            staged.append((buf, recs))
        if self._pin:
            results = self._window_steps(
                [(buf.win.to(self.device, non_blocking=True),
                  buf.state.to(self.device, non_blocking=True))
                 for buf, _recs in staged])
            hosts = []
            for res in results:
                host = torch.empty(res.shape, dtype=torch.int32,
                                   pin_memory=True)
                host.copy_(res.view(torch.int32), non_blocking=True)
                hosts.append(host)
            event = torch.cuda.Event()
            event.record()
        else:
            hosts = self._window_steps([(buf.win, buf.state)
                                        for buf, _recs in staged])
            event = None
        now = time.perf_counter_ns()
        for (buf, recs), host in zip(staged, hosts):
            self._inflight.append(_InFlight(host, event, recs, buf, now))
            self._note_pass(len(recs))

    # ------------------------------------------------------------- harvest
    def _harvest(self, *, force: bool = False) -> int:
        keep: list[_InFlight] = []
        installed = 0
        for inf in self._inflight:
            age = time.perf_counter_ns() - inf.dispatch_ns
            if not (inf.ready() or force or age >= self.FORCE_FETCH_NS):
                keep.append(inf)           # never stall the wake on it
                continue
            if inf.event is not None:
                inf.event.synchronize()    # no-op once query() said done
            packed = inf.host.numpy().view(np.uint32)
            segs = scatter_affine_segments(
                packed, [n for (_s, _e, _k, n, _b) in inf.entries])
            for (_stream, eng, key, _n, base), seg in zip(inf.entries, segs):
                if self._install_segment(eng, key, seg, base=base):
                    installed += 1
            self._recycle(inf.buf)
            self.harvests += 1
        self._inflight = keep
        return installed

    # -------------------------------------------------------------- stats
    def drain(self) -> int:
        """Force-fetch everything in flight (tests/teardown)."""
        return self._harvest(force=True)

    def stats(self) -> dict:
        return {
            "wakes": self.wakes,
            "passes": self.passes,
            "prime_passes": self.prime_passes,
            "window_calls": self.window_calls,
            "streams_coalesced": self.streams_coalesced,
            "inflight": len(self._inflight),
            "harvests": self.harvests,
            "installs": self.installs,
            "mismatches": self.mismatches,
            "deferred_wakes": self.deferred_wakes,
            "native_gather": self.native_gather,
        }
