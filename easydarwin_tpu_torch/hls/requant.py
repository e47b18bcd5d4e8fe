"""HLS bitrate renditions via transform-domain H.264 requantization.

``RequantLadder`` is ONE relay sink a published path: it depacketizes the
source once, requantizes each access unit to every q-rung of the path,
and feeds the per-rung muxers (``LadderRendition``, an ``HlsOutput``) in
source order.  Each AU runs parse → B6 → recode on a shared worker pool:

    AU ──► slice NALs ──► [parse ×S across the pool]
                                  │
                                  └► ONE FusedRequantDispatch (S slices ×
                                     N renditions; on a card one
                                     ``ed_h264_requant`` launch and, with
                                     chroma residual, one
                                     ``ed_h264_requant_chroma`` launch) ──►
                                     [recode ×S×N across the pool]
                                  │
                     ordered per-AU reassembly ──► rendition muxers

The worker that finishes an AU's last parse runs the dispatch; several
AUs may be in flight, each dispatch owning its staging (``codecs.
h264_requant.DevicePass``).  Admission sheds an AU when ``pending >=
max(4, 2 * workers)`` (degrade in frame rate, never in latency), and
counts it.

The reference chooses a native C walk instead whenever its C core loads;
the port has no such walk (ROADMAP A7c), so the choice does not look at
``native.available()`` (the port's egress core): every ladder takes the
device arm on its ``device``.  An exception in the dispatch (the upload,
a launch, the readback) is counted in ``device_errors`` with its
traceback on stderr, apart from ``slices_passed_through``; the AU's
source slices then go to the rungs unchanged.  ``counters()`` gives the
ladder's counts and the host seconds of each stage (``REQUANT_STAGES``),
which ``HlsService.stats`` sums.

``RequantHlsOutput`` is the serial single-rendition form: an
``HlsOutput`` whose AUs pass through one ``SliceRequantizer``."""

from __future__ import annotations

import asyncio
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

from ..codecs.h264_requant import (FusedRequantDispatch, RequantStats,
                                   SliceRequantizer, gather_slice,
                                   parse_slice_nal, recode_parsed)
from ..relay.output import RelayOutput, WriteResult
from ..vod.depacketize import AccessUnit, H264Depacketizer
from .segmenter import HlsOutput

#: the requant pipeline's stages: ``parse`` = one slice's entropy decode,
#: ``transform_device`` = an AU's fused B6 dispatch and its harvest,
#: ``recode`` = one rendition's entropy re-encode of one slice,
#: ``reassemble`` = the ordered per-AU emit
REQUANT_STAGES = ("parse", "transform_device", "recode", "reassemble")

#: one shared pool for ALL requant renditions of the process, sized to the
#: cores it may use; the Python parse and recode hold the GIL, so the pool
#: mostly keeps the work off the event loop, while the B6 pass and its
#: copies release it
_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()
_sizing_cache: dict | None = None


def widen_affinity() -> None:
    """Undo a ONE-CORE pin on the calling thread (a runtime that pins the
    thread it initializes on passes the one-core mask to every thread
    spawned after it, which would stack the whole pool on one CPU).

    Deliberately narrow: only the exact one-core signature is widened,
    so an operator's multi-core confinement (``taskset -c 0,1``) is
    preserved; the kernel intersects the widened mask with the cpuset,
    so a cpuset quota is never escaped either.  What this CANNOT see is
    a pure bandwidth quota (cgroup ``cpu.max`` on a big node): size the
    pool explicitly with ``EDTPU_REQUANT_WORKERS`` there (the override
    also disables widening entirely)."""
    if os.environ.get("EDTPU_REQUANT_WORKERS"):
        return
    try:
        if len(os.sched_getaffinity(0)) == 1 and (os.cpu_count() or 1) > 1:
            os.sched_setaffinity(0, range(os.cpu_count() or 1))
    except (AttributeError, OSError, ValueError):
        pass


def _own_cgroup_path(proc_cgroup: str, controller: str | None) -> str:
    """This process's cgroup path for ``controller`` (None = the v2
    unified hierarchy) from ``/proc/self/cgroup`` — the effective quota
    lives in OUR cgroup, not the root (a systemd CPUQuota= service sits
    in system.slice/<svc> where the root's cpu.max reads 'max')."""
    try:
        with open(proc_cgroup, encoding="ascii") as f:
            for ln in f:
                parts = ln.strip().split(":", 2)
                if len(parts) != 3:
                    continue
                if controller is None and parts[0] == "0":
                    return parts[2]
                if controller is not None and \
                        controller in parts[1].split(","):
                    return parts[2]
    except OSError:
        pass
    return ""


def _cgroup_quota_cpus(proc_cgroup: str = "/proc/self/cgroup",
                       fs_root: str = "/sys/fs/cgroup") -> float | None:
    """CPU-equivalents allowed by the cgroup's *bandwidth* quota (the
    signal affinity masks cannot see): cgroup v2 ``cpu.max`` or v1
    ``cpu.cfs_quota_us``/``cpu.cfs_period_us``, read from THIS
    process's cgroup and every ancestor up to the root — the effective
    limit is the minimum along the chain.  None = no quota anywhere
    (or not on Linux/cgroups)."""
    best: float | None = None

    def note(v: float) -> None:
        nonlocal best
        best = v if best is None else min(best, v)

    def walk(root: str, rel: str, read) -> None:
        node = root + rel if rel and rel != "/" else root
        while True:
            v = read(node)
            if v is not None:
                note(v)
            if node == root or not node.startswith(root):
                break
            node = os.path.dirname(node)

    def read_v2(node: str) -> float | None:
        try:
            with open(node + "/cpu.max", encoding="ascii") as f:
                quota, _, period = f.read().strip().partition(" ")
            if quota != "max" and float(period) > 0:
                return float(quota) / float(period)
        except (OSError, ValueError):
            pass
        return None

    def read_v1(node: str) -> float | None:
        try:
            with open(node + "/cpu.cfs_quota_us", encoding="ascii") as f:
                quota = float(f.read().strip())
            with open(node + "/cpu.cfs_period_us", encoding="ascii") as f:
                period = float(f.read().strip())
            if quota > 0 and period > 0:
                return quota / period
        except (OSError, ValueError):
            pass
        return None

    walk(fs_root, _own_cgroup_path(proc_cgroup, None), read_v2)
    walk(fs_root + "/cpu", _own_cgroup_path(proc_cgroup, "cpu"), read_v1)
    return best


def _probe_affinity() -> int:
    """CPUs visible to a fresh thread that first widens its own affinity
    (un-inheriting a one-core pin of the importing thread)."""
    box: list[int] = []

    def probe() -> None:
        widen_affinity()
        try:
            box.append(len(os.sched_getaffinity(0)))
        except (AttributeError, OSError):
            box.append(os.cpu_count() or 1)

    t = threading.Thread(target=probe, name="hls-requant-probe")
    t.start()
    t.join()
    return max(1, box[0] if box else 1)


def pool_sizing(*, affinity: int | None = None,
                quota: float | None = None,
                cpu_count: int | None = None,
                env: str | None = None) -> dict:
    """Worker count for the shared requant pool PLUS the rationale:
    which signal won and what every signal read, so a wrong sizing is
    diagnosable from the stats alone.

    Signals, in precedence order:

    * ``EDTPU_REQUANT_WORKERS`` — explicit operator override;
    * the **affinity probe** (widened throwaway thread) — the CPUs the
      scheduler will actually run our threads on;
    * the **cgroup bandwidth quota** (``cpu.max`` / cfs_quota) — the
      signal the affinity mask cannot see.  Two regressions it fixes:
      the case where the probe collapses to 1 (a runtime's
      one-core pin survives because ``sched_setaffinity`` is denied in
      the container) while the quota provisions several CPUs — trust
      the quota, the per-worker initializer still retries the widen;
      and the big-node case where affinity says 96 but ``cpu.max``
      caps at 2 — sizing to 96 just trades throughput for preemption
      thrash, so the quota caps the pool.

    Keyword arguments override the probed signals (tests); the no-
    argument call is memoized — none of these signals move at runtime."""
    global _sizing_cache
    injected = (affinity is not None or quota is not None
                or cpu_count is not None or env is not None)
    if not injected and _sizing_cache is not None:
        return _sizing_cache
    env = os.environ.get("EDTPU_REQUANT_WORKERS") if env is None else env
    if env:
        try:
            sizing = {"workers": max(1, int(env)), "source": "env",
                      "affinity_cpus": None, "quota_cpus": None,
                      "cpu_count": os.cpu_count() or 1}
            if not injected:
                _sizing_cache = sizing
            return sizing
        except ValueError:
            pass
    ncpu = cpu_count if cpu_count is not None else (os.cpu_count() or 1)
    aff = affinity if affinity is not None else _probe_affinity()
    q = quota if quota is not None else _cgroup_quota_cpus()
    q_cpus = max(1, int(q)) if q is not None and q >= 1 else \
        (1 if q is not None else None)
    if aff <= 1 and q_cpus is not None and q_cpus > 1:
        workers, source = min(q_cpus, ncpu), "cpu_max_quota"
    elif q_cpus is not None and q_cpus < aff:
        workers, source = q_cpus, "cpu_max_cap"
    else:
        workers, source = aff, "affinity"
    sizing = {"workers": max(1, workers), "source": source,
              "affinity_cpus": aff,
              "quota_cpus": round(q, 2) if q is not None else None,
              "cpu_count": ncpu}
    if not injected:
        _sizing_cache = sizing
    return sizing


def pool_workers() -> int:
    """Worker count for the shared requant pool (see ``pool_sizing``
    for the decision rationale)."""
    return pool_sizing()["workers"]


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            # initializer: each worker un-inherits the importing thread's
            # one-core pin, or the sized pool still stacks on one CPU
            _pool = ThreadPoolExecutor(max_workers=pool_workers(),
                                       thread_name_prefix="hls-requant",
                                       initializer=widen_affinity)
        return _pool


class RequantHlsOutput(HlsOutput):
    """An ``HlsOutput`` whose AUs pass through ONE ``SliceRequantizer``
    (``delta_qp``, B6 on ``device``, or the host scalar oracles with
    ``device=None``) before muxing.  Under a running event loop the AUs
    run on the shared pool and a reorder buffer emits them in order;
    without one (tests, offline tools) they run inline."""

    def __init__(self, delta_qp: int, *,
                 device: str | torch.device | None = None, **kw):
        super().__init__(**kw)
        self.requant = SliceRequantizer(delta_qp, device=device)
        self.delta_qp = delta_qp
        self._ps_fed: tuple[bytes | None, bytes | None] = (None, None)
        #: AUs dropped because the pipeline was too far behind: shedding
        #: keeps the rendition live instead of ever-later
        self.shed = 0
        self._max_pending = max(4, 2 * pool_workers())
        # workers complete out of order, fMP4 fragments must not
        self._next_submit = 0
        self._next_emit = 0
        self._ready: dict[int, AccessUnit] = {}

    def _feed_ps(self, ps: tuple[bytes | None, bytes | None]) -> None:
        # the depacketizer latches SPS/PPS out of band (they are config,
        # not sample data): feed them to the requantizer when they change
        if ps != self._ps_fed:
            self._ps_fed = ps
            for n in ps:
                if n:
                    self.requant.transform_nal(n)

    def _on_unit(self, au: AccessUnit) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        # parameter sets are captured at ENQUEUE time: a queued AU is
        # requantized against the PPS it was coded with
        ps = (self.depack.sps, self.depack.pps)
        if loop is None:
            self._feed_ps(ps)
            super()._on_unit(AccessUnit(
                au.timestamp,
                [self.requant.transform_nal(n) for n in au.nals]))
            return
        # gate on SUBMITTED-minus-EMITTED: a straggler stalls admission
        # too, so the reorder buffer stays bounded
        if self.pending >= self._max_pending:
            self.shed += 1
            return
        self._feed_ps(ps)
        sps, pps = self.requant.sps, self.requant.pps
        seq = self._next_submit
        self._next_submit += 1

        def work():
            try:
                deltas = []
                nals = []
                for n in au.nals:
                    out, d = self.requant.requant_with(n, sps, pps)
                    nals.append(out)
                    deltas.append(d)
                out_au = AccessUnit(au.timestamp, nals)
            except Exception:
                # never strand the reorder slot (that would shed every
                # later AU); the unit passes through with none of its
                # stats, and the traceback is kept
                traceback.print_exc(file=sys.stderr)
                out_au = au
                deltas = []
            loop.call_soon_threadsafe(self._emit, seq, out_au, deltas)

        _get_pool().submit(work)

    @property
    def pending(self) -> int:
        """Submitted-but-not-yet-emitted AUs."""
        return self._next_submit - self._next_emit

    def _emit(self, seq: int, au: AccessUnit, deltas) -> None:
        for d in deltas:
            self.requant.stats.merge(d)
        self._ready[seq] = au
        while self._next_emit in self._ready:
            super()._on_unit(self._ready.pop(self._next_emit))
            self._next_emit += 1


class LadderRendition(HlsOutput):
    """One rung's CMAF muxer: fed already-requantized AUs by its ladder
    (never raw packets: ``send_bytes`` on a rendition is a wiring bug).
    Keeps the ``.requant`` (its stats) and ``.shed`` surface of a q-rung
    output."""

    def __init__(self, ladder: "RequantLadder", delta_qp: int,
                 engine: SliceRequantizer, **kw):
        super().__init__(**kw)
        self._ladder = ladder
        self.delta_qp = delta_qp
        #: the per-rendition stats container; worker deltas merge into
        #: ``requant.stats`` once per AU
        self.requant = engine
        #: share the ladder's depacketizer so the init segment sees the
        #: source SPS/PPS (requant never rewrites parameter sets)
        self.depack = ladder.depack

    def send_bytes(self, data: bytes, *, is_rtcp: bool):
        raise RuntimeError("ladder renditions are fed AUs by the "
                           "ladder, not packets")

    @property
    def shed(self) -> int:
        """AUs shed at ladder admission (every rendition together)."""
        return self._ladder.shed

    @property
    def pending(self) -> int:
        return self._ladder.pending


class _AuJob:
    """One AU in flight through the ladder pool: per-rendition output
    slots (slice-ordered), per-worker stats deltas, and the outstanding
    unit counter that triggers the next step."""

    __slots__ = ("seq", "au", "deltas", "sps", "pps", "slice_idx",
                 "outs", "stats", "remaining", "lock", "parsed",
                 "mismatch", "t_in")

    def __init__(self, seq: int, au: AccessUnit, deltas, sps, pps):
        self.seq = seq
        #: when the AU came out of the depacketizer (its latency's start)
        self.t_in = time.perf_counter()
        self.au = au
        self.deltas = deltas
        self.sps = sps
        self.pps = pps
        self.slice_idx = [i for i, n in enumerate(au.nals)
                          if n and (n[0] & 0x1F) in (1, 5)
                          and sps is not None and pps is not None]
        # non-slice NALs ride through in place; slice slots start EMPTY
        # so the reassembly check catches a genuinely lost unit instead
        # of silently emitting the source slice
        slice_set = set(self.slice_idx)
        self.outs = {d: [None if i in slice_set else n
                         for i, n in enumerate(au.nals)]
                     for d in deltas}
        self.stats = {d: [] for d in deltas}
        self.remaining = 0
        self.lock = threading.Lock()
        self.parsed = {}                # slice pos -> (ParsedSlice, gather)
        self.mismatch = False


class RequantLadder(RelayOutput):
    """The multi-rendition requant pipeline of one path (module notes):
    B6 on ``device``, parse and recode on the shared pool."""

    #: ``counters()`` keys besides the per-stage ``<stage>_s`` seconds
    #: and ``<stage>_n`` counts; a key ending in ``_max`` is a peak (the
    #: service takes the largest), the others sum
    COUNTERS = ("aus", "no_ps_aus", "shed", "mismatches", "dispatches",
                "dispatches_chroma", "device_errors", "slices",
                "transform_submit_s", "transform_wait_s", "latency_s",
                "latency_s_max", "pending_max")

    def __init__(self, *, device: str | torch.device = "cuda",
                 target_duration: float = 2.0, window: int = 6,
                 audio=None):
        super().__init__(ssrc=0x415)
        # identity rewrite, same as HlsOutput: every rendition keeps the
        # SOURCE timestamps so ABR switching never jumps in time
        self.rewrite.base_src_seq = 0
        self.rewrite.base_src_ts = 0
        self.rewrite.out_seq_start = 0
        self.rewrite.out_ts_start = 0
        self.depack = H264Depacketizer()
        self.device = torch.device(device)
        self.target_duration = target_duration
        self.window = window
        self.audio = audio
        self.renditions: dict[int, LadderRendition] = {}
        self._sps = None
        self._pps = None
        self._sps_raw: bytes | None = None
        self._pps_raw: bytes | None = None
        self.shed = 0
        self._max_pending = max(4, 2 * pool_workers())
        self._next_submit = 0
        self._next_emit = 0
        self._ready: dict[int, _AuJob] = {}
        #: guards the counters below (workers dispatch and time stages)
        self._stats_lock = threading.Lock()
        self.aus = 0
        #: AUs that came before an SPS and PPS were latched: nothing to
        #: requant against, so they go to the renditions as they are (a
        #: segmenter drops them: it starts at an IDR with its sets)
        self.no_ps_aus = 0
        self.mismatches = 0
        #: fused dispatches that launched the luma pass / the chroma pass
        self.dispatches = 0
        self.dispatches_chroma = 0
        #: dispatches whose upload, launch or readback raised
        self.device_errors = 0
        #: (slice, rendition) units finished
        self.slices = 0
        #: host seconds of the dispatches' submit (gather, staging, the
        #: uploads and launches enqueued) and wait (the readbacks' events)
        self.transform_submit_s = 0.0
        self.transform_wait_s = 0.0
        #: host seconds from an AU's depacketizing to its emit, summed
        #: and the largest: growing latency is a ladder falling behind
        self.latency_s = 0.0
        self.latency_s_max = 0.0
        #: the most AUs pending at an admission (the gate sheds at
        #: ``max(4, 2 * workers)``)
        self.pending_max = 0
        self.stage_s = dict.fromkeys(REQUANT_STAGES, 0.0)
        self.stage_n = dict.fromkeys(REQUANT_STAGES, 0)

    def _stage(self, stage: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stage_s[stage] += dt
            self.stage_n[stage] += 1

    def counters(self) -> dict:
        with self._stats_lock:
            out = {k: getattr(self, k) for k in self.COUNTERS}
            for st in REQUANT_STAGES:
                out[f"{st}_s"] = self.stage_s[st]
                out[f"{st}_n"] = self.stage_n[st]
        return out

    # -- ladder membership -------------------------------------------------
    def add_rendition(self, delta_qp: int) -> LadderRendition:
        """Get-or-create the rung at ``delta_qp`` (multiples of 6, the
        exact-shift window; ``SliceRequantizer`` validates)."""
        out = self.renditions.get(delta_qp)
        if out is None:
            engine = SliceRequantizer(delta_qp, device=self.device)
            out = LadderRendition(self, delta_qp, engine,
                                  target_duration=self.target_duration,
                                  window=self.window, audio=self.audio)
            self.renditions[delta_qp] = out
        return out

    @property
    def pending(self) -> int:
        """Submitted-but-not-yet-emitted AUs (in workers OR waiting in
        the reorder buffer): the admission gate and test barrier."""
        return self._next_submit - self._next_emit

    # -- ingest ------------------------------------------------------------
    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return WriteResult.OK
        self.depack.push(data)
        for au in self.depack.pop_units():
            self._on_unit(au)
        return WriteResult.OK

    def _latch_ps(self, au: AccessUnit) -> None:
        """Latch SPS/PPS at AU granularity on the ingest thread: the
        depacketizer's out-of-band sets plus any in-band sets riding the
        AU."""
        from ..codecs.h264_intra import Pps, Sps
        cands = [self.depack.sps, self.depack.pps]
        cands += [n for n in au.nals if n and (n[0] & 0x1F) in (7, 8)]
        for n in cands:
            if not n:
                continue
            t = n[0] & 0x1F
            try:
                if t == 7 and n != self._sps_raw:
                    self._sps, self._sps_raw = Sps.parse(n), n
                elif t == 8 and n != self._pps_raw:
                    self._pps, self._pps_raw = Pps.parse(n), n
            except (ValueError, EOFError, IndexError):
                if t == 7:
                    self._sps = self._sps_raw = None
                else:
                    self._pps = self._pps_raw = None

    def _on_unit(self, au: AccessUnit) -> None:
        if not self.renditions:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        self._latch_ps(au)
        deltas = tuple(sorted(self.renditions))
        if loop is None:
            # synchronous caller (tests, offline tools): run the SAME
            # pipeline inline; sync and pooled output are byte-identical
            job = _AuJob(self._next_submit, au, deltas, self._sps,
                         self._pps)
            self._next_submit += 1
            self._count_no_ps(job)
            self._run_job_inline(job)
            self._emit(job)
            return
        self.pending_max = max(self.pending_max, self.pending)
        if self.pending >= self._max_pending:
            self.shed += 1               # backlogged: shed, stay live
            return
        job = _AuJob(self._next_submit, au, deltas, self._sps, self._pps)
        self._next_submit += 1
        self._count_no_ps(job)
        if not job.slice_idx:
            self._emit(job)              # SEI/PS-only AU: nothing to do,
            return                       # but it keeps its emit slot
        pool = _get_pool()
        job.remaining = len(job.slice_idx)
        for pos in job.slice_idx:
            pool.submit(self._parse_unit, loop, job, pos)

    def _count_no_ps(self, job: _AuJob) -> None:
        if job.sps is None or job.pps is None:
            if any(n and (n[0] & 0x1F) in (1, 5) for n in job.au.nals):
                with self._stats_lock:
                    self.no_ps_aus += 1

    # -- worker units ------------------------------------------------------
    # Every unit takes ``loop``: the pooled path passes the event loop
    # (completion notifies it thread-safely); the synchronous inline
    # path passes None and the caller emits after the last unit: ONE
    # implementation, so sync and pooled can never drift apart.
    def _complete_unit(self, loop, job: _AuJob) -> None:
        with job.lock:
            job.remaining -= 1
            done = job.remaining == 0
        if done and loop is not None:
            loop.call_soon_threadsafe(self._emit, job)

    def _parse_unit(self, loop, job: _AuJob, pos: int) -> None:
        """Shared parse of one slice: entropy-decode ONCE for the whole
        ladder.  The worker that finishes the AU's last parse runs the
        fused dispatch and fans the recodes back across the pool."""
        nal = job.au.nals[pos]
        parsed = None
        try:
            t0 = time.perf_counter()
            p = parse_slice_nal(nal, job.sps, job.pps)
            parsed = (p, gather_slice(p))
            self._stage("parse", t0)
        except Exception:
            # out of the requant profile (or bytes no parser takes):
            # pass through, never strand the AU's slot
            parsed = None
        with job.lock:
            if parsed is not None:
                job.parsed[pos] = parsed
            job.remaining -= 1
            last = job.remaining == 0    # this was the AU's final parse
        if last:
            self._dispatch_unit(loop, job)

    def _fill_source(self, job: _AuJob, positions, *,
                     passed_through: bool) -> None:
        """Put the source NAL of each slice in ``positions`` into every
        rendition's slot, with its stats delta (counted as passed
        through only when the slice is out of the requant profile)."""
        for pos in positions:
            n = len(job.au.nals[pos])
            with job.lock:
                for delta in job.deltas:
                    d = RequantStats()
                    d.bytes_in += n
                    d.bytes_out += n
                    d.slices_passed_through += int(passed_through)
                    job.outs[delta][pos] = job.au.nals[pos]
                    job.stats[delta].append(d)
        with self._stats_lock:
            self.slices += len(positions) * len(job.deltas)

    def _dispatch_unit(self, loop, job: _AuJob) -> None:
        """The AU's single fused transform dispatch (slices × renditions
        in one call a kernel; asynchronous on a card, so device time
        hides behind the NEXT AU's parses on other workers), then the
        recode fan-out."""
        order = sorted(job.parsed)
        self._fill_source(job, [pos for pos in job.slice_idx
                                if pos not in job.parsed],
                          passed_through=True)
        dispatch = None
        if order:
            t0 = time.perf_counter()
            try:
                dispatch = FusedRequantDispatch(
                    [job.parsed[pos][1] for pos in order],
                    job.deltas, chroma_qp_offset=job.pps.chroma_qp_offset,
                    device=self.device)
                t1 = time.perf_counter()
                dispatch._harvested()    # the device wait lands here
            except Exception:
                # an upload, launch or readback error: counted apart from
                # the out-of-profile pass-through, traceback kept
                traceback.print_exc(file=sys.stderr)
                with self._stats_lock:
                    self.device_errors += 1
                self._fill_source(job, order, passed_through=False)
                order = []
            else:
                self._stage("transform_device", t0)
                with self._stats_lock:
                    # the leg's two halves: gather, staging and enqueue;
                    # then the wait on the readbacks' events
                    self.transform_submit_s += t1 - t0
                    self.transform_wait_s += time.perf_counter() - t1
                    self.dispatches += int(dispatch.luma_launched)
                    self.dispatches_chroma += int(dispatch.chroma_launched)
        if not order:
            if loop is not None:
                loop.call_soon_threadsafe(self._emit, job)
            return
        with job.lock:
            # swap the exhausted parse budget for the recode budget: one
            # unit per (slice, rendition)
            job.remaining = len(order) * len(job.deltas)
        if loop is None:
            for s_i, pos in enumerate(order):
                for d_i, delta in enumerate(job.deltas):
                    self._recode_unit(None, job, dispatch, s_i, pos,
                                      d_i, delta)
            return
        pool = _get_pool()
        for s_i, pos in enumerate(order):
            for d_i, delta in enumerate(job.deltas):
                pool.submit(self._recode_unit, loop, job, dispatch,
                            s_i, pos, d_i, delta)

    def _recode_unit(self, loop, job: _AuJob, dispatch, s_i: int,
                     pos: int, d_i: int, delta: int) -> None:
        """One rendition's serial entropy re-encode of one slice over
        the shared parse."""
        nal = job.au.nals[pos]
        parsed, gather = job.parsed[pos]
        d = RequantStats()
        d.bytes_in += len(nal)
        try:
            t0 = time.perf_counter()
            out, n_blocks = recode_parsed(parsed, gather, dispatch,
                                          s_i, d_i)
            self._stage("recode", t0)
            d.slices_requantized += 1
            d.blocks += n_blocks
        except Exception:
            out = nal                    # e.g. this rung's QP ceiling
            d.slices_passed_through += 1
        d.bytes_out += len(out)
        with job.lock:
            job.outs[delta][pos] = out
            job.stats[delta].append(d)
        with self._stats_lock:
            self.slices += 1
        self._complete_unit(loop, job)

    # -- synchronous path --------------------------------------------------
    def _run_job_inline(self, job: _AuJob) -> None:
        """The pooled pipeline, single-threaded (no loop running): same
        primitives, same order, same bytes."""
        if not job.slice_idx:
            return
        job.remaining = len(job.slice_idx)
        for pos in job.slice_idx:
            self._parse_unit(None, job, pos)

    # -- reassembly --------------------------------------------------------
    def _emit(self, job: _AuJob) -> None:
        """Ordered per-AU reassembly (loop/caller thread): verify every
        slice slot, merge each rendition's worker deltas into its stats
        ONCE, and feed the muxers in source order."""
        t0 = time.perf_counter()
        for delta in job.deltas:
            if any(n is None for n in job.outs[delta]):
                # a pipeline bookkeeping bug, never silent corruption:
                # count it, pass the source AU through for this rung,
                # and drop its stats (its output was discarded)
                job.mismatch = True
                job.outs[delta] = list(job.au.nals)
                job.stats[delta] = []
        self._ready[job.seq] = job
        emitted = 0
        latency = latency_max = 0.0
        while self._next_emit in self._ready:
            j = self._ready.pop(self._next_emit)
            self._next_emit += 1
            emitted += 1
            dt = time.perf_counter() - j.t_in
            latency += dt
            latency_max = max(latency_max, dt)
            for delta in j.deltas:
                out = self.renditions.get(delta)
                if out is None:
                    continue
                au_delta = RequantStats()
                for d in j.stats[delta]:
                    au_delta.merge(d)
                out.requant.stats.merge(au_delta)
                out._on_unit(AccessUnit(j.au.timestamp, j.outs[delta]))
        with self._stats_lock:
            self.aus += emitted
            self.mismatches += int(job.mismatch)
            self.latency_s += latency
            self.latency_s_max = max(self.latency_s_max, latency_max)
        self._stage("reassemble", t0)
