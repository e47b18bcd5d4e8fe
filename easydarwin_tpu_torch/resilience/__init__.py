"""Resilience subsystem: fault injection, degradation ladder, checkpoint.

The observability stack (``obs``) can *describe* a failure; this package
makes the server survive one — and makes failure reproducible enough to
test that claim continuously:

* ``resilience.inject`` — a seeded, config-driven :class:`FaultPlan`
  executed by the process-wide :data:`INJECTOR`: packet drop / reorder /
  corruption at ingest, EAGAIN / ENOBUFS / latency spikes at the native
  egress (the egress core's ``ed_fault_*`` knobs), device-dispatch
  exceptions and artificial stale params in the relay engines, and
  slow-subscriber backpressure.  Same seed → same injection schedule, so a chaos run is
  a regression test, not a dice roll.
* ``resilience.ladder`` — :class:`DegradationLadder`: a per-stream state
  machine megabatch → per-stream device → CPU oracle → shed-newest-
  subscribers with bounded retry-with-backoff before any rung change and
  time-hysteresis on the way back up, driven by device errors, SLO burn
  and injected-fault pressure.
* ``resilience.checkpoint`` — :class:`CheckpointManager`: periodic
  serialization of the relay bookkeeping (ring cursors, subscriber
  rewrite state, RR accounting — all plain integers)
  to ``<log_folder>/ckpt/``, restored on startup so a supervisor-
  restarted server resumes live relays without re-SETUP.

The package imports nothing of JAX and nothing of the reference package;
``tests/test_torch_resilience.py`` holds it against the reference's.
"""

from .inject import (  # noqa: F401
    INJECTOR, FaultInjector, FaultPlan, InjectedFault)
from .ladder import (  # noqa: F401
    LEVEL_CPU, LEVEL_DEVICE, LEVEL_FULL, LEVEL_SHED, RUNGS,
    DegradationLadder, LadderConfig)
from .checkpoint import (  # noqa: F401
    CKPT_VERSION, CheckpointManager, snapshot_registry)
