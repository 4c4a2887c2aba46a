"""Deterministic fault injection for the durable write path.

The port's own copy of ``repro/serve/faults.py`` (standard library only,
like the original; the port imports nothing of the JAX package).  Named
**fault sites** in the write path call :func:`fire`, and an installed
:class:`FaultPlan` decides -- by site name and a per-site event counter --
whether the Nth event raises :class:`InjectedFault` or kills the process
with SIGKILL (a real ``kill -9``: no atexit, no flushing, no cleanup).

Sites wired in the port:

========================  ====================================================
``wal.append``            mid-append: frame header flushed, payload not yet
                          written (a torn frame on disk)
``wal.appended``          after the full frame is flushed to the OS
``wal.fsync``             pre-fsync: appends flushed but not yet durable
``wal.fsynced``           post-fsync
``ckpt.rename``           mid-snapshot: payload + manifest written to the
                          temp dir, final rename not yet performed
``seal``                  mid-seal: the SEAL record is in the WAL but the
                          segment mutation has not been applied
``snapshot``              per tenant, before its checkpoint is written
``compact.freeze``        mid-compaction freeze: the COMPACT record is in
                          the WAL, the delta not yet force-sealed
``compact.swap``          after the shadow build, before the swap
========================  ====================================================

With no plan installed :func:`fire` is one attribute load.  A plan can
come from the environment, for subprocesses::

    REPRO_FAULTS="wal.append:7:kill,seal:2:raise" python -m repro_torch.launch.serve ...

(``site:nth:action`` tuples, comma-separated; action ``raise`` | ``kill``.)
A ``raise`` that fires counts ``faults_fired_total{site}``, published
through an import inside :func:`fire`, so this module imports nothing of
the port at load.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import Dict, Optional

_ENV_FAULTS = "REPRO_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-action fault trigger (never by real code)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One trigger: the ``nth`` event at ``site`` performs ``action``."""

    site: str
    nth: int                 # 1-based: nth call to fire(site) triggers
    action: str = "raise"    # "raise" -> InjectedFault, "kill" -> SIGKILL

    def __post_init__(self):
        if self.nth < 1:
            raise ValueError(f"nth must be >= 1, got {self.nth}")
        if self.action not in ("raise", "kill"):
            raise ValueError(f"action must be 'raise' or 'kill', "
                             f"got {self.action!r}")


class FaultPlan:
    """A set of :class:`FaultSpec` triggers with per-site event counters.

    The counter is the number of times the instrumented code reached the
    site, which for a fixed workload is a fixed sequence: the same plan
    always detonates at the same state.
    """

    def __init__(self, *specs):
        self.specs: Dict[str, FaultSpec] = {}
        for s in specs:
            if not isinstance(s, FaultSpec):
                s = FaultSpec(*s)
            if s.site in self.specs:
                raise ValueError(f"duplicate fault site {s.site!r}")
            self.specs[s.site] = s
        self.counts: Dict[str, int] = {}
        self.fired: list = []            # sites that triggered (raise only)
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, value: Optional[str] = None) -> Optional["FaultPlan"]:
        """Parse ``REPRO_FAULTS`` (``site:nth:action,...``); None if unset."""
        value = os.environ.get(_ENV_FAULTS) if value is None else value
        if not value:
            return None
        specs = []
        for part in value.split(","):
            fields = part.strip().split(":")
            if len(fields) == 2:
                fields.append("raise")
            if len(fields) != 3:
                raise ValueError(f"bad {_ENV_FAULTS} entry {part!r} "
                                 f"(want site:nth[:action])")
            specs.append(FaultSpec(fields[0], int(fields[1]), fields[2]))
        return cls(*specs)

    def note(self, site: str) -> Optional[FaultSpec]:
        """Count one event at ``site``; return the spec iff it triggers."""
        with self._lock:
            n = self.counts.get(site, 0) + 1
            self.counts[site] = n
            spec = self.specs.get(site)
            if spec is not None and n == spec.nth:
                return spec
        return None


_plan: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` process-wide (None clears)."""
    global _plan
    _plan = plan


def clear() -> None:
    install(None)


def active_plan() -> Optional[FaultPlan]:
    return _plan


def fire(site: str) -> None:
    """Count one event at ``site`` and detonate if the active plan says
    this is the one.  No plan: no-op."""
    plan = _plan
    if plan is None:
        return
    spec = plan.note(site)
    if spec is None:
        return
    if spec.action == "kill":
        # a real kill -9: what the recovery path finds on disk is exactly
        # what was durable
        os.kill(os.getpid(), signal.SIGKILL)
    plan.fired.append(site)
    # lazy import keeps this module leaf-level; only a fault that fires
    # pays it
    from ..obs import metrics as obs_metrics
    obs_metrics.registry().inc("faults_fired_total", site=site)
    raise InjectedFault(f"injected fault at {site!r} "
                        f"(event #{spec.nth})")


def install_from_env() -> Optional[FaultPlan]:
    """Install whatever ``REPRO_FAULTS`` describes; returns the plan."""
    plan = FaultPlan.from_env()
    if plan is not None:
        install(plan)
    return plan
