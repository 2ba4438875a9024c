"""Seedable fault injection (port of `repro.runtime.chaos`; numpy only).

A deterministic :class:`FaultInjector` names the sites where the serving
stack can fail, and each site's code asks it, through the module-level
:func:`fire` / :func:`should_corrupt`, whether to fail, stall or tear its
payload there.  The sites and their schedules are the reference's, so one
seeded schedule replays the same faults on either package:

  ``checkpoint.write``      fired at the top of `repro_torch.checkpoint.
                            manager.save_pytree` -- a ``fail`` rule is a
                            transient IO error (the manager retries);
  ``checkpoint.payload``    checked after the arrays payload is written --
                            a ``corrupt`` rule tears the bytes on disk, and
                            verification and walk-back must skip it;
  ``gateway.tick``          fired inside `repro_torch.serving.gateway.
                            StatsGateway.tick`'s timed window -- a ``stall``
                            rule is a straggler device (tick deadline,
                            degraded mode);
  ``ingest.payload``        checked once per ADMITTED ingest submission in
                            ``StatsGateway.submit_ingest`` -- a ``corrupt``
                            rule poisons the payload with a NaN (sentinel,
                            per-tenant policies, tenant rebuild); call order
                            is submission order, so ``calls={k}`` targets
                            one (tick, tenant);
  ``backend.<primitive>``   fired by `repro_torch.core.backend.
                            CircuitBreakerBackend` before each call it
                            tries on its primary backend (not during an
                            open breaker's cooldown) -- a ``fail`` rule is
                            a kernel fault: the breaker serves the call by
                            its fallback and trips.

Rules match explicit 0-based call indices of their site and/or a seeded
per-site Bernoulli rate, so a chaos run replays bit for bit.  Install an
injector process-wide with :func:`install` (or :func:`scoped`); with none
installed the hooks are no-ops.  This module holds its own installed
schedule: arming the reference's `repro.runtime.chaos` does not arm it.

    inj = FaultInjector(seed=0)
    inj.corrupt("checkpoint.payload", calls={1})
    inj.stall("gateway.tick", calls={4}, seconds=0.2)
    with scoped(inj):
        ...   # drive the gateway; inj.log records every firing
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = [
    "InjectedFault",
    "FaultInjector",
    "install",
    "installed",
    "clear",
    "scoped",
    "fire",
    "should_corrupt",
]


class InjectedFault(RuntimeError):
    """The error a ``fail`` rule raises at its site (chaos, not a real bug)."""


@dataclasses.dataclass
class _Rule:
    site: str
    action: str                      # "fail" | "stall" | "corrupt"
    calls: Optional[frozenset]       # explicit 0-based call indices, or None
    rate: float = 0.0                # seeded Bernoulli, evaluated per call
    seconds: float = 0.0             # stall duration
    exc: type = InjectedFault        # what a fail rule raises

    def matches(self, n: int, draw: float) -> bool:
        if self.calls is not None and n in self.calls:
            return True
        return self.rate > 0.0 and draw < self.rate


def _as_calls(calls) -> Optional[frozenset]:
    if calls is None:
        return None
    if isinstance(calls, (int, np.integer)):
        return frozenset({int(calls)})
    return frozenset(int(c) for c in calls)


class FaultInjector:
    """A deterministic schedule of faults over named injection sites.

    Every site keeps its own 0-based call counter and its own seeded RNG
    substream (derived from ``seed`` and the site name), so adding a rule
    on one site never perturbs the draws — or the schedule — of another.
    ``log`` records every firing as ``(site, call_index, action)``; the
    per-site counters are exposed via :meth:`count`.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: List[_Rule] = []
        self._counts: Dict[str, int] = {}
        self._rngs: Dict[str, np.random.RandomState] = {}
        self.log: List[tuple] = []

    # -- schedule construction --------------------------------------------
    def fail(
        self,
        site: str,
        calls: Optional[Iterable[int]] = None,
        rate: float = 0.0,
        exc: type = InjectedFault,
    ) -> "FaultInjector":
        """Raise ``exc`` at the matching calls of ``site``."""
        self._rules.append(_Rule(site, "fail", _as_calls(calls), rate, exc=exc))
        return self

    def stall(
        self,
        site: str,
        calls: Optional[Iterable[int]] = None,
        rate: float = 0.0,
        seconds: float = 0.2,
    ) -> "FaultInjector":
        """Sleep ``seconds`` at the matching calls of ``site``."""
        self._rules.append(
            _Rule(site, "stall", _as_calls(calls), rate, seconds=float(seconds))
        )
        return self

    def corrupt(
        self,
        site: str,
        calls: Optional[Iterable[int]] = None,
        rate: float = 0.0,
    ) -> "FaultInjector":
        """Report ``True`` from :meth:`should_corrupt` at the matching calls
        (the call site owns *how* to tear its payload)."""
        self._rules.append(_Rule(site, "corrupt", _as_calls(calls), rate))
        return self

    # -- firing ------------------------------------------------------------
    def _rng(self, site: str) -> np.random.RandomState:
        rng = self._rngs.get(site)
        if rng is None:
            sub = (zlib.crc32(site.encode()) ^ self.seed) & 0xFFFFFFFF
            rng = self._rngs[site] = np.random.RandomState(sub)
        return rng

    def _step(self, site: str) -> tuple:
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        # one draw per call whether or not any rule is rated, so adding a
        # calls= rule never shifts a rate= rule's later draws on this site
        draw = float(self._rng(site).random_sample())
        return n, draw

    def fire(self, site: str) -> None:
        """One call at ``site``: apply any matching stall, then any
        matching fail (stalls-then-raise composes both)."""
        n, draw = self._step(site)
        failed: Optional[_Rule] = None
        for rule in self._rules:
            if rule.site != site or not rule.matches(n, draw):
                continue
            if rule.action == "stall":
                self.log.append((site, n, "stall"))
                time.sleep(rule.seconds)
            elif rule.action == "fail":
                failed = failed or rule
        if failed is not None:
            self.log.append((site, n, "fail"))
            raise failed.exc(
                f"injected fault at {site!r} (call {n}, seed {self.seed})"
            )

    def should_corrupt(self, site: str) -> bool:
        """One call at ``site``: does a ``corrupt`` rule match it?"""
        n, draw = self._step(site)
        for rule in self._rules:
            if rule.site == site and rule.action == "corrupt" and rule.matches(n, draw):
                self.log.append((site, n, "corrupt"))
                return True
        return False

    def count(self, site: str) -> int:
        """How many times ``site`` has fired (0-based next index)."""
        return self._counts.get(site, 0)


# -- process-wide installation (what the threaded call sites read) ----------
_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> None:
    """Make ``injector`` the process-wide active schedule."""
    global _ACTIVE
    _ACTIVE = injector


def installed() -> Optional[FaultInjector]:
    return _ACTIVE


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def scoped(injector: FaultInjector):
    """Install ``injector`` for the duration of a with-block (test scope)."""
    global _ACTIVE
    prev = _ACTIVE
    install(injector)
    try:
        yield injector
    finally:
        _ACTIVE = prev


def fire(site: str) -> None:
    """Module-level hook the instrumented layers call: no-op when no
    injector is installed, else one counted call at ``site``."""
    if _ACTIVE is not None:
        _ACTIVE.fire(site)


def should_corrupt(site: str) -> bool:
    if _ACTIVE is not None:
        return _ACTIVE.should_corrupt(site)
    return False
