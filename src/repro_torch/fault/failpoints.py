"""Deterministic failpoints: named fault-injection sites.

A cut-down copy of ``repro.fault.failpoints`` (the port imports nothing of
the JAX package) holding what the port uses.  A *failpoint* is a named
call site threaded through the serving, sharding, mutation, persistence,
durability and autotune paths (``DECLARED_SITES``).  Production code calls
``hit(site)`` at each one; with nothing armed that is a single module-flag
check and an immediate return.  Tests and the crash sweeps arm sites with
a ``FaultSpec`` naming *when* to fire (explicit hit indices, or every hit,
capped by ``max_fires``) and *what* to do:

* ``raise``    — raise ``FaultInjected`` (a process "crash" at that site);
* ``delay``    — sleep ``delay_s`` then continue (stragglers, timeouts);
* ``corrupt``/``truncate`` — return the kind string; the site applies the
  damage itself (only sites that own bytes — ``index.save.write``,
  ``checkpoint.write``, ``wal.append`` — honor these; everywhere else an
  armed corrupt kind is a no-op).

Sub-targeting: a site that fans out over numbered children (shards) calls
``hit("shard.search", sub="1")``; arming ``shard.search`` fires on every
child while ``shard.search.1`` fires on child 1 only.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Dict, FrozenSet, Optional

KINDS = ("raise", "delay", "corrupt", "truncate")


class FaultInjected(RuntimeError):
    """An armed failpoint fired with ``kind="raise"``."""

    def __init__(self, site: str, hit_index: int):
        super().__init__(f"failpoint {site!r} fired (hit {hit_index})")
        self.site = site
        self.hit_index = hit_index


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """When and how one armed site fires.

    ``hits`` names explicit 0-based hit indices; with ``hits=None`` every
    hit fires.  ``max_fires`` caps total fires either way — the knob for
    "fail twice, then recover" schedules.
    """

    kind: str = "raise"
    hits: Optional[FrozenSet[int]] = None
    max_fires: Optional[int] = None
    delay_s: float = 0.05

    def __post_init__(self):
        assert self.kind in KINDS, f"unknown fault kind {self.kind!r}"
        if self.hits is not None:
            object.__setattr__(self, "hits", frozenset(int(h) for h in self.hits))


class _Armed:
    """Mutable per-site schedule state (guarded by the registry lock)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.hit_count = 0
        self.fire_count = 0

    def decide(self) -> bool:
        i, self.hit_count = self.hit_count, self.hit_count + 1
        s = self.spec
        if s.max_fires is not None and self.fire_count >= s.max_fires:
            return False
        fire = s.hits is None or i in s.hits
        if fire:
            self.fire_count += 1
        return fire

_LOCK = threading.Lock()
_SITES: Dict[str, _Armed] = {}   # guarded by: _LOCK
_ACTIVE = False          # fast path: hit() is one bool check when disarmed

# Every production failpoint site of the port, one name per ``hit(...)``
# call site (the ``write_site=``/``rename_site=`` arguments of the
# atomic-write helpers count: the literal lives at the caller).  Passive:
# ``arm()`` accepts any name so tests can use scratch sites.  The same
# names as the JAX package's.
DECLARED_SITES = frozenset({
    "serve.dispatch",
    "serve.worker",
    "shard.search",
    "sharded.search",
    "mutate.merge.build",
    "mutate.merge.swap",
    "index.save.write",
    "index.save.rename",
    "wal.append",
    "wal.fsync",
    "wal.rotate",
    "checkpoint.write",
    "manifest.rename",
    "autotune.step",
    "autotune.probe",
})


def arm(site: str, spec: Optional[FaultSpec] = None, **kw) -> None:
    """Arm ``site`` with ``spec`` (or ``FaultSpec(**kw)``), resetting its
    hit/fire counters."""
    global _ACTIVE
    if spec is None:
        spec = FaultSpec(**kw)
    elif kw:
        raise TypeError("pass a FaultSpec or kwargs, not both")
    with _LOCK:
        _SITES[site] = _Armed(spec)
        _ACTIVE = True


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site, or every site (``site=None``).  Counters drop."""
    global _ACTIVE
    with _LOCK:
        if site is None:
            _SITES.clear()
        else:
            _SITES.pop(site, None)
        _ACTIVE = bool(_SITES)


@contextmanager
def scoped(schedule: Dict[str, FaultSpec]):
    """Arm a whole schedule for the duration of a ``with`` block."""
    for site, spec in schedule.items():
        arm(site, spec)
    try:
        yield
    finally:
        for site in schedule:
            disarm(site)


def hit(site: str, sub: Optional[str] = None) -> Optional[str]:
    """One pass through the failpoint ``site``.

    Disarmed (the common case): returns ``None`` after a single flag
    check.  Armed and scheduled to fire: ``raise`` kinds raise
    ``FaultInjected``; ``delay`` sleeps then returns ``"delay"``; data
    kinds (``corrupt``/``truncate``) return the kind string for the call
    site to act on.  ``sub`` checks ``f"{site}.{sub}"`` as well, most
    specific first.
    """
    if not _ACTIVE:
        return None
    with _LOCK:
        ent = None
        name = site
        if sub is not None:
            name = f"{site}.{sub}"
            ent = _SITES.get(name)
        if ent is None:
            name = site
            ent = _SITES.get(site)
        if ent is None:
            return None
        fire = ent.decide()
        spec = ent.spec
        index = ent.hit_count - 1
    if not fire:
        return None
    if spec.kind == "raise":
        raise FaultInjected(name, index)
    if spec.kind == "delay":
        time.sleep(spec.delay_s)
        return "delay"
    return spec.kind


def fires(site: str) -> int:
    """How many times ``site`` has fired since it was armed (0 if never)."""
    with _LOCK:
        ent = _SITES.get(site)
        return ent.fire_count if ent is not None else 0

