"""Deterministic failpoints: named fault-injection sites.

A cut-down copy of ``repro.fault.failpoints`` (the port imports nothing of
the JAX package), holding what index persistence uses.  A *failpoint* is a
named call site; the port has two, both in ``AnnIndex.save``
(``index.save.write`` and ``index.save.rename``).  Production code calls
``hit(site)`` at each one; with nothing armed that is a single module-flag
check and an immediate return.  Tests arm a site with a ``FaultSpec``
naming what to do on every hit:

* ``raise``    — raise ``FaultInjected`` (a process "crash" at that site);
* ``corrupt``/``truncate`` — return the kind string; the site applies the
  damage itself (only ``index.save.write``, which owns the bytes, honors
  these).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Dict, Optional

KINDS = ("raise", "corrupt", "truncate")


class FaultInjected(RuntimeError):
    """An armed failpoint fired with ``kind="raise"``."""

    def __init__(self, site: str, hit_index: int):
        super().__init__(f"failpoint {site!r} fired (hit {hit_index})")
        self.site = site
        self.hit_index = hit_index


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What one armed site does on every hit."""

    kind: str = "raise"

    def __post_init__(self):
        assert self.kind in KINDS, f"unknown fault kind {self.kind!r}"


_LOCK = threading.Lock()
_SITES: Dict[str, FaultSpec] = {}   # guarded by: _LOCK
_FIRES: Dict[str, int] = {}         # guarded by: _LOCK
_ACTIVE = False          # fast path: hit() is one bool check when disarmed


def arm(site: str, spec: Optional[FaultSpec] = None, **kw) -> None:
    """Arm ``site`` with ``spec`` (or ``FaultSpec(**kw)``), resetting its
    fire count."""
    global _ACTIVE
    if spec is None:
        spec = FaultSpec(**kw)
    elif kw:
        raise TypeError("pass a FaultSpec or kwargs, not both")
    with _LOCK:
        _SITES[site] = spec
        _FIRES[site] = 0
        _ACTIVE = True


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site, or every site (``site=None``).  Counts drop."""
    global _ACTIVE
    with _LOCK:
        if site is None:
            _SITES.clear()
            _FIRES.clear()
        else:
            _SITES.pop(site, None)
            _FIRES.pop(site, None)
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


def hit(site: str) -> Optional[str]:
    """One pass through the failpoint ``site``.

    Disarmed (the common case): returns ``None`` after a single flag
    check.  Armed: ``raise`` raises ``FaultInjected``; the data kinds
    (``corrupt``/``truncate``) return the kind string for the call site to
    act on.
    """
    if not _ACTIVE:
        return None
    with _LOCK:
        spec = _SITES.get(site)
        if spec is None:
            return None
        index = _FIRES[site]
        _FIRES[site] = index + 1
    if spec.kind == "raise":
        raise FaultInjected(site, index)
    return spec.kind


def fires(site: str) -> int:
    """How many times ``site`` has fired since it was armed (0 if never)."""
    with _LOCK:
        return _FIRES.get(site, 0)
