"""Spans and counters inside the program, in memory, for this process.

Counters are always on:

* named totals (``add``, ``totals``) of one-time work: the K-NN build's
  product and selection on the device (``knn.product_s``,
  ``knn.select_s``: ``core/knn_graph.py``) and the SQ8 set-up on the host
  (``engine.sq8_s``: ``core/search.py``'s ``ensure_sq8_arrays``), in
  seconds, and counts: the hop iterations captured as CUDA graphs
  (``search.graph_captures``), the lanes the router pruned and the lanes
  that took a first-stage distance, exact or SQ8 (``search.pruned``,
  ``search.first_stage``: ``core/index.py``'s ``search_on``), the query
  rows of a cosine index normalised on the card (``search.normalised_rows``:
  ``search_on``), and the angle
  profile's queries and samples (``profile.queries``, ``profile.samples``:
  ``core/angles.py``);
* a log of the last ``CALL_LOG_MAX`` search engine calls (``calls``), one
  ``Call`` each: its rows and hop-loop iterations, how many of those were
  replays of a captured graph (``graph_iters``), the loop's host time
  split into the time blocked in its ``done.all()`` reads (``sync_ns``)
  and the rest (``dispatch_ns``), its host start and end, whether a torch
  profiler was active and whether it was a first use of the engine.

Spans are recorded only between ``enable()`` and ``disable()``; ``drain()``
returns and clears them (the last ``SPAN_LOG_MAX``).  Each has a name, a
start and an end (``time.perf_counter_ns``), its own id, its parent's id
and the request id of the engine call it belongs to.  Whether or not they
are recorded, while a torch profiler is active each *leaf* span (a phase)
also opens a ``torch.profiler.record_function`` range of its name, so the
profiler's trace names the program's phases beside the device's
operations.  The spans of a call and of an iteration (``leaf=False``) open
no range: each phase's range is then a direct child of the range the caller
has open.

``span(name)`` is a context manager; the hop loop marks its phases one
after another with ``phases()`` instead (``Phases.hop``, ``Phases.to``),
since a ``with`` block costs ~0.2 us of host time even when it does
nothing.  Off and outside a profiler, both are one shared object that
does nothing, behind one check.  An iteration that replays a captured
CUDA graph marks one phase, ``hop.replay``, in place of ``hop.beam``
through ``hop.merge`` (and ``hop.capture`` before it, if it captured the
graph).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

CALL_LOG_MAX = 4096
SPAN_LOG_MAX = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]


@dataclasses.dataclass
class Call:
    """One search engine call (``SearchEngine.__call__``)."""

    request: int
    rows: int = 0
    iters: int = 0
    graph_iters: int = 0     # of the iters, replays of a captured graph
    dispatch_ns: int = 0     # hop-loop host time less sync_ns
    sync_ns: int = 0         # host time blocked in the loop's done.all() reads
    start_ns: int = 0        # host clock, time.perf_counter_ns
    end_ns: int = 0
    profiled: bool = False   # a torch profiler was active during the call
    first_use: bool = False  # a new batch shape, or a kernel library loaded


_LOCK = threading.Lock()
_TOTALS: Dict[str, float] = defaultdict(float)    # guarded by: _LOCK
_CALLS: deque = deque(maxlen=CALL_LOG_MAX)         # guarded by: _LOCK
_SPANS: deque = deque(maxlen=SPAN_LOG_MAX)         # guarded by: _LOCK
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_ON = False


class _Thread(threading.local):
    def __init__(self):
        self.open: list = []     # the thread's open spans, innermost last
        self.request = None      # its engine call's request id
        self.call = None         # its engine call in progress


_LOCAL = _Thread()


def enable() -> None:
    """Record spans from now on."""
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def drain() -> List[Span]:
    """The spans recorded so far, which are then cleared."""
    with _LOCK:
        out = list(_SPANS)
        _SPANS.clear()
    return [Span(*s) for s in out]


def add(name: str, value: float) -> None:
    """Add ``value`` to the named total."""
    with _LOCK:
        _TOTALS[name] += value


def totals() -> Dict[str, float]:
    with _LOCK:
        return dict(_TOTALS)


def log_call(call: Call) -> None:
    with _LOCK:
        _CALLS.append(call)


def calls() -> List[Call]:
    """The logged engine calls, oldest first."""
    with _LOCK:
        return list(_CALLS)


def reset() -> None:
    """Clear the totals, the call log and the recorded spans."""
    with _LOCK:
        _TOTALS.clear()
        _CALLS.clear()
        _SPANS.clear()


# --- spans --------------------------------------------------------------------

class _Open:
    """A span while it is open (from its construction; also a context
    manager): recorded at its end if it began recorded; its range, if it
    opened one, ends with it."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "rf")

    def __init__(self, name: str, leaf: bool):
        stack = _LOCAL.open
        self.name = name
        self.rf = None
        if leaf and _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(name)
            self.rf.__enter__()
        self.id = None
        if _ON:
            self.id = next(_IDS)
            self.parent = next((s.id for s in reversed(stack)
                                if s.id is not None), None)
            self.request = _LOCAL.request
        stack.append(self)
        self.start_ns = time.perf_counter_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        """End this span and, first, every span opened inside it that is
        still open (an exception left it so)."""
        end = time.perf_counter_ns()
        stack = _LOCAL.open
        if stack and stack[-1] is self:
            stack.pop()
            self._end(end)
            return
        if not any(s is self for s in stack):
            return                      # an enclosing span ended it
        while True:
            s = stack.pop()
            s._end(end)
            if s is self:
                return

    def _end(self, end_ns: int) -> None:
        if self.id is not None:
            with _LOCK:
                _SPANS.append((self.name, self.start_ns, end_ns, self.id,
                               self.parent, self.request))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)


_NULL = contextlib.nullcontext()


def span(name: str, leaf: bool = True):
    """A context manager: the span ``name`` (``leaf=False``: a call or an
    iteration, which opens no profiler range)."""
    if not _ON and not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, leaf)


class Phases:
    """The phases of one hop loop, marked one after another.

    ``hop()`` ends the open phase and iteration and opens a ``hop`` span;
    ``to(name)`` ends the open phase and opens the leaf span ``name``,
    inside the open iteration if ``name`` starts with ``hop.`` (else the
    iteration ends first); ``close()`` ends what is open.
    """

    __slots__ = ("_hop", "_phase")

    def __init__(self):
        self._hop = self._phase = None

    def _end_phase(self):
        if self._phase is not None:
            self._phase.close()
            self._phase = None

    def _end_hop(self):
        self._end_phase()
        if self._hop is not None:
            self._hop.close()
            self._hop = None

    def hop(self) -> None:
        self._end_hop()
        self._hop = _Open("hop", leaf=False)

    def to(self, name: str) -> None:
        if name.startswith("hop."):
            self._end_phase()
        else:
            self._end_hop()
        self._phase = _Open(name, leaf=True)

    def close(self) -> None:
        self._end_hop()


class _NoPhases:
    __slots__ = ()

    def hop(self) -> None:
        pass

    def to(self, name: str) -> None:
        pass

    def close(self) -> None:
        pass


NO_PHASES = _NoPhases()


def phases():
    """A ``Phases`` for one hop loop; the shared one that does nothing
    (``NO_PHASES``) while spans are off and no profiler is active."""
    if not _ON and not _profiler._is_profiler_enabled:
        return NO_PHASES
    return Phases()


# --- engine calls ---------------------------------------------------------------

@contextlib.contextmanager
def call():
    """One search engine call: its ``Call`` (logged when the call returns)
    and its root span ``search``, whose request id every span opened inside
    it carries; spans opened later on the thread, up to its next call,
    carry it too (the caller's copy of the results)."""
    rec = Call(request=next(_REQUESTS), start_ns=time.perf_counter_ns(),
               profiled=_profiler._is_profiler_enabled)
    outer = _LOCAL.call
    _LOCAL.call = rec
    _LOCAL.request = rec.request
    try:
        with span("search", leaf=False):
            yield rec
    finally:
        _LOCAL.call = outer
    rec.end_ns = time.perf_counter_ns()
    rec.profiled = rec.profiled or _profiler._is_profiler_enabled
    log_call(rec)


def hop_loop(iters: int, dispatch_ns: int, sync_ns: int,
             graph_iters: int = 0) -> None:
    """Add one hop loop's iterations (``graph_iters`` of them replays of a
    captured graph) and host times to the engine call in progress on this
    thread (none: the loop ran outside an engine call)."""
    rec = _LOCAL.call
    if rec is not None:
        rec.iters += iters
        rec.graph_iters += graph_iters
        rec.dispatch_ns += dispatch_ns
        rec.sync_ns += sync_ns


class Stopwatch:
    """Seconds of stretches of work on ``device``, added to named totals.

    ``mark()`` marks the point the work queued so far has reached: a timing
    CUDA event recorded on the device's current stream, or the host clock
    for a CPU device (whose work is done when its call returns).
    ``lap(name, a, b)`` counts the stretch from mark ``a`` to mark ``b``
    under ``name``; ``commit()`` adds the counted seconds to the totals. Call
    it once the device has finished the work (after a copy to the host that
    waits for it): it adds no synchronisation of its own.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.laps: list = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    def lap(self, name: str, a, b) -> None:
        self.laps.append((name, a, b))

    def commit(self) -> None:
        sums: Dict[str, float] = defaultdict(float)
        for name, a, b in self.laps:
            sums[name] += a.elapsed_time(b) / 1e3 if self.cuda else b - a
        self.laps = []
        for name, s in sums.items():
            add(name, s)
