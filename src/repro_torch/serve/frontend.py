"""The serving frontend: futures queue -> bucketed micro-batches -> engines.

The counterpart of ``repro.serve.frontend``.  ``ServeFrontend`` is the
piece between "a numpy array of queries" and the search engines (DESIGN.md
§6): callers ``submit()`` arbitrary-size query
batches and get ``concurrent.futures.Future``s; the micro-batcher coalesces
pending requests, rounds each dispatch up the bucket ladder (pad +
``valid`` mask — padded lanes never pollute results or counters), and runs
the session's warmed engine, so a ragged request stream pays no first-use
event (a new batch shape, an engine setup, a kernel library load) after
warmup.

Sessions: one engine session per *canonical* ``SearchSpec`` (the engine
cache key) — requests override only the request-only fields
``k``/``cos_theta``, which never shape the engine.  Submitting a
spec whose canonical form is new creates (and warms) a new session.

Admission control, not silent degradation:

* a request larger than the top bucket raises ``RequestRejected`` — it is
  never truncated or split behind the caller's back;
* ``k`` beyond the session's ``efs`` raises — it would widen the pool;
* a full queue raises ``QueueFull`` (backpressure to the caller);
* a request whose deadline passes while queued fails its future with
  ``DeadlineExceeded`` at dispatch time (admission deadline: once a request
  makes it into a dispatch it always completes).

Dispatch grouping: requests sharing a session and an effective
``cos_theta`` coalesce (the threshold is one scalar per engine call);
``k`` mixes freely — the dispatch searches ``max(k)`` and each request
slices its own ``k`` from the pool.

Threading: ``flush()`` is synchronous and deterministic (tests, benchmarks
drive it directly).  ``start()`` spawns a daemon worker that flushes
whenever requests are pending — the launcher's "serve forever" mode.  Both
may run concurrently; the queue and dispatch path are lock-protected.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.spec import SearchSpec
from repro_torch.fault import failpoints as fault
from repro_torch.serve.backends import make_session
from repro_torch.serve.bucketing import (DEFAULT_BUCKETS, bucket_for,
                                         pad_to_bucket, validate_buckets)
from repro_torch.serve.telemetry import ServeTelemetry


class RequestRejected(RuntimeError):
    """Admission control refused the request (oversized, bad k, ...)."""


class QueueFull(RequestRejected):
    """Backpressure: the pending-row budget is exhausted; retry later."""


class DeadlineExceeded(RequestRejected):
    """The request's deadline passed while it waited in the queue."""


class FrontendStopped(RequestRejected):
    """``submit()`` after ``stop()``: the frontend is no longer accepting
    requests.  ``start()`` reopens it."""


class WorkerFailure(RuntimeError):
    """The background flush loop itself failed (NOT a per-batch engine
    error — those resolve onto their batch's futures).  Stored on the
    frontend and re-raised, wrapped, from the next ``submit()``/``flush()``
    on a caller thread, so a silent worker death cannot strand a trace."""


@dataclasses.dataclass
class _Request:
    queries: np.ndarray          # [n, d] f32, preprocessed by the engine
    n: int
    k: int
    cos_theta: Optional[float]   # None -> the index's profile
    deadline: Optional[float]    # absolute perf_counter() time
    t_submit: float
    future: Future


class _Session:
    """One canonical SearchSpec: engine binding + its own FIFO queue."""

    def __init__(self, index, spec: Optional[SearchSpec]):
        self.engine = make_session(index, spec)
        self.spec = self.engine.spec
        self.queue: deque = deque()
        self.warmed = False


class ServeFrontend:
    """Bucketed dynamic batcher over the port's four index types."""

    def __init__(self, index, spec: Optional[SearchSpec] = None, *,
                 buckets=DEFAULT_BUCKETS, max_pending_rows: int = 1024,
                 default_timeout: Optional[float] = None, warmup: bool = True):
        self.index = index
        self.buckets = validate_buckets(buckets)
        self.max_pending_rows = int(max_pending_rows)
        self.default_timeout = default_timeout
        self.telemetry = ServeTelemetry()
        self._lock = threading.RLock()          # queue + session state
        self._dispatch_lock = threading.Lock()  # serializes engine calls
        self._pending_rows = 0                  # guarded by: self._lock
        # spec -> session -- guarded by: self._lock
        self._sessions: Dict[SearchSpec, _Session] = {}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._stopped = False                   # stop() called, no start() yet
        self.worker_error: Optional[BaseException] = None
        self.autotune = None        # AutotuneDriver.attach registers itself
        self._base = self._session(spec)
        if warmup:
            self.warmup()

    # --- sessions ---------------------------------------------------------
    def _session(self, spec: Optional[SearchSpec]) -> _Session:
        """The session for ``spec`` (created on first use).  Request-only
        field differences map to the same session."""
        with self._lock:
            if spec is None:
                sess = getattr(self, "_base", None)
                if sess is not None:
                    return sess
            s = _Session(self.index, spec)
            key = s.spec.canonical()
            if key in self._sessions:
                return self._sessions[key]
            self._sessions[key] = s
            return s

    def activate_spec(self, spec: SearchSpec) -> SearchSpec:
        """Hot-swap the default session: pre-warm, THEN atomically switch.

        The autotune controller's promotion path (DESIGN.md §12).  The new
        spec's session runs every bucket rung off the request path
        (under the dispatch lock only — concurrent submits keep flowing
        into the old default), and only then does the default-session
        pointer flip, under the state lock.  Requests already queued on the
        old session still dispatch through it — an admitted future always
        resolves — and the old session stays warm for an instant switch
        back.  Returns the activated session's resolved spec.
        """
        if spec is None:
            raise TypeError("activate_spec requires an explicit SearchSpec")
        sess = self._session(spec)
        self._warm_session(sess)                # no-op if already warm
        with self._lock:
            self._base = sess
        return sess.spec

    @property
    def active_spec(self) -> SearchSpec:
        """The default session's resolved spec (what ``spec=None`` gets)."""
        return self._base.spec

    def warmup(self):
        """Run every bucket rung of every session once (first uses off the
        request path).  Idempotent; new sessions warm on creation via
        ``submit``."""
        with self._lock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            self._warm_session(sess)
        self.telemetry.mark_warm()

    def _warm_session(self, sess: _Session):
        """Run every rung once for one session.  Runs under the DISPATCH
        lock only: a first use (a kernel library's nvcc build among them)
        must never hold the state lock (it would block every concurrent
        submit and queue drain)."""
        if sess.warmed:
            return
        with self._dispatch_lock:
            if sess.warmed:           # lost the race: another thread warmed
                return
            q1 = sess.engine.sample_query()[None, :]
            for b in self.buckets:
                qb, _ = pad_to_bucket(q1, b)
                c0 = sess.engine.compile_count()
                t0 = time.perf_counter()
                sess.engine.search_padded(qb, 1, sess.spec.k,
                                          sess.spec.cos_theta)
                self.telemetry.observe_dispatch(
                    b, 0, time.perf_counter() - t0,
                    sess.engine.compile_count() - c0, None)
            sess.warmed = True

    # --- submission -------------------------------------------------------
    def submit(self, queries: np.ndarray, *, spec: Optional[SearchSpec] = None,
               k: Optional[int] = None, cos_theta: Optional[float] = None,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future of (ids, dists, stats).

        ``spec`` selects/creates the engine session; ``k``/``cos_theta``
        override its request-only fields.  ``timeout`` (seconds) is the
        admission deadline.  Raises ``RequestRejected``/``QueueFull``
        synchronously — an admitted future always resolves.
        """
        if self._stopped:
            raise FrontendStopped(
                "frontend is stopped; call start() to accept requests again")
        self._raise_worker_error()
        with self._lock:
            self.telemetry.submitted += 1
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            self._reject(f"expected [n>=1, d] queries, got {q.shape}")
        sess = self._session(spec)
        if q.shape[1] != sess.engine.dim:
            self._reject(
                f"query dim {q.shape[1]} != index dim {sess.engine.dim}")
        n = q.shape[0]
        if n > self.buckets[-1]:
            self._reject(
                f"batch of {n} rows exceeds the largest bucket "
                f"{self.buckets[-1]}; split the request or widen the ladder")
        kk = sess.spec.k if k is None else int(k)
        if not 1 <= kk <= sess.spec.efs:
            self._reject(
                f"k={kk} outside [1, efs={sess.spec.efs}] — a wider pool "
                "would widen the engine's pool; open a session with larger "
                "efs")
        if not sess.warmed:
            # first use of a late-created session: warm its rungs off
            # the request path, WITHOUT holding the state lock
            self._warm_session(sess)
        timeout = self.default_timeout if timeout is None else timeout
        now = time.perf_counter()
        with self._lock:
            if self._pending_rows + n > self.max_pending_rows:
                self.telemetry.rejected += 1
                raise QueueFull(
                    f"{self._pending_rows} rows pending >= budget "
                    f"{self.max_pending_rows}; retry after a flush")
            req = _Request(
                queries=q, n=n, k=kk,
                cos_theta=cos_theta if cos_theta is not None
                else sess.spec.cos_theta,
                deadline=None if timeout is None else now + timeout,
                t_submit=now, future=Future())
            sess.queue.append(req)
            self._pending_rows += n
        self._wake.set()
        return req.future

    def _reject(self, msg: str):
        with self._lock:
            self.telemetry.rejected += 1
        raise RequestRejected(msg)

    def search(self, queries: np.ndarray, **kw
               ) -> Tuple[np.ndarray, np.ndarray, object]:
        """Blocking convenience: submit + flush + result."""
        fut = self.submit(queries, **kw)
        if self._worker is None:
            self.flush()
        return fut.result()

    # --- dispatch ---------------------------------------------------------
    def flush(self) -> int:
        """Drain every session queue once; returns the dispatch count.

        The queue pop (fast) runs under the state lock; the engine calls
        (slow) run under a separate dispatch lock, so concurrent
        ``submit()``s are never blocked behind a running search.
        """
        with self._lock:
            work = [(sess, self._drain(sess))
                    for sess in list(self._sessions.values())]
        n_dispatched = 0
        with self._dispatch_lock:
            for sess, admitted in work:
                n_dispatched += self._dispatch_admitted(sess, admitted)
        # AFTER the drain: queued futures resolve first, then a stored
        # worker failure surfaces to the calling thread
        self._raise_worker_error()
        return n_dispatched

    def _raise_worker_error(self):
        """Surface a background-worker failure on a CALLER thread (the
        worker itself flushes too — re-raising there would just loop)."""
        if self.worker_error is None:
            return
        if threading.current_thread() is self._worker:
            return
        err, self.worker_error = self.worker_error, None
        raise WorkerFailure(
            "background serve worker hit an unexpected error; queued "
            "requests were drained — call start() again to resume") from err

    def _drain(self, sess: _Session) -> List[_Request]:
        """Pop the session queue (state lock held); fail expired futures."""
        now = time.perf_counter()
        admitted: List[_Request] = []
        while sess.queue:
            r = sess.queue.popleft()
            # repolint: ignore[guarded-by] calling contract (see docstring):
            # flush() and the worker loop invoke _drain under self._lock
            self._pending_rows -= r.n
            if r.deadline is not None and now > r.deadline:
                self.telemetry.expired += 1
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed after {now - r.t_submit:.3f}s in queue"))
                continue
            admitted.append(r)
        return admitted

    def _dispatch_admitted(self, sess: _Session,
                           admitted: List[_Request]) -> int:
        # group by effective cos_theta (one traced scalar per engine call),
        # FIFO within each group
        groups: Dict[object, List[_Request]] = {}
        for r in admitted:
            groups.setdefault(r.cos_theta, []).append(r)
        n_dispatched = 0
        for ct, reqs in groups.items():
            batch, rows = [], 0
            for r in reqs:
                if rows + r.n > self.buckets[-1]:
                    self._dispatch(sess, batch, rows, ct)
                    n_dispatched += 1
                    batch, rows = [], 0
                batch.append(r)
                rows += r.n
            if batch:
                self._dispatch(sess, batch, rows, ct)
                n_dispatched += 1
        return n_dispatched

    def _dispatch(self, sess: _Session, batch: List[_Request], rows: int,
                  cos_theta: Optional[float]):
        bucket = bucket_for(rows, self.buckets)
        q = (batch[0].queries if len(batch) == 1
             else np.concatenate([r.queries for r in batch], axis=0))
        qp, _ = pad_to_bucket(q, bucket)
        k_d = max(r.k for r in batch)
        c0 = sess.engine.compile_count()
        t0 = time.perf_counter()
        try:
            fault.hit("serve.dispatch")
            ids, dists, stats = sess.engine.search_padded(
                qp, rows, k_d, cos_theta)
        except Exception as e:                     # noqa: BLE001
            # the failure belongs to THIS batch's futures only: callers see
            # it via result(), and the flush loop keeps dispatching the
            # other groups/sessions (an admitted future always resolves)
            self.telemetry.observe_dispatch_failure(len(batch))
            for r in batch:
                r.future.set_exception(e)
            return
        t1 = time.perf_counter()
        self.telemetry.observe_dispatch(
            bucket, rows, t1 - t0, sess.engine.compile_count() - c0, stats)
        lo = 0
        for r in batch:
            hi = lo + r.n
            r_stats = sess.engine.stats_for_rows(stats, lo, hi)
            r.future.set_result(
                (ids[lo:hi, :r.k], dists[lo:hi, :r.k], r_stats))
            self.telemetry.observe_request_done(
                t1 - r.t_submit, t0 - r.t_submit)
            lo = hi

    # --- health -----------------------------------------------------------
    def health(self) -> dict:
        """Operational state as a plain dict (launcher/monitoring surface):
        acceptance + worker liveness, queue depth, any stored worker error,
        the active canonical spec + windowed p99 (what the autotune loop
        acts on), the attached controller's own state, and the backend
        session's degraded/quarantined state."""
        with self._lock:
            base = self._base
            h = {
                "stopped": self._stopped,
                "worker_alive": (self._worker is not None
                                 and self._worker.is_alive()),
                "queue_depth_rows": self._pending_rows,
                "queued_requests": sum(len(s.queue)
                                       for s in self._sessions.values()),
                "sessions": len(self._sessions),
                "worker_error": (repr(self.worker_error)
                                 if self.worker_error is not None else None),
                "worker_errors_total": self.telemetry.worker_errors,
            }
        h["active_spec"] = dataclasses.asdict(base.spec.canonical())
        snap = self.telemetry.window_snapshot()
        h["latency_window"] = {
            "p99_ms": snap["latency"]["p99_ms"],
            "qps": snap["window_qps"],
            "served": snap["served"],
        }
        h["autotune"] = (self.autotune.health()
                         if self.autotune is not None else None)
        h["backend"] = base.engine.health()
        return h

    # --- background worker --------------------------------------------------
    def start(self, poll_s: float = 0.05) -> "ServeFrontend":
        """Spawn the daemon flush loop ("serve forever" mode).  Also
        reopens a ``stop()``ed frontend for submissions."""
        self._stopped = False
        if self._worker is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._wake.wait(timeout=poll_s)
                self._wake.clear()
                try:
                    fault.hit("serve.worker")
                    self.flush()
                except Exception as e:             # noqa: BLE001
                    # per-batch failures land on their futures inside
                    # _dispatch; anything reaching here is unexpected — keep
                    # the worker alive and surface it on the frontend
                    self.worker_error = e
                    self.telemetry.worker_errors += 1

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="serve-frontend")
        self._worker.start()
        return self

    def stop(self):
        """Stop accepting requests, stop the worker, and drain what is
        still queued (an admitted future always resolves).  Idempotent —
        a second ``stop()`` is a no-op; ``submit()`` afterwards raises
        ``FrontendStopped`` until ``start()`` reopens the frontend."""
        if self._stopped:
            return
        self._stopped = True
        if self._worker is not None:
            self._stop.set()
            self._wake.set()
            self._worker.join()
            self._worker = None
        self.flush()

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
