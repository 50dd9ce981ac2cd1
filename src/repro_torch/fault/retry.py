"""Jittered capped-exponential-backoff retry policy.

A copy of ``repro.fault.retry`` (the port imports nothing of the JAX
package).  One policy object serves every transient-failure caller: the
``QueueFull`` backpressure loop of ``examples/serve_anns_torch.py`` and the
background-merge retry inside ``MutableAnnIndex``.  Frozen and
seeded: the same policy replays the same backoff sequence, so chaos runs
and tests are deterministic.

Jitter exists to decorrelate retries across many callers (the classic
thundering-herd fix); the cap bounds the worst single wait.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type, Union

ExcTypes = Union[Type[BaseException], Tuple[Type[BaseException], ...]]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic seeded jitter.

    ``max_attempts`` counts calls, not retries: ``max_attempts=1`` never
    retries.  The d-th delay is ``min(base_s * multiplier**d, cap_s)``
    scaled by a jitter factor drawn uniformly from ``[1-jitter, 1+jitter]``
    (a fresh ``random.Random(seed)`` per ``delays()`` walk, so two walks of
    the same policy produce identical sequences).
    """

    max_attempts: int = 8
    base_s: float = 0.01
    cap_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: Optional[int] = None
    # total-budget cap: the SUMMED backoff sleeps never
    # exceed this — the last delay is truncated to fit and the schedule ends
    # there, so a retry loop can't overrun e.g. a quarantine cooldown no
    # matter how many attempts remain.  None = attempts-only bound.
    max_elapsed_s: Optional[float] = None

    def __post_init__(self):
        assert self.max_attempts >= 1, "need at least one attempt"
        assert self.base_s >= 0 and self.cap_s >= 0 and self.multiplier >= 1
        assert 0.0 <= self.jitter < 1.0, "jitter is a fraction of the delay"
        assert self.max_elapsed_s is None or self.max_elapsed_s >= 0

    def delays(self) -> Iterator[float]:
        """The (at most ``max_attempts - 1``) sleeps between attempts, in
        order.  With ``max_elapsed_s`` set the walk ends early once the
        budget is spent (its last delay truncated to exactly exhaust it)."""
        rng = random.Random(self.seed)
        d = self.base_s
        spent = 0.0
        for _ in range(self.max_attempts - 1):
            j = 1.0 + self.jitter * (2.0 * rng.random() - 1.0) \
                if self.jitter else 1.0
            s = min(d, self.cap_s) * j
            if self.max_elapsed_s is not None:
                remaining = self.max_elapsed_s - spent
                if remaining <= 0:
                    return
                s = min(s, remaining)
            spent += s
            yield s
            d = min(d * self.multiplier, self.cap_s)

    def call(self, fn: Callable, *args,
             retry_on: ExcTypes = Exception,
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             **kw):
        """Call ``fn`` under this policy, retrying on ``retry_on``.

        The final attempt's exception propagates unwrapped — whether the
        schedule ends on ``max_attempts`` or on an exhausted
        ``max_elapsed_s`` budget.  ``on_retry`` (attempt index, exception)
        observes each failure before its backoff sleep — telemetry's hook.
        ``sleep`` is injectable for tests.
        """
        delays = self.delays()
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kw)
            except retry_on as e:
                if attempt == self.max_attempts - 1:
                    raise
                try:
                    delay = next(delays)
                except StopIteration:
                    raise e          # noqa: B904 — budget spent: propagate
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)
        raise AssertionError("unreachable")
