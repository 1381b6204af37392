"""Jittered exponential backoff with deadline — the ONE retry/poll home.

A copy of the JAX package's ``utils/retry.py`` (the port keeps its own,
importing nothing from that package). Every seam that needs "try again in
a bit" goes through here instead of growing its own loop with its own
(usually missing) jitter, cap and deadline: an unjittered fleet
restart-storms in lockstep, an uncapped poll hangs forever.

Three primitives:

- :class:`Backoff` — a stateful jittered-exponential delay generator with
  ``reset()`` (the launcher resets it when the snapshot ring advances, the
  same signal that resets its restart budget).
- :func:`retry_call` — call a function until it succeeds, the attempt
  budget runs out, or the deadline passes. Never retries after success;
  always re-raises the last error when it gives up.
- :func:`wait_until` — bounded condition polling (the one sleep-poll
  loop), returning whether the predicate turned true in time.

Determinism: every random draw comes from the ``rng`` the caller passes
(``random.Random(seed)``); the default is a module-private instance so
production jitter stays uncorrelated across processes while chaos
schedules replay byte-for-byte.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

__all__ = ["Backoff", "RetryError", "RetryPolicy", "retry_call", "wait_until"]

_DEFAULT_RNG = random.Random()


@dataclass(frozen=True)
class RetryPolicy:
    """One retry/backoff shape.

    ``initial_s`` is the first delay's base; each subsequent base is
    multiplied by ``multiplier`` and capped at ``max_s``. Every emitted
    delay is drawn uniformly from ``[base * (1 - jitter), base]`` — jitter
    pulls *early*, never past the cap, so the worst case stays bounded.
    ``max_attempts`` bounds total calls (0 = unbounded by count);
    ``deadline_s`` bounds total elapsed time from the first attempt
    (None = unbounded). Whichever budget runs out first wins.
    """

    initial_s: float = 0.1
    max_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5
    max_attempts: int = 0
    deadline_s: Optional[float] = None


class RetryError(RuntimeError):
    """Raised by :func:`retry_call` when every attempt failed; the last
    underlying error rides as ``__cause__``."""


class Backoff:
    """Stateful delay generator over a :class:`RetryPolicy`.

    ``next_delay()`` returns the next jittered delay and advances the
    exponential base; ``sleep()`` additionally sleeps it; ``reset()``
    rewinds to the initial base (progress signal — e.g. the launcher's
    snapshot-ring advance). Deterministic given a seeded ``rng``.
    """

    def __init__(
        self,
        policy: RetryPolicy,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy
        self.rng = rng or _DEFAULT_RNG
        self._sleep = sleep
        self._clock = clock
        self.attempts = 0
        self._base = max(0.0, float(policy.initial_s))
        self._started: Optional[float] = None

    def reset(self) -> None:
        """Rewind to the initial base (attempt count and deadline too):
        the caller observed progress, so the next failure is a NEW episode,
        not a continuation of the old one."""
        self.attempts = 0
        self._base = max(0.0, float(self.policy.initial_s))
        self._started = None

    def next_delay(self) -> float:
        """The next jittered delay; advances the exponential base."""
        if self._started is None:
            self._started = self._clock()
        base = min(self._base, float(self.policy.max_s))
        j = min(max(float(self.policy.jitter), 0.0), 1.0)
        delay = base * (1.0 - j * self.rng.random()) if base > 0 else 0.0
        self._base = min(max(self._base, 1e-9) * float(self.policy.multiplier),
                         float(self.policy.max_s))
        self.attempts += 1
        return delay

    def sleep(self) -> float:
        d = self.next_delay()
        if d > 0:
            self._sleep(d)
        return d

    def expired(self) -> bool:
        """True when another attempt would bust a budget (attempts or
        deadline)."""
        p = self.policy
        if p.max_attempts and self.attempts >= p.max_attempts:
            return True
        if p.deadline_s is not None and self._started is not None:
            return self._clock() - self._started >= p.deadline_s
        return False


def retry_call(
    fn: Callable,
    *,
    policy: Optional[RetryPolicy] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    describe: str = "",
    on_retry: Optional[Callable[[BaseException, float, int], None]] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
):
    """Call ``fn()`` until it returns (never retried after success).

    A raised ``retry_on`` error consumes one attempt; when the policy's
    attempt or deadline budget is spent, the final error is re-raised
    wrapped in :class:`RetryError` (cause preserved) so callers can tell
    "gave up after retries" from a first-try failure type. ``on_retry``
    observes each retry as ``(error, upcoming_delay_s, attempt_number)``
    — the place callers hang logging/metrics.
    """
    policy = policy or RetryPolicy()
    backoff = Backoff(policy, rng=rng, sleep=sleep, clock=clock)
    what = describe or getattr(fn, "__name__", "call")
    started = clock()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - the retry loop IS the point
            if policy.max_attempts and attempt >= policy.max_attempts:
                raise RetryError(
                    f"{what} failed after {attempt} attempt(s): "
                    f"{type(e).__name__}: {e}") from e
            delay = backoff.next_delay()
            if (policy.deadline_s is not None
                    and clock() + delay - started > policy.deadline_s):
                # Honor the deadline strictly: never start a sleep that
                # would end past it.
                raise RetryError(
                    f"{what} deadline ({policy.deadline_s:.3f}s) reached "
                    f"after {attempt} attempt(s): "
                    f"{type(e).__name__}: {e}") from e
            if on_retry is not None:
                on_retry(e, delay, attempt)
            if delay > 0:
                sleep(delay)


def wait_until(
    predicate: Callable[[], bool],
    timeout_s: float,
    interval_s: float = 0.01,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> bool:
    """Poll ``predicate`` every ``interval_s`` until it returns true or
    ``timeout_s`` elapses; returns the predicate's final verdict. The ONE
    sleep-poll loop (drain/stop waits, strategy-file waits)."""
    deadline = clock() + max(0.0, float(timeout_s))
    while True:
        if predicate():
            return True
        now = clock()
        if now >= deadline:
            return bool(predicate())
        sleep(min(max(interval_s, 0.0), deadline - now))
