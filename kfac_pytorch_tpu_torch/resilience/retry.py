"""Retry with backoff and jitter for transient host-side failures (the
port's copy of ``kfac_pytorch_tpu/resilience/retry.py``; stdlib only).

- :func:`call_with_retry`: one idempotent call (a checkpoint save, whose
  puts are atomic temp-and-rename, or a restore).
- :func:`resumable_iter`: an iterator whose producer can die mid-epoch
  (the next-batch path): the broken iterator is rebuilt and fast-forwarded
  past the items already delivered, so the consumer sees the sequence an
  unfaulted epoch would have produced.

The clock (``monotonic`` and ``sleep``) and the jitter RNG are
injectable: with :class:`ManualClock` a test pins the attempts, the
delays and the deadline without sleeping.
"""

import dataclasses
import logging
import random
import time
from typing import Callable, Optional, Tuple

from kfac_pytorch_tpu_torch import resilience as _res

log = logging.getLogger(__name__)


class RetryError(RuntimeError):
    """Raise from an ``on_retry`` callback to stop retrying; the helper
    then re-raises the original failure, not this marker."""


class _RealClock:
    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


REAL_CLOCK = _RealClock()


class ManualClock:
    """A clock for tests: ``sleep`` advances ``monotonic`` at once and
    records every delay asked for."""

    def __init__(self, start=0.0):
        self.now = float(start)
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps.append(float(seconds))
        self.now += float(seconds)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` tries in all; retry ``k`` (from 0) waits
    ``base_delay * multiplier**k``, capped at ``max_delay`` and jittered
    uniformly into ``[d*(1-jitter), d*(1+jitter)]``. ``deadline`` bounds
    the whole affair: a retry whose wait would end more than ``deadline``
    seconds after the first attempt is not taken."""
    attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline: Optional[float] = None
    retry_on: Tuple[type, ...] = (OSError, TimeoutError)

    def delay(self, k, rng):
        try:
            raw = self.base_delay * self.multiplier ** k
        except OverflowError:
            raw = self.max_delay
        d = min(self.max_delay, raw)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


def call_with_retry(fn, *, policy=None, clock=None, rng=None,
                    on_retry: Optional[Callable] = None, label=None,
                    counter='io_retries'):
    """``fn()`` under ``policy``; once the attempts (or the deadline) are
    spent the last failure is re-raised as it was, so a caller's
    ``except OSError`` still holds. ``on_retry(exc, attempt, delay)``
    runs before each wait; a :class:`RetryError` from it stops the
    retries (the original failure propagates). Each retry is logged and
    bumps ``resilience.counters`` under ``counter``."""
    policy = policy or RetryPolicy()
    clock = clock or REAL_CLOCK
    rng = rng or random
    start = clock.monotonic()
    for attempt in range(policy.attempts):
        try:
            return fn()
        except policy.retry_on as e:
            last = attempt == policy.attempts - 1
            delay = policy.delay(attempt, rng)
            over = (policy.deadline is not None and
                    clock.monotonic() + delay - start > policy.deadline)
            if last or over:
                raise
            _res.counters.bump(counter)
            log.warning('retry %d/%d%s in %.2fs after: %s',
                        attempt + 1, policy.attempts - 1,
                        f' ({label})' if label else '', delay, e)
            if on_retry is not None:
                try:
                    on_retry(e, attempt, delay)
                except RetryError:
                    raise e from None
            clock.sleep(delay)
    raise RetryError('RetryPolicy.attempts must be >= 1, got '
                     f'{policy.attempts}')


def resumable_iter(make_iter, *, policy=None, clock=None, rng=None,
                   label=None, counter='data_retries'):
    """A generator over ``make_iter()`` that survives a transient failure
    of its producer: the iterator is rebuilt and fast-forwarded past the
    items already delivered. Correct only when ``make_iter()`` replays the
    same sequence each call (``data.Loader.epoch`` draws its epoch seed
    once, up front, for this). The retry budget is the iterator's whole
    lifetime's, not an item's. Each retry bumps ``resilience.counters``
    under ``counter``."""
    policy = policy or RetryPolicy()
    clock = clock or REAL_CLOCK
    rng = rng or random
    delivered = 0
    failures = 0
    start = clock.monotonic()
    it = None
    try:
        while True:
            try:
                # the rebuild and the replay share the next()'s try: a
                # producer that fails again mid-replay draws from the
                # same budget
                if it is None:
                    it = make_iter()
                    for _ in range(delivered):
                        next(it)
                item = next(it)
            except StopIteration:
                return
            except policy.retry_on as e:
                failures += 1
                delay = policy.delay(failures - 1, rng)
                over = (policy.deadline is not None and
                        clock.monotonic() + delay - start > policy.deadline)
                if failures >= policy.attempts or over:
                    raise
                _res.counters.bump(counter)
                log.warning(
                    'next-batch retry %d/%d%s in %.2fs (rebuilding the '
                    'iterator, skipping %d delivered batches) after: %s',
                    failures, policy.attempts - 1,
                    f' ({label})' if label else '', delay, delivered, e)
                clock.sleep(delay)
                _close(it)
                it = None
                continue
            delivered += 1
            yield item
    finally:
        _close(it)


def _close(it):
    close = getattr(it, 'close', None)
    if callable(close):
        try:
            close()
        except Exception:  # noqa: BLE001 - already tearing down
            pass
