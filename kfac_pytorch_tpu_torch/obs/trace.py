"""Structured trace spans in the Chrome trace-event format (the port's
own stdlib copy of ``kfac_pytorch_tpu/obs/trace.py``).

One :class:`TraceRecorder` per process buffers events in a bounded ring
and appends them to a JSONL file, one event object per line (Perfetto
and ``chrome://tracing`` load the file wrapped as ``{"traceEvents":
[...]}``). The events carry wall-clock microsecond timestamps, so files
of several ranks merge on one axis:

- complete spans (``ph='X'``): a train step (``kfac.step``, the trainer's
  ``PhaseTimers``), one dispatch of the step function (``kfac.dispatch``),
  one timed ``--speed`` iteration (``bench.iter``);
- instants (``ph='i'``): point events;
- metadata (``ph='M'``) and a ``clock_sync`` instant: the process's name
  and one paired (wall, monotonic) reading.

Span names follow the K-FAC phase taxonomy (``kfac.ComputeFactor`` and
the other ``exclude_parts`` names). :meth:`TraceRecorder.span` with
``profiler=True`` also opens ``torch.profiler.record_function(name)``,
so the same label marks the range in a ``torch.profiler`` trace of the
card (``utils.profiling.trace``): the JAX package's bridge keyword was
``xla=True`` and entered ``jax.named_scope``.

The ring is flushed through the run log's SIGTERM/atexit chain
(``utils.runlog.register_flusher``), so a preemption loses no more of
the trace than of the log. The process id is the torch rank
(``utils.runlog.process_index``).
"""

import contextlib
import json
import os
import threading
import time
from collections import deque

#: launcher -> trainer trace contract: a directory (per-host file name
#: is derived from the process id) or an exact file path.
ENV_TRACE_DIR = 'KFAC_TRACE_DIR'

#: default ring capacity: ~64k events is hours of per-step spans at
#: trainer cadence, and a few MiB of JSONL — bounded by construction so
#: a forgotten tracer can never eat the host's memory.
DEFAULT_MAXLEN = 65536

_DEFAULT = None
_DEFAULT_LOCK = threading.Lock()


class TraceRecorder:
    """Bounded in-memory trace buffer with JSONL append-on-flush.

    ``path=None`` keeps events purely in memory (tests, ad-hoc
    inspection via :meth:`events`). All mutators are thread-safe: an
    instant may come from a background thread while the trainer emits
    step spans.
    """

    def __init__(self, path=None, *, maxlen=DEFAULT_MAXLEN,
                 process_id=None, clock=time.time,
                 perf=time.perf_counter):
        if process_id is None:
            from kfac_pytorch_tpu_torch.utils.runlog import process_index
            process_id = process_index()
        self.path = path
        self.process_id = int(process_id)
        self._clock = clock
        self._perf = perf
        self._lock = threading.Lock()
        self._buf = deque(maxlen=maxlen)
        self._pushed = 0    # total events ever buffered
        self._flushed = 0   # total events ever written
        self.dropped = 0    # overwrote-before-flush count (ring wrapped)
        # process metadata + one paired clock reading: the aggregator
        # aligns hosts on wall time and can bound skew against the
        # monotonic reading of later sync instants
        self.emit({'ph': 'M', 'name': 'process_name', 'pid': self.process_id,
                   'tid': 0, 'ts': 0,
                   'args': {'name': f'host{self.process_id}'}})
        self.clock_sync()

    # -- raw event plumbing -----------------------------------------------

    def emit(self, event):
        """Buffer one already-shaped Chrome trace event dict."""
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(event)
            self._pushed += 1
        return event

    def _base(self, name, ph, cat, args):
        evt = {'name': name, 'ph': ph, 'cat': cat,
               'ts': self._clock() * 1e6, 'pid': self.process_id,
               'tid': threading.get_ident() % 2**31}
        if args:
            evt['args'] = args
        return evt

    # -- the public event shapes ------------------------------------------

    @contextlib.contextmanager
    def span(self, name, cat='kfac', profiler=False, **args):
        """Record a complete span around the with-block. ``profiler=True``
        also opens ``torch.profiler.record_function(name)`` around it, so a
        ``torch.profiler`` trace shows the same label over the work the
        block launches (a range costs a few microseconds of host time when
        no profiler runs)."""
        cm = contextlib.nullcontext()
        if profiler:
            import torch
            cm = torch.profiler.record_function(name)
        t_wall = self._clock()
        t0 = self._perf()
        try:
            with cm:
                yield
        finally:
            dur = self._perf() - t0
            evt = self._base(name, 'X', cat, args)
            evt['ts'] = t_wall * 1e6
            evt['dur'] = dur * 1e6
            self.emit(evt)

    def complete(self, name, seconds, cat='kfac', end_wall=None, **args):
        """Record an already-measured span ending now (or ``end_wall``):
        :meth:`span` after the fact, for a caller that timed the work
        itself (``PhaseTimers.record``: the step's time includes the loss
        read that synchronizes it, which no context manager inside the
        step can see)."""
        end = self._clock() if end_wall is None else end_wall
        evt = self._base(name, 'X', cat, args)
        evt['ts'] = (end - seconds) * 1e6
        evt['dur'] = seconds * 1e6
        return self.emit(evt)

    def instant(self, name, cat='resilience', scope='p', **args):
        """Record a point event (``scope``: p=process, t=thread,
        g=global — resilience events default to process scope)."""
        evt = self._base(name, 'i', cat, args)
        evt['s'] = scope
        return self.emit(evt)

    def counter(self, name, values, cat='kfac'):
        """Record a Chrome counter sample (``values``: {series: num})."""
        return self.emit(self._base(name, 'C', cat, dict(values)))

    def clock_sync(self):
        """Paired (wall, monotonic) reading for cross-host alignment."""
        return self.instant('clock_sync', cat='meta', scope='p',
                            wall=self._clock(),
                            monotonic=time.monotonic())

    # -- draining ---------------------------------------------------------

    def events(self):
        """Snapshot of the currently-buffered events (does not drain)."""
        with self._lock:
            return list(self._buf)

    def flush(self):
        """Append buffered events to ``path`` as JSONL and clear the
        ring. No-op without a path. Safe to call from signal handlers
        (the runlog flush chain) — any I/O error is swallowed: flushing
        is best-effort exactly like the log-handler flushes beside it.

        Signal-context caveat handled here: a SIGTERM can interrupt the
        MAIN thread inside an ``emit()`` lock section, and the handler
        then runs flush() on that same thread — a blocking acquire
        would self-deadlock on the non-reentrant lock. The bounded
        acquire below times out only in exactly that case (any OTHER
        holder is a live thread that releases in microseconds), and the
        fallback proceeds unlocked: the interrupted holder is suspended,
        so the worst case is one racing background-thread event landing
        in the old deque after the swap — bounded loss on a process
        that is dying anyway, instead of a hang that eats the
        preemption grace window.
        """
        if self.path is None:
            return 0
        locked = self._lock.acquire(timeout=1.0)
        try:
            batch, self._buf = list(self._buf), deque(
                maxlen=self._buf.maxlen)
        finally:
            if locked:
                self._lock.release()
        if not batch:
            return 0
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, 'a') as f:
                for evt in batch:
                    f.write(json.dumps(evt) + '\n')
                f.flush()
            self._flushed += len(batch)  # GIL-atomic; see caveat above
            return len(batch)
        except OSError:
            # put the batch back IN ORDER at the old end (a transient
            # filesystem error must not silently discard the
            # post-mortem); if the ring overflows, the deque evicts
            # from the new end — counted as drops either way. Same
            # bounded-acquire discipline as the swap above.
            locked = self._lock.acquire(timeout=1.0)
            try:
                overflow = (len(batch) + len(self._buf)
                            - self._buf.maxlen)
                self.dropped += max(overflow, 0)
                self._buf.extendleft(reversed(batch))
            finally:
                if locked:
                    self._lock.release()
            return 0

    def stats(self):
        with self._lock:
            return {'buffered': len(self._buf), 'pushed': self._pushed,
                    'flushed': self._flushed, 'dropped': self.dropped}


# -- process-default recorder -------------------------------------------------
#
# Code that narrates calls the module-level instant()/span() below; with
# no recorder installed they are near-free no-ops, so tracing stays
# opt-in.

def get():
    """The installed process-default recorder, or None."""
    return _DEFAULT


def install(path=None, recorder=None, **kw):
    """Install a process-default recorder and hook its flush into the
    run-log SIGTERM/atexit chain. Idempotent-by-replacement: installing
    over an existing recorder flushes and unhooks the old one first.
    Returns the installed recorder."""
    global _DEFAULT
    from kfac_pytorch_tpu_torch.utils.runlog import (install_flush_hooks,
                                                     register_flusher)
    rec = recorder if recorder is not None else TraceRecorder(path, **kw)
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _uninstall_locked()
        _DEFAULT = rec
        register_flusher(rec.flush)
        install_flush_hooks()
    return rec


def _uninstall_locked():
    global _DEFAULT
    from kfac_pytorch_tpu_torch.utils.runlog import unregister_flusher
    rec, _DEFAULT = _DEFAULT, None
    if rec is not None:
        unregister_flusher(rec.flush)
        rec.flush()
    return rec


def uninstall():
    """Flush + remove the process-default recorder (test isolation)."""
    with _DEFAULT_LOCK:
        return _uninstall_locked()


def install_from_env(env=None, role=None):
    """Install a default recorder iff ``env`` (default the process's)
    holds :data:`ENV_TRACE_DIR`: a directory (files named
    ``trace-host<rank>[-role].jsonl``) or an exact ``*.jsonl`` path. One
    variable turns tracing on in every rank of a run; ``role`` keeps two
    processes of one rank out of each other's file. The rank is ``env``'s
    ``RANK``, else :func:`utils.runlog.process_index`. Returns the
    recorder or None."""
    env = os.environ if env is None else env
    target = env.get(ENV_TRACE_DIR)
    if not target:
        return None
    if 'RANK' in env:
        pid = int(env['RANK'])
    else:
        from kfac_pytorch_tpu_torch.utils.runlog import process_index
        pid = process_index()
    if target.endswith('.jsonl'):
        # the role disambiguator applies here too: two co-hosted
        # processes appending to one file interleave partial lines
        path = (target[:-len('.jsonl')] + f'-{role}.jsonl' if role
                else target)
    else:
        stem = f'trace-host{pid}' + (f'-{role}' if role else '')
        path = os.path.join(target, stem + '.jsonl')
    return install(path, process_id=pid)


def instant(name, cat='resilience', **args):
    """Module-level instant on the default recorder (no-op without one):
    cheap and exception-free on every path, interpreter shutdown
    included."""
    rec = _DEFAULT
    if rec is None:
        return None
    try:
        return rec.instant(name, cat=cat, **args)
    except Exception:  # noqa: BLE001 — observability never takes the run down
        return None


@contextlib.contextmanager
def span(name, cat='kfac', profiler=False, **args):
    """Module-level span on the default recorder (plain pass-through
    with-block without one; ``profiler=True`` still opens the profiler
    range)."""
    rec = _DEFAULT
    if rec is None:
        if profiler:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        return
    with rec.span(name, cat=cat, profiler=profiler, **args):
        yield


def flush():
    """Flush the default recorder (no-op without one)."""
    rec = _DEFAULT
    return rec.flush() if rec is not None else 0


# -- phase taxonomy -----------------------------------------------------------

#: the step's host phase labels (``training`` ``step_fn.last_phases``) ->
#: the exclude_parts taxonomy that the profiler ranges of
#: ``preconditioner.py`` carry. 'pred', the preconditioning, has no
#: exclude_parts name of its own: 'Precondition', as its range.
PHASE_TAXONOMY = {
    'stats': 'ComputeFactor',
    'decomp': 'ComputeInverse',
    'gather': 'CommunicateInverse',
    'pred': 'Precondition',
}


def taxonomy_phases(phases):
    """Map a step's host phase set to sorted ledger-taxonomy names."""
    return sorted(PHASE_TAXONOMY.get(p, p) for p in phases)
