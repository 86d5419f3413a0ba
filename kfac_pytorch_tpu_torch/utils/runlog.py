"""Per-run logging of the port's trainers (the port's own stdlib copy of
``kfac_pytorch_tpu/utils/runlog.py``).

Each run gets its own log file: the config-encoded stem the trainer
passes, plus a start-time suffix, opened fresh ('w'), so reruns of one
configuration never append into one stream. The flush chain (atexit and
SIGTERM) carries every registered flusher (the trace ring of
``obs.trace``) with the log handlers, so a crash or a preemption loses
neither tail. The epoch-line suffixes (``[health: ...]``,
``[resilience: ...]``, `` kfac_phase_ms=...``) are formatted here, byte
for byte as the JAX package formats them.

The process id of :func:`setup_run_logging` is the torch process group's
rank, or ``RANK`` as the launcher (``launch.py``, torchrun) sets it
(:func:`process_index`).
"""

import atexit
import logging
import os
import signal
import time

_FLUSH_HOOKS_INSTALLED = False
_PREV_SIGTERM = None
_EXTRA_FLUSHERS = []

#: ``extra=`` of a record the trainer has already printed to stdout: the
#: run log's stream handler leaves it out, its file handler keeps it
PRINTED = {'printed': True}


def process_index():
    """This process's rank: the default torch process group's when one is
    initialized, else ``RANK`` from the launcher's environment (0
    without)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get('RANK', '0'))


def register_flusher(fn):
    """Add a callback to the run-log flush chain (idempotent): it runs
    wherever the log handlers flush (atexit, SIGTERM, any
    :func:`flush_all_handlers` call)."""
    if fn not in _EXTRA_FLUSHERS:
        _EXTRA_FLUSHERS.append(fn)


def unregister_flusher(fn):
    """Remove a callback added by :func:`register_flusher`."""
    if fn in _EXTRA_FLUSHERS:
        _EXTRA_FLUSHERS.remove(fn)


def flush_all_handlers():
    """Flush every registered flusher, then every root-logger handler
    (best-effort: the flushers go first, so a line they log is carried
    by the handler flush)."""
    for fn in list(_EXTRA_FLUSHERS):
        try:
            fn()
        except Exception:  # noqa: BLE001 - flushing is best-effort
            pass
    for h in logging.getLogger().handlers:
        try:
            h.flush()
        except Exception:  # noqa: BLE001 - flushing is best-effort
            pass


def _sigterm_flush(signum, frame):
    """Flush the run log, then get out of the signal's way: called as the
    predecessor of a handler installed over it (a ``PreemptionGuard``),
    only flush; still the installed handler, put back the one from before
    and deliver the signal again, so the process ends as it would have."""
    flush_all_handlers()
    if signal.getsignal(signum) is _sigterm_flush:
        prev = _PREV_SIGTERM
        signal.signal(signum,
                      prev if callable(prev) or prev in (
                          signal.SIG_IGN,) else signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_flush_hooks():
    """Idempotent: flush the run log (and the registered flushers) at exit
    and on SIGTERM."""
    global _FLUSH_HOOKS_INSTALLED, _PREV_SIGTERM
    if _FLUSH_HOOKS_INSTALLED:
        return
    _FLUSH_HOOKS_INSTALLED = True
    atexit.register(flush_all_handlers)
    try:
        _PREV_SIGTERM = signal.signal(signal.SIGTERM, _sigterm_flush)
    except ValueError:  # pragma: no cover - not the main thread: atexit only
        pass


def uninstall_flush_hooks():
    """Undo :func:`install_flush_hooks`."""
    global _FLUSH_HOOKS_INSTALLED, _PREV_SIGTERM
    if not _FLUSH_HOOKS_INSTALLED:
        return
    _FLUSH_HOOKS_INSTALLED = False
    atexit.unregister(flush_all_handlers)
    if signal.getsignal(signal.SIGTERM) is _sigterm_flush:
        signal.signal(signal.SIGTERM,
                      _PREV_SIGTERM if _PREV_SIGTERM is not None
                      else signal.SIG_DFL)
    _PREV_SIGTERM = None


class _NotPrinted(logging.Filter):
    def filter(self, record):
        return not getattr(record, 'printed', False)


def setup_run_logging(log_dir, *parts, unique=True, process_id=None):
    """``basicConfig`` with a stream handler and, on process 0, a per-run
    file handler (``'%(asctime)s %(message)s'``). ``parts`` are joined
    with '_' (None and '' dropped). Returns ``(logger, logfile_path)``,
    the path None on the other processes: on a shared filesystem their
    files would truncate each other. ``process_id`` defaults to
    :func:`process_index`. A record logged with ``extra=PRINTED`` goes to
    the file only: the port's trainers print their lines to stdout
    themselves."""
    if process_id is None:
        process_id = process_index()
    stream = logging.StreamHandler()
    stream.addFilter(_NotPrinted())
    handlers = [stream]
    path = None
    if process_id == 0:
        os.makedirs(log_dir, exist_ok=True)
        stem = '_'.join(str(p) for p in parts if p not in (None, ''))
        if unique:
            stem += time.strftime('_%m%dT%H%M%S')
        path = os.path.join(log_dir, stem + '.log')
        handlers.append(logging.FileHandler(path, mode='w'))
    logging.basicConfig(
        level=logging.INFO, format='%(asctime)s %(message)s', force=True,
        handlers=handlers)
    install_flush_hooks()
    return logging.getLogger(), path


def health_suffix(epoch_counts):
    """An epoch's health-guard deltas for the epoch line:
    ``metrics.HealthMonitor.epoch_flush()``'s dict formats to '' for a
    clean epoch, else e.g. `` [health: skipped=2 sgd_fallbacks=1
    max_rung=1]`` (grep run logs for ``[health:``)."""
    if not epoch_counts or not any(epoch_counts.values()):
        return ''
    return (' [health: skipped=%d sgd_fallbacks=%d max_rung=%d]'
            % (epoch_counts['skipped'], epoch_counts['fallbacks'],
               epoch_counts['max_rung']))


def kfac_phase_suffix(phase_ms):
    """Per-phase K-FAC step times for the epoch line:
    ``metrics.PhaseTimers.epoch_flush()``'s dict (marginals in ms, with
    ``step_mean``/``step_max``) formats to e.g. ``
    kfac_phase_ms=decomp+gather:3.10,pred:1.20,step_max:6.00,
    step_mean:4.80`` (keys sorted), '' when empty."""
    if not phase_ms:
        return ''
    body = ','.join(f'{k}:{v:.2f}' for k, v in sorted(phase_ms.items()))
    return f' kfac_phase_ms={body}'


def counter_deltas(now, prev):
    """The epoch's view of cumulative counters: ``now - prev`` per key,
    except ``*_level`` keys, which are gauges and pass through."""
    return {k: (v if k.endswith('_level') else v - prev.get(k, 0))
            for k, v in now.items()}


_RES_SUFFIX = None  # compiled on first use


def parse_resilience_suffix(line):
    """The ``{name: value}`` of a line's ``[resilience: k=v ...]`` suffix
    ({} without one): ints where they parse, else floats, else the raw
    string."""
    global _RES_SUFFIX
    if _RES_SUFFIX is None:
        import re
        _RES_SUFFIX = re.compile(r'\[resilience: ([^\]]+)\]')
    m = _RES_SUFFIX.search(line)
    if not m:
        return {}
    out = {}
    for part in m.group(1).split():
        if '=' not in part:
            continue
        k, v = part.split('=', 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def resilience_suffix(counts):
    """Process-resilience counters for a log line: '' when all are zero,
    else e.g. `` [resilience: io_retries=2]`` (nonzero keys, sorted)."""
    if not counts or not any(counts.values()):
        return ''
    body = ' '.join(f'{k}={v}' for k, v in sorted(counts.items()) if v)
    return f' [resilience: {body}]'
