"""Typed metrics registry with exporters gated to rank 0 (the port's own
stdlib copy of ``kfac_pytorch_tpu/obs/metrics.py``).

- typed metrics: :class:`Counter` (monotonic, cumulative), :class:`Gauge`
  (current value; optionally stale after each epoch flush),
  :class:`Watermark` (the epoch's maximum), :class:`Histogram` (bucketed,
  Prometheus-shaped);
- collectors: callables the registry runs at each epoch flush, so a
  source that keeps its own state (``resilience.counters``,
  ``utils.metrics.PhaseTimers``) publishes through one hook;
- exporters: JSONL, the native TensorBoard writer (``utils.summary``) and
  a Prometheus textfile, written by rank 0 only;
- :meth:`Registry.epoch_suffixes`, the epoch line's suffixes rendered by
  ``utils.runlog``'s formatters over the epoch view, byte for byte as
  the JAX package renders them.

The epoch view: counters give their delta since the last flush,
``*_level`` gauges their current value, watermarks the epoch's maximum.
The process id is the torch rank (``utils.runlog.process_index``).
"""

import json
import os
import threading
import time

#: histogram bucket default: step-time-shaped (seconds), exponential.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic cumulative count; epoch view = delta since last flush."""

    kind = 'counter'

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._mark = 0

    def inc(self, by=1):
        if by < 0:
            raise ValueError(f'counter {self.name} cannot decrease '
                             f'(inc by {by})')
        self.value += by

    def set_total(self, total):
        """Adopt an externally-maintained cumulative total (the
        resilience counters keep their own); monotonic non-decreasing."""
        if total >= self.value:
            self.value = total

    def rebase(self, total):
        """Adopt a restored baseline WITHOUT it appearing in the next
        epoch view (a resumed run's pre-resume events already happened)."""
        self.value = total
        self._mark = total

    def epoch_view(self):
        delta, self._mark = self.value - self._mark, self.value
        return delta


class Gauge:
    """Point-in-time value; epoch view = current value. With
    ``reset_on_flush`` the value goes STALE after each flush: a stale
    gauge is omitted from the next epoch view (a phase timing from two
    epochs ago must not leak into the next epoch's line) but keeps its
    last value for :meth:`Registry.snapshot` — exporters see the last
    known reading, standard gauge semantics."""

    kind = 'gauge'

    def __init__(self, name, reset_on_flush=False):
        self.name = name
        self.value = None
        self.reset_on_flush = reset_on_flush
        self._stale = False

    def set(self, value):
        self.value = value
        self._stale = False

    def epoch_view(self):
        if self._stale:
            return None
        if self.reset_on_flush:
            self._stale = True
        return self.value


class Watermark:
    """Per-epoch maximum (e.g. the health ladder's max rung); resets at
    each flush. Cumulative ``value`` stays the all-time max for
    exporters."""

    kind = 'watermark'

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._epoch_max = 0

    def set(self, value):
        self.value = max(self.value, value)
        self._epoch_max = max(self._epoch_max, value)

    def epoch_view(self):
        v, self._epoch_max = self._epoch_max, 0
        return v


class Histogram:
    """Bucketed distribution (cumulative-bucket counts, Prometheus
    shape). Epoch view = {count, sum, max} since last flush."""

    kind = 'histogram'

    def __init__(self, name, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.total = 0.0
        self.count = 0
        self._mark = (0, 0.0, 0.0)  # count, sum, epoch max

    def observe(self, value):
        value = float(value)
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += value
        self.count += 1
        c, s, m = self._mark
        self._mark = (c, s, max(m, value))

    def epoch_view(self):
        c0, s0, m = self._mark
        view = {'count': self.count - c0, 'sum': self.total - s0, 'max': m}
        self._mark = (self.count, self.total, 0.0)
        return view


class Registry:
    """The process metrics registry. Thread-safe creation; metric
    mutation uses plain attribute ops (ints/floats under the GIL —
    same contract as ``resilience.Counters``)."""

    def __init__(self, process_id=None):
        if process_id is None:
            from kfac_pytorch_tpu_torch.utils.runlog import process_index
            process_id = process_index()
        self.process_id = int(process_id)
        self._lock = threading.Lock()
        self._metrics = {}
        self._exporters = []
        self._collectors = []

    # -- metric accessors (create-on-first-use) ---------------------------

    def _get(self, name, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f'metric {name!r} already registered as {m.kind}, '
                    f'requested {cls.__name__.lower()}')
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name, reset_on_flush=False):
        g = self._get(name, Gauge, reset_on_flush=reset_on_flush)
        return g

    def watermark(self, name):
        return self._get(name, Watermark)

    def histogram(self, name, buckets=DEFAULT_BUCKETS):
        return self._get(name, Histogram, buckets=buckets)

    # -- collectors / exporters -------------------------------------------

    def add_collector(self, fn):
        """``fn(registry)`` runs at the top of every epoch flush —
        sources that own their own accumulation publish here."""
        self._collectors.append(fn)
        return fn

    def add_exporter(self, exporter):
        self._exporters.append(exporter)
        return exporter

    # -- views ------------------------------------------------------------

    def snapshot(self):
        """Cumulative {name: value} (histograms as dicts)."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            if m.kind == 'histogram':
                out[name] = {'count': m.count, 'sum': m.total,
                             'buckets': dict(zip(
                                 [*map(str, m.buckets), '+Inf'],
                                 _cumulate(m.counts)))}
            elif m.value is not None:
                out[name] = m.value
        return out

    def kinds(self):
        """{name: kind} — the typed half of :meth:`snapshot` (the
        Prometheus exporter declares TYPE from it instead of guessing
        from names)."""
        with self._lock:
            return {name: m.kind for name, m in self._metrics.items()}

    def epoch_flush(self):
        """Run collectors, return the per-epoch view {name: value} and
        advance every metric's epoch mark. Gauges that were never set
        (None) are omitted."""
        for fn in list(self._collectors):
            fn(self)
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            v = m.epoch_view()
            if v is not None:
                out[name] = v
        return out

    # -- legacy epoch-line rendering --------------------------------------

    def epoch_suffixes(self, view=None):
        """Render the legacy epoch-line suffixes from an epoch view
        (``epoch_flush()``'s dict; computed fresh when omitted).

        Grouping is by name prefix: ``health/*`` feeds
        ``runlog.health_suffix`` (needs skipped/fallbacks/max_rung),
        ``resilience/*`` feeds ``runlog.resilience_suffix``,
        ``kfac_phase/*`` feeds ``runlog.kfac_phase_suffix``. The
        formatters themselves are imported from ``utils.runlog`` — one
        source of truth, so the registry path is byte-identical to the
        hand-plumbed one by construction (and pinned by test).
        """
        from kfac_pytorch_tpu_torch.utils.runlog import (health_suffix,
                                                         kfac_phase_suffix,
                                                         resilience_suffix)
        if view is None:
            view = self.epoch_flush()
        groups = {'health': {}, 'resilience': {}, 'kfac_phase': {}}
        for name, v in view.items():
            if '/' not in name or isinstance(v, dict):
                continue
            prefix, key = name.split('/', 1)
            if prefix in groups:
                groups[prefix][key] = v
        parts = []
        h = groups['health']
        if h:
            parts.append(health_suffix({
                'skipped': h.get('skipped', 0),
                'fallbacks': h.get('fallbacks', 0),
                'max_rung': h.get('max_rung', 0)}))
        parts.append(resilience_suffix(groups['resilience']))
        parts.append(kfac_phase_suffix(groups['kfac_phase']))
        return ''.join(parts)

    # -- export -----------------------------------------------------------

    def export(self, step=None, wall=None):
        """Push the cumulative snapshot to every exporter. Gated to
        process 0 — non-zero ranks keep accumulating (their counters
        still feed epoch lines) but never write shared files, the same
        rank-gating the run-log file handler and the TensorBoard writer
        already use."""
        if self.process_id != 0 or not self._exporters:
            return 0
        snap = self.snapshot()
        kinds = self.kinds()
        wall = time.time() if wall is None else wall
        n = 0
        for exp in self._exporters:
            try:
                exp.export(snap, step=step, wall=wall, kinds=kinds)
                n += 1
            except Exception:  # noqa: BLE001 — an exporter must not
                pass           # take the trainer down
        return n

    def close(self):
        for exp in self._exporters:
            try:
                exp.close()
            except Exception:  # noqa: BLE001
                pass


def _cumulate(counts):
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


# -- exporters ----------------------------------------------------------------


class JsonlExporter:
    """One JSON object per export call, appended to a file:
    ``{"wall": ..., "step": ..., "metrics": {...}}``."""

    def __init__(self, path):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def export(self, snapshot, step=None, wall=None, kinds=None):
        with open(self.path, 'a') as f:
            f.write(json.dumps({'wall': wall, 'step': step,
                                'metrics': snapshot}) + '\n')

    def close(self):
        pass


class TensorBoardExporter:
    """Scalar export through the repo's native dependency-free writer
    (``utils.summary.SummaryWriter``). Accepts an existing writer (the
    trainers already construct one for loss/lr scalars) or a directory.
    Histogram metrics export their running mean."""

    def __init__(self, writer_or_dir):
        if isinstance(writer_or_dir, str):
            from kfac_pytorch_tpu_torch.utils.summary import SummaryWriter
            self._writer = SummaryWriter(writer_or_dir)
            self._owned = True
        else:
            self._writer = writer_or_dir
            self._owned = False

    def export(self, snapshot, step=None, wall=None, kinds=None):
        step = 0 if step is None else step
        for name, v in sorted(snapshot.items()):
            if isinstance(v, dict):  # histogram: export the mean
                if v.get('count'):
                    self._writer.add_scalar(name + '/mean',
                                            v['sum'] / v['count'], step)
                continue
            self._writer.add_scalar(name, float(v), step)
        self._writer.flush()

    def close(self):
        if self._owned:
            self._writer.close()


def job_namespace(env=None):
    """``'<tenant>-<job>'`` from the training service's per-job env
    (``KFAC_TENANT`` / ``KFAC_JOB_ID``), or None outside the service."""
    env = env if env is not None else os.environ
    tenant = (env.get('KFAC_TENANT') or '').strip()
    job = (env.get('KFAC_JOB_ID') or '').strip()
    if not tenant and not job:
        return None
    return '-'.join(p for p in (tenant, job) if p)


def namespaced_prom_path(path, env=None):
    """Namespace a Prometheus textfile path by tenant/job id.

    Two trainers exporting to the same textfile path silently clobber
    each other — the node-exporter collector sees whichever rename
    landed last, and both tenants read each other's gauges. Under the
    service env the default path therefore gains a ``<tenant>-<job>``
    suffix before the extension (``metrics.prom`` ->
    ``metrics-alice-job-000003.prom``); a path that already names the
    job is left alone, and outside the service this is the identity."""
    ns = job_namespace(env)
    if not path or not ns:
        return path
    head, base = os.path.split(path)
    if ns in base:
        return path
    root, ext = os.path.splitext(base)
    return os.path.join(head, f'{root}-{ns}{ext}')


class PrometheusTextfileExporter:
    """Standard Prometheus text exposition written atomically (tmp +
    rename — the node-exporter textfile collector reads these mid-run).
    Metric names are sanitized to the Prometheus charset and prefixed
    ``kfac_``.

    In-process collision guard: two live exporters on one path would
    interleave renames and each epoch's file would alternate between
    two unrelated metric sets — construction fails loudly instead
    (release the path with :meth:`close`). The CROSS-process case is
    handled by :func:`namespaced_prom_path` giving each service job its
    own file."""

    _claimed = {}   # abspath -> id(exporter)

    def __init__(self, path):
        self.path = path
        self._claim_key = os.path.abspath(path)
        holder = PrometheusTextfileExporter._claimed.get(self._claim_key)
        if holder is not None:
            raise ValueError(
                f'Prometheus textfile {path!r} is already exported by '
                'another live registry in this process — two writers '
                'would clobber each other\'s epochs. Namespace the '
                'path (namespaced_prom_path / KFAC_TENANT+KFAC_JOB_ID) '
                'or close the other exporter first.')
        PrometheusTextfileExporter._claimed[self._claim_key] = id(self)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    @staticmethod
    def _sanitize(name):
        out = []
        for ch in name:
            out.append(ch if (ch.isascii() and (ch.isalnum() or ch == '_'))
                       else '_')
        name = ''.join(out)
        if name and name[0].isdigit():
            name = '_' + name
        return 'kfac_' + name

    def export(self, snapshot, step=None, wall=None, kinds=None):
        kinds = kinds or {}
        lines = []
        for name, v in sorted(snapshot.items()):
            pname = self._sanitize(name)
            if isinstance(v, dict):  # histogram
                lines.append(f'# TYPE {pname} histogram')
                for le, c in v['buckets'].items():
                    lines.append(f'{pname}_bucket{{le="{le}"}} {c}')
                lines.append(f'{pname}_sum {v["sum"]}')
                lines.append(f'{pname}_count {v["count"]}')
            else:
                # the registry knows each metric's real kind; watermarks
                # (per-epoch maxima) expose as gauges
                kind = ('counter' if kinds.get(name) == 'counter'
                        else 'gauge')
                lines.append(f'# TYPE {pname} {kind}')
                lines.append(f'{pname} {v}')
        tmp = self.path + '.tmp'
        with open(tmp, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        os.replace(tmp, self.path)

    def close(self):
        if PrometheusTextfileExporter._claimed.get(self._claim_key) \
                == id(self):
            del PrometheusTextfileExporter._claimed[self._claim_key]


# -- built-in collectors ------------------------------------------------------


def resilience_collector(*extra_counts):
    """Collector that folds ``resilience.counters.snapshot()`` (and any
    ``extra_counts``: dicts, or callables returning one) into the
    registry.
    Event counts become ``resilience/<name>`` counters (epoch deltas on
    the line — ``counter_deltas`` semantics); ``*_level`` keys are
    gauges (current ladder position, passes through)."""
    def collect(reg):
        from kfac_pytorch_tpu_torch import resilience
        counts = resilience.counters.snapshot()
        for fn in extra_counts:
            counts.update(fn() if callable(fn) else fn)
        for k, v in counts.items():
            if k.endswith('_level'):
                reg.gauge('resilience/' + k).set(v)
            else:
                reg.counter('resilience/' + k).set_total(v)
    return collect
