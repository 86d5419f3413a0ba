"""Training metrics (the port of ``kfac_pytorch_tpu/utils/metrics.py``):
:func:`accuracy`, :func:`topk_accuracy`, :class:`Metric` (a weighted
running average, summed over the trainer's process group by
:meth:`Metric.sync`), :class:`HealthMonitor` (the guard's counters, read
on the host) and :class:`PhaseTimers` (the step's wall time split by
K-FAC phase set)."""

import logging

import torch
import torch.distributed as dist


def accuracy(outputs, labels):
    """Top-1 accuracy from logits."""
    return (outputs.argmax(dim=-1) == labels).to(torch.float32).mean()


def topk_accuracy(outputs, labels, k=5):
    """Top-``k`` accuracy from logits: a hit when the label is among the
    ``k`` largest (``argsort``'s last ``k``, as the JAX package takes
    them)."""
    topk = outputs.argsort(dim=-1)[:, -k:]
    return (topk == labels[:, None]).any(dim=-1).to(torch.float32).mean()


class Metric:
    """Weighted running average of scalars (loss, accuracy). ``group``:
    the trainer's process group, over which :meth:`sync` sums."""

    def __init__(self, name, group=None):
        self.name = name
        self.group = group
        self.total = 0.0
        self.n = 0.0

    def update(self, val, n=1):
        self.total += float(val) * n
        self.n += n

    @property
    def avg(self):
        return self.total / max(self.n, 1e-12)

    def sync(self):
        """Sum ``(total, n)`` over the group (the reference's all-reduced
        average); a no-op at world 1. Every rank must call it."""
        if self.group is None or dist.get_world_size(self.group) == 1:
            return self
        dev = ('cuda' if dist.get_backend(self.group) == 'nccl'
               else 'cpu')
        t = torch.tensor([self.total, self.n], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, group=self.group)
        self.total, self.n = float(t[0]), float(t[1])
        return self


class HealthMonitor:
    """Host-side reader of the step metrics' ``health/*`` counters.

    The step returns CUMULATIVE device counters (batches skipped,
    raw-SGD fallbacks, the ladder's rung); the monitor diffs them between
    ``update`` calls and logs a WARNING when something happens (a skipped
    batch, a fallback, a climb of the ladder; recovery at INFO), so a run
    log carries each event at its step. ``epoch_flush`` returns (and
    resets) the epoch's deltas for the epoch line
    (``utils.runlog.health_suffix`` formats them).

    Reading the counters adds no device sync to a trainer that already
    reads the loss every step."""

    def __init__(self, log=None, state=None, registry=None):
        """``state``: the (possibly restored) TrainState, so the baseline
        starts from ITS counters and a resumed run does not announce the
        skips from before the resume again.

        ``registry``: an ``obs.metrics.Registry``, to which the monitor
        publishes ``health/skipped`` and ``health/fallbacks`` (counters,
        rebased on the restored counts) and ``health/max_rung`` (a
        watermark), so ``registry.epoch_suffixes()`` renders the
        ``[health: ...]`` suffix."""
        self.log = log if log is not None else logging.getLogger(__name__)
        self.skipped = 0      # cumulative, mirrors the device counter
        self.fallbacks = 0
        self.rung = 0
        h = getattr(state, 'health', None)
        if h is not None:
            self.skipped = int(h.skipped)
            self.fallbacks = int(h.fallbacks)
            self.rung = int(h.rung)
        self._epoch = {'skipped': 0, 'fallbacks': 0, 'max_rung': 0}
        self.registry = registry
        if registry is not None:
            registry.counter('health/skipped').rebase(self.skipped)
            registry.counter('health/fallbacks').rebase(self.fallbacks)
            registry.watermark('health/max_rung')

    def update(self, metrics, step=None):
        """Consume one step's metrics dict; no-op without health/*."""
        if 'health/skipped' not in metrics:
            return
        at = '' if step is None else f' at step {step}'
        skipped = int(metrics['health/skipped'])
        fallbacks = int(metrics['health/fallbacks'])
        rung = int(metrics['health/rung'])
        if skipped > self.skipped:
            self._epoch['skipped'] += skipped - self.skipped
            self.log.warning(
                'health: non-finite batch skipped%s (total %d) — params '
                'and factor EMAs untouched', at, skipped)
        if fallbacks > self.fallbacks:
            self._epoch['fallbacks'] += fallbacks - self.fallbacks
            self.log.warning(
                'health: non-finite preconditioner output%s — raw-SGD '
                'gradients used for this step (total %d)', at, fallbacks)
        if rung > self.rung:
            self.log.warning(
                'health: damping-escalation ladder climbed to rung %d%s',
                rung, at)
        elif rung < self.rung:
            self.log.info(
                'health: recovered%s — damping ladder reset to rung %d',
                at, rung)
        self._epoch['max_rung'] = max(self._epoch['max_rung'], rung)
        if self.registry is not None:
            self.registry.counter('health/skipped').set_total(skipped)
            self.registry.counter('health/fallbacks').set_total(fallbacks)
            self.registry.watermark('health/max_rung').set(rung)
        self.skipped, self.fallbacks, self.rung = skipped, fallbacks, rung

    def quality_signal(self):
        """A monotone count of bad events, the autotuner's health gate:
        skipped batches plus raw-SGD fallbacks."""
        return self.skipped + self.fallbacks

    def epoch_flush(self):
        """Per-epoch deltas ``{skipped, fallbacks, max_rung}``; resets the
        epoch accumulators (cumulative totals keep running)."""
        out, self._epoch = self._epoch, {'skipped': 0, 'fallbacks': 0,
                                         'max_rung': 0}
        return out


class PhaseTimers:
    """Host-side attribution of each step's wall time to its K-FAC phase
    set. The host sees which phases a step ran (``step_fn.last_phases``:
    'pred'/'stats'/'decomp'/'gather') and the step's wall time. The
    timers bucket wall times by phase set and at ``epoch_flush`` derive
    marginal per-phase costs by subtraction between observed sets: the
    in-run form of the exclude-parts ablation
    (``utils.profiling.exclude_parts_breakdown``). A set with no observed
    strict subset reports its joint mean under a '+'-joined label (a
    staggered run at fac-freq 1, where every step runs everything,
    reports one ``decomp+gather+pred+stats`` figure).

    ``step_max``/``step_mean`` always ride along: the refresh spike —
    and its removal under ``stagger=True`` — is visible as
    ``step_max/step_mean`` collapsing toward 1 in the epoch lines
    (runlog.kfac_phase_suffix formats the dict).
    """

    def __init__(self, tracer=None, registry=None, histogram=False):
        """``tracer``: an ``obs.trace.TraceRecorder`` — every recorded
        step then ALSO lands as a Chrome-trace span named
        ``kfac.step``, carrying the step's phase set in the
        exclude-parts ledger taxonomy (``obs.trace.PHASE_TAXONOMY``), so
        the same host-side attribution this class aggregates is
        inspectable step-by-step in Perfetto.

        ``registry``: an ``obs.metrics.Registry`` — ``collect`` (or a
        direct ``epoch_flush``-then-set) publishes the per-epoch phase
        marginals as ``kfac_phase/*`` epoch gauges, which the registry
        renders into the ``kfac_phase_ms=`` suffix.
        ``histogram=True`` additionally feeds a ``step_seconds``
        histogram (Prometheus-shaped step-time distribution)."""
        self._acc = {}
        self._max = 0.0
        self._total = 0.0
        self._n = 0
        self.tracer = tracer
        self.registry = registry
        self._histogram = histogram
        if registry is not None:
            registry.add_collector(self.collect)
            if histogram:
                registry.histogram('step_seconds')

    def record(self, phases, seconds):
        """One step's wall time, attributed to its phase set. Call with
        the COMPLETED step's duration (time around the dispatch plus the
        blocking metric read that materializes it)."""
        key = frozenset(phases)
        tot, n = self._acc.get(key, (0.0, 0))
        self._acc[key] = (tot + seconds, n + 1)
        self._total += seconds
        self._n += 1
        self._max = max(self._max, seconds)
        if self.tracer is not None:
            from kfac_pytorch_tpu_torch.obs.trace import taxonomy_phases
            self.tracer.complete('kfac.step', seconds, cat='kfac.step',
                                 phases=taxonomy_phases(phases))
        if self.registry is not None and self._histogram:
            self.registry.histogram('step_seconds').observe(seconds)

    def collect(self, registry):
        """Registry collector: flush the epoch's marginals into
        ``kfac_phase/<label>`` epoch gauges (reset after each flush so a
        phase set that disappears — a variant change, an idle epoch —
        cannot leak a stale number into the next epoch line)."""
        for label, ms in self.epoch_flush().items():
            registry.gauge('kfac_phase/' + label,
                           reset_on_flush=True).set(ms)

    def epoch_flush(self):
        """Per-epoch ``{label: ms}`` (resets the accumulators): marginal
        per-phase costs where a baseline set was observed, joint means
        otherwise, plus ``step_mean``/``step_max``. Empty dict when
        nothing was recorded."""
        means = {k: t / n for k, (t, n) in self._acc.items()}
        out = {}
        for s in sorted(means, key=lambda k: (len(k), sorted(k))):
            bases = [b for b in means if b < s]
            if bases:
                # deterministic base pick; and the FIRST derivation of a
                # label wins — smaller sets are flushed first and their
                # baselines are the better-sampled ones (a refresh step's
                # 'stats' marginal would be the noisiest estimate)
                base = max(bases, key=lambda b: (len(b), tuple(sorted(b))))
                label = '+'.join(sorted(s - base))
                val = max(means[s] - means[base], 0.0)
            else:
                label = '+'.join(sorted(s)) if s else 'step'
                val = means[s]
            if label and label not in out:
                out[label] = val
        if self._n:
            out['step_mean'] = self._total / self._n
            out['step_max'] = self._max
        self._acc, self._max, self._total, self._n = {}, 0.0, 0.0, 0
        return {k: v * 1000.0 for k, v in out.items()}
