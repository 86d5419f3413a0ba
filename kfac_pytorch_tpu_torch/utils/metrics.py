"""Training metrics (port of ``accuracy`` and ``HealthMonitor`` in
``kfac_pytorch_tpu/utils/metrics.py``; the monitor's ``registry`` and
``quality_signal`` hooks come with the observability and autotune slice,
ROADMAP queue 1, slice F)."""

import logging

import torch


def accuracy(outputs, labels):
    """Top-1 accuracy from logits."""
    return (outputs.argmax(dim=-1) == labels).to(torch.float32).mean()


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

    def __init__(self, log=None, state=None):
        """``state``: the (possibly restored) TrainState, so the baseline
        starts from ITS counters and a resumed run does not announce the
        skips from before the resume again."""
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
        self.skipped, self.fallbacks, self.rung = skipped, fallbacks, rung

    def epoch_flush(self):
        """Per-epoch deltas ``{skipped, fallbacks, max_rung}``; resets the
        epoch accumulators (cumulative totals keep running)."""
        out, self._epoch = self._epoch, {'skipped': 0, 'fallbacks': 0,
                                         'max_rung': 0}
        return out
