"""Epoch-indexed hyper-parameter scheduling (port of
``kfac_pytorch_tpu/scheduler.py``): multiplicative decay of the damping
and of the factor/inverse update frequencies at listed epochs.

The scheduler is a proposer, not a writer: it hands the epoch's factors
to the preconditioner's knob arbiter (``autotune.arbiter_for``), which
composes them with the tuner's overrides (and a straggler stretch) over
the construction-time base and applies the result once: damping ``base *
factor``, frequencies ``max(1, int(base * factor))``, and a staggered
preconditioner's cohort layout rebased to the new window.
"""

from kfac_pytorch_tpu_torch import autotune


class KFACParamScheduler:
    def __init__(self, kfac, damping_alpha=1, damping_schedule=None,
                 update_freq_alpha=1, update_freq_schedule=None,
                 start_epoch=0):
        self.kfac = kfac
        # the bases the factors apply to live in the arbiter
        # (autotune.arbiter_for(kfac).base): this class holds no knob
        # state of its own
        self.damping_factor_func = self._factor_func(
            damping_schedule, damping_alpha)
        self.update_freq_factor_func = self._factor_func(
            update_freq_schedule, update_freq_alpha)
        self.epoch = start_epoch
        if start_epoch:
            self._apply()

    @staticmethod
    def _factor_func(schedule, alpha):
        schedule = sorted(schedule, reverse=True) if schedule else []

        def factor(epoch):
            f = 1.0
            for e in schedule:
                if epoch >= e:
                    f *= alpha
            return f

        return factor

    def _apply(self):
        autotune.arbiter_for(self.kfac).propose(
            'schedule',
            damping_factor=self.damping_factor_func(self.epoch),
            freq_factor=self.update_freq_factor_func(self.epoch))

    def step(self, epoch=None):
        """Advance to ``epoch`` (or by one) and update the wrapped KFAC's
        damping and update frequencies."""
        self.epoch = epoch if epoch is not None else self.epoch + 1
        self._apply()
