"""Epoch-indexed hyper-parameter scheduling (port of
``kfac_pytorch_tpu/scheduler.py``): multiplicative decay of the damping
and of the factor/inverse update frequencies at listed epochs.

The JAX scheduler proposes its factors to a knob arbiter shared with the
straggler governor and the autotuner; neither exists in the port yet, so
this one applies them directly, with the arbiter's rule: damping
``base * factor``, frequencies ``max(1, int(base * factor))``, and a
staggered preconditioner's cohort layout rebased to the new window.
"""


class KFACParamScheduler:
    def __init__(self, kfac, damping_alpha=1, damping_schedule=None,
                 update_freq_alpha=1, update_freq_schedule=None,
                 start_epoch=0):
        self.kfac = kfac
        self.base = {'damping': kfac.damping,
                     'fac_update_freq': kfac.fac_update_freq,
                     'kfac_update_freq': kfac.kfac_update_freq}
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
        self.kfac.damping = (self.base['damping']
                             * self.damping_factor_func(self.epoch))
        f = self.update_freq_factor_func(self.epoch)
        for k in ('fac_update_freq', 'kfac_update_freq'):
            setattr(self.kfac, k, max(1, int(self.base[k] * f)))
        self.kfac.rebase_cohorts()   # a no-op unless the window changed

    def step(self, epoch=None):
        """Advance to ``epoch`` (or by one) and update the wrapped KFAC's
        damping and update frequencies."""
        self.epoch = epoch if epoch is not None else self.epoch + 1
        self._apply()
