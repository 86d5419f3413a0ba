"""The numerical-health guard: skip, escalate, degrade, recover (port of
``kfac_pytorch_tpu/health.py``).

The trainer screens each batch's loss, gradients and captured factor
statistics for NaN/Inf (:func:`batch_ok`), and the step routes on that
one device flag without a host round trip:

- **healthy batch**: the normal K-FAC + optimizer update;
- **non-finite batch**: the parameters, optimizer state, factor EMAs,
  decompositions and BatchNorm running statistics come out bit for bit as
  they went in (only the step counters and the health counters advance),
  as if the batch had never been in the data.

A :class:`HealthState` rides in the ``TrainState`` and drives a damping
ladder: *consecutive* failures (skipped batches or a non-finite
preconditioner output) climb it, each rung multiplying the damping by
``damping_factor``; at the top rung the step degrades to plain SGD (raw
averaged gradients, factor statistics still accumulating) until
``recover_after`` healthy steps in a row reset it. An isolated failure
leaves the ladder alone (``escalate_after=2``), so a run that skips one
batch goes on exactly as a run whose data never held it.

Every function here is a few tensor ops on the step's device: the ladder
never reads a value back to the host.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from kfac_pytorch_tpu_torch.capture import all_finite
from kfac_pytorch_tpu_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Host-side knobs of the ladder.

    escalate_after: consecutive failures before the ladder climbs a rung
      (2: an isolated bad batch is skipped with no effect on later steps).
    damping_factor: per-rung damping multiplier (``damping *
      damping_factor**rung``).
    max_rungs: ladder height; at ``rung == max_rungs`` the step degrades
      to plain SGD while the factor statistics keep accumulating.
    recover_after: consecutive healthy steps that reset the ladder to 0.
    """
    escalate_after: int = 2
    damping_factor: float = 10.0
    max_rungs: int = 3
    recover_after: int = 10


_FIELDS = ('bad_streak', 'good_streak', 'rung', 'skipped', 'fallbacks')


@dataclasses.dataclass
class HealthState:
    """The guard's counters: five int32 0-d tensors on the step's device.

    bad_streak:  consecutive unhealthy steps (a skipped batch or a
                 non-finite preconditioner output).
    good_streak: consecutive fully healthy steps since the last failure.
    rung:        the damping ladder's rung, 0..max_rungs.
    skipped:     batches skipped, in total.
    fallbacks:   steps whose preconditioned gradients were non-finite and
                 replaced by the raw ones, in total.
    """
    bad_streak: torch.Tensor
    good_streak: torch.Tensor
    rung: torch.Tensor
    skipped: torch.Tensor
    fallbacks: torch.Tensor

    @classmethod
    def init(cls, device=None):
        return cls(**{k: torch.zeros((), dtype=torch.int32, device=device)
                      for k in _FIELDS})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def tensors(self):
        """The five counters, in field order."""
        return [getattr(self, k) for k in _FIELDS]

    def select(self, ok, other):
        """``self`` where the 0-d bool ``ok`` is true, else ``other``."""
        return HealthState(*[torch.where(ok, a, b) for a, b in
                             zip(self.tensors(), other.tensors())])


def batch_ok(group, grads, *local_trees):
    """0-d bool tensor: is this batch usable on EVERY rank? ``grads`` are
    already averaged over the group (the same on every rank), so their
    screen is local; ``local_trees`` (the local loss, the captured a and
    g) are this rank's, so their bad flag is summed over the group: one
    scalar all-reduce, and every rank takes the same branch."""
    ok_local = all_finite(*local_trees)
    with coll.named_scope('health.batch_ok'):
        bad = coll.psum(torch.where(ok_local, 0.0, 1.0), group)
    return all_finite(grads) & (bad == 0)


_POW = {}


def effective_damping(hstate: HealthState, damping, cfg: HealthConfig):
    """Ladder-escalated damping ``damping * damping_factor**rung``, a
    float32 0-d tensor on the counters' device. The powers are an fp32
    table made once per device (``float32(factor) ** r``), so a step
    indexes it instead of copying a value from the host."""
    dev = hstate.rung.device
    key = (cfg.damping_factor, cfg.max_rungs, str(dev))
    table = _POW.get(key)
    if table is None:
        table = torch.from_numpy(
            np.float32(cfg.damping_factor)
            ** np.arange(cfg.max_rungs + 1, dtype=np.float32)).to(dev)
        _POW[key] = table
    # gather, not table[rung]: a 0-d index tensor would be read back to
    # the host as a Python int
    scale = table.gather(
        0, hstate.rung.clamp(0, cfg.max_rungs).long().reshape(1))[0]
    if torch.is_tensor(damping):
        return damping.to(torch.float32) * scale
    return scale * float(np.float32(damping))


def degraded(hstate: HealthState, cfg: HealthConfig):
    """True while the ladder's top rung forces the plain-SGD step."""
    return hstate.rung >= cfg.max_rungs


def _escalate(hstate: HealthState, cfg: HealthConfig):
    streak = hstate.bad_streak + 1
    rung = torch.where(streak >= cfg.escalate_after,
                       torch.clamp(hstate.rung + 1, max=cfg.max_rungs),
                       hstate.rung)
    return streak, rung


def on_bad_batch(hstate: HealthState, cfg: HealthConfig) -> HealthState:
    """Transition for a skipped (non-finite) batch."""
    streak, rung = _escalate(hstate, cfg)
    return hstate.replace(bad_streak=streak,
                          good_streak=torch.zeros_like(hstate.good_streak),
                          rung=rung, skipped=hstate.skipped + 1)


def on_good_batch(hstate: HealthState, cfg: HealthConfig,
                  precond_ok) -> HealthState:
    """Transition for an applied step. ``precond_ok`` false (the
    preconditioned gradients were non-finite and the raw ones were used)
    counts as a failure for the ladder; a fully healthy step extends
    ``good_streak`` and resets the ladder once ``recover_after`` is
    reached."""
    precond_ok = torch.as_tensor(precond_ok, device=hstate.rung.device)
    streak, esc_rung = _escalate(hstate, cfg)
    zero = torch.zeros_like(hstate.good_streak)
    gstreak = torch.where(precond_ok, hstate.good_streak + 1, zero)
    rung = torch.where(
        precond_ok,
        torch.where(gstreak >= cfg.recover_after, zero, hstate.rung),
        esc_rung)
    return hstate.replace(
        bad_streak=torch.where(precond_ok, zero, streak),
        good_streak=gstreak, rung=rung,
        fallbacks=hstate.fallbacks + (~precond_ok).to(torch.int32))


def metrics(hstate: HealthState, ok) -> dict:
    """The step's health metrics (device tensors; ``utils.metrics.
    HealthMonitor`` reads them on the host)."""
    return {'ok': ok, 'skipped': hstate.skipped, 'rung': hstate.rung,
            'fallbacks': hstate.fallbacks, 'bad_streak': hstate.bad_streak}


def resolve(health) -> Optional[HealthConfig]:
    """A user-facing ``health`` argument normalized: True -> defaults,
    False/None -> disabled, a HealthConfig -> itself."""
    if health is True:
        return HealthConfig()
    if not health:
        return None
    if not isinstance(health, HealthConfig):
        raise TypeError('health must be a bool or HealthConfig, got '
                        f'{health!r}')
    return health
