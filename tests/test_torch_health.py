"""The port's numerical-health guard against the JAX package's
(``kfac_pytorch_tpu/health.py``), part 1: the ladder's transition
functions, compared exactly over seeded random sequences of skipped,
applied and fallback steps; the health monitor's lines and epoch
suffixes; and a skipped batch under gradient accumulation, bitwise its
control. The guarded step against JAX's is
``tests/test_torch_health_guard.py`` (a file of its own, so the suite's
scheduler runs its JAX step beside the longest files).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu import health as jhealth
from kfac_pytorch_tpu.utils.metrics import HealthMonitor as JMonitor
from kfac_pytorch_tpu.utils.runlog import health_suffix as jsuffix
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import health as thealth
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch.models import cifar_resnet as tresnet
from kfac_pytorch_tpu_torch.utils import lr as tlr
from kfac_pytorch_tpu_torch.utils.metrics import HealthMonitor as TMonitor
from kfac_pytorch_tpu_torch.utils.runlog import health_suffix as tsuffix

torch.set_num_threads(2)

BS, HW = 8, 16
HP = dict(lr=0.1, damping=0.003, kfac_update_freq=1, kl_clip=0.001,
          factor_decay=0.95)
LADDER = dict(escalate_after=2, damping_factor=10.0, max_rungs=2,
              recover_after=2)
FALLBACK_STEP = 5
PARAM_RTOL = 5e-4
KEYS = ('ok', 'skipped', 'rung', 'fallbacks', 'bad_streak')


def _lr_fn(mod):
    # 4 steps per epoch, one warmup epoch: the lr changes every step
    return mod.warmup_multistep(0.1, 4, 1, [35])


def _batches(n, nan_at=(), seed=0):
    r = np.random.RandomState(seed)
    out = [{'input': r.randn(BS, HW, HW, 3).astype(np.float32),
            'label': r.randint(0, 10, BS).astype(np.int64)}
           for _ in range(n)]
    for i in nan_at:
        out[i]['input'] = np.full_like(out[i]['input'], np.nan)
    return out


# ---------------------------------------------------------------------------
# the transition functions
# ---------------------------------------------------------------------------

def _h_ints(h):
    return [int(getattr(h, k)) for k in thealth._FIELDS]


@pytest.mark.parametrize('cfg', [
    dict(), LADDER, dict(escalate_after=1, damping_factor=3.0, max_rungs=4,
                         recover_after=3)], ids=['default', 'ladder', 'fast'])
def test_transitions_match_jax(cfg):
    jcfg, tcfg = jhealth.HealthConfig(**cfg), thealth.HealthConfig(**cfg)
    r = np.random.RandomState(7)
    jh, th = jhealth.HealthState.init(), thealth.HealthState.init('cpu')
    for event in r.choice(['bad', 'good', 'fallback'], 200,
                          p=[0.35, 0.5, 0.15]):
        if event == 'bad':
            jh, th = jhealth.on_bad_batch(jh, jcfg), \
                thealth.on_bad_batch(th, tcfg)
        else:
            pok = event == 'good'
            jh = jhealth.on_good_batch(jh, jcfg, jnp.asarray(pok))
            th = thealth.on_good_batch(th, tcfg, torch.tensor(pok))
        assert _h_ints(th) == [int(getattr(jh, k))
                               for k in thealth._FIELDS]
        assert bool(thealth.degraded(th, tcfg)) == \
            bool(jhealth.degraded(jh, jcfg))
        for d in (0.003, 0.001):
            assert np.float32(thealth.effective_damping(th, d, tcfg)) == \
                np.float32(jhealth.effective_damping(jh, d, jcfg))
        s, rung = thealth._escalate(th, tcfg)
        js, jrung = jhealth._escalate(jh, jcfg)
        assert (int(s), int(rung)) == (int(js), int(jrung))
    assert thealth.resolve(True) == thealth.HealthConfig()
    assert thealth.resolve(False) is None and thealth.resolve(None) is None
    assert thealth.resolve(tcfg) is tcfg
    with pytest.raises(TypeError):
        thealth.resolve('yes')


def test_monitor_lines_and_suffix_match_jax(caplog):
    """The same metric sequence gives JAX's WARNING/INFO lines and epoch
    suffixes."""
    seq = [dict(skipped=0, fallbacks=0, rung=0), dict(skipped=1,
           fallbacks=0, rung=0), dict(skipped=2, fallbacks=0, rung=1),
           dict(skipped=2, fallbacks=1, rung=2), dict(skipped=2,
           fallbacks=1, rung=0)]

    def drive(monitor_cls, suffix, name):
        log = logging.getLogger(name)
        caplog.clear()
        mon = monitor_cls(log)
        suffixes = []
        for i, m in enumerate(seq):
            mon.update({'health/' + k: v for k, v in m.items()}, step=i)
            if i in (0, 3, 4):
                suffixes.append(suffix(mon.epoch_flush()))
        mon.update({'loss': 1.0})
        return ([(r.levelname, r.getMessage()) for r in caplog.records],
                suffixes)

    with caplog.at_level(logging.INFO):
        jout = drive(JMonitor, jsuffix, 'jax_monitor')
        tout = drive(TMonitor, tsuffix, 'port_monitor')
    assert tout == jout
    assert tout[1] == ['', ' [health: skipped=2 sgd_fallbacks=1 max_rung=2]',
                       '']


def test_skip_under_gradient_accumulation():
    """MultiSteps (2 batches an update) with an all-NaN batch mid-way:
    the accumulator, its device counters, the momentum and the parameters
    end bitwise as in a run whose data never held the batch."""
    def run(batches):
        model = tresnet._make(1)
        tx = ttraining.MultiSteps(ttraining.sgd(_lr_fn(tlr), momentum=0.9,
                                                weight_decay=5e-4), 2)
        pre = tkfac.KFAC(variant='eigen_dp', **HP)
        state = ttraining.init_train_state(
            model, tx, pre, np.zeros((4, 8, 8, 3), np.float32), device='cpu')
        step = ttraining.build_train_step(
            model, tx, pre, lambda out, b: F.cross_entropy(out, b['label']))
        for b in batches:
            state, m = step(state, {
                'input': torch.from_numpy(b['input'][:4, :8, :8].copy()),
                'label': torch.from_numpy(b['label'][:4])})
        return state, m

    batches = _batches(6, nan_at=[3], seed=5)
    faulted, m = run(batches)
    control, _ = run(batches[:3] + batches[4:])
    assert int(m['health/skipped']) == 1
    assert int(faulted.opt_state['mini_step']) == 1
    assert int(faulted.opt_state['gradient_step']) == 2
    for k, v in control.model.state_dict().items():
        assert torch.equal(faulted.model.state_dict()[k], v), k
    from kfac_pytorch_tpu_torch import capture
    for a, b in zip(capture.tensor_leaves(faulted.opt_state),
                    capture.tensor_leaves(control.opt_state)):
        assert torch.equal(a, b)
