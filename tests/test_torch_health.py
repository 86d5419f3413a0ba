"""The port's numerical-health guard against the JAX package's
(``kfac_pytorch_tpu/health.py`` and the guarded step of
``kfac_pytorch_tpu/training.py``).

The ladder's transition functions are compared exactly over seeded random
sequences of skipped, applied and fallback steps. The guarded step runs
as ``tests/test_torch_slice.py`` runs the slice: ``_make(1)``, batch 8 at
16x16, ``eigen_dp`` with a decomposition every step (so the schedule is
the same with and without a batch), SGD with the warmup lr schedule (the
optimizer counts applied updates, so a skip shifts its lr index), the KL
clip's lr fixed (``lr=None``: ``precond.lr``), from the same weights
(``weights.params_from_jax``). One JAX step function with
``HealthConfig(escalate_after=2, max_rungs=2, recover_after=2)`` serves
every scenario (one compile); its ``precond.step`` returns NaN in the
``fc`` kernel's preconditioned gradient at K-FAC step ``FALLBACK_STEP``,
which only the fallback scenario reaches on a healthy batch.

Tolerances are ``test_torch_slice.py``'s: parameters and BN statistics
5e-4 of each tensor's largest entry. The health counters match exactly,
and a skipped batch leaves the port's parameters, momentum, BN buffers,
factors and decomposition bitwise equal to a run without that batch.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import health as jhealth
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.utils import lr as jlr
from kfac_pytorch_tpu.utils.metrics import HealthMonitor as JMonitor
from kfac_pytorch_tpu.utils.runlog import health_suffix as jsuffix
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import health as thealth
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
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


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


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


# ---------------------------------------------------------------------------
# the guarded step against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_side():
    """One JAX model, init and guarded step function for every
    scenario; ``run(batches)`` returns its per-step health metrics and
    final parameters and BN statistics."""
    model = jresnet._make(1)
    lr_fn = _lr_fn(jlr)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-4)
    pre = jkfac.KFAC(variant='eigen_dp',
                     health=jhealth.HealthConfig(**LADDER), **HP)
    init_fn = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, HW, HW, 3))))
    state = init_fn(jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.extra_vars['batch_stats']))
    orig = pre.step

    def step_with_fault(kstate, grads, *a, **kw):
        new, s = orig(kstate, grads, *a, **kw)
        fc = dict(new['fc'])
        fc['kernel'] = jnp.where(kstate.step == FALLBACK_STEP, jnp.nan,
                                 fc['kernel'])
        return {**new, 'fc': fc}, s

    pre.step = step_with_fault

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch['label']).mean()

    step = jtraining.build_train_step(model, tx, pre, loss_fn,
                                      extra_mutable=('batch_stats',))

    def run(batches):
        step.warm_tracking.clear()
        st = init_fn(jax.random.PRNGKey(0))
        mets = []
        for b in batches:
            st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()},
                         damping=HP['damping'])
            mets.append({k: int(m['health/' + k]) for k in KEYS})
        return {'mets': mets, 'params': _np_tree(st.params),
                'batch_stats': _np_tree(st.extra_vars['batch_stats'])}

    return {'init': init, 'run': run}


def _port_run(init, batches, health=None, fallback_at=None):
    model = tresnet._make(1)
    model.load_state_dict(weights.params_from_jax(*init))
    tx = ttraining.sgd(_lr_fn(tlr), momentum=0.9, weight_decay=5e-4)
    pre = tkfac.KFAC(variant='eigen_dp',
                     health=(thealth.HealthConfig(**LADDER) if health is None
                             else health), **HP)
    if fallback_at is not None:
        orig = pre.step

        def step_with_fault(kstate, grads, *a, **kw):
            new, s = orig(kstate, grads, *a, **kw)
            if kstate.step == fallback_at:
                new = {**new, 'fc.weight': torch.full_like(new['fc.weight'],
                                                           float('nan'))}
            return new, s

        pre.step = step_with_fault
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, HW, HW, 3), np.float32),
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: F.cross_entropy(out, b['label']))
    mets = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        damping=HP['damping'])
        mets.append({k: int(m['health/' + k]) for k in KEYS
                     if 'health/' + k in m})
    return state, mets


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _assert_params_match_jax(state, want):
    want_sd = weights.params_from_jax(want['params'], want['batch_stats'])
    got_sd = state.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, w in want_sd.items():
        got = got_sd[k].numpy()
        assert np.all(np.isfinite(got)), k
        err = _rel_to_max(got, w.numpy())
        assert err <= PARAM_RTOL, (k, err)


def _port_tensors(state):
    out = {f'model.{k}': v for k, v in state.model.state_dict().items()}
    out.update({f'mom.{k}': v for k, v in state.opt_state.items()})
    for part in ('factors',):
        out.update({f'{part}.{k}': v for k, v in
                    getattr(state.kfac_state, part).items()})
    for kind, tree in state.kfac_state.decomp.items():
        out.update({f'decomp.{kind}.{k}': v for k, v in tree.items()})
    return out


def _assert_bitwise(a, b):
    ta, tb = _port_tensors(a), _port_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert (ta[k].detach().contiguous().numpy().tobytes()
                == tb[k].detach().contiguous().numpy().tobytes()), k


@pytest.mark.parametrize('nan_at', [2, 0], ids=['step2', 'first_decomp'])
def test_skipped_batch_matches_jax_and_control(jax_side, nan_at):
    """An all-NaN input batch: the port's health counters are JAX's, its
    parameters and BN statistics JAX's within tolerance, and its whole
    state bitwise the state of a run that never saw the batch."""
    batches = _batches(5, nan_at=[nan_at])
    want = jax_side['run'](batches)
    state, mets = _port_run(jax_side['init'], batches)
    assert mets == want['mets']
    assert [m['ok'] for m in mets] == [int(i != nan_at) for i in range(5)]
    assert mets[-1]['skipped'] == 1 and mets[-1]['rung'] == 0
    _assert_params_match_jax(state, want)
    control, _ = _port_run(jax_side['init'],
                           batches[:nan_at] + batches[nan_at + 1:])
    _assert_bitwise(state, control)
    assert state.step == 5 and control.step == 4
    assert state.kfac_state.step == 5


def test_ladder_matches_jax(jax_side):
    """NaN batches at steps 2-5 of 10: the ladder climbs to its top rung
    (degraded SGD), holds through the first healthy step and recovers
    after two, as JAX's oracle (tests/test_health.py) has it."""
    batches = _batches(10, nan_at=[2, 3, 4, 5], seed=1)
    want = jax_side['run'](batches)
    state, mets = _port_run(jax_side['init'], batches)
    assert [m['rung'] for m in mets] == [0, 0, 0, 1, 2, 2, 2, 0, 0, 0]
    assert mets == want['mets']
    _assert_params_match_jax(state, want)


def test_preconditioner_fallback_matches_jax(jax_side):
    """A non-finite preconditioned gradient at K-FAC step FALLBACK_STEP:
    that step applies the raw gradients, counts one fallback, and the run
    goes on as JAX's does."""
    batches = _batches(FALLBACK_STEP + 2, seed=2)
    want = jax_side['run'](batches)
    state, mets = _port_run(jax_side['init'], batches,
                            fallback_at=FALLBACK_STEP)
    assert mets == want['mets']
    assert mets[-1]['fallbacks'] == 1 and mets[-1]['skipped'] == 0
    assert [m['bad_streak'] for m in mets][FALLBACK_STEP] == 1
    _assert_params_match_jax(state, want)


def test_guard_off_nan_contaminates(jax_side):
    """health=False: no health metrics, no counters, and the NaN batch
    poisons the parameters (the JAX oracle:
    tests/test_health.py::test_guard_off_nan_contaminates)."""
    state, mets = _port_run(jax_side['init'], _batches(3, nan_at=[1]),
                            health=False)
    assert mets == [{}, {}, {}]
    assert state.health is None
    assert any(not torch.all(torch.isfinite(p))
               for p in state.model.parameters())


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
