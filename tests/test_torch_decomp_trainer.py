"""The port's trainer on the decomposition ladder against the JAX trainer:
``tests/test_torch_slice.py``'s model and sizes (``_make(1)``, batch 8 at
16x16, weights carried by ``weights.params_from_jax``), one run each of

- ``eigen_dp`` with ``decomp_impl='subspace', basis_update_freq=2``: a
  cold full decomposition, a refresh, a warm full one, a refresh;
- ``eigen_dp`` with ``stagger=True, kfac_update_freq=2``: a full
  decomposition, then one cohort a step;
- ``inverse_dp`` with ``decomp_impl='newton_schulz'``: a cold Cholesky,
  then Newton-Schulz warm inverses;
- the first run stopped after two steps, saved, restored into a fresh
  trainer and run two more: its first decomposition is full and cold
  (where the uninterrupted run's is warm) and the streak restarts.

Each step's losses (rtol 1e-5), ``last_phases`` and the cadence record
``warm_tracking`` equal JAX's; at the end the parameters and BatchNorm
statistics are within 5e-4 of each tensor's largest entry (the
tolerances of ``tests/test_torch_slice.py``).

The running averages start at the identity, so a factor's low-rank
statistic leaves an eigenvalue cluster at ``factor_decay`` of high
multiplicity, and two eigh solvers pick different bases inside it. The
preconditioner of a full decomposition does not depend on that choice,
but a refresh (eigenvalues in the retained basis) and a warm start do.
So in the ``basis_update_freq`` runs the JAX trainer is handed the
port's stored eigenbasis and eigenvalues before each step (everything
else it computes itself): the two then refresh and track in the same
basis, which is what the comparison can hold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_resnet as tresnet
from kfac_pytorch_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

BS, HW = 8, 16
LOSS_RTOL = 1e-5
PARAM_RTOL = 5e-4
HP = dict(lr=0.1, damping=0.003, kl_clip=0.001, factor_decay=0.95)
CONFIGS = {
    'subspace_basis': (dict(variant='eigen_dp', decomp_impl='subspace',
                            basis_update_freq=2, kfac_update_freq=1), 4,
                       ['full', 'refresh', 'warm', 'refresh']),
    'stagger': (dict(variant='eigen_dp', stagger=True, kfac_update_freq=2), 4,
                ['full', 'cohort', 'cohort', 'cohort']),
    'newton_schulz': (dict(variant='inverse_dp', decomp_impl='newton_schulz',
                           kfac_update_freq=1), 3, ['full', 'warm', 'warm']),
}
#: the resume run: CONFIGS['subspace_basis'] saved after RESUME_AT steps
RESUME_AT = 2


def _batches(n):
    r = np.random.RandomState(0)
    return [{'input': r.randn(BS, HW, HW, 3).astype(np.float32),
             'label': r.randint(0, 10, BS).astype(np.int64)}
            for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


def _jax_loss(out, batch):
    return optax.softmax_cross_entropy_with_integer_labels(
        out, batch['label']).mean()


@functools.lru_cache(maxsize=None)
def _init():
    """The JAX trainer's initial parameters and BatchNorm statistics."""
    model = jresnet._make(1)
    tx = jtraining.sgd(0.1, momentum=0.9, weight_decay=5e-4)
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, None, key, jnp.zeros((BS, HW, HW, 3))))(
            jax.random.PRNGKey(0))
    return _np_tree(state.params), _np_tree(state.extra_vars['batch_stats'])


def _jax_run(name, resume_at=None, feeds=None):
    """The JAX trainer on config ``name``; with ``resume_at`` a fresh
    step function (an empty cadence record, as after a restart) takes
    over at that step; ``feeds[i]`` (numpy, or None) replaces the stored
    decomposition before step ``i``."""
    kw, steps, _ = CONFIGS[name]
    model = jresnet._make(1)
    tx = jtraining.sgd(0.1, momentum=0.9, weight_decay=5e-4)
    pre = jkfac.KFAC(health=False, **HP, **kw)
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, HW, HW, 3))))(
            jax.random.PRNGKey(0))

    def build():
        return jtraining.build_train_step(model, tx, pre, _jax_loss,
                                          extra_mutable=('batch_stats',))

    step = build()
    out = {'losses': [], 'phases': [], 'tracking': []}
    for i, b in enumerate(_batches(steps)):
        if i == resume_at:
            step = build()
        if feeds is not None and feeds[i] is not None:
            state = state.replace(kfac_state=state.kfac_state.replace(
                decomp=jax.tree.map(jnp.asarray, feeds[i])))
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        lr=HP['lr'], damping=HP['damping'])
        out['losses'].append(float(m['loss']))
        out['phases'].append(step.last_phases)
        out['tracking'].append(dict(step.warm_tracking))
    out['params'] = _np_tree(state.params)
    out['batch_stats'] = _np_tree(state.extra_vars['batch_stats'])
    return out


def _port_trainer(name):
    kw, _, _ = CONFIGS[name]
    model = tresnet._make(1)
    model.load_state_dict(weights.params_from_jax(*_init()))
    tx = ttraining.sgd(0.1, momentum=0.9, weight_decay=5e-4)
    pre = tkfac.KFAC(**HP, **kw)
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, HW, HW, 3), np.float32),
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: F.cross_entropy(out, b['label']))
    return state, step


def _port_steps(state, step, batches, out):
    """Run ``batches``, recording per step what the comparison reads and
    the stored decomposition the step started from (the JAX run's
    feed)."""
    for b in batches:
        decomp = state.kfac_state.decomp
        out['feeds'].append({part: {k: v.numpy().copy()
                                    for k, v in tree.items()}
                             for part, tree in decomp.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()},
                        lr=HP['lr'], damping=HP['damping'])
        out['losses'].append(float(m['loss']))
        out['phases'].append(step.last_phases)
        out['decomps'].append(step.last_decomp)
        out['tracking'].append(dict(step.warm_tracking))
    return state


def _run_port(name, batches):
    state, step = _port_trainer(name)
    got = {'losses': [], 'phases': [], 'decomps': [], 'tracking': [],
           'feeds': []}
    return _port_steps(state, step, batches, got), step, got


def _assert_matches(state, got, want):
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=LOSS_RTOL)
    assert got['phases'] == want['phases']
    assert got['tracking'] == want['tracking']
    want_sd = weights.params_from_jax(want['params'], want['batch_stats'])
    got_sd = state.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, w in want_sd.items():
        g, w = got_sd[k].double().numpy(), w.double().numpy()
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err <= PARAM_RTOL, (k, err)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_ladder_trainer_matches_jax(name):
    kw, steps, decomps = CONFIGS[name]
    state, _, got = _run_port(name, _batches(steps))
    assert got['decomps'] == decomps
    feeds = got['feeds'] if 'basis_update_freq' in kw else None
    _assert_matches(state, got, _jax_run(name, feeds=feeds))


def test_resumed_run_decomposes_full_and_cold_first(tmp_path):
    name = 'subspace_basis'
    batches = _batches(CONFIGS[name][1])
    state, _, got = _run_port(name, batches[:RESUME_AT])
    checkpoint.save_checkpoint(str(tmp_path), 0, state)
    fresh, step = _port_trainer(name)
    state = checkpoint.restore_checkpoint(str(tmp_path), 0, fresh)
    assert state.decomposed and state.step == RESUME_AT
    state = _port_steps(state, step, batches[RESUME_AT:], got)
    # uninterrupted, the third decomposition is warm (CONFIGS); resumed it
    # is full and cold, and the streak starts again
    assert got['decomps'] == ['full', 'refresh', 'full', 'refresh']
    assert got['tracking'][RESUME_AT] == {'yes': True,
                                          'last_full': RESUME_AT,
                                          'warm_streak': 0}
    _assert_matches(state, got, _jax_run(name, resume_at=RESUME_AT,
                                         feeds=got['feeds']))
