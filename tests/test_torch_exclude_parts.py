"""The port's ``exclude_parts`` ablation (``KFAC(exclude_parts=)``, the
trainers' ``--exclude-parts``) against the JAX package, held to
``tests/test_exclude_parts.py``'s oracle: TinyCNN, ``eigen_dp``, lr 0.1,
damping 0.003, SGD with momentum 0.9, cross-entropy, two steps, here on
a 15 x 15 batch (an odd size: the port's TinyCNN pads symmetrically).

- World 1 (``tests/test_torch_exclude_parts_runs.py``, a file of its own
  so the suite's scheduler runs its JAX steps beside the longest files,
  with this file's helpers): the full run, ComputeInverse and all four
  together equal the JAX run from the same weights and batch (losses rtol 1e-5; the first
  step's factors 1e-5 relative plus 1e-6 of sqrt(F_ii F_jj); each
  K-FAC layer's parameters, weight and bias as the one matrix K-FAC
  updates, within 5e-4 of its largest entry; decompositions compared as
  the preconditioner uses them, ``Q diag(d) Q^T``). ComputeFactor,
  CommunicateFactor and CommunicateInverse equal, bit for bit, the port
  run that computes the same at world 1 (an EMA weight of 0 on the new
  statistic; the full run; no KL clip). Every run keeps the oracle's
  properties: ComputeFactor leaves the factors at their initial value
  (and, through the kernels' plain versions, launches no K1/K2),
  ComputeInverse leaves the decomposition zero while the factors
  accumulate and passes the gradients through, CommunicateInverse skips
  the KL clip, and every ablated run stays finite. Here: without
  ComputeFactor the kernels' plain versions are never called.
- World 2: ``tests/test_torch_exclude_parts_world2.py``.
- ``decomp_shard`` with CommunicateInverse raises JAX's ValueError, and
  both trainers take ``--exclude-parts``.
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
from kfac_pytorch_tpu.models.tiny import TinyCNN as JTinyCNN
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import tiny
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
from tests.test_torch_imagenet import (FACTOR_ATOL, FACTOR_RTOL, LOSS_RTOL,
                                       PARAM_RTOL, _rel_to_max)

torch.set_num_threads(2)

STEPS, BS, HW = 2, 4, 15
HP = dict(lr=0.1, damping=0.003)
ALL_PARTS = ('CommunicateInverse,ComputeInverse,CommunicateFactor,'
             'ComputeFactor')
#: each ablation at world 1 and the port run it equals bit for bit (the
#: KFAC arguments of that run): no factor update is an EMA that keeps
#: the current factor (``cur * 1 + stat * 0``); no stats reduce changes
#: nothing for local statistics; no gather at world 1 leaves only the
#: skipped KL clip
EQUIVALENT = {'ComputeFactor': {'factor_decay': 0.0},
              'CommunicateFactor': {},
              'CommunicateInverse': {'kl_clip': None}}


def _batch():
    x = np.random.RandomState(0).randn(BS, HW, HW, 3).astype(np.float32)
    return {'input': x, 'label': np.arange(BS, dtype=np.int64)}


def _np(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's TinyCNN parameters from the runs' seed, the init compiled
    whole (no step: for the tests that need weights only)."""
    model = JTinyCNN()
    pre = jkfac.KFAC(variant='eigen_dp', health=False, **HP)
    tx = jtraining.sgd(HP['lr'], momentum=0.9)
    x = jnp.asarray(_batch()['input'])
    return _np(jax.jit(lambda k: jtraining.init_train_state(
        model, tx, pre, k, x))(jax.random.PRNGKey(0)).params)


@functools.lru_cache(maxsize=None)
def _jax_run(parts):
    model = JTinyCNN()
    pre = jkfac.KFAC(variant='eigen_dp', health=False, exclude_parts=parts,
                     **HP)
    tx = jtraining.sgd(HP['lr'], momentum=0.9)
    b = _batch()
    x = jnp.asarray(b['input'])
    batch = {'input': x, 'label': jnp.asarray(b['label'])}
    state = jtraining.init_train_state(model, tx, pre, jax.random.PRNGKey(0),
                                       x)
    init = _np(state.params)

    def ce(outputs, b):
        return optax.softmax_cross_entropy_with_integer_labels(
            outputs, b['label']).mean()

    step = jtraining.build_train_step(model, tx, pre, ce)
    losses, factors = [], []
    for _ in range(STEPS):
        state, m = step(state, batch, lr=HP['lr'], damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(_np(state.kfac_state.factors))
    return {'init': init, 'losses': losses, 'params': _np(state.params),
            'factors': factors,
            'decomp': _np(state.kfac_state.decomp)}


def _port_run(parts, init, capture_impl=None, **kfac_kw):
    model = tiny.TinyCNN(in_size=HW)
    model.load_state_dict(weights.params_from_jax(init))
    pre = tkfac.KFAC(variant='eigen_dp', exclude_parts=parts,
                     capture_impl=capture_impl, **{**HP, **kfac_kw})
    tx = ttraining.sgd(HP['lr'], momentum=0.9)
    state = ttraining.init_train_state(model, tx, pre, _batch()['input'],
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: F.cross_entropy(out, b['label']))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses, factors, grads_in, grads_out = [], [], [], []
    inner = pre.step

    def spy(state, grads, *args, **kw):
        out = inner(state, grads, *args, **kw)
        grads_in.append(dict(grads))
        grads_out.append(out[0])
        return out

    pre.step = spy
    for _ in range(STEPS):
        state, m = step(state, batch, lr=HP['lr'], damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(state.kfac_state.factors)
    return {'losses': losses, 'state': state, 'factors': factors,
            'phases': step.last_phases,
            'decomp_ran': step.last_decomp, 'grads_in': grads_in,
            'grads_out': grads_out}


def _layer_matrices(sd):
    """Each layer's weight (flattened to ``[out, -1]``) and bias as the
    one matrix K-FAC preconditions: a bias column's update is a small part
    of it and carries the matrix's rounding."""
    out = {}
    for key, w in sd.items():
        if key.endswith('.weight'):
            name = key[:-len('.weight')]
            w = torch.as_tensor(w).reshape(w.shape[0], -1)
            b = sd.get(name + '.bias')
            out[name] = (w if b is None else
                         torch.cat([w, torch.as_tensor(b)[:, None]], dim=1))
    return out


def _assert_factors_close(got, want):
    for key, w in want.items():
        g = got[key].double().numpy()
        d = np.sqrt(np.abs(np.diagonal(w, axis1=1, axis2=2)))
        bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                 + FACTOR_RTOL * np.abs(w))
        assert np.all(np.abs(g - w) <= bound), key


def _rebuilt(decomp):
    """Per bucket the stored eigendecomposition as ``Q diag(d) Q^T``:
    eigh solvers pick other bases inside an eigenvalue cluster."""
    return {k: np.einsum('rij,rj,rkj->rik', np.asarray(decomp['evecs'][k],
                                                       np.float64),
                         np.asarray(decomp['evals'][k], np.float64),
                         np.asarray(decomp['evecs'][k], np.float64))
            for k in decomp['evals']}


def _check_oracle(parts, got):
    """``tests/test_exclude_parts.py``'s properties of a run: no factor
    update leaves the factors at their initial identity, no decomposition
    leaves it zero (the factors still accumulate) and passes the
    gradients through; every run stays finite."""
    st = got['state']
    for p in st.model.parameters():
        assert torch.isfinite(p).all()
    factors = torch.cat([f.flatten() for f in st.kfac_state.factors.values()])
    eye = torch.cat([torch.eye(int(k)).repeat(f.shape[0], 1, 1).flatten()
                     for k, f in st.kfac_state.factors.items()])
    decomp_zero = all(bool((t == 0).all()) for tree in
                      st.kfac_state.decomp.values() for t in tree.values())
    if 'ComputeFactor' in parts:
        assert torch.equal(factors, eye)
        assert 'stats' not in got['phases']
    else:
        assert not torch.equal(factors, eye)
    if 'ComputeInverse' in parts:
        assert decomp_zero and got['decomp_ran'] is None
        for gin, gout in zip(got['grads_in'], got['grads_out']):
            assert all(gout[k] is gin[k] for k in gin)
    else:
        assert not decomp_zero and got['decomp_ran'] == 'full'


@pytest.mark.parametrize('parts', ['', 'ComputeFactor'])
def test_compute_factor_launches_no_capture_kernel(monkeypatch, parts):
    """The kernels' plain versions stand in for K1/K2 on the CPU: the
    ComputeFactor ablation calls neither."""
    calls = []
    for name in ('_conv_a_plain', '_stat_rows_plain'):
        fn = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, fn=fn, name=name, **k: (
            calls.append(name), fn(*a, **k))[1])
    _port_run(parts, _jax_init(), capture_impl='auto')
    if parts:
        assert calls == []
    else:
        # two convs (K1 and K2 each) and the dense head (K2 twice), a step
        assert sorted(calls) == sorted(
            ['_conv_a_plain'] * 2 * STEPS + ['_stat_rows_plain'] * 4 * STEPS)


def test_tiny_cnn_takes_odd_sizes_only():
    # JAX's stride-2 SAME pads an even map (0, 1): no symmetric torch pad
    with pytest.raises(ValueError, match='odd in_size'):
        tiny.TinyCNN(in_size=16)
    assert tiny.TinyCNN(in_size=HW)(torch.zeros((1, 3, HW, HW))).shape \
        == (1, 10)


def test_decomp_shard_with_communicate_inverse_raises():
    with pytest.raises(ValueError, match='decomp_shard IS a communication'):
        tkfac.KFAC(variant='eigen_dp', decomp_shard=True,
                   exclude_parts='CommunicateInverse')
    with pytest.raises(ValueError, match='decomp_shard IS a communication'):
        jkfac.KFAC(variant='eigen_dp', decomp_shard=True,
                   exclude_parts='CommunicateInverse')
    # the shard and the other ablations compose
    tkfac.KFAC(variant='eigen_dp', decomp_shard=True,
               exclude_parts='ComputeFactor,CommunicateFactor')


@pytest.mark.parametrize('trainer', ['train_cifar', 'train_imagenet'])
def test_trainers_take_exclude_parts(trainer):
    import importlib
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{trainer}')
    argv = ['--device', 'cpu', '--exclude-parts',
            'ComputeFactor,CommunicateInverse']
    args = mod.parse_args(argv)
    pre = mod.kfac_for(args, 1)
    assert (pre.exclude_compute_factor, pre.exclude_communicate_factor,
            pre.exclude_compute_inverse, pre.exclude_communicate_inverse) \
        == (True, False, False, True)
