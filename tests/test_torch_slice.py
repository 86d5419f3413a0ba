"""The port's slice as a whole against the JAX package: a ResNet-8-width
CIFAR ResNet (``_make(1)``), batch 8 at 16x16, three ``eigen_dp`` steps
with ``kfac_update_freq=2`` (decompositions on steps 0 and 2), SGD with
momentum, weight decay and the warmup lr schedule. The JAX trainer runs
``capture_impl=None`` (its XLA capture path); the port runs from the same
weights (``weights.params_from_jax``) and batches with ``capture_impl``
None and 'auto' (the capture kernels' plain versions on CPU tensors).

Tolerances, all from fp32 op-order differences between XLA and PyTorch
on the CPU: losses rtol 1e-5; factors 1e-5 relative plus 1e-6 of
sqrt(F_ii F_jj) (the Cauchy-Schwarz bound of an entry's summed terms);
parameters and BN statistics 5e-4 of each tensor's largest entry — the
eigh-amplification bound tests/test_pallas_capture.py uses for the
preconditioned gradient (the damped eigenbasis turns factor rounding
into ~1e-4 relative changes of the update).
"""

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
from kfac_pytorch_tpu.utils import lr as jlr
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import scheduler as tscheduler
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_resnet as tresnet
from kfac_pytorch_tpu_torch.utils import lr as tlr

torch.set_num_threads(2)

STEPS, BS, HW = 3, 8, 16
HP = dict(lr=0.1, damping=0.003, kfac_update_freq=2, kl_clip=0.001,
          factor_decay=0.95)
LOSS_RTOL = 1e-5
FACTOR_RTOL, FACTOR_ATOL = 1e-5, 1e-6
PARAM_RTOL = 5e-4


def _lr_fn(mod):
    # 4 steps per epoch, one warmup epoch: the lr changes every step
    return mod.warmup_multistep(0.1, 4, 1, [35])


def _batches():
    r = np.random.RandomState(0)
    return [{'input': r.randn(BS, HW, HW, 3).astype(np.float32),
             'label': r.randint(0, 10, BS).astype(np.int64)}
            for _ in range(STEPS)]


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


@pytest.fixture(scope='module')
def jax_run():
    model = jresnet._make(1)
    lr_fn = _lr_fn(jlr)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-4)
    # the port's trainer has no health guard yet (finite values pass
    # through it unchanged); without it the JAX step compiles in a third
    # of the time
    pre = jkfac.KFAC(variant='eigen_dp', health=False, **HP)
    # one compiled init (Flax's eager init costs several times more here)
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, HW, HW, 3))))(
            jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.extra_vars['batch_stats']))

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch['label']).mean()

    step = jtraining.build_train_step(model, tx, pre, loss_fn,
                                      extra_mutable=('batch_stats',))
    losses = []
    for i, b in enumerate(_batches()):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        lr=float(lr_fn(i)), damping=HP['damping'])
        losses.append(float(m['loss']))
    return {'init': init, 'losses': losses, 'plan': pre.plan,
            'params': _np_tree(state.params),
            'batch_stats': _np_tree(state.extra_vars['batch_stats']),
            'factors': _np_tree(state.kfac_state.factors)}


def _port_run(init, capture_impl):
    model = tresnet._make(1)
    model.load_state_dict(weights.params_from_jax(*init))
    lr_fn = _lr_fn(tlr)
    tx = ttraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-4)
    pre = tkfac.KFAC(variant='eigen_dp', capture_impl=capture_impl, **HP)
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, HW, HW, 3), np.float32),
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: F.cross_entropy(out, b['label']))
    losses = []
    for i, b in enumerate(_batches()):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        lr=lr_fn(i), damping=HP['damping'])
        losses.append(float(m['loss']))
    return pre, state, losses


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_eigen_dp_three_steps_match_jax(jax_run, capture_impl):
    pre, state, losses = _port_run(jax_run['init'], capture_impl)
    # same layers, same plan
    assert [m.name for m in pre.plan.metas] == \
        [m.name for m in jax_run['plan'].metas]
    assert pre.plan.bucket_dims == jax_run['plan'].bucket_dims
    np.testing.assert_allclose(losses, jax_run['losses'], rtol=LOSS_RTOL)
    for k, want in jax_run['factors'].items():
        got = state.kfac_state.factors[k].double().numpy()
        d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
        bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                 + FACTOR_RTOL * np.abs(want))
        assert np.all(np.abs(got - want) <= bound), k
    want_sd = weights.params_from_jax(jax_run['params'],
                                      jax_run['batch_stats'])
    got_sd = state.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, want in want_sd.items():
        err = _rel_to_max(got_sd[k].numpy(), want.numpy())
        assert err <= PARAM_RTOL, (k, err)


def test_lr_schedule_matches_jax():
    jfn = jlr.warmup_multistep(0.1, 16, 5, [35, 75, 90])
    tfn = tlr.warmup_multistep(0.1, 16, 5, [35, 75, 90])
    for step in (0, 1, 7, 40, 79, 80, 81, 16 * 40):
        assert np.float32(tfn(step)) == np.float32(jfn(step)), step


def test_scheduler_matches_jax():
    jpre = jkfac.KFAC(variant='eigen_dp', damping=0.003, kfac_update_freq=10)
    tpre = tkfac.KFAC(variant='eigen_dp', damping=0.003, kfac_update_freq=10)
    kw = dict(damping_alpha=0.5, damping_schedule=[2, 4],
              update_freq_alpha=10, update_freq_schedule=[3])
    js = jkfac.KFACParamScheduler(jpre, **kw)
    ts = tscheduler.KFACParamScheduler(tpre, **kw)
    for epoch in range(1, 6):
        js.step(epoch)
        ts.step(epoch)
        assert (tpre.damping, tpre.fac_update_freq, tpre.kfac_update_freq) \
            == (jpre.damping, jpre.fac_update_freq, jpre.kfac_update_freq)
