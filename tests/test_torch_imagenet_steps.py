"""The port's ImageNet slice against the JAX package, part 2: a narrow
stem + Bottleneck network trained three ``eigen_dp`` steps
(``kfac_update_freq=1``) with and without gradient accumulation, in
fp32 (bf16: ``tests/test_torch_imagenet_bf16_steps.py``).

The run (``tests/test_torch_slice.py``'s tolerances, fp32 op
order): losses rtol 1e-5; factors 1e-5 relative plus 1e-6 of
sqrt(F_ii F_jj); parameters and BatchNorm statistics 5e-4 of each
tensor's largest entry (the damped eigenbasis amplifies factor
rounding). As in ``tests/test_torch_lm_slice.py``, the factors are held
after the steps whose statistics both packages take from the same
weights: those before the first parameter update (one step, or two
when two batches accumulate). With a decomposition every step
(damping 0.002) the first update parts the parameters by ~1e-5 of
their largest entry, and a later statistic inherits that (1.5e-5
relative on a diagonal entry of step 3); the parameter bound holds
it. The port runs ``capture_impl`` None and 'auto' (the capture
kernels' plain versions on CPU tensors).
"""

import functools

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import nn as jknn
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu.models import imagenet_resnet as jres
from kfac_pytorch_tpu.utils import losses as jlosses
from kfac_pytorch_tpu.utils import lr as jlr
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import nn as tknn
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet as tres
from kfac_pytorch_tpu_torch.utils import losses as tlosses
from kfac_pytorch_tpu_torch.utils import lr as tlr

from test_torch_imagenet import (DTYPES, FACTOR_ATOL, FACTOR_RTOL,
                                 LOSS_RTOL, PARAM_RTOL, _np_tree,
                                 _rel_to_max)

torch.set_num_threads(2)
STEPS, BS, HW, CLASSES = 3, 8, 32, 10
HP = dict(lr=0.0125, damping=0.002, kfac_update_freq=1, kl_clip=0.001,
          factor_decay=0.95, assignment='balanced')


class JNarrow(linen.Module):
    """The ImageNet ResNet's stem and two Bottlenecks (the second with a
    stride-2 3x3 and a 1x1 stride-2 shortcut), narrow, computing in
    ``dtype`` as ``ResNet`` does."""
    dtype: jnp.dtype = jnp.float32

    @linen.compact
    def __call__(self, x, train=True):
        x = jknn.Conv(8, (7, 7), strides=(2, 2), padding=(3, 3),
                      use_bias=False, kernel_init=jres._kaiming,
                      dtype=self.dtype, name='conv1')(x)
        x = linen.relu(jres._norm(train, self.dtype, 'bn1')(x))
        x = linen.max_pool(x, (3, 3), strides=(2, 2),
                           padding=((1, 1), (1, 1)))
        x = jres.Bottleneck(planes=4, stride=1, downsample=True,
                            dtype=self.dtype, name='layer1_0')(x, train=train)
        x = jres.Bottleneck(planes=4, stride=2, downsample=True,
                            dtype=self.dtype, name='layer2_0')(x, train=train)
        x = jnp.mean(x, axis=(1, 2))
        return jknn.Dense(CLASSES, kernel_init=jres._kaiming,
                          dtype=self.dtype, name='fc')(x)


class TNarrow(torch.nn.Module):
    input_layout = 'NHWC'

    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = tknn.Conv2d(3, 8, 7, stride=2, padding=3, bias=False,
                                 compute_dtype=dtype)
        self.bn1 = cifar_resnet.BatchNorm2d(8, dtype=dtype)
        self.layer1_0 = tres.Bottleneck(8, 4, 1, True, dtype=dtype)
        self.layer2_0 = tres.Bottleneck(16, 4, 2, True, dtype=dtype)
        self.fc = tknn.Linear(16, CLASSES, compute_dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer2_0(self.layer1_0(x))
        return self.fc(x.mean(dim=(2, 3)))


def _lr_fn(mod, k):
    # 4 steps an epoch, one warmup epoch, the trainer's batch scale
    return mod.warmup_multistep(HP['lr'], 4, 1, [35], scale=k)


def _batches():
    r = np.random.RandomState(3)
    return [{'input': r.randn(BS, HW, HW, 3).astype(np.float32),
             'label': r.randint(0, CLASSES, BS).astype(np.int64)}
            for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(k, dtype='float32'):
    """The JAX trainer's step on JNarrow: ``k`` batches a parameter
    update, the input cast to ``dtype`` as ``examples/imagenet_resnet.py``
    casts it."""
    jdt = DTYPES[dtype][0]
    model = JNarrow(dtype=jdt)
    lr_fn = _lr_fn(jlr, k)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-5)
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    hp = {n: v for n, v in HP.items() if n != 'lr'}
    pre = jkfac.KFAC(variant='eigen_dp', health=False, lr=HP['lr'], **hp)
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, HW, HW, 3))))(
            jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.extra_vars['batch_stats']))

    def loss_fn(out, batch):
        return jlosses.label_smoothing_cross_entropy(out, batch['label'],
                                                     smoothing=0.1)

    step = jtraining.build_train_step(model, tx, pre, loss_fn,
                                      extra_mutable=('batch_stats',))
    losses, factors = [], []
    for i, b in enumerate(_batches()):
        b = {'input': jnp.asarray(b['input'], jdt),
             'label': jnp.asarray(b['label'])}
        state, m = step(state, b, lr=float(lr_fn(i)), damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(_np_tree(state.kfac_state.factors))
    return {'k': k, 'init': init, 'losses': losses, 'plan': pre.plan,
            'params': _np_tree(state.params),
            'batch_stats': _np_tree(state.extra_vars['batch_stats']),
            'factors': factors}


@pytest.fixture(scope='module', params=[1, 2], ids=['bpa1', 'bpa2'])
def jax_run(request):
    return _jax_run(request.param)


def _port_run(init, k, capture_impl, dtype=None):
    model = TNarrow(dtype)
    model.load_state_dict(weights.params_from_jax(*init))
    lr_fn = _lr_fn(tlr, k)
    tx = ttraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-5)
    if k > 1:
        tx = ttraining.MultiSteps(tx, k)
    pre = tkfac.KFAC(variant='eigen_dp', capture_impl=capture_impl, **HP)
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, HW, HW, 3), np.float32),
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: tlosses.label_smoothing_cross_entropy(
            out, b['label'], smoothing=0.1), input_dtype=dtype)
    losses, factors = [], []
    for i, b in enumerate(_batches()):
        state, m = step(state, {kk: torch.from_numpy(v)
                                for kk, v in b.items()},
                        lr=lr_fn(i), damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(state.kfac_state.factors)
    return pre, state, losses, factors


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_narrow_resnet_three_steps_match_jax(jax_run, capture_impl):
    k = jax_run['k']
    pre, state, losses, factors = _port_run(jax_run['init'], k,
                                            capture_impl)
    assert [m.name for m in pre.plan.metas] == \
        [m.name for m in jax_run['plan'].metas]
    assert pre.plan.bucket_dims == jax_run['plan'].bucket_dims
    np.testing.assert_allclose(losses, jax_run['losses'], rtol=LOSS_RTOL)
    for i in range(k):   # the steps before the first parameter update
        for key, want in jax_run['factors'][i].items():
            got = factors[i][key].double().numpy()
            d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
            bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                     + FACTOR_RTOL * np.abs(want))
            assert np.all(np.abs(got - want) <= bound), (i, key)
    want_sd = weights.params_from_jax(jax_run['params'],
                                      jax_run['batch_stats'])
    got_sd = state.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for key, want in want_sd.items():
        err = _rel_to_max(got_sd[key].numpy(), want.numpy())
        assert err <= PARAM_RTOL, (key, err)
    if k > 1:
        # the third call only accumulated: one inner update was applied
        assert state.opt_state['gradient_step'] == 1
        assert state.opt_state['mini_step'] == 1
