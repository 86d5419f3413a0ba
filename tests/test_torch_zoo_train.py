"""Narrow nets of the rest of the vision zoo trained three ``eigen_dp``
steps (a decomposition every step) in the port and in the JAX package,
from the same weights and batches:

- a two-stage CIFAR VGG (``cfg (8, 'M', 16, 'M')`` at 16 x 16, so the
  classifier reads a 4 x 4 map in Flax's NHWC order) through the CIFAR
  trainer's step: cross-entropy, SGD with momentum 0.9 and weight decay
  5e-4, damping 0.003, fp32;
- a narrow DenseNet-BC (``block_config (2, 2)``, growth 8, 16 initial
  features, a transition between the blocks) through the ImageNet
  trainer's step in bf16: the input cast to bf16, bf16 convolutions,
  BatchNorms and logits, label-smoothed cross-entropy, SGD with momentum
  0.9 and weight decay 5e-5, damping 0.002.

The port runs ``capture_impl`` None and 'auto' (the capture kernels'
plain versions on CPU tensors). Tolerances are
``tests/test_torch_imagenet.py``'s: in fp32 losses rtol 1e-5, the
factors of the first step (taken from the same weights) 1e-5 relative
plus 1e-6 of sqrt(F_ii F_jj), parameters and BatchNorm statistics 5e-4
of each tensor's largest entry (the classifier's weight and bias as the
one matrix K-FAC preconditions); in bf16 losses rtol 2^-8 and the whole
model's parameter gap ``||p - p_jax|| / ||p_jax - p0||`` within 2x the
same gap of an fp32 run (the port's own: a JAX fp32 compile would cost
more than the whole test, and the fp32 paths are held to JAX elsewhere).
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
from kfac_pytorch_tpu.models import cifar_vgg as jvgg
from kfac_pytorch_tpu.models import densenet as jdense
from kfac_pytorch_tpu.utils import losses as jlosses
from kfac_pytorch_tpu.utils import lr as jlr
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_vgg as tvgg
from kfac_pytorch_tpu_torch.models import densenet as tdense
from kfac_pytorch_tpu_torch.utils import losses as tlosses
from kfac_pytorch_tpu_torch.utils import lr as tlr
from tests.test_torch_imagenet import (BF16_LOSS_RTOL, BF16_TRAJ_FACTOR,
                                       DTYPES, FACTOR_ATOL, FACTOR_RTOL,
                                       LOSS_RTOL, PARAM_RTOL, _np_tree,
                                       _rel_to_max, _update_gap)

torch.set_num_threads(2)

STEPS, BS, CLASSES = 3, 8, 10
VGG_CFG = (8, 'M', 16, 'M')

#: per net: input size, the trainer's K-FAC damping, weight decay and
#: base lr, and (JAX net, port net) factories taking the dtypes
NETS = {
    'vgg': dict(
        hw=16, damping=0.003, wd=5e-4, lr=0.1,
        jax=lambda d: jvgg.CifarVGG(cfg=VGG_CFG, num_classes=CLASSES,
                                    dtype=d),
        port=lambda d: tvgg.CifarVGG(VGG_CFG, CLASSES, dtype=d, in_size=16)),
    'densenet': dict(
        hw=32, damping=0.002, wd=5e-5, lr=0.0125,
        jax=lambda d: jdense.DenseNet(block_config=(2, 2), growth_rate=8,
                                      num_init_features=16,
                                      num_classes=CLASSES, dtype=d),
        port=lambda d: tdense.DenseNet((2, 2), 8, 16, CLASSES, dtype=d)),
}


def _hp(net):
    cfg = NETS[net]
    return dict(lr=cfg['lr'], damping=cfg['damping'], kfac_update_freq=1,
                kl_clip=0.001, factor_decay=0.95)


def _lr_fn(mod, net):
    # 4 steps an epoch, one warmup epoch: the lr changes every step
    return mod.warmup_multistep(NETS[net]['lr'], 4, 1, [35])


def _batches(net):
    hw = NETS[net]['hw']
    r = np.random.RandomState(5)
    return [{'input': r.randn(BS, hw, hw, 3).astype(np.float32),
             'label': r.randint(0, CLASSES, BS).astype(np.int64)}
            for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(net, dtype):
    cfg = NETS[net]
    jdt = DTYPES[dtype][0]
    model = cfg['jax'](jdt)
    lr_fn = _lr_fn(jlr, net)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=cfg['wd'])
    hp = _hp(net)
    pre = jkfac.KFAC(variant='eigen_dp', health=False, **hp)
    hw = cfg['hw']
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, hw, hw, 3))))(
            jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.extra_vars['batch_stats']))

    def loss_fn(out, batch):
        if net == 'vgg':
            return optax.softmax_cross_entropy_with_integer_labels(
                out, batch['label']).mean()
        return jlosses.label_smoothing_cross_entropy(out, batch['label'],
                                                     smoothing=0.1)

    step = jtraining.build_train_step(model, tx, pre, loss_fn,
                                      extra_mutable=('batch_stats',))
    losses, factors = [], []
    for i, b in enumerate(_batches(net)):
        b = {'input': jnp.asarray(b['input'], jdt),
             'label': jnp.asarray(b['label'])}
        state, m = step(state, b, lr=float(lr_fn(i)), damping=hp['damping'])
        losses.append(float(m['loss']))
        factors.append(_np_tree(state.kfac_state.factors))
    return {'init': init, 'losses': losses, 'plan': pre.plan,
            'params': _np_tree(state.params),
            'batch_stats': _np_tree(state.extra_vars['batch_stats']),
            'factors': factors}


def _port_run(net, init, capture_impl, dtype=None):
    cfg = NETS[net]
    model = cfg['port'](dtype)
    model.load_state_dict(weights.params_from_jax(*init))
    lr_fn = _lr_fn(tlr, net)
    tx = ttraining.sgd(lr_fn, momentum=0.9, weight_decay=cfg['wd'])
    hp = _hp(net)
    pre = tkfac.KFAC(variant='eigen_dp', capture_impl=capture_impl, **hp)
    hw = cfg['hw']
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, hw, hw, 3), np.float32),
                                       device='cpu')
    if net == 'vgg':
        def loss_fn(out, b):
            return F.cross_entropy(out, b['label'])
    else:
        def loss_fn(out, b):
            return tlosses.label_smoothing_cross_entropy(out, b['label'],
                                                         smoothing=0.1)
    step = ttraining.build_train_step(model, tx, pre, loss_fn,
                                      input_dtype=dtype)
    losses, factors = [], []
    for i, b in enumerate(_batches(net)):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        lr=lr_fn(i), damping=hp['damping'])
        losses.append(float(m['loss']))
        factors.append(state.kfac_state.factors)
    return pre, state, losses, factors


def _joint_dense(sd):
    """``sd`` with the classifier's weight and bias as the one ``[W | b]``
    matrix the preconditioner updates: its 256 inputs make the bias
    column's update ~30x smaller than the weights', and it carries the
    matrix's rounding, not a bias-sized one."""
    sd = dict(sd)
    w, b = sd.pop('classifier.weight'), sd.pop('classifier.bias')
    sd['classifier'] = torch.cat([w, b[:, None]], dim=1)
    return sd


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_narrow_vgg_three_steps_match_jax(capture_impl):
    want = _jax_run('vgg', 'float32')
    pre, state, losses, factors = _port_run('vgg', want['init'],
                                            capture_impl)
    assert [m.name for m in pre.plan.metas] == \
        [m.name for m in want['plan'].metas]
    assert pre.plan.bucket_dims == want['plan'].bucket_dims
    np.testing.assert_allclose(losses, want['losses'], rtol=LOSS_RTOL)
    # the step before the first parameter update
    for key, w in want['factors'][0].items():
        got = factors[0][key].double().numpy()
        d = np.sqrt(np.abs(np.diagonal(w, axis1=1, axis2=2)))
        bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                 + FACTOR_RTOL * np.abs(w))
        assert np.all(np.abs(got - w) <= bound), key
    want_sd = _joint_dense(weights.params_from_jax(want['params'],
                                                   want['batch_stats']))
    got_sd = _joint_dense(state.model.state_dict())
    assert set(want_sd) == set(got_sd)
    for key, w in want_sd.items():
        err = _rel_to_max(got_sd[key].numpy(), w.numpy())
        assert err <= PARAM_RTOL, (key, err)


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_narrow_densenet_three_steps_match_jax_bf16(capture_impl):
    want = _jax_run('densenet', 'bfloat16')
    pre, state, losses, _ = _port_run('densenet', want['init'], capture_impl,
                                      torch.bfloat16)
    assert [m.name for m in pre.plan.metas] == \
        [m.name for m in want['plan'].metas]
    assert pre.plan.bucket_dims == want['plan'].bucket_dims
    np.testing.assert_allclose(losses, want['losses'], rtol=BF16_LOSS_RTOL)
    ref = weights.params_from_jax(want['params'], want['batch_stats'])
    init = weights.params_from_jax(*want['init'])
    got = state.model.state_dict()
    assert set(got) == set(ref)
    # the control: the same run in fp32 (the port's; the fp32 block and
    # VGG tests hold the port's fp32 path to JAX's at 1e-5 and 5e-4)
    fp32 = _port_run('densenet', want['init'], capture_impl)[1]
    control = _update_gap(fp32.model.state_dict(), ref, init)
    gap = _update_gap(got, ref, init)
    assert gap <= BF16_TRAJ_FACTOR * control, (gap, control)
