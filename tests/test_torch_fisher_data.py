"""The port's F1mc Fisher, its pseudo-label sampler and its CIFAR data path
against the JAX package.

F1mc: three ``eigen_dp`` steps as ``tests/test_torch_slice.py`` runs them
(``_make(1)``, batch 8 at 16x16, ``kfac_update_freq=2``, the warmup lr),
both packages sampling the same labels (numpy's, from a seed, injected
through ``fisher_sample_fn``: torch cannot reproduce
``jax.random.categorical``'s bits), with the slice's tolerances: factors
1e-5 relative plus 1e-6 of sqrt(F_ii F_jj), parameters 5e-4 of each
tensor's largest entry. The port's own sampler is held to ``softmax`` by a
chi-square test and to its seeding.

Data: the augmentation (the native library, compiled here with the
system ``c++``, and the numpy branch), the CIFAR-10 pickle reader and the
prefetching loader give JAX's bits, and the CIFAR trainer reads
``--dir``.
"""

import os
import pickle
import tarfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import data as jdata
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.utils import lr as jlr
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import native_lib
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_resnet as tresnet
from kfac_pytorch_tpu_torch.utils import lr as tlr
from kfac_pytorch_tpu_torch.utils.losses import sample_pseudo_labels

torch.set_num_threads(2)

STEPS, BS, HW = 3, 8, 16
HP = dict(lr=0.1, damping=0.003, kfac_update_freq=2, kl_clip=0.001,
          factor_decay=0.95)
FACTOR_RTOL, FACTOR_ATOL = 1e-5, 1e-6
PARAM_RTOL = 5e-4
#: the pseudo labels both packages draw (numpy's, from a seed)
PSEUDO = np.random.RandomState(11).randint(0, 10, BS)


def _lr_fn(mod):
    return mod.warmup_multistep(0.1, 4, 1, [35])


def _batches():
    r = np.random.RandomState(0)
    return [{'input': r.randn(BS, HW, HW, 3).astype(np.float32),
             'label': r.randint(0, 10, BS).astype(np.int64)}
            for _ in range(STEPS)]


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


@pytest.fixture(scope='module')
def jax_f1mc():
    model = jresnet._make(1)
    lr_fn = _lr_fn(jlr)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-4)
    pre = jkfac.KFAC(variant='eigen_dp', health=False, **HP)
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, HW, HW, 3))))(
            jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.extra_vars['batch_stats']))

    def loss_fn(out, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, batch['label']).mean()

    step = jtraining.build_train_step(
        model, tx, pre, loss_fn, extra_mutable=('batch_stats',),
        fisher_type='F1mc', fisher_sample_fn=lambda rng, out: jnp.asarray(
            PSEUDO))
    factors = []
    for i, b in enumerate(_batches()):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        lr=float(lr_fn(i)), damping=HP['damping'])
        factors.append(_np_tree(state.kfac_state.factors))
    return {'init': init, 'factors': factors,
            'params': _np_tree(state.params),
            'batch_stats': _np_tree(state.extra_vars['batch_stats'])}


def _port_run(init, fisher_type, steps=STEPS, capture_impl=None):
    model = tresnet._make(1)
    model.load_state_dict(weights.params_from_jax(*init))
    lr_fn = _lr_fn(tlr)
    tx = ttraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-4)
    pre = tkfac.KFAC(variant='eigen_dp', capture_impl=capture_impl, **HP)
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, HW, HW, 3), np.float32),
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: F.cross_entropy(out, b['label']),
        fisher_type=fisher_type,
        fisher_sample_fn=lambda gen, out: torch.from_numpy(PSEUDO))
    factors = []
    for i, b in enumerate(_batches()[:steps]):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        lr=lr_fn(i), damping=HP['damping'])
        factors.append({k: v.clone() for k, v in
                        state.kfac_state.factors.items()})
    return state, factors


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_f1mc_three_steps_match_jax(jax_f1mc, capture_impl):
    state, factors = _port_run(jax_f1mc['init'], 'F1mc',
                               capture_impl=capture_impl)
    for i in range(STEPS):
        for k, want in jax_f1mc['factors'][i].items():
            got = factors[i][k].double().numpy()
            d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
            bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                     + FACTOR_RTOL * np.abs(want))
            assert np.all(np.abs(got - want) <= bound), (i, k)
    want_sd = weights.params_from_jax(jax_f1mc['params'],
                                      jax_f1mc['batch_stats'])
    got_sd = state.model.state_dict()
    for k, want in want_sd.items():
        err = _rel_to_max(got_sd[k].numpy(), want.numpy())
        assert err <= PARAM_RTOL, (k, err)


def test_f1mc_keeps_real_grads_and_bn(jax_f1mc):
    """One F1mc step moves the BatchNorm statistics once and leaves the
    real loss's parameter gradients in place: both bitwise a Femp step's;
    only the factors' G differs."""
    femp, ff = _port_run(jax_f1mc['init'], 'Femp', steps=1)
    f1mc, fm = _port_run(jax_f1mc['init'], 'F1mc', steps=1)
    for (k, a), b in zip(femp.model.named_buffers(), f1mc.model.buffers()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(femp.model.named_parameters(),
                         f1mc.model.parameters()):
        assert torch.equal(a.grad, b.grad), k
    assert any(not torch.equal(ff[0][k], fm[0][k]) for k in ff[0])


def test_sample_pseudo_labels():
    """20,000 draws from fixed logits pass a chi-square test against
    softmax; a seed and step give the same labels, another step others."""
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0, 1.0])
    out = logits.repeat(20000, 1)
    gen = ttraining.fisher_generator(42, 3, None, 'cpu')
    labels = sample_pseudo_labels(gen, out)
    counts = np.bincount(labels.numpy(), minlength=5)
    p = torch.softmax(logits.double(), 0).numpy()
    expect = p / p.sum() * counts.sum()
    assert scipy.stats.chisquare(counts, expect).pvalue > 1e-3
    again = sample_pseudo_labels(ttraining.fisher_generator(42, 3, None,
                                                            'cpu'), out)
    assert torch.equal(labels, again)
    other = sample_pseudo_labels(ttraining.fisher_generator(42, 4, None,
                                                            'cpu'), out)
    assert not torch.equal(labels, other)
    rank1 = sample_pseudo_labels(ttraining.fisher_generator(42, 3, 1, 'cpu'),
                                 out)
    assert not torch.equal(labels, rank1)


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------

def test_augment_matches_jax():
    """The native library builds with the system compiler into the port's
    build directory; native and numpy crops give JAX's bits."""
    lib = native_lib.get_lib()
    assert lib is not None, native_lib.build_error
    assert os.path.exists(native_lib.lib_path())
    assert os.path.dirname(native_lib.lib_path()) != os.path.dirname(
        native_lib.SOURCE)
    x = np.random.RandomState(0).rand(16, 32, 32, 3).astype(np.float32)
    want = jdata.augment_cifar(np.random.RandomState(5), x)
    calls = native_lib.augment_crop_flip.calls
    native = tdata.augment_cifar(np.random.RandomState(5), x)
    assert native_lib.augment_crop_flip.calls == calls + 1
    np.testing.assert_array_equal(native, want)
    r = np.random.RandomState(5)
    offs = r.randint(0, 9, size=(16, 2)).astype(np.int32)
    flips = r.rand(16) < 0.5
    np.testing.assert_array_equal(tdata.crop_flip(x, offs, flips), want)
    costs = np.random.RandomState(1).rand(13)
    from kfac_pytorch_tpu_torch.parallel import partition
    np.testing.assert_array_equal(native_lib.lpt_assign(costs, 3),
                                  partition.balanced_assign(costs, 3))
    np.testing.assert_array_equal(native_lib.block_partition(costs, 3),
                                  partition.block_partition(costs, 3))


def _write_cifar(root, n=6):
    """A CIFAR-10 ``cifar-10-batches-py`` directory with ``n`` images a
    batch, in the archive's pickle format."""
    base = os.path.join(root, 'cifar-10-batches-py')
    os.makedirs(base)
    r = np.random.RandomState(3)
    for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
        d = {b'data': r.randint(0, 256, (n, 3072)).astype(np.uint8),
             b'labels': [int(v) for v in r.randint(0, 10, n)]}
        with open(os.path.join(base, name), 'wb') as f:
            pickle.dump(d, f)
    return base


@pytest.fixture
def cifar_dirs(tmp_path):
    """``(pickles dir, archive-only dir)`` of the same data."""
    plain = tmp_path / 'plain'
    base = _write_cifar(str(plain))
    packed = tmp_path / 'packed'
    packed.mkdir()
    with tarfile.open(packed / 'cifar-10-python.tar.gz', 'w:gz') as tf:
        tf.add(base, arcname='cifar-10-batches-py')
    return str(plain), str(packed)


def test_load_cifar10_and_loader_match_jax(cifar_dirs):
    plain, packed = cifar_dirs
    want = jdata.load_cifar10(plain)
    for d in (plain, packed):
        got = tdata.get_cifar(d)
        for (wx, wy), (gx, gy) in zip(want, got):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    (x, y), _ = want
    jl = jdata.Loader(x, y, 4, train=True, augment=jdata.augment_cifar,
                      seed=42, shard=(0, 1))
    loaders = [tdata.Loader(x, y, 4, train=True, augment=tdata.augment_cifar,
                            seed=42) for _ in range(2)]
    for _ in range(2):   # two epochs: the child seeds agree at any depth
        jb = list(jl.epoch(prefetch_depth=0))
        for loader, depth in zip(loaders, (0, 2)):
            got = list(loader.epoch(prefetch_depth=depth))
            assert len(got) == len(jb) == 7
            for g, w in zip(got, jb):
                np.testing.assert_array_equal(g['input'], w['input'])
                np.testing.assert_array_equal(g['label'], w['label'])


def test_prefetch_close_stops_its_thread():
    def producers():
        return [t for t in threading.enumerate()
                if t.name == 'kfac-prefetch']

    before = len(producers())
    x = np.zeros((64, 32, 32, 3), np.float32)
    it = tdata.Loader(x, np.zeros(64, np.int64), 4).epoch(prefetch_depth=2)
    next(it)
    assert len(producers()) == before + 1
    it.close()
    assert len(producers()) == before
    with pytest.raises(StopIteration):
        next(it)


def test_train_cifar_reads_dir(cifar_dirs, capsys):
    from kfac_pytorch_tpu_torch import train_cifar
    plain, _ = cifar_dirs
    args = ['--device', 'cpu', '--dir', plain, '--model', 'resnet20',
            '--batch-size', '8', '--val-batch-size', '3', '--epochs', '1',
            '--steps-per-epoch', '2', '--kfac-type', 'F1mc']
    tr = train_cifar.Trainer(train_cifar.parse_args(args))
    np.testing.assert_array_equal(tr.train_loader.x,
                                  jdata.load_cifar10(plain)[0][0])
    assert tr.step_fn.health is not None
    train_cifar.main(args)
    assert 'epoch 0: train_loss' in capsys.readouterr().out
