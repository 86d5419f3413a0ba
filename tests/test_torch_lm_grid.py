"""``train_lm`` on a data x seq grid of gloo ranks against the JAX LM's
step on the same ``('data', 'seq')`` mesh.

A narrow LM (2 layers, d_model 32, 4 heads, L 32, batch 4, vocab 80:
only ``lm_head`` matches ``exclude_vocabulary_size``) takes three
``eigen_dp`` steps (a factor update and a decomposition every step: one
compiled JAX step a configuration) from the same weights and global
batches in both packages: the JAX side with
``examples/longcontext_lm.py``'s mesh, K-FAC axis and ``P('data',
'seq')`` batch specs (XLA attention blocks, the plain capture), the port
through ``train_lm.Trainer`` in
``tests/torch_dist_workers.lm_grid_runs`` (attention's and K2's plain
versions on CPU tensors). Configurations: (nd, ns) = (1, 2) ring, (1, 2)
Ulysses, (1, 2) ring with the bf16 factor wire (MPD ``eigen``, its
error-feedback residual carried), and (2, 2) ring.

Bounds: parameters within 5e-4 of each tensor's largest entry
(``tests/test_torch_lm_slice.py``'s; over the bf16 wire the factor rows
within its summation bound instead, the rule of
``tests/test_torch_distributed.py``), every K-FAC layer's weight moved
beyond that bound, the replicas bitwise equal; the sequence-sharded
gradients within the JAX test's 5e-4 of the dense model's
(``tests/test_long_context.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import models as jmodels
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu_torch import launch, weights

import torch_dist_workers as workers

VOCAB, B, L, STEPS = 80, 4, 32, 3
ARCH = dict(n_layer=2, n_head=4, d_model=32, max_len=L)
HP = dict(lr=0.1, damping=0.003, kfac_update_freq=1, kl_clip=0.001,
          factor_decay=0.95, fac_update_freq=1)
PARAM_RTOL = 5e-4
GRAD_TOL = 5e-4
ARGV = ['--device', 'cpu', '--seq-len', str(L), '--batch-size', str(B),
        '--n-layer', '2', '--n-head', '4', '--d-model', '32',
        '--synthetic-vocab', str(VOCAB), '--base-lr', '0.1',
        '--damping', '0.003', '--kfac-update-freq', '1']
#: name -> (data devices, seq devices, seq impl, variant, wire)
CONFIGS = {'ring_1x2': (1, 2, 'ring', 'eigen_dp', 'fp32'),
           'ulysses_1x2': (1, 2, 'ulysses', 'eigen_dp', 'fp32'),
           'ring_1x2_bf16': (1, 2, 'ring', 'eigen', 'bf16'),
           'ring_2x2': (2, 2, 'ring', 'eigen_dp', 'fp32')}


def _batches():
    r = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        toks = r.randint(0, VOCAB, (B, L + 1))
        out.append({'input': toks[:, :-1], 'label': toks[:, 1:]})
    return out


def _ce(outputs, batch):
    return optax.softmax_cross_entropy_with_integer_labels(
        outputs, batch['label']).mean()


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


def _jax_init():
    """The twin's (``seq_axis=None``) parameters and K-FAC layers, once for
    every configuration (neither depends on the shard's shape); the init
    compiled whole (eager flax pays a compile an op)."""
    twin = jmodels.transformer_lm(vocab_size=VOCAB, **ARCH)
    sample = jnp.zeros((B, L), jnp.int32)
    params = jax.jit(lambda k: jcapture.init(twin, {'params': k}, sample))(
        jax.random.PRNGKey(0))['params']
    metas = jcapture.collect_layer_meta(twin, {'params': params}, sample,
                                        train=False,
                                        exclude_vocabulary_size=VOCAB)
    return params, metas


def _jax_run(params, metas, nd, ns, impl, variant, wire):
    """The JAX example's step on an nd x ns mesh from ``params``: the
    final parameters and the K-FAC layer names."""
    ndev = nd * ns
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(nd, ns),
                ('data', 'seq'))
    axes = tuple(a for a, n in (('data', nd), ('seq', ns)) if n > 1)
    kfac_axis = axes if len(axes) > 1 else axes[0]
    model = jmodels.transformer_lm(vocab_size=VOCAB, seq_axis='seq',
                                   seq_impl=impl, **ARCH)
    pre = jkfac.KFAC(variant=variant, health=False, num_devices=ndev,
                     axis_name=kfac_axis, comm_precision=wire,
                     exclude_vocabulary_size=VOCAB, **HP)
    pre.setup(metas)
    tx = jtraining.sgd(HP['lr'], momentum=0.9)
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), kfac_state=pre.init(), extra_vars={})
    bspec = P('data' if nd > 1 else None, 'seq')
    step = jtraining.build_train_step(
        model, tx, pre, _ce, axis_name=kfac_axis, mesh=mesh,
        batch_specs={'input': bspec, 'label': bspec})
    for b in _batches():
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        lr=HP['lr'], damping=HP['damping'])
    return {'final': _np_tree(state.params),
            'factors': _np_tree(state.kfac_state.factors),
            'per_dev': {k: b.per_dev for k, b in pre.plan.buckets.items()},
            'metas': [m.name for m in pre.plan.metas]}


def _argv(nd, ns, impl, variant, wire):
    return ARGV + ['--data-devices', str(nd), '--seq-devices', str(ns),
                   '--seq-impl', impl, '--kfac-name', variant,
                   '--kfac-comm-precision', wire]


@pytest.fixture(scope='module')
def runs():
    params, metas = _jax_init()
    init = _np_tree(params)
    # the JAX step donates its state: the initial parameters are copied
    jax_runs = {name: {**_jax_run(_np_tree(params), metas, *cfg),
                       'init': init} for name, cfg in CONFIGS.items()}
    state_dict = {k: v.numpy() for k, v in
                  weights.transformer_lm_from_jax(init).items()}
    cfgs = {n: {} for n in (2, 4)}
    for name, cfg in CONFIGS.items():
        cfgs[cfg[0] * cfg[1]][name] = {
            'argv': _argv(*cfg), 'batches': _batches(),
            'state_dict': state_dict, 'dense': name == 'ring_1x2'}
    port = {}
    for n, group_cfgs in cfgs.items():
        ranks = launch.spawn(workers.lm_grid_runs, n, args=(group_cfgs,),
                             timeout=300)
        for name in group_cfgs:
            port[name] = [r[name] for r in ranks]
    return jax_runs, port


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _check_lossy_factors(ranks, want, world=2):
    """The bf16 wire's rule (``tests/test_torch_distributed.py``): each
    rank's factor rows after the last step within the bf16 summation
    bound of the mesh's, ``1.1 * world * 2^-8 * max|F|``. The packages'
    statistics differ by fp32 roundings, which tip some entries to the
    neighbouring bf16 value on the wire, and the damped eigenbasis of
    every later step amplifies those flips in the parameters."""
    for r, out in enumerate(ranks):
        for k, rows in out['factors'].items():
            per = want['per_dev'][int(k)]
            w = want['factors'][k][r * per:(r + 1) * per]
            bound = 1.1 * world * 2.0 ** -8 * np.abs(w).max()
            assert np.abs(rows - w).max() <= bound, (r, k)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_grid_steps_match_jax(runs, name):
    jax_runs, port = runs
    want, ranks = jax_runs[name], port[name]
    assert len({r['digest'] for r in ranks}) == 1, 'replicas differ'
    assert all(np.isfinite(r['losses']).all() for r in ranks)
    # the bf16 wire carries its error-feedback residual; fp32 none
    assert all((r['residual'] > 0) == (CONFIGS[name][4] == 'bf16')
               for r in ranks)
    want_sd = weights.transformer_lm_from_jax(want['final'])
    init_sd = weights.transformer_lm_from_jax(want['init'])
    got_sd = ranks[0]['state_dict']
    assert set(want_sd) == set(got_sd)
    if CONFIGS[name][4] == 'bf16':
        _check_lossy_factors(ranks, want)
    else:
        for k, w in want_sd.items():
            err = _rel_to_max(got_sd[k], w.numpy())
            assert err <= PARAM_RTOL, (k, err)
    for layer in want['metas']:
        k = layer.replace('/', '.') + '.weight'
        w1, w0 = want_sd[k].double().numpy(), init_sd[k].double().numpy()
        assert np.abs(w1 - w0).max() > PARAM_RTOL * np.abs(w1).max(), k


def test_sharded_grads_match_dense_and_the_loss_guard(runs):
    """The (1, 2) ring's gradients, averaged over the ranks, equal the
    dense model's; ``check_local_mean_loss`` passes the local loss (the
    ring's nodes sit behind it) and a loss straight out of Ulysses' swap,
    and refuses a loss reduced over the world; the launcher holds the
    LM's grid to ``--nproc``."""
    _, port = runs
    for r in port['ring_1x2']:
        for k, want in r['dense_grads'].items():
            np.testing.assert_allclose(r['sharded_grads'][k], want,
                                       atol=GRAD_TOL, rtol=GRAD_TOL)
        assert r['guard'] == {'local': True, 'ulysses': True,
                              'world_reduced': False}
    args = ['--device', 'cpu', '--data-devices', '2', '--seq-devices', '2']
    assert launch.check_world(4, args, trainer='train_lm') == args
    with pytest.raises(ValueError, match='grid'):
        launch.check_world(2, args, trainer='train_lm')
    with pytest.raises(ValueError, match='grid'):
        launch.check_world(2, ['--device', 'cpu'], trainer='train_lm')
