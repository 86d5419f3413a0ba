"""The Multi-30k and SQuAD trainers at ``--num-devices 2`` against the
JAX examples' step on a 2-device ``'batch'`` mesh.

Three ``eigen_dp`` steps (a factor update and a decomposition every
step) of each trainer on two gloo ranks
(``tests/torch_dist_workers.seq_world_runs``: each rank its rows of the
global batch, the gradients averaged, K-FAC over the world), from the
JAX initial weights, against JAX's ``build_train_step(axis_name='batch',
mesh=...)`` on the same global batches, with dropout 0 (each rank's masks
come from its own stream, which cannot draw JAX's bits). The sizes,
flags and bounds are ``tests/test_torch_seq_train.py``'s world=1 ones:
the parameters within 5e-4 of each tensor's largest entry plus 1e-7,
every K-FAC layer's weight moved beyond that bound; and the two ranks'
replicas bitwise equal. With dropout on, the ranks draw different masks
(``training.dropout_rng``: seeded by ``(seed + 2, step, rank)``), one
rank the same masks again for the same step, and the replicas still
agree after a step; without a preconditioner (Adam) the gradients are
averaged all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcap
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu import utils as jutils
from kfac_pytorch_tpu.models import bert as jbert
from kfac_pytorch_tpu.models import transformer as jtr
from kfac_pytorch_tpu_torch import launch, train_multi30k, train_squad
from kfac_pytorch_tpu_torch import weights

import torch_dist_workers as workers
from test_torch_seq_train import (KFAC_HP, M30K, SQUAD, STEPS, Wrapped,
                                  _assert_kfac_weights_moved,
                                  _assert_params_close, _init,
                                  _jax_steps, _multi30k_loss, _np)

WORLD = 2


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ('batch',))


def _jax_world2(model, tx, pre, loss_fn, batches, lr, damping):
    """JAX's step on the 'batch' mesh from ``model``'s seeded init: the
    initial and final parameters and the K-FAC layer names."""
    sample = tuple(jnp.asarray(t[:len(t) // WORLD])
                   for t in batches[0]['input'])
    params = _init(model, sample)
    pre.setup(jcap.collect_layer_meta(model, {'params': params}, sample,
                                      train=False,
                                      exclude_vocabulary_size=pre
                                      .exclude_vocabulary_size))
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), kfac_state=pre.init(), extra_vars={})
    init = _np(params)
    step = jtraining.build_train_step(model, tx, pre, loss_fn,
                                      axis_name='batch', mesh=_mesh())
    final = _jax_steps(step, state, batches, lr, damping)
    return {'init': init, 'final': final,
            'metas': [m.name for m in pre.plan.metas]}


def _multi30k_jax():
    a = train_multi30k.parse_args(M30K)
    tr = train_multi30k.Trainer(a)
    batches = list(tr.batches(0))[:STEPS]
    v = a.synthetic_vocab
    model = Wrapped(inner=jtr.Transformer(
        n_src_vocab=v, n_trg_vocab=v, src_pad_idx=1, trg_pad_idx=1,
        d_word_vec=a.d_model, d_model=a.d_model, d_inner=a.d_inner,
        n_layers=a.n_layers, n_head=a.n_head, d_k=a.d_model // a.n_head,
        d_v=a.d_model // a.n_head, dropout=0.0, n_position=200))
    lr_fn = jutils.warmup_multistep(
        a.base_lr, max(len(tr.train_src) // a.batch_size, 1), 5, a.lr_decay)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-4)
    pre = jkfac.get_kfac_module('eigen_dp')(
        lr=a.base_lr, damping=a.damping, exclude_vocabulary_size=v,
        num_devices=WORLD, axis_name='batch', **KFAC_HP)
    run = _jax_world2(model, tx, pre, _multi30k_loss(a.label_smoothing, 1),
                      batches, a.base_lr, a.damping)
    return {**run, 'batches': batches, 'argv': M30K, 'module':
            'train_multi30k'}


def _squad_jax():
    import optax
    a = train_squad.parse_args(SQUAD)
    tr = train_squad.Trainer(a)
    batches = [tr.batch(np.arange(i * 4, (i + 1) * 4)) for i in range(STEPS)]
    cfg = jbert.BertConfig.tiny(max_position_embeddings=64,
                                hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)
    model = jbert.BertForQuestionAnswering(cfg)
    total = len(tr.train[0]) // a.batch_size * a.epochs
    lr_fn = jutils.polynomial_decay(
        a.base_lr, total, power=1.0,
        warmup_steps=int(total * a.warmup_frac))
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=0.0)
    pre = jkfac.get_kfac_module('eigen_dp')(
        lr=a.base_lr, damping=a.damping,
        exclude_vocabulary_size=cfg.vocab_size, num_devices=WORLD,
        axis_name='batch', **KFAC_HP)

    def loss_fn(outputs, batch):
        s, e = outputs
        return (optax.softmax_cross_entropy_with_integer_labels(
            s, batch['label'][:, 0]).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                e, batch['label'][:, 1]).mean()) / 2.0

    run = _jax_world2(model, tx, pre, loss_fn, batches, a.base_lr,
                      a.damping)
    return {**run, 'batches': batches, 'argv': SQUAD, 'module':
            'train_squad', 'no_dropout': True}


@pytest.fixture(scope='module')
def runs():
    jax_runs = {'multi30k': _multi30k_jax(), 'squad': _squad_jax()}
    cfgs = {name: {'module': r['module'], 'argv': r['argv'],
                   'batches': r['batches'],
                   'no_dropout': r.get('no_dropout', False),
                   'state_dict': {k: v.numpy() for k, v in
                                  weights.params_from_jax(r['init'])
                                  .items()}}
            for name, r in jax_runs.items()}
    # dropout on: the probe's masks, then one step
    probe = cfgs['multi30k']['batches'][0]['input']
    cfgs['dropout'] = {'module': 'train_multi30k',
                       'argv': M30K + ['--dropout', '0.5'],
                       'batches': cfgs['multi30k']['batches'][:1],
                       'dropout_probe': tuple(t[:2] for t in probe)}
    # no preconditioner: Adam's gradients are averaged all the same
    cfgs['adam'] = {'module': 'train_multi30k',
                    'argv': M30K + ['--optimizer', 'adam'],
                    'batches': cfgs['multi30k']['batches'][:2]}
    ranks = launch.spawn(workers.seq_world_runs, WORLD, args=(cfgs,),
                         timeout=300)
    return jax_runs, {name: [r[name] for r in ranks] for name in cfgs}


@pytest.mark.parametrize('trainer', ['multi30k', 'squad'])
def test_world2_steps_match_jax(runs, trainer):
    jax_runs, port = runs
    ranks = port[trainer]
    assert ranks[0]['digest'] == ranks[1]['digest'], 'replicas differ'
    assert ranks[0]['losses'] == ranks[1]['losses']
    assert np.all(np.isfinite(ranks[0]['losses']))
    got = {k: torch.from_numpy(v)
           for k, v in ranks[0]['state_dict'].items()}
    _assert_params_close(got, jax_runs[trainer]['final'])
    _assert_kfac_weights_moved(jax_runs[trainer])


def test_dropout_masks_differ_between_ranks(runs):
    _, port = runs
    (a0, a1, b0), (c0, c1, d0) = (r['probes'] for r in port['dropout'])
    # one rank, one step: the same masks again; another step, others
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_array_equal(c0, c1)
    assert not np.array_equal(a0, b0) and not np.array_equal(c0, d0)
    # the same input and weights on both ranks: only the masks differ
    assert not np.array_equal(a0, c0)
    r0, r1 = port['dropout']
    assert r0['digest'] == r1['digest']
    assert np.all(np.isfinite(r0['losses']))


def test_world2_without_kfac_averages_gradients(runs):
    """``--optimizer adam`` (no preconditioner) at world 2: each rank
    trains on its own rows, and the replicas stay bitwise equal only if
    the step averages the gradients over the group."""
    _, port = runs
    r0, r1 = port['adam']
    assert r0['digest'] == r1['digest'] and r0['losses'] == r1['losses']
    assert np.all(np.isfinite(r0['losses']))
