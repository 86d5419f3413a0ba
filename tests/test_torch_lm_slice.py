"""The port's second slice against the JAX package, part 1: the
long-context ``TransformerLM``'s K-FAC layers (``exclude_vocabulary_size``
keeps only the trailing head out, as JAX's ``filter_vocab_head``) and
``train_lm`` on the CPU, at world 1 and on two gloo ranks. The model's
logits and three ``eigen_dp`` steps against JAX are
``tests/test_torch_lm_steps.py``, the corpus and the batches
``tests/test_torch_lm_corpus.py`` (files of their own, so the suite's
scheduler runs their JAX work beside the longest files).
"""

import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import launch
from kfac_pytorch_tpu_torch import models as tmodels
from kfac_pytorch_tpu_torch import train_lm

import torch_dist_workers as workers

torch.set_num_threads(2)

VOCAB, B, L, STEPS = 96, 4, 64, 3
ARCH = dict(n_layer=2, n_head=8, d_model=64, max_len=L)
HP = dict(lr=0.1, damping=0.003, kfac_update_freq=2, kl_clip=0.001,
          factor_decay=0.95)
LOSS_RTOL = 1e-5
FACTOR_RTOL, FACTOR_ATOL = 1e-5, 1e-6
PARAM_RTOL = 5e-4


def _batches():
    r = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        toks = r.randint(0, VOCAB, (B, L + 1))
        out.append({'input': toks[:, :-1], 'label': toks[:, 1:]})
    return out


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


def _ce(outputs, batch):
    return optax.softmax_cross_entropy_with_integer_labels(
        outputs, batch['label']).mean()


def _dense(name, out_dim, in_dim=8):
    return tcapture.LayerMeta(name=name, path=tuple(name.split('/')),
                              kind='dense', use_bias=True, in_dim=in_dim + 1,
                              out_dim=out_dim, kernel_shape=(in_dim, out_dim))


@pytest.mark.parametrize('dims,vocab,dropped,warns', [
    ((16, 32, 96), 96, ['c'], False),      # the trailing head goes
    ((96, 32, 96), 96, ['c'], True),       # an interior match stays, warned
    ((16, 96, 32), 96, [], True),          # no trailing head: nothing goes
    ((16, 32, 64), 96, [], False),         # no match at all
])
def test_filter_vocab_head_matches_jax(dims, vocab, dropped, warns):
    metas = {n: _dense(n, d) for n, d in zip('abc', dims)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = tcapture.filter_vocab_head(metas, vocab)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = jcapture.filter_vocab_head(metas, vocab)
    assert list(got) == list(want) == [n for n in 'abc' if n not in dropped]
    assert any('exclude_vocabulary_size' in str(w.message)
               for w in caught) == warns


def test_vocab_equal_to_d_model_warns_and_keeps_interior_layers():
    """vocab == d_model: proj and fc2 (out_dim d_model) match the
    vocabulary size too; only the trailing lm_head leaves the plan."""
    model = tmodels.transformer_lm(vocab_size=32, n_layer=1, n_head=4,
                                   d_model=32, max_len=8)
    with pytest.warns(UserWarning, match='block0/attn/proj'):
        metas = tcapture.collect_layer_meta(
            model, torch.zeros((1, 8), dtype=torch.int64),
            exclude_vocabulary_size=32)
    assert list(metas) == ['block0/attn/qkv', 'block0/attn/proj',
                           'block0/fc1', 'block0/fc2']


def test_train_lm_runs_on_cpu(capsys):
    train_lm.main(['--device', 'cpu', '--seq-len', '32', '--n-layer', '1',
                   '--d-model', '32', '--n-head', '4', '--steps-per-epoch',
                   '3', '--epochs', '1', '--synthetic-vocab', '40',
                   '--kfac-update-freq', '2', '--kfac-capture-impl', 'auto'])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith('epoch 0: train_ppl ')
    assert np.isfinite(float(line.split()[3]))
    # the sequence axis over two gloo ranks (the grid's parity against
    # JAX: test_torch_lm_grid.py)
    ranks = launch.spawn(workers.trainer_main_run, 2, args=(
        'train_lm', ['--seq-len', '32', '--n-layer', '1', '--d-model', '32',
                     '--n-head', '4', '--steps-per-epoch', '2', '--epochs',
                     '1', '--synthetic-vocab', '40', '--kfac-update-freq',
                     '1', '--seq-devices', '2']), timeout=300)
    assert ranks[0]['digest'] == ranks[1]['digest']
    assert ranks[0]['stdout'].splitlines()[-1] == \
        'replicas: 2 ranks bitwise identical'
    assert ranks[1]['stdout'] == '' and ranks[0]['step'] == 2
