"""The port's second slice as a whole against the JAX package: the
long-context ``TransformerLM`` (2 layers, d_model 64, 8 heads, L 64,
vocab 96 — a vocabulary that differs from d_model and 4 d_model, so only
``lm_head`` matches ``exclude_vocabulary_size``) and three ``eigen_dp``
steps at world=1 with ``kfac_update_freq=2`` (decompositions on steps 0
and 2), SGD with momentum. The JAX side runs ``capture_impl=None`` and
its XLA attention; the port runs from the same weights
(``weights.transformer_lm_from_jax``) and batches, with the attention
kernels' and capture kernels' plain versions on CPU tensors.

Tolerances: logits 2e-4 (tests/test_long_context.py's); losses rtol
1e-5, factors 1e-5 relative plus 1e-6 of sqrt(F_ii F_jj), parameters 5e-4
of each tensor's largest entry (tests/test_torch_slice.py's, all from
fp32 op order; the damped eigenbasis amplifies factor rounding in the
update). Factors are held after the first step, where both packages take
the statistics from the same weights: the first update already parts
the parameters by up to ~7e-5 of their largest entry (damping 0.003),
and the later statistics of the deeper block inherit that gap, which the
parameter bound holds.
"""

import argparse
import importlib.util
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import models as jmodels
from kfac_pytorch_tpu import training as jtraining
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import models as tmodels
from kfac_pytorch_tpu_torch import train_lm
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


@pytest.fixture(scope='module')
def jax_run():
    model = jmodels.transformer_lm(vocab_size=VOCAB, **ARCH)
    tx = jtraining.sgd(HP['lr'], momentum=0.9)
    pre = jkfac.KFAC(variant='eigen_dp', health=False,
                     exclude_vocabulary_size=VOCAB, **HP)
    sample = jnp.zeros((B, L), jnp.int32)
    state = jtraining.init_train_state(model, tx, pre,
                                       jax.random.PRNGKey(0), sample)
    init = _np_tree(state.params)
    logits = np.asarray(model.apply({'params': state.params},
                                    jnp.asarray(_batches()[0]['input']),
                                    train=False))
    step = jtraining.build_train_step(model, tx, pre, _ce)
    losses, factors = [], []
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        lr=HP['lr'], damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(_np_tree(state.kfac_state.factors))
    return {'init': init, 'logits': logits, 'losses': losses,
            'plan': pre.plan, 'params': _np_tree(state.params),
            'factors': factors[0]}


def _port_model(init, block_impl):
    model = tmodels.transformer_lm(vocab_size=VOCAB, block_impl=block_impl,
                                   **ARCH)
    model.load_state_dict(weights.transformer_lm_from_jax(init))
    return model


@pytest.mark.parametrize('block_impl', ['auto', 'xla'])
def test_logits_match_jax(jax_run, block_impl):
    model = _port_model(jax_run['init'], block_impl).eval()
    with torch.no_grad():
        got = model(torch.as_tensor(_batches()[0]['input']))
    np.testing.assert_allclose(got.numpy(), jax_run['logits'], atol=2e-4,
                               rtol=2e-4)


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('capture_impl,block_impl', [
    (None, 'auto'), ('auto', 'auto'), ('auto', 'xla')])
def test_eigen_dp_three_steps_match_jax(jax_run, capture_impl, block_impl):
    model = _port_model(jax_run['init'], block_impl)
    tx = ttraining.sgd(HP['lr'], momentum=0.9)
    pre = tkfac.KFAC(variant='eigen_dp', capture_impl=capture_impl,
                     exclude_vocabulary_size=VOCAB, **HP)
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((B, L), np.int64),
                                       device='cpu')
    step = ttraining.build_train_step(model, tx, pre, train_lm.loss_fn)
    losses, factors = [], []
    for b in _batches():
        state, m = step(state, {k: torch.as_tensor(v, dtype=torch.int64)
                                for k, v in b.items()},
                        lr=HP['lr'], damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(state.kfac_state.factors)
    # same layers (lm_head excluded), same plan: factor dims 65/192/64/256
    # and 257 land on buckets 128, 192, 256 and 384
    names = [m.name for m in pre.plan.metas]
    assert names == [m.name for m in jax_run['plan'].metas]
    assert 'lm_head' not in names and len(names) == 4 * ARCH['n_layer']
    assert pre.plan.bucket_dims == jax_run['plan'].bucket_dims
    np.testing.assert_allclose(losses, jax_run['losses'], rtol=LOSS_RTOL)
    for k, want in jax_run['factors'].items():
        got = factors[0][k].double().numpy()
        d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
        bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                 + FACTOR_RTOL * np.abs(want))
        assert np.all(np.abs(got - want) <= bound), k
    want_sd = weights.transformer_lm_from_jax(jax_run['params'])
    got_sd = state.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, want in want_sd.items():
        err = _rel_to_max(got_sd[k].numpy(), want.numpy())
        assert err <= PARAM_RTOL, (k, err)


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


def test_capture_keeps_only_planned_layers():
    """The excluded head is not hooked: no activation or gradient of it
    is kept."""
    model = tmodels.transformer_lm(vocab_size=VOCAB, **ARCH)
    toks = torch.as_tensor(_batches()[0]['input'])
    metas = tcapture.collect_layer_meta(model, toks,
                                        exclude_vocabulary_size=VOCAB)
    with tcapture.Capture(model, metas.values()) as cap:
        train_lm.loss_fn(model(toks), {'label': toks}).backward()
    assert set(cap.acts) == set(cap.gs) == set(metas)
    assert 'lm_head' not in cap.acts
    assert cap.acts['block0/fc1'].shape == (B, L, ARCH['d_model'])


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        'longcontext_lm_example',
        os.path.join(ROOT, 'examples', 'longcontext_lm.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('text', [None, 'a b a c a b d e a b c a b'])
def test_corpus_and_batches_match_the_jax_trainer(tmp_path, text):
    """The synthetic Markov corpus (text None) and a text-file corpus
    (``--data``, vocabulary cut to ``vocab_limit``) give the JAX trainer's
    ids, and the sampler its batches."""
    data = None
    if text is not None:
        data = str(tmp_path / 'corpus.txt')
        with open(data, 'w') as f:
            f.write(' '.join([text] * 4))
    ex = _jax_example()
    args = argparse.Namespace(data=data, vocab_limit=4, synthetic_vocab=40,
                              batch_size=2, seq_len=8, seed=3,
                              steps_per_epoch=4)
    jids, jv = ex.load_corpus(args)
    tids, tv = tdata.load_corpus(data, 4, 40, 2, 8, 3)
    assert tv == jv == (40 if text is None else 4)
    np.testing.assert_array_equal(tids, jids)
    jb = list(ex.sample_batches(jids, args, np.random.RandomState(5)))
    tb = list(tdata.sample_lm_batches(tids, 8, 2, 4,
                                      np.random.RandomState(5)))
    assert len(tb) == len(jb) == 4
    for j, t in zip(jb, tb):
        for k in ('input', 'label'):
            np.testing.assert_array_equal(t[k], np.asarray(j[k]))


def test_train_lm_runs_on_cpu(capsys):
    train_lm.main(['--device', 'cpu', '--seq-len', '32', '--n-layer', '1',
                   '--d-model', '32', '--n-head', '4', '--steps-per-epoch',
                   '3', '--epochs', '1', '--synthetic-vocab', '40',
                   '--kfac-update-freq', '2', '--kfac-capture-impl', 'auto'])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith('epoch 0: train_ppl ')
    assert np.isfinite(float(line.split()[3]))
    with pytest.raises(NotImplementedError, match='port slices'):
        train_lm.main(['--device', 'cpu', '--seq-devices', '2'])
