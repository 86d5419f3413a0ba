"""The port's sequence trainers against the JAX examples' steps, and the
loader's multi-host shard.

- Three ``eigen_dp`` steps (a factor update and a decomposition every
  step) of each new trainer's step at a tiny size, against the JAX
  example's step built the same way (the same optimizer chain, schedule,
  loss and K-FAC flags, ``health=False`` on the JAX side, dropout 0),
  from the same weights and batches: the parameters within 5e-4 of each
  tensor's largest entry (tests/test_torch_lm_slice.py's bound), plus
  1e-7 absolute: the span head's softmax over positions is blind to a
  shift every position shares, so the last LayerNorm's bias takes a
  gradient of pure rounding noise (~1e-10), whose largest entry is no
  scale. Multi30k
  takes the label-smoothed SGD with weight decay under the warmup
  schedule, SQuAD the polynomial decay, the WikiText LSTM the global-norm
  clip before SGD with the per-timestep K-FAC cell; the port runs both
  capture paths (the plain ops, and ``auto``: K2's plain version).
- ``inverse_sqrt`` and ``polynomial_decay`` equal JAX's, float32 bit for
  bit, over a few dozen steps (and on the device form); the Adam chain's
  first three updates within 1e-6; the clip within 1e-6 on both branches.
- Each trainer's ``main`` runs one short epoch with ``--device cpu`` on
  its synthetic fallback and on a tiny corpus file written here, and
  ``--speed``; the corpus readers equal the JAX examples'.
- ``data.Loader(shard=)`` yields the JAX ``Loader``'s batches bit for bit
  for three shard layouts.

Each JAX step is compiled once per module (module-scoped fixtures).
"""

import importlib.util
import json
import os
import types

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcap
from kfac_pytorch_tpu import data as jdata
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu import utils as jutils
from kfac_pytorch_tpu.models import bert as jbert
from kfac_pytorch_tpu.models import rnn as jrnn
from kfac_pytorch_tpu.models import transformer as jtr
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import launch
from kfac_pytorch_tpu_torch import train_imagenet
from kfac_pytorch_tpu_torch import train_multi30k
from kfac_pytorch_tpu_torch import train_squad
from kfac_pytorch_tpu_torch import train_wikitext
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.utils import lr as tlr

import torch_dist_workers as workers

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-7
KFAC_HP = dict(fac_update_freq=1, kfac_update_freq=1, kl_clip=0.001,
               factor_decay=0.95, health=False)
CPU = ['--device', 'cpu']
M30K = CPU + ['--d-model', '16', '--d-inner', '32', '--n-layers', '1',
              '--n-head', '2', '--max-len', '12', '--batch-size', '8',
              '--synthetic-vocab', '40', '--synthetic-size', '64',
              '--dropout', '0', '--kfac-update-freq', '1']
SQUAD = CPU + ['--batch-size', '4', '--max-seq-length', '24',
               '--synthetic-size', '64', '--warmup-frac', '0.05',
               '--kfac-update-freq', '1']
WIKI = CPU + ['--embed-dim', '16', '--hidden-dim', '16', '--bptt', '8',
              '--batch-size', '4', '--synthetic-vocab', '30',
              '--synthetic-tokens', '2000', '--dropout', '0',
              '--kfac-update-freq', '1']


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(ROOT, 'examples', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Wrapped(linen.Module):
    """The JAX Multi-30k trainer's adapter (defined in its ``main``)."""
    inner: linen.Module

    @linen.compact
    def __call__(self, xs, train=True):
        return self.inner(xs[0], xs[1], train=train)


def _init(model, sample):
    """Flax parameters of ``model``, the init compiled whole (eager flax
    pays a compile an op)."""
    return jax.jit(lambda k: jcap.init(model, {'params': k}, sample))(
        jax.random.PRNGKey(0))['params']


def _np(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


def _jnp_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def _jax_steps(step, state, batches, lr, damping):
    for b in batches:
        state, _ = step(state, _jnp_batch(b), lr=lr, damping=damping)
    return _np(state.params)


def _port_steps(tr, init, batches):
    tr.state.model.load_state_dict(weights.params_from_jax(init))
    losses = [float(tr.train_step(b)['loss']) for b in batches]
    assert np.all(np.isfinite(losses)), losses
    return tr.state.model.state_dict()


def _assert_params_close(got_sd, want_params):
    want_sd = weights.params_from_jax(want_params)
    assert set(want_sd) == set(got_sd)
    for k, want in want_sd.items():
        got, want = got_sd[k].double().numpy(), want.double().numpy()
        err = np.abs(got - want).max()
        assert err <= PARAM_RTOL * np.abs(want).max() + PARAM_ATOL, (k, err)


def _assert_kfac_weights_moved(jax_run):
    """Each K-FAC layer's weight moved in the JAX run's steps by more
    than the bound the port is held to, so a port step that left a
    layer's update out, or got it wrong, cannot pass within the bound."""
    init = weights.params_from_jax(jax_run['init'])
    final = weights.params_from_jax(jax_run['final'])
    for name in jax_run['metas']:
        k = name.replace('/', '.') + '.weight'
        w0, w1 = init[k].double().numpy(), final[k].double().numpy()
        moved = np.abs(w1 - w0).max()
        assert moved > PARAM_RTOL * np.abs(w1).max() + PARAM_ATOL, (k, moved)


def _multi30k_loss(smoothing, pad):
    """The JAX example's loss (defined in its ``main``)."""
    def loss_fn(outputs, batch):
        logits = outputs[:, :-1]
        target = batch['label'][:, 1:]
        mask = (target != pad).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        V = logits.shape[-1]
        tgt = jax.nn.one_hot(target, V) * (1 - smoothing) + smoothing / V
        ll = -(tgt * logp).sum(-1)
        return (ll * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss_fn


@pytest.fixture(scope='module')
def multi30k_jax():
    """The JAX example's Multi-30k step at M30K's flags, three steps on
    the port trainer's first batches."""
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
        **KFAC_HP)
    sample = tuple(jnp.asarray(t) for t in batches[0]['input'])
    params = _init(model, sample)
    pre.setup(jcap.collect_layer_meta(model, {'params': params}, sample,
                                      train=False,
                                      exclude_vocabulary_size=v))
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), kfac_state=pre.init(), extra_vars={})
    init = _np(params)
    step = jtraining.build_train_step(
        model, tx, pre, _multi30k_loss(a.label_smoothing, 1))
    final = _jax_steps(step, state, batches, a.base_lr, a.damping)
    return {'init': init, 'final': final, 'batches': batches,
            'metas': [m.name for m in pre.plan.metas]}


@pytest.fixture(scope='module')
def squad_jax():
    a = train_squad.parse_args(SQUAD)
    tr = train_squad.Trainer(a)
    batches = [tr.batch(np.arange(i * 4, (i + 1) * 4))
               for i in range(STEPS)]
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
        exclude_vocabulary_size=cfg.vocab_size, **KFAC_HP)
    sample = tuple(jnp.asarray(t) for t in batches[0]['input'])
    params = _init(model, sample)
    pre.setup(jcap.collect_layer_meta(
        model, {'params': params}, sample, train=False,
        exclude_vocabulary_size=cfg.vocab_size))
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), kfac_state=pre.init(), extra_vars={})
    init = _np(params)

    def loss_fn(outputs, batch):
        s, e = outputs
        return (optax.softmax_cross_entropy_with_integer_labels(
            s, batch['label'][:, 0]).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                e, batch['label'][:, 1]).mean()) / 2.0

    step = jtraining.build_train_step(model, tx, pre, loss_fn)
    final = _jax_steps(step, state, batches, a.base_lr, a.damping)
    return {'init': init, 'final': final, 'batches': batches,
            'lrs': [float(lr_fn(i)) for i in range(STEPS)],
            'metas': [m.name for m in pre.plan.metas]}


@pytest.fixture(scope='module')
def wikitext_jax():
    a = train_wikitext.parse_args(WIKI)
    tr = train_wikitext.Trainer(a)
    batches = list(tr.batches())[:STEPS]
    model = jrnn.wikitext_lstm(tr.vocab, embed_dim=a.embed_dim,
                               hidden_dim=a.hidden_dim,
                               num_layers=a.num_layers, dropout=0.0,
                               kfac_lstm=True)
    tx = optax.chain(optax.clip_by_global_norm(a.clip),
                     optax.sgd(a.base_lr))
    pre = jkfac.KFAC(variant='eigen_dp', lr=a.base_lr, damping=a.damping,
                     num_devices=1, axis_name=None,
                     exclude_vocabulary_size=tr.vocab, **KFAC_HP)
    sample = jnp.asarray(batches[0]['input'])
    params = _init(model, sample)
    pre.setup(jcap.collect_layer_meta(model, {'params': params}, sample,
                                      train=False,
                                      exclude_vocabulary_size=tr.vocab))
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), kfac_state=pre.init(), extra_vars={})
    init = _np(params)

    def ce(outputs, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            outputs, batch['label']).mean()

    step = jtraining.build_train_step(model, tx, pre, ce)
    final = _jax_steps(step, state, batches, a.base_lr, a.damping)
    return {'init': init, 'final': final, 'batches': batches,
            'metas': [m.name for m in pre.plan.metas]}


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_multi30k_eigen_dp_steps_match_jax(multi30k_jax, capture_impl):
    argv = M30K + (['--kfac-capture-impl', capture_impl]
                   if capture_impl else [])
    tr = train_multi30k.Trainer(train_multi30k.parse_args(argv))
    assert [m.name for m in tr.precond.plan.metas] == multi30k_jax['metas']
    got = _port_steps(tr, multi30k_jax['init'], multi30k_jax['batches'])
    _assert_params_close(got, multi30k_jax['final'])
    _assert_kfac_weights_moved(multi30k_jax)


def test_squad_eigen_dp_steps_match_jax(squad_jax):
    tr = train_squad.Trainer(train_squad.parse_args(SQUAD))
    cfg = tr.state.model.config
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    # the warmup's first step (lr 0), then the linear decay
    assert [tr.lr_fn(i) for i in range(STEPS)] == squad_jax['lrs']
    assert squad_jax['lrs'][0] == 0.0 < squad_jax['lrs'][2] \
        < squad_jax['lrs'][1]
    got = _port_steps(tr, squad_jax['init'], squad_jax['batches'])
    _assert_params_close(got, squad_jax['final'])
    _assert_kfac_weights_moved(squad_jax)


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_wikitext_kfac_lstm_steps_match_jax(wikitext_jax, capture_impl):
    argv = WIKI + (['--kfac-capture-impl', capture_impl]
                   if capture_impl else [])
    tr = train_wikitext.Trainer(train_wikitext.parse_args(argv))
    assert [m.name for m in tr.precond.plan.metas] == wikitext_jax['metas']
    got = _port_steps(tr, wikitext_jax['init'], wikitext_jax['batches'])
    _assert_params_close(got, wikitext_jax['final'])
    _assert_kfac_weights_moved(wikitext_jax)


def test_schedules_equal_jax():
    steps = np.arange(0, 130, 3)
    for args in [(0.04, 100, 1.0, 10), (0.1, 60, 2.0, 0),
                 (0.5, 90, 1.0, 30)]:
        kw = dict(power=args[2], warmup_steps=args[3])
        got = tlr.polynomial_decay(*args[:2], **kw)
        want = jutils.polynomial_decay(*args[:2], **kw)
        g = np.array([got(int(s)) for s in steps], np.float32)
        np.testing.assert_array_equal(
            g, np.array([want(int(s)) for s in steps], np.float32))
        np.testing.assert_array_equal(g, np.array(
            [float(got.device(torch.tensor(int(s)))) for s in steps],
            np.float32))
    for args in [(512, 4000, 0.5), (16, 4, 1.0)]:
        got, want = tlr.inverse_sqrt(*args), jutils.inverse_sqrt(*args)
        np.testing.assert_array_equal(
            np.array([got(int(s)) for s in steps * 50], np.float32),
            np.array([want(int(s)) for s in steps * 50], np.float32))


def _random_tree(rng, shapes):
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def test_adam_chain_matches_optax():
    rng = np.random.RandomState(5)
    shapes = {'w': (7, 5), 'b': (5,)}
    params = _random_tree(rng, shapes)
    grads = [_random_tree(rng, shapes) for _ in range(3)]
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.98, eps=1e-9),
                     optax.scale_by_learning_rate(
                         jutils.inverse_sqrt(16, 4, 1.0)))
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    adam = ttraining.adam(tlr.inverse_sqrt(16, 4, 1.0), b1=0.9, b2=0.98,
                          eps=1e-9)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = adam.init(tp)
    for i, g in enumerate(grads):
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        adam.apply(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, i)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize('max_norm', [0.25, 1e3], ids=['clipped', 'kept'])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(6)
    shapes = {'w': (6, 4), 'b': (4,)}
    params = _random_tree(rng, shapes)
    g = _random_tree(rng, shapes)
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.sgd(0.5))
    jp = jax.tree.map(jnp.asarray, params)
    upd, _ = tx.update(jax.tree.map(jnp.asarray, g), tx.init(jp), jp)
    jp = optax.apply_updates(jp, upd)
    chain = ttraining.clip_by_global_norm(max_norm,
                                          ttraining.sgd(0.5, momentum=0.0))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    chain.apply(tp, {k: torch.tensor(v) for k, v in g.items()},
                chain.init(tp), 0)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-6)


def test_corpus_readers_match_jax(tmp_path):
    jm30k = _example('multi30k_transformer')
    jwiki = _example('wikitext_rnn')
    (tmp_path / 'train.de').write_text(
        'ein hund läuft\nzwei katzen schlafen heute\nein hund schläft\n')
    (tmp_path / 'train.en').write_text(
        'a dog runs\ntwo cats sleep today\na dog sleeps\n')
    got = train_multi30k.load_parallel(str(tmp_path), 'train', 5)
    want = jm30k.load_parallel(str(tmp_path), 'train', 5)
    assert got == want
    vs = [train_multi30k.build_vocab(s) for s in got]
    assert vs == [jm30k.build_vocab(s) for s in want]
    for g, w in zip(train_multi30k.encode_corpus(*got, *vs, 5),
                    jm30k.encode_corpus(*want, *vs, 5)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(train_multi30k.synthetic_translation(20, 30, 12, 3),
                    jm30k.synthetic_translation(20, 30, 12, 3)):
        np.testing.assert_array_equal(g, w)
    text = tmp_path / 'wiki.txt'
    text.write_text('the cat sat on the mat . the dog sat too .\n' * 3)
    for data, vocab in ((str(text), 5), (None, 37)):
        args = types.SimpleNamespace(data=data, vocab_limit=vocab, seed=7,
                                     synthetic_vocab=vocab,
                                     synthetic_tokens=3000)
        (gi, gv), (wi, wv) = (train_wikitext.load_corpus(args),
                              jwiki.load_corpus(args))
        np.testing.assert_array_equal(gi, wi)
        assert gv == wv
        np.testing.assert_array_equal(train_wikitext.batchify(gi, 4),
                                      jwiki.batchify(wi, 4))


def test_synthetic_squad_and_metric_match_jax():
    jsquad = _example('squad_bert')
    for g, w in zip(train_squad.synthetic_squad(12, 24, 128, 5),
                    jsquad.synthetic_squad(12, 24, 128, 5)):
        np.testing.assert_array_equal(g, w)
    toks = np.random.RandomState(8).randint(0, 9, (5, 12))
    pred = [(1, 3), (4, 4), (6, 5), (0, 11), (2, 7)]
    gold = [(1, 3), (3, 5), (6, 8), (2, 2), (7, 9)]
    assert train_squad.squad_f1_em(pred, gold, toks) == \
        jsquad.squad_f1_em(pred, gold, toks)


def _squad_file(path):
    ctx = 'the quick brown fox jumps over the lazy dog near the river bank'
    qas = [{'question': 'what jumps over the dog',
            'answers': [{'text': 'brown fox', 'answer_start': 10}]},
           {'question': 'where is the dog',
            'answers': [{'text': 'near the river bank',
                         'answer_start': ctx.index('near')}]}]
    data = {'data': [{'paragraphs': [{'context': ctx, 'qas': qas}] * 6}]}
    path.write_text(json.dumps(data))


def test_load_squad_reads_spans(tmp_path):
    path = tmp_path / 'train.json'
    _squad_file(path)
    ids, types_, mask, starts, ends = train_squad.load_squad(str(path), 24,
                                                             64)
    assert ids.shape == (12, 24)
    # [CLS] q(5 words) [SEP] ...: 'brown fox' is context words 2..3
    assert (starts[0], ends[0]) == (7 + 2, 7 + 3)
    assert ids[0, 0] == train_squad.CLS and ids[0, 6] == train_squad.SEP
    assert types_[0, :7].sum() == 0 and types_[0, 7] == 1
    assert (starts[1], ends[1]) == (6 + 9, 6 + 12)
    assert mask[0].sum() == 1 + 5 + 1 + 13 + 1
    # cut to fit: the second question's answer no longer fits in 14 tokens
    ids, *_ = train_squad.load_squad(str(path), 14, 64)
    assert len(ids) == 6


@pytest.mark.parametrize('trainer,source', [
    (t, s) for t in ('multi30k', 'squad', 'wikitext')
    for s in ('synthetic', 'file')])
def test_main_runs_an_epoch_on_cpu(tmp_path, capsys, trainer, source):
    if trainer == 'multi30k':
        mod = train_multi30k
        argv = M30K + ['--epochs', '1', '--steps-per-epoch', '2']
        if source == 'file':
            words = ' '.join(f'w{i}' for i in range(12))
            (tmp_path / 'train.de').write_text((words + '\n') * 24)
            (tmp_path / 'train.en').write_text((words + '\n') * 24)
            argv += ['--dir', str(tmp_path)]
        want = 'BLEU'
    elif trainer == 'squad':
        mod = train_squad
        argv = SQUAD + ['--epochs', '1', '--steps-per-epoch', '2']
        if source == 'file':
            _squad_file(tmp_path / 'train.json')
            argv += ['--train-file', str(tmp_path / 'train.json')]
        want = 'F1'
    else:
        mod = train_wikitext
        argv = WIKI + ['--epochs', '1', '--steps-per-epoch', '2']
        if source == 'file':
            (tmp_path / 'wiki.txt').write_text(
                'the cat sat on the mat . the dog sat too .\n' * 150)
            argv += ['--data', str(tmp_path / 'wiki.txt')]
        want = 'val_ppl'
    tr = mod.main(argv)
    assert tr.state.step == 2
    line = capsys.readouterr().out
    assert line.startswith('epoch 0:') and want in line


@pytest.mark.parametrize('trainer', ['multi30k', 'squad', 'wikitext'])
def test_speed_reports_tokens(monkeypatch, capsys, trainer):
    monkeypatch.setattr(train_imagenet, 'SPEED_WARMUP', 1)
    monkeypatch.setattr(train_imagenet, 'SPEED_ITERS', 2)
    mod, argv = {'multi30k': (train_multi30k, M30K),
                 'squad': (train_squad, SQUAD),
                 'wikitext': (train_wikitext, WIKI)}[trainer]
    tr = mod.main(argv + ['--speed'])
    assert tr.state.step == 3
    assert 'tokens/sec' in capsys.readouterr().out


@pytest.fixture(scope='module')
def world2_mains():
    """Each trainer's ``main`` at ``--num-devices 2`` on two gloo ranks
    (one spawn for both)."""
    runs = {t: (f'train_{t}', {'multi30k': M30K, 'squad': SQUAD}[t] + [
        '--steps-per-epoch', '2', '--epochs', '1', '--num-devices', '2'])
        for t in ('multi30k', 'squad')}
    ranks = launch.spawn(workers.trainer_main_runs, 2, args=(runs,),
                         timeout=300)
    return {t: [r[t] for r in ranks] for t in runs}


@pytest.mark.parametrize('trainer', ['multi30k', 'squad'])
def test_world_gt1_raises_naming_the_roadmap_item(world2_mains, trainer):
    """Once raising (the item was not ported), now the item itself:
    ``main`` at ``--num-devices 2`` on two gloo ranks trains an epoch,
    rank 0 prints, and the replicas end bitwise equal (parity against
    JAX's mesh: test_torch_seq_world.py)."""
    ranks = world2_mains[trainer]
    assert ranks[0]['digest'] == ranks[1]['digest']
    lines = ranks[0]['stdout'].splitlines()
    assert lines[0].startswith('epoch 0: ')
    assert lines[-1] == 'replicas: 2 ranks bitwise identical'
    assert ranks[1]['stdout'] == '' and ranks[0]['step'] == 2


@pytest.mark.parametrize('shard', [(0, 2), (1, 2), (2, 3)])
def test_loader_shard_matches_jax(shard):
    rng = np.random.RandomState(9)
    x = rng.randint(0, 256, (50, 4, 4, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 50).astype(np.int64)
    jl = jdata.Loader(x, y, 4, train=True, seed=11, shard=shard)
    tl = tdata.Loader(x, y, 4, train=True, seed=11, shard=shard)
    assert tl.steps_per_epoch == jl.steps_per_epoch == 50 // (4 * shard[1])
    for _ in range(2):
        jb = list(jl.epoch(prefetch_depth=0))
        tb = list(tl.epoch(prefetch_depth=0))
        assert len(tb) == len(jb) == tl.steps_per_epoch
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a['input'], b['input'])
            np.testing.assert_array_equal(a['label'], b['label'])


def test_loader_default_shard_is_the_process_group():
    assert tdata.default_shard() == (0, 1)
    x = np.zeros((10, 2, 2, 3), np.uint8)
    assert tdata.Loader(x, np.zeros(10, np.int64), 2).steps_per_epoch == 5
