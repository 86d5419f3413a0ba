"""The port's sequence models against the JAX package, at the fixture
sizes of tests/test_nlp_models.py: the encoder-decoder Transformer (vocab
53/57, d 32, 2 + 2 layers, 4 heads), BERT tiny and the WikiText LSTM
(both cells), on weights converted from the JAX nets
(``weights.params_from_jax``), dropout 0 / eval mode.

- logits within 1e-5 (fp32 op order);
- the K-FAC layer metas (name, kind, dims, bias, kernel shape, order;
  the vocabulary head excluded) equal JAX's ``collect_layer_meta``;
- the K-FAC LSTM's per-timestep capture: ``a`` and ``g`` stacked ``(T,
  B, ...)`` and within 1e-5 of JAX's ``value_and_grad_with_capture``
  (``g`` relative to its largest entry), ``ih`` and ``hh`` sharing ``g``;
- one factor update from the identity (A and G of one layer of each net,
  through K2's plain version) within 1e-5 of JAX's, relative to the
  largest entry;
- greedy and beam decoding token-identical; ``bleu`` within 1e-12.

Each JAX net is built and run once per module (module-scoped fixtures).
"""

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kfac_pytorch_tpu import capture as jcap
from kfac_pytorch_tpu.models import bert as jbert
from kfac_pytorch_tpu.models import rnn as jrnn
from kfac_pytorch_tpu.models import transformer as jtr
from kfac_pytorch_tpu.models import translator as jtrans
from kfac_pytorch_tpu.ops import factors as jfactors
from kfac_pytorch_tpu_torch import capture as tcap
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import bert as tbert
from kfac_pytorch_tpu_torch.models import rnn as trnn
from kfac_pytorch_tpu_torch.models import transformer as ttr
from kfac_pytorch_tpu_torch.models import translator as ttrans
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck

torch.set_num_threads(2)

SRC_V, TRG_V, B, L = 53, 57, 2, 10
TR_ARCH = dict(d_word_vec=32, d_model=32, d_inner=64, n_layers=2, n_head=4,
               d_k=8, d_v=8, dropout=0.0)
LM_V, LM_T = 50, 8
LOGIT_TOL = 1e-5
CAPTURE_TOL = 1e-5
FACTOR_RTOL = 1e-5
ALPHA = 0.05


class Wrapped(linen.Module):
    """The JAX Multi-30k trainer's adapter: ``(src, trg)`` as one input,
    every layer under ``inner``."""
    inner: linen.Module

    @linen.compact
    def __call__(self, xs, train=True):
        return self.inner(xs[0], xs[1], train=train)


def _state_dict(params):
    with np.errstate(all='ignore'):
        return weights.params_from_jax(jax.tree.map(np.array, params))


def _meta_fields(metas):
    return [(m.name, m.kind, m.use_bias, m.in_dim, m.out_dim,
             tuple(m.kernel_shape)) for m in metas.values()]


def _ce(labels):
    def loss(out):
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(labels)).mean()
    return loss


def _port_capture(model, metas, x, loss_of):
    model.train()
    with tcap.Capture(model, list(metas.values())) as cap:
        loss_of(model(x)).backward()
    model.zero_grad(set_to_none=True)
    return cap.acts, cap.gs


def _jax_nets(jm, x, loss=None, vocab=None):
    """JAX's variables, eval-mode outputs, metas (``vocab`` excluded) and,
    given ``loss``, the captured ``(acts, gs)`` of ``jm`` on input ``x``;
    each computation compiled whole (``jax.jit``: eager flax pays a
    compile an op)."""
    v = jax.jit(lambda k: jcap.init(jm, k, x, train=False))(
        jax.random.PRNGKey(0))
    out = jax.jit(lambda v: jm.apply(v, x, train=False))(v)
    metas = jcap.collect_layer_meta(jm, v, x, train=False,
                                    exclude_vocabulary_size=vocab)
    if loss is None:
        return v, out, metas, None, None
    _, _, _, acts, gs, _ = jax.jit(
        lambda v: jcap.value_and_grad_with_capture(jm, loss, v, x,
                                                   train=False))(v)
    return v, out, metas, acts, gs


def _jax_leaf(tree, name, leaf):
    for part in name.split('/'):
        tree = tree[part]
    return np.asarray(tree[leaf])


@pytest.fixture(scope='module')
def transformer_nets():
    rng = np.random.RandomState(0)
    src = rng.randint(4, SRC_V, (B, L))
    trg = rng.randint(4, TRG_V, (B, L))
    src[0, -3:] = 1           # pad keys, masked in every attention
    trg[1, -2:] = 1
    labels = rng.randint(0, TRG_V, (B, L))
    xs = (jnp.asarray(src), jnp.asarray(trg))
    jm = Wrapped(inner=jtr.multi30k_transformer(SRC_V, TRG_V, **TR_ARCH))
    v, logits, metas, acts, gs = _jax_nets(jm, xs, _ce(labels), TRG_V)
    logits = np.asarray(logits)
    tm = ttr.Wrapped(ttr.Transformer(SRC_V, TRG_V, **TR_ARCH))
    tm.load_state_dict(_state_dict(v['params']))
    return dict(jm=jm, v=v, src=src, trg=trg, labels=labels, logits=logits,
                metas=metas, acts=acts, gs=gs, tm=tm)


@pytest.fixture(scope='module')
def bert_nets():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 100, (B, 16))
    types = np.zeros_like(ids)
    types[:, 6:] = 1
    mask = np.ones((B, 16), np.float32)
    mask[1, 12:] = 0
    labels = rng.randint(0, 16, (B, 2))
    xs = tuple(jnp.asarray(t) for t in (ids, types, mask))
    jm = jbert.bert_tiny_qa()

    def loss(out):
        return (_ce(labels[:, 0])(out[0]) + _ce(labels[:, 1])(out[1])) / 2

    v, (start, end), metas, acts, gs = _jax_nets(jm, xs, loss, 128)
    tm = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    tm.load_state_dict(_state_dict(v['params']))
    return dict(xs=(torch.as_tensor(ids), torch.as_tensor(types),
                    torch.as_tensor(mask)), labels=labels,
                logits=(np.asarray(start), np.asarray(end)), metas=metas,
                acts=acts, gs=gs, tm=tm)


def _lstm_nets(kfac_lstm):
    rng = np.random.RandomState(2)
    toks = rng.randint(0, LM_V, (B + 2, LM_T))
    labels = np.roll(toks, -1, 1)
    arch = dict(embed_dim=16, hidden_dim=16, num_layers=2, dropout=0.0,
                kfac_lstm=kfac_lstm)
    jm = jrnn.wikitext_lstm(LM_V, **arch)
    v, logits, metas, acts, gs = _jax_nets(
        jm, jnp.asarray(toks), _ce(labels) if kfac_lstm else None, LM_V)
    out = dict(toks=toks, labels=labels, kfac_lstm=kfac_lstm,
               logits=np.asarray(logits), metas=metas, acts=acts, gs=gs)
    tm = trnn.LSTMLanguageModel(LM_V, **arch)
    tm.load_state_dict(_state_dict(v['params']))
    out['tm'] = tm
    return out


@pytest.fixture(scope='module')
def lstm_fused():
    return _lstm_nets(False)


@pytest.fixture(scope='module')
def lstm_kfac():
    return _lstm_nets(True)


@pytest.fixture(params=['fused_cell', 'kfac_cell'])
def lstm_nets(request):
    return request.getfixturevalue(
        {'fused_cell': 'lstm_fused', 'kfac_cell': 'lstm_kfac'}[
            request.param])


def test_transformer_logits_match_jax(transformer_nets):
    n = transformer_nets
    model = n['tm'].eval()
    with torch.no_grad():
        got = model((torch.as_tensor(n['src']), torch.as_tensor(n['trg'])))
    np.testing.assert_allclose(got.numpy(), n['logits'], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_bert_logits_match_jax(bert_nets):
    model = bert_nets['tm'].eval()
    with torch.no_grad():
        got = model(bert_nets['xs'])
    for g, want in zip(got, bert_nets['logits']):
        np.testing.assert_allclose(g.numpy(), want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_lstm_logits_match_jax(lstm_nets):
    model = lstm_nets['tm'].eval()
    with torch.no_grad():
        got = model(torch.as_tensor(lstm_nets['toks']))
    np.testing.assert_allclose(got.numpy(), lstm_nets['logits'],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_layer_metas_match_jax(transformer_nets, bert_nets, lstm_nets):
    tr = transformer_nets
    got = tcap.collect_layer_meta(
        tr['tm'], (torch.as_tensor(tr['src']), torch.as_tensor(tr['trg'])),
        exclude_vocabulary_size=TRG_V)
    assert _meta_fields(got) == _meta_fields(tr['metas'])
    # 2 encoder layers x 6, 2 decoder layers x 10, the tied head none
    assert len(got) == 32 and all(k.startswith('inner/') for k in got)
    with pytest.warns(UserWarning, match='intermediate'):
        got = tcap.collect_layer_meta(bert_nets['tm'], bert_nets['xs'],
                                      exclude_vocabulary_size=128)
    assert _meta_fields(got) == _meta_fields(bert_nets['metas'])
    assert list(got)[-1] == 'qa_outputs'
    got = tcap.collect_layer_meta(lstm_nets['tm'],
                                  torch.as_tensor(lstm_nets['toks']),
                                  exclude_vocabulary_size=LM_V)
    assert _meta_fields(got) == _meta_fields(lstm_nets['metas'])
    want = (['lstm_scan_0/ih', 'lstm_scan_0/hh', 'lstm_scan_1/ih',
             'lstm_scan_1/hh'] if lstm_nets['kfac_lstm'] else [])
    assert list(got) == want      # the decoder excluded


def test_untied_transformer_head_is_excluded_as_jax():
    rng = np.random.RandomState(3)
    src, trg = rng.randint(4, SRC_V, (B, L)), rng.randint(4, TRG_V, (B, L))
    tm = ttr.Wrapped(ttr.Transformer(SRC_V, TRG_V, **TR_ARCH,
                                     trg_emb_prj_weight_sharing=False))
    xs = (torch.as_tensor(src), torch.as_tensor(trg))
    every = tcap.collect_layer_meta(tm, xs)
    kept = tcap.collect_layer_meta(tm, xs, exclude_vocabulary_size=TRG_V)
    assert list(every)[-1] == 'inner/trg_proj'
    assert list(kept) == list(every)[:-1]


def test_kfac_lstm_capture_is_stacked_per_timestep_as_jax(lstm_kfac):
    n = lstm_kfac
    metas = tcap.collect_layer_meta(n['tm'], torch.as_tensor(n['toks']),
                                    exclude_vocabulary_size=LM_V)
    labels = torch.as_tensor(n['labels'])
    acts, gs = _port_capture(
        n['tm'], metas, torch.as_tensor(n['toks']),
        lambda o: torch.nn.functional.cross_entropy(
            o.reshape(-1, LM_V), labels.reshape(-1)))
    for name in metas:
        a, g = acts[name].numpy(), gs[name].numpy()
        ja = _jax_leaf(n['acts'], name, 'a')
        jg = _jax_leaf(n['gs'], name, 'g')
        assert a.shape == ja.shape == (LM_T, B + 2, 16)
        assert g.shape == jg.shape == (LM_T, B + 2, 64)
        np.testing.assert_allclose(a, ja, atol=CAPTURE_TOL, rtol=0)
        assert np.abs(g - jg).max() <= CAPTURE_TOL * np.abs(jg).max()
    for layer in ('lstm_scan_0', 'lstm_scan_1'):
        np.testing.assert_array_equal(gs[layer + '/ih'].numpy(),
                                      gs[layer + '/hh'].numpy())
        # the first step's recurrent input is the zero carry
        assert not acts[layer + '/hh'][0].any()


def test_single_call_layers_capture_as_before(transformer_nets):
    """A layer called once keeps its captured tensors as they are: the
    Transformer's ``[B, L, d]`` rows, the layer's own input object."""
    tm = transformer_nets['tm']
    metas = tcap.collect_layer_meta(
        tm, (torch.as_tensor(transformer_nets['src']),
             torch.as_tensor(transformer_nets['trg'])))
    seen = {}
    mod = tm.inner.enc_0.ffn.w_1
    h = mod.register_forward_hook(lambda m, i, o: seen.update(x=i[0]))
    try:
        acts, gs = _port_capture(
            tm, metas, (torch.as_tensor(transformer_nets['src']),
                        torch.as_tensor(transformer_nets['trg'])),
            lambda o: o.square().mean())
    finally:
        h.remove()
    a = acts['inner/enc_0/ffn/w_1']
    assert a.shape == (B, L, 32) and a.data_ptr() == seen['x'].data_ptr()
    assert gs['inner/enc_0/ffn/w_1'].shape == (B, L, 64)


def _factor_pair(name, acts, gs, jacts, jgs, metas):
    meta = metas[name]
    eye_a = torch.eye(meta.in_dim)
    eye_g = torch.eye(meta.out_dim)
    got_a = ck.compute_a_dense(acts[name].contiguous(), meta.use_bias,
                               ema=(eye_a, ALPHA))
    got_g = ck.compute_g_dense(gs[name].contiguous(), True,
                               ema=(eye_g, ALPHA))
    ja = jfactors.update_running_avg(
        jfactors.compute_a_dense(jnp.asarray(_jax_leaf(jacts, name, 'a')),
                                 meta.use_bias),
        jnp.eye(meta.in_dim), ALPHA)
    jg = jfactors.update_running_avg(
        jfactors.compute_g_dense(jnp.asarray(_jax_leaf(jgs, name, 'g'))),
        jnp.eye(meta.out_dim), ALPHA)
    for got, want in ((got_a, ja), (got_g, jg)):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= FACTOR_RTOL * np.abs(want).max(), (name, err)


@pytest.mark.parametrize('net', ['transformer', 'bert', 'lstm'])
def test_one_factor_update_matches_jax(net, transformer_nets, bert_nets,
                                       lstm_kfac):
    if net == 'transformer':
        n = transformer_nets
        xs = (torch.as_tensor(n['src']), torch.as_tensor(n['trg']))
        labels = torch.as_tensor(n['labels'])
        model, name = n['tm'], 'inner/dec_1/ffn/w_1'

        def loss_of(o):
            return torch.nn.functional.cross_entropy(
                o.reshape(-1, TRG_V), labels.reshape(-1))
    elif net == 'bert':
        n = bert_nets
        xs = n['xs']
        labels = torch.as_tensor(n['labels'])
        model, name = n['tm'], 'bert/layer_1/attention/query'

        def loss_of(o):
            return (torch.nn.functional.cross_entropy(o[0], labels[:, 0])
                    + torch.nn.functional.cross_entropy(o[1],
                                                        labels[:, 1])) / 2
    else:
        n = lstm_kfac
        xs = torch.as_tensor(n['toks'])
        labels = torch.as_tensor(n['labels'])
        model, name = n['tm'], 'lstm_scan_1/ih'

        def loss_of(o):
            return torch.nn.functional.cross_entropy(o.reshape(-1, LM_V),
                                                     labels.reshape(-1))
    metas = tcap.collect_layer_meta(model, xs)
    acts, gs = _port_capture(model, metas, xs, loss_of)
    _factor_pair(name, acts, gs, n['acts'], n['gs'], metas)


def test_greedy_and_beam_decode_match_jax(transformer_nets):
    n = transformer_nets
    inner_v = {'params': n['v']['params']['inner']}
    model = n['jm'].inner
    src = jnp.asarray(n['src'])
    want = np.asarray(jtrans.greedy_decode(model, inner_v, src, bos_idx=2,
                                           eos_idx=3, max_len=8))
    net = n['tm'].inner
    got = ttrans.greedy_decode(net, torch.as_tensor(n['src']), 2, 3,
                               max_len=8)
    np.testing.assert_array_equal(got.numpy(), want)
    # beam search is per sentence (the JAX decoder compiles its step at
    # each call): the padded one
    want = jtrans.beam_search_decode(model, inner_v, src[0], bos_idx=2,
                                     eos_idx=3, beam_size=3, max_len=8)
    got = ttrans.beam_search_decode(net, torch.as_tensor(n['src'][0]), 2, 3,
                                    beam_size=3, max_len=8)
    assert got == want and all(isinstance(t, int) for t in got)


def test_bleu_matches_jax():
    rng = np.random.RandomState(4)
    hyps = [rng.randint(0, 6, rng.randint(3, 12)).tolist()
            for _ in range(20)]
    refs = [rng.randint(0, 6, rng.randint(3, 12)).tolist()
            for _ in range(20)]
    for h, r in ((hyps, refs), (refs, refs), ([[9, 9, 9]], [[1, 2, 3]]),
                 ([[1, 2, 3, 4, 5, 9]], [[1, 2, 3, 4, 5]])):
        assert abs(ttrans.bleu(h, r) - jtrans.bleu(h, r)) <= 1e-12
    assert abs(ttrans.bleu(refs, refs) - 100.0) < 1e-9
