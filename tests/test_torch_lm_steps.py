"""The port's second slice against the JAX package, part 2: the
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
parameter bound holds. The capture hooks only the planned layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import models as jmodels
from kfac_pytorch_tpu import training as jtraining
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import models as tmodels
from kfac_pytorch_tpu_torch import train_lm
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights

from test_torch_lm_slice import (ARCH, B, FACTOR_ATOL, FACTOR_RTOL, HP, L,
                                 LOSS_RTOL, PARAM_RTOL, VOCAB, _batches,
                                 _ce, _np_tree)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def jax_run():
    model = jmodels.transformer_lm(vocab_size=VOCAB, **ARCH)
    tx = jtraining.sgd(HP['lr'], momentum=0.9)
    pre = jkfac.KFAC(variant='eigen_dp', health=False,
                     exclude_vocabulary_size=VOCAB, **HP)
    sample = jnp.zeros((B, L), jnp.int32)
    # the init and the logits compiled whole (eager flax pays a compile
    # an op)
    state = jax.jit(lambda k: jtraining.init_train_state(
        model, tx, pre, k, sample))(jax.random.PRNGKey(0))
    init = _np_tree(state.params)
    logits = np.asarray(jax.jit(lambda p, x: model.apply(
        {'params': p}, x, train=False))(
            state.params, jnp.asarray(_batches()[0]['input'])))
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
