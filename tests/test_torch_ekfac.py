"""The port's E-KFAC variants ('ekfac', 'ekfac_dp') against the JAX
package's, on the same seeded numpy inputs.

- ``ops.layer_rows_dense``/``layer_rows_conv``/``ekfac_scales`` equal
  JAX's (dense with a sequence axis, conv 3x3 SAME and stride-2 VALID, with
  and without bias, fp32 and bf16 captures) within rtol 1e-5 and 1e-6 of
  the largest entry;
- the moments equal the explicit per-example and per-patch oracles of
  ``tests/test_ekfac.py`` (rtol 2e-4);
- ``engine.update_ekfac_scales(_local)``, ``rotate_ekfac_scales(_local)``
  and the E-KFAC ``compute_pred_*`` equal JAX's engine on the same plan
  and the same decomposition (the port's, handed to JAX): 1e-5 of the
  largest entry;
- ``KFAC('ekfac')``/``KFAC('ekfac_dp')``: three steps at world=1 on a
  conv+dense net whose factors have more rows than dims (so the
  eigenbases are not degenerate), fed JAX's captures, give JAX's
  preconditioned gradients and moments within rtol 1e-4 (of each
  tensor's largest entry);
- all-zero moments reproduce 'eigen' bit for bit, a state without
  moments steps, sign flips leave the transport exact, 'ekfac_dp' at
  world=1 equals 'ekfac', a NaN batch under the guard leaves the moments
  bitwise as they were, and ``stagger``/``comm_prefetch`` raise JAX's
  errors.

The world=2 cases are in ``tests/test_torch_distributed.py``.
"""

import dataclasses

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import engine as jengine
from kfac_pytorch_tpu import nn as jnn
from kfac_pytorch_tpu import ops as jops
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import engine as tengine
from kfac_pytorch_tpu_torch import ops as tops
from kfac_pytorch_tpu_torch import training, weights

import torch_dist_workers as workers

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore:ekfac variants')

N, HW, CIN = 16, 6, 2


def _rel_close(got, want, rtol, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f'{what}: {err:.3g} > {rtol}'


# ---------------------------------------------------------------------------
# ops: the rows and the moments
# ---------------------------------------------------------------------------

ROW_CASES = {
    'dense': dict(kind='dense', a=(N, 7), g=(N, 5), bias=True),
    'dense_seq': dict(kind='dense', a=(N, 3, 7), g=(N, 3, 5), bias=False),
    'conv_same': dict(kind='conv', a=(N, HW, HW, CIN), g=(N, HW, HW, 4),
                      k=(3, 3), s=(1, 1), pad=((1, 1), (1, 1)), bias=True),
    'conv_s2_valid': dict(kind='conv', a=(N, 7, 7, CIN), g=(N, 3, 3, 4),
                          k=(3, 3), s=(2, 2), pad=((0, 0), (0, 0)),
                          bias=False),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', list(ROW_CASES))
def test_rows_and_scales_match_jax(case, dtype):
    c = ROW_CASES[case]
    rng = np.random.RandomState(3)
    a = rng.randn(*c['a']).astype(np.float32)
    g = rng.randn(*c['g']).astype(np.float32)
    ta, tg = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, g))
    ja, jg = (jnp.asarray(x, getattr(jnp, dtype)) for x in (a, g))
    if c['kind'] == 'dense':
        trows = tops.layer_rows_dense(ta, tg, c['bias'])
        jrows = jops.layer_rows_dense(ja, jg, c['bias'])
    else:
        args = (c['k'], c['s'], c['pad'], c['bias'])
        trows = tops.layer_rows_conv(ta, tg, *args)
        jrows = jops.layer_rows_conv(ja, jg, *args)
    assert trows[2] == jrows[2]
    for t, j, side in zip(trows[:2], jrows[:2], 'ag'):
        assert t.dtype == torch.float32 and t.shape == j.shape, side
        _rel_close(t.numpy(), j, 1e-6, side)
    da, dg = trows[0].shape[1], trows[1].shape[1]
    qa = np.linalg.qr(rng.randn(da, da))[0].astype(np.float32)
    qg = np.linalg.qr(rng.randn(dg, dg))[0].astype(np.float32)
    got = tops.ekfac_scales(trows[0], trows[1], torch.from_numpy(qa),
                            torch.from_numpy(qg), trows[2]).numpy()
    want = np.asarray(jops.ekfac_scales(jrows[0], jrows[1], jnp.asarray(qa),
                                        jnp.asarray(qg), jrows[2]))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# a conv + dense net, run through JAX's capture for both packages
# ---------------------------------------------------------------------------

class JNet(linen.Module):
    """conv 3x3 SAME (A 19, G 4; 576 rows) -> relu -> conv 3x3 stride 2
    VALID (A 37, G 4; 64 rows) -> spatial mean -> dense (A 5, G 3; 16
    rows): every factor has more rows than dims."""

    @linen.compact
    def __call__(self, x, train=True):
        x = linen.relu(jnn.Conv(4, (3, 3), padding='SAME', name='c1')(x))
        x = jnn.Conv(4, (3, 3), strides=(2, 2), padding='VALID',
                     name='c2')(x)
        return jnn.Dense(3, name='fc')(x.mean(axis=(1, 2)))


class JDense(linen.Module):
    @linen.compact
    def __call__(self, x, train=True):
        return jnn.Dense(5, name='fc')(x)


def _batch(seed, shape=(N, HW, HW, CIN), classes=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, classes, shape[0]))


_CAPTURE = {}


def _captured(model, variables, x, y):
    """JAX's grads and captures of one batch, and the same as the port's
    inputs (grads by torch parameter name, captures by layer name)."""
    if model not in _CAPTURE:
        def run(variables, x, y):
            def loss(out):
                return optax.softmax_cross_entropy_with_integer_labels(
                    out, y).mean()
            return jcapture.value_and_grad_with_capture(model, loss,
                                                        variables, x)[2:5]
        _CAPTURE[model] = jax.jit(run)
    grads, acts, gs = _CAPTURE[model](variables, jnp.asarray(x),
                                      jnp.asarray(y))
    metas = jcapture.collect_layer_meta(model, variables, jnp.asarray(x))
    tgrads = weights.params_from_jax(jax.tree.map(np.asarray, grads))
    tacts = {m.name: torch.from_numpy(np.array(jcapture.layer_act(acts, m)))
             for m in metas.values()}
    tgs = {m.name: torch.from_numpy(np.array(jcapture.layer_g(gs, m)))
           for m in metas.values()}
    return (grads, acts, gs), (tgrads, tacts, tgs), metas


def _port_metas(jmetas):
    return {k: tcapture.LayerMeta(**dataclasses.asdict(m))
            for k, m in jmetas.items()}


def _pair(variant, model, x, **kw):
    kw = dict(dict(lr=0.1, damping=0.01, fac_update_freq=1,
                   kfac_update_freq=1), **kw)
    variables = jcapture.init(model, jax.random.PRNGKey(0), jnp.asarray(x))
    metas = jcapture.collect_layer_meta(model, variables, jnp.asarray(x))
    jpre = jkfac.KFAC(variant=variant, **kw)
    jpre.setup(metas)
    tpre = tkfac.KFAC(variant=variant, **kw)
    tpre.setup(_port_metas(metas))
    return jpre, tpre, variables


def _grads_np(tgrads):
    return {k: v.detach().numpy() for k, v in tgrads.items()}


def _jgrads_np(jgrads):
    return {k: v.numpy() for k, v in weights.params_from_jax(
        jax.tree.map(np.asarray, jgrads)).items()}


# ---------------------------------------------------------------------------
# the oracles of tests/test_ekfac.py
# ---------------------------------------------------------------------------

def test_dense_scales_match_per_example_oracle():
    x, y = _batch(0, (N, 8), 5)
    model = JDense()
    _, tpre, variables = _pair('ekfac', model, x, factor_decay=1.0,
                               bucket_fn=lambda d: d)
    _, (tg, ta, tgs), metas = _captured(model, variables, x, y)
    _, state = tpre.step(tpre.init('cpu'), tg, ta, tgs)
    pg = tpre.plan.pred_groups[0]
    qa = state.decomp['evecs'][str(pg.da)][int(pg.row_a[0])].numpy()
    qg = state.decomp['evecs'][str(pg.dg)][int(pg.row_g[0])].numpy()
    a_rows = np.concatenate([x, np.ones((N, 1), np.float32)], axis=1)
    g_tilde = tgs['fc'].numpy()
    want = np.zeros((pg.dg, pg.da))
    for b in range(N):
        want += (qg.T @ np.outer(N * g_tilde[b], a_rows[b]) @ qa) ** 2
    np.testing.assert_allclose(state.decomp['scales']['g0'][0].numpy(),
                               want / N, rtol=2e-4, atol=1e-6)


def test_conv_scales_match_per_patch_oracle():
    rng = np.random.RandomState(21)
    x = rng.randn(6, 8, 8, 3).astype(np.float32)
    y = rng.randn(6, 8, 8, 4).astype(np.float32)

    class OneConv(linen.Module):
        @linen.compact
        def __call__(self, x, train=True):
            return jnn.Conv(4, (3, 3), padding='SAME', name='c')(x)

    model = OneConv()
    variables = jcapture.init(model, jax.random.PRNGKey(0), jnp.asarray(x))
    metas = jcapture.collect_layer_meta(model, variables, jnp.asarray(x))
    _, _, grads, acts, gs, _ = jcapture.value_and_grad_with_capture(
        model, lambda out: ((out - y) ** 2).mean(), variables,
        jnp.asarray(x))
    meta = next(iter(metas.values()))
    tpre = tkfac.KFAC(variant='ekfac', lr=0.1, damping=0.01,
                      factor_decay=1.0, bucket_fn=lambda d: d)
    tpre.setup(_port_metas(metas))
    ta = {meta.name: torch.from_numpy(np.array(jcapture.layer_act(acts,
                                                                  meta)))}
    tgs = {meta.name: torch.from_numpy(np.array(jcapture.layer_g(gs, meta)))}
    tg = weights.params_from_jax(jax.tree.map(np.asarray, grads))
    _, state = tpre.step(tpre.init('cpu'), tg, ta, tgs)
    pg = tpre.plan.pred_groups[0]
    qa = state.decomp['evecs'][str(pg.da)][int(pg.row_a[0])].numpy()
    qg = state.decomp['evecs'][str(pg.dg)][int(pg.row_g[0])].numpy()
    patches = np.asarray(jops.extract_patches(
        jcapture.layer_act(acts, meta), meta.kernel_size, meta.strides,
        meta.padding))
    spatial = patches.shape[1] * patches.shape[2]
    arows = patches.reshape(-1, patches.shape[-1])
    arows = np.concatenate([arows, np.ones((len(arows), 1), np.float32)],
                           axis=1) / spatial
    grows = tgs[meta.name].numpy().reshape(-1, 4) * 6 * spatial
    want = ((grows @ qg) ** 2).T.astype(np.float64) @ ((arows @ qa) ** 2)
    np.testing.assert_allclose(state.decomp['scales']['g0'][0].numpy(),
                               want / 6, rtol=2e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# engine: the port's decomposition handed to JAX
# ---------------------------------------------------------------------------

def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _j_tree(tree):
    if isinstance(tree, dict):
        return {k: _j_tree(v) for k, v in tree.items()}
    return jnp.asarray(np.array(tree))


@pytest.mark.parametrize('comm_mode', ['inverse', 'pred'])
def test_engine_scales_rotations_and_pred_match_jax(comm_mode):
    x, y = _batch(1)
    model = JNet()
    variant = 'ekfac' if comm_mode == 'inverse' else 'ekfac_dp'
    jpre, tpre, variables = _pair(variant, model, x)
    (jg, ja, jgs), (tg, ta, tgs), _ = _captured(model, variables, x, y)
    # two bases: the port's decomposition of two steps' factors
    _, s0 = tpre.step(tpre.init('cpu'), tg, ta, tgs)
    x1, y1 = _batch(2)
    _, (tg1, ta1, tgs1), _ = _captured(model, variables, x1, y1)
    _, s1 = tpre.step(s0, tg1, ta1, tgs1)
    d0, d1 = _np_tree(s0.decomp), _np_tree(s1.decomp)
    tplan, jplan = tpre.plan, jpre.plan
    if comm_mode == 'inverse':
        got = tengine.update_ekfac_scales(
            tplan, s1.decomp, ta, tgs, True, s0.decomp['scales'], 0.95,
            'pmean', None)
        want = jax.jit(lambda d, a, g, s: jengine.update_ekfac_scales(
            jplan, d, a, g, True, s, 0.95, 'pmean', None))(
                _j_tree(d1), ja, jgs, _j_tree(d0['scales']))
        rot = tengine.rotate_ekfac_scales(tplan, s1.decomp['scales'],
                                          s0.decomp, s1.decomp)
        jrot = jax.jit(lambda s, a, b: jengine.rotate_ekfac_scales(
            jplan, s, a, b))(_j_tree(d1['scales']), _j_tree(d0),
                             _j_tree(d1))
    else:
        got = tengine.update_ekfac_scales_local(
            tplan, s1.decomp, ta, tgs, True, s0.decomp['scales'], 0.95,
            None)
        want = jax.jit(lambda d, a, g, s: jengine.update_ekfac_scales_local(
            jplan, d, a, g, True, s, 0.95, None))(
                _j_tree(d1), ja, jgs, _j_tree(d0['scales']))
        rot = tengine.rotate_ekfac_scales_local(
            tplan, s1.decomp['scales'], s0.decomp['evecs'],
            s1.decomp['evecs'], None)
        jrot = jax.jit(lambda s, a, b: jengine.rotate_ekfac_scales_local(
            jplan, s, a, b, None))(_j_tree(d1['scales']),
                                   _j_tree(d0['evecs']), _j_tree(d1['evecs']))
    for k in want:
        _rel_close(got[k].numpy(), want[k], 1e-5, f'update {k}')
        _rel_close(rot[k].numpy(), jrot[k], 1e-5, f'rotate {k}')
    # the pred path with the moments in its denominators
    metas = tplan.metas
    gm = [tengine.layer_grad_matrix(m, tg) for m in metas]
    jgm = [jengine.layer_grad_matrix(m, jg) for m in jplan.metas]
    damp = 0.01
    if comm_mode == 'inverse':
        preds = tengine.compute_pred_replicated(
            tplan, s1.decomp, gm, torch.tensor(damp), 'eigh', scales=got)
        jpreds = jax.jit(lambda d, m, w: jengine.compute_pred_replicated(
            jplan, d, m, jnp.float32(damp), 'eigh', scales=w))(
                _j_tree(d1), jgm, want)
    else:
        preds = tengine.compute_pred_local(
            tplan, s1.decomp, gm, torch.tensor(damp), 'eigh', None,
            scales=got)
        jpreds = jax.jit(lambda d, m, w: jengine.compute_pred_local(
            jplan, d, m, jnp.float32(damp), 'eigh', None, scales=w))(
                _j_tree(d1), jgm, want)
    for m, p, jp in zip(metas, preds, jpreds):
        _rel_close(p.numpy(), jp, 1e-5, f'pred {m.name}')


def test_pred_eigh_zero_scales_fall_back_per_member():
    rng = np.random.RandomState(4)
    q = torch.from_numpy(np.linalg.qr(rng.randn(2, 5, 5))[0]
                         .astype(np.float32))
    d = torch.from_numpy(rng.rand(2, 5).astype(np.float32))
    gm = torch.from_numpy(rng.randn(2, 5, 5).astype(np.float32))
    s = torch.from_numpy(rng.rand(2, 5, 5).astype(np.float32))
    s[1] = 0.0                      # member 1 has no moments yet
    got = tengine._pred_eigh(q, d, q, d, gm, 0.01, s)
    plain = tengine._pred_eigh(q, d, q, d, gm, 0.01)
    want = jengine._pred_eigh(*(jnp.asarray(t.numpy())
                                for t in (q, d, q, d, gm)), 0.01,
                              jnp.asarray(s.numpy()))
    torch.testing.assert_close(got[1], plain[1], rtol=0, atol=0)
    assert not torch.equal(got[0], plain[0])
    _rel_close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------------------
# KFAC: three steps against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', ['ekfac', 'ekfac_dp'])
def test_kfac_three_steps_match_jax(variant):
    x0, _ = _batch(10)
    model = JNet()
    jpre, tpre, variables = _pair(variant, model, x0, bucket_fn=lambda d: d)
    jstate, tstate = jpre.init(), tpre.init('cpu')
    jstep = jax.jit(jpre.step)
    for i in range(3):
        x, y = _batch(10 + i)
        (jg, ja, jgs), (tg, ta, tgs), _ = _captured(model, variables, x, y)
        jout, jstate = jstep(jstate, jg, ja, jgs)
        tout, tstate = tpre.step(tstate, tg, ta, tgs)
        want = _jgrads_np(jout)
        for k, v in _grads_np(tout).items():
            _rel_close(v, want[k], 1e-4, f'step {i} grad {k}')
        for k, v in tstate.decomp['scales'].items():
            assert np.any(v.numpy() != 0)
            _rel_close(v.numpy(), jstate.decomp['scales'][k], 1e-4,
                       f'step {i} scales {k}')


def test_zero_scales_reproduce_eigen_exactly():
    x, y = _batch(7)
    model = JNet()
    _, tpre_e, variables = _pair('eigen', model, x)
    _, (tg, ta, tgs), metas = _captured(model, variables, x, y)
    want, state_e = tpre_e.step(tpre_e.init('cpu'), tg, ta, tgs)
    tpre_k = tkfac.KFAC(variant='ekfac', lr=0.1, damping=0.01)
    tpre_k.setup(_port_metas(metas))
    st = tpre_k.init('cpu')
    st = dataclasses.replace(
        st, factors=state_e.factors,
        decomp={**state_e.decomp, 'scales': st.decomp['scales']})
    got, _ = tpre_k.step(st, tg, update_factors=False, update_inverse=False)
    want2, _ = tpre_e.step(state_e, tg, update_factors=False,
                           update_inverse=False)
    for k in want2:
        torch.testing.assert_close(got[k], want2[k], rtol=0, atol=0)


@pytest.mark.parametrize('variant', ['ekfac', 'ekfac_dp'])
def test_state_without_scales_steps(variant):
    x, y = _batch(15)
    model = JNet()
    _, tpre_e, variables = _pair(variant.replace('ekfac', 'eigen'), model, x)
    _, (tg, ta, tgs), metas = _captured(model, variables, x, y)
    _, state_e = tpre_e.step(tpre_e.init('cpu'), tg, ta, tgs)
    assert 'scales' not in state_e.decomp
    tpre = tkfac.KFAC(variant=variant)
    tpre.setup(_port_metas(metas))
    new_grads, new_state = tpre.step(state_e, tg, ta, tgs)
    assert all(torch.isfinite(v).all() for v in new_grads.values())
    want = {k: v.shape for k, v in tpre.init('cpu').decomp['scales'].items()}
    assert {k: v.shape for k, v in new_state.decomp['scales'].items()} == \
        want
    assert all(torch.any(v != 0) for v in new_state.decomp['scales'].values())


def test_rotation_exact_under_sign_flips():
    x, y = _batch(9)
    model = JNet()
    _, tpre, variables = _pair('ekfac', model, x)
    _, (tg, ta, tgs), _ = _captured(model, variables, x, y)
    _, state = tpre.step(tpre.init('cpu'), tg, ta, tgs)
    flipped = {'evals': state.decomp['evals'],
               'evecs': {k: -q for k, q in state.decomp['evecs'].items()}}
    out = tengine.rotate_ekfac_scales(tpre.plan, state.decomp['scales'],
                                      state.decomp, flipped)
    for k, v in out.items():
        torch.testing.assert_close(v, state.decomp['scales'][k], rtol=1e-5,
                                   atol=1e-7)
    local = tengine.rotate_ekfac_scales_local(
        tpre.plan, state.decomp['scales'], state.decomp['evecs'],
        flipped['evecs'], None) if tpre.comm_mode == 'pred' else out
    for k, v in local.items():
        torch.testing.assert_close(v, state.decomp['scales'][k], rtol=1e-5,
                                   atol=1e-7)


def test_ekfac_dp_at_world1_equals_ekfac():
    model = JNet()
    x0, _ = _batch(17)
    _, tpre_r, variables = _pair('ekfac', model, x0)
    _, tpre_d, _ = _pair('ekfac_dp', model, x0)
    sr, sd = tpre_r.init('cpu'), tpre_d.init('cpu')
    for i in range(2):
        x, y = _batch(17 + i)
        _, (tg, ta, tgs), _ = _captured(model, variables, x, y)
        gr, sr = tpre_r.step(sr, tg, ta, tgs)
        gd, sd = tpre_d.step(sd, tg, ta, tgs)
        for k in gr:
            torch.testing.assert_close(gd[k], gr[k], rtol=0, atol=0)
        for k in sr.decomp['scales']:
            torch.testing.assert_close(sd.decomp['scales'][k],
                                       sr.decomp['scales'][k], rtol=0,
                                       atol=0)


# ---------------------------------------------------------------------------
# the trainer's guard, and the constructor's exclusions
# ---------------------------------------------------------------------------

def _tiny_trainer(variant='ekfac_dp'):
    model = workers.TinyCNN()
    pre = tkfac.KFAC(variant=variant, lr=0.1, damping=0.01,
                     bucket_fn=workers.bucket_tiny)
    tx = training.sgd(0.1, momentum=0.9)
    state = training.init_train_state(model, tx, pre,
                                      np.zeros((8, 7, 7, 3), np.float32),
                                      device='cpu')
    step = training.build_train_step(
        model, tx, pre, lambda out, b: ((out - b['label']) ** 2).mean())
    return pre, state, step


def _tiny_batch(seed, bad=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 7, 7, 3).astype(np.float32)
    if bad:
        x[:] = np.nan
    return {'input': torch.from_numpy(x),
            'label': torch.from_numpy(rng.randn(8, 10).astype(np.float32))}


@pytest.mark.parametrize('without_scales', [False, True])
def test_nan_batch_leaves_scales_bitwise(without_scales):
    pre, state, step = _tiny_trainer()
    for i in range(3):
        state, _ = step(state, _tiny_batch(i))
    before = {k: v.clone() for k, v in state.kfac_state.decomp['scales']
              .items()}
    assert all(torch.any(v != 0) for v in before.values())
    if without_scales:
        # a state from before E-KFAC: the skip keeps the zeros the step
        # would start it from
        state = dataclasses.replace(state, kfac_state=dataclasses.replace(
            state.kfac_state, decomp={k: v for k, v in
                                      state.kfac_state.decomp.items()
                                      if k != 'scales'}))
        before = {k: torch.zeros_like(v) for k, v in before.items()}
    state, m = step(state, _tiny_batch(9, bad=True))
    assert not bool(m['health/ok'])
    for k, v in before.items():
        assert torch.equal(state.kfac_state.decomp['scales'][k], v), k
    state, m = step(state, _tiny_batch(10))
    assert bool(m['health/ok'])
    assert all(torch.isfinite(v).all()
               for v in state.kfac_state.decomp['scales'].values())


def _raised(ctor, kw):
    try:
        ctor(**kw)
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize('kw', [
    dict(variant='ekfac', stagger=True),
    dict(variant='ekfac_dp', stagger=True),
    dict(variant='ekfac', comm_prefetch=True),
    dict(variant='ekfac_dp', comm_prefetch=True),
    dict(variant='eigen_dp', comm_prefetch=True)],
    ids=lambda kw: '-'.join(f'{k}={v}' for k, v in kw.items()))
def test_exclusions_raise_as_jax(kw):
    got = _raised(tkfac.KFAC, kw)
    want = _raised(jkfac.KFAC, kw)
    assert want is not None and got == want


def test_comm_prefetch_without_ekfac_is_not_ported():
    # comm_prefetch is ported: without E-KFAC it builds and keeps the flag
    pre = tkfac.KFAC(variant='eigen', comm_prefetch=True)
    assert pre.comm_prefetch and not pre.ekfac


def test_damping_warning_once(monkeypatch):
    from kfac_pytorch_tpu_torch import preconditioner as tprec
    monkeypatch.setattr(tprec, '_EKFAC_DAMPING_WARNED', False)
    with pytest.warns(UserWarning, match='ekfac variants'):
        tkfac.KFAC(variant='ekfac_dp')
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tkfac.KFAC(variant='ekfac')


def test_checkpoint_restores_the_moments(tmp_path):
    from kfac_pytorch_tpu_torch.utils import checkpoint
    pre, state, step = _tiny_trainer()
    for i in range(3):
        state, _ = step(state, _tiny_batch(i))
    checkpoint.save_checkpoint(tmp_path, 0, state)
    _, fresh, _ = _tiny_trainer()
    restored = checkpoint.restore_checkpoint(tmp_path, 0, fresh)
    assert restored.decomposed
    for k, v in state.kfac_state.decomp['scales'].items():
        assert torch.any(v != 0)
        assert torch.equal(restored.kfac_state.decomp['scales'][k], v)
