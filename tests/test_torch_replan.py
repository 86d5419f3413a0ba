"""``KFAC.replan`` at world=1 (the cases of ``tests/test_replan.py``) and
its transport, ``plan.same_row_layout`` and
``utils.checkpoint.reshard_kfac_state``, against the JAX package's on the
same layers.

- a replan to the identical plan returns the state object itself, fires
  no invalidator, and the run goes on bit for bit as a control's;
- the two comm modes are one algorithm at world=1: bit-identical runs;
- a pure comm-mode round trip (eigen, bf16 wire: the residual too) is
  carried verbatim; a variant round trip keeps the factor EMAs and the
  step exactly; E-KFAC moments restart at zero when not carried;
- after a cross-method replan the trainer passes gradients through
  (``TrainState.decomposed`` false) until the next inverse update
  rebuilds the decomposition; a queued ``request_replan`` is applied at
  the top of the next step;
- ``bucket_overrides`` under stagger rebuild the cohorts with the
  stretched period;
- the validation errors are JAX's (type and message), a host replan to
  another world equals JAX's reshard, and the not-ported moves raise
  NotImplementedError naming their ROADMAP item;
- ``same_row_layout`` and ``reshard_kfac_state`` (with and without
  ``carry_decomp``) equal JAX's at 1 -> 1, 2 -> 1 and 1 -> 2 ranks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import plan as jplan
from kfac_pytorch_tpu.utils import checkpoint as jckpt
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import plan as tplan
from kfac_pytorch_tpu_torch import training
from kfac_pytorch_tpu_torch.preconditioner import KFACState
from kfac_pytorch_tpu_torch.utils import checkpoint as tckpt

import torch_dist_workers as workers

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore:ekfac variants')

B = 8


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {'input': torch.from_numpy(rng.randn(B, 7, 7, 3)
                                      .astype(np.float32)),
            'label': torch.from_numpy(rng.randn(B, 10).astype(np.float32))}


def _loss(out, batch):
    return ((out - batch['label']) ** 2).mean()


def _make(variant='eigen_dp', **kw):
    torch.manual_seed(0)
    model = workers.TinyCNN()
    pre = tkfac.KFAC(variant=variant, lr=0.1, damping=0.003,
                     fac_update_freq=1, kfac_update_freq=2,
                     bucket_fn=workers.bucket_tiny, **kw)
    tx = training.sgd(0.1, momentum=0.9)
    state = training.init_train_state(model, tx, pre, _batch(0)['input'],
                                      device='cpu')
    step = training.build_train_step(model, tx, pre, _loss)
    return pre, state, step


def _run(step, state, n, start=0):
    for i in range(start, start + n):
        state, m = step(state, _batch(i))
    return state, float(m['loss'])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _kfac_tree(st):
    return {'factors': st.factors, 'decomp': st.decomp,
            'comm_err': st.comm_err}


# ---------------------------------------------------------------------------
# the replan invariants, at world=1
# ---------------------------------------------------------------------------

def test_world1_modes_bit_identical():
    out = {}
    for mode in ('pred', 'inverse'):
        pre, state, step = _make(comm_mode=mode)
        state, loss = _run(step, state, 4)
        out[mode] = (loss, dict(state.model.state_dict()))
    assert out['pred'][0] == out['inverse'][0]
    _assert_equal(out['pred'][1], out['inverse'][1])


@pytest.mark.parametrize('variant', ['eigen_dp', 'ekfac_dp'])
def test_replan_to_identical_plan_is_bitwise_noop(variant):
    pre, state, step = _make(variant)
    prec, statec, stepc = _make(variant)
    state, _ = _run(step, state, 3)
    statec, _ = _run(stepc, statec, 3)
    fired = []
    pre.add_invalidator(lambda: fired.append(1))
    plan = pre.plan
    carried = pre.replan(state.kfac_state, comm_mode=pre.comm_mode)
    assert carried is state.kfac_state
    assert not fired and pre.plan is not plan
    state, loss = _run(step, state, 3, start=3)
    statec, lossc = _run(stepc, statec, 3, start=3)
    assert loss == lossc
    _assert_equal(dict(state.model.state_dict()),
                  dict(statec.model.state_dict()))
    _assert_equal(state.opt_state, statec.opt_state)
    _assert_equal(_kfac_tree(state.kfac_state), _kfac_tree(statec.kfac_state))


def test_pure_comm_mode_roundtrip_carries_state_verbatim():
    pre, state, step = _make('eigen', comm_precision='bf16')
    state, _ = _run(step, state, 4)
    k0 = state.kfac_state
    assert k0.comm_err is not None
    k1 = pre.replan(k0, comm_mode='pred')
    assert pre.comm_mode == 'pred' and pre.plan.comm_mode == 'pred'
    assert k1 is k0
    k2 = pre.replan(k1, comm_mode='inverse')
    assert pre.plan.comm_mode == 'inverse' and k2 is k0


def test_ekfac_comm_mode_switch_restarts_the_moments():
    pre, state, step = _make('ekfac_dp')
    state, _ = _run(step, state, 4)
    k0 = state.kfac_state
    k1 = pre.replan(k0, comm_mode='inverse')
    assert k1 is not k0
    _assert_equal(k1.factors, k0.factors)
    _assert_equal({p: k1.decomp[p] for p in ('evals', 'evecs')},
                  {p: k0.decomp[p] for p in ('evals', 'evecs')})
    want = pre._zero_scales('cpu')
    assert {k: v.shape for k, v in k1.decomp['scales'].items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(not torch.any(v) for v in k1.decomp['scales'].values())
    state = dataclasses.replace(state, kfac_state=k1)
    state, loss = _run(step, state, 2, start=4)
    assert np.isfinite(loss)
    assert all(torch.any(v != 0)
               for v in state.kfac_state.decomp['scales'].values())


@pytest.mark.parametrize('first,second', [('eigen', 'inverse_dp'),
                                          ('ekfac_dp', 'eigen_dp')])
def test_variant_roundtrip_preserves_factor_emas_exactly(first, second):
    pre, state, step = _make(first)
    state, _ = _run(step, state, 4)
    k0 = state.kfac_state
    k1 = pre.replan(k0, variant=second)
    assert (pre.variant, pre.method, pre.stats_reduce, pre.comm_mode) == (
        second, tkfac.preconditioner._VARIANTS[second]['method'],
        tkfac.preconditioner._VARIANTS[second]['stats_reduce'],
        tkfac.preconditioner._VARIANTS[second]['comm_mode'])
    if pre.method == 'cholesky':
        assert set(k1.decomp) == {'invs'}
        assert all(not torch.any(v) for v in k1.decomp['invs'].values())
    else:
        assert 'scales' not in k1.decomp
    k2 = pre.replan(k1, variant=first)
    assert pre.variant == first and k2.step == k0.step
    _assert_equal(k2.factors, k0.factors)
    if first == 'ekfac_dp':
        # the same method both ways: the decomposition is carried
        _assert_equal({p: k2.decomp[p] for p in ('evals', 'evecs')},
                      {p: k0.decomp[p] for p in ('evals', 'evecs')})
        assert all(not torch.any(v) for v in k2.decomp['scales'].values())


def test_trainer_rearms_after_cross_method_replan():
    pre, state, step = _make('eigen_dp')
    state, _ = _run(step, state, 5)          # last decomposition at step 4
    assert state.decomposed
    pre.request_replan(variant='inverse_dp')
    assert pre.pending_replan == {'variant': 'inverse_dp'}
    state, _ = _run(step, state, 1, start=5)  # applied at the top; no
    assert pre.pending_replan is None          # inverse update at step 5
    assert pre.method == 'cholesky'
    assert not state.decomposed and step.last_phases == ('stats',)
    grads = step.last_grads
    state, loss = _run(step, state, 1, start=6)   # the rebuild
    assert state.decomposed and step.last_decomp == 'full'
    assert np.isfinite(loss)
    assert all(torch.any(v != 0)
               for v in state.kfac_state.decomp['invs'].values())
    assert grads is not None


def test_rederived_decomposition_survives_a_same_method_replan():
    pre, state, step = _make('eigen_dp', decomp_impl='subspace')
    state, _ = _run(step, state, 5)
    assert 'last_full' in step.warm_tracking
    carried = pre.replan(state.kfac_state, variant='ekfac_dp')
    state = dataclasses.replace(state, kfac_state=carried)
    state, _ = _run(step, state, 2, start=5)
    # the carried eigenbasis is a decomposition: preconditioned from the
    # first step on, and the next full decomposition is cold
    assert state.decomposed
    assert step.last_decomp == 'full'


def test_replan_during_stagger_rebuilds_cohorts_with_bucket_overrides():
    pre, state, step = _make('eigen_dp', stagger=True)
    state, _ = _run(step, state, 4)
    base_f = pre.cohorts.base_freq
    assert pre.cohorts.bucket_freq == {}
    big = max(pre.plan.bucket_dims)
    carried = pre.replan(state.kfac_state, bucket_overrides={big: 2})
    assert carried is state.kfac_state
    assert pre.bucket_stagger_freq == {big: 2}
    layout = pre.cohorts
    assert layout.base_freq == base_f and layout.bucket_freq == {big: 2}
    assert layout.num_cohorts == 2 * base_f
    for bdim in pre.plan.bucket_dims:
        period = base_f * (2 if bdim == big else 1)
        rows, valid = layout.rows[bdim], layout.valid[bdim]
        seen = {}
        for f in range(layout.num_cohorts):
            for j in range(rows.shape[2]):
                if valid[f, 0, j]:
                    seen.setdefault(int(rows[f, 0, j]), []).append(f)
        for fs in seen.values():
            gaps = set(np.diff(fs + [fs[0] + layout.num_cohorts]))
            assert gaps == {period}, (bdim, fs, period)
    state = dataclasses.replace(state, kfac_state=carried)
    state, loss = _run(step, state, 2 * layout.num_cohorts, start=4)
    assert np.isfinite(loss) and state.decomposed
    assert step.last_decomp == 'cohort'
    pre.replan(state.kfac_state, bucket_overrides={})
    assert pre.cohorts.num_cohorts == base_f


# ---------------------------------------------------------------------------
# validation: JAX's errors, and what is not ported
# ---------------------------------------------------------------------------

def _metas(pkg):
    """Three dense layers without bias and a conv, for a plan of three
    buckets under the tiny bucketing."""
    out = {f'fc{i}': pkg.LayerMeta(name=f'fc{i}', path=(f'fc{i}',),
                                   kind='dense', use_bias=False, in_dim=a,
                                   out_dim=g, kernel_shape=(a, g))
           for i, (a, g) in enumerate([(28, 8), (73, 10), (129, 8)])}
    return out


def _raised(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the type is compared
        return type(e), str(e)
    return None


_RULES = [
    (dict(), dict(bucket_overrides={32: 2})),
    (dict(stagger=True), dict(bucket_overrides={32: 0})),
    (dict(stagger=True), dict(bucket_overrides={32: 3})),
    (dict(stagger=True), dict(bucket_overrides={999: 2})),
    (dict(stagger=True), dict(variant='ekfac_dp')),
    (dict(), dict(variant='nope')),
    (dict(), dict(comm_mode='sideways')),
    (dict(), dict(num_devices=0)),
    (dict(variant='inverse_dp', decomp_impl='newton_schulz'),
     dict(variant='eigen')),
    (dict(variant='eigen', decomp_impl='subspace'),
     dict(variant='inverse_dp')),
]


@pytest.mark.parametrize('ctor,spec', _RULES,
                         ids=[str(i) for i in range(len(_RULES))])
def test_replan_validation_rules_match_jax(ctor, spec):
    kw = dict(dict(variant='eigen_dp', bucket_fn=workers.bucket_tiny), **ctor)
    tpre, jpre = tkfac.KFAC(**kw), jkfac.KFAC(**kw)
    tpre.setup(_metas(tcapture))
    jpre.setup(_metas(jcapture))
    plan = tpre.plan
    got = _raised(lambda: tpre.replan(None, **spec))
    want = _raised(lambda: jpre.replan(None, **spec))
    assert want is not None and got == want
    assert tpre.plan is plan and tpre.bucket_stagger_freq == {}


@pytest.mark.parametrize('spec,item', [
    (dict(num_devices=2), 'item 13'), (dict(mesh_axes='dp2xtp2'), 'slice E'),
    (dict(_invalidate=False), 'slice F')])
def test_unported_replans_name_their_roadmap_item(spec, item):
    pre = tkfac.KFAC(variant='eigen_dp', bucket_fn=workers.bucket_tiny)
    pre.setup(_metas(tcapture))
    if 'num_devices' in spec:
        # the elastic lane (item 13) is ported: a host replan to another
        # world returns that world's states, JAX's reshard row for row
        jold, jnew = _pre(jkfac, 'eigen_dp', 1), _pre(jkfac, 'eigen_dp', 2)
        jstate = _global_state(jold, 3)
        got = pre.replan(_port_states(pre, jstate), **spec)
        want = _port_states(_pre(tkfac, 'eigen_dp', 2),
                            jckpt.reshard_kfac_state(jold, jnew, jstate,
                                                     carry_decomp=True))
        assert pre.num_devices == pre.plan.num_devices == 2
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.step == w.step == 7
            _assert_equal(g.factors, w.factors)
            _assert_equal(g.decomp, w.decomp)
    else:
        with pytest.raises(NotImplementedError, match=item):
            pre.replan(None, **spec)
    with pytest.raises(NotImplementedError, match='slice F'):
        pre.request_replan(_invalidate=False, comm_mode='inverse')
    assert pre.pending_replan is None


# ---------------------------------------------------------------------------
# same_row_layout and reshard_kfac_state against JAX
# ---------------------------------------------------------------------------

def _pre(pkg, variant, world):
    pre = pkg.KFAC(variant=variant, num_devices=world,
                   bucket_fn=workers.bucket_tiny,
                   **({'axis_name': 'batch'} if pkg is jkfac and world > 1
                      else {}))
    pre.setup(_metas(jcapture if pkg is jkfac else tcapture))
    return pre


def test_same_row_layout_matches_jax():
    cases = [(('eigen_dp', 1), ('eigen', 1)), (('eigen_dp', 2), ('eigen', 2)),
             (('eigen_dp', 1), ('eigen_dp', 2)), (('eigen', 2), ('eigen', 2))]
    for a, b in cases:
        got = tplan.same_row_layout(_pre(tkfac, *a).plan,
                                    _pre(tkfac, *b).plan)
        want = jplan.same_row_layout(_pre(jkfac, *a).plan,
                                     _pre(jkfac, *b).plan)
        assert got == want, (a, b)
    ta = tkfac.KFAC(variant='eigen_dp', bucket_fn=workers.bucket_tiny,
                    num_devices=2, assignment='balanced')
    ta.setup(_metas(tcapture))
    ja = jkfac.KFAC(variant='eigen_dp', bucket_fn=workers.bucket_tiny,
                    num_devices=2, axis_name='batch', assignment='balanced')
    ja.setup(_metas(jcapture))
    assert tplan.same_row_layout(ta.plan, _pre(tkfac, 'eigen_dp', 2).plan) \
        == jplan.same_row_layout(ja.plan, _pre(jkfac, 'eigen_dp', 2).plan)


def _global_state(jpre, seed):
    """A JAX state of ``jpre`` (global rows) filled with seeded values."""
    rng = np.random.RandomState(seed)
    init = jpre.init()

    def fill(x):
        return jnp.asarray(rng.randn(*x.shape).astype(np.float32))
    return init.replace(
        step=jnp.asarray(7, jnp.int32),
        factors={k: fill(v) for k, v in init.factors.items()},
        decomp={p: {k: fill(v) for k, v in tree.items()}
                for p, tree in init.decomp.items()})


def _port_states(tpre, jstate):
    """The same state as the port's per-rank states (rank order)."""
    plan = tpre.plan
    out = []
    P = plan.num_devices
    for r in range(P):
        def mine(x, decomposition=False):
            x = torch.from_numpy(np.array(x))
            if decomposition and tpre.comm_mode == 'inverse':
                return x
            per = x.shape[0] // P
            return x[r * per:(r + 1) * per]
        out.append(KFACState(
            step=int(jstate.step),
            factors={k: mine(v) for k, v in jstate.factors.items()},
            decomp={p: {k: mine(v, True) for k, v in tree.items()}
                    for p, tree in jstate.decomp.items()}))
    return out if len(out) > 1 else out[0]


@pytest.mark.parametrize('carry', [False, True])
@pytest.mark.parametrize('old,new', [
    (('eigen_dp', 1), ('eigen', 1)), (('eigen_dp', 1), ('ekfac_dp', 1)),
    (('eigen_dp', 2), ('eigen_dp', 1)), (('eigen', 2), ('inverse_dp', 1)),
    (('eigen', 1), ('eigen_dp', 2))],
    ids=lambda v: f'{v[0]}x{v[1]}')
def test_reshard_kfac_state_matches_jax(old, new, carry):
    jo, jn = _pre(jkfac, *old), _pre(jkfac, *new)
    to, tn = _pre(tkfac, *old), _pre(tkfac, *new)
    jstate = _global_state(jo, 3)
    want = jckpt.reshard_kfac_state(jo, jn, jstate, carry_decomp=carry)
    got = tckpt.reshard_kfac_state(to, tn, _port_states(to, jstate),
                                   carry_decomp=carry)
    wanted = _port_states(tn, want)
    if new[1] == 1:
        got, wanted = [got], [wanted]
    assert len(got) == len(wanted) == new[1]
    for g, w in zip(got, wanted):
        assert g.step == w.step == 7
        _assert_equal(g.factors, w.factors)
        assert set(g.decomp) == set(w.decomp)
        _assert_equal(g.decomp, w.decomp)
        assert g.comm_err is None
