"""The sharded decomposition (``decomp_shard``), the staggered refresh at
world>1 and ``comm_prefetch`` against the JAX package (oracles:
``tests/test_decomp_shard.py`` and ``tests/test_stagger.py``).

- ``plan.build_decomp_shard``'s tables equal JAX's element for element
  for ResNet-32's layers and for a plan whose large factors all sit on one
  owner, at P in {2, 4} and F in {1, 2, 4}; ``comm_volume(decomp_shard=)``
  equals JAX's at fp32, bf16 and int8;
- at world=1, ``decomp_shard`` leaves the decomposition bitwise as the
  owner-local staggered schedule does, for the four variants, cold and
  (comm_mode 'inverse') warm-started; both merge
  guards keep the stored rows where a fresh row is not finite, and a
  finite merge equals JAX's bitwise;
- at world=2 (gloo ranks through ``launch.spawn``, the rank functions in
  ``tests/torch_dist_workers.py``; the JAX oracle on the 2-device CPU
  mesh, from the same weights and batch, lr 0): ``eigen_dp`` and
  ``eigen``, staggered and sharded, over 5 steps. The decomposition rows
  are held to JAX's at ``rtol=1e-5, atol=1e-6``: the eigenvalues as they
  are, the eigenvectors through the matrix they rebuild, ``Q diag(d)
  Q^T``, its ``atol`` in units of its largest entry (two eigh solvers may
  pick other bases inside an eigenvalue cluster, and a damped inverse
  would amplify the fp32 error of an eigenvalue near 0); rows outside the step's cohort keep the previous step's bits;
  the preconditioned gradients at ``GRAD_TOL``. Within the port the
  sharded run equals the owner-local one bitwise, and a sharded step's
  ``kfac.DecompComm`` bytes equal ``comm_volume``;
- ``comm_prefetch``: a prefetched inverse update preconditions with the
  stored table and publishes the fresh one (world=1 bitwise, world=2
  against the mesh), and the trainer never prefetches the first
  decomposition;
- the constructor's rules equal JAX's; ``train_cifar --num-devices 2
  --kfac-decomp-shard`` trains with both ranks bitwise equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import engine as jengine
from kfac_pytorch_tpu import plan as jplan
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import engine as tengine
from kfac_pytorch_tpu_torch import launch, training
from kfac_pytorch_tpu_torch import plan as tplan

import torch_dist_workers as workers
from test_torch_distributed import GRAD_TOL, _assert_grads, _cfg, \
    _jax_mesh_run
from test_torch_ekfac import _raised

torch.set_num_threads(2)

ROW_TOL = dict(rtol=1e-5, atol=1e-6)
#: cohorts and steps of the world=2 runs: step 0 decomposes in full, the
#: next four one cohort each (cohort ``t % F2`` at step t)
F2, STEPS = 2, 5
TRAINER_ARGV = ['--model', 'resnet20', '--batch-size', '16',
                '--kfac-update-freq', '2', '--kfac-decomp-shard']
TRAINER_STEPS = 2


# ---------------------------------------------------------------------------
# the shard tables and their price
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def resnet32_metas():
    model = jresnet.resnet32()
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax.eval_shape(
        lambda: jcapture.init(model, jax.random.PRNGKey(0), x))
    return jcapture.collect_layer_meta(model, variables, x)


def _metas(kind, resnet32, P):
    """``(port metas, JAX metas)``: ResNet-32's layers, or JAX's
    imbalanced plan (``tests/test_decomp_shard.py``): 16 square dense
    layers, the 512-wide ones (index % P == 0) all on rank 0."""
    if kind == 'resnet32':
        jm = resnet32
    else:
        jm = {}
        for i in range(16):
            d = 512 if i % P == 0 else 48
            jm[f'l{i}'] = jcapture.LayerMeta(
                name=f'l{i}', path=(f'l{i}',), kind='dense', use_bias=False,
                in_dim=d, out_dim=d, kernel_shape=(d, d))
    tm = {k: tcapture.LayerMeta(**dataclasses.asdict(m))
          for k, m in jm.items()}
    return tm, jm


def _both_shards(tm, jm, P, F, mode='pred'):
    kw = dict(num_devices=P, comm_mode=mode)
    tp, jp = tplan.build_plan(tm, **kw), jplan.build_plan(jm, **kw)
    return (tp, tplan.build_decomp_shard(tp, tplan.build_cohorts(tp, F)),
            jp, jplan.build_decomp_shard(jp, jplan.build_cohorts(jp, F)))


def _assert_same_shard(got, want):
    assert got.num_cohorts == want.num_cohorts
    assert got.cohort_rows == want.cohort_rows
    for f in ('shard_cost', 'shard_count'):
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype, f
    for f in ('src', 'src_valid', 'src_global', 'res_slot', 'res_valid'):
        g, w = getattr(got, f), getattr(want, f)
        assert list(g) == list(w), f
        for b in w:
            np.testing.assert_array_equal(g[b], w[b], err_msg=f'{f} {b}')
            assert g[b].dtype == w[b].dtype, (f, b)
    for b in want.src:
        assert got.gather_rows(b) == want.gather_rows(b)
        assert got.shard_rows(b) == want.shard_rows(b)
    for m in ('max_rows_per_step', 'padded_rows_per_step'):
        assert getattr(got, m)() == getattr(want, m)(), m


@pytest.mark.parametrize('F', [1, 2, 4])
@pytest.mark.parametrize('P', [2, 4])
@pytest.mark.parametrize('kind', ['resnet32', 'imbalanced'])
def test_shard_tables_match_jax(resnet32_metas, kind, P, F):
    tp, ts, _, js = _both_shards(*_metas(kind, resnet32_metas, P), P, F)
    _assert_same_shard(ts, js)
    # every valid row decomposed once a window, by one rank
    total = sum(int(tp.buckets[b].valid.sum()) for b in tp.bucket_dims)
    assert int(ts.shard_count.sum()) == total


@pytest.mark.parametrize('prec', ['fp32', 'bf16', 'int8'])
def test_comm_volume_prices_the_exchange_as_jax(resnet32_metas, prec):
    for kind in ('resnet32', 'imbalanced'):
        tm, jm = _metas(kind, resnet32_metas, 2)
        for mode in ('pred', 'inverse'):
            tp, ts, jp, js = _both_shards(tm, jm, 2, 2, mode)
            for reduce in ('local', 'pmean'):
                for method in ('eigh', 'cholesky'):
                    args = dict(stats_reduce=reduce, method=method,
                                comm_precision=prec)
                    got = tp.comm_volume(decomp_shard=ts, **args)
                    assert got == jp.comm_volume(decomp_shard=js, **args)
                    # the exchange replaces the staggered merge's gather
                    assert got['InverseComm'] == 0 < got['DecompComm']
                    assert tp.comm_volume(**args)['DecompComm'] == 0


# ---------------------------------------------------------------------------
# world=1: the preconditioner API
# ---------------------------------------------------------------------------

def _mlp_batch():
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randn(4, 5).astype(np.float32)),
            torch.from_numpy(rng.randn(4, 3).astype(np.float32)))


def _world1(variant, **kw):
    """The MLP's KFAC (one 16 bucket), its fresh state, grads and
    captures of one batch."""
    x, y = _mlp_batch()
    torch.manual_seed(0)
    model = workers.MLP()
    pre = tkfac.KFAC(variant=variant, bucket_fn=workers.bucket16, **kw)
    pre.setup(tcapture.collect_layer_meta(model, x))
    with tcapture.Capture(model, pre.plan.metas) as cap:
        ((model(x) - y) ** 2).mean().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return pre, pre.init('cpu'), grads, cap.acts, cap.gs


def _assert_equal_trees(a, b, what=''):
    assert set(a) == set(b), what
    for part in a:
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (what, part, k)


@pytest.mark.parametrize('variant,kw', [
    ('eigen_dp', {}), ('inverse_dp', {}), ('eigen', {}), ('inverse', {}),
    # warm seeds: the shard reads them through src_global in comm_mode
    # 'inverse', owner-local stagger through its local rows
    ('eigen', {'decomp_impl': 'subspace'}),
    ('inverse', {'decomp_impl': 'newton_schulz', 'comm_mode': 'inverse'})],
    ids=lambda v: v if isinstance(v, str) else
    '-'.join(map(str, v.values())) or 'cold')
def test_shard_world1_bitwise_equals_stagger(variant, kw):
    F = 3
    ps, ss, grads, acts, gs = _world1(variant, kfac_update_freq=F,
                                      decomp_shard=True, **kw)
    assert ps.stagger and ps.decomp_shard_plan.num_cohorts == F
    po, so, *_ = _world1(variant, kfac_update_freq=F, stagger=True, **kw)
    assert po.decomp_shard_plan is None
    _, ss = ps.step(ss, grads, acts, gs)
    _, so = po.step(so, grads, acts, gs)
    for t in range(2 * F):
        gs_, ss = ps.step(ss, grads, acts, gs, stagger_update=True)
        go_, so = po.step(so, grads, acts, gs, stagger_update=True)
        _assert_equal_trees(ss.decomp, so.decomp, f'{variant} step {t}')
        assert all(torch.equal(gs_[k], go_[k]) for k in grads)


def _jax_twin(pre):
    """The JAX plan, cohorts and shard tables of ``pre``'s world=1 plan."""
    jm = {m.name: jcapture.LayerMeta(**dataclasses.asdict(m))
          for m in pre.plan.metas}
    jp = jplan.build_plan(jm, num_devices=1, comm_mode=pre.comm_mode,
                          bucket_fn=workers.bucket16)
    jc = jplan.build_cohorts(jp, pre.cohorts.num_cohorts)
    return jp, jc, jplan.build_decomp_shard(jp, jc)


def _jnp(tree):
    return {p: {k: jnp.asarray(v.numpy()) for k, v in t.items()}
            for p, t in tree.items()}


@pytest.mark.parametrize('shard', [True, False], ids=['shard', 'stagger'])
def test_merge_guard_keeps_stored_rows_on_nonfinite(shard):
    """``test_shard_merge_guard_keeps_stored_rows_on_nonfinite`` and
    ``test_stagger_merge_guard_keeps_stored_rows_on_nonfinite``: an
    all-NaN cohort leaves the stored table as it was with the guard on and
    lands with it off; a finite cohort merges as JAX merges it."""
    kw = dict(decomp_shard=True) if shard else dict(stagger=True)
    pre, state, grads, acts, gs = _world1('eigen_dp', kfac_update_freq=2,
                                          **kw)
    _, state = pre.step(state, grads, acts, gs)
    # the factors move on, so the fresh cohort differs from the stored one
    _, state = pre.step(state, grads, acts, gs, update_inverse=False)
    jp, jc, js = _jax_twin(pre)
    damping = torch.tensor(pre.damping)
    if shard:
        fresh = tengine.compute_shard_decomposition(
            pre.plan, pre.cohorts, pre.decomp_shard_plan, state.factors, 1,
            damping, pre.method, pre.eps)
        merge = functools.partial(tengine.merge_shard_decomposition,
                                  pre.plan, pre.decomp_shard_plan)
        jmerge = functools.partial(jengine.merge_shard_decomposition, jp, js)
    else:
        fresh = tengine.compute_cohort_decomposition(
            pre.plan, pre.cohorts, state.factors, 1, damping, pre.method,
            pre.eps)
        merge = functools.partial(tengine.merge_cohort_decomposition,
                                  pre.plan, pre.cohorts)
        jmerge = functools.partial(jengine.merge_cohort_decomposition, jp,
                                   jc)
    poisoned = {p: {k: torch.full_like(v, float('nan'))
                    for k, v in t.items()} for p, t in fresh.items()}
    args = (1, None, pre.comm_mode, pre.method)
    kept = merge(state.decomp, poisoned, *args, guard=True)
    _assert_equal_trees(kept, state.decomp)
    raw = merge(state.decomp, poisoned, *args, guard=False)
    assert any(not torch.isfinite(v).all() for p in ('evals', 'evecs')
               for v in raw[p].values())
    got = merge(state.decomp, fresh, *args, guard=True)
    want = jmerge(_jnp(state.decomp), _jnp(fresh), jnp.int32(1), None,
                  pre.comm_mode, pre.method, guard=True)
    assert not all(torch.equal(got['evals'][k], state.decomp['evals'][k])
                   for k in got['evals'])
    for p in ('evals', 'evecs'):
        for k, v in got[p].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[p][k]))


@pytest.mark.parametrize('kw', [
    dict(variant='eigen_dp', decomp_shard=True),
    dict(variant='inverse', decomp_shard=True),
    dict(variant='ekfac_dp', decomp_shard=True),
    dict(variant='ekfac', decomp_shard=True),
    dict(variant='eigen_dp', decomp_shard=True, basis_update_freq=4),
    dict(variant='inverse_dp', decomp_shard=True, warm_start_basis=True),
    dict(variant='eigen', comm_prefetch=True),
    dict(variant='eigen', comm_prefetch=True, decomp_shard=True),
    dict(variant='inverse', comm_prefetch=True),
    dict(variant='inverse', comm_prefetch=True,
         communicate_inverse_or_not=True),
    dict(variant='eigen_dp', comm_prefetch=True, comm_mode='inverse'),
    dict(variant='eigen_dp', stagger=True, num_devices=2)],
    ids=lambda kw: '-'.join(f'{k}={v}' for k, v in kw.items()))
@pytest.mark.filterwarnings('ignore::UserWarning')
def test_constructor_rules_match_jax(kw):
    got = _raised(tkfac.KFAC, kw)
    assert got == _raised(jkfac.KFAC, kw)
    if got is None:
        t, j = tkfac.KFAC(**kw), jkfac.KFAC(**kw)
        for a in ('stagger', 'decomp_shard', 'comm_prefetch', 'comm_mode'):
            assert getattr(t, a) == getattr(j, a), a


def test_scheduler_rescale_and_replan_rebuild_the_shard_plan():
    pre, *_ = _world1('eigen_dp', kfac_update_freq=4, decomp_shard=True)
    sched = tkfac.KFACParamScheduler(pre, update_freq_alpha=2,
                                     update_freq_schedule=[1])
    sched.step(1)
    assert pre.kfac_update_freq == 8 and pre.cohorts.num_cohorts == 8
    _assert_same_shard(pre.decomp_shard_plan, _jax_twin(pre)[2])
    old = pre.decomp_shard_plan
    pre.replan(comm_mode='inverse')
    assert pre.decomp_shard_plan is not old
    _assert_same_shard(pre.decomp_shard_plan, _jax_twin(pre)[2])
    pre, *_ = _world1('eigen', comm_prefetch=True)
    with pytest.raises(ValueError, match='comm_prefetch'):
        pre.replan(comm_mode='pred')


def test_prefetched_update_preconditions_with_the_stored_table():
    """The port counterpart of ``test_stagger_double_buffer_pred_uses_
    previous_table``, for a full update: a prefetched inverse update
    preconditions with ``state.decomp`` (as a step without one does),
    publishes the same table a plain update computes, and the next step
    preconditions with it."""
    pre, s0, grads, acts, gs = _world1('eigen', comm_prefetch=True)
    _, s1 = pre.step(s0, grads, acts, gs)
    g_stale, _ = pre.step(s1, grads, acts, gs, update_inverse=False)
    g_pf, s_pf = pre.step(s1, grads, acts, gs, prefetch=True)
    g_full, s_full = pre.step(s1, grads, acts, gs)
    assert all(torch.equal(g_pf[k], g_stale[k]) for k in grads)
    assert not all(torch.equal(g_full[k], g_stale[k]) for k in grads)
    _assert_equal_trees(s_pf.decomp, s_full.decomp)
    g_next, _ = pre.step(s_pf, grads, acts, gs, update_inverse=False)
    assert all(torch.equal(g_next[k], g_full[k]) for k in grads)
    plain, s, *_ = _world1('eigen')
    with pytest.raises(AssertionError, match='comm_prefetch'):
        plain.step(s, grads, acts, gs, prefetch=True)


def test_trainer_never_prefetches_the_first_decomposition():
    x, y = _mlp_batch()
    torch.manual_seed(0)
    model = workers.MLP()
    model.input_layout = 'tokens'   # training.model_input: as it is
    pre = tkfac.KFAC(variant='eigen', comm_prefetch=True,
                     kfac_update_freq=2, bucket_fn=workers.bucket16)
    tx = training.sgd(0.1, momentum=0.9)
    state = training.init_train_state(model, tx, pre, x, 'cpu')
    step = training.build_train_step(
        model, tx, pre, lambda o, b: ((o - b['label']) ** 2).mean())
    seen = []
    for _ in range(5):
        state, _ = step(state, {'input': x, 'label': y})
        seen.append((step.last_decomp, step.last_prefetch))
    assert seen == [('full', False), (None, False), ('full', True),
                    (None, False), ('full', True)]


# ---------------------------------------------------------------------------
# world=2 against the mesh
# ---------------------------------------------------------------------------

def _w2_cfg(variant, **kfac):
    return dict(_cfg('mlp', variant, steps=STEPS),
                kfac=dict(kfac_update_freq=F2, **kfac), ledger_step=1,
                ladder=[{}] + [{'stagger_update': True}] * (STEPS - 1))


W2_CFGS = {(v, shard): _w2_cfg(v, **({'decomp_shard': True} if shard
                                      else {'stagger': True}))
           for v in ('eigen_dp', 'eigen') for shard in (False, True)}
PREFETCH_CFG = dict(_cfg('mlp', 'eigen', steps=4),
                    kfac=dict(comm_prefetch=True),
                    ladder=[{}, {'update_inverse': False}, {'prefetch': True},
                            {'update_inverse': False}])


@functools.lru_cache(maxsize=None)
def _world2():
    """Every world=2 config and the trainer on one spawned gloo world:
    ``({name: [rank outs]}, [trainer out a rank])``."""
    names = list(W2_CFGS) + ['prefetch']
    cfgs = list(W2_CFGS.values()) + [PREFETCH_CFG]
    outs = launch.spawn(workers.shard_module_runs, 2,
                        args=(cfgs, TRAINER_ARGV, TRAINER_STEPS),
                        timeout=300)
    runs = {n: [outs[r][0][i] for r in range(2)]
            for i, n in enumerate(names)}
    return runs, [outs[r][1] for r in range(2)]


def _port_kfac(cfg):
    """A world=2 KFAC of ``cfg`` (no group): its plan and tables."""
    x = torch.from_numpy(cfg['x'][:4])
    pre = tkfac.KFAC(variant=cfg['variant'], num_devices=2,
                     bucket_fn=workers.bucket16, **cfg['kfac'])
    pre.setup(tcapture.collect_layer_meta(workers.MLP(), x))
    return pre


def _rebuilt(d, q):
    """``Q diag(d) Q^T`` per row, in fp64."""
    d, q = np.asarray(d, np.float64), np.asarray(q, np.float64)
    return q @ (d[..., :, None] * np.swapaxes(q, -1, -2))


def _rank_rows(plan, key, rank, local):
    """The global rows a rank holds of bucket ``key``."""
    per = plan.buckets[int(key)].per_dev
    if local:
        return range(rank * per, (rank + 1) * per)
    return range(plan.buckets[int(key)].n_rows)


@pytest.mark.parametrize('shard', [False, True], ids=['stagger', 'shard'])
@pytest.mark.parametrize('variant', ['eigen_dp', 'eigen'])
def test_world2_staggered_matches_jax_mesh(variant, shard):
    cfg = W2_CFGS[(variant, shard)]
    ranks = _world2()[0][(variant, shard)]
    want = _jax_mesh_run(cfg, 2)
    pre = _port_kfac(cfg)
    plan, layout = pre.plan, pre.cohorts
    local = variant == 'eigen_dp'
    for r, out in enumerate(ranks):
        for t, (jgrads, jstate, _) in enumerate(want):
            step = out['steps'][t]
            _assert_grads(step['grads'], jgrads, f'rank {r} step {t}')
            dec, jd = step['decomp'], jstate.decomp
            for key, d in dec['evals'].items():
                rows = list(_rank_rows(plan, key, r, local))
                np.testing.assert_allclose(d, jd['evals'][key][rows],
                                           err_msg=f'{key} step {t}',
                                           **ROW_TOL)
                op = _rebuilt(jd['evals'][key][rows], jd['evecs'][key][rows])
                np.testing.assert_allclose(
                    _rebuilt(d, dec['evecs'][key]), op,
                    rtol=ROW_TOL['rtol'],
                    atol=ROW_TOL['atol'] * np.abs(op).max(),
                    err_msg=f'{key} step {t}')
            if t == 0:
                continue
            c, changed = t % F2, 0
            prev = out['steps'][t - 1]['decomp']
            for key in dec['evals']:
                b = int(key)
                per = plan.buckets[b].per_dev
                touched = {d * per + int(j)
                           for d in range(2)
                           for j, v in zip(layout.rows[b][c, d],
                                           layout.valid[b][c, d]) if v}
                for i, g in enumerate(_rank_rows(plan, key, r, local)):
                    for part in ('evals', 'evecs'):
                        same = np.array_equal(dec[part][key][i],
                                              prev[part][key][i])
                        if g not in touched:
                            assert same, (part, key, g, t)
                        changed += not same
            assert changed or local, (r, t)


@pytest.mark.parametrize('variant', ['eigen_dp', 'eigen'])
def test_world2_shard_is_bitwise_owner_local(variant):
    runs = _world2()[0]
    for sharded, owner in zip(runs[(variant, True)], runs[(variant, False)]):
        for t, (a, b) in enumerate(zip(sharded['steps'], owner['steps'])):
            for part in b['decomp']:
                for k in b['decomp'][part]:
                    np.testing.assert_array_equal(
                        a['decomp'][part][k], b['decomp'][part][k],
                        err_msg=f'{part}[{k}] step {t}')
            for k in b['grads']:
                np.testing.assert_array_equal(a['grads'][k], b['grads'][k])


@pytest.mark.parametrize('variant', ['eigen_dp', 'eigen'])
def test_world2_decomp_comm_bytes_equal_comm_volume(variant):
    """A staggered step's collectives by scope: sharded, the two
    DecompComm legs and no CommunicateInverse gather; owner-local in
    comm_mode 'inverse', the cohort's ``P * R_b`` rows gathered."""
    runs = _world2()[0]
    pre = _port_kfac(W2_CFGS[(variant, True)])
    want = pre.plan.comm_volume(stats_reduce=pre.stats_reduce,
                                method=pre.method,
                                decomp_shard=pre.decomp_shard_plan)
    owner = _port_kfac(W2_CFGS[(variant, False)])
    cohort = sum(2 * owner.cohorts.rows[b].shape[2] * (b * b + b) * 4
                 for b in owner.plan.bucket_dims)
    for r in range(2):
        scopes = {}
        for scope, _, _, n in runs[(variant, True)][r]['ledger']:
            scopes[scope] = scopes.get(scope, 0) + n
        assert scopes['kfac.DecompComm'] == want['DecompComm'] > 0
        assert 'kfac.CommunicateInverse' not in scopes
        inverse = sum(n for scope, _, _, n in
                      runs[(variant, False)][r]['ledger']
                      if scope == 'kfac.CommunicateInverse')
        assert inverse == (cohort if variant == 'eigen' else 0)


def test_world2_prefetch_matches_jax_mesh():
    """``eigen`` at world 2: a full decomposition, a step without one, a
    prefetched one and a step without one: the prefetched step's grads are
    the step before's bit for bit (the stored table, the same gradients),
    and every step's are the mesh's."""
    want = _jax_mesh_run(PREFETCH_CFG, 2)
    for r, out in enumerate(_world2()[0]['prefetch']):
        steps = out['steps']
        for t, (jgrads, _, _) in enumerate(want):
            _assert_grads(steps[t]['grads'], jgrads, f'rank {r} step {t}')
        for k in steps[1]['grads']:
            np.testing.assert_array_equal(steps[2]['grads'][k],
                                          steps[1]['grads'][k])
            assert not np.array_equal(steps[3]['grads'][k],
                                      steps[2]['grads'][k])


def test_train_cifar_world2_decomp_shard_trains_bitwise_equal_ranks():
    trained = _world2()[1]
    for out in trained:
        assert out['stagger'] and out['shard']
        assert [s[1] for s in out['steps']] == ['full', 'cohort']
        assert all(np.isfinite(s[0]) for s in out['steps'])
    assert trained[0]['steps'] == trained[1]['steps']
