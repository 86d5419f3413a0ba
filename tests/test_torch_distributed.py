"""The port at world>1 against the JAX package's 2- and 4-device CPU mesh.

The port's ranks are gloo processes (``launch.spawn``, importing no JAX,
``tests/torch_dist_workers.py``); the JAX oracle is the same step under
``shard_map`` on the virtual CPU mesh, as ``tests/test_distributed.py``
runs it, from the same weights (``weights.params_from_jax``) and batch.

- plan tables and ``FactorPlan.comm_volume`` equal JAX's for the
  ResNet-32 layers at P in {2, 4, 8}, round robin and balanced, with and
  without factor-wise distribution; the bytes counted at the collective
  calls (``collectives.ledger``) of one step equal ``comm_volume``;
- MPD ``eigen`` (the MLP and a conv+BatchNorm net) and the DP variants'
  owner-local statistics match the mesh: preconditioned gradients
  ``rtol=1e-3, atol=1e-4`` (``tests/test_distributed.py``), DP factor
  rows ``rtol=1e-4, atol=1e-5``;
- ``eigen`` over a bf16 and an int8 wire matches JAX's ``capture_impl=
  None`` mesh run for three steps (the port with ``capture_impl`` None
  and 'auto', K3's plain version): at world 2 to 5% of the compression's
  own effect, at world 4 (another bf16 summation order) the factors to
  the summation bound; the error-feedback residual is live exactly for
  lossy MPD (``tests/test_comm_precision.py``);
- the launcher trains ResNet-20 at world=2 on the CPU with both ranks
  bitwise equal.
"""

import functools
import os
import re
import subprocess
import sys

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import nn as jnn
from kfac_pytorch_tpu import plan as jplan
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.models.tiny import TinyCNN as JTinyCNN
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import launch, weights
from kfac_pytorch_tpu_torch import plan as tplan
from kfac_pytorch_tpu_torch.models import cifar_resnet as tresnet
from kfac_pytorch_tpu_torch.parallel import mesh as tmesh
from kfac_pytorch_tpu_torch.preconditioner import KFAC

import torch_dist_workers as workers

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LOSSY_STEPS = 3
EKFAC_STEPS = 2


class JMLP(linen.Module):
    @linen.compact
    def __call__(self, x):
        x = jnn.Dense(8, name='fc1')(x)
        x = linen.relu(x)
        return jnn.Dense(3, name='fc2')(x)


def _data(kind):
    rng = np.random.RandomState(0)
    if kind == 'mlp':
        return (rng.randn(8, 5).astype(np.float32),
                rng.randn(8, 3).astype(np.float32))
    return (rng.randn(8, 7, 7, 3).astype(np.float32),
            rng.randn(8, 10).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    model = JMLP() if kind == 'mlp' else JTinyCNN(batch_norm=True)
    x, _ = _data(kind)
    variables = jcapture.init(model, jax.random.PRNGKey(0), jnp.asarray(x))
    return model, variables


def _state_dict(kind):
    _, variables = _jax_model(kind)
    sd = weights.params_from_jax(variables['params'],
                                 variables.get('batch_stats'))
    return {k: v.numpy() for k, v in sd.items()}


def _cfg(kind, variant, precision='fp32', capture_impl=None, steps=1):
    x, y = _data(kind)
    return dict(model=kind, state_dict=_state_dict(kind), x=x, y=y,
                variant=variant, buckets='16' if kind == 'mlp' else 'tiny',
                comm_precision=precision, capture_impl=capture_impl,
                steps=steps)


def _configs(world):
    cfgs = [_cfg('mlp', 'eigen'), _cfg('tiny', 'eigen')]
    for prec in ('bf16', 'int8'):
        cfgs += [_cfg('mlp', 'eigen', prec, impl, LOSSY_STEPS)
                 for impl in ((None, 'auto') if world == 2 else ('auto',))]
    if world == 2:
        cfgs += [_cfg('mlp', v, steps=EKFAC_STEPS)
                 for v in ('ekfac', 'ekfac_dp')]
        cfgs += [_cfg('mlp', 'eigen_dp'), _cfg('mlp', 'inverse_dp'),
                 _cfg('tiny', 'eigen', 'bf16'), _cfg('tiny', 'eigen', 'int8'),
                 _cfg('tiny', 'eigen_dp', 'bf16'), _cfg('tiny', 'inverse')]
    return cfgs


@functools.lru_cache(maxsize=None)
def _port_runs(world):
    """Every config of ``world`` on one spawned gloo world:
    ``(world, cfgs, runs)`` with ``runs[i][rank]``."""
    cfgs = _configs(world)
    outs = launch.spawn(workers.run_many, world, args=(cfgs,), timeout=300)
    return world, cfgs, [[outs[r][i] for r in range(world)]
                         for i in range(len(cfgs))]


_JAX_RUNS = {}


def _jax_mesh_run(cfg, world, feeds=None):
    """``cfg``'s steps under shard_map on ``world`` CPU devices: per step
    the preconditioned grads (as a torch state_dict of numpy) and the
    new state (numpy). ``cfg['phases']`` drives the decomposition ladder
    as in ``torch_dist_workers.run_steps``, and so do ``cfg['kfac']`` (more
    ``KFAC`` arguments) and ``cfg['ladder']`` (``KFAC.step``'s, a dict a
    step); ``feeds[i]`` (numpy) replaces the stored decomposition before
    step ``i``."""
    key = (cfg['model'], cfg['variant'], cfg['comm_precision'], world,
           cfg['steps'], repr(cfg.get('kfac')), repr(cfg.get('ladder')))
    if feeds is None and key in _JAX_RUNS:
        return _JAX_RUNS[key]
    kind = cfg['model']
    model, variables = _jax_model(kind)
    x, y = jnp.asarray(cfg['x']), jnp.asarray(cfg['y'])
    metas = jcapture.collect_layer_meta(model, variables, x)
    pre = jkfac.KFAC(variant=cfg['variant'], num_devices=world,
                     axis_name='batch', health=False,
                     bucket_fn=workers.BUCKETS[cfg['buckets']],
                     comm_precision=cfg['comm_precision'],
                     decomp_impl=cfg.get('decomp_impl'),
                     basis_update_freq=cfg.get('basis_update_freq'),
                     **cfg.get('kfac', {}))
    pre.setup(metas)
    mesh = Mesh(np.array(jax.devices()[:world]), ('batch',))
    pspecs = pre.state_pspecs('batch')
    mutable = ('batch_stats',) if 'batch_stats' in variables else ()

    @functools.lru_cache(maxsize=None)
    def step_of(ladder):
        @jax.jit
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P(), pspecs, P('batch'), P('batch')),
                           out_specs=(P(), pspecs))
        def step(variables, state, xs, ys):
            def loss_fn(out):
                return jnp.mean((out - ys) ** 2)
            _, _, grads, acts, gs, _ = jcapture.value_and_grad_with_capture(
                model, loss_fn, variables, xs, mutable=mutable,
                axis_name='batch')
            grads = jkfac.parallel.average_grads(grads, 'batch')
            return pre.step(state, grads, acts, gs, axis_name='batch',
                            **dict(ladder))
        return step

    state = pre.init()
    out = []
    for i in range(cfg['steps']):
        ladder = ()
        if cfg.get('phases') is not None:
            ladder = tuple(zip(('update_basis', 'warm_basis'),
                               cfg['phases'][i]))
        if cfg.get('ladder') is not None:
            ladder += tuple(sorted(cfg['ladder'][i].items()))
        if feeds is not None:
            state = state.replace(decomp=jax.tree.map(jnp.asarray, feeds[i]))
        grads, state = step_of(ladder)(variables, state, x, y)
        sd = weights.params_from_jax(jax.tree.map(np.asarray, grads))
        out.append(({k: v.numpy() for k, v in sd.items()},
                    jax.tree.map(np.asarray, state), pre.plan))
    if feeds is None:
        _JAX_RUNS[key] = out
    return out


def _runs_of(port_runs, **match):
    world, cfgs, runs = port_runs
    return [(cfg, ranks) for cfg, ranks in zip(cfgs, runs)
            if all(cfg.get(k) == v for k, v in match.items())]


def _assert_grads(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f'{what} {k}',
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# plan tables and the comm volume
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def resnet32_metas():
    jmodel = jresnet.resnet32()
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax.eval_shape(
        lambda: jcapture.init(jmodel, jax.random.PRNGKey(0), x))
    jmetas = jcapture.collect_layer_meta(jmodel, variables, x)
    tmetas = tcapture.collect_layer_meta(tresnet.resnet32(),
                                         torch.zeros((1, 3, 32, 32)))
    return jmetas, tmetas


def _assert_same_plan(tp, jp):
    assert tp.bucket_dims == jp.bucket_dims
    assert tp.layer_rows == jp.layer_rows
    assert tp.local_flat_offsets == jp.local_flat_offsets
    assert tp.assignment == jp.assignment
    for bdim in jp.bucket_dims:
        jb, tb = jp.buckets[bdim], tp.buckets[bdim]
        assert (tb.per_dev, tb.n_rows) == (jb.per_dev, jb.n_rows)
        assert [None if s is None else (s.layer_idx, s.side, s.dim, s.owner)
                for s in tb.slot_of_row] == \
            [None if s is None else (s.layer_idx, s.side, s.dim, s.owner)
             for s in jb.slot_of_row]
        for f in ('true_dims', 'valid', 'mate_flat', 'own_dim', 'mate_dim',
                  'side_is_a'):
            a, b = getattr(tb, f), getattr(jb, f)
            assert (a is None and b is None) or np.array_equal(a, b), \
                (bdim, f)
    assert len(tp.pred_groups) == len(jp.pred_groups)
    for tg, jg in zip(tp.pred_groups, jp.pred_groups):
        assert (tg.dg, tg.da, tg.k_per_dev) == (jg.dg, jg.da, jg.k_per_dev)
        for f in ('layer_idx', 'row_a', 'row_g', 'local_member',
                  'local_valid', 'local_row_a', 'local_row_g',
                  'gathered_row'):
            a, b = getattr(tg, f), getattr(jg, f)
            assert (a is None and b is None) or np.array_equal(a, b), f


@pytest.mark.parametrize('distribute', [False, True])
@pytest.mark.parametrize('assignment', ['round_robin', 'balanced'])
@pytest.mark.parametrize('world', [2, 4, 8])
def test_plan_and_comm_volume_match_jax(resnet32_metas, world, assignment,
                                        distribute):
    jmetas, tmetas = resnet32_metas
    mode = 'inverse' if distribute else 'pred'
    kw = dict(num_devices=world, comm_mode=mode, assignment=assignment,
              distribute_layer_factors=distribute)
    jp, tp = jplan.build_plan(jmetas, **kw), tplan.build_plan(tmetas, **kw)
    _assert_same_plan(tp, jp)
    for reduce, method in (('pmean', 'eigh'), ('local', 'cholesky')):
        for prec in ('fp32', 'bf16', 'int8'):
            for over in (None, 'inverse', 'pred'):
                args = dict(stats_reduce=reduce, method=method,
                            comm_precision=prec, comm_mode=over)
                # no shard plan: DecompComm is 0 (its pricing is held in
                # tests/test_torch_decomp_shard.py)
                assert tp.comm_volume(**args) == jp.comm_volume(**args), args


@pytest.mark.parametrize('world', [2, 3, 8])
def test_partition_matches_jax(world):
    from kfac_pytorch_tpu.parallel import partition as jpart
    from kfac_pytorch_tpu_torch.parallel import partition as tpart
    costs = np.random.RandomState(world).rand(13) ** 3
    assert np.array_equal(tpart.round_robin_assign(13, world),
                          jpart.round_robin_assign(13, world))
    for fn in ('balanced_assign', 'block_partition'):
        assert np.array_equal(getattr(tpart, fn)(costs, world),
                              getattr(jpart, fn)(costs, world)), fn


def test_plan_rejects_pred_with_distributed_factors(resnet32_metas):
    _, tmetas = resnet32_metas
    with pytest.raises(ValueError, match='factor-wise'):
        tplan.build_plan(tmetas, num_devices=2, comm_mode='pred',
                         distribute_layer_factors=True)
    with pytest.raises(ValueError, match='assignment'):
        tplan.build_plan(tmetas, num_devices=2, comm_mode='pred',
                         assignment='lpt')


@pytest.mark.parametrize('world', [2, 4])
def test_comm_volume_is_the_bytes_on_the_wire(world):
    _, cfgs, runs = _port_runs(world)
    for cfg, ranks in zip(cfgs, runs):
        model = workers.MODELS[cfg['model']]()
        x = workers.model_input(cfg['model'], cfg['x'][:8 // world])
        pre = KFAC(variant=cfg['variant'], num_devices=world,
                   bucket_fn=workers.BUCKETS[cfg['buckets']],
                   comm_precision=cfg['comm_precision'])
        pre.setup(tcapture.collect_layer_meta(model, x))
        want = pre.plan.comm_volume(stats_reduce=pre.stats_reduce,
                                    method=pre.method,
                                    comm_precision=cfg['comm_precision'])
        scopes = {'kfac.CommunicateFactor': 'FactorComm',
                  'kfac.CommunicateInverse': 'InverseComm',
                  'kfac.Precondition': 'PredComm'}
        for out in ranks:
            got = dict.fromkeys(want, 0)
            for scope, _, _, n in out['ledger']:
                if scope in scopes:
                    got[scopes[scope]] += n
            assert got == want, (cfg['variant'], cfg['comm_precision'])


# ---------------------------------------------------------------------------
# MPD eigen and the DP variants against the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['mlp', 'tiny'])
@pytest.mark.parametrize('world', [2, 4])
def test_mpd_eigen_matches_jax_mesh(world, kind):
    (cfg, ranks), = _runs_of(_port_runs(world), model=kind, variant='eigen',
                             comm_precision='fp32')
    want, state, plan = _jax_mesh_run(cfg, world)[0]
    for r, out in enumerate(ranks):
        _assert_grads(out['steps'][0]['grads'], want, f'rank {r}')
        # the MPD factors are the global batch's: this rank's rows
        for k, rows in out['steps'][0]['factors'].items():
            per = plan.buckets[int(k)].per_dev
            np.testing.assert_allclose(
                rows, state.factors[k][r * per:(r + 1) * per], rtol=1e-4,
                atol=1e-5)
        assert out['steps'][0]['comm_err'] is None
    if kind == 'mlp' and world == 4:
        # more ranks than layers: the eigen auto rule splits A and G
        assert plan.layer_rows[0][1] // plan.buckets[16].per_dev != \
            plan.layer_rows[0][3] // plan.buckets[16].per_dev


def test_basis_refresh_matches_jax_mesh():
    """``basis_update_freq`` at world 2: MPD ``eigen`` (the decomposition
    replicated by a gather) with ``decomp_impl='subspace'``, four steps:
    a cold full decomposition, an eigenvalue-only refresh (only the
    eigenvalue vectors gathered), a warm full one, a refresh. The mesh is
    handed the port's stored decomposition before each step: inside an
    eigenvalue cluster two eigh solvers pick different bases, and the
    refresh and the warm start depend on the basis
    (``tests/test_torch_decomp_trainer.py``)."""
    cfg = dict(_cfg('mlp', 'eigen', steps=4), decomp_impl='subspace',
               basis_update_freq=2,
               phases=[(True, False), (False, False), (True, True),
                       (False, False)])
    ranks = launch.spawn(workers.run_many, 2, args=([cfg],), timeout=300)
    feeds = [s['decomp_in'] for s in ranks[0][0]['steps']]
    want = _jax_mesh_run(cfg, 2, feeds=feeds)
    for r in range(2):
        steps = ranks[r][0]['steps']
        for i, (grads, _, _) in enumerate(want):
            _assert_grads(steps[i]['grads'], grads, f'rank {r} step {i}')
            # the replicated table is the same on both ranks
            for part, tree in steps[i]['decomp_in'].items():
                for k, v in tree.items():
                    np.testing.assert_array_equal(v, feeds[i][part][k])
    # the refresh keeps the basis: the table after step 1 has step 0's
    for k, q in feeds[1]['evecs'].items():
        np.testing.assert_array_equal(feeds[2]['evecs'][k], q)
        assert not np.array_equal(feeds[2]['evals'][k], feeds[1]['evals'][k])


@pytest.mark.parametrize('variant', ['eigen_dp', 'inverse_dp'])
def test_dp_owner_local_stats_match_jax_mesh(variant):
    world = 2
    (cfg, ranks), = _runs_of(_port_runs(world), model='mlp',
                             variant=variant)
    want, state, plan = _jax_mesh_run(cfg, world)[0]
    for r, out in enumerate(ranks):
        _assert_grads(out['steps'][0]['grads'], want, f'rank {r}')
        for k, rows in out['steps'][0]['factors'].items():
            per = plan.buckets[int(k)].per_dev
            np.testing.assert_allclose(
                rows, state.factors[k][r * per:(r + 1) * per], rtol=1e-4,
                atol=1e-5)
        assert out['steps'][0]['comm_err'] is None


@pytest.mark.filterwarnings('ignore:ekfac variants')
@pytest.mark.parametrize('variant', ['ekfac', 'ekfac_dp'])
def test_ekfac_matches_jax_mesh(variant):
    """E-KFAC at world 2 over fp32, two steps (the second rotates the
    moments into a new basis): MPD 'ekfac' averages the moments over the
    ranks (one all-reduce, every rank the same moments); 'ekfac_dp' keeps
    each layer's moments on its owner, from the owner's own batch, and
    moves no moment bytes."""
    world = 2
    (cfg, ranks), = _runs_of(_port_runs(world), model='mlp', variant=variant)
    runs = _jax_mesh_run(cfg, world)
    for r, out in enumerate(ranks):
        for i, (want, state, plan) in enumerate(runs):
            _assert_grads(out['steps'][i]['grads'], want,
                          f'rank {r} step {i}')
            for k, got in out['steps'][i]['scales'].items():
                ref = state.decomp['scales'][k]
                if variant == 'ekfac_dp':
                    rows = got.shape[0]
                    ref = ref[r * rows:(r + 1) * rows]
                np.testing.assert_allclose(got, ref, rtol=1e-4,
                                           atol=1e-5 * np.abs(ref).max())
                assert np.any(got != 0)
        scopes = [scope for scope, _, _, _ in out['ledger']]
        moved = [sc for sc in scopes if 'scales' in sc]
        if variant == 'ekfac':
            assert moved == ['kfac.CommunicateFactor.scales']
        else:
            assert not moved, moved
    if variant == 'ekfac':
        for a, b in zip(ranks[0]['steps'], ranks[1]['steps']):
            for k in a['scales']:
                assert np.array_equal(a['scales'][k], b['scales'][k])


def _norm(a, b):
    return float(np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a)))


def _check_lossy_factors(ranks, jax_steps, world):
    """Each step's factor rows within the bf16 summation bound of the mesh's:
    the wires are the same, but gloo rounds each of its world - 1 partial
    sums to bf16 and the mesh the whole sum once, each rounding at most
    2^-8 of sum_r |x_r| <= world * max|F| (Cauchy-Schwarz on the
    covariances), 10% over for the EMA's carry."""
    for i, (_, state, plan) in enumerate(jax_steps):
        for r, out in enumerate(ranks):
            for k, rows in out['steps'][i]['factors'].items():
                per = plan.buckets[int(k)].per_dev
                want = state.factors[k][r * per:(r + 1) * per]
                bound = 1.1 * world * 2.0 ** -8 * np.abs(want).max()
                assert np.abs(rows - want).max() <= bound, (i, r, k)


@pytest.mark.parametrize('precision', ['bf16', 'int8'])
def test_lossy_eigen_matches_jax_mesh_and_residual_is_live(precision):
    """World 2: one addition per reduced element, so the wire sums equal
    the mesh's; a bf16 rounding of a statistic that fp32 roundoff tips
    the other way is amplified by the damped eigenbasis (damping 0.001),
    so the preconditioned gradients are held, per step and over all
    tensors, to 5% of the compression's own effect (the mesh's lossy run
    against its fp32 run) — they sit at 0.3% of it or less."""
    world = 2
    runs = _runs_of(_port_runs(world), model='mlp', variant='eigen',
                    comm_precision=precision)
    assert len(runs) == 2
    for cfg, ranks in runs:
        want = _jax_mesh_run(cfg, world)
        exact = _jax_mesh_run(dict(cfg, comm_precision='fp32'), world)
        _check_lossy_factors(ranks, want, world)
        for i in range(LOSSY_STEPS):
            effect = _norm(want[i][0], exact[i][0])
            assert effect > 1e-3
            for r, out in enumerate(ranks):
                step = out['steps'][i]
                assert _norm(step['grads'], want[i][0]) <= 0.05 * effect, \
                    (cfg['capture_impl'], i, r)
                total = sum(float(np.abs(v).sum())
                            for v in step['comm_err'].values())
                assert total > 0 and np.isfinite(total)
        # the residual is each rank's own: the ranks' residuals differ
        last = [out['steps'][-1]['comm_err'] for out in ranks]
        assert not all(np.array_equal(last[0][k], last[1][k])
                       for k in last[0])
    # K3's plain version and the three ops give the same bits
    (_, none), (_, auto) = runs
    for a, b in zip(none, auto):
        for sa, sb in zip(a['steps'], b['steps']):
            for k in sa['grads']:
                assert np.array_equal(sa['grads'][k], sb['grads'][k])
            for k in sa['comm_err']:
                assert np.array_equal(sa['comm_err'][k], sb['comm_err'][k])


@pytest.mark.parametrize('precision', ['bf16', 'int8'])
def test_lossy_eigen_world4_factors_match_jax_mesh(precision):
    """World 4 (and factor-wise distribution: 4 ranks, 2 layers): the
    partial sums are rounded in another order than the mesh's, which the
    damped eigenbasis amplifies to the size of the compression's own
    effect in the preconditioned gradients; the factor rows are held to
    the summation bound, the residual is live and the ranks agree."""
    world = 4
    (cfg, ranks), = _runs_of(_port_runs(world), model='mlp', variant='eigen',
                             comm_precision=precision, capture_impl='auto')
    _check_lossy_factors(ranks, _jax_mesh_run(cfg, world), world)
    for out in ranks:
        for step in out['steps']:
            assert all(np.isfinite(v).all() for v in step['grads'].values())
            assert sum(float(np.abs(v).sum())
                       for v in step['comm_err'].values()) > 0


@pytest.mark.parametrize('world', [2, 4])
def test_residual_absent_without_a_lossy_reduce(world):
    for cfg, ranks in _runs_of(_port_runs(world)):
        lossy_mpd = (cfg['comm_precision'] != 'fp32'
                     and cfg['variant'] in ('eigen', 'inverse'))
        for out in ranks:
            assert (out['steps'][-1]['comm_err'] is not None) == lossy_mpd


@pytest.mark.parametrize('world', [2, 4])
def test_ranks_agree_on_the_preconditioned_grads(world):
    for cfg, ranks in _runs_of(_port_runs(world)):
        for out in ranks[1:]:
            for a, b in zip(out['steps'], ranks[0]['steps']):
                assert a['loss'] == b['loss']
                for k in a['grads']:
                    assert np.array_equal(a['grads'][k], b['grads'][k]), k


# ---------------------------------------------------------------------------
# set-up pieces and the launcher
# ---------------------------------------------------------------------------

def test_kfac_checks_the_group_size():
    with pytest.raises(ValueError, match='group'):
        pre = KFAC(variant='eigen', num_devices=2)
        pre.setup(tcapture.collect_layer_meta(workers.MLP(),
                                              torch.zeros(2, 5)))
        pre.step(pre.init('cpu'), {}, {}, {})
    # the E-KFAC variants construct at any world; a replan at world>1 is
    # the elastic lane's
    pre = KFAC(variant='ekfac', num_devices=2)
    pre.setup(tcapture.collect_layer_meta(workers.MLP(), torch.zeros(2, 5)))
    with pytest.raises(NotImplementedError, match='item 13'):
        pre.replan(comm_mode='pred')


def test_shard_batch_and_init_retry():
    batch = {'input': np.arange(12).reshape(6, 2), 'label': np.arange(6)}
    parts = [tmesh.shard_batch(batch, r, 3) for r in range(3)]
    assert np.array_equal(np.concatenate([p['label'] for p in parts]),
                          batch['label'])
    with pytest.raises(ValueError, match='split'):
        tmesh.shard_batch(batch, 0, 4)
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError('Connection refused by the store')
        return 'ok'

    assert tmesh.init_with_retry(flaky, sleep=sleeps.append) == 'ok'
    assert sleeps == [1.0, 2.0]

    def broken():
        raise RuntimeError('trying to initialize the default group twice')

    with pytest.raises(RuntimeError, match='twice'):
        tmesh.init_with_retry(broken, sleep=sleeps.append)
    assert sleeps == [1.0, 2.0]
    assert tmesh.maybe_initialize_distributed('gloo', env={}) is None
    with pytest.raises(ValueError, match='WORLD_SIZE=1'):
        tmesh.maybe_initialize_distributed('gloo', 2, env={})
    with pytest.raises(RuntimeError, match='MASTER_ADDR'):
        tmesh.maybe_initialize_distributed('gloo', 2,
                                           env={'WORLD_SIZE': '2'})


def test_launcher_checks_the_world():
    assert launch.check_world(2, ['--device', 'cpu']) == \
        ['--device', 'cpu', '--num-devices', '2']
    with pytest.raises(ValueError, match='--nproc'):
        launch.check_world(2, ['--device', 'cpu', '--num-devices', '4'])
    with pytest.raises(RuntimeError, match='NCCL refuses'):
        launch.check_world(2, [], cuda_available=True, device_count=1)
    assert launch.check_world(2, ['--dist-backend', 'gloo'],
                              cuda_available=True, device_count=1)
    with pytest.raises(ValueError, match='nccl needs'):
        launch.check_world(2, ['--device', 'cpu', '--dist-backend', 'nccl'])


def test_launcher_trains_resnet20_at_world2():
    out = subprocess.run(
        [sys.executable, '-m', 'kfac_pytorch_tpu_torch.launch', '--nproc',
         '2', '--', 'train_cifar', '--device', 'cpu', '--model', 'resnet20',
         '--batch-size', '16', '--epochs', '1', '--steps-per-epoch', '3',
         '--kfac-name', 'eigen', '--kfac-comm-precision', 'bf16',
         '--kfac-capture-impl', 'auto'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'PYTHONPATH': ROOT})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    m = re.search(r'epoch 0: train_loss (\S+) val_loss (\S+)', out.stdout)
    assert m and all(np.isfinite(float(v)) for v in m.groups()), out.stdout
    assert 'replicas: 2 ranks bitwise identical' in out.stdout
    # rank 0 prints alone
    assert out.stdout.count('epoch 0:') == 1


def _guard_batches(rank_bad):
    """Five global batches of 8 (four rows a rank at world=2) of TinyCNN's
    7x7 inputs; batch 2 is NaN in ``rank_bad``'s rows only."""
    r = np.random.RandomState(4)
    out = [{'input': r.randn(8, 7, 7, 3).astype(np.float32),
            'label': r.randint(0, 10, 8).astype(np.int64)}
           for _ in range(5)]
    out[2]['input'][rank_bad * 4:(rank_bad + 1) * 4] = np.nan
    return out


def test_guard_skips_on_every_rank_at_world2():
    """NaN in rank 1's shard only: both ranks skip the batch (the screen's
    flag is all-reduced), their replicas stay bitwise equal and equal the
    world=2 control run without that batch, over the fp32 DP wire and the
    bf16 MPD reduce (K3's plain version on the guarded path)."""
    cfgs = [{'variant': v, 'comm_precision': p, 'skip': 2,
             'batches': _guard_batches(1)}
            for v, p in (('eigen_dp', 'fp32'), ('eigen', 'bf16'))]
    ranks = launch.spawn(workers.guarded_runs, 2, args=(cfgs,), timeout=300)
    for c in range(len(cfgs)):
        r0, r1 = ranks[0][c], ranks[1][c]
        for r in (r0, r1):
            assert [m['ok'] for m in r['faulted']['mets']] == [1, 1, 0, 1, 1]
            assert r['faulted']['mets'][-1]['skipped'] == 1
            assert r['faulted']['mets'][-1]['rung'] == 0
            assert r['faulted']['mets'] == r0['faulted']['mets']
            for part in ('replica', 'kfac'):
                assert r['faulted'][part] == r['control'][part], part
        assert r0['faulted']['replica'] == r1['faulted']['replica']
