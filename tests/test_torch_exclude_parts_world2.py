"""The ``exclude_parts`` ablation at world 2: the port's gloo ranks
(``tests/torch_dist_workers.py``) against JAX's 2-device CPU mesh, as
``tests/test_torch_distributed.py`` runs them (TinyCNN with BatchNorm on
7 x 7, MSE, two steps, the capture kernels' plain versions), at its
tolerance for preconditioned gradients, ``rtol=1e-3, atol=1e-4``.

- MPD ``eigen`` without CommunicateFactor: each rank's factors take its
  own statistics, no bytes in the ``kfac.CommunicateFactor`` scope; over
  the bf16 wire K3 (the lossy reduce's prep) is never called and the
  error-feedback residual stays zero, where the control run calls K3 and
  keeps a residual.
- ``eigen`` and ``eigen_dp`` without CommunicateInverse: no bytes in the
  ``kfac.CommunicateInverse`` scope nor in the preconditioned-gradient
  gather's (``kfac.Precondition``); each rank preconditions only the
  layers it owns (zeros elsewhere) and skips the KL clip, so the ranks'
  gradients differ and each is held against the same rank of the mesh
  (the first step: the mesh's state layout cannot hold the ranks' own
  decomposition rows past it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu_torch import launch, weights
from tests.test_torch_distributed import _assert_grads, _cfg, _jax_model

import torch_dist_workers as workers

STEPS = 2
#: (variant, wire, exclude_parts, the ledger scopes that must carry no
#: bytes). The fp32 runs are held against JAX's mesh; the bf16 ones show
#: the lossy reduce's K3 and residual gone with its collective (the lossy
#: wire's own numerics are tests/test_torch_distributed.py's)
WORLD2 = [('eigen', 'bf16', 'CommunicateFactor', ('kfac.CommunicateFactor',)),
          ('eigen', 'bf16', '', ()),
          ('eigen', 'fp32', 'CommunicateFactor', ('kfac.CommunicateFactor',)),
          ('eigen', 'fp32', 'CommunicateInverse', ('kfac.CommunicateInverse',)),
          ('eigen_dp', 'fp32', 'CommunicateInverse',
           ('kfac.CommunicateInverse', 'kfac.Precondition'))]


def _world2_cfg(variant, wire, parts):
    cfg = _cfg('tiny', variant, wire, capture_impl='auto', steps=STEPS)
    cfg['kfac'] = {'exclude_parts': parts}
    return cfg


@functools.lru_cache(maxsize=None)
def _port_runs():
    cfgs = [_world2_cfg(*c[:3]) for c in WORLD2]
    outs = launch.spawn(workers.exclude_parts_runs, 2, args=(cfgs,),
                        timeout=300)
    return cfgs, [[outs[r][i] for r in range(2)] for i in range(len(cfgs))]


def _jax_mesh_grads(cfg, world=2):
    """``cfg``'s steps under shard_map on ``world`` CPU devices: per step
    every rank's preconditioned grads (``[rank][name]``, numpy). Under
    the CommunicateInverse ablation each rank keeps its own decomposition
    rows where the state's layout declares them replicated, so only the
    first step (from the initial state) runs and no state comes out."""
    model, variables = _jax_model(cfg['model'])
    x, y = jnp.asarray(cfg['x']), jnp.asarray(cfg['y'])
    pre = jkfac.KFAC(variant=cfg['variant'], num_devices=world,
                     axis_name='batch', health=False,
                     bucket_fn=workers.BUCKETS[cfg['buckets']],
                     comm_precision=cfg['comm_precision'], **cfg['kfac'])
    pre.setup(jcapture.collect_layer_meta(model, variables, x))
    mesh = Mesh(np.array(jax.devices()[:world]), ('batch',))
    pspecs = pre.state_pspecs('batch')
    local = pre.exclude_communicate_inverse

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(), pspecs, P('batch'), P('batch')),
                       out_specs=(P('batch'), P() if local else pspecs))
    def step(variables, state, xs, ys):
        def loss_fn(out):
            return jnp.mean((out - ys) ** 2)
        _, _, grads, acts, gs, _ = jcapture.value_and_grad_with_capture(
            model, loss_fn, variables, xs, mutable=('batch_stats',),
            axis_name='batch')
        grads = jkfac.parallel.average_grads(grads, 'batch')
        grads, new = pre.step(state, grads, acts, gs, axis_name='batch')
        # a rank's own gradients, stacked over the ranks
        return (jax.tree.map(lambda g: g[None], grads),
                jnp.zeros(()) if local else new)

    state = pre.init()
    out = []
    for _ in range(1 if local else cfg['steps']):
        grads, state = step(variables, state, x, y)
        out.append([{k: v.numpy() for k, v in weights.params_from_jax(
            jax.tree.map(lambda g, r=r: np.asarray(g[r]), grads)).items()}
            for r in range(world)])
    return out


@pytest.mark.parametrize('case', range(len(WORLD2)),
                         ids=[f'{c[0]}-{c[1]}-{c[2] or "none"}'
                              for c in WORLD2])
def test_world2_matches_jax_mesh(case):
    variant, wire, parts, silent = WORLD2[case]
    cfgs, runs = _port_runs()
    cfg, ranks = cfgs[case], runs[case]
    for rank in ranks:
        scopes = {scope for scope, _, _, n in rank['ledger'] if n}
        assert not any(s.startswith(x) for s in scopes for x in silent), \
            scopes
        if not parts:
            assert any(s.startswith('kfac.CommunicateFactor')
                       for s in scopes), scopes
        for step in rank['steps']:
            for g in step['grads'].values():
                assert np.isfinite(g).all()
    if wire == 'bf16':
        for r in ranks:
            assert (r['k3_calls'] == 0) == bool(parts), r['k3_calls']
            assert all(bool(v.any()) != bool(parts)
                       for v in r['steps'][-1]['comm_err'].values())
        return
    want = _jax_mesh_grads(cfg)
    for i, per_rank in enumerate(want):
        for r, rank in enumerate(ranks):
            _assert_grads(rank['steps'][i]['grads'], per_rank[r],
                          f'{variant} {parts} step {i} rank {r}')
    if parts == 'CommunicateInverse':
        # each rank preconditions its own layers only
        g0, g1 = (rank['steps'][0]['grads'] for rank in ranks)
        assert any(not np.array_equal(g0[k], g1[k]) for k in g0)
