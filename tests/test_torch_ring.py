"""Ring and Ulysses attention over a process group against the JAX
package's ``ring_attention``/``ulysses_attention`` in ``jax.shard_map``.

The sequence axis of seeded ``[B, H, L, D]`` q/k/v and a ``[B, L]`` key
mask (key 0 always attended, so no row is fully masked: such a row's
result depends on the block sizes, in JAX too) is split over 2 and 4
gloo ranks (``tests/torch_dist_workers.ring_cases``, one spawn a world
size) and over a 'seq' mesh of as many CPU devices. Held to the JAX
tests' tolerances (``tests/test_ring_attention.py``): 2e-5 for the
outputs, 5e-4 for the q/k/v gradients of ``sum(out ** 2)``:

- ring and Ulysses, causal with the key mask, the ring non-causal, and
  Ulysses causal without a mask; the plain blocks ('xla') and the
  kernels' blocks ('auto': K4/K5's plain versions on CPU tensors);
- the 'pallas' block path against JAX's ring with its interpreted Pallas
  blocks (``test_pallas_attention.py::test_ring_with_pallas_blocks_
  matches_dense``'s shapes);
- the blocks the causal mask skips entirely: with only rank 0's output in
  the loss, every gradient on the other ranks comes from such blocks and
  is exactly 0, and an all-masked ring gives finite outputs and
  gradients;
- Ulysses raises ValueError when the heads do not divide over the ranks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from kfac_pytorch_tpu_torch import launch

import torch_dist_workers as workers

# the JAX package's ``parallel`` re-exports the function over its module
jring = importlib.import_module('kfac_pytorch_tpu.parallel.ring_attention')

B, H, L, D = 2, 4, 32, 8
VAL_TOL, GRAD_TOL = 2e-5, 5e-4
#: name -> (impl, causal, key mask, block_impl)
CASES = {'ring_causal_mask': ('ring', True, True, 'xla'),
         'ring_causal_mask_kernels': ('ring', True, True, 'auto'),
         'ring_mask': ('ring', False, True, 'auto'),
         'ulysses_causal_mask': ('ulysses', True, True, 'auto'),
         'ulysses_causal': ('ulysses', True, False, 'xla')}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    mask = rng.rand(B, L) > 0.3
    mask[:, 0] = True
    return {'q': q, 'k': k, 'v': v, 'mask': mask}


def _jax_case(n, impl, causal, masked, block_impl, inp):
    """JAX's sharded attention on ``n`` devices: the output and the q/k/v
    gradients of ``sum(out ** 2)``."""
    mesh = Mesh(np.array(jax.devices()[:n]), ('seq',))
    spec = P(None, None, 'seq', None)
    fn = jring.ring_attention if impl == 'ring' else jring.ulysses_attention

    def local(q, k, v, m):
        return fn(q, k, v, 'seq', causal=causal,
                  kv_mask=(m > 0.5) if masked else None,
                  block_impl=block_impl)

    sharded = jax.shard_map(local, mesh=mesh,
                            in_specs=(spec,) * 3 + (P(None, 'seq'),),
                            out_specs=spec,
                            check_vma=block_impl != 'pallas_interpret')
    args = [jnp.asarray(inp[x]) for x in 'qkv'] + [
        jnp.asarray(inp['mask'].astype(np.float32))]

    @jax.jit
    def value_and_grads(q, k, v, m):
        out = sharded(q, k, v, m)
        return out, jax.grad(lambda q, k, v: (sharded(q, k, v, m) ** 2)
                             .sum(), argnums=(0, 1, 2))(q, k, v)

    out, grads = value_and_grads(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _gather(results, name):
    """Every rank's output and gradients, concatenated along L."""
    return [np.concatenate([r[name][i] for r in results], axis=2)
            for i in range(4)]


def _assert_matches(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = VAL_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def _pallas_inputs():
    """``test_pallas_attention.py::test_ring_with_pallas_blocks_matches_
    dense``'s shapes (B 2, H 2, L 64), causal, no mask."""
    rng = np.random.RandomState(2)
    shape = (2, 2, 64, D)
    inp = {x: rng.randn(*shape).astype(np.float32) for x in 'qkv'}
    inp['mask'] = np.ones(shape[:1] + shape[2:3], bool)
    return inp


@pytest.fixture(scope='module')
def runs():
    """Every case of CASES at 2 and 4 ranks, and at 4 ranks the 'pallas'
    block path on :func:`_pallas_inputs` (one spawn a world size)."""
    inp = _inputs()
    cfgs = {2: [{**inp, 'cases': CASES}],
            4: [{**inp, 'cases': CASES},
                {**_pallas_inputs(), 'cases': {
                    'pallas': ('ring', True, False, 'pallas')}}]}
    res = {}
    for n, cfg in cfgs.items():
        ranks = launch.spawn(workers.ring_cases_of, n, args=(cfg,),
                             timeout=300)
        res[n] = [r[0] for r in ranks]
        if n == 4:
            res['pallas'] = [r[1] for r in ranks]
    return inp, res


@pytest.mark.parametrize('n', [2, 4])
def test_ring_and_ulysses_match_jax(runs, n):
    inp, res = runs
    for name, (impl, causal, masked, _) in CASES.items():
        # JAX's plain blocks: the kernels' plain versions must equal them
        want = _jax_case(n, impl, causal, masked, 'xla', inp)
        _assert_matches(_gather(res[n], name), want)


def test_pallas_blocks_match_jax_interpreted(runs):
    """The 'pallas' block path (K4/K5's plain versions on CPU tensors)
    against JAX's ring with interpreted Pallas blocks, on 4 ranks."""
    _, res = runs
    want = _jax_case(4, 'ring', True, False, 'pallas_interpret',
                     _pallas_inputs())
    _assert_matches(_gather(res['pallas'], 'pallas'), want)


def test_skipped_blocks_give_exact_zeros(runs):
    _, res = runs
    for n in (2, 4):
        ranks = res[n]
        for r, out in enumerate(ranks):
            _, dq, dk, dv = out['rank0_loss']
            for g in (dq, dk, dv):
                assert np.isfinite(g).all()
                if r > 0:
                    # only skipped blocks reach these ranks' shards
                    assert not g.any(), (n, r)
            assert all(np.isfinite(t).all() for t in out['all_masked'])
        # rank 0's own shard takes a gradient
        assert ranks[0]['rank0_loss'][1].any()


def test_ulysses_rejects_indivisible_heads(runs):
    _, res = runs
    for n in (2, 4):
        for out in res[n]:
            assert out['indivisible'] is not None
            assert 'ulysses' in out['indivisible'], out['indivisible']

