"""The port's compression-aware collectives (``parallel/collectives.py``)
and K3's plain version against the JAX package, on gloo process groups
of 2 and 4 CPU processes (``launch.spawn``; the ranks import no JAX).

Contracts, from ``tests/test_comm_precision.py`` and
``tests/test_pallas_capture.py``:

- the fp32 reduce-scatter equals pmean + the rank's own rows;
- the bf16 error-feedback residual is bitwise ``(x+r) - f32(bf16(x+r))``
  (the JAX algebra, bit for bit), stays bounded over 8 reduces, and its
  time average beats the residual-free reduce; int8 reduces on the bf16
  wire; the bf16 reduce equals the JAX mesh's at world 2 (one addition)
  and is within world-1 bf16 roundings of it at world 4 (summation
  order);
- compressed gathers: bf16 exact to bf16 rounding, int8 within
  absmax/254 per row, and their bytes as ``FactorPlan.comm_volume``
  counts them;
- ``quantize_rows`` and ``_ef_quantize_plain`` bitwise against JAX
  (``ef_quantize(interpret=True)`` and the two-pass algebra) on ties,
  overflow, infinities and NaN (as a mask), and against numpy's fp32
  algebra (``ml_dtypes`` bf16) everywhere, subnormals included: XLA's
  CPU flushes subnormal arithmetic to zero, the port does not;
- ``group=None`` is a bitwise identity for every ``comm_precision``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kfac_pytorch_tpu.ops import pallas_capture as jpc
from kfac_pytorch_tpu.parallel import collectives as jcoll
from kfac_pytorch_tpu_torch import launch
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
from kfac_pytorch_tpu_torch.parallel import collectives as coll

import torch_dist_workers as workers

torch.set_num_threads(2)

SEED = 5


@pytest.fixture(scope='module', params=[2, 4])
def ranks(request):
    world = request.param
    return world, launch.spawn(workers.collective_cases, world,
                               args=(SEED,), timeout=300)


def _inputs(world):
    return workers.collective_inputs(world, SEED)


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_reduce_scatter_is_pmean_plus_own_rows(ranks):
    world, outs = ranks
    xs, _, _ = _inputs(world)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o['scatter'], o['pmean_rows'], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(o['scatter'],
                                   xs.mean(0)[r * 4:(r + 1) * 4], rtol=1e-6,
                                   atol=1e-6)


def test_ef_residual_algebra(ranks):
    world, outs = ranks
    _, near_one, _ = _inputs(world)
    for r, o in enumerate(outs):
        # the first residual is the JAX algebra's, bit for bit
        want = near_one[r] - _bf16(near_one[r])
        assert np.array_equal(o['r1'], want)
        assert np.abs(o['rk']).max() <= np.abs(want).max() * 4 + 1e-7
        true_mean = near_one.mean(0)[r * 4:(r + 1) * 4]
        e_ef = np.abs(o['ef_mean'] - true_mean).mean()
        e_ne = np.abs(o['ne_mean'] - true_mean).mean()
        assert e_ef < e_ne, (e_ef, e_ne)
        # int8 floors to the bf16 wire on the reduce
        assert np.array_equal(o['int8_once'], o['bf16_once'])


def test_bf16_reduce_matches_jax_mesh(ranks):
    world, outs = ranks
    _, near_one, _ = _inputs(world)
    mesh = Mesh(np.array(jax.devices()[:world]), ('x',))

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P('x'),
                       out_specs=P('x'))
    def f(xs):
        m, _ = jcoll.pmean_scatter_ef(xs[0], 'x', 'bf16',
                                      jnp.zeros_like(xs[0]))
        return m[None]

    want = np.asarray(f(jnp.asarray(near_one)))
    for r, o in enumerate(outs):
        if world == 2:
            assert np.array_equal(o['bf16_once'], want[r])
        else:
            # summation order: gloo rounds each of its world - 1 partial
            # sums to bf16, the JAX mesh the whole sum once: each rounding
            # is at most half a bf16 ulp (2^-8) of sum_r |x_r|
            tol = 2.0 ** -8 * np.abs(_bf16(near_one)).sum(0)[
                r * 4:(r + 1) * 4]
            assert np.all(np.abs(o['bf16_once'] - want[r]) <= tol)


def test_compressed_gathers(ranks):
    world, outs = ranks
    _, _, gath = _inputs(world)
    full = gath.reshape(world * 2, 6, 6)
    for o in outs:
        assert np.array_equal(o['gather_fp32'], full)
        assert np.array_equal(o['gather_bf16'], _bf16(full))
        absmax = np.abs(full).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(o['gather_int8'] - full) <= absmax / 254 + 1e-12)
        # bytes on the wire: the gathered payload in the wire dtype, int8
        # with its [rows] fp32 scales
        rows = world * 2
        assert o['gather_ledger'] == [
            ('all_gather', 'torch.float32', rows * 36 * 4),
            ('all_gather', 'torch.uint8', rows * 36 * 2),
            ('all_gather', 'torch.int8', rows * 36),
            ('all_gather', 'torch.float32', rows * 4)]
        np.testing.assert_allclose(
            o['wire_mean_bf16'], _inputs(world)[0].mean(0), rtol=2e-2,
            atol=2e-2)


def test_psum_and_decomposition_gather(ranks):
    world, outs = ranks
    xs, _, gath = _inputs(world)
    full = gath.reshape(world * 2, 6, 6)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o['psum'], xs.sum(0), rtol=1e-6,
                                   atol=1e-6)
        got = o['gather_decomp_True']
        assert np.array_equal(got['evecs']['6'], _bf16(full))
        assert np.array_equal(got['evals']['6'], _bf16(full[:, 0]))
        placed = o['gather_decomp_False']['evecs']['6']
        want = np.zeros_like(full)
        want[r * 2:(r + 1) * 2] = gath[r]
        assert np.array_equal(placed, want)


def test_loss_convention_guard(ranks):
    _, outs = ranks
    assert [o['guard'] for o in outs] == ['raised'] * len(outs)


def _flushed(*arrays):
    """Where any array holds a subnormal: XLA's CPU flushes subnormal
    arithmetic to zero, numpy and the port (on the CPU and the card) do
    not, so there JAX is no oracle and numpy is."""
    tiny = np.finfo(np.float32).tiny
    out = np.zeros(np.shape(arrays[0]), bool)
    for a in arrays:
        a = np.abs(np.asarray(a, np.float32))
        out |= (a > 0) & (a < tiny)
    return out


def test_quantize_rows_bitwise_with_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 7, 7) * np.array([1e-3, 1.0, 50.0, 0.0, 3.0, 1e-40]
                                        )[:, None, None]).astype(np.float32)
    x[1, 0, 0] = np.abs(x[1]).max() / 127 * 2.5   # a half-way tie of round()
    q, s = coll.quantize_rows(torch.from_numpy(x))
    jq, js = jcoll.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    # numpy's fp32 algebra everywhere; JAX on the rows without subnormals
    absmax = np.abs(x).max(axis=(1, 2))
    scale = absmax / np.float32(127.0)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    nq = np.clip(np.round(x / safe[:, None, None]), -127, 127).astype(np.int8)
    assert np.array_equal(q.numpy(), nq) and np.array_equal(s.numpy(), scale)
    normal = ~_flushed(x).any(axis=(1, 2))
    assert normal.sum() == 5
    assert np.array_equal(q.numpy()[normal], np.asarray(jq)[normal])
    assert np.array_equal(s.numpy()[normal], np.asarray(js)[normal])
    back = coll.dequantize_rows(q, s)
    assert np.array_equal(back.numpy()[normal], np.asarray(
        jcoll.dequantize_rows(jq, js))[normal])
    assert np.all(back.numpy()[3] == 0)


def _special(shape, seed):
    """fp32 ``(x, r)`` with bf16 ties, values past bf16's largest finite,
    +-Inf, subnormals and NaN mixed into normal draws."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    r = (rng.randn(*shape) * 1e-3).astype(np.float32)
    flat_x, flat_r = x.reshape(-1), r.reshape(-1)
    n = flat_x.size
    picks = rng.permutation(n)[:min(n, 12)]
    # exact ties: 1 + 2^-8 lies halfway between two bf16 values
    specials = [(1.0 + 2.0 ** -8, 0.0), (1.0 + 3 * 2.0 ** -8, 0.0),
                (3.3961e38, 0.0), (-3.3961e38, 0.0), (np.inf, 0.0),
                (-np.inf, 1.0), (1e-40, 0.0), (-3e-39, 1e-41),
                (np.nan, 0.0), (0.5, np.nan), (3.4e38, 3.4e38),
                (0.0, -0.0)]
    for i, (a, b) in zip(picks, specials):
        flat_x[i], flat_r[i] = a, b
    return x, r


def _bits(wire, nr):
    """``(wire int16 bits, residual int32 bits, NaN mask)``; the bits of
    a NaN entry are zeroed (NaN payloads are not part of the contract)."""
    wire, nr = np.asarray(wire), np.asarray(nr, np.float32)
    nan = np.isnan(nr)
    wb = wire.view(np.int16).copy()
    rb = nr.view(np.int32).copy()
    wb[nan], rb[nan] = 0, 0
    return wb, rb, nan


@pytest.mark.parametrize('shape', [(6, 16, 16), (3, 5, 7), (1,), (2, 3)])
def test_ef_quantize_plain_bitwise_with_jax(shape):
    import ml_dtypes
    x, r = _special(shape, seed=sum(shape))
    with np.errstate(all='ignore'):
        wire, nr = ck._ef_quantize_plain(torch.from_numpy(x),
                                         torch.from_numpy(r))
        # the two-pass algebra in numpy (exact bf16 rounding, no flush)
        xc = x + r
        nwire = xc.astype(ml_dtypes.bfloat16)
        nnr = xc - nwire.astype(np.float32)
        # in JAX, and JAX's Pallas kernel in interpret mode (as its own
        # tests run it)
        jxc = jnp.asarray(x) + jnp.asarray(r)
        jwire = jxc.astype(jnp.bfloat16)
        jax_runs = [(jwire, jxc - jwire.astype(jnp.float32))]
        if len(shape) == 3:
            jax_runs.append(jpc.ef_quantize(jnp.asarray(x), jnp.asarray(r),
                                            interpret=True))
    assert wire.dtype == torch.bfloat16 and nr.dtype == torch.float32
    wb, rb, nan = _bits(wire.view(torch.int16).numpy(), nr.numpy())
    nwb, nrb, nnan = _bits(nwire, nnr)
    assert np.array_equal(nan, nnan)
    assert np.array_equal(wb, nwb) and np.array_equal(rb, nrb)
    keep = ~_flushed(x, r, xc, nnr)
    assert keep.sum() >= x.size - 2
    for jw, jr in jax_runs:
        jwb, jrb, jnan = _bits(np.asarray(jw), np.asarray(jr))
        assert np.array_equal(nan[keep], jnan[keep])
        assert np.array_equal(wb[keep], jwb[keep])
        assert np.array_equal(rb[keep], jrb[keep])


@pytest.mark.parametrize('variant', ['eigen', 'eigen_dp'])
def test_group_none_is_identity_for_every_precision(variant):
    rng = np.random.RandomState(0)
    w = {'fc1.weight': rng.randn(8, 5).astype(np.float32) * 0.4,
         'fc1.bias': np.zeros(8, np.float32),
         'fc2.weight': rng.randn(3, 8).astype(np.float32) * 0.3,
         'fc2.bias': np.zeros(3, np.float32)}
    base = dict(model='mlp', state_dict=w, buckets='16', variant=variant,
                x=rng.randn(8, 5).astype(np.float32),
                y=rng.randn(8, 3).astype(np.float32), steps=5, sgd=True)
    runs = {p: workers.run_steps(0, 1, None, dict(base, comm_precision=p))
            for p in ('fp32', 'bf16', 'int8')}
    for p in ('bf16', 'int8'):
        for got, want in zip(runs[p]['steps'], runs['fp32']['steps']):
            assert got['loss'] == want['loss']
            for k in want['grads']:
                assert np.array_equal(got['grads'][k], want['grads'][k])
        assert runs[p]['ledger'] == []
        # the residual exists (the lossy MPD config tracks one) and stays
        # zero: no reduce ran
        err = runs[p]['steps'][-1]['comm_err']
        if variant == 'eigen':
            assert all(not v.any() for v in err.values())
        else:
            assert err is None
