"""The port's linear algebra (ops/linalg.py), factor plan (plan.py) and
layer discovery (capture.py) against the JAX package's.

Eigendecompositions are compared by reconstruction and eigenvalues, not
raw eigenvectors (their signs and the order within a degenerate cluster
are free); tolerances are fp32 solver differences on well-conditioned
inputs. The masking, padding and clamp ops and the plan's tables are
held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import engine as jengine
from kfac_pytorch_tpu import plan as jplan
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.ops import linalg as jlinalg
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import engine as tengine
from kfac_pytorch_tpu_torch import plan as tplan
from kfac_pytorch_tpu_torch.models import cifar_resnet as tresnet
from kfac_pytorch_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(2)


def _spd(seed, n=6, d=12):
    r = np.random.RandomState(seed)
    x = r.randn(n, d, 3 * d).astype(np.float32)
    return (x @ x.transpose(0, 2, 1) / (3 * d)
            + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)


def test_sym_eig_reconstructs_and_matches_jax_eigenvalues():
    x = _spd(0)
    d, q = tlinalg.sym_eig(torch.from_numpy(x))
    recon = (q * d[:, None, :]) @ q.mT
    np.testing.assert_allclose(recon.numpy(), x, rtol=1e-5, atol=1e-5)
    eye = np.broadcast_to(np.eye(x.shape[-1]), x.shape)
    np.testing.assert_allclose((q.mT @ q).numpy(), eye, atol=1e-5)
    dj, _ = jlinalg.sym_eig(jnp.asarray(x), impl='xla')
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(NotImplementedError):
        tlinalg.sym_eig(torch.from_numpy(x), impl='subspace')


def test_psd_inverse_matches_jax():
    x = _spd(1)
    got = tlinalg.psd_inverse(torch.from_numpy(x)).numpy()
    want = np.asarray(jlinalg.psd_inverse(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _asymmetric_stat(seed, n=3, rows=96, d=144):
    """The unfused bf16 statistic ``x^T round_bf16(x / rows) + 0.1 I``
    (``[n, d, d]``): its two triangles round apart (by ~1e-3 here)."""
    x = _bf16(np.random.RandomState(seed).randn(n, rows, d)
              .astype(np.float32))
    stat = x.transpose(0, 2, 1) @ _bf16(x / np.float32(rows))
    return (stat + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize('fn', ['sym_eig', 'psd_inverse'])
def test_decomposes_the_symmetrized_input_as_jax(fn):
    # jnp.linalg.eigh/cholesky symmetrize their input; torch's read one
    # triangle, which alone parts from JAX by 1.2e-3 (eigenvalues) and
    # 3.4e-3 (inverse, of its largest entry) on this input
    x = _asymmetric_stat(4)
    assert np.abs(x - x.transpose(0, 2, 1)).max() > 1e-4
    if fn == 'sym_eig':
        got = tlinalg.sym_eig(torch.from_numpy(x))[0].numpy()
        want = np.asarray(jlinalg.sym_eig(jnp.asarray(x), impl='xla')[0])
        err = np.abs(got - want).max()
        assert err <= 1e-5, err
    else:
        got = tlinalg.psd_inverse(torch.from_numpy(x)).numpy()
        want = np.asarray(jlinalg.psd_inverse(jnp.asarray(x)))
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_elementwise_ops_match_jax_exactly():
    x = _spd(2, n=3, d=5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert np.array_equal(tlinalg.identity_pad(xt, 8).numpy(),
                          np.asarray(jlinalg.identity_pad(xj, 8)))
    dims = np.array([5, 3, 1], np.int32)
    assert np.array_equal(
        tlinalg.masked_trace(tlinalg.identity_pad(xt, 8),
                             torch.from_numpy(dims)).numpy(),
        np.asarray(jlinalg.masked_trace(jlinalg.identity_pad(xj, 8),
                                        jnp.asarray(dims))))
    vals = np.array([0.5, 0.25, 2.0], np.float32)
    assert np.array_equal(
        tlinalg.add_scaled_identity(xt, torch.from_numpy(vals)).numpy(),
        np.asarray(jlinalg.add_scaled_identity(xj, jnp.asarray(vals))))
    ev = np.array([-1e-3, 0.0, 1e-12, 1e-9, 3.0], np.float32)
    assert np.array_equal(
        tlinalg.clamp_eigvals(torch.from_numpy(ev), 1e-10).numpy(),
        np.asarray(jlinalg.clamp_eigvals(jnp.asarray(ev), 1e-10)))


def test_default_bucket_fn_matches_jax():
    for dim in range(1, 3000, 7):
        assert tplan.default_bucket_fn(dim) == jplan.default_bucket_fn(dim)
    # the ResNet-32 factor dims land on 128/192/384/768
    assert [tplan.default_bucket_fn(d) for d in
            (27, 144, 288, 576, 65, 16, 32, 64, 10)] == \
        [128, 192, 384, 768, 128, 128, 128, 128, 128]


@pytest.fixture(scope='module')
def resnet20_metas():
    jmodel = jresnet.resnet20()
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax.eval_shape(
        lambda: jcapture.init(jmodel, jax.random.PRNGKey(0), x))
    jmetas = jcapture.collect_layer_meta(jmodel, variables, x)
    tmetas = tcapture.collect_layer_meta(
        tresnet.resnet20(), torch.zeros((1, 3, 32, 32)))
    return jmetas, tmetas


def test_layer_discovery_matches_jax(resnet20_metas):
    jmetas, tmetas = resnet20_metas
    assert list(tmetas) == list(jmetas)
    for name, jm in jmetas.items():
        tm = tmetas[name]
        for field in ('path', 'kind', 'use_bias', 'in_dim', 'out_dim',
                      'kernel_shape', 'kernel_size', 'strides', 'padding'):
            assert getattr(tm, field) == getattr(jm, field), (name, field)


def test_build_plan_matches_jax(resnet20_metas):
    jmetas, tmetas = resnet20_metas
    jp = jplan.build_plan(jmetas, num_devices=1, comm_mode='pred')
    tp = tplan.build_plan(tmetas, num_devices=1, comm_mode='pred')
    assert tp.bucket_dims == jp.bucket_dims
    assert tp.layer_rows == jp.layer_rows
    assert tp.local_flat_offsets == jp.local_flat_offsets
    for bdim in jp.bucket_dims:
        jb, tb = jp.buckets[bdim], tp.buckets[bdim]
        assert (tb.per_dev, tb.n_rows) == (jb.per_dev, jb.n_rows)
        assert [None if s is None else (s.layer_idx, s.side, s.dim, s.owner)
                for s in tb.slot_of_row] == \
            [None if s is None else (s.layer_idx, s.side, s.dim, s.owner)
             for s in jb.slot_of_row]
        for f in ('true_dims', 'valid', 'mate_flat', 'own_dim', 'mate_dim',
                  'side_is_a'):
            assert np.array_equal(getattr(tb, f), getattr(jb, f)), (bdim, f)
    assert len(tp.pred_groups) == len(jp.pred_groups)
    for tg, jg in zip(tp.pred_groups, jp.pred_groups):
        assert (tg.dg, tg.da, tg.k_per_dev) == (jg.dg, jg.da, jg.k_per_dev)
        for f in ('layer_idx', 'row_a', 'row_g', 'local_member',
                  'local_valid', 'local_row_a', 'local_row_g',
                  'gathered_row'):
            assert np.array_equal(getattr(tg, f), getattr(jg, f)), f


@pytest.mark.parametrize('method', ['eigh', 'cholesky'])
def test_decomposition_preconditions_like_jax(resnet20_metas, method):
    # damped decomposition + pred on random SPD factors for the first
    # resnet20 layers and its head (small exact-size buckets keep the CPU
    # eigh cheap): the preconditioned gradients compare (sign/order-free)
    jmetas, tmetas = resnet20_metas
    keep = list(jmetas)[:3] + list(jmetas)[-1:]
    exact = lambda d: d  # noqa: E731
    jp = jplan.build_plan({k: jmetas[k] for k in keep}, num_devices=1,
                          comm_mode='pred', bucket_fn=exact)
    tp = tplan.build_plan({k: tmetas[k] for k in keep}, num_devices=1,
                          comm_mode='pred', bucket_fn=exact)
    r = np.random.RandomState(3)
    factors = {}
    for bdim in jp.bucket_dims:
        b = jp.buckets[bdim]
        x = r.randn(b.n_rows, bdim, 2 * bdim).astype(np.float32)
        factors[str(bdim)] = (x @ x.transpose(0, 2, 1) / (2 * bdim)
                              ).astype(np.float32)
    grads = [r.randn(*m.grad_shape).astype(np.float32) for m in tp.metas]
    damping = np.float32(0.1)
    # compiled once: JAX's eager dispatch of these ops costs more here
    jpred = jax.jit(lambda f, g: jengine.compute_pred_local(
        jp, jengine.compute_decomposition(jp, f, damping, method, 1e-10,
                                          None, impl='xla'),
        g, damping, method, None))(
            {k: jnp.asarray(v) for k, v in factors.items()},
            [jnp.asarray(g) for g in grads])
    tdec = tengine.compute_decomposition(
        tp, {k: torch.from_numpy(v) for k, v in factors.items()},
        torch.tensor(damping), method, 1e-10)
    tpred = tengine.compute_pred_local(
        tp, tdec, [torch.from_numpy(g) for g in grads], torch.tensor(damping),
        method)
    for t, j in zip(tpred, jpred):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-4)
