"""The port's factor ops and the plain versions of its capture kernels
(kfac_pytorch_tpu_torch/ops/factors.py, ops/capture_kernels.py on CPU
tensors) against the JAX package's ops/factors.py and its Pallas capture
kernels run in interpret mode, on the same numpy inputs.

Tolerances: the ops are the same elementwise scalings in the same order
and dtype, so they differ only in the covariance matmul's fp32 summation
order (XLA's vs PyTorch's). An entry F_ij sums terms u_ri w_rj, and a
reordered sum moves by a few roundings of sum_r |u_ri w_rj|, which
Cauchy-Schwarz bounds by sqrt(F_ii F_jj): the tolerance is
|port - jax| <= 1e-6 * sqrt(F_ii F_jj) + 1e-5 * |jax|. Patch extraction
and the EMA combine are exact copies of the JAX arithmetic and are held
bitwise; the EMA epilogue against the Pallas kernel keeps that kernel's
2-ulp contract (tests/test_pallas_capture.py) on top of the statistic's
own summation difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.ops import factors as jf
from kfac_pytorch_tpu.ops import pallas_capture as jpc
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
from kfac_pytorch_tpu_torch.ops import factors as tf

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _rng(seed):
    return np.random.RandomState(seed)


def _both(x, dtype='float32'):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))


def assert_factor_close(got, want):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.sqrt(np.abs(np.diagonal(want)))
    bound = ATOL * d[:, None] * d[None, :] + RTOL * np.abs(want)
    err = np.abs(got - want)
    assert np.all(err <= bound), float(np.max(err - bound))


PADDINGS = ['SAME', 'VALID', (1, 1), ((1, 2), (0, 1))]


@pytest.mark.parametrize('strides', [(1, 1), (2, 2)])
@pytest.mark.parametrize('padding', PADDINGS)
def test_extract_patches_exact(strides, padding):
    xj, xt = _both(_rng(5).randn(4, 9, 9, 3))
    want = jf.extract_patches(xj, (3, 3), strides, padding)
    got = tf.extract_patches(xt, (3, 3), strides, padding)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('use_bias', [True, False])
@pytest.mark.parametrize('strides', [(1, 1), (2, 2)])
@pytest.mark.parametrize('padding', PADDINGS)
def test_a_conv(use_bias, strides, padding):
    xj, xt = _both(_rng(5).randn(4, 9, 9, 3))
    ref = jf.compute_a_conv(xj, (3, 3), strides, padding, use_bias)
    assert_factor_close(tf.compute_a_conv(xt, (3, 3), strides, padding,
                                          use_bias), ref)
    # K1's plain version (CPU tensor) against the Pallas kernel
    pal = jpc.compute_a_conv(xj, (3, 3), strides, padding, use_bias,
                             interpret=True)
    assert_factor_close(ck.compute_a_conv(xt, (3, 3), strides, padding,
                                          use_bias), pal)


def test_a_conv_rect_kernel():
    xj, xt = _both(_rng(6).randn(3, 8, 10, 2))
    pal = jpc.compute_a_conv(xj, (1, 3), (1, 2), 'SAME', True,
                             interpret=True)
    assert_factor_close(ck.compute_a_conv(xt, (1, 3), (1, 2), 'SAME', True),
                        pal)


@pytest.mark.parametrize('use_bias', [True, False])
def test_a_dense(use_bias):
    xj, xt = _both(_rng(1).randn(32, 12))
    assert_factor_close(tf.compute_a_dense(xt, use_bias),
                        jf.compute_a_dense(xj, use_bias))
    assert_factor_close(ck.compute_a_dense(xt, use_bias),
                        jpc.compute_a_dense(xj, use_bias, interpret=True))


def test_a_dense_seq_mean():
    xj, xt = _both(_rng(2).randn(8, 6, 10))
    assert_factor_close(ck.compute_a_dense(xt, True),
                        jpc.compute_a_dense(xj, True, interpret=True))


@pytest.mark.parametrize('batch_averaged', [True, False])
def test_g_dense(batch_averaged):
    xj, xt = _both(_rng(3).randn(32, 9))
    assert_factor_close(tf.compute_g_dense(xt, batch_averaged),
                        jf.compute_g_dense(xj, batch_averaged))
    assert_factor_close(ck.compute_g_dense(xt, batch_averaged),
                        jpc.compute_g_dense(xj, batch_averaged,
                                            interpret=True))


@pytest.mark.parametrize('batch_averaged', [True, False])
def test_g_conv(batch_averaged):
    xj, xt = _both(_rng(4).randn(4, 5, 5, 7))
    assert_factor_close(tf.compute_g_conv(xt, batch_averaged),
                        jf.compute_g_conv(xj, batch_averaged))
    assert_factor_close(ck.compute_g_conv(xt, batch_averaged),
                        jpc.compute_g_conv(xj, batch_averaged,
                                           interpret=True))


@pytest.mark.parametrize('kind', ['a_conv', 'a_dense', 'g_conv'])
def test_bf16_inputs(kind):
    # bf16 activations: every scaling rounds to bf16 in both packages,
    # the covariance accumulates in fp32
    r = _rng(7)
    if kind == 'a_conv':
        xj, xt = _both(r.randn(4, 9, 9, 3), 'bfloat16')
        ref = jf.compute_a_conv(xj, (3, 3), (2, 2), 'SAME', True)
        got = ck.compute_a_conv(xt, (3, 3), (2, 2), 'SAME', True)
    elif kind == 'a_dense':
        xj, xt = _both(r.randn(32, 12), 'bfloat16')
        ref = jf.compute_a_dense(xj, True)
        got = ck.compute_a_dense(xt, True)
    else:
        xj, xt = _both(r.randn(4, 5, 5, 7), 'bfloat16')
        ref = jf.compute_g_conv(xj, True)
        got = ck.compute_g_conv(xt, True)
    assert got.dtype == torch.float32
    assert_factor_close(got, ref)


def test_update_running_avg_bitwise():
    r = _rng(8)
    new, cur = r.randn(7, 7).astype(np.float32), r.randn(7, 7).astype(
        np.float32)
    want = jf.update_running_avg(jnp.asarray(new), jnp.asarray(cur), 0.95)
    got = tf.update_running_avg(torch.from_numpy(new), torch.from_numpy(cur),
                                0.95)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('kind', ['a_dense', 'a_conv', 'g_dense', 'g_conv'])
def test_ema_epilogue(kind):
    r = _rng(9)
    if kind == 'a_dense':
        xj, xt = _both(r.randn(16, 10))
        run_j = lambda ema: jpc.compute_a_dense(xj, True, ema=ema,  # noqa
                                                interpret=True)
        run_t = lambda ema: ck.compute_a_dense(xt, True, ema=ema)  # noqa
        f = 11
    elif kind == 'a_conv':
        xj, xt = _both(r.randn(3, 7, 7, 2))
        run_j = lambda ema: jpc.compute_a_conv(  # noqa
            xj, (3, 3), (1, 1), 'SAME', True, ema=ema, interpret=True)
        run_t = lambda ema: ck.compute_a_conv(  # noqa
            xt, (3, 3), (1, 1), 'SAME', True, ema=ema)
        f = 19
    elif kind == 'g_dense':
        xj, xt = _both(r.randn(16, 6))
        run_j = lambda ema: jpc.compute_g_dense(xj, True, ema=ema,  # noqa
                                                interpret=True)
        run_t = lambda ema: ck.compute_g_dense(xt, True, ema=ema)  # noqa
        f = 6
    else:
        xj, xt = _both(r.randn(3, 5, 5, 4))
        run_j = lambda ema: jpc.compute_g_conv(xj, True, ema=ema,  # noqa
                                               interpret=True)
        run_t = lambda ema: ck.compute_g_conv(xt, True, ema=ema)  # noqa
        f = 4
    cur_j, cur_t = _both(r.randn(f, f))
    stat_j = np.asarray(run_j(None), np.float64)
    stat_t = run_t(None).double().numpy()
    want = np.asarray(run_j((cur_j, 0.95)), np.float64)
    got = run_t((cur_t, 0.95)).double().numpy()
    # the Pallas combine may drop one rounding (<= 2 ulp of the larger
    # term); the statistics themselves differ by their summation order
    mag = np.maximum(np.abs(cur_t.numpy()) * np.float32(0.05),
                     np.abs(stat_j) * np.float32(0.95))
    ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
    bound = 2 * ulp + 0.95 * np.abs(stat_t - stat_j)
    assert np.all(np.abs(got - want) <= bound)
    # and deterministic: a second call is bit-identical
    assert np.array_equal(got, run_t((cur_t, 0.95)).double().numpy())


def test_tensor_alpha_two_passes():
    # a tensor decay is not folded: statistic, then update_running_avg
    xt = torch.from_numpy(_rng(11).randn(16, 10).astype(np.float32))
    cur = torch.eye(11)
    alpha = torch.tensor(0.95)
    assert not ck._ema_static((cur, alpha))
    want = tf.update_running_avg(tf.compute_a_dense(xt, True), cur, alpha)
    got = ck.compute_a_dense(xt, True, ema=(cur, alpha))
    assert torch.equal(got, want)
