"""Kronecker-factor statistics ops (port of ``kfac_pytorch_tpu/ops/factors.py``).

Layouts at these public functions are the JAX package's: conv activations
and output-gradients are NHWC, dense ones ``[N, ..., d]`` (middle dims are
mean-reduced), and conv patch features are in ``(kh, kw, c)`` order, so a
factor compares with the JAX one index for index and factor A aligns with
a conv weight flattened as ``w.permute(0, 2, 3, 1).reshape(c_out, -1)``.

The op order is the reference's: ``x^T @ (x / n)``, the bias ones column
appended before the ``/ spatial`` scaling, and G's ``x N`` before its
``x spatial``. Each elementwise scaling rounds in the input dtype; the
covariance product accumulates in fp32.
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.capture import canonical_padding
from kfac_pytorch_tpu_torch.ops.linalg import fp32_matmul

_FACTOR_DTYPE = torch.float32


def _stat_gemm(x, n):
    """``x^T @ (x / n)`` in fp32 — the covariance GEMM of every factor.
    The scaling rounds in ``x``'s dtype; the product of two bf16 values is
    exact in fp32, so upcasting before the matmul is bf16-in/fp32-accum."""
    return x.to(_FACTOR_DTYPE).T @ (x / n).to(_FACTOR_DTYPE)


def extract_patches(x, kernel_size, strides, padding):
    """im2col: ``[N, H, W, C] -> [N, OH, OW, kh*kw*C]``, features in
    ``(kh, kw, c)`` order. ``padding`` is 'SAME', 'VALID', ``(ph, pw)`` or
    ``((top, bottom), (left, right))`` with ``lax`` semantics. One strided
    slice per tap of the zero-padded input: an exact copy in any dtype."""
    n, h, w, c = x.shape
    kh, kw = kernel_size
    sh, sw = strides
    (pt, pb), (pl, pr) = canonical_padding((h, w), kernel_size, strides,
                                           padding)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    taps = [xp[:, ki:ki + (oh - 1) * sh + 1:sh, kj:kj + (ow - 1) * sw + 1:sw]
            for ki in range(kh) for kj in range(kw)]
    return torch.cat(taps, dim=-1)


def _append_ones_column(x):
    return torch.cat([x, x.new_ones(x.shape[:-1] + (1,))], dim=-1)


def compute_a_dense(a, use_bias):
    """Factor A for a dense layer: ``[d_in(+1), d_in(+1)]``."""
    if a.ndim > 2:
        a = a.mean(dim=tuple(range(1, a.ndim - 1)))
    n = a.shape[0]
    if use_bias:
        a = _append_ones_column(a)
    return _stat_gemm(a, n)


def compute_a_conv(a, kernel_size, strides, padding, use_bias):
    """Factor A for a conv layer: ``[kh*kw*C(+1), kh*kw*C(+1)]``; patch
    rows are divided by the number of output positions."""
    n = a.shape[0]
    patches = extract_patches(a, kernel_size, strides, padding)
    spatial = patches.shape[1] * patches.shape[2]
    rows = patches.reshape(-1, patches.shape[-1])
    if use_bias:
        rows = _append_ones_column(rows)
    rows = rows / spatial
    return _stat_gemm(rows, n)


def compute_g_dense(g, batch_averaged=True):
    """Factor G for a dense layer from output-gradients ``[N, ..., d_out]``
    (the batch-mean's 1/N undone when ``batch_averaged``)."""
    if g.ndim > 2:
        g = g.mean(dim=tuple(range(1, g.ndim - 1)))
    n = g.shape[0]
    if batch_averaged:
        g = g * n
    return _stat_gemm(g, n)


def compute_g_conv(g, batch_averaged=True):
    """Factor G for a conv layer from output-gradients ``[N, OH, OW, C]``;
    positions are extra samples, scaled by the spatial size."""
    n = g.shape[0]
    spatial = g.shape[1] * g.shape[2]
    rows = g.reshape(-1, g.shape[-1])
    if batch_averaged:
        rows = rows * n
    rows = rows * spatial
    return _stat_gemm(rows, rows.shape[0])


def layer_rows_dense(a, g, use_bias, batch_averaged=True):
    """Aligned per-example rows of a dense layer, the rows whose
    covariances are :func:`compute_a_dense` / :func:`compute_g_dense`
    (same sequence mean, bias column and batch-averaged undo): ``(arows
    [N, d_in(+1)], grows [N, d_out], N)`` in fp32, row ``b`` of both sides
    example ``b``'s (the E-KFAC moment input)."""
    if a.ndim > 2:
        a = a.mean(dim=tuple(range(1, a.ndim - 1)))
    if g.ndim > 2:
        g = g.mean(dim=tuple(range(1, g.ndim - 1)))
    n = a.shape[0]
    if use_bias:
        a = _append_ones_column(a)
    if batch_averaged:
        g = g * n
    return a.to(_FACTOR_DTYPE), g.to(_FACTOR_DTYPE), n


def layer_rows_conv(a, g, kernel_size, strides, padding, use_bias,
                    batch_averaged=True):
    """Aligned per-patch rows of a conv layer, the row sets and scalings of
    :func:`compute_a_conv` / :func:`compute_g_conv` (patch rows divided by
    the spatial size, g rows scaled by N and the spatial size), row ``r``
    of both sides one (example, position): ``(arows [N*OH*OW,
    kh*kw*C(+1)], grows [N*OH*OW, C_out], N)`` in fp32."""
    n = a.shape[0]
    patches = extract_patches(a, kernel_size, strides, padding)
    spatial = patches.shape[1] * patches.shape[2]
    arows = patches.reshape(-1, patches.shape[-1])
    if use_bias:
        arows = _append_ones_column(arows)
    arows = arows / spatial
    grows = g.reshape(-1, g.shape[-1])
    if batch_averaged:
        grows = grows * n
    grows = grows * spatial
    return arows.to(_FACTOR_DTYPE), grows.to(_FACTOR_DTYPE), n


def ekfac_scales(arows, grows, qa, qg, n):
    """E-KFAC second moments in the joint Kronecker eigenbasis, ``s_ij =
    (1/n) sum_r (qg^T grows_r)_i^2 (arows_r^T qa)_j^2``: two projections
    and one GEMM of the squared projections, all in fp32 (TF32 off)."""
    with fp32_matmul():
        pa = arows @ qa
        pg = grows @ qg
        return (pg * pg).T @ ((pa * pa) / n)


def update_running_avg(new, current, alpha):
    """``current * (1 - alpha) + new * alpha`` with ``alpha`` and its
    complement taken in the factor dtype, as the JAX version does. A
    python ``alpha`` stays a 0-dim CPU tensor, which a CUDA op takes as a
    scalar: no host-to-device copy, so no stream synchronization."""
    if torch.is_tensor(alpha):
        alpha = alpha.to(current.dtype)
    else:
        alpha = torch.tensor(alpha, dtype=current.dtype)
    return current * (1.0 - alpha) + new.to(current.dtype) * alpha
