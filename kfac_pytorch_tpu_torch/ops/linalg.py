"""Batched symmetric linear algebra for K-FAC factors (port of the main-path
subset of ``kfac_pytorch_tpu/ops/linalg.py``).

All functions take one matrix ``[D, D]`` or a stack ``[L, D, D]``.
Identity padding is exact for preconditioning: padded eigenvectors live in
the pad subspace, orthogonal to the zero-padded gradient, and
``blockdiag(A, I)^-1 = blockdiag(A^-1, I)``.
"""

import torch


def _symmetrized(x):
    """``(x + x^T) / 2``: what ``jnp.linalg.eigh``/``cholesky`` decompose
    (``symmetrize_input=True``), where torch's solvers read one triangle.
    Exact, so a symmetric ``x`` passes through bit for bit."""
    return (x + x.mT) / 2


def psd_inverse(x):
    """Cholesky-based inverse of an SPD matrix (batched): two triangular
    solves against the identity, as the JAX version, on the symmetrized
    ``x`` as ``jnp.linalg.cholesky`` takes it."""
    x = _symmetrized(x)
    chol = torch.linalg.cholesky(x)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device).expand_as(x)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def sym_eig(x, impl=None):
    """Symmetric eigendecomposition ``(eigvals, eigvecs)`` (batched),
    ascending eigenvalues, of the symmetrized ``x`` as ``jnp.linalg.eigh``
    takes it. ``impl`` None or 'xla' is the cold solver
    (``torch.linalg.eigh``); the warm kernels are not ported yet."""
    if impl not in (None, 'xla'):
        raise NotImplementedError(f'sym_eig impl={impl!r}: the warm '
                                  'decompositions are port slice D')
    return torch.linalg.eigh(_symmetrized(x))


def clamp_eigvals(d, eps):
    """Zero out eigenvalues ``<= eps``."""
    return d * (d > eps).to(d.dtype)


def add_scaled_identity(x, value):
    """``x + value * I`` (batched); ``value`` a scalar or ``[L]``."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    if value.ndim > 0:
        value = value[..., None, None]
    return x + value * eye


def masked_trace(x, true_dim):
    """Trace over the leading ``true_dim`` diagonal entries (batched); the
    identity pad's ones are masked out. ``true_dim`` scalar or ``[L]``."""
    diag = torch.diagonal(x, dim1=-2, dim2=-1)
    idx = torch.arange(x.shape[-1], device=x.device)
    true_dim = torch.as_tensor(true_dim, device=x.device)
    mask = idx < (true_dim[..., None] if true_dim.ndim > 0 else true_dim)
    return torch.sum(diag * mask.to(diag.dtype), dim=-1)


def identity_pad(x, target_dim):
    """Embed ``[d, d]`` (or ``[L, d, d]``) as ``blockdiag(x, I)`` of size
    ``target_dim``."""
    d = x.shape[-1]
    if d == target_dim:
        return x
    out = torch.zeros(x.shape[:-2] + (target_dim, target_dim),
                      dtype=x.dtype, device=x.device)
    out[..., :d, :d] = x
    idx = torch.arange(d, target_dim, device=x.device)
    out[..., idx, idx] = 1.0
    return out
