"""Batched symmetric linear algebra for K-FAC factors (port of
``kfac_pytorch_tpu/ops/linalg.py``): the cold solvers and the warm ones
(Newton-Schulz inverse, subspace tracking, Jacobi sweeps).

All functions take one matrix ``[D, D]`` or a stack ``[L, D, D]``.
Identity padding is exact for preconditioning: padded eigenvectors live in
the pad subspace, orthogonal to the zero-padded gradient, and
``blockdiag(A, I)^-1 = blockdiag(A^-1, I)``.

A Cholesky that fails on a slot gives NaN there, as ``jnp.linalg.cholesky``
does, and never raises: the engine's guard replaces such rows. The warm
kernels' matmuls run in full fp32 (TF32 off for their duration), as the
reference runs them at ``Precision.HIGHEST``.
"""

import contextlib
import functools
import os

import numpy as np
import torch


def _symmetrized(x):
    """``(x + x^T) / 2``: what ``jnp.linalg.eigh``/``cholesky`` decompose
    (``symmetrize_input=True``), where torch's solvers read one triangle.
    Exact, so a symmetric ``x`` passes through bit for bit."""
    return (x + x.mT) / 2


@contextlib.contextmanager
def fp32_matmul():
    """Full-fp32 matmuls on the card (the reference's
    ``Precision.HIGHEST``) whatever the caller's TF32 setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _cholesky(x):
    """Lower Cholesky factor of ``x`` (batched) with
    ``jnp.linalg.cholesky``'s failure semantics: a slot that is not
    positive definite comes back NaN in its lower triangle (zeros above)
    instead of raising."""
    chol, info = torch.linalg.cholesky_ex(x)
    bad = (info != 0).reshape(info.shape + (1, 1))
    nan = torch.full_like(chol, float('nan')).tril()
    return torch.where(bad, nan, chol)


def psd_inverse(x):
    """Cholesky-based inverse of an SPD matrix (batched): two triangular
    solves against the identity, as the JAX version, on the symmetrized
    ``x`` as ``jnp.linalg.cholesky`` takes it. A slot whose Cholesky fails
    is NaN."""
    x = _symmetrized(x)
    chol = _cholesky(x)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device).expand_as(x)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def newton_schulz_inverse(a, x0, iters=2):
    """Warm inverse by Newton-Schulz iteration ``X <- X (2I - A X)``,
    seeded with a previous inverse (batched); each iteration squares the
    residual ``I - A X``. The result is symmetrized. Returns ``(x,
    resid)`` with ``resid[i] = max |I - A_i X_i|`` after the last
    iteration, the caller's acceptance gate (a stale seed diverges)."""
    with fp32_matmul():
        x = x0.to(a.dtype)
        for _ in range(iters):
            ax = a @ x
            x = 2.0 * x - x @ ax
        x = 0.5 * (x + x.mT)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        resid = torch.amax(torch.abs(eye - a @ x), dim=(-2, -1))
    return x, resid


def warm_inverse(damped, seed, iters=2, accept_resid=0.05):
    """Newton-Schulz warm inverse with a per-slot acceptance gate: slots
    whose residual clears ``accept_resid`` keep the iteration's result,
    the rest take the batched Cholesky :func:`psd_inverse`. The Cholesky
    runs only when some slot failed (one host read of the gate, the
    reference's ``lax.cond``); either way the result is the ``where``
    form's."""
    ns, resid = newton_schulz_inverse(damped, seed, iters=iters)
    slot_ok = resid < accept_resid
    if bool(torch.all(slot_ok)):
        return ns
    return torch.where(slot_ok[..., None, None], ns, psd_inverse(damped))


def sym_eig(x, impl=None, basis=None, sweeps=None):
    """Symmetric eigendecomposition ``(eigvals, eigvecs)`` (batched).

    impl: 'xla' (the cold solver, ``torch.linalg.eigh`` of the
    symmetrized ``x``, ascending), 'jacobi' (:func:`jacobi_eigh`, sorted),
    'subspace' (:func:`subspace_eigh`, unsorted; the cold solver when no
    basis exists yet), 'auto' (= 'subspace'), or None to read
    ``KFAC_EIGH_IMPL`` (default 'xla'). ``basis``: a previous orthogonal
    eigenbasis to warm-start 'jacobi'/'subspace' (ignored by 'xla');
    ``sweeps`` their iteration count (None = the kernel's default)."""
    impl = impl or os.environ.get('KFAC_EIGH_IMPL', 'xla')
    if impl == 'auto':
        impl = 'subspace'
    if impl == 'jacobi':
        return jacobi_eigh(x, sweeps=sweeps, basis=basis)
    if impl == 'subspace' and basis is not None:
        return subspace_eigh(x, basis, steps=sweeps)
    return torch.linalg.eigh(_symmetrized(x))


def _chol_qr(z, jitter=1e-6):
    """Batched CholeskyQR: orthonormal columns of ``z`` from one Gram
    matmul, one Cholesky (a relative diagonal jitter keeps it positive
    definite) and one triangular solve, ``q = z r^-T``."""
    g = z.mT @ z
    d = torch.diagonal(g, dim1=-2, dim2=-1)
    scale = torch.mean(d, dim=-1, keepdim=True)[..., None]
    eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    r = _cholesky(g + jitter * scale * eye)
    return torch.linalg.solve_triangular(r.mT, z, upper=True, left=False)


def subspace_eigh(x, basis, steps=None, tau=0.01, clip=0.5):
    """Warm eigendecomposition by perturbative tracking from the previous
    eigenbasis: each step rotates the basis by the first-order correction
    ``K_ij = B_ij / (d_j - d_i)`` of ``B = Q^T X Q`` (near-degenerate pairs
    Tikhonov-suppressed by ``tau`` times the spread, each angle clipped to
    ``clip``) and re-orthonormalizes by CholeskyQR2. A constant-diagonal
    slot (an identity pad) has its spread floored at fp32 eps, so its
    rotation is 0, not 0/0. Returns unsorted ``(eigvals, eigvecs)``, the
    Rayleigh quotients ``diag(Q^T X Q)``."""
    steps = 2 if steps is None else max(int(steps), 1)
    eps = torch.finfo(x.dtype).eps
    with fp32_matmul():
        q = basis.to(x.dtype)
        for _ in range(steps):
            b = q.mT @ (x @ q)
            d = torch.diagonal(b, dim1=-2, dim2=-1)
            eps_floor = eps * (1.0 + torch.amax(torch.abs(d), dim=-1))
            spread = torch.maximum(
                torch.amax(d, dim=-1) - torch.amin(d, dim=-1),
                eps_floor)[..., None, None]
            denom = d[..., None, :] - d[..., :, None]      # d_j - d_i
            reg = denom / (denom * denom + (tau * spread) ** 2)
            k = torch.clamp(b * reg, -clip, clip)
            q = _chol_qr(q + q @ k)
            q = _chol_qr(q)                                # CholeskyQR2
        w = torch.sum(q * (x @ q), dim=-2)
    return w, q


@functools.lru_cache(maxsize=None)
def _tournament_pairs(n):
    """Round-robin schedule (circle method): ``[n-1, n/2, 2]`` disjoint
    ``(p, q)`` pairs, every index pair once."""
    assert n % 2 == 0, n
    circle = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        seats = [0] + circle
        pairs = [(seats[i], seats[n - 1 - i]) for i in range(n // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        circle = circle[-1:] + circle[:-1]
    return np.asarray(rounds, np.int32)


@functools.lru_cache(maxsize=None)
def _tournament_perms(n):
    """Per round, the permutation putting its pairs adjacent ``[p0, q0,
    p1, q1, ...]`` and its inverse (the 'paired' rotation form)."""
    perms = _tournament_pairs(n).reshape(n - 1, n)
    invs = np.empty_like(perms)
    rows = np.arange(n - 1)[:, None]
    invs[rows, perms] = np.arange(n)[None, :]
    return perms, invs


def _givens_cs(app, aqq, apq, tiny):
    """Stable Givens ``(c, s)`` zeroing the symmetric 2x2 off-diagonal:
    ``tau = (aqq - app) / (2 apq)``, ``t`` the smaller root."""
    small = torch.abs(apq) < tiny
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def jacobi_eigh(x, sweeps=None, basis=None, rotate=None):
    """Batched symmetric eigendecomposition by cyclic Jacobi sweeps: each
    round zeroes ``n/2`` disjoint off-diagonal pairs (a round-robin
    schedule, ``n - 1`` rounds a sweep), applied as one orthogonal ``J``
    (``A <- J^T A J``, ``V <- V J``; ``rotate='dense'``, three matmuls) or
    as 2x2 rotations of the permuted-adjacent pairs (``'paired'``, the
    same result); None reads ``KFAC_JACOBI_ROT`` (default 'dense').

    sweeps: default 10 (n <= 512) or 12, and 5 when warm. ``basis``: the
    previous orthogonal eigenbasis Q; the problem is rotated to ``Q^T x
    Q`` (near-diagonal) and the result rotated back. Returns ``(eigvals,
    eigvecs)`` sorted ascending. Odd ``n`` is padded by one decoupled
    identity index. The rounds are sequential: ``sweeps * (n - 1)``
    rounds of a few kernels each."""
    rotate = rotate or os.environ.get('KFAC_JACOBI_ROT', 'dense')
    if rotate not in ('dense', 'paired'):
        raise ValueError(f'rotate={rotate!r}: expected dense|paired')
    cd = torch.float64 if x.dtype == torch.float64 else torch.float32
    if basis is not None:
        with fp32_matmul():
            basis_c = basis.to(cd)
            rot = basis_c.mT @ (x.to(cd) @ basis_c)
            rot = 0.5 * (rot + rot.mT)
            w, vr = jacobi_eigh(rot, sweeps=5 if sweeps is None else sweeps,
                                rotate=rotate)
            v = basis_c @ vr.to(cd)
        return w.to(x.dtype), v.to(x.dtype)
    single = x.ndim == 2
    if single:
        x = x[None]
    n = x.shape[-1]
    odd = n % 2 == 1
    if odd:
        x = identity_pad(x, n + 1)
        n += 1
    if sweeps is None:
        sweeps = 10 if n <= 512 else 12
    dtype = x.dtype
    dev = x.device
    a = x.to(cd)
    eye = torch.eye(n, dtype=cd, device=dev)
    v = eye.expand_as(a).clone()
    tiny = 1e-30
    with fp32_matmul():
        if rotate == 'dense':
            pairs = torch.as_tensor(_tournament_pairs(n), dtype=torch.long,
                                    device=dev)
            bidx = torch.arange(a.shape[0], device=dev)[:, None]
            for r in range(sweeps * (n - 1)):
                pq = pairs[r % (n - 1)]
                p, q = pq[:, 0], pq[:, 1]
                c, s = _givens_cs(a[:, p, p], a[:, q, q], a[:, p, q], tiny)
                j = eye.expand_as(a).clone()
                j[bidx, p, p] = c
                j[bidx, q, q] = c
                j[bidx, p, q] = s
                j[bidx, q, p] = -s
                a = j.mT @ (a @ j)
                v = v @ j
                a = 0.5 * (a + a.mT)
        else:
            perms_np, invs_np = _tournament_perms(n)
            perms = torch.as_tensor(perms_np, dtype=torch.long, device=dev)
            invs = torch.as_tensor(invs_np, dtype=torch.long, device=dev)

            def rot_rows(m, cr, sr):               # J^T on the left
                mr = m.reshape(m.shape[:-2] + (n // 2, 2, m.shape[-1]))
                r0, r1 = mr[..., 0, :], mr[..., 1, :]
                return torch.stack([cr * r0 - sr * r1, sr * r0 + cr * r1],
                                   dim=-2).reshape(m.shape)

            for r in range(sweeps * (n - 1)):
                perm, inv = perms[r % (n - 1)], invs[r % (n - 1)]
                ap = a[:, perm][:, :, perm]
                d = torch.diagonal(ap, dim1=-2, dim2=-1)
                apq = torch.diagonal(ap[:, 0::2, 1::2], dim1=-2, dim2=-1)
                c, s = _givens_cs(d[:, 0::2], d[:, 1::2], apq, tiny)
                cr, sr = c[..., None], s[..., None]
                ap = rot_rows(ap, cr, sr)
                ap = rot_rows(ap.mT, cr, sr).mT
                a = ap[:, inv][:, :, inv]
                vp = v[:, :, perm]
                vp = rot_rows(vp.mT, cr, sr).mT
                v = vp[:, :, inv]
                a = 0.5 * (a + a.mT)
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    if odd:
        w = w[..., :-1]
        v = v[..., :-1, :-1]
    order = torch.argsort(w, dim=-1)
    w = torch.take_along_dim(w, order, dim=-1).to(dtype)
    v = torch.take_along_dim(v, order[..., None, :], dim=-1).to(dtype)
    if single:
        w, v = w[0], v[0]
    return w, v


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
