"""The port's decomposition ladder (``ops/linalg.py``'s warm kernels,
``engine``'s warm, refresh and guarded paths, ``KFAC``'s ladder options)
against the JAX package's, on the same numpy inputs (seeded).

Tolerances: the Cholesky, Newton-Schulz and warm-inverse results within
1e-5 of the largest entry; the subspace tracker's eigenvalues within 1e-5
of max |d| and its damped inverse ``Q diag(1/(d + lam)) Q^T`` within 1e-5
of its largest entry; Jacobi's sorted eigenvalues and its reconstruction
within 1e-5 of the largest entry. The trackers return unsorted
eigenpairs, so eigenvectors are never compared column by column.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import engine as jengine
from kfac_pytorch_tpu import plan as jplan
from kfac_pytorch_tpu.ops import linalg as jlinalg
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import engine as tengine
from kfac_pytorch_tpu_torch import plan as tplan
from kfac_pytorch_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(2)

TOL = 1e-5
LAM = 1e-2


def _spd(rng, n, d):
    a = rng.randn(n, d, 2 * d).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) / (2 * d)
            + 0.05 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _drift(seed, n, d, w=0.05):
    """``(x0, x1)``: an SPD stack and the running average one step on."""
    rng = np.random.RandomState(seed)
    x0 = _spd(rng, n, d)
    x1 = ((1 - w) * x0 + w * _spd(rng, n, d)).astype(np.float32)
    return x0, x1


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def _precond_op(w, q, lam=LAM):
    """``Q diag(1/(max(d, 0) + lam)) Q^T``, in fp64."""
    w, q = np.asarray(w, np.float64), np.asarray(q, np.float64)
    return q @ (np.swapaxes(q, -1, -2)
                / (np.maximum(w, 0) + lam)[..., :, None])


def _assert_same_eig(tw, tq, jw, jq, tol=TOL):
    dw = np.abs(np.sort(np.asarray(tw), -1) - np.sort(np.asarray(jw), -1))
    assert dw.max() <= tol * np.abs(np.asarray(jw)).max(), dw.max()
    err = _rel(_precond_op(tw, tq), _precond_op(jw, jq))
    assert err <= tol, err


# ---------------------------------------------------------------------------
# the repair: a failed Cholesky slot is NaN, and the guard heals it
# ---------------------------------------------------------------------------

def _one_bad_slot():
    rng = np.random.RandomState(0)
    x = _spd(rng, 2, 8)
    x[1] = -x[1]                    # slot 1 negative definite
    return x


def test_psd_inverse_failed_cholesky_slot_is_nan_as_jax():
    x = _one_bad_slot()
    got = tlinalg.psd_inverse(_t(x)).numpy()
    want = np.asarray(jlinalg.psd_inverse(_j(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1]).all() and np.isfinite(want[0]).all()
    assert _rel(got[0], want[0]) <= TOL
    # the Cholesky factor itself: NaN lower triangle, zeros above
    chol = tlinalg._cholesky(_t(x)).numpy()
    np.testing.assert_array_equal(
        np.isnan(chol), np.isnan(np.asarray(jnp.linalg.cholesky(_j(x)))))


def _metas(pkg):
    """Three dense layers without bias, for a two-bucket plan (4 and 8)."""
    return {f'fc{i}': pkg.LayerMeta(name=f'fc{i}', path=(f'fc{i}',),
                                    kind='dense', use_bias=False, in_dim=a,
                                    out_dim=g, kernel_shape=(a, g))
            for i, (a, g) in enumerate([(6, 5), (7, 3), (4, 8)])}


def _bucket(d):
    return 4 if d <= 4 else 8


def _plans(comm_mode='pred'):
    kw = dict(num_devices=1, comm_mode=comm_mode, bucket_fn=_bucket)
    return (tplan.build_plan(_metas(tcapture), **kw),
            jplan.build_plan(_metas(jcapture), **kw))


def _factors(plan, seed):
    """Per bucket ``[rows, D, D]``: SPD true blocks, identity pads."""
    rng = np.random.RandomState(seed)
    out = {}
    for bdim in plan.bucket_dims:
        rows = []
        for s in plan.buckets[bdim].slot_of_row:
            m = np.eye(bdim, dtype=np.float32)
            if s is not None:
                m[:s.dim, :s.dim] = _spd(rng, 1, s.dim)[0]
            rows.append(m)
        out[str(bdim)] = np.stack(rows)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def _tt(tree):
    return {k: _tt(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else _t(tree)


def _jt(tree):
    return {k: _jt(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else _j(tree)


@pytest.mark.parametrize('cold', [True, False])
def test_guard_heals_a_failed_cholesky_slot_as_jax(cold):
    tp, jp = _plans()
    f = _factors(tp, 1)
    f['8'][1] = -f['8'][1]          # this slot's Cholesky fails
    prev = {'invs': {k: (np.zeros_like(v) if cold else
                         np.linalg.inv(v + 0.1 * np.eye(v.shape[-1]))
                         .astype(np.float32)) for k, v in f.items()}}
    damping = np.float32(0.003)
    got = tengine.guard_decomposition(
        tengine.compute_decomposition(tp, _tt(f), torch.tensor(damping),
                                      'cholesky', 1e-10),
        _tt(prev), 'cholesky')
    want = jengine.guard_decomposition(
        jengine.compute_decomposition(jp, _jt(f), jnp.float32(damping),
                                      'cholesky', 1e-10, None),
        _jt(prev), 'cholesky')
    got, want = _np(got)['invs'], _np(want)['invs']
    heal = np.eye(8) if cold else prev['invs']['8'][1]
    np.testing.assert_array_equal(got['8'][1], heal)
    np.testing.assert_array_equal(want['8'][1], heal)
    for k in want:
        assert np.isfinite(got[k]).all()
        assert _rel(got[k], want[k]) <= TOL, k


# ---------------------------------------------------------------------------
# ops/linalg.py: Newton-Schulz, subspace tracking, Jacobi, sym_eig
# ---------------------------------------------------------------------------

def test_newton_schulz_inverse_matches_jax():
    a0, a1 = _drift(5, 3, 32)
    seed = np.linalg.inv(a0).astype(np.float32)
    tx, tr = tlinalg.newton_schulz_inverse(_t(a1), _t(seed))
    jx, jr = jlinalg.newton_schulz_inverse(_j(a1), _j(seed))
    assert _rel(tx.numpy(), jx) <= TOL
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL)
    assert (tr.numpy() < 1e-2).all()
    np.testing.assert_array_equal(tx.numpy(), tx.numpy().transpose(0, 2, 1))
    _, bad = tlinalg.newton_schulz_inverse(_t(a1), torch.zeros(3, 32, 32))
    assert (bad.numpy() >= 1.0 - 1e-6).all()


@pytest.mark.parametrize('stale_slot', [None, 1])
def test_warm_inverse_per_slot_gate_matches_jax(stale_slot):
    a0, a1 = _drift(7, 3, 32, w=0.03)
    seed = np.linalg.inv(a0).astype(np.float32)
    if stale_slot is not None:
        seed[stale_slot] = 0.0      # fails the gate alone
    got = tlinalg.warm_inverse(_t(a1), _t(seed)).numpy()
    want = np.asarray(jlinalg.warm_inverse(_j(a1), _j(seed)))
    assert _rel(got, want) <= TOL
    ns, resid = tlinalg.newton_schulz_inverse(_t(a1), _t(seed))
    for i in range(3):
        if i == stale_slot:
            assert resid[i] >= 1.0 - 1e-6
            np.testing.assert_array_equal(
                got[i], tlinalg.psd_inverse(_t(a1)).numpy()[i])
        else:
            np.testing.assert_array_equal(got[i], ns.numpy()[i])


@pytest.mark.parametrize('steps', [None, 3])
def test_subspace_eigh_tracks_a_drifting_factor_as_jax(steps):
    x0, x1 = _drift(11, 3, 24)
    # slot 2: a constant diagonal (an identity pad): no NaN
    x0[2] = x1[2] = 2.0 * np.eye(24, dtype=np.float32)
    q0 = np.linalg.eigh(x0)[1].astype(np.float32)
    tw, tq = tlinalg.subspace_eigh(_t(x1), _t(q0), steps=steps)
    jw, jq = jlinalg.subspace_eigh(_j(x1), _j(q0), steps=steps)
    assert np.isfinite(tw.numpy()).all() and np.isfinite(tq.numpy()).all()
    _assert_same_eig(tw.numpy(), tq.numpy(), jw, jq)
    np.testing.assert_allclose(tw.numpy()[2], 2.0, atol=TOL)
    np.testing.assert_allclose(tq.numpy().transpose(0, 2, 1) @ tq.numpy(),
                               np.broadcast_to(np.eye(24), (3, 24, 24)),
                               atol=5e-5)


def test_subspace_eigh_chained_tracking_matches_jax():
    """Ten chained warm decompositions of a running-average factor from
    the identity: at each step JAX's tracker, given the port's chained
    basis, agrees with the port's, and the port's damped inverse stays
    within the reference's own chained bound (6% of the exact one's
    largest entry, ``tests/test_linalg.py``). Two independent chains are
    not compared: in the near-degenerate clusters the tracker leaves
    mixed, rounding alone moves them apart by up to ~1e-2."""
    rng = np.random.RandomState(0)
    n, b = 32, 16
    a = np.eye(n, dtype=np.float32)
    q = torch.eye(n)
    for _ in range(10):
        r = rng.randn(b, n).astype(np.float32)
        a = (0.95 * a + 0.05 * (r.T @ r) / b).astype(np.float32)
        jw, jq = jlinalg.subspace_eigh(_j(a), _j(q.numpy()))
        w, q = tlinalg.subspace_eigh(_t(a), q)
        _assert_same_eig(w.numpy(), q.numpy(), jw, jq)
        we, qe = np.linalg.eigh(a.astype(np.float64))
        assert _rel(_precond_op(w.numpy(), q.numpy(), 0.03),
                    _precond_op(we, qe, 0.03)) < 0.06


@pytest.mark.parametrize('rotate', ['dense', 'paired'])
@pytest.mark.parametrize('shape', [(3, 16, 16), (9, 9), (2, 33, 33)])
def test_jacobi_eigh_matches_jax(shape, rotate):
    x = _spd(np.random.RandomState(3), int(np.prod(shape[:-2])),
             shape[-1]).reshape(shape)
    tw, tv = tlinalg.jacobi_eigh(_t(x), sweeps=6, rotate=rotate)
    jw, jv = jlinalg.jacobi_eigh(_j(x), sweeps=6, rotate=rotate)
    scale = np.abs(np.asarray(jw)).max()
    assert np.abs(tw.numpy() - np.asarray(jw)).max() <= TOL * scale
    assert (np.diff(tw.numpy(), axis=-1) >= 0).all()
    rec = tv.numpy() @ (tw.numpy()[..., None] * np.swapaxes(tv.numpy(), -1,
                                                            -2))
    assert _rel(rec, x) <= TOL


def test_jacobi_eigh_warm_start_matches_jax():
    x0, x1 = _drift(4, 2, 20)
    q0 = np.linalg.eigh(x0)[1].astype(np.float32)
    tw, tv = tlinalg.jacobi_eigh(_t(x1), basis=_t(q0))
    jw, jv = jlinalg.jacobi_eigh(_j(x1), basis=_j(q0))
    _assert_same_eig(tw.numpy(), tv.numpy(), jw, jv)
    rec = tv.numpy() @ (tw.numpy()[..., None] * tv.numpy().transpose(0, 2, 1))
    assert _rel(rec, x1) <= TOL


def test_jacobi_eigh_rejects_an_unknown_rotation():
    with pytest.raises(ValueError, match='dense|paired'):
        tlinalg.jacobi_eigh(torch.eye(4), rotate='givens')


def test_sym_eig_dispatch_matches_jax(monkeypatch):
    x0, x1 = _drift(12, 2, 16, w=0.03)
    monkeypatch.delenv('KFAC_EIGH_IMPL', raising=False)
    cold = tlinalg.sym_eig(_t(x0))
    # subspace with no basis is the cold solver
    for impl in ('subspace', 'auto', 'xla'):
        d, q = tlinalg.sym_eig(_t(x0), impl=impl)
        np.testing.assert_array_equal(d.numpy(), cold[0].numpy())
    q0 = cold[1]
    jq0 = _j(q0.numpy())
    want_sub = jlinalg.sym_eig(_j(x1), impl='subspace', basis=jq0)
    for impl in ('subspace', 'auto'):
        d, q = tlinalg.sym_eig(_t(x1), impl=impl, basis=q0)
        _assert_same_eig(d.numpy(), q.numpy(), *want_sub)
    # impl None reads KFAC_EIGH_IMPL
    for env, kw in (('subspace', {}), ('auto', {}), ('jacobi', {'sweeps': 4})):
        monkeypatch.setenv('KFAC_EIGH_IMPL', env)
        d, q = tlinalg.sym_eig(_t(x1), basis=q0, **kw)
        jd, jq = jlinalg.sym_eig(_j(x1), basis=jq0, **kw)
        _assert_same_eig(d.numpy(), q.numpy(), jd, jq)
    monkeypatch.setenv('KFAC_EIGH_IMPL', 'xla')
    d, _ = tlinalg.sym_eig(_t(x1), basis=q0)
    jd, _ = jlinalg.sym_eig(_j(x1), basis=jq0)
    assert np.abs(d.numpy() - np.asarray(jd)).max() <= TOL * np.abs(
        np.asarray(jd)).max()


# ---------------------------------------------------------------------------
# engine: warm full decompositions and the eigenvalue-only refresh
# ---------------------------------------------------------------------------

def _stored_eigh(factors):
    """An eigh decomposition of ``factors`` as the state stores it."""
    evals, evecs = {}, {}
    for k, v in factors.items():
        w, q = np.linalg.eigh(v.astype(np.float64))
        evals[k] = w.astype(np.float32)
        evecs[k] = q.astype(np.float32)
    return {'evals': evals, 'evecs': evecs}


@pytest.mark.parametrize('impl', ['subspace', 'jacobi'])
def test_warm_eigh_decomposition_matches_jax(impl):
    tp, jp = _plans()
    f0, f1 = _factors(tp, 2), _factors(tp, 3)
    f1 = {k: (0.95 * f0[k] + 0.05 * f1[k]).astype(np.float32) for k in f0}
    prev = _stored_eigh(f0)
    # a never-decomposed row (all zero) warm-starts from the identity
    prev['evecs']['8'][2] = 0.0
    got = tengine.compute_decomposition(
        tp, _tt(f1), torch.tensor(0.003), 'eigh', 1e-10,
        basis_local=tengine.local_evecs(tp, _tt(prev), None, 'pred'),
        impl=impl)
    want = jengine.compute_decomposition(
        jp, _jt(f1), jnp.float32(0.003), 'eigh', 1e-10, None,
        basis_local=jengine.local_evecs(jp, _jt(prev), None, 'pred'),
        impl=impl)
    for k in f1:
        _assert_same_eig(got['evals'][k].numpy(), got['evecs'][k].numpy(),
                         want['evals'][k], want['evecs'][k])


def test_newton_schulz_decomposition_matches_jax():
    tp, jp = _plans()
    f0, f1 = _factors(tp, 4), _factors(tp, 5)
    f1 = {k: (0.97 * f0[k] + 0.03 * f1[k]).astype(np.float32) for k in f0}
    damping = np.float32(0.003)
    seed = _np(jengine.compute_decomposition(
        jp, _jt(f0), jnp.float32(damping), 'cholesky', 1e-10, None))
    seed['invs']['8'][0] = 0.0      # never computed: the Cholesky takes it
    got = tengine.compute_decomposition(
        tp, _tt(f1), torch.tensor(damping), 'cholesky', 1e-10,
        invs_prev_local=tengine.local_invs(tp, _tt(seed), None, 'pred'))
    want = jengine.compute_decomposition(
        jp, _jt(f1), jnp.float32(damping), 'cholesky', 1e-10, None,
        invs_prev_local=jengine.local_invs(jp, _jt(seed), None, 'pred'))
    for k in f1:
        assert _rel(got['invs'][k].numpy(), want['invs'][k]) <= TOL, k


@pytest.mark.parametrize('comm_mode', ['pred', 'inverse'])
def test_refresh_decomposition_matches_jax(comm_mode):
    tp, jp = _plans(comm_mode)
    f0, f1 = _factors(tp, 6), _factors(tp, 7)
    f1 = {k: (0.9 * f0[k] + 0.1 * f1[k]).astype(np.float32) for k in f0}
    prev = _stored_eigh(f0)
    got = tengine.refresh_decomposition(tp, _tt(f1), _tt(prev), 1e-10, None,
                                        comm_mode)
    want = jengine.refresh_decomposition(jp, _jt(f1), _jt(prev), 1e-10, None,
                                         comm_mode)
    for k in f1:
        np.testing.assert_array_equal(got['evecs'][k].numpy(),
                                      prev['evecs'][k])
        d, dw = got['evals'][k].numpy(), np.asarray(want['evals'][k])
        assert np.abs(d - dw).max() <= TOL * np.abs(dw).max(), k


# ---------------------------------------------------------------------------
# KFAC: the ladder options, with JAX's validation
# ---------------------------------------------------------------------------

def _raised(ctor, kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        try:
            ctor(**kw)
        except (ValueError, NotImplementedError) as e:
            return type(e), str(e)
    return None


@pytest.mark.parametrize('kw', [
    dict(variant='inverse_dp', basis_update_freq=5),
    dict(variant='eigen_dp', cold_restart_every=0),
    dict(variant='eigen_dp', cold_restart_every=2.5),
    dict(variant='eigen_dp', decomp_impl='qdwh'),
    dict(variant='inverse_dp', decomp_impl='subspace'),
    dict(variant='inverse_dp', decomp_impl='jacobi'),
    dict(variant='eigen_dp', decomp_impl='newton_schulz'),
    dict(variant='eigen_dp', stagger=True, basis_update_freq=10),
    dict(variant='inverse_dp', stagger=True, warm_start_basis=True),
    dict(variant='eigen_dp', decomp_impl='auto', basis_update_freq=3),
])
def test_validation_errors_match_jax(kw):
    want = _raised(jkfac.KFAC, kw)
    assert _raised(tkfac.KFAC, kw) == want


def test_warnings_match_jax(monkeypatch):
    monkeypatch.delenv('KFAC_EIGH_IMPL', raising=False)
    for kw in (dict(warm_start_basis=True),
               dict(warm_start_basis=True, basis_update_freq=20)):
        with pytest.warns(UserWarning) as jw:
            jkfac.KFAC(variant='eigen_dp', **kw)
        with pytest.warns(UserWarning) as tw:
            tkfac.KFAC(variant='eigen_dp', **kw)
        assert len(tw) == len(jw)
        # the first names the cold solver (JAX's QDWH, the port's
        # torch.linalg.eigh); the interval warning is JAX's word for word
        assert str(tw[0].message).startswith(
            'warm_start_basis has no effect on the')
        assert [str(w.message) for w in tw[1:]] == \
            [str(w.message) for w in jw[1:]]


def test_ladder_properties_match_jax():
    for variant in ('eigen_dp', 'inverse_dp'):
        for impl in (None, 'xla', 'auto') + (
                ('subspace', 'jacobi') if variant == 'eigen_dp'
                else ('newton_schulz',)):
            t = tkfac.KFAC(variant=variant, decomp_impl=impl)
            j = jkfac.KFAC(variant=variant, decomp_impl=impl)
            assert (t.resolved_decomp_impl, t.warm_impl) == \
                (j.resolved_decomp_impl, j.warm_impl)
    t = tkfac.KFAC(variant='eigen_dp', basis_update_freq=3)
    j = jkfac.KFAC(variant='eigen_dp', basis_update_freq=3)
    for step, last in ((5, None), (5, 3), (6, 3), (9, 5)):
        assert t.should_update_basis(step, last) == \
            j.should_update_basis(step, last)
    assert tkfac.preconditioner.DECOMP_IMPLS == \
        jkfac.preconditioner.DECOMP_IMPLS


def test_stagger_at_world_above_one_names_its_roadmap_item():
    # stagger at world>1 is ported (tests/test_torch_decomp_shard.py)
    pre = tkfac.KFAC(variant='eigen_dp', stagger=True, num_devices=2,
                     bucket_fn=_bucket)
    pre.setup(_metas(tcapture))
    assert pre.stagger and pre.cohorts.rows[8].shape[1] == 2
    # E-KFAC (item 18) is ported; its replan to another world is not
    pre = tkfac.KFAC(variant='ekfac_dp', bucket_fn=_bucket)
    pre.setup(_metas(tcapture))
    with pytest.raises(NotImplementedError, match='item 13'):
        pre.replan(num_devices=2)


def test_layer_meta_fields_match_jax():
    # the plans above are built from hand-made metas of both packages
    assert [f.name for f in dataclasses.fields(tcapture.LayerMeta)] == \
        [f.name for f in dataclasses.fields(jcapture.LayerMeta)]
