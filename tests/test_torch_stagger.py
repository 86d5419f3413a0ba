"""The port's staggered refresh (``plan.build_cohorts``, ``engine``'s cohort
decomposition and merge, ``KFAC(stagger=True)``'s layout) against the JAX
package's.

The cohort tables equal JAX's element for element on ResNet-32's and
ResNet-50's plans (factor dims do not depend on the image size, so the
layers come from a 32x32 input), at 1, 2, 3 and 10 cohorts and with
per-bucket stretches. The cohort decomposition matches JAX's at the
tolerances of ``tests/test_torch_decomp.py``; the merge writes only the
cohort's rows, keeps every other row's bits, and keeps the stored row
where a fresh one is not finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import engine as jengine
from kfac_pytorch_tpu import plan as jplan
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.models import imagenet_resnet as jimagenet
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import engine as tengine
from kfac_pytorch_tpu_torch import plan as tplan

from test_torch_decomp import (TOL, _assert_same_eig, _factors, _jt, _np,
                               _plans, _rel, _stored_eigh, _tt)

torch.set_num_threads(2)


def _jax_metas(model):
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax.eval_shape(
        lambda: jcapture.init(model, jax.random.PRNGKey(0), x))
    return jcapture.collect_layer_meta(model, variables, x)


@pytest.fixture(scope='module')
def model_metas():
    return {'resnet32': _jax_metas(jresnet.resnet32()),
            'resnet50': _jax_metas(jimagenet.resnet50())}


def _both_plans(jmetas, world):
    tmetas = {k: tcapture.LayerMeta(**dataclasses.asdict(m))
              for k, m in jmetas.items()}
    kw = dict(num_devices=world, comm_mode='pred')
    return tplan.build_plan(tmetas, **kw), jplan.build_plan(jmetas, **kw)


def _assert_same_cohorts(got, want):
    for f in ('num_cohorts', 'base_freq', 'bucket_freq'):
        assert getattr(got, f) == getattr(want, f), f
    for f in ('cohort_cost', 'cohort_count'):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for f in ('rows', 'valid', 'global_rows', 'global_valid', 'own_flat',
              'mate_flat'):
        g, w = getattr(got, f), getattr(want, f)
        assert list(g) == list(w), f
        for b in w:
            np.testing.assert_array_equal(g[b], w[b], err_msg=f'{f} {b}')
            assert g[b].dtype == w[b].dtype, (f, b)
    for m in ('max_rows_per_step', 'padded_rows_per_step', 'total_rows'):
        assert getattr(got, m)() == getattr(want, m)(), m


@pytest.mark.parametrize('model,world', [('resnet32', 1), ('resnet32', 2),
                                         ('resnet50', 1)])
def test_build_cohorts_matches_jax(model_metas, model, world):
    tp, jp = _both_plans(model_metas[model], world)
    big = sorted(jp.bucket_dims)[-2:]
    for n in (1, 2, 3, 10):
        _assert_same_cohorts(tplan.build_cohorts(tp, n),
                             jplan.build_cohorts(jp, n))
    stretch = {big[-1]: 2, big[0]: 4}
    _assert_same_cohorts(tplan.build_cohorts(tp, 3, bucket_freq=stretch),
                         jplan.build_cohorts(jp, 3, bucket_freq=stretch))
    # every valid row refreshed once a window
    total = sum(int(tp.buckets[b].valid.sum()) for b in tp.bucket_dims)
    assert tplan.build_cohorts(tp, 10).total_rows() * world == total


def test_build_cohorts_errors_match_jax(model_metas):
    tp, jp = _both_plans(model_metas['resnet32'], 1)
    for stretch in ({999: 2}, {jp.bucket_dims[0]: 3,
                               jp.bucket_dims[1]: 7,
                               jp.bucket_dims[2]: 11}):
        with pytest.raises(ValueError) as jerr:
            jplan.build_cohorts(jp, 2, bucket_freq=stretch)
        with pytest.raises(ValueError) as terr:
            tplan.build_cohorts(tp, 2, bucket_freq=stretch)
        assert str(terr.value) == str(jerr.value)


def test_stagger_layout_and_scheduler_rebase_match_jax():
    tp, jp = _plans()
    bucket = (lambda d: 4 if d <= 4 else 8)
    t = tkfac.KFAC(variant='eigen_dp', kfac_update_freq=4, stagger=True,
                   bucket_fn=bucket)
    j = jkfac.KFAC(variant='eigen_dp', kfac_update_freq=4, stagger=True,
                   bucket_fn=bucket)
    t.setup(tp.metas)
    j.setup(jp.metas)
    _assert_same_cohorts(t.cohorts, j.cohorts)
    kw = dict(update_freq_alpha=2, update_freq_schedule=[1])
    ts = tkfac.KFACParamScheduler(t, **kw)
    js = jkfac.KFACParamScheduler(j, **kw)
    ts.step(1)
    js.step(1)
    assert t.kfac_update_freq == j.kfac_update_freq == 8
    _assert_same_cohorts(t.cohorts, j.cohorts)
    assert t.cohorts.num_cohorts == 8
    # no stagger: no layout
    assert tkfac.KFAC(variant='eigen_dp').rebase_cohorts() is None


def _cohorts(tp, jp, n=2):
    return tplan.build_cohorts(tp, n), jplan.build_cohorts(jp, n)


def _stored_invs(factors):
    return {'invs': {k: np.linalg.inv(v + 0.1 * np.eye(v.shape[-1]))
                     .astype(np.float32) for k, v in factors.items()}}


@pytest.mark.parametrize('impl', [None, 'subspace', 'newton_schulz'])
@pytest.mark.parametrize('comm_mode', ['pred', 'inverse'])
def test_cohort_decomposition_and_merge_match_jax(comm_mode, impl):
    method = 'cholesky' if impl == 'newton_schulz' else 'eigh'
    tp, jp = _plans(comm_mode)
    tc, jc = _cohorts(tp, jp)
    f0, f1 = _factors(tp, 8), _factors(tp, 9)
    f1 = {k: (0.95 * f0[k] + 0.05 * f1[k]).astype(np.float32) for k in f0}
    stored = (_stored_eigh(f0) if method == 'eigh'
              else _stored_invs(f0))
    damping = np.float32(0.003)
    for cohort in range(tc.num_cohorts):
        got = tengine.compute_cohort_decomposition(
            tp, tc, _tt(f1), cohort, torch.tensor(damping), method, 1e-10,
            impl=impl, decomp_prev=_tt(stored) if impl else None,
            comm_mode=comm_mode)
        want = jengine.compute_cohort_decomposition(
            jp, jc, _jt(f1), jnp.int32(cohort), jnp.float32(damping), method,
            1e-10, None, impl=impl,
            decomp_prev=_jt(stored) if impl else None, comm_mode=comm_mode)
        for k in f1:
            if method == 'eigh':
                _assert_same_eig(got['evals'][k].numpy(),
                                 got['evecs'][k].numpy(),
                                 want['evals'][k], want['evecs'][k])
            else:
                assert _rel(got['invs'][k].numpy(), want['invs'][k]) <= TOL
        merged = _np(tengine.merge_cohort_decomposition(
            tp, tc, _tt(stored), got, cohort, None, comm_mode, method))
        jmerged = _np(jengine.merge_cohort_decomposition(
            jp, jc, _jt(stored), _jt(_np(got)), jnp.int32(cohort), None,
            comm_mode, method))
        for part in merged:
            for k in merged[part]:
                np.testing.assert_array_equal(merged[part][k],
                                              jmerged[part][k])
                b = int(k)
                fresh = set(tc.rows[b][cohort, 0][tc.valid[b][cohort, 0]])
                for r in range(merged[part][k].shape[0]):
                    if r not in fresh:      # outside the cohort: same bits
                        np.testing.assert_array_equal(merged[part][k][r],
                                                      stored[part][k][r])


def test_merge_keeps_the_stored_row_where_a_fresh_one_is_not_finite():
    tp, jp = _plans()
    tc, jc = _cohorts(tp, jp)
    f = _factors(tp, 10)
    stored = _stored_eigh(f)
    fresh = _np(tengine.compute_cohort_decomposition(
        tp, tc, _tt(f), 0, torch.tensor(0.003), 'eigh', 1e-10))
    b = 8
    poisoned_row = int(tc.rows[b][0, 0, 0])
    assert tc.valid[b][0, 0, 0]
    fresh['evecs'][str(b)][0, 1, 2] = np.nan   # evals fine, evecs not
    merged = _np(tengine.merge_cohort_decomposition(
        tp, tc, _tt(stored), _tt(fresh), 0, None, 'pred', 'eigh'))
    jmerged = _np(jengine.merge_cohort_decomposition(
        jp, jc, _jt(stored), _jt(fresh), jnp.int32(0), None, 'pred',
        'eigh'))
    for part in ('evals', 'evecs'):
        np.testing.assert_array_equal(merged[part][str(b)][poisoned_row],
                                      stored[part][str(b)][poisoned_row])
        for k in merged[part]:
            np.testing.assert_array_equal(merged[part][k], jmerged[part][k])
            assert np.isfinite(merged[part][k]).all()
