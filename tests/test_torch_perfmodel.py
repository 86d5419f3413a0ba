"""The port's perf model (``kfac_pytorch_tpu_torch/perfmodel.py``) and
drift gate (``obs/drift.py``) held against the JAX package's, in the same
process (both stdlib: no JAX compile).

- With the JAX module's TPU constants handed in (a ``perfmodel.Chip``),
  the port's ``predict``, ``predict_block``'s scenarios and eigh fit,
  ``prior_phase_costs``, ``decomp_impl_priors``, ``capture_impl_priors``
  and ``comm_scenarios`` equal JAX's to 1e-12 relative.
- The committed inputs are byte-equal to the JAX copy, and the port's
  defaults are the H100's, each with its card, power limit and date, and
  none of the TPU's.
- ``drift_block`` and its adapters equal JAX's on the same inputs: the
  modeled chip's verdicts ('TPU v5e' for JAX, 'NVIDIA H100 80GB HBM3' for
  the port), advisory elsewhere.
"""

import math
import os

import pytest

from kfac_pytorch_tpu import perfmodel as jpm
from kfac_pytorch_tpu.obs import drift as jdrift
from kfac_pytorch_tpu_torch import perfmodel as tpm
from kfac_pytorch_tpu_torch.obs import drift as tdrift

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX module's chip, as the port's functions take it
TPU = tpm.Chip(kind='TPU v5e (v5 lite)', peak_bf16=jpm.PEAK_BF16,
               hbm_bw=jpm.HBM_BW, f32_penalty=jpm.F32_PENALTY,
               fenced_eigh_points=jpm.FENCED_EIGH_POINTS,
               attn_note=jpm.FENCED_ATTN_NOTE, ici_bw=jpm.ICI_BW,
               dcn_bw=jpm.DCN_BW)


def _close(got, want, rel=1e-12, path=''):
    """``got == want`` with floats to ``rel`` relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rel, f'{path}/{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rel, f'{path}[{i}]')
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=rel, abs_tol=0.0), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_inputs_are_the_jax_copy():
    port = os.path.join(ROOT, 'kfac_pytorch_tpu_torch', 'perf_inputs',
                        'perf_inputs_resnet50_bs32.json')
    jax = os.path.join(ROOT, 'kfac_pytorch_tpu', 'data',
                       'perf_inputs_resnet50_bs32.json')
    assert open(port, 'rb').read() == open(jax, 'rb').read()
    assert tpm.load_inputs() == jpm.load_inputs()


def test_predictions_match_jax_under_the_tpu_constants():
    inputs = jpm.load_inputs()
    _close(tpm.predict(inputs, chip=TPU), jpm.predict(inputs))
    c, p, fit = tpm.eigh_time_model(TPU)
    jc, jp, jfit = jpm.eigh_time_model()
    _close([c, p, fit(3, 4608)], [jc, jp, jfit(3, 4608)])
    tblock, jblock = tpm.predict_block(chip=TPU), jpm.predict_block()
    _close(tblock['scenarios'], jblock['scenarios'])
    _close(tblock['headline']['value'], jblock['headline']['value'])
    _close(tblock['assumptions']['eigh_fit'],
           jblock['assumptions']['eigh_fit'])
    assert tblock['inputs_meta'] == jblock['inputs_meta']
    for anchor in ('optimistic', 'central', 'conservative'):
        for variant in ('inverse_dp', 'eigen_dp', 'ekfac'):
            for impl in (None, 'xla', 'auto', 'subspace', 'newton_schulz'):
                _close(tpm.prior_phase_costs(jblock, variant, anchor, impl),
                       jpm.prior_phase_costs(jblock, variant, anchor, impl))
        for method in ('eigh', 'cholesky', 'qr'):
            _close(tpm.decomp_impl_priors(jblock, method, anchor),
                   jpm.decomp_impl_priors(jblock, method, anchor))
        _close(tpm.capture_impl_priors(jblock, anchor),
               jpm.capture_impl_priors(jblock, anchor))
    assert tpm.prior_phase_costs({}, 'eigen_dp') == {}
    assert tpm.capture_impl_priors(None) == {}


def test_comm_scenarios_match_jax_under_the_tpu_constants():
    vol = {'data': {'FactorComm': 1 << 20, 'InverseComm': 3 << 20},
           'seq': {'PredComm': 5 << 18}, 'expert': {}}
    for kw in ({}, {'dcn_axes': ('data',)},
               {'axis_bw': {'seq': 1e11}, 'dcn_axes': ('data',)}):
        _close(tpm.comm_scenarios(vol, chip=TPU, **kw),
               jpm.comm_scenarios(vol, **kw))
        _close(tpm.comm_block(vol, chip=TPU, **kw)['scenarios'],
               jpm.comm_block(vol, **kw)['scenarios'])


def test_the_port_defaults_are_the_h100s():
    tpu = {jpm.PEAK_BF16, jpm.HBM_BW, jpm.F32_PENALTY, jpm.ICI_BW,
           jpm.DCN_BW, jpm.FENCED_ATTN_NOTE['seconds']}
    h100 = tpm.H100
    mine = {h100.peak_bf16, h100.hbm_bw, h100.f32_penalty, h100.ici_bw,
            h100.dcn_bw, h100.attn_note['seconds']}
    assert not tpu & mine
    assert not {t for _, _, t in jpm.FENCED_EIGH_POINTS} & \
        {t for _, _, t in h100.fenced_eigh_points}
    # the same shapes, measured on the card
    assert [(b, d) for b, d, _ in h100.fenced_eigh_points] == \
        [(b, d) for b, d, _ in jpm.FENCED_EIGH_POINTS]
    assert h100.attn_note['config'] == jpm.FENCED_ATTN_NOTE['config']
    assert h100.kind.startswith('NVIDIA H100')
    assert {'card', 'power_limit', 'date'} <= set(h100.source)
    assert 'H100' in h100.source['card']
    assert h100.source['power_limit'].endswith(' W')
    assert tpm.BASELINE_ITER_S == jpm.BASELINE_ITER_S
    assert tpm.BATCH == jpm.BATCH
    assert tpm.SCENARIOS == jpm.SCENARIOS
    assert tpm.COMM_SCENARIOS == jpm.COMM_SCENARIOS
    block = tpm.predict_block()
    assert 'error' not in block, block
    assert block['chip']['measured_on'] == h100.source
    assert block['chip']['peak_bf16'] == h100.peak_bf16


# ---------------------------------------------------------------------------
# the drift gate
# ---------------------------------------------------------------------------

MEASURED = {
    'Model': 0.11, 'Precondition': 0.0069, 'ComputeFactor': 0.02,
    'ComputeInverse': 70.0, 'CommunicateInverse': 0.5,
    'Precondition+ComputeFactor': 0.03, 'step_mean': 0.2, 'Nope': 1.0,
    'None': None}


def _without_text(block):
    """A drift block less what names its platform (the platform and the
    gate's note)."""
    out = {k: v for k, v in block.items() if k != 'platform'}
    out['gate'] = {k: v for k, v in block['gate'].items() if k != 'note'}
    return out


@pytest.mark.parametrize('kw', [
    dict(variant='eigen_dp'),
    dict(variant='inverse_dp', decomp_impl='newton_schulz',
         capture_impl='pallas', tolerance=2.0),
    dict(variant='eigen_dp', decomp_impl='subspace', anchor='optimistic',
         comm_precision='int8', source='autotune'),
    dict(variant='ekfac', capture_impl='auto', comm_precision='bf16')],
    ids=['eigen', 'ns_pallas', 'subspace_int8', 'ekfac_bf16'])
@pytest.mark.parametrize('modeled', [True, False],
                         ids=['modeled', 'advisory'])
def test_drift_block_matches_jax(kw, modeled):
    block = jpm.predict_block()
    block['scenarios']['central']['phases_s']['CommunicateInverse'] = 0.4
    jplat, tplat = (('TPU v5e', 'NVIDIA H100 80GB HBM3') if modeled
                    else ('cpu', 'cpu'))
    got = tdrift.drift_block(MEASURED, block, platform=tplat, **kw)
    want = jdrift.drift_block(MEASURED, block, platform=jplat, **kw)
    assert got['comparable'] is want['comparable'] is modeled
    assert _without_text(got) == _without_text(want)
    assert got['platform'] == tplat
    assert tdrift.gate(MEASURED, block, platform=tplat, **kw) == \
        jdrift.gate(MEASURED, block, platform=jplat, **kw)
    # the verdict is the modeled card's alone
    assert (got['gate']['verdict'] == 'advisory') is (not modeled)
    if modeled:
        assert tdrift.drift_block(MEASURED, block, platform='TPU v5e',
                                  **kw)['gate']['verdict'] == 'advisory'


def test_drift_adapters_match_jax():
    timers = {'decomp+gather': 512.0, 'pred': 7.5, 'stats': 2.0,
              'step_mean': 90.0, 'step_max': 600.0}
    assert tdrift.measured_from_phase_timers(timers) == \
        jdrift.measured_from_phase_timers(timers)
    for extra in ({'phase_breakdown_s': {'Model': 0.1, 'Total': 2.0,
                                         'ComputeInverse': 1.0,
                                         'Rest': 0.2, 'X': None},
                   'sgd_iter_s': 0.12},
                  {'sgd_iter_s': 0.12, 'inverse_dp_iter_s_freq1': 0.5},
                  {}):
        assert tdrift.measured_from_bench_extras(extra) == \
            jdrift.measured_from_bench_extras(extra)
    for micro in ({'unstaggered': {'steady_ms': 10.0, 'refresh_ms': 40.0}},
                  {'unstaggered': {'steady_ms': 10.0, 'refresh_ms': 4.0}},
                  {}):
        assert tdrift.micro_measured(micro) == jdrift.micro_measured(micro)
    block = jpm.predict_block()
    for prec in ('fp32', 'bf16', 'int8', 'fp8'):
        assert tdrift.scale_comm_scenarios(block, prec) == \
            jdrift.scale_comm_scenarios(block, prec)
    assert tdrift.COMM_WIRE_FACTORS == jdrift.COMM_WIRE_FACTORS
    assert tdrift.drift_block({'Model': 1.0}, None)['gate']['verdict'] == \
        jdrift.drift_block({'Model': 1.0}, None)['gate']['verdict']
