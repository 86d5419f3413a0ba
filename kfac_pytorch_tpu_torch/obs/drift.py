"""Perf-model drift: measured per-phase wall time against ``perfmodel.py``
(port of ``kfac_pytorch_tpu/obs/drift.py``).

The perf model predicts per-phase seconds under three roofline scenarios;
a measurement outside the [optimistic, conservative] band falsifies it
for that phase. :func:`drift_block` pairs what was measured (the
``PhaseTimers`` marginals, a benchmark's extras) with the matching
predictions, as per-phase ratios and a verdict; :func:`gate` is the
tuner's commit veto.

Two rules, as in JAX:

- a measurement on a platform the model does not describe (anything but
  an H100: the CPU, another GPU) still gets its ratios, but the verdict is
  ``advisory`` and ``comparable: false`` rides beside every number;
- a phase with no prediction (the single-GPU model predicts no comm
  phases) or no measurement reports ``null``, never a made-up ratio.

Stdlib only.
"""

import math

#: PhaseTimers label -> ledger taxonomy (the span emitter's table)
from kfac_pytorch_tpu_torch.obs.trace import PHASE_TAXONOMY as _TIMER_LABELS

#: substrings of ``torch.cuda.get_device_name`` naming the card the model
#: describes (perfmodel's constants were measured on an H100)
_MODEL_CHIP_KEYS = ('h100',)

#: comm_precision -> multiplier on the comm phases' predictions (the wire
#: ratios of parallel/collectives.py: the stats reduce floors at bf16
#: under 'int8', the gathers take the whole factor). 'Precondition' is
#: deliberately not scaled: the host timers' phase is the joint
#: compute + gather apply, and the single-GPU model predicts no comm share
#: in it.
COMM_WIRE_FACTORS = {
    'fp32': {'CommunicateFactor': 1.0, 'CommunicateInverse': 1.0,
             'PredComm': 1.0},
    'bf16': {'CommunicateFactor': 0.5, 'CommunicateInverse': 0.5,
             'PredComm': 0.5},
    'int8': {'CommunicateFactor': 0.5, 'CommunicateInverse': 0.25,
             'PredComm': 0.25},
}

_COMM_PHASES = ('CommunicateFactor', 'CommunicateInverse', 'PredComm')


def scale_comm_scenarios(predicted_block, comm_precision):
    """A deep copy of a ``perfmodel.predict_block()`` dict whose comm
    phases are scaled by ``COMM_WIRE_FACTORS[comm_precision]``; fp32, an
    unknown dtype or no block returns the block unchanged."""
    import copy
    factors = COMM_WIRE_FACTORS.get(comm_precision)
    if not factors or comm_precision == 'fp32' or not predicted_block:
        return predicted_block
    block = copy.deepcopy(predicted_block)
    for scen in (block.get('scenarios') or {}).values():
        if not isinstance(scen, dict):
            continue
        phases = scen.get('phases_s') or {}
        for name in _COMM_PHASES:
            if phases.get(name) is not None:
                phases[name] = float(phases[name]) * factors[name]
    block['comm_precision'] = comm_precision
    return block


def _timer_label_to_taxonomy(label):
    """'decomp+gather' -> 'ComputeInverse+CommunicateInverse' etc."""
    return '+'.join(_TIMER_LABELS.get(p, p) for p in label.split('+'))


def measured_from_phase_timers(phase_ms):
    """A ``PhaseTimers.epoch_flush()`` dict (ms, host labels) in
    ledger-taxonomy seconds; ``step_mean``/``step_max`` keep their names
    (no prediction maps to them)."""
    out = {}
    for label, ms in (phase_ms or {}).items():
        if label in ('step_mean', 'step_max'):
            out[label] = ms / 1e3
        else:
            out[_timer_label_to_taxonomy(label)] = ms / 1e3
    return out


def measured_from_bench_extras(extra):
    """Every phase-shaped measurement of a benchmark's extras dict: the
    exclude-parts breakdown when present, the SGD leg as the Model phase,
    and the freq-1 K-FAC overhead as a joint phase when only whole
    iterations exist."""
    out = {}
    bd = extra.get('phase_breakdown_s')
    if bd:
        for k, v in bd.items():
            if k not in ('Total', 'Rest') and v is not None:
                out[k] = float(v)
    sgd = extra.get('sgd_iter_s')
    if sgd is not None:
        out.setdefault('Model', float(sgd))
        inv1 = extra.get('inverse_dp_iter_s_freq1')
        if inv1 is not None and not bd:
            out['Precondition+ComputeFactor+ComputeInverse'] = max(
                float(inv1) - float(sgd), 0.0)
    return out


def _predicted_phase(phases_s, name, variant, decomp_impl=None,
                     capture_impl=None):
    """Predicted seconds of one (possibly joint) taxonomy name, or None
    when a part has no prediction. 'ComputeInverse' binds to the
    variant's kernel (Cholesky for inverse_*, the full eigh for eigen_*),
    an iterative ``decomp_impl`` to its rung; 'ComputeFactor' binds to the
    fused rung under ``capture_impl`` 'pallas'/'auto'."""
    eigen = variant.startswith('eigen') or variant.startswith('ekfac')
    total = 0.0
    for part in name.split('+'):
        if part == 'ComputeInverse':
            if decomp_impl in ('subspace', 'jacobi', 'auto') and eigen:
                key = 'ComputeInverse_subspace'
            elif decomp_impl in ('newton_schulz', 'auto') and not eigen:
                key = 'ComputeInverse_ns'
            elif eigen:
                key = 'ComputeInverse_eigh_full'
            else:
                key = 'ComputeInverse_chol'
        elif (part == 'ComputeFactor'
                and capture_impl in ('pallas', 'auto')):
            key = 'ComputeFactor_pallas'
        else:
            key = part
        v = phases_s.get(key)
        if v is None:
            return None
        total += float(v)
    return total


def drift_block(measured_s, predicted_block, *, platform=None,
                variant='inverse_dp', anchor='central', tolerance=1.0,
                source=None, comm_precision='fp32', decomp_impl=None,
                capture_impl=None):
    """The ``drift`` block: per measured phase its seconds, the
    predictions by scenario, the ratio to the ``anchor`` scenario, the
    band and whether the measurement is inside it (x ``tolerance``), and
    a gate verdict: 'drift' (a phase outside its band on the modeled
    card), 'ok', 'no_overlap', or 'advisory' off the modeled card.
    ``platform`` is ``torch.cuda.get_device_name`` (or 'cpu');
    ``comm_precision``, ``decomp_impl`` and ``capture_impl`` bind the
    predictions to what the measured run ran. Never raises: an error is
    reported in the block."""
    try:
        predicted_block = scale_comm_scenarios(predicted_block,
                                               comm_precision)
        scenarios = (predicted_block or {}).get('scenarios') or {}
        per_scen = {name: scen.get('phases_s', {})
                    for name, scen in scenarios.items()
                    if isinstance(scen, dict)}
        comparable = bool(platform) and any(
            k in str(platform).lower() for k in _MODEL_CHIP_KEYS)
        phases = {}
        violations = []
        for name, meas in sorted((measured_s or {}).items()):
            if meas is None:
                continue
            pred = {scen: _predicted_phase(ph, name, variant, decomp_impl,
                                           capture_impl)
                    for scen, ph in per_scen.items()}
            pred = {k: v for k, v in pred.items() if v is not None}
            entry = {'measured_s': round(float(meas), 6),
                     'predicted_s': {k: round(v, 6)
                                     for k, v in sorted(pred.items())}}
            anchor_pred = pred.get(anchor)
            if anchor_pred and anchor_pred > 0 and meas >= 0:
                entry['ratio'] = round(meas / anchor_pred, 4)
            else:
                entry['ratio'] = None
            band_vals = [v for k, v in pred.items()
                         if k in ('optimistic', 'conservative', 'central')]
            if band_vals and entry['ratio'] is not None:
                lo, hi = min(band_vals), max(band_vals)
                entry['band_s'] = [round(lo, 6), round(hi, 6)]
                within = (lo / tolerance <= meas <= hi * tolerance)
                entry['within_band'] = within
                if not within:
                    violations.append(name)
            else:
                entry['within_band'] = None
            phases[name] = entry
        if not comparable:
            verdict = 'advisory'
        elif violations:
            verdict = 'drift'
        elif any(e['within_band'] for e in phases.values()):
            verdict = 'ok'
        else:
            verdict = 'no_overlap'  # nothing measured maps to a prediction
        return {
            'measured_vs_predicted': True,
            'source': source,
            'platform': platform,
            'variant': variant,
            'comparable': comparable,
            'comm_precision': comm_precision,
            'decomp_impl': decomp_impl,
            'capture_impl': capture_impl,
            'anchor_scenario': anchor,
            'tolerance': tolerance,
            'phases': phases,
            'gate': {
                'verdict': verdict,
                'violations': violations,
                'note': ('ratios are informational: the analytic model '
                         'describes the NVIDIA H100, not this platform'
                         if not comparable else
                         'a phase outside the [optimistic, conservative]'
                         ' band (x tolerance) falsifies the model for '
                         'that phase'),
            },
        }
    except Exception as e:  # noqa: BLE001 — never break the caller
        return {'measured_vs_predicted': True,
                'error': f'{type(e).__name__}: {e}'}


def gate(measured_s, predicted_block, **kw):
    """``(verdict, violations)`` of :func:`drift_block` (the tuner's commit
    veto: 'drift' rejects a knob change; 'advisory', 'ok' and
    'no_overlap' let it through)."""
    block = drift_block(measured_s, predicted_block, **kw)
    g = block.get('gate') or {}
    return g.get('verdict'), g.get('violations') or []


def micro_measured(micro):
    """A micro-benchmark block's phases: its steady step runs model +
    precondition + statistics, the unstaggered refresh step adds the full
    decomposition, so refresh minus steady is ComputeInverse. Ledger
    seconds, or {} when the block lacks them."""
    try:
        un = micro['unstaggered']
        steady = un['steady_ms'] / 1e3
        refresh = un['refresh_ms'] / 1e3
        out = {'Model+Precondition+ComputeFactor': steady}
        marg = refresh - steady
        if math.isfinite(marg) and marg >= 0:
            out['ComputeInverse'] = marg
        return out
    except (KeyError, TypeError):
        return {}
