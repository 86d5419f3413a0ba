"""Analytic per-phase performance model of the K-FAC step, for one NVIDIA
H100 (port of ``kfac_pytorch_tpu/perfmodel.py``).

The formulae are the JAX module's, unchanged: per-phase FLOPs and bytes
of the ImageNet ResNet-50 bs32 step (XLA cost analysis of the JAX
programs, differenced along the exclude-parts ladder; the committed
``perf_inputs/perf_inputs_resnet50_bs32.json``, byte-equal to the JAX
copy), priced as ``t = max(flops / (eff * rate), bytes / (hbm_eff *
bw))`` under three efficiency scenarios, the full ``eigh`` phase from a
two-point power-law fit of measured batched ``eigh`` times instead.

What differs is the chip. Every constant a function reads lives in one
:class:`Chip`; the functions take ``chip=`` (default :data:`H100`), so a
test can hand them the TPU's values and hold the port to the JAX module.
The H100's values are measurements of this card by :func:`measure_chip`
(run by ``chip_smoke.py``'s slice-18 phase, which prints them beside the
committed ones): the achieved bf16 and fp32 (TF32 off) GEMM rates, a
device-to-device copy rate, the port's own batched ``eigh`` at the JAX
module's two shapes, and the port's K4/K5 attention kernels forward and
backward at the JAX module's attention shape. The efficiency scenarios are
the JAX module's bands, stated assumptions applied to the measured rates,
not fitted to the ResNet-50 step the model is then tested on. The link
rates are NVIDIA's datasheet figures, not measured.

Every prediction is labeled ``predicted_not_measured``. Stdlib only at
import (``torch`` is imported inside :func:`measure_chip`).
"""

import dataclasses
import datetime
import json
import math
import os
import time
from typing import Optional

#: the reference's 1-GPU K-FAC iteration at bs 32, measured by the
#: reference's authors on their own GPU (BASELINE.md: an RTX 2080 Ti-era
#: cluster, scripts/time_breakdown.py:26), not on this card
BASELINE_ITER_S = 0.487
BATCH = 32

@dataclasses.dataclass(frozen=True)
class Chip:
    """Every chip constant the model's functions read."""
    kind: str
    peak_bf16: float
    hbm_bw: float
    f32_penalty: float
    fenced_eigh_points: tuple
    attn_note: Optional[dict]
    ici_bw: float
    dcn_bw: float
    source: dict = dataclasses.field(default_factory=dict)


#: the H100's constants, measured by :func:`measure_chip` (which
#: ``chip_smoke.py``'s slice-18 phase runs again each time, printing the
#: ratios) on the card, power limit (``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader``) and date of
#: ``source``
H100 = Chip(
    kind='NVIDIA H100 80GB HBM3',
    # achieved dense bf16 GEMM rate (FLOP/s): torch.mm of two 8192 x 8192
    # bf16 matrices (793.18 TFLOP/s)
    peak_bf16=7.9318e14,
    # achieved device-to-device copy rate (B/s, read + write): a 1 GiB
    # copy_ (3.026 TB/s)
    hbm_bw=3.0262e12,
    # peak_bf16 over the achieved fp32 GEMM rate with TF32 off (4096 x
    # 4096: 51.34 TFLOP/s)
    f32_penalty=15.450,
    # the port's batched eigh (``ops.linalg.sym_eig``, impl 'xla':
    # cuSOLVER through torch.linalg.eigh) of random SPD fp32 stacks,
    # host-fenced median seconds: (rows, dim, seconds)
    fenced_eigh_points=((4, 2304, 0.13063), (8, 512, 0.11571)),
    # the port's attention kernels (K4 forward, K5a/K5b backward) on one
    # causal block, B=1 H=8 D=64 L=16384 fp32, host-fenced median seconds
    # of forward + backward; approx_flops counts forward + backward as
    # three times the causal forward's 2 x 2 x B H L^2 D / 2 (the JAX
    # note's count)
    attn_note=dict(program='kfac_flash_fwd_bwd_causal',
                   config='B1_H8_D64_L16384', seconds=0.035926,
                   approx_flops=8.2463e11, achieved_flops=2.2954e13),
    # NVLink 4 per-GPU bandwidth, one direction (900 GB/s both ways), and
    # a ConnectX-7 400 Gb/s NIC per GPU: NVIDIA's H100 SXM / DGX H100
    # datasheet figures, not measured (separate cards are not reachable
    # here: ROADMAP queue 1, item 5)
    ici_bw=4.5e11,
    dcn_bw=5.0e10,
    source={'card': 'NVIDIA H100 80GB HBM3', 'power_limit': '700.00 W',
            'date': '2026-10-19',
            'script': 'kfac_pytorch_tpu_torch/perfmodel.py measure_chip'})

#: Roofline scenarios: (efficiency on the achieved GEMM rate for bf16-input
#: matmul/conv work, efficiency on the achieved copy rate). The JAX
#: module's three bands, kept as stated assumptions: optimistic near the
#: practical ceiling of conv nets, central a well-mapped model,
#: conservative fusion and layout misses.
SCENARIOS = {
    'optimistic': (0.60, 0.90),
    'central': (0.40, 0.70),
    'conservative': (0.20, 0.50),
}

#: analytic FLOPs of psd_inverse per dxd matrix: potrf d^3/3 + two
#: full-RHS triangular solves d^3 each
CHOLESKY_FLOPS_PER_MATRIX = lambda d: (7.0 / 3.0) * d ** 3  # noqa: E731

#: analytic FLOPs of the iterative decomposition rungs per dxd matrix
#: (``ops/linalg.py``): subspace tracking ~12.7 d^3 a step plus a 3 d^3
#: Rayleigh quotient; Newton-Schulz 4 d^3 an iteration plus a 2 d^3
#: residual check
SUBSPACE_FLOPS_PER_MATRIX = \
    lambda d, steps=2: (12.7 * steps + 3.0) * d ** 3  # noqa: E731
NEWTON_SCHULZ_FLOPS_PER_MATRIX = \
    lambda d, iters=2: (4.0 * iters + 2.0) * d ** 3   # noqa: E731

#: HBM-byte multiplier of the fused capture path (K1/K2) relative to the
#: unfused ComputeFactor bytes: no materialized im2col matrix, the EMA in
#: the epilogue; FLOPs unchanged. The JAX module's stated assumption.
CAPTURE_FUSION_BYTES_FACTOR = 0.5

#: link-efficiency scenarios of the collective comm model
COMM_SCENARIOS = {
    'optimistic': 0.85,
    'central': 0.70,
    'conservative': 0.45,
}


_INPUTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'perf_inputs', 'perf_inputs_resnet50_bs32.json')


def load_inputs(path=None):
    with open(path or _INPUTS_PATH) as f:
        return json.load(f)


def eigh_time_model(chip=None):
    """Two-point power-law fit of the measured batched-eigh times:
    ``t = c * rows * dim**p``, batch-linear, the dim exponent solved from
    the two points. Returns ``(c, p, fn)`` with ``fn(rows, dim) ->
    seconds``; beyond [512, 2304] it extrapolates."""
    chip = chip or H100
    (b1, d1, t1), (b2, d2, t2) = chip.fenced_eigh_points
    p = math.log((t1 / b1) / (t2 / b2)) / math.log(d1 / d2)
    c = (t1 / b1) / d1 ** p
    return c, p, lambda rows, dim: c * rows * dim ** p


def _phase_time(flops, bytes_, eff, hbm_eff, rate=None, chip=None):
    """Roofline: compute-bound vs memory-bound, whichever dominates."""
    chip = chip or H100
    rate = chip.peak_bf16 if rate is None else rate
    t_c = flops / (eff * rate) if flops else 0.0
    t_m = bytes_ / (hbm_eff * chip.hbm_bw) if bytes_ else 0.0
    return max(t_c, t_m)


def phase_costs(inputs):
    """Difference the per-program cost-analysis totals into the ledger
    phases. Returns {phase: (flops, bytes)}; 'inverse_chol' and the
    iterative rungs are analytic over the bucket table."""
    prog = inputs['programs']

    def diff(a, b):
        return (max(prog[a]['flops'] - prog[b]['flops'], 0.0),
                max(prog[a]['bytes'] - prog[b]['bytes'], 0.0))

    buckets = inputs['buckets']  # [[rows, dim], ...]
    chol_flops = sum(r * CHOLESKY_FLOPS_PER_MATRIX(d) for r, d in buckets)
    # bytes: read factors + write inverses, f32: 2 * rows * d^2 * 4 B
    chol_bytes = sum(2 * r * d * d * 4 for r, d in buckets)
    # iterative decomp_impl rungs: reads factor + seed, writes result
    sub_flops = sum(r * SUBSPACE_FLOPS_PER_MATRIX(d) for r, d in buckets)
    ns_flops = sum(r * NEWTON_SCHULZ_FLOPS_PER_MATRIX(d)
                   for r, d in buckets)
    iter_bytes = sum(3 * r * d * d * 4 for r, d in buckets)
    return {
        'model': (prog['sgd']['flops'], prog['sgd']['bytes']),
        'precondition': diff('inverse_dp_base', 'sgd'),
        'precondition_eigen': diff('eigen_dp_base', 'sgd'),
        'factor': diff('inverse_dp_factor', 'inverse_dp_base'),
        'refresh': diff('eigen_dp_refresh', 'eigen_dp_factor'),
        'ekfac_scales': diff('ekfac_factor', 'eigen_dp_factor'),
        'inverse_chol': (chol_flops, chol_bytes),
        'inverse_subspace': (sub_flops, iter_bytes),
        'inverse_ns': (ns_flops, iter_bytes),
    }


def decomp_impl_priors(block, method, anchor='central'):
    """{rung: predicted decomposition seconds} for the method's
    decomp_impl ladder, from a :func:`predict_block` dict (the tuner's
    seeding input). {} when the block carries no usable phases."""
    try:
        ph = block['scenarios'][anchor]['phases_s']
    except (KeyError, TypeError):
        return {}
    if method == 'eigh':
        out = {'xla': ph.get('ComputeInverse_eigh_full'),
               'subspace': ph.get('ComputeInverse_subspace')}
    elif method == 'cholesky':
        out = {'xla': ph.get('ComputeInverse_chol'),
               'newton_schulz': ph.get('ComputeInverse_ns')}
    else:
        return {}
    if any(v is None for v in out.values()):
        return {}
    return {k: float(v) for k, v in out.items()}


def capture_impl_priors(block, anchor='central'):
    """{rung: predicted ComputeFactor seconds} for the capture_impl
    ladder: the plain path ('xla') against K1/K2 ('pallas'), the latter's
    bytes scaled by CAPTURE_FUSION_BYTES_FACTOR. {} without phases."""
    try:
        ph = block['scenarios'][anchor]['phases_s']
    except (KeyError, TypeError):
        return {}
    out = {'xla': ph.get('ComputeFactor'),
           'pallas': ph.get('ComputeFactor_pallas')}
    if any(v is None for v in out.values()):
        return {}
    return {k: float(v) for k, v in out.items()}


def predict(inputs=None, chip=None):
    """Predicted steady-state s/iter + imgs/s per variant per scenario:
    sgd; inverse_dp at freq 1 and 10; eigen_dp freq 10 cold and with
    basis_update_freq 100; ekfac freq 10 + basis 100."""
    chip = chip or H100
    inputs = inputs or load_inputs()
    ph = phase_costs(inputs)
    _, _, eigh_t = eigh_time_model(chip)
    eigh_full_s = sum(eigh_t(r, d) for r, d in inputs['buckets'])

    out = {}
    # the fourth entry is the compute-bound floor: bytes ignored at the
    # central efficiency (the CPU-derived byte totals overstate device
    # traffic, so the three scenarios skew slow)
    cases = dict(SCENARIOS)
    cases['central_flops_only'] = (SCENARIOS['central'][0], None)
    for name, (eff, hbm) in cases.items():

        def t(phase, rate=chip.peak_bf16, _eff=eff, _hbm=hbm):
            f, b = ph[phase]
            if _hbm is None:
                b = 0.0
            return _phase_time(f, b, _eff, _hbm or 1.0, rate, chip)

        f32 = chip.peak_bf16 / chip.f32_penalty
        model = t('model')
        prec = t('precondition', f32)
        prec_e = t('precondition_eigen', f32)
        fac = t('factor')
        # the fused capture rung: same GEMM FLOPs, the bytes scaled
        fac_f, fac_b = ph['factor']
        fac_pallas = _phase_time(
            fac_f, 0.0 if hbm is None
            else fac_b * CAPTURE_FUSION_BYTES_FACTOR, eff, hbm or 1.0,
            chip=chip)
        chol = t('inverse_chol', f32)
        refresh = t('refresh', f32)
        scales = t('ekfac_scales', f32)
        sub = t('inverse_subspace', f32)
        ns = t('inverse_ns', f32)

        variants = {
            'sgd': model,
            'inverse_dp_freq1': model + prec + fac + chol,
            'inverse_dp_freq10': model + prec + (fac + chol) / 10.0,
            'eigen_dp_freq10_cold': (model + prec_e
                                     + (fac + eigh_full_s) / 10.0),
            'eigen_dp_freq10_basis100': (model + prec_e + fac / 10.0
                                         + eigh_full_s / 100.0
                                         + refresh * 9.0 / 100.0),
            'ekfac_freq10_basis100': (model + prec_e
                                      + (fac + scales) / 10.0
                                      + eigh_full_s / 100.0
                                      + refresh * 9.0 / 100.0),
        }
        out[name] = {
            k: {'iter_s': round(v, 4), 'imgs_per_s': round(BATCH / v, 1),
                'vs_baseline': round((BATCH / v)
                                     / (BATCH / BASELINE_ITER_S), 2)}
            for k, v in variants.items()
        }
        out[name]['phases_s'] = {
            'Model': round(model, 4), 'Precondition': round(prec, 4),
            'ComputeFactor': round(fac, 4),
            'ComputeFactor_pallas': round(fac_pallas, 4),
            'ComputeInverse_chol': round(chol, 4),
            'ComputeInverse_eigh_full': round(eigh_full_s, 2),
            'ComputeInverse_subspace': round(sub, 6),
            'ComputeInverse_ns': round(ns, 6),
            'EigenRefresh': round(refresh, 4),
            'EkfacScales': round(scales, 4),
        }
    return out


def prior_phase_costs(block, variant='inverse_dp', anchor='central',
                      decomp_impl=None):
    """Per-phase prior seconds for the tuner's seeding
    (``autotune.prior_best_freq``): the ``anchor`` scenario's phases,
    the decomposition bound to the variant's kernel (an iterative
    ``decomp_impl`` rebinds it to its rung). Returns ``{'model',
    'precondition', 'factor', 'decomp'}`` seconds, or {}."""
    try:
        ph = block['scenarios'][anchor]['phases_s']
    except (KeyError, TypeError):
        return {}
    eigen = str(variant).startswith(('eigen', 'ekfac'))
    decomp_key = ('ComputeInverse_eigh_full' if eigen
                  else 'ComputeInverse_chol')
    if decomp_impl in ('subspace', 'jacobi', 'auto') and eigen:
        decomp_key = 'ComputeInverse_subspace'
    elif decomp_impl in ('newton_schulz', 'auto') and not eigen:
        decomp_key = 'ComputeInverse_ns'
    out = {
        'model': ph.get('Model'),
        'precondition': ph.get('Precondition'),
        'factor': ph.get('ComputeFactor'),
        'decomp': ph.get(decomp_key),
    }
    if any(v is None for v in out.values()):
        return {}
    return {k: float(v) for k, v in out.items()}


def predict_block(inputs=None, chip=None):
    """The self-describing prediction block (the tuner's ``predicted``,
    the drift gate's band)."""
    chip = chip or H100
    try:
        inputs = inputs or load_inputs()
        c, p, _ = eigh_time_model(chip)
        return {
            'predicted_not_measured': True,
            'method': ('per-phase analytic model: XLA cost_analysis '
                       'FLOPs/bytes of the JAX programs (CPU-derived, '
                       'backend-independent dot/conv counts) x roofline '
                       'scenarios on the measured GEMM and copy rates + '
                       'the measured batched eigh for the eigh phase; see '
                       'kfac_pytorch_tpu_torch/perfmodel.py'),
            'anchor': {'reference_kfac_iter_s': BASELINE_ITER_S,
                       'source': 'reference scripts/time_breakdown.py:26 '
                                 '(1 GPU of the reference\'s own cluster, '
                                 'bs 32, factor+inverse every step; not '
                                 'this card)'},
            'chip': {'kind': chip.kind, 'peak_bf16': chip.peak_bf16,
                     'hbm_bw': chip.hbm_bw, 'measured_on': chip.source},
            'assumptions': {
                'scenarios_mxu_hbm_eff': {k: list(v) for k, v
                                          in SCENARIOS.items()},
                'f32_gemm_rate': f'peak_bf16 / {chip.f32_penalty}',
                'eigh_fit': {'form': 't = c * rows * dim^p',
                             'c': c, 'p': round(p, 4),
                             'fenced_points': [list(x) for x
                                               in chip.fenced_eigh_points],
                             'note': 'extrapolated beyond dim 2304 '
                                     '(largest ResNet-50 bucket 4608)'},
                'cholesky_flops': '7/3 d^3 per matrix (analytic)',
                'iterative_decomp_flops': (
                    'subspace ~(12.7*steps+3) d^3, newton_schulz '
                    '~(4*iters+2) d^3 per matrix at the defaults '
                    '(steps=iters=2), rooflined at the f32 rate'),
                'bytes_proxy_bias': (
                    'the CPU-derived bytes-accessed totals overstate '
                    'device traffic (pre-fusion buffer counting), so the '
                    'roofline scenarios skew slow; central_flops_only is '
                    'the compute-bound floor from the other side'),
                'skinny_floor_datapoint': chip.attn_note,
            },
            'inputs_meta': inputs['meta'],
            'scenarios': (scen := predict(inputs, chip)),
            'headline': {
                'metric': 'predicted_inverse_dp_freq1_imgs_per_s_central',
                'value': scen['central']['inverse_dp_freq1']['imgs_per_s'],
                'falsify': ('a fenced measured value outside the '
                            '[conservative, optimistic] band falsifies '
                            'the model'),
            },
        }
    except Exception as e:  # noqa: BLE001 — a caller must still emit
        return {'predicted_not_measured': True,
                'error': f'{type(e).__name__}: {e}'}


def comm_scenarios(per_axis_volume, axis_bw=None, dcn_axes=(), chip=None):
    """Per-axis K-FAC communication time scenarios: each axis's bytes
    (``{axis: {phase: bytes}}``) at ``bytes / (eff * bw)`` under
    COMM_SCENARIOS, summed over axes. ``axis_bw`` overrides an axis's
    rate; axes in ``dcn_axes`` default to the NIC rate instead of the
    NVLink rate."""
    chip = chip or H100
    axis_bw = dict(axis_bw or {})
    out = {}
    for scen, eff in COMM_SCENARIOS.items():
        axes = {}
        total_s = 0.0
        for ax, phases in per_axis_volume.items():
            bw = axis_bw.get(ax, chip.dcn_bw if ax in dcn_axes
                             else chip.ici_bw)
            byts = int(sum(phases.values()))
            t = byts / (eff * bw)
            axes[ax] = {'bytes': byts,
                        'phase_bytes': dict(phases),
                        'bw_assumed': bw,
                        's': t}
            total_s += t
        out[scen] = {'axes': axes, 'total_s': total_s}
    return out


def comm_block(per_axis_volume, axis_bw=None, dcn_axes=(), chip=None):
    """Self-describing wrapper around :func:`comm_scenarios`."""
    chip = chip or H100
    return {
        'predicted_not_measured': True,
        'method': 'per-axis serial sum of bytes/(eff*bw)',
        'assumptions': {
            'ici_bw_B_per_s': chip.ici_bw,
            'dcn_bw_B_per_s': chip.dcn_bw,
            'link_bw_source': 'NVIDIA datasheet, not measured',
            'link_eff_scenarios': dict(COMM_SCENARIOS),
            'serialisation': 'axes summed, intra-axis perfectly '
                             'overlapped within each phase',
        },
        'scenarios': comm_scenarios(per_axis_volume, axis_bw=axis_bw,
                                    dcn_axes=dcn_axes, chip=chip),
    }


# ---------------------------------------------------------------------------
# the measurement behind the H100 constants
# ---------------------------------------------------------------------------

#: the attention shape of the H100's ``attn_note``: (B, H, D, L)
ATTN_SHAPE = (1, 8, 64, 16384)
#: ResNet-50's widest bucket (rows, dim): the eigh fit's extrapolation,
#: measured beside its prediction
EIGH_CHECK = (3, 4608)


def measure_chip(device='cuda', reps=5):
    """Measure this card's constants of :class:`Chip` (the GPU's kernels
    must be buildable: K4/K5 run here). Returns a dict: ``peak_bf16``,
    ``fp32_rate``, ``f32_penalty``, ``hbm_bw``, ``fenced_eigh_points``,
    ``eigh_check`` (EIGH_CHECK measured, and the fit's prediction from the
    points just measured), ``attn_note`` and the card and date. GEMMs and
    the copy are timed with CUDA events over 10 back-to-back calls; eigh
    and attention host-fenced (synchronize), the median of ``reps``."""
    import torch

    from kfac_pytorch_tpu_torch.ops import linalg
    from kfac_pytorch_tpu_torch.parallel.ring_attention import \
        ring_attention

    gen = torch.Generator().manual_seed(0)

    def fenced(fn):
        fn()
        torch.cuda.synchronize(device)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    def events(fn, inner=10):
        fn()
        ts = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(inner):
                fn()
            e.record()
            torch.cuda.synchronize(device)
            ts.append(s.elapsed_time(e) / 1e3 / inner)
        return sorted(ts)[len(ts) // 2]

    def gemm_rate(dtype, n):
        a = torch.randn(n, n, generator=gen).to(device, dtype)
        b = torch.randn(n, n, generator=gen).to(device, dtype)
        return 2.0 * n ** 3 / events(lambda: torch.mm(a, b))

    def spd(rows, dim):
        a = torch.randn(rows, dim, dim, generator=gen).to(device)
        return a @ a.mT / dim + torch.eye(dim, device=device)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bf16 = gemm_rate(torch.bfloat16, 8192)
        fp32 = gemm_rate(torch.float32, 4096)
        x = torch.empty(1 << 28, dtype=torch.float32, device=device)
        y = torch.empty_like(x)
        copy = 2.0 * x.numel() * 4 / events(lambda: y.copy_(x))
        del x, y
        points = []
        for rows, dim in ((4, 2304), (8, 512)):
            m = spd(rows, dim)
            points.append((rows, dim,
                           fenced(lambda m=m: linalg.sym_eig(m, impl='xla'))))
        m = spd(*EIGH_CHECK)
        check_s = fenced(lambda: linalg.sym_eig(m, impl='xla'))
        del m
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    B, H, D, L = ATTN_SHAPE
    q, k, v = (torch.randn(B, H, L, D, generator=gen).to(device)
               .requires_grad_() for _ in range(3))
    g = torch.randn(B, H, L, D, generator=gen).to(device)

    def attn():
        out = ring_attention(q, k, v, causal=True, block_impl='pallas')
        out.backward(g)
    attn_s = fenced(attn)
    del q, k, v, g
    flops = 3 * 2 * 2 * B * H * L * L * D / 2
    chip = Chip(kind=torch.cuda.get_device_name(device), peak_bf16=bf16,
                hbm_bw=copy, f32_penalty=bf16 / fp32,
                fenced_eigh_points=tuple(points), attn_note=None,
                ici_bw=H100.ici_bw, dcn_bw=H100.dcn_bw)
    _, _, fit = eigh_time_model(chip)
    return {
        'card': chip.kind,
        'date': datetime.date.today().isoformat(),
        'peak_bf16': bf16, 'fp32_rate': fp32, 'f32_penalty': bf16 / fp32,
        'hbm_bw': copy,
        'fenced_eigh_points': [list(p) for p in points],
        'eigh_check': {'rows': EIGH_CHECK[0], 'dim': EIGH_CHECK[1],
                       'measured_s': check_s,
                       'fit_s': fit(*EIGH_CHECK)},
        'attn_note': dict(H100.attn_note, seconds=attn_s,
                          approx_flops=flops, achieved_flops=flops / attn_s),
    }


if __name__ == '__main__':
    print(json.dumps(measure_chip()))
