"""Smoke test of the PyTorch/CUDA port on one GPU: builds the kernels
from ``kfac_pytorch_tpu_torch/csrc`` (one ``nvcc`` per source, all at
once), then drives the slices' main paths, counting each kernel's
launches:

- slice 1: ResNet-32 ``eigen_dp`` with the fused capture kernels (K1,
  K2) for 12 steps, a 3-step profile, each capture kernel against its
  plain PyTorch version at every factor shape and at off-path layer
  geometries, and the fused path against the unfused one;
- slice 2: the long-context TransformerLM ``eigen_dp`` trainer (4 layers,
  d_model 256, L 2048, batch 4) with the flash-attention kernels (K4,
  K5a, K5b) and the capture kernels for 12 steps, a 3-step profile, K2
  at the LM's factor shapes, K4/K5a/K5b against their plain versions at
  the trainer's attention shape and at off-path geometries, and the
  kernel trainer in lockstep with the plain-attention one;
- slice 3: world=2 on this one card (two ranks over gloo, which stages
  CUDA tensors through host memory: NCCL refuses two ranks on one card):
  ResNet-32 MPD ``eigen`` with the bf16 factor reduce (K1, K2, K3) for 12
  steps with launch counts, the residual and the ranks' parameters
  checked every step, its K-FAC step in lockstep with the unfused one
  over the bf16 and the fp32 wire,
  and ``eigen_dp`` over the fp32 wire for 6 steps; a 1-rank NCCL group
  running ``eigen`` over the bf16 and the int8 wire with every residual
  checked against the plain algebra; K3 against its plain version,
  bitwise, at the world=2 bucket shapes (timed) and at odd sizes with
  special values;
- slice 7: the ImageNet trainer (``train_imagenet``: ResNet-50, batch
  32, 224 x 224, bf16, ``eigen_dp`` with a decomposition every step, the
  capture kernels) for 4 steps with K1/K2 launch counts, images/s and a
  1-step device profile; ``eigh`` ms per bucket; K1 and K2 against their
  plain versions in bf16 at every ResNet-50 factor shape (bitwise over
  two runs, timed beside one bf16 tensor-core GEMM with an fp32 result,
  the bound at the bf16 tensor-core rate); the kernels' K-FAC step in
  lockstep with ``capture_impl=None`` and an fp64-GEMM control; and a
  checkpoint saved after step 2, restored into a fresh trainer and run 1
  more steps, which must be bitwise equal to the uninterrupted run under
  deterministic cuDNN;
- slice 8, the decomposition ladder, in the same phase: per bucket of the
  trained ResNet-50 factors, ``eigh``, the cold Cholesky inverse and the
  warm rungs seeded from the step before (the subspace tracker, the
  eigenvalue-only refresh, the Newton-Schulz inverse, and up to dim 512
  warm Jacobi sweeps), timed, each warm rung's damped inverse held to its
  fp64 twin and its gap to the exact fp64 inverse printed, and the whole
  decomposition of a step for each rung; then the trainer for 6 more
  steps on each of two rungs (``--kfac-decomp-impl subspace
  --kfac-basis-update-freq 5``; ``--kfac-update-freq 6 --kfac-stagger``),
  which must run the expected decomposition each step with finite losses
  and the default run's K1/K2 launches;
- slice 9, right after slice 1: the health guard on ResNet-32
  (``--kfac-capture-impl pallas``): all-NaN batches at steps 3 and 10 (a
  decomposition step) of 12 skipped, the run bitwise equal to a control
  without them (deterministic cuDNN, a constant lr); NaN batches at
  steps 2-5 climbing JAX's ladder (rungs 0,0,0,1,2,2,2,0,0,0); F1mc's
  factors in lockstep with the plain path (fp64 factor GEMMs) over 3
  factor steps, and K1/K2 launches a factor step for Femp and F1mc; the
  step median with the guard on and off (ResNet-32, and ResNet-50 after
  its lockstep) and the synchronizing calls of one steady step
  (``set_sync_debug_mode``), none added by the guard; the native
  crop-flip bitwise against numpy, the loader at prefetch depth 2 batch
  for batch against depth 0, and the ResNet-32 step median and device
  idle share at both depths. The world=2 phase checks that the guard
  adds one scalar all-reduce a step;
- slice 10, after the ResNet-50 phase: E-KFAC and ``KFAC.replan``. The
  ImageNet trainer with ``--kfac-name ekfac_dp`` (ResNet-50, bs32, 224 x
  224, bf16, the capture kernels) for 3 steps with eigen_dp's K1/K2
  counts and every moments group non-zero after step 0; the moments at
  every ResNet-50 layer against the same operands in fp64 (gated at
  ``SCALES_TOL``); the moment update's device ms; step medians against
  eigen_dp in alternating rounds and the peak memory a step adds; the
  ResNet-32 ekfac_dp lockstep, kernels against ``capture_impl=None``; a
  ResNet-32 run replanned eigen_dp -> ekfac_dp -> inverse_dp (factors
  carried bitwise, the cross-method switch passing gradients through
  until its next inverse update); an ekfac_dp checkpoint resumed bitwise,
  the moments included. The world=2 phase adds MPD ``ekfac`` over the
  bf16 wire (K1/K2/K3 counts, replicas and moments bitwise across the
  ranks) and ``ekfac_dp`` over fp32 with no moment collective;
- slice 11, in the world=2 phase: the staggered refresh at world=2
  (``--kfac-update-freq 4 --kfac-stagger``) for ``eigen_dp`` over fp32
  and MPD ``eigen`` over the bf16 wire, 8 steps each through the trainer:
  K1/K2 (and K3 on the bf16 run) launch counts, finite losses, the ranks'
  parameters bitwise equal every step and every stored decomposition row
  outside the step's cohort bitwise kept; ``decomp_shard`` in lockstep
  with owner-local stagger (one model's gradients and captures into both,
  ``eigen_dp`` and ``eigen`` over fp32, 5 steps): the decompositions
  compared every step (bitwise, or within ``SHARD_RTOL``/``SHARD_ATOL``)
  with the largest gap printed, one sharded step's ``kfac.DecompComm``
  bytes equal to ``comm_volume(decomp_shard=...)``, each rank's shard and
  cohort row counts, the staggered K-FAC step's host ms and the
  decompositions' CUDA-event ms a step for both layouts, all with two
  processes sharing the card; ``comm_prefetch`` on MPD ``eigen``
  (``--kfac-update-freq 3``, 7 steps): each prefetched update's
  preconditioned gradients are the stored table's, it publishes the table
  a plain update computes, and the next step reads that table;
- slice 12: durability and the elastic lane, through the trainers'
  ``main``. ResNet-32 (``train_cifar``, batch 128, ``eigen_dp``, the
  capture kernels, 4-step epochs) for 3 epochs with a checkpoint every
  epoch, then the same run with a SIGTERM in epoch 2 (it saves and
  exits) and a ``--resume`` run to the end, which must be bitwise the
  uninterrupted one under deterministic cuDNN, K1/K2 launched in each; the
  host ms ``save_checkpoint`` blocks with ``block=True`` and
  ``block=False``, and the blob's bytes. MPD ``eigen`` moved world 2
  (bf16 wire, two gloo ranks on the card) -> 1 (fp32) -> 2 through
  ``--checkpoint-dir`` and ``--resume``: the ``RESHARDED`` and
  ``WORLD_RESCALE ... lr_factor=1`` lines, every layer's true factor
  block and decomposition row bitwise its old owner's, the first step
  after a move preconditioning, K3 launched at world 2, the lossy residual
  dropped at world 1, replicas bitwise. The ImageNet trainer (ResNet-50
  bs32 bf16) at world 2 for 2 steps, checkpointed and resumed at world 1
  with the same row check, and its saves timed;
- slice 13: the rest of the vision zoo through the trainers at
  full width and depth (``S13_NETS``: VGG-16 on CIFAR-100 and WRN-28-10
  in fp32, DenseNet-201 and Inception-v4 at batch 16, 224 x 224, bf16):
  finite losses, K1/K2 one a conv and one a conv's G and a dense layer's
  A and G a factor step, the decomposition on the steps the cadence
  says, the step median, images/s, the decomposition's ms and peak
  memory; K1/K2 against their plain versions at every distinct captured
  shape (timed once each); Inception-v4's K-FAC step in lockstep with
  the plain path (its 1x7, 7x1, 1x3 and 3x1 kernels); and the
  reference's time breakdown by subtraction on DenseNet-201
  (``--exclude-parts``: without ComputeFactor no K1/K2, without
  ComputeInverse no decomposition and the gradients bitwise untouched).
  The world=2 phase runs MPD ``eigen`` over the bf16 wire without
  CommunicateFactor (no byte in its scope, no K3) and without
  CommunicateInverse (no byte in its scope);
- slice 14: the sequence trainers on their synthetic fallbacks
  (``S14_NETS``): Transformer-base on Multi30k (bs128, a factor and a
  decomposition every step), BERT-base on SQuAD (bs4, sequence 64, every
  step), and the WikiText-2 LSTM (650 wide, 2 layers, bs20, BPTT 35)
  with SGD and with K-FAC every 10 steps (the per-timestep capture, the
  timed window ending on a decomposition): finite losses, K2 once for
  each dense layer's A and G a factor step, the step median, tokens/s,
  the decomposition's ms and peak memory; K2 against its plain version
  at every distinct captured shape (128 rows at d up to 2049, 4 rows at
  d up to 3073, 35 rows at d up to 2600), bitwise over two runs and
  timed; the Transformer-base and K-FAC LSTM K-FAC steps in lockstep
  with the plain path;
- slice 15, last: sequence parallelism over process groups, every rank
  on this one card over gloo. The LM at full width (4 layers, 8 heads,
  d_model 256, L 2048, global batch 4, every kernel on) on a data x seq
  grid of ranks: (1, 2) ring and (1, 2) Ulysses for 6 steps, (1, 2) ring
  with MPD ``eigen`` over the bf16 wire (K3) for 3, and (2, 2) ring on
  four ranks for 6: finite losses, each rank's K2/K3/K4/K5a/K5b
  launches, the replicas bitwise equal every step, the bytes of one
  step's ring or all-to-all traffic; the (1, 2) ring's averaged
  gradients against the world=1 LM's (GRAD_RTOL of each tensor's largest
  entry), and its K-FAC step in lockstep with the same grid's plain path
  (preconditioned gradients within GRAD_RTOL, or TRAJ_FACTOR x a control
  with fp64 factor GEMMs);
  Transformer-base and BERT-base through their trainers at
  ``--num-devices 2`` for 2 steps with their K2 launches and replicas.
  Then K4/K5a/K5b against their plain versions at every block of the
  grids (the ring's diagonal, full and skipped blocks at their offsets,
  Ulysses' whole-sequence block on half the heads), the skipped block's
  outputs exactly (-1e30, 0, 0) and zero gradients, bitwise over two
  runs, timed beside ``scaled_dot_product_attention`` and the bound;
- slice 17: observability through the trainers' ``main``. The
  ImageNet trainer at full width (ResNet-50, bs32, 224 x 224, bf16, the
  capture kernels; 9 steps, a decomposition every 4th) with ``--trace``,
  ``--prom-file``, ``--log-dir`` and ``--tb-dir``: the run log's epoch
  line carries a ``kfac_phase_ms=`` decomposition marginal with
  ``step_mean``/``step_max``, the trace one ``kfac.step`` and one
  ``kfac.dispatch`` span a step with that step's phases, the JSONL and
  Prometheus exports a ``step_seconds`` histogram of one observation a
  step, and the TensorBoard records pass their crc32c; the LM (K4/K5,
  4 steps) with one ``kfac.dispatch`` span a step and the registry's
  suffixes on its epoch line. Then the step split by the ``kfac.*``
  profiler ranges (``torch.profiler``, host and device): ResNet-32 at a
  decomposition step and a plain one, ResNet-50 at a plain one (its
  decomposition marginal is the phase timers'), the LM at both; every K1
  and K2 device kernel must lie inside a ``kfac.ComputeFactor`` range.
  Last, ResNet-32's step median with no ranges, with the ranges, and
  with the tracer and registry on, interleaved;
- slice 18, last: the control loop. The perf model's H100 constants
  measured (``perfmodel.measure_chip``: the bf16 and fp32 GEMM rates,
  the copy rate, the port's batched ``eigh`` at the model's two points
  and at ResNet-50's 4608 bucket beside the fit's prediction, K4/K5
  forward and backward at B1 H8 D64 L16384) and printed beside the
  committed values. ResNet-32 through ``train_cifar.main --kfac-autotune
  --trace`` with the capture and decomposition rungs explicit, long
  enough that the tuner probes the capture rung: its decision log, its
  ``adopted-knobs.json`` and the preconditioner's final knobs agree, K1/K2
  launch on every factor step of the 'pallas' rung and never on the
  'xla' rung, and the epoch line's counters are the tuner's. The LM with
  ``--kfac-autotune`` for 3 windows (K4/K5 launched). ResNet-50 bs32
  through ``train_imagenet.main --kfac-autotune``, drift-gated on this
  card, for at least two judged windows: each modeled phase's drift
  verdict, for the tuner's last window, the run's phase timers and slice
  17's. For each tuned run, the tuner's mean interval beside the
  CUDA-event interval between step ends and the phase timers'
  ``step_mean``: the loop blocks once a step.

After the build it prints, for the split-TF32 ``wgmma`` kernels (K1 for
fp32 and bf16 inputs, K4, K5a and K5b at every head dim), the tensor-core
instructions in the kernel's SASS (``cuobjdump --dump-sass``, ``HGMMA``),
``ptxas -v``'s registers and spills (K1 and K4 must not spill), and the
dynamic shared memory and resident blocks per SM. K1 and K2 at every
factor shape of the main paths, and K4, K5a and K5b at the main attention
shape, must give the same bits on two runs (no atomics). K1's and the
attention kernels' bound counts their operations at the TF32 tensor-core
rate, three passes (``ops_ms``); the fp32 rate's bound stays beside it in
the per-shape rows (``ops_ms_fp32``). Each profile must show one
``conv_a_kernel`` a K1 call and one device kernel a K2 call. Each
attention wrapper must also refuse, with a ValueError, an input that does
not start 16-byte aligned.

  python3 chip_smoke.py

Needs a CUDA device (exits non-zero without one). Prints the kernel
table, a ``{"kernels": [...]}`` JSON line, the GPU's name and power
limit, and last ``{"ok": true, "device": {...}}``; the per-shape tables
and the profiles also go to ``build/chip_smoke.json``. TF32 is off
throughout, so every comparison is fp32 against fp32.
"""

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# (non-tensor-core) FLOP/s and dense TF32 and bf16 tensor-core FLOP/s.
# Products of bf16 operands (exact in fp32) take the bf16 rate. Work done to
# fp32 accuracy on the tensor cores takes three TF32 passes (split TF32), so
# its least time is 3 x operations / PEAK_TF32.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
TF32_PASSES = 3
#: kernel vs plain version: fp32 sums taken in another order. An entry
#: F_ij sums R terms u_ri w_rj, and reordering the sum moves it by a few
#: fp32 roundings of sum_r |u_ri w_rj| <= sqrt(F_ii F_jj) (Cauchy-Schwarz),
#: so the absolute part of the tolerance is in units of sqrt(F_ii F_jj):
#: |got - want| <= ATOL * sqrt(F_ii F_jj) + RTOL * |want|
RTOL, ATOL = 1e-5, 1e-6
#: fused vs unfused trainer: factors take the kernels' summation order;
#: the damped eigendecomposition amplifies it (condition ~ 1/damping) in
#: the preconditioned gradients and the parameters
FACTOR_RTOL, FACTOR_ATOL = 1e-5, 1e-6
#: (relative to each tensor's largest entry: the error is the tensor's,
#: not each element's)
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
#: free trajectories: the fused run may part from the unfused one by at
#: most this many times what the larger control of the unfused path
#: (a rerun, fp64 factor GEMMs) parts by
TRAJ_FACTOR = 10
TRAIN_STEPS = 12
AGREE_STEPS = 3
OUT_DIR = 'build'
#: where the checks make their tensors
DEVICE = 'cuda'
#: kernel vs plain attention: tests/test_pallas_attention.py's tolerances
#: (|got - want| <= tol * (1 + |want|)): m and l 1e-5, pv 1e-4, gradients
#: 2e-4 (its fused-vs-recompute backward)
ATTN_TOL = {'m': 1e-5, 'l': 1e-5, 'pv': 1e-4, 'dq': 2e-4, 'dk': 2e-4,
            'dv': 2e-4}
#: the LM trainer's attention block: (batch 4 x 8 heads, Lq, Lk, head dim),
#: causal, starts (0, 0)
ATTN_MAIN = (32, 2048, 2048, 32)
#: attention geometries off the main path, checked but not timed:
#: (BH, Lq, Lk, D, causal, starts, random key mask)
ATTN_OFF_PATH = [
    (4, 256, 256, 32, False, (64, 32), True),   # non-causal, offsets, mask
    (4, 100, 100, 32, True, (0, 0), False),     # ragged length
    (2, 100, 160, 64, True, (64, 32), True),    # ragged, offsets, D 64
    (3, 72, 40, 16, False, (0, 0), True),       # Lq != Lk, D 16
    (4, 128, 128, 32, True, (0, 128), True),    # fully future: all skipped
]


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def close(got, want, rtol, atol, scale=1.0, stat=None, alpha=None):
    """Max |got - want| and whether every element is within
    ``atol * scale + rtol * |want|``. With the EMA epilogue (``alpha``,
    ``stat`` the raw statistic ``scale`` was taken from) the output is
    ``cur * (1 - alpha) + stat * alpha``: the statistic's own tolerance
    enters with its weight, ``alpha * (atol * scale + rtol * |stat|) +
    rtol * |want|`` (where the two terms cancel, ``|want|`` alone would
    hold the statistic to a tolerance relative to the difference)."""
    got, want = got.detach().double(), want.detach().double()
    err = (got - want).abs()
    bound = atol * scale + rtol * want.abs()
    if alpha is not None:
        bound = alpha * (atol * scale + rtol * stat.detach().double().abs()) \
            + rtol * want.abs()
    ok = bool(torch.all(err <= bound))
    return float(err.max()), ok


def close_tensor(got, want, rtol, atol):
    """Max |got - want| and whether it is within ``atol + rtol *
    max|want|``."""
    got, want = got.detach().double(), want.detach().double()
    err = float((got - want).abs().max())
    return err, err <= atol + rtol * float(want.abs().max())


def cs_scale(stat):
    """``sqrt(|F_ii| |F_jj|)`` of a statistic (or a stack of them), the
    bound on the sum of |terms| of each entry."""
    d = torch.diagonal(stat.double(), dim1=-2, dim2=-1).abs().sqrt()
    return d[..., :, None] * d[..., None, :]


def time_ms(fn, reps=10, hide_host=True):
    """Mean ms of ``fn`` between two CUDA events, with the 50 MB L2
    flushed before every call (the main path finds its activations cold).

    With ``hide_host`` a GPU spin is queued before the start event, long
    enough that the host has queued every launch of ``fn`` before the
    device reaches that event: the events then time ``fn``'s kernels back
    to back, its device time. The spin doubles until the start event is
    still pending when ``fn`` returns. Without it the time also holds the
    wrapper's host work and launch latency."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    fn()
    cycles = 1 << 20
    times = []
    while len(times) < reps:
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        exposed = hide_host and s.query()
        torch.cuda.synchronize()
        if not exposed:
            times.append(s.elapsed_time(e))
        elif cycles >= 1 << 30:
            fail('time_ms: the host still outruns a 2^30-cycle spin')
        else:
            cycles *= 2
    return sum(times) / reps


def gpu_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def counters():
    """``{kernel name: wrapper}``; each wrapper counts its launches."""
    from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    return {'K1 conv_a': ck.compute_a_conv, 'K2 stat_rows': ck._stat_rows,
            'K3 ef_quantize': ck.ef_quantize,
            'K4 flash_fwd': ak.flash_fwd,
            'K5a flash_bwd_dq': ak.flash_bwd_dq,
            'K5b flash_bwd_dkv': ak.flash_bwd_dkv}


def reset_counts():
    for name, fn in counters().items():
        fn.launches = 0
        if name in ATTN_KERNELS:
            fn.by_kind = {}


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def read_kinds():
    """``{K4/K5 name: {block kind: launches}}`` (``block_kind``)."""
    return {name: dict(fn.by_kind) for name, fn in counters().items()
            if name in ATTN_KERNELS}


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def captured_shapes(model, metas, x, loss_of):
    """One captured (a, g) of ``model`` on input ``x`` (loss
    ``loss_of(outputs)``), grouped into the distinct (kernel, shape)
    launches of one factor step with their multiplicity. Dense captures
    with sequence dims are mean-reduced first, as ``compute_a_dense`` /
    ``compute_g_dense`` do before K2."""
    from kfac_pytorch_tpu_torch import capture
    model.train()
    with capture.Capture(model, metas) as cap:
        loss_of(model(x)).backward()
    model.zero_grad(set_to_none=True)
    cases = {}
    for meta in metas:
        a = capture.layer_act(cap.acts, meta).contiguous()
        g = capture.layer_g(cap.gs, meta).contiguous()
        if meta.kind == 'conv':
            sides = [('K1 conv_a', 'conv A', a), ('K2 stat_rows', 'conv G', g)]
        else:
            if a.ndim > 2:
                a = a.mean(dim=tuple(range(1, a.ndim - 1)))
                g = g.mean(dim=tuple(range(1, g.ndim - 1)))
            sides = [('K2 stat_rows', 'dense A', a),
                     ('K2 stat_rows', 'dense G', g)]
        for kname, what, t in sides:
            # an A side's factor takes the bias column: the same rows with
            # and without it are two launches
            key = (kname, what, tuple(t.shape),
                   (meta.kernel_size, meta.strides) if what == 'conv A'
                   else None, meta.use_bias if what.endswith('A') else None)
            if key not in cases:
                cases[key] = {'kernel': kname, 'what': what, 'meta': meta,
                              'x': t, 'count': 0}
            cases[key]['count'] += 1
    return list(cases.values())


def resnet_cases(tr):
    from kfac_pytorch_tpu_torch import training
    batch = tr.to_device(next(tr.train_loader.epoch()))
    model = tr.state.model
    return captured_shapes(
        model, tr.precond.plan.metas,
        training.model_input(model, batch['input']),
        lambda out: torch.nn.functional.cross_entropy(out, batch['label']))


def lm_cases(tr):
    from kfac_pytorch_tpu_torch import train_lm
    batch = tr.to_device(next(tr.batches()))
    return captured_shapes(tr.state.model, tr.precond.plan.metas,
                           batch['input'],
                           lambda out: train_lm.loss_fn(out, batch))


def kernel_fns(case, x, ema):
    """(kernel call, plain call, lhs, rhs) of one case: the library
    yardstick (:func:`library_gemm`) is ``lhs.T @ rhs`` on the rows
    materialized in ``x``'s dtype."""
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    from kfac_pytorch_tpu_torch.ops import factors
    meta, what = case['meta'], case['what']
    if what == 'conv A':
        args = (x, meta.kernel_size, meta.strides, meta.padding,
                meta.use_bias)
        rows = factors.extract_patches(*args[:4]).reshape(
            -1, meta.in_dim - meta.use_bias)
        rows = rows / (rows.shape[0] // x.shape[0])
        n = x.shape[0]
        return (lambda: ck.compute_a_conv(*args, ema=ema),
                lambda: ck._conv_a_plain(*args, ema=ema),
                rows, rows / n)
    if what == 'conv G':
        r = x.reshape(-1, x.shape[-1])
        r = r * x.shape[0] * (x.shape[1] * x.shape[2])
        return (lambda: ck.compute_g_conv(x, True, ema=ema),
                lambda: ck._stat_rows_plain(
                    x.reshape(-1, x.shape[-1]), r.shape[0],
                    (x.shape[0], x.shape[1] * x.shape[2]), False, ema),
                r, r / r.shape[0])
    if what == 'dense A':
        r = factors._append_ones_column(x) if meta.use_bias else x
        return (lambda: ck.compute_a_dense(x, meta.use_bias, ema=ema),
                lambda: ck._stat_rows_plain(x, x.shape[0], (),
                                            meta.use_bias, ema),
                r, r / x.shape[0])
    r = x * x.shape[0]
    return (lambda: ck.compute_g_dense(x, True, ema=ema),
            lambda: ck._stat_rows_plain(x, x.shape[0], (x.shape[0],),
                                        False, ema),
            r, r / x.shape[0])


def library_gemm(lhs_t, rhs):
    """One library call for ``lhs_t @ rhs`` with an fp32 result: fp32
    rows in an fp32 GEMM (TF32 off), bf16 rows in a bf16 tensor-core GEMM
    that accumulates and returns fp32 (``mm``'s ``out_dtype``)."""
    if lhs_t.dtype == torch.float32:
        return torch.matmul(lhs_t, rhs)
    return torch.mm(lhs_t, rhs, out_dtype=torch.float32)


def check_kernels(cases, path, dtypes=None, timed=torch.float32):
    """Each case's kernel against its plain version, with and without the
    EMA, in each of ``dtypes`` (default: fp32, and bf16 at the 16-channel
    shapes); in the ``timed`` dtype also bitwise over two runs and timed
    beside the plain version, the library yardstick and the bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows_out = []
    for case in cases:
        for dtype in dtypes or (torch.float32, torch.bfloat16):
            if (dtypes is None and dtype == torch.bfloat16
                    and case['x'].shape[-1] != 16):
                continue  # bf16 inputs: checked at the 16-channel shapes
            x = case['x'].to(dtype)
            f = {'conv A': case['meta'].in_dim, 'dense A':
                 case['meta'].in_dim}.get(case['what'], x.shape[-1])
            cur = torch.eye(f, device=DEVICE) + 0.01 * torch.randn(
                f, f, device=DEVICE, generator=gen)
            errs = []
            scale = None
            for ema in (None, (cur, 0.95)):
                kern, plain, _, _ = kernel_fns(case, x, ema)
                got = kern()
                # the reference: the plain version's statistic summed in
                # fp64 and rounded once (one fp32 GEMM over thousands of
                # rows rounds further from it than the tolerance)
                with fp64_stat_gemm():
                    want = plain()
                if scale is None:
                    scale, stat = cs_scale(want), want
                torch.cuda.synchronize()
                if got.shape != (f, f) or not bool(torch.isfinite(got).all()):
                    fail(f"{case['kernel']} {case['what']} {tuple(x.shape)}: "
                         f'shape {tuple(got.shape)} or non-finite output')
                err, ok = close(got, want, RTOL, ATOL, scale, stat,
                                None if ema is None else ema[1])
                if not ok:
                    fail(f"{case['kernel']} {case['what']} {tuple(x.shape)} "
                         f'{dtype} ema={ema is not None}: max |err| {err:.3e} '
                         f'outside rtol {RTOL} atol {ATOL}')
                errs.append(err)
            row = {'path': path, 'kernel': case['kernel'],
                   'what': case['what'],
                   'shape': list(x.shape), 'dtype': str(dtype)[6:], 'F': f,
                   'per_step': case['count'], 'max_abs_err': max(errs)}
            if dtype == timed:
                ema = (cur, 0.95)
                kern, plain, lhs, rhs = kernel_fns(case, x, ema)
                nrows = lhs.shape[0]
                lhs_t = lhs.T.contiguous()
                row['ms'] = time_ms(kern)
                row['wrapper_ms'] = time_ms(kern, hide_host=False)
                row['plain_ms'] = time_ms(plain)
                row['library_ms'] = time_ms(lambda: library_gemm(lhs_t, rhs))
                nbytes = x.numel() * x.element_size() + 2 * f * f * 4
                # the output is symmetric: its F(F+1)/2 distinct entries
                # take one multiply and one add per row each
                flops = float(nrows) * f * (f + 1)
                row['bytes_ms'] = nbytes / PEAK_BYTES * 1e3
                row['ops_ms_fp32'] = flops / PEAK_FP32 * 1e3
                # fp32 inputs: K1 runs on the tensor cores, three TF32
                # passes; K2 on the fp32 units. bf16 inputs: the products
                # of bf16 operands at the bf16 tensor-core rate
                if dtype == torch.bfloat16:
                    row['ops_ms'] = flops / PEAK_BF16 * 1e3
                elif case['kernel'] == 'K1 conv_a':
                    row['ops_ms'] = TF32_PASSES * flops / PEAK_TF32 * 1e3
                else:
                    row['ops_ms'] = row['ops_ms_fp32']
                row['bound_ms'] = max(row['bytes_ms'], row['ops_ms'])
                check_bitwise_repeat(f"{case['kernel']} {case['what']} "
                                     f'{tuple(x.shape)}',
                                     lambda: (kern(),), ('stat',))
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    return rows_out


#: layer geometries off the main path (bias column, odd channel counts,
#: asymmetric padding, non-square taps, unaligned widths), checked like
#: the main path's shapes but not timed: (input shape, kernel size,
#: strides, padding, bias) for K1, (rows shape, bias) for K2's dense A
OFF_PATH_K1 = [((8, 9, 9, 6), (3, 3), (2, 2), ((1, 2), (0, 1)), True),
               ((4, 7, 7, 8), (1, 3), (1, 2), 'SAME', True),
               ((3, 6, 5, 20), (3, 3), (1, 1), 'VALID', False),
               # F = 289 (> 256, odd: a third chunk) and F = 45 (not a
               # multiple of 8)
               ((4, 12, 12, 32), (3, 3), (1, 1), 'SAME', True),
               ((6, 10, 10, 5), (3, 3), (1, 1), 'SAME', False),
               # Inception-v4's 1x7/7x1 pair and its VALID stride-2 3x3
               # on an odd map
               ((4, 17, 17, 24), (1, 7), (1, 1), (0, 3), False),
               ((4, 17, 17, 24), (7, 1), (1, 1), (3, 0), False),
               ((4, 15, 15, 16), (3, 3), (2, 2), 'VALID', False)]
#: ... and K2 tall and narrow with the ones column, short and wide
OFF_PATH_K2 = [((32, 12), True), ((50, 13), True), ((7, 3), False),
               ((20000, 64), True), ((3, 1024), True)]


def check_off_path():
    """K1 and K2 against their plain versions at OFF_PATH_* geometries,
    fp32 and bf16, with and without the EMA."""
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    cases = []
    for shape, ksize, strides, padding, bias in OFF_PATH_K1:
        args = (ksize, strides, padding, bias)
        f = ksize[0] * ksize[1] * shape[-1] + bias
        cases.append((shape, f, lambda x, ema, a=args: ck.compute_a_conv(
            x, *a, ema=ema), lambda x, ema, a=args: ck._conv_a_plain(
            x, *a, ema=ema)))
    for shape, bias in OFF_PATH_K2:
        cases.append((shape, shape[-1] + bias,
                      lambda x, ema, b=bias: ck.compute_a_dense(x, b,
                                                                ema=ema),
                      lambda x, ema, b=bias: ck._stat_rows_plain(
                          x, x.shape[0], (), b, ema)))
    worst = 0.0
    for shape, f, kern, plain in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            cur = torch.randn(f, f, device=DEVICE, generator=gen)
            scale = None
            for ema in (None, (cur, 0.95)):
                got, want = kern(x, ema), plain(x, ema)
                if scale is None:
                    scale, stat = cs_scale(want), want
                err, ok = close(got, want, RTOL, ATOL, scale, stat,
                                None if ema is None else ema[1])
                worst = max(worst, err)
                if not ok:
                    fail(f'off-path {tuple(shape)} {dtype} ema='
                         f'{ema is not None}: max |err| {err:.3e}')
    torch.cuda.synchronize()
    print(f'off-path geometries: {len(cases)} cases x 2 dtypes x +-EMA, '
          f'max |err| {worst:.3e}', flush=True)


#: kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    'K1 conv_a': ('kfac_pytorch_tpu_torch/csrc/capture.cu',
                  'kfac_pytorch_tpu/ops/pallas_capture.py:314'),
    'K2 stat_rows': ('kfac_pytorch_tpu_torch/csrc/capture.cu',
                     'kfac_pytorch_tpu/ops/pallas_capture.py:207'),
    'K3 ef_quantize': ('kfac_pytorch_tpu_torch/csrc/capture.cu',
                       'kfac_pytorch_tpu/ops/pallas_capture.py:478'),
    'K4 flash_fwd': ('kfac_pytorch_tpu_torch/csrc/attention.cu',
                     'kfac_pytorch_tpu/ops/pallas_attention.py:56'),
    'K5a flash_bwd_dq': ('kfac_pytorch_tpu_torch/csrc/attention.cu',
                         'kfac_pytorch_tpu/ops/pallas_attention.py:270'),
    'K5b flash_bwd_dkv': ('kfac_pytorch_tpu_torch/csrc/attention.cu',
                          'kfac_pytorch_tpu/ops/pallas_attention.py:302'),
}


def kernel_summary(rows, launches, names=tuple(KERNELS), suffix=''):
    """Per kernel of ``names``: times summed over the launches of one step
    of each main path that runs it (each distinct shape of ``rows`` times
    its count per step; a factor step for K1/K2, a training step for
    K4/K5). ``ms`` is device time; ``wrapper_ms`` the same calls timed
    with the wrapper's host work and launch latency exposed. ``launches``
    is the sum over the main paths' runs (``launches_by_path``). The row's
    name is the kernel's plus ``suffix``."""
    out = []
    for name in names:
        source, replaces = KERNELS[name]
        mine = [r for r in rows if r['kernel'] == name]
        timed = [r for r in mine if 'ms' in r]

        def tot(k):
            return sum(r[k] * r['per_step'] for r in timed)

        by_path = {path: counts[name] for path, counts in launches.items()
                   if counts[name]}
        has_library = all(r.get('library_ms') is not None for r in timed)
        row = {
            'name': name + suffix, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': sum(by_path.values()),
            'launches_by_path': by_path,
            'max_abs_err': max(r['max_abs_err'] for r in mine),
            'ms': tot('ms'), 'wrapper_ms': tot('wrapper_ms'),
            'plain_ms': tot('plain_ms'), 'bound_ms': tot('bound_ms'),
            'bound_by': ('operations' if tot('ops_ms') >= tot('bytes_ms')
                         else 'bytes'),
            'library_ms': tot('library_ms') if has_library else None}
        if name.startswith('K4'):
            row['library_note'] = ('scaled_dot_product_attention forward, '
                                   'the normalized output (K4 returns the '
                                   'unnormalized m, l, pv)')
        if name.startswith('K5'):
            row['library_note'] = ('scaled_dot_product_attention backward, '
                                   'dq, dk and dv together (K5a + K5b)')
        if name.startswith('K3'):
            row['library_note'] = ('none: no one PyTorch call adds, rounds '
                                   'to bf16 and keeps the rounding error')
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer, fused and against the unfused path
# ---------------------------------------------------------------------------

def make_trainer(capture_impl, extra=()):
    from kfac_pytorch_tpu_torch import train_cifar
    argv = ['--device', 'cuda'] + list(extra)
    if capture_impl is not None:
        argv += ['--kfac-capture-impl', capture_impl]
    return train_cifar.Trainer(train_cifar.parse_args(argv))


def run_trainer():
    tr = make_trainer('auto')
    layers = tr.precond.plan.metas
    n_conv = sum(m.kind == 'conv' for m in layers)
    n_dense = len(layers) - n_conv
    batches = tr.train_loader.epoch()
    reset_counts()
    losses, times, decomp_steps = [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        if 'decomp' in tr.step_fn.last_phases:
            decomp_steps.append(i)
    launches = read_counts()
    if not all(np.isfinite(losses)):
        fail(f'non-finite training loss: {losses}')
    want = {'K1 conv_a': n_conv * TRAIN_STEPS,
            'K2 stat_rows': (n_conv + 2 * n_dense) * TRAIN_STEPS,
            'K3 ef_quantize': 0, 'K4 flash_fwd': 0, 'K5a flash_bwd_dq': 0,
            'K5b flash_bwd_dkv': 0}
    if launches != want:
        fail(f'kernel launches {launches}, expected {want}')
    expect_decomp = [i for i in range(TRAIN_STEPS)
                     if i % tr.precond.kfac_update_freq == 0]
    if decomp_steps != expect_decomp:
        fail(f'decomposition ran on steps {decomp_steps}, expected '
             f'{expect_decomp}')
    print(f'trainer (world=1, no process group): resnet32 bs128 eigen_dp '
          f'capture_impl=auto, '
          f'{TRAIN_STEPS} steps, losses {[round(x, 4) for x in losses]}, '
          f'step ms median {float(np.median(times)):.3f} '
          f'(first {times[0]:.1f}, decomposition step 10 {times[10]:.1f}), '
          f'launches {launches}, decomposition on steps {decomp_steps}',
          flush=True)
    return tr, launches, times


def per_step(launches):
    """Wrapper calls a step from a TRAIN_STEPS run's launch counts."""
    return {k: v // TRAIN_STEPS for k, v in launches.items()}


def kernel_group(name):
    """The port's kernel body a profiler kernel name belongs to, or None:
    K1 ``conv_a_kernel`` and its split reduce ``split_reduce_kernel``, K2
    ``stat_tall_kernel`` / ``stat_wide_kernel``, K3, K4, K5a, K5b."""
    for kernel, body in (('K1', 'conv_a_kernel'),
                         ('K1', 'split_reduce_kernel'),
                         ('K2', 'stat_tall_kernel'),
                         ('K2', 'stat_wide_kernel'),
                         ('K3', 'ef_quantize_kernel')):
        if body in name:
            return f'{kernel} {body}'
    for body in ('fwd_kernel', 'dq_kernel', 'dkv_kernel'):
        if f'::{body}<' in name:
            return f'attention {body}'
    return None


def profile_steps(tr, batches, label, per_step, steps=3, host=True):
    """Device time by kernel over ``steps`` factor-update steps
    (torch.profiler; with a decomposition only on a path that runs one
    every step), after one warm step, and the device's busy share of the
    wall time. ``host=False`` traces the device alone (a step of tens of
    thousands of solver kernels takes minutes to trace with the host ops).
    Fails unless the profile shows K1's and
    K2's bodies launched as often as ``per_step`` (wrapper calls a step by
    kernel name) says: one device kernel a K2 call, one ``conv_a_kernel``
    a K1 call. Returns the summary dict."""
    from torch.profiler import ProfilerActivity, profile
    tr.train_step(next(batches))
    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if host else [])
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.train_step(next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith('CUDA'):
            continue  # host ops: their device time is their kernels'
        dev = getattr(ev, 'self_device_time_total',
                      getattr(ev, 'self_cuda_time_total', 0)) / 1e3
        if dev > 0:
            rows.append((dev / steps, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # the port's own kernels' device time per step, by body
    ours, calls = {}, {}
    for ms, n, k in rows:
        group = kernel_group(k)
        if group is not None:
            ours[group] = ours.get(group, 0.0) + ms
            calls[group] = calls.get(group, 0) + n
    out = {'path': label, 'steps': steps, 'wall_ms_per_step': wall / steps,
           'device_ms_per_step': busy, 'port_kernels_ms': ours,
           'port_kernel_calls_per_step': calls,
           'top': [{'name': k[:80], 'ms_per_step': ms, 'calls_per_step': n}
                   for ms, n, k in rows[:20]]}
    if busy == 0:
        print(f'profile ({label}): torch.profiler saw no device time',
              flush=True)
        return out
    print(f'profile ({label}): {steps} factor steps, wall '
          f'{wall / steps:.2f} ms/step, device busy {busy:.2f} ms/step '
          f'({100 * busy / (wall / steps):.1f}%), port kernels ms/step '
          f'{json.dumps(ours)}, calls/step {json.dumps(calls)}', flush=True)
    k2 = sum(n for g, n in calls.items() if g.startswith('K2'))
    if (k2 != per_step['K2 stat_rows']
            or calls.get('K1 conv_a_kernel', 0) != per_step['K1 conv_a']):
        fail(f'profile ({label}): device kernels a step {calls}, expected '
             f"one a call: K1 {per_step['K1 conv_a']}, K2 "
             f"{per_step['K2 stat_rows']}")
    for ms, n, k in rows[:12]:
        print(f'  {ms:8.3f} ms {n:5d}x  {k[:90]}', flush=True)
    return out


def check_agreement():
    """The fused path (capture_impl='auto') against the unfused one (None),
    from the same weights and batches, two ways.

    Lockstep, as tests/test_pallas_capture.py holds the JAX kernels: both
    preconditioners see the SAME gradients and captures every step (taken
    from the unfused model); each keeps its own factors and SGD state.
    Factors, preconditioned gradients and parameters are held to
    FACTOR_*/GRAD_* tolerances.

    Trajectory: trainers run on their own from the same seed, as the
    trainer runs and again with cuDNN held to deterministic algorithms.
    The fused run's losses are held to RTOL against the unfused run's.
    How far its parameters part from the unfused run's, relative to the
    update's norm, is held to TRAJ_FACTOR times the larger of two
    controls of the unfused path: a rerun (run-to-run nondeterminism) and
    one with the factor GEMMs summed in fp64 (another summation order of
    the same statistics). Three steps turn any rounding-level difference,
    whatever its source, into a gap of a few 1e-3 of the update norm; the
    fused path's gap is of that size, not a kernel fault."""
    bad = lockstep()
    # the free trajectories, as the trainer runs and again with cuDNN held
    # to deterministic algorithms (which takes its noise out of the rerun)
    for label, ctl in (('', ()), (', deterministic cuDNN',
                                  (deterministic_cudnn,))):
        losses_ref, p0, p_ref = trajectory(None, *ctl)
        runs = {'fused': trajectory('auto', *ctl),
                'unfused rerun': trajectory(None, *ctl),
                'unfused, fp64 factor GEMM': trajectory(None, fp64_stat_gemm,
                                                        *ctl)}
        for i, l_ref in enumerate(losses_ref):
            l_fused = runs['fused'][0][i]
            rel = abs(l_ref - l_fused) / abs(l_ref)
            print(f'agreement (trajectory{label}) step {i}: loss '
                  f'{l_fused:.6f} vs {l_ref:.6f}, rel err {rel:.3e}',
                  flush=True)
            if rel > RTOL:
                bad.append(f'trajectory{label} step {i} loss {l_fused} vs '
                           f'{l_ref}')
        gaps = report_gaps(label, runs, p_ref, p0)
        control = max(v for k, v in gaps.items() if k != 'fused')
        if gaps['fused'] > TRAJ_FACTOR * control:
            bad.append(f"trajectory{label} params: fused gap "
                       f"{gaps['fused']:.3e} over {TRAJ_FACTOR} x the "
                       f"controls' {control:.3e}")
    if bad:
        fail('; '.join(bad))


def lockstep(extra=(), label='', control=False):
    """The lockstep half of :func:`check_agreement` for the ResNet-32
    trainer with the flags ``extra``; returns the failures. With E-KFAC
    the moments' largest gap (relative to each group's largest entry) is
    printed beside the gradients'.

    With ``control`` a third preconditioner takes the unfused path with
    its factor GEMMs summed in fp64, and the preconditioned gradients are
    held by the ResNet-50 lockstep's rule: a step fails when its worst
    tensor parts from the unfused path by more than GRAD_RTOL of its
    largest entry and by more than TRAJ_FACTOR x the control's gap. The
    E-KFAC moments divide each eigen-coordinate separately, so a
    rounding-level change of the factors moves the preconditioned
    gradient by the basis' sensitivity, ~1e-3 (PERF.md §6, E-KFAC); the
    control shows how far the factors' summation order alone moves it."""
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams
    ref, fused = make_trainer(None, extra), make_trainer('auto', extra)
    it = ref.train_loader.epoch()
    bad = []
    tag = f'{label}: ' if label else ''
    st_ref, st_fused = ref.state.kfac_state, fused.state.kfac_state
    st_ctl = ref.precond.init(ref.device) if control else None
    params_ref = dict(ref.state.model.named_parameters())
    params_fused = dict(fused.state.model.named_parameters())
    for i in range(AGREE_STEPS):
        batch = ref.to_device(next(it))
        model = ref.state.model
        model.zero_grad(set_to_none=True)
        with capture.Capture(model, ref.precond.plan.metas) as cap:
            out = model(batch['input'].permute(0, 3, 1, 2))
            torch.nn.functional.cross_entropy(out, batch['label']).backward()
        grads = {k: p.grad for k, p in params_ref.items()}
        hyper = KFACHyperParams(lr=ref.lr_fn(i), damping=ref.precond.damping)
        kw = dict(hyper=hyper, update_factors=True,
                  update_inverse=ref.precond.should_update_inverse(i))
        pg_ref, st_ref = ref.precond.step(st_ref, grads, cap.acts, cap.gs,
                                          **kw)
        pg_fused, st_fused = fused.precond.step(st_fused, grads, cap.acts,
                                                cap.gs, **kw)
        ctl = ''
        if control:
            with fp64_stat_gemm():
                pg_ctl, st_ctl = ref.precond.step(st_ctl, grads, cap.acts,
                                                  cap.gs, **kw)
            (gap, gk), (cgap, ck_) = (grad_gap(pg_fused, pg_ref),
                                      grad_gap(pg_ctl, pg_ref))
            ctl = f'; control (fp64 factor GEMMs) {cgap:.3e} ({ck_})'
            if gap > GRAD_RTOL and gap > TRAJ_FACTOR * cgap:
                bad.append(f'{tag}step {i} preconditioned grad {gk} '
                           f'{gap:.3e} of its largest entry, over '
                           f'{GRAD_RTOL} and {TRAJ_FACTOR} x the control '
                           f'{cgap:.3e}')
        ref.tx.apply(params_ref, pg_ref, ref.state.opt_state, i)
        fused.tx.apply(params_fused, pg_fused, fused.state.opt_state, i)
        worst = (0.0, '')
        for k in pg_ref:
            err, ok = close_tensor(pg_fused[k], pg_ref[k], GRAD_RTOL,
                                   GRAD_ATOL)
            worst = max(worst, (err / max(float(pg_ref[k].detach().abs()
                                                .max()), 1e-30), k))
            if not ok and not control:
                bad.append(f'{tag}step {i} preconditioned grad {k}: max '
                           f'|err| {err:.3e}')
        fac = 0.0
        for k, v in st_ref.factors.items():
            s = cs_scale(v)
            err, ok = close(st_fused.factors[k], v, FACTOR_RTOL, FACTOR_ATOL,
                            s)
            fac = max(fac, float(((st_fused.factors[k].double()
                                   - v.double()).abs() / s).max()))
            if not ok:
                bad.append(f'{tag}step {i} factor bucket {k}: max |err| '
                           f'{err:.3e}')
        moments = ''
        if 'scales' in st_ref.decomp:
            sg = grad_gap(st_fused.decomp['scales'], st_ref.decomp['scales'])
            moments = f', moments max rel err {sg[0]:.3e} ({sg[1]})'
        print(f'agreement (lockstep{", " + label if label else ""}) step '
              f'{i}: factors max err {fac:.3e} x sqrt(F_ii F_jj), '
              f'preconditioned grads max rel err {worst[0]:.3e} '
              f'({worst[1]}){moments}{ctl}', flush=True)
    par = (0.0, '')
    for k, v in params_ref.items():
        err, ok = close_tensor(params_fused[k], v, GRAD_RTOL, GRAD_ATOL)
        par = max(par, (err / max(float(v.detach().abs().max()), 1e-30),
                        k))
        if not ok:
            bad.append(f'{tag}parameter {k}: max |err| {err:.3e}')
    print(f'agreement (lockstep{", " + label if label else ""}): params '
          f'after {AGREE_STEPS} steps max rel err {par[0]:.3e} ({par[1]})',
          flush=True)
    return bad


def report_gaps(label, runs, p_ref, p0):
    """Print and return each run's :func:`update_gap` to ``p_ref``."""
    gaps = {}
    for name, (_, _, p) in runs.items():
        gaps[name], worst, key = update_gap(p, p_ref, p0)
        print(f'agreement (trajectory{label}) {name} vs unfused: params '
              f'after {AGREE_STEPS} steps differ by {gaps[name]:.3e} of the '
              f'update norm (worst tensor {worst:.3e}, {key})', flush=True)
    return gaps


def trajectory(capture_impl, *controls):
    """Losses, initial and final parameters of AGREE_STEPS trainer steps
    from the seed's weights and batches; each step runs inside every
    context of ``controls`` (called to make it)."""
    tr = make_trainer(capture_impl)
    params = dict(tr.state.model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    it = tr.train_loader.epoch()
    losses = []
    for _ in range(AGREE_STEPS):
        with contextlib.ExitStack() as stack:
            for control in controls:
                stack.enter_context(control())
            losses.append(float(tr.train_step(next(it))['loss']))
    return losses, p0, {k: v.detach().clone() for k, v in params.items()}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


@contextlib.contextmanager
def fp64_stat_gemm():
    """The unfused path with each factor GEMM summed in fp64 and rounded
    once to fp32: the same statistics in another summation order."""
    from kfac_pytorch_tpu_torch.ops import factors
    gemm = factors._stat_gemm
    factors._stat_gemm = lambda x, n: (
        x.double().T @ (x / n).double()).float()
    try:
        yield
    finally:
        factors._stat_gemm = gemm


def update_gap(p, p_ref, p0):
    """How far parameters ``p`` are from ``p_ref``, measured against the
    reference's update ``p_ref - p0`` (a scale that stays put for tensors
    near zero): the whole model's ``||p - p_ref|| / ||p_ref - p0||``, and
    the worst tensor's ratio with its name."""
    num = den = 0.0
    worst = (0.0, '')
    for k, v in p_ref.items():
        d = float((p[k].double() - v.double()).norm())
        u = float((v.double() - p0[k].double()).norm())
        num, den = num + d * d, den + u * u
        worst = max(worst, (d / max(u, 1e-30), k))
    return (num ** 0.5) / max(den ** 0.5, 1e-30), worst[0], worst[1]


# ---------------------------------------------------------------------------
# slice 2: the long-context LM trainer and the flash-attention kernels
# ---------------------------------------------------------------------------

def make_lm_trainer(attn_impl):
    """The LM trainer at ``examples/longcontext_lm.py``'s defaults with
    the capture kernels on."""
    from kfac_pytorch_tpu_torch import train_lm
    return train_lm.Trainer(train_lm.parse_args(
        ['--device', 'cuda', '--kfac-capture-impl', 'auto', '--attn-impl',
         attn_impl]))


def run_lm_trainer():
    tr = make_lm_trainer('auto')
    n_layer = tr.args.n_layer
    n_kfac = len(tr.precond.plan.metas)
    batches = tr.batches()
    reset_counts()
    losses, times, decomp_steps = [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        if 'decomp' in tr.step_fn.last_phases:
            decomp_steps.append(i)
    launches = read_counts()
    if not all(np.isfinite(losses)):
        fail(f'LM: non-finite training loss: {losses}')
    # every step updates the factors (kfac_cov_update_freq 1): one K2
    # launch per factor of every K-FAC layer; one attention block per
    # layer and step
    want = {'K1 conv_a': 0, 'K2 stat_rows': 2 * n_kfac * TRAIN_STEPS,
            'K3 ef_quantize': 0, 'K4 flash_fwd': n_layer * TRAIN_STEPS,
            'K5a flash_bwd_dq': n_layer * TRAIN_STEPS,
            'K5b flash_bwd_dkv': n_layer * TRAIN_STEPS}
    if launches != want:
        fail(f'LM kernel launches {launches}, expected {want}')
    expect_decomp = [i for i in range(TRAIN_STEPS)
                     if i % tr.precond.kfac_update_freq == 0]
    if decomp_steps != expect_decomp:
        fail(f'LM decomposition ran on steps {decomp_steps}, expected '
             f'{expect_decomp}')
    a = tr.args
    print(f'trainer (world=1, no process group): transformer_lm '
          f'L{a.seq_len} bs{a.batch_size} '
          f'{n_layer}x{a.d_model} vocab {tr.vocab} eigen_dp '
          f'capture_impl=auto attn=kernels, {TRAIN_STEPS} steps, losses '
          f'{[round(x, 4) for x in losses]}, step ms median '
          f'{float(np.median(times)):.3f} (first {times[0]:.1f}, '
          f'decomposition step 10 {times[10]:.1f}), launches {launches}, '
          f'{n_kfac} K-FAC layers, decomposition on steps {decomp_steps}',
          flush=True)
    return tr, launches, times


def attn_inputs(bh, lq, lk, d, masked, gen):
    """Random q/k/v, key mask (1 = attend, 20% masked when ``masked``)
    and cotangents dl/dpv on the card."""
    def randn(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)
    mask = ((torch.rand(bh, lk, device=DEVICE, generator=gen) > 0.2).float()
            if masked else torch.ones(bh, lk, device=DEVICE))
    return (randn(bh, lq, d), randn(bh, lk, d), randn(bh, lk, d), mask,
            randn(bh, lq), randn(bh, lq, d))


def attn_calls(q, k, v, mask, dl, dpv, starts, causal):
    """``{kernel: (kernel call, plain call, output names)}`` of one block;
    the backward takes the plain forward's m."""
    from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
    scale = q.shape[-1] ** -0.5
    m = ak._fwd_plain(q, k, v, mask, starts, scale, causal)[0]
    fwd = (q, k, v, mask, starts, scale, causal)
    bwd = (q, k, v, mask, m, dl, dpv, starts, scale, causal)
    return {'K4 flash_fwd': (lambda: ak.flash_fwd(*fwd),
                             lambda: ak._fwd_plain(*fwd), ('m', 'l', 'pv')),
            'K5a flash_bwd_dq': (lambda: (ak.flash_bwd_dq(*bwd),),
                                 lambda: (ak._bwd_dq_plain(*bwd),), ('dq',)),
            'K5b flash_bwd_dkv': (lambda: ak.flash_bwd_dkv(*bwd),
                                  lambda: ak._bwd_dkv_plain(*bwd),
                                  ('dk', 'dv'))}


def attn_bound(name, bh, lq, lk, d, starts, causal):
    """(bytes ms, fp32 operations ms, tensor-core operations ms) of one
    launch: each input read once, each output written once; 4D (K4), 6D
    (K5a) or 8D (K5b) operations per (query, key) pair the causal mask
    keeps, over the fp32 rate and, three TF32 passes each, over the TF32
    tensor-core rate. A block the mask keeps no pair of reads nothing:
    its outputs are constants, (-1e30, 0, 0) from K4 and zeros from K5,
    so only they are counted."""
    if causal:
        qpos = starts[0] + np.arange(lq)
        pairs = bh * int(np.clip(qpos - starts[1] + 1, 0, lk).sum())
    else:
        pairs = bh * lq * lk
    read = 1 if pairs else 0
    qkv = read * (bh * lq * d + 2 * bh * lk * d + bh * lk) * 4  # q k v mask
    if name == 'K4 flash_fwd':   # writes m, l, pv
        nbytes, per_pair = qkv + (2 * bh * lq + bh * lq * d) * 4, 4
    elif name == 'K5a flash_bwd_dq':   # reads m, dl, dpv; writes dq
        nbytes, per_pair = (qkv + read * (2 * bh * lq + bh * lq * d) * 4
                            + bh * lq * d * 4), 6
    else:   # reads m, dl, dpv; writes dk, dv
        nbytes, per_pair = (qkv + read * (2 * bh * lq + bh * lq * d) * 4
                            + 2 * bh * lk * d * 4), 8
    ops = pairs * per_pair * d
    return (nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3,
            TF32_PASSES * ops / PEAK_TF32 * 1e3)


ATTN_KERNELS = ('K4 flash_fwd', 'K5a flash_bwd_dq', 'K5b flash_bwd_dkv')


def check_attention(n_layer, n_head):
    """K4/K5a/K5b against their plain versions at the LM trainer's block
    (timed, with the bound and the library yardstick) and at ATTN_OFF_PATH
    (checked). Returns the per-kernel rows of the main shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    worst = {name: 0.0 for name in ATTN_KERNELS}
    cases = [ATTN_MAIN + (True, (0, 0), False)] + ATTN_OFF_PATH
    rows = []
    for ci, (bh, lq, lk, d, causal, starts, masked) in enumerate(cases):
        inputs = attn_inputs(bh, lq, lk, d, masked, gen)
        for name, (kern, plain, outs) in attn_calls(*inputs, starts,
                                                    causal).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            for o, g, w in zip(outs, got, want):
                if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                    fail(f'{name} {o} {(bh, lq, lk, d)}: shape '
                         f'{tuple(g.shape)} or non-finite output')
                err, ok = close(g, w, ATTN_TOL[o], ATTN_TOL[o])
                worst[name] = max(worst[name], err)
                if not ok:
                    fail(f'{name} {o} at (BH, Lq, Lk, D) {(bh, lq, lk, d)} '
                         f'causal={causal} starts={starts}: max |err| '
                         f'{err:.3e} outside {ATTN_TOL[o]}')
            if ci:
                continue
            check_bitwise_repeat(name, kern, outs)
            bytes_ms, fp32_ms, tc_ms = attn_bound(name, bh, lq, lk, d,
                                                  starts, causal)
            rows.append({'path': 'transformer_lm', 'kernel': name,
                         'shape': [bh, lq, lk, d], 'causal': causal,
                         'per_step': n_layer, 'ms': time_ms(kern),
                         'wrapper_ms': time_ms(kern, hide_host=False),
                         'plain_ms': time_ms(plain), 'bytes_ms': bytes_ms,
                         'ops_ms': tc_ms, 'ops_ms_fp32': fp32_ms,
                         'bound_ms': max(bytes_ms, tc_ms)})
        if ci == 0:
            library = library_attention_ms(*inputs[:3], n_head)
            for r in rows:
                r['library_ms'] = library['fwd' if r['kernel'].startswith(
                    'K4') else 'bwd']
    for r in rows:
        r['max_abs_err'] = worst[r['kernel']]
        print(json.dumps(r), flush=True)
    print(f'attention kernels vs plain: the main shape and '
          f'{len(ATTN_OFF_PATH)} off-path geometries, max |err| '
          f'{json.dumps(worst)}', flush=True)
    check_misaligned(gen)
    return rows


def check_misaligned(gen):
    """The attention kernels read rows as 16-byte vectors: each wrapper
    must raise ValueError, and launch nothing, when one of the tensors it
    reads so (q, k, v, dpv) is a contiguous view starting 4 bytes into its
    storage."""
    from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
    bh, lq, lk, d = 2, 64, 64, 32
    q, k, v, mask, dl, dpv = attn_inputs(bh, lq, lk, d, False, gen)
    m = ak._fwd_plain(q, k, v, mask, (0, 0), d ** -0.5, True)[0]

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4
        return out

    wrappers = {
        'K4 flash_fwd': (lambda t: ak.flash_fwd(
            t['q'], t['k'], t['v'], mask, (0, 0), d ** -0.5, True),
            ('q', 'k', 'v')),
        'K5a flash_bwd_dq': (lambda t: ak.flash_bwd_dq(
            t['q'], t['k'], t['v'], mask, m, dl, t['dpv'], (0, 0),
            d ** -0.5, True), ('q', 'k', 'v', 'dpv')),
        'K5b flash_bwd_dkv': (lambda t: ak.flash_bwd_dkv(
            t['q'], t['k'], t['v'], mask, m, dl, t['dpv'], (0, 0),
            d ** -0.5, True), ('q', 'k', 'v', 'dpv'))}
    before = read_counts()
    for name, (call, names) in wrappers.items():
        for which in names:
            t = {'q': q, 'k': k, 'v': v, 'dpv': dpv}
            t[which] = shifted(t[which])
            try:
                call(t)
            except ValueError:
                continue
            fail(f'{name}: {which} starting 4 bytes into its storage was '
                 f'not refused')
    torch.cuda.synchronize()
    if read_counts() != before:
        fail(f'a refused misaligned call launched a kernel: '
             f'{read_counts()} vs {before}')
    print('attention wrappers refuse inputs not 16-byte aligned (q, k, v; '
          'dpv for K5a/K5b)', flush=True)


def check_bitwise_repeat(name, kern, outs):
    """No atomics: two launches on the same inputs give the same bits."""
    first, second = kern(), kern()
    torch.cuda.synchronize()
    for o, a, b in zip(outs, first, second):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f'{name} {o}: two runs on the same inputs differ '
                 f'(max |diff| {float((a - b).abs().max()):.3e})')
    print(f'{name}: two runs at the main shape bitwise equal', flush=True)


def sass_and_ptxas(name):
    """For ``csrc/<name>.cu``'s built library: per kernel function, its
    ``HGMMA``/``HMMA`` instructions in the SASS (``cuobjdump --dump-sass``)
    and ``ptxas -v``'s registers and spill bytes."""
    import re
    from kfac_pytorch_tpu_torch.ops import _cuda_build
    lib = _cuda_build.build(os.path.join(_cuda_build.CSRC, f'{name}.cu'))
    cuobjdump = os.path.join(os.path.dirname(_cuda_build.nvcc_path()),
                             'cuobjdump')
    dump = subprocess.run([cuobjdump, '--dump-sass', lib],
                          capture_output=True, text=True, check=True).stdout
    sass, cur = {}, None
    for line in dump.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            cur = m.group(1)
            sass[cur] = {'HGMMA': 0, 'HMMA': 0}
        elif cur:
            for op in sass[cur]:
                sass[cur][op] += bool(re.search(rf'\b{op}\b', line))
    ptxas, cur = {}, None
    with open(_cuda_build.ptxas_log(name)) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
                ptxas[cur] = {}
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
            if m and cur:
                ptxas[cur]['spill_bytes'] = int(m.group(1)) + int(m.group(2))
            m = re.search(r'Used (\d+) registers', line)
            if m and cur:
                ptxas[cur]['registers'] = int(m.group(1))
    return sass, ptxas


def build_report():
    """The tensor-core kernels as built: K1 (fp32 and bf16 inputs; one
    kernel serves every ResNet width, its chunk width chosen per block) and
    K4/K5a/K5b at every head dim. Per kernel: ``HGMMA``/``HMMA`` counts,
    registers, spills, dynamic shared memory and resident blocks per SM.
    Fails if one has no tensor-core instruction, or if K1 or K4 spills."""
    from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    report = []

    def add(kname, fn, sass, ptxas, extra):
        row = {'kernel': kname, **extra, **sass[fn], **ptxas.get(fn, {})}
        if not row['HGMMA'] + row['HMMA']:
            fail(f'{kname} {extra}: no tensor-core instruction in its SASS')
        report.append(row)
        print(json.dumps(row), flush=True)
        return row

    sass, ptxas = sass_and_ptxas('capture')
    # the power-of-two divisors' kernels (conv_a_kernel<T, true>), the main
    # path's
    for dtype, tag in ((torch.float32, 'conv_a_kernelIfLb1E'),
                       (torch.bfloat16, 'conv_a_kernelI13__nv_bfloat16Lb1E')):
        fn = [f for f in sass if tag in f]
        if len(fn) != 1:
            fail(f'K1 {dtype}: no single SASS function matching {tag}')
        smem, blocks = ck.conv_a_occupancy(dtype, max(ck.K1_CHUNKS))
        row = add('K1 conv_a', fn[0], sass, ptxas,
                  {'dtype': str(dtype)[6:], 'dynamic_smem_bytes': smem,
                   'blocks_per_sm': blocks,
                   'smem_bytes_by_chunk': {n: ck.conv_a_occupancy(
                       dtype, n)[0] for n in ck.K1_CHUNKS}})
        if row.get('spill_bytes', 0):
            fail(f'K1 {dtype}: ptxas reports {row["spill_bytes"]} spill '
                 'bytes')
    sass, ptxas = sass_and_ptxas('attention')
    for which, kname in (('fwd', 'K4 flash_fwd'), ('dq', 'K5a flash_bwd_dq'),
                         ('dkv', 'K5b flash_bwd_dkv')):
        for d in ak.HEAD_DIMS:
            tag = f'{which}_kernelILi{d}E'
            fn = [f for f in sass if tag in f]
            if len(fn) != 1:
                fail(f'{kname} D={d}: no single SASS function matching {tag}')
            smem, blocks = ak.occupancy(which, d)
            row = add(kname, fn[0], sass, ptxas,
                      {'D': d, 'dynamic_smem_bytes': smem,
                       'blocks_per_sm': blocks})
            if which == 'fwd' and row.get('spill_bytes', 0):
                fail(f'K4 D={d}: ptxas reports {row["spill_bytes"]} spill '
                     'bytes')
    return report


def library_attention_ms(q, k, v, heads, causal=True):
    """The library yardstick (never called by the port): one
    ``scaled_dot_product_attention`` call, causal or not, on the same
    q/k/v as ``[B, H, L, D]``, forward and (separately) backward. It
    returns the normalized output, not the kernels' (m, l, pv)."""
    F = torch.nn.functional
    bh, lq, d = q.shape
    q4, k4, v4 = (t.reshape(bh // heads, heads, t.shape[1], d)
                  .detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    dout = torch.randn_like(out)
    return {'fwd': time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)),
            'bwd': time_ms(lambda: torch.autograd.grad(
                out, (q4, k4, v4), dout, retain_graph=True))}


def check_lm_agreement():
    """The kernel trainer (--attn-impl auto) in lockstep with the plain-
    attention one (--attn-impl xla): before each of AGREE_STEPS steps the
    kernel model takes the plain model's parameters, both step on the
    same batch (each with its own K-FAC state), and the loss, the raw
    gradients and the preconditioned gradients are held within GRAD_RTOL
    of each tensor's largest entry."""
    ref, kern = make_lm_trainer('xla'), make_lm_trainer('auto')
    p_ref = dict(ref.state.model.named_parameters())
    p_kern = dict(kern.state.model.named_parameters())
    batches = ref.batches()
    bad = []
    for i in range(AGREE_STEPS):
        with torch.no_grad():
            for k, v in p_ref.items():
                p_kern[k].copy_(v)
        batch = next(batches)
        l_ref = float(ref.train_step(batch)['loss'])
        l_kern = float(kern.train_step(batch)['loss'])
        if abs(l_kern - l_ref) > GRAD_RTOL * abs(l_ref):
            bad.append(f'step {i} loss {l_kern} vs {l_ref}')
        worst = {}
        for what, got, want in (
                ('raw', {k: p.grad for k, p in p_kern.items()},
                 {k: p.grad for k, p in p_ref.items()}),
                ('preconditioned', kern.step_fn.last_grads,
                 ref.step_fn.last_grads)):
            w = (0.0, '')
            for k in want:
                err, ok = close_tensor(got[k], want[k], GRAD_RTOL, GRAD_ATOL)
                w = max(w, (err / max(float(want[k].abs().max()), 1e-30), k))
                if not ok:
                    bad.append(f'step {i} {what} grad {k}: max |err| '
                               f'{err:.3e}')
            worst[what] = w
        print(f'agreement (LM lockstep, kernels vs plain attention) step '
              f'{i}: loss {l_kern:.6f} vs {l_ref:.6f}, raw grads max rel '
              f'err {worst["raw"][0]:.3e} ({worst["raw"][1]}), '
              f'preconditioned {worst["preconditioned"][0]:.3e} '
              f'({worst["preconditioned"][1]})', flush=True)
    if bad:
        fail('; '.join(bad))


# ---------------------------------------------------------------------------
# slice 3: world>1 K-FAC on process groups, the compressed reduce's K3
# ---------------------------------------------------------------------------

#: the world=2 trainer: ResNet-32 MPD eigen with the bf16 factor reduce,
#: at examples/cifar10_resnet.py's defaults (global batch 128, 64 a rank)
WORLD2_EIGEN = ['--kfac-name', 'eigen', '--kfac-comm-precision', 'bf16',
                '--kfac-capture-impl', 'auto']
WORLD2_DP_STEPS = 6
#: slice 10 at world=2: MPD 'ekfac' over the bf16 wire, then 'ekfac_dp'
#: over fp32 (its last step's collectives read by scope)
WORLD2_EKFAC = ['--kfac-name', 'ekfac', '--kfac-comm-precision', 'bf16',
                '--kfac-capture-impl', 'auto']
WORLD2_EKFAC_STEPS, WORLD2_EKFAC_DP_STEPS = 6, 3
#: slice 11 at world=2: the staggered refresh (4 cohorts) of eigen_dp over
#: fp32 and of MPD eigen over the bf16 wire (K3), WORLD2_STAGGER_STEPS steps
WORLD2_STAGGER = {
    'eigen_dp': ['--kfac-update-freq', '4', '--kfac-stagger',
                 '--kfac-capture-impl', 'auto'],
    'eigen bf16': ['--kfac-name', 'eigen', '--kfac-comm-precision', 'bf16',
                   '--kfac-update-freq', '4', '--kfac-stagger',
                   '--kfac-capture-impl', 'auto']}
WORLD2_STAGGER_STEPS = 8
#: decomp_shard in lockstep with owner-local stagger: a full
#: decomposition, then one cohort a step
WORLD2_SHARD_STEPS = 5
#: sharded vs owner-local rows where they are not bitwise equal (cuSOLVER
#: may take another routine for a batch of S_b matrices than of R_b):
#: tests/test_stagger.py's tolerance, |got - want| <= ATOL + RTOL |want|
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6
#: comm_prefetch on MPD eigen: decompositions at steps 0, 3 and 6, the
#: last two prefetched
WORLD2_PREFETCH = ['--kfac-name', 'eigen', '--kfac-comm-prefetch',
                   '--kfac-update-freq', '3', '--kfac-capture-impl', 'auto']
WORLD2_PREFETCH_STEPS = 7
#: slice 13 at world=2: the MPD eigen bf16 trainer with each communication
#: phase excluded (``--exclude-parts``), WORLD2_EXCLUDE_STEPS steps each
WORLD2_EXCLUDE = ('CommunicateFactor', 'CommunicateInverse')
WORLD2_EXCLUDE_STEPS = 3
#: K3 inputs off the main path: element counts (odd, one, a vector group
#: plus a tail) and whether the tensors start 4 bytes past an aligned
#: address (the kernel's scalar path)
EF_OFF_PATH = [(1, False), (3, False), (1001, False), (4097, False),
               (4096, True), (12345, True)]


def ef_special(n, gen):
    """fp32 ``(x, r)`` of ``n`` elements on the card: normal draws with
    exact bf16 ties, values past bf16's largest finite, +-Inf,
    subnormals and NaN mixed in."""
    x = torch.randn(n, device=DEVICE, generator=gen)
    r = torch.randn(n, device=DEVICE, generator=gen) * 1e-3
    specials = [(1.0 + 2.0 ** -8, 0.0), (1.0 + 3 * 2.0 ** -8, 0.0),
                (3.3961e38, 0.0), (-3.3961e38, 0.0), (float('inf'), 0.0),
                (float('-inf'), 1.0), (1e-40, 0.0), (-3e-39, 1e-41),
                (float('nan'), 0.0), (0.5, float('nan')),
                (3.4e38, 3.4e38), (0.0, -0.0)]
    idx = torch.randperm(n, device=DEVICE, generator=gen)[:len(specials)]
    for i, (a, b) in zip(idx.tolist(), specials):
        x[i], r[i] = a, b
    return x, r


def ef_bitwise(got, want):
    """K3 ``(wire, residual)`` against the plain version's: the wire as
    int16 bits, the residual as fp32 bits, NaN compared as a mask.
    Returns (equal, number of NaN entries)."""
    (w, nr), (pw, pnr) = got, want
    nan, pnan = torch.isnan(nr), torch.isnan(pnr)
    ok = torch.equal(nan, pnan) and torch.equal(
        torch.isnan(w.float()), torch.isnan(pw.float()))
    keep = ~nan
    ok = ok and torch.equal(w.view(torch.int16)[keep],
                            pw.view(torch.int16)[keep])
    ok = ok and torch.equal(nr.view(torch.int32)[keep],
                            pnr.view(torch.int32)[keep])
    return ok, int(nan.sum())


def check_ef(shapes):
    """K3 against its plain version, bitwise: at the world=2 ResNet-32
    bucket shapes ``[rows, D, D]`` (timed: device ms, wrapper ms, plain
    ms, the bytes bound), then at EF_OFF_PATH with the special values.
    Returns the per-shape rows of the main path."""
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rows = []
    for shape in shapes:
        x = torch.randn(shape, device=DEVICE, generator=gen)
        r = torch.randn(shape, device=DEVICE, generator=gen) * 1e-3
        ok, _ = ef_bitwise(ck.ef_quantize(x, r), ck._ef_quantize_plain(x, r))
        torch.cuda.synchronize()
        if not ok:
            fail(f'K3 ef_quantize {shape}: not bitwise equal to its plain '
                 'version')
        n = x.numel()
        bytes_ms = 14 * n / PEAK_BYTES * 1e3
        ops_ms = 3 * n / PEAK_FP32 * 1e3
        row = {'path': 'resnet32_world2', 'kernel': 'K3 ef_quantize',
               'shape': list(shape), 'per_step': 1, 'max_abs_err': 0.0,
               'ms': time_ms(lambda: ck.ef_quantize(x, r)),
               'wrapper_ms': time_ms(lambda: ck.ef_quantize(x, r),
                                     hide_host=False),
               'plain_ms': time_ms(lambda: ck._ef_quantize_plain(x, r)),
               'bytes_ms': bytes_ms, 'ops_ms': ops_ms,
               'bound_ms': max(bytes_ms, ops_ms), 'library_ms': None}
        rows.append(row)
        print(json.dumps(row), flush=True)
    nans = 0
    for n, shifted in EF_OFF_PATH:
        x, r = ef_special(n + shifted, gen)
        if shifted:   # views 4 bytes past an aligned start
            x, r = x[1:], r[1:]
        ok, k = ef_bitwise(ck.ef_quantize(x, r), ck._ef_quantize_plain(x, r))
        nans += k
        if not ok:
            fail(f'K3 ef_quantize off-path n={n} shifted={shifted}: not '
                 'bitwise equal to its plain version')
    torch.cuda.synchronize()
    print(f'K3 ef_quantize vs plain: bitwise at {len(shapes)} bucket shapes '
          f'and {len(EF_OFF_PATH)} off-path sizes (ties, overflow, +-Inf, '
          f'subnormals; {nans} NaN entries compared as a mask)', flush=True)
    return rows


def grad_gap(got, want):
    """The worst tensor's max |got - want| relative to its largest entry,
    and its name."""
    worst = (0.0, '')
    for k in want:
        err = float((got[k].double() - want[k].double()).abs().max())
        worst = max(worst, (err / max(float(want[k].abs().max()), 1e-30),
                            k))
    return worst


class CommTimer:
    """Host seconds spent in the port's collectives (they block on the
    host: gloo stages CUDA tensors through host memory), by wrapping the
    three collective primitives of ``parallel.collectives``."""

    NAMES = ('_all_reduce_sum', '_all_gather', '_reduce_scatter')

    def __init__(self):
        from kfac_pytorch_tpu_torch.parallel import collectives as coll
        self.coll, self.saved = coll, {}
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        for name in self.NAMES:
            fn = getattr(coll, name)
            self.saved[name] = fn
            setattr(coll, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return wrapped

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.coll, name, fn)


def world2_rank(rank, world, group):
    """One rank of the world=2 phases on cuda:0 (two ranks share the card
    over gloo): the MPD eigen bf16 trainer for TRAIN_STEPS steps with its
    launch counts, residual and replica checks; its K-FAC step in
    lockstep, kernels vs capture_impl=None (and a control: the unfused
    path with fp64 factor GEMMs), over the bf16 and the fp32 wire; the
    eigen_dp fp32 trainer for
    WORLD2_DP_STEPS steps. Returns numbers only."""
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch import train_cifar
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    def trainer(extra):
        args = train_cifar.parse_args(['--device', 'cuda', '--num-devices',
                                       str(world), '--dist-backend', 'gloo']
                                      + extra)
        return train_cifar.Trainer(args, group=group, local_rank=0)

    out = {'backend': str(torch.distributed.get_backend(group))}
    tr = trainer(WORLD2_EIGEN)
    plan = tr.precond.plan
    out['buckets'] = [[plan.buckets[d].n_rows, d, d]
                      for d in plan.bucket_dims]
    out['layers'] = {'conv': sum(m.kind == 'conv' for m in plan.metas),
                     'dense': sum(m.kind == 'dense' for m in plan.metas)}
    batches = tr.train_loader.epoch()
    timer = CommTimer()
    reset_counts()
    times, losses, agree, comm_s, resid = [], [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        c0 = dict(timer.seconds)
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        comm_s.append({k[1:]: (v - c0[k]) * 1e3
                       for k, v in timer.seconds.items()})
        losses.append(float(m['loss']))
        resid.append(float(sum(float(v.double().norm()) ** 2 for v in
                               tr.state.kfac_state.comm_err.values())) ** 0.5)
        agree.append(tr.replicas_agree())
    out['launches'] = read_counts()
    timer.close()
    # one more step's collectives by scope: the health guard's flag is one
    # scalar all-reduce (host-staged on gloo)
    with coll.ledger() as led:
        tr.train_step(next(batches))
    out['step_collectives'] = [[scope, op, str(dtype), n]
                               for scope, op, dtype, n in led]
    out.update(step_ms=times, comm_ms=comm_s, losses=losses,
               residual_norm=resid, replicas_agree=agree)
    del tr

    # lockstep over each wire: the same grads and captures into the
    # kernels' preconditioner, the unfused one and the unfused one with
    # fp64 factor GEMMs (the control)
    out['lockstep'] = {}
    for wire in ('bf16', 'fp32'):
        unfused = ['--kfac-name', 'eigen', '--kfac-comm-precision', wire]
        ref, fused, ctl = (trainer(unfused), trainer(
            unfused + ['--kfac-capture-impl', 'auto']), trainer(unfused))
        model = ref.state.model
        params = dict(model.named_parameters())
        states = [p.state.kfac_state for p in (ref, fused, ctl)]
        it = ref.train_loader.epoch()
        gaps = []
        for i in range(AGREE_STEPS):
            batch = ref.to_device(next(it))
            model.zero_grad(set_to_none=True)
            with capture.Capture(model, ref.precond.plan.metas) as cap:
                outp = model(batch['input'].permute(0, 3, 1, 2))
                torch.nn.functional.cross_entropy(
                    outp, batch['label']).backward()
            grads = coll.average_grads(
                {k: p.grad for k, p in params.items()}, group)
            pgs = []
            for j, t in enumerate((ref, fused, ctl)):
                kw = dict(hyper=KFACHyperParams(lr=ref.lr_fn(i),
                                                damping=ref.precond.damping),
                          update_factors=True,
                          update_inverse=ref.precond.should_update_inverse(i))
                with (fp64_stat_gemm() if j == 2
                      else contextlib.nullcontext()):
                    pg, states[j] = t.precond.step(states[j], grads,
                                                   cap.acts, cap.gs, **kw)
                pgs.append(pg)
            ref.tx.apply(params, pgs[0], ref.state.opt_state, i)
            gaps.append({'fused': grad_gap(pgs[1], pgs[0]),
                         'control': grad_gap(pgs[2], pgs[0])})
        out['lockstep'][wire] = gaps
        del ref, fused, ctl

    # eigen_dp, fp32 wire
    tr = trainer([])
    batches = tr.train_loader.epoch()
    dp_losses, dp_agree = [], []
    for _ in range(WORLD2_DP_STEPS):
        dp_losses.append(float(tr.train_step(next(batches))['loss']))
        dp_agree.append(tr.replicas_agree())
    out.update(dp_losses=dp_losses, dp_agree=dp_agree,
               dp_comm_err=tr.state.kfac_state.comm_err is None)
    del tr
    out['ekfac'] = world2_ekfac(trainer, batches_of=lambda t: t.train_loader
                                .epoch())
    out['stagger'] = world2_stagger(trainer)
    out['shard'] = world2_shard_lockstep(trainer, group)
    out['prefetch'] = world2_prefetch(trainer)
    out['exclude'] = world2_exclude(trainer)
    return out


def world2_exclude(trainer):
    """Slice 13 at world=2 (one rank): the MPD eigen bf16 trainer without
    each communication phase (WORLD2_EXCLUDE), WORLD2_EXCLUDE_STEPS steps:
    the launches, the collectives of every step by scope, the losses and
    whether the parameters stay finite. Returns numbers only."""
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    out = {}
    for parts in WORLD2_EXCLUDE:
        tr = trainer(WORLD2_EIGEN + ['--exclude-parts', parts])
        it = tr.train_loader.epoch()
        reset_counts()
        losses = []
        with coll.ledger() as led:
            for _ in range(WORLD2_EXCLUDE_STEPS):
                losses.append(float(tr.train_step(next(it))['loss']))
        out[parts] = {
            'launches': read_counts(), 'losses': losses,
            'collectives': [[scope, op, str(dtype), n]
                            for scope, op, dtype, n in led],
            'finite': all(bool(torch.isfinite(p).all())
                          for p in tr.state.model.parameters())}
        del tr
    return out


def check_world2_exclude(outs, nb, conv, dense):
    """Slice 13's world=2 checks: without CommunicateFactor no byte in its
    scope and no K3 launch; without CommunicateInverse no byte in its
    scope; K1/K2 a step as always, the losses and parameters finite."""
    n = WORLD2_EXCLUDE_STEPS
    for parts in WORLD2_EXCLUDE:
        want = {'K1 conv_a': conv * n, 'K2 stat_rows': (conv + 2 * dense) * n,
                'K3 ef_quantize': 0 if parts == 'CommunicateFactor'
                else nb * n, 'K4 flash_fwd': 0, 'K5a flash_bwd_dq': 0,
                'K5b flash_bwd_dkv': 0}
        scope = 'kfac.' + parts
        for r, out in enumerate(outs):
            o = out['exclude'][parts]
            if o['launches'] != want:
                fail(f'world2 exclude {parts} rank {r}: kernel launches '
                     f'{o["launches"]}, expected {want}')
            moved = [c for c in o['collectives']
                     if c[0].startswith(scope) and c[3]]
            if moved:
                fail(f'world2 exclude {parts} rank {r}: bytes in the '
                     f'excluded scope: {moved}')
            if not (all(np.isfinite(o['losses'])) and o['finite']):
                fail(f'world2 exclude {parts} rank {r}: non-finite losses '
                     f'{o["losses"]} or parameters')
        o = outs[0]['exclude'][parts]
        by_scope = {}
        for c in o['collectives']:
            by_scope[c[0]] = by_scope.get(c[0], 0) + c[3]
        print(f'world2 exclude_parts {parts} (resnet32 eigen bf16, {n} '
              f'steps): losses {[round(x, 4) for x in o["losses"]]}, '
              f'launches per rank {o["launches"]}, collective bytes by scope '
              f'{json.dumps(by_scope)}', flush=True)


def world2_ekfac(trainer, batches_of):
    """Slice 10 at world=2 (one rank): MPD 'ekfac' over the bf16 wire with
    the capture kernels for WORLD2_EKFAC_STEPS steps (K1/K2/K3 counts,
    replica digests and the moments' digest each step), then 'ekfac_dp'
    over fp32 for WORLD2_EKFAC_DP_STEPS steps with one step's collectives
    by scope. Returns numbers only."""
    import hashlib
    from kfac_pytorch_tpu_torch.parallel import collectives as coll

    def digest(scales):
        h = hashlib.sha1()
        for k in sorted(scales):
            h.update(scales[k].detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
        return h.hexdigest()

    out = {}
    tr = trainer(WORLD2_EKFAC)
    it = batches_of(tr)
    reset_counts()
    losses, agree, moments, nonzero = [], [], [], []
    for _ in range(WORLD2_EKFAC_STEPS):
        losses.append(float(tr.train_step(next(it))['loss']))
        agree.append(tr.replicas_agree())
        sc = tr.state.kfac_state.decomp['scales']
        moments.append(digest(sc))
        nonzero.append(all(bool(torch.any(v != 0)) for v in sc.values()))
    out.update(launches=read_counts(), losses=losses, replicas_agree=agree,
               scales_digest=moments, scales_nonzero=nonzero,
               groups=len(tr.precond.plan.pred_groups))
    del tr
    tr = trainer(['--kfac-name', 'ekfac_dp'])
    it = batches_of(tr)
    dp_losses, dp_agree = [], []
    for _ in range(WORLD2_EKFAC_DP_STEPS - 1):
        dp_losses.append(float(tr.train_step(next(it))['loss']))
        dp_agree.append(tr.replicas_agree())
    with coll.ledger() as led:
        dp_losses.append(float(tr.train_step(next(it))['loss']))
    dp_agree.append(tr.replicas_agree())
    out.update(dp_losses=dp_losses, dp_agree=dp_agree,
               dp_collectives=[[scope, op, str(dtype), n]
                               for scope, op, dtype, n in led],
               dp_scales_nonzero=all(
                   bool(torch.any(v != 0))
                   for v in tr.state.kfac_state.decomp['scales'].values()))
    return out


def held_rows(pre, bdim):
    """The global rows of bucket ``bdim`` that this rank's stored
    decomposition holds (all in comm_mode 'inverse', its own in 'pred')."""
    b = pre.plan.buckets[bdim]
    if pre.comm_mode == 'inverse':
        return list(range(b.n_rows))
    r = torch.distributed.get_rank(pre.group)
    return list(range(r * b.per_dev, (r + 1) * b.per_dev))


def untouched_kept(pre, before, after, cohort):
    """Whether every stored decomposition row outside ``cohort`` kept its
    bits from ``before`` to ``after``."""
    for bdim in pre.plan.bucket_dims:
        b = pre.plan.buckets[bdim]
        rows = pre.cohorts.rows[bdim][cohort]
        valid = pre.cohorts.valid[bdim][cohort]
        touched = {d * b.per_dev + int(j) for d in range(rows.shape[0])
                   for j, v in zip(rows[d], valid[d]) if v}
        keep = [i for i, g in enumerate(held_rows(pre, bdim))
                if g not in touched]
        for part in ('evals', 'evecs'):
            if not torch.equal(before[part][str(bdim)][keep],
                               after[part][str(bdim)][keep]):
                return False
    return True


def world2_stagger(trainer):
    """Slice 11 at world=2 (one rank): each WORLD2_STAGGER run through the
    trainer for WORLD2_STAGGER_STEPS steps: launches, losses, the replicas
    and the decomposition each step ran, and on every staggered step
    whether the rows outside its cohort kept their bits."""
    out = {}
    for name, extra in WORLD2_STAGGER.items():
        tr = trainer(extra)
        it = tr.train_loader.epoch()
        reset_counts()
        run = {'losses': [], 'replicas_agree': [], 'decomps': [],
               'untouched_kept': []}
        for _ in range(WORLD2_STAGGER_STEPS):
            ks = tr.state.kfac_state
            cohort = ks.step % tr.precond.cohorts.num_cohorts
            run['losses'].append(float(tr.train_step(next(it))['loss']))
            run['replicas_agree'].append(tr.replicas_agree())
            run['decomps'].append(tr.step_fn.last_decomp)
            if tr.step_fn.last_decomp == 'cohort':
                run['untouched_kept'].append(untouched_kept(
                    tr.precond, ks.decomp, tr.state.kfac_state.decomp,
                    cohort))
        run['launches'] = read_counts()
        out[name] = run
        del tr
    return out


def decomp_close(got, want):
    """``(bitwise, within, worst)`` of two stored decompositions: bit for
    bit equal; every element within SHARD_ATOL + SHARD_RTOL |want|; the
    largest |got - want| relative to its tensor's largest entry."""
    bitwise, within, worst = True, True, 0.0
    for part in ('evals', 'evecs'):
        for k, w in want[part].items():
            g = got[part][k]
            bitwise = bitwise and torch.equal(g, w)
            within = within and torch.allclose(g, w, rtol=SHARD_RTOL,
                                               atol=SHARD_ATOL)
            worst = max(worst, grad_gap({k: g}, {k: w})[0])
    return bitwise, within, worst


def world2_shard_lockstep(trainer, group):
    """Slice 11 at world=2 (one rank): for eigen_dp and eigen over fp32,
    the same gradients and captures of one model into two preconditioners,
    owner-local stagger and ``decomp_shard`` (4 cohorts), for
    WORLD2_SHARD_STEPS steps: the decompositions compared each step, one
    sharded step's DecompComm bytes beside ``comm_volume``, host ms of
    each staggered K-FAC step (synchronized; gloo gathers included) and
    the CUDA-event ms of the decompositions a rank runs a step
    (``sym_eig`` over ``R_b`` rows a bucket owner-local, ``S_b`` sharded;
    L2 flushed, host not hidden), with two processes sharing the card."""
    from kfac_pytorch_tpu_torch import capture, ops
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams
    rank = torch.distributed.get_rank(group)
    out = {}
    for variant in ('eigen_dp', 'eigen'):
        base = ['--kfac-name', variant, '--kfac-update-freq', '4',
                '--kfac-capture-impl', 'auto']
        owner = trainer(base + ['--kfac-stagger'])
        shard = trainer(base + ['--kfac-decomp-shard'])
        model = owner.state.model
        params = dict(model.named_parameters())
        states = [owner.state.kfac_state, shard.state.kfac_state]
        it = owner.train_loader.epoch()
        run = {'close': [], 'grad_gap': [], 'step_ms': [[], []]}
        for i in range(WORLD2_SHARD_STEPS):
            batch = owner.to_device(next(it))
            model.zero_grad(set_to_none=True)
            with capture.Capture(model, owner.precond.plan.metas) as cap:
                outp = model(batch['input'].permute(0, 3, 1, 2))
                torch.nn.functional.cross_entropy(
                    outp, batch['label']).backward()
            grads = coll.average_grads(
                {k: p.grad for k, p in params.items()}, group)
            kw = dict(hyper=KFACHyperParams(lr=owner.lr_fn(i),
                                            damping=owner.precond.damping))
            kw.update({'stagger_update': True} if i
                      else {'update_inverse': True})
            pgs = []
            for j, t in enumerate((owner, shard)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with coll.ledger() as led:
                    pg, states[j] = t.precond.step(states[j], grads,
                                                   cap.acts, cap.gs, **kw)
                torch.cuda.synchronize()
                if i:
                    run['step_ms'][j].append(
                        (time.perf_counter() - t0) * 1e3)
                if i == 1 and j == 1:
                    run['decomp_comm'] = sum(n for scope, _, _, n in led
                                             if scope == 'kfac.DecompComm')
                pgs.append(pg)
            owner.tx.apply(params, pgs[0], owner.state.opt_state, i)
            run['close'].append(decomp_close(states[1].decomp,
                                             states[0].decomp))
            run['grad_gap'].append(grad_gap(pgs[1], pgs[0])[0])
        sp, op_ = shard.precond, owner.precond
        run['decomp_comm_want'] = sp.plan.comm_volume(
            stats_reduce=sp.stats_reduce, method=sp.method,
            comm_precision=sp.comm_precision,
            decomp_shard=sp.decomp_shard_plan)['DecompComm']
        run['shard_count'] = sp.decomp_shard_plan.shard_count[:, rank] \
            .tolist()
        run['cohort_count'] = op_.cohorts.cohort_count[rank].tolist()
        rows = {'owner': {b: op_.cohorts.rows[b].shape[2]
                          for b in op_.plan.bucket_dims},
                'shard': {b: sp.decomp_shard_plan.shard_rows(b)
                          for b in sp.plan.bucket_dims}}
        run['rows'] = {k: {str(b): n for b, n in v.items()}
                       for k, v in rows.items()}
        run['eigh_ms'] = {}
        for name, per in rows.items():
            xs = [states[0].factors[str(b)][:n] for b, n in per.items()]
            # eigh waits on its error flags on the host: no spin hides it
            run['eigh_ms'][name] = time_ms(
                lambda: [ops.sym_eig(x) for x in xs], reps=5,
                hide_host=False)
        out[variant] = run
        del owner, shard, model, params, states
    return out


def world2_prefetch(trainer):
    """Slice 11 at world=2 (one rank): WORLD2_PREFETCH through the trainer
    for WORLD2_PREFETCH_STEPS steps, ``KFAC.step`` spied on: a prefetched
    update's preconditioned gradients must be those of the stored table
    (the same call without its inverse update), differ from those of the
    fresh one, and publish the table the same update computes without
    prefetch; the next step must read that table and precondition with
    it. Returns each step's ``last_prefetch`` and the checks."""
    import dataclasses
    tr = trainer(WORLD2_PREFETCH)
    pre = tr.precond
    real = pre.step
    checks, pending = [], {}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)

    def spy(state, grads, acts=None, gs=None, **kw):
        pg, new = real(state, grads, acts, gs, **kw)
        if 'fresh' in pending:
            fresh = pending.pop('fresh')
            ref, _ = real(dataclasses.replace(state, decomp=fresh), grads,
                          acts, gs, **kw)
            checks.append(('next', all(same(state.decomp[p], fresh[p])
                                       for p in fresh) and same(pg, ref)))
        if kw.get('prefetch'):
            stale, _ = real(state, grads, acts, gs,
                            **{**kw, 'prefetch': False,
                               'update_inverse': False})
            full, full_state = real(state, grads, acts, gs,
                                    **{**kw, 'prefetch': False})
            checks.append(('prefetch', same(pg, stale)
                           and not same(pg, full)
                           and all(same(new.decomp[p], full_state.decomp[p])
                                   for p in full_state.decomp)))
            pending['fresh'] = full_state.decomp
        return pg, new

    pre.step = spy
    it = tr.train_loader.epoch()
    prefetched, losses, agree = [], [], []
    try:
        for _ in range(WORLD2_PREFETCH_STEPS):
            losses.append(float(tr.train_step(next(it))['loss']))
            prefetched.append(tr.step_fn.last_prefetch)
            agree.append(tr.replicas_agree())
    finally:
        del pre.step
    return {'prefetched': prefetched, 'checks': checks, 'losses': losses,
            'replicas_agree': agree}


def nccl_rank(rank, world, group):
    """A 1-rank NCCL group (an axis of size 1: the collectives run, on the
    card): eigen over the bf16 and the int8 wire for AGREE_STEPS steps
    each. Every lossy reduce's residual is checked bit for bit against
    the plain algebra on the same inputs, and its mean against the wire."""
    from kfac_pytorch_tpu_torch import train_cifar
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    real = coll.pmean_scatter_ef
    seen = []

    def recorded(x, grp, prec, residual, fused=False):
        x_in, r_in = x.clone(), residual.clone()
        mean, new_r = real(x, grp, prec, residual, fused=fused)
        wire, want_r = ck._ef_quantize_plain(x_in, r_in)
        seen.append(bool(torch.equal(new_r.view(torch.int32),
                                     want_r.view(torch.int32))
                         and torch.equal(mean, wire.float())))
        return mean, new_r

    coll.pmean_scatter_ef = recorded
    out = {'backend': str(torch.distributed.get_backend(group))}
    try:
        for prec in ('bf16', 'int8'):
            args = train_cifar.parse_args(
                ['--device', 'cuda', '--kfac-name', 'eigen',
                 '--kfac-comm-precision', prec, '--kfac-capture-impl',
                 'auto'])
            tr = train_cifar.Trainer(args, group=group)
            batches = tr.train_loader.epoch()
            seen.clear()
            reset_counts()
            losses = [float(tr.train_step(next(batches))['loss'])
                      for _ in range(AGREE_STEPS)]
            grads_finite = all(bool(torch.isfinite(g).all())
                               for g in tr.step_fn.last_grads.values())
            out[prec] = {'losses': losses, 'grads_finite': grads_finite,
                         'launches': read_counts(),
                         'residual_checks': list(seen),
                         'residual_norm': float(sum(
                             float(v.double().norm()) ** 2 for v in
                             tr.state.kfac_state.comm_err.values())) ** 0.5}
            del tr
    finally:
        coll.pmean_scatter_ef = real
    return out


def run_world2():
    """The world=2 phases (:func:`world2_rank`) on two ranks over gloo,
    checked. Returns the launch counts (both ranks) of the eigen bf16 run
    and of the two staggered runs, by path, and rank 0's outputs."""
    from kfac_pytorch_tpu_torch import launch
    t0 = time.perf_counter()
    outs = launch.spawn(world2_rank, 2, backend='gloo', timeout=600)
    o = outs[0]
    nb, conv, dense = len(o['buckets']), o['layers']['conv'], \
        o['layers']['dense']
    want = {'K1 conv_a': conv * TRAIN_STEPS,
            'K2 stat_rows': (conv + 2 * dense) * TRAIN_STEPS,
            'K3 ef_quantize': nb * TRAIN_STEPS, 'K4 flash_fwd': 0,
            'K5a flash_bwd_dq': 0, 'K5b flash_bwd_dkv': 0}
    for r, out in enumerate(outs):
        if out['launches'] != want:
            fail(f'world2 rank {r}: kernel launches {out["launches"]}, '
                 f'expected {want}')
        if not all(np.isfinite(out['losses'])):
            fail(f'world2 rank {r}: non-finite loss {out["losses"]}')
        if not out['residual_norm'][0] > 0:
            fail(f'world2 rank {r}: the residual is zero after step 1')
        if not all(out['replicas_agree']) or not all(out['dp_agree']):
            fail(f'world2 rank {r}: the ranks\' parameters differ '
                 f'(eigen {out["replicas_agree"]}, eigen_dp '
                 f'{out["dp_agree"]})')
        if not out['dp_comm_err'] or not all(np.isfinite(out['dp_losses'])):
            fail(f'world2 rank {r}: eigen_dp fp32 carried a residual or '
                 f'lost finiteness')
        for wire, gaps in out['lockstep'].items():
            for i, g in enumerate(gaps):
                (gap, k), (ctl, _) = g['fused'], g['control']
                # over the fp32 wire the world=1 bound; a bf16 wire's
                # roundings tip with the statistics' summation order, so
                # there the kernels may part from the unfused path as far
                # as TRAJ_FACTOR x the fp64-GEMM control does
                if gap > GRAD_RTOL and (wire == 'fp32'
                                        or gap > TRAJ_FACTOR * ctl):
                    fail(f'world2 rank {r} lockstep ({wire} wire) step {i}: '
                         f'preconditioned grad {k} {gap:.3e} of its largest '
                         f'entry, over {GRAD_RTOL} (fp64-GEMM control '
                         f'{ctl:.3e})')
    if outs[0]['losses'] != outs[1]['losses']:
        fail('world2: the ranks report different losses')
    ms = o['step_ms']
    comm = {k: float(np.median([c[k] for c in o['comm_ms']]))
            for k in o['comm_ms'][0]}
    print(f'world2 ({o["backend"]}, 2 ranks on one card, host-staged): '
          f'resnet32 bs128 (64 a rank) eigen bf16 capture_impl=auto, '
          f'{TRAIN_STEPS} steps, losses {[round(x, 4) for x in o["losses"]]}'
          f', step ms median {float(np.median(ms)):.3f} (first {ms[0]:.1f}, '
          f'decomposition step 10 {ms[10]:.1f}), host ms median in the '
          f'collectives {json.dumps(comm)}, launches per rank '
          f'{o["launches"]} (per step K1 {conv}, K2 {conv + 2 * dense}, '
          f'K3 {nb}), residual norm {o["residual_norm"][0]:.4e} after step '
          f'1, replicas bitwise equal after every step', flush=True)
    for wire, gaps in o['lockstep'].items():
        for i, g in enumerate(gaps):
            print(f'world2 lockstep (kernels vs capture_impl=None, {wire} '
                  f'wire) step {i}: preconditioned grads max rel err '
                  f'{g["fused"][0]:.3e} ({g["fused"][1]}); control (fp64 '
                  f'factor GEMMs) {g["control"][0]:.3e} '
                  f'({g["control"][1]})', flush=True)
    guard = [c for c in o['step_collectives'] if c[0] == 'health.batch_ok']
    if len(guard) != 1:
        fail(f'world2: the health guard ran {len(guard)} collectives in a '
             f'step, expected one scalar all-reduce: {guard}')
    print(f'world2 collectives in one step: {len(o["step_collectives"])}, '
          f'of which the health guard\'s: {guard}', flush=True)
    print(f'world2 ({o["backend"]}) eigen_dp fp32: {WORLD2_DP_STEPS} steps, '
          f'losses {[round(x, 4) for x in o["dp_losses"]]}, replicas '
          f'bitwise equal, no residual; phase {time.perf_counter() - t0:.1f}'
          ' s', flush=True)
    check_world2_ekfac(outs, nb, conv, dense)
    check_world2_slice11(outs, nb, conv, dense)
    check_world2_exclude(outs, nb, conv, dense)
    total = {k: sum(out['launches'][k] for out in outs) for k in want}
    stagger = {k: sum(out['stagger'][name]['launches'][k] for out in outs
                      for name in WORLD2_STAGGER) for k in want}
    exclude = {k: sum(out['exclude'][parts]['launches'][k] for out in outs
                      for parts in WORLD2_EXCLUDE) for k in want}
    return {'resnet32_world2_eigen_bf16': total,
            'resnet32_world2_stagger': stagger,
            'resnet32_world2_exclude': exclude}, o


def check_world2_ekfac(outs, nb, conv, dense):
    """Slice 10's world=2 checks on both ranks' :func:`world2_ekfac`."""
    n = WORLD2_EKFAC_STEPS
    want = {'K1 conv_a': conv * n, 'K2 stat_rows': (conv + 2 * dense) * n,
            'K3 ef_quantize': nb * n, 'K4 flash_fwd': 0,
            'K5a flash_bwd_dq': 0, 'K5b flash_bwd_dkv': 0}
    e = [o['ekfac'] for o in outs]
    for r, o in enumerate(e):
        if o['launches'] != want:
            fail(f'world2 ekfac rank {r}: kernel launches {o["launches"]}, '
                 f'expected {want}')
        if not (all(np.isfinite(o['losses']))
                and all(np.isfinite(o['dp_losses']))):
            fail(f'world2 ekfac rank {r}: non-finite loss')
        if not (all(o['replicas_agree']) and all(o['dp_agree'])):
            fail(f'world2 ekfac rank {r}: the ranks\' parameters differ')
        if not (all(o['scales_nonzero']) and o['dp_scales_nonzero']):
            fail(f'world2 ekfac rank {r}: a moments group stayed zero')
        moved = [c for c in o['dp_collectives'] if 'scales' in c[0]]
        if moved:
            fail(f'world2 ekfac_dp rank {r}: the moments were communicated: '
                 f'{moved}')
    if e[0]['scales_digest'] != e[1]['scales_digest']:
        fail('world2 ekfac: the ranks\' moments differ')
    if e[0]['losses'] != e[1]['losses']:
        fail('world2 ekfac: the ranks report different losses')
    print(f'world2 slice 10: resnet32 ekfac bf16 wire capture_impl=auto, '
          f'{n} steps, losses {[round(x, 4) for x in e[0]["losses"]]}, '
          f'launches per rank {e[0]["launches"]}, replicas and the moments '
          f'({e[0]["groups"]} groups) bitwise equal across the ranks every '
          f'step; ekfac_dp fp32 {WORLD2_EKFAC_DP_STEPS} steps, losses '
          f'{[round(x, 4) for x in e[0]["dp_losses"]]}, replicas bitwise '
          f'equal, collectives of its last step by scope '
          f'{sorted(set(c[0] for c in e[0]["dp_collectives"]))} (no moment '
          f'bytes)', flush=True)


def check_world2_slice11(outs, nb, conv, dense):
    """Slice 11's world=2 checks on both ranks' staggered runs, sharded
    lockstep and prefetched run."""
    n = WORLD2_STAGGER_STEPS
    for name in WORLD2_STAGGER:
        want = {'K1 conv_a': conv * n, 'K2 stat_rows': (conv + 2 * dense) * n,
                'K3 ef_quantize': nb * n if 'bf16' in name else 0,
                'K4 flash_fwd': 0, 'K5a flash_bwd_dq': 0,
                'K5b flash_bwd_dkv': 0}
        runs = [o['stagger'][name] for o in outs]
        for r, o in enumerate(runs):
            if o['launches'] != want:
                fail(f'world2 stagger {name} rank {r}: kernel launches '
                     f'{o["launches"]}, expected {want}')
            if not all(np.isfinite(o['losses'])):
                fail(f'world2 stagger {name} rank {r}: non-finite loss')
            if not all(o['replicas_agree']):
                fail(f'world2 stagger {name} rank {r}: the ranks\' '
                     'parameters differ')
            if o['decomps'] != ['full'] + ['cohort'] * (n - 1):
                fail(f'world2 stagger {name} rank {r}: decompositions '
                     f'{o["decomps"]}')
            if not all(o['untouched_kept']):
                fail(f'world2 stagger {name} rank {r}: a row outside the '
                     f'cohort changed: {o["untouched_kept"]}')
        if runs[0]['losses'] != runs[1]['losses']:
            fail(f'world2 stagger {name}: the ranks report different '
                 'losses')
        print(f'world2 slice 11 stagger (4 cohorts) resnet32 {name} '
              f'capture_impl=auto, {n} steps, losses '
              f'{[round(x, 4) for x in runs[0]["losses"]]}, launches per '
              f'rank {runs[0]["launches"]}, replicas bitwise equal, rows '
              'outside each cohort bitwise kept', flush=True)
    for variant in outs[0]['shard']:
        runs = [o['shard'][variant] for o in outs]
        for r, o in enumerate(runs):
            for i, (bitwise, within, worst) in enumerate(o['close']):
                if not (bitwise or within):
                    fail(f'world2 decomp_shard {variant} rank {r} step {i}: '
                         f'the sharded decomposition parts from the '
                         f'owner-local one by {worst:.3e} of a tensor\'s '
                         f'largest entry (rtol {SHARD_RTOL}, atol '
                         f'{SHARD_ATOL})')
            if o['decomp_comm'] != o['decomp_comm_want']:
                fail(f'world2 decomp_shard {variant} rank {r}: DecompComm '
                     f'{o["decomp_comm"]} bytes, comm_volume '
                     f'{o["decomp_comm_want"]}')
            bitwise = all(c[0] for c in o['close'])
            print(f'world2 slice 11 decomp_shard {variant} rank {r} (two '
                  f'processes on one card, gloo): lockstep with owner-local '
                  f'stagger {WORLD2_SHARD_STEPS} steps, decompositions '
                  f'{"bitwise equal" if bitwise else "within tolerance"}, '
                  f'largest gap {max(c[2] for c in o["close"]):.3e}, '
                  f'preconditioned grads largest gap '
                  f'{max(o["grad_gap"]):.3e}; rows a step by cohort: '
                  f'sharded {o["shard_count"]}, owner-local '
                  f'{o["cohort_count"]}; padded rows a bucket '
                  f'{json.dumps(o["rows"])}; staggered K-FAC step host ms '
                  f'median owner-local '
                  f'{float(np.median(o["step_ms"][0])):.2f}, sharded '
                  f'{float(np.median(o["step_ms"][1])):.2f}; decomposition '
                  f'event ms a step owner-local '
                  f'{o["eigh_ms"]["owner"]:.3f}, sharded '
                  f'{o["eigh_ms"]["shard"]:.3f}; DecompComm '
                  f'{o["decomp_comm"]} bytes = comm_volume', flush=True)
    p = [o['prefetch'] for o in outs]
    want = [False, False, False, True, False, False, True]
    for r, o in enumerate(p):
        if o['prefetched'] != want[:WORLD2_PREFETCH_STEPS]:
            fail(f'world2 comm_prefetch rank {r}: prefetched '
                 f'{o["prefetched"]}')
        kinds = [k for k, _ in o['checks']]
        if kinds != ['prefetch', 'next', 'prefetch'] or \
                not all(ok for _, ok in o['checks']):
            fail(f'world2 comm_prefetch rank {r}: checks {o["checks"]}')
        if not (all(np.isfinite(o['losses'])) and all(o['replicas_agree'])):
            fail(f'world2 comm_prefetch rank {r}: non-finite loss or the '
                 'ranks differ')
    print(f'world2 slice 11 comm_prefetch resnet32 eigen fp32 '
          f'kfac_update_freq 3, {WORLD2_PREFETCH_STEPS} steps, losses '
          f'{[round(x, 4) for x in p[0]["losses"]]}, prefetched '
          f'{p[0]["prefetched"]}: each prefetched step preconditioned '
          'with the stored table and published the fresh one, which the '
          'next step read (bitwise)', flush=True)


def run_nccl():
    """The 1-rank NCCL phase (:func:`nccl_rank`), checked."""
    from kfac_pytorch_tpu_torch import launch
    t0 = time.perf_counter()
    o, = launch.spawn(nccl_rank, 1, backend='nccl', timeout=600)
    for prec in ('bf16', 'int8'):
        res = o[prec]
        if not (all(np.isfinite(res['losses'])) and res['grads_finite']):
            fail(f'nccl {prec}: non-finite losses or gradients')
        if res['launches']['K3 ef_quantize'] == 0:
            fail(f'nccl {prec}: K3 never launched')
        if not res['residual_checks'] or not all(res['residual_checks']):
            fail(f'nccl {prec}: a residual or mean differs from the plain '
                 f'algebra: {res["residual_checks"]}')
        print(f'nccl ({o["backend"]}, 1 rank): eigen {prec} wire, '
              f'{AGREE_STEPS} steps, losses '
              f'{[round(x, 4) for x in res["losses"]]}, launches '
              f'{res["launches"]}, {len(res["residual_checks"])} reduces '
              f'with the residual bitwise the plain algebra\'s, residual '
              f'norm {res["residual_norm"]:.4e}', flush=True)
    print(f'nccl phase {time.perf_counter() - t0:.1f} s', flush=True)
    return o


# ---------------------------------------------------------------------------
# slice 7: the ImageNet ResNet-50 trainer in bf16 (K1/K2 at ResNet-50's
# shapes, the decomposition every step, checkpoint save and resume)
# ---------------------------------------------------------------------------

#: the ImageNet trainer at examples/imagenet_resnet.py's defaults (ResNet-50,
#: batch 32, 224 x 224, bf16, label smoothing 0.1, eigen_dp,
#: kfac_update_freq=1) with the capture kernels, on 256 synthetic images
R50_ARGS = ['--device', 'cuda', '--synthetic-size', '256']
R50_STEPS = 4
R50_PROFILE_STEPS = 1
R50_AGREE_STEPS = 2
#: the resume check: save after R50_SAVE_AFTER steps, restore into a fresh
#: trainer, run R50_RESUME_MORE more
R50_SAVE_AFTER, R50_RESUME_MORE = 2, 1
R50_CKPT = os.path.join(OUT_DIR, 'ckpt_resnet50')
#: each warm rung of the decomposition ladder on the card against its fp64
#: twin (the same rung on the same inputs and seeds in fp64; Newton-Schulz
#: with the fp32 run's per-slot gate decisions): the largest gap of its
#: damped inverse (``Q diag(1/(d + lam)) Q^T``, or the inverse), relative to
#: the twin's largest entry, lam the Cholesky path's pi-damping of the row.
#: Each rung's gap to the exact fp64 inverse of the damped factor, the
#: algorithm's own error, is printed beside it without a gate: the
#: reference holds its tracker to 5e-2 of it (tests/test_linalg.py) and
#: accepts a Newton-Schulz residual up to 5e-2
RUNG_TOL = 1e-3
#: Jacobi runs sweeps x (n - 1) sequential rounds of a few kernels each
#: (thousands of launches a sweep at 4608): timed only up to this dim
JACOBI_MAX_DIM = 512
#: the ResNet-50 trainer on two more rungs of the ladder, R50_LADDER_STEPS
#: steps each: (extra flags, the decomposition each step must run)
R50_LADDER_STEPS = 6
R50_LADDER_RUNS = {
    'subspace, basis_update_freq 5': (
        ['--kfac-decomp-impl', 'subspace', '--kfac-basis-update-freq', '5'],
        ['full'] + ['refresh'] * 4 + ['warm']),
    'stagger, kfac_update_freq 6': (
        ['--kfac-update-freq', '6', '--kfac-stagger'],
        ['full'] + ['cohort'] * 5),
}


def make_imagenet_trainer(capture_impl='pallas', extra=()):
    from kfac_pytorch_tpu_torch import train_imagenet
    argv = R50_ARGS + ['--checkpoint-format', R50_CKPT] + list(extra)
    if capture_impl is not None:
        argv += ['--kfac-capture-impl', capture_impl]
    return train_imagenet.Trainer(train_imagenet.parse_args(argv))


def launches_wanted(tr, steps):
    """K1/K2 launches of ``steps`` factor steps of ``tr``'s model at
    world=1 (any trainer's: ResNet-50, ResNet-32, the slice-13 nets): one
    K1 a conv, one K2 a conv's G and a dense layer's A and G."""
    layers = tr.precond.plan.metas
    n_conv = sum(m.kind == 'conv' for m in layers)
    n_dense = len(layers) - n_conv
    return {'K1 conv_a': n_conv * steps,
            'K2 stat_rows': (n_conv + 2 * n_dense) * steps,
            'K3 ef_quantize': 0, 'K4 flash_fwd': 0, 'K5a flash_bwd_dq': 0,
            'K5b flash_bwd_dkv': 0}, n_conv, n_dense


def run_resnet50():
    """The ImageNet trainer for R50_STEPS steps: losses, host-clock step
    times, images/s, and the K1/K2 launches against the plan's layers (a
    factor update and a decomposition every step). Also returns the
    K-FAC state before the last step (the warm rungs' seeds)."""
    t0 = time.perf_counter()
    tr = make_imagenet_trainer('pallas')
    built_s = time.perf_counter() - t0
    want, n_conv, n_dense = launches_wanted(tr, R50_STEPS)
    batches = tr.train_loader.epoch()
    reset_counts()
    losses, times, decomp_steps = [], [], []
    for i in range(R50_STEPS):
        prev = tr.state.kfac_state
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        if 'decomp' in tr.step_fn.last_phases:
            decomp_steps.append(i)
    launches = read_counts()
    if not all(np.isfinite(losses)):
        fail(f'resnet50: non-finite training loss: {losses}')
    if launches != want:
        fail(f'resnet50 kernel launches {launches}, expected {want}')
    if decomp_steps != list(range(R50_STEPS)):
        fail(f'resnet50 decomposition ran on steps {decomp_steps}, '
             'expected every step')
    a = tr.args
    med = float(np.median(times))
    print(f'trainer (world=1): {a.model} bs{a.batch_size} {a.img_size}x'
          f'{a.img_size} bf16 eigen_dp kfac_update_freq='
          f'{a.kfac_update_freq} capture_impl={a.kfac_capture_impl}, '
          f'{R50_STEPS} steps, losses {[round(x, 4) for x in losses]}, '
          f'step ms median {med:.1f} (first {times[0]:.1f}), images/s '
          f'{a.batch_size / med * 1e3:.1f}, launches {launches} ({n_conv} '
          f'convs, {n_dense} dense: K1 {n_conv}, K2 {n_conv + 2 * n_dense} '
          f'a step), {len(tr.precond.plan.bucket_dims)} buckets '
          f'{tr.precond.plan.bucket_dims}, trainer built in {built_s:.1f} s',
          flush=True)
    return tr, launches, times, prev


def rung_gap(op, ref):
    """Largest ``|op - ref|`` of a stack relative to each matrix's largest
    ``|ref|`` entry, the worst matrix's."""
    err = (op.double() - ref).abs().amax(dim=(-2, -1))
    return float((err / ref.abs().amax(dim=(-2, -1))).max())


def eig_inverse(w, q, lam):
    """``Q diag(1/(d + lam)) Q^T`` in fp64 (``lam`` one a matrix)."""
    w, q = w.double(), q.double()
    return q @ (q.mT / (w + lam.double()[:, None])[..., :, None])


def time_decomposition(tr, prev):
    """Each rung of the decomposition ladder on the card, for each
    bucket's stack of the trained factors: ``eigh`` (``torch.linalg.eigh``)
    and the cold Cholesky inverse; warm-started from ``prev`` (the K-FAC
    state of the step before) the subspace tracker at its default 2 steps,
    the eigenvalue-only refresh, the Newton-Schulz inverse (seeded with
    ``prev``'s factors' Cholesky inverse) and, up to JACOBI_MAX_DIM, 5
    warm Jacobi sweeps. Each warm rung's damped inverse is held to its
    fp64 twin (RUNG_TOL), and its gap to the exact fp64 inverse of the
    damped factor is printed (the refresh, inexact by design, only
    that). Then the whole
    decomposition of a step for each rung. Host clock included: the
    solvers wait on the card for their error flags, and the Newton-Schulz
    gate reads its residuals on the host."""
    from kfac_pytorch_tpu_torch import engine, ops
    plan = tr.precond.plan
    factors = tr.state.kfac_state.factors
    eps = tr.precond.eps
    damping = torch.tensor(tr.precond.damping, device=tr.device)
    basis = engine.local_evecs(plan, prev.decomp, None, 'pred')
    lams = engine.pi_damping(plan, factors, damping)
    seeds = engine.compute_decomposition(plan, prev.factors, damping,
                                         'cholesky', eps)['invs']

    # one rep a rung and bucket (after its warm-up call): the whole run
    # keeps inside its time limit as the script grows
    def ms(fn):
        return time_ms(fn, reps=1, hide_host=False)

    rows, bad = [], []
    for d in plan.bucket_dims:
        k = str(d)
        f, q0, lam = factors[k], basis[k], lams[k]
        damped = ops.add_scaled_identity(f, lam)
        ref = torch.linalg.inv(f.double() + lam.double()[:, None, None]
                               * torch.eye(d, dtype=torch.float64,
                                           device=f.device))
        row = {'bucket': d, 'matrices': f.shape[0],
               'eigh_ms': ms(lambda: ops.sym_eig(f)),
               'cholesky_ms': ms(lambda: ops.psd_inverse(damped)),
               'subspace_ms': ms(lambda: ops.sym_eig(f, impl='subspace',
                                                     basis=q0)),
               'refresh_ms': ms(lambda: engine.refresh_evals(f, q0, eps)),
               'newton_schulz_ms': ms(lambda: ops.warm_inverse(
                   damped, seeds[k], accept_resid=engine.NS_ACCEPT_RESID))}

        def eig_op(rung, x):
            """The eigh rung's damped inverse of ``x`` (fp32, or the
            fp64 twin), warm from ``q0``."""
            w, q = ops.sym_eig(x, impl=rung, basis=q0.to(x.dtype))
            return eig_inverse(ops.clamp_eigvals(w, eps), q, lam)

        row['eigh_gap'] = rung_gap(eig_op('xla', f), ref)
        row['cholesky_gap'] = rung_gap(ops.psd_inverse(damped), ref)
        op = eig_op('subspace', f)
        row['subspace_gap'] = rung_gap(op, ref)
        row['subspace_fp64_gap'] = rung_gap(op, eig_op('subspace',
                                                         f.double()))
        row['refresh_gap'] = rung_gap(
            eig_inverse(engine.refresh_evals(f, q0, eps), q0, lam), ref)
        ns_ok = ops.newton_schulz_inverse(damped, seeds[k])[1] \
            < engine.NS_ACCEPT_RESID
        x = ops.warm_inverse(damped, seeds[k],
                             accept_resid=engine.NS_ACCEPT_RESID)
        x64 = torch.where(ns_ok[:, None, None], ops.newton_schulz_inverse(
            damped.double(), seeds[k].double())[0], ref)
        row['newton_schulz_gap'] = rung_gap(x, ref)
        row['newton_schulz_fp64_gap'] = rung_gap(x, x64)
        row['newton_schulz_fallbacks'] = int((~ns_ok).sum())
        if d <= JACOBI_MAX_DIM:
            row['jacobi_ms'] = ms(lambda: ops.sym_eig(f, impl='jacobi',
                                                      basis=q0))
            op = eig_op('jacobi', f)
            row['jacobi_gap'] = rung_gap(op, ref)
            row['jacobi_fp64_gap'] = rung_gap(op, eig_op('jacobi',
                                                           f.double()))
        else:
            row['jacobi_ms'] = row['jacobi_gap'] = None
            row['jacobi_fp64_gap'] = None
            row['jacobi_skipped'] = (
                f'{5 * (d - 1)} sequential rounds for 5 warm sweeps: not '
                f'timed above dim {JACOBI_MAX_DIM}')
        for rung in ('subspace', 'jacobi', 'newton_schulz'):
            gap = row[f'{rung}_fp64_gap']
            if gap is not None and not gap <= RUNG_TOL:
                bad.append(f'{rung} at bucket {d}: {gap:.3e}')
        rows.append(row)
        print(json.dumps({'path': 'resnet50', 'decomposition': row}),
              flush=True)
    whole = {
        'eigh': ms(lambda: engine.compute_decomposition(
            plan, factors, damping, 'eigh', eps)),
        'cholesky': ms(lambda: engine.compute_decomposition(
            plan, factors, damping, 'cholesky', eps)),
        'subspace': ms(lambda: engine.compute_decomposition(
            plan, factors, damping, 'eigh', eps, basis_local=basis,
            impl='subspace')),
        'refresh': ms(lambda: engine.refresh_decomposition(
            plan, factors, prev.decomp, eps, None, 'pred')),
        'newton_schulz': ms(lambda: engine.compute_decomposition(
            plan, factors, damping, 'cholesky', eps, invs_prev_local=seeds)),
        'jacobi': None}
    print(f'decomposition (resnet50): {whole["eigh"]:.1f} ms a step over '
          f'{sum(r["matrices"] for r in rows)} factors, eigh by bucket '
          f'{json.dumps({r["bucket"]: round(r["eigh_ms"], 2) for r in rows})}',
          flush=True)
    print('decomposition ladder (resnet50, ms a step, warm rungs seeded '
          'from the step before): ' + ', '.join(
              f'{k} {v:.1f}' for k, v in whole.items() if v is not None)
          + f'; jacobi not timed whole (buckets above {JACOBI_MAX_DIM}); '
          'damped-inverse gaps by bucket, to the exact fp64 inverse and '
          '(gated) to the rung\'s fp64 twin: ' + json.dumps(
              {r['bucket']: {g: r[g] and float(f'{r[g]:.3e}')
                             for g in ('eigh_gap', 'cholesky_gap',
                                       'subspace_gap', 'subspace_fp64_gap',
                                       'refresh_gap', 'newton_schulz_gap',
                                       'newton_schulz_fp64_gap',
                                       'jacobi_gap', 'jacobi_fp64_gap')}
               for r in rows}), flush=True)
    if bad:
        fail(f'decomposition ladder: gap to the fp64 twin over {RUNG_TOL}: '
             + '; '.join(bad))
    return {'buckets': rows, 'ms_per_step': whole['eigh'],
            'ladder_ms_per_step': whole}


def run_resnet50_ladder(name, default_ms, default_decomp_ms):
    """The ImageNet trainer on one more rung of the ladder
    (R50_LADDER_RUNS) for R50_LADDER_STEPS steps: finite losses, the
    expected decomposition each step, K1/K2 launches as the default
    run's; a staggered run's cohorts must hold every valid row once a
    window. Prints the step median and the decomposition ms a step beside
    the default run's."""
    from kfac_pytorch_tpu_torch import engine
    extra, expect = R50_LADDER_RUNS[name]
    tr = make_imagenet_trainer('pallas', extra)
    want, _, _ = launches_wanted(tr, R50_LADDER_STEPS)
    # more steps than one epoch of the synthetic set has: epoch after epoch
    batches = (b for _ in iter(int, 1) for b in tr.train_loader.epoch())
    reset_counts()
    losses, times, decomps = [], [], []
    for _ in range(R50_LADDER_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        decomps.append(tr.step_fn.last_decomp)
    launches = read_counts()
    if not all(np.isfinite(losses)):
        fail(f'resnet50 {name}: non-finite training loss: {losses}')
    if decomps != expect:
        fail(f'resnet50 {name}: decompositions {decomps}, expected {expect}')
    if launches != want:
        fail(f'resnet50 {name}: kernel launches {launches}, expected {want}')
    pre, kstate = tr.precond, tr.state.kfac_state
    plan, eps = pre.plan, pre.eps
    damping = torch.tensor(pre.damping, device=tr.device)
    ms = {}
    if pre.stagger:
        cohorts = pre.cohorts
        for b in plan.bucket_dims:
            seen = np.concatenate(
                [cohorts.rows[b][c, 0][cohorts.valid[b][c, 0]]
                 for c in range(cohorts.num_cohorts)])
            valid = np.flatnonzero(plan.buckets[b].valid)
            if cohorts.num_cohorts != R50_LADDER_STEPS or \
                    sorted(seen.tolist()) != valid.tolist():
                fail(f'resnet50 {name}: bucket {b} rows {sorted(seen)} over '
                     f'{cohorts.num_cohorts} cohorts, expected each of '
                     f'{valid.tolist()} once in {R50_LADDER_STEPS}')

        def cohort(c):
            return engine.merge_cohort_decomposition(
                plan, cohorts, kstate.decomp,
                engine.compute_cohort_decomposition(
                    plan, cohorts, kstate.factors, c, damping, 'eigh', eps),
                c, None, 'pred', 'eigh')

        per = [time_ms(lambda c=c: cohort(c), reps=1, hide_host=False)
               for c in range(cohorts.num_cohorts)]
        ms = {'cohort_mean': float(np.mean(per)),
              'cohort_max': float(np.max(per)),
              'max_rows_per_step': cohorts.max_rows_per_step(),
              'padded_rows_per_step': cohorts.padded_rows_per_step()}
        decomp_ms = ms['cohort_mean']
    else:
        basis = engine.local_evecs(plan, kstate.decomp, None, 'pred')
        ms = {'warm_full': time_ms(lambda: engine.compute_decomposition(
                  plan, kstate.factors, damping, 'eigh', eps,
                  basis_local=basis, impl='subspace'), reps=3,
                  hide_host=False),
              'refresh': time_ms(lambda: engine.refresh_decomposition(
                  plan, kstate.factors, kstate.decomp, eps, None, 'pred'),
                  reps=3, hide_host=False)}
        f = pre.basis_update_freq
        decomp_ms = (ms['warm_full'] + (f - 1) * ms['refresh']) / f
    med = float(np.median(times))
    print(f'resnet50 ladder ({name}): {R50_LADDER_STEPS} steps, losses '
          f'{[round(x, 4) for x in losses]}, decompositions {decomps}, step '
          f'ms median {med:.1f} (first {times[0]:.1f}; default run '
          f'{default_ms:.1f}), decomposition ms a step {decomp_ms:.1f} '
          f'(default eigh every step {default_decomp_ms:.1f}; '
          f'{json.dumps({k: round(v, 2) for k, v in ms.items()})}), '
          f'launches as the default run\'s', flush=True)
    return {'losses': losses, 'step_ms': times, 'decomps': decomps,
            'decomp_ms_per_step': decomp_ms, 'decomp_ms': ms}


def resnet50_cases(tr):
    from kfac_pytorch_tpu_torch import training
    batch = tr.to_device(next(tr.train_loader.epoch()))
    model = tr.state.model
    return captured_shapes(
        model, tr.precond.plan.metas,
        training.model_input(model, batch['input'], tr.dtype),
        lambda out: tr.loss_fn(out, batch))


def check_lockstep(tr, label='resnet50', steps=R50_AGREE_STEPS,
                   batches=None):
    """The trainer's kernel preconditioner in lockstep with two
    capture_impl=None ones (the second with its factor GEMMs summed in
    fp64, the control), each from a fresh K-FAC state: every step all
    three take the same captures and gradients. The kernels'
    preconditioned gradients may part from the unfused ones by GRAD_RTOL
    of each tensor's largest entry, or by TRAJ_FACTOR times the
    control's gap (the rule of the bf16 wire). ``tr`` is a world=1
    trainer (``label`` names its net in the output), ``steps`` steps on
    ``batches`` (host batches; default the trainer's loader), the KL
    clip at the lr the trainer's step hands K-FAC (``tr.kfac_lr``)."""
    import kfac_pytorch_tpu_torch as tkfac
    from kfac_pytorch_tpu_torch import capture, training
    from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams
    a = tr.args
    metas = tr.precond.plan.metas

    def unfused():
        pre = tkfac.get_kfac_module(a.kfac_name)(
            lr=a.base_lr, damping=tr.precond.damping,
            fac_update_freq=a.kfac_cov_update_freq,
            kfac_update_freq=a.kfac_update_freq, kl_clip=a.kl_clip,
            factor_decay=a.stat_decay, assignment=a.assignment)
        pre.setup(metas)
        return pre

    pres = [tr.precond, unfused(), unfused()]
    states = [p.init(tr.device) for p in pres]
    model = tr.state.model
    params = dict(model.named_parameters())
    it = tr.train_loader.epoch() if batches is None else batches
    bad, gaps = [], []
    for i in range(steps):
        batch = tr.to_device(next(it))
        model.train()
        model.zero_grad(set_to_none=True)
        with capture.Capture(model, metas) as cap:
            out = model(training.model_input(model, batch['input'],
                                             tr.dtype))
            tr.loss_fn(out, batch).backward()
        grads = {k: p.grad for k, p in params.items()}
        hyper = KFACHyperParams(lr=tr.kfac_lr(i), damping=tr.precond.damping)
        pgs = []
        for j, (pre, st) in enumerate(zip(pres, states)):
            with (fp64_stat_gemm() if j == 2 else contextlib.nullcontext()):
                pg, states[j] = pre.step(st, grads, cap.acts, cap.gs,
                                         hyper=hyper, update_factors=True,
                                         update_inverse=True)
            pgs.append(pg)
        tr.tx.apply(params, pgs[1], tr.state.opt_state, i)
        (gap, k), (ctl, kc) = grad_gap(pgs[0], pgs[1]), grad_gap(pgs[2],
                                                                 pgs[1])
        fac = max(float(((states[0].factors[b].double()
                          - states[1].factors[b].double()).abs()
                         / cs_scale(states[1].factors[b])).max())
                  for b in states[1].factors)
        print(f'{label} lockstep (kernels vs capture_impl=None, '
              f'{str(tr.dtype)[6:]} captures) '
              f'step {i}: factors max err {fac:.3e} x sqrt(F_ii '
              f'F_jj), preconditioned grads max rel err {gap:.3e} ({k}); '
              f'control (fp64 factor GEMMs) {ctl:.3e} ({kc})', flush=True)
        gaps.append({'factors': fac, 'grads': gap, 'control': ctl})
        if gap > GRAD_RTOL and gap > TRAJ_FACTOR * ctl:
            bad.append(f'step {i}: preconditioned grad {k} {gap:.3e} of its '
                       f'largest entry, over {GRAD_RTOL} and {TRAJ_FACTOR} x '
                       f'the control {ctl:.3e}')
    if bad:
        fail(f'{label} lockstep: ' + '; '.join(bad))
    return gaps


def _state_tensors(state):
    """``{name: tensor}`` of a train state: parameters and buffers, the
    optimizer's tensors, the K-FAC factors and decomposition."""
    out = {f'model.{k}': v for k, v in state.model.state_dict().items()}
    out.update({f'opt.{k}': v for k, v in state.opt_state.items()})
    k = state.kfac_state
    out.update({f'factors.{b}': v for b, v in k.factors.items()})
    for part, tree in k.decomp.items():
        out.update({f'{part}.{b}': v for b, v in tree.items()})
    return out


def check_resnet50_resume():
    """With cuDNN held to deterministic algorithms: the trainer runs
    R50_SAVE_AFTER + R50_RESUME_MORE steps and saves a checkpoint after
    R50_SAVE_AFTER; a fresh trainer auto-resumes from it and runs the
    last R50_RESUME_MORE steps on the same batches. Its parameters,
    buffers, optimizer and K-FAC state must be bitwise the uninterrupted
    run's; else it fails with the largest difference and the tensors that
    differ."""
    shutil.rmtree(R50_CKPT, ignore_errors=True)
    n = R50_SAVE_AFTER + R50_RESUME_MORE
    with deterministic_cudnn():
        whole = make_imagenet_trainer('pallas')
        it = whole.train_loader.epoch()
        batches = [next(it) for _ in range(n)]
        for i, b in enumerate(batches):
            whole.train_step(b)
            if i + 1 == R50_SAVE_AFTER:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                whole.save(0)
                save_s = time.perf_counter() - t0
        resumed = make_imagenet_trainer('pallas')
        t0 = time.perf_counter()
        start = resumed.resume()
        load_s = time.perf_counter() - t0
        if start != 1 or resumed.state.step != R50_SAVE_AFTER:
            fail(f'resnet50 resume: started at epoch {start}, step '
                 f'{resumed.state.step}; expected epoch 1, step '
                 f'{R50_SAVE_AFTER}')
        for b in batches[R50_SAVE_AFTER:]:
            resumed.train_step(b)
    nbytes = os.path.getsize(os.path.join(R50_CKPT, 'checkpoint-0.pt'))
    shutil.rmtree(R50_CKPT, ignore_errors=True)
    got, want = _state_tensors(resumed.state), _state_tensors(whole.state)
    if set(got) != set(want):
        fail('resnet50 resume: the resumed state has other tensors')
    differ = {k: float((got[k].double() - want[k].double()).abs().max())
              for k in want if not torch.equal(got[k], want[k])}
    head = (f'resnet50 resume: saved after step {R50_SAVE_AFTER} '
            f'({nbytes / 2**20:.0f} MiB in {save_s:.1f} s, restored in '
            f'{load_s:.1f} s), {R50_RESUME_MORE} more steps')
    if not differ and resumed.state.step == whole.state.step:
        print(f'{head}: parameters, buffers, optimizer and K-FAC state '
              f'({len(want)} tensors) bitwise equal to the uninterrupted '
              f'run (deterministic cuDNN)', flush=True)
        return {'blob_bytes': nbytes, 'save_s': save_s,
                'load_s': load_s}
    worst = max(differ, key=differ.get, default=None)
    fail(f'{head}: not bitwise: step {resumed.state.step} against '
         f'{whole.state.step}; {len(differ)} of {len(want)} tensors differ, '
         f'the largest by {differ.get(worst, 0.0):.3e} ({worst}): '
         f'{sorted(differ)}')


# ---------------------------------------------------------------------------
# slice 9: the health guard, the F1mc Fisher and the prefetched data path
# ---------------------------------------------------------------------------

#: steps of the skip check, the batches made all-NaN there (step 10 is a
#: decomposition step at the trainer's kfac_update_freq 10)
SKIP_STEPS, SKIP_NAN = 12, (3, 10)
#: the ladder check: HealthConfig, steps, NaN steps and the rung sequence
#: of the JAX oracle (tests/test_health.py)
LADDER_CFG = dict(escalate_after=2, max_rungs=2, recover_after=2)
LADDER_STEPS, LADDER_NAN = 10, (2, 3, 4, 5)
LADDER_RUNGS = [0, 0, 0, 1, 2, 2, 2, 0, 0, 0]
F1MC_STEPS = 3
#: timed steps of the guard's cost (after GUARD_WARM untimed ones), in
#: rounds alternating on and off
GUARD_STEPS_R32, GUARD_STEPS_R50, GUARD_WARM = 15, 2, 2
#: steps of each loader-depth timing, in rounds alternating 2 and 0
DEPTH_STEPS, DEPTH_ROUNDS = 6, 3


def align(tr, batch, r):
    """Step ``tr`` on ``batch`` until its step is ``r`` modulo
    ``kfac_update_freq``: timed windows that start there see the same
    decomposition steps."""
    freq = tr.precond.kfac_update_freq
    while tr.state.step % freq != r % freq:
        tr.train_step(batch)


def set_guard(tr, health, loss_fn, **kw):
    """Rebuild ``tr``'s step with the guard ``health`` (True, False or a
    HealthConfig), the preconditioner's in-engine screens to match."""
    from kfac_pytorch_tpu_torch import health as health_lib
    from kfac_pytorch_tpu_torch import training
    tr.precond.health = health_lib.resolve(health)
    tr.step_fn = training.build_train_step(
        tr.state.model, tr.tx, tr.precond, loss_fn,
        input_dtype=getattr(tr, 'dtype', None), health=health, **kw)


def nan_batch(batch):
    return {**batch, 'input': np.full_like(batch['input'], np.nan)}


def skip_state(state):
    """``{name: tensor}`` a skipped batch must leave alone: parameters,
    BN buffers, momentum, factors and decomposition."""
    out = _state_tensors(state)
    return {k: v.detach().clone() for k, v in out.items()}


def state_gap(got, want):
    """Tensors of ``got`` that differ from ``want`` bit for bit, with
    their largest difference."""
    return {k: float((got[k].double() - want[k].double()).abs().max())
            for k in want if not torch.equal(got[k], want[k])}


def check_skip():
    """ResNet-32 (``--kfac-capture-impl pallas``, a constant lr:
    ``--warmup-epochs 0``) for SKIP_STEPS steps with all-NaN input batches
    at SKIP_NAN, against a control run of the same batches without them,
    under deterministic cuDNN: the two must end bitwise equal (parameters,
    BN buffers, momentum, factors, decomposition). The lr is constant
    because the trainer feeds the KL clip the lr at its own step, as the
    JAX trainer does, and a skipped batch shifts that step against the
    control's. The control runs twice: if it does not repeat itself
    bitwise, the faulted run may part from it as far as its rerun
    does."""
    extra = ['--warmup-epochs', '0']
    with deterministic_cudnn():
        tr = make_trainer('pallas', extra)
        it = tr.train_loader.epoch()
        batches = [next(it) for _ in range(SKIP_STEPS)]
        mets = []
        for i, b in enumerate(batches):
            m = tr.train_step(nan_batch(b) if i in SKIP_NAN else b)
            mets.append({k: int(v) for k, v in m.items()
                         if k.startswith('health/')})
        faulted = skip_state(tr.state)
        health = {k[len('health/'):]: v for k, v in mets[-1].items()}
        oks = [m['health/ok'] for m in mets]
        del tr
        controls = []
        for _ in range(2):
            ctl = make_trainer('pallas', extra)
            for i, b in enumerate(batches):
                if i not in SKIP_NAN:
                    ctl.train_step(b)
            controls.append(skip_state(ctl.state))
            del ctl
    want_ok = [int(i not in SKIP_NAN) for i in range(SKIP_STEPS)]
    if oks != want_ok or health['skipped'] != len(SKIP_NAN) \
            or health['rung'] != 0:
        fail(f'health skip: ok per step {oks}, expected {want_ok}; '
             f'counters {health}')
    gap = state_gap(faulted, controls[0])
    rerun = state_gap(controls[1], controls[0])
    worst = max(gap.values(), default=0.0)
    worst_rerun = max(rerun.values(), default=0.0)
    if gap and worst > worst_rerun:
        fail(f'health skip: {len(gap)} of {len(faulted)} tensors differ '
             f'from the control (largest {worst:.3e}, control rerun '
             f'{worst_rerun:.3e}): {sorted(gap)[:8]}')
    print(f'health skip: resnet32 bs128 capture_impl=pallas, NaN batches at '
          f'steps {list(SKIP_NAN)} of {SKIP_STEPS} (step 10 decomposes), '
          f'health after the last step {json.dumps(health)}; against the '
          f'control without them: {len(gap)} of {len(faulted)} tensors '
          f'differ (largest {worst:.3e}; control rerun: {len(rerun)}, '
          f'{worst_rerun:.3e})', flush=True)
    return {'health': health, 'ok': oks, 'tensors': len(faulted),
            'differ': len(gap), 'max_diff': worst,
            'rerun_differ': len(rerun), 'rerun_max_diff': worst_rerun}


def check_ladder():
    """ResNet-32 with HealthConfig(**LADDER_CFG) and NaN batches at
    LADDER_NAN: the rung after each step must be JAX's oracle
    LADDER_RUNGS and the parameters finite."""
    from kfac_pytorch_tpu_torch import health as health_lib
    from kfac_pytorch_tpu_torch import train_cifar
    tr = make_trainer('pallas')
    set_guard(tr, health_lib.HealthConfig(**LADDER_CFG), train_cifar.loss_fn)
    it = tr.train_loader.epoch()
    rungs, skipped = [], []
    for i in range(LADDER_STEPS):
        b = next(it)
        m = tr.train_step(nan_batch(b) if i in LADDER_NAN else b)
        rungs.append(int(m['health/rung']))
        skipped.append(int(m['health/skipped']))
    finite = all(bool(torch.isfinite(p).all())
                 for p in tr.state.model.parameters())
    if rungs != LADDER_RUNGS or not finite:
        fail(f'health ladder: rungs {rungs}, expected {LADDER_RUNGS}; '
             f'parameters finite: {finite}')
    print(f'health ladder: {LADDER_CFG}, NaN at steps {list(LADDER_NAN)}: '
          f'rungs {rungs} (the JAX oracle), skipped {skipped[-1]}, '
          f'parameters finite', flush=True)
    return {'rungs': rungs, 'skipped': skipped[-1]}


def take_batches(loader, n):
    """The first ``n`` batches of ``loader``'s epochs, one epoch after
    another."""
    out = []
    while len(out) < n:
        with loader.epoch() as it:
            out.extend(b for _, b in zip(range(n - len(out)), it))
    return out


def step_times(tr, batches, n, step=None):
    """Host-clock ms of ``n`` synchronized steps on ``batches`` (host
    batches, or an iterator), the batch fetch included."""
    it = iter(batches)
    step = step or tr.train_step
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(next(it))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def check_f1mc():
    """F1mc on ResNet-32: the kernels' preconditioner (the trainer's,
    ``--kfac-capture-impl pallas --kfac-type F1mc``, pseudo labels from a
    numpy sampler) in lockstep with a capture_impl=None one that takes the
    same gradients and F1mc captures each step under fp64 factor GEMMs:
    the factors are held to check_kernels' RTOL/ATOL. Then K1/K2 launches
    of one factor step and the median factor step, Femp against F1mc."""
    import kfac_pytorch_tpu_torch as tkfac
    from kfac_pytorch_tpu_torch import train_cifar
    rng = np.random.RandomState(9)

    def sampler(gen, out):
        return torch.from_numpy(rng.randint(0, out.shape[-1],
                                            out.shape[0])).to(out.device)

    tr = make_trainer('pallas', ['--kfac-type', 'F1mc'])
    set_guard(tr, True, train_cifar.loss_fn, fisher_type='F1mc',
              fisher_seed=tr.args.seed, fisher_sample_fn=sampler)
    a = tr.args
    ref = tkfac.get_kfac_module(a.kfac_name)(
        lr=a.base_lr, damping=a.damping, kfac_update_freq=a.kfac_update_freq,
        kl_clip=a.kl_clip, factor_decay=a.stat_decay)
    ref.setup(tr.precond.plan.metas)
    ref_state = [ref.init(tr.device)]
    inner = tr.precond.step
    worst = [0.0]
    bad = []

    def lockstep(state, grads, acts=None, gs=None, **kw):
        out = inner(state, grads, acts, gs, **kw)
        with fp64_stat_gemm():
            _, ref_state[0] = ref.step(ref_state[0], grads, acts, gs, **kw)
        for k, v in ref_state[0].factors.items():
            s = cs_scale(v)
            err, ok = close(out[1].factors[k], v, RTOL, ATOL, s)
            worst[0] = max(worst[0], float(((out[1].factors[k].double()
                                             - v.double()).abs() / s).max()))
            if not ok:
                bad.append(f'step {state.step} bucket {k}: {err:.3e}')
        return out

    tr.precond.step = lockstep
    it = tr.train_loader.epoch()
    for _ in range(F1MC_STEPS):
        tr.train_step(next(it))
    tr.precond.step = inner
    if bad:
        fail('f1mc lockstep: factors off the fp64-GEMM plain path: '
             + '; '.join(bad))
    femp = make_trainer('pallas')
    batch = next(it)
    launches, ms = {}, {}
    for name, t in (('Femp', femp), ('F1mc', tr)):
        t.train_step(batch)
        reset_counts()
        t.train_step(batch)
        launches[name] = {k: v for k, v in read_counts().items()
                          if k in ('K1 conv_a', 'K2 stat_rows')}
        ms[name] = float(np.median(step_times(t, [batch] * 10, 10)))
    print(f'f1mc: {F1MC_STEPS} steps in lockstep (kernels vs the plain path '
          f'under fp64 factor GEMMs, same F1mc captures): factors max err '
          f'{worst[0]:.3e} x sqrt(F_ii F_jj) (tolerance {ATOL} + {RTOL} '
          f'relative); K1/K2 launches a factor step {json.dumps(launches)}; '
          f'factor step ms median Femp {ms["Femp"]:.3f}, F1mc '
          f'{ms["F1mc"]:.3f}', flush=True)
    return {'factor_max_err': worst[0], 'launches': launches,
            'step_ms': ms}


def count_syncs(fn):
    """The synchronizing CUDA calls that ``fn`` makes
    (``torch.cuda.set_sync_debug_mode('warn')``), each as the
    ``file:line`` of the Python call that made it."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f'{os.path.relpath(w.filename)}:{w.lineno}' for w in caught
            if 'called a synchronizing' in str(w.message)]


def guard_parts(tr):
    """Host ms of each part of the guard (its device work included:
    each part ends in a synchronize), on the tensors of one ResNet-32
    factor step: the screens, the selects, the snapshot, the ladder and
    the device lr; 50 calls each."""
    from kfac_pytorch_tpu_torch import capture, training
    from kfac_pytorch_tpu_torch import health as health_lib
    rec = {}
    inner = tr.precond.step

    def spy(state, grads, acts=None, gs=None, **kw):
        out = inner(state, grads, acts, gs, **kw)
        rec.update(grads=grads, acts=acts, gs=gs, pgrads=out[0], old=state,
                   new=out[1])
        return out

    tr.precond.step = spy
    tr.train_step(next(tr.train_loader.epoch()))
    tr.precond.step = inner
    g, pg = rec['grads'], rec['pgrads']
    changed = [k for k in g if pg[k] is not g[k]]
    hs, cfg, keep = tr.state.health, tr.step_fn.health, tr.step_fn.keep
    model = tr.state.model
    ok = torch.ones((), dtype=torch.bool, device=DEVICE)
    loss = torch.zeros((), device=DEVICE)
    parts = {
        'screen a, g, loss': lambda: capture.all_finite(rec['acts'],
                                                        rec['gs'], loss),
        'screen grads': lambda: capture.all_finite(g),
        'screen preconditioned': lambda: capture.all_finite(
            [pg[k] for k in changed]),
        'select grads': lambda: [torch.where(ok, pg[k], g[k])
                                 for k in changed],
        'snapshot lookup': lambda: training.Snapshot.of(
            list(model.parameters()) + list(model.buffers())
            + capture.tensor_leaves(tr.state.opt_state), keep),
        'snapshot save': keep.save,
        'snapshot restore': lambda: keep.restore_unless(ok),
        'select K-FAC state': lambda: training._select_kfac_state(
            ok, rec['new'], rec['old']),
        'ladder': lambda: health_lib.on_good_batch(hs, cfg, ok).select(
            ok, health_lib.on_bad_batch(hs, cfg)),
        'ladder damping': lambda: health_lib.effective_damping(
            hs, tr.precond.damping, cfg),
        'lr on the device': lambda: tr.tx.lr(tr.state.step - hs.skipped),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 50 * 1e3
    return out


#: the CUDA runtime calls that launch a kernel, as torch.profiler names them
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC',
                'cudaLaunchCooperativeKernel', 'cuLaunchKernel',
                'cuLaunchKernelEx')


def launches_a_step(tr, batch, steps=3):
    """Kernel launches and host (self CPU) ms a step of ``tr``'s step
    function over ``steps`` steps after a warm one (torch.profiler, host
    and device), none a decomposition step."""
    from torch.profiler import ProfilerActivity, profile
    align(tr, batch, 1)
    b = tr.to_device(batch)

    def step():
        tr.state, _ = tr.step_fn(tr.state, b, lr=tr.lr_fn(tr.state.step),
                                 damping=tr.precond.damping)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return {'launches': sum(e.count for e in ev
                            if e.key in LAUNCH_CALLS) / steps,
            'host_ms': sum(e.self_cpu_time_total for e in ev) / steps / 1e3}


def guard_cost(tr, loss_fn, steps, label, rounds=3, parts=False):
    """Median step ms of ``tr`` with the guard on and off: ``rounds``
    rounds, each a block of ``steps`` timed steps (after GUARD_WARM
    untimed ones) on and one off, every block starting at the same step
    of the decomposition cycle; the synchronizing calls of one step of
    each, half way between decompositions (its step function on a batch
    already on the card); with ``parts``, :func:`guard_parts`."""
    batches = take_batches(tr.train_loader, steps + GUARD_WARM)
    out = {}
    for _ in range(rounds):
        for on in (True, False):
            set_guard(tr, on, loss_fn)
            align(tr, batches[0], 1)
            times = step_times(tr, batches, len(batches))[GUARD_WARM:]
            out.setdefault('on' if on else 'off', []).append(
                float(np.median(times)))
    syncs = {}
    dev_batch = tr.to_device(batches[1])
    freq = tr.precond.kfac_update_freq
    for on in (True, False):
        set_guard(tr, on, loss_fn)
        tr.train_step(batches[0])
        tr.train_step(batches[0])
        align(tr, batches[0], freq // 2)
        lr = tr.lr_fn(tr.state.step)

        torch.cuda.synchronize()

        def one():
            tr.state, _ = tr.step_fn(tr.state, dev_batch, lr=lr,
                                     damping=tr.precond.damping)
        syncs['on' if on else 'off'] = count_syncs(one)
        torch.cuda.synchronize()
    host, prof = {}, {}
    if parts:
        for on in (True, False):
            set_guard(tr, on, loss_fn)
            prof['on' if on else 'off'] = launches_a_step(tr, batches[0])
    set_guard(tr, True, loss_fn)
    if parts:
        host = guard_parts(tr)
    n_on, n_off = len(syncs['on']), len(syncs['off'])
    if host:
        print(f'guard cost ({label}): host ms of its parts (device work '
              f'included) {json.dumps({k: round(v, 4) for k, v in host.items()})}, '
              f'sum {sum(host.values()):.3f}; a factor step under '
              f'torch.profiler, on / off: {prof["on"]["launches"]:.0f} / '
              f'{prof["off"]["launches"]:.0f} kernel launches, host '
              f'{prof["on"]["host_ms"]:.2f} / {prof["off"]["host_ms"]:.2f} '
              'ms (self CPU, profiled)', flush=True)
    print(f'guard cost ({label}): step ms median, guard on '
          f'{out["on"]} vs off {out["off"]} ({rounds} x {steps} steps); '
          f'synchronizing calls in one step (step % kfac_update_freq = '
          f'{freq // 2}): on {n_on}, off {n_off}, at '
          f'{json.dumps(sorted(set(syncs["on"] + syncs["off"])))}',
          flush=True)
    if n_on > n_off:
        fail(f'guard cost ({label}): the guard adds synchronizing calls: '
             f'{syncs["on"]} against {syncs["off"]}')
    return {'step_ms_on': out['on'], 'step_ms_off': out['off'],
            'parts_ms': host, 'profiled_step': prof,
            'syncs_on': n_on, 'syncs_off': n_off,
            'sync_sites': {k: sorted(set(v)) for k, v in syncs.items()}}


def check_data(tr, launches):
    """The native augmentation (built from native/kfac_native.cc) bitwise
    against the numpy branch on a batch of 128, with host ms of each; the
    first epoch at prefetch depth 2 batch for batch the one at depth 0;
    the ResNet-32 step median (batch fetch included) and a profile's
    device busy share at depth 2 and at depth 0."""
    from kfac_pytorch_tpu_torch import data as kdata
    from kfac_pytorch_tpu_torch import native_lib
    if native_lib.get_lib() is None:
        fail(f'native library did not build: {native_lib.build_error}')
    x = kdata._normalize(tr.train_loader.x[:128])
    r = np.random.RandomState(3)
    offs = r.randint(0, 9, size=(len(x), 2)).astype(np.int32)
    flips = r.rand(len(x)) < 0.5
    host = {}
    outs = {}
    for name, fn in (('native', lambda: native_lib.augment_crop_flip(
            x, offs, flips.astype(np.uint8))),
                     ('numpy', lambda: kdata.crop_flip(x, offs, flips))):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            outs[name] = fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        host[name] = float(np.median(ts))
    if not np.array_equal(outs['native'], outs['numpy']):
        fail('data: the native crop-flip differs from the numpy branch')
    a = kdata.Loader(tr.train_loader.x, tr.train_loader.y, 128, seed=5,
                     augment=kdata.augment_cifar)
    b = kdata.Loader(tr.train_loader.x, tr.train_loader.y, 128, seed=5,
                     augment=kdata.augment_cifar)
    n = 0
    for ba, bb in zip(a.epoch(prefetch_depth=2), b.epoch(prefetch_depth=0)):
        n += 1
        if not (np.array_equal(ba['input'], bb['input'])
                and np.array_equal(ba['label'], bb['label'])):
            fail(f'data: batch {n - 1} at prefetch depth 2 differs from '
                 'depth 0')
    calls = native_lib.augment_crop_flip.calls
    depth = {d: {'step_ms_median': []} for d in (2, 0)}
    b0 = next(tr.train_loader.epoch())
    for _ in range(DEPTH_ROUNDS):
        for d in (2, 0):
            align(tr, b0, 1)
            times = step_times(tr, tr.train_loader.epoch(prefetch_depth=d),
                               DEPTH_STEPS + 1)
            depth[d]['step_ms_median'].append(float(np.median(times[1:])))
    for d in (2, 0):
        # one warm step and 3 profiled ones, none a decomposition step
        align(tr, b0, 1)
        prof = profile_steps(tr, tr.train_loader.epoch(prefetch_depth=d),
                             f'resnet32 prefetch depth {d}',
                             per_step(launches))
        busy = prof['device_ms_per_step'] / prof['wall_ms_per_step']
        depth[d].update(device_busy=busy, idle_share=1.0 - busy)
    if native_lib.augment_crop_flip.calls <= calls:
        fail('data: the trainer\'s loader did not use the native library')
    print(f'data: native augment bitwise the numpy branch on 128 images '
          f'(host ms {host["native"]:.3f} native, {host["numpy"]:.3f} '
          f'numpy); {n} batches at prefetch depth 2 equal depth 0; resnet32 '
          f'step ms medians (fetch included, {DEPTH_ROUNDS} alternating '
          f'rounds of {DEPTH_STEPS}) depth 2 {depth[2]["step_ms_median"]} '
          f'(device idle {100 * depth[2]["idle_share"]:.1f}%), depth 0 '
          f'{depth[0]["step_ms_median"]} (idle '
          f'{100 * depth[0]["idle_share"]:.1f}%)', flush=True)
    return {'augment_host_ms': host, 'epoch_batches_equal': n,
            'depth': depth}


def run_slice9(launches):
    """The slice-9 phase on ResNet-32 (and the guard's cost there); the
    ResNet-50 guard cost runs in the ResNet-50 phase."""
    from kfac_pytorch_tpu_torch import train_cifar
    t0 = time.perf_counter()
    out = {'skip': check_skip(), 'ladder': check_ladder(),
           'f1mc': check_f1mc()}
    torch.cuda.empty_cache()
    tr = make_trainer('pallas')
    out['guard_cost_resnet32'] = guard_cost(tr, train_cifar.loss_fn,
                                            GUARD_STEPS_R32, 'resnet32',
                                            parts=True)
    out['data'] = check_data(tr, launches)
    del tr
    torch.cuda.empty_cache()
    print(f'slice 9 phase: {time.perf_counter() - t0:.1f} s', flush=True)
    return out


# ---------------------------------------------------------------------------
# slice 10: E-KFAC (ekfac, ekfac_dp) and KFAC.replan at world=1
# ---------------------------------------------------------------------------

#: ResNet-50 ekfac_dp: trainer steps, then alternating timing rounds of
#: R50_EKFAC_BLOCK steps each against eigen_dp
R50_EKFAC_STEPS, R50_EKFAC_ROUNDS, R50_EKFAC_BLOCK = 6, 2, 2
#: the moments at every ResNet-50 layer against the same operands in fp64:
#: the largest gap relative to the layer's largest moment
SCALES_TOL = 1e-4
#: the replan run on ResNet-32: (variant, steps) in order
REPLAN_RUNS = [('eigen_dp', 4), ('ekfac_dp', 4), ('inverse_dp', 4)]
#: the E-KFAC checkpoint check on ResNet-32: save after, run on
EKFAC_SAVE_AFTER, EKFAC_RESUME_MORE = 3, 2
EKFAC_CKPT = os.path.join(OUT_DIR, 'ckpt_ekfac')


def scales_nonzero(kfac_state):
    return all(bool(torch.any(v != 0))
               for v in kfac_state.decomp['scales'].values())


def zero_scale_groups(kfac_state):
    return sorted(k for k, v in kfac_state.decomp['scales'].items()
                  if not bool(torch.any(v != 0)))


def r50_captures(tr):
    """One batch's bf16 captures and gradients of ``tr``'s model."""
    from kfac_pytorch_tpu_torch import capture, training
    model = tr.state.model
    batch = tr.to_device(next(iter(tr.train_loader.epoch())))
    model.train()
    model.zero_grad(set_to_none=True)
    with capture.Capture(model, tr.precond.plan.metas) as cap:
        out = model(training.model_input(model, batch['input'], tr.dtype))
        tr.loss_fn(out, batch).backward()
    model.zero_grad(set_to_none=True)
    return cap.acts, cap.gs


def check_scales_fp64(tr, acts, gs):
    """The port's E-KFAC moments at every ResNet-50 layer (its rows from
    one batch's bf16 captures, the trained basis) against the same
    operands in fp64; fails over SCALES_TOL. Returns the gaps by layer."""
    from kfac_pytorch_tpu_torch import capture, ops
    plan, decomp = tr.precond.plan, tr.state.kfac_state.decomp
    gaps = {}
    for i, meta in enumerate(plan.metas):
        a, g = capture.layer_act(acts, meta), capture.layer_g(gs, meta)
        if meta.kind == 'dense':
            arows, grows, n = ops.layer_rows_dense(a, g, meta.use_bias)
        else:
            arows, grows, n = ops.layer_rows_conv(
                a, g, meta.kernel_size, meta.strides, meta.padding,
                meta.use_bias)
        ba, ra, bg, rg, _ = plan.layer_rows[i]
        qa = decomp['evecs'][str(ba)][ra][:arows.shape[1]]
        qg = decomp['evecs'][str(bg)][rg][:grows.shape[1]]
        got = ops.ekfac_scales(arows, grows, qa, qg, n).double()
        pa = arows.double() @ qa.double()
        pg = grows.double() @ qg.double()
        want = (pg * pg).T @ ((pa * pa) / n)
        gaps[meta.name] = float((got - want).abs().max()
                                / want.abs().max())
        del arows, grows, pa, pg, got, want
    worst = max(gaps, key=gaps.get)
    print(f'resnet50 ekfac moments vs fp64 (same bf16 captures, trained '
          f'basis): {len(gaps)} layers, largest gap {gaps[worst]:.3e} of the '
          f'layer\'s largest moment ({worst}), median '
          f'{float(np.median(list(gaps.values()))):.3e}', flush=True)
    if gaps[worst] > SCALES_TOL:
        fail(f'resnet50 ekfac moments: {worst} parts from fp64 by '
             f'{gaps[worst]:.3e}, over {SCALES_TOL}')
    return gaps


def moment_ms(tr, acts, gs):
    """Ms between two CUDA events around each E-KFAC part of an
    ``ekfac_dp`` step on one batch's captures: the moment update (every
    layer's rows, projections and moment GEMM, and the EMA) and the
    transport after a full decomposition (the stored basis read with
    ``local_evecs``, then ``rotate_ekfac_scales_local``). The update's
    ~1,000 launches fill the launch queue, so no GPU spin can hide the
    host: each time holds the host's enqueue where the device does not
    overlap it."""
    from kfac_pytorch_tpu_torch import engine
    pre, st = tr.precond, tr.state.kfac_state
    plan, decomp = pre.plan, st.decomp

    def update():
        engine.update_ekfac_scales_local(
            plan, decomp, acts, gs, pre.batch_averaged, decomp['scales'],
            pre.factor_decay, None)

    def rotate():
        engine.rotate_ekfac_scales_local(
            plan, decomp['scales'],
            engine.local_evecs(plan, decomp, None, 'pred'),
            decomp['evecs'], None)
    return {'update_ms': time_ms(update, reps=3, hide_host=False),
            'rotate_ms': time_ms(rotate, reps=3, hide_host=False)}


def step_peak_mib(tr, batch):
    """Peak device memory one step adds over what is allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(batch)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def run_resnet50_ekfac():
    """ResNet-50 ``ekfac_dp`` at the ImageNet trainer's full size (bs32,
    224 x 224, bf16, the capture kernels): R50_EKFAC_STEPS steps with K1/K2
    counts (eigen_dp's a step), finite losses, every moments group non-zero
    after step 0 (at step 0 a group whose layers all feed a residual-final
    BatchNorm, its scale initialized to zero, has g = 0 and zero
    moments; its first update makes the scale non-zero); the moments at every layer against fp64; the moment
    update's device ms; and the step median and a step's peak memory
    against eigen_dp in alternating rounds, and one device-only profiled
    step of each (device busy ms)."""
    t0 = time.perf_counter()
    tr = make_imagenet_trainer('pallas', ['--kfac-name', 'ekfac_dp'])
    want, n_conv, n_dense = launches_wanted(tr, R50_EKFAC_STEPS)
    batches = take_batches(tr.train_loader, R50_EKFAC_STEPS)
    reset_counts()
    losses, times, zero = [], [], {}
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        losses.append(float(tr.train_step(b)['loss']))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - s0) * 1e3)
        groups = zero_scale_groups(tr.state.kfac_state)
        if groups:
            zero[i] = groups
    launches = read_counts()
    if launches != want:
        fail(f'resnet50 ekfac_dp kernel launches {launches}, expected '
             f'{want} (eigen_dp\'s)')
    if not all(np.isfinite(losses)) or set(zero) - {0}:
        fail(f'resnet50 ekfac_dp: losses {losses}, zero moments groups '
             f'by step {zero}')
    groups = len(tr.precond.plan.pred_groups)
    scale_bytes = sum(v.numel() * v.element_size() for v in
                      tr.state.kfac_state.decomp['scales'].values())
    a = tr.args
    print(f'{a.model} ekfac_dp (world=1): bs{a.batch_size} {a.img_size}x'
          f'{a.img_size} bf16 kfac_update_freq={a.kfac_update_freq} '
          f'capture_impl={a.kfac_capture_impl}, {R50_EKFAC_STEPS} steps, '
          f'losses {[round(x, 4) for x in losses]}, step ms median '
          f'{float(np.median(times)):.1f} (first {times[0]:.1f}), launches '
          f'{launches} (K1 {n_conv}, K2 {n_conv + 2 * n_dense} a step, as '
          f'eigen_dp), {groups} moment groups ({scale_bytes / 2**20:.1f} '
          f'MiB), zero at step 0 {zero.get(0, [])} (residual-final '
          f'BatchNorm scales start at zero), non-zero from step 1', flush=True)
    acts, gs = r50_captures(tr)
    gaps = check_scales_fp64(tr, acts, gs)
    ms = moment_ms(tr, acts, gs)
    print(f'resnet50 ekfac moments: update {ms["update_ms"]:.3f} ms a '
          f'factor step, transport {ms["rotate_ms"]:.3f} ms a full '
          f'decomposition (CUDA events, host enqueue not hidden)',
          flush=True)
    del acts, gs
    torch.cuda.empty_cache()
    eig = make_imagenet_trainer('pallas')
    runs = {'eigen_dp': eig, 'ekfac_dp': tr}
    med = {k: [] for k in runs}
    peak = {}
    timed = take_batches(tr.train_loader, R50_EKFAC_BLOCK + 1)
    for name, t in runs.items():
        t.train_step(timed[0])          # both past their first (cold) step
    for _ in range(R50_EKFAC_ROUNDS):
        for name, t in runs.items():
            med[name].append(float(np.median(
                step_times(t, timed[1:], R50_EKFAC_BLOCK))))
    for name, t in runs.items():
        peak[name] = step_peak_mib(t, timed[1])
    ratio = float(np.median(med['ekfac_dp']) / np.median(med['eigen_dp']))
    print(f'resnet50 ekfac_dp vs eigen_dp (alternating, {R50_EKFAC_ROUNDS} '
          f'rounds x {R50_EKFAC_BLOCK} steps): step ms medians {med}, ratio '
          f'{ratio:.4f}; peak MiB a step adds {json.dumps(peak)}', flush=True)
    per, _, _ = launches_wanted(tr, 1)
    prof = {name: profile_steps(t, iter(timed + timed), f'resnet50 {name}',
                                per, steps=1, host=False)
            for name, t in runs.items()}
    print(f'resnet50 ekfac_dp vs eigen_dp, one profiled step each: device '
          f'busy ms {prof["ekfac_dp"]["device_ms_per_step"]:.1f} vs '
          f'{prof["eigen_dp"]["device_ms_per_step"]:.1f}, wall ms '
          f'{prof["ekfac_dp"]["wall_ms_per_step"]:.1f} vs '
          f'{prof["eigen_dp"]["wall_ms_per_step"]:.1f}; phase '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    del eig, tr, runs
    torch.cuda.empty_cache()
    return {'losses': losses, 'step_ms': times, 'launches': launches,
            'scales_fp64_gap': gaps, 'moment_ms': ms,
            'scales_bytes': scale_bytes, 'round_medians_ms': med,
            'ratio': ratio, 'step_peak_mib': peak,
            'profile': {k: {f: v[f] for f in ('wall_ms_per_step',
                                               'device_ms_per_step', 'top')}
                        for k, v in prof.items()}}


def run_replan():
    """ResNet-32 with the capture kernels through REPLAN_RUNS by
    ``KFAC.replan`` between the runs: the factors carried bitwise at each
    switch, the same-method switch still decomposed, the cross-method one
    passing gradients through (``decomposed`` false) until its next
    inverse update rebuilds the decomposition, K1/K2 launched every step,
    every loss finite."""
    import dataclasses
    tr = make_trainer('pallas', ['--kfac-name', REPLAN_RUNS[0][0]])
    batches = tr.train_loader.epoch()
    freq = tr.precond.kfac_update_freq
    reset_counts()
    losses, log, step = [], [], 0
    for j, (variant, n) in enumerate(REPLAN_RUNS):
        if j:
            k0 = tr.state.kfac_state
            k1 = tr.precond.replan(k0, variant=variant)
            same = all(torch.equal(k1.factors[k], v)
                       for k, v in k0.factors.items())
            if not same or tr.precond.variant != variant:
                fail(f'replan to {variant}: factors not carried bitwise')
            tr.state = dataclasses.replace(tr.state, kfac_state=k1)
            switched = step
        for _ in range(n):
            losses.append(float(tr.train_step(next(batches))['loss']))
            log.append((variant, step, bool(tr.state.decomposed),
                        tr.step_fn.last_decomp))
            step += 1
        if tr.precond.ekfac and not scales_nonzero(tr.state.kfac_state):
            fail(f'replan run: {variant}\'s moments stayed zero')
    launches = read_counts()
    want, _, _ = launches_wanted(tr, step)
    if launches != want:
        fail(f'replan run: kernel launches {launches}, expected {want}')
    # only the last switch changes the method: from it until its first
    # inverse update the gradients pass through
    for variant, i, dec, _ in log:
        expect = i < switched or any(k % freq == 0
                                     for k in range(switched, i + 1))
        if dec != expect:
            fail(f'replan run step {i} ({variant}): decomposed {dec}, '
                 f'expected {expect}: {log}')
    rearm = [i for _, i, dec, _ in log if not dec]
    if not rearm or not all(np.isfinite(losses)):
        fail(f'replan run: no pass-through after the cross-method switch '
             f'or a non-finite loss: {log}, {losses}')
    print(f'replan (resnet32, capture kernels): '
          f'{" -> ".join(f"{v} x{n}" for v, n in REPLAN_RUNS)}, factors '
          f'carried bitwise at each switch, gradients passed through on '
          f'steps {rearm} after the cross-method switch, (variant, step, '
          f'decomposed, decomposition) {log}, losses '
          f'{[round(x, 4) for x in losses]}, launches {launches}',
          flush=True)
    return {'log': log, 'losses': losses, 'launches': launches}


def check_ekfac_resume():
    """An ``ekfac_dp`` ResNet-32 run (capture kernels, deterministic cuDNN)
    saved after EKFAC_SAVE_AFTER steps, restored into a fresh trainer and
    run EKFAC_RESUME_MORE more steps on the same batches: bitwise the
    uninterrupted run, the moments included."""
    import dataclasses
    from kfac_pytorch_tpu_torch.utils import checkpoint
    shutil.rmtree(EKFAC_CKPT, ignore_errors=True)
    extra = ['--kfac-name', 'ekfac_dp']
    with deterministic_cudnn():
        whole = make_trainer('pallas', extra)
        batches = take_batches(whole.train_loader,
                               EKFAC_SAVE_AFTER + EKFAC_RESUME_MORE)
        for i, b in enumerate(batches):
            whole.train_step(b)
            if i + 1 == EKFAC_SAVE_AFTER:
                checkpoint.save_checkpoint(EKFAC_CKPT, 0, whole.state)
        resumed = make_trainer('pallas', extra)
        resumed.state = checkpoint.restore_checkpoint(EKFAC_CKPT, 0,
                                                      resumed.state)
        for b in batches[EKFAC_SAVE_AFTER:]:
            resumed.train_step(b)
    shutil.rmtree(EKFAC_CKPT, ignore_errors=True)
    got, want = _state_tensors(resumed.state), _state_tensors(whole.state)
    differ = state_gap(got, want) if set(got) == set(want) else {'keys': 1}
    n_scales = sum(k.startswith('scales.') for k in want)
    if differ or resumed.state.step != whole.state.step or not n_scales:
        fail(f'ekfac_dp resume: not bitwise ({len(differ)} tensors differ: '
             f'{sorted(differ)}) or no moments ({n_scales})')
    if not scales_nonzero(resumed.state.kfac_state):
        fail('ekfac_dp resume: a moments group is zero')
    print(f'ekfac_dp resume (resnet32, deterministic cuDNN): saved after '
          f'step {EKFAC_SAVE_AFTER}, restored, {EKFAC_RESUME_MORE} more '
          f'steps bitwise the uninterrupted run ({len(want)} tensors, '
          f'{n_scales} moment groups)', flush=True)
    return {'tensors': len(want), 'moment_groups': n_scales}


def run_slice10():
    """The slice-10 phase: ResNet-50 ekfac_dp, the ResNet-32 ekfac_dp
    lockstep, the replan run and the E-KFAC checkpoint (the world=2
    E-KFAC runs are in the world=2 phase)."""
    t0 = time.perf_counter()
    out = {'resnet50': run_resnet50_ekfac()}
    bad = lockstep(['--kfac-name', 'ekfac_dp'], 'ekfac_dp', control=True)
    if bad:
        fail('ekfac_dp lockstep: ' + '; '.join(bad))
    out['replan'] = run_replan()
    out['resume'] = check_ekfac_resume()
    torch.cuda.empty_cache()
    print(f'slice 10 phase: {time.perf_counter() - t0:.1f} s', flush=True)
    return out


# ---------------------------------------------------------------------------
# slice 12: durability and the elastic lane
# ---------------------------------------------------------------------------

S12_DIR = os.path.join(OUT_DIR, 'slice12')
#: the CIFAR trainer's ResNet-32 main path (batch 128, eigen_dp, the
#: capture kernels) with an "epoch" cut to S12_SPE steps; the preempted
#: run gets its SIGTERM just before step S12_SIGTERM_AT (epoch 2)
S12_SPE, S12_EPOCHS, S12_SIGTERM_AT = 4, 3, 9
S12_R32 = ['--device', 'cuda', '--kfac-capture-impl', 'auto',
           '--steps-per-epoch', str(S12_SPE)]
#: the world moves: MPD eigen, over the bf16 wire at world 2 (K3 and a
#: residual) and fp32 at world 1 (the lossy checkpoint's residual dropped)
S12_MOVE = S12_R32 + ['--kfac-name', 'eigen']
#: the ImageNet trainer's ResNet-50 (bs32 224x224 bf16 eigen_dp) for one
#: 2-step epoch with one decomposition
S12_R50 = ['--device', 'cuda', '--synthetic-size', '64', '--steps-per-epoch',
           '2', '--kfac-update-freq', '2', '--kfac-capture-impl', 'pallas',
           '--epochs', '1']


def _digest(t):
    import hashlib
    return hashlib.sha1(t.detach().contiguous().cpu().numpy()
                        .tobytes()).hexdigest()


def owner_rows(pre, kfac_state, rank):
    """``{'<layer>.<A|G>[.<part>]': sha1}`` of the factor rows rank
    ``rank`` owns in ``pre``'s plan: each true factor block, and the
    whole decomposition row of each (``evals``/``evecs``/``invs``)."""
    plan = pre.plan
    out = {}
    for i, meta in enumerate(plan.metas):
        for side, d in ((0, meta.in_dim), (1, meta.out_dim)):
            b, row = plan.layer_rows[i][2 * side:2 * side + 2]
            per = plan.buckets[b].per_dev
            if row // per != rank:
                continue
            key = f'{meta.name}.{"AG"[side]}'
            out[key] = _digest(kfac_state.factors[str(b)][row % per, :d, :d])
            drow = row if pre.comm_mode == 'inverse' else row % per
            for part, tree in kfac_state.decomp.items():
                if part != 'scales':
                    out[f'{key}.{part}'] = _digest(tree[str(b)][drow])
    return out


@contextlib.contextmanager
def spy_resume(module, rec):
    """Record, in ``rec``, what ``module.Trainer``'s resume leaves (the
    owned rows, ``decomposed``, the step, its host seconds) and the K-FAC
    phases of the first step after it."""
    resume, step = module.Trainer.resume, module.Trainer.train_step

    def spied_resume(self):
        t0 = time.perf_counter()
        out = resume(self)
        rec['resume_s'] = time.perf_counter() - t0
        rec['rows'] = owner_rows(self.precond, self.state.kfac_state,
                                 self.rank)
        rec['decomposed'] = bool(self.state.decomposed)
        rec['step'] = self.state.step
        return out

    def spied_step(self, batch):
        m = step(self, batch)
        rec.setdefault('first_phases', list(self.step_fn.last_phases))
        return m

    module.Trainer.resume, module.Trainer.train_step = spied_resume, \
        spied_step
    try:
        yield rec
    finally:
        module.Trainer.resume, module.Trainer.train_step = resume, step


def s12_run(module, argv, group=None):
    """``module.main(argv)`` (in ``group`` at world>1) with its stdout
    captured and echoed, its launches counted and its resume spied:
    returns ``(trainer, record)``."""
    import importlib
    import io
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{module}')
    rec, buf = {}, io.StringIO()
    reset_counts()
    with spy_resume(mod, rec), contextlib.redirect_stdout(buf):
        tr = mod.main(argv, group=group)
    torch.cuda.synchronize()
    rec['launches'] = read_counts()
    rec['log'] = buf.getvalue()
    if tr.rank == 0:
        print(''.join(f'  [{module} world={tr.world}] {line}\n'
                      for line in rec['log'].splitlines()), end='',
              flush=True)
    return tr, rec


def s12_rank(rank, world, group, module, argv):
    """One rank of a world=2 slice-12 run on cuda:0 over gloo: the
    trainer's ``main``; returns its log, launch counts, owned rows at the
    end (and after a resume), and the residual's norm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    tr, rec = s12_run(module, argv + ['--num-devices', str(world),
                                      '--dist-backend', 'gloo'], group)
    k = tr.state.kfac_state
    rec['rows_end'] = owner_rows(tr.precond, k, rank)
    rec['residual_norm'] = (None if k.comm_err is None else float(sum(
        float(v.double().norm()) ** 2 for v in k.comm_err.values())) ** 0.5)
    rec['step_end'] = tr.state.step
    del tr
    torch.cuda.empty_cache()
    return rec


def s12_state(state):
    """``{name: tensor}`` of everything a resumed train state must carry:
    :func:`_state_tensors`, the residual and the health counters."""
    out = _state_tensors(state)
    if state.kfac_state.comm_err is not None:
        out.update({f'comm_err.{b}': v
                    for b, v in state.kfac_state.comm_err.items()})
    if state.health is not None:
        out.update({f'health.{f.name}': getattr(state.health, f.name)
                    for f in dataclasses.fields(state.health)})
    return out


def save_ms(tr, base, epoch, block):
    """Host ms ``save_checkpoint`` blocks for (and until the save is
    durable), and the blob's bytes."""
    from kfac_pytorch_tpu_torch.utils import checkpoint
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(base, epoch, tr.state, block=block)
    blocked = (time.perf_counter() - t0) * 1e3
    checkpoint.wait_for_checkpoints()
    durable = (time.perf_counter() - t0) * 1e3
    return {'blocked_ms': blocked, 'durable_ms': durable,
            'blob_bytes': os.path.getsize(os.path.join(
                base, checkpoint.blob_key(epoch)))}


def s12_preempt():
    """ResNet-32 for S12_EPOCHS epochs straight, then the same run with a
    SIGTERM before step S12_SIGTERM_AT (it saves and exits), then a
    ``--resume`` run to the end, all under deterministic cuDNN: the two
    ends must be bitwise equal (parameters, buffers, momentum, K-FAC state,
    health counters), K1/K2 launched in every run. Then the blocking and
    the asynchronous save of the final state, timed."""
    import signal
    from kfac_pytorch_tpu_torch import train_cifar
    argv = S12_R32 + ['--epochs', str(S12_EPOCHS)]
    dirs = [os.path.join(S12_DIR, n) for n in ('whole', 'cut', 'saves')]
    step = train_cifar.Trainer.train_step

    def preempting(self, batch):
        if self.state.step == S12_SIGTERM_AT:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self, batch)

    with deterministic_cudnn():
        whole, rw = s12_run('train_cifar',
                            argv + ['--checkpoint-dir', dirs[0]])
        train_cifar.Trainer.train_step = preempting
        try:
            cut, rc = s12_run('train_cifar',
                              argv + ['--checkpoint-dir', dirs[1]])
        finally:
            train_cifar.Trainer.train_step = step
        resumed, rr = s12_run('train_cifar', argv + ['--checkpoint-dir',
                                                     dirs[1], '--resume'])
    n_conv = sum(m.kind == 'conv' for m in whole.precond.plan.metas)
    n_dense = len(whole.precond.plan.metas) - n_conv
    total = S12_SPE * S12_EPOCHS
    cut_at = S12_SIGTERM_AT + 1
    for rec, steps, what in ((rw, total, 'uninterrupted'),
                             (rc, cut_at, 'preempted'),
                             (rr, total - cut_at, 'resumed')):
        want = {'K1 conv_a': n_conv * steps,
                'K2 stat_rows': (n_conv + 2 * n_dense) * steps}
        got = {k: rec['launches'][k] for k in want}
        if got != want:
            fail(f'slice 12 {what} run: launches {got}, expected {want}')
    if 'preempted in epoch 2' not in rc['log'] or cut.state.step != cut_at:
        fail(f'slice 12: the SIGTERM did not stop the run in epoch 2 at '
             f'step {cut_at} (step {cut.state.step})')
    got, want = s12_state(resumed.state), s12_state(whole.state)
    differ = sorted(k for k in want if k not in got
                    or not torch.equal(got[k], want[k]))
    if differ or resumed.state.step != whole.state.step:
        fail(f'slice 12: the preempted and resumed run is not bitwise the '
             f'uninterrupted one (step {resumed.state.step} against '
             f'{whole.state.step}; {len(differ)} of {len(want)} tensors '
             f'differ: {differ[:8]})')
    saves = {'block': save_ms(resumed, dirs[2], 0, True),
             'async': save_ms(resumed, dirs[2], 1, False)}
    print(f'slice 12 preemption: resnet32 bs128 eigen_dp, {S12_EPOCHS} '
          f'epochs of {S12_SPE} steps; SIGTERM before step '
          f'{S12_SIGTERM_AT}, saved at step {cut.state.step}, resumed '
          f'{total - cut_at} steps in {rr["resume_s"]:.3f} s: '
          f'{len(want)} tensors bitwise equal to the uninterrupted run '
          f'(deterministic cuDNN); K1/K2 launches {rw["launches"]}, '
          f'{rc["launches"]}, {rr["launches"]}; save_checkpoint of '
          f'{saves["block"]["blob_bytes"]} bytes blocks '
          f'{saves["block"]["blocked_ms"]:.1f} ms (block=True), '
          f'{saves["async"]["blocked_ms"]:.1f} ms (block=False, durable '
          f'after {saves["async"]["durable_ms"]:.1f})', flush=True)
    launches = {k: rw['launches'][k] + rc['launches'][k] + rr['launches'][k]
                for k in rw['launches']}
    return launches, {'saves': saves, 'resume_s': rr['resume_s'],
                      'tensors': len(want)}


def _move_lines(log, old, new, step):
    lines = [f'RESHARDED from_world={old} to_world={new} step={step}',
             f'WORLD_RESCALE from_world={old} to_world={new} '
             'global_batch=']
    bad = [ln for ln in lines if ln not in log]
    m = [ln for ln in log.splitlines() if ln.startswith('WORLD_RESCALE')]
    if bad or not m or not m[0].endswith('lr_factor=1'):
        fail(f'slice 12 move {old} -> {new}: the log lacks {bad} or '
             f'lr_factor=1: {log[-600:]}')


def _check_move(name, before, rec):
    """The rows after a move against the owners' rows before it, and the
    first step after it preconditioning with the carried decomposition."""
    differ = sorted(k for k in before if rec['rows'].get(k) != before[k])
    if differ or set(rec['rows']) != set(before):
        fail(f'slice 12 {name}: {len(differ)} of {len(before)} factor '
             f'blocks and decomposition rows not bitwise the old owners\' '
             f'(first {differ[:6]})')
    if not rec['decomposed'] or (rec.get('first_phases') is not None
                                 and 'pred' not in rec['first_phases']):
        fail(f'slice 12 {name}: the decomposition was not carried '
             f'(decomposed {rec["decomposed"]}, first step phases '
             f'{rec.get("first_phases")})')


def _merged(recs, key):
    out = {}
    for r in recs:
        out.update(r[key])
    return out


def s12_moves():
    """ResNet-32 MPD eigen: world 2 over bf16 (one epoch, checkpoint),
    world 1 over fp32 (resume: the residual dropped; one epoch,
    checkpoint), world 2 over bf16 (resume; one epoch). Every move carries
    each layer's true factor blocks and decomposition rows bitwise from
    their old owners, prints RESHARDED and WORLD_RESCALE (lr_factor=1),
    and preconditions from its first step; the world-2 runs launch K3 and
    end with bitwise replicas."""
    from kfac_pytorch_tpu_torch import launch
    d = os.path.join(S12_DIR, 'moves')
    bf16 = ['--kfac-comm-precision', 'bf16', '--checkpoint-dir', d]
    w2 = launch.spawn(s12_rank, 2, backend='gloo', timeout=300, args=(
        'train_cifar', S12_MOVE + bf16 + ['--epochs', '1']))
    w1_tr, w1 = s12_run('train_cifar', S12_MOVE + [
        '--kfac-comm-precision', 'fp32', '--checkpoint-dir', d, '--resume',
        '--epochs', '2'])
    w1_end = owner_rows(w1_tr.precond, w1_tr.state.kfac_state, 0)
    nb = len(w1_tr.precond.plan.bucket_dims)
    if w1_tr.state.kfac_state.comm_err is not None:
        fail('slice 12: the lossy checkpoint kept its residual in the fp32 '
             'world-1 run')
    del w1_tr
    w2b = launch.spawn(s12_rank, 2, backend='gloo', timeout=300, args=(
        'train_cifar', S12_MOVE + bf16 + ['--resume', '--epochs', '3']))
    w2_blob = os.path.getsize(os.path.join(d, 'checkpoint-0.pt'))
    _move_lines(w1['log'], 2, 1, S12_SPE)
    _move_lines(w2b[0]['log'], 1, 2, 2 * S12_SPE)
    _check_move('world 2 -> 1', _merged(w2, 'rows_end'), w1)
    for r, rec in enumerate(w2b):
        _check_move(f'world 1 -> 2 (rank {r})',
                    {k: v for k, v in w1_end.items() if k in rec['rows']},
                    rec)
    if set(_merged(w2b, 'rows')) != set(w1_end):
        fail('slice 12 world 1 -> 2: the ranks do not own every row')
    for rec in [w1] + w2 + w2b:
        n = rec['launches']
        if not (n['K1 conv_a'] and n['K2 stat_rows']):
            fail(f'slice 12 moves: K1/K2 did not launch: {rec["launches"]}')
    for r, rec in enumerate(w2 + w2b):
        if rec['launches']['K3 ef_quantize'] != nb * S12_SPE:
            fail(f'slice 12 world-2 rank {r % 2}: K3 launched '
                 f'{rec["launches"]["K3 ef_quantize"]} times, expected '
                 f'{nb * S12_SPE}')
        if not rec['residual_norm']:
            fail(f'slice 12 world-2 rank {r % 2}: no residual')
        if 'replicas: 2 ranks bitwise identical' not in rec['log'] \
                and r % 2 == 0:
            fail('slice 12: the world-2 replicas differ')
    print(f'slice 12 moves: resnet32 eigen, world 2 (bf16) -> 1 (fp32) -> 2 '
          f'(bf16), {S12_SPE} steps each: every true factor block and '
          f'decomposition row bitwise the old owner\'s, the lossy '
          f'residual dropped at world 1, preconditioned from the first '
          f'step; the world-2 checkpoint {w2_blob} bytes; resume '
          f'{w1["resume_s"]:.3f} s (2 -> 1), '
          f'{w2b[0]["resume_s"]:.3f} s (1 -> 2, rank 0); launches world 1 '
          f'{w1["launches"]}, world 2 rank 0 {w2[0]["launches"]}',
          flush=True)
    world2 = {k: sum(rec['launches'][k] for rec in w2 + w2b)
              for k in w1['launches']}
    return w1['launches'], world2, {
        'world2_blob_bytes': w2_blob,
        'resume_s': {'2to1': w1['resume_s'], '1to2': w2b[0]['resume_s']}}


def s12_resnet50():
    """The ImageNet trainer, ResNet-50 bs32 bf16 at world 2 (two gloo ranks
    on the card) for 2 steps and a checkpoint, resumed at world 1: every
    true factor block and decomposition row bitwise its old owner's. Then
    the blocking and the asynchronous save, timed."""
    from kfac_pytorch_tpu_torch import launch
    d = os.path.join(S12_DIR, 'resnet50')
    argv = S12_R50 + ['--checkpoint-format', d]
    w2 = launch.spawn(s12_rank, 2, backend='gloo', timeout=600,
                      args=('train_imagenet', argv))
    tr, w1 = s12_run('train_imagenet', argv)
    _move_lines(w1['log'], 2, 1, 2)
    _check_move('resnet50 world 2 -> 1', _merged(w2, 'rows_end'), w1)
    n_conv = sum(m.kind == 'conv' for m in tr.precond.plan.metas)
    n_dense = len(tr.precond.plan.metas) - n_conv
    want = {'K1 conv_a': 2 * n_conv,
            'K2 stat_rows': 2 * (n_conv + 2 * n_dense)}
    for r, rec in enumerate(w2):
        if {k: rec['launches'][k] for k in want} != want:
            fail(f'slice 12 resnet50 world-2 rank {r}: launches '
                 f'{rec["launches"]}, expected {want}')
    blob = os.path.getsize(os.path.join(d, 'checkpoint-0.pt'))
    shutil.rmtree(d, ignore_errors=True)
    saves = {'block': save_ms(tr, d, 0, True),
             'async': save_ms(tr, d, 1, False)}
    del tr
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f'slice 12 resnet50: world 2 (gloo, one card) 2 steps, a '
          f'{blob}-byte checkpoint, resumed at world 1 in '
          f'{w1["resume_s"]:.3f} s with every true factor block and '
          f'decomposition row bitwise the old owner\'s; save_checkpoint '
          f'of {saves["block"]["blob_bytes"]} bytes blocks '
          f'{saves["block"]["blocked_ms"]:.1f} ms (block=True), '
          f'{saves["async"]["blocked_ms"]:.1f} ms (block=False, durable '
          f'after {saves["async"]["durable_ms"]:.1f})', flush=True)
    launches = {k: sum(rec['launches'][k] for rec in w2) for k in want}
    return launches, {'world2_blob_bytes': blob, 'saves': saves,
                      'resume_s': w1['resume_s']}


def run_slice12():
    """The slice-12 phase; returns the launches by path and the numbers."""
    t0 = time.perf_counter()
    shutil.rmtree(S12_DIR, ignore_errors=True)
    launches, out = {}, {}
    launches['resnet32_slice12_preempt'], out['preempt'] = s12_preempt()
    w1, w2, out['moves'] = s12_moves()
    launches['resnet32_slice12_world1'] = w1
    launches['resnet32_slice12_world2'] = w2
    r50, out['resnet50'] = s12_resnet50()
    shutil.rmtree(S12_DIR, ignore_errors=True)
    out['seconds'] = time.perf_counter() - t0
    print(f'slice 12 phase: {out["seconds"]:.1f} s', flush=True)
    return launches, r50, out


# ---------------------------------------------------------------------------
# slice 13: the rest of the vision zoo, and the exclude_parts ablation
# ---------------------------------------------------------------------------

#: the slice-13 nets through their trainers at the repo launchers'
#: configurations, full width and depth, world=1, seed 42, synthetic data,
#: the capture kernels: name -> (trainer module, flags, steps, the dtype
#: of the kernel checks). VGG-16 as train_cifar100.sh runs it (batch.sh:12:
#: bs128, eigen_dp, a factor and a decomposition every step, damping
#: 0.03); WRN-28-10 at the CIFAR trainer's defaults (kfac_update_freq 10);
#: DenseNet-201 and Inception-v4 at train_imagenet.sh's defaults with
#: batch.sh:14's batch of 16 (bf16, eigen_dp every step, damping 0.002)
S13_NETS = {
    'vgg16_cifar100': ('train_cifar', [
        '--model', 'vgg16', '--dataset', 'cifar100', '--kfac-update-freq',
        '1', '--kfac-cov-update-freq', '1', '--damping', '0.03'], 2,
        torch.float32),
    'wrn28_10': ('train_cifar', ['--model', 'wrn-28-10'], 2, torch.float32),
    'densenet201': ('train_imagenet', [
        '--model', 'densenet201', '--batch-size', '16', '--synthetic-size',
        '128'], 2, torch.bfloat16),
    'inception_v4': ('train_imagenet', [
        '--model', 'inception-v4', '--batch-size', '16', '--synthetic-size',
        '128'], 2, torch.bfloat16),
}
#: the Inception-v4 lockstep (its non-square kernels), kernels against the
#: plain path, in steps
S13_LOCKSTEP_STEPS = 1
#: the reference's time breakdown by subtraction on DenseNet-201: the
#: trainer with each of these --exclude-parts, S13_EXCLUDE_STEPS steps of
#: which the first S13_EXCLUDE_WARM are not timed
S13_EXCLUDE = ('', 'ComputeFactor', 'ComputeInverse',
               'ComputeFactor,ComputeInverse')
S13_EXCLUDE_STEPS, S13_EXCLUDE_WARM = 3, 1


def s13_trainer(name, extra=()):
    """Net ``name``'s trainer (S13_NETS) with the capture kernels."""
    import importlib
    module, argv, _, _ = S13_NETS[name]
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{module}')
    return mod.Trainer(mod.parse_args(
        ['--device', DEVICE, '--kfac-capture-impl', 'pallas'] + argv
        + list(extra)))


def s13_steps(tr, steps):
    """``steps`` synchronized steps of ``tr`` on fresh batches: host-clock
    ms, losses, the decomposition each ran (``step_fn.last_decomp``), the
    launches and the peak device memory (MiB) over the run."""
    batches = tr.train_loader.epoch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses, decomps = [], [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        decomps.append(tr.step_fn.last_decomp)
    return {'step_ms': times, 'losses': losses, 'decomps': decomps,
            'launches': read_counts(),
            'peak_mib': torch.cuda.max_memory_allocated() / 2**20}


def s13_decomposition_ms(tr):
    """Device and host ms of one whole decomposition of ``tr``'s trained
    factors (``torch.linalg.eigh`` waits on its error flags on the host)."""
    from kfac_pytorch_tpu_torch import engine
    pre = tr.precond
    damping = torch.tensor(pre.damping, device=tr.device)
    return time_ms(lambda: engine.compute_decomposition(
        pre.plan, tr.state.kfac_state.factors, damping, pre.method, pre.eps),
        reps=2, hide_host=False)


def s13_net(name):
    """Net ``name``'s trainer for its steps: finite losses, K1/K2 one a
    conv and one a conv's G and a dense layer's A and G each factor step,
    the decomposition on the steps the cadence says; the step median,
    images/s, the decomposition's ms, peak memory; then K1/K2 against
    their plain versions at every distinct captured shape. Returns the
    trainer, its launches, its per-shape rows and its numbers."""
    t0 = time.perf_counter()
    _, _, steps, dtype = S13_NETS[name]
    tr = s13_trainer(name)
    built_s = time.perf_counter() - t0
    pre = tr.precond
    want, n_conv, n_dense = launches_wanted(tr, steps)
    run = s13_steps(tr, steps)
    if not all(np.isfinite(run['losses'])):
        fail(f'{name}: non-finite training loss: {run["losses"]}')
    if run['launches'] != want:
        fail(f'{name}: kernel launches {run["launches"]}, expected {want}')
    cadence = ['full' if i % pre.kfac_update_freq == 0 else None
               for i in range(steps)]
    if run['decomps'] != cadence:
        fail(f'{name}: decompositions {run["decomps"]}, expected '
             f'{cadence}')
    med = float(np.median(run['step_ms']))
    batch = tr.args.batch_size
    out = {'built_s': built_s, **run, 'step_ms_median': med,
           'images_per_s': batch / med * 1e3,
           'decomposition_ms': s13_decomposition_ms(tr),
           'convs': n_conv, 'dense': n_dense,
           'buckets': list(pre.plan.bucket_dims),
           'params': sum(p.numel() for p in tr.state.model.parameters())}
    cases = (resnet50_cases(tr) if dtype == torch.bfloat16
             else resnet_cases(tr))
    out['distinct_shapes'] = len(cases)
    rows = check_kernels(cases, name, dtypes=(dtype,), timed=dtype)
    out['k1_ms'] = sum(r['ms'] * r['per_step'] for r in rows
                       if r['kernel'] == 'K1 conv_a')
    out['k2_ms'] = sum(r['ms'] * r['per_step'] for r in rows
                       if r['kernel'] == 'K2 stat_rows')
    print(f'slice 13 {name}: {out["params"] / 1e6:.1f} M parameters, '
          f'{n_conv} convs, {n_dense} dense, buckets {out["buckets"]}; '
          f'bs{batch} {str(dtype)[6:]} eigen_dp kfac_update_freq='
          f'{pre.kfac_update_freq} damping {pre.damping}, {steps} steps, '
          f'losses {[round(x, 4) for x in run["losses"]]}, decompositions '
          f'{run["decomps"]}, step ms median {med:.1f} (first '
          f'{run["step_ms"][0]:.1f}), images/s {out["images_per_s"]:.1f}, '
          f'decomposition {out["decomposition_ms"]:.1f} ms, peak '
          f'{out["peak_mib"]:.0f} MiB, launches {run["launches"]} (K1 '
          f'{n_conv}, K2 {n_conv + 2 * n_dense} a factor step); K1/K2 '
          f'against plain at {len(cases)} distinct shapes: K1 '
          f'{out["k1_ms"]:.3f} ms, K2 {out["k2_ms"]:.3f} ms a factor step; '
          f'trainer built in {built_s:.1f} s', flush=True)
    return tr, run['launches'], rows, out


def s13_exclude_parts():
    """The reference's breakdown by subtraction on DenseNet-201: its
    trainer with each of S13_EXCLUDE (``--exclude-parts``) for
    S13_EXCLUDE_STEPS steps, each median of the steps after the first
    S13_EXCLUDE_WARM printed. Without
    ComputeFactor no K1/K2 launches; without ComputeInverse no
    decomposition runs and the gradients leave the preconditioner bitwise
    as they entered it. Returns the launches and the numbers."""
    from kfac_pytorch_tpu_torch import engine
    out, launches, batch = {}, None, None
    calls = {'decompositions': 0}
    inner = engine.compute_decomposition

    def counted(*a, **k):
        calls['decompositions'] += 1
        return inner(*a, **k)

    engine.compute_decomposition = counted
    try:
        for parts in S13_EXCLUDE:
            tr = s13_trainer('densenet201', ['--exclude-parts', parts])
            batch = tr.args.batch_size
            want, _, _ = launches_wanted(tr, S13_EXCLUDE_STEPS)
            step, same = tr.precond.step, []

            def spy(state, grads, *a, **k):
                new, st = step(state, grads, *a, **k)
                same.append(all(torch.equal(new[n], grads[n])
                                for n in grads))
                return new, st

            tr.precond.step = spy
            calls['decompositions'] = 0
            run = s13_steps(tr, S13_EXCLUDE_STEPS)
            label = parts or 'none'
            if not all(np.isfinite(run['losses'])):
                fail(f'exclude_parts {label}: non-finite loss')
            if 'ComputeFactor' in parts:
                want = dict(want, **{'K1 conv_a': 0, 'K2 stat_rows': 0})
            if run['launches'] != want:
                fail(f'exclude_parts {label}: kernel launches '
                     f'{run["launches"]}, expected {want}')
            if 'ComputeInverse' in parts:
                if calls['decompositions'] or any(run['decomps']) \
                        or not all(same):
                    fail(f'exclude_parts {label}: {calls["decompositions"]} '
                         f'decompositions ran, or the gradients changed '
                         f'({same})')
            elif calls['decompositions'] != S13_EXCLUDE_STEPS:
                fail(f'exclude_parts {label}: {calls["decompositions"]} '
                     'decompositions')
            launches = ({k: v + run['launches'][k] for k, v in
                         launches.items()} if launches else run['launches'])
            out[label] = {**run,
                          'step_ms_median': float(np.median(
                              run['step_ms'][S13_EXCLUDE_WARM:])),
                          'grads_untouched': same}
            del tr
            torch.cuda.empty_cache()
    finally:
        engine.compute_decomposition = inner
    med = {k: v['step_ms_median'] for k, v in out.items()}
    out['breakdown_ms'] = {
        'ComputeFactor': med['none'] - med['ComputeFactor'],
        'ComputeInverse': med['none'] - med['ComputeInverse'],
        'rest': med['ComputeFactor,ComputeInverse']}
    print(f'slice 13 exclude_parts on densenet201 (bs{batch} bf16 eigen_dp, '
          f'{S13_EXCLUDE_WARM} warm + '
          f'{S13_EXCLUDE_STEPS - S13_EXCLUDE_WARM} timed steps each): step '
          f'ms medians '
          f'{json.dumps({k: round(v, 1) for k, v in med.items()})}; by '
          f'subtraction ComputeFactor {out["breakdown_ms"]["ComputeFactor"]:.1f}'
          f' ms, ComputeInverse {out["breakdown_ms"]["ComputeInverse"]:.1f} '
          f'ms, the rest {out["breakdown_ms"]["rest"]:.1f} ms; without '
          'ComputeFactor no K1/K2, without ComputeInverse no decomposition '
          'and the gradients bitwise untouched', flush=True)
    return launches, out


def run_slice13():
    """The slice-13 phase: the four nets (:func:`s13_net`), the
    Inception-v4 lockstep and the exclude_parts breakdown. Returns the
    launches by path, the per-shape rows (fp32 and bf16) and the
    numbers."""
    t0 = time.perf_counter()
    launches, rows, out = {}, [], {}
    for name in S13_NETS:
        t1 = time.perf_counter()
        tr, launches[name], net_rows, out[name] = s13_net(name)
        rows += net_rows
        if name == 'inception_v4':
            out[name]['lockstep'] = check_lockstep(
                tr, label=name, steps=S13_LOCKSTEP_STEPS)
        del tr
        torch.cuda.empty_cache()
        out[name]['seconds'] = time.perf_counter() - t1
    launches['densenet201_exclude_parts'], out['exclude_parts'] = \
        s13_exclude_parts()
    out['seconds'] = time.perf_counter() - t0
    nets = {k: round(out[k]['seconds'], 1) for k in S13_NETS}
    print(f'slice 13 phase: {out["seconds"]:.1f} s (nets {json.dumps(nets)})',
          flush=True)
    return launches, rows, out


#: slice 14: the sequence trainers at the repo's configurations, on their
#: synthetic fallbacks with the capture kernels: Transformer-base on
#: Multi30k (train_multi30k.sh: bs128, max_len 32, a factor and a
#: decomposition every step, damping 0.03, a 10000-token vocabulary),
#: BERT-base on SQuAD (train_squad.sh: bs4, sequence 64, every step,
#: damping 0.003), the WikiText-2 LSTM (650 wide, 2 layers, bs20, BPTT 35,
#: 10000 tokens) with SGD and with K-FAC every 10 steps
S14_COMMON = ['--kfac-capture-impl', 'pallas', '--seed', '42']
S14_NETS = {
    'transformer_base': ('train_multi30k', [
        '--kfac-update-freq', '1', '--kfac-cov-update-freq', '1',
        '--damping', '0.03', '--synthetic-vocab', '10000']),
    'bert_base': ('train_squad', [
        '--model-size', 'base', '--batch-size', '4', '--max-seq-length',
        '64', '--kfac-update-freq', '1', '--kfac-cov-update-freq', '1',
        '--damping', '0.003']),
    'lstm_sgd': ('train_wikitext', ['--synthetic-vocab', '10000']),
    'lstm_kfac': ('train_wikitext', ['--synthetic-vocab', '10000',
                                     '--kfac-update-freq', '10']),
}
#: timed steps a net, after its warm steps (one, or as many as put a
#: decomposition step last in the window)
S14_TIMED = 4
#: the kernels' K-FAC step in lockstep with the plain path, in steps
S14_LOCKSTEP_STEPS = 2
S14_LOCKSTEP = ('transformer_base', 'lstm_kfac')


def s14_trainer(name, corpus=None):
    """Net ``name``'s trainer (S14_NETS); the LSTMs share ``corpus``."""
    import importlib
    module, argv = S14_NETS[name]
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{module}')
    args = mod.parse_args(['--device', DEVICE] + S14_COMMON + argv)
    return mod.Trainer(args) if corpus is None else mod.Trainer(args,
                                                                corpus)


def s14_net(name, corpus=None):
    """Net ``name``'s trainer: warm steps, then S14_TIMED synchronized
    steps with finite losses, K2 launched once for each dense layer's A
    and G a factor step (none for SGD), the decomposition on the steps
    the cadence says; the step median, tokens/s, the decomposition's ms,
    the peak memory of the trainer's build, warm and timed steps over
    what was allocated before; then K2 against its plain version at
    every distinct captured shape, and the lockstep for S14_LOCKSTEP.
    Returns the launches, the per-shape rows and the numbers."""
    from kfac_pytorch_tpu_torch import training
    # the net's peak is taken over what earlier phases left allocated
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = s14_trainer(name, corpus)
    built_s = time.perf_counter() - t0
    pre = tr.precond
    freq = pre.kfac_update_freq if pre is not None else 0
    warm = max(1, freq - S14_TIMED + 1)
    batches = tr.batches()
    for _ in range(warm):
        tr.train_step(next(batches))
    torch.cuda.synchronize()
    reset_counts()
    times, losses, decomps = [], [], []
    for _ in range(S14_TIMED):
        batch = next(batches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m['loss']))
        decomps.append(tr.step_fn.last_decomp)
    launches = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    if not all(np.isfinite(losses)):
        fail(f'{name}: non-finite training loss: {losses}')
    if pre is None:
        want = {k: 0 for k in launches}
        cadence = [None] * S14_TIMED
    else:
        want, _, _ = launches_wanted(tr, S14_TIMED)
        cadence = ['full' if (warm + i) % freq == 0 else None
                   for i in range(S14_TIMED)]
    if launches != want:
        fail(f'{name}: kernel launches {launches}, expected {want}')
    if decomps != cadence:
        fail(f'{name}: decompositions {decomps}, expected {cadence}')
    if pre is not None and 'full' not in decomps:
        fail(f'{name}: no decomposition in the timed window')
    med = float(np.median(times))
    out = {'built_s': built_s, 'warm_steps': warm, 'step_ms': times,
           'losses': losses, 'decomps': decomps, 'launches': launches,
           'peak_mib': peak, 'held_before_mib': held / 2**20,
           'step_ms_median': med,
           'tokens_per_s': tr.tokens(batch) / med * 1e3,
           'k2_per_factor_step': launches['K2 stat_rows'] // S14_TIMED,
           'params': sum(p.numel() for p in tr.state.model.parameters()),
           'decomposition_ms': None, 'buckets': None}
    rows = []
    if pre is not None:
        out['decomposition_ms'] = s13_decomposition_ms(tr)
        out['buckets'] = list(pre.plan.bucket_dims)
        b = tr.to_device(next(batches))
        model = tr.state.model
        cases = captured_shapes(model, pre.plan.metas,
                                training.model_input(model, b['input']),
                                lambda o: tr.loss_fn(o, b))
        out['distinct_shapes'] = [list(c['x'].shape) for c in cases]
        rows = check_kernels(cases, name, dtypes=(torch.float32,))
        out['k2_ms'] = sum(r['ms'] * r['per_step'] for r in rows)
        if name in S14_LOCKSTEP:
            out['lockstep'] = check_lockstep(tr, label=name,
                                             steps=S14_LOCKSTEP_STEPS,
                                             batches=tr.batches())
    a = tr.args
    print(f'slice 14 {name} ({a.kfac_name if pre else "sgd"}, '
          f'kfac_update_freq {freq}): {out["params"] / 1e6:.1f} M '
          f'parameters, buckets {out["buckets"]}; {warm} warm + {S14_TIMED} '
          f'steps, losses {[round(x, 4) for x in losses]}, decompositions '
          f'{decomps}, step ms median {med:.1f} (first {times[0]:.1f}), '
          f'tokens/s {out["tokens_per_s"]:.0f}, decomposition '
          f'{out["decomposition_ms"]} ms, peak {peak:.0f} MiB over the '
          f'{held / 2**20:.0f} MiB held before the trainer, K2 '
          f'{out["k2_per_factor_step"]} a factor step'
          + (f', K2 against plain at {len(rows)} distinct shapes '
             f'{out["distinct_shapes"]}: {out["k2_ms"]:.3f} ms a factor step'
             if rows else '')
          + f'; trainer built in {built_s:.1f} s; {gpu_line()}', flush=True)
    del tr
    torch.cuda.empty_cache()
    return launches, rows, out


def run_slice14():
    """The slice-14 phase: the four runs of S14_NETS (:func:`s14_net`),
    the LSTMs on one corpus. Returns the launches by net, the per-shape
    rows and the numbers."""
    from kfac_pytorch_tpu_torch import train_wikitext
    t0 = time.perf_counter()
    launches, rows, out = {}, [], {}
    corpus = train_wikitext.load_corpus(train_wikitext.parse_args(
        S14_NETS['lstm_sgd'][1]))
    out['corpus_s'] = time.perf_counter() - t0
    for name in S14_NETS:
        t1 = time.perf_counter()
        launches[name], net_rows, out[name] = s14_net(
            name, corpus if name.startswith('lstm') else None)
        rows += net_rows
        out[name]['seconds'] = time.perf_counter() - t1
    out['seconds'] = time.perf_counter() - t0
    nets = {k: round(out[k]['seconds'], 1) for k in S14_NETS}
    print(f'slice 14 phase: {out["seconds"]:.1f} s (corpus '
          f'{out["corpus_s"]:.1f} s, nets {json.dumps(nets)})', flush=True)
    return launches, rows, out


# ---------------------------------------------------------------------------
# slice 15: the LM on a data x seq grid (ring and Ulysses attention over a
# process group) and the sequence trainers at world 2
# ---------------------------------------------------------------------------

#: the LM of slice 15: examples/longcontext_lm.py's defaults (4 layers, 8
#: heads, d_model 256, L 2048, global batch 4) with every kernel on
S15_LM = ['--kfac-capture-impl', 'pallas', '--attn-impl', 'pallas']
#: grid name -> (data devices, seq devices, seq impl, extra flags, steps)
S15_GRIDS = {
    'ring_1x2': (1, 2, 'ring', [], 6),
    'ulysses_1x2': (1, 2, 'ulysses', [], 6),
    'ring_1x2_bf16': (1, 2, 'ring', ['--kfac-name', 'eigen',
                                     '--kfac-comm-precision', 'bf16'], 3),
    'ring_2x2': (2, 2, 'ring', [], 6),
}
#: the (1, 2) ring's K-FAC step in lockstep with the world=1 LM, in steps
S15_LOCKSTEP_STEPS = 3
#: the sequence trainers at --num-devices 2, full width (S14_NETS' flags)
S15_SEQ_NETS = ('transformer_base', 'bert_base')
S15_SEQ_STEPS = 3
#: the attention blocks of the grids' main paths: (label, the grid run,
#: BH, Lq, Lk, D, starts, blocks of this kind a layer and step over all
#: ranks of the run). The (1, 2) ring's rank 0 runs its diagonal block and
#: the block of rank 1's keys, every tile of which the causal mask skips;
#: rank 1 its diagonal block and the full block of rank 0's keys. Each
#: block's kind (``block_kind``) is unique within its run, so the
#: wrappers' launches by kind are the launches of each block.
S15_BLOCKS = [
    ('ring 1x2 diagonal', 'ring_1x2', 32, 1024, 1024, 32, (0, 0), 2),
    ('ring 1x2 full', 'ring_1x2', 32, 1024, 1024, 32, (1024, 0), 1),
    ('ring 1x2 skipped', 'ring_1x2', 32, 1024, 1024, 32, (0, 1024), 1),
    ('ulysses 1x2', 'ulysses_1x2', 16, 2048, 2048, 32, (0, 0), 2),
    ('ring 2x2 diagonal', 'ring_2x2', 16, 1024, 1024, 32, (0, 0), 4),
    ('ring 2x2 full', 'ring_2x2', 16, 1024, 1024, 32, (1024, 0), 2),
    ('ring 2x2 skipped', 'ring_2x2', 16, 1024, 1024, 32, (0, 1024), 2),
]


def s15_lm(argv, group=None):
    """The LM trainer at S15_LM's flags plus ``argv``, in ``group``."""
    from kfac_pytorch_tpu_torch import train_lm
    args = train_lm.parse_args(['--device', DEVICE] + S15_LM + argv)
    return train_lm.Trainer(args, group=group, local_rank=0)


def s15_grid(name, group):
    """Grid ``name`` of S15_GRIDS for its steps: per step the loss, the
    host ms and this rank's replica digest; the rank's launches; the bytes
    of one step's sequence collectives by op."""
    from kfac_pytorch_tpu_torch import training
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    nd, ns, impl, extra, steps = S15_GRIDS[name]
    tr = s15_lm(['--dist-backend', 'gloo', '--data-devices', str(nd),
                 '--seq-devices', str(ns), '--seq-impl', impl] + extra,
                group)
    batches = tr.batches()
    reset_counts()
    times, losses, digests = [], [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        digests.append(training.replica_digest(tr.state.model))
    launches, kinds = read_counts(), read_kinds()
    with coll.ledger() as led:
        tr.train_step(next(batches))
    seq_bytes = {}
    for _, op, _, n in led:
        if op in ('ring_shift', 'all_to_all'):
            seq_bytes[op] = seq_bytes.get(op, 0) + n
    pre = tr.precond
    out = {'step_ms': times, 'losses': losses, 'digests': digests,
           'launches': launches, 'kinds': kinds, 'seq_bytes': seq_bytes,
           'n_layer': tr.args.n_layer, 'n_kfac': len(pre.plan.metas),
           'buckets': len(pre.plan.bucket_dims),
           'tokens': tr.tokens(batch), 'ns': ns}
    if name == 'ring_1x2':
        out['lockstep'] = s15_lockstep(tr)
    del tr
    release_memory()
    return out


def s15_lockstep(tr):
    """The grid's K-FAC step (every kernel) in lockstep with the same
    grid's plain path (``--attn-impl xla --kfac-capture-impl xla``) and a
    control (the plain path with its factor GEMMs summed in fp64), three
    fresh trainers in ``tr``'s group: before each step the plain ones take
    the kernel trainer's parameters (first ``tr``'s), all three step on
    the same global batch, and the
    kernels' preconditioned gradients are held to the plain path's. The
    reference is the grid, not world=1: the dense layers' G factor
    averages g over each rank's own tokens (``compute_g_dense``, as in
    JAX), another estimator than the whole sequence's. Before the first
    step the gradients the ranks average are held to the world=1 LM's
    (rank 0). Returns rank 0's gaps (None elsewhere)."""
    from kfac_pytorch_tpu_torch import data as kdata
    from kfac_pytorch_tpu_torch import train_lm
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    a = tr.args
    batches = list(kdata.sample_lm_batches(
        tr.train_ids, a.seq_len, a.batch_size, S15_LOCKSTEP_STEPS,
        np.random.RandomState(a.seed + 7)))
    grid = ['--dist-backend', 'gloo', '--seq-devices', str(a.seq_devices)]
    plain = grid + ['--attn-impl', 'xla', '--kfac-capture-impl', 'xla']
    kern, ref, ctl = (s15_lm(grid, tr.group), s15_lm(plain, tr.group),
                      s15_lm(plain, tr.group))
    # the gradients the ranks average, against world=1's
    batch = tr.to_device(batches[0])
    model = tr.state.model
    model.zero_grad(set_to_none=True)
    train_lm.loss_fn(model(batch['input']), batch).backward()
    avg = coll.average_grads({k: p.grad for k, p in
                              model.named_parameters()}, tr.group)
    raw = None
    if tr.rank == 0:
        one = s15_lm([])
        one.state.model.load_state_dict(model.state_dict())
        full = one.to_device(batches[0])
        dense = one.state.model
        train_lm.loss_fn(dense(full['input']), full).backward()
        raw = grad_gap(avg, {k: p.grad for k, p in dense.named_parameters()})
        del one
    gaps = []
    for batch in batches:
        src = dict(model.named_parameters())
        with torch.no_grad():
            for t in (kern, ref, ctl):
                for k, p in t.state.model.named_parameters():
                    p.copy_(src[k])
        kern.train_step(batch)
        ref.train_step(batch)
        with fp64_stat_gemm():
            ctl.train_step(batch)
        gaps.append({'kernels': grad_gap(kern.step_fn.last_grads,
                                         ref.step_fn.last_grads),
                     'control': grad_gap(ctl.step_fn.last_grads,
                                         ref.step_fn.last_grads)})
        model = kern.state.model
    del kern, ref, ctl
    return {'raw_vs_world1': raw, 'steps': gaps} if tr.rank == 0 else None


def s15_seq_net(name, group):
    """Sequence net ``name`` of S14_NETS through its trainer at
    ``--num-devices 2``: a warm step, then S15_SEQ_STEPS synchronized
    steps with their losses, host ms and replica digests, and the rank's
    launches."""
    import importlib
    from kfac_pytorch_tpu_torch import training
    module, argv = S14_NETS[name]
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{module}')
    args = mod.parse_args(['--device', DEVICE, '--num-devices', '2',
                           '--dist-backend', 'gloo'] + S14_COMMON + argv)
    tr = mod.Trainer(args, group=group, local_rank=0)
    batches = tr.batches()
    tr.train_step(next(batches))
    reset_counts()
    times, losses, digests = [], [], []
    for _ in range(S15_SEQ_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m['loss']))
        digests.append(training.replica_digest(tr.state.model))
    out = {'step_ms': times, 'losses': losses, 'digests': digests,
           'launches': read_counts(),
           'launches_wanted': launches_wanted(tr, S15_SEQ_STEPS)[0],
           'tokens': tr.tokens(batch)}
    del tr
    release_memory()
    return out


def release_memory():
    """Free what unreachable reference cycles hold (a trainer's hooks
    keep it in one, so ``del`` alone leaves its tensors to the cyclic
    collector), then return the cached blocks to the card: the ranks of
    slice 15 and the parent share it."""
    gc.collect()
    torch.cuda.empty_cache()


def s15_rank(rank, world, group, grids, nets):
    """One rank of slice 15 on cuda:0 (the ranks share the card over
    gloo): the LM grids ``grids`` (:func:`s15_grid`), then the sequence
    nets ``nets`` (:func:`s15_seq_net`). Returns numbers only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    out = {name: s15_grid(name, group) for name in grids}
    out.update({name: s15_seq_net(name, group) for name in nets})
    return out


def s15_want(name, out):
    """Launches one rank of grid ``name`` (its output ``out``) must make:
    per step a K2 for each K-FAC layer's A and G, a K4, K5a and K5b for
    each layer and block the rank runs (``ns`` ring blocks, one Ulysses
    block), a K3 a bucket over the bf16 wire."""
    steps = S15_GRIDS[name][4]
    blocks = 1 if name.startswith('ulysses') else out['ns']
    attn = out['n_layer'] * blocks * steps
    return {'K1 conv_a': 0, 'K2 stat_rows': 2 * out['n_kfac'] * steps,
            'K3 ef_quantize': (out['buckets'] * steps
                               if name.endswith('bf16') else 0),
            'K4 flash_fwd': attn, 'K5a flash_bwd_dq': attn,
            'K5b flash_bwd_dkv': attn}


def check_slice15(runs):
    """Every check of the grids and the sequence nets (``runs``: name ->
    the ranks' outputs)."""
    for name, ranks in runs.items():
        for r, out in enumerate(ranks):
            if not all(np.isfinite(out['losses'])):
                fail(f'slice 15 {name} rank {r}: non-finite loss '
                     f'{out["losses"]}')
            want = (s15_want(name, out) if name in S15_GRIDS
                    else out['launches_wanted'])
            if out['launches'] != want:
                fail(f'slice 15 {name} rank {r}: launches '
                     f'{out["launches"]}, expected {want}')
            if out['digests'] != ranks[0]['digests']:
                fail(f'slice 15 {name}: the ranks\' parameters differ')
            if out['losses'] != ranks[0]['losses']:
                fail(f'slice 15 {name}: the ranks report different losses')
    lock = runs['ring_1x2'][0]['lockstep']
    gap, k = lock['raw_vs_world1']
    if gap > GRAD_RTOL:
        fail(f'slice 15: the (1, 2) ring\'s averaged gradient {k} parts '
             f'from the world=1 LM\'s by {gap:.3e} of its largest entry')
    for i, g in enumerate(lock['steps']):
        (gap, k), (ctl, _) = g['kernels'], g['control']
        if gap > GRAD_RTOL and gap > TRAJ_FACTOR * ctl:
            fail(f'slice 15 lockstep step {i}: preconditioned grad {k} '
                 f'{gap:.3e} of its largest entry, over {GRAD_RTOL} and '
                 f'{TRAJ_FACTOR} x the control {ctl:.3e}')


def s15_block_launches(runs):
    """``{(grid run, block label): {kernel: launches}}``: the launches the
    wrappers counted by block kind over every rank of each grid's timed
    steps, held to the blocks S15_BLOCKS says each layer and step runs."""
    from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
    out = {}
    for label, run, bh, lq, lk, d, starts, per_layer in S15_BLOCKS:
        ranks = runs[run]
        kind = ak.block_kind(lq, lk, starts, True)
        want = per_layer * ranks[0]['n_layer'] * S15_GRIDS[run][4]
        got = {name: sum(o['kinds'][name].get(kind, 0) for o in ranks)
               for name in ATTN_KERNELS}
        if any(v != want for v in got.values()):
            fail(f'slice 15 {run}: {kind} blocks ({label}) launched '
                 f'{got}, expected {want} each')
        out[run, label] = got
    return out


def s15_block_rows(runs):
    """K4/K5a/K5b against their plain versions at every block of
    S15_BLOCKS (the skipped block's outputs exactly (-1e30, 0, 0) and
    zero gradients), bitwise over two runs, timed beside
    ``scaled_dot_product_attention`` where one computes the block (the
    diagonal block causal, the full one without a mask; nothing computes
    a block every key of which is masked) and the bound. Returns the
    rows of the kernels line, one a kernel and block, each with the
    launches counted at its block kind (:func:`s15_block_launches`)."""
    from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
    counted = s15_block_launches(runs)
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    kernels = []
    for label, run, bh, lq, lk, d, starts, per_layer in S15_BLOCKS:
        inputs = attn_inputs(bh, lq, lk, d, False, gen)
        n_layer = runs[run][0]['n_layer']
        rows = []
        for name, (kern, plain, outs) in attn_calls(*inputs, starts,
                                                    True).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            worst = 0.0
            for o, g, w in zip(outs, got, want):
                err, ok = close(g, w, ATTN_TOL[o], ATTN_TOL[o])
                worst = max(worst, err)
                if not ok or not bool(torch.isfinite(g).all()):
                    fail(f'{name} {o} at {label} {(bh, lq, lk, d)} starts '
                         f'{starts}: max |err| {err:.3e}')
            if label.endswith('skipped'):
                zero = {'m': ak.NEG_INF, 'l': 0.0, 'pv': 0.0, 'dq': 0.0,
                        'dk': 0.0, 'dv': 0.0}
                for o, g in zip(outs, got):
                    if not bool((g == zero[o]).all()):
                        fail(f'{name} {o} at the skipped block {label}: '
                             f'not exactly {zero[o]}')
            check_bitwise_repeat(f'{name} ({label})', kern, outs)
            bytes_ms, _, tc_ms = attn_bound(name, bh, lq, lk, d, starts,
                                            True)
            rows.append({'path': run, 'kernel': name, 'block': label,
                         'shape': [bh, lq, lk, d], 'starts': list(starts),
                         'per_step': per_layer * n_layer,
                         'ms': time_ms(kern),
                         'wrapper_ms': time_ms(kern, hide_host=False),
                         'plain_ms': time_ms(plain), 'bytes_ms': bytes_ms,
                         'ops_ms': tc_ms, 'bound_ms': max(bytes_ms, tc_ms),
                         'max_abs_err': worst})
        library = None
        if not label.endswith('skipped'):
            # [1, BH, L, D]: the heads of every sequence in one call
            library = library_attention_ms(*inputs[:3], bh,
                                           causal=starts == (0, 0))
        for r in rows:
            r['library_ms'] = (None if library is None else library[
                'fwd' if r['kernel'].startswith('K4') else 'bwd'])
            print(json.dumps(r), flush=True)
        kernels += kernel_summary(rows, {run: counted[run, label]},
                                  names=ATTN_KERNELS, suffix=f' ({label})')
    return kernels


def run_slice15():
    """The slice-15 phase: the (1, 2) grids and the sequence nets on two
    ranks, the (2, 2) grid on four, all on this one card over gloo
    (host-staged: NCCL refuses two ranks on one card), checked; then the
    attention kernels at the grids' blocks. Returns the kernels-line rows
    and the numbers."""
    from kfac_pytorch_tpu_torch import launch
    release_memory()
    print(f'slice 15: the parent holds '
          f'{torch.cuda.memory_allocated() / 2**20:.0f} MiB on the card',
          flush=True)
    t0 = time.perf_counter()
    pairs = launch.spawn(s15_rank, 2, backend='gloo', timeout=900,
                         args=(['ring_1x2', 'ulysses_1x2', 'ring_1x2_bf16'],
                               list(S15_SEQ_NETS)))
    quad = launch.spawn(s15_rank, 4, backend='gloo', timeout=600,
                        args=(['ring_2x2'], []))
    runs = {name: [o[name] for o in pairs] for name in pairs[0]}
    runs['ring_2x2'] = [o['ring_2x2'] for o in quad]
    check_slice15(runs)
    out = {'spawn_s': time.perf_counter() - t0}
    for name, ranks in runs.items():
        o = ranks[0]
        med = float(np.median(o['step_ms']))
        out[name] = {**{k: v for k, v in o.items() if k != 'digests'},
                     'step_ms_median': med,
                     'tokens_per_s': o['tokens'] / med * 1e3}
        print(f'slice 15 {name} ({len(ranks)} ranks on one card, gloo): '
              f'{len(o["step_ms"])} steps, losses '
              f'{[round(x, 4) for x in o["losses"]]}, step ms median '
              f'{med:.1f} (first {o["step_ms"][0]:.1f}), tokens/s '
              f'{out[name]["tokens_per_s"]:.0f}, launches a rank '
              f'{o["launches"]}'
              + (f', sequence collectives a step {o["seq_bytes"]} B'
                 if 'seq_bytes' in o else '')
              + ', replicas bitwise equal every step', flush=True)
    lock = runs['ring_1x2'][0]['lockstep']
    print(f'slice 15 ring 1x2: the averaged gradients against the world=1 '
          f'LM\'s, max rel err {lock["raw_vs_world1"][0]:.3e} '
          f'({lock["raw_vs_world1"][1]})', flush=True)
    for i, g in enumerate(lock['steps']):
        print(f'slice 15 lockstep (ring 1x2, kernels vs the plain path) '
              f'step {i}: preconditioned grads max rel err '
              f'{g["kernels"][0]:.3e} ({g["kernels"][1]}); control (fp64 '
              f'factor GEMMs) {g["control"][0]:.3e} ({g["control"][1]})',
              flush=True)
    kernels = s15_block_rows(runs)
    out['launches'] = {name: {k: sum(o['launches'][k] for o in ranks)
                              for k in ranks[0]['launches']}
                       for name, ranks in runs.items() if name in S15_GRIDS}
    out['seconds'] = time.perf_counter() - t0
    print(f'slice 15 phase: {out["seconds"]:.1f} s (spawned runs '
          f'{out["spawn_s"]:.1f} s); {gpu_line()}', flush=True)
    return kernels, out


def build_kernels():
    """Compile every ``csrc/*.cu`` at once (one nvcc each), then load."""
    from concurrent.futures import ThreadPoolExecutor
    from kfac_pytorch_tpu_torch.ops import _cuda_build
    names = ('capture', 'attention')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_cuda_build.build, [os.path.join(_cuda_build.CSRC,
                                                     f'{n}.cu')
                                        for n in names]))
    for n in names:
        _cuda_build.load(n)
    print(f'build: {", ".join(f"{n}.cu" for n in names)} in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)


# ---------------------------------------------------------------------------
# slice 17: observability (the run log, trace spans, the metrics registry,
# the phase timers, profiler ranges and summaries) in the trainers
# ---------------------------------------------------------------------------

S17_DIR = os.path.join(OUT_DIR, 'slice17')
#: the ImageNet trainer at full width (ResNet-50, bs32, 224 x 224, bf16,
#: the capture kernels), one epoch of 9 steps with a decomposition every
#: 4th, every observability flag on
S17_R50 = ['--device', 'cuda', '--kfac-capture-impl', 'pallas',
           '--synthetic-size', '288', '--epochs', '1', '--kfac-update-freq',
           '4']
S17_R50_STEPS = 9
#: the LM at full width with every kernel on, a few steps
S17_LM = ['--kfac-capture-impl', 'pallas', '--attn-impl', 'pallas',
          '--epochs', '1', '--steps-per-epoch', '4']
S17_LM_STEPS = 4
#: the device kernels of K1 and K2 (``kernel_group``'s names)
S17_CAPTURE = ('K1 conv_a_kernel', 'K1 split_reduce_kernel',
               'K2 stat_tall_kernel', 'K2 stat_wide_kernel')
#: ResNet-32 steps a round of the observability cost takes a setting
S17_COST_STEPS = 10
S17_COST_ROUNDS = 5


class _Recorded:
    """A trainer's step function that records ``last_phases`` after each
    call (every other attribute is the step function's)."""

    def __init__(self, fn, seen):
        self._fn, self._seen = fn, seen

    def __call__(self, *args, **kw):
        out = self._fn(*args, **kw)
        self._seen.append(tuple(self._fn.last_phases))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


@contextlib.contextmanager
def recording_phases():
    """Each step function the trainers build inside records its steps'
    phases into the yielded list."""
    from kfac_pytorch_tpu_torch import training
    seen = []
    build = training.build_train_step

    def recorded(*args, **kw):
        return _Recorded(build(*args, **kw), seen)
    training.build_train_step = recorded
    try:
        yield seen
    finally:
        training.build_train_step = build


def obs_flags(d):
    """Every observability flag, writing under ``d``."""
    return ['--log-dir', os.path.join(d, 'logs'),
            '--trace', os.path.join(d, 'trace'),
            '--prom-file', os.path.join(d, 'metrics.prom'),
            '--tb-dir', os.path.join(d, 'tb')]


def epoch_line(d, label):
    """The run log's one file under ``d`` and its epoch line."""
    import glob
    logs = glob.glob(os.path.join(d, 'logs', '*.log'))
    if len(logs) != 1:
        fail(f'slice 17 {label}: run logs {logs}, expected one')
    lines = [ln for ln in open(logs[0]).read().splitlines()
             if ' epoch 0: ' in ln]
    if len(lines) != 1:
        fail(f'slice 17 {label}: {len(lines)} epoch lines in {logs[0]}')
    return lines[0]


def phase_ms(line):
    """The ``kfac_phase_ms=`` suffix of an epoch line as a dict."""
    import re
    m = re.search(r' kfac_phase_ms=(\S+)', line)
    if m is None:
        return {}
    return {k: float(v) for k, v in
            (kv.rsplit(':', 1) for kv in m.group(1).split(','))}


def trace_spans(d, name):
    events = [json.loads(ln) for ln in
              open(os.path.join(d, 'trace', 'trace-host0.jsonl'))]
    return [e for e in events if e['name'] == name]


def check_spans(d, name, seen, label):
    """One ``name`` span a step, its phases the step's ``last_phases``."""
    from kfac_pytorch_tpu_torch.obs.trace import taxonomy_phases
    got = [e['args']['phases'] for e in trace_spans(d, name)]
    want = [taxonomy_phases(p) for p in seen]
    if got != want:
        fail(f'slice 17 {label}: {name} spans carry phases {got}, the '
             f'steps ran {want}')


def prometheus(path):
    """``{sample: value}`` of a Prometheus textfile."""
    out = {}
    for line in open(path).read().splitlines():
        if not line.startswith('#'):
            name, value = line.rsplit(' ', 1)
            out[name] = float(value)
    return out


def tensorboard_records(d):
    """The records of the one event file under ``d``; fails unless every
    length and payload passes its crc32c."""
    import struct
    from kfac_pytorch_tpu_torch.utils import summary
    names = os.listdir(d)
    if len(names) != 1:
        fail(f'slice 17: TensorBoard files {names}, expected one')
    data = open(os.path.join(d, names[0]), 'rb').read()
    i = n = 0
    while i < len(data):
        (ln,) = struct.unpack('<Q', data[i:i + 8])
        (crc_len,) = struct.unpack('<I', data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + ln]
        (crc,) = struct.unpack('<I', data[i + 12 + ln:i + 16 + ln])
        if (crc_len != summary._masked_crc(data[i:i + 8])
                or crc != summary._masked_crc(payload)):
            fail(f'slice 17: TensorBoard record {n} fails its crc32c')
        i += 16 + ln
        n += 1
    return n


def s17_resnet50():
    """``train_imagenet.main`` at full width with every observability flag:
    the checks of the slice-17 phase on the ImageNet path. Returns the
    trainer, its launches and the numbers."""
    from kfac_pytorch_tpu_torch import train_imagenet
    d = os.path.join(S17_DIR, 'resnet50')
    shutil.rmtree(d, ignore_errors=True)
    argv = S17_R50 + obs_flags(d) + ['--checkpoint-format',
                                     os.path.join(d, 'ckpt')]
    t0 = time.perf_counter()
    with recording_phases() as seen:
        reset_counts()
        tr = train_imagenet.main(argv)
        launches = read_counts()
    seconds = time.perf_counter() - t0
    label = 'resnet50'
    if tr.state.step != S17_R50_STEPS or len(seen) != S17_R50_STEPS:
        fail(f'slice 17 {label}: {tr.state.step} steps ({len(seen)} '
             f'recorded), expected {S17_R50_STEPS}')
    if not (launches['K1 conv_a'] and launches['K2 stat_rows']):
        fail(f'slice 17 {label}: K1/K2 not launched: {launches}')
    decomps = [i for i, p in enumerate(seen) if 'decomp' in p]
    if decomps != list(range(0, S17_R50_STEPS, 4)):
        fail(f'slice 17 {label}: decompositions on steps {decomps}')
    line = epoch_line(d, label)
    phases = phase_ms(line)
    marginal = [k for k in phases if 'decomp' in k]
    if not (marginal and {'step_mean', 'step_max'} <= set(phases)):
        fail(f'slice 17 {label}: the epoch line has no decomposition '
             f'marginal with step_mean/step_max: {line}')
    check_spans(d, 'kfac.step', seen, label)
    check_spans(d, 'kfac.dispatch', seen, label)
    prom = prometheus(os.path.join(d, 'metrics.prom'))
    rows = [json.loads(ln) for ln in
            open(os.path.join(d, 'trace', 'metrics.jsonl'))]
    counts = (prom.get('kfac_step_seconds_count'),
              rows[-1]['metrics']['step_seconds']['count'])
    if counts != (S17_R50_STEPS, S17_R50_STEPS):
        fail(f'slice 17 {label}: step_seconds counts {counts} (textfile, '
             f'JSONL), expected {S17_R50_STEPS}')
    records = tensorboard_records(os.path.join(d, 'tb'))
    shutil.rmtree(os.path.join(d, 'ckpt'), ignore_errors=True)
    out = {'seconds': seconds, 'epoch_line': line, 'kfac_phase_ms': phases,
           'decomposition_marginal': {k: phases[k] for k in marginal},
           'phases': [list(p) for p in seen], 'launches': launches,
           'tensorboard_records': records}
    print(f'slice 17 resnet50 (train_imagenet.main, bs32 224 bf16, '
          f'{S17_R50_STEPS} steps, --kfac-update-freq 4, every flag): '
          f'{seconds:.1f} s, kfac_phase_ms {json.dumps(phases)}, launches '
          f'{launches}, {records} TensorBoard records', flush=True)
    return tr, launches, out


def s17_lm():
    """``train_lm.main`` at full width with K4/K5 and ``--trace``: one
    ``kfac.dispatch`` span a step with its phases, and the registry's
    suffixes on the epoch line."""
    from kfac_pytorch_tpu_torch import train_lm
    d = os.path.join(S17_DIR, 'lm')
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    with recording_phases() as seen:
        reset_counts()
        tr = train_lm.main(S17_LM + obs_flags(d))
        launches = read_counts()
    seconds = time.perf_counter() - t0
    label = 'transformer_lm'
    if tr.state.step != S17_LM_STEPS or len(seen) != S17_LM_STEPS:
        fail(f'slice 17 {label}: {tr.state.step} steps, expected '
             f'{S17_LM_STEPS}')
    missing = [k for k in ('K2 stat_rows', 'K4 flash_fwd',
                           'K5a flash_bwd_dq', 'K5b flash_bwd_dkv')
               if not launches[k]]
    if missing:
        fail(f'slice 17 {label}: {missing} not launched: {launches}')
    check_spans(d, 'kfac.dispatch', seen, label)
    line = epoch_line(d, label)
    # the registry renders the suffixes: '' for a clean epoch, and the
    # line ends right after its time
    from kfac_pytorch_tpu_torch import obs
    reg = obs.metrics.Registry(process_id=0)
    reg.counter('health/skipped')
    if not line.endswith('s)' + reg.epoch_suffixes()):
        fail(f'slice 17 {label}: epoch line {line!r}')
    prom = prometheus(os.path.join(d, 'metrics.prom'))
    if prom.get('kfac_health_skipped') != 0:
        fail(f'slice 17 {label}: the registry export {prom}')
    print(f'slice 17 transformer_lm (train_lm.main, K4/K5, {S17_LM_STEPS} '
          f'steps, every flag): {seconds:.1f} s, launches {launches}',
          flush=True)
    return tr, launches, {'seconds': seconds, 'epoch_line': line,
                          'phases': [list(p) for p in seen],
                          'launches': launches}


def range_profile(step, label):
    """One ``step()`` under ``torch.profiler`` (host and device): the device
    ms under each ``kfac.*`` range and its share of the step's device time
    (``utils.profiling.range_device_ms``). Fails unless every K1 and K2
    device kernel lies inside a ``kfac.ComputeFactor`` range."""
    from torch.profiler import ProfilerActivity, profile

    from kfac_pytorch_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    path = os.path.join(S17_DIR, f'profile_{label.replace(" ", "_")}.json')
    prof.export_chrome_trace(path)
    ranges, total, kernels = profiling.range_device_ms(path)
    os.remove(path)
    outside = [(n, r) for n, _, r in kernels
               if kernel_group(n) in S17_CAPTURE
               and 'kfac.ComputeFactor' not in r]
    n_capture = sum(kernel_group(n) in S17_CAPTURE for n, _, _ in kernels)
    if DEVICE == 'cuda' and not n_capture:
        fail(f'slice 17 profile ({label}): the trace holds no K1/K2 device '
             f'kernel ({len(kernels)} device events, {total:.3f} ms)')
    if outside:
        fail(f'slice 17 profile ({label}): {len(outside)} of {n_capture} '
             f'K1/K2 device kernels outside kfac.ComputeFactor, e.g. '
             f'{outside[:3]}')
    out = {'device_ms': total, 'ranges_ms': ranges,
           'share': {k: v / total for k, v in ranges.items()} if total
           else {}, 'capture_kernels': n_capture}
    body = ', '.join(f'{k} {v:.3f} ms ({100 * out["share"][k]:.1f}%)'
                     for k, v in sorted(ranges.items(), key=lambda kv:
                                        -kv[1]))
    print(f'slice 17 profile ({label}): device {total:.3f} ms, {body}; '
          f'{n_capture} K1/K2 kernels, all in kfac.ComputeFactor',
          flush=True)
    return out


def trainer_step(tr, batch):
    """One step of trainer ``tr`` on a host batch, the loss read."""
    def step():
        float(tr.train_step(batch)['loss'])
    return step


def s17_profiles(r50, lm):
    """The step split by ``kfac.*`` range on the card: ResNet-32 (CIFAR's
    main path, ``eigen_dp``) at a decomposition step and a plain one, the
    ResNet-50 ``r50`` at a plain step, the LM ``lm`` at a plain step and a
    decomposition step."""
    out = {}
    tr = make_trainer('auto')
    batches = iter(tr.train_loader.epoch())
    freq = tr.precond.kfac_update_freq
    for _ in range(freq):     # warm: the next step decomposes
        tr.train_step(next(batches))
    for name in ('decomposition', 'plain'):
        out[f'resnet32 {name}'] = range_profile(
            trainer_step(tr, next(batches)), f'resnet32 {name} step')
        out[f'resnet32 {name}']['phases'] = list(tr.step_fn.last_phases)
    del tr
    release_memory()
    batch = next(iter(r50.train_loader.epoch()))
    while r50.state.step % r50.precond.kfac_update_freq == 0:
        r50.train_step(batch)
    out['resnet50 plain'] = range_profile(trainer_step(r50, batch),
                                          'resnet50 plain step')
    out['resnet50 plain']['phases'] = list(r50.step_fn.last_phases)
    def lm_batches():
        while True:
            yield from lm.batches()
    batches = lm_batches()
    freq = lm.precond.kfac_update_freq
    out['transformer_lm plain'] = range_profile(
        trainer_step(lm, next(batches)), 'transformer_lm plain step')
    out['transformer_lm plain']['phases'] = list(lm.step_fn.last_phases)
    while lm.state.step % freq:
        lm.train_step(next(batches))
    out['transformer_lm decomposition'] = range_profile(
        trainer_step(lm, next(batches)), 'transformer_lm decomposition step')
    out['transformer_lm decomposition']['phases'] = list(
        lm.step_fn.last_phases)
    for key, prof in out.items():
        want = 'decomp' in key.split()[1]
        if ('decomp' in prof['phases']) != want:
            fail(f'slice 17 profile ({key}): the step ran {prof["phases"]}')
    return out


def s17_obs_cost():
    """The host cost of the observability on ResNet-32's step: the median
    step ms with no profiler ranges and no tracer or registry ('bare'),
    with the ranges ('ranges': the default), and with the ranges, the
    trace spans, the phase timers, the health monitor's registry and the
    step histogram ('obs': ``--trace``/``--prom-file`` on). Rounds of
    bare, ranges, obs, obs, ranges, bare, each S17_COST_STEPS steps
    starting at the same step of the decomposition cycle."""
    from kfac_pytorch_tpu_torch import obs, preconditioner, utils
    d = os.path.join(S17_DIR, 'cost')
    shutil.rmtree(d, ignore_errors=True)
    tracer, reg = obs.setup_trainer(trace_dir=os.path.join(d, 'trace'),
                                    prom_file=os.path.join(d, 'm.prom'))
    on = make_trainer('auto')
    on.tracer = tracer
    on.step_fn.set_tracer(tracer)
    off = make_trainer('auto')
    timers = utils.PhaseTimers(tracer=tracer, registry=reg, histogram=True)
    monitor = utils.HealthMonitor(state=on.state, registry=reg)
    batches = take_batches(on.train_loader, S17_COST_STEPS)
    ranges = preconditioner._range
    times = {'bare': [], 'ranges': [], 'obs': []}

    def window(name):
        tr = on if name == 'obs' else off
        preconditioner._range = (contextlib.nullcontext if name == 'bare'
                                 else ranges)
        try:
            for b in batches:
                t0 = time.perf_counter()
                m = tr.train_step(b)
                float(m['loss'])
                if name == 'obs':
                    timers.record(tr.step_fn.last_phases,
                                  time.perf_counter() - t0)
                    monitor.update(m, step=tr.state.step - 1)
                times[name].append((time.perf_counter() - t0) * 1e3)
        finally:
            preconditioner._range = ranges
    for tr in (on, off):     # warm, and at a multiple of the cadence
        for b in batches:
            tr.train_step(b)
    for _ in range(S17_COST_ROUNDS):
        for name in ('bare', 'ranges', 'obs', 'obs', 'ranges', 'bare'):
            window(name)
    reg.epoch_suffixes()
    reg.export(step=0)
    tracer.flush()
    reg.close()
    obs.trace.uninstall()
    out = {k: float(np.median(v)) for k, v in times.items()}
    out['steps_each'] = len(times['obs'])
    print(f'slice 17 observability cost (resnet32 bs128 eigen_dp, median '
          f'step ms over {out["steps_each"]} steps each, interleaved): '
          f'bare {out["bare"]:.3f}, ranges {out["ranges"]:.3f}, obs '
          f'{out["obs"]:.3f}', flush=True)
    del on, off
    release_memory()
    return out


def run_slice17():
    """The slice-17 phase: the ImageNet and LM trainers' main paths with
    every observability flag (:func:`s17_resnet50`, :func:`s17_lm`), the
    step split by profiler range (:func:`s17_profiles`) and the
    observability's host cost (:func:`s17_obs_cost`). Returns the
    launches by path and the numbers."""
    t0 = time.perf_counter()
    out = {}
    r50, r50_launches, out['resnet50'] = s17_resnet50()
    lm, lm_launches, out['transformer_lm'] = s17_lm()
    out['profiles'] = s17_profiles(r50, lm)
    del r50, lm
    release_memory()
    out['obs_cost'] = s17_obs_cost()
    out['seconds'] = time.perf_counter() - t0
    print(f'slice 17 phase: {out["seconds"]:.1f} s', flush=True)
    return {'resnet50_slice17': r50_launches,
            'transformer_lm_slice17': lm_launches}, out


# ---------------------------------------------------------------------------
# slice 18: the control loop (the knob arbiter, the online tuner, the perf
# model on this card's constants and the drift gate)
# ---------------------------------------------------------------------------

S18_DIR = os.path.join(OUT_DIR, 'slice18')
#: ResNet-32 with the tuner and both rungs explicit (the tuner probes a
#: rung only when it is set), long enough that the capture rung is probed
#: after up to three commits (each dwells two windows): 20 epochs of the
#: synthetic set's 16 steps
S18_R32 = ['--device', 'cuda', '--kfac-autotune', '--kfac-capture-impl',
           'pallas', '--kfac-decomp-impl', 'xla', '--epochs', '20']
#: the LM with the tuner, every kernel on, 3 windows (16 steps a window, 2
#: settling)
S18_LM = ['--kfac-capture-impl', 'pallas', '--attn-impl', 'pallas',
          '--kfac-autotune', '--epochs', '1', '--steps-per-epoch', '56']
#: ResNet-50 bs32 (the perf model's workload: the drift-gated tuner), one
#: epoch of 56 steps for at least two judged windows; the prior seeds
#: kfac_update_freq near the ladder's top, so few steps decompose
S18_R50 = ['--device', 'cuda', '--model', 'resnet50', '--batch-size', '32',
           '--kfac-autotune', '--kfac-capture-impl', 'pallas',
           '--kfac-update-freq', '8', '--synthetic-size', '1792',
           '--epochs', '1']
#: the least windows a run's tuner must judge
S18_WINDOWS = {'resnet32': 4, 'transformer_lm': 3, 'resnet50': 2}


class _Tracked:
    """A trainer's step function that records, after each call, the
    phases, the capture rung in force, the kernels' launches the call
    made and a CUDA event at its end (every other attribute is the step
    function's)."""

    def __init__(self, fn, seen):
        self._fn, self._seen = fn, seen

    def __call__(self, state, *args, **kw):
        before = read_counts()
        out = self._fn(state, *args, **kw)
        after = read_counts()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pre = self._fn.precond
        self._seen.append({
            'step': state.step, 'phases': tuple(self._fn.last_phases),
            'capture_impl': None if pre is None else pre.capture_impl,
            'launches': {k: after[k] - before[k] for k in after},
            'event': ev})
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


@contextlib.contextmanager
def tracking_steps():
    """Each step function the trainers build inside is a :class:`_Tracked`
    feeding the yielded list (and knows its preconditioner)."""
    from kfac_pytorch_tpu_torch import training
    seen = []
    build = training.build_train_step

    def tracked(model, tx, precond, *args, **kw):
        fn = build(model, tx, precond, *args, **kw)
        fn.precond = precond
        return _Tracked(fn, seen)
    training.build_train_step = tracked
    try:
        yield seen
    finally:
        training.build_train_step = build


def s18_constants():
    """``perfmodel.measure_chip`` on this card beside the committed H100
    constants, with their ratios, and the eigh fit's prediction at
    ResNet-50's widest bucket beside the measured time."""
    from kfac_pytorch_tpu_torch import perfmodel
    t0 = time.perf_counter()
    got = perfmodel.measure_chip()
    want = perfmodel.H100
    pairs = {'peak_bf16': (got['peak_bf16'], want.peak_bf16),
             'fp32_rate': (got['fp32_rate'],
                           want.peak_bf16 / want.f32_penalty),
             'f32_penalty': (got['f32_penalty'], want.f32_penalty),
             'hbm_bw': (got['hbm_bw'], want.hbm_bw),
             'attn_seconds': (got['attn_note']['seconds'],
                              want.attn_note['seconds'])}
    for (b, d, s), (_, _, c) in zip(got['fenced_eigh_points'],
                                    want.fenced_eigh_points):
        pairs[f'eigh_{b}x{d}_s'] = (s, c)
    rows = {k: {'measured': m, 'committed': c, 'ratio': m / c}
            for k, (m, c) in pairs.items()}
    bad = [k for k, r in rows.items() if not np.isfinite(r['ratio'])
           or r['ratio'] <= 0]
    if bad:
        fail(f'slice 18 perf model constants: {bad} not measured: {rows}')
    _, _, fit = perfmodel.eigh_time_model()
    check = dict(got['eigh_check'], committed_fit_s=fit(
        got['eigh_check']['rows'], got['eigh_check']['dim']))
    seconds = time.perf_counter() - t0
    print(f'slice 18 perf model constants (measured, committed, ratio; '
          f'{got["card"]}, {got["date"]}): ' + ', '.join(
              f'{k} {r["measured"]:.6g} {r["committed"]:.6g} '
              f'{r["ratio"]:.3f}' for k, r in rows.items()), flush=True)
    print(f'slice 18 eigh at ResNet-50\'s bucket [{check["rows"]}, '
          f'{check["dim"]}]: measured {check["measured_s"] * 1e3:.1f} ms, '
          f'the two-point fit predicts {check["committed_fit_s"] * 1e3:.1f} '
          f'ms (this run\'s points: {check["fit_s"] * 1e3:.1f} ms); '
          f'{seconds:.1f} s', flush=True)
    return {'measured': got, 'rows': rows, 'eigh_4608': check,
            'seconds': seconds}


def tuner_consistent(tr, d, label):
    """The tuner's decision log against its decisions, the
    preconditioner's final knobs and ``adopted-knobs.json``; returns the
    decisions."""
    from kfac_pytorch_tpu_torch import autotune
    tuner = tr.tuner
    path = os.path.join(d, 'trace', 'autotune-decisions.jsonl')
    logged = ([json.loads(ln) for ln in open(path)]
              if os.path.exists(path) else [])
    if logged != list(tuner.decisions):
        fail(f'slice 18 {label}: the decision log {logged} is not the '
             f'tuner\'s decisions {list(tuner.decisions)}')
    knobs = autotune._capture(tr.precond)
    last = {}
    for dec in logged:
        if dec['kind'] in ('seed', 'commit', 'revert'):
            last[dec['knob']] = dec['to']
    wrong = {k: (v, knobs[k]) for k, v in last.items() if knobs[k] != v}
    if tuner.state == 'probe':
        # a probe still in flight holds its candidate
        knob, _, new = tuner._candidate
        wrong.pop(knob, None)
        if knobs[knob] != new:
            wrong[knob] = (new, knobs[knob])
    if wrong:
        fail(f'slice 18 {label}: decisions against the final knobs '
             f'(decided, in force): {wrong}')
    adopted_path = os.path.join(d, 'trace', autotune.ADOPTED_KNOBS_FILENAME)
    if last:
        adopted = json.load(open(adopted_path))
        moved = {autotune.ADOPTED_KNOB_FLAGS[k]: v for k, v in last.items()}
        if {k: adopted.get(k) for k in moved} != moved:
            fail(f'slice 18 {label}: adopted-knobs.json {adopted} against '
                 f'the last decisions {moved}')
    return logged


def epoch_lines(d, label):
    """Every epoch line of the run log's one file under ``d``."""
    import glob
    logs = glob.glob(os.path.join(d, 'logs', '*.log'))
    if len(logs) != 1:
        fail(f'slice 18 {label}: run logs {logs}, expected one')
    lines = [ln for ln in open(logs[0]).read().splitlines()
             if re.search(r' epoch \d+: ', ln)]
    if not lines:
        fail(f'slice 18 {label}: no epoch line in {logs[0]}')
    return lines


def tick_timing(tr, seen, lines, label):
    """The tuner's intervals beside the device's: the seconds it recorded
    (a step's host inter-arrival, the loss read included), the CUDA-event
    interval between consecutive step ends, and the phase timers'
    ``step_mean`` (the epochs' mean, when the epoch lines have one). A
    loop that blocks once a step gives intervals no shorter than the
    device's."""
    torch.cuda.synchronize()
    events = [s['event'] for s in seen]
    dev = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    ticks = tr.tuner.recorded
    out = {'tick_mean_s': float(np.mean(ticks)) if ticks else None,
           'tick_median_s': float(np.median(ticks)) if ticks else None,
           'device_interval_mean_s': float(np.mean(dev)),
           'device_interval_median_s': float(np.median(dev)),
           'step_mean_s': None}
    means = [phase_ms(ln)['step_mean'] for ln in lines
             if 'step_mean' in phase_ms(ln)]
    if means:
        out['step_mean_s'] = float(np.mean(means)) / 1e3
    if not ticks or out['tick_mean_s'] < 0.9 * out['device_interval_mean_s']:
        fail(f'slice 18 {label}: the tuner\'s intervals are shorter than '
             f'the device\'s: {out}')
    return out


def s18_tuned(module, argv, label, d, launches_per_step=None):
    """``module.main(argv)`` with the tuner, ``--trace`` and ``--log-dir``
    under ``d``, every step tracked (:func:`tracking_steps`) and the
    tuner's recorded intervals kept. Returns the trainer, the tracked
    steps, the epoch line, the launches and the numbers."""
    import importlib

    from kfac_pytorch_tpu_torch import autotune
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{module}')
    shutil.rmtree(d, ignore_errors=True)
    argv = argv + ['--trace', os.path.join(d, 'trace'), '--log-dir',
                   os.path.join(d, 'logs')]
    if module == 'train_imagenet':
        argv += ['--checkpoint-format', os.path.join(d, 'ckpt')]
    record = autotune.KnobController.record

    def recording(self, phases, seconds, step=None):
        self.__dict__.setdefault('recorded', []).append(seconds)
        return record(self, phases, seconds, step=step)
    autotune.KnobController.record = recording
    t0 = time.perf_counter()
    try:
        with tracking_steps() as seen:
            reset_counts()
            tr = mod.main(argv)
            launches = read_counts()
    finally:
        autotune.KnobController.record = record
    seconds = time.perf_counter() - t0
    shutil.rmtree(os.path.join(d, 'ckpt'), ignore_errors=True)
    tuner = tr.tuner
    if tuner is None or tuner.windows < S18_WINDOWS[label]:
        fail(f'slice 18 {label}: {0 if tuner is None else tuner.windows} '
             f'windows judged, expected {S18_WINDOWS[label]}')
    tuner.__dict__.setdefault('recorded', [])
    lines = epoch_lines(d, label)
    decisions = tuner_consistent(tr, d, label)
    # the tuner's counters on the epoch lines (each an epoch's deltas)
    counts = {}
    for ln in lines:
        for k, v in re.findall(r'(autotune_\w+)=(\d+)', ln):
            counts[k] = counts.get(k, 0) + int(v)
    want = {k: v for k, v in tuner.counts().items() if v}
    if counts != want:
        fail(f'slice 18 {label}: the epoch lines count {counts}, the tuner '
             f'{want}: {lines}')
    timing = tick_timing(tr, seen, lines, label)
    return tr, seen, lines, launches, {
        'seconds': seconds, 'windows': tuner.windows, 'state': tuner.state,
        'decisions': decisions, 'counts': tuner.counts(),
        'knobs': autotune._capture(tr.precond), 'launches': launches,
        'timing': timing, 'epoch_lines': lines}


def s18_resnet32():
    """ResNet-32 with the tuner: K1/K2 on every factor step of the
    'pallas' rung and never on the 'xla' rung, which the tuner must
    have probed."""
    label = 'resnet32'
    tr, seen, _, launches, out = s18_tuned(
        'train_cifar', S18_R32, label, os.path.join(S18_DIR, label))
    per, _, _ = launches_wanted(tr, 1)
    rungs, bad = {}, []
    for s in seen:
        got = {k: s['launches'][k] for k in ('K1 conv_a', 'K2 stat_rows')}
        if s['capture_impl'] == 'xla' or 'stats' not in s['phases']:
            want = {k: 0 for k in got}
        else:
            want = {k: per[k] for k in got}
        rungs[s['capture_impl']] = rungs.get(s['capture_impl'], 0) + 1
        if got != want:
            bad.append((s['step'], s['capture_impl'], s['phases'], got))
    if bad:
        fail(f'slice 18 {label}: K1/K2 launches against the capture rung '
             f'(step, rung, phases, launches): {bad[:5]}')
    if not rungs.get('xla') or not rungs.get('pallas'):
        fail(f'slice 18 {label}: steps by capture rung {rungs}: the tuner '
             f'never probed the plain path; decisions {out["decisions"]}')
    out['steps_by_capture_rung'] = rungs
    print(f'slice 18 {label} (train_cifar.main --kfac-autotune, capture '
          f'pallas, decomposition xla): {len(seen)} steps, '
          f'{out["windows"]} windows ({out["state"]}), steps by capture '
          f'rung {rungs}, K1/K2 on the pallas rung only, counts '
          f'{out["counts"]}, knobs {out["knobs"]}, intervals '
          f'{json.dumps(out["timing"])}, {out["seconds"]:.1f} s; decisions '
          f'{json.dumps(out["decisions"])}', flush=True)
    return tr, launches, out


def s18_lm():
    """The LM with the tuner for 3 windows: K4/K5 launched."""
    label = 'transformer_lm'
    tr, seen, _, launches, out = s18_tuned(
        'train_lm', S18_LM, label, os.path.join(S18_DIR, 'lm'))
    missing = [k for k in ('K2 stat_rows', 'K4 flash_fwd',
                           'K5a flash_bwd_dq', 'K5b flash_bwd_dkv')
               if not launches[k]]
    if missing:
        fail(f'slice 18 {label}: {missing} not launched: {launches}')
    print(f'slice 18 {label} (train_lm.main --kfac-autotune): {len(seen)} '
          f'steps, {out["windows"]} windows ({out["state"]}), launches '
          f'{launches}, counts {out["counts"]}, knobs {out["knobs"]}, '
          f'intervals {json.dumps(out["timing"])}, {out["seconds"]:.1f} s; '
          f'decisions {json.dumps(out["decisions"])}', flush=True)
    return tr, launches, out


def drift_verdicts(measured_s, tr, label, source):
    """``obs.drift.drift_block`` of ``measured_s`` (ledger-taxonomy
    seconds) against the perf model on this card, printed phase by
    phase."""
    from kfac_pytorch_tpu_torch import autotune, perfmodel
    from kfac_pytorch_tpu_torch.obs import drift
    pre = tr.precond
    block = drift.drift_block(
        {k: v for k, v in measured_s.items()
         if k not in ('step_mean', 'step_max')},
        perfmodel.predict_block(),
        platform=autotune.device_platform(pre.device), variant=pre.variant,
        comm_precision=pre.comm_precision, decomp_impl=pre.decomp_impl,
        capture_impl=pre.capture_impl, source=source)
    if 'error' in block or not block['comparable']:
        fail(f'slice 18 {label} drift ({source}): {block}')
    print(f'slice 18 {label} drift ({source}): verdict '
          f'{block["gate"]["verdict"]}; ' + '; '.join(
              f'{name} measured {e["measured_s"]} s, band {e.get("band_s")}'
              f' s, within {e["within_band"]}'
              for name, e in block['phases'].items()), flush=True)
    return block


def s18_resnet50(slice17_phase_ms):
    """ResNet-50 bs32 with the tuner, drift-gated (this card is the
    modeled one): at least two judged windows, K1/K2 launched, the drift
    verdicts of the tuner's last window, of this run's phase timers and
    of slice 17's (``slice17_phase_ms``, its epoch line's marginals)."""
    from kfac_pytorch_tpu_torch.obs import drift
    label = 'resnet50'
    tr, seen, lines, launches, out = s18_tuned(
        'train_imagenet', S18_R50, label, os.path.join(S18_DIR, label))
    line = lines[0]
    if tr.tuner.predicted is None or tr.tuner.platform != \
            torch.cuda.get_device_name(0):
        fail(f'slice 18 {label}: the tuner is not drift-gated on this card '
             f'(platform {tr.tuner.platform})')
    if not (launches['K1 conv_a'] and launches['K2 stat_rows']):
        fail(f'slice 18 {label}: K1/K2 not launched: {launches}')
    out['drift'] = {
        'last_window': drift_verdicts(tr.tuner.last_window['measured'], tr,
                                      label, 'the tuner\'s last window'),
        'phase_timers': drift_verdicts(
            drift.measured_from_phase_timers(phase_ms(line)), tr, label,
            'this run\'s phase timers'),
        'slice17_phase_timers': drift_verdicts(
            drift.measured_from_phase_timers(slice17_phase_ms), tr, label,
            'slice 17\'s phase timers (--kfac-update-freq 4)')}
    print(f'slice 18 {label} (train_imagenet.main --kfac-autotune, bs32 '
          f'224 bf16, drift-gated): {len(seen)} steps, {out["windows"]} '
          f'windows ({out["state"]}), launches {launches}, counts '
          f'{out["counts"]}, knobs {out["knobs"]}, kfac_phase_ms '
          f'{json.dumps(phase_ms(line))}, intervals '
          f'{json.dumps(out["timing"])}, {out["seconds"]:.1f} s; decisions '
          f'{json.dumps(out["decisions"])}', flush=True)
    return tr, launches, out


def run_slice18(slice17_phase_ms):
    """The slice-18 phase: the perf model's constants (:func:`s18_constants`),
    then ResNet-32, the LM and ResNet-50 through their trainers with the
    tuner (:func:`s18_resnet32`, :func:`s18_lm`, :func:`s18_resnet50`).
    Returns the launches by path and the numbers."""
    t0 = time.perf_counter()
    out = {'constants': s18_constants()}
    r32, r32_launches, out['resnet32'] = s18_resnet32()
    del r32
    release_memory()
    lm, lm_launches, out['transformer_lm'] = s18_lm()
    del lm
    release_memory()
    r50, r50_launches, out['resnet50'] = s18_resnet50(slice17_phase_ms)
    del r50
    release_memory()
    out['seconds'] = time.perf_counter() - t0
    print(f'slice 18 phase: {out["seconds"]:.1f} s', flush=True)
    return {'resnet32_slice18': r32_launches,
            'transformer_lm_slice18': lm_launches,
            'resnet50_slice18': r50_launches}, out


def main():
    if not torch.cuda.is_available():
        fail('no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_line()
    print(f'device: {smi}', flush=True)
    build_kernels()
    tc_report = build_report()

    # slice 1: ResNet-32, capture kernels K1/K2
    tr, launches, step_times = run_trainer()
    profiles = [profile_steps(tr, tr.train_loader.epoch(), 'resnet32',
                              per_step(launches))]
    rows = check_kernels(resnet_cases(tr), 'resnet32')
    check_off_path()
    check_agreement()
    del tr

    # slice 9: the health guard, F1mc and the prefetched data path
    slice9 = run_slice9(launches)

    # slice 2: the long-context LM, attention kernels K4/K5a/K5b and K2
    lm, lm_launches, lm_times = run_lm_trainer()
    profiles.append(profile_steps(lm, lm.batches(), 'transformer_lm',
                                  per_step(lm_launches)))
    rows += check_kernels(lm_cases(lm), 'transformer_lm')
    rows += check_attention(lm.args.n_layer, lm.args.n_head)
    del lm
    check_lm_agreement()
    torch.cuda.empty_cache()

    # slice 3: world>1 on process groups, the compressed reduce's K3
    w2_launches, w2 = run_world2()
    nccl = run_nccl()
    rows += check_ef([tuple(b) for b in w2['buckets']])
    torch.cuda.empty_cache()

    # slice 7: the ImageNet ResNet-50 trainer, bf16, K1/K2 at its shapes
    t0 = time.perf_counter()

    def lap(what):
        print(f'resnet50 {what} done, {time.perf_counter() - t0:.1f} s into '
              'the phase', flush=True)

    r50, r50_launches, r50_times, r50_prev = run_resnet50()
    lap('trainer')
    profiles.append(profile_steps(
        r50, r50.train_loader.epoch(), 'resnet50',
        {k: v // R50_STEPS for k, v in r50_launches.items()},
        steps=R50_PROFILE_STEPS, host=False))
    lap('profile')
    decomp = time_decomposition(r50, r50_prev)
    del r50_prev
    lap('decomposition')
    r50_rows = check_kernels(resnet50_cases(r50), 'resnet50',
                             dtypes=(torch.bfloat16,), timed=torch.bfloat16)
    lap('kernel checks')
    check_lockstep(r50)
    lap('lockstep')
    slice9['guard_cost_resnet50'] = guard_cost(
        r50, r50.loss_fn, GUARD_STEPS_R50, 'resnet50 bs32', rounds=1)
    lap('guard cost')
    del r50
    torch.cuda.empty_cache()
    resume = check_resnet50_resume()
    lap('resume')
    torch.cuda.empty_cache()
    ladder = {}
    for name in R50_LADDER_RUNS:
        ladder[name] = run_resnet50_ladder(name, float(np.median(r50_times)),
                                           decomp['ms_per_step'])
        torch.cuda.empty_cache()
        lap(f'ladder run ({name})')

    # slice 10: E-KFAC and replan
    slice10 = run_slice10()
    lap('slice 10')

    # slice 12: checkpoints, preemption and the world moves
    s12_launches, s12_r50, slice12 = run_slice12()
    torch.cuda.empty_cache()

    # slice 13: VGG-16, WRN-28-10, DenseNet-201, Inception-v4; exclude_parts
    s13_launches, s13_rows, slice13 = run_slice13()
    release_memory()

    # slice 14: Transformer-base, BERT-base, the WikiText-2 LSTM
    s14_launches, s14_rows, slice14 = run_slice14()
    release_memory()

    # slice 15: the LM on data x seq grids, the sequence trainers at world 2
    s15_kernels, slice15 = run_slice15()
    release_memory()

    # slice 17: the trainers' observability, the step split by range
    s17_launches, slice17 = run_slice17()
    release_memory()

    # slice 18: the control loop (tuner, arbiter, perf model, drift gate)
    s18_launches, slice18 = run_slice18(slice17['resnet50']['kfac_phase_ms'])

    kernels = kernel_summary(rows, {
        'resnet32': launches, 'transformer_lm': lm_launches, **w2_launches,
        **s12_launches, 'transformer_lm_slice17':
        s17_launches['transformer_lm_slice17'],
        'resnet32_slice18': s18_launches['resnet32_slice18'],
        'transformer_lm_slice18': s18_launches['transformer_lm_slice18']})
    kernels += kernel_summary(r50_rows, {'resnet50': r50_launches,
                                         'resnet50_slice12_world2': s12_r50,
                                         'resnet50_slice17':
                                         s17_launches['resnet50_slice17'],
                                         'resnet50_slice18':
                                         s18_launches['resnet50_slice18']},
                              names=('K1 conv_a', 'K2 stat_rows'),
                              suffix=' (resnet50 bf16)')
    for name, (_, _, _, dtype) in S13_NETS.items():
        paths = {name: s13_launches[name]}
        if name == 'densenet201':
            paths['densenet201_exclude_parts'] = \
                s13_launches['densenet201_exclude_parts']
        kernels += kernel_summary(
            [r for r in s13_rows if r['path'] == name], paths,
            names=('K1 conv_a', 'K2 stat_rows'),
            suffix=f' ({name} {str(dtype)[6:]})')
    for name in S14_NETS:
        if any(r['path'] == name for r in s14_rows):
            kernels += kernel_summary(
                [r for r in s14_rows if r['path'] == name],
                {name: s14_launches[name]}, names=('K2 stat_rows',),
                suffix=f' ({name} fp32)')
    kernels += s15_kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump({'device': smi,
                   'shapes': rows + r50_rows + s13_rows + s14_rows,
                   'kernels': kernels, 'tc_build': tc_report,
                   'step_ms': {'resnet32': step_times,
                               'transformer_lm': lm_times,
                               'resnet32_world2_eigen_bf16': w2['step_ms'],
                               'resnet50': r50_times},
                   'world2': w2, 'nccl': nccl, 'slice9': slice9,
                   'slice10': slice10, 'slice12': slice12,
                   'slice13': slice13, 'slice14': slice14,
                   'slice15': slice15, 'slice17': slice17,
                   'slice18': slice18,
                   'resnet50': {'decomposition': decomp,
                                'resume': {k: v for k, v in resume.items()
                                           if k != 'differ'},
                                'ladder_runs': ladder},
                   'profiles': profiles}, f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
