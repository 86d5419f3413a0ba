"""Smoke test of the PyTorch/CUDA port on one GPU: builds the capture
kernels from ``kfac_pytorch_tpu_torch/csrc``, trains ResNet-32
``eigen_dp`` with the fused capture kernels for 12 steps (counting each
kernel's launches), profiles three steps, holds each kernel against its
plain PyTorch version at every ResNet-32 batch-128 factor shape and at a
few other layer geometries, and checks the fused path against the
unfused one.

  python3 chip_smoke.py

Needs a CUDA device (exits non-zero without one). Prints the kernel
table, a ``{"kernels": [...]}`` JSON line, the GPU's name and power
limit, and last ``{"ok": true, "device": {...}}``; the per-shape table
and the profile also go to ``build/chip_smoke.json``. TF32 is off
throughout, so every comparison is fp32 against fp32.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) FLOP/s — the kernels run fp32 FMAs with TF32 off
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
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


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def close(got, want, rtol, atol, scale=1.0):
    """Max |got - want| and whether every element is within
    ``atol * scale + rtol * |want|``."""
    got, want = got.detach().double(), want.detach().double()
    err = (got - want).abs()
    ok = bool(torch.all(err <= atol * scale + rtol * want.abs()))
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
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


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def captured_shapes(tr):
    """One captured (a, g) of ResNet-32 on a real batch, grouped into the
    distinct (kernel, shape) launches of one factor step with their
    multiplicity."""
    from kfac_pytorch_tpu_torch import capture
    model = tr.state.model
    batch = tr.to_device(next(tr.train_loader.epoch()))
    model.train()
    with capture.Capture(model) as cap:
        out = model(batch['input'].permute(0, 3, 1, 2))
        torch.nn.functional.cross_entropy(out, batch['label']).backward()
    model.zero_grad(set_to_none=True)
    cases = {}
    for meta in tr.precond.plan.metas:
        a = capture.layer_act(cap.acts, meta).contiguous()
        g = capture.layer_g(cap.gs, meta).contiguous()
        if meta.kind == 'conv':
            sides = [('K1 conv_a', 'conv A', a), ('K2 stat_rows', 'conv G', g)]
        else:
            sides = [('K2 stat_rows', 'dense A', a),
                     ('K2 stat_rows', 'dense G', g)]
        for kname, what, x in sides:
            key = (kname, what, tuple(x.shape),
                   meta.strides if what == 'conv A' else None)
            if key not in cases:
                cases[key] = {'kernel': kname, 'what': what, 'meta': meta,
                              'x': x, 'count': 0}
            cases[key]['count'] += 1
    return list(cases.values())


def kernel_fns(case, x, ema):
    """(kernel call, plain call, lhs, rhs) of one case: the library
    yardstick is ``torch.matmul(lhs.T, rhs)`` on the materialized rows."""
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    from kfac_pytorch_tpu_torch.ops import factors
    meta, what = case['meta'], case['what']
    if what == 'conv A':
        args = (x, meta.kernel_size, meta.strides, meta.padding,
                meta.use_bias)
        rows = factors.extract_patches(*args[:4]).reshape(
            -1, meta.in_dim - meta.use_bias).float()
        rows = rows / (rows.shape[0] // x.shape[0])
        n = x.shape[0]
        return (lambda: ck.compute_a_conv(*args, ema=ema),
                lambda: ck._conv_a_plain(*args, ema=ema),
                rows, rows / n)
    if what == 'conv G':
        r = x.reshape(-1, x.shape[-1]).float()
        r = r * x.shape[0] * (x.shape[1] * x.shape[2])
        return (lambda: ck.compute_g_conv(x, True, ema=ema),
                lambda: ck._stat_rows_plain(
                    x.reshape(-1, x.shape[-1]), r.shape[0],
                    (x.shape[0], x.shape[1] * x.shape[2]), False, ema),
                r, r / r.shape[0])
    if what == 'dense A':
        r = torch.cat([x.float(), x.new_ones(x.shape[0], 1).float()], 1)
        return (lambda: ck.compute_a_dense(x, meta.use_bias, ema=ema),
                lambda: ck._stat_rows_plain(x, x.shape[0], (),
                                            meta.use_bias, ema),
                r, r / x.shape[0])
    r = x.float() * x.shape[0]
    return (lambda: ck.compute_g_dense(x, True, ema=ema),
            lambda: ck._stat_rows_plain(x, x.shape[0], (x.shape[0],),
                                        False, ema),
            r, r / x.shape[0])


def check_kernels(tr):
    cases = captured_shapes(tr)
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows_out = []
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and case['x'].shape[-1] != 16:
                continue  # bf16 inputs: checked at the 16-channel shapes
            x = case['x'].to(dtype)
            f = {'conv A': case['meta'].in_dim, 'dense A':
                 case['meta'].in_dim}.get(case['what'], x.shape[-1])
            cur = torch.eye(f, device='cuda') + 0.01 * torch.randn(
                f, f, device='cuda', generator=gen)
            errs = []
            scale = None
            for ema in (None, (cur, 0.95)):
                kern, plain, _, _ = kernel_fns(case, x, ema)
                got, want = kern(), plain()
                if scale is None:
                    scale = cs_scale(want)
                torch.cuda.synchronize()
                if got.shape != (f, f) or not bool(torch.isfinite(got).all()):
                    fail(f"{case['kernel']} {case['what']} {tuple(x.shape)}: "
                         f'shape {tuple(got.shape)} or non-finite output')
                err, ok = close(got, want, RTOL, ATOL, scale)
                if not ok:
                    fail(f"{case['kernel']} {case['what']} {tuple(x.shape)} "
                         f'{dtype} ema={ema is not None}: max |err| {err:.3e} '
                         f'outside rtol {RTOL} atol {ATOL}')
                errs.append(err)
            row = {'kernel': case['kernel'], 'what': case['what'],
                   'shape': list(x.shape), 'dtype': str(dtype)[6:], 'F': f,
                   'per_step': case['count'], 'max_abs_err': max(errs)}
            if dtype == torch.float32:
                ema = (cur, 0.95)
                kern, plain, lhs, rhs = kernel_fns(case, x, ema)
                nrows = lhs.shape[0]
                lhs_t = lhs.T.contiguous()
                row['ms'] = time_ms(kern)
                row['wrapper_ms'] = time_ms(kern, hide_host=False)
                row['plain_ms'] = time_ms(plain)
                row['library_ms'] = time_ms(lambda: torch.matmul(lhs_t, rhs))
                nbytes = x.numel() * x.element_size() + 2 * f * f * 4
                # the output is symmetric: its F(F+1)/2 distinct entries
                # take one multiply and one add per row each
                flops = float(nrows) * f * (f + 1)
                row['bytes_ms'] = nbytes / PEAK_BYTES * 1e3
                row['ops_ms'] = flops / PEAK_FP32 * 1e3
                row['bound_ms'] = max(row['bytes_ms'], row['ops_ms'])
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    return rows_out


#: layer geometries off the main path (bias column, odd channel counts,
#: asymmetric padding, non-square taps, unaligned widths), checked like
#: the main path's shapes but not timed: (input shape, kernel size,
#: strides, padding, bias) for K1, (rows shape, bias) for K2's dense A
OFF_PATH_K1 = [((8, 9, 9, 6), (3, 3), (2, 2), ((1, 2), (0, 1)), True),
               ((4, 7, 7, 8), (1, 3), (1, 2), 'SAME', True),
               ((3, 6, 5, 20), (3, 3), (1, 1), 'VALID', False)]
OFF_PATH_K2 = [((32, 12), True), ((50, 13), True), ((7, 3), False)]


def check_off_path():
    """K1 and K2 against their plain versions at OFF_PATH_* geometries,
    fp32 and bf16, with and without the EMA."""
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    gen = torch.Generator(device='cuda').manual_seed(1)
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
            x = torch.randn(shape, device='cuda', generator=gen).to(dtype)
            cur = torch.randn(f, f, device='cuda', generator=gen)
            scale = None
            for ema in (None, (cur, 0.95)):
                got, want = kern(x, ema), plain(x, ema)
                if scale is None:
                    scale = cs_scale(want)
                err, ok = close(got, want, RTOL, ATOL, scale)
                worst = max(worst, err)
                if not ok:
                    fail(f'off-path {tuple(shape)} {dtype} ema='
                         f'{ema is not None}: max |err| {err:.3e}')
    torch.cuda.synchronize()
    print(f'off-path geometries: {len(cases)} cases x 2 dtypes x +-EMA, '
          f'max |err| {worst:.3e}', flush=True)


def kernel_summary(rows, launches):
    """Per kernel: times summed over one factor step's launches (each
    distinct shape times its count per step). ``ms`` is device time;
    ``wrapper_ms`` the same calls timed with the wrapper's host work and
    launch latency exposed."""
    meta = {
        'K1 conv_a': 'kfac_pytorch_tpu/ops/pallas_capture.py:314',
        'K2 stat_rows': 'kfac_pytorch_tpu/ops/pallas_capture.py:207',
    }
    out = []
    for name, replaces in meta.items():
        mine = [r for r in rows if r['kernel'] == name]
        timed = [r for r in mine if 'ms' in r]

        def tot(k):
            return sum(r[k] * r['per_step'] for r in timed)

        out.append({
            'name': name, 'route': 'cuda',
            'source': 'kfac_pytorch_tpu_torch/csrc/capture.cu',
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': max(r['max_abs_err'] for r in mine),
            'ms': tot('ms'), 'wrapper_ms': tot('wrapper_ms'),
            'plain_ms': tot('plain_ms'),
            'bound_ms': tot('bound_ms'),
            'bound_by': ('operations' if tot('ops_ms') >= tot('bytes_ms')
                         else 'bytes'),
            'library_ms': tot('library_ms')})
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer, fused and against the unfused path
# ---------------------------------------------------------------------------

def make_trainer(capture_impl):
    from kfac_pytorch_tpu_torch import train_cifar
    argv = ['--device', 'cuda']
    if capture_impl is not None:
        argv += ['--kfac-capture-impl', capture_impl]
    return train_cifar.Trainer(train_cifar.parse_args(argv))


def run_trainer():
    from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
    tr = make_trainer('auto')
    layers = tr.precond.plan.metas
    n_conv = sum(m.kind == 'conv' for m in layers)
    n_dense = len(layers) - n_conv
    batches = tr.train_loader.epoch()
    ck.compute_a_conv.launches = 0
    ck._stat_rows.launches = 0
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
    launches = {'K1 conv_a': ck.compute_a_conv.launches,
                'K2 stat_rows': ck._stat_rows.launches}
    if not all(np.isfinite(losses)):
        fail(f'non-finite training loss: {losses}')
    want = {'K1 conv_a': n_conv * TRAIN_STEPS,
            'K2 stat_rows': (n_conv + 2 * n_dense) * TRAIN_STEPS}
    if launches != want:
        fail(f'kernel launches {launches}, expected {want}')
    expect_decomp = [i for i in range(TRAIN_STEPS)
                     if i % tr.precond.kfac_update_freq == 0]
    if decomp_steps != expect_decomp:
        fail(f'decomposition ran on steps {decomp_steps}, expected '
             f'{expect_decomp}')
    print(f'trainer: resnet32 bs128 eigen_dp capture_impl=auto, '
          f'{TRAIN_STEPS} steps, losses {[round(x, 4) for x in losses]}, '
          f'step ms median {float(np.median(times)):.3f} '
          f'(first {times[0]:.1f}, decomposition step 10 {times[10]:.1f}), '
          f'launches {launches}, decomposition on steps {decomp_steps}',
          flush=True)
    return tr, launches, times


def profile_steps(tr, steps=3):
    """Device time by kernel over ``steps`` factor-update steps without a
    decomposition (torch.profiler), and the device's busy share of the
    wall time. Returns the summary dict."""
    from torch.profiler import ProfilerActivity, profile
    batches = tr.train_loader.epoch()
    tr.train_step(next(batches))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    # the capture kernels' own device time per step, by body (the reduce
    # + EMA kernel serves both K1 and K2)
    capture_ms = {'K1 partial_kernel': 0.0, 'K2 partial_kernel': 0.0,
                  'reduce_ema_kernel': 0.0}
    for ms, _, k in rows:
        if 'partial_kernel' in k:
            capture_ms['K1 partial_kernel' if 'ConvRows' in k
                       else 'K2 partial_kernel'] += ms
        elif 'reduce_ema_kernel' in k:
            capture_ms['reduce_ema_kernel'] += ms
    out = {'steps': steps, 'wall_ms_per_step': wall / steps,
           'device_ms_per_step': busy, 'capture_kernels_ms': capture_ms,
           'top': [{'name': k[:80], 'ms_per_step': ms, 'calls_per_step': n}
                   for ms, n, k in rows[:20]]}
    if busy == 0:
        print('profile: torch.profiler saw no device time', flush=True)
        return out
    print(f'profile: {steps} factor steps, wall {wall / steps:.2f} ms/step, '
          f'device busy {busy:.2f} ms/step '
          f'({100 * busy / (wall / steps):.1f}%), capture kernels ms/step '
          f'{json.dumps(capture_ms)}', flush=True)
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
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams
    ref, fused = make_trainer(None), make_trainer('auto')
    it = ref.train_loader.epoch()
    bad = []
    st_ref, st_fused = ref.state.kfac_state, fused.state.kfac_state
    params_ref = dict(ref.state.model.named_parameters())
    params_fused = dict(fused.state.model.named_parameters())
    for i in range(AGREE_STEPS):
        batch = ref.to_device(next(it))
        model = ref.state.model
        model.zero_grad(set_to_none=True)
        with capture.Capture(model) as cap:
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
        ref.tx.apply(params_ref, pg_ref, ref.state.opt_state, i)
        fused.tx.apply(params_fused, pg_fused, fused.state.opt_state, i)
        worst = (0.0, '')
        for k in pg_ref:
            err, ok = close_tensor(pg_fused[k], pg_ref[k], GRAD_RTOL,
                                   GRAD_ATOL)
            worst = max(worst, (err / max(float(pg_ref[k].detach().abs()
                                                .max()), 1e-30), k))
            if not ok:
                bad.append(f'step {i} preconditioned grad {k}: max |err| '
                           f'{err:.3e}')
        fac = 0.0
        for k, v in st_ref.factors.items():
            s = cs_scale(v)
            err, ok = close(st_fused.factors[k], v, FACTOR_RTOL, FACTOR_ATOL,
                            s)
            fac = max(fac, float(((st_fused.factors[k].double()
                                   - v.double()).abs() / s).max()))
            if not ok:
                bad.append(f'step {i} factor bucket {k}: max |err| {err:.3e}')
        print(f'agreement (lockstep) step {i}: factors max err '
              f'{fac:.3e} x sqrt(F_ii F_jj), preconditioned grads max rel '
              f'err {worst[0]:.3e} ({worst[1]})', flush=True)
    par = (0.0, '')
    for k, v in params_ref.items():
        err, ok = close_tensor(params_fused[k], v, GRAD_RTOL, GRAD_ATOL)
        par = max(par, (err / max(float(v.detach().abs().max()), 1e-30),
                        k))
        if not ok:
            bad.append(f'parameter {k}: max |err| {err:.3e}')
    print(f'agreement (lockstep): params after {AGREE_STEPS} steps max rel '
          f'err {par[0]:.3e} ({par[1]})', flush=True)

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


def main():
    if not torch.cuda.is_available():
        fail('no CUDA device')
    from kfac_pytorch_tpu_torch.ops import _cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_line()
    print(f'device: {smi}', flush=True)

    t0 = time.perf_counter()
    _cuda_build.load('capture')
    print(f'build: capture.cu in {time.perf_counter() - t0:.1f} s',
          flush=True)

    tr, launches, step_times = run_trainer()
    prof = profile_steps(tr)
    rows = check_kernels(tr)
    check_off_path()
    check_agreement()

    kernels = kernel_summary(rows, launches)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump({'device': smi, 'shapes': rows, 'kernels': kernels,
                   'step_ms': step_times, 'profile': prof}, f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
