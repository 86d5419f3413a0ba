"""Tracing and phase attribution (the port of
``kfac_pytorch_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` context over the CPU and, where
  there is one, the card, exporting a Chrome trace (Perfetto and
  ``chrome://tracing`` load it). The preconditioner opens a
  ``record_function`` range at each phase (``kfac.ComputeFactor``,
  ``kfac.ComputeInverse``, ``kfac.Precondition``, ...: the JAX
  package's ``named_scope`` names), and :func:`range_device_ms` splits
  the device time of such a trace by those ranges.
- :func:`time_steps` and :func:`speed_report`: the ``--speed``
  measurement, each step fenced by :func:`host_fence`, the idle round
  trip (:func:`fence_rtt`) taken off.
- :func:`exclude_parts_breakdown`: the reference's split of the step by
  subtraction, one timed run per ``exclude_parts`` ablation.
"""

import contextlib
import json
import os
import time

import numpy as np
import torch

PHASES = ('ComputeFactor', 'CommunicateFactor', 'ComputeInverse',
          'CommunicateInverse')

#: Chrome-trace categories of device work (kineto's names)
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler.profile`` over the CPU and, when there is a card,
    the CUDA activity; on exit the Chrome trace is written to
    ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _last_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in reversed(out):
            t = _last_tensor(x)
            if t is not None:
                return t
    return None


def host_fence(out):
    """Wait until the work that produced ``out`` (a tensor, or a dict or
    sequence holding some) has run: ``torch.cuda.synchronize`` on the
    device of its last tensor. A CPU tensor is ready when it is
    returned."""
    t = _last_tensor(out)
    if t is not None and t.device.type == 'cuda':
        torch.cuda.synchronize(t.device)


def fence_rtt(out, samples=3):
    """The host cost of :func:`host_fence` with nothing pending (call it
    right after a fence), to take off per-step times."""
    t0 = time.perf_counter()
    for _ in range(samples):
        host_fence(out)
    return (time.perf_counter() - t0) / samples


def time_steps(step_fn, state, batch, iters=30, warmup=5, kw_fn=None,
               tracer=None, **kw):
    """Mean and std of a warm step's time, and the state after: ``warmup``
    steps, then ``iters`` steps each fenced by :func:`host_fence`, less
    the idle round trip. ``step_fn(state, batch, **kw) -> (state,
    metrics)``; ``kw_fn(i)`` adds per-step keyword arguments. ``tracer``
    (an ``obs.trace.TraceRecorder``) records each timed step as a
    ``bench.iter`` span of the time that enters the mean."""
    def kwargs(i):
        return {**kw, **(kw_fn(i) if kw_fn else {})}

    for i in range(warmup):
        state, m = step_fn(state, batch, **kwargs(i))
    host_fence(m)
    rtt = fence_rtt(m)
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, **kwargs(warmup + i))
        host_fence(m)
        t = max(time.perf_counter() - t0 - rtt, 0.0)
        times.append(t)
        if tracer is not None:
            tracer.complete('bench.iter', t, cat='bench', i=i)
    return float(np.mean(times)), float(np.std(times)), state


def speed_report(log, step_fn, state, batch, units_per_iter,
                 unit='tokens/sec', iters=60, warmup=5, kw_fn=None,
                 tracer=None, **kw):
    """:func:`time_steps`, then one ``SPEED: iter time <mean> +- <std> s
    (<unit> <rate>)`` line through ``log.info`` (``scripts/parse_logs.py``
    reads it). ``units_per_iter``: the real work of one step (rows x
    sequence length, not the requested batch). Returns the state."""
    mean, std, state = time_steps(step_fn, state, batch, iters=iters,
                                  warmup=warmup, kw_fn=kw_fn,
                                  tracer=tracer, **kw)
    log.info('SPEED: iter time %.4f +- %.4f s (%s %.1f)',
             mean, std, unit, units_per_iter / mean)
    return state


def exclude_parts_breakdown(make_step, batch, iters=20, **kw):
    """The step's time by phase, by ablation subtraction:
    ``make_step(exclude_parts) -> (step_fn, fresh_state)`` builds a step
    leaving out the named phases. Returns ``{phase: seconds}`` with
    'Total', each phase's cost (phases left out one more at a time, the
    reference's ``parse_logs.py`` order) and 'Rest'."""
    results = {}
    excluded = []
    step, state = make_step('')
    t_full, _, _ = time_steps(step, state, batch, iters=iters, **kw)
    results['Total'] = t_full
    prev = t_full
    for phase in ('CommunicateInverse', 'ComputeInverse',
                  'CommunicateFactor', 'ComputeFactor'):
        excluded.append(phase)
        step, state = make_step(','.join(excluded))
        t, _, _ = time_steps(step, state, batch, iters=iters, **kw)
        results[phase] = max(prev - t, 0.0)
        prev = t
    results['Rest'] = prev
    return results


def range_device_ms(trace_events, prefix='kfac.'):
    """Split a Chrome trace's device time by the host ranges it was
    launched in. ``trace_events``: the ``traceEvents`` list of a
    ``torch.profiler`` export (or the path of one). A device event
    (:data:`DEVICE_CATS`) belongs to every ``record_function`` range named
    ``prefix...`` that holds its launch (the host runtime event of the
    same ``correlation``, on the same thread). Returns ``(ranges, total,
    kernels)``: ``{range: device ms}``, the device ms of all device
    events, and ``[(name, ms, [enclosing ranges])]`` for each device
    event, ranges innermost first."""
    if isinstance(trace_events, str):
        with open(trace_events) as f:
            trace_events = json.load(f)['traceEvents']
    spans, launches, device = [], {}, []
    for e in trace_events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        corr = (e.get('args') or {}).get('correlation')
        if cat == 'user_annotation' and e.get('name', '').startswith(prefix):
            spans.append((e['name'], e.get('pid'), e.get('tid'),
                          float(e['ts']), float(e['ts']) + float(e['dur'])))
        elif cat in ('cuda_runtime', 'cuda_driver') and corr is not None:
            launches[corr] = (e.get('pid'), e.get('tid'), float(e['ts']))
        elif cat in DEVICE_CATS:
            device.append((e.get('name', ''), float(e.get('dur', 0.0)) / 1e3,
                           corr))
    ranges, kernels, total = {}, [], 0.0
    for name, ms, corr in device:
        total += ms
        held = []
        at = launches.get(corr)
        if at is not None:
            pid, tid, ts = at
            held = [s for s in spans
                    if s[1] == pid and s[2] == tid and s[3] <= ts <= s[4]]
            held.sort(key=lambda s: s[4] - s[3])
        names = list(dict.fromkeys(s[0] for s in held))
        for r in names:
            ranges[r] = ranges.get(r, 0.0) + ms
        kernels.append((name, ms, names))
    return ranges, total, kernels
