"""The port's observability modules against the JAX package's, byte for
byte: ``utils/runlog.py`` (the epoch-line suffixes, ``counter_deltas``,
``parse_resilience_suffix``, the run log and its flush chain),
``obs/trace.py`` (``TraceRecorder``'s events and JSONL), ``obs/metrics.py``
(the registry's epoch views and suffixes, the JSONL and Prometheus
exports), ``utils/metrics.py`` (``PhaseTimers.epoch_flush`` on the same
``(phases, seconds)`` streams, ``HealthMonitor`` with a registry,
``Metric``, ``topk_accuracy``) and ``utils/summary.py`` (the TensorBoard
event file's bytes), fed the same seeded events with the same injected
clocks. Everything here is host arithmetic on the same floats: the
tolerance is exact. Also ``utils.profiling`` on the CPU: the ``--speed``
timing and the split of a trace's device time by profiler range. No
case compiles a JAX step.
"""

import json
import logging
import os
import random
import time

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import obs as jobs
from kfac_pytorch_tpu import resilience as jres
from kfac_pytorch_tpu.utils import metrics as jmetrics
from kfac_pytorch_tpu.utils import runlog as jrunlog
from kfac_pytorch_tpu.utils import summary as jsummary
from kfac_pytorch_tpu_torch import obs as tobs
from kfac_pytorch_tpu_torch import resilience as tres
from kfac_pytorch_tpu_torch.resilience import retry as tretry
from kfac_pytorch_tpu_torch.utils import metrics as tmetrics
from kfac_pytorch_tpu_torch.utils import profiling as tprofiling
from kfac_pytorch_tpu_torch.utils import runlog as trunlog
from kfac_pytorch_tpu_torch.utils import summary as tsummary

PHASE_SETS = [(), ('stats',), ('pred', 'stats'), ('pred',),
              ('pred', 'stats', 'decomp', 'gather'),
              ('pred', 'stats', 'decomp'), ('pred', 'decomp', 'gather')]


@pytest.fixture(autouse=True)
def _clean_process_state():
    """Both packages' process-global state (resilience counters, the
    default trace recorder, the flush hooks, the root logger's handlers)
    as it was before the case."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    jres.counters.reset()
    tres.counters.reset()
    yield
    jobs.trace.uninstall()
    tobs.trace.uninstall()
    jrunlog.uninstall_flush_hooks()
    trunlog.uninstall_flush_hooks()
    jres.counters.reset()
    tres.counters.reset()
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


class Clock:
    """A deterministic clock: each reading advances by a seeded step."""

    def __init__(self, seed, start=1.7e9):
        self.rng = random.Random(seed)
        self.now = start

    def __call__(self):
        self.now += self.rng.uniform(1e-4, 0.5)
        return self.now


def _counts(rng):
    keys = ['io_retries', 'data_retries', 'watchdog_trips',
            'straggler_level', 'restarts']
    return {k: rng.choice([0, 0, rng.randint(1, 9)]) for k in keys}


@pytest.mark.parametrize('seed', range(4))
def test_runlog_formatters_match_jax(seed):
    rng = random.Random(seed)
    health = {'skipped': rng.randint(0, 3), 'fallbacks': rng.randint(0, 2),
              'max_rung': rng.randint(0, 3)}
    phase = {k: rng.uniform(0, 5e3) for k in
             rng.sample(['stats', 'pred', 'decomp+gather', 'step_mean',
                         'step_max', 'pred+stats'], rng.randint(0, 5))}
    prev, now = _counts(rng), _counts(rng)
    now = {k: v + prev.get(k, 0) for k, v in now.items()}
    deltas = jrunlog.counter_deltas(now, prev)
    assert trunlog.counter_deltas(now, prev) == deltas
    for fmt in ('health_suffix', 'kfac_phase_suffix', 'resilience_suffix'):
        for arg in (health, phase, now, deltas, {}):
            try:
                want = getattr(jrunlog, fmt)(arg)
            except KeyError:
                with pytest.raises(KeyError):
                    getattr(trunlog, fmt)(arg)
                continue
            assert getattr(trunlog, fmt)(arg) == want, (fmt, arg)
    line = f'epoch {seed}: x{jrunlog.resilience_suffix(now)} detect_s=1.25'
    for text in (line, line.replace(']', ' detect_s=1.25 tag=a]'),
                 'no suffix'):
        assert trunlog.parse_resilience_suffix(text) == \
            jrunlog.parse_resilience_suffix(text)


def _trace_events(mod, tmp_path, monkeypatch, seed):
    """One recorder's events from the same scripted calls, flushed to a
    file; the clocks (wall, perf, monotonic) are the seeded ones."""
    monkeypatch.setattr(time, 'monotonic', Clock(seed + 7, 100.0))
    path = tmp_path / f'{mod.__name__.split(".")[0]}.jsonl'
    rec = mod.TraceRecorder(str(path), process_id=3, clock=Clock(seed),
                            perf=Clock(seed + 1, 0.0), maxlen=64)
    rng = random.Random(seed)
    for i in range(40):
        kind = rng.choice(['span', 'complete', 'instant', 'counter', 'sync'])
        if kind == 'span':
            with rec.span('kfac.dispatch', cat='kfac.step', step=i,
                          phases=mod.taxonomy_phases(rng.choice(
                              PHASE_SETS))):
                pass
        elif kind == 'complete':
            rec.complete('kfac.step', rng.uniform(0, 1), cat='kfac.step',
                         phases=['Precondition'])
        elif kind == 'instant':
            rec.instant('retry', attempt=i)
        elif kind == 'counter':
            rec.counter('queue', {'depth': rng.randint(0, 5)})
        else:
            rec.clock_sync()
        if i == 30:
            rec.flush()
    rec.flush()
    return path.read_bytes(), rec.stats(), rec.events()


@pytest.mark.parametrize('seed', range(2))
def test_trace_recorder_matches_jax(tmp_path, monkeypatch, seed):
    # the ring wraps (64 events): the dropped count is part of the match
    want = _trace_events(jobs.trace, tmp_path, monkeypatch, seed)
    got = _trace_events(tobs.trace, tmp_path, monkeypatch, seed)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert tobs.trace.PHASE_TAXONOMY == jobs.trace.PHASE_TAXONOMY
    for phases in PHASE_SETS:
        assert tobs.trace.taxonomy_phases(phases) == \
            jobs.trace.taxonomy_phases(phases)


def test_trace_install_from_env_and_module_spans(tmp_path):
    env = {'KFAC_TRACE_DIR': str(tmp_path), 'RANK': '2'}
    rec = tobs.trace.install_from_env(env, role='sup')
    assert rec is tobs.trace.get()
    assert rec.path == str(tmp_path / 'trace-host2-sup.jsonl')
    assert rec.process_id == 2
    with tobs.trace.span('kfac.x', k=1):
        pass
    tobs.trace.instant('io_retry')
    # the flush chain carries the recorder
    trunlog.flush_all_handlers()
    names = [json.loads(ln)['name'] for ln in
             open(rec.path).read().splitlines()]
    assert names == ['process_name', 'clock_sync', 'kfac.x', 'io_retry']
    assert tobs.trace.install_from_env({}) is None
    assert tobs.trace.install_from_env(
        {'KFAC_TRACE_DIR': str(tmp_path / 'one.jsonl'), 'RANK': '0'}
    ).path == str(tmp_path / 'one.jsonl')
    # the profiler bridge opens the range, with or without a recorder
    tobs.trace.uninstall()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.trace.span('kfac.bridge', profiler=True):
            torch.ones(2).sum()
        rec = tobs.trace.TraceRecorder(None, process_id=0)
        with rec.span('kfac.bridged', profiler=True):
            torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert {'kfac.bridge', 'kfac.bridged'} <= names
    assert [e['name'] for e in rec.events()][-1] == 'kfac.bridged'


def _phase_stream(kind, rng, n):
    if kind == 'windowed':     # a decomposition every 4th step
        return [(('pred', 'stats', 'decomp', 'gather') if i % 4 == 0
                 else ('pred', 'stats')) for i in range(n)]
    if kind == 'staggered':    # every step runs everything
        return [('pred', 'stats', 'decomp', 'gather')] * n
    if kind == 'cold':         # factors only, then a first decomposition
        return [('stats',)] * (n // 2) + [('pred', 'stats', 'decomp')] + \
            [('pred', 'stats')] * (n - n // 2 - 1)
    return [rng.choice(PHASE_SETS) for _ in range(n)]


def _registry_run(pkg, tmp_path, seed, kinds):
    """A registry fed the same epochs by each package: the trainers'
    PhaseTimers (with a tracer and the step histogram), a HealthMonitor,
    the resilience counters and typed metrics of every kind; returns the
    epoch lines, the epoch views and the exports' bytes."""
    obs, metrics, runlog, res = pkg
    out = tmp_path / obs.__name__.split('.')[0]
    out.mkdir()
    rng = random.Random(seed)
    tracer = obs.trace.TraceRecorder(None, process_id=0, clock=Clock(seed),
                                     perf=Clock(seed + 1, 0.0))
    reg = obs.metrics.Registry(process_id=0)
    reg.add_collector(obs.metrics.resilience_collector(
        lambda: {'straggler_level': rng.randint(0, 2)}))
    reg.add_exporter(obs.metrics.JsonlExporter(str(out / 'metrics.jsonl')))
    prom = obs.metrics.PrometheusTextfileExporter(str(out / 'm.prom'))
    reg.add_exporter(prom)
    timers = metrics.PhaseTimers(tracer=tracer, registry=reg, histogram=True)
    monitor = metrics.HealthMonitor(logging.getLogger('obs-test'),
                                    registry=reg)
    lines, views, proms = [], [], []
    skipped = fallbacks = 0
    for epoch, kind in enumerate(kinds):
        for phases in _phase_stream(kind, rng, rng.randint(3, 9)):
            timers.record(phases, rng.uniform(1e-3, 2.0))
            skipped += rng.random() < 0.2
            fallbacks += rng.random() < 0.1
            monitor.update({'health/skipped': skipped,
                            'health/fallbacks': fallbacks,
                            'health/rung': rng.randint(0, 3)})
        for _ in range(rng.randint(0, 3)):
            res.counters.bump(rng.choice(['io_retries', 'data_retries']))
        reg.counter('evals').inc(rng.randint(0, 4))
        reg.gauge('lr', reset_on_flush=epoch % 2 == 0).set(rng.random())
        reg.watermark('mem').set(rng.randint(0, 100))
        reg.histogram('val_seconds', buckets=(0.1, 1.0)).observe(rng.random())
        if kind == 'idle':
            # a phase set that disappears: no step this epoch
            timers.epoch_flush()
        view = reg.epoch_flush()
        views.append(view)
        lines.append(f'epoch {epoch}: x{reg.epoch_suffixes(view)}')
        monitor.epoch_flush()
        reg.export(step=epoch, wall=1.7e9 + epoch)
        proms.append((out / 'm.prom').read_bytes())
    reg.close()
    return (lines, views, proms, (out / 'metrics.jsonl').read_bytes(),
            tracer.events(), reg.snapshot(), reg.kinds())


@pytest.mark.parametrize('kinds', [
    ('windowed', 'windowed'), ('staggered', 'windowed', 'idle', 'random'),
    ('cold', 'random', 'random'), ('random',) * 5],
    ids=['windowed', 'stagger-then-windowed', 'cold', 'random'])
def test_registry_phase_timers_and_exports_match_jax(tmp_path, kinds,
                                                     monkeypatch):
    monkeypatch.setattr(time, 'monotonic', lambda: 42.0)
    jax_side = (jobs, jmetrics, jrunlog, jres)
    port = (tobs, tmetrics, trunlog, tres)
    want = _registry_run(jax_side, tmp_path, 11, kinds)
    got = _registry_run(port, tmp_path, 11, kinds)
    names = ('lines', 'views', 'prom', 'jsonl', 'trace', 'snapshot', 'kinds')
    for name, g, w in zip(names, got, want):
        assert g == w, name
    assert any('kfac_phase_ms=' in ln for ln in got[0])


@pytest.mark.parametrize('kind', ['windowed', 'staggered', 'cold', 'random'])
def test_phase_timers_epoch_flush_matches_jax(kind):
    rng = random.Random(kind)
    jt, tt = jmetrics.PhaseTimers(), tmetrics.PhaseTimers()
    for epoch in range(3):
        for phases in _phase_stream(kind, rng, 2 + 3 * epoch):
            s = rng.uniform(1e-4, 3.0)
            jt.record(phases, s)
            tt.record(phases, s)
        assert tt.epoch_flush() == jt.epoch_flush()
    assert tt.epoch_flush() == jt.epoch_flush() == {}


def test_prometheus_path_namespacing_and_claims_match_jax(tmp_path):
    envs = [{}, {'KFAC_TENANT': 'alice'}, {'KFAC_JOB_ID': '7'},
            {'KFAC_TENANT': ' bob ', 'KFAC_JOB_ID': '000003'}]
    for env in envs:
        assert tobs.metrics.job_namespace(env) == \
            jobs.metrics.job_namespace(env)
        for path in ('metrics.prom', '/a/b/m.prom', None, '',
                     '/x/m-alice.prom'):
            assert tobs.metrics.namespaced_prom_path(path, env) == \
                jobs.metrics.namespaced_prom_path(path, env)
    first = tobs.metrics.PrometheusTextfileExporter(str(tmp_path / 'p'))
    with pytest.raises(ValueError, match='already exported'):
        tobs.metrics.PrometheusTextfileExporter(str(tmp_path / 'p'))
    first.close()
    tobs.metrics.PrometheusTextfileExporter(str(tmp_path / 'p')).close()


def _events_file(mod, log_dir, monkeypatch):
    clock = Clock(5)
    monkeypatch.setattr(time, 'time', clock)
    tb = mod.SummaryWriter(str(log_dir))
    rng = random.Random(5)
    for step in range(6):
        tb.add_scalar('train/loss', rng.uniform(0, 4), step)
    mod.log_epoch_scalars(tb, 3, 1.5, 0.1, 2.5, 0.75)
    mod.log_epoch_scalars(None, 3, 1.5, 0.1, 2.5, 0.75)
    tb.close()
    name, = os.listdir(log_dir)
    return name, (log_dir / name).read_bytes()


def test_tensorboard_event_file_bytes_match_jax(tmp_path, monkeypatch):
    want = _events_file(jsummary, tmp_path / 'jax', monkeypatch)
    got = _events_file(tsummary, tmp_path / 'port', monkeypatch)
    assert got == want
    # the records pass their crc32c, and the reader sees the scalars
    data = got[1]
    i = n = 0
    while i < len(data):
        (ln,) = np.frombuffer(data[i:i + 8], '<u8')
        head = data[i:i + 8]
        assert int.from_bytes(data[i + 8:i + 12], 'little') == \
            tsummary._masked_crc(head)
        payload = data[i + 12:i + 12 + int(ln)]
        assert int.from_bytes(data[i + 12 + int(ln):i + 16 + int(ln)],
                              'little') == tsummary._masked_crc(payload)
        i += 16 + int(ln)
        n += 1
    assert n == 1 + 6 + 4
    series = tsummary.read_scalars(str(tmp_path / 'port'))
    assert series == jsummary.read_scalars(str(tmp_path / 'jax'))
    # six scalars, then the epoch set's train/loss at step 3
    assert [s for s, _ in series['train/loss']] == [0, 1, 2, 3, 4, 5, 3]
    assert set(series) == {'train/loss', 'train/lr', 'val/loss',
                           'val/accuracy'}
    # the registry's exporter on the same writer
    w = tsummary.SummaryWriter(str(tmp_path / 'reg'))
    reg = tobs.metrics.Registry(process_id=0)
    reg.add_exporter(tobs.metrics.TensorBoardExporter(w))
    reg.histogram('step_seconds').observe(0.5)
    reg.counter('health/skipped').inc(2)
    reg.export(step=4)
    got = tsummary.read_scalars(str(tmp_path / 'reg'))
    assert got == {'health/skipped': [(4, 2.0)],
                   'step_seconds/mean': [(4, 0.5)]}
    # a registry off rank 0 exports nothing
    assert tobs.metrics.Registry(process_id=1).export(step=0) == 0


def test_metric_topk_and_health_monitor_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(64, 10).astype(np.float32)
    labels = rng.randint(0, 10, 64)
    for k in (1, 3, 5):
        want = float(jmetrics.topk_accuracy(logits, labels, k=k))
        got = float(tmetrics.topk_accuracy(torch.as_tensor(logits),
                                           torch.as_tensor(labels), k=k))
        assert got == want
    jm, tm = jmetrics.Metric('loss'), tmetrics.Metric('loss')
    for v, n in zip(rng.rand(7), rng.randint(1, 9, 7)):
        jm.update(v, n)
        tm.update(torch.tensor(v, dtype=torch.float64), n)
    assert tm.sync() is tm and tm.avg == jm.sync().avg
    # a restored state's counters are the baseline, not an epoch's events
    state = type('S', (), {'health': type('H', (), {
        'skipped': 2, 'fallbacks': 1, 'rung': 1})()})()
    regs = (jobs.metrics.Registry(process_id=0),
            tobs.metrics.Registry(process_id=0))
    mons = (jmetrics.HealthMonitor(state=state, registry=regs[0]),
            tmetrics.HealthMonitor(state=state, registry=regs[1]))
    for m in ({'health/skipped': 2, 'health/fallbacks': 1,
               'health/rung': 1},
              {'health/skipped': 4, 'health/fallbacks': 1,
               'health/rung': 3}, {'loss': 1.0}):
        for mon in mons:
            mon.update(m, step=5)
    assert regs[1].epoch_suffixes() == regs[0].epoch_suffixes() == \
        ' [health: skipped=2 sgd_fallbacks=0 max_rung=3]'
    assert mons[1].quality_signal() == mons[0].quality_signal() == 5
    assert mons[1].epoch_flush() == mons[0].epoch_flush()


def test_retries_count_into_the_resilience_suffix():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError('transient')
        return 'ok'

    clock = tretry.ManualClock()
    assert tretry.call_with_retry(flaky, clock=clock) == 'ok'

    def produce():
        yield 1
        if len(calls) < 4:
            calls.append(1)
            raise OSError('producer died')
        yield 2

    assert list(tretry.resumable_iter(produce, clock=clock)) == [1, 2]
    assert tres.counters.snapshot() == {'io_retries': 2, 'data_retries': 1}
    reg = tobs.metrics.Registry(process_id=0)
    reg.add_collector(tobs.metrics.resilience_collector())
    assert reg.epoch_suffixes() == \
        ' [resilience: data_retries=1 io_retries=2]'
    assert reg.epoch_suffixes() == ''


def test_setup_trainer_and_run_log(tmp_path, monkeypatch):
    monkeypatch.delenv('KFAC_TENANT', raising=False)
    monkeypatch.setenv('KFAC_JOB_ID', '9')
    tracer, reg = tobs.setup_trainer(trace_dir=str(tmp_path / 't'),
                                     prom_file=str(tmp_path / 'm.prom'))
    assert tracer is tobs.trace.get()
    assert tracer.path == str(tmp_path / 't' / 'trace-host0.jsonl')
    reg.counter('x').inc()
    assert reg.export(step=0) == 2
    reg.close()
    assert (tmp_path / 'm-9.prom').read_text().startswith('# TYPE kfac_x')
    row = json.loads((tmp_path / 't' / 'metrics.jsonl').read_text())
    assert row['step'] == 0 and row['metrics'] == {'x': 1}
    tobs.trace.uninstall()
    monkeypatch.delenv('KFAC_TRACE_DIR', raising=False)
    assert tobs.setup_trainer()[0] is None
    # the run log: the file on rank 0 only, a printed line left out of
    # the stream, the flush chain on SIGTERM's handler
    log, path = trunlog.setup_run_logging(str(tmp_path / 'logs'), 'run',
                                          None, '', 'bs4', unique=False)
    assert path == str(tmp_path / 'logs' / 'run_bs4.log')
    log.info('args: %s', {'a': 1})
    log.info('epoch 0: x', extra=trunlog.PRINTED)
    trunlog.flush_all_handlers()
    text = open(path).read().splitlines()
    assert [t.split(' ', 2)[2] for t in text] == ["args: {'a': 1}",
                                                  'epoch 0: x']
    stream = [h for h in logging.getLogger().handlers
              if type(h) is logging.StreamHandler][0]
    rec = logging.LogRecord('r', logging.INFO, '', 0, 'm', (), None)
    assert stream.filter(rec)
    rec.printed = True
    assert not stream.filter(rec)
    import signal
    assert signal.getsignal(signal.SIGTERM) is trunlog._sigterm_flush
    assert trunlog.setup_run_logging(str(tmp_path / 'l1'), 'x',
                                     process_id=1)[1] is None
    assert not (tmp_path / 'l1').exists()
    trunlog.uninstall_flush_hooks()
    assert signal.getsignal(signal.SIGTERM) is not trunlog._sigterm_flush
    assert trunlog.process_index() == int(os.environ.get('RANK', '0'))


def test_speed_report_and_breakdown_on_cpu():
    steps = []

    def step_fn(state, batch, lr=0.0):
        steps.append(lr)
        time.sleep(0.001)
        return state + 1, {'loss': torch.tensor(float(state))}

    class Log:
        lines = []

        def info(self, fmt, *args):
            self.lines.append(fmt % args)

    rec = tobs.trace.TraceRecorder(None, process_id=0)
    state = tprofiling.speed_report(Log(), step_fn, 0, None, 64,
                                    unit='imgs/sec', iters=4, warmup=2,
                                    kw_fn=lambda i: {'lr': i}, tracer=rec)
    assert state == 6 and steps == list(range(6))
    line, = Log.lines
    assert line.startswith('SPEED: iter time ') and '(imgs/sec ' in line
    assert [e['args']['i'] for e in rec.events()
            if e['name'] == 'bench.iter'] == [0, 1, 2, 3]
    # the ablation subtraction: each phase left out is that much faster
    cost = {'CommunicateInverse': 0.004, 'ComputeInverse': 0.006,
            'CommunicateFactor': 0.0, 'ComputeFactor': 0.003}

    def make_step(exclude):
        left = [p for p in cost if p not in exclude.split(',')]

        def step(state, batch):
            time.sleep(0.002 + sum(cost[p] for p in left))
            return state, {}
        return step, 0
    got = tprofiling.exclude_parts_breakdown(make_step, None, iters=3,
                                             warmup=1)
    assert set(got) == {'Total', 'Rest', *cost}
    assert got['ComputeInverse'] > got['ComputeFactor'] > 0.0
    assert got['Total'] > got['Rest'] > 0.001


def test_range_device_ms_attributes_launches_to_ranges():
    def x(name, cat, ts, dur, corr=None, tid=1):
        e = {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
             'pid': 7, 'tid': tid}
        if corr is not None:
            e['args'] = {'correlation': corr}
        return e
    events = [
        x('kfac.ComputeFactor', 'user_annotation', 0, 100),
        x('kfac.UpdateFactors', 'user_annotation', 100, 100),
        x('kfac.CommunicateFactor', 'user_annotation', 150, 20),
        x('other', 'user_annotation', 300, 10),
        x('cudaLaunchKernel', 'cuda_runtime', 10, 1, corr=1),
        x('cudaLaunchKernel', 'cuda_runtime', 160, 1, corr=2),
        x('cudaLaunchKernel', 'cuda_runtime', 305, 1, corr=3),
        x('cudaLaunchKernel', 'cuda_runtime', 50, 1, corr=4, tid=2),
        x('conv_a_kernel', 'kernel', 500, 2000, corr=1),
        x('ncclKernel', 'kernel', 2600, 500, corr=2),
        x('Memcpy HtoD', 'gpu_memcpy', 3200, 100, corr=3),
        x('stat_tall_kernel', 'kernel', 3400, 1000, corr=4),
        {'ph': 'i', 'name': 'noise'}]
    ranges, total, kernels = tprofiling.range_device_ms(events)
    assert ranges == {'kfac.ComputeFactor': 2.0, 'kfac.UpdateFactors': 0.5,
                      'kfac.CommunicateFactor': 0.5}
    assert total == pytest.approx(3.6)
    assert kernels[1] == ('ncclKernel', 0.5, ['kfac.CommunicateFactor',
                                              'kfac.UpdateFactors'])
    assert kernels[3][2] == []   # launched on another thread
