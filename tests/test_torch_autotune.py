"""The port's control loop (``kfac_pytorch_tpu_torch/autotune.py``) held
against the JAX package's ``autotune.py`` in the same process, on the
same inputs. Both modules are stdlib at import and deterministic under a
synthetic feed (``KnobController.record``), so no case compiles a JAX
step.

- The arbiter: the same proposal sequences (schedule, straggler stretch,
  tuner overrides, elastic records, external writes, ``sync_knobs``,
  unknown sources and knobs) give the same effective knobs, bases,
  rebases, invalidator calls, queued replans and errors, on duck-typed
  stand-ins and on both packages' real ``KFAC``.
- The tuner: the same synthetic ``record()`` feeds give the same
  decisions, field for field, the same decision-log and
  ``adopted-knobs.json`` bytes, the same log lines, trace instants and
  resilience counters: a planted optimum, a flat profile, dwell, a
  quality-gate veto, the decomposition and capture ladders, the wire
  ladder, the perf-model seeds, and the drift gate (a veto on the
  modeled card: 'TPU v5e' for JAX, 'NVIDIA H100 80GB HBM3' for the port,
  the same predicted block; advisory elsewhere).
- Nothing in the port assigns a knob attribute on a KFAC outside
  ``autotune.py`` and KFAC's constructor and ``replan`` (an AST walk).
- ``KFACParamScheduler`` proposes to the arbiter and gives the damping and
  frequencies of the port's previous direct rule, and JAX's, at every
  epoch.
"""

import ast
import json
import logging
import os

import pytest

from kfac_pytorch_tpu import autotune as jat
from kfac_pytorch_tpu import perfmodel as jpm
from kfac_pytorch_tpu import resilience as jres
from kfac_pytorch_tpu.obs import trace as jtrace
from kfac_pytorch_tpu_torch import autotune as tat
from kfac_pytorch_tpu_torch import resilience as tres
from kfac_pytorch_tpu_torch.obs import trace as ttrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'kfac_pytorch_tpu_torch')


class _Plan:
    """A plan stand-in: its layers and the two comm modes' bytes."""
    metas = ['fc1', 'fc2']

    def comm_volume(self, *, stats_reduce, method, comm_precision,
                    comm_mode):
        return {'InverseComm': 4096.0 if comm_mode == 'inverse' else 0.0,
                'PredComm': 512.0 if comm_mode == 'pred' else 0.0}


class _Fake:
    """Knob-attribute stand-in both packages drive: the knobs, the
    no-collectives test of each (JAX ``axis_name``, the port ``group``),
    and records of the hooks the arbiter calls."""

    def __init__(self, fac=1, kfac=10, damping=0.03, comm_precision=None,
                 world=None, decomp_impl=None, capture_impl=None,
                 method=None, comm_mode=None, plan=None, variant=None,
                 comm_prefetch=False):
        self.fac_update_freq = fac
        self.kfac_update_freq = kfac
        self.damping = damping
        self.comm_precision = comm_precision
        self.axis_name = self.group = world
        self.decomp_impl = decomp_impl
        self.capture_impl = capture_impl
        self.method = method
        self.comm_mode = comm_mode
        self.plan = plan
        if variant is not None:
            self.variant = variant
        self.comm_prefetch = comm_prefetch
        self.num_devices = 2 if world else 1
        self._distributed = False
        self.rebases = 0
        self.replans = []

    def rebase_cohorts(self):
        self.rebases += 1

    def request_replan(self, _invalidate=True, **spec):
        self.replans.append((spec, _invalidate))


def _raised(fn):
    try:
        return 'ok', fn()
    except Exception as e:      # noqa: BLE001 — the type and text compared
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# the arbiter
# ---------------------------------------------------------------------------

ARBITER_CASES = {
    'compose': (dict(fac=1, kfac=10, damping=0.04), [
        ('propose', 'schedule', dict(freq_factor=2.0, damping_factor=0.5)),
        ('propose', 'straggler', dict(stretch=4)),
        ('propose', 'tuner', dict(kfac_update_freq=5)),
        ('propose', 'straggler', dict(stretch=1)),
        ('propose', 'tuner', dict(kfac_update_freq=None))]),
    'floor': (dict(fac=1, kfac=2), [
        ('propose', 'schedule', dict(freq_factor=0.1)),
        ('propose', 'schedule', dict(freq_factor=0.7, damping_factor=3.0))]),
    'adopt': (dict(fac=1, kfac=10), [
        ('propose', 'straggler', dict(stretch=2)),
        ('write', dict(fac_update_freq=4, kfac_update_freq=40)),
        ('propose', 'straggler', dict(stretch=1)),
        ('propose', 'schedule', dict(freq_factor=2.0, damping_factor=0.5)),
        ('write', dict(damping=0.5)),
        ('propose', 'schedule', dict(freq_factor=4.0, damping_factor=0.25))]),
    'damping': (dict(fac=1, kfac=10, damping=0.03), [
        ('propose', 'tuner', dict(damping=0.1)),
        ('propose', 'schedule', dict(damping_factor=0.5)),
        ('propose', 'tuner', dict(damping=None))]),
    'knobs': (dict(comm_precision='fp32', world='g', decomp_impl='xla',
                   capture_impl='pallas', comm_mode='inverse'), [
        ('propose', 'tuner', dict(comm_precision='bf16')),
        ('propose', 'tuner', dict(decomp_impl='subspace')),
        ('propose', 'tuner', dict(capture_impl='xla')),
        ('propose', 'tuner', dict(comm_mode='pred')),
        ('sync', dict(comm_mode='pred')),
        ('propose', 'tuner', dict(kfac_update_freq=20)),
        ('invalidate',),
        ('write', dict(comm_precision='int8')),
        ('propose', 'tuner', dict(comm_precision=None)),
        ('propose', 'elastic', dict(lr=0.1, world=2))]),
    'errors': (dict(comm_precision='fp32', decomp_impl='xla',
                    capture_impl='xla', comm_mode='inverse',
                    comm_prefetch=True), [
        ('propose', 'bogus', {}),
        ('propose', 'tuner', dict(bogus=1)),
        ('propose', 'tuner', dict(comm_precision='fp8')),
        ('propose', 'tuner', dict(comm_precision=None)),
        ('propose', 'tuner', dict(decomp_impl='nope')),
        ('propose', 'tuner', dict(decomp_impl=None)),
        ('propose', 'tuner', dict(capture_impl='nope')),
        ('propose', 'tuner', dict(capture_impl=None)),
        ('propose', 'tuner', dict(comm_mode='nope')),
        ('propose', 'tuner', dict(comm_mode='pred')),
        ('sync', dict(bogus=1))]),
}


def _arbiter_trace(at, pre, ops):
    """Every observable of ``at``'s arbiter over ``ops`` on ``pre``."""
    arb = at.arbiter_for(pre)
    assert at.arbiter_for(pre) is arb
    fired = []
    arb.add_invalidator(lambda: fired.append(1))
    out = []
    for op in ops:
        if op[0] == 'propose':
            res = _raised(lambda: arb.propose(op[1], **op[2]))
        elif op[0] == 'write':
            for k, v in op[1].items():
                setattr(pre, k, v)
            res = None
        elif op[0] == 'sync':
            res = _raised(lambda: arb.sync_knobs(**op[1]))
        else:
            res = _raised(arb.invalidate)
        out.append((res, at._capture(pre), dict(arb.base),
                    dict(arb.schedule), arb.stretch, dict(arb.tuner),
                    list(arb.records), arb.changes, pre.rebases,
                    list(pre.replans), len(fired)))
    return out


@pytest.mark.parametrize('case', list(ARBITER_CASES))
def test_arbiter_matches_jax(case):
    kw, ops = ARBITER_CASES[case]
    got = _arbiter_trace(tat, _Fake(**kw), ops)
    want = _arbiter_trace(jat, _Fake(**kw), ops)
    assert got == want


def test_arbiter_on_the_real_kfac_matches_jax():
    """Both packages' KFAC: the schedule, a wire-dtype commit (one
    invalidation), a comm-mode commit (one invalidation and a queued
    replan that does not fire again when applied), and a replan done
    directly afterwards (re-based, not adopted)."""
    import kfac_pytorch_tpu as jkfac
    import kfac_pytorch_tpu_torch as tkfac
    import torch_dist_workers as workers
    from kfac_pytorch_tpu import capture as jcapture
    from kfac_pytorch_tpu_torch import capture as tcapture

    def run(pkg, at):
        cap = tcapture if pkg is tkfac else jcapture
        pre = pkg.KFAC(variant='eigen_dp', damping=0.003, kfac_update_freq=10,
                       bucket_fn=workers.bucket_tiny)
        pre.setup({f'fc{i}': cap.LayerMeta(
            name=f'fc{i}', path=(f'fc{i}',), kind='dense', use_bias=False,
            in_dim=a, out_dim=g, kernel_shape=(a, g))
            for i, (a, g) in enumerate([(28, 8), (73, 10), (129, 8)])})
        arb = at.arbiter_for(pre)
        fired = []
        arb.add_invalidator(lambda: fired.append(1))
        out = []

        def note(res):
            out.append((res, at._capture(pre), dict(arb.base),
                        pre.pending_replan, len(fired), arb.changes))
        note(arb.propose('schedule', freq_factor=0.5, damping_factor=0.1))
        note(arb.propose('tuner', comm_precision='bf16'))
        note(arb.propose('tuner', comm_mode='inverse'))
        note(pre.apply_pending_replan(None))
        note(pre.comm_mode == pre.plan.comm_mode == 'inverse')
        note(pre.replan(None, comm_mode='pred'))
        note(arb.propose('schedule', freq_factor=1.0))
        return out

    assert run(tkfac, tat) == run(jkfac, jat)


# ---------------------------------------------------------------------------
# the tuner: synthetic feeds
# ---------------------------------------------------------------------------

def _amortized(pre, F, i):
    """Refresh cost 0.5 amortized over the window: optimum = max freq."""
    if i == 0:
        return ('pred', 'stats', 'decomp', 'gather'), 0.51
    return ('pred',), 0.01


def _stale(pre, F, i):
    phases = ('pred', 'stats', 'decomp', 'gather') if i == 0 else ('pred',)
    return phases, 0.01 + 0.002 * F + (0.001 if i == 0 else 0.0)


def _flat(pre, F, i):
    return ('pred',), 0.01


def _decomp_rung(fast, slow, events=None):
    def model(pre, F, i):
        rung = pre.decomp_impl
        if events is not None and rung != 'xla':
            events['n'] += 1
        cost = slow if rung == 'xla' else fast
        if i == 0:
            return ('pred', 'stats', 'decomp'), 0.01 + cost
        return ('pred',), 0.01
    return model


def _capture_rung(pre, F, i):
    cost = 0.02 if pre.capture_impl == 'xla' else 0.01
    return ('pred', 'stats'), 0.01 + cost


def _wire(pre, F, i):
    cost = {'fp32': 0.05, 'bf16': 0.03, 'int8': 0.031}[pre.comm_precision]
    return ('pred', 'stats'), cost


def _veto(pre, F, i):
    # 0.6 s steps in the baseline window, 0.5 s after: an improvement the
    # drift band rejects ('Precondition' far above its prediction)
    return ('pred',), 0.6 if pre.kfac_update_freq == 4 else 0.5


TUNER_CASES = {
    'planted_optimum': (dict(kfac=1), dict(
        window=16, settle=1, rel_improve=0.03, dwell_windows=1, cooldown=2,
        steady_every=0, tune=('kfac_update_freq',), freq_bounds=(1, 8)),
        _amortized, 400, None),
    'down_from_high_freq': (dict(kfac=8), dict(
        window=16, settle=1, dwell_windows=1, cooldown=2, steady_every=0,
        tune=('kfac_update_freq',), freq_bounds=(1, 8)), _stale, 600, None),
    'flat_profile': (dict(kfac=4), dict(
        window=8, settle=1, dwell_windows=2, cooldown=4, steady_every=0,
        tune=('kfac_update_freq',), freq_bounds=(1, 8)), _flat, 600, None),
    'dwell_and_steady_reprobe': (dict(kfac=1), dict(
        window=16, settle=1, dwell_windows=3, cooldown=2, steady_every=3,
        tune=('kfac_update_freq', 'fac_update_freq'),
        freq_bounds=(1, 8)), _amortized, 500, None),
    'decomp_ladder': (dict(kfac=4, method='cholesky', decomp_impl='xla'),
                      dict(window=8, settle=1, dwell_windows=1, cooldown=2,
                           steady_every=0, tune=('decomp_impl',)),
                      _decomp_rung(0.1, 0.4), 200, None),
    'decomp_ladder_slower': (dict(kfac=4, method='eigh',
                                  decomp_impl='auto'),
                             dict(window=8, settle=1, dwell_windows=1,
                                  cooldown=2, steady_every=0,
                                  tune=('decomp_impl',)),
                             _decomp_rung(0.8, 0.4), 200, None),
    'quality_veto': (dict(kfac=4, method='cholesky', decomp_impl='xla'),
                     dict(window=8, settle=1, dwell_windows=1, cooldown=2,
                          steady_every=0, tune=('decomp_impl',)),
                     'quality', 300, None),
    'capture_ladder': (dict(kfac=4, capture_impl='auto'),
                       dict(window=8, settle=1, dwell_windows=1,
                            cooldown=2, steady_every=0,
                            tune=('capture_impl',)),
                       _capture_rung, 200, None),
    'capture_hidden': (dict(kfac=4, capture_impl=None),
                       dict(window=4, settle=0, tune=('capture_impl',)),
                       _capture_rung, 40, None),
    'wire_ladder_and_comm_mode': (
        dict(kfac=4, comm_precision='fp32', world='g', comm_mode='inverse',
             plan=_Plan(), method='eigh', variant='eigen'),
        dict(window=8, settle=1, dwell_windows=1, cooldown=3,
             steady_every=0, tune=('comm_precision', 'comm_mode')),
        _wire, 300, None),
    'seeded_from_prior': (dict(kfac=1, method='eigh', decomp_impl='xla',
                               capture_impl='xla'),
                          dict(window=4, settle=0, freq_bounds=(1, 512),
                               variant='eigen_dp'),
                          _flat, 12, 'prior'),
    'drift_veto_on_modeled_card': (dict(kfac=4), dict(
        window=4, settle=0, rel_improve=0.03, dwell_windows=1, cooldown=2,
        steady_every=0, tune=('kfac_update_freq',), freq_bounds=(1, 8),
        variant='eigen_dp'), _veto, 8, 'modeled'),
    'drift_gate_advisory': (dict(kfac=4), dict(
        window=4, settle=0, rel_improve=0.03, dwell_windows=1, cooldown=2,
        steady_every=0, tune=('kfac_update_freq',), freq_bounds=(1, 8),
        variant='eigen_dp'), _veto, 8, 'advisory'),
}

#: the platform each package's gate takes for a case's drift mode
PLATFORM = {'modeled': ('TPU v5e', 'NVIDIA H100 80GB HBM3'),
            'advisory': ('cpu', 'cpu'), 'prior': ('cpu', 'cpu')}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _run_tuner(at, trace_mod, res_mod, case, tmp):
    fake_kw, ctl_kw, model, steps, drift = TUNER_CASES[case]
    pre = _Fake(**fake_kw)
    events = {'n': 0}
    if model == 'quality':
        model = _decomp_rung(0.05, 0.4, events)
    kw = dict(ctl_kw)
    if drift is not None:
        # the JAX module's block, handed to both: the port's gate and
        # priors run on the same predictions
        kw['predicted'] = jpm.predict_block()
        kw['platform'] = PLATFORM[drift][0 if at is jat else 1]
    logger = logging.getLogger(f'autotune-parity-{at.__name__}')
    logger.propagate = False
    logger.setLevel(logging.INFO)
    handler = _Lines()
    logger.handlers = [handler]
    os.makedirs(tmp, exist_ok=True)
    rec = trace_mod.install(os.path.join(tmp, 'trace.jsonl'))
    res_mod.counters.reset()
    try:
        ctl = at.KnobController(
            pre, decision_log=os.path.join(tmp, 'autotune-decisions.jsonl'),
            log=logger, quality_gate=lambda: events['n'], **kw)
        if drift == 'modeled' or drift == 'advisory':
            ctl._seeded = 'done'     # the gate alone, as JAX's test does
        fed = 0
        while fed < steps:
            F = pre.kfac_update_freq
            for i in range(F):
                phases, cost = model(pre, F, i)
                ctl.record(phases, cost)
                fed += 1
                if fed >= steps:
                    break
        rec.flush()
    finally:
        trace_mod.uninstall()
    instants = [(e['name'], e.get('args')) for e in
                (json.loads(ln) for ln in open(os.path.join(
                    tmp, 'trace.jsonl'))) if e.get('cat') == 'autotune']
    files = {name: open(os.path.join(tmp, name)).read()
             for name in ('autotune-decisions.jsonl', 'adopted-knobs.json')
             if os.path.exists(os.path.join(tmp, name))}
    return {'decisions': list(ctl.decisions), 'files': files,
            'lines': handler.lines, 'instants': instants,
            'counters': res_mod.counters.snapshot(),
            'report': ctl.report(), 'counts': ctl.counts(),
            'knobs': at._capture(pre), 'replans': pre.replans,
            'state': (ctl.state, ctl.windows, ctl.commits, ctl.reverts,
                      ctl.vetoes, ctl.quality_vetoes,
                      ctl.advisory_violations)}


@pytest.mark.parametrize('case', list(TUNER_CASES))
def test_tuner_decisions_match_jax(case, tmp_path):
    got = _run_tuner(tat, ttrace, tres, case, str(tmp_path / 'port'))
    want = _run_tuner(jat, jtrace, jres, case, str(tmp_path / 'jax'))
    assert got == want
    # the cases do what they are named for
    kinds = [d['kind'] for d in got['decisions']]
    expect = {'planted_optimum': 'commit', 'flat_profile': 'revert',
              'quality_veto': 'veto', 'decomp_ladder': 'commit',
              'decomp_ladder_slower': 'revert', 'capture_ladder': 'revert',
              'wire_ladder_and_comm_mode': 'comm_mode',
              'seeded_from_prior': 'seed',
              'drift_veto_on_modeled_card': 'veto',
              'drift_gate_advisory': 'commit'}
    if case in expect:
        assert expect[case] in kinds, kinds
    if case == 'capture_hidden':
        assert kinds == ['steady'] and got['knobs']['capture_impl'] is None
    if case == 'drift_veto_on_modeled_card':
        veto = next(d for d in got['decisions'] if d['kind'] == 'veto')
        assert 'Precondition' in veto['violations']
    if case == 'drift_gate_advisory':
        assert got['state'][-1] >= 1    # violations counted, not vetoed


def test_tick_attributes_the_interval_to_the_previous_dispatch():
    """The inter-arrival feed on an injected clock, in both packages: the
    interval that ends at a tick is recorded under the phases passed."""
    def run(at):
        t = [0.0]
        pre = _Fake(kfac=4)
        ctl = at.KnobController(pre, window=2, settle=0, clock=lambda: t[0],
                                tune=('kfac_update_freq',))
        seen = []
        ctl.record = lambda phases, s, step=None: seen.append(
            (phases, round(s, 9), step))
        for step, (dt, phases) in enumerate([(0.5, ()), (0.25, ('pred',)),
                                             (1.0, ('pred', 'decomp'))]):
            ctl.tick(step, phases)
            t[0] += dt
        return seen
    assert run(tat) == run(jat) == [((('pred',)), 0.5, 1),
                                    (('pred', 'decomp'), 0.25, 2)]


def test_restated_ladders_match_the_preconditioner():
    from kfac_pytorch_tpu_torch import preconditioner
    assert tat.DECOMP_IMPLS == preconditioner.DECOMP_IMPLS
    assert set(tat.CAPTURE_IMPLS) == set(preconditioner.CAPTURE_IMPLS)
    for name in ('KNOB_ATTRS', 'COMM_PRECISIONS', 'COMM_MODES',
                 'DECOMP_IMPLS', 'DECOMP_LADDERS', 'CAPTURE_IMPLS',
                 'CAPTURE_LADDER', 'ADOPTED_KNOB_FLAGS',
                 'ADOPTED_KNOBS_FILENAME'):
        assert getattr(tat, name) == getattr(jat, name), name
    for fn in ('_marginals', '_robust_mean', '_taxonomy_seconds'):
        arg = ({frozenset(): 0.1, frozenset({'pred'}): 0.3,
                frozenset({'pred', 'stats', 'decomp'}): 0.9}
               if fn == '_marginals' else
               [0.1, 0.2, 5.0, 0.15] if fn == '_robust_mean' else
               {'decomp+gather': 0.5, 'pred': 0.1, 'step_mean': 0.3})
        assert getattr(tat, fn)(arg) == getattr(jat, fn)(arg)
    vols = {'inverse': 1000.0, 'pred': 100.0}
    for freq in (1, 10, 100):
        assert tat.decide_comm_mode(vols, freq) == \
            jat.decide_comm_mode(vols, freq)
    plan = _Plan()
    assert tat.comm_mode_bytes(plan, 'eigh', 'bf16') == \
        jat.comm_mode_bytes(plan, 'eigh', 'bf16')


# ---------------------------------------------------------------------------
# the single writer: an AST walk of the port
# ---------------------------------------------------------------------------

def _knob_writes(tree):
    """``(function, line)`` of every assignment to a knob attribute and
    every ``setattr`` with a constant knob name or a variable one."""
    out = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (child.targets if isinstance(child, ast.Assign)
                           else [child.target])
                for t in targets:
                    for sub in ast.walk(t):
                        if (isinstance(sub, ast.Attribute)
                                and sub.attr in tat.KNOB_ATTRS):
                            out.append((name, child.lineno))
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Name)
                    and child.func.id == 'setattr' and len(child.args) >= 2):
                key = child.args[1]
                if not isinstance(key, ast.Constant) or \
                        key.value in tat.KNOB_ATTRS:
                    out.append((name, child.lineno))
            walk(child, name)
    walk(tree, None)
    return out


def test_nothing_in_the_port_writes_knobs_outside_the_arbiter():
    """JAX's ``test_scheduler_and_governor_never_write_knobs_directly``,
    at the source level: outside ``autotune.py`` a knob attribute is
    assigned only in ``KFAC.__init__`` (and ``_set_decomp_ladder``, which
    only the constructor calls) and in ``KFAC.replan``."""
    allowed = {('preconditioner.py', '__init__'),
               ('preconditioner.py', '_set_decomp_ladder'),
               ('preconditioner.py', 'replan')}
    bad = []
    for dirpath, _, names in os.walk(PORT):
        for n in names:
            if not n.endswith('.py') or n == 'autotune.py':
                continue
            path = os.path.join(dirpath, n)
            tree = ast.parse(open(path).read())
            for fn, line in _knob_writes(tree):
                if (n, fn) not in allowed:
                    bad.append(f'{os.path.relpath(path, ROOT)}:{line} ({fn})')
    assert not bad, bad
    # the constructor's helper is the constructor's only
    src = open(os.path.join(PORT, 'preconditioner.py')).read()
    assert src.count('self._set_decomp_ladder(') == 1
    # and the scheduler, the former direct writer, proposes
    sched = ast.parse(open(os.path.join(PORT, 'scheduler.py')).read())
    assert not _knob_writes(sched)
    assert 'propose(' in open(os.path.join(PORT, 'scheduler.py')).read()


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _old_rule(base, damping_factor, freq_factor):
    """The port's scheduler before it proposed: damping ``base * f``,
    frequencies ``max(1, int(base * f))``."""
    return {'damping': base['damping'] * damping_factor,
            'fac_update_freq': max(1, int(base['fac_update_freq']
                                          * freq_factor)),
            'kfac_update_freq': max(1, int(base['kfac_update_freq']
                                           * freq_factor))}


@pytest.mark.parametrize('cfg', [
    # the trainers' schedules: ImageNet (55 epochs), CIFAR (100)
    dict(base=(1, 1, 0.002), damping_alpha=0.5,
         damping_schedule=[25, 35, 40, 45, 50], update_freq_alpha=10,
         update_freq_schedule=[25, 35], epochs=55),
    dict(base=(1, 10, 0.003), damping_alpha=0.5, damping_schedule=[35, 75],
         update_freq_alpha=0.5, update_freq_schedule=[40, 80], epochs=100)],
    ids=['imagenet', 'cifar'])
def test_scheduler_keeps_its_numbers_and_proposes(cfg):
    from kfac_pytorch_tpu.scheduler import KFACParamScheduler as JSched
    from kfac_pytorch_tpu_torch.scheduler import KFACParamScheduler as TSched
    fac, kfac, damping = cfg['base']
    kw = {k: cfg[k] for k in ('damping_alpha', 'damping_schedule',
                              'update_freq_alpha', 'update_freq_schedule')}
    tpre, jpre = _Fake(fac, kfac, damping), _Fake(fac, kfac, damping)
    base = {'damping': damping, 'fac_update_freq': fac,
            'kfac_update_freq': kfac}
    tsched, jsched = TSched(tpre, **kw), JSched(jpre, **kw)
    for epoch in range(cfg['epochs'] + 1):
        tsched.step(epoch)
        jsched.step(epoch)
        want = _old_rule(base, tsched.damping_factor_func(epoch),
                         tsched.update_freq_factor_func(epoch))
        got = {k: getattr(tpre, k) for k in want}
        assert got == want, epoch
        assert got == {k: getattr(jpre, k) for k in want}, epoch
    assert tat.arbiter_for(tpre).changes > 0
