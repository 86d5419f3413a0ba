"""Closed-loop autotuning: one online controller for every runtime knob
(port of ``kfac_pytorch_tpu/autotune.py``).

Two layers, as in JAX:

**The arbiter** (:class:`KnobArbiter`, one per preconditioner through
:func:`arbiter_for`) is the only writer of a ``KFAC``'s runtime knobs
(:data:`KNOB_ATTRS`). The other controllers propose to it:

- ``schedule``: :class:`~kfac_pytorch_tpu_torch.scheduler.KFACParamScheduler`
  proposes multiplicative ``damping_factor`` / ``freq_factor`` decays;
- ``straggler``: an integer frequency ``stretch`` (1 = recovered); the
  straggler governor that proposes it is not ported yet (ROADMAP queue 1,
  slice G);
- ``tuner``: :class:`KnobController` below proposes absolute knob values;
- ``elastic``: a trainer's world-change rescale records its verdict for
  provenance (the lr schedule stays the trainer's).

Composition precedence (highest first): the straggler stretch, the tuner's
absolute overrides, the schedule's factors, the construction-time base.
The arbiter applies the composed result once a change, rebasing the
staggered cohorts and firing the trainers' invalidators at most once, and
adopts a direct external write as the new base instead of clobbering it.

**The tuner** (:class:`KnobController`) is the online policy: fed measured
per-step wall times attributed by phase set (``step_fn.last_phases``, the
taxonomy ``utils.PhaseTimers`` uses, or a deterministic synthetic feed in
tests), it hill-climbs the bounded knob ladder (frequency doublings and
halvings, the fp32 -> bf16 -> int8 wire, the decomposition and capture
rungs, the comm mode) one probe window at a time, with hysteresis (dwell
windows after a commit, cooldown after a revert). Before any measurement it
seeds from ``perfmodel`` priors. An improving candidate must pass the
``obs.drift`` band gate: on the card the perf model describes (an H100) a
measured phase outside the [optimistic, conservative] band vetoes it;
elsewhere the gate is advisory. Decisions emit trace instants, resilience
counters, log lines in JAX's wording (the ``kfac-obs`` event grammar) and an
append-only JSONL decision log.

Stdlib only at import (the port's collectives, trace, drift, perfmodel and
resilience bridges are imported where used).
"""

import contextlib
import json
import os
import threading
import time
from collections import deque

#: the preconditioner attributes the arbiter owns. Nothing else in the port
#: assigns these on a KFAC outside its constructor and ``replan``
#: (tests/test_torch_autotune.py's AST check). Committing ``comm_mode``
#: queues a ``KFAC.request_replan``: the trainer rebuilds the plan and
#: carries the state between steps.
KNOB_ATTRS = ('fac_update_freq', 'kfac_update_freq', 'damping',
              'comm_precision', 'decomp_impl', 'comm_mode',
              'capture_impl')

#: the wire-dtype ladder the tuner climbs (collectives.WIRE_DTYPES order)
COMM_PRECISIONS = ('fp32', 'bf16', 'int8')

#: the two comm-mode roads of one factor layout: gather decompositions once
#: per refresh vs gather preconditioned gradients every step. The analytic
#: ``decide_comm_mode`` verdict seeds which road is probed first.
COMM_MODES = ('inverse', 'pred')

#: the decomposition ladder: per method, the cold kernel vs its warm
#: iterative replacement. Restates preconditioner.DECOMP_IMPLS (this module
#: stays stdlib-importable; agreement pinned by test).
DECOMP_IMPLS = ('xla', 'auto', 'jacobi', 'subspace', 'newton_schulz')
DECOMP_LADDERS = {'eigh': ('xla', 'subspace'),
                  'cholesky': ('xla', 'newton_schulz')}

#: the capture ladder: the plain path ('xla') vs the capture kernels
#: ('pallas': K1/K2, with the EMA in their epilogue). Restates
#: preconditioner.CAPTURE_IMPLS (agreement pinned by test).
CAPTURE_IMPLS = ('xla', 'pallas', 'auto')
CAPTURE_LADDER = ('xla', 'pallas')

#: arbiter knob -> the trainer flag (``--kfac-*`` dest) a relaunch carries
#: it back through. ``damping`` is absent: the trainers' ``--damping`` is
#: not a kfac_* knob and the schedule owns its decay.
ADOPTED_KNOB_FLAGS = {
    'fac_update_freq': 'kfac_cov_update_freq',
    'kfac_update_freq': 'kfac_update_freq',
    'comm_precision': 'kfac_comm_precision',
    'decomp_impl': 'kfac_decomp_impl',
    'comm_mode': 'kfac_comm_mode',
    'capture_impl': 'kfac_capture_impl',
}

#: the adopted-knob snapshot filename (written next to the decision log; a
#: relaunch reads it to resume at the tuned knobs)
ADOPTED_KNOBS_FILENAME = 'adopted-knobs.json'

_APPLYING = threading.local()


def in_apply():
    """True while the arbiter is writing knobs (the setattr-guard hook
    tests use to prove nothing else writes them)."""
    return getattr(_APPLYING, 'depth', 0) > 0


@contextlib.contextmanager
def _applying():
    _APPLYING.depth = getattr(_APPLYING, 'depth', 0) + 1
    try:
        yield
    finally:
        _APPLYING.depth -= 1


def _capture(precond):
    """Current knob values of ``precond`` (missing attrs -> None: tests
    drive plain stand-ins with only some of the knob attributes)."""
    return {
        'fac_update_freq': getattr(precond, 'fac_update_freq', None),
        'kfac_update_freq': getattr(precond, 'kfac_update_freq', None),
        'damping': getattr(precond, 'damping', None),
        'comm_precision': getattr(precond, 'comm_precision', None),
        'decomp_impl': getattr(precond, 'decomp_impl', None),
        'comm_mode': getattr(precond, 'comm_mode', None),
        'capture_impl': getattr(precond, 'capture_impl', None),
    }


def arbiter_for(precond):
    """The one :class:`KnobArbiter` of ``precond`` (created on first
    use, stored on the instance). Every knob mutation in the port goes
    through this accessor."""
    arb = getattr(precond, '_knob_arbiter', None)
    if arb is None:
        arb = KnobArbiter(precond)
        precond._knob_arbiter = arb
    return arb


class KnobArbiter:
    """Single writer of a preconditioner's runtime knobs.

    Proposers call :meth:`propose` with their slice of intent; the
    arbiter recomposes the effective knob set and applies it once.
    Thread-safe (a proposer may run on another thread than the
    trainer's).
    """

    def __init__(self, precond, log=None):
        self.precond = precond
        self._lock = threading.RLock()
        self.base = _capture(precond)
        self.schedule = {'freq_factor': 1.0, 'damping_factor': 1.0}
        self.stretch = 1
        self.tuner = {}          # absolute overrides (freqs, comm_precision)
        self.records = []        # provenance-only proposals (elastic)
        self._applied = None     # what WE last wrote (external-write check)
        self._invalidators = []  # run when a trace-affecting knob changes
        self.changes = 0

    # -- wiring ------------------------------------------------------------

    def add_invalidator(self, fn):
        """Register a callback run when a TRACE-affecting knob changes
        (``comm_precision``, ``decomp_impl``, ``comm_mode``,
        ``capture_impl``, and every replan that changes the step):
        ``training.build_train_step`` registers its
        invalidator here: its next step re-derives the decomposition
        record and decomposes cold. Frequency/damping changes do NOT
        invalidate — they are host-side gating and a scalar."""
        if fn not in self._invalidators:
            self._invalidators.append(fn)
        return fn

    # -- proposals ---------------------------------------------------------

    def adopt_external(self):
        """Detect a direct (non-arbiter) write of the knob attributes
        and adopt the externally-written values — the external writer
        is authoritative for the knobs it touched, and ONLY those: an
        in-force schedule factor or straggler stretch on the untouched
        knobs survives. Adopted bases divide out the live schedule
        factor, so a later epoch advance applies its (cumulative)
        factor INCREMENTALLY from the external value instead of
        re-decaying an already-decayed base. An external frequency
        write supersedes the stretch (the written cadence is the new
        unstretched base; a straggler proposer restarts its ladder from
        it when this returns True). Returns True when an adoption
        happened."""
        with self._lock:
            if self._applied is None:
                return False
            cur = _capture(self.precond)
            changed = [k for k in KNOB_ATTRS if cur[k] != self._applied[k]]
            if not changed:
                return False
            if ('fac_update_freq' in changed
                    or 'kfac_update_freq' in changed):
                f = self.schedule['freq_factor'] or 1.0
                for k in ('fac_update_freq', 'kfac_update_freq'):
                    self.tuner.pop(k, None)
                    self.base[k] = (None if cur[k] is None
                                    else cur[k] / f)
                self.stretch = 1
            if 'damping' in changed:
                self.tuner.pop('damping', None)
                d = self.schedule['damping_factor'] or 1.0
                self.base['damping'] = (None if cur['damping'] is None
                                        else cur['damping'] / d)
            if 'comm_precision' in changed:
                self.tuner.pop('comm_precision', None)
                self.base['comm_precision'] = cur['comm_precision']
            if 'decomp_impl' in changed:
                self.tuner.pop('decomp_impl', None)
                self.base['decomp_impl'] = cur['decomp_impl']
            if 'comm_mode' in changed:
                self.tuner.pop('comm_mode', None)
                self.base['comm_mode'] = cur['comm_mode']
            if 'capture_impl' in changed:
                self.tuner.pop('capture_impl', None)
                self.base['capture_impl'] = cur['capture_impl']
            self._applied = cur
            return True

    def sync_knobs(self, **values):
        """Re-base knobs an AUTHORITATIVE external path just wrote —
        ``KFAC.replan`` calls this after swapping ``comm_mode``, so the
        rebuilt plan's mode becomes the arbiter's base instead of being
        detected (and re-adopted) as a foreign write on the next
        proposal. Tuner overrides for the synced knobs are kept only if
        they match the new value (a direct replan supersedes a stale
        override the same way an external freq write supersedes the
        stretch)."""
        with self._lock:
            for k, v in values.items():
                if k not in KNOB_ATTRS:
                    raise KeyError(f'unknown knob {k!r}')
                self.base[k] = v
                if self.tuner.get(k, v) != v:
                    self.tuner.pop(k, None)
            if self._applied is not None:
                self._applied.update(values)

    def invalidate(self):
        """Run the registered invalidators once (the replan path fires
        them through here; knob commits fire them in :meth:`_commit`). A
        failing invalidator must never block the change.
        """
        for fn in list(self._invalidators):
            try:
                fn()
            except Exception:  # noqa: BLE001
                pass

    def propose(self, source, **kw):
        """Fold one proposer's intent in and apply the composed knobs.

        ``source``: 'schedule' (``freq_factor=``, ``damping_factor=``),
        'straggler' (``stretch=`` int, 1 = recovered), 'tuner'
        (absolute ``fac_update_freq=`` / ``kfac_update_freq=`` /
        ``comm_precision=``; a None value clears that override), or
        'elastic' (free-form provenance record — composes nothing).
        Returns the dict of knob values now in force.
        """
        with self._lock:
            self.adopt_external()
            if source == 'schedule':
                if 'freq_factor' in kw:
                    self.schedule['freq_factor'] = float(kw['freq_factor'])
                if 'damping_factor' in kw:
                    self.schedule['damping_factor'] = \
                        float(kw['damping_factor'])
            elif source == 'straggler':
                self.stretch = max(1, int(kw.get('stretch', 1)))
            elif source == 'tuner':
                for k, v in kw.items():
                    if k not in KNOB_ATTRS:
                        raise KeyError(f'unknown tuner knob {k!r} '
                                       f'(knobs: {KNOB_ATTRS})')
                    if v is None:
                        self.tuner.pop(k, None)
                    else:
                        self.tuner[k] = v
            elif source == 'elastic':
                self.records.append(dict(kw))
            else:
                raise KeyError(f'unknown proposer {source!r}')
            return self._commit(source)

    # -- composition + the one write ---------------------------------------

    def _effective(self):
        eff = {}
        f = self.schedule['freq_factor']
        for k in ('fac_update_freq', 'kfac_update_freq'):
            if self.base[k] is None:
                eff[k] = None
                continue
            # tuner absolute override replaces base x schedule (the
            # schedule part keeps the reference's int() truncation —
            # kfac_preconditioner_base.py:295-301); the straggler
            # stretch multiplies either: a host emergency composes on
            # top of whatever cadence is in force
            v = (self.tuner[k] if k in self.tuner
                 else max(1, int(self.base[k] * f)))
            eff[k] = max(1, int(v) * self.stretch)
        if 'damping' in self.tuner:
            eff['damping'] = float(self.tuner['damping'])
        else:
            eff['damping'] = (None if self.base['damping'] is None else
                              self.base['damping']
                              * self.schedule['damping_factor'])
        eff['comm_precision'] = self.tuner.get(
            'comm_precision', self.base['comm_precision'])
        eff['decomp_impl'] = self.tuner.get(
            'decomp_impl', self.base['decomp_impl'])
        eff['comm_mode'] = self.tuner.get(
            'comm_mode', self.base['comm_mode'])
        eff['capture_impl'] = self.tuner.get(
            'capture_impl', self.base['capture_impl'])
        return eff

    def _commit(self, source):
        eff = self._effective()
        cur = _capture(self.precond)
        changed = [k for k in KNOB_ATTRS
                   if eff[k] is not None and eff[k] != cur[k]]
        if not changed:
            self._applied = _capture(self.precond)
            return eff
        if 'comm_precision' in changed:
            # validate BEFORE writing — an unknown wire dtype must not
            # land on the preconditioner half-applied
            try:
                from kfac_pytorch_tpu_torch.parallel import collectives as _coll
                _coll.check_wire_dtype(eff['comm_precision'])
            except ImportError:  # pragma: no cover — torch-free context
                pass
        if ('decomp_impl' in changed
                and eff['decomp_impl'] not in DECOMP_IMPLS):
            raise ValueError(
                f'decomp_impl must be one of {DECOMP_IMPLS}, '
                f'got {eff["decomp_impl"]!r}')
        if ('capture_impl' in changed
                and eff['capture_impl'] not in CAPTURE_IMPLS):
            raise ValueError(
                f'capture_impl must be one of {CAPTURE_IMPLS}, '
                f'got {eff["capture_impl"]!r}')
        if 'comm_mode' in changed:
            if eff['comm_mode'] not in COMM_MODES:
                raise ValueError(f'comm_mode must be one of {COMM_MODES}, '
                                 f'got {eff["comm_mode"]!r}')
            if (eff['comm_mode'] == 'pred'
                    and getattr(self.precond, 'comm_prefetch', False)):
                # mirror replan's combination rule SYNCHRONOUSLY — a
                # deferred failure would land inside the next train
                # step with the knob already written against the old
                # plan
                raise ValueError(
                    "cannot propose comm_mode='pred' with comm_prefetch "
                    'in force: the pred gather IS the step consumer and '
                    'cannot be deferred')
        with _applying():
            for k in changed:
                setattr(self.precond, k, eff[k])
        if ('fac_update_freq' in changed or 'kfac_update_freq' in changed):
            # staggered cohort layout derives from kfac_update_freq:
            # rebase ONCE per composed change (no-op when off/unchanged)
            rebase = getattr(self.precond, 'rebase_cohorts', None)
            if rebase is not None:
                rebase()
        if 'comm_mode' in changed:
            # the applied switch: the new mode needs a new FactorPlan
            # and a state swap the arbiter cannot perform (the state
            # lives in the trainer) — queue a replan the trainer applies
            # between steps. The invalidators fire HERE, once (the
            # queued replan carries _invalidate=False).
            request = getattr(self.precond, 'request_replan', None)
            if request is not None:
                request(comm_mode=eff['comm_mode'], _invalidate=False)
        if ('comm_precision' in changed or 'decomp_impl' in changed
                or 'comm_mode' in changed or 'capture_impl' in changed):
            # the wire dtype, the decomposition kernel and the capture
            # kernels change what a step computes (comm_precision also
            # the error-feedback residual, which the step re-seeds or
            # drops on its next call; comm_mode the whole collective
            # schedule): every attached step's next full decomposition
            # goes cold
            self.invalidate()
        self.changes += 1
        self._applied = _capture(self.precond)
        try:
            from kfac_pytorch_tpu_torch.obs import trace as _trace
            _trace.instant('knob_change', cat='autotune', source=source,
                           **{k: eff[k] for k in changed})
        except Exception:  # noqa: BLE001 — tracing never blocks a knob
            pass
        return eff


# ---------------------------------------------------------------------------
# the online tuner
# ---------------------------------------------------------------------------

#: PhaseTimers host labels -> exclude-parts ledger taxonomy, restated
#: lazily from obs.trace (stdlib) inside the converter below.


def _taxonomy_seconds(marginals):
    """{'decomp+gather': s} host labels -> ledger taxonomy names
    ('ComputeInverse+CommunicateInverse'), matching
    ``obs.drift.measured_from_phase_timers`` semantics (seconds in,
    seconds out)."""
    from kfac_pytorch_tpu_torch.obs.trace import PHASE_TAXONOMY
    out = {}
    for label, s in marginals.items():
        if label in ('step_mean', 'step_max'):
            out[label] = s
        else:
            out['+'.join(PHASE_TAXONOMY.get(p, p)
                         for p in label.split('+'))] = s
    return out


def _robust_mean(samples):
    """Mean with >3x-median outliers dropped — host noise (a GC pause,
    a page fault) must not masquerade as a knob effect. Applied PER
    phase set, so a refresh step's legitimate spike is judged against
    other refresh steps, never discarded against cheap steady steps."""
    s = sorted(samples)
    med = s[len(s) // 2]
    good = [x for x in samples if x <= 3 * med] or samples
    return sum(good) / len(good)


def _marginals(means):
    """Per-phase marginal seconds by subtraction between observed phase
    sets — the same derivation ``utils.metrics.PhaseTimers.epoch_flush``
    uses (restated here so the controller stays stdlib-importable).
    ``means``: {frozenset(phases): mean seconds}."""
    out = {}
    for s in sorted(means, key=lambda k: (len(k), sorted(k))):
        bases = [b for b in means if b < s]
        if bases:
            base = max(bases, key=lambda b: (len(b), tuple(sorted(b))))
            label = '+'.join(sorted(s - base))
            val = max(means[s] - means[base], 0.0)
        else:
            label = '+'.join(sorted(s)) if s else 'step'
            val = means[s]
        if label and label not in out:
            out[label] = val
    return out


def _agree_max(precond, values):
    """``values`` (floats, None for no value) replaced by their largest
    over the preconditioner's process group (a float64 all-reduce), where
    it has one. At world > 1 each rank runs its own tuner on its own
    clock: judging the ranks' largest window times and health counters
    keeps their decisions, and so their knobs, equal step for step (a
    rank that committed a comm mode another reverted would mismatch
    their collectives). A value that is None on every rank stays None.
    Every rank must call it at the same point."""
    group = getattr(precond, 'group', None)
    import torch.distributed as dist
    if (not isinstance(group, dist.ProcessGroup)
            or dist.get_world_size(group) == 1):
        return list(values)
    import torch
    dev = 'cuda' if dist.get_backend(group) == 'nccl' else 'cpu'
    buf = torch.tensor([float('-inf') if v is None else float(v)
                        for v in values], dtype=torch.float64, device=dev)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return [None if v == float('-inf') else v for v in buf.tolist()]


def _writes_files():
    """Only the first process writes the decision log and
    ``adopted-knobs.json``: every rank holds the same decisions (see
    :func:`_agree_max`) and shares the trace directory."""
    from kfac_pytorch_tpu_torch.utils.runlog import process_index
    return process_index() == 0


def _mode_switch_keeps_layout(precond, mode):
    """Would a replan to ``mode`` keep the row layout (the verbatim
    in-place carry)? Mirrors replan's distribute resolution: pred
    always collapses the factor-wise split; a non-pred target
    re-resolves the eigen/ekfac auto rule for the current world."""
    if mode == 'pred':
        target = False
    else:
        dl = getattr(precond, 'distribute_layer_factors', None)
        if dl is None and getattr(precond, 'variant', '') in ('eigen',
                                                              'ekfac'):
            plan = getattr(precond, 'plan', None)
            target = (plan is not None
                      and getattr(precond, 'num_devices', 1)
                      > len(plan.metas))
        else:
            target = bool(dl)
    return target == bool(getattr(precond, '_distributed', False))


def comm_mode_bytes(plan, method, comm_precision='fp32'):
    """Analytic collective bytes of the two comm modes under ``plan``'s
    layout: ``{'inverse': bytes per REFRESH, 'pred': bytes per STEP}``.
    Both roads come from ``plan.comm_volume`` (the ledger-pinned single
    source of truth for wire bytes) via its ``comm_mode`` override —
    the tuner never restates the byte formulas. Returns None when the
    layout carries no collective payload."""
    try:
        inverse = plan.comm_volume(
            stats_reduce='none', method=method,
            comm_precision=comm_precision,
            comm_mode='inverse')['InverseComm']
        pred = plan.comm_volume(
            stats_reduce='none', method=method,
            comm_precision=comm_precision, comm_mode='pred')['PredComm']
    except Exception:  # noqa: BLE001 — advisory only, never blocks
        return None
    if not pred and not inverse:
        return None
    return {'inverse': inverse, 'pred': pred}


def decide_comm_mode(bytes_by_mode, kfac_update_freq):
    """Cheaper comm mode by amortized per-step collective bytes:
    comm_inverse ships its gather once per ``kfac_update_freq`` steps,
    comm_pred ships preconditioned gradients every step. Returns
    ('inverse'|'pred', per_step_bytes dict)."""
    per_step = {
        'inverse': bytes_by_mode['inverse'] / max(1, int(kfac_update_freq)),
        'pred': float(bytes_by_mode['pred']),
    }
    return min(per_step, key=per_step.get), per_step


def prior_best_freq(predicted, variant, ladder, fac_update_freq=1,
                    anchor='central', slack=0.02, decomp_impl=None):
    """Seed ``kfac_update_freq`` from the analytic perf model before any
    measurement exists. Predicted steady step time (model + precondition
    + factor/fac_freq + decomposition/F) is monotone in F — amortizing
    more is never slower — so "fastest" alone would always pick the
    ladder top and needlessly stale the preconditioner. The prior is
    therefore the SMALLEST ladder value within ``slack`` (2%) of the
    asymptotic steady time: maximum freshness once further stretching
    is perf noise. Returns None when the block carries no usable phases
    (the controller then starts from the configured value)."""
    try:
        from kfac_pytorch_tpu_torch.perfmodel import prior_phase_costs
        ph = prior_phase_costs(predicted, variant=variant, anchor=anchor,
                               decomp_impl=decomp_impl)
    except Exception:  # noqa: BLE001 — priors are best-effort
        return None
    if not ph:
        return None

    def steady(F):
        return (ph['model'] + ph['precondition']
                + ph['factor'] / max(1, fac_update_freq)
                + ph['decomp'] / F)

    floor = steady(max(ladder))
    for F in sorted(ladder):
        if steady(F) <= floor * (1.0 + slack):
            return F
    return max(ladder)


class KnobController:
    """Bounded online hill-climb over the runtime knob ladder.

    Feed it one measurement per host step — either through
    :meth:`tick` (inter-arrival timing on an injectable clock, the
    ``training.build_train_step(autotune=...)`` wiring) or directly
    through :meth:`record` (deterministic synthetic feeds in tests: no
    wall clock anywhere). Every ``window`` recorded steps form one
    probe window; the policy is:

    - establish a baseline for the committed config, then probe ONE
      neighboring knob value (frequency x2 / ÷2 within
      ``freq_bounds``, or the next wire dtype on the ladder);
    - commit the candidate only if its window beats the baseline by
      ``rel_improve`` AND the drift gate does not veto; otherwise
      revert and put that candidate on ``cooldown``;
    - after a commit, dwell ``dwell_windows`` windows before the next
      probe (hysteresis: no knob flap inside the dwell);
    - when every candidate is exhausted or cooling, enter STEADY state
      (re-probing only every ``steady_every`` windows — bounded probe
      budget by construction).

    Frequency tuning trades preconditioner freshness for step time —
    ``freq_bounds`` caps how far the tuner may move from the
    configured cadence (default: no lower than 1, no higher than 8x
    the starting value). The drift veto consults
    ``obs.drift.drift_block`` over the window's per-phase marginals:
    verdict 'drift' (only possible on the modeled chip) rejects the
    candidate; elsewhere the gate is advisory and violations are only
    counted. While a straggler stretch is in force the controller
    discards windows — a host emergency is not a tuning signal.
    With a process group every rank's tuner judges the ranks' largest
    window time and health counter (:func:`_agree_max`), so all commit
    and revert together; the first process alone writes the artifacts.
    """

    def __init__(self, precond, *, window=16, settle=2, rel_improve=0.03,
                 dwell_windows=2, cooldown=6, steady_every=50,
                 tune=('kfac_update_freq', 'fac_update_freq',
                       'comm_precision', 'decomp_impl', 'comm_mode',
                       'capture_impl'),
                 freq_bounds=None, comm_precisions=COMM_PRECISIONS,
                 predicted=None, platform=None, variant=None,
                 anchor='central', decision_log=None, log=None,
                 clock=time.monotonic, quality_gate=None):
        if window < 2:
            raise ValueError(f'window must be >= 2, got {window}')
        self.precond = precond
        self.arbiter = arbiter_for(precond)
        self.window = int(window)
        self.settle = int(settle)
        self.rel_improve = float(rel_improve)
        self.dwell_windows = int(dwell_windows)
        self.cooldown = int(cooldown)
        self.steady_every = int(steady_every)
        self.tune = tuple(tune)
        kf0 = int(getattr(precond, 'kfac_update_freq', 1) or 1)
        self.freq_bounds = (tuple(freq_bounds) if freq_bounds
                            else (1, max(8, kf0 * 8)))
        self.comm_precisions = tuple(comm_precisions)
        self.predicted = predicted
        self.platform = platform
        self.variant = variant or getattr(precond, 'variant', 'inverse_dp')
        self.anchor = anchor
        # numerical-health gate: a zero-arg callable returning a
        # monotone "badness" counter (e.g. the HealthMonitor's skipped-
        # batch + escalation total). Sampled when a probe starts and
        # when it is judged: an otherwise-improving candidate whose
        # probe window raised the counter is VETOED — a knob rung that
        # regresses accuracy (NS residual-gate fallbacks manifest as
        # health events) can never commit on speed alone. None = no
        # gate (the engine's per-row acceptance gates still protect the
        # math; this gate protects the TUNING DECISION).
        self.quality_gate = quality_gate
        self._probe_quality = None
        self.quality_vetoes = 0
        self.decision_log = decision_log
        import logging
        self.log = log if log is not None else logging.getLogger(__name__)
        self.clock = clock
        # measurement state
        self._acc = {}          # frozenset(phases) -> [seconds, ...]
        self._n = 0
        self._settle_left = self.settle
        self._last = None
        self._step = -1
        # policy state
        self.state = 'baseline'
        self.baseline_t = None
        self.windows = 0
        self._candidate = None      # (knob, old, new)
        self._cooldowns = {}        # (knob, value) -> retry-at window idx
        self._rotation = 0
        self._dwell_left = 0
        self._steady_since = None
        self._seeded = 'seed' if predicted is not None else 'done'
        self.comm_mode_choice = None
        # counters / artifacts
        self.commits = 0
        self.reverts = 0
        self.vetoes = 0
        self.advisory_violations = 0
        self.decisions = deque(maxlen=256)
        self.last_window = None

    # -- feeds -------------------------------------------------------------

    def tick(self, step=None, phases=()):
        """Inter-arrival feed (the trainer wiring): measures the time
        since the previous tick — the full host step, blocking metric
        read included — and attributes it to the phase set of the
        dispatch that interval covered. ``build_train_step`` ticks at
        the top of ``step_fn``, BEFORE this step's dispatch updates
        ``step_fn.last_phases`` — so the ``phases`` argument still
        names the previous dispatch, which is exactly the one the
        just-ended interval timed."""
        now = self.clock()
        if self._last is not None:
            self.record(tuple(phases), now - self._last, step=step)
        self._last = now

    def record(self, phases, seconds, step=None):
        """One measured step. ``phases`` is the host phase set
        ('pred'/'stats'/'decomp'/'gather'); ``seconds`` its wall time.
        Deterministic by construction — no clock is read here."""
        self._step = int(step) if step is not None else self._step + 1
        if self._seeded == 'seed':
            self._seed()
        if self._settle_left > 0:
            # post-change settle: the first steps of a fresh knob set
            # (a cold decomposition, first launches) must not pollute
            # the window
            self._settle_left -= 1
            return
        if self.arbiter.stretch != 1:
            # straggler emergency in force: not a tuning signal
            self._reset_window()
            return
        self._acc.setdefault(frozenset(phases), []).append(float(seconds))
        self._n += 1
        if self._n >= self.window:
            self._window_done()

    # -- seeding -----------------------------------------------------------

    def _freq_ladder(self):
        lo, hi = self.freq_bounds
        ladder, v = [], max(1, int(lo))
        while v <= hi:
            ladder.append(v)
            v *= 2
        return ladder or [max(1, int(lo))]

    def _seed(self):
        self._seeded = 'done'
        # kernels first: the freq prior prices the decomposition phase
        # at the kernel the run will actually execute
        self._seed_decomp_impl()
        self._seed_capture_impl()
        self._seed_freq()

    def _seed_freq(self):
        if 'kfac_update_freq' not in self.tune:
            return
        best = prior_best_freq(
            self.predicted, self.variant, self._freq_ladder(),
            fac_update_freq=getattr(self.precond, 'fac_update_freq', 1)
            or 1, anchor=self.anchor,
            decomp_impl=getattr(self.precond, 'decomp_impl', None))
        cur = getattr(self.precond, 'kfac_update_freq', None)
        if best is None or cur is None or best == cur:
            return
        self.arbiter.propose('tuner', kfac_update_freq=best)
        self._decision('seed', knob='kfac_update_freq', frm=cur, to=best)
        self.log.info('autotune: seeded kfac_update_freq=%d from '
                      'perfmodel prior (%s)', best, self.anchor)
        self._instant('autotune_seed', kfac_update_freq=best)
        self._settle_left = self.settle
        # the seeded value becomes the config the first baseline measures

    def _seed_decomp_impl(self):
        """Seed the decomposition-kernel rung from the perf model's
        GEMM-roofline priors (perfmodel.decomp_impl_priors): when the
        iterative kernel's predicted decomposition phase undercuts the
        cold kernel's, start there — the fenced eigh constants say the
        gap is seconds-per-refresh on the modeled chip, too expensive
        to discover by probing alone."""
        if 'decomp_impl' not in self.tune:
            return
        cur = getattr(self.precond, 'decomp_impl', None)
        method = getattr(self.precond, 'method', None)
        if cur is None or method not in DECOMP_LADDERS:
            return
        try:
            from kfac_pytorch_tpu_torch.perfmodel import decomp_impl_priors
            priors = decomp_impl_priors(self.predicted, method,
                                        anchor=self.anchor)
        except Exception:  # noqa: BLE001 — priors are best-effort
            return
        if not priors:
            return
        best = min(priors, key=priors.get)
        eff = (DECOMP_LADDERS[method][1] if cur == 'auto' else cur)
        if best == eff:
            return
        self.arbiter.propose('tuner', decomp_impl=best)
        self._decision('seed', knob='decomp_impl', frm=cur, to=best,
                       prior_s=priors)
        self.log.info('autotune: seeded decomp_impl=%s from perfmodel '
                      'prior (%s)', best, self.anchor)
        self._instant('autotune_seed', decomp_impl=best)
        self._settle_left = self.settle

    def _seed_capture_impl(self):
        """Seed the capture-kernel rung from the perf model's fusion
        priors (perfmodel.capture_impl_priors): when the capture
        kernels' predicted ComputeFactor phase undercuts the plain
        path's, start there — the win is the skipped patch matrix and
        the folded EMA epilogue, which the roofline prices without a
        probe."""
        if 'capture_impl' not in self.tune:
            return
        cur = getattr(self.precond, 'capture_impl', None)
        if cur is None:
            # None = the legacy capture path AND the rung hidden from
            # the tuner (preconditioner.CAPTURE_IMPLS contract)
            return
        try:
            from kfac_pytorch_tpu_torch.perfmodel import capture_impl_priors
            priors = capture_impl_priors(self.predicted,
                                         anchor=self.anchor)
        except Exception:  # noqa: BLE001 — priors are best-effort
            return
        if not priors:
            return
        best = min(priors, key=priors.get)
        eff = (CAPTURE_LADDER[1] if cur == 'auto' else cur)
        if best == eff:
            return
        self.arbiter.propose('tuner', capture_impl=best)
        self._decision('seed', knob='capture_impl', frm=cur, to=best,
                       prior_s=priors)
        self.log.info('autotune: seeded capture_impl=%s from perfmodel '
                      'prior (%s)', best, self.anchor)
        self._instant('autotune_seed', capture_impl=best)
        self._settle_left = self.settle

    # -- the window --------------------------------------------------------

    def _reset_window(self):
        self._acc, self._n = {}, 0
        self._settle_left = self.settle

    def _window_done(self):
        # the objective: mean step seconds over the window, with the
        # outlier screen applied per phase set (a refresh step's real
        # spike is weighed at its true frequency; host noise is not)
        means = {k: _robust_mean(v) for k, v in self._acc.items()}
        n = sum(len(v) for v in self._acc.values())
        t = sum(means[k] * len(v) for k, v in self._acc.items()) / n
        measured = _taxonomy_seconds(_marginals(means))
        # every rank judges the slowest rank's window, so all take the
        # same decision on the same step
        keys = sorted(measured)
        agreed = _agree_max(self.precond,
                            [t] + [measured[k] for k in keys])
        t, measured = agreed[0], dict(zip(keys, agreed[1:]))
        self.windows += 1
        self.last_window = {'window': self.windows, 'time_s': t,
                            'measured': measured,
                            'knobs': _capture(self.precond)}
        self._reset_window()
        if self.state == 'baseline':
            self.baseline_t = t
            self._maybe_comm_mode(measured)
            self._next_probe()
        elif self.state == 'probe':
            self._judge(t, measured)
        elif self.state == 'dwell':
            self.baseline_t = t  # track drift of the committed config
            self._dwell_left -= 1
            if self._dwell_left <= 0:
                self._next_probe()
        elif self.state == 'steady':
            self.baseline_t = t
            if (self.steady_every
                    and self.windows - self._steady_since
                    >= self.steady_every):
                self._cooldowns.clear()
                self._next_probe()

    # -- candidates --------------------------------------------------------

    def _candidates(self):
        out = []
        lo, hi = self.freq_bounds
        for knob in self.tune:
            if knob in ('kfac_update_freq', 'fac_update_freq'):
                cur = getattr(self.precond, knob, None)
                if cur is None:
                    continue
                if cur * 2 <= hi:
                    out.append((knob, cur, cur * 2))
                if cur // 2 >= lo and cur // 2 != cur:
                    out.append((knob, cur, cur // 2))
            elif knob == 'comm_precision':
                cur = getattr(self.precond, 'comm_precision', None)
                # wire compression only exists where collectives exist
                if cur is None or getattr(self.precond, 'group',
                                          None) is None:
                    continue
                i = self.comm_precisions.index(cur) \
                    if cur in self.comm_precisions else 0
                if i + 1 < len(self.comm_precisions):
                    out.append((knob, cur, self.comm_precisions[i + 1]))
                if i > 0:
                    out.append((knob, cur, self.comm_precisions[i - 1]))
            elif knob == 'decomp_impl':
                # the inverse-free ladder: per-method cold kernel vs
                # its warm iterative replacement. Tunable only when the
                # knob was EXPLICITLY configured (None = the legacy
                # KFAC_EIGH_IMPL env contract, which the tuner must not
                # silently take over) on a real preconditioner (fake
                # knob-only stand-ins carry no method)
                cur = getattr(self.precond, 'decomp_impl', None)
                method = getattr(self.precond, 'method', None)
                ladder = DECOMP_LADDERS.get(method)
                if cur is None or ladder is None:
                    continue
                # 'auto' sits on the method's warm rung
                eff = ladder[1] if cur == 'auto' else cur
                out.extend((knob, cur, v) for v in ladder if v != eff)
            elif knob == 'capture_impl':
                # the capture ladder: method-independent — every
                # factor kind has a kernel — but tunable only when the
                # knob was EXPLICITLY configured (None = the plain
                # capture path, which the tuner must not silently take
                # over)
                cur = getattr(self.precond, 'capture_impl', None)
                if cur is None:
                    continue
                # 'auto' sits on the fused rung
                eff = CAPTURE_LADDER[1] if cur == 'auto' else cur
                out.extend((knob, cur, v) for v in CAPTURE_LADDER
                           if v != eff)
            elif knob == 'comm_mode':
                # the applied comm-mode switch: probeable only where
                # the replan path exists — a set-up preconditioner with
                # a process group that can rebuild its plan. ekfac is
                # excluded (its scale moments are comm-mode shaped and
                # would re-accumulate across every probe), and the pred
                # road is unreachable under comm_prefetch (the pred
                # gather IS the step consumer).
                cur = getattr(self.precond, 'comm_mode', None)
                if (cur not in COMM_MODES
                        or getattr(self.precond, 'group', None) is None
                        or getattr(self.precond, 'plan', None) is None
                        or getattr(self.precond, 'ekfac', False)
                        or not callable(getattr(self.precond,
                                                'request_replan', None))):
                    continue
                for v in COMM_MODES:
                    if v == cur:
                        continue
                    if v == 'pred' and getattr(self.precond,
                                               'comm_prefetch', False):
                        continue
                    if not _mode_switch_keeps_layout(self.precond, v):
                        # a switch that re-resolves the factor
                        # distribution (distributed eigen -> pred
                        # collapses ownership; pred-start eigen ->
                        # inverse can re-distribute) is a row-layout
                        # rebuild with a host-side state transport,
                        # not the verbatim in-place switch a probe can
                        # afford — the tuner only probes
                        # layout-preserving switches
                        continue
                    out.append((knob, cur, v))
        # the analytic comm-mode verdict is a SEEDED PRIOR, not an
        # applied decision: when it disagrees with the current mode,
        # its candidate probes first — the measured window still
        # decides the commit
        if self.comm_mode_choice is not None:
            pri = [c for c in out if c[0] == 'comm_mode'
                   and c[2] == self.comm_mode_choice]
            if pri:
                out = pri + [c for c in out if c not in pri]
        return out

    def _next_probe(self):
        cands = self._candidates()
        for i in range(len(cands)):
            knob, old, new = cands[(self._rotation + i) % len(cands)]
            if self._cooldowns.get((knob, new), 0) > self.windows:
                continue
            self._rotation = (self._rotation + i + 1) % max(1, len(cands))
            self._candidate = (knob, old, new)
            self._probe_quality = self._quality()
            self.arbiter.propose('tuner', **{knob: new})
            self.state = 'probe'
            self._decision('probe', knob=knob, frm=old, to=new)
            self.log.info('autotune: probing %s %s -> %s at step %d '
                          '(window %d)', knob, old, new, self._step,
                          self.windows)
            self._instant('autotune_probe', knob=knob, to=str(new))
            return
        if self.state != 'steady':
            self.state = 'steady'
            self._steady_since = self.windows
            k = _capture(self.precond)
            self._decision('steady', knobs=k)
            self.log.info(
                'autotune: steady state — knobs fac=%d kfac=%d '
                'comm_precision=%s after %d windows at step %d',
                k['fac_update_freq'] or 0, k['kfac_update_freq'] or 0,
                k['comm_precision'] or 'fp32', self.windows, self._step)
            self._instant('autotune_steady', windows=self.windows)

    def _quality(self):
        """Sample the numerical-health gate counter (None = no gate /
        gate errored — an erroring gate must never take tuning down)."""
        if self.quality_gate is None:
            return None
        try:
            q = float(self.quality_gate())
        except Exception:  # noqa: BLE001
            q = None
        # the largest counter over the ranks: a health event on any rank
        # vetoes the probe on every rank
        return _agree_max(self.precond, [q])[0]

    def _judge(self, t, measured):
        knob, old, new = self._candidate
        improved = t < self.baseline_t * (1 - self.rel_improve)
        vetoed = improved and self._drift_veto(measured, knob, new)
        if improved and not vetoed:
            q0, q1 = self._probe_quality, self._quality()
            if q0 is not None and q1 is not None and q1 > q0:
                # the probe window regressed accuracy (health events
                # fired): a faster-but-wrong rung never commits
                vetoed = True
                self.vetoes += 1
                self.quality_vetoes += 1
                self._bump('autotune_vetoes')
                self._decision('veto', knob=knob, value=new,
                               reason='quality',
                               health_events=q1 - q0)
                self.log.warning(
                    'autotune: quality veto — knob %s %s rejected '
                    '(+%g health events in the probe window) at step '
                    '%d', knob, new, q1 - q0, self._step)
                self._instant('autotune_veto', knob=knob,
                              violations=['quality'])
        if improved and not vetoed:
            self.commits += 1
            self._bump('autotune_commits')
            gain = 100.0 * (1 - t / self.baseline_t)
            extra = {}
            if knob == 'comm_mode':
                # an APPLIED (not advisory) switch: the plan was rebuilt
                # and the state carried through KFAC.replan — the
                # decision-log grammar the acceptance criterion greps for
                extra['applied'] = True
            self._decision('commit', knob=knob, frm=old, to=new,
                           before_s=self.baseline_t, after_s=t, **extra)
            self.log.info(
                'autotune: committed %s %s -> %s (step time %.6fs -> '
                '%.6fs, -%.1f%%) at step %d', knob, old, new,
                self.baseline_t, t, gain, self._step)
            self._instant('autotune_commit', knob=knob, to=str(new))
            self.baseline_t = t
            self._candidate = None
            self.state = 'dwell'
            self._dwell_left = self.dwell_windows
        else:
            self.arbiter.propose('tuner', **{knob: old})
            self.reverts += 1
            self._bump('autotune_reverts')
            self._cooldowns[(knob, new)] = self.windows + self.cooldown
            if not vetoed:
                self._decision('revert', knob=knob, frm=new, to=old,
                               baseline_s=self.baseline_t, probe_s=t)
                self.log.info(
                    'autotune: reverted %s %s -> %s (no improvement: '
                    '%.6fs -> %.6fs) at step %d', knob, new, old,
                    self.baseline_t, t, self._step)
                self._instant('autotune_revert', knob=knob, to=str(old))
            self._candidate = None
            self._settle_left = self.settle
            self._next_probe()

    # -- gates -------------------------------------------------------------

    def _drift_veto(self, measured, knob, value):
        """The obs/drift band gate over this window's phase marginals.
        Verdict 'drift' — only reachable when the platform IS the chip
        the perf model describes — vetoes the candidate; on any other
        platform the gate is advisory (violations counted, commit
        allowed). No predicted block = no gate."""
        if not self.predicted:
            return False
        try:
            from kfac_pytorch_tpu_torch.obs import drift
            verdict, violations = drift.gate(
                {k: v for k, v in measured.items()
                 if k not in ('step_mean', 'step_max')},
                self.predicted, platform=self.platform,
                variant=self.variant, anchor=self.anchor,
                comm_precision=getattr(self.precond, 'comm_precision',
                                       'fp32') or 'fp32',
                # bind ComputeInverse to the kernel the probe actually
                # ran — without this, committing an iterative rung on
                # the modeled chip would land seconds under the fenced
                # full-eigh band and the gate would veto the very win
                # it exists to protect
                decomp_impl=getattr(self.precond, 'decomp_impl', None),
                # likewise bind ComputeFactor to the capture kernel the
                # probe actually ran — the fused band sits well under
                # the unfused one on the modeled chip
                capture_impl=getattr(self.precond, 'capture_impl', None),
                source='autotune')
            if verdict == 'drift':
                self.vetoes += 1
                self._bump('autotune_vetoes')
                self._decision('veto', knob=knob, value=value,
                               violations=violations)
                self.log.warning(
                    'autotune: drift veto — knob %s %s rejected '
                    '(violations=%s) at step %d', knob, value,
                    ','.join(violations), self._step)
                self._instant('autotune_veto', knob=knob,
                              violations=violations)
                return True
            if violations:
                self.advisory_violations += len(violations)
        except Exception:  # noqa: BLE001 — the gate must never take the
            return False   # trainer down; an error gate is no gate
        return False

    def _maybe_comm_mode(self, measured):
        """One-shot analytic comm-mode verdict from the layout's
        per-step collective bytes at the current cadence (comm_inverse
        amortizes its gather over kfac_update_freq steps; comm_pred
        ships preconditioned grads every step). This is the SEEDED
        PRIOR of a real knob, not an advisory log line: when
        the verdict disagrees with the running mode, ``_candidates``
        probes that mode first and the measured probe window decides —
        a commit rebuilds the plan live through ``KFAC.replan`` (the
        decision log then shows an *applied* comm_mode commit)."""
        if self.comm_mode_choice is not None:
            return
        plan = getattr(self.precond, 'plan', None)
        if plan is None or getattr(self.precond, 'group', None) is None:
            return
        vols = comm_mode_bytes(plan, getattr(self.precond, 'method', None),
                               getattr(self.precond, 'comm_precision',
                                       'fp32') or 'fp32')
        if not vols:
            return
        choice, per_step = decide_comm_mode(
            vols, getattr(self.precond, 'kfac_update_freq', 1) or 1)
        self.comm_mode_choice = choice
        self._decision('comm_mode', mode=choice, per_step_bytes=per_step,
                       current=getattr(self.precond, 'comm_mode', None))
        self.log.info(
            'autotune: comm_mode decision %s (inverse %.1f KiB/step vs '
            'pred %.1f KiB/step) at step %d', choice,
            per_step['inverse'] / 1024.0, per_step['pred'] / 1024.0,
            self._step)
        self._instant('autotune_comm_mode', mode=choice)

    # -- artifacts ---------------------------------------------------------

    def _decision(self, kind, **fields):
        d = {'kind': kind, 'window': self.windows, 'step': self._step}
        d.update(fields)
        self.decisions.append(d)
        if self.decision_log and _writes_files():
            try:
                dirn = os.path.dirname(self.decision_log)
                if dirn:
                    os.makedirs(dirn, exist_ok=True)
                with open(self.decision_log, 'a') as f:
                    f.write(json.dumps(d) + '\n')
            except OSError:
                pass
        if kind in ('seed', 'commit', 'revert'):
            # every knob movement refreshes the adopted snapshot, so a
            # relaunch always resumes at the latest tuned cadence
            self._export_adopted()
        return d

    def _export_adopted(self):
        """Snapshot the currently-adopted knobs as spec-grammar names
        (``adopted-knobs.json`` next to the decision log, the trainer
        flags' names): a relaunch that carries the values into its argv
        resumes at its tuned cadence instead of re-climbing the ladder
        from the submitted config."""
        if not self.decision_log or not _writes_files():
            return
        knobs = _capture(self.precond)
        doc = {flag: knobs[k] for k, flag in ADOPTED_KNOB_FLAGS.items()
               if knobs[k] is not None}
        path = os.path.join(os.path.dirname(self.decision_log) or '.',
                            ADOPTED_KNOBS_FILENAME)
        try:
            # read cross-process at relaunch: written atomically (lazy
            # import — this module stays stdlib-importable)
            from kfac_pytorch_tpu_torch.resilience import atomic_write_json
            atomic_write_json(path, doc, indent=2, sort_keys=True)
        except OSError:
            pass

    def _instant(self, name, **args):
        try:
            from kfac_pytorch_tpu_torch.obs import trace as _trace
            _trace.instant(name, cat='autotune', step=self._step, **args)
        except Exception:  # noqa: BLE001
            pass

    def _bump(self, name):
        try:
            from kfac_pytorch_tpu_torch import resilience as _res
            _res.counters.bump(name)
        except Exception:  # noqa: BLE001
            pass

    # -- reporting ---------------------------------------------------------

    def counts(self):
        """Counter dict in the resilience epoch-suffix shape (feeds the
        registry collector like ``StragglerGovernor.counts``)."""
        return {'autotune_commits': self.commits,
                'autotune_reverts': self.reverts,
                'autotune_vetoes': self.vetoes}

    def collect(self, registry):
        """``obs.metrics.Registry`` collector: current knob gauges +
        cumulative decision counters."""
        k = _capture(self.precond)
        for name in ('fac_update_freq', 'kfac_update_freq'):
            if k[name] is not None:
                registry.gauge('autotune/' + name).set(k[name])
        if k['decomp_impl'] is not None:
            # gauge by ladder index (0 = cold kernel, 1 = iterative)
            method = getattr(self.precond, 'method', None)
            ladder = DECOMP_LADDERS.get(method)
            if ladder:
                eff = ladder[1] if k['decomp_impl'] == 'auto' \
                    else k['decomp_impl']
                if eff in ladder:
                    registry.gauge('autotune/decomp_impl_rung').set(
                        ladder.index(eff))
        if k['capture_impl'] is not None:
            # gauge by ladder index (0 = the plain path, 1 = K1/K2)
            eff = CAPTURE_LADDER[1] if k['capture_impl'] == 'auto' \
                else k['capture_impl']
            if eff in CAPTURE_LADDER:
                registry.gauge('autotune/capture_impl_rung').set(
                    CAPTURE_LADDER.index(eff))
        try:
            from kfac_pytorch_tpu_torch.parallel.collectives import \
                WIRE_COMPRESSION
            if k['comm_precision'] in WIRE_COMPRESSION:
                registry.gauge('autotune/comm_wire_factor').set(
                    WIRE_COMPRESSION[k['comm_precision']])
        except ImportError:
            pass
        registry.counter('autotune/commits').set_total(self.commits)
        registry.counter('autotune/reverts').set_total(self.reverts)
        registry.counter('autotune/vetoes').set_total(self.vetoes)

    def report(self):
        """The ``autotune`` block for a benchmark's extras / smoke
        artifacts: final knob state + the decision-log tail."""
        return {
            'enabled': True,
            'state': self.state,
            'windows': self.windows,
            'knobs': _capture(self.precond),
            'comm_mode_choice': self.comm_mode_choice,
            'commits': self.commits,
            'reverts': self.reverts,
            'vetoes': self.vetoes,
            'quality_vetoes': self.quality_vetoes,
            'advisory_violations': self.advisory_violations,
            'last_window_s': (self.last_window or {}).get('time_s'),
            'decisions_tail': list(self.decisions)[-10:],
        }


def device_platform(device):
    """The platform name the drift gate matches for ``device``: a CUDA
    device's ``torch.cuda.get_device_name``, else the device type
    ('cpu'); None for None."""
    if device is None:
        return None
    import torch
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return device.type


def controller_from_args(precond, *, enabled, trace_dir=None,
                         predicted=None, variant=None, log=None,
                         quality_gate=None):
    """The trainers' shared constructor: returns a
    :class:`KnobController` (decision log under ``trace_dir`` when
    tracing is on) or None. ``predicted`` should be the perf-model
    block ONLY when the run matches the workload the model describes
    (the imagenet resnet50 bs32 config) — the drift gate judges phase
    ratios against it; other workloads run ungated (advisory-free).
    ``quality_gate``: a zero-arg monotone badness counter — a probe
    window that raised it never commits, whatever its step time said.
    The trainers construct the tuner BEFORE the HealthMonitor exists,
    so they late-bind the same hook instead
    (``tuner.quality_gate = monitor.quality_signal``); this parameter
    serves callers whose counter already exists at construction.
    The platform the drift gate judges is the preconditioner's device
    (``KFAC.device``, set by ``KFAC.init``; :func:`device_platform`)."""
    if not enabled or precond is None:
        return None
    decision_log = (os.path.join(trace_dir, 'autotune-decisions.jsonl')
                    if trace_dir else None)
    platform = None
    try:
        platform = device_platform(getattr(precond, 'device', None))
    except Exception:  # noqa: BLE001 — platform is advisory metadata
        pass
    return KnobController(precond, predicted=predicted, platform=platform,
                          variant=variant, decision_log=decision_log,
                          log=log, quality_gate=quality_gate)
