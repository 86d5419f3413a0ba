"""The K-FAC preconditioner (port of ``kfac_pytorch_tpu/preconditioner.py``).

  variant       stats_reduce   method      comm_mode
  ----------    ------------   ---------   ---------
  inverse       pmean (MPD)    cholesky    'pred' or 'inverse'
                                           (communicate_inverse_or_not)
  eigen         pmean (MPD)    eigh        'inverse'
  inverse_dp    local  (DP)    cholesky    'pred'
  eigen_dp      local  (DP)    eigh        'pred'   (the flagship)
  ekfac         pmean (MPD)    eigh        'inverse' + E-KFAC moments
  ekfac_dp      local  (DP)    eigh        'pred'    + E-KFAC moments

All six run, at world=1 and over a process group (``group``).
``comm_mode`` overrides the variant's mode. The E-KFAC variants keep, per
pred group, the second moments of the per-example gradients in the
joint eigenbasis (``decomp['scales']``, ``{'g<i>': [members, dg, da]}``:
every member in comm_mode 'inverse', this rank's slots in 'pred'),
which replace the eigenvalue products in the preconditioner; 'ekfac_dp'
computes them from each rank's own batch and never communicates them.

``replan`` rebuilds the plan mid-run (variant, comm_mode, the staggered
cohorts' per-bucket cadence, the world) and carries the state into it:
on the host for a whole world's states, or, with a live process group,
through a host gather of every rank's rows.

``step`` maps ``(state, grads, captured a/g) -> (preconditioned grads,
new state)`` and leaves its inputs untouched, like the JAX version; the
trainer picks ``update_factors``/``update_inverse``/``update_basis``/
``warm_basis``/``stagger_update`` on the host (``should_update_*``).
The decomposition ladder: a full decomposition, cold or warm-started
from the stored one (``decomp_impl``, ``warm_start_basis``), an
eigenvalue-only refresh in the retained basis (``basis_update_freq``),
or one staggered cohort a step (``stagger``), decomposed by its owners or
balanced across every rank (``decomp_shard``). At world>1 the
state is each rank's own: its factor rows, its error-feedback residual,
and (comm_mode 'pred') its decomposition rows; in comm_mode 'inverse'
the gathered decomposition is the same on every rank.
"""

import copy
import dataclasses
import logging
import os
import warnings
from typing import Dict, Optional

import torch

from kfac_pytorch_tpu_torch import engine
from kfac_pytorch_tpu_torch import health as health_lib
from kfac_pytorch_tpu_torch.capture import filter_vocab_head
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.plan import (build_cohorts, build_decomp_shard,
                                         build_plan, default_bucket_fn,
                                         same_row_layout)
from kfac_pytorch_tpu_torch.utils.platform import resolve_device

log = logging.getLogger(__name__)

#: the profiler range of a K-FAC phase: each ``with _range(name)`` in
#: :meth:`KFAC.step` sits where the JAX package opens ``jax.named_scope``
#: of that name, so a ``torch.profiler`` trace splits the step as an
#: xprof trace of the JAX step does
_range = torch.profiler.record_function

#: capture-kernel ladder, the JAX package's values: 'xla' is the
#: ops/factors.py path, 'pallas' the fused capture kernels (the name is
#: kept from the JAX package; in the port it means the hand-written CUDA
#: kernels of ops/capture_kernels.py), 'auto' resolves to 'pallas'.
#: None keeps the unfused path: plain torch ops, the covariance GEMM as
#: torch.matmul. So the four values select two paths: 'xla' is the same
#: as None, and 'auto' observes nothing yet (it always picks the kernels).
CAPTURE_IMPLS = ('xla', 'pallas', 'auto')

#: decomposition ladder, the JAX package's values: 'xla' the cold solver
#: (``torch.linalg.eigh`` / batched Cholesky), 'subspace' and 'jacobi'
#: warm eigh kernels (eigh variants), 'newton_schulz' the warm inverse
#: (Cholesky variants), 'auto' the method's warm kernel (subspace or
#: Newton-Schulz; the JAX package's choice, not yet measured against the
#: others on the card)
DECOMP_IMPLS = ('xla', 'auto', 'jacobi', 'subspace', 'newton_schulz')

#: impls that warm-start from the stored decomposition without
#: ``warm_start_basis``
_WARM_IMPLS = ('auto', 'jacobi', 'subspace', 'newton_schulz')


@dataclasses.dataclass
class KFACState:
    """Factor + decomposition state in the stacked-bucket layout:
    ``factors[str(D)]`` is this rank's ``[per_dev, D, D]`` rows;
    ``decomp`` holds ``evals``/``evecs`` (eigh) or ``invs`` (Cholesky)
    keyed the same way, this rank's rows in comm_mode 'pred' and all
    ``n_rows`` in 'inverse', plus ``scales`` for the E-KFAC variants
    (keyed per pred group). ``comm_err`` is this rank's error-feedback
    residual of the lossy stats reduce, ``[n_rows, D, D]`` per bucket
    (None when no lossy reduce exists: fp32, DP variants)."""
    step: int
    factors: Dict[str, torch.Tensor]
    decomp: Dict[str, Dict[str, torch.Tensor]]
    comm_err: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class KFACHyperParams:
    """Per-step hyper-parameters (schedulable without rebuilding)."""
    lr: float
    damping: float


_VARIANTS = {
    'inverse': dict(stats_reduce='pmean', method='cholesky', comm_mode=None),
    'eigen': dict(stats_reduce='pmean', method='eigh', comm_mode='inverse'),
    'inverse_dp': dict(stats_reduce='local', method='cholesky',
                       comm_mode='pred'),
    'eigen_dp': dict(stats_reduce='local', method='eigh', comm_mode='pred'),
    'ekfac': dict(stats_reduce='pmean', method='eigh', comm_mode='inverse',
                  ekfac=True),
    'ekfac_dp': dict(stats_reduce='local', method='eigh', comm_mode='pred',
                     ekfac=True),
}

_EKFAC_DAMPING_WARNED = False


def _warn_ekfac_damping_once(damping):
    """One warning a process that the E-KFAC variants want their own
    damping: their second-moment denominators are systematically at least
    the Kronecker eigenvalue products they replace, so a damping tuned for
    'eigen'/'eigen_dp' can under-damp them."""
    global _EKFAC_DAMPING_WARNED
    if _EKFAC_DAMPING_WARNED:
        return
    _EKFAC_DAMPING_WARNED = True
    warnings.warn(
        f'ekfac variants replace the Kronecker eigenvalue product with '
        f'exact (typically larger) second moments in the denominator — '
        f'a damping calibrated for an eigen variant (got {damping}) may '
        'be too small here. If this config was tuned on eigen/eigen_dp, '
        'sweep damping upward (3x/10x) before judging ekfac.',
        stacklevel=3)


#: what replan does not do yet, by the ROADMAP item that brings it
_REPLAN_LATER = {
    'mesh_axes': 'replan(mesh_axes=) is not ported yet: ROADMAP queue 1, '
                 'slice E (composed meshes)',
}

#: ``replan``'s default ``group``: keep the current one
_UNCHANGED = object()


class KFAC:
    """K-FAC gradient preconditioner.

    Args (reference semantics unless noted):
      variant: one of the six names in the table above.
      lr, damping, fac_update_freq, kfac_update_freq, kl_clip,
      factor_decay, hook_enabled, batch_averaged: as in the JAX package.
      communicate_inverse_or_not: 'inverse' variant only — gather the
        inverse factors instead of the preconditioned gradients.
      exclude_vocabulary_size: drop the pre-softmax head, the last layer
        if it is a dense with this output dim (``capture.filter_vocab_head``),
        from the plan: its gradient passes through unpreconditioned.
      num_devices / group: the K-FAC world's size and its process group
        (the JAX ``axis_name``); ``group=None`` is the zero-communication
        world=1 path, and a group must have ``num_devices`` ranks.
      assignment: 'round_robin' (reference) | 'balanced' (LPT scheduler).
      distribute_layer_factors: eigen variant — put the A and G of one
        layer on different ranks when the world outnumbers the layers;
        default auto (never in comm_mode 'pred').
      comm_mode: 'inverse' | 'pred', overriding the variant's mode.
      comm_precision: wire dtype of the factor collectives, 'fp32' (exact),
        'bf16' or 'int8' (``parallel.collectives``); a lossy MPD stats
        reduce carries an error-feedback residual in ``KFACState.comm_err``.
        The gradient all-reduce is never compressed.
      bucket_fn: factor dim -> bucket dim (default ``default_bucket_fn``).
      eps: eigenvalue clamp (``d * (d > eps)``).
      capture_impl: None | 'xla' | 'pallas' | 'auto' (see
        ``CAPTURE_IMPLS``). With 'pallas'/'auto' the statistics run
        through the capture kernels — at world=1 with local statistics
        one fused launch per factor row with the EMA in its epilogue
        (``engine.update_factors_fused``) — and a lossy stats reduce's
        prep through K3.
      basis_update_freq: eigh variants — a full eigendecomposition every
        this many steps; the inverse updates between refresh only the
        eigenvalues in the retained basis (two matmuls a bucket). None:
        every inverse update is full.
      warm_start_basis: full decompositions after the first start from
        the stored one: eigh variants track the stored basis
        (``KFAC_EIGH_IMPL`` 'subspace'/'auto' or 'jacobi'), Cholesky
        variants iterate Newton-Schulz from the stored inverse with a
        per-slot Cholesky fallback.
      warm_sweeps: iterations of a warm full decomposition (None = the
        kernel's default: 2 subspace steps, 5 Jacobi sweeps, 2
        Newton-Schulz iterations).
      cold_restart_every: a cold full decomposition after this many
        consecutive warm ones (the chained basis gathers orthogonality
        error); a positive int.
      stagger: staggered refresh: after the first full decomposition,
        each step decomposes one of ``kfac_update_freq`` cost-balanced
        cohorts (``plan.build_cohorts``) and merges it for the next step,
        preconditioning with the stored table (in comm_mode 'inverse' the
        cohort's rows are gathered, ``sum_b R_b`` a step). Excludes
        ``basis_update_freq`` and ``warm_start_basis``.
      decomp_shard: the staggered cohort's rows are decomposed balanced
        across every rank (``plan.build_decomp_shard``) instead of by
        their owners: ``sum_b S_b`` rows a rank instead of ``sum_b R_b``,
        for two ``kfac.DecompComm`` gathers a step (the damped cohort out,
        the results back; ``FactorPlan.comm_volume(decomp_shard=...)``).
        Implies ``stagger`` and its exclusions.
      decomp_impl: None (``KFAC_EIGH_IMPL`` decides, warm only with
        ``warm_start_basis``) or one of ``DECOMP_IMPLS``; an explicit
        iterative value implies warm starts.

      comm_prefetch: comm_mode 'inverse' only: on a full inverse update
        with ``step(prefetch=True)`` the step preconditions with the
        stored table and publishes the freshly gathered one for the next
        step (one step of staleness, as a staggered step has). The trainer
        never prefetches the first decomposition of a process (a cold
        state would precondition with zeros). Not with the E-KFAC
        variants.
      health: the numerical-health guard (``health.py``). True (the
        default) turns on the in-engine screens with the default ladder:
        factor and decomposition rows that come back non-finite fall back
        to their last good value (the identity when cold), and a
        non-finite residual row resets to zero (pure pass-through on
        finite values). A ``health.HealthConfig`` tunes the damping ladder
        the trainer drives; False turns every screen off
        (``self.health`` is then None). With E-KFAC a non-finite moment
        row keeps its (rotated) previous value.
      exclude_parts: the reference's phase ablation, a string naming any
        of 'ComputeFactor' (no factor update: no K1/K2 launch),
        'CommunicateFactor' (the statistics stay local, no reduce),
        'ComputeInverse' (no decomposition; the gradients pass through
        unpreconditioned, the step still counts) and
        'CommunicateInverse' (no decomposition or preconditioned-gradient
        gather: each rank places its own rows, zeros elsewhere, and the
        KL clip, which reads every layer's pred, is skipped). Timing runs
        with each part removed splits a step's time by subtraction. Not
        with ``decomp_shard`` and 'CommunicateInverse'.

    The E-KFAC variants ('ekfac', 'ekfac_dp') warn once a process that a
    damping tuned for an eigen variant may be too small for them, and
    exclude ``stagger`` and ``comm_prefetch``, as in JAX.
    """

    def __init__(self, variant='eigen_dp', lr=0.1, damping=0.001,
                 fac_update_freq=1, kfac_update_freq=1,
                 communicate_inverse_or_not=False, kl_clip=0.001,
                 factor_decay=0.95, exclude_vocabulary_size=None,
                 hook_enabled=True, batch_averaged=True, num_devices=1,
                 group=None, assignment='round_robin',
                 distribute_layer_factors=None, bucket_fn=None, eps=1e-10,
                 comm_precision='fp32', comm_mode=None, capture_impl=None,
                 basis_update_freq=None, warm_start_basis=False,
                 warm_sweeps=None, cold_restart_every=50, stagger=False,
                 decomp_impl=None, health=True, comm_prefetch=False,
                 decomp_shard=False, exclude_parts=''):
        if variant not in _VARIANTS:
            raise KeyError(f'unknown variant {variant!r}')
        if capture_impl is not None and capture_impl not in CAPTURE_IMPLS:
            raise ValueError(f'capture_impl must be one of {CAPTURE_IMPLS}, '
                             f'got {capture_impl!r}')
        cfg = _VARIANTS[variant]
        mode = cfg['comm_mode'] or ('inverse' if communicate_inverse_or_not
                                    else 'pred')
        if comm_mode is not None:
            if comm_mode not in ('inverse', 'pred'):
                raise ValueError("comm_mode must be 'inverse' or 'pred', "
                                 f'got {comm_mode!r}')
            mode = comm_mode
        if group is not None and coll.axis_size(group) != num_devices:
            raise ValueError(f'num_devices={num_devices} but the group has '
                             f'{coll.axis_size(group)} ranks')
        self.variant = variant
        self.stats_reduce = cfg['stats_reduce']
        self.method = cfg['method']
        self.comm_mode = mode
        self.ekfac = cfg.get('ekfac', False)
        if self.ekfac:
            _warn_ekfac_damping_once(damping)
        self.lr = lr
        self.damping = damping
        self.fac_update_freq = fac_update_freq
        self.kfac_update_freq = kfac_update_freq
        self.kl_clip = kl_clip if (kl_clip is not None and kl_clip > 0) \
            else None
        self.factor_decay = factor_decay
        self.exclude_vocabulary_size = exclude_vocabulary_size
        self.hook_enabled = hook_enabled
        self.batch_averaged = batch_averaged
        self.num_devices = num_devices
        self.group = group
        self.assignment = assignment
        self.distribute_layer_factors = distribute_layer_factors
        self.bucket_fn = bucket_fn or default_bucket_fn
        self.eps = eps
        self.comm_precision = coll.check_wire_dtype(comm_precision)
        self.capture_impl = capture_impl
        self.health = health_lib.resolve(health)
        self._set_decomp_ladder(basis_update_freq, warm_start_basis,
                                warm_sweeps, cold_restart_every, stagger,
                                decomp_impl, decomp_shard)
        self._check_prefetch(comm_prefetch)
        if self.decomp_shard and 'CommunicateInverse' in exclude_parts:
            raise ValueError(
                'decomp_shard IS a communication pattern — the '
                'CommunicateInverse ablation cannot exclude the shard '
                'exchange (drop decomp_shard for that ablation)')
        self.exclude_compute_factor = 'ComputeFactor' in exclude_parts
        self.exclude_communicate_factor = 'CommunicateFactor' in exclude_parts
        self.exclude_compute_inverse = 'ComputeInverse' in exclude_parts
        self.exclude_communicate_inverse = ('CommunicateInverse'
                                            in exclude_parts)
        self.plan = None
        self._cohorts = None
        self._shard_plan = None
        # per-bucket stagger cadence ({bucket dim: stretch},
        # plan.build_cohorts' bucket_freq), set by replan; empty = uniform
        self.bucket_stagger_freq = {}
        self._pending_replan = None
        # the single writer of the runtime knobs (autotune.arbiter_for),
        # made on first use; it also holds the step invalidators
        self._knob_arbiter = None
        # the plan's factor-wise split (setup/replan), read by the tuner's
        # comm-mode candidates
        self._distributed = None
        # the device of the state (init): the tuner's platform
        self.device = None

    def _check_prefetch(self, comm_prefetch):
        """Keep ``comm_prefetch``, with the JAX constructor's errors."""
        self.comm_prefetch = bool(comm_prefetch)
        if not comm_prefetch:
            return
        if self.comm_mode != 'inverse':
            raise ValueError(
                "comm_prefetch applies to comm_mode='inverse' (the "
                'decomposition gathers); the comm_pred variants gather '
                "preconditioned gradients, which ARE the step's consumer "
                'and cannot be deferred')
        if self.ekfac:
            raise ValueError(
                'comm_prefetch is not supported for the ekfac variants: the '
                'scale moments must be estimated in the same basis the pred '
                'consumes, which prefetch splits across steps')

    def _set_decomp_ladder(self, basis_update_freq, warm_start_basis,
                           warm_sweeps, cold_restart_every, stagger,
                           decomp_impl, decomp_shard):
        """Validate and keep the decomposition-ladder options, with the
        JAX constructor's errors and warnings."""
        if basis_update_freq is not None and self.method != 'eigh':
            raise ValueError('basis_update_freq applies to eigh variants')
        self.basis_update_freq = basis_update_freq
        if (warm_start_basis and self.method == 'eigh'
                and os.environ.get('KFAC_EIGH_IMPL', 'xla') == 'xla'):
            warnings.warn(
                'warm_start_basis has no effect on the cold eigh path '
                "(torch.linalg.eigh cannot warm-start) — set "
                "KFAC_EIGH_IMPL='subspace' (or 'auto'/'jacobi') to use it",
                stacklevel=3)
        self.warm_start_basis = warm_start_basis
        if warm_start_basis and warm_sweeps is None:
            interval = basis_update_freq or self.kfac_update_freq
            if interval > 10:
                warnings.warn(
                    f'warm_start_basis with a {interval}-step interval '
                    'between full decompositions: the default warm_sweeps '
                    '(5) is calibrated for <=10-step basis drift — pass '
                    'warm_sweeps>=8 if eigen accuracy degrades',
                    stacklevel=3)
        self.warm_sweeps = warm_sweeps
        if not (isinstance(cold_restart_every, int)
                and cold_restart_every > 0):
            raise ValueError('cold_restart_every must be a positive int '
                             f'(got {cold_restart_every!r})')
        self.cold_restart_every = cold_restart_every
        if decomp_impl is not None:
            if decomp_impl not in DECOMP_IMPLS:
                raise ValueError(
                    f'decomp_impl must be one of {DECOMP_IMPLS}, '
                    f'got {decomp_impl!r}')
            if (decomp_impl in ('subspace', 'jacobi')
                    and self.method != 'eigh'):
                raise ValueError(
                    f'decomp_impl={decomp_impl!r} is an eigh kernel; '
                    f'variant {self.variant!r} decomposes by Cholesky — use '
                    "'newton_schulz' (or 'auto') there")
            if decomp_impl == 'newton_schulz' and self.method != 'cholesky':
                raise ValueError(
                    "decomp_impl='newton_schulz' replaces the Cholesky "
                    f'inverse; variant {self.variant!r} eigendecomposes — '
                    "use 'subspace' (or 'auto') there")
        self.decomp_impl = decomp_impl
        # the shard repartitions the staggered cohort: it implies stagger
        # and inherits its exclusions
        self.decomp_shard = bool(decomp_shard)
        self.stagger = bool(stagger) or self.decomp_shard
        if self.stagger:
            if self.ekfac:
                raise ValueError(
                    'stagger is not supported for the ekfac variants: the '
                    'per-example moment rotation assumes a whole-table '
                    'basis change, not a per-cohort one')
            if basis_update_freq is not None or warm_start_basis:
                raise ValueError(
                    'stagger is an alternative amortization of the inverse '
                    'refresh — it does not compose with basis_update_freq '
                    'or warm_start_basis (pick one; see README '
                    '"Staggered refresh")')

    def setup(self, metas):
        """Build the static factor plan from ``{name: LayerMeta}`` (or a
        meta list), the vocabulary head excluded if asked for. The eigen
        variant's auto rule distributes a layer's factors over two ranks
        iff the world outnumbers the layers (never in comm_mode 'pred')."""
        if not isinstance(metas, dict):
            metas = {m.name: m for m in metas}
        if self.exclude_vocabulary_size is not None:
            metas = filter_vocab_head(metas, self.exclude_vocabulary_size)
        distribute = self.distribute_layer_factors
        if self.variant in ('eigen', 'ekfac') and distribute is None:
            distribute = (self.comm_mode != 'pred'
                          and self.num_devices > len(metas))
        self.plan = build_plan(metas, num_devices=self.num_devices,
                               comm_mode=self.comm_mode,
                               assignment=self.assignment,
                               distribute_layer_factors=bool(distribute),
                               bucket_fn=self.bucket_fn)
        self._distributed = bool(distribute)
        self._cohorts = self._shard_plan = None
        if self.stagger:
            self.rebase_cohorts()
        return self.plan

    def rebase_cohorts(self):
        """(Re)build the staggered cohort layout for the current
        ``kfac_update_freq`` and ``bucket_stagger_freq`` (after ``setup``,
        a scheduler rescale, a replan, and on every staggered dispatch),
        and with ``decomp_shard`` its shard layout; a no-op when both
        already match. Returns the cohort layout (None without stagger or
        a plan)."""
        if not self.stagger or self.plan is None:
            return None
        f = max(1, int(self.kfac_update_freq))
        overrides = {int(k): max(1, int(v))
                     for k, v in self.bucket_stagger_freq.items()}
        if (self._cohorts is None or self._cohorts.base_freq != f
                or self._cohorts.bucket_freq != overrides):
            self._cohorts = build_cohorts(self.plan, f,
                                          bucket_freq=overrides)
            self._shard_plan = None
        if self.decomp_shard and self._shard_plan is None:
            self._shard_plan = build_decomp_shard(self.plan, self._cohorts)
        return self._cohorts

    @property
    def cohorts(self):
        """The current staggered cohort layout (``plan.CohortPlan``)."""
        return self._cohorts

    @property
    def decomp_shard_plan(self):
        """The sharded decomposition layout (``plan.DecompShardPlan``), or
        None when ``decomp_shard`` is off."""
        return self._shard_plan

    # -- live replanning --------------------------------------------------

    @property
    def pending_replan(self):
        """The queued :meth:`request_replan` spec, or None; the trainer
        applies it at the top of its next step."""
        return self._pending_replan

    def request_replan(self, _invalidate=True, **spec):
        """Queue a replan for the next step boundary; later requests merge
        key by key. ``_invalidate=False`` records that the caller already
        fired the invalidators (the knob arbiter does, once, when it
        commits a ``comm_mode``); the flag ORs across merged requests, so
        a caller that still needs the invalidation keeps it armed."""
        pend = dict(self._pending_replan or {'_invalidate': False})
        invalidate = bool(pend.get('_invalidate', False)) or _invalidate
        pend.update(spec)
        pend['_invalidate'] = invalidate
        self._pending_replan = pend
        return pend

    def apply_pending_replan(self, kfac_state):
        """Apply and clear the queued replan against ``kfac_state``;
        returns the carried state (``kfac_state`` itself when nothing is
        pending)."""
        spec, self._pending_replan = self._pending_replan, None
        if not spec:
            return kfac_state
        return self.replan(kfac_state, **spec)

    def replan(self, kfac_state=None, *, comm_mode=None, num_devices=None,
               bucket_overrides=None, variant=None, mesh_axes=None,
               group=_UNCHANGED, _invalidate=True):
        """Rebuild the plan (and the staggered cohort tables) mid-run and
        carry ``kfac_state`` into the new layout; returns the carried state
        (None for ``kfac_state=None``: plan only).

        ``variant`` switches the family (stats_reduce, method, comm_mode
        and E-KFAC re-derive from the variant table; an explicit
        ``comm_mode`` still wins); ``comm_mode`` switches the road alone;
        ``bucket_overrides`` sets a staggered preconditioner's per-bucket
        cadence ``{bucket dim: stretch}`` (powers of two <= 64; ``{}``
        clears); ``num_devices`` moves to another world (the elastic
        lane), and ``group`` (JAX's ``axis_name``) names its process group
        (None: no group; default the current one, which must then have
        ``num_devices`` ranks). Where the row layout, the method, the
        residual and (for E-KFAC) the comm mode all stay, the state is
        carried verbatim: the same object, not a byte moved. Otherwise it
        is transported by :func:`utils.checkpoint.reshard_kfac_state` with
        ``carry_decomp``: the factor EMAs and step exactly, a same-method
        decomposition row for row, and a cross-method switch leaves a zero
        decomposition that the next inverse update rebuilds from the
        carried factors (until then the trainer passes gradients through).
        E-KFAC moments and the error-feedback residual are comm-mode or
        world shaped and restart from zero when not carried.

        Without a group ``kfac_state`` is the whole world's state: the
        world=1 state, or the list of every rank's states in rank order,
        and the new world's comes back the same way. With a live group
        (``self.group``) it is this rank's state: every rank must call
        the replan, the ranks' rows are gathered on the host, and this
        rank's entry of the new world comes back (its rank in the new
        group; the whole list when the new world has no group).

        The new plan and state are built before any attribute changes, so
        a failed replan leaves the preconditioner as it was. The
        ``comm_mode`` write is the knob arbiter's (under its applying
        guard, then ``sync_knobs``); a replan that changes what a step
        computes fires the arbiter's invalidators once, unless
        ``_invalidate=False`` (the arbiter's queued replan: it fired them
        when it committed). ``mesh_axes`` raises NotImplementedError
        naming its ROADMAP item."""
        assert self.plan is not None, 'call setup() first'
        if mesh_axes is not None:
            raise NotImplementedError(_REPLAN_LATER['mesh_axes'])
        old_plan = self.plan
        # the mode the state is held in: the plan's (the knob arbiter
        # writes ``comm_mode`` when it commits and queues this replan)
        old_mode = old_plan.comm_mode

        # -- the target configuration
        new_variant = self.variant if variant is None else variant
        if new_variant not in _VARIANTS:
            raise KeyError(f'unknown variant {new_variant!r}')
        cfg = _VARIANTS[new_variant]
        new_mode = (self.comm_mode if variant is None
                    else cfg['comm_mode'] or 'pred')
        if comm_mode is not None:
            if comm_mode not in ('inverse', 'pred'):
                raise ValueError("comm_mode must be 'inverse' or 'pred', "
                                 f'got {comm_mode!r}')
            new_mode = comm_mode
        new_method = self.method if variant is None else cfg['method']
        new_reduce = (self.stats_reduce if variant is None
                      else cfg['stats_reduce'])
        new_ekfac = self.ekfac if variant is None else cfg.get('ekfac', False)
        new_P = self.num_devices if num_devices is None else int(num_devices)
        if new_P < 1:
            raise ValueError(f'num_devices must be >= 1, got {new_P}')
        new_group = self.group if group is _UNCHANGED else group
        if new_group is not None and coll.axis_size(new_group) != new_P:
            raise ValueError(f'num_devices={new_P} but the group has '
                             f'{coll.axis_size(new_group)} ranks (pass '
                             'group= for the new world)')
        new_overrides = self._replan_overrides(bucket_overrides, old_plan)

        # -- the constructor's rules, checked again
        if new_mode == 'pred' and self.comm_prefetch:
            raise ValueError(
                "cannot replan to comm_mode='pred' with comm_prefetch: "
                'the pred gather IS the step consumer and cannot be '
                'deferred (drop comm_prefetch first)')
        if new_ekfac and self.stagger:
            raise ValueError('cannot replan a staggered preconditioner '
                             'onto an ekfac variant (stagger exclusion)')
        if self.decomp_impl is not None:
            if (self.decomp_impl in ('subspace', 'jacobi')
                    and new_method != 'eigh'):
                raise ValueError(
                    f'decomp_impl={self.decomp_impl!r} is an eigh kernel '
                    f'but the replan target decomposes by {new_method} — '
                    'switch decomp_impl first')
            if (self.decomp_impl == 'newton_schulz'
                    and new_method != 'cholesky'):
                raise ValueError(
                    "decomp_impl='newton_schulz' replaces the Cholesky "
                    f'inverse but the replan target uses {new_method} — '
                    'switch decomp_impl first')
        # the plan a fresh setup of the target would build (comm_mode
        # 'pred' forbids the factor-wise split)
        distribute = self.distribute_layer_factors
        if distribute is None and new_variant in ('eigen', 'ekfac'):
            distribute = (new_mode != 'pred'
                          and new_P > len(old_plan.metas))
        distribute = bool(distribute) and new_mode != 'pred'

        # -- build the new plan and the carried state first
        new_plan = build_plan({m.name: m for m in old_plan.metas},
                              num_devices=new_P,
                              comm_mode=new_mode,
                              assignment=self.assignment,
                              distribute_layer_factors=distribute,
                              bucket_fn=self.bucket_fn)
        clone = copy.copy(self)
        clone.variant, clone.stats_reduce = new_variant, new_reduce
        clone.method, clone.comm_mode = new_method, new_mode
        clone.ekfac, clone.plan = new_ekfac, new_plan
        clone.num_devices, clone.group = new_P, new_group
        clone.bucket_stagger_freq = new_overrides
        clone._cohorts = clone._shard_plan = None
        same_layout = same_row_layout(old_plan, new_plan)
        new_state = kfac_state
        verbatim = False
        if kfac_state is not None:
            first = (kfac_state[0] if isinstance(kfac_state, list)
                     else kfac_state)
            verbatim = (
                same_layout and self.method == new_method
                # the moments are comm-mode shaped; the residual exists
                # only on a lossy MPD reduce
                and (not (self.ekfac or new_ekfac)
                     or (self.ekfac == new_ekfac
                         and old_mode == new_mode))
                and self.tracks_comm_err == clone.tracks_comm_err
                and ((first.comm_err is None)
                     == (not clone.tracks_comm_err)))
            if not verbatim:
                new_state = self._transport(clone, kfac_state)
            elif old_mode != new_mode and new_P > 1:
                new_state = self._regather_decomp(kfac_state, old_mode,
                                                  new_mode)

        # -- commit every attribute together
        trace_changed = (
            not same_layout or new_mode != old_mode
            or new_method != self.method or new_reduce != self.stats_reduce
            or new_ekfac != self.ekfac or new_group is not self.group
            or new_overrides != self.bucket_stagger_freq)
        if new_ekfac and not self.ekfac:
            _warn_ekfac_damping_once(self.damping)
        from kfac_pytorch_tpu_torch import autotune
        with autotune._applying():
            # a knob: written under the arbiter's guard, and re-based on
            # it below so it is never adopted as a foreign write
            self.comm_mode = new_mode
        self.variant, self.stats_reduce = new_variant, new_reduce
        self.method = new_method
        self.ekfac, self.plan = new_ekfac, new_plan
        self.num_devices, self.group = new_P, new_group
        self._distributed = distribute
        self.bucket_stagger_freq = new_overrides
        self._cohorts = self._shard_plan = None
        if self.stagger:
            self.rebase_cohorts()
        if self._knob_arbiter is not None:
            self._knob_arbiter.sync_knobs(comm_mode=new_mode)
        log.info('kfac: replan applied variant=%s comm_mode=%s world=%d%s '
                 '(layout %s, state %s)', new_variant, new_mode, new_P,
                 f' bucket_overrides={new_overrides}' if new_overrides
                 else '', 'unchanged' if same_layout else 'rebuilt',
                 'carried verbatim' if verbatim else
                 ('transported' if kfac_state is not None else 'none'))
        if _invalidate and trace_changed:
            autotune.arbiter_for(self).invalidate()
        return new_state

    def _regather_decomp(self, kfac_state, old_mode, new_mode):
        """``kfac_state`` with its decomposition rows moved from
        ``old_mode``'s holding to ``new_mode``'s at the same row layout:
        at world > 1 comm_mode 'inverse' holds every row on every rank,
        'pred' a rank's own (``KFACState``), where JAX's global arrays
        carry over as they are. The factors and the residual are carried
        as they are. With a live group the state is this rank's (pred ->
        inverse gathers the rows over the group), else the list of every
        rank's."""
        plan = self.plan
        states = kfac_state if isinstance(kfac_state, list) else None
        rank = None if states is not None else coll.axis_index(self.group)

        def moved(st, r):
            decomp = {}
            for part, tree in st.decomp.items():
                decomp[part] = {}
                for k, v in tree.items():
                    per = plan.buckets[int(k)].per_dev
                    if new_mode == 'pred':
                        v = v[r * per:(r + 1) * per]
                    elif states is not None:
                        v = torch.cat([s.decomp[part][k] for s in states])
                    else:
                        v = coll.all_gather_rows(v, self.group)
                    decomp[part][k] = v
            return dataclasses.replace(st, decomp=decomp)

        if states is None:
            return moved(kfac_state, rank)
        return [moved(st, r) for r, st in enumerate(states)]

    def _transport(self, clone, kfac_state):
        """``kfac_state`` carried from this preconditioner's layout into
        ``clone``'s by ``reshard_kfac_state`` (``carry_decomp``): through
        a host gather of every rank's state when this preconditioner has
        a live group, and down to this rank's entry when ``clone`` has
        one."""
        from kfac_pytorch_tpu_torch.utils.checkpoint import (
            kfac_state_to, reshard_kfac_state)
        dev = None
        if self.group is not None:
            dev = next(iter(kfac_state.factors.values())).device
            states = [None] * self.num_devices
            torch.distributed.all_gather_object(
                states, kfac_state_to(kfac_state, 'cpu'), group=self.group)
            kfac_state = states
        out = reshard_kfac_state(self, clone, kfac_state, carry_decomp=True)
        if clone.group is not None and isinstance(out, list):
            out = out[coll.axis_index(clone.group)]
        if dev is not None:
            out = ([kfac_state_to(st, dev) for st in out]
                   if isinstance(out, list) else kfac_state_to(out, dev))
        return out

    def _replan_overrides(self, bucket_overrides, plan):
        """The validated per-bucket cadence of a replan (the current one
        when not given)."""
        if bucket_overrides is None:
            return dict(self.bucket_stagger_freq)
        if not self.stagger:
            raise ValueError(
                'bucket_overrides tune the STAGGERED cohort cadence '
                '(KFAC(stagger=True)); this preconditioner refreshes whole '
                'tables')
        out = {int(k): int(v) for k, v in dict(bucket_overrides).items()}
        if any(v < 1 for v in out.values()):
            raise ValueError(f'bucket_overrides stretches must be >= 1, got '
                             f'{out}')
        if any(v & (v - 1) or v > 64 for v in out.values()):
            raise ValueError('bucket_overrides stretches must be powers of '
                             f'two <= 64, got {out}')
        unknown = sorted(set(out) - set(plan.bucket_dims))
        if unknown:
            raise ValueError(f'bucket_overrides names unknown bucket dims '
                             f'{unknown} (plan has {plan.bucket_dims})')
        return out

    @property
    def resolved_decomp_impl(self):
        """'auto' resolves per method (subspace for eigh, Newton-Schulz
        for Cholesky); None stays None (``KFAC_EIGH_IMPL`` decides)."""
        if self.decomp_impl == 'auto':
            return 'subspace' if self.method == 'eigh' else 'newton_schulz'
        return self.decomp_impl

    @property
    def warm_impl(self):
        """Does the explicit ``decomp_impl`` warm-start from the stored
        decomposition? (An impl chosen by ``KFAC_EIGH_IMPL`` does not.)"""
        return self.decomp_impl in _WARM_IMPLS

    @property
    def resolved_capture_impl(self):
        """'auto' resolves to the fused kernels ('pallas'); others as set."""
        return 'pallas' if self.capture_impl == 'auto' else self.capture_impl

    @property
    def tracks_comm_err(self):
        """Does this config carry an error-feedback residual? Only a lossy
        MPD stats reduce does (a gather has one contributor per row:
        nothing accumulates to feed back)."""
        return self.comm_precision != 'fp32' and self.stats_reduce == 'pmean'

    def zero_comm_err(self, device):
        """A fresh residual on ``device``: zeros shaped like this rank's
        whole stats stack, ``[n_rows, D, D]`` per bucket (None when the
        config tracks none)."""
        if not self.tracks_comm_err:
            return None
        return {str(d): torch.zeros((self.plan.buckets[d].n_rows, d, d),
                                    device=device)
                for d in self.plan.bucket_dims}

    def init(self, device=None):
        """Identity factors and zero decompositions of this rank on
        ``device`` (the GPU unless ``device='cpu'`` is asked for)."""
        assert self.plan is not None, 'call setup() first'
        device = resolve_device(device)
        self.device = device
        plan = self.plan
        factors = {str(d): torch.eye(d, device=device).repeat(
            plan.buckets[d].per_dev, 1, 1) for d in plan.bucket_dims}

        def rows(d):
            b = plan.buckets[d]
            return b.n_rows if self.comm_mode == 'inverse' else b.per_dev

        if self.method == 'eigh':
            decomp = {'evals': {str(d): torch.zeros((rows(d), d),
                                                    device=device)
                                for d in plan.bucket_dims},
                      'evecs': {str(d): torch.zeros((rows(d), d, d),
                                                    device=device)
                                for d in plan.bucket_dims}}
            if self.ekfac:
                decomp['scales'] = self._zero_scales(device)
        else:
            decomp = {'invs': {str(d): torch.zeros((rows(d), d, d),
                                                   device=device)
                               for d in plan.bucket_dims}}
        return KFACState(step=0, factors=factors, decomp=decomp,
                         comm_err=self.zero_comm_err(device))

    def _zero_scales(self, device):
        """This rank's zero E-KFAC moments (JAX's ``local=True`` shape),
        ``{'g<i>': [rows, dg, da]}``: in comm_mode 'pred' the rank's ``K``
        slots of each pred group, in 'inverse' every member."""
        out = {}
        for gi, pg in enumerate(self.plan.pred_groups):
            if self.comm_mode == 'pred':
                rows = pg.local_member.shape[1]
            else:
                rows = len(pg.layer_idx)
            out[f'g{gi}'] = torch.zeros((rows, pg.dg, pg.da),
                                        device=device)
        return out

    def should_update_factors(self, step: int) -> bool:
        return self.hook_enabled and step % self.fac_update_freq == 0

    def should_update_inverse(self, step: int) -> bool:
        return step % self.kfac_update_freq == 0

    def should_update_basis(self, step: int,
                            last_full_step: Optional[int] = None) -> bool:
        """Full eigendecomposition (True) or eigenvalue-only refresh at an
        inverse-update step: full once ``basis_update_freq`` steps have
        passed since the last full one (staleness, not step modulo, so a
        rescaled ``kfac_update_freq`` cannot alias it away)."""
        if self.basis_update_freq is None or last_full_step is None:
            return True
        return step - last_full_step >= self.basis_update_freq

    def step(self, state: KFACState, grads, acts=None, gs=None,
             hyper: Optional[KFACHyperParams] = None, *,
             update_factors: bool = True, update_inverse: bool = True,
             update_basis: bool = True, warm_basis: bool = False,
             factors_only: bool = False, stagger_update: bool = False,
             prefetch: bool = False):
        """One K-FAC step: ``(state, grads, captured a/g) ->
        (preconditioned grads, new state)``. ``grads`` is
        ``{parameter name: tensor}``, already averaged over the group;
        only K-FAC layers' entries change. ``acts``/``gs`` are this rank's
        captures. ``factors_only`` accumulates statistics and returns the
        grads untouched (before any decomposition exists).

        An inverse update is a full decomposition, or with
        ``update_basis=False`` (eigh) an eigenvalue-only refresh;
        ``warm_basis`` (set once a decomposition exists) seeds a full one
        from the stored decomposition when ``warm_start_basis`` or an
        iterative ``decomp_impl`` asks for it. ``prefetch`` (needs
        ``comm_prefetch``) makes an inverse update publish its gathered
        decomposition for the next step while this step preconditions
        with ``state.decomp``, the stored table. ``stagger_update``
        replaces the inverse update: cohort ``state.step % num_cohorts``
        is decomposed (by its owners, or with ``decomp_shard`` across
        every rank) and merged for the next step, and this step
        preconditions with the stored table."""
        assert self.plan is not None, 'call setup() first'
        plan = self.plan
        group = self.group
        if group is None and plan.num_devices != 1:
            raise ValueError(f'a {plan.num_devices}-rank plan needs its '
                             'process group')
        if hyper is None:
            hyper = KFACHyperParams(lr=self.lr, damping=self.damping)
        factors, decomp = state.factors, state.decomp
        comm_err = state.comm_err
        dev = next(iter(factors.values())).device
        damping = torch.as_tensor(hyper.damping, dtype=torch.float32,
                                  device=dev)
        lr = torch.as_tensor(hyper.lr, dtype=torch.float32, device=dev)

        # the stats reduce, or none under the CommunicateFactor ablation
        reduce = ('local' if self.exclude_communicate_factor
                  else self.stats_reduce)
        if update_factors and not self.exclude_compute_factor:
            cap_impl = self.resolved_capture_impl
            if (cap_impl == 'pallas' and reduce == 'local'
                    and plan.num_devices == 1):
                # world=1 local stats: capture -> factor GEMM -> EMA is one
                # fused kernel per factor row
                with _range('kfac.ComputeFactor'):
                    factors = engine.update_factors_fused(
                        plan, factors, acts, gs, self.batch_averaged,
                        self.factor_decay)
            else:
                with _range('kfac.ComputeFactor'):
                    a_list, g_list = engine.compute_layer_stats(
                        plan, acts, gs, self.batch_averaged,
                        capture_impl=cap_impl)
                    stats = engine.stack_stats(plan, a_list, g_list)
                # the reduce inside opens its own kfac.CommunicateFactor
                with _range('kfac.UpdateFactors'):
                    factors, comm_err = engine.update_factors(
                        plan, factors, stats, self.factor_decay, reduce,
                        group, comm_precision=self.comm_precision,
                        comm_err=comm_err, capture_impl=cap_impl)
            if self.health is not None and comm_err is not None:
                # a non-finite residual row resets to zero (feedback is a
                # correction, never load-bearing)
                with _range('kfac.HealthGuard.comm_err'):
                    comm_err = engine.where_finite_rows(
                        comm_err, {k: torch.zeros_like(v)
                                   for k, v in comm_err.items()})
            if self.health is not None:
                # a non-finite EMA row keeps the last good factor; a row
                # whose stored value is corrupt too restarts from identity
                with _range('kfac.HealthGuard.factors'):
                    factors = engine.where_finite_rows(
                        factors, state.factors, reinit_identity=True)

        if factors_only or self.exclude_compute_inverse:
            # no decomposition yet, or the ComputeInverse ablation: the
            # gradients pass through
            return grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp, comm_err=comm_err)

        communicate = not self.exclude_communicate_inverse
        if stagger_update:
            update_inverse = False
        impl = self.resolved_decomp_impl
        scales_prev = None
        if self.ekfac:
            # a state from before E-KFAC (no 'scales') starts from zero
            # moments: the pred path then keeps the Kronecker denominator
            scales_prev = decomp.get('scales')
            if scales_prev is None:
                scales_prev = self._zero_scales(dev)
        if update_inverse and self.method == 'eigh' and not update_basis:
            # the basis is kept, so the stored moments stay as they are
            with _range('kfac.ComputeInverse.refresh'):
                refreshed = engine.refresh_decomposition(
                    plan, factors, decomp, self.eps, group, self.comm_mode,
                    communicate=communicate,
                    comm_precision=self.comm_precision)
            if self.health is not None:
                with _range('kfac.HealthGuard.decomp'):
                    refreshed = engine.guard_decomposition(
                        refreshed, decomp, 'eigh')
            decomp = refreshed
        elif update_inverse:
            basis_local = invs_prev = None
            if (self.warm_start_basis or self.warm_impl) and warm_basis:
                if self.method == 'eigh':
                    basis_local = engine.local_evecs(plan, decomp, group,
                                                     self.comm_mode)
                else:
                    invs_prev = engine.local_invs(plan, decomp, group,
                                                  self.comm_mode)
            with _range('kfac.ComputeInverse'):
                decomp_local = engine.compute_decomposition(
                    plan, factors, damping, self.method, self.eps, group,
                    basis_local=basis_local, warm_sweeps=self.warm_sweeps,
                    invs_prev_local=invs_prev, impl=impl)
            if self.health is not None:
                with _range('kfac.HealthGuard.decomp'):
                    decomp_local = engine.guard_decomposition(
                        decomp_local,
                        engine.local_decomposition(plan, decomp, group,
                                                   self.comm_mode,
                                                   self.method),
                        self.method)
            if self.comm_mode == 'inverse':
                with _range('kfac.CommunicateInverse'):
                    new_decomp = engine.gather_decomposition(
                        plan, decomp_local, group, communicate=communicate,
                        comm_precision=self.comm_precision)
                if self.ekfac:
                    # the moments live in the old basis: carry them over
                    with _range('kfac.EkfacScales.rotate'):
                        scales_prev = engine.rotate_ekfac_scales(
                            plan, scales_prev, decomp, new_decomp)
                decomp = new_decomp
            else:
                if self.ekfac:
                    with _range('kfac.EkfacScales.rotate'):
                        scales_prev = engine.rotate_ekfac_scales_local(
                            plan, scales_prev,
                            engine.local_evecs(plan, decomp, group, 'pred'),
                            decomp_local['evecs'], group)
                decomp = decomp_local
        if self.ekfac:
            decomp = {**decomp, 'scales': scales_prev}
            if (update_factors and acts is not None
                    and not self.exclude_compute_factor):
                with _range('kfac.EkfacScales'):
                    if self.comm_mode == 'pred':
                        scales = engine.update_ekfac_scales_local(
                            plan, decomp, acts, gs, self.batch_averaged,
                            scales_prev, self.factor_decay, group)
                    else:
                        scales = engine.update_ekfac_scales(
                            plan, decomp, acts, gs, self.batch_averaged,
                            scales_prev, self.factor_decay, reduce, group,
                            comm_precision=self.comm_precision)
                if self.health is not None:
                    # a non-finite moment row keeps the (rotated) previous
                    with _range('kfac.HealthGuard.scales'):
                        scales = engine.where_finite_rows(scales,
                                                          scales_prev)
                decomp['scales'] = scales
        pred_decomp = decomp
        if prefetch and update_inverse:
            assert self.comm_prefetch, \
                'prefetch requires KFAC(comm_prefetch=True)'
            pred_decomp = state.decomp
        if stagger_update:
            cohorts = self._cohorts
            assert cohorts is not None, \
                'stagger_update requires KFAC(stagger=True) + setup()'
            cohort_idx = state.step % cohorts.num_cohorts
            guard = self.health is not None
            if self.decomp_shard:
                shard = self._shard_plan
                assert shard is not None, \
                    'decomp_shard requires setup() (rebase_cohorts)'
                # the exchange's two gathers open kfac.DecompComm
                with _range('kfac.ComputeInverse.stagger'):
                    shard_new = engine.compute_shard_decomposition(
                        plan, cohorts, shard, factors, cohort_idx, damping,
                        self.method, self.eps, group, impl=impl,
                        decomp_prev=decomp, comm_mode=self.comm_mode,
                        warm_sweeps=self.warm_sweeps,
                        comm_precision=self.comm_precision)
                with _range('kfac.CommunicateInverse.stagger'):
                    decomp = engine.merge_shard_decomposition(
                        plan, shard, decomp, shard_new, cohort_idx, group,
                        self.comm_mode, self.method, guard=guard,
                        comm_precision=self.comm_precision)
            else:
                with _range('kfac.ComputeInverse.stagger'):
                    cohort_new = engine.compute_cohort_decomposition(
                        plan, cohorts, factors, cohort_idx, damping,
                        self.method, self.eps, group, impl=impl,
                        decomp_prev=decomp if self.warm_impl else None,
                        comm_mode=self.comm_mode,
                        warm_sweeps=self.warm_sweeps)
                with _range('kfac.CommunicateInverse.stagger'):
                    decomp = engine.merge_cohort_decomposition(
                        plan, cohorts, decomp, cohort_new, cohort_idx,
                        group, self.comm_mode, self.method,
                        communicate=communicate, guard=guard,
                        comm_precision=self.comm_precision)

        grad_mats = [engine.layer_grad_matrix(m, grads) for m in plan.metas]
        scales = pred_decomp.get('scales') if self.ekfac else None
        with _range('kfac.Precondition'):
            if self.comm_mode == 'inverse':
                preds = engine.compute_pred_replicated(
                    plan, pred_decomp, grad_mats, damping, self.method,
                    scales=scales)
            else:
                preds = engine.compute_pred_local(
                    plan, pred_decomp, grad_mats, damping, self.method,
                    group, communicate=communicate,
                    comm_precision=self.comm_precision, scales=scales)
        new_grads = engine.preconditioned_grads(
            plan, grads, grad_mats, preds, lr, self.kl_clip,
            skip_clip=not communicate)
        return new_grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp, comm_err=comm_err)
