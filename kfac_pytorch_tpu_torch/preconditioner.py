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

All six names are accepted; the first four run, at world=1 and over a
process group (``group``). ``ekfac``/``ekfac_dp`` raise
``NotImplementedError`` naming the port slice that brings them.
``comm_mode`` overrides the variant's mode.

``step`` maps ``(state, grads, captured a/g) -> (preconditioned grads,
new state)`` and leaves its inputs untouched, like the JAX version; the
trainer picks ``update_factors``/``update_inverse``/``update_basis``/
``warm_basis``/``stagger_update`` on the host (``should_update_*``).
The decomposition ladder: a full decomposition, cold or warm-started
from the stored one (``decomp_impl``, ``warm_start_basis``), an
eigenvalue-only refresh in the retained basis (``basis_update_freq``),
or one staggered cohort a step (``stagger``, world=1). At world>1 the
state is each rank's own: its factor rows, its error-feedback residual,
and (comm_mode 'pred') its decomposition rows; in comm_mode 'inverse'
the gathered decomposition is the same on every rank.
"""

import dataclasses
import os
import warnings
from typing import Dict, Optional

import torch

from kfac_pytorch_tpu_torch import engine
from kfac_pytorch_tpu_torch import health as health_lib
from kfac_pytorch_tpu_torch.capture import filter_vocab_head
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.plan import (build_cohorts, build_plan,
                                         default_bucket_fn)
from kfac_pytorch_tpu_torch.utils.platform import resolve_device

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
    ``n_rows`` in 'inverse'. ``comm_err`` is this rank's error-feedback
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

_LATER = {
    'ekfac': 'ROADMAP queue 1, slice D item 18 (E-KFAC)',
    'ekfac_dp': 'ROADMAP queue 1, slice D item 18 (E-KFAC)',
}


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
      stagger: staggered refresh (world=1): after the first full
        decomposition, each step decomposes one of ``kfac_update_freq``
        cost-balanced cohorts (``plan.build_cohorts``) and merges it for
        the next step, preconditioning with the stored table. Excludes
        ``basis_update_freq`` and ``warm_start_basis``.
      decomp_impl: None (``KFAC_EIGH_IMPL`` decides, warm only with
        ``warm_start_basis``) or one of ``DECOMP_IMPLS``; an explicit
        iterative value implies warm starts.

      health: the numerical-health guard (``health.py``). True (the
        default) turns on the in-engine screens with the default ladder:
        factor and decomposition rows that come back non-finite fall back
        to their last good value (the identity when cold), and a
        non-finite residual row resets to zero (pure pass-through on
        finite values). A ``health.HealthConfig`` tunes the damping ladder
        the trainer drives; False turns every screen off
        (``self.health`` is then None). The E-KFAC scales screen comes
        with E-KFAC (ROADMAP queue 1, item 18).
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
                 decomp_impl=None, health=True):
        if variant not in _VARIANTS:
            raise KeyError(f'unknown variant {variant!r}')
        if variant in _LATER:
            raise NotImplementedError(
                f'variant {variant!r} is not ported yet: '
                f'{_LATER[variant]}')
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
                                decomp_impl)
        self.plan = None
        self._cohorts = None

    def _set_decomp_ladder(self, basis_update_freq, warm_start_basis,
                           warm_sweeps, cold_restart_every, stagger,
                           decomp_impl):
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
        self.stagger = bool(stagger)
        if self.stagger:
            if basis_update_freq is not None or warm_start_basis:
                raise ValueError(
                    'stagger is an alternative amortization of the inverse '
                    'refresh — it does not compose with basis_update_freq '
                    'or warm_start_basis (pick one; see README '
                    '"Staggered refresh")')
            if self.num_devices > 1:
                raise NotImplementedError(
                    'stagger at world>1 is not ported yet: ROADMAP queue 1, '
                    "slice D item 15's remainder (the double-buffered "
                    'cohort gather and comm_prefetch, with item 16)')

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
        if self.variant == 'eigen' and distribute is None:
            distribute = (self.comm_mode != 'pred'
                          and self.num_devices > len(metas))
        self.plan = build_plan(metas, num_devices=self.num_devices,
                               comm_mode=self.comm_mode,
                               assignment=self.assignment,
                               distribute_layer_factors=bool(distribute),
                               bucket_fn=self.bucket_fn)
        self._cohorts = None
        if self.stagger:
            self.rebase_cohorts()
        return self.plan

    def rebase_cohorts(self):
        """(Re)build the staggered cohort layout for the current
        ``kfac_update_freq`` (after ``setup``, a scheduler rescale, and on
        every staggered dispatch); a no-op when it already matches.
        Returns the layout (None without stagger or a plan)."""
        if not self.stagger or self.plan is None:
            return None
        f = max(1, int(self.kfac_update_freq))
        if self._cohorts is None or self._cohorts.base_freq != f:
            self._cohorts = build_cohorts(self.plan, f)
        return self._cohorts

    @property
    def cohorts(self):
        """The current staggered cohort layout (``plan.CohortPlan``)."""
        return self._cohorts

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
        else:
            decomp = {'invs': {str(d): torch.zeros((rows(d), d, d),
                                                   device=device)
                               for d in plan.bucket_dims}}
        return KFACState(step=0, factors=factors, decomp=decomp,
                         comm_err=self.zero_comm_err(device))

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
             factors_only: bool = False, stagger_update: bool = False):
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
        iterative ``decomp_impl`` asks for it. ``stagger_update`` replaces
        the inverse update: cohort ``state.step % num_cohorts`` is
        decomposed and merged for the next step, and this step
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

        if update_factors:
            cap_impl = self.resolved_capture_impl
            if (cap_impl == 'pallas' and self.stats_reduce == 'local'
                    and plan.num_devices == 1):
                # world=1 local stats: capture -> factor GEMM -> EMA is one
                # fused kernel per factor row
                factors = engine.update_factors_fused(
                    plan, factors, acts, gs, self.batch_averaged,
                    self.factor_decay)
            else:
                a_list, g_list = engine.compute_layer_stats(
                    plan, acts, gs, self.batch_averaged,
                    capture_impl=cap_impl)
                stats = engine.stack_stats(plan, a_list, g_list)
                factors, comm_err = engine.update_factors(
                    plan, factors, stats, self.factor_decay,
                    self.stats_reduce, group,
                    comm_precision=self.comm_precision, comm_err=comm_err,
                    capture_impl=cap_impl)
            if self.health is not None and comm_err is not None:
                # a non-finite residual row resets to zero (feedback is a
                # correction, never load-bearing)
                comm_err = engine.where_finite_rows(
                    comm_err, {k: torch.zeros_like(v)
                               for k, v in comm_err.items()})
            if self.health is not None:
                # a non-finite EMA row keeps the last good factor; a row
                # whose stored value is corrupt too restarts from identity
                factors = engine.where_finite_rows(factors, state.factors,
                                                   reinit_identity=True)

        if factors_only:
            return grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp, comm_err=comm_err)

        if stagger_update:
            update_inverse = False
        impl = self.resolved_decomp_impl
        if update_inverse and self.method == 'eigh' and not update_basis:
            refreshed = engine.refresh_decomposition(
                plan, factors, decomp, self.eps, group, self.comm_mode,
                comm_precision=self.comm_precision)
            if self.health is not None:
                refreshed = engine.guard_decomposition(refreshed, decomp,
                                                       'eigh')
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
            decomp_local = engine.compute_decomposition(
                plan, factors, damping, self.method, self.eps, group,
                basis_local=basis_local, warm_sweeps=self.warm_sweeps,
                invs_prev_local=invs_prev, impl=impl)
            if self.health is not None:
                decomp_local = engine.guard_decomposition(
                    decomp_local,
                    engine.local_decomposition(plan, decomp, group,
                                               self.comm_mode, self.method),
                    self.method)
            if self.comm_mode == 'inverse':
                decomp = engine.gather_decomposition(
                    plan, decomp_local, group,
                    comm_precision=self.comm_precision)
            else:
                decomp = decomp_local
        pred_decomp = decomp
        if stagger_update:
            cohorts = self._cohorts
            assert cohorts is not None, \
                'stagger_update requires KFAC(stagger=True) + setup()'
            cohort_idx = state.step % cohorts.num_cohorts
            cohort_new = engine.compute_cohort_decomposition(
                plan, cohorts, factors, cohort_idx, damping, self.method,
                self.eps, group, impl=impl,
                decomp_prev=decomp if self.warm_impl else None,
                comm_mode=self.comm_mode, warm_sweeps=self.warm_sweeps)
            decomp = engine.merge_cohort_decomposition(
                plan, cohorts, decomp, cohort_new, cohort_idx, group,
                self.comm_mode, self.method, guard=self.health is not None,
                comm_precision=self.comm_precision)

        grad_mats = [engine.layer_grad_matrix(m, grads) for m in plan.metas]
        if self.comm_mode == 'inverse':
            preds = engine.compute_pred_replicated(
                plan, pred_decomp, grad_mats, damping, self.method)
        else:
            preds = engine.compute_pred_local(
                plan, pred_decomp, grad_mats, damping, self.method, group,
                comm_precision=self.comm_precision)
        new_grads = engine.preconditioned_grads(plan, grads, grad_mats,
                                                preds, lr, self.kl_clip)
        return new_grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp, comm_err=comm_err)
