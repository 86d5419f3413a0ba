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
trainer picks ``update_factors``/``update_inverse`` on the host from
``should_update_*``. At world>1 the state is each rank's own: its factor
rows, its error-feedback residual, and (comm_mode 'pred') its
decomposition rows; in comm_mode 'inverse' the gathered decomposition is
the same on every rank.
"""

import dataclasses
from typing import Dict, Optional

import torch

from kfac_pytorch_tpu_torch import engine
from kfac_pytorch_tpu_torch.capture import filter_vocab_head
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.plan import build_plan, default_bucket_fn
from kfac_pytorch_tpu_torch.utils.platform import resolve_device

#: capture-kernel ladder, the JAX package's values: 'xla' is the
#: ops/factors.py path, 'pallas' the fused capture kernels (the name is
#: kept from the JAX package; in the port it means the hand-written CUDA
#: kernels of ops/capture_kernels.py), 'auto' resolves to 'pallas'.
#: None keeps the unfused path: plain torch ops, the covariance GEMM as
#: torch.matmul. So the four values select two paths: 'xla' is the same
#: as None, and 'auto' observes nothing yet (it always picks the kernels).
CAPTURE_IMPLS = ('xla', 'pallas', 'auto')


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
    'ekfac': 'slice D (E-KFAC moments)',
    'ekfac_dp': 'slice D (E-KFAC moments)',
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

    The JAX package's in-engine health screens are always on: factor and
    decomposition rows that come back non-finite fall back to their last
    good value, and a non-finite residual row resets to zero (pure
    pass-through on finite values).
    """

    def __init__(self, variant='eigen_dp', lr=0.1, damping=0.001,
                 fac_update_freq=1, kfac_update_freq=1,
                 communicate_inverse_or_not=False, kl_clip=0.001,
                 factor_decay=0.95, exclude_vocabulary_size=None,
                 hook_enabled=True, batch_averaged=True, num_devices=1,
                 group=None, assignment='round_robin',
                 distribute_layer_factors=None, bucket_fn=None, eps=1e-10,
                 comm_precision='fp32', comm_mode=None, capture_impl=None):
        if variant not in _VARIANTS:
            raise KeyError(f'unknown variant {variant!r}')
        if variant in _LATER:
            raise NotImplementedError(
                f'variant {variant!r} is not ported yet: port '
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
        self.plan = None

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
        return self.plan

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

    def step(self, state: KFACState, grads, acts=None, gs=None,
             hyper: Optional[KFACHyperParams] = None, *,
             update_factors: bool = True, update_inverse: bool = True,
             factors_only: bool = False):
        """One K-FAC step: ``(state, grads, captured a/g) ->
        (preconditioned grads, new state)``. ``grads`` is
        ``{parameter name: tensor}``, already averaged over the group;
        only K-FAC layers' entries change. ``acts``/``gs`` are this rank's
        captures. ``factors_only`` accumulates statistics and returns the
        grads untouched (before any decomposition exists)."""
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
            if comm_err is not None:
                # a non-finite residual row resets to zero (feedback is a
                # correction, never load-bearing)
                comm_err = engine.where_finite_rows(
                    comm_err, {k: torch.zeros_like(v)
                               for k, v in comm_err.items()})
            factors = engine.where_finite_rows(factors, state.factors,
                                               reinit_identity=True)

        if factors_only:
            return grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp, comm_err=comm_err)

        if update_inverse:
            decomp_local = engine.guard_decomposition(
                engine.compute_decomposition(plan, factors, damping,
                                             self.method, self.eps, group),
                engine.local_decomposition(plan, decomp, group,
                                           self.comm_mode, self.method),
                self.method)
            if self.comm_mode == 'inverse':
                decomp = engine.gather_decomposition(
                    plan, decomp_local, group,
                    comm_precision=self.comm_precision)
            else:
                decomp = decomp_local

        grad_mats = [engine.layer_grad_matrix(m, grads) for m in plan.metas]
        if self.comm_mode == 'inverse':
            preds = engine.compute_pred_replicated(plan, decomp, grad_mats,
                                                   damping, self.method)
        else:
            preds = engine.compute_pred_local(
                plan, decomp, grad_mats, damping, self.method, group,
                comm_precision=self.comm_precision)
        new_grads = engine.preconditioned_grads(plan, grads, grad_mats,
                                                preds, lr, self.kl_clip)
        return new_grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp, comm_err=comm_err)
