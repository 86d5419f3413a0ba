"""The K-FAC preconditioner (port of ``kfac_pytorch_tpu/preconditioner.py``).

  variant       stats_reduce   method      comm_mode
  ----------    ------------   ---------   ---------
  inverse       pmean (MPD)    cholesky    'pred' or 'inverse'
  eigen         pmean (MPD)    eigh        'inverse'
  inverse_dp    local  (DP)    cholesky    'pred'
  eigen_dp      local  (DP)    eigh        'pred'   (the main path)
  ekfac         pmean (MPD)    eigh        'inverse' + E-KFAC moments
  ekfac_dp      local  (DP)    eigh        'pred'    + E-KFAC moments

All six names are accepted; this slice runs the DP variants at world=1
(``eigen_dp`` end to end, ``inverse_dp`` through the same code with the
Cholesky branch). The others raise ``NotImplementedError`` naming the
port slice that brings them.

``step`` maps ``(state, grads, captured a/g) -> (preconditioned grads,
new state)`` and leaves its inputs untouched, like the JAX version; the
trainer picks ``update_factors``/``update_inverse`` on the host from
``should_update_*``.
"""

import dataclasses
from typing import Dict, Optional

import torch

from kfac_pytorch_tpu_torch import engine
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
    ``factors[str(D)]`` is ``[rows, D, D]``; ``decomp`` holds
    ``evals``/``evecs`` (eigh) or ``invs`` (Cholesky) keyed the same way."""
    step: int
    factors: Dict[str, torch.Tensor]
    decomp: Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class KFACHyperParams:
    """Per-step hyper-parameters (schedulable without rebuilding)."""
    lr: float
    damping: float


_VARIANTS = {
    'inverse': dict(stats_reduce='pmean', method='cholesky'),
    'eigen': dict(stats_reduce='pmean', method='eigh'),
    'inverse_dp': dict(stats_reduce='local', method='cholesky'),
    'eigen_dp': dict(stats_reduce='local', method='eigh'),
    'ekfac': dict(stats_reduce='pmean', method='eigh', ekfac=True),
    'ekfac_dp': dict(stats_reduce='local', method='eigh', ekfac=True),
}

_LATER = {
    'inverse': 'slice B (MPD factor averaging and world>1)',
    'eigen': 'slice B (MPD factor averaging and the inverse gather)',
    'ekfac': 'slice D (E-KFAC moments)',
    'ekfac_dp': 'slice D (E-KFAC moments)',
}


class KFAC:
    """K-FAC gradient preconditioner.

    Args (reference semantics unless noted):
      variant: one of the six names in the table above.
      lr, damping, fac_update_freq, kfac_update_freq, kl_clip,
      factor_decay, hook_enabled, batch_averaged: as in the JAX package.
      bucket_fn: factor dim -> bucket dim (default ``default_bucket_fn``).
      eps: eigenvalue clamp (``d * (d > eps)``).
      capture_impl: None | 'xla' | 'pallas' | 'auto' (see
        ``CAPTURE_IMPLS``). With 'pallas'/'auto' at world=1 every factor
        row is one fused kernel launch with the EMA in its epilogue
        (``engine.update_factors_fused``).

    The world is one device (world>1 is port slice B). The JAX package's
    in-engine health screens are always on: factor and decomposition rows
    that come back non-finite fall back to their last good value (pure
    pass-through on finite values).
    """

    def __init__(self, variant='eigen_dp', lr=0.1, damping=0.001,
                 fac_update_freq=1, kfac_update_freq=1, kl_clip=0.001,
                 factor_decay=0.95, hook_enabled=True, batch_averaged=True,
                 bucket_fn=None, eps=1e-10, capture_impl=None):
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
        self.variant = variant
        self.stats_reduce = cfg['stats_reduce']
        self.method = cfg['method']
        self.comm_mode = 'pred'
        self.lr = lr
        self.damping = damping
        self.fac_update_freq = fac_update_freq
        self.kfac_update_freq = kfac_update_freq
        self.kl_clip = kl_clip if (kl_clip is not None and kl_clip > 0) \
            else None
        self.factor_decay = factor_decay
        self.hook_enabled = hook_enabled
        self.batch_averaged = batch_averaged
        self.num_devices = 1
        self.bucket_fn = bucket_fn or default_bucket_fn
        self.eps = eps
        self.capture_impl = capture_impl
        self.plan = None

    def setup(self, metas):
        """Build the static factor plan from ``{name: LayerMeta}`` (or a
        meta list)."""
        if not isinstance(metas, dict):
            metas = {m.name: m for m in metas}
        self.plan = build_plan(metas, num_devices=self.num_devices,
                               comm_mode=self.comm_mode,
                               bucket_fn=self.bucket_fn)
        return self.plan

    @property
    def resolved_capture_impl(self):
        """'auto' resolves to the fused kernels ('pallas'); others as set."""
        return 'pallas' if self.capture_impl == 'auto' else self.capture_impl

    def init(self, device=None):
        """Identity factors and zero decompositions on ``device`` (the GPU
        unless ``device='cpu'`` is asked for)."""
        assert self.plan is not None, 'call setup() first'
        device = resolve_device(device)
        plan = self.plan
        factors = {str(d): torch.eye(d, device=device).repeat(
            plan.buckets[d].n_rows, 1, 1) for d in plan.bucket_dims}
        zeros = {str(d): torch.zeros((plan.buckets[d].n_rows, d, d),
                                     device=device)
                 for d in plan.bucket_dims}
        if self.method == 'eigh':
            decomp = {'evals': {str(d): torch.zeros(
                          (plan.buckets[d].n_rows, d), device=device)
                          for d in plan.bucket_dims},
                      'evecs': zeros}
        else:
            decomp = {'invs': zeros}
        return KFACState(step=0, factors=factors, decomp=decomp)

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
        ``{parameter name: tensor}``; only K-FAC layers' entries change.
        ``factors_only`` accumulates statistics and returns the grads
        untouched (before any decomposition exists)."""
        assert self.plan is not None, 'call setup() first'
        plan = self.plan
        if hyper is None:
            hyper = KFACHyperParams(lr=self.lr, damping=self.damping)
        factors, decomp = state.factors, state.decomp
        dev = next(iter(factors.values())).device
        damping = torch.as_tensor(hyper.damping, dtype=torch.float32,
                                  device=dev)
        lr = torch.as_tensor(hyper.lr, dtype=torch.float32, device=dev)

        if update_factors:
            if self.resolved_capture_impl == 'pallas':
                # world=1 local stats: capture -> factor GEMM -> EMA is one
                # fused kernel per factor row
                factors = engine.update_factors_fused(
                    plan, factors, acts, gs, self.batch_averaged,
                    self.factor_decay)
            else:
                a_list, g_list = engine.compute_layer_stats(
                    plan, acts, gs, self.batch_averaged)
                stats = engine.stack_stats(plan, a_list, g_list)
                factors = engine.update_factors(
                    plan, factors, stats, self.factor_decay,
                    self.stats_reduce)
            factors = engine.where_finite_rows(factors, state.factors,
                                               reinit_identity=True)

        if factors_only:
            return grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp)

        if update_inverse:
            decomp = engine.guard_decomposition(
                engine.compute_decomposition(plan, factors, damping,
                                             self.method, self.eps),
                decomp, self.method)

        grad_mats = [engine.layer_grad_matrix(m, grads) for m in plan.metas]
        preds = engine.compute_pred_local(plan, decomp, grad_mats, damping,
                                          self.method)
        new_grads = engine.preconditioned_grads(plan, grads, grad_mats,
                                                preds, lr, self.kl_clip)
        return new_grads, KFACState(step=state.step + 1, factors=factors,
                                    decomp=decomp)
