"""The K-FAC + SGD training step (port of the Femp path of
``kfac_pytorch_tpu/training.py``), at world=1 or data-parallel over a
process group.

One iteration: forward on this rank's shard (capture armed on
factor-update steps) -> the LOCAL-mean loss -> backward (capture takes
``g``) -> gradients averaged over the group in fp32 -> ``KFAC.step``
(preconditioned grads) -> SGD (or :class:`MultiSteps`, the gradient
accumulation of ``optax.MultiSteps``); BatchNorm running statistics are
averaged over the group, and the reported loss is the group mean.
Parameters and buffers stay bitwise identical across ranks. Each step
makes the JAX trainer's choice of decomposition (full cold or warm, an
eigenvalue-only refresh, a staggered cohort). The JAX trainer's
numerical-health guard (bad-batch skip and the damping ladder), the F1mc
Fisher, faults and tracing are not ported yet; the preconditioner's own
non-finite screens are.
"""

import dataclasses
import hashlib
from typing import Any, Dict

import numpy as np
import torch

from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams
from kfac_pytorch_tpu_torch.utils.platform import resolve_device


class SGD:
    """SGD with momentum and weight decay in ``torch.optim.SGD``'s order:
    ``g + wd * p``, then ``buf = momentum * buf + g``, then
    ``p += -lr * buf``, with ``lr = lr_schedule(step)`` at the step index
    the JAX optimizer's count gives (0 on the first step)."""

    def __init__(self, lr_schedule, momentum=0.9, weight_decay=0.0):
        self.lr_schedule = (lr_schedule if callable(lr_schedule)
                            else (lambda step: lr_schedule))
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]):
        """Zero momentum buffers, one per parameter."""
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def apply(self, params, grads, opt_state, count):
        """Update ``params`` (and the buffers in ``opt_state``) in place,
        each op once over all tensors (``torch._foreach_*``)."""
        lr = float(np.float32(self.lr_schedule(count)))
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        buf = [opt_state[k] for k in keys]
        if self.weight_decay:
            g = torch._foreach_add(torch._foreach_mul(p, self.weight_decay),
                                   g)
        torch._foreach_mul_(buf, self.momentum)
        torch._foreach_add_(buf, g)
        torch._foreach_add_(p, torch._foreach_mul(buf, -lr))


def sgd(lr_schedule, momentum=0.9, weight_decay=0.0):
    """The reference harness optimizer (see :class:`SGD`)."""
    return SGD(lr_schedule, momentum=momentum, weight_decay=weight_decay)


class MultiSteps:
    """Gradient accumulation, ``optax.MultiSteps(inner, every_k)`` with
    its default mean: every call folds the gradients into a running mean
    (``acc + (g - acc) / (n + 1)``, optax's Welford update), and every
    ``every_k``-th call applies ``inner`` to that mean and resets it; the
    calls between change no parameter. ``inner``'s lr schedule counts its
    own updates (``gradient_step``), not the calls."""

    def __init__(self, inner, every_k):
        if every_k < 1:
            raise ValueError(f'every_k must be >= 1, got {every_k}')
        self.inner = inner
        self.every_k = every_k

    def init(self, params):
        return {'mini_step': 0, 'gradient_step': 0,
                'inner': self.inner.init(params),
                'acc': {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def apply(self, params, grads, opt_state, count):
        """Accumulate ``grads``; on the ``every_k``-th call update
        ``params`` in place. ``count`` (the caller's step) is unused: the
        inner schedule reads ``gradient_step``."""
        del count
        n = opt_state['mini_step']
        keys = list(params)
        acc = [opt_state['acc'][k] for k in keys]
        g = [grads[k] for k in keys]
        torch._foreach_add_(acc, torch._foreach_div(
            torch._foreach_sub(g, acc), n + 1))
        if n == self.every_k - 1:
            self.inner.apply(params, opt_state['acc'], opt_state['inner'],
                             opt_state['gradient_step'])
            opt_state['gradient_step'] += 1
            torch._foreach_zero_(acc)
        opt_state['mini_step'] = (n + 1) % self.every_k


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module     # parameters and BN running statistics
    opt_state: Dict[str, Any]
    kfac_state: Any
    #: whether a decomposition exists yet (before one, the gradients pass
    #: through while the factor statistics accumulate)
    decomposed: bool = False


def init_train_state(model, tx, precond, sample_input, device=None):
    """Move ``model`` to ``device`` (the GPU unless ``device='cpu'``),
    channels_last for its 4-D weights, discover its K-FAC layers from
    ``sample_input`` (a batch input, numpy or tensor, laid out as
    ``batch['input']``) if the preconditioner is not set up, and initialize
    the optimizer and K-FAC state."""
    device = resolve_device(device)
    model.to(device=device, memory_format=torch.channels_last)
    kfac_state = None
    if precond is not None:
        if precond.plan is None:
            x = torch.as_tensor(sample_input).to(device, non_blocking=True)
            precond.setup(capture.collect_layer_meta(model,
                                                     model_input(model, x)))
        kfac_state = precond.init(device)
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, opt_state=tx.init(params),
                      kfac_state=kfac_state)


def model_input(model, x, dtype=None):
    """``batch['input']`` as ``model`` takes it, by ``model.input_layout``:
    an ``'NHWC'`` image batch becomes its NCHW view (channels_last in
    memory when the batch is NHWC-contiguous), cast to ``dtype`` if one is
    given (the JAX trainers' ``batch['input'].astype(dtype)``);
    ``'tokens'`` pass as they are."""
    if model.input_layout == 'NHWC':
        x = x.permute(0, 3, 1, 2)
        return x if dtype is None else x.to(dtype)
    if model.input_layout == 'tokens':
        return x
    raise ValueError(f'unknown input_layout {model.input_layout!r}')


def sync_buffers(model, group):
    """Average ``model``'s floating buffers (BatchNorm running
    statistics) over the group in place, through one all-reduce — the
    JAX trainer's pmean of the mutated ``batch_stats``."""
    bufs = [b for b in model.buffers() if b.dtype.is_floating_point]
    if group is None or not bufs:
        return
    with torch.no_grad():
        for b, v in zip(bufs, coll.pmean_flat(bufs, group)):
            b.copy_(v)


def replica_digest(model):
    """SHA-1 of ``model``'s parameters and buffers, bit for bit: equal on
    every rank while the replicas agree."""
    h = hashlib.sha1()
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _warm_basis_gate(precond, seen, step, ui, ub):
    """Warm or cold, for a full decomposition, updating the run's ``seen``
    record: warm only once a full one exists in this process (the stored
    basis must be orthogonal, not zeros) and cold again after
    ``cold_restart_every`` warm ones in a row. An explicit iterative
    ``decomp_impl`` warms through the same gate."""
    streak = seen.get('warm_streak', 0)
    warm = ((precond.warm_start_basis or precond.warm_impl)
            and 'last_full' in seen
            and streak < precond.cold_restart_every)
    if ui and ub:
        seen['last_full'] = step
        seen['warm_streak'] = streak + 1 if warm else 0
    return warm


def _dispatch(precond, seen, step):
    """The JAX trainer's host-side choice for one step: ``(uf, ui, ub,
    warm, st)`` (factor update, inverse update, full decomposition rather
    than refresh, warm start, staggered cohort), updating ``seen``. After
    the first decomposition a staggered preconditioner decomposes a cohort
    every step; the first inverse update of a process is always full and
    cold."""
    enabled = precond.hook_enabled
    uf = precond.should_update_factors(step)
    st = precond.stagger and enabled and seen['yes']
    if st:
        return uf, False, True, False, True
    ui = enabled and precond.should_update_inverse(step)
    ub = (not seen['yes']
          or precond.should_update_basis(step, seen.get('last_full')))
    warm = _warm_basis_gate(precond, seen, step, ui, ub)
    seen['yes'] = seen['yes'] or ui
    if not ui:
        ub, warm = True, False
    if not ub:
        warm = False
    return uf, ui, ub, warm, False


def build_train_step(model, tx, precond, loss_fn, input_dtype=None):
    """Return ``step_fn(state, batch, lr=None, damping=None) -> (state,
    metrics)``. ``batch`` holds this rank's shard as tensors on the
    model's device: ``'input'`` (see :func:`model_input`; cast to
    ``input_dtype`` if given) and whatever ``loss_fn(outputs, batch)``
    reads; ``loss_fn`` is the local-mean loss.
    The data-parallel process group is the preconditioner's (``group``;
    None at world=1). ``lr``/``damping`` feed the preconditioner (KL clip
    and damping). ``step_fn.last_phases`` names the K-FAC phases of the
    last call ('pred', 'stats', 'decomp', 'gather'), as the JAX trainer
    does; ``step_fn.last_decomp`` says which decomposition it ran (None,
    'full', 'warm', 'refresh' or 'cohort'), and ``step_fn.last_grads``
    holds its preconditioned gradients.

    ``step_fn.warm_tracking`` is the process's record of the
    decomposition cadence (the JAX trainer's): ``'yes'`` (a decomposition
    exists: ``state.decomposed``), ``'last_full'`` (the step of the last
    full one) and ``'warm_streak'``. The last two are not part of the
    state: a resumed run's first decomposition is full and cold, and the
    streak restarts from zero."""
    group = None if precond is None else precond.group
    seen = {}

    def step_fn(state, batch, lr=None, damping=None):
        step = state.step
        uf = ui = st = factors_only = False
        ub, warm = True, False
        if precond is not None:
            seen['yes'] = bool(state.decomposed)
            uf, ui, ub, warm, st = _dispatch(precond, seen, step)
            if st:
                precond.rebase_cohorts()
            # before any decomposition exists the grads pass through while
            # the factor statistics accumulate
            factors_only = not seen['yes']

        model.train()
        x = model_input(model, batch['input'], input_dtype)
        cap = capture.Capture(model, precond.plan.metas if uf else ())
        model.zero_grad(set_to_none=True)
        with cap:
            out = model(x)
            loss = loss_fn(out, batch)
            capture.check_local_mean_loss(loss, batch, group)
            loss.backward()
        params = dict(model.named_parameters())
        grads = coll.average_grads({k: p.grad for k, p in params.items()},
                                   group)
        sync_buffers(model, group)

        kfac_state = state.kfac_state
        if precond is not None:
            kfac_state = _match_comm_err(precond, kfac_state)
            hyper = KFACHyperParams(
                lr=precond.lr if lr is None else lr,
                damping=precond.damping if damping is None else damping)
            grads, kfac_state = precond.step(
                kfac_state, grads, cap.acts, cap.gs, hyper=hyper,
                update_factors=uf, update_inverse=ui, update_basis=ub,
                warm_basis=warm, factors_only=factors_only,
                stagger_update=st)
        tx.apply(params, grads, state.opt_state, step)

        decomp = None
        if precond is None or factors_only:
            phases = ('stats',) if uf else ()
        else:
            phases = ('pred',) + (('stats',) if uf else ())
            if ui or st:
                phases += ('decomp',) + (
                    ('gather',) if precond.comm_mode == 'inverse' else ())
                decomp = ('cohort' if st else 'refresh' if not ub
                          else 'warm' if warm else 'full')
        step_fn.last_phases = phases
        step_fn.last_decomp = decomp
        step_fn.last_grads = grads
        state = dataclasses.replace(
            state, step=step + 1, kfac_state=kfac_state,
            decomposed=precond is not None and seen['yes'])
        return state, {'loss': coll.pmean(loss.detach(), group)}

    step_fn.last_phases = ()
    step_fn.last_decomp = None
    step_fn.last_grads = None
    step_fn.warm_tracking = seen
    return step_fn


def _match_comm_err(precond, kfac_state):
    """Give the state the residual its preconditioner's config carries:
    zeros when a lossy MPD wire was switched on (or a state built without
    one is resumed), none when the wire went back to fp32 (the residual
    is a correction, never load-bearing). Host-side, before the step."""
    if kfac_state is None:
        return None
    has = kfac_state.comm_err is not None
    if precond.tracks_comm_err and not has:
        dev = next(iter(kfac_state.factors.values())).device
        return dataclasses.replace(kfac_state,
                                   comm_err=precond.zero_comm_err(dev))
    if has and not precond.tracks_comm_err:
        return dataclasses.replace(kfac_state, comm_err=None)
    return kfac_state


def eval_step(model, batch, loss_fn, input_dtype=None):
    """``(loss, accuracy)`` of ``model`` in eval mode on one batch, the
    input cast to ``input_dtype`` if given."""
    from kfac_pytorch_tpu_torch.utils.metrics import accuracy
    model.eval()
    with torch.no_grad():
        out = model(model_input(model, batch['input'], input_dtype))
        return loss_fn(out, batch), accuracy(out, batch['label'])


def fp32_cross_entropy(outputs, batch):
    """The ImageNet trainer's eval loss: softmax cross-entropy of the
    logits cast to fp32 (``examples/imagenet_resnet.py`` ``eval_step``)."""
    return torch.nn.functional.cross_entropy(outputs.float(),
                                             batch['label'])
