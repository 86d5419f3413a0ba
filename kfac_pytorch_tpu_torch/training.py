"""The K-FAC + SGD training step (port of the world=1 Femp path of
``kfac_pytorch_tpu/training.py``).

One iteration: forward (capture armed on factor-update steps) -> loss ->
backward (capture takes ``g``) -> ``KFAC.step`` (preconditioned grads) ->
SGD. The JAX trainer's numerical-health guard (bad-batch skip and the
damping ladder), the F1mc Fisher, faults, sharding and tracing are not
ported yet; the preconditioner's own non-finite screens are.
"""

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from kfac_pytorch_tpu_torch import capture
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


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module     # parameters and BN running statistics
    opt_state: Dict[str, torch.Tensor]
    kfac_state: Any


def init_train_state(model, tx, precond, sample_input, device=None):
    """Move ``model`` to ``device`` (the GPU unless ``device='cpu'``) in
    channels_last, discover its K-FAC layers from ``sample_input`` (NHWC
    numpy or tensor) if the preconditioner is not set up, and initialize
    the optimizer and K-FAC state."""
    device = resolve_device(device)
    model.to(device=device, memory_format=torch.channels_last)
    kfac_state = None
    if precond is not None:
        if precond.plan is None:
            precond.setup(capture.collect_layer_meta(
                model, to_nchw(sample_input, device)))
        kfac_state = precond.init(device)
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, opt_state=tx.init(params),
                      kfac_state=kfac_state)


def to_nchw(x, device):
    """NHWC input (numpy or tensor) -> the NCHW channels_last view."""
    x = torch.as_tensor(x).to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2)


def build_train_step(model, tx, precond, loss_fn):
    """Return ``step_fn(state, batch, lr=None, damping=None) -> (state,
    metrics)``. ``batch`` holds tensors on the model's device: ``'input'``
    NHWC and whatever ``loss_fn(outputs, batch)`` reads; ``loss_fn`` is the
    local-mean loss. ``lr``/``damping`` feed the preconditioner (KL clip
    and damping). ``step_fn.last_phases`` names the K-FAC phases of the
    last call ('pred', 'stats', 'decomp') and ``step_fn.last_grads`` holds
    its preconditioned gradients."""
    seen = {'inverse': False}

    def step_fn(state, batch, lr=None, damping=None):
        step = state.step
        uf = ui = factors_only = False
        if precond is not None:
            uf = precond.should_update_factors(step)
            ui = precond.hook_enabled and precond.should_update_inverse(step)
            # before any decomposition exists the grads pass through while
            # the factor statistics accumulate
            factors_only = not (seen['inverse'] or ui)
            seen['inverse'] = seen['inverse'] or ui

        model.train()
        x = batch['input'].permute(0, 3, 1, 2)
        cap = capture.Capture(model)
        model.zero_grad(set_to_none=True)
        if uf:
            with cap:
                out = model(x)
                loss = loss_fn(out, batch)
                capture.check_local_mean_loss(loss, batch, None)
                loss.backward()
        else:
            out = model(x)
            loss = loss_fn(out, batch)
            loss.backward()
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}

        kfac_state = state.kfac_state
        if precond is not None:
            hyper = KFACHyperParams(
                lr=precond.lr if lr is None else lr,
                damping=precond.damping if damping is None else damping)
            grads, kfac_state = precond.step(
                kfac_state, grads, cap.acts, cap.gs, hyper=hyper,
                update_factors=uf, update_inverse=ui,
                factors_only=factors_only)
        tx.apply(params, grads, state.opt_state, step)

        if precond is None or factors_only:
            phases = ('stats',) if uf else ()
        else:
            phases = ('pred',) + (('stats',) if uf else ()) \
                + (('decomp',) if ui else ())
        step_fn.last_phases = phases
        step_fn.last_grads = grads
        state = dataclasses.replace(state, step=step + 1,
                                    kfac_state=kfac_state)
        return state, {'loss': loss.detach()}

    step_fn.last_phases = ()
    step_fn.last_grads = None
    return step_fn


def eval_step(model, batch, loss_fn):
    """``(loss, accuracy)`` of ``model`` in eval mode on one batch."""
    from kfac_pytorch_tpu_torch.utils.metrics import accuracy
    model.eval()
    with torch.no_grad():
        out = model(batch['input'].permute(0, 3, 1, 2))
        return loss_fn(out, batch), accuracy(out, batch['label'])
