"""The K-FAC + SGD training step (port of ``kfac_pytorch_tpu/training.py``),
at world=1 or data-parallel over a process group.

One iteration: forward on this rank's shard (capture armed on
factor-update steps) -> the LOCAL-mean loss -> backward (capture takes
``g``) -> with the F1mc Fisher, a second backward of the same forward
against labels sampled from the model, whose ``g`` replaces the first ->
gradients averaged over the group in fp32 -> ``KFAC.step``
(preconditioned grads) -> SGD (or :class:`MultiSteps`, the gradient
accumulation of ``optax.MultiSteps``); BatchNorm running statistics are
averaged over the group, and the reported loss is the group mean.
Parameters and buffers stay bitwise identical across ranks. Each step
makes the JAX trainer's choice of decomposition (full cold or warm, an
eigenvalue-only refresh, a staggered cohort).

The numerical-health guard (``health.py``, on by default as in JAX)
screens each batch on the device and skips a non-finite one without a
host round trip: parameters, optimizer state, BatchNorm statistics and
the K-FAC state come out bit for bit as they went in. Faults and tracing
are not ported yet (ROADMAP queue 1, slices F and G).
"""

import dataclasses
import hashlib
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch import health as health_lib
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.preconditioner import KFACHyperParams, KFACState
from kfac_pytorch_tpu_torch.utils.losses import sample_pseudo_labels
from kfac_pytorch_tpu_torch.utils.platform import resolve_device


class SGD:
    """SGD with momentum and weight decay in ``torch.optim.SGD``'s order:
    ``g + wd * p``, then ``buf = momentum * buf + g``, then
    ``p += -lr * buf``, with ``lr = lr_schedule(count)`` at the count of
    updates the JAX optimizer has applied (0 on the first step; a batch
    the health guard skipped is not counted). ``lr_schedule`` is a number
    or a schedule of ``utils.lr``."""

    def __init__(self, lr_schedule, momentum=0.9, weight_decay=0.0):
        self.lr_schedule = lr_schedule
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]):
        """Zero momentum buffers, one per parameter."""
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def lr(self, count):
        """The lr at ``count``: a float for an int count; for a 0-d
        integer tensor (the guarded step's device count) a float32 0-d
        tensor on its device, from the schedule's ``device`` form."""
        sched = self.lr_schedule
        if not callable(sched):
            return float(np.float32(sched))
        if not torch.is_tensor(count):
            return float(np.float32(sched(count)))
        on_device = getattr(sched, 'device', None)
        if on_device is None:
            raise TypeError(
                'the guarded step counts updates on the device: give SGD a '
                'number or a utils.lr schedule (with a device form), not '
                f'{sched!r}')
        return on_device(count)

    @torch.no_grad()
    def apply(self, params, grads, opt_state, count):
        """Update ``params`` (and the buffers in ``opt_state``) in place,
        each op once over all tensors (``torch._foreach_*``)."""
        lr = self.lr(count)
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
    own updates (``gradient_step``), not the calls.

    The counters ``mini_step`` and ``gradient_step`` are 0-d int64
    tensors on the parameters' device and every call is the same launches
    with no branch on them: the inner update runs into the tensors and is
    kept only on the ``every_k``-th call (a select, never read back to the
    host)."""

    def __init__(self, inner, every_k):
        if every_k < 1:
            raise ValueError(f'every_k must be >= 1, got {every_k}')
        self.inner = inner
        self.every_k = every_k
        self._keep = self._zero = None

    def init(self, params):
        dev = next(iter(params.values())).device
        return {'mini_step': torch.zeros((), dtype=torch.int64, device=dev),
                'gradient_step': torch.zeros((), dtype=torch.int64,
                                             device=dev),
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
            torch._foreach_sub(g, acc), (n + 1).to(acc[0].dtype)))
        final = n == self.every_k - 1
        self._keep = Snapshot.of([params[k] for k in keys]
                                 + capture.tensor_leaves(opt_state['inner']),
                                 self._keep)
        self._zero = Snapshot.of(acc, self._zero, zeros=True)
        self._keep.save()
        self.inner.apply(params, opt_state['acc'], opt_state['inner'],
                         opt_state['gradient_step'])
        self._keep.restore_unless(final)
        self._zero.restore_unless(~final)
        opt_state['gradient_step'].add_(final.to(torch.int64))
        n.copy_(torch.remainder(n + 1, self.every_k))


def _memory_flat(t):
    """A 1-D view of tensor ``t`` in its memory order (NCHW, channels_last
    and their permuted views alike), or a flat copy when ``t`` is not
    dense."""
    if t.is_contiguous():
        return t.view(-1)
    p = t.permute(sorted(range(t.ndim), key=lambda d: -t.stride(d)))
    return p.view(-1) if p.is_contiguous() else t.reshape(-1)


class Snapshot:
    """A saved copy of a fixed set of dense tensors, put back where a 0-d
    bool flag is false: ``save()`` copies them, ``restore_unless(ok)``
    leaves each tensor as it is where ``ok`` holds and bit for bit as
    saved where it does not (all zeros with ``zeros``, and no ``save``).
    A select, never a multiply by a 0/1 mask (``NaN * 0`` is NaN). The
    tensors are grouped by dtype and device into flat buffers made once
    (:meth:`of` keeps them while the tensors stay the same), so each call
    is a few launches and host ops for any number of tensors: a
    ``torch.cat``, a ``torch.where`` and one ``torch._foreach_copy_`` a
    group."""

    def __init__(self, tensors, zeros=False):
        self.key = self._key(tensors)
        self._groups = []
        groups = {}
        for t in tensors:
            flat = _memory_flat(t)
            if flat.numel() and flat.data_ptr() != t.data_ptr():
                raise ValueError('Snapshot takes dense tensors only')
            groups.setdefault((t.dtype, t.device), []).append(flat)
        for (dtype, dev), flats in groups.items():
            n = sum(f.numel() for f in flats)
            saved, now, sel = (torch.zeros(n, dtype=dtype, device=dev)
                               for _ in range(3))
            self._groups.append((flats, saved, now, sel, list(sel.split(
                [f.numel() for f in flats]))))

    @staticmethod
    def _key(tensors):
        return tuple((t.data_ptr(), t.dtype, t.shape, t.stride())
                     for t in tensors)

    @classmethod
    def of(cls, tensors, prev, zeros=False):
        """``prev`` if it holds these same tensors, else a new one."""
        if prev is not None and prev.key == cls._key(tensors):
            return prev
        return cls(tensors, zeros=zeros)

    @torch.no_grad()
    def save(self):
        for flats, saved, _, _, _ in self._groups:
            torch.cat(flats, out=saved)

    @torch.no_grad()
    def restore_unless(self, ok):
        for flats, saved, now, sel, chunks in self._groups:
            torch.cat(flats, out=now)
            torch.where(ok, now, saved, out=sel)
            torch._foreach_copy_(flats, chunks)


class WorldRescale(NamedTuple):
    """What the batch geometry and the learning rate become after an
    elastic world change (:func:`world_change_rescale`)."""
    old_world: int
    new_world: int
    global_batch: int          # the global batch after the change
    per_host_batch: int        # the per-rank batch after the change
    lr: float                  # the rescaled learning rate
    lr_factor: float           # the lr multiplier applied

    def log_line(self):
        """The trainer's ``WORLD_RESCALE`` protocol line, the JAX
        package's grammar byte for byte."""
        return (f'WORLD_RESCALE from_world={self.old_world} '
                f'to_world={self.new_world} '
                f'global_batch={self.global_batch} '
                f'lr={self.lr:g} lr_factor={self.lr_factor:g}')


def world_change_rescale(old_world, new_world, *, lr, global_batch=None,
                         per_host_batch=None, lr_scaling='linear'):
    """The batch and learning-rate hook of an elastic shrink or grow.
    Exactly one of ``global_batch``/``per_host_batch`` names the batch
    invariant: a fixed GLOBAL batch (the port's trainers, whose loaders
    produce it whatever the world) re-splits as ``ceil(global /
    new_world)`` a rank and keeps the lr (``lr_factor`` 1); a fixed
    PER-RANK batch makes the global batch follow the world, and the lr
    follows it by ``lr_scaling``: 'linear' (Goyal et al.), 'sqrt', or
    'none'. Returns a :class:`WorldRescale`; the trainers log its
    ``log_line()``."""
    old_world, new_world = int(old_world), int(new_world)
    if old_world < 1 or new_world < 1:
        raise ValueError('world sizes must be >= 1, got '
                         f'{old_world} -> {new_world}')
    if (global_batch is None) == (per_host_batch is None):
        raise ValueError('pass exactly one of global_batch / '
                         'per_host_batch (the batch invariant)')
    if lr_scaling not in ('linear', 'sqrt', 'none'):
        raise ValueError(f'lr_scaling must be linear/sqrt/none, '
                         f'got {lr_scaling!r}')
    if global_batch is not None:
        global_batch = int(global_batch)
        per_host = max(1, -(-global_batch // new_world))
        factor = 1.0
        new_global = global_batch
    else:
        per_host = int(per_host_batch)
        new_global = per_host * new_world
        ratio = new_global / (per_host * old_world)
        factor = {'linear': ratio, 'sqrt': float(np.sqrt(ratio)),
                  'none': 1.0}[lr_scaling]
    return WorldRescale(old_world=old_world, new_world=new_world,
                        global_batch=new_global, per_host_batch=per_host,
                        lr=float(lr) * factor, lr_factor=factor)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module     # parameters and BN running statistics
    opt_state: Dict[str, Any]
    kfac_state: Any
    #: whether a decomposition exists yet (before one, the gradients pass
    #: through while the factor statistics accumulate)
    decomposed: bool = False
    #: the health guard's counters (``health.HealthState``); None when the
    #: guard is off
    health: Any = None


def _resolve_health(health, precond):
    """``'auto'`` -> the preconditioner's guard (off without one);
    else ``health.resolve``."""
    if health == 'auto':
        return getattr(precond, 'health', None)
    return health_lib.resolve(health)


def init_train_state(model, tx, precond, sample_input, device=None,
                     health='auto'):
    """Move ``model`` to ``device`` (the GPU unless ``device='cpu'``),
    channels_last for its 4-D weights, discover its K-FAC layers from
    ``sample_input`` (a batch input, numpy or tensor, laid out as
    ``batch['input']``) if the preconditioner is not set up, and initialize
    the optimizer and K-FAC state. ``health`` is ``build_train_step``'s:
    'auto' seeds the health counters iff the preconditioner's guard is
    on; True/False/a HealthConfig override it."""
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
    hstate = (health_lib.HealthState.init(device)
              if _resolve_health(health, precond) is not None else None)
    return TrainState(step=0, model=model, opt_state=tx.init(params),
                      kfac_state=kfac_state, health=hstate)


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
        # flattened first: a contiguous 1x1 conv weight in channels_last
        # keeps a stride other than 1 on its last (size-1) dim
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
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
    warm, st, pf)`` (factor update, inverse update, full decomposition
    rather than refresh, warm start, staggered cohort, prefetched inverse
    update), updating ``seen``. After the first decomposition a staggered
    preconditioner decomposes a cohort every step, at any world; the
    first inverse update of a process is always full and cold, and never
    prefetched (a cold state would precondition with zeros)."""
    enabled = precond.hook_enabled
    uf = precond.should_update_factors(step)
    st = precond.stagger and enabled and seen['yes']
    if st:
        return uf, False, True, False, True, False
    ui = enabled and precond.should_update_inverse(step)
    ub = (not seen['yes']
          or precond.should_update_basis(step, seen.get('last_full')))
    warm = _warm_basis_gate(precond, seen, step, ui, ub)
    pf = precond.comm_prefetch and ui and seen['yes']
    seen['yes'] = seen['yes'] or ui
    if not ui:
        ub, warm = True, False
    if not ub:
        warm = False
    return uf, ui, ub, warm, False, pf


def softmax_cross_entropy(outputs, labels):
    """Mean softmax cross-entropy over the last axis with integer labels,
    in the logits' dtype (``optax.softmax_cross_entropy_with_integer_labels
    (...).mean()``): the F1mc Fisher's default sampling loss, for
    classifiers and LM token heads alike."""
    logp = torch.nn.functional.log_softmax(outputs, dim=-1)
    return -logp.gather(-1, labels.unsqueeze(-1)).mean()


def fisher_generator(seed, step, rank, device):
    """The F1mc pseudo-label stream of one step: a ``torch.Generator`` on
    ``device`` seeded from ``seed``, the domain tag ``0xF15C``, ``step``
    and (under data parallelism) ``rank``, folded in that order as the
    JAX trainer folds its key. A host-side seed: no device round trip."""
    key = seed
    for part in (0xF15C, step) + (() if rank is None else (rank,)):
        digest = hashlib.blake2b(f'{key}:{part}'.encode(),
                                 digest_size=8).digest()
        key = int.from_bytes(digest, 'little') >> 1
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return gen


def build_train_step(model, tx, precond, loss_fn, input_dtype=None, *,
                     health='auto', fisher_type='Femp', fisher_loss_fn=None,
                     fisher_sample_fn=None, fisher_seed=0):
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
    'full', 'warm', 'refresh' or 'cohort'), ``step_fn.last_prefetch``
    whether it was a prefetched inverse update (``KFAC.comm_prefetch``:
    preconditioned with the stored table, the fresh one published for the
    next step), and ``step_fn.last_grads`` holds the gradients it handed
    the optimizer.

    ``health``: the numerical-health guard (``health.py``). 'auto' (the
    default) inherits the preconditioner's ``health`` (off without one);
    True/False/a ``HealthConfig`` override it. When on, the step screens
    the local loss, the averaged gradients and the captured a/g
    (:func:`health.batch_ok`, one scalar all-reduce over the group) and,
    with no host round trip, either applies the update or leaves the
    parameters, optimizer state, BatchNorm buffers and K-FAC factors and
    decompositions bit for bit as they were (the work is done and its
    result dropped by ``torch.where``); consecutive failures climb the
    damping ladder (``effective_damping`` feeds the preconditioner), a
    non-finite preconditioner output or the ladder's top rung gives the
    optimizer the raw gradients, and the optimizer counts only applied
    updates (its lr is taken at ``state.step - health.skipped``, on the
    device). The metrics gain ``health/ok``, ``health/skipped``,
    ``health/rung``, ``health/fallbacks`` and ``health/bad_streak``
    (device tensors; ``utils.metrics.HealthMonitor`` reads them).

    ``fisher_type``: 'Femp' (the empirical Fisher of the real loss) or
    'F1mc', the one-sample Monte-Carlo true Fisher: on factor-update steps
    a second backward of the same forward, against labels drawn from the
    model's own outputs (``fisher_sample_fn(generator, outputs.detach())``,
    default :func:`utils.losses.sample_pseudo_labels`, the generator from
    :func:`fisher_generator`) through ``fisher_loss_fn(outputs, labels)``
    (default :func:`softmax_cross_entropy`), gives the ``g`` the factors
    take; the parameter update keeps the real loss's gradients, and the
    BatchNorm statistics move once (the forward is shared, as XLA shares
    it in the JAX trainer).

    ``step_fn.warm_tracking`` is the process's record of the
    decomposition cadence (the JAX trainer's): ``'yes'`` (a decomposition
    exists: ``state.decomposed``), ``'last_full'`` (the step of the last
    full one) and ``'warm_streak'``. The last two are not part of the
    state: a resumed run's first decomposition is full and cold, and the
    streak restarts from zero. The choice is made on the host before the
    batch is screened, as in JAX, so a skipped batch still counts as the
    step that decomposed.

    A replan queued on the preconditioner (``KFAC.request_replan``) is
    applied at the top of the next step. After any replan that changes the
    step (the invalidator this registers, JAX's), the next step forgets
    ``'last_full'`` and ``'warm_streak'`` and re-derives
    ``state.decomposed`` from the K-FAC state (:func:`has_decomposition`),
    so its next full decomposition is cold and, after a cross-method
    switch left a zero decomposition, the gradients pass through until
    the next inverse update rebuilds it."""
    if fisher_type not in ('Femp', 'F1mc'):
        raise ValueError(f'fisher_type must be Femp or F1mc, '
                         f'got {fisher_type!r}')
    health_cfg = _resolve_health(health, precond)
    if fisher_loss_fn is None:
        fisher_loss_fn = softmax_cross_entropy
    if fisher_sample_fn is None:
        fisher_sample_fn = sample_pseudo_labels
    seen = {}
    if precond is not None:
        # after a replan that changes the step, the next step re-derives
        # from the state whether a decomposition exists (a cross-method
        # switch leaves a zero one) and decomposes cold
        precond.add_invalidator(lambda: seen.update(rederive=True))

    def step_fn(state, batch, lr=None, damping=None):
        step = state.step
        uf = ui = st = pf = factors_only = False
        ub, warm = True, False
        if precond is not None:
            if precond.pending_replan:
                state = dataclasses.replace(
                    state, kfac_state=precond.apply_pending_replan(
                        state.kfac_state))
            if seen.pop('rederive', False):
                for k in ('last_full', 'warm_streak'):
                    seen.pop(k, None)
                state = dataclasses.replace(
                    state, decomposed=has_decomposition(state.kfac_state,
                                                        precond.group))
            seen['yes'] = bool(state.decomposed)
            uf, ui, ub, warm, st, pf = _dispatch(precond, seen, step)
            if st:
                precond.rebase_cohorts()
            # before any decomposition exists the grads pass through while
            # the factor statistics accumulate
            factors_only = not seen['yes']
        # read at every step: a replan may have moved the world
        group = None if precond is None else precond.group
        params = dict(model.named_parameters())
        hstate = state.health
        guard = health_cfg is not None
        if guard:
            dev = next(iter(params.values())).device
            if hstate is None:
                # a state from before the guard (an old checkpoint, a
                # hand-built state) starts from zeroed counters
                hstate = health_lib.HealthState.init(dev)
            # what a skipped batch must leave as it found it; the forward
            # below moves the BatchNorm statistics
            step_fn.keep = Snapshot.of(
                list(params.values()) + list(model.buffers())
                + capture.tensor_leaves(state.opt_state), step_fn.keep)
            step_fn.keep.save()

        model.train()
        x = model_input(model, batch['input'], input_dtype)
        cap = capture.Capture(model, precond.plan.metas if uf else ())
        f1mc = fisher_type == 'F1mc' and uf
        model.zero_grad(set_to_none=True)
        with cap:
            out = model(x)
            loss = loss_fn(out, batch)
            capture.check_local_mean_loss(loss, batch, group)
            loss.backward(retain_graph=f1mc)
            if f1mc:
                rank = None if group is None else coll.axis_index(group)
                pseudo = fisher_sample_fn(
                    fisher_generator(fisher_seed, step, rank, out.device),
                    out.detach())
                floss = fisher_loss_fn(out, pseudo)
                capture.check_local_mean_loss(floss, pseudo, group)
                cap.regrad(floss)
        grads = coll.average_grads({k: p.grad for k, p in params.items()},
                                   group)
        sync_buffers(model, group)
        acts, gs = (cap.acts, cap.gs) if uf else (None, None)
        if guard:
            ok = health_lib.batch_ok(group, grads, loss.detach(), acts, gs)

        kfac_state = old_kfac = state.kfac_state
        new_grads = grads
        precond_ok = None
        if precond is not None:
            kfac_state = old_kfac = _match_comm_err(precond, kfac_state)
            d = precond.damping if damping is None else damping
            if guard:
                d = health_lib.effective_damping(hstate, d, health_cfg)
            hyper = KFACHyperParams(lr=precond.lr if lr is None else lr,
                                    damping=d)
            pgrads, kfac_state = precond.step(
                kfac_state, grads, acts, gs, hyper=hyper,
                update_factors=uf, update_inverse=ui, update_basis=ub,
                warm_basis=warm, factors_only=factors_only,
                stagger_update=st, prefetch=pf)
            new_grads = pgrads
            changed = [k for k in grads if pgrads[k] is not grads[k]]
            if guard and changed:
                # a non-finite preconditioner output, or the ladder's top
                # rung, gives this step the raw gradients; the factor
                # statistics above still accumulated
                precond_ok = capture.all_finite([pgrads[k] for k in changed])
                use = precond_ok & ~health_lib.degraded(hstate, health_cfg)
                new_grads = {**grads, **{k: torch.where(use, pgrads[k],
                                                        grads[k])
                                         for k in changed}}
        # the optimizer counts the updates it applied: a skipped batch is
        # not one
        count = step - hstate.skipped if guard else step
        tx.apply(params, new_grads, state.opt_state, count)

        mets = {'loss': coll.pmean(loss.detach(), group)}
        if guard:
            step_fn.keep.restore_unless(ok)
            if precond is not None:
                kfac_state = _select_kfac_state(ok, kfac_state, old_kfac)
            if precond_ok is None:
                precond_ok = torch.ones((), dtype=torch.bool, device=dev)
            hstate = health_lib.on_good_batch(
                hstate, health_cfg, precond_ok).select(
                    ok, health_lib.on_bad_batch(hstate, health_cfg))
            mets.update({'health/' + k: v for k, v in
                         health_lib.metrics(hstate, ok).items()})

        decomp = None
        # the phases the preconditioner ran, its exclude_parts ablation
        # taken out
        stats = (('stats',) if uf and not (
            precond is not None and precond.exclude_compute_factor) else ())
        if (precond is None or factors_only
                or precond.exclude_compute_inverse):
            phases = stats
        else:
            phases = ('pred',) + stats
            if ui or st:
                phases += ('decomp',) + (
                    ('gather',) if precond.comm_mode == 'inverse'
                    and not precond.exclude_communicate_inverse else ())
                decomp = ('cohort' if st else 'refresh' if not ub
                          else 'warm' if warm else 'full')
        step_fn.last_phases = phases
        step_fn.last_decomp = decomp
        step_fn.last_prefetch = pf
        step_fn.last_grads = new_grads
        state = dataclasses.replace(
            state, step=step + 1, kfac_state=kfac_state,
            decomposed=precond is not None and seen['yes'],
            health=hstate if guard else state.health)
        return state, mets

    step_fn.last_phases = ()
    step_fn.last_decomp = None
    step_fn.last_prefetch = False
    step_fn.last_grads = None
    step_fn.warm_tracking = seen
    step_fn.health = health_cfg
    step_fn.keep = None
    return step_fn


def _select_kfac_state(ok, new, old):
    """The K-FAC state ``new`` where ``ok`` holds, else ``old``'s tensors
    with ``new``'s step (a skipped batch advances the step counter, as
    the JAX skip branch does). A part ``new`` has and ``old`` lacks (the
    E-KFAC moments of a state from before E-KFAC) falls back to zeros,
    the value the step gives such a state."""
    def pick(a, b):
        if a is None or a is b:
            return a
        if isinstance(a, dict):
            return {k: pick(a[k], None if b is None else b.get(k))
                    for k in a}
        if b is None:
            b = torch.zeros_like(a)
        return torch.where(ok, a, b)
    return KFACState(step=new.step, factors=pick(new.factors, old.factors),
                     decomp=pick(new.decomp, old.decomp),
                     comm_err=pick(new.comm_err, old.comm_err))


def has_decomposition(kfac_state, group=None):
    """Whether ``kfac_state`` holds a decomposition (any non-zero entry),
    read back to the host: what ``TrainState.decomposed`` is re-derived
    from after a replan. With a ``group``, whether any rank's does (a
    rank may hold only padding rows, and every rank must take the same
    branch)."""
    if kfac_state is None:
        return False
    mine = any(bool(torch.any(v != 0)) for tree in kfac_state.decomp.values()
               for v in tree.values())
    if group is None:
        return mine
    flags = [None] * coll.axis_size(group)
    torch.distributed.all_gather_object(flags, mine, group=group)
    return any(flags)


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
