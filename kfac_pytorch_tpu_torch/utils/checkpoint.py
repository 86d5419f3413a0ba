"""Checkpoint save, restore and auto-resume (port of
``kfac_pytorch_tpu/utils/checkpoint.py``).

A checkpoint of epoch ``e`` is one blob, ``checkpoint-<e>.pt`` (a
``torch.save`` file of the train state), and its manifest,
``checkpoint-<e>.manifest.json``, written LAST through the atomic put of
:class:`~kfac_pytorch_tpu_torch.store.PosixStore`: the epoch is committed
exactly when its manifest exists, and the manifest's sha256 and size of
the blob are checked before a restore reads it. The manifest's schema is
the JAX package's (``store/manifest.py``), kind ``'torch'``.

The blob holds the model's ``state_dict`` (parameters and BatchNorm
running statistics), the optimizer state (SGD momentum, or
:class:`~kfac_pytorch_tpu_torch.training.MultiSteps`' counters,
accumulator and inner state), the step count, the K-FAC state (factors,
decompositions, step counter, ``comm_err``), whether a decomposition
exists yet (``TrainState.decomposed``) and the health guard's counters
(``TrainState.health``), so a resumed run continues bit for bit, as the
JAX docstring promises. A blob written before the guard existed restores
with zeroed counters (``HealthState.init``), as the JAX pre-health
fallback does, and its ``MultiSteps`` counters, Python ints then, land
in the 0-d tensors the optimizer keeps now. ``include_kfac=False`` leaves the
K-FAC state out, the reference's behaviour: the factors then start again
from the identity and the first steps only accumulate statistics.

:func:`reshard_kfac_state` re-lays a K-FAC state from one plan into
another on the host (``KFAC.replan`` uses it for every move it cannot
carry verbatim). Not ported yet (ROADMAP queue 1, item 13): asynchronous
saves (``block=False``), the trainers' resume at another world size, the
world stamp and lineage fence, the HTTP store and ``RetryPolicy``. Every
save blocks, so :func:`wait_for_checkpoints` has nothing to wait for.
"""

import dataclasses
import io
import logging
import os
import pickle
import re
import signal

import torch

from kfac_pytorch_tpu_torch.health import HealthState
from kfac_pytorch_tpu_torch.preconditioner import KFACState
from kfac_pytorch_tpu_torch.store import PosixStore
from kfac_pytorch_tpu_torch.store import manifest as _manifest

#: the manifest ``kind`` of the port's checkpoints
KIND = 'torch'
_LATER = 'is not ported yet (ROADMAP queue 1, item 13)'

log = logging.getLogger(__name__)


class CheckpointCorruptError(OSError):
    """A committed blob failed its manifest hash or size check: silent
    storage corruption. :func:`auto_resume` scans down past it."""


def blob_key(epoch):
    return f'checkpoint-{int(epoch)}.pt'


def _store(base_dir):
    return PosixStore(os.path.abspath(str(base_dir)))


def _kfac_payload(kfac_state):
    return {'step': kfac_state.step, 'factors': kfac_state.factors,
            'decomp': kfac_state.decomp, 'comm_err': kfac_state.comm_err}


def save_checkpoint(base_dir, epoch, state, include_kfac=True, block=True):
    """Write checkpoint ``epoch`` of ``state`` (a ``training.TrainState``)
    under ``base_dir``: the blob first, then the manifest. Blocks until
    both are on disk."""
    if not block:
        raise NotImplementedError(f'save_checkpoint(block=False) {_LATER}')
    keep_kfac = include_kfac and state.kfac_state is not None
    payload = {'step': int(state.step),
               'decomposed': bool(state.decomposed) and keep_kfac,
               'model': state.model.state_dict(),
               'opt_state': state.opt_state,
               'kfac_state': (_kfac_payload(state.kfac_state) if keep_kfac
                              else None),
               'health': (None if state.health is None
                          else dataclasses.asdict(state.health))}
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    store = _store(base_dir)
    key = blob_key(epoch)
    store.put(key, blob)
    manifest = _manifest.build_manifest(epoch, KIND, {key: blob})
    store.put(_manifest.manifest_key(epoch),
              _manifest.encode_manifest(manifest))
    log.info('ckpt: committed manifest epoch=%d blobs=%d kind=%s',
             int(epoch), len(manifest['blobs']), KIND)


def _global_rows(pre, states, x_of):
    """One state component in the global device-major row layout, from
    the per-rank states: rows concatenated in rank order, or rank 0's for
    a decomposition replicated by comm_mode 'inverse'."""
    parts = [x_of(st) for st in states]
    return parts[0] if pre.comm_mode == 'inverse' else torch.cat(parts)


def reshard_kfac_state(pre_old, pre_new, kfac_state, carry_decomp=False):
    """Re-lay a K-FAC state from ``pre_old``'s plan into ``pre_new``'s
    (both set up on the same layers), on the host. ``kfac_state`` is the
    whole state: the world=1 state, or the list of every rank's states in
    rank order. Returns the new world's state the same way (a list of
    per-rank states when it has more than one rank).

    The factor EMAs move row by row through both plans' per-layer row
    maps (their true blocks; pads and new dummy rows start from the fresh
    identity), and the step counter is kept. Decompositions restart at
    zero, unless ``carry_decomp`` and both decompose by the same method:
    then every layer's rows move whole (a row's decomposition belongs to
    its identity-padded factor alone, so a whole-row move is exact; eigh
    sorts the pad's unit eigenpairs in among the true ones, so a true
    block could not be cut out). The E-KFAC moments are comm-mode shaped
    and restart at zero, like the error-feedback residual."""
    plan_o, plan_n = pre_old.plan, pre_new.plan
    assert plan_o is not None and plan_n is not None, 'call setup() first'
    sig_o = [(m.name, m.in_dim, m.out_dim) for m in plan_o.metas]
    sig_n = [(m.name, m.in_dim, m.out_dim) for m in plan_n.metas]
    if sig_o != sig_n:
        raise ValueError('reshard_kfac_state needs the same layers (names '
                         f'and dims): {sig_o} != {sig_n}')
    states = (list(kfac_state) if isinstance(kfac_state, (list, tuple))
              else [kfac_state])
    if len(states) != plan_o.num_devices:
        raise ValueError(f'{len(states)} states for a '
                         f'{plan_o.num_devices}-rank plan')
    dev = next(iter(states[0].factors.values())).device
    old_f = {k: torch.cat([st.factors[k] for st in states])
             for k in states[0].factors}
    factors = {str(d): torch.eye(d, device=dev).repeat(
        plan_n.buckets[d].n_rows, 1, 1) for d in plan_n.bucket_dims}
    carry = carry_decomp and pre_old.method == pre_new.method
    parts = ('evals', 'evecs') if pre_new.method == 'eigh' else ('invs',)
    decomp = {p: {str(d): torch.zeros(
        (plan_n.buckets[d].n_rows,) + ((d,) if p == 'evals' else (d, d)),
        device=dev) for d in plan_n.bucket_dims} for p in parts}
    old_d = {}
    if carry:
        old_d = {p: {k: _global_rows(pre_old, states,
                                     lambda st, p=p, k=k: st.decomp[p][k])
                     for k in states[0].decomp[p]} for p in parts}
    with torch.no_grad():
        for i, meta in enumerate(plan_o.metas):
            ba_o, ra_o, bg_o, rg_o, _ = plan_o.layer_rows[i]
            ba_n, ra_n, bg_n, rg_n, _ = plan_n.layer_rows[i]
            da, dg = meta.in_dim, meta.out_dim
            factors[str(ba_n)][ra_n, :da, :da] = \
                old_f[str(ba_o)][ra_o, :da, :da]
            factors[str(bg_n)][rg_n, :dg, :dg] = \
                old_f[str(bg_o)][rg_o, :dg, :dg]
            for p in old_d:
                decomp[p][str(ba_n)][ra_n] = old_d[p][str(ba_o)][ra_o]
                decomp[p][str(bg_n)][rg_n] = old_d[p][str(bg_o)][rg_o]
    out = []
    for r in range(plan_n.num_devices):
        def mine(x, b, decomposition=False):
            if decomposition and pre_new.comm_mode == 'inverse':
                return x.clone()
            per = plan_n.buckets[b].per_dev
            return x[r * per:(r + 1) * per].clone()
        dec = {p: {k: mine(v, int(k), True) for k, v in tree.items()}
               for p, tree in decomp.items()}
        if pre_new.method == 'eigh' and pre_new.ekfac:
            dec['scales'] = pre_new._zero_scales(dev)
        out.append(KFACState(
            step=states[0].step,
            factors={k: mine(v, int(k)) for k, v in factors.items()},
            decomp=dec, comm_err=pre_new.zero_comm_err(dev)))
    return out[0] if len(out) == 1 else out


def find_resume_epoch(base_dir, max_epoch):
    """The newest committed epoch at or below ``max_epoch``, scanning
    downward, or None. A blob without a manifest is a torn commit (the
    writer died between the two) and is skipped; the port has no
    checkpoints from before manifests."""
    committed = set(_manifest.manifest_epochs(_store(base_dir)))
    for e in range(max_epoch, -1, -1):
        if e in committed:
            return e
        if os.path.exists(os.path.join(base_dir, blob_key(e))):
            log.warning('checkpoint-%d in %s has no manifest (torn '
                        'commit); skipping it in the resume scan', e,
                        base_dir)
    return None


def _check_like(want, got, path):
    """Raise ValueError unless ``got`` has ``want``'s structure: the same
    dict keys and, for tensors, the same shape and dtype."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            raise ValueError(f'checkpoint {path}: keys differ from the '
                             'target state')
        for k in want:
            _check_like(want[k], got[k], f'{path}.{k}')
    elif (torch.is_tensor(want) and want.ndim == 0
          and not want.is_floating_point() and type(got) is int):
        return      # a counter older checkpoints saved as a Python int
    elif torch.is_tensor(want):
        if (not torch.is_tensor(got) or got.shape != want.shape
                or got.dtype != want.dtype):
            raise ValueError(f'checkpoint {path}: '
                             f'{getattr(got, "shape", type(got))} does not '
                             f'match the target {tuple(want.shape)} '
                             f'{want.dtype}')
    elif want is not None and type(got) is not type(want):
        raise ValueError(f'checkpoint {path}: {type(got).__name__} where '
                         f'the target has {type(want).__name__}')


def _copy_into(want, got):
    """``got``'s values in ``want``'s tensors (their device and memory
    format kept) and ``got``'s python scalars."""
    if isinstance(want, dict):
        return {k: _copy_into(want[k], got[k]) for k in want}
    if torch.is_tensor(want):
        with torch.no_grad():
            return want.fill_(got) if type(got) is int else want.copy_(got)
    return got


def _restore_into(target, payload):
    """The state ``payload`` holds, laid into ``target`` (a
    ``training.TrainState``); every structure is checked before anything
    is written, so a mismatch leaves ``target`` as it was."""
    model_sd = target.model.state_dict()
    _check_like(model_sd, payload['model'], 'model')
    _check_like(target.opt_state, payload['opt_state'], 'opt_state')
    saved = payload['kfac_state']
    kfac_state = target.kfac_state
    if saved is not None:
        if kfac_state is None:
            raise ValueError('checkpoint carries a K-FAC state; the target '
                             'has none')
        for part in ('factors', 'decomp'):
            _check_like(_kfac_payload(kfac_state)[part], saved[part],
                        f'kfac_state.{part}')
        dev = next(iter(kfac_state.factors.values())).device
        kfac_state = KFACState(
            step=int(saved['step']),
            factors=_to(saved['factors'], dev),
            decomp=_to(saved['decomp'], dev),
            comm_err=(None if saved['comm_err'] is None
                      else _to(saved['comm_err'], dev)))
    hstate = target.health
    if hstate is not None:
        dev = hstate.rung.device
        saved_h = payload.get('health')
        hstate = (HealthState.init(dev) if saved_h is None else
                  HealthState(**{k: v.to(dev) for k, v in saved_h.items()}))
    target.model.load_state_dict(payload['model'])
    opt_state = _copy_into(target.opt_state, payload['opt_state'])
    return dataclasses.replace(
        target, step=int(payload['step']), opt_state=opt_state,
        kfac_state=kfac_state, health=hstate,
        decomposed=bool(payload['decomposed']) and saved is not None)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def restore_checkpoint(base_dir, epoch, target_state):
    """The train state of committed checkpoint ``epoch``, laid into
    ``target_state`` (its model is loaded in place; its tensors' devices
    are kept). Raises :class:`CheckpointCorruptError` when the blob fails
    its manifest, FileNotFoundError when the epoch is not committed, and
    ValueError when its structure does not match the target's."""
    store = _store(base_dir)
    manifest = _manifest.read_manifest(store, epoch)
    if manifest is None:
        raise FileNotFoundError(f'checkpoint-{epoch} is not committed in '
                                f'{base_dir}')
    if manifest.get('kind') != KIND:
        raise ValueError(f'checkpoint-{epoch} is a {manifest.get("kind")!r} '
                         f'checkpoint, not the port\'s {KIND!r}')
    key = blob_key(epoch)
    spec = manifest['blobs'].get(key)
    data = store.get(key)
    reason = ('not in the manifest' if spec is None
              else _manifest.blob_problem(data, spec))
    if reason is not None:
        log.warning('ckpt: corrupt blob key=%s epoch=%d reason=%s', key,
                    int(epoch), reason)
        raise CheckpointCorruptError(f'checkpoint-{epoch} failed manifest '
                                     f'verification: {key} ({reason})')
    device = next(target_state.model.parameters()).device
    payload = torch.load(io.BytesIO(data), map_location=device,
                         weights_only=True)
    return _restore_into(target_state, payload)


def auto_resume(base_dir, max_epoch, target_state):
    """``(restored state, epoch)`` of the newest restorable checkpoint at
    or below ``max_epoch``, or ``(None, None)``. An epoch that fails to
    restore (a blob that fails its hash, a structure that does not match)
    is logged with its error, and the scan goes on to the next older
    one."""
    epoch = find_resume_epoch(base_dir, max_epoch)
    while epoch is not None:
        try:
            return restore_checkpoint(base_dir, epoch, target_state), epoch
        except (OSError, ValueError, RuntimeError,
                pickle.UnpicklingError):
            log.warning('checkpoint-%d in %s is unreadable; falling back to '
                        'the next-older epoch', epoch, base_dir,
                        exc_info=True)
        epoch = find_resume_epoch(base_dir, epoch - 1) if epoch > 0 else None
    return None, None


def wait_for_checkpoints():
    """Block until every save is durable: every save already blocks
    (``block=False`` is not ported), so there is nothing in flight."""


_PRUNE_RE = re.compile(r'^checkpoint-(\d+)(\.pt|\.manifest\.json)$')


def prune_checkpoints(base_dir, keep):
    """Keep only the ``keep`` newest checkpoint epochs (no-op for
    ``keep`` None or <= 0). An older epoch's manifest goes first, so a
    crash mid-prune leaves an uncommitted blob, never a committed epoch
    without its blob. Other files are left alone."""
    if keep is None or keep <= 0 or not os.path.isdir(base_dir):
        return
    by_epoch = {}
    for name in os.listdir(base_dir):
        m = _PRUNE_RE.match(name)
        if m:
            by_epoch.setdefault(int(m.group(1)), []).append(name)
    for epoch in sorted(by_epoch)[:-keep]:
        for name in sorted(by_epoch[epoch], key=lambda n: '.pt' in n):
            os.remove(os.path.join(base_dir, name))


class PreemptionGuard:
    """Turns a preemption signal (SIGTERM by default) into a flag that
    the trainer polls at step boundaries: it then saves the current state
    and exits cleanly inside the grace window. Handlers chain to the ones
    installed before; :meth:`uninstall` puts those back. One process (the
    JAX guard's cross-host OR is not needed at world=1)."""

    def __init__(self, signals=None):
        self._flag = False
        self._prev = {}
        for s in signals or (signal.SIGTERM,):
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._flag = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def uninstall(self):
        """Restore the handlers this guard displaced (idempotent;
        uninstall nested guards in reverse order)."""
        for s, prev in self._prev.items():
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._prev = {}

    def should_stop(self):
        """Whether a preemption signal arrived."""
        return self._flag
