"""Checkpoint save, restore and auto-resume (port of
``kfac_pytorch_tpu/utils/checkpoint.py``).

A checkpoint of epoch ``e`` is one blob, ``checkpoint-<e>.pt`` (a
``torch.save`` file of the train state), and its manifest,
``checkpoint-<e>.manifest.json``, written LAST through the atomic put of
:class:`~kfac_pytorch_tpu_torch.store.PosixStore`: the epoch is committed
exactly when its manifest exists, and the manifest's sha256 and size of
the blob are checked before a restore reads it. The manifest's schema is
the JAX package's (``store/manifest.py``), kind ``'torch'``, with the
world stamp's ``num_devices``/``gen``/``lineage`` copied in.

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

At world>1 each rank holds only its own K-FAC rows: every rank calls
:func:`save_checkpoint` with the group, every rank's K-FAC state reaches
rank 0 on the host, and rank 0 writes ONE blob holding the list in rank
order (``kfac_state``) and the world size (``kfac_world``); the model,
optimizer, step and health parts are the same on every rank. A restore
at the same world hands rank r entry r; a restore at another world goes
through :func:`~kfac_pytorch_tpu_torch.resilience.elastic_resume`, which
reads the world stamp (:func:`write_world_stamp`) and carries the list
into the new layout with :func:`reshard_kfac_state`.

``block=False`` snapshots the state to host memory on the calling thread
(so the next step may change the live tensors at once) and leaves the
serialization, the blob's write and the manifest's commit to one
background writer: the epoch is restorable only once
:func:`wait_for_checkpoints` has returned. ``retry=`` (a
``resilience.RetryPolicy``) retries a failing write or restore; once the
policy is spent the failure raises. The residual of a lossy stats reduce
(``comm_err``) is a correction, never load-bearing: a checkpoint that
carries one restores into a run that tracks none by dropping it, and one
without it restores into a lossy run with a zero residual.

Not ported: the HTTP object store and its remote contract (ROADMAP
queue 1, slice G).
"""

import dataclasses
import io
import logging
import os
import pickle
import re
import signal
import threading

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.health import HealthState
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.preconditioner import KFACState
from kfac_pytorch_tpu_torch.store import PosixStore
from kfac_pytorch_tpu_torch.store import manifest as _manifest

#: the manifest ``kind`` of the port's checkpoints
KIND = 'torch'

log = logging.getLogger(__name__)

#: the background writer of the last ``block=False`` save: ``(thread,
#: outcome)``, where ``outcome`` gains ``'error'`` if the write failed
_PENDING = None


class CheckpointCorruptError(OSError):
    """A committed blob failed its manifest hash or size check: silent
    storage corruption. :func:`auto_resume` scans down past it."""


class StaleLineageError(RuntimeError):
    """This process belongs to an abandoned (fenced) fork of the pod: the
    ``world.json`` on disk records a newer lineage than the one this
    process was launched with. Resuming, or stamping, would clobber the
    surviving lineage's state, so both refuse."""


def blob_key(epoch):
    return f'checkpoint-{int(epoch)}.pt'


def _store(base_dir):
    return PosixStore(os.path.abspath(str(base_dir)))


def _process_index():
    """This process's global rank (0 without a process group): the
    writer of the world stamp and the pruner, as ``jax.process_index()``
    is in the JAX package."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def kfac_tree(kfac_state):
    """The parts of a ``KFACState`` a checkpoint holds, as a dict."""
    return {'step': kfac_state.step, 'factors': kfac_state.factors,
            'decomp': kfac_state.decomp, 'comm_err': kfac_state.comm_err}


def _host_copy(tree):
    """``tree`` with every tensor copied to host memory (a new tensor even
    for a CPU one, so later in-place updates of the live state do not
    reach it)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to('cpu', copy=True)
    return tree


def _gather_to_writer(obj, group):
    """Every rank's ``obj`` in rank order on the group's rank 0 (None on
    the others), through the host."""
    out = [None] * coll.axis_size(group) if coll.axis_index(group) == 0 \
        else None
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, 0),
                       group=group)
    return out


def save_checkpoint(base_dir, epoch, state, include_kfac=True, block=True,
                    retry=None, group=None):
    """Write checkpoint ``epoch`` of ``state`` (a ``training.TrainState``)
    under ``base_dir``: the blob first, then the manifest.

    ``group``: the K-FAC process group at world>1. Every rank of it must
    call the save (the K-FAC states are gathered to rank 0 on the host);
    only rank 0 writes. Without a group only process 0 writes, and
    ``state.kfac_state`` may also be a whole world's states held on one
    host (a list, one state a rank).
    ``block=False`` returns once the state is snapshotted to host memory
    (and gathered); the write runs on a background writer, and the epoch
    is committed once :func:`wait_for_checkpoints` returns. A save first
    joins the previous writer, and logs its failure if it had one.
    ``retry``: a ``resilience.RetryPolicy`` for the write (serialize, put
    the blob, commit the manifest); a write that still fails raises (at
    :func:`wait_for_checkpoints` for ``block=False``)."""
    _join_pending(raise_error=False)
    keep_kfac = include_kfac and state.kfac_state is not None
    world = coll.axis_size(group)
    kfac = None
    if keep_kfac and isinstance(state.kfac_state, list):
        # a whole world's states, held on this host
        world = len(state.kfac_state)
        kfac = [_host_copy(kfac_tree(st)) for st in state.kfac_state]
    elif keep_kfac:
        kfac = _host_copy(kfac_tree(state.kfac_state))
        if world > 1:
            kfac = _gather_to_writer(kfac, group)
    writer = (coll.axis_index(group) == 0 if group is not None
              else _process_index() == 0)
    if not writer:
        return
    health = state.health
    payload = {'step': int(state.step),
               'decomposed': bool(state.decomposed) and keep_kfac,
               'model': _host_copy(state.model.state_dict()),
               'opt_state': _host_copy(state.opt_state),
               'kfac_world': world if keep_kfac else None,
               'kfac_state': kfac,
               'health': (None if health is None else _host_copy(
                   {f.name: getattr(health, f.name)
                    for f in dataclasses.fields(health)}))}

    def write():
        buf = io.BytesIO()
        torch.save(payload, buf)
        blob = buf.getvalue()
        store = _store(base_dir)
        key = blob_key(epoch)
        store.put(key, blob)
        _commit_manifest(base_dir, store, epoch, {key: blob})

    def attempt():
        if retry is None:
            return write()
        from kfac_pytorch_tpu_torch.resilience.retry import call_with_retry
        return call_with_retry(write, policy=retry,
                               label=f'save checkpoint-{epoch}')

    if block:
        attempt()
        return
    global _PENDING
    outcome = {}

    def run():
        try:
            attempt()
        except BaseException as e:  # noqa: BLE001 - re-raised at the join
            outcome['error'] = e

    thread = threading.Thread(target=run, name=f'kfac-ckpt-{epoch}')
    thread.start()
    _PENDING = (thread, outcome)


def _commit_manifest(base_dir, store, epoch, blobs):
    """The commit point: the blob is durable, and the manifest naming it
    (sha256 and size, plus the world stamp's provenance) lands last, in
    one atomic put."""
    stamp = read_world_stamp_info(base_dir)
    manifest = _manifest.build_manifest(epoch, KIND, blobs, stamp=stamp)
    store.put(_manifest.manifest_key(epoch),
              _manifest.encode_manifest(manifest))
    log.info('ckpt: committed manifest epoch=%d blobs=%d kind=%s',
             int(epoch), len(manifest['blobs']), KIND)


def _join_pending(raise_error):
    """Join the background writer; its failure is raised
    (``raise_error``) or logged."""
    global _PENDING
    if _PENDING is None:
        return
    thread, outcome = _PENDING
    thread.join()
    _PENDING = None
    err = outcome.get('error')
    if err is None:
        return
    if raise_error:
        raise err
    log.error('a previous async checkpoint save failed (its epoch is not '
              'committed); attempting this save anyway', exc_info=err)


def wait_for_checkpoints():
    """Block until the last ``block=False`` save is durable and its
    manifest committed; re-raise its failure if it had one. Only after
    this returns is that save restorable."""
    _join_pending(raise_error=True)


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


def write_world_stamp(base_dir, num_devices, gen=None, lineage=None):
    """Record the K-FAC world the checkpoints in ``base_dir`` are taken
    at (``world.json``, written atomically by process 0 only; the JAX
    package's format). :func:`~kfac_pytorch_tpu_torch.resilience.
    elastic_resume` compares it with the relaunched run's world and
    routes a difference, either way, through the reshard. ``gen`` is
    provenance (the pod generation); ``lineage`` is protocol state: the
    stamp never moves backward, and a writer at a lower lineage than the
    one on disk raises :class:`StaleLineageError` (the check and the
    write are serialized by an advisory ``flock`` beside the stamp where
    the filesystem has one)."""
    if _process_index() != 0:
        return
    from kfac_pytorch_tpu_torch.resilience import atomic_write_json
    os.makedirs(base_dir, exist_ok=True)
    stamp = {'num_devices': int(num_devices)}
    if gen is not None:
        stamp['gen'] = int(gen)
    target = os.path.join(os.path.abspath(base_dir), 'world.json')
    if lineage is None:
        atomic_write_json(target, stamp)
        return
    import contextlib
    lock_cm = contextlib.nullcontext()
    try:
        import fcntl
        lock_f = open(target + '.lock', 'w')
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        lock_cm = lock_f    # closing it releases the lock
    except (ImportError, OSError):
        pass
    with lock_cm:
        existing = read_world_stamp_info(base_dir)
        if (existing is not None
                and isinstance(existing.get('lineage'), int)
                and existing['lineage'] > int(lineage)):
            raise StaleLineageError(
                f'world stamp in {base_dir} is at lineage '
                f'{existing["lineage"]} but this process is at lineage '
                f'{int(lineage)}: refusing to move the stamp backward '
                '(this host belongs to an abandoned fork of the pod)')
        stamp['lineage'] = int(lineage)
        atomic_write_json(target, stamp)


def read_world_stamp_info(base_dir):
    """The whole ``world.json`` (``num_devices``, and ``gen``/``lineage``
    when stamped), or None: an absent or corrupt stamp reads as None."""
    import json
    path = os.path.join(os.path.abspath(base_dir), 'world.json')
    try:
        with open(path) as f:
            stamp = json.load(f)
        stamp['num_devices'] = int(stamp['num_devices'])
        return stamp
    except (OSError, ValueError, KeyError, TypeError):
        return None


def read_world_stamp(base_dir):
    """The stamped ``num_devices``, or None (no stamp: a same-world
    resume)."""
    stamp = read_world_stamp_info(base_dir)
    return None if stamp is None else stamp['num_devices']


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


def check_like(want, got, path):
    """Raise ValueError unless ``got`` has ``want``'s structure: the same
    dict keys and, for tensors, the same shape and dtype."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            raise ValueError(f'checkpoint {path}: keys differ from the '
                             'target state')
        for k in want:
            check_like(want[k], got[k], f'{path}.{k}')
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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def kfac_state_to(kfac_state, device):
    """``kfac_state`` with every tensor on ``device``."""
    return KFACState(
        step=kfac_state.step, factors=_to(kfac_state.factors, device),
        decomp=_to(kfac_state.decomp, device),
        comm_err=(None if kfac_state.comm_err is None
                  else _to(kfac_state.comm_err, device)))


def _restored_kfac(target, saved):
    """One rank's saved K-FAC state laid out like ``target`` (its device
    and its residual: a saved ``comm_err`` is dropped when the target
    tracks none, and a missing one starts from zeros when it does)."""
    tree = kfac_tree(target)
    for part in ('factors', 'decomp'):
        check_like(tree[part], saved[part], f'kfac_state.{part}')
    dev = next(iter(target.factors.values())).device
    comm_err = None
    if target.comm_err is not None:
        if saved['comm_err'] is None:
            comm_err = {k: torch.zeros_like(v)
                        for k, v in target.comm_err.items()}
        else:
            check_like(target.comm_err, saved['comm_err'],
                       'kfac_state.comm_err')
            comm_err = _to(saved['comm_err'], dev)
    return KFACState(step=int(saved['step']),
                     factors=_to(saved['factors'], dev),
                     decomp=_to(saved['decomp'], dev), comm_err=comm_err)


def _restore_into(target, payload, group=None):
    """The state ``payload`` holds, laid into ``target`` (a
    ``training.TrainState``); every structure is checked before anything
    is written, so a mismatch leaves ``target`` as it was. The target's
    ``kfac_state`` is this rank's (entry ``rank`` of a checkpoint of the
    group's world) or, for a host-side restore of a whole world, a list
    with one state a rank."""
    model_sd = target.model.state_dict()
    check_like(model_sd, payload['model'], 'model')
    check_like(target.opt_state, payload['opt_state'], 'opt_state')
    saved = payload['kfac_state']
    kfac_state = target.kfac_state
    if saved is not None:
        if kfac_state is None:
            raise ValueError('checkpoint carries a K-FAC state; the target '
                             'has none')
        saved = saved if isinstance(saved, list) else [saved]
        want = (len(kfac_state) if isinstance(kfac_state, list)
                else coll.axis_size(group))
        if len(saved) != want:
            raise ValueError(f'checkpoint holds the K-FAC states of a '
                             f'{len(saved)}-rank world; the target is '
                             f'{want} rank(s) (resume at another world '
                             'through resilience.elastic_resume)')
        if isinstance(kfac_state, list):
            kfac_state = [_restored_kfac(t, s)
                          for t, s in zip(kfac_state, saved)]
            dropped = kfac_state[0].comm_err is None
        else:
            kfac_state = _restored_kfac(kfac_state,
                                        saved[coll.axis_index(group)])
            dropped = kfac_state.comm_err is None
        if dropped and saved[0]['comm_err'] is not None:
            log.info('checkpoint carries an error-feedback residual '
                     '(comm_err) this run\'s comm_precision does not use; '
                     'residual discarded')
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


def restore_checkpoint(base_dir, epoch, target_state, retry=None,
                       group=None):
    """The train state of committed checkpoint ``epoch``, laid into
    ``target_state`` (its model is loaded in place; its tensors' devices
    are kept; at world>1 this rank of ``group`` takes its own K-FAC
    entry). Raises :class:`CheckpointCorruptError` when the blob fails
    its manifest, FileNotFoundError when the epoch is not committed, and
    ValueError when its structure (or world) does not match the
    target's. ``retry``: a ``resilience.RetryPolicy`` for the read."""
    if retry is not None:
        from kfac_pytorch_tpu_torch.resilience.retry import call_with_retry
        return call_with_retry(
            lambda: _restore_once(base_dir, epoch, target_state, group),
            policy=retry, label=f'restore checkpoint-{epoch}')
    return _restore_once(base_dir, epoch, target_state, group)


def _restore_once(base_dir, epoch, target_state, group):
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
    payload = torch.load(io.BytesIO(data), map_location='cpu',
                         weights_only=True)
    return _restore_into(target_state, payload, group)


def auto_resume(base_dir, max_epoch, target_state, retry=None, group=None):
    """``(restored state, epoch)`` of the newest restorable checkpoint at
    or below ``max_epoch``, or ``(None, None)``. An epoch that fails to
    restore (a blob that fails its hash, a structure that does not match)
    is logged with its error, and the scan goes on to the next older
    one. ``retry`` applies to each restore attempt, so a transient read
    failure of the newest epoch is retried in place."""
    epoch = find_resume_epoch(base_dir, max_epoch)
    while epoch is not None:
        try:
            return (restore_checkpoint(base_dir, epoch, target_state,
                                       retry=retry, group=group), epoch)
        except (OSError, ValueError, RuntimeError,
                pickle.UnpicklingError):
            log.warning('checkpoint-%d in %s is unreadable; falling back to '
                        'the next-older epoch', epoch, base_dir,
                        exc_info=True)
        epoch = find_resume_epoch(base_dir, epoch - 1) if epoch > 0 else None
    return None, None


_PRUNE_RE = re.compile(r'^checkpoint-(\d+)(\.pt|\.manifest\.json)$')


def prune_checkpoints(base_dir, keep):
    """Keep only the ``keep`` newest checkpoint epochs (no-op for
    ``keep`` None or <= 0, and on every process but 0). An older epoch's
    manifest goes first, so a crash mid-prune leaves an uncommitted blob,
    never a committed epoch without its blob. Other files are left alone.
    Safe beside a ``block=False`` save in flight: that epoch is the
    newest, and its blob is written under a temp name until it is
    whole."""
    if (keep is None or keep <= 0 or _process_index() != 0
            or not os.path.isdir(base_dir)):
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
    installed before; :meth:`uninstall` puts those back.

    With a process ``group``, poll :meth:`should_stop`, not the raw flag:
    ranks can receive the signal at different steps, and a rank that left
    the loop alone would strand the others in a collective.
    ``should_stop`` ORs the flag over the group (every ``sync_every``
    steps when given the step, at every call otherwise), so every rank
    stops at the same step."""

    def __init__(self, signals=None, sync_every=20, group=None):
        self._flag = False
        self._stopped = False
        self.sync_every = max(1, sync_every)
        self.group = group
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

    def should_stop(self, step=None):
        """Whether a preemption signal arrived: this process's flag, or,
        with a group, the OR over its ranks."""
        if self.group is None:
            return self._flag
        if self._stopped:
            return True
        if step is not None and step % self.sync_every != 0:
            return False
        flags = [None] * coll.axis_size(self.group)
        dist.all_gather_object(flags, self._flag, group=self.group)
        self._stopped = any(flags)
        return self._stopped
