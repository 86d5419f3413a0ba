"""Process-group set-up and batch sharding (port of
``kfac_pytorch_tpu/parallel/mesh.py``).

The JAX package builds one mesh over all devices and initializes
``jax.distributed`` from its launcher's environment. Here each rank is
one process, started by ``torchrun`` (``python -m
kfac_pytorch_tpu_torch.launch``) or by :func:`launch.spawn`, and the
K-FAC world is the default process group.
"""

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

#: the environment torchrun exports to every rank
ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')

#: words of a connection failure: the only failures worth retrying (a
#: malformed address or a second initialization fail the same way again)
_CONNECT_WORDS = ('connect', 'refused', 'timed out', 'timeout',
                  'unavailable', 'reset by peer', 'broken pipe')


def _connection_failure(exc):
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    return isinstance(exc, (OSError, RuntimeError)) and any(
        w in str(exc).lower() for w in _CONNECT_WORDS)


def init_with_retry(init, attempts=5, base_delay=1.0, max_delay=15.0,
                    sleep=time.sleep):
    """Call ``init()``, retrying connection failures only, with doubling
    back-off (``base_delay``, capped at ``max_delay``): on a restart every
    rank races the rendezvous listener coming back up. Any other failure,
    or the last attempt's, is raised."""
    delay = base_delay
    for attempt in range(attempts):
        try:
            return init()
        except Exception as exc:  # noqa: BLE001 — filtered just below
            if attempt == attempts - 1 or not _connection_failure(exc):
                raise
            sleep(delay)
            delay = min(2 * delay, max_delay)


def maybe_initialize_distributed(backend, num_devices=None, retry=True,
                                 env=None):
    """Initialize the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``).
    Returns the group, or None when the environment names no world
    larger than one. ``num_devices``, when given, must equal
    ``WORLD_SIZE``. An NCCL group binds the rank to ``cuda:LOCAL_RANK``
    first. ``retry=False`` fails on the first connection error."""
    env = os.environ if env is None else env
    world = int(env.get('WORLD_SIZE', '1'))
    if num_devices is not None and num_devices != world:
        raise ValueError(f'--num-devices {num_devices} but the launcher '
                         f'started WORLD_SIZE={world} ranks')
    if world <= 1:
        return None
    missing = [k for k in ENV if k not in env]
    if missing:
        raise RuntimeError(f'WORLD_SIZE={world} without {missing}: launch '
                           'with python -m kfac_pytorch_tpu_torch.launch '
                           '(torchrun)')
    if dist.is_initialized():
        return dist.group.WORLD
    if backend == 'nccl':
        torch.cuda.set_device(int(env['LOCAL_RANK']))
    url = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"

    def init():
        dist.init_process_group(backend, init_method=url, world_size=world,
                                rank=int(env['RANK']))

    if retry:
        init_with_retry(init)
    else:
        init()
    return dist.group.WORLD


def local_rank(env=None):
    """This process's ``LOCAL_RANK`` (0 outside a launcher)."""
    env = os.environ if env is None else env
    return int(env.get('LOCAL_RANK', '0'))


def _rows(v, rank, world):
    """Rank ``rank``'s rows of one array, or of each array of a tuple
    (a model of several inputs)."""
    if isinstance(v, (tuple, list)):
        return tuple(_rows(t, rank, world) for t in v)
    n = np.shape(v)[0]
    if n % world:
        raise ValueError(f'batch of {n} rows does not split over '
                         f'{world} ranks')
    per = n // world
    return v[rank * per:(rank + 1) * per]


def shard_batch(batch, rank, world):
    """Rank ``rank``'s rows of a global host batch: ``[r*B/P, (r+1)*B/P)``
    of every array, or of every array of a tuple input (the
    DistributedSampler counterpart; the global batch is the invariant,
    as in the JAX trainer)."""
    return {k: _rows(v, rank, world) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class Grid:
    """A data x seq grid of ranks: the port's ``Mesh(devices.reshape(nd,
    ns), ('data', 'seq'))``. World rank ``r = d * ns + s``; ``seq`` is
    the group of the ranks that share ``d`` (size ``ns``), None when the
    axis has size 1, as a mesh axis of size 1 is left out. The data axis
    has no group: K-FAC and the gradient average run over the world."""
    nd: int
    ns: int
    d: int
    s: int
    seq: Any = None


def make_grid(nd, ns, group=None):
    """The :class:`Grid` of ``nd x ns`` ranks over ``group`` (None: one
    rank, no group), which must hold ``nd * ns`` ranks. Every rank
    creates every seq group, in the same order (``new_group`` is
    collective)."""
    world = 1 if group is None else dist.get_world_size(group)
    if nd < 1 or ns < 1 or nd * ns != world:
        raise ValueError(f'a {nd} x {ns} grid needs {nd * ns} ranks, the '
                         f'process group has {world}')
    if world == 1:
        return Grid(nd, ns, 0, 0)
    d, s = divmod(dist.get_rank(group), ns)
    ranks = [dist.get_global_rank(group, i) for i in range(world)]
    # an axis of size 1 gets no group; ns is the same on every rank, so
    # every rank skips it alike
    seq = None
    for i in range(nd if ns > 1 else 0):
        g = dist.new_group([ranks[i * ns + j] for j in range(ns)])
        seq = g if i == d else seq
    return Grid(nd, ns, d, s, seq)


def shard_tokens(batch, grid):
    """Rank ``(d, s)``'s block of a global host batch of ``[B, L]``
    arrays, ``P('data', 'seq')``: rows ``[d*B/nd, (d+1)*B/nd)`` and
    columns ``[s*L/ns, (s+1)*L/ns)``."""
    out = {}
    for k, v in batch.items():
        b, n = np.shape(v)[:2]
        if b % grid.nd or n % grid.ns:
            raise ValueError(f'a batch of {b} x {n} tokens does not split '
                             f'over the {grid.nd} x {grid.ns} grid')
        pb, pl = b // grid.nd, n // grid.ns
        out[k] = v[grid.d * pb:(grid.d + 1) * pb,
                   grid.s * pl:(grid.s + 1) * pl]
    return out
