"""Process-group set-up and batch sharding (port of
``kfac_pytorch_tpu/parallel/mesh.py``).

The JAX package builds one mesh over all devices and initializes
``jax.distributed`` from its launcher's environment. Here each rank is
one process, started by ``torchrun`` (``python -m
kfac_pytorch_tpu_torch.launch``) or by :func:`launch.spawn`, and the
K-FAC world is the default process group.
"""

import os
import time

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


def shard_batch(batch, rank, world):
    """Rank ``rank``'s rows of a global host batch: ``[r*B/P, (r+1)*B/P)``
    of every array (the DistributedSampler counterpart; the global batch
    is the invariant, as in the JAX trainer)."""
    out = {}
    for k, v in batch.items():
        n = np.shape(v)[0]
        if n % world:
            raise ValueError(f'batch of {n} rows does not split over '
                             f'{world} ranks')
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out
