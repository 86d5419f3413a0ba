"""Launcher of the port's world>1 trainers, and the process spawner its
tests and ``chip_smoke.py`` share.

  python -m kfac_pytorch_tpu_torch.launch --nproc 2 -- train_cifar \\
      --kfac-name eigen --kfac-comm-precision bf16 --kfac-capture-impl auto
  python -m kfac_pytorch_tpu_torch.launch --nproc 4 -- train_lm \\
      --data-devices 2 --seq-devices 2 --dist-backend gloo

starts ``--nproc`` ranks of the trainer on this host through ``torchrun``
(``torch.distributed.run``, static rendezvous on 127.0.0.1), which
exports ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
``MASTER_PORT`` to each; the trainer initializes the process group from
them (``parallel.mesh``). Before it starts anything the launcher checks
what ``launch_tpu.sh`` checks for the JAX trainers: the world size
(``--num-devices``, added when absent, must equal ``--nproc``; for the
LM ``--data-devices`` x ``--seq-devices`` must) and the
devices: on the GPU (the default) a CUDA device must exist, and an NCCL
world needs one card per rank (NCCL refuses two ranks on one card; take
``--dist-backend gloo`` for that). Exits with the trainers' code.

:func:`spawn` runs a function on ``world`` fresh processes joined in one
process group and returns each rank's result.
"""

import multiprocessing
import queue
import socket
import subprocess
import sys
import time
import traceback

#: trainer name -> module
TRAINERS = {name: f'kfac_pytorch_tpu_torch.{name}' for name in (
    'train_cifar', 'train_imagenet', 'train_lm', 'train_multi30k',
    'train_squad')}
#: trainers whose world is a grid, not ``--num-devices``
GRID_TRAINERS = ('train_lm',)

USAGE = ('usage: python -m kfac_pytorch_tpu_torch.launch --nproc N '
         '[--master-port P] -- TRAINER [trainer flags]; trainers: '
         + ', '.join(TRAINERS))


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on right now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _flag(args, name, default=None):
    """The value of ``--name v`` / ``--name=v`` in ``args`` (the last
    occurrence wins, as argparse has it)."""
    val = default
    for i, a in enumerate(args):
        if a == name and i + 1 < len(args):
            val = args[i + 1]
        elif a.startswith(name + '='):
            val = a.split('=', 1)[1]
    return val


def check_world(nproc, trainer_args, cuda_available=None, device_count=None,
                trainer='train_cifar'):
    """Validate a launch of ``nproc`` ranks of ``trainer`` with
    ``trainer_args``; return the trainer's arguments with
    ``--num-devices`` set (the LM has none: its ``--data-devices`` x
    ``--seq-devices`` must equal ``nproc``). Raises ValueError on an
    inconsistent world, RuntimeError when the devices cannot carry it."""
    import torch
    if nproc < 1:
        raise ValueError(f'--nproc must be >= 1, got {nproc}')
    if trainer in GRID_TRAINERS:
        nd = int(_flag(trainer_args, '--data-devices', 1))
        ns = int(_flag(trainer_args, '--seq-devices', 1))
        if nd * ns != nproc:
            raise ValueError(f'--data-devices {nd} x --seq-devices {ns} but '
                             f'--nproc {nproc}: the grid is the launched '
                             'world')
    else:
        nd = _flag(trainer_args, '--num-devices')
        if nd is None:
            trainer_args = list(trainer_args) + ['--num-devices', str(nproc)]
        elif int(nd) != nproc:
            raise ValueError(f'--num-devices {nd} but --nproc {nproc}: the '
                             'K-FAC world is the launched world')
    device = _flag(trainer_args, '--device', 'cuda')
    backend = _flag(trainer_args, '--dist-backend',
                    'gloo' if device == 'cpu' else 'nccl')
    if device == 'cpu' and backend == 'nccl':
        raise ValueError('--dist-backend nccl needs --device cuda')
    if device != 'cpu':
        if cuda_available is None:
            cuda_available = torch.cuda.is_available()
        if not cuda_available:
            raise RuntimeError('no CUDA device: kfac_pytorch_tpu_torch runs '
                               'on the GPU unless --device cpu is passed')
        if device_count is None:
            device_count = torch.cuda.device_count()
        if backend == 'nccl' and nproc > device_count:
            raise RuntimeError(
                f'{nproc} NCCL ranks on {device_count} GPU(s): NCCL '
                'refuses two ranks on one card; pass --dist-backend gloo')
    return trainer_args


def torchrun_command(nproc, trainer, trainer_args, port):
    return [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
            '--nproc_per_node', str(nproc), '--master_addr', '127.0.0.1',
            '--master_port', str(port), '-m', TRAINERS[trainer],
            *trainer_args]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if '--' not in argv:
        raise SystemExit(USAGE)
    cut = argv.index('--')
    own, rest = argv[:cut], argv[cut + 1:]
    if not rest or rest[0] not in TRAINERS:
        raise SystemExit(USAGE)
    nproc = _flag(own, '--nproc')
    if nproc is None:
        raise SystemExit(USAGE)
    port = int(_flag(own, '--master-port', 0)) or free_port()
    trainer_args = check_world(int(nproc), rest[1:], trainer=rest[0])
    return subprocess.call(torchrun_command(int(nproc), rest[0],
                                            trainer_args, port))


# ---------------------------------------------------------------------------
# spawn: a function on `world` processes of one process group
# ---------------------------------------------------------------------------

def _worker(fn, rank, world, backend, port, args, results):
    import torch
    import torch.distributed as dist
    try:
        if backend == 'nccl':
            torch.cuda.set_device(rank)
        dist.init_process_group(backend,
                                init_method=f'tcp://127.0.0.1:{port}',
                                world_size=world, rank=rank)
        out = fn(rank, world, dist.group.WORLD, *args)
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world, backend='gloo', args=(), timeout=600.0):
    """Run ``fn(rank, world, group, *args)`` on ``world`` new processes
    (the 'spawn' start method: nothing of this process, CUDA included,
    is inherited), joined in one ``backend`` process group on 127.0.0.1;
    return the list of their results by rank. ``fn`` must be importable
    by name and its results picklable (numpy, not tensors). An NCCL rank
    r runs on ``cuda:r``. Raises RuntimeError with the failing rank's
    traceback if any rank raises or dies, TimeoutError after
    ``timeout`` seconds; every process is stopped before it returns."""
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world, backend, port, args, results))
             for r in range(world)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f'spawn: {world - len(out)} rank(s) not '
                                   f'done after {timeout} s')
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f'spawn: rank(s) {dead} died '
                                       f'(exit codes '
                                       f'{[procs[r].exitcode for r in dead]})')
                continue
            if not ok:
                raise RuntimeError(f'spawn: rank {rank} failed:\n{payload}')
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world)]


if __name__ == '__main__':
    sys.exit(main())
