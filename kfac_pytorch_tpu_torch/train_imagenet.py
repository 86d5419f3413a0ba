"""ImageNet trainer of the port (counterpart of
``examples/imagenet_resnet.py``; ResNets, ResNeXts, DenseNet-BC,
Inception-v4): the JAX trainer's flag names and defaults (ResNet-50,
batch 32, 224 x 224, base lr 0.0125 scaled by the accumulated batches,
5 warmup epochs, wd 5e-5, label smoothing 0.1,
``eigen_dp`` with ``kfac_update_freq=1``, bf16 on), gradient accumulation
(``--batches-per-allreduce``), the K-FAC scheduler, auto-resume from
``--checkpoint-format`` at start, a checkpoint every epoch, retention
(``--keep-checkpoints``) and a SIGTERM save; plus ``--device`` (default
``cuda``), ``--dist-backend`` and ``--steps-per-epoch``.

  python -m kfac_pytorch_tpu_torch.train_imagenet --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_imagenet --kfac-name ekfac_dp \\
      --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_imagenet --device cpu \\
      --model resnet18 --img-size 32 --batch-size 4 --steps-per-epoch 2 \\
      --epochs 1

Reads ``images.npy``/``labels.npy`` from ``--train-dir`` when present,
else the synthetic stand-in (``data.get_imagenet``), two batches ahead on
a background thread (``data.Loader.epoch``). The numerical-health guard
is on (``KFAC(health=True)``), its events logged at their step and
summarized on the epoch line. At ``--num-devices`` > 1 each rank is one
process (``python -m kfac_pytorch_tpu_torch.launch --nproc N --
train_imagenet``), ``--batch-size`` is the GLOBAL batch and rank r trains
on its rows, as in the CIFAR trainer; the run stamps its world beside its
checkpoints and resumes through ``resilience.elastic_resume``, at that
world or another. ``--io-retries`` retries checkpoint I/O and the next
batch. ``--exclude-parts`` leaves phases out of every K-FAC step
(``KFAC``'s ``exclude_parts``). Flags of the JAX trainer whose features
the port does not have yet raise NotImplementedError naming their
ROADMAP item.
"""

import argparse
import os
import time

import numpy as np
import torch

import kfac_pytorch_tpu_torch as kfac
from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import models, resilience, training, utils
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.utils import checkpoint
from kfac_pytorch_tpu_torch.utils.losses import label_smoothing_cross_entropy

#: flags of the JAX trainer the port does not honour yet: (flag, the value
#: that leaves the feature off, the ROADMAP item that brings it)
UNPORTED = [
    ('kfac_autotune', False, 'queue 1, slice F item 22 (autotune)'),
    ('trace', None, 'queue 1, slice F item 22 (obs)'),
    ('prom_file', None, 'queue 1, slice F item 22 (obs)'),
    ('tb_dir', None, 'queue 1, slice F item 22 (summaries)'),
    ('step_deadline', 0, 'queue 1, slice G item 23 (resilience: the step '
                         'watchdog)'),
    ('straggler_budget', 0, 'queue 1, slice G item 23 (resilience: the '
                            'straggler governor)'),
]
#: steps the --speed timer discards, then times (the JAX speed_report's)
SPEED_WARMUP, SPEED_ITERS = 5, 60


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='ImageNet K-FAC trainer '
                                            '(PyTorch)')
    p.add_argument('--model', default='resnet50')
    p.add_argument('--train-dir', default=None)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--val-batch-size', type=int, default=32)
    p.add_argument('--batches-per-allreduce', type=int, default=1)
    p.add_argument('--epochs', type=int, default=55)
    p.add_argument('--base-lr', type=float, default=0.0125)
    p.add_argument('--lr-decay', nargs='+', type=int,
                   default=[25, 35, 40, 45, 50])
    p.add_argument('--warmup-epochs', type=int, default=5)
    p.add_argument('--wd', type=float, default=5e-5)
    p.add_argument('--label-smoothing', type=float, default=0.1)
    p.add_argument('--img-size', type=int, default=224)
    p.add_argument('--kfac-update-freq', type=int, default=1,
                   help='0 disables K-FAC (pure SGD)')
    p.add_argument('--kfac-cov-update-freq', type=int, default=1)
    p.add_argument('--kfac-capture-impl', default=None,
                   choices=['xla', 'pallas', 'auto'],
                   help="capture path: unset or 'xla' = plain torch ops; "
                        "'pallas'/'auto' = the fused CUDA capture kernels")
    p.add_argument('--kfac-comm-precision', default='fp32',
                   choices=['fp32', 'bf16', 'int8'])
    p.add_argument('--kfac-comm-mode', default=None,
                   choices=['inverse', 'pred'])
    p.add_argument('--kfac-name', default='eigen_dp',
                   choices=list(kfac.KFAC_VARIANTS))
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--damping', type=float, default=0.002)
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--damping-alpha', type=float, default=0.5)
    p.add_argument('--damping-decay', nargs='+', type=int, default=None)
    p.add_argument('--kfac-update-freq-alpha', type=float, default=10)
    p.add_argument('--kfac-update-freq-decay', nargs='+', type=int,
                   default=None)
    p.add_argument('--assignment', default='balanced',
                   choices=['round_robin', 'balanced'])
    p.add_argument('--num-devices', type=int, default=1,
                   help='ranks of the K-FAC world; > 1 must be launched '
                        '(python -m kfac_pytorch_tpu_torch.launch) and '
                        'equal WORLD_SIZE')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='process-group backend (default nccl on the GPU, '
                        'gloo with --device cpu)')
    p.add_argument('--io-retries', type=int, default=3,
                   help='retry budget for checkpoint I/O and next-batch '
                        'transients (0 = fail fast)')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--speed', action='store_true',
                   help='print images/s of warm, synchronized steps and '
                        'exit')
    p.add_argument('--bf16', action='store_true', default=True)
    p.add_argument('--checkpoint-format', default='./checkpoints',
                   help='checkpoint directory')
    p.add_argument('--keep-checkpoints', type=int, default=0,
                   help='retain only the N newest checkpoints (0 = all)')
    p.add_argument('--synthetic-size', type=int, default=1024)
    p.add_argument('--steps-per-epoch', type=int, default=None,
                   help='cut each epoch to this many steps (default: the '
                        'whole training set)')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    add_decomp_flags(p)
    # the JAX trainer's flags whose features are not ported (UNPORTED)
    p.add_argument('--kfac-autotune', action='store_true')
    p.add_argument('--tb-dir', default=None)
    p.add_argument('--step-deadline', type=float, default=0)
    p.add_argument('--straggler-budget', type=float, default=0)
    p.add_argument('--trace', default=None)
    p.add_argument('--prom-file', default=None)
    return p.parse_args(argv)


def add_decomp_flags(p):
    """The decomposition-ladder flags of the JAX trainers and
    ``--exclude-parts``, shared by the port's three trainers."""
    p.add_argument('--kfac-basis-update-freq', type=int, default=0,
                   help='full eigendecomposition cadence; intermediate '
                        'inverse updates refresh eigenvalues in the '
                        'retained basis (0 = always full)')
    p.add_argument('--kfac-warm-start', action='store_true',
                   help='warm-start decompositions from the stored one: '
                        'eigen variants track the previous eigenbasis '
                        '(KFAC_EIGH_IMPL=subspace|auto|jacobi), Cholesky '
                        'variants Newton-Schulz-iterate the previous '
                        'inverse')
    p.add_argument('--kfac-stagger', action='store_true',
                   help='staggered inverse refresh: decompose one cost-'
                        'balanced cohort of factors per step instead of '
                        'all factors every --kfac-update-freq steps, '
                        'preconditioning with the stored table')
    p.add_argument('--kfac-decomp-shard', action='store_true',
                   help='decompose each staggered cohort balanced across '
                        'all ranks instead of by its owners (two '
                        'DecompComm gathers a step; implies '
                        '--kfac-stagger)')
    p.add_argument('--kfac-comm-prefetch', action='store_true',
                   help="comm_mode 'inverse' variants only: publish each "
                        "inverse update's gathered decomposition for the "
                        'next step and precondition this one with the '
                        'stored table (one step of staleness)')
    p.add_argument('--kfac-decomp-impl', default=None,
                   choices=['xla', 'auto', 'jacobi', 'subspace',
                            'newton_schulz'],
                   help='decomposition kernel (unset = KFAC_EIGH_IMPL '
                        'decides): xla = cold eigh / Cholesky; subspace|'
                        'jacobi (eigh variants) and newton_schulz '
                        '(Cholesky variants) warm-start from the stored '
                        'decomposition; auto = subspace or newton_schulz')
    p.add_argument('--exclude-parts', default='',
                   help='phase ablation: any of ComputeFactor, '
                        'CommunicateFactor, ComputeInverse, '
                        'CommunicateInverse (comma-separated) left out of '
                        'every K-FAC step, to split its time by '
                        'subtraction')


def decomp_kwargs(args):
    """``KFAC`` keyword arguments of :func:`add_decomp_flags`' flags."""
    return dict(basis_update_freq=args.kfac_basis_update_freq or None,
                warm_start_basis=args.kfac_warm_start,
                stagger=args.kfac_stagger,
                decomp_impl=args.kfac_decomp_impl,
                decomp_shard=args.kfac_decomp_shard,
                comm_prefetch=args.kfac_comm_prefetch,
                exclude_parts=args.exclude_parts)


def check_ported(args):
    """Raise NotImplementedError for a flag whose feature the port lacks,
    naming the ROADMAP item that brings it."""
    for name, off, item in UNPORTED:
        if getattr(args, name) != off:
            flag = '--' + name.replace('_', '-')
            raise NotImplementedError(f'{flag} is not ported yet: ROADMAP '
                                      f'{item}')


def io_retry(args):
    """The ``resilience.RetryPolicy`` of ``--io-retries`` (that many
    retries after the first attempt), or None for 0: the JAX trainers'
    policy for checkpoint I/O and the next batch."""
    if args.io_retries <= 0:
        return None
    return resilience.RetryPolicy(attempts=args.io_retries + 1)


def kfac_for(args, world, group=None):
    """The trainers' preconditioner from their K-FAC flags, at ``world``
    ranks (``group`` their process group; None for the groupless host
    structure of another world, as ``elastic_resume`` asks for)."""
    return kfac.get_kfac_module(args.kfac_name)(
        lr=args.base_lr, damping=args.damping,
        fac_update_freq=args.kfac_cov_update_freq,
        kfac_update_freq=args.kfac_update_freq,
        capture_impl=args.kfac_capture_impl,
        comm_precision=args.kfac_comm_precision,
        comm_mode=args.kfac_comm_mode,
        kl_clip=args.kl_clip, factor_decay=args.stat_decay,
        num_devices=world, group=group,
        assignment=args.assignment, **decomp_kwargs(args))


def resume_from(tr, base_dir):
    """Resume trainer ``tr`` (``args``, ``precond``, ``state``,
    ``io_retry``, ``world``, ``say``) from the newest restorable
    checkpoint in ``base_dir``, at the stamped world or another
    (``resilience.elastic_resume``; a world change prints the
    ``WORLD_RESCALE`` and ``RESHARDED`` lines). Returns the checkpoint's
    epoch, or None without one."""
    args = tr.args

    def old_precond(world):
        pre = kfac_for(args, world)
        pre.setup(tr.precond.plan.metas)
        return pre

    def on_world_change(old_world, new_world):
        # the loaders yield the GLOBAL batch at any world: it is the
        # invariant, and the lr stays (lr_factor 1)
        tr.say(training.world_change_rescale(
            old_world, new_world, lr=args.base_lr,
            global_batch=args.batch_size).log_line())

    restored, epoch, old_world = resilience.elastic_resume(
        base_dir, args.epochs, tr.precond, tr.state,
        make_precond=old_precond, retry=tr.io_retry,
        on_world_change=on_world_change)
    if epoch is None:
        return None
    tr.state = restored
    if old_world is not None:
        tr.say(f'RESHARDED from_world={old_world} to_world={tr.world} '
               f'step={tr.state.step}')
    tr.say(f'resumed from checkpoint-{epoch} (step {tr.state.step})')
    return epoch


def stamp_world(tr, base_dir):
    """Stamp ``tr``'s world beside its checkpoints in ``base_dir``
    (``checkpoint.write_world_stamp``, with the pod generation and the
    lineage from the environment), once every rank has read the old stamp
    in its resume: a rank still resuming would otherwise read the new
    world as the checkpoints'."""
    if tr.group is not None:
        torch.distributed.barrier(group=tr.group)
    checkpoint.write_world_stamp(base_dir, tr.world,
                                 gen=os.environ.get('KFAC_POD_GEN'),
                                 lineage=os.environ.get('KFAC_LINEAGE'))


def init_world(args, group=None, local_rank=None):
    """``(group, rank, device)`` of a trainer at ``args.num_devices``
    ranks: ``group`` if given (as ``launch.spawn`` gives one), else the
    default group initialized from the launcher's environment; the rank
    runs on ``cuda:local_rank`` (``LOCAL_RANK`` unless given). Raises
    before any group is made when the GPU is asked for and absent."""
    utils.resolve_device(args.device)
    world = args.num_devices
    backend = args.dist_backend or ('gloo' if args.device == 'cpu'
                                    else 'nccl')
    if group is None and world > 1:
        group = kmesh.maybe_initialize_distributed(backend, world)
    if coll.axis_size(group) != world:
        raise ValueError(f'--num-devices {world} but the process group '
                         f'has {coll.axis_size(group)} ranks')
    if world > 1 and local_rank is None:
        local_rank = kmesh.local_rank()
    return group, coll.axis_index(group), utils.resolve_device(
        args.device, local_rank)


class Trainer:
    """Everything one run needs, built from the parsed flags: data,
    model (in bf16 unless ``args.bf16`` is off), optimizer (SGD, wrapped
    in ``training.MultiSteps`` when batches accumulate), preconditioner,
    scheduler, state and step. Matmuls and convolutions in fp32 run with
    TF32 off, the reference's precision."""

    def __init__(self, args, group=None, local_rank=None):
        check_ported(args)
        self.args = args
        self.group, self.rank, self.device = init_world(args, group,
                                                        local_rank)
        self.world = args.num_devices
        self.io_retry = io_retry(args)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = torch.bfloat16 if args.bf16 else torch.float32
        (train_x, train_y), (val_x, val_y) = kdata.get_imagenet(
            args.train_dir, args.img_size, args.synthetic_size)
        self.train_loader = kdata.Loader(train_x, train_y, args.batch_size,
                                         train=True, seed=args.seed)
        if args.steps_per_epoch is not None:
            self.train_loader.steps_per_epoch = min(
                args.steps_per_epoch, self.train_loader.steps_per_epoch)
        self.val_loader = kdata.Loader(val_x, val_y, args.val_batch_size,
                                       train=False)
        model = models.get_model(args.model, num_classes=1000,
                                 seed=args.seed, dtype=self.dtype)
        self.lr_fn = utils.warmup_multistep(
            args.base_lr, self.train_loader.steps_per_epoch,
            args.warmup_epochs, args.lr_decay,
            scale=max(1, args.num_devices * args.batches_per_allreduce))
        self.tx = training.sgd(self.lr_fn, momentum=0.9,
                               weight_decay=args.wd)
        if args.batches_per_allreduce > 1:
            self.tx = training.MultiSteps(self.tx,
                                          args.batches_per_allreduce)
        self.precond = self.scheduler = None
        if args.kfac_update_freq > 0:
            self.precond = kfac_for(args, self.world, self.group)
            self.scheduler = kfac.KFACParamScheduler(
                self.precond, damping_alpha=args.damping_alpha,
                damping_schedule=args.damping_decay,
                update_freq_alpha=args.kfac_update_freq_alpha,
                update_freq_schedule=args.kfac_update_freq_decay)
        sample = torch.zeros((args.batch_size // self.world, args.img_size,
                              args.img_size, 3))
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.step_fn = training.build_train_step(
            model, self.tx, self.precond, self.loss_fn,
            input_dtype=self.dtype)

    def say(self, *args, **kw):
        """``print`` on rank 0."""
        if self.rank == 0:
            print(*args, flush=True, **kw)

    def loss_fn(self, outputs, batch):
        """Label-smoothed CE on the model's (bf16) logits."""
        return label_smoothing_cross_entropy(
            outputs, batch['label'], smoothing=self.args.label_smoothing)

    def to_device(self, batch):
        """This rank's rows of a global host batch, on the device."""
        if self.world > 1:
            batch = kmesh.shard_batch(batch, self.rank, self.world)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch):
        """One step on a host batch; returns the metrics dict."""
        lr = self.lr_fn(self.state.step)
        self.state, m = self.step_fn(
            self.state, self.to_device(batch), lr=lr,
            damping=self.precond.damping if self.precond else 0.0)
        return m

    def evaluate(self):
        loss = acc = n = 0.0
        for batch in self.val_loader.epoch():
            l, a = training.eval_step(self.state.model,
                                      self.to_device(batch),
                                      training.fp32_cross_entropy,
                                      input_dtype=self.dtype)
            k = len(batch['label'])
            loss, acc, n = loss + float(l) * k, acc + float(a) * k, n + k
        return loss / n, acc / n

    def resume(self):
        """Auto-resume from ``--checkpoint-format`` (:func:`resume_from`):
        returns the epoch to start from (0 without a checkpoint). The
        scheduler steps to it and the loader draws the epochs it skips,
        so the resumed epochs see the batches an uninterrupted run
        would."""
        epoch = resume_from(self, self.args.checkpoint_format)
        if epoch is None:
            return 0
        start = epoch + 1
        if self.scheduler is not None:
            self.scheduler.step(start)
        for _ in range(start):
            self.train_loader.rng.randint(1 << 31)
        return start

    def save(self, epoch, block=True):
        """Checkpoint ``epoch`` of the state (every rank calls it; rank 0
        writes)."""
        checkpoint.save_checkpoint(self.args.checkpoint_format, epoch,
                                   self.state, block=block,
                                   retry=self.io_retry, group=self.group)


def speed(tr):
    """Images/s over SPEED_ITERS synchronized steps on one batch, after
    SPEED_WARMUP steps (the JAX ``speed_report``'s counts)."""
    batch = next(tr.train_loader.epoch())
    sync = (torch.cuda.synchronize if tr.device.type == 'cuda'
            else (lambda: None))
    for _ in range(SPEED_WARMUP):
        tr.train_step(batch)
    times = []
    for _ in range(SPEED_ITERS):
        sync()
        t0 = time.perf_counter()
        tr.train_step(batch)
        sync()
        times.append(time.perf_counter() - t0)
    mean, std = float(np.mean(times)), float(np.std(times))
    tr.say(f'SPEED: iter time {mean:.4f} +- {std:.4f} s (imgs/sec '
           f'{len(batch["label"]) / mean:.1f})')


def main(argv=None, group=None):
    """Run the trainer (in ``group`` if given, as ``launch.spawn`` gives
    one; else the launcher's group at world>1); returns it."""
    args = parse_args(argv)
    tr = Trainer(args, group=group)
    start_epoch = tr.resume()
    if args.speed:
        speed(tr)
        return tr
    stamp_world(tr, args.checkpoint_format)
    guard = checkpoint.PreemptionGuard(group=tr.group)
    monitor = utils.HealthMonitor(state=tr.state)
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            total = count = 0.0
            with tr.train_loader.epoch(retry=tr.io_retry) as batches:
                for batch in batches:
                    if guard.should_stop(tr.state.step):
                        break
                    m = tr.train_step(batch)
                    total += float(m['loss']) * len(batch['label'])
                    count += len(batch['label'])
                    monitor.update(m, step=tr.state.step - 1)
            if guard.should_stop():
                # tagged with the last completed epoch: the resume replays
                # the interrupted one (the step count keeps the lr exact)
                tag = max(epoch - 1, 0)
                tr.save(tag)
                tr.say(f'preempted in epoch {epoch} (step {tr.state.step}): '
                       f'state saved as checkpoint-{tag}, exiting')
                return tr
            vl, va = tr.evaluate()
            tr.say(f'epoch {epoch}: train_loss {total / max(count, 1):.4f} '
                   f'val_loss {vl:.4f} val_acc {va:.4f} '
                   f'({time.time() - t0:.1f}s)'
                   f'{utils.health_suffix(monitor.epoch_flush())}')
            if tr.scheduler is not None:
                tr.scheduler.step(epoch + 1)
            tr.save(epoch, block=False)
            checkpoint.prune_checkpoints(args.checkpoint_format,
                                         args.keep_checkpoints)
            if guard.should_stop():
                checkpoint.wait_for_checkpoints()
                tr.say(f'preempted after epoch {epoch}: exiting')
                return tr
        checkpoint.wait_for_checkpoints()
        checkpoint.prune_checkpoints(args.checkpoint_format,
                                     args.keep_checkpoints)
        if group is None and tr.world > 1:
            torch.distributed.destroy_process_group()
    finally:
        guard.uninstall()
    return tr


if __name__ == '__main__':
    main()
