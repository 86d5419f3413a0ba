"""CIFAR trainer of the port (ResNet, VGG, WRN-28-10) (counterpart of
``examples/cifar10_resnet.py``): the same flag names and defaults for the
flags the port supports, plus ``--device`` (default ``cuda``),
``--dist-backend`` and ``--steps-per-epoch``.

  python -m kfac_pytorch_tpu_torch.train_cifar --kfac-capture-impl auto --epochs 1
  python -m kfac_pytorch_tpu_torch.train_cifar --kfac-name ekfac_dp
  python -m kfac_pytorch_tpu_torch.launch --nproc 2 -- train_cifar \\
      --kfac-name eigen --kfac-comm-precision bf16 --kfac-capture-impl auto

Trains on CIFAR-10 from ``--dir`` when it holds the archive, else on the
synthetic stand-in (``data.get_cifar``), with batches assembled two ahead
on a background thread (``data.Loader.epoch``). The numerical-health
guard is on (``KFAC(health=True)``): skipped batches and the damping
ladder are logged as WARNINGs at their step and summarized on the epoch
line (`` [health: ...]``). ``--kfac-type F1mc`` estimates the factors'
Fisher from labels sampled from the model (seeded by ``--seed``). At
``--num-devices`` > 1 each rank is one process (started by the launcher,
which sets ``--num-devices``), ``--batch-size`` is the GLOBAL batch and
rank r trains on its rows ``[r*B/P, (r+1)*B/P)``; rank 0 prints.

Durability, as in the JAX trainer: with ``--checkpoint-dir`` the run
stamps its world there (``world.json``), saves every epoch without
blocking the next one (``save_checkpoint(block=False)``), keeps the
``--keep-checkpoints`` newest, and on SIGTERM saves its state (tagged
with the last completed epoch) and exits. ``--resume`` resumes from the
newest restorable checkpoint through ``resilience.elastic_resume``, at
the checkpoints' world or another (a world change prints ``RESHARDED``
and ``WORLD_RESCALE`` lines), and continues at the batch after the last
one the state took (the JAX trainer replays an interrupted epoch from its
start). ``--io-retries`` retries checkpoint I/O and the next batch;
``--speed`` prints images/s of warm steps and exits.
``--exclude-parts`` leaves phases out of every K-FAC step (``KFAC``'s
``exclude_parts``: the reference's time breakdown by subtraction). A
world change::

  python -m kfac_pytorch_tpu_torch.launch --nproc 2 -- train_cifar \\
      --checkpoint-dir D --epochs 2
  python -m kfac_pytorch_tpu_torch.train_cifar --checkpoint-dir D \\
      --resume --epochs 4
"""

import argparse
import time

import torch
import torch.nn.functional as F

import kfac_pytorch_tpu_torch as kfac
from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import models, training, utils
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.train_imagenet import (add_decomp_flags,
                                                   init_world, io_retry,
                                                   kfac_for, resume_from,
                                                   speed, stamp_world)
from kfac_pytorch_tpu_torch.utils import checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='CIFAR K-FAC trainer (PyTorch)')
    p.add_argument('--model', default='resnet32')
    p.add_argument('--dataset', default='cifar10',
                   choices=['cifar10', 'cifar100'])
    p.add_argument('--dir', default=None,
                   help='dataset directory (cifar-10-batches-py or its '
                        'tar.gz); synthetic data when absent')
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--val-batch-size', type=int, default=128)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--base-lr', type=float, default=0.1)
    p.add_argument('--lr-decay', nargs='+', type=int, default=[35, 75, 90])
    p.add_argument('--warmup-epochs', type=int, default=5)
    p.add_argument('--wd', type=float, default=5e-4)
    p.add_argument('--momentum', type=float, default=0.9)
    p.add_argument('--kfac-update-freq', type=int, default=10,
                   help='0 disables K-FAC (pure SGD)')
    p.add_argument('--kfac-capture-impl', default=None,
                   choices=['xla', 'pallas', 'auto'],
                   help="capture path: unset or 'xla' = plain torch ops; "
                        "'pallas'/'auto' = the fused CUDA capture kernels")
    p.add_argument('--kfac-cov-update-freq', type=int, default=1)
    p.add_argument('--kfac-type', '--fisher-type', default='Femp',
                   choices=['Femp', 'F1mc'],
                   help='Fisher estimator: empirical-gradient (Femp) or '
                        '1-sample MC with model-sampled pseudo labels '
                        '(F1mc)')
    add_decomp_flags(p)
    p.add_argument('--kfac-name', default='eigen_dp',
                   choices=list(kfac.KFAC_VARIANTS))
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--damping', type=float, default=0.003)
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--damping-alpha', type=float, default=0.5)
    p.add_argument('--damping-decay', nargs='+', type=int, default=None)
    p.add_argument('--kfac-update-freq-alpha', type=float, default=10)
    p.add_argument('--kfac-update-freq-decay', nargs='+', type=int,
                   default=None)
    p.add_argument('--kfac-comm-precision', default='fp32',
                   choices=['fp32', 'bf16', 'int8'],
                   help='wire dtype of the K-FAC factor collectives: bf16 '
                        'halves, int8 quarters the gather payloads; a lossy '
                        'stats reduce carries an error-feedback residual; '
                        'the gradient all-reduce is never compressed')
    p.add_argument('--kfac-comm-mode', default=None,
                   choices=['inverse', 'pred'],
                   help="override the variant's comm mode: 'inverse' "
                        "gathers decompositions once per refresh, 'pred' "
                        'gathers preconditioned gradients every step')
    p.add_argument('--assignment', default='round_robin',
                   choices=['round_robin', 'balanced'])
    p.add_argument('--num-devices', type=int, default=1,
                   help='ranks of the K-FAC world; > 1 must be launched '
                        '(python -m kfac_pytorch_tpu_torch.launch) and '
                        'equal WORLD_SIZE')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='process-group backend (default nccl on the GPU, '
                        'gloo with --device cpu)')
    p.add_argument('--steps-per-epoch', type=int, default=None,
                   help='cut each epoch to this many steps (default: the '
                        'whole training set)')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--speed', action='store_true',
                   help='SPEED mode: time ~60 iterations and exit')
    p.add_argument('--checkpoint-dir', default=None)
    p.add_argument('--keep-checkpoints', type=int, default=0,
                   help='retain only the N newest checkpoints '
                        '(0 = keep all, reference behavior)')
    p.add_argument('--resume', action='store_true',
                   help='auto-resume from the newest readable checkpoint '
                        'in --checkpoint-dir (scan-downward), at its world '
                        'or another')
    p.add_argument('--io-retries', type=int, default=3,
                   help='retry budget for checkpoint I/O and next-batch '
                        'transients (0 = fail fast)')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p.parse_args(argv)


def loss_fn(outputs, batch):
    return F.cross_entropy(outputs, batch['label'])


class Trainer:
    """Everything one run needs, built from the parsed flags: model,
    optimizer, preconditioner, scheduler, loaders, state and the step.
    Matmuls and convolutions run in fp32 (TF32 off), the reference's
    precision.

    At ``--num-devices`` > 1 the process group is ``group`` if given (as
    :func:`launch.spawn` gives it), else the default group initialized
    from the launcher's environment; the rank runs on ``cuda:local_rank``
    (``LOCAL_RANK`` unless given)."""

    def __init__(self, args, group=None, local_rank=None):
        self.args = args
        world = args.num_devices
        self.group, self.rank, self.device = init_world(args, group,
                                                        local_rank)
        self.world = world
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        num_classes = 10 if args.dataset == 'cifar10' else 100
        (train_x, train_y), (val_x, val_y) = kdata.get_cifar(args.dir,
                                                             num_classes)
        self.train_loader = kdata.Loader(train_x, train_y, args.batch_size,
                                         train=True,
                                         augment=kdata.augment_cifar,
                                         seed=args.seed)
        if args.steps_per_epoch is not None:
            self.train_loader.steps_per_epoch = min(
                args.steps_per_epoch, self.train_loader.steps_per_epoch)
        self.val_loader = kdata.Loader(val_x, val_y, args.val_batch_size,
                                       train=False)
        model = models.get_model(args.model, num_classes=num_classes,
                                 seed=args.seed)
        # the JAX trainer's scale, quirk included: world x GLOBAL batch
        self.lr_fn = utils.warmup_multistep(
            args.base_lr, self.train_loader.steps_per_epoch,
            args.warmup_epochs, args.lr_decay,
            scale=max(1, world * args.batch_size // 128))
        self.tx = training.sgd(self.lr_fn, momentum=args.momentum,
                               weight_decay=args.wd)
        self.io_retry = io_retry(args)
        self.precond = self.scheduler = None
        if args.kfac_update_freq > 0:
            self.precond = kfac_for(args, world, self.group)
            self.scheduler = kfac.KFACParamScheduler(
                self.precond, damping_alpha=args.damping_alpha,
                damping_schedule=args.damping_decay,
                update_freq_alpha=args.kfac_update_freq_alpha,
                update_freq_schedule=args.kfac_update_freq_decay)
        sample = torch.zeros((args.batch_size // world, 32, 32, 3))
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.step_fn = training.build_train_step(
            model, self.tx, self.precond, loss_fn,
            fisher_type=args.kfac_type, fisher_seed=args.seed)

    def say(self, *args, **kw):
        """``print`` on rank 0."""
        if self.rank == 0:
            print(*args, flush=True, **kw)

    def resume(self):
        """Resume from ``--checkpoint-dir`` when ``--resume`` is given
        (``train_imagenet.resume_from``): returns ``(epoch, batches)``,
        the epoch to start at and how many of its batches the restored
        state already took (``(0, 0)`` without a checkpoint). The
        scheduler steps to that epoch and the loader draws the seeds of
        the epochs before it, so the resumed run sees the batches an
        uninterrupted one would."""
        args = self.args
        if not (args.resume and args.checkpoint_dir) or resume_from(
                self, args.checkpoint_dir) is None:
            return 0, 0
        start, done = divmod(int(self.state.step),
                             self.train_loader.steps_per_epoch)
        if self.scheduler is not None:
            self.scheduler.step(start)
        for _ in range(start):
            self.train_loader.rng.randint(1 << 31)
        return start, done

    def save(self, epoch, block=True):
        """Checkpoint ``epoch`` of the state to ``--checkpoint-dir`` (every
        rank calls it; rank 0 writes)."""
        checkpoint.save_checkpoint(self.args.checkpoint_dir, epoch,
                                   self.state, block=block,
                                   retry=self.io_retry, group=self.group)

    def to_device(self, batch):
        """This rank's rows of a global host batch, on the device."""
        if self.world > 1:
            batch = kmesh.shard_batch(batch, self.rank, self.world)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch):
        """One step on a global host batch; returns the metrics dict (the
        loss averaged over the ranks)."""
        lr = self.lr_fn(self.state.step)
        self.state, m = self.step_fn(
            self.state, self.to_device(batch), lr=lr,
            damping=self.precond.damping if self.precond else 0.0)
        return m

    def replicas_agree(self):
        """Whether every rank's parameters and buffers are bitwise the same
        as this rank's (:func:`training.replica_digest`)."""
        digest = training.replica_digest(self.state.model)
        if self.group is None:
            return True
        digests = [None] * self.world
        torch.distributed.all_gather_object(digests, digest,
                                            group=self.group)
        return len(set(digests)) == 1

    def evaluate(self):
        loss = acc = n = 0.0
        for batch in self.val_loader.epoch():
            b = self.to_device(batch)
            l, a = training.eval_step(self.state.model, b, loss_fn)
            k = len(batch['label'])
            loss, acc, n = loss + float(l) * k, acc + float(a) * k, n + k
        return loss / n, acc / n


def main(argv=None, group=None):
    """Run the trainer (in ``group`` if given, as ``launch.spawn`` gives
    one; else the launcher's group at world>1); returns it, its final
    state in ``.state``."""
    args = parse_args(argv)
    tr = Trainer(args, group=group)
    start_epoch, done = tr.resume()
    if args.speed:
        speed(tr)
        return tr
    ckdir = args.checkpoint_dir
    if ckdir:
        # the world stamp routes a relaunch at another world through the
        # reshard; the lineage fences a fork's straggler out
        stamp_world(tr, ckdir)
    guard = checkpoint.PreemptionGuard(group=tr.group)
    # skipped batches and ladder climbs as WARNINGs at their step, and a
    # per-epoch suffix
    monitor = utils.HealthMonitor(state=tr.state)
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            total = count = 0.0
            with tr.train_loader.epoch(retry=tr.io_retry) as batches:
                for batch in batches:
                    if done:    # taken before the resumed checkpoint
                        done -= 1
                        continue
                    if guard.should_stop(tr.state.step):
                        break
                    m = tr.train_step(batch)
                    total += float(m['loss']) * len(batch['label'])
                    count += len(batch['label'])
                    monitor.update(m, step=tr.state.step - 1)
            if guard.should_stop():
                # tagged with the last completed epoch; the resume goes on
                # from the step the state holds
                tag = max(epoch - 1, 0)
                if ckdir:
                    tr.save(tag)
                    tr.say(f'preempted in epoch {epoch} (step '
                           f'{tr.state.step}): state saved as '
                           f'checkpoint-{tag}, exiting')
                else:
                    tr.say(f'preempted in epoch {epoch} (step '
                           f'{tr.state.step}): no --checkpoint-dir '
                           'configured, state lost')
                return tr
            vl, va = tr.evaluate()
            tr.say(f'epoch {epoch}: train_loss {total / max(count, 1):.4f} '
                   f'val_loss {vl:.4f} val_acc {va:.4f} '
                   f'({time.time() - t0:.1f}s)'
                   f'{utils.health_suffix(monitor.epoch_flush())}')
            if tr.scheduler is not None:
                tr.scheduler.step(epoch + 1)
            if ckdir:
                # the write hides behind the next epoch's compute
                tr.save(epoch, block=False)
                checkpoint.prune_checkpoints(ckdir, args.keep_checkpoints)
            if guard.should_stop():
                checkpoint.wait_for_checkpoints()
                tr.say(f'preempted after epoch {epoch}: exiting')
                return tr
        checkpoint.wait_for_checkpoints()
        if ckdir:
            checkpoint.prune_checkpoints(ckdir, args.keep_checkpoints)
        if tr.world > 1:
            if tr.precond is not None and \
                    tr.precond.exclude_communicate_inverse:
                # each rank preconditions only the layers it owns
                tr.say('replicas: not compared (the CommunicateInverse '
                       'ablation updates each rank\'s own layers)')
            elif not tr.replicas_agree():
                raise RuntimeError('the ranks\' parameters and buffers '
                                   'differ')
            else:
                tr.say(f'replicas: {tr.world} ranks bitwise identical')
            if group is None:
                torch.distributed.destroy_process_group()
    finally:
        guard.uninstall()
    return tr


if __name__ == '__main__':
    main()
