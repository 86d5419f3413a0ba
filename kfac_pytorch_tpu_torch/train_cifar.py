"""CIFAR ResNet trainer of the port (counterpart of
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
"""

import argparse
import time

import torch
import torch.nn.functional as F

import kfac_pytorch_tpu_torch as kfac
from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import models, training, utils
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.train_imagenet import (add_decomp_flags,
                                                   decomp_kwargs)


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
        utils.resolve_device(args.device)   # no GPU: raise before the group
        world = args.num_devices
        backend = args.dist_backend or ('gloo' if args.device == 'cpu'
                                        else 'nccl')
        if group is None and world > 1:
            group = kmesh.maybe_initialize_distributed(backend, world)
        if coll.axis_size(group) != world:
            raise ValueError(f'--num-devices {world} but the process group '
                             f'has {coll.axis_size(group)} ranks')
        self.group, self.world = group, world
        self.rank = coll.axis_index(group)
        if world > 1 and local_rank is None:
            local_rank = kmesh.local_rank()
        self.device = utils.resolve_device(args.device, local_rank)
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
        self.precond = self.scheduler = None
        if args.kfac_update_freq > 0:
            self.precond = kfac.get_kfac_module(args.kfac_name)(
                lr=args.base_lr, damping=args.damping,
                fac_update_freq=args.kfac_cov_update_freq,
                kfac_update_freq=args.kfac_update_freq,
                capture_impl=args.kfac_capture_impl,
                comm_precision=args.kfac_comm_precision,
                comm_mode=args.kfac_comm_mode,
                kl_clip=args.kl_clip, factor_decay=args.stat_decay,
                num_devices=world, group=group,
                assignment=args.assignment, **decomp_kwargs(args))
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


def main(argv=None):
    args = parse_args(argv)
    tr = Trainer(args)
    say = print if tr.rank == 0 else (lambda *a, **k: None)
    # skipped batches and ladder climbs as WARNINGs at their step, and a
    # per-epoch suffix
    monitor = utils.HealthMonitor(state=tr.state)
    for epoch in range(args.epochs):
        t0 = time.time()
        total = count = 0.0
        with tr.train_loader.epoch() as batches:
            for batch in batches:
                m = tr.train_step(batch)
                total += float(m['loss']) * len(batch['label'])
                count += len(batch['label'])
                monitor.update(m, step=tr.state.step - 1)
        vl, va = tr.evaluate()
        say(f'epoch {epoch}: train_loss {total / count:.4f} '
            f'val_loss {vl:.4f} val_acc {va:.4f} ({time.time() - t0:.1f}s)'
            f'{utils.health_suffix(monitor.epoch_flush())}', flush=True)
        if tr.scheduler is not None:
            tr.scheduler.step(epoch + 1)
    if tr.world > 1:
        if not tr.replicas_agree():
            raise RuntimeError('the ranks\' parameters and buffers differ')
        say(f'replicas: {tr.world} ranks bitwise identical', flush=True)
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
