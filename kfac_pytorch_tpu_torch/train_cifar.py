"""CIFAR ResNet trainer of the port (counterpart of
``examples/cifar10_resnet.py``): the same flag names and defaults for the
flags the port supports, plus ``--device`` (default ``cuda``).

  python -m kfac_pytorch_tpu_torch.train_cifar --kfac-capture-impl auto --epochs 1

Trains on the synthetic CIFAR stand-in (``data.get_cifar``).
"""

import argparse
import time

import torch
import torch.nn.functional as F

import kfac_pytorch_tpu_torch as kfac
from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import models, training, utils


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='CIFAR K-FAC trainer (PyTorch)')
    p.add_argument('--model', default='resnet32')
    p.add_argument('--dataset', default='cifar10',
                   choices=['cifar10', 'cifar100'])
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
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p.parse_args(argv)


def loss_fn(outputs, batch):
    return F.cross_entropy(outputs, batch['label'])


class Trainer:
    """Everything one run needs, built from the parsed flags: model,
    optimizer, preconditioner, scheduler, loaders, state and the step.
    Matmuls and convolutions run in fp32 (TF32 off), the reference's
    precision."""

    def __init__(self, args):
        self.args = args
        self.device = utils.resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        num_classes = 10 if args.dataset == 'cifar10' else 100
        (train_x, train_y), (val_x, val_y) = kdata.get_cifar(num_classes)
        self.train_loader = kdata.Loader(train_x, train_y, args.batch_size,
                                         train=True,
                                         augment=kdata.augment_cifar,
                                         seed=args.seed)
        self.val_loader = kdata.Loader(val_x, val_y, args.val_batch_size,
                                       train=False)
        model = models.get_model(args.model, num_classes=num_classes,
                                 seed=args.seed)
        self.lr_fn = utils.warmup_multistep(
            args.base_lr, self.train_loader.steps_per_epoch,
            args.warmup_epochs, args.lr_decay,
            scale=max(1, args.batch_size // 128))
        self.tx = training.sgd(self.lr_fn, momentum=args.momentum,
                               weight_decay=args.wd)
        self.precond = self.scheduler = None
        if args.kfac_update_freq > 0:
            self.precond = kfac.get_kfac_module(args.kfac_name)(
                lr=args.base_lr, damping=args.damping,
                fac_update_freq=args.kfac_cov_update_freq,
                kfac_update_freq=args.kfac_update_freq,
                capture_impl=args.kfac_capture_impl,
                kl_clip=args.kl_clip, factor_decay=args.stat_decay)
            self.scheduler = kfac.KFACParamScheduler(
                self.precond, damping_alpha=args.damping_alpha,
                damping_schedule=args.damping_decay,
                update_freq_alpha=args.kfac_update_freq_alpha,
                update_freq_schedule=args.kfac_update_freq_decay)
        sample = torch.zeros((args.batch_size, 32, 32, 3))
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.step_fn = training.build_train_step(model, self.tx,
                                                 self.precond, loss_fn)

    def to_device(self, batch):
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
            b = self.to_device(batch)
            l, a = training.eval_step(self.state.model, b, loss_fn)
            k = len(batch['label'])
            loss, acc, n = loss + float(l) * k, acc + float(a) * k, n + k
        return loss / n, acc / n


def main(argv=None):
    args = parse_args(argv)
    tr = Trainer(args)
    for epoch in range(args.epochs):
        t0 = time.time()
        total = count = 0.0
        for batch in tr.train_loader.epoch():
            m = tr.train_step(batch)
            total += float(m['loss']) * len(batch['label'])
            count += len(batch['label'])
        vl, va = tr.evaluate()
        print(f'epoch {epoch}: train_loss {total / count:.4f} '
              f'val_loss {vl:.4f} val_acc {va:.4f} ({time.time() - t0:.1f}s)',
              flush=True)
        if tr.scheduler is not None:
            tr.scheduler.step(epoch + 1)


if __name__ == '__main__':
    main()
