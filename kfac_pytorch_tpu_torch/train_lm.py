"""Long-context causal-LM trainer of the port (counterpart of
``examples/longcontext_lm.py``): the same flag names and defaults for the
flags the port supports, plus ``--device`` (default ``cuda``),
``--dist-backend``, ``--kfac-capture-impl`` and ``--attn-impl``.

  python -m kfac_pytorch_tpu_torch.train_lm --kfac-capture-impl auto --epochs 1
  python -m kfac_pytorch_tpu_torch.launch --nproc 2 -- train_lm \
      --seq-devices 2 --dist-backend gloo --kfac-capture-impl auto

Trains the 4-layer, 256-wide ``TransformerLM`` on 2048-token windows of
the synthetic Markov corpus (or ``--data``, a text file) with
``eigen_dp`` K-FAC, the vocabulary head excluded; the K-FAC flags are
the other trainers' (``train_imagenet.add_kfac_flags``: the comm mode
and wire precision, the decomposition ladder, ``--exclude-parts``).
``--attn-impl`` 'pallas'/'auto' runs attention through the hand-written
CUDA kernels (K4 forward, K5a/K5b backward), 'xla' through plain PyTorch
ops.

``--data-devices`` x ``--seq-devices`` ranks (started by the launcher,
or a ``group`` from ``launch.spawn``) form the JAX trainer's ``('data',
'seq')`` mesh (``parallel.mesh.make_grid``): rank ``d * ns + s`` trains
on rows ``[d*B/nd, (d+1)*B/nd)`` and tokens ``[s*L/ns, (s+1)*L/ns)`` of
the global batch, attention runs as the ring or Ulysses
(``--seq-impl``) over the seq group, and K-FAC's world is the whole
grid (JAX's flattened ``('data', 'seq')`` axis): each rank's loss is the
mean over its own tokens, the gradients and factor statistics are
reduced over every rank, and the reported losses are their mean.

The numerical-health guard is on: a skipped batch is logged at its step
and counted on the epoch line (`` [health: ...]``), and training goes
on. ``--log-dir``, ``--trace``, ``--prom-file`` and ``--tb-dir`` as the
JAX trainer wires them (``train_imagenet.observed``): each step a
``kfac.dispatch`` span, no phase timers.
"""

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import models, training, utils
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.parallel.ring_attention import BLOCK_IMPLS
from kfac_pytorch_tpu_torch.train_imagenet import (
    add_autotune_flag, add_kfac_flags, add_obs_flags, add_world_flags,
    end_epoch, end_world, gate_tuner, init_world, kfac_for, observed, say,
    speed, tuner_for)

#: batches of the validation pass (as the JAX trainer's)
VAL_BATCHES = 10


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Long-context TransformerLM + K-FAC (PyTorch)')
    p.add_argument('--data', default=None)
    p.add_argument('--seq-len', type=int, default=2048)
    p.add_argument('--batch-size', type=int, default=4)
    p.add_argument('--epochs', type=int, default=3)
    p.add_argument('--steps-per-epoch', type=int, default=100)
    p.add_argument('--n-layer', type=int, default=4)
    p.add_argument('--n-head', type=int, default=8)
    p.add_argument('--d-model', type=int, default=256)
    p.add_argument('--seq-impl', choices=['ring', 'ulysses'], default='ring')
    p.add_argument('--seq-devices', type=int, default=1,
                   help="size of the 'seq' mesh axis")
    p.add_argument('--data-devices', type=int, default=1,
                   help="size of the 'data' mesh axis")
    p.add_argument('--kfac-mesh', default=None, metavar='SPEC',
                   help='composed-mesh spec (not ported yet)')
    p.add_argument('--base-lr', type=float, default=3e-2)
    add_kfac_flags(p, update_freq=10, damping=0.003)
    add_autotune_flag(p)
    p.add_argument('--attn-impl', default='auto', choices=list(BLOCK_IMPLS),
                   help="attention blocks: 'xla' = plain torch ops; "
                        "'pallas'/'auto' = the CUDA flash-attention kernels")
    p.add_argument('--vocab-limit', type=int, default=8192)
    p.add_argument('--synthetic-vocab', type=int, default=512)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--speed', action='store_true',
                   help='print tokens/s of warm, synchronized steps and '
                        'exit')
    add_world_flags(p)
    add_obs_flags(p)
    return p.parse_args(argv)


def loss_fn(outputs, batch):
    """Mean next-token cross entropy over every position."""
    return F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                           batch['label'].reshape(-1))


class Trainer:
    """Everything one run needs, built from the parsed flags: corpus,
    grid, model, optimizer, preconditioner, state and the step. Matmuls
    run in fp32 (TF32 off), the reference's precision.

    At ``--data-devices`` x ``--seq-devices`` > 1 the process group is
    ``group`` if given (as :func:`launch.spawn` gives it), else the
    default group initialized from the launcher's environment; the rank
    runs on ``cuda:local_rank`` (``LOCAL_RANK`` unless given)."""

    log = None

    def __init__(self, args, group=None, local_rank=None, log=None):
        if args.kfac_mesh:
            raise NotImplementedError(
                '--kfac-mesh is not ported yet: ROADMAP queue 1, item 21 '
                '(parallel layers and the mesh plan)')
        self.args = args
        self.tracer = None
        self.log = log
        self.world = args.data_devices * args.seq_devices
        self.group, self.rank, self.device = init_world(
            args, group, local_rank, world=self.world)
        self.grid = kmesh.make_grid(args.data_devices, args.seq_devices,
                                    self.group)
        if args.batch_size % args.data_devices or \
                args.seq_len % args.seq_devices:
            raise ValueError(
                f'--batch-size {args.batch_size} x --seq-len {args.seq_len} '
                f'does not split over the {args.data_devices} x '
                f'{args.seq_devices} grid')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ids, self.vocab = kdata.load_corpus(
            args.data, args.vocab_limit, args.synthetic_vocab,
            args.batch_size, args.seq_len, args.seed)
        split = int(len(ids) * 0.9)
        self.train_ids, self.val_ids = ids[:split], ids[split:]
        model = models.get_model(
            'transformer_lm', seed=args.seed, vocab_size=self.vocab,
            n_layer=args.n_layer, n_head=args.n_head, d_model=args.d_model,
            max_len=args.seq_len, seq_impl=args.seq_impl,
            block_impl=args.attn_impl, seq_group=self.grid.seq)
        self.tx = training.sgd(args.base_lr, momentum=0.9)
        self.precond = None
        if args.kfac_update_freq > 0:
            self.precond = kfac_for(args, self.world, self.group,
                                    exclude_vocabulary_size=self.vocab)
        # the model is set up from a sample of the local shard's shape
        sample = np.zeros((args.batch_size // args.data_devices,
                           args.seq_len // args.seq_devices), np.int64)
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.tuner = tuner_for(self, args)
        self.step_fn = training.build_train_step(model, self.tx,
                                                 self.precond, loss_fn,
                                                 group=self.group,
                                                 autotune=self.tuner)
        self.rng = np.random.RandomState(args.seed)

    def say(self, *args, **kw):
        say(self, *args, **kw)

    def batches(self):
        """One epoch of training batches (host numpy)."""
        a = self.args
        return kdata.sample_lm_batches(self.train_ids, a.seq_len,
                                       a.batch_size, a.steps_per_epoch,
                                       self.rng)

    def tokens(self, batch):
        """Tokens of a global host batch (every rank's together)."""
        return batch['input'].size

    def to_device(self, batch):
        """This rank's block of a global host batch, on the device."""
        if self.world > 1:
            batch = kmesh.shard_tokens(batch, self.grid)
        return {k: torch.as_tensor(v).to(self.device, torch.int64)
                for k, v in batch.items()}

    def kfac_lr(self, step):
        """The lr the step hands K-FAC (its KL clip): the constant
        ``--base-lr``."""
        return self.args.base_lr

    def train_step(self, batch):
        """One step on a global host batch; returns the metrics dict (the
        loss averaged over the ranks)."""
        self.state, m = self.step_fn(
            self.state, self.to_device(batch),
            lr=self.kfac_lr(self.state.step),
            damping=self.precond.damping if self.precond else 0.0)
        return m

    def evaluate(self):
        """Mean loss over the validation batches: the JAX trainer's draw,
        the first VAL_BATCHES of an epoch's worth from seed + 1."""
        a = self.args
        draws = kdata.sample_lm_batches(
            self.val_ids, a.seq_len, a.batch_size,
            min(VAL_BATCHES, a.steps_per_epoch),
            np.random.RandomState(a.seed + 1))
        return float(np.mean([float(coll.pmean(training.eval_step(
            self.state.model, self.to_device(b), loss_fn)[0], self.group))
            for b in draws]))


def main(argv=None, group=None):
    """Run the trainer (in ``group`` if given, as ``launch.spawn`` gives
    one; else the launcher's group at world>1); returns it."""
    args = parse_args(argv)
    with observed(
            args, f'longctx_L{args.seq_len}', args.kfac_name,
            f'bs{args.batch_size}', f'sd{args.seq_devices}',
            f'dd{args.data_devices}',
            trainer=lambda log: Trainer(args, group=group, log=log)) as (
                tr, log, tracer, reg, tb):
        if args.speed:
            batch = next(tr.batches())
            speed(tr, batch, tr.tokens(batch), 'tokens/sec')
            return tr
        monitor = utils.HealthMonitor(log, state=tr.state, registry=reg)
        gate_tuner(tr, monitor)
        for epoch in range(args.epochs):
            t0 = time.time()
            losses = []
            for b in tr.batches():
                m = tr.train_step(b)
                losses.append(float(m['loss']))
                monitor.update(m, step=tr.state.step - 1)
            val = tr.evaluate()
            ppl = math.exp(min(np.mean(losses), 20))
            vppl = math.exp(min(val, 20))
            end_epoch(tr, f'epoch {epoch}: train_ppl {ppl:.2f} val_ppl '
                          f'{vppl:.2f} ({time.time() - t0:.1f}s)',
                      epoch, monitor, reg, tracer)
            if tb is not None:
                tb.add_scalar('train/ppl', ppl, epoch)
                tb.add_scalar('val/ppl', vppl, epoch)
                tb.flush()
        end_world(tr, group)
        return tr


if __name__ == '__main__':
    main()
