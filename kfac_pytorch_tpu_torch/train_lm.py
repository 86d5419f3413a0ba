"""Long-context causal-LM trainer of the port (counterpart of
``examples/longcontext_lm.py`` at world=1): the same flag names and
defaults for the flags the port supports, plus ``--device`` (default
``cuda``), ``--kfac-capture-impl`` and ``--attn-impl``.

  python -m kfac_pytorch_tpu_torch.train_lm --kfac-capture-impl auto --epochs 1

Trains the 4-layer, 256-wide ``TransformerLM`` on 2048-token windows of
the synthetic Markov corpus (or ``--data``, a text file) with
``eigen_dp`` K-FAC, the vocabulary head excluded. ``--attn-impl``
'pallas'/'auto' runs attention through the hand-written CUDA kernels
(K4 forward, K5a/K5b backward), 'xla' through plain PyTorch ops.
"""

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu_torch as kfac
from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import models, training, utils
from kfac_pytorch_tpu_torch.parallel.ring_attention import BLOCK_IMPLS

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
                   help="size of the 'seq' mesh axis (1 in the port so far)")
    p.add_argument('--data-devices', type=int, default=1,
                   help="size of the 'data' mesh axis (1 in the port so "
                        'far)')
    p.add_argument('--base-lr', type=float, default=3e-2)
    p.add_argument('--kfac-update-freq', type=int, default=10,
                   help='0 disables K-FAC (pure SGD)')
    p.add_argument('--kfac-cov-update-freq', type=int, default=1)
    p.add_argument('--kfac-capture-impl', default=None,
                   choices=['xla', 'pallas', 'auto'],
                   help="capture path: unset or 'xla' = plain torch ops; "
                        "'pallas'/'auto' = the fused CUDA capture kernels")
    p.add_argument('--attn-impl', default='auto', choices=list(BLOCK_IMPLS),
                   help="attention blocks: 'xla' = plain torch ops; "
                        "'pallas'/'auto' = the CUDA flash-attention kernels")
    p.add_argument('--kfac-name', default='eigen_dp',
                   choices=list(kfac.KFAC_VARIANTS))
    p.add_argument('--damping', type=float, default=0.003)
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--vocab-limit', type=int, default=8192)
    p.add_argument('--synthetic-vocab', type=int, default=512)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p.parse_args(argv)


def loss_fn(outputs, batch):
    """Mean next-token cross entropy over every position."""
    return F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                           batch['label'].reshape(-1))


class Trainer:
    """Everything one run needs, built from the parsed flags: corpus,
    model, optimizer, preconditioner, state and the step. Matmuls run in
    fp32 (TF32 off), the reference's precision."""

    def __init__(self, args):
        if args.seq_devices != 1 or args.data_devices != 1:
            raise NotImplementedError(
                '--seq-devices/--data-devices > 1 (the sequence and data '
                'mesh over a process group) are port slices E and B')
        self.args = args
        self.device = utils.resolve_device(args.device)
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
            block_impl=args.attn_impl)
        self.tx = training.sgd(args.base_lr, momentum=0.9)
        self.precond = None
        if args.kfac_update_freq > 0:
            self.precond = kfac.get_kfac_module(args.kfac_name)(
                lr=args.base_lr, damping=args.damping,
                fac_update_freq=args.kfac_cov_update_freq,
                kfac_update_freq=args.kfac_update_freq,
                kl_clip=args.kl_clip, factor_decay=args.stat_decay,
                capture_impl=args.kfac_capture_impl,
                exclude_vocabulary_size=self.vocab)
        sample = np.zeros((args.batch_size, args.seq_len), np.int64)
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.step_fn = training.build_train_step(model, self.tx,
                                                 self.precond, loss_fn)
        self.rng = np.random.RandomState(args.seed)

    def batches(self):
        """One epoch of training batches (host numpy)."""
        a = self.args
        return kdata.sample_lm_batches(self.train_ids, a.seq_len,
                                       a.batch_size, a.steps_per_epoch,
                                       self.rng)

    def to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device, torch.int64)
                for k, v in batch.items()}

    def train_step(self, batch):
        """One step on a host batch; returns the metrics dict."""
        self.state, m = self.step_fn(self.state, self.to_device(batch),
                                     lr=self.args.base_lr,
                                     damping=self.args.damping)
        return m

    def evaluate(self):
        """Mean loss over the validation batches: the JAX trainer's draw,
        the first VAL_BATCHES of an epoch's worth from seed + 1."""
        a = self.args
        draws = kdata.sample_lm_batches(
            self.val_ids, a.seq_len, a.batch_size,
            min(VAL_BATCHES, a.steps_per_epoch),
            np.random.RandomState(a.seed + 1))
        return float(np.mean([
            float(training.eval_step(self.state.model, self.to_device(b),
                                     loss_fn)[0]) for b in draws]))


def main(argv=None):
    args = parse_args(argv)
    tr = Trainer(args)
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = [float(tr.train_step(b)['loss']) for b in tr.batches()]
        if not np.all(np.isfinite(losses)):
            raise FloatingPointError(f'non-finite training loss: {losses}')
        val = tr.evaluate()
        print(f'epoch {epoch}: train_ppl '
              f'{math.exp(min(np.mean(losses), 20)):.2f} val_ppl '
              f'{math.exp(min(val, 20)):.2f} ({time.time() - t0:.1f}s)',
              flush=True)


if __name__ == '__main__':
    main()
