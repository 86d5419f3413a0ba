"""WikiText-2 LSTM language-model trainer of the port (counterpart of
``examples/wikitext_rnn.py``): the JAX trainer's flag names and defaults
(2-layer LSTM-650, batch 20, BPTT 35, SGD at lr 20 after clipping the
gradients' global norm to 0.25, perplexity each epoch), plus
``--device`` (default ``cuda``), ``--steps-per-epoch`` and the
decomposition-ladder flags of the port's other trainers.

  python -m kfac_pytorch_tpu_torch.train_wikitext
  python -m kfac_pytorch_tpu_torch.train_wikitext --kfac-update-freq 10 \\
      --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_wikitext --device cpu \\
      --embed-dim 32 --hidden-dim 32 --steps-per-epoch 2 --epochs 1

``--kfac-update-freq`` 0 (the default) is plain SGD with the fused cell;
above 0 the model takes the capture-aware cell
(``models.rnn.KFACLSTMCell``), whose input and recurrent projections
K-FAC preconditions with their per-timestep captures, the decoder
excluded by the vocabulary size. Reads a whitespace-tokenized text file
from ``--data`` when it exists, else a synthetic Markov chain
(:func:`load_corpus`).

``--log-dir``, ``--trace``, ``--prom-file`` and ``--tb-dir`` as the JAX
trainer wires them (``train_imagenet.observed``): the run log, a
``kfac.dispatch`` span a step, the metrics registry's exports and the
epoch's TensorBoard scalars.
"""

import argparse
import collections
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import models, training, utils
from kfac_pytorch_tpu_torch.train_imagenet import (
    add_autotune_flag, add_kfac_flags, add_obs_flags, end_epoch, gate_tuner,
    kfac_for, observed, say, speed, tuner_for)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='WikiText LSTM LM (PyTorch)')
    p.add_argument('--data', default=None)
    p.add_argument('--batch-size', type=int, default=20)
    p.add_argument('--bptt', type=int, default=35)
    p.add_argument('--epochs', type=int, default=5)
    p.add_argument('--steps-per-epoch', type=int, default=None,
                   help='cut each epoch to this many steps (default: the '
                        'whole corpus)')
    p.add_argument('--embed-dim', type=int, default=650)
    p.add_argument('--hidden-dim', type=int, default=650)
    p.add_argument('--num-layers', type=int, default=2)
    p.add_argument('--dropout', type=float, default=0.5)
    p.add_argument('--base-lr', type=float, default=20.0)
    p.add_argument('--clip', type=float, default=0.25)
    p.add_argument('--vocab-limit', type=int, default=10000)
    add_kfac_flags(p, update_freq=0, damping=0.003)
    add_autotune_flag(p)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--synthetic-vocab', type=int, default=256)
    p.add_argument('--synthetic-tokens', type=int, default=100000)
    p.add_argument('--speed', action='store_true',
                   help='print tokens/s of warm, synchronized steps and '
                        'exit')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    add_obs_flags(p)
    return p.parse_args(argv)


def markov_corpus(vocab, n, seed):
    """``n`` int32 tokens of a Markov chain over ``vocab`` tokens with
    sparse Dirichlet(0.05) transitions, from token 0: the JAX trainer's
    ``rng.choice(V, p=trans[prev])`` draws (one uniform a token, the
    row's normalized CDF searched on its right), made in one pass."""
    rng = np.random.RandomState(seed)
    cdf = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab).cumsum(axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random_sample(n - 1)
    ids = np.zeros(n, np.int32)
    for i in range(1, n):
        ids[i] = np.searchsorted(cdf[ids[i - 1]], u[i - 1], side='right')
    return ids


def load_corpus(args):
    """``(ids int32, vocab size)``: the whitespace tokens of ``--data`` if
    it exists (the ``--vocab-limit - 1`` most common words plus
    ``<unk>``), else the synthetic chain over ``--synthetic-vocab``
    tokens (:func:`markov_corpus`)."""
    if args.data and os.path.exists(args.data):
        with open(args.data) as f:
            words = f.read().split()
        vocab = {w: i for i, (w, _) in enumerate(
            collections.Counter(words).most_common(args.vocab_limit - 1))}
        vocab['<unk>'] = len(vocab)
        ids = np.asarray([vocab.get(w, vocab['<unk>']) for w in words],
                         np.int32)
        return ids, len(vocab)
    return (markov_corpus(args.synthetic_vocab, args.synthetic_tokens,
                          args.seed), args.synthetic_vocab)


def batchify(ids, batch_size):
    """``[batch_size, n]``: the stream cut into ``batch_size`` rows."""
    n = len(ids) // batch_size
    return ids[:n * batch_size].reshape(batch_size, n)


def loss_fn(outputs, batch):
    """Mean next-token cross entropy over every position."""
    return F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                           batch['label'].reshape(-1))


class Trainer:
    """Everything one run needs, built from the parsed flags: corpus,
    model, optimizer, preconditioner, state and the step. Matmuls run in
    fp32 (TF32 off), the reference's precision."""

    #: the input cast of the port's other trainers: token ids pass as they
    #: are, and the weights stay fp32
    dtype = torch.float32

    log = None

    def __init__(self, args, corpus=None, log=None):
        self.args = args
        self.tracer = None
        self.log = log
        self.rank = 0
        self.device = utils.resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ids, self.vocab = load_corpus(args) if corpus is None else corpus
        split = int(len(ids) * 0.95)
        self.train_data = batchify(ids[:split], args.batch_size)
        self.val_data = batchify(ids[split:], args.batch_size)
        use_kfac = args.kfac_update_freq > 0
        model = models.get_model(
            'wikitext_lstm', seed=args.seed, vocab_size=self.vocab,
            embed_dim=args.embed_dim, hidden_dim=args.hidden_dim,
            num_layers=args.num_layers, dropout=args.dropout,
            kfac_lstm=use_kfac)
        self.tx = training.clip_by_global_norm(
            args.clip, training.sgd(args.base_lr, momentum=0.0))
        self.precond = (kfac_for(args, exclude_vocabulary_size=self.vocab)
                        if use_kfac else None)
        self.steps_per_epoch = (self.train_data.shape[1] - 1) // args.bptt
        if args.steps_per_epoch is not None:
            self.steps_per_epoch = min(args.steps_per_epoch,
                                       self.steps_per_epoch)
        sample = self.train_data[:, :args.bptt].astype(np.int64)
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.loss_fn = loss_fn
        self.tuner = tuner_for(self, args)
        self.step_fn = training.build_train_step(model, self.tx,
                                                 self.precond, loss_fn,
                                                 autotune=self.tuner)

    def say(self, *args, **kw):
        say(self, *args, **kw)

    @staticmethod
    def windows(data, bptt, steps):
        """``steps`` consecutive BPTT windows of ``data`` and their next
        tokens."""
        for i in range(steps):
            s = i * bptt
            yield {'input': data[:, s:s + bptt],
                   'label': data[:, s + 1:s + bptt + 1]}

    def batches(self):
        """One epoch of host batches, in corpus order."""
        return self.windows(self.train_data, self.args.bptt,
                            self.steps_per_epoch)

    def tokens(self, batch):
        return batch['input'].size

    def to_device(self, batch):
        return {k: torch.as_tensor(v.astype(np.int64), device=self.device)
                for k, v in batch.items()}

    def kfac_lr(self, step):
        """The lr the step hands K-FAC (its KL clip) at ``step``: the
        JAX trainer's constant ``--base-lr``."""
        return self.args.base_lr

    def train_step(self, batch):
        """One step on a host batch; returns the metrics dict."""
        a = self.args
        self.state, m = self.step_fn(self.state, self.to_device(batch),
                                     lr=self.kfac_lr(self.state.step),
                                     damping=a.damping)
        return m

    def evaluate(self):
        """Mean next-token loss over the validation windows."""
        bptt = self.args.bptt
        losses = [float(training.eval_step(self.state.model,
                                           self.to_device(b), loss_fn)[0])
                  for b in self.windows(self.val_data, bptt,
                                        (self.val_data.shape[1] - 1)
                                        // bptt)]
        return float(np.mean(losses))


def main(argv=None):
    """Run the trainer; returns it."""
    args = parse_args(argv)
    with observed(
            args, 'wikitext', f'kfac{args.kfac_update_freq}',
            args.kfac_name if args.kfac_update_freq else 'sgd',
            f'bs{args.batch_size}',
            trainer=lambda log: Trainer(args, log=log)) as (
                tr, log, tracer, reg, tb):
        if args.speed:
            bptt = min(args.bptt, tr.train_data.shape[1] - 1)
            batch = next(tr.windows(tr.train_data, bptt, 1))
            speed(tr, batch, tr.tokens(batch), 'tokens/sec')
            return tr
        monitor = utils.HealthMonitor(log, state=tr.state, registry=reg)
        gate_tuner(tr, monitor)
        for epoch in range(args.epochs):
            t0 = time.time()
            losses = []
            for batch in tr.batches():
                m = tr.train_step(batch)
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
        return tr


if __name__ == '__main__':
    main()
