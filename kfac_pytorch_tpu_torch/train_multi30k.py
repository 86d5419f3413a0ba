"""Multi-30k Transformer trainer of the port (counterpart of
``examples/multi30k_transformer.py``): the JAX trainer's flag
names and defaults (Transformer-base: d_model 512, 6 + 6 layers, 8
heads, d_inner 2048, max length 32, batch 128; SGD with momentum 0.9,
weight decay 5e-4 and ``warmup_multistep(base_lr, steps_per_epoch, 5,
lr_decay)``, ``eigen_dp`` K-FAC every 10 steps; or ``--optimizer adam``,
Adam(0.9, 0.98, 1e-9) under the inverse-sqrt schedule, without K-FAC),
plus ``--device`` (default ``cuda``), ``--dist-backend``,
``--steps-per-epoch`` and the decomposition-ladder flags of the port's
other trainers.

  python -m kfac_pytorch_tpu_torch.train_multi30k --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_multi30k --device cpu \\
      --d-model 32 --d-inner 64 --n-layers 2 --n-head 4 --batch-size 16 \\
      --steps-per-epoch 2 --epochs 1
  python -m kfac_pytorch_tpu_torch.launch --nproc 2 -- train_multi30k \\
      --dist-backend gloo --kfac-capture-impl pallas

Reads whitespace-tokenized ``train.de``/``train.en`` (and ``val.*``)
from ``--dir`` when they exist, else the synthetic reversal task
(:func:`synthetic_translation`). The model is wrapped as the JAX trainer
wraps it (``models.transformer.Wrapped``: ``batch['input']`` is the
``(src, trg)`` pair, layer names start with ``inner/``); the loss is the
label-smoothed cross entropy of ``trg[1:]`` from ``trg[:-1]`` over the
non-pad tokens; the tied pre-softmax projection is not a K-FAC layer
(``exclude_vocabulary_size`` would drop an untied one). Each epoch ends
with a greedy-decoded (``--beam-size`` > 0: beam search) BLEU on 128
validation sentences.

At ``--num-devices`` > 1 (the JAX trainer's ``'batch'`` mesh axis) each
rank is one process (started by the launcher, or a ``group`` from
``launch.spawn``), ``--batch-size`` is the GLOBAL batch and rank r
trains on its rows ``[r*B/P, (r+1)*B/P)``: the local-mean loss, the
gradients averaged over the ranks, K-FAC over the world. Dropout draws
each rank's own masks, from a stream seeded by ``(seed + 2, step,
rank)`` (the JAX trainer's ``dropout_seed`` folded with the step and the
axis index). Rank 0 prints; the run ends by checking that the replicas
are bitwise equal.

``--log-dir``, ``--trace``, ``--prom-file`` and ``--tb-dir`` as the JAX
trainer wires them (``train_imagenet.observed``): the run log, a
``kfac.dispatch`` span a step, the metrics registry's exports and the
epoch's TensorBoard scalars.
"""

import argparse
import collections
import os
import time

import numpy as np
import torch

from kfac_pytorch_tpu_torch import training, utils
from kfac_pytorch_tpu_torch.models import transformer, translator
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.train_imagenet import (
    add_autotune_flag, add_kfac_flags, add_obs_flags, add_world_flags,
    end_epoch, end_world, gate_tuner, init_world, kfac_for, observed, say,
    speed, tuner_for)
from kfac_pytorch_tpu_torch.utils.losses import label_smoothing_cross_entropy

PAD, BOS, EOS = 1, 2, 3
#: validation sentences kept, and the ones each epoch's BLEU decodes
VAL_SIZE, BLEU_SIZE = 256, 128


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Multi-30k Transformer + K-FAC '
                                            '(PyTorch)')
    p.add_argument('--dir', default=None)
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--steps-per-epoch', type=int, default=None,
                   help='cut each epoch to this many steps (default: the '
                        'whole training set)')
    p.add_argument('--d-model', type=int, default=512)
    p.add_argument('--d-inner', type=int, default=2048)
    p.add_argument('--n-layers', type=int, default=6)
    p.add_argument('--n-head', type=int, default=8)
    p.add_argument('--max-len', type=int, default=32)
    p.add_argument('--dropout', type=float, default=0.1)
    p.add_argument('--label-smoothing', type=float, default=0.1)
    p.add_argument('--optimizer', default='sgd', choices=['sgd', 'adam'])
    p.add_argument('--base-lr', type=float, default=0.1)
    p.add_argument('--lr-mul', type=float, default=0.5)
    p.add_argument('--warmup-steps', type=int, default=4000)
    p.add_argument('--lr-decay', nargs='+', type=int, default=[40, 80])
    add_kfac_flags(p, update_freq=10, damping=0.03)
    add_autotune_flag(p)
    p.add_argument('--num-devices', type=int, default=1)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--speed', action='store_true',
                   help='print tokens/s of warm, synchronized steps and '
                        'exit')
    p.add_argument('--beam-size', type=int, default=0,
                   help='>0 uses beam search for the BLEU evaluation')
    p.add_argument('--synthetic-vocab', type=int, default=64)
    p.add_argument('--synthetic-size', type=int, default=2048)
    add_world_flags(p)
    add_obs_flags(p)
    return p.parse_args(argv)


def load_parallel(data_dir, split, max_len):
    """Whitespace-tokenized ``{split}.de``/``{split}.en`` of ``data_dir``,
    each sentence cut to ``max_len - 2`` words (bos and eos to come)."""
    with open(os.path.join(data_dir, f'{split}.de')) as f:
        src = [line.split()[:max_len - 2] for line in f]
    with open(os.path.join(data_dir, f'{split}.en')) as f:
        trg = [line.split()[:max_len - 2] for line in f]
    return src, trg


def build_vocab(sentences, min_freq=2):
    """Word -> id: the four specials, then every word seen ``min_freq``
    times or more, most common first."""
    c = collections.Counter(w for s in sentences for w in s)
    vocab = {'<unk>': 0, '<pad>': PAD, '<bos>': BOS, '<eos>': EOS}
    for w, n in c.most_common():
        if n >= min_freq:
            vocab[w] = len(vocab)
    return vocab


def encode_corpus(src, trg, src_vocab, trg_vocab, max_len):
    """``[N, max_len]`` int32 id arrays: bos, the words (unknown -> 0),
    eos, then pad."""
    def enc(sents, vocab):
        out = np.full((len(sents), max_len), PAD, np.int32)
        for i, s in enumerate(sents):
            ids = [BOS] + [vocab.get(w, 0) for w in s] + [EOS]
            out[i, :len(ids)] = ids[:max_len]
        return out
    return enc(src, src_vocab), enc(trg, trg_vocab)


def synthetic_translation(n, vocab, max_len, seed=0):
    """The reversal task: the target is the source's tokens reversed,
    between bos and eos."""
    rng = np.random.RandomState(seed)
    src = np.full((n, max_len), PAD, np.int32)
    trg = np.full((n, max_len), PAD, np.int32)
    for i in range(n):
        L = rng.randint(4, max_len - 2)
        toks = rng.randint(4, vocab - 1, L)
        src[i, 0], src[i, 1:L + 1], src[i, L + 1] = BOS, toks, EOS
        trg[i, 0], trg[i, 1:L + 1], trg[i, L + 1] = BOS, toks[::-1], EOS
    return src, trg


def load_data(args):
    """``(train_src, train_trg, val_src, val_trg, n_src_vocab,
    n_trg_vocab)``: the corpus of ``--dir`` (its first 256 training pairs
    stand in for a missing ``val`` split), else the synthetic task."""
    if args.dir and os.path.exists(os.path.join(args.dir, 'train.de')):
        src_s, trg_s = load_parallel(args.dir, 'train', args.max_len)
        vsrc, vtrg = build_vocab(src_s), build_vocab(trg_s)
        train_src, train_trg = encode_corpus(src_s, trg_s, vsrc, vtrg,
                                             args.max_len)
        try:
            vs, vt = load_parallel(args.dir, 'val', args.max_len)
            val_src, val_trg = encode_corpus(vs, vt, vsrc, vtrg,
                                             args.max_len)
        except FileNotFoundError:
            val_src, val_trg = train_src[:VAL_SIZE], train_trg[:VAL_SIZE]
        return (train_src, train_trg, val_src, val_trg, len(vsrc),
                len(vtrg))
    v = args.synthetic_vocab
    train_src, train_trg = synthetic_translation(
        args.synthetic_size, v, args.max_len, args.seed)
    val_src, val_trg = synthetic_translation(VAL_SIZE, v, args.max_len,
                                             args.seed + 1)
    return train_src, train_trg, val_src, val_trg, v, v


def loss_fn(outputs, batch, smoothing=0.1):
    """Shifted teacher forcing: the label-smoothed cross entropy of
    ``trg[1:]`` from the logits at ``trg[:-1]``, over the non-pad
    targets."""
    target = batch['label'][:, 1:]
    return label_smoothing_cross_entropy(
        outputs[:, :-1], target, smoothing=smoothing,
        weights=(target != PAD).to(torch.float32))


class Trainer:
    """Everything one run needs, built from the parsed flags: corpus,
    model, optimizer, preconditioner, state and the step. Matmuls run in
    fp32 (TF32 off), the reference's precision."""

    #: the input cast of the port's other trainers: token ids pass as they
    #: are, and the weights stay fp32
    dtype = torch.float32

    log = None

    def __init__(self, args, group=None, local_rank=None, log=None):
        self.args = args
        self.tracer = None
        self.log = log
        self.world = args.num_devices
        self.group, self.rank, self.device = init_world(args, group,
                                                        local_rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        (self.train_src, self.train_trg, self.val_src, self.val_trg,
         n_src, n_trg) = load_data(args)
        d = args.d_model
        self.net = transformer.multi30k_transformer(
            n_src, n_trg, seed=args.seed, src_pad_idx=PAD, trg_pad_idx=PAD,
            d_word_vec=d, d_model=d, d_inner=args.d_inner,
            n_layers=args.n_layers, n_head=args.n_head,
            d_k=d // args.n_head, d_v=d // args.n_head,
            dropout=args.dropout, n_position=max(200, args.max_len))
        model = transformer.Wrapped(self.net)
        self.steps_per_epoch = max(len(self.train_src) // args.batch_size, 1)
        if args.steps_per_epoch is not None:
            self.steps_per_epoch = min(args.steps_per_epoch,
                                       self.steps_per_epoch)
        self.precond = None
        if args.optimizer == 'adam':
            self.lr_fn = utils.inverse_sqrt(d, args.warmup_steps,
                                            args.lr_mul)
            self.tx = training.adam(self.lr_fn, b1=0.9, b2=0.98, eps=1e-9)
        else:
            self.lr_fn = utils.warmup_multistep(
                args.base_lr, max(len(self.train_src) // args.batch_size, 1),
                5, args.lr_decay)
            self.tx = training.sgd(self.lr_fn, momentum=0.9,
                                   weight_decay=5e-4)
            if args.kfac_update_freq > 0:
                self.precond = kfac_for(args, self.world, self.group,
                                        exclude_vocabulary_size=n_trg)
        # the model is set up from a sample of a rank's rows
        bs = args.batch_size // self.world
        sample = (self.train_src[:bs].astype(np.int64),
                  self.train_trg[:bs].astype(np.int64))
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.tuner = tuner_for(self, args)
        self.step_fn = training.build_train_step(
            model, self.tx, self.precond, self.loss_fn,
            dropout_seed=args.seed + 2, group=self.group, autotune=self.tuner)

    def say(self, *args, **kw):
        say(self, *args, **kw)

    def loss_fn(self, outputs, batch):
        return loss_fn(outputs, batch, self.args.label_smoothing)

    def batches(self, epoch=0):
        """One epoch of host batches, in the JAX trainer's order (a
        permutation seeded by the epoch)."""
        bs = self.args.batch_size
        order = np.random.RandomState(epoch).permutation(len(self.train_src))
        for i in range(self.steps_per_epoch):
            sel = order[i * bs:(i + 1) * bs]
            yield {'input': (self.train_src[sel], self.train_trg[sel]),
                   'label': self.train_trg[sel]}

    def tokens(self, batch):
        """Token positions a batch feeds the model (source and target
        rows of max_len each, as the JAX speed report counts them)."""
        return batch['label'].shape[0] * self.args.max_len

    def to_device(self, batch):
        """This rank's rows of a global host batch, on the device."""
        if self.world > 1:
            batch = kmesh.shard_batch(batch, self.rank, self.world)
        return {'input': training.to_device(
                    tuple(t.astype(np.int64) for t in batch['input']),
                    self.device),
                'label': torch.as_tensor(batch['label'].astype(np.int64),
                                         device=self.device)}

    def kfac_lr(self, step):
        """The lr the step hands K-FAC (its KL clip) at ``step``: the
        JAX trainer's constant ``--base-lr``."""
        return self.args.base_lr

    def train_step(self, batch):
        """One step on a host batch; returns the metrics dict."""
        a = self.args
        self.state, m = self.step_fn(
            self.state, self.to_device(batch),
            lr=self.kfac_lr(self.state.step),
            damping=a.damping if self.precond else 0.0)
        return m

    def evaluate(self):
        """Corpus BLEU of the first BLEU_SIZE validation sentences, greedy
        (or beam search with ``--beam-size``), against their targets
        without bos, eos and pad."""
        a = self.args
        src = torch.as_tensor(self.val_src[:BLEU_SIZE].astype(np.int64),
                              device=self.device)
        if a.beam_size > 0:
            hyp = [translator.beam_search_decode(
                self.net, s, BOS, EOS, beam_size=a.beam_size,
                max_len=a.max_len) for s in src]
        else:
            hyp = translator.greedy_decode(self.net, src, BOS, EOS,
                                           max_len=a.max_len).cpu().tolist()
        hyps, refs = [], []
        for h, r in zip(hyp, self.val_trg[:BLEU_SIZE]):
            hyps.append(h[:h.index(EOS)] if EOS in h else h)
            refs.append([t for t in r.tolist()[1:] if t not in (PAD, EOS)])
        return translator.bleu(hyps, refs)


def main(argv=None, group=None):
    """Run the trainer (in ``group`` if given, as ``launch.spawn`` gives
    one; else the launcher's group at world>1); returns it."""
    args = parse_args(argv)
    with observed(
            args, 'multi30k', args.optimizer,
            f'kfac{args.kfac_update_freq}', args.kfac_name,
            f'bs{args.batch_size}', f'nd{args.num_devices}',
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
            for batch in tr.batches(epoch):
                m = tr.train_step(batch)
                losses.append(float(m['loss']))
                monitor.update(m, step=tr.state.step - 1)
            score = tr.evaluate()
            train_loss = np.mean(losses)
            end_epoch(tr, f'epoch {epoch}: train_loss {train_loss:.4f} BLEU '
                          f'{score:.2f} ({time.time() - t0:.1f}s)',
                      epoch, monitor, reg, tracer)
            if tb is not None:
                tb.add_scalar('train/loss', train_loss, epoch)
                tb.add_scalar('val/BLEU', score, epoch)
                tb.flush()
        end_world(tr, group)
        return tr


if __name__ == '__main__':
    main()
