"""SQuAD BERT trainer of the port (counterpart of
``examples/squad_bert.py``): the JAX trainer's flag names and defaults
(BERT tiny, batch 4, sequence 64, SGD with momentum 0.9 under
``polynomial_decay(base_lr, total, power=1, warmup_steps=total *
warmup_frac)``, ``eigen_dp`` K-FAC every 10 steps with the wordpiece
vocabulary excluded), plus ``--device``
(default ``cuda``), ``--dist-backend``, ``--steps-per-epoch`` and the
decomposition-ladder flags of the port's other trainers.

  python -m kfac_pytorch_tpu_torch.train_squad --model-size base \\
      --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_squad --device cpu \\
      --steps-per-epoch 2 --epochs 1

The data is the synthetic span task (:func:`synthetic_squad`), or with
``--train-file`` a SQuAD v1.1 JSON read with whitespace tokens
(:func:`load_squad`; the JAX trainer names the flag but reads only the
synthetic task). The loss is the mean of the start and end cross
entropies; each epoch ends with token-level F1 and exact match on 256
held-out examples. ``--num-devices`` > 1 runs as the Multi-30k trainer
does (``train_multi30k``: each rank its rows of the global batch, its
own dropout masks, the replicas checked at the end).

``--log-dir``, ``--trace``, ``--prom-file`` and ``--tb-dir`` as the JAX
trainer wires them (``train_imagenet.observed``): the run log, a
``kfac.dispatch`` span a step, the metrics registry's exports and the
epoch's TensorBoard scalars.
"""

import argparse
import collections
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import training, utils
from kfac_pytorch_tpu_torch.models import bert
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.train_imagenet import (
    add_autotune_flag, add_kfac_flags, add_obs_flags, add_world_flags,
    end_epoch, end_world, gate_tuner, init_world, kfac_for, observed, say,
    speed, tuner_for)

PAD, CLS, SEP, MARK = 0, 1, 2, 3
#: the id of a word outside a SQuAD file's vocabulary
UNK = 4
#: held-out examples each epoch evaluates
VAL_SIZE = 256


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='SQuAD BERT + K-FAC (PyTorch)')
    p.add_argument('--train-file', default=None)
    p.add_argument('--model-size', default='tiny',
                   choices=['tiny', 'base', 'large'])
    p.add_argument('--batch-size', type=int, default=4)
    p.add_argument('--epochs', type=int, default=2)
    p.add_argument('--steps-per-epoch', type=int, default=None,
                   help='cut each epoch to this many steps (default: the '
                        'whole training set; the lr schedule keeps its '
                        'length)')
    p.add_argument('--max-seq-length', type=int, default=64)
    p.add_argument('--base-lr', type=float, default=0.04)
    p.add_argument('--warmup-frac', type=float, default=0.1)
    add_kfac_flags(p, update_freq=10, damping=0.003)
    add_autotune_flag(p)
    p.add_argument('--num-devices', type=int, default=1)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--synthetic-size', type=int, default=1024)
    p.add_argument('--speed', action='store_true',
                   help='print tokens/s of warm, synchronized steps and '
                        'exit')
    add_world_flags(p)
    add_obs_flags(p)
    return p.parse_args(argv)


def synthetic_squad(n, seq_len, vocab, seed=0):
    """A context with a MARK-delimited answer span of 1-3 tokens; the
    question is the span's first token. ``(ids, types, mask, starts,
    ends)``, answers as token positions in ``ids``."""
    rng = np.random.RandomState(seed)
    ids = np.full((n, seq_len), PAD, np.int32)
    types = np.zeros((n, seq_len), np.int32)
    mask = np.zeros((n, seq_len), np.float32)
    starts = np.zeros(n, np.int32)
    ends = np.zeros(n, np.int32)
    for i in range(n):
        ctx_len = seq_len - 8
        ctx = rng.randint(4, vocab, ctx_len)
        s = rng.randint(2, ctx_len - 6)
        L = rng.randint(1, 4)
        ctx[s - 1] = MARK
        ctx[s + L] = MARK
        q = ctx[s:s + 1]
        seq = np.concatenate(([CLS], q, [SEP], ctx, [SEP]))
        ids[i, :len(seq)] = seq[:seq_len]
        types[i, 3:len(seq)] = 1
        mask[i, :len(seq)] = 1
        starts[i] = 3 + s
        ends[i] = 3 + s + L - 1
    return ids, types, mask, starts, ends


def load_squad(path, seq_len, vocab_size):
    """A SQuAD v1.1 JSON (``data[].paragraphs[].context/qas[].question/
    answers[0].text/answer_start``) as :func:`synthetic_squad`'s arrays:
    whitespace tokens, ids from the file's words by frequency (UNK past
    ``vocab_size``), ``[CLS] question [SEP] context [SEP]`` cut to
    ``seq_len``; a question whose answer the cut leaves out is dropped."""
    with open(path) as f:
        data = json.load(f)['data']
    examples = []
    for article in data:
        for para in article['paragraphs']:
            ctx = para['context']
            words = ctx.split()
            for qa in para['qas']:
                ans = qa['answers'][0]
                s = len(ctx[:ans['answer_start']].split())
                e = s + max(len(ans['text'].split()), 1) - 1
                examples.append((qa['question'].split(), words, s, e))
    counts = collections.Counter(w for q, c, _, _ in examples
                                 for w in q + c)
    vocab = {w: i + UNK + 1 for i, (w, _) in enumerate(
        counts.most_common(vocab_size - UNK - 1))}
    rows = []
    for q, c, s, e in examples:
        seq = ([CLS] + [vocab.get(w, UNK) for w in q] + [SEP]
               + [vocab.get(w, UNK) for w in c] + [SEP])[:seq_len]
        off = len(q) + 2
        if off + e < len(seq):
            rows.append((seq, off, s, e))
    n = len(rows)
    ids = np.full((n, seq_len), PAD, np.int32)
    types = np.zeros((n, seq_len), np.int32)
    mask = np.zeros((n, seq_len), np.float32)
    starts = np.zeros(n, np.int32)
    ends = np.zeros(n, np.int32)
    for i, (seq, off, s, e) in enumerate(rows):
        ids[i, :len(seq)] = seq
        types[i, off:len(seq)] = 1
        mask[i, :len(seq)] = 1
        starts[i], ends[i] = off + s, off + e
    return ids, types, mask, starts, ends


def squad_f1_em(pred_spans, gold_spans, token_seqs):
    """Token-level F1 and exact match, in percent, over the answers' token
    bags (the reference's metric)."""
    f1s, ems = [], []
    for (ps, pe), (gs, ge), toks in zip(pred_spans, gold_spans, token_seqs):
        pred = list(toks[ps:pe + 1]) if pe >= ps else []
        gold = list(toks[gs:ge + 1])
        ems.append(float(pred == gold))
        common = collections.Counter(pred) & collections.Counter(gold)
        n_common = sum(common.values())
        if n_common == 0:
            f1s.append(0.0)
            continue
        prec = n_common / max(len(pred), 1)
        rec = n_common / max(len(gold), 1)
        f1s.append(2 * prec * rec / (prec + rec))
    return 100.0 * np.mean(f1s), 100.0 * np.mean(ems)


def loss_fn(outputs, batch):
    """The mean of the start and end positions' cross entropies."""
    start, end = outputs
    return (F.cross_entropy(start, batch['label'][:, 0])
            + F.cross_entropy(end, batch['label'][:, 1])) / 2.0


class Trainer:
    """Everything one run needs, built from the parsed flags: data,
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
        cfg = {'tiny': bert.BertConfig.tiny, 'base': bert.BertConfig.base,
               'large': bert.BertConfig.large}[args.model_size](
                   max_position_embeddings=max(64, args.max_seq_length))
        if args.train_file:
            data = load_squad(args.train_file, args.max_seq_length,
                              cfg.vocab_size)
            self.train = tuple(a[VAL_SIZE:] for a in data)
            self.val = tuple(a[:VAL_SIZE] for a in data)
            if not len(self.train[0]):
                self.train = self.val
        else:
            self.train = synthetic_squad(args.synthetic_size,
                                         args.max_seq_length,
                                         cfg.vocab_size, args.seed)
            self.val = synthetic_squad(VAL_SIZE, args.max_seq_length,
                                       cfg.vocab_size, args.seed + 1)
        model = bert.bert_qa(cfg, seed=args.seed)
        self.steps_per_epoch = len(self.train[0]) // args.batch_size
        total = self.steps_per_epoch * args.epochs
        if args.steps_per_epoch is not None:
            self.steps_per_epoch = min(args.steps_per_epoch,
                                       self.steps_per_epoch)
        self.lr_fn = utils.polynomial_decay(
            args.base_lr, total, power=1.0,
            warmup_steps=int(total * args.warmup_frac))
        self.tx = training.sgd(self.lr_fn, momentum=0.9, weight_decay=0.0)
        self.precond = None
        if args.kfac_update_freq > 0:
            self.precond = kfac_for(
                args, self.world, self.group,
                exclude_vocabulary_size=cfg.vocab_size)
        # the model is set up from a sample of a rank's rows
        bs = args.batch_size // self.world
        self.state = training.init_train_state(
            model, self.tx, self.precond,
            self.batch(np.arange(bs))['input'], self.device)
        self.loss_fn = loss_fn
        self.tuner = tuner_for(self, args)
        self.step_fn = training.build_train_step(
            model, self.tx, self.precond, loss_fn,
            dropout_seed=args.seed + 2, group=self.group, autotune=self.tuner)
        self.rng = np.random.RandomState(args.seed)

    def say(self, *args, **kw):
        say(self, *args, **kw)

    def batch(self, sel, data=None):
        """The host batch of examples ``sel``: ``input`` the ``(ids,
        types, mask)`` triple, ``label`` the ``[B, 2]`` start and end."""
        ids, types, mask, starts, ends = self.train if data is None else data
        return {'input': (ids[sel].astype(np.int64),
                          types[sel].astype(np.int64), mask[sel]),
                'label': np.stack([starts[sel], ends[sel]],
                                  1).astype(np.int64)}

    def batches(self):
        """One epoch of host batches, in the JAX trainer's order (one
        permutation a epoch from the trainer's seeded stream)."""
        bs = self.args.batch_size
        order = self.rng.permutation(len(self.train[0]))
        for i in range(self.steps_per_epoch):
            yield self.batch(order[i * bs:(i + 1) * bs])

    def tokens(self, batch):
        return batch['input'][0].size

    def to_device(self, batch):
        """This rank's rows of a global host batch, on the device."""
        if self.world > 1:
            batch = kmesh.shard_batch(batch, self.rank, self.world)
        return {'input': training.to_device(batch['input'], self.device),
                'label': torch.as_tensor(batch['label'], device=self.device)}

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
        """``(F1, EM)`` of the argmax spans on the held-out examples."""
        model = self.state.model
        b = self.to_device(self.batch(np.arange(len(self.val[0])),
                                      self.val))
        model.eval()
        with torch.no_grad():
            s, e = model(training.model_input(model, b['input']))
        ids, _, _, starts, ends = self.val
        return squad_f1_em(
            list(zip(s.argmax(-1).tolist(), e.argmax(-1).tolist())),
            list(zip(starts, ends)), ids)


def main(argv=None, group=None):
    """Run the trainer (in ``group`` if given, as ``launch.spawn`` gives
    one; else the launcher's group at world>1); returns it."""
    args = parse_args(argv)
    with observed(
            args, 'squad', args.model_size,
            f'kfac{args.kfac_update_freq}', args.kfac_name,
            f'bs{args.batch_size}', f'nd{args.num_devices}',
            trainer=lambda log: Trainer(args, group=group, log=log)) as (
                tr, log, tracer, reg, tb):
        if args.speed:
            batch = tr.batch(np.arange(min(args.batch_size, len(tr.train[0]))))
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
            f1, em = tr.evaluate()
            loss = np.mean(losses)
            end_epoch(tr, f'epoch {epoch}: loss {loss:.4f} F1 {f1:.2f} EM '
                          f'{em:.2f} ({time.time() - t0:.1f}s)',
                      epoch, monitor, reg, tracer)
            if tb is not None:
                tb.add_scalar('train/loss', loss, epoch)
                tb.add_scalar('val/F1', f1, epoch)
                tb.add_scalar('val/EM', em, epoch)
                tb.flush()
        end_world(tr, group)
        return tr


if __name__ == '__main__':
    main()
