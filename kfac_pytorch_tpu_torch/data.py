"""Input pipeline (port of ``kfac_pytorch_tpu/data.py``: the CIFAR-10
archive reader and the synthetic CIFAR source, normalization, the
augmentation (native, with its numpy branch), the background prefetch and
the shuffling loader; of the ImageNet trainer's data,
``examples/imagenet_resnet.py``; and of the long-context trainer's corpus
and batch sampler, ``examples/longcontext_lm.py``).

Batches are host numpy dicts, ``{'input': [B, H, W, 3] float32 NHWC,
'label': [B] int64}`` for CIFAR and ImageNet, and ``{'input': [B, L]
int32 tokens, 'label': [B, L] int32 next tokens}`` for the LM, drawn from
the same seeded streams as the JAX package's, so both packages see the
same batches. ``Loader.epoch(retry=)`` survives a transient producer
failure (``resilience.resumable_iter``), and ``Loader(shard=)`` gives each
process its slice of every epoch. Not ported yet: the loader's fault
hook (ROADMAP queue 1, slice G).
"""

import collections
import os
import pickle
import queue
import tarfile
import threading

import numpy as np

from kfac_pytorch_tpu_torch import native_lib

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def synthetic_classification(n, shape, num_classes, seed=0):
    """Deterministic synthetic dataset with class-dependent means, so a
    model can fit it."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    means = rng.randn(num_classes, *shape).astype(np.float32) * 0.5
    x = (rng.randn(n, *shape).astype(np.float32) + means[labels])
    return x, labels.astype(np.int64)


def load_cifar10(data_dir):
    """``((train_x, train_y), (test_x, test_y))`` from the standard
    ``cifar-10-batches-py`` pickles under ``data_dir`` (extracted from
    ``cifar-10-python.tar.gz`` there first if only the archive is):
    uint8 NHWC images, int64 labels."""
    base = os.path.join(data_dir, 'cifar-10-batches-py')
    if not os.path.isdir(base):
        archive = os.path.join(data_dir, 'cifar-10-python.tar.gz')
        if os.path.exists(archive):
            with tarfile.open(archive) as tf:
                tf.extractall(data_dir, filter='data')
    xs, ys = [], []
    for name in [f'data_batch_{i}' for i in range(1, 6)]:
        with open(os.path.join(base, name), 'rb') as f:
            d = pickle.load(f, encoding='bytes')
        xs.append(d[b'data'])
        ys.extend(d[b'labels'])
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    with open(os.path.join(base, 'test_batch'), 'rb') as f:
        d = pickle.load(f, encoding='bytes')
    test_x = d[b'data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ((train_x, np.asarray(ys, np.int64)),
            (test_x, np.asarray(d[b'labels'], np.int64)))


def get_cifar(data_dir=None, num_classes=10, synthetic_size=2048):
    """(train, val) arrays: CIFAR-10 from ``data_dir`` when it holds it
    (:func:`load_cifar10`), else the synthetic stand-in: one draw, then
    split, so train and val share the class means."""
    if data_dir and num_classes == 10:
        try:
            return load_cifar10(data_dir)
        except (FileNotFoundError, OSError):
            pass
    n_val = synthetic_size // 4
    x, y = synthetic_classification(synthetic_size + n_val, (32, 32, 3),
                                    num_classes, seed=1)
    return (x[:synthetic_size], y[:synthetic_size]), \
        (x[synthetic_size:], y[synthetic_size:])


def get_imagenet(train_dir=None, img_size=224, synthetic_size=1024):
    """(train, val) arrays of the ImageNet trainer
    (``examples/imagenet_resnet.py`` ``get_data``): ``images.npy``
    (memory-mapped) and ``labels.npy`` from ``train_dir`` when it holds
    them, validating on their first 1024; else the synthetic stand-in,
    ``synthetic_size + 256`` images of ``img_size`` x ``img_size`` x 3 in
    1000 classes, one draw split so train and val share the class
    means."""
    if train_dir and os.path.exists(os.path.join(train_dir, 'images.npy')):
        x = np.load(os.path.join(train_dir, 'images.npy'), mmap_mode='r')
        y = np.load(os.path.join(train_dir, 'labels.npy'))
        return (x, y), (x[:1024], y[:1024])
    x, y = synthetic_classification(synthetic_size + 256,
                                    (img_size, img_size, 3), 1000, seed=1)
    return (x[:-256], y[:-256]), (x[-256:], y[-256:])


def _normalize(x):
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
        x = (x - CIFAR10_MEAN) / CIFAR10_STD
    return x.astype(np.float32)


def augment_cifar(rng, x):
    """Pad-4 (reflect) random crop + horizontal flip: the native batched
    kernel (``native_lib.augment_crop_flip``) when the library builds,
    else :func:`crop_flip` in numpy; the same bits either way."""
    n = x.shape[0]
    offs = rng.randint(0, 9, size=(n, 2)).astype(np.int32)
    flips = (rng.rand(n) < 0.5)
    out = native_lib.augment_crop_flip(
        x.astype(np.float32, copy=False), offs, flips.astype(np.uint8))
    return crop_flip(x, offs, flips) if out is None else out


def crop_flip(x, offs, flips, pad=4):
    """The numpy branch of :func:`augment_cifar`: ``x`` ``[N, H, W, C]``
    reflect-padded by ``pad``, cropped at ``offs[i]`` and flipped where
    ``flips[i]``."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode='reflect')
    out = np.empty_like(x)
    for i in range(n):
        oy, ox = offs[i]
        win = xp[i, oy:oy + h, ox:ox + w]
        out[i] = win[:, ::-1] if flips[i] else win
    return out


class PrefetchIterator:
    """Iterator over prefetched batches with deterministic release:
    ``close()`` (idempotent) stops the producer thread at once, and the
    object is its own context manager (``with loader.epoch() as it``)."""

    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch(gen, depth=2):
    """Run a batch generator on a background thread, ``depth`` items
    ahead, so host batch assembly (gather, normalize, augment) overlaps
    the device's step. Exceptions in the producer re-raise at the
    consumer; the sequence is ``gen``'s. Returns a
    :class:`PrefetchIterator`."""
    return PrefetchIterator(_prefetch_gen(gen, depth))


def _prefetch_gen(gen, depth):
    if depth <= 0:
        yield from gen
        return
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(msg):
        # a put that gives up once the consumer is gone, so an abandoned
        # epoch does not pin this thread, its queue and the source
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(('item', item)):
                    gen.close()
                    return
            put(('end', None))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            put(('exc', e))

    t = threading.Thread(target=worker, daemon=True, name='kfac-prefetch')
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == 'end':
                break
            if kind == 'exc':
                raise payload
            yield payload
    finally:
        stop.set()
        t.join()


def default_shard():
    """``(rank, world)`` of the default process group, or ``(0, 1)``
    without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Loader:
    """Persistent shuffling batch iterator (drop-last, reshuffle per
    epoch). Each epoch draws one child seed from the loader's stream, as
    the JAX loader does.

    ``shard=(index, count)`` restricts iteration to this process's slice
    of every epoch's permutation, the multi-host DistributedSampler: every
    process draws the same permutation (the same seed) and takes the
    ``index``-th of ``count`` contiguous slices, so ``batch_size`` is the
    per-process batch and an epoch is ``len(x) // (batch_size * count)``
    steps. The default is :func:`default_shard`. The port's CIFAR and
    ImageNet trainers pass ``(0, 1)``: their loaders produce the global
    batch, and each rank takes its rows in the step."""

    def __init__(self, x, y, batch_size, train=True, augment=None, seed=0,
                 shard=None):
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.train = train
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        self.shard_index, self.shard_count = (default_shard() if shard is None
                                              else shard)
        self.steps_per_epoch = len(x) // (batch_size * self.shard_count)

    def epoch(self, prefetch_depth=2, retry=None):
        """One epoch of batches, assembled ``prefetch_depth`` ahead on a
        background thread (:func:`prefetch`; 0 = synchronous). The child
        seed is drawn here, at the call, so the batch sequence is the same
        at any depth and however far the producer ran ahead.

        ``retry``: a ``resilience.RetryPolicy`` for the next-batch path: a
        transient producer failure rebuilds the epoch from the same seed
        and fast-forwards past the batches already delivered
        (``resilience.resumable_iter``), so the consumer sees the
        unfaulted sequence; a failure that outlasts the policy raises."""
        seed = self.rng.randint(1 << 31)

        def make():
            return prefetch(self._epoch_sync(np.random.RandomState(seed)),
                            depth=prefetch_depth)

        if retry is None:
            return make()
        from kfac_pytorch_tpu_torch.resilience.retry import resumable_iter
        return PrefetchIterator(resumable_iter(make, policy=retry,
                                               label='next-batch'))

    def _epoch_sync(self, rng):
        idx = np.arange(len(self.x))
        if self.train:
            rng.shuffle(idx)
        per = len(self.x) // self.shard_count
        idx = idx[self.shard_index * per:(self.shard_index + 1) * per]
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size:(s + 1) * self.batch_size]
            bx = _normalize(self.x[sel])
            if self.train and self.augment is not None:
                bx = self.augment(rng, bx)
            yield {'input': bx, 'label': self.y[sel]}


def load_corpus(data=None, vocab_limit=8192, synthetic_vocab=512,
                batch_size=4, seq_len=2048, seed=42):
    """``(ids int32, vocab size)`` of the LM corpus: the whitespace tokens
    of the text file ``data`` (the ``vocab_limit - 1`` most common words
    plus ``<unk>``) if it exists, else a synthetic Markov chain over
    ``synthetic_vocab`` tokens (sparse Dirichlet transitions, at least
    200000 tokens), the same ids for a seed as the JAX trainer's."""
    if data and os.path.exists(data):
        with open(data) as f:
            words = f.read().split()
        vocab = {w: i for i, (w, _) in enumerate(
            collections.Counter(words).most_common(vocab_limit - 1))}
        vocab['<unk>'] = len(vocab)
        ids = np.asarray([vocab.get(w, vocab['<unk>']) for w in words],
                         np.int32)
        return ids, len(vocab)
    rng = np.random.RandomState(seed)
    V = synthetic_vocab
    cum = rng.dirichlet(np.ones(V) * 0.05, size=V).cumsum(axis=1)
    n = max(200000, batch_size * seq_len * 8)
    u = rng.rand(n)
    ids = np.zeros(n, np.int32)
    for i in range(1, n):  # inverse-CDF sampling: O(log V) per token
        ids[i] = np.searchsorted(cum[ids[i - 1]], u[i])
    return np.minimum(ids, V - 1), V


def sample_lm_batches(ids, seq_len, batch_size, steps, rng):
    """``steps`` batches of ``batch_size`` random windows of ``ids``: input
    tokens and the next tokens as labels."""
    for _ in range(steps):
        starts = rng.randint(0, len(ids) - seq_len - 1, batch_size)
        yield {'input': np.stack([ids[s:s + seq_len] for s in starts]),
               'label': np.stack([ids[s + 1:s + seq_len + 1]
                                  for s in starts])}
