"""Input pipeline (port of ``kfac_pytorch_tpu/data.py``: the synthetic
CIFAR source, normalization, numpy augmentation and the shuffling loader).

Batches are host numpy dicts ``{'input': [B, 32, 32, 3] float32 NHWC,
'label': [B] int64}``, drawn from the same seeded streams as the JAX
loader, so both packages see the same batches.
"""

import numpy as np

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


def get_cifar(num_classes=10, synthetic_size=2048):
    """(train, val) arrays of the synthetic CIFAR stand-in: one draw, then
    split, so train and val share the class means."""
    n_val = synthetic_size // 4
    x, y = synthetic_classification(synthetic_size + n_val, (32, 32, 3),
                                    num_classes, seed=1)
    return (x[:synthetic_size], y[:synthetic_size]), \
        (x[synthetic_size:], y[synthetic_size:])


def _normalize(x):
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
        x = (x - CIFAR10_MEAN) / CIFAR10_STD
    return x.astype(np.float32)


def augment_cifar(rng, x):
    """Pad-4 (reflect) random crop + horizontal flip, in numpy."""
    n, h, w, c = x.shape
    offs = rng.randint(0, 9, size=(n, 2)).astype(np.int32)
    flips = (rng.rand(n) < 0.5)
    xp = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode='reflect')
    out = np.empty_like(x)
    for i in range(n):
        oy, ox = offs[i]
        win = xp[i, oy:oy + h, ox:ox + w]
        out[i] = win[:, ::-1] if flips[i] else win
    return out


class Loader:
    """Persistent shuffling batch iterator (drop-last, reshuffle per
    epoch). Each epoch draws one child seed from the loader's stream, as
    the JAX loader does."""

    def __init__(self, x, y, batch_size, train=True, augment=None, seed=0):
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.train = train
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        self.steps_per_epoch = len(x) // batch_size

    def epoch(self):
        """One epoch of batches."""
        rng = np.random.RandomState(self.rng.randint(1 << 31))
        idx = np.arange(len(self.x))
        if self.train:
            rng.shuffle(idx)
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size:(s + 1) * self.batch_size]
            bx = _normalize(self.x[sel])
            if self.train and self.augment is not None:
                bx = self.augment(rng, bx)
            yield {'input': bx, 'label': self.y[sel]}
