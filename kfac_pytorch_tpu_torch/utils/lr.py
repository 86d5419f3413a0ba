"""Learning-rate schedules (port of ``kfac_pytorch_tpu/utils/lr.py``).

Step-indexed callables evaluated in float32, op for op as the JAX
schedule evaluates them, so both packages feed the optimizer the same lr.
Each also evaluates on the device (``schedule.device(count)``, ``count`` a
0-d integer tensor), to the same bits and without a host round trip: the
guarded step's optimizer count lives on the device.
"""

import numpy as np
import torch


class WarmupMultistep:
    """Linear warmup from ``base_lr*init_scale`` to ``base_lr*scale`` over
    ``warmup_epochs``, then multiply by ``decay_factor`` at each epoch in
    ``decay_epochs``; ``scale`` is the large-batch multiplier."""

    def __init__(self, base_lr, steps_per_epoch, warmup_epochs, decay_epochs,
                 decay_factor=0.1, init_scale=None, scale=1.0):
        if init_scale is None:
            init_scale = 1.0 / max(scale, 1.0)
        self.base_lr = base_lr
        self.steps_per_epoch = steps_per_epoch
        self.warmup_epochs = warmup_epochs
        self.init_scale = init_scale
        self.scale = scale
        self.boundaries = np.asarray(sorted(decay_epochs or []), np.float32)
        # the decayed lr after k boundaries, k = 0..len(boundaries)
        self.decayed = np.asarray(
            [np.float32(base_lr * scale)
             * (np.float32(decay_factor) ** np.float32(k))
             for k in range(self.boundaries.size + 1)], np.float32)
        self._tables = {}

    def __call__(self, step):
        epoch = np.float32(step) / np.float32(self.steps_per_epoch)
        warm_frac = epoch / np.float32(max(self.warmup_epochs, 1e-9))
        warm = np.float32(self.base_lr) * (
            np.float32(self.init_scale)
            + np.float32(self.scale - self.init_scale)
            * np.minimum(warm_frac, np.float32(1.0)))
        k = int(np.sum(epoch >= self.boundaries)) \
            if self.boundaries.size else 0
        if self.warmup_epochs and epoch < self.warmup_epochs:
            return float(warm)
        return float(self.decayed[k])

    def device(self, count):
        """The lr at step ``count`` (a 0-d integer tensor) as a float32
        0-d tensor on ``count``'s device, the same bits as ``self(count)``.
        The boundary and decay tables are copied to a device once."""
        dev = count.device
        tables = self._tables.get(str(dev))
        if tables is None:
            # the divisors are device tensors: CUDA divides by a host
            # scalar as a multiplication by its reciprocal, which can
            # differ from the division in the last bit
            divisors = np.asarray([self.steps_per_epoch,
                                   max(self.warmup_epochs, 1e-9)],
                                  np.float32)
            tables = tuple(torch.from_numpy(t).to(dev) for t in
                           (self.boundaries, self.decayed, divisors))
            self._tables[str(dev)] = tables
        bounds, decayed, divisors = tables
        epoch = count.to(torch.float32) / divisors[0]
        warm_frac = epoch / divisors[1]
        warm = (torch.clamp(warm_frac, max=1.0)
                * float(np.float32(self.scale - self.init_scale))
                + float(np.float32(self.init_scale))) \
            * float(np.float32(self.base_lr))
        k = (epoch >= bounds).sum().reshape(1)
        lr = decayed.gather(0, k)[0]
        if self.warmup_epochs:
            lr = torch.where(epoch < float(self.warmup_epochs), warm, lr)
        return lr


def warmup_multistep(base_lr, steps_per_epoch, warmup_epochs, decay_epochs,
                     decay_factor=0.1, init_scale=None, scale=1.0):
    """The :class:`WarmupMultistep` schedule."""
    return WarmupMultistep(base_lr, steps_per_epoch, warmup_epochs,
                           decay_epochs, decay_factor=decay_factor,
                           init_scale=init_scale, scale=scale)
