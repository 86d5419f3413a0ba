"""Learning-rate schedules (port of ``kfac_pytorch_tpu/utils/lr.py``).

Step-indexed callables evaluated in float32, op for op as the JAX
schedule evaluates them, so both packages feed the optimizer the same lr.
"""

import numpy as np


def warmup_multistep(base_lr, steps_per_epoch, warmup_epochs, decay_epochs,
                     decay_factor=0.1, init_scale=None, scale=1.0):
    """Linear warmup from ``base_lr*init_scale`` to ``base_lr*scale`` over
    ``warmup_epochs``, then multiply by ``decay_factor`` at each epoch in
    ``decay_epochs``; ``scale`` is the large-batch multiplier."""
    if init_scale is None:
        init_scale = 1.0 / max(scale, 1.0)
    boundaries = np.asarray(sorted(decay_epochs or []), np.float32)

    def schedule(step):
        epoch = np.float32(step) / np.float32(steps_per_epoch)
        warm_frac = epoch / np.float32(max(warmup_epochs, 1e-9))
        warm = np.float32(base_lr) * (
            np.float32(init_scale) + np.float32(scale - init_scale)
            * np.minimum(warm_frac, np.float32(1.0)))
        k = int(np.sum(epoch >= boundaries)) if boundaries.size else 0
        decayed = np.float32(base_lr * scale) * (
            np.float32(decay_factor) ** np.float32(k))
        if warmup_epochs and epoch < warmup_epochs:
            return float(warm)
        return float(decayed)

    return schedule
