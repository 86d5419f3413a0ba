"""Training utilities of the port.

The checkpoint plane's names (``save_checkpoint`` ... ``read_world_stamp_
info``, the JAX package's ``utils`` exports) load on first use:
``utils.checkpoint`` imports the preconditioner, which imports this
package.
"""

from kfac_pytorch_tpu_torch.utils.lr import warmup_multistep  # noqa: F401
from kfac_pytorch_tpu_torch.utils.metrics import (  # noqa: F401
    HealthMonitor, accuracy)
from kfac_pytorch_tpu_torch.utils.platform import resolve_device  # noqa: F401
from kfac_pytorch_tpu_torch.utils.runlog import health_suffix  # noqa: F401

_CHECKPOINT = (
    'save_checkpoint', 'restore_checkpoint', 'find_resume_epoch',
    'auto_resume', 'PreemptionGuard', 'StaleLineageError',
    'wait_for_checkpoints', 'prune_checkpoints', 'reshard_kfac_state',
    'write_world_stamp', 'read_world_stamp', 'read_world_stamp_info')


def __getattr__(name):
    if name in _CHECKPOINT:
        from kfac_pytorch_tpu_torch.utils import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['warmup_multistep', 'HealthMonitor', 'accuracy',
           'resolve_device', 'health_suffix', *_CHECKPOINT]
