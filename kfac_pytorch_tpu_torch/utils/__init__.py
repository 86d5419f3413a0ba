"""Training utilities of the port."""

from kfac_pytorch_tpu_torch.utils.lr import warmup_multistep  # noqa: F401
from kfac_pytorch_tpu_torch.utils.metrics import (  # noqa: F401
    HealthMonitor, accuracy)
from kfac_pytorch_tpu_torch.utils.platform import resolve_device  # noqa: F401
from kfac_pytorch_tpu_torch.utils.runlog import health_suffix  # noqa: F401
