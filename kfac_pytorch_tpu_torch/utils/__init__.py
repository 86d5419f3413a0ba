"""Training utilities of the port."""

from kfac_pytorch_tpu_torch.utils.lr import warmup_multistep  # noqa: F401
from kfac_pytorch_tpu_torch.utils.metrics import accuracy  # noqa: F401
from kfac_pytorch_tpu_torch.utils.platform import resolve_device  # noqa: F401
