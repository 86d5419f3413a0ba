"""K-FAC-aware layers (port of ``kfac_pytorch_tpu/nn.py``).

Plain ``torch.nn.Conv2d``/``torch.nn.Linear`` that carry the
``kfac_enabled`` mark :mod:`capture` looks for; the capture itself is
hooks armed from outside (``capture.Capture``), so an unarmed layer is
exactly the torch layer.
"""

import torch


class Conv2d(torch.nn.Conv2d):
    """2-D convolution captured by K-FAC (reference hook target)."""

    def __init__(self, *args, kfac_enabled=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.kfac_enabled = kfac_enabled


class Linear(torch.nn.Linear):
    """Dense layer captured by K-FAC (reference hook target)."""

    def __init__(self, *args, kfac_enabled=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.kfac_enabled = kfac_enabled
