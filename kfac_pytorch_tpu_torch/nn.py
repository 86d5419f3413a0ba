"""K-FAC-aware layers (port of ``kfac_pytorch_tpu/nn.py``).

Plain ``torch.nn.Conv2d``/``torch.nn.Linear`` that carry the
``kfac_enabled`` mark :mod:`capture` looks for; the capture itself is
hooks armed from outside (``capture.Capture``), so an unarmed layer is
exactly the torch layer.

``compute_dtype`` is the Flax layers' ``dtype``: parameters stay fp32,
and the forward casts its input and weight to ``compute_dtype`` and
returns ``compute_dtype``, with the bias added after the product, in
that dtype, as ``linen.dtypes.promote_dtype`` + ``y + bias`` do. The
capture hooks see the input before the cast, as the JAX layers sow it.
"""

import torch
import torch.nn.functional as F


class Conv2d(torch.nn.Conv2d):
    """2-D convolution captured by K-FAC (reference hook target)."""

    def __init__(self, *args, kfac_enabled=True, compute_dtype=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kfac_enabled = kfac_enabled
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        y = self._conv_forward(x.to(cd), self.weight.to(cd), None)
        return y if self.bias is None else y + self.bias.to(cd)[:, None,
                                                                None]


class Linear(torch.nn.Linear):
    """Dense layer captured by K-FAC (reference hook target)."""

    def __init__(self, *args, kfac_enabled=True, compute_dtype=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kfac_enabled = kfac_enabled
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)
