"""Tiny conv net for tests (port of ``kfac_pytorch_tpu/models/tiny.py``):
two K-FAC convs and a dense head, with an optional BatchNorm.

``c1`` (3x3, 8), [``bn1``], relu, ``c2`` (3x3 stride 2, 8), relu, the
NHWC flatten, ``fc`` (10), every layer with a bias. The tests load the
JAX net's weights into it (``weights.params_from_jax``). The JAX convs
pad 'SAME', which at stride 2 puts the odd pixel at the high end of an
even map; torch pads symmetrically, so the port takes odd ``in_size``
only (where SAME is symmetric).
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.cifar_resnet import BatchNorm2d


class TinyCNN(torch.nn.Module):
    """Input: NCHW (channels_last in memory) ``[N, 3, in_size, in_size]``;
    output: logits [N, 10]."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, batch_norm=False, in_size=7):
        super().__init__()
        if in_size % 2 == 0:
            raise ValueError('TinyCNN takes an odd in_size (its stride-2 '
                             'SAME padding is symmetric only there), got '
                             f'{in_size}')
        self.batch_norm = batch_norm
        self.c1 = knn.Conv2d(3, 8, 3, padding=1)
        if batch_norm:
            self.bn1 = BatchNorm2d(8)
        self.c2 = knn.Conv2d(8, 8, 3, stride=2, padding=1)
        out = (in_size + 1) // 2
        self.fc = knn.Linear(out * out * 8, 10)

    def forward(self, x):
        x = self.c1(x)
        if self.batch_norm:
            x = self.bn1(x)
        x = F.relu(self.c2(F.relu(x)))
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))

