"""Wide ResNet (WRN-28-10) for CIFAR (port of
``kfac_pytorch_tpu/models/cifar_wide_resnet.py``): pre-activation
BN-relu-conv blocks and a widen factor, no dropout.

As in the JAX block, a projection shortcut (stride or width change)
reads the ACTIVATED input ``relu(bn1(x))`` while the identity shortcut
reads the raw ``x``, and the block's modules are called, and registered,
in the order ``bn1, conv1, bn2, conv2, shortcut``. Submodule names are
the Flax ones (``conv1``, ``block{s}_{i}.bn1/conv1/bn2/conv2/shortcut``,
``bn_out``, ``fc``). ``dtype`` has Flax's meaning
(``models/imagenet_resnet.py``).
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.cifar_resnet import (BatchNorm2d,
                                                        init_weights)


def _conv(cin, cout, k, stride, dtype):
    return knn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                      bias=False, compute_dtype=dtype)


class WideBlock(torch.nn.Module):
    def __init__(self, in_planes, planes, stride=1, dtype=None):
        super().__init__()
        self.bn1 = BatchNorm2d(in_planes, dtype=dtype)
        self.conv1 = _conv(in_planes, planes, 3, stride, dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, 1, dtype)
        self.project = stride != 1 or in_planes != planes
        if self.project:
            self.shortcut = _conv(in_planes, planes, 1, stride, dtype)

    def forward(self, x):
        act = F.relu(self.bn1(x))
        out = self.conv1(act)
        out = self.conv2(F.relu(self.bn2(out)))
        return out + (self.shortcut(act) if self.project else x)


class WideResNet(torch.nn.Module):
    """Input: NCHW (channels_last in memory); output: logits [N, classes]
    in ``dtype``."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, depth=28, widen=10, num_classes=10, dtype=None):
        super().__init__()
        n = (depth - 4) // 6
        widths = (16, 16 * widen, 32 * widen, 64 * widen)
        self.conv1 = _conv(3, widths[0], 3, 1, dtype)
        self.blocks = []
        in_planes = widths[0]
        for stage in range(3):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f'block{stage + 1}_{i}'
                self.add_module(name, WideBlock(in_planes, widths[stage + 1],
                                                stride, dtype))
                self.blocks.append(name)
                in_planes = widths[stage + 1]
        self.bn_out = BatchNorm2d(in_planes, dtype=dtype)
        self.fc = knn.Linear(in_planes, num_classes, compute_dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = F.relu(self.bn_out(x))
        return self.fc(x.mean(dim=(2, 3)))


def wrn_28_10(num_classes=10, seed=0, **kw):
    return init_weights(WideResNet(28, 10, num_classes, **kw), seed)
