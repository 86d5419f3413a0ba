"""ImageNet DenseNet-BC 121/169/201 (port of
``kfac_pytorch_tpu/models/densenet.py``): BN-relu-conv pre-activation
layers with a 4k-wide bottleneck, compression-0.5 transitions with a 2x2
average pool, growth rate 32; a 7x7 stride-2 stem and a 3x3 stride-2 max
pool with padding 1 (torch pads it with -inf, as Flax does).

Submodule names are the Flax ones (``conv0``, ``bn0``,
``block{i}_layer{j}.bn1/conv1/bn2/conv2``, ``trans{i}.bn/conv``,
``bn_final``, ``fc``). The ``fc`` keeps Flax's default init
(lecun-normal), every conv kaiming-normal. ``dtype`` has Flax's meaning
(``models/imagenet_resnet.py``).
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.cifar_resnet import (BatchNorm2d,
                                                        init_weights)


def _conv(cin, cout, k, dtype, stride=1):
    return knn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                      bias=False, compute_dtype=dtype)


class DenseLayer(torch.nn.Module):
    def __init__(self, in_features, growth_rate, dtype=None):
        super().__init__()
        self.bn1 = BatchNorm2d(in_features, dtype=dtype)
        self.conv1 = _conv(in_features, 4 * growth_rate, 1, dtype)
        self.bn2 = BatchNorm2d(4 * growth_rate, dtype=dtype)
        self.conv2 = _conv(4 * growth_rate, growth_rate, 3, dtype)

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        return torch.cat([x, out], dim=1)


class Transition(torch.nn.Module):
    def __init__(self, in_features, out_features, dtype=None):
        super().__init__()
        self.bn = BatchNorm2d(in_features, dtype=dtype)
        self.conv = _conv(in_features, out_features, 1, dtype)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, stride=2)


class DenseNet(torch.nn.Module):
    """Input: NCHW (channels_last in memory); output: logits [N, classes]
    in ``dtype``."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, block_config=(6, 12, 24, 16), growth_rate=32,
                 num_init_features=64, num_classes=1000, dtype=None):
        super().__init__()
        self.conv0 = _conv(3, num_init_features, 7, dtype, stride=2)
        self.bn0 = BatchNorm2d(num_init_features, dtype=dtype)
        self.blocks = []
        features = num_init_features
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                name = f'block{i}_layer{j}'
                self.add_module(name, DenseLayer(features, growth_rate,
                                                 dtype))
                self.blocks.append(name)
                features += growth_rate
            if i != len(block_config) - 1:
                name = f'trans{i}'
                # BC compression 0.5
                self.add_module(name, Transition(features, features // 2,
                                                 dtype))
                self.blocks.append(name)
                features //= 2
        self.bn_final = BatchNorm2d(features, dtype=dtype)
        self.fc = knn.Linear(features, num_classes, compute_dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = F.relu(self.bn_final(x))
        return self.fc(x.mean(dim=(2, 3)))


def _make(block_config, num_classes, seed, **kw):
    return init_weights(DenseNet(block_config, num_classes=num_classes,
                                 **kw), seed, lecun=('fc',))


def densenet121(num_classes=1000, seed=0, **kw):
    return _make((6, 12, 24, 16), num_classes, seed, **kw)


def densenet169(num_classes=1000, seed=0, **kw):
    return _make((6, 12, 32, 32), num_classes, seed, **kw)


def densenet201(num_classes=1000, seed=0, **kw):
    return _make((6, 12, 48, 32), num_classes, seed, **kw)
