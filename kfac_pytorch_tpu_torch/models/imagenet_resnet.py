"""ImageNet ResNet-18/34/50/101/152 and ResNeXt (port of
``kfac_pytorch_tpu/models/imagenet_resnet.py``): the 7x7 stride-2 stem
with explicit padding 3, a 3x3 stride-2 max pool with padding 1,
Basic/Bottleneck stages with 1x1 projection shortcuts (``ds_conv`` /
``ds_bn``), and the residual-final BatchNorm's scale initialized to zero.

Submodule names are the Flax ones (``conv1``, ``bn1``,
``layer{s}_{i}.conv1..3``, ``bn1..3``, ``ds_conv``, ``ds_bn``, ``fc``),
so weights convert by name (``weights.params_from_jax``) and the K-FAC
layer names match the JAX plan. ResNeXt's grouped ``conv2`` is a plain
convolution with ``groups``, not a K-FAC layer, as in the JAX package.

``dtype`` has Flax's meaning: parameters stay fp32, each conv and dense
casts its input and weight to ``dtype`` and returns ``dtype``
(``nn.Conv2d``/``nn.Linear`` ``compute_dtype``), and each BatchNorm
normalizes in fp32 and returns ``dtype``
(``cifar_resnet.BatchNorm2d``). Run the model in
``torch.channels_last``: the capture kernels' NHWC views are then free.
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.cifar_resnet import (BatchNorm2d,
                                                        init_weights)


def _conv(cin, cout, k, stride, dtype, groups=1):
    return knn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                      bias=False, groups=groups, kfac_enabled=groups == 1,
                      compute_dtype=dtype)


def _zero_scale(bn):
    with torch.no_grad():
        bn.weight.zero_()
    return bn


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, downsample=False,
                 groups=1, base_width=64, dtype=None):
        super().__init__()
        del groups, base_width   # the JAX block takes and ignores them
        self.conv1 = _conv(in_planes, planes, 3, stride, dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, 1, dtype)
        # zero-init gamma on the residual-final BN (the torchvision
        # zero_init_residual analogue of the reference)
        self.bn2 = _zero_scale(BatchNorm2d(planes, dtype=dtype))
        self.downsample = downsample
        if downsample:
            self.ds_conv = _conv(in_planes, planes, 1, stride, dtype)
            self.ds_bn = BatchNorm2d(planes, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(torch.nn.Module):
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, downsample=False,
                 groups=1, base_width=64, dtype=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * self.expansion
        self.conv1 = _conv(in_planes, width, 1, 1, dtype)
        self.bn1 = BatchNorm2d(width, dtype=dtype)
        self.conv2 = _conv(width, width, 3, stride, dtype, groups)
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = _conv(width, out_planes, 1, 1, dtype)
        self.bn3 = _zero_scale(BatchNorm2d(out_planes, dtype=dtype))
        self.downsample = downsample
        if downsample:
            self.ds_conv = _conv(in_planes, out_planes, 1, stride, dtype)
            self.ds_bn = BatchNorm2d(out_planes, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNet(torch.nn.Module):
    """Input: NCHW (channels_last in memory); output: logits [N, classes]
    in ``dtype``."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, block, layers, num_classes=1000, groups=1,
                 width_per_group=64, dtype=None):
        super().__init__()
        self.conv1 = knn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
        self.blocks = []
        in_planes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                layers)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                downsample = (stride != 1
                              or in_planes != planes * block.expansion)
                name = f'layer{stage + 1}_{i}'
                self.add_module(name, block(
                    in_planes, planes, stride, downsample, groups=groups,
                    base_width=width_per_group, dtype=dtype))
                self.blocks.append(name)
                in_planes = planes * block.expansion
        self.fc = knn.Linear(in_planes, num_classes, compute_dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))


def _make(block, layers, num_classes, seed, **kw):
    """A seeded ResNet; ``init_weights`` leaves the BN scales alone, so
    the residual-final ones stay zero."""
    return init_weights(ResNet(block, layers, num_classes, **kw), seed)


def resnet18(num_classes=1000, seed=0, **kw):
    return _make(BasicBlock, (2, 2, 2, 2), num_classes, seed, **kw)


def resnet34(num_classes=1000, seed=0, **kw):
    return _make(BasicBlock, (3, 4, 6, 3), num_classes, seed, **kw)


def resnet50(num_classes=1000, seed=0, **kw):
    return _make(Bottleneck, (3, 4, 6, 3), num_classes, seed, **kw)


def resnet101(num_classes=1000, seed=0, **kw):
    return _make(Bottleneck, (3, 4, 23, 3), num_classes, seed, **kw)


def resnet152(num_classes=1000, seed=0, **kw):
    return _make(Bottleneck, (3, 8, 36, 3), num_classes, seed, **kw)


def resnext50_32x4d(num_classes=1000, seed=0, **kw):
    return _make(Bottleneck, (3, 4, 6, 3), num_classes, seed, groups=32,
                 width_per_group=4, **kw)


def resnext101_32x8d(num_classes=1000, seed=0, **kw):
    return _make(Bottleneck, (3, 4, 23, 3), num_classes, seed, groups=32,
                 width_per_group=8, **kw)
