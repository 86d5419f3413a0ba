"""Inception-v4 (port of ``kfac_pytorch_tpu/models/inception_v4.py``):
conv-BN-relu units (BatchNorm eps 1e-3), the stem, 4 x Inception-A,
Reduction-A, 7 x Inception-B, Reduction-B, 3 x Inception-C, a global
average pool and the classifier. The 3x3 average pools of the Inception
blocks pad by one and divide by the pixels inside the map
(``count_include_pad=False``, as Flax's); the max pools are VALID.

Submodule names are the Flax ones (``stem.c1``, ``mixed_a{i}.b1a``,
``reduction_a.b0``, ..., each unit's ``conv`` and ``bn``; ``fc``). Every
block creates its units in the order the JAX block calls them, so
registration order, call order and the K-FAC plan agree (Inception-C's
``b1b`` and ``b1c`` both read ``b1a``'s output, as do ``b2d`` and
``b2e`` ``b2c``'s). ``dtype`` has Flax's meaning
(``models/imagenet_resnet.py``).
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.capture import canonical_padding
from kfac_pytorch_tpu_torch.models.cifar_resnet import (BatchNorm2d,
                                                        init_weights)


class ConvUnit(torch.nn.Module):
    """conv + BN + relu (the reference's BasicConv2d); ``padding`` as the
    JAX unit takes it, ``(ph, pw)``, VALID by default."""

    def __init__(self, cin, features, kernel, strides=(1, 1),
                 padding=(0, 0), dtype=None):
        super().__init__()
        (ph, ph_hi), (pw, pw_hi) = canonical_padding(None, kernel, strides,
                                                     padding)
        if (ph, pw) != (ph_hi, pw_hi):
            raise ValueError(f'ConvUnit takes symmetric padding, got '
                             f'{padding!r}')
        self.conv = knn.Conv2d(cin, features, kernel, stride=strides,
                               padding=(ph, pw), bias=False,
                               compute_dtype=dtype)
        self.bn = BatchNorm2d(features, eps=1e-3, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _Block(torch.nn.Module):
    """Units built from ``(name, in channels, features, kernel, strides,
    padding)`` specs, in call order."""

    def __init__(self, specs, dtype):
        super().__init__()
        for name, cin, feat, k, s, p in specs:
            self.add_module(name, ConvUnit(cin, feat, k, s, p, dtype))


_1x1 = ((1, 1), (1, 1), (0, 0))
_3x3 = ((3, 3), (1, 1), (1, 1))
_3x3_valid = ((3, 3), (1, 1), (0, 0))
_3x3_s2 = ((3, 3), (2, 2), (0, 0))
_1x7 = ((1, 7), (1, 1), (0, 3))
_7x1 = ((7, 1), (1, 1), (3, 0))
_1x3 = ((1, 3), (1, 1), (0, 1))
_3x1 = ((3, 1), (1, 1), (1, 0))


class Stem(_Block):
    out_channels = 384

    def __init__(self, dtype=None):
        super().__init__([
            ('c1', 3, 32) + _3x3_s2, ('c2', 32, 32) + _3x3_valid,
            ('c3', 32, 64) + _3x3, ('c4', 64, 96) + _3x3_s2,
            ('a1', 160, 64) + _1x1, ('a2', 64, 96) + _3x3_valid,
            ('b1', 160, 64) + _1x1, ('b2', 64, 64) + _1x7,
            ('b3', 64, 64) + _7x1, ('b4', 64, 96) + _3x3_valid,
            ('d1', 192, 192) + _3x3_s2], dtype)

    def forward(self, x):
        x = self.c3(self.c2(self.c1(x)))
        x = torch.cat([_max_pool(x), self.c4(x)], dim=1)
        a = self.a2(self.a1(x))
        b = self.b4(self.b3(self.b2(self.b1(x))))
        x = torch.cat([a, b], dim=1)
        return torch.cat([self.d1(x), _max_pool(x)], dim=1)


class InceptionA(_Block):
    out_channels = 384

    def __init__(self, cin=384, dtype=None):
        super().__init__([
            ('b0', cin, 96) + _1x1, ('b1a', cin, 64) + _1x1,
            ('b1b', 64, 96) + _3x3, ('b2a', cin, 64) + _1x1,
            ('b2b', 64, 96) + _3x3, ('b2c', 96, 96) + _3x3,
            ('b3', cin, 96) + _1x1], dtype)

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2c(self.b2b(self.b2a(x)))
        b3 = self.b3(_avg_pool(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class ReductionA(_Block):
    def __init__(self, cin=384, dtype=None):
        super().__init__([
            ('b0', cin, 384) + _3x3_s2, ('b1a', cin, 192) + _1x1,
            ('b1b', 192, 224) + _3x3, ('b1c', 224, 256) + _3x3_s2], dtype)
        self.out_channels = 384 + 256 + cin

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1c(self.b1b(self.b1a(x)))
        return torch.cat([b0, b1, _max_pool(x)], dim=1)


class InceptionB(_Block):
    out_channels = 1024

    def __init__(self, cin=1024, dtype=None):
        super().__init__([
            ('b0', cin, 384) + _1x1, ('b1a', cin, 192) + _1x1,
            ('b1b', 192, 224) + _1x7, ('b1c', 224, 256) + _7x1,
            ('b2a', cin, 192) + _1x1, ('b2b', 192, 192) + _7x1,
            ('b2c', 192, 224) + _1x7, ('b2d', 224, 224) + _7x1,
            ('b2e', 224, 256) + _1x7, ('b3', cin, 128) + _1x1], dtype)

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1c(self.b1b(self.b1a(x)))
        b2 = self.b2e(self.b2d(self.b2c(self.b2b(self.b2a(x)))))
        b3 = self.b3(_avg_pool(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class ReductionB(_Block):
    def __init__(self, cin=1024, dtype=None):
        super().__init__([
            ('b0a', cin, 192) + _1x1, ('b0b', 192, 192) + _3x3_s2,
            ('b1a', cin, 256) + _1x1, ('b1b', 256, 256) + _1x7,
            ('b1c', 256, 320) + _7x1, ('b1d', 320, 320) + _3x3_s2], dtype)
        self.out_channels = 192 + 320 + cin

    def forward(self, x):
        b0 = self.b0b(self.b0a(x))
        b1 = self.b1d(self.b1c(self.b1b(self.b1a(x))))
        return torch.cat([b0, b1, _max_pool(x)], dim=1)


class InceptionC(_Block):
    out_channels = 1536

    def __init__(self, cin=1536, dtype=None):
        super().__init__([
            ('b0', cin, 256) + _1x1, ('b1a', cin, 384) + _1x1,
            ('b1b', 384, 256) + _1x3, ('b1c', 384, 256) + _3x1,
            ('b2a', cin, 384) + _1x1, ('b2b', 384, 448) + _3x1,
            ('b2c', 448, 512) + _1x3, ('b2d', 512, 256) + _1x3,
            ('b2e', 512, 256) + _3x1, ('b3', cin, 256) + _1x1], dtype)

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1a(x)
        b1a, b1b = self.b1b(b1), self.b1c(b1)
        b2 = self.b2c(self.b2b(self.b2a(x)))
        b2a, b2b = self.b2d(b2), self.b2e(b2)
        b3 = self.b3(_avg_pool(x))
        return torch.cat([b0, b1a, b1b, b2a, b2b, b3], dim=1)


class InceptionV4(torch.nn.Module):
    """Input: NCHW (channels_last in memory), at least 75 x 75; output:
    logits [N, classes] in ``dtype``."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, num_classes=1000, dtype=None):
        super().__init__()
        self.blocks = []

        def add(name, block):
            self.add_module(name, block)
            self.blocks.append(name)

        add('stem', Stem(dtype))
        for i in range(4):
            add(f'mixed_a{i}', InceptionA(dtype=dtype))
        add('reduction_a', ReductionA(dtype=dtype))
        for i in range(7):
            add(f'mixed_b{i}', InceptionB(dtype=dtype))
        add('reduction_b', ReductionB(dtype=dtype))
        for i in range(3):
            add(f'mixed_c{i}', InceptionC(dtype=dtype))
        self.fc = knn.Linear(InceptionC.out_channels, num_classes,
                             compute_dtype=dtype)

    def forward(self, x):
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))


def inception_v4(num_classes=1000, seed=0, **kw):
    return init_weights(InceptionV4(num_classes, **kw), seed)
