"""CIFAR VGG-11/13/16/19 with BatchNorm (port of
``kfac_pytorch_tpu/models/cifar_vgg.py``): conv-BN-relu stacks from the
standard cfg tables, a 2x2 max pool at each ``'M'``, one dense
classifier.

Submodule names are the Flax ones (``conv{i}``, ``bn{i}``, ``i``
counting convolutions only, and ``classifier``), so weights convert by
name (``weights.params_from_jax``) and the K-FAC layer names match the
JAX plan. The classifier reads the last map flattened in NHWC order, as
Flax flattens it: at CIFAR's 32 x 32 input the map is 1 x 1 and the
order is moot, but for another ``in_size`` the rows stay Flax's.
``dtype`` has Flax's meaning (``models/imagenet_resnet.py``).
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.cifar_resnet import (BatchNorm2d,
                                                        init_weights)

_CFG = {
    'vgg11': (64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    'vgg13': (64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M',
              512, 512, 'M'),
    'vgg16': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512, 'M'),
    'vgg19': (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
              512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M'),
}


class CifarVGG(torch.nn.Module):
    """Input: NCHW (channels_last in memory) of ``in_size`` x ``in_size``;
    output: logits [N, classes] in ``dtype``."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, cfg, num_classes=10, dtype=None, in_size=32):
        super().__init__()
        self.cfg = tuple(cfg)
        cin, size, i = 3, in_size, 0
        for v in self.cfg:
            if v == 'M':
                size //= 2
                continue
            self.add_module(f'conv{i}', knn.Conv2d(
                cin, v, 3, padding=1, bias=False, compute_dtype=dtype))
            self.add_module(f'bn{i}', BatchNorm2d(v, dtype=dtype))
            cin, i = v, i + 1
        self.classifier = knn.Linear(cin * size * size, num_classes,
                                     compute_dtype=dtype)

    def forward(self, x):
        i = 0
        for v in self.cfg:
            if v == 'M':
                x = F.max_pool2d(x, 2, stride=2)
            else:
                bn, conv = getattr(self, f'bn{i}'), getattr(self, f'conv{i}')
                x = F.relu(bn(conv(x)))
                i += 1
        # Flax's NHWC flatten
        return self.classifier(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def _make(name, num_classes, seed, **kw):
    return init_weights(CifarVGG(_CFG[name], num_classes, **kw), seed)


def vgg11(num_classes=10, seed=0, **kw):
    return _make('vgg11', num_classes, seed, **kw)


def vgg13(num_classes=10, seed=0, **kw):
    return _make('vgg13', num_classes, seed, **kw)


def vgg16(num_classes=10, seed=0, **kw):
    return _make('vgg16', num_classes, seed, **kw)


def vgg19(num_classes=10, seed=0, **kw):
    return _make('vgg19', num_classes, seed, **kw)
