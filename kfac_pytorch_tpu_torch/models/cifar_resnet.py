"""CIFAR ResNet-20/32/44/56/110, option-A shortcuts (port of
``kfac_pytorch_tpu/models/cifar_resnet.py``).

Submodule names are the Flax ones (``conv1``, ``bn1``,
``layer{s}_{i}.conv1/bn1/conv2/bn2``, ``fc``) so weights convert by name
(``weights.params_from_jax``) and K-FAC layer names match the JAX plan.
Run the model in ``torch.channels_last``: the NHWC view the capture
kernels read is then a free permute of each conv's input and
output-gradient.
"""

import math

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn


class BatchNorm2d(torch.nn.Module):
    """Batch norm with Flax ``linen.BatchNorm`` semantics.

    Flax's ``momentum=0.9`` is the weight of the OLD running value
    (torch's ``momentum=0.1``), and Flax updates the running variance with
    the biased batch variance, where ``torch.nn.BatchNorm2d`` uses the
    unbiased one. Training normalizes with ``F.batch_norm`` and updates
    the running statistics here, Flax's way; eval normalizes with them.

    ``dtype`` is Flax's ``BatchNorm(dtype=...)``. With a reduced dtype
    (bf16) the layer computes as ``flax.linen.normalization`` (flax 0.12)
    does: ``_compute_stats`` (``force_float32_reductions``,
    ``use_fast_variance``) takes the statistics in fp32 as ``E[x^2] -
    E[x]^2`` clamped at zero, and ``_normalize`` computes ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in fp32 and rounds it once to
    ``dtype``. Parameters and running statistics stay fp32. As there, the
    input is converted to fp32 once for the statistics and once for the
    normalization, so the backward rounds each use's gradient to
    ``dtype`` and adds the two in ``dtype``, as JAX's transpose does.
    """

    def __init__(self, num_features, momentum=0.9, eps=1e-5, dtype=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = torch.nn.Parameter(torch.ones(num_features))
        self.bias = torch.nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def _update_running(self, mean, var):
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x):
        if self.dtype not in (None, torch.float32):
            return self._reduced_precision(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _reduced_precision(self, x):
        if self.training:
            xs = x.float()
            mean = xs.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xs * xs).mean(dim=(0, 2, 3))
                                  - mean * mean, 0.0)
            self._update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((x.float() - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(self.dtype)


def _conv3x3(cin, cout, stride):
    return knn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(torch.nn.Module):
    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv3x3(planes, planes, 1)
        self.bn2 = BatchNorm2d(planes)
        self.in_planes, self.planes, self.stride = in_planes, planes, stride

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.stride != 1 or self.in_planes != self.planes:
            # option A: stride-2 subsample + zero-padded channels
            pad = (self.planes - self.in_planes) // 2
            sc = F.pad(x[:, :, ::2, ::2], (0, 0, 0, 0, pad, pad))
            sc = sc.contiguous(memory_format=torch.channels_last)
        else:
            sc = x
        return F.relu(out + sc)


class CifarResNet(torch.nn.Module):
    """Input: NCHW (channels_last in memory); output: logits [N, classes]."""

    #: the trainer hands ``batch['input']`` over as its NCHW view
    input_layout = 'NHWC'

    def __init__(self, num_blocks, num_classes=10):
        super().__init__()
        self.conv1 = _conv3x3(3, 16, 1)
        self.bn1 = BatchNorm2d(16)
        self.blocks = []
        in_planes = 16
        for stage, (planes, n) in enumerate(zip((16, 32, 64), num_blocks)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f'layer{stage + 1}_{i}'
                self.add_module(name, BasicBlock(in_planes, planes, stride))
                self.blocks.append(name)
                in_planes = planes
        self.fc = knn.Linear(64, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))


def _kaiming_(w, fan_in, gen):
    # Flax kaiming_normal: variance scaling 2/fan_in, normal truncated at
    # two standard deviations (std corrected for the truncation)
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=gen)


def _lecun_(w, fan_in, gen):
    # Flax's default kernel init, lecun_normal: variance scaling 1/fan_in,
    # the same truncation
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=gen)


def init_weights(model, seed=0, lecun=()):
    """Seeded initialization with the Flax model's distributions: conv and
    dense kernels kaiming-normal (lecun-normal, Flax's default, for the
    modules named in ``lecun``), biases zero, BN scale one and bias
    zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                init = _lecun_ if name in lecun else _kaiming_
                init(m.weight, m.weight[0].numel(), gen)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def _make(n, num_classes=10, seed=0):
    return init_weights(CifarResNet((n, n, n), num_classes), seed)


def resnet20(num_classes=10, seed=0):
    return _make(3, num_classes, seed)


def resnet32(num_classes=10, seed=0):
    return _make(5, num_classes, seed)


def resnet44(num_classes=10, seed=0):
    return _make(7, num_classes, seed)


def resnet56(num_classes=10, seed=0):
    return _make(9, num_classes, seed)


def resnet110(num_classes=10, seed=0):
    return _make(18, num_classes, seed)
