"""Model zoo of the port: the CIFAR and ImageNet ResNets and the
long-context LM."""

from kfac_pytorch_tpu_torch.models.cifar_resnet import (
    resnet20, resnet32, resnet44, resnet56, resnet110)
from kfac_pytorch_tpu_torch.models.gpt import transformer_lm
from kfac_pytorch_tpu_torch.models.imagenet_resnet import (
    resnet18, resnet34, resnet50, resnet101, resnet152, resnext50_32x4d,
    resnext101_32x8d)


def get_model(name, seed=0, **kw):
    """Name-based factory mirroring the trainers' ``--model`` flag; ``kw``
    goes to the constructor (``num_classes``, ``vocab_size``, ``dtype``
    for the ImageNet ResNets, ...). Returns a CPU module with seeded
    weights."""
    registry = {
        'resnet20': resnet20, 'resnet32': resnet32, 'resnet44': resnet44,
        'resnet56': resnet56, 'resnet110': resnet110,
        'resnet18': resnet18, 'resnet34': resnet34, 'resnet50': resnet50,
        'resnet101': resnet101, 'resnet152': resnet152,
        'resnext50_32x4d': resnext50_32x4d,
        'resnext101_32x8d': resnext101_32x8d,
        'transformer_lm': transformer_lm,
    }
    if name not in registry:
        raise KeyError(f'unknown model {name!r}; the port has '
                       f'{sorted(registry)}')
    return registry[name](seed=seed, **kw)
