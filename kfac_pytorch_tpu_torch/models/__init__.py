"""Model zoo of the port: the CIFAR ResNets so far."""

from kfac_pytorch_tpu_torch.models.cifar_resnet import (
    resnet20, resnet32, resnet44, resnet56, resnet110)


def get_model(name, num_classes=10, seed=0):
    """Name-based factory mirroring the trainers' ``--model`` flag. Returns
    a CPU module with seeded weights."""
    registry = {
        'resnet20': resnet20, 'resnet32': resnet32, 'resnet44': resnet44,
        'resnet56': resnet56, 'resnet110': resnet110,
    }
    if name not in registry:
        raise KeyError(f'unknown model {name!r}; the port has '
                       f'{sorted(registry)}')
    return registry[name](num_classes=num_classes, seed=seed)
