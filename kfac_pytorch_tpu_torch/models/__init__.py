"""Model zoo of the port: the CIFAR ResNets and the long-context LM."""

from kfac_pytorch_tpu_torch.models.cifar_resnet import (
    resnet20, resnet32, resnet44, resnet56, resnet110)
from kfac_pytorch_tpu_torch.models.gpt import transformer_lm


def get_model(name, seed=0, **kw):
    """Name-based factory mirroring the trainers' ``--model`` flag; ``kw``
    goes to the constructor (``num_classes``, ``vocab_size``, ...).
    Returns a CPU module with seeded weights."""
    registry = {
        'resnet20': resnet20, 'resnet32': resnet32, 'resnet44': resnet44,
        'resnet56': resnet56, 'resnet110': resnet110,
        'transformer_lm': transformer_lm,
    }
    if name not in registry:
        raise KeyError(f'unknown model {name!r}; the port has '
                       f'{sorted(registry)}')
    return registry[name](seed=seed, **kw)
