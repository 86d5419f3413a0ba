"""Model zoo of the port: the JAX zoo's vision nets (CIFAR ResNets, VGG,
WRN-28-10; ImageNet ResNets and ResNeXts, DenseNet-BC, Inception-v4), the
long-context LM and the sequence models (the encoder-decoder Transformer,
BERT with its SQuAD head, the WikiText-2 LSTM; ``models/translator.py``
decodes the Transformer). ``models/tiny.py`` holds the tests' tiny conv
net."""

from kfac_pytorch_tpu_torch.models.cifar_resnet import (
    resnet20, resnet32, resnet44, resnet56, resnet110)
from kfac_pytorch_tpu_torch.models.cifar_vgg import vgg11, vgg13, vgg16, vgg19
from kfac_pytorch_tpu_torch.models.cifar_wide_resnet import wrn_28_10
from kfac_pytorch_tpu_torch.models.densenet import (
    densenet121, densenet169, densenet201)
from kfac_pytorch_tpu_torch.models.gpt import transformer_lm
from kfac_pytorch_tpu_torch.models.imagenet_resnet import (
    resnet18, resnet34, resnet50, resnet101, resnet152, resnext50_32x4d,
    resnext101_32x8d)
from kfac_pytorch_tpu_torch.models.inception_v4 import inception_v4
from kfac_pytorch_tpu_torch.models.bert import bert_base_qa, bert_tiny_qa
from kfac_pytorch_tpu_torch.models.rnn import wikitext_lstm
from kfac_pytorch_tpu_torch.models.transformer import multi30k_transformer


#: ``--model`` name -> constructor: every name of the JAX registry,
#: aliases included (``'resnext50'``/``'resnext101'`` beside the long
#: ones), and the sequence models the JAX package exports beside it
REGISTRY = {
    'resnet20': resnet20, 'resnet32': resnet32, 'resnet44': resnet44,
    'resnet56': resnet56, 'resnet110': resnet110,
    'vgg11': vgg11, 'vgg13': vgg13, 'vgg16': vgg16, 'vgg19': vgg19,
    'wrn-28-10': wrn_28_10, 'wideresnet': wrn_28_10,
    'resnet18': resnet18, 'resnet34': resnet34, 'resnet50': resnet50,
    'resnet101': resnet101, 'resnet152': resnet152,
    'resnext50': resnext50_32x4d, 'resnext101': resnext101_32x8d,
    'resnext50_32x4d': resnext50_32x4d,
    'resnext101_32x8d': resnext101_32x8d,
    'inceptionv4': inception_v4, 'inception-v4': inception_v4,
    'densenet121': densenet121, 'densenet169': densenet169,
    'densenet201': densenet201,
    'transformer_lm': transformer_lm,
    'wikitext_lstm': wikitext_lstm,
    'multi30k_transformer': multi30k_transformer,
    'bert_base_qa': bert_base_qa, 'bert_tiny_qa': bert_tiny_qa,
}


def get_model(name, num_classes=None, seed=0, dtype=None, **kw):
    """Name-based factory mirroring the trainers' ``--model`` flag
    (:data:`REGISTRY`): the constructor gets ``num_classes`` (its own
    default when None), ``seed``, ``dtype`` (the compute dtype of the
    vision nets; None keeps fp32) and ``kw`` (``vocab_size`` and the
    LM's sizes, ...). Returns a CPU module with seeded weights."""
    if name not in REGISTRY:
        raise KeyError(f'unknown model {name!r}; the port has '
                       f'{sorted(REGISTRY)}')
    if num_classes is not None:
        kw['num_classes'] = num_classes
    if dtype is not None:
        kw['dtype'] = dtype
    return REGISTRY[name](seed=seed, **kw)
