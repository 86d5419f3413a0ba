"""PyTorch/CUDA port of ``kfac_pytorch_tpu`` for NVIDIA Hopper.

The JAX package beside it is the frozen reference; this package keeps its
module names and layouts (NHWC activations, ``(kh, kw, c)`` patch
features, the stacked-bucket factor layout) so each piece compares with
its counterpart, and replaces its Pallas TPU kernels with hand-written
CUDA kernels (``csrc/``, bound in ``ops/capture_kernels.py``). It imports
torch and numpy only. Entry points run on the GPU unless the caller asks
for ``device='cpu'``.
"""

from kfac_pytorch_tpu_torch.preconditioner import (  # noqa: F401
    KFAC, KFACHyperParams, KFACState)
from kfac_pytorch_tpu_torch.scheduler import KFACParamScheduler  # noqa: F401
from kfac_pytorch_tpu_torch import capture, nn, ops  # noqa: F401
from kfac_pytorch_tpu_torch import resilience  # noqa: F401

KFAC_VARIANTS = ('inverse', 'eigen', 'inverse_dp', 'eigen_dp', 'ekfac',
                 'ekfac_dp')


def get_kfac_module(kfac='eigen_dp'):
    """A KFAC factory pre-bound to a variant name."""
    if kfac not in KFAC_VARIANTS:
        raise KeyError(f'unknown kfac variant {kfac!r}; choose from '
                       f'{KFAC_VARIANTS}')

    def factory(*args, **kwargs):
        kwargs.setdefault('variant', kfac)
        return KFAC(*args, **kwargs)

    return factory


def DP_KFAC(*args, inv_type='eigen', **kwargs):
    """Distributed-preconditioning K-FAC: the eigen or explicit-inverse DP
    variant by ``inv_type``."""
    kwargs.setdefault('variant',
                      'eigen_dp' if inv_type == 'eigen' else 'inverse_dp')
    return KFAC(*args, **kwargs)


__all__ = [
    'KFAC', 'KFACHyperParams', 'KFACState', 'KFACParamScheduler',
    'KFAC_VARIANTS', 'get_kfac_module', 'DP_KFAC', 'capture', 'nn', 'ops',
    'resilience',
]
