"""Convert the JAX package's parameters and K-FAC factors into the port's.

``params_from_jax`` maps a Flax ``params``/``batch_stats`` pair (nested
dicts of numpy arrays) to a ``state_dict`` of the port's model by module
path: conv kernel HWIO -> OIHW, dense kernel ``[in, out]`` -> ``[out, in]``,
embedding table ``embedding`` -> ``weight``, BatchNorm and LayerNorm
``scale/bias`` -> ``weight/bias``, BatchNorm ``mean/var`` ->
``running_mean/running_var``. K-FAC factors need no conversion: the
port's bucket layout is the JAX one, row for row.
"""

import numpy as np
import torch

_PARAM_NAMES = {'bias': 'bias', 'scale': 'weight', 'embedding': 'weight'}
_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}


def _walk(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def params_from_jax(params, batch_stats=None):
    """``state_dict`` (CPU tensors) of the port's model from Flax
    ``params`` and ``batch_stats``."""
    out = {}
    for path, v in _walk(params):
        mod, leaf = '.'.join(path[:-1]), path[-1]
        if leaf == 'kernel':
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            name = 'weight'
        else:
            name = _PARAM_NAMES[leaf]
        out[f'{mod}.{name}'] = torch.from_numpy(np.ascontiguousarray(v))
    for path, v in _walk(batch_stats or {}):
        mod = '.'.join(path[:-1])
        out[f'{mod}.{_STAT_NAMES[path[-1]]}'] = torch.from_numpy(
            np.ascontiguousarray(v))
    return out


def transformer_lm_from_jax(params):
    """``state_dict`` of the port's ``TransformerLM`` from the Flax LM's
    ``params``: dense kernels transposed, ``wte``/``wpe`` tables and
    LayerNorm ``scale``/``bias`` carried by name."""
    return params_from_jax(params)
