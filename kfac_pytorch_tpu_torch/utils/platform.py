"""Device selection for the port's entry points."""

import torch


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: the GPU unless the
    caller names another device. Without a GPU and without an explicit
    ``device='cpu'`` this raises — the port never quietly runs on the CPU."""
    if device is None or str(device) == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: kfac_pytorch_tpu_torch runs '
                               "on the GPU unless device='cpu' is passed")
        return torch.device('cuda')
    return torch.device(device)
