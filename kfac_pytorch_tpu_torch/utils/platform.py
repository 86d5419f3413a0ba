"""Device selection for the port's entry points."""

import torch


def resolve_device(device=None, local_rank=None):
    """The ``torch.device`` an entry point runs on: the GPU unless the
    caller names another device, ``cuda:local_rank`` when a rank's local
    index is given (a launcher's ``LOCAL_RANK``). Without a GPU and
    without an explicit ``device='cpu'`` this raises — the port never
    quietly runs on the CPU."""
    if device is None or str(device) == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: kfac_pytorch_tpu_torch runs '
                               "on the GPU unless device='cpu' is passed")
        if local_rank is None:
            return torch.device('cuda')
        return torch.device('cuda', local_rank)
    return torch.device(device)
