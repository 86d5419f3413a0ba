"""Loss helpers (port of ``label_smoothing_cross_entropy`` in
``kfac_pytorch_tpu/utils/losses.py``)."""

import torch
import torch.nn.functional as F


def label_smoothing_cross_entropy(outputs, labels, smoothing=0.1,
                                  num_classes=None):
    """CE against a smoothed one-hot target, with the reference's dtypes:
    the log-softmax runs in the logits' dtype (bf16 for a bf16 model), the
    fp32 target times it promotes to fp32, and the loss is fp32."""
    if num_classes is None:
        num_classes = outputs.shape[-1]
    logp = F.log_softmax(outputs, dim=-1)
    onehot = F.one_hot(labels, num_classes).to(torch.float32)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -(target * logp).sum(dim=-1).mean()
