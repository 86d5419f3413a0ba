"""Loss helpers (port of ``kfac_pytorch_tpu/utils/losses.py``: the label-
smoothing loss and the F1mc Fisher's pseudo-label sampler)."""

import torch
import torch.nn.functional as F


def label_smoothing_cross_entropy(outputs, labels, smoothing=0.1,
                                  num_classes=None, weights=None):
    """CE against a smoothed one-hot target, with the reference's dtypes:
    the log-softmax runs in the logits' dtype (bf16 for a bf16 model), the
    fp32 target times it promotes to fp32, and the loss is fp32. The mean
    over every position, or with ``weights`` (a 0/1 mask of ``labels``'
    shape, the Transformer trainer's non-pad tokens) ``sum(loss *
    weights) / max(sum(weights), 1)``."""
    if num_classes is None:
        num_classes = outputs.shape[-1]
    logp = F.log_softmax(outputs, dim=-1)
    onehot = F.one_hot(labels, num_classes).to(torch.float32)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    loss = -(target * logp).sum(dim=-1)
    if weights is None:
        return loss.mean()
    return (loss * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def sample_pseudo_labels(generator, outputs):
    """Labels drawn from the model's predictive distribution,
    ``softmax(outputs)`` over the last axis (the F1mc Fisher's backward
    targets; JAX's ``jax.random.categorical``): the Gumbel-max draw
    ``argmax(outputs + Gumbel noise)``, the noise from ``generator`` (a
    ``torch.Generator`` on the outputs' device), in fp32. No host round
    trip; the bits differ from JAX's, whose generator torch does not
    have."""
    u = torch.rand(outputs.shape, generator=generator, dtype=torch.float32,
                   device=outputs.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(outputs.float() - torch.log(-torch.log(u)), dim=-1)
