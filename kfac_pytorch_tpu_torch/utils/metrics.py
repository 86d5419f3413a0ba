"""Evaluation metrics (port of ``accuracy`` in
``kfac_pytorch_tpu/utils/metrics.py``)."""

import torch


def accuracy(outputs, labels):
    """Top-1 accuracy from logits."""
    return (outputs.argmax(dim=-1) == labels).to(torch.float32).mean()
