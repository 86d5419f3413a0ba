"""Long-context decoder-only transformer LM (port of
``kfac_pytorch_tpu/models/gpt.py``).

Submodule names are the Flax ones (``wte``, ``wpe``,
``block{i}.ln1/attn.qkv/attn.proj/ln2/fc1/fc2``, ``ln_f``, ``lm_head``),
so weights convert by name (``weights.transformer_lm_from_jax``) and the
K-FAC layer names match the JAX plan. Flax conventions kept: ``gelu`` is
the tanh approximation, LayerNorm's epsilon is 1e-5, and ``qkv`` splits
into q, k, v in that order. The model runs on one device
(``seq_axis=None`` in the JAX package); attention goes through
``parallel.ring_attention`` with the given ``block_impl``.
"""

import math

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.parallel.ring_attention import (
    ring_attention, ulysses_attention)


class CausalSelfAttention(torch.nn.Module):
    def __init__(self, n_head, d_model, seq_impl='ring', block_impl='auto'):
        super().__init__()
        self.n_head, self.d_model = n_head, d_model
        self.seq_impl, self.block_impl = seq_impl, block_impl
        self.qkv = knn.Linear(d_model, 3 * d_model)
        self.proj = knn.Linear(d_model, d_model)

    def forward(self, x):
        B, L, _ = x.shape
        h = self.n_head
        d = self.d_model // h
        q, k, v = (t.reshape(B, L, h, d).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        attn = ring_attention if self.seq_impl == 'ring' \
            else ulysses_attention
        out = attn(q, k, v, None, causal=True, block_impl=self.block_impl)
        return self.proj(out.transpose(1, 2).reshape(B, L, self.d_model))


class Block(torch.nn.Module):
    def __init__(self, n_head, d_model, mlp_ratio=4, seq_impl='ring',
                 block_impl='auto'):
        super().__init__()
        self.ln1 = torch.nn.LayerNorm(d_model, eps=1e-5)
        self.attn = CausalSelfAttention(n_head, d_model, seq_impl,
                                        block_impl)
        self.ln2 = torch.nn.LayerNorm(d_model, eps=1e-5)
        self.fc1 = knn.Linear(d_model, mlp_ratio * d_model)
        self.fc2 = knn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.fc1(self.ln2(x)), approximate='tanh')
        return x + self.fc2(y)


class TransformerLM(torch.nn.Module):
    """Causal LM: ``forward(tokens [B, L] int64)`` returns logits
    ``[B, L, vocab]``."""

    #: the trainer hands ``batch['input']`` over as it is
    input_layout = 'tokens'

    def __init__(self, vocab_size, n_layer=4, n_head=8, d_model=256,
                 max_len=65536, seq_impl='ring', block_impl='auto'):
        super().__init__()
        if seq_impl not in ('ring', 'ulysses'):
            raise ValueError(f"seq_impl must be 'ring' or 'ulysses', got "
                             f'{seq_impl!r}')
        self.wte = torch.nn.Embedding(vocab_size, d_model)
        self.wpe = torch.nn.Embedding(max_len, d_model)
        self.blocks = []
        for i in range(n_layer):
            self.add_module(f'block{i}', Block(n_head, d_model,
                                               seq_impl=seq_impl,
                                               block_impl=block_impl))
            self.blocks.append(f'block{i}')
        self.ln_f = torch.nn.LayerNorm(d_model, eps=1e-5)
        # pre-softmax projection: excluded from K-FAC by vocab size
        self.lm_head = knn.Linear(d_model, vocab_size, bias=False)

    def forward(self, tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.wte(tokens) + self.wpe(pos)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.lm_head(self.ln_f(x))


def init_weights(model, seed=0):
    """Seeded initialization with the Flax model's distributions: dense
    kernels lecun-normal (variance 1/fan_in, truncated at two standard
    deviations), biases zero, embeddings normal with variance 1/d_model,
    LayerNorm scale one and bias zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                            2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.Embedding):
                torch.nn.init.normal_(m.weight, 0.0,
                                      m.embedding_dim ** -0.5, generator=gen)
    return model


def transformer_lm(vocab_size=32000, seed=0, **kw):
    return init_weights(TransformerLM(vocab_size=vocab_size, **kw), seed)
