"""LSTM language model, the WikiText-2 workload (port of
``kfac_pytorch_tpu/models/rnn.py``): embedding, ``num_layers`` LSTMs,
dropout, a tied or untied decoder.

Two cells, chosen by ``kfac_lstm``:

- the plain cell (the default), Flax's ``OptimizedLSTMCell``: parameters
  ``ii``, ``if``, ``ig``, ``io`` (input kernels, no bias) and ``hi``,
  ``hf``, ``hg``, ``ho`` (recurrent kernels with the biases), gates in
  ``i, f, g, o`` order, ``c' = sigmoid(f) c + sigmoid(i) tanh(g)`` and
  ``h' = sigmoid(o) tanh(c')``. Not K-FAC layers: the input projection
  of every timestep is one GEMM, then the recurrence runs a step a
  timestep;
- :class:`KFACLSTMCell`, whose ``gates = ih(x_t) + hh(h_{t-1})`` are two
  K-FAC ``Linear`` layers (``ih`` with the bias, ``hh`` without), called
  once a timestep in a Python loop. ``capture.Capture`` stacks their
  calls along a leading time axis, ``[T, B, E]`` and ``[T, B, 4H]``, as
  the JAX package's ``nn.scan`` of the cell does, and both take the same
  ``g`` (the gates' gradient).

Module names are the Flax ones (``embedding``, ``lstm_scan_{i}`` with
the cell's parameters under it, ``decoder``), so
``weights.params_from_jax`` converts by path and the K-FAC layer names
are JAX's: ``lstm_scan_0/ih``, ``lstm_scan_0/hh``, ..., ``decoder``.
"""

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.gpt import init_weights

GATES = ('i', 'f', 'g', 'o')


def _gates(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


class KFACLSTMCell(torch.nn.Module):
    """LSTM whose gate projections are K-FAC-captured ``Linear`` layers,
    run over a ``[B, T, E]`` sequence one timestep a call."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        self.ih = knn.Linear(in_features, 4 * features)
        self.hh = knn.Linear(features, 4 * features, bias=False)

    def forward(self, x):
        B = x.shape[0]
        c = h = x.new_zeros((B, self.features))
        out = []
        for t in range(x.shape[1]):
            c, h = _gates(self.ih(x[:, t]) + self.hh(h), c)
            out.append(h)
        return torch.stack(out, dim=1)


class FusedLSTMCell(torch.nn.Module):
    """Flax's ``OptimizedLSTMCell`` over a ``[B, T, E]`` sequence: the
    same parameters (plain ``torch.nn.Linear``), gate order and carry."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        for g in GATES:
            self.add_module(f'i{g}', torch.nn.Linear(in_features, features,
                                                     bias=False))
            self.add_module(f'h{g}', torch.nn.Linear(features, features))

    def forward(self, x):
        mods = dict(self.named_children())
        w_i = torch.cat([mods[f'i{g}'].weight for g in GATES])
        w_h = torch.cat([mods[f'h{g}'].weight for g in GATES])
        b_h = torch.cat([mods[f'h{g}'].bias for g in GATES])
        xs = x @ w_i.T
        B = x.shape[0]
        c = h = x.new_zeros((B, self.features))
        out = []
        for t in range(x.shape[1]):
            c, h = _gates(torch.addmm(b_h, h, w_h.T) + xs[:, t], c)
            out.append(h)
        return torch.stack(out, dim=1)


class LSTMLanguageModel(torch.nn.Module):
    """``forward(tokens [B, L] int64)`` returns logits ``[B, L, V]``."""

    #: the trainer hands ``batch['input']`` over as it is
    input_layout = 'tokens'

    def __init__(self, vocab_size, embed_dim=650, hidden_dim=650,
                 num_layers=2, dropout=0.5, tie_weights=False,
                 kfac_lstm=False):
        super().__init__()
        self.dropout = dropout
        self.num_layers = num_layers
        self.tie_weights = tie_weights
        self.embedding = torch.nn.Embedding(vocab_size, embed_dim)
        cell = KFACLSTMCell if kfac_lstm else FusedLSTMCell
        for i in range(num_layers):
            self.add_module(f'lstm_scan_{i}', cell(
                embed_dim if i == 0 else hidden_dim, hidden_dim))
        if not tie_weights:
            # the pre-softmax projection: excluded from K-FAC by vocab size
            self.decoder = knn.Linear(hidden_dim, vocab_size)

    def forward(self, tokens):
        x = F.dropout(self.embedding(tokens), self.dropout, self.training)
        for i in range(self.num_layers):
            x = F.dropout(getattr(self, f'lstm_scan_{i}')(x), self.dropout,
                          self.training)
        if self.tie_weights:
            return x @ self.embedding.weight.T
        return self.decoder(x)


def wikitext_lstm(vocab_size, seed=0, **kw):
    """The WikiText-2 LM with seeded weights: ``gpt.init_weights`` (the
    Flax distributions), and the plain cell's recurrent kernels
    orthogonal, as Flax's ``recurrent_kernel_init``."""
    model = init_weights(LSTMLanguageModel(vocab_size, **kw), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FusedLSTMCell):
                for g in GATES:
                    torch.nn.init.orthogonal_(getattr(m, f'h{g}').weight,
                                              generator=gen)
    return model
