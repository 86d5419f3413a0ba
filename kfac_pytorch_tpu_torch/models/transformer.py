"""Encoder-decoder Transformer (port of
``kfac_pytorch_tpu/models/transformer.py``; Attention Is All You Need).

d_model 512, 6 + 6 layers, 8 heads, d_inner 2048 by default, sinusoidal
positions, post-norm residual blocks, the target embedding tied to the
pre-softmax projection with ``scale_emb_or_prj='prj'`` (the logits times
d_model^-0.5). Every attention and FFN projection is a K-FAC ``Linear``;
the embeddings are not K-FAC layers, and an untied head (``trg_proj``)
is one that ``exclude_vocabulary_size`` drops from the plan.

Submodule names are the Flax ones (``src_emb``, ``trg_emb``, ``enc_{i}``/
``dec_{i}`` with ``self_attn``/``cross_attn``/``ffn``, their ``w_q``,
``w_k``, ``w_v``, ``w_o``, ``w_1``, ``w_2`` and ``ln``, ``enc_ln``,
``dec_ln``), so ``weights.params_from_jax`` converts by path and the
K-FAC layer names match the JAX plan. The attention core is plain
matmuls, as the JAX package's einsums are (no kernel of its own). The
trainer wraps the model in :class:`Wrapped`, as the JAX trainer does, so
its layer names start with ``inner/``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.gpt import init_weights


def sinusoid_position_encoding(n_position, d_model):
    """``[n_position, d_model]`` float32: sin on even, cos on odd dims."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_model)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    enc = np.zeros((n_position, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(enc)


def multi_head_attention_core(q, k, v, n_head, d_k, d_v, mask, dropout,
                              train):
    """Scaled dot-product attention over ``n_head`` heads: ``[B, L, h*d]``
    projections in, the merged ``[B, Lq, h*d_v]`` out. ``mask`` (bool,
    broadcast to ``[B, h, Lq, Lk]``) keeps a score where true and puts
    -1e9 elsewhere."""
    B, Lq = q.shape[0], q.shape[1]
    Lk = k.shape[1]
    q = q.reshape(B, Lq, n_head, d_k).transpose(1, 2)
    k = k.reshape(B, Lk, n_head, d_k).transpose(1, 2)
    v = v.reshape(B, Lk, n_head, d_v).transpose(1, 2)
    attn = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(d_k)
    if mask is not None:
        attn = attn.masked_fill(~mask, -1e9)
    attn = F.dropout(torch.softmax(attn, dim=-1), dropout, train)
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(B, Lq, n_head * d_v)


class MultiHeadAttention(torch.nn.Module):
    """Post-norm multi-head attention."""

    def __init__(self, n_head, d_model, d_k, d_v, dropout=0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.w_q = knn.Linear(d_model, n_head * d_k, bias=False)
        self.w_k = knn.Linear(d_model, n_head * d_k, bias=False)
        self.w_v = knn.Linear(d_model, n_head * d_v, bias=False)
        self.w_o = knn.Linear(n_head * d_v, d_model, bias=False)
        self.ln = torch.nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q_in, k_in, v_in, mask=None):
        out = multi_head_attention_core(
            self.w_q(q_in), self.w_k(k_in), self.w_v(v_in), self.n_head,
            self.d_k, self.d_v, mask, self.dropout, self.training)
        out = F.dropout(self.w_o(out), self.dropout, self.training)
        return self.ln(out + q_in)


class PositionwiseFFN(torch.nn.Module):
    """Post-norm FFN: ``ln(x + w_2(relu(w_1(x))))``."""

    def __init__(self, d_model, d_inner, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.w_1 = knn.Linear(d_model, d_inner)
        self.w_2 = knn.Linear(d_inner, d_model)
        self.ln = torch.nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x):
        h = F.dropout(self.w_2(F.relu(self.w_1(x))), self.dropout,
                      self.training)
        return self.ln(h + x)


class EncoderLayer(torch.nn.Module):
    def __init__(self, d_model, d_inner, n_head, d_k, d_v, dropout=0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                            dropout)
        self.ffn = PositionwiseFFN(d_model, d_inner, dropout)

    def forward(self, x, mask):
        return self.ffn(self.self_attn(x, x, x, mask))


class DecoderLayer(torch.nn.Module):
    def __init__(self, d_model, d_inner, n_head, d_k, d_v, dropout=0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                            dropout)
        self.cross_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                             dropout)
        self.ffn = PositionwiseFFN(d_model, d_inner, dropout)

    def forward(self, x, enc_out, self_mask, cross_mask):
        x = self.self_attn(x, x, x, self_mask)
        return self.ffn(self.cross_attn(x, enc_out, enc_out, cross_mask))


class Transformer(torch.nn.Module):
    """``forward(src [B, Ls], trg [B, Lt])`` (int64 tokens) returns the
    logits ``[B, Lt, n_trg_vocab]``; :meth:`encode`, :meth:`decode` and
    :meth:`project` are the decoders' steps. The constructor takes the JAX
    module's fields."""

    def __init__(self, n_src_vocab, n_trg_vocab, src_pad_idx=1,
                 trg_pad_idx=1, d_word_vec=512, d_model=512, d_inner=2048,
                 n_layers=6, n_head=8, d_k=64, d_v=64, dropout=0.1,
                 n_position=200, trg_emb_prj_weight_sharing=True,
                 scale_emb_or_prj='prj'):
        super().__init__()
        self.src_pad_idx, self.trg_pad_idx = src_pad_idx, trg_pad_idx
        self.d_model = d_model
        self.dropout = dropout
        self.trg_emb_prj_weight_sharing = trg_emb_prj_weight_sharing
        self.scale_emb_or_prj = scale_emb_or_prj
        self.src_emb = torch.nn.Embedding(n_src_vocab, d_word_vec)
        self.trg_emb = torch.nn.Embedding(n_trg_vocab, d_word_vec)
        self.register_buffer('pos_enc', sinusoid_position_encoding(
            n_position, d_word_vec), persistent=False)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f'enc_{i}', EncoderLayer(
                d_model, d_inner, n_head, d_k, d_v, dropout))
            self.add_module(f'dec_{i}', DecoderLayer(
                d_model, d_inner, n_head, d_k, d_v, dropout))
        self.enc_ln = torch.nn.LayerNorm(d_model, eps=1e-6)
        self.dec_ln = torch.nn.LayerNorm(d_model, eps=1e-6)
        if not trg_emb_prj_weight_sharing:
            # the untied head: a K-FAC layer that exclude_vocabulary_size
            # drops from the plan
            self.trg_proj = knn.Linear(d_model, n_trg_vocab, bias=False)

    def src_mask(self, src):
        """``[B, 1, 1, Ls]``: the source's non-pad keys."""
        return (src != self.src_pad_idx)[:, None, None, :]

    def trg_mask(self, trg):
        """``[B, 1, Lt, Lt]``: non-pad keys at or before the query."""
        L = trg.shape[1]
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=trg.device).tril()
        return (trg != self.trg_pad_idx)[:, None, None, :] & causal

    def _embed(self, emb, seq, ln):
        x = emb(seq)
        if self.scale_emb_or_prj == 'emb' and self.trg_emb_prj_weight_sharing:
            x = x * self.d_model ** 0.5
        x = F.dropout(x + self.pos_enc[None, :x.shape[1]], self.dropout,
                      self.training)
        return ln(x)

    def encode(self, src, src_mask):
        x = self._embed(self.src_emb, src, self.enc_ln)
        for i in range(self.n_layers):
            x = getattr(self, f'enc_{i}')(x, src_mask)
        return x

    def decode(self, trg, enc_out, self_mask, cross_mask):
        x = self._embed(self.trg_emb, trg, self.dec_ln)
        for i in range(self.n_layers):
            x = getattr(self, f'dec_{i}')(x, enc_out, self_mask, cross_mask)
        return x

    def project(self, dec_out):
        if not self.trg_emb_prj_weight_sharing:
            return self.trg_proj(dec_out)
        logits = dec_out @ self.trg_emb.weight.T
        if self.scale_emb_or_prj == 'prj':
            logits = logits * self.d_model ** -0.5
        return logits

    def forward(self, src, trg):
        src_mask = self.src_mask(src)
        enc_out = self.encode(src, src_mask)
        return self.project(self.decode(trg, enc_out, self.trg_mask(trg),
                                        src_mask))


class Wrapped(torch.nn.Module):
    """The trainer's adapter (the JAX trainer's ``Wrapped``): takes
    ``(src, trg)`` as one input, so the model fits the one-input step, and
    puts every parameter and K-FAC layer under ``inner``."""

    #: ``batch['input']`` is the ``(src, trg)`` pair
    input_layout = 'tuple'

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, xs):
        return self.inner(xs[0], xs[1])


def multi30k_transformer(n_src_vocab, n_trg_vocab, seed=0, **kw):
    """The Multi-30k configuration (the reference harness's defaults),
    seeded weights (``gpt.init_weights``: the Flax distributions)."""
    return init_weights(Transformer(n_src_vocab=n_src_vocab,
                                    n_trg_vocab=n_trg_vocab, **kw), seed)
