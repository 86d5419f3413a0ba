"""BERT encoder (base, large and tiny configurations) with the SQuAD span
head (port of ``kfac_pytorch_tpu/models/bert.py``).

Post-norm encoder, exact GELU, learned positions. Every attention, FFN
and span-head projection is a K-FAC ``Linear``; the word, position and
type embeddings and the LayerNorms are plain torch layers. Submodule
names are the Flax ones (``bert.word_emb``/``pos_emb``/``type_emb``/
``emb_ln``, ``bert.layer_{i}.attention.query|key|value|output|ln``,
``.intermediate``, ``.ffn_output``, ``.ln``, ``qa_outputs``), so
``weights.params_from_jax`` converts by path and the K-FAC layer names
match the JAX plan.
"""

import math

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models.gpt import init_weights


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.layer_norm_eps = layer_norm_eps

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        kw.setdefault('hidden_size', 1024)
        kw.setdefault('num_hidden_layers', 24)
        kw.setdefault('num_attention_heads', 16)
        kw.setdefault('intermediate_size', 4096)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests and smoke runs."""
        kw.setdefault('vocab_size', 128)
        kw.setdefault('hidden_size', 64)
        kw.setdefault('num_hidden_layers', 2)
        kw.setdefault('num_attention_heads', 4)
        kw.setdefault('intermediate_size', 128)
        kw.setdefault('max_position_embeddings', 64)
        return cls(**kw)


class BertSelfAttention(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        h = c.hidden_size
        self.query = knn.Linear(h, h)
        self.key = knn.Linear(h, h)
        self.value = knn.Linear(h, h)
        self.output = knn.Linear(h, h)
        self.ln = torch.nn.LayerNorm(h, eps=c.layer_norm_eps)

    def forward(self, x, mask):
        c = self.c
        h = c.num_attention_heads
        d = c.hidden_size // h
        B, L = x.shape[:2]
        q, k, v = (t.reshape(B, L, h, d).transpose(1, 2)
                   for t in (self.query(x), self.key(x), self.value(x)))
        attn = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(d)
        if mask is not None:
            attn = attn + (1.0 - mask[:, None, None, :]) * -1e9
        attn = F.dropout(torch.softmax(attn, dim=-1),
                         c.attention_probs_dropout_prob, self.training)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(
            B, L, c.hidden_size)
        out = F.dropout(self.output(out), c.hidden_dropout_prob,
                        self.training)
        return self.ln(out + x)


class BertLayer(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.attention = BertSelfAttention(c)
        self.intermediate = knn.Linear(c.hidden_size, c.intermediate_size)
        self.ffn_output = knn.Linear(c.intermediate_size, c.hidden_size)
        self.ln = torch.nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x, mask):
        x = self.attention(x, mask)
        h = self.ffn_output(F.gelu(self.intermediate(x)))
        h = F.dropout(h, self.c.hidden_dropout_prob, self.training)
        return self.ln(h + x)


class BertEncoder(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.word_emb = torch.nn.Embedding(c.vocab_size, c.hidden_size)
        self.pos_emb = torch.nn.Embedding(c.max_position_embeddings,
                                          c.hidden_size)
        self.type_emb = torch.nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.emb_ln = torch.nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        for i in range(c.num_hidden_layers):
            self.add_module(f'layer_{i}', BertLayer(c))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        c = self.c
        B, L = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones((B, L), dtype=torch.float32,
                                        device=input_ids.device)
        pos = torch.arange(L, device=input_ids.device)[None]
        x = self.emb_ln(self.word_emb(input_ids) + self.pos_emb(pos)
                        + self.type_emb(token_type_ids))
        x = F.dropout(x, c.hidden_dropout_prob, self.training)
        for i in range(c.num_hidden_layers):
            x = getattr(self, f'layer_{i}')(x, attention_mask)
        return x


class BertForQuestionAnswering(torch.nn.Module):
    """``forward((input_ids, token_type_ids, attention_mask))`` returns
    the span logits ``(start [B, L], end [B, L])``: a ``Linear(hidden ->
    2)`` over the sequence."""

    #: ``batch['input']`` is the ``(ids, types, mask)`` triple
    input_layout = 'tuple'

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.bert = BertEncoder(config)
        self.qa_outputs = knn.Linear(config.hidden_size, 2)

    def forward(self, inputs):
        input_ids, token_type_ids, attention_mask = inputs
        logits = self.qa_outputs(self.bert(input_ids, token_type_ids,
                                           attention_mask))
        return logits[..., 0], logits[..., 1]


def bert_qa(config, seed=0):
    """The span model of ``config`` with seeded weights
    (``gpt.init_weights``: the Flax distributions)."""
    return init_weights(BertForQuestionAnswering(config), seed)


def bert_base_qa(seed=0, **kw):
    return bert_qa(BertConfig.base(**kw), seed)


def bert_tiny_qa(seed=0, **kw):
    return bert_qa(BertConfig.tiny(**kw), seed)
