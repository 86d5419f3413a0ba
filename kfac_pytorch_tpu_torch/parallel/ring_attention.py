"""Ring and Ulysses attention (port of the world=1 subset of
``kfac_pytorch_tpu/parallel/ring_attention.py``).

With ``axis_name=None`` both are exact causal/padded softmax attention
over one block: ``(m, l, pv)`` from :func:`_block_attn_dispatch`, then
``pv / max(l, 1e-30)``. Sharding the sequence over a process group (the
K/V ring, the all-to-all) is not ported yet and raises.

``block_impl`` keeps the JAX package's names: 'xla' is the plain block
path (:func:`_block_attn`, autograd through PyTorch ops, the ``[Lq, Lk]``
scores materialized); 'pallas' and 'auto' are the hand-written CUDA
kernels of ``ops/attention_kernels.py`` (K4 forward, K5a/K5b backward),
whose plain versions run on CPU tensors. The JAX 'auto' picks by a key
length measured on a TPU; here 'auto' always takes the kernels.
"""

import torch

from kfac_pytorch_tpu_torch.ops.attention_kernels import (NEG_INF,
                                                          flash_block_attn)

BLOCK_IMPLS = ('xla', 'pallas', 'auto')
_LATER = ('sequence parallelism over a process group (ring K/V rotation, '
          'Ulysses all-to-all) is a later part of port slice E')


def _block_attn_dispatch(q, k, v, q_start, k_start, causal, kv_mask, scale,
                         block_impl):
    """One block's ``(m, l, pv)`` through ``block_impl``. ``q`` is
    ``[B, H, Lq, D]``, ``k``/``v`` ``[B, H, Lk, D]``, ``kv_mask`` None or
    ``[B, Lk]`` bool (True = attend)."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f'block_impl must be one of {BLOCK_IMPLS}, got '
                         f'{block_impl!r}')
    if block_impl == 'xla':
        bias = _bias_for_block(q_start, k_start, q.shape[2], k.shape[2],
                               causal, kv_mask, q.device)
        return _block_attn(q, k, v, bias, scale)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    maskf = (torch.ones((B, Lk), dtype=torch.float32, device=q.device)
             if kv_mask is None else kv_mask.to(torch.float32))
    # row b*H + h of the folded batch is head h of sequence b
    maskf = maskf.repeat_interleave(H, dim=0).contiguous()

    def fold(x):
        return x.reshape(B * H, *x.shape[2:]).contiguous()

    m, l, pv = flash_block_attn(fold(q), fold(k), fold(v), maskf,
                                (q_start, k_start), scale, causal)
    return (m.reshape(B, H, Lq), l.reshape(B, H, Lq),
            pv.reshape(B, H, Lq, D))


def _block_attn(q, k, v, bias, scale):
    """One block, plain: scores plus the additive ``bias``, the row max as
    a constant shift, ``(m, sum exp(s - m), exp(s - m) @ v)``."""
    s = (q @ k.mT) * scale
    if bias is not None:
        s = s + bias
    # the running max is a pure numerical shift: softmax is invariant to
    # it, so it must be a constant to autograd
    m = s.amax(dim=-1).detach()
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), p @ v


def _merge(o, l, m, pv_j, l_j, m_j):
    """Merge one block's ``(pv, l, m)`` into the running ``(o, l, m)``: the
    online-softmax recurrence of the ring."""
    m_new = torch.maximum(m, m_j)
    c = torch.exp(m - m_new)
    c_j = torch.exp(m_j - m_new)
    o = o * c[..., None] + pv_j * c_j[..., None]
    return o, l * c + l_j * c_j, m_new


def _bias_for_block(q_start, k_start, lq, lk, causal, kv_mask, device):
    """Additive bias broadcastable to ``[B, H, Lq, Lk]``: global-position
    causal masking plus the key-padding mask, or None."""
    bias = None
    if causal:
        qpos = q_start + torch.arange(lq, device=device)[:, None]
        kpos = k_start + torch.arange(lk, device=device)[None, :]
        bias = torch.where(qpos >= kpos, 0.0, NEG_INF)[None, None]
    if kv_mask is not None:
        pad = torch.where(kv_mask, 0.0, NEG_INF)[:, None, None, :]
        bias = pad if bias is None else bias + pad
    return bias


def ring_attention(q, k, v, axis_name=None, causal=False, kv_mask=None,
                   scale=None, block_impl='auto'):
    """Exact softmax attention of ``q [B, H, Lq, D]`` over ``k``/``v``
    ``[B, H, Lk, D]``; ``kv_mask`` ``[B, Lk]`` bool (True = attend);
    ``scale`` defaults to ``D ** -0.5``. Returns ``[B, H, Lq, D]``."""
    if axis_name is not None:
        raise NotImplementedError(_LATER)
    scale = scale or q.shape[-1] ** -0.5
    m, l, pv = _block_attn_dispatch(q, k, v, 0, 0, causal, kv_mask, scale,
                                    block_impl)
    return (pv / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, axis_name=None, causal=False, kv_mask=None,
                      scale=None, block_impl='auto'):
    """The all-to-all form of :func:`ring_attention`; with
    ``axis_name=None`` the two are the same attention."""
    if axis_name is not None:
        raise NotImplementedError(_LATER)
    return ring_attention(q, k, v, None, causal=causal, kv_mask=kv_mask,
                          scale=scale, block_impl=block_impl)
