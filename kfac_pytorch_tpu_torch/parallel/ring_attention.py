"""Ring and Ulysses attention (port of
``kfac_pytorch_tpu/parallel/ring_attention.py``).

The sequence axis is sharded over a process group, the counterpart of
the JAX mesh axis (``axis_name``; the port's collectives take a group in
its place, ``collectives.axis_size(group)``). Group rank i holds tokens
``[i*L, (i+1)*L)`` of every sequence.

- **Ring** (:func:`ring_attention`): the K/V block (packed, one tensor)
  rotates around the group (``collectives.ring_shift``, one paired send
  and receive a step) while each rank merges the blocks' unnormalized
  ``(m, l, pv)`` online (:func:`_merge`, fp32 accumulators, ``m`` from
  -1e30). At step t the block came from rank ``(me - t) % n`` and runs at
  the global offsets ``(me*Lq, src*Lk)``. The backward sends each block's
  K/V gradient back around the ring to its owner.
- **Ulysses** (:func:`ulysses_attention`): one tiled all-to-all swaps
  the sequence shard of q, k and v (packed) for a head shard, one dense
  block runs over the whole sequence on ``H/n`` heads, and a second
  all-to-all swaps back.

With ``group=None`` both are exact causal/padded softmax attention over
one block: ``(m, l, pv)`` from :func:`_block_attn_dispatch`, then ``pv /
max(l, 1e-30)``.

``block_impl`` keeps the JAX package's names: 'xla' is the plain block
path (:func:`_block_attn`, autograd through PyTorch ops, the ``[Lq, Lk]``
scores materialized); 'pallas' and 'auto' are the hand-written CUDA
kernels of ``ops/attention_kernels.py`` (K4 forward, K5a/K5b backward),
whose plain versions run on CPU tensors. Every ring block goes through
them, the causal ring's blocks from later ranks too (all their tiles
skipped: ``m = -1e30, l = 0, pv = 0``), as in JAX. The JAX 'auto' picks
by a key length measured on a TPU; here 'auto' always takes the kernels.
"""

import torch

from kfac_pytorch_tpu_torch.ops.attention_kernels import (NEG_INF,
                                                          flash_block_attn)
from kfac_pytorch_tpu_torch.parallel import collectives as coll

BLOCK_IMPLS = ('xla', 'pallas', 'auto')


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
    """Exact softmax attention of the local query shard ``q [B, H, Lq, D]``
    over the whole sequence, whose key/value shards ``k``/``v [B, H, Lk,
    D]`` are spread over the process group ``axis_name`` (None: one
    block, no communication). ``kv_mask`` ``[B, Lk]`` bool (True =
    attend) masks the local keys; ``causal`` masks by global position;
    ``scale`` defaults to ``D ** -0.5``. Returns ``[B, H, Lq, D]``."""
    scale = scale or q.shape[-1] ** -0.5
    n = coll.axis_size(axis_name)
    if n == 1:
        m, l, pv = _block_attn_dispatch(q, k, v, 0, 0, causal, kv_mask,
                                        scale, block_impl)
        return (pv / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    me = coll.axis_index(axis_name)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    o = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    m = torch.full_like(l, NEG_INF)
    # the padding mask rides along as fp32, outside autograd; k and v go
    # as one tensor, one send and one receive a step each way
    mask_t = (torch.ones((B, Lk), dtype=torch.float32, device=q.device)
              if kv_mask is None else kv_mask.to(torch.float32))
    kv_t = torch.stack([k, v])
    for t in range(n):
        src = (me - t) % n   # the rank whose K/V block this is
        m_j, l_j, pv_j = _block_attn_dispatch(
            q, kv_t[0], kv_t[1], me * Lq, src * Lk, causal, mask_t > 0.5,
            scale, block_impl)
        o, l, m = _merge(o, l, m, pv_j, l_j, m_j)
        if t < n - 1:
            kv_t = coll.ring_shift(kv_t, axis_name)
            with torch.no_grad():
                mask_t = coll.ring_shift(mask_t, axis_name)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, axis_name=None, causal=False, kv_mask=None,
                      scale=None, block_impl='auto'):
    """The all-to-all form of :func:`ring_attention`, same contract: the
    sequence shard becomes a head shard (``H % n == 0``, else ValueError),
    one dense block runs over the whole sequence on ``H/n`` heads, and
    the result swaps back. With ``axis_name=None`` the two are the same
    attention."""
    scale = scale or q.shape[-1] ** -0.5
    n = coll.axis_size(axis_name)
    if n == 1:
        return ring_attention(q, k, v, None, causal=causal, kv_mask=kv_mask,
                              scale=scale, block_impl=block_impl)
    H = q.shape[1]
    if H % n:
        raise ValueError(f'ulysses needs heads ({H}) % axis ({n}) == 0')
    # [3, B, H, L_local, D] -> [3, B, H/n, L_global, D]: one swap of the
    # packed q, k and v
    qkv = coll.all_to_all(torch.stack([q, k, v]), 2, 3, axis_name)
    maskg = None
    if kv_mask is not None:
        maskg = coll.all_gather_axis1(kv_mask.to(torch.float32),
                                      axis_name) > 0.5
    m, l, pv = _block_attn_dispatch(qkv[0], qkv[1], qkv[2], 0, 0, causal,
                                    maskg, scale, block_impl)
    out = (pv / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return coll.all_to_all(out, 2, 1, axis_name)
