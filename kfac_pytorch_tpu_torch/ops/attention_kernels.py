"""Flash-attention block kernels (port of ``kfac_pytorch_tpu/ops/pallas_attention.py``).

Three hand-written CUDA kernels for Hopper, in ``csrc/attention.cu``:

- K4, :func:`flash_fwd`, replaces ``_fwd_kernel`` (via ``_pallas_fwd``):
  the unnormalized online-softmax pieces ``(m, l, pv)`` of one attention
  block, the ``[Lq, Lk]`` scores never stored.
- K5a, :func:`flash_bwd_dq`, replaces ``_bwd_dq_kernel``: ``dq`` from the
  cotangents ``(dl, dpv)``, scores recomputed.
- K5b, :func:`flash_bwd_dkv`, replaces ``_bwd_dkv_kernel``: ``dk`` and
  ``dv``, accumulated inside one block per key tile (no atomics, so the
  same bits on every run).

All three run every product on the tensor cores (``wgmma``) as split
TF32: each fp32 operand is split into two TF32 values and a product
takes three TF32 passes, which keeps fp32 accuracy. K4 keeps the
online-softmax state (row max, row sum, running ``pv``) in registers and
adds each key tile's ``p v`` into ``pv`` in fp32.

:class:`FlashBlockAttn` (through :func:`flash_block_attn`) plays the part
of the JAX ``jax.custom_vjp``: ``m`` is a constant shift, so it is marked
non-differentiable and its cotangent is ignored; the backward runs K5a
and K5b.

Semantics are the Pallas kernels': ``s = (q k^T) * scale``, then the
causal bias, then the key-mask bias, both additive ``-1e30`` (not
replacement, so a row whose every key is masked keeps its ``exp(s - m)``
terms). Key tiles above the causal diagonal are skipped (``last_q >=
first_k`` with global ``(q_start, k_start)`` offsets, the tile's last
query clipped to ``Lq``) at the kernels' 64-row tiles; a row whose every
tile is skipped emits ``m = -1e30, l = 0, pv = 0``; the backward recomputes ``p = exp(min(s - m, 0))``. Lengths
need not be tile multiples: the kernels bounds-check the ragged tile (a
key at or past ``Lk`` contributes nothing), so the TPU's padding to
multiples of 8/128 is not needed.

What bounds them on an H100: each causal (query, key) pair costs 4D (K4),
6D (K5a) or 8D (K5b) operations against a few bytes per row, so all three
are bound by arithmetic: by TF32 tensor-core throughput taken three
times; the source says what the design does about it.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version beside each wrapper (the same function, used by the tests); a
CUDA tensor launches the kernel or raises. Every wrapper takes contiguous
float32 tensors and counts its kernel launches in ``launches``, and in
``by_kind`` by the block's kind (:func:`block_kind`).
"""

import ctypes

import torch

#: the JAX package's masking bias (``_NEG_INF``)
NEG_INF = -1e30
#: rows of a tile on both sides (kTile in csrc/attention.cu): the unit of
#: the causal skip, which the plain versions repeat
TILE = 64
#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64)
#: key block of the plain backward (``_blockwise_bwd``'s tk)
_BWD_BLOCK = 128
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from kfac_pytorch_tpu_torch.ops import _cuda_build
        lib = _cuda_build.load('attention')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # BH, Lq, Lk, D, q_start, k_start, scale, causal
        scalars = [i] * 6 + [f, i]
        lib.kfac_flash_fwd.argtypes = [p] * 4 + scalars + [p] * 4
        lib.kfac_flash_bwd_dq.argtypes = [p] * 7 + scalars + [p] * 2
        lib.kfac_flash_bwd_dkv.argtypes = [p] * 7 + scalars + [p] * 3
        lib.kfac_flash_occupancy.argtypes = [i, i, p, p]
        for fn in (lib.kfac_flash_fwd, lib.kfac_flash_bwd_dq,
                   lib.kfac_flash_bwd_dkv, lib.kfac_flash_occupancy):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, kv_mask, *rest):
    """Shapes ``q [BH, Lq, D]``, ``k/v [BH, Lk, D]``, ``kv_mask [BH, Lk]``;
    every tensor contiguous float32 on one device. Returns the device
    type the call dispatches on: 'cpu' or 'cuda' (raises for others)."""
    tensors = (q, k, v, kv_mask) + rest
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'attention kernels take float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError('attention kernels take contiguous tensors')
        if t.device != q.device:
            raise ValueError(f'attention inputs on {t.device} and {q.device}')
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or tuple(kv_mask.shape) != tuple(k.shape[:2]):
        raise ValueError(f'q {tuple(q.shape)}, k {tuple(k.shape)}, v '
                         f'{tuple(v.shape)}, kv_mask {tuple(kv_mask.shape)}: '
                         'expected [BH, Lq, D], [BH, Lk, D] twice, [BH, Lk]')
    if q.device.type == 'cpu':
        return 'cpu'
    if q.device.type != 'cuda':
        raise RuntimeError(f'no attention kernel for device {q.device}')
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f'attention kernels take head dims {HEAD_DIMS}, '
                         f'got {q.shape[2]}')
    if any(t.data_ptr() % 16 for t in (q, k, v) + rest[2:]):
        raise ValueError('attention kernels read rows as 16-byte vectors: '
                         'q, k, v and dpv must start 16-byte aligned')
    if q.shape[0] > 65535:
        raise ValueError(f'attention kernels take at most 65535 (batch x '
                         f'head) rows, got {q.shape[0]}')
    return 'cuda'


def occupancy(which, d):
    """``(dynamic shared memory bytes, blocks resident per SM)`` of K4
    (``which`` 'fwd'), K5a ('dq') or K5b ('dkv') at head dim ``d``, from
    the CUDA occupancy calculator."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _kernels().kfac_flash_occupancy(
        {'fwd': 0, 'dq': 1, 'dkv': 2}[which], d, ctypes.addressof(smem),
        ctypes.addressof(blocks))
    _raise_on(err, f'occupancy({which}, {d})')
    return smem.value, blocks.value


def _scalars(q, k, starts, scale, causal):
    bh, lq, d = q.shape
    return (bh, lq, k.shape[1], d, int(starts[0]), int(starts[1]),
            float(scale), int(bool(causal)))


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError {err}')


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def block_kind(lq, lk, starts, causal):
    """What the causal mask leaves of a ``[Lq, Lk]`` block at global
    offsets ``starts``: 'skipped' (no pair: every query precedes every
    key, so every tile is skipped), 'full' (every pair: no mask, or every
    key at or before every query) or 'diagonal' (some pairs)."""
    q_start, k_start = int(starts[0]), int(starts[1])
    if not causal or q_start >= k_start + lk - 1:
        return 'full'
    if q_start + lq - 1 < k_start:
        return 'skipped'
    return 'diagonal'


def _count(wrapper, q, k, starts, causal):
    """One launch of ``wrapper``'s kernel, in its total and its kind's."""
    wrapper.launches += 1
    kind = block_kind(q.shape[1], k.shape[1], starts, causal)
    wrapper.by_kind[kind] = wrapper.by_kind.get(kind, 0) + 1


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in PyTorch ops
# ---------------------------------------------------------------------------

def _biased_scores(q, k, kv_mask, q_start, k_start, scale, causal):
    """``s = (q k^T) * scale`` plus the additive causal and key-mask
    biases, in the kernels' order."""
    s = (q @ k.mT) * scale
    if causal:
        qpos = q_start + torch.arange(q.shape[1], device=q.device)
        kpos = k_start + torch.arange(k.shape[1], device=q.device)
        s = s + torch.where(qpos[:, None] >= kpos[None, :], 0.0, NEG_INF)
    return s + torch.where(kv_mask > 0.5, 0.0, NEG_INF)[:, None, :]


def _tiles_computed(lq, j0, j1, q_start, k_start, device):
    """``[Lq, j1 - j0]`` bool: the pair of a query and a key of ``[j0, j1)``
    lies in a tile the kernels compute under the causal skip (the Pallas
    ``last_q >= first_k`` at TILE-row tiles, the tile's last query clipped
    to ``Lq``)."""
    last_row = torch.clamp((torch.arange(lq, device=device) // TILE + 1)
                           * TILE, max=lq) - 1
    last_q = q_start + last_row
    first_k = k_start + torch.arange(j0, j1, device=device) // TILE * TILE
    return last_q[:, None] >= first_k[None, :]


def _fwd_plain(q, k, v, kv_mask, starts, scale, causal):
    """Plain version of K4: ring_attention's ``_block_attn`` with the
    additive bias, over the tiles the kernel computes. ``m`` starts at
    -1e30 as the kernel's online max does, so a row with no computed tile
    gives ``(-1e30, 0, 0)``."""
    q_start, k_start = starts
    s = _biased_scores(q, k, kv_mask, q_start, k_start, scale, causal)
    if causal:
        s = s.masked_fill(~_tiles_computed(q.shape[1], 0, k.shape[1],
                                           q_start, k_start, q.device),
                          float('-inf'))
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), p @ v


def _p_ds_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale, causal, j0,
                j1):
    """Backward recompute for keys ``[j0, j1)`` (the Pallas ``_tile_p_ds``):
    ``p = exp(min(s - m, 0))`` (0 in skipped tiles) and ``ds = p * (dl +
    dpv v^T)``."""
    q_start, k_start = starts
    s = _biased_scores(q, k[:, j0:j1], kv_mask[:, j0:j1], q_start,
                       k_start + j0, scale, causal)
    p = torch.exp(torch.clamp(s - m[..., None], max=0.0))
    if causal:
        p = torch.where(_tiles_computed(q.shape[1], j0, j1, q_start, k_start,
                                        q.device), p, 0.0)
    ds = p * (dl[..., None] + dpv @ v[:, j0:j1].mT)
    return p, ds


def _key_blocks(lk):
    return [(j0, min(j0 + _BWD_BLOCK, lk)) for j0 in range(0, lk, _BWD_BLOCK)]


def _bwd_dq_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale, causal):
    """Plain version of K5a: ``_blockwise_bwd``'s dq over key blocks."""
    dq = torch.zeros_like(q)
    for j0, j1 in _key_blocks(k.shape[1]):
        _, ds = _p_ds_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale,
                            causal, j0, j1)
        dq = dq + (ds @ k[:, j0:j1]) * scale
    return dq


def _bwd_dkv_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale, causal):
    """Plain version of K5b: ``_blockwise_bwd``'s dk and dv per key
    block."""
    dks, dvs = [], []
    for j0, j1 in _key_blocks(k.shape[1]):
        p, ds = _p_ds_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale,
                            causal, j0, j1)
        dks.append((ds.mT @ q) * scale)
        dvs.append(p.mT @ dpv)
    return torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, the kernel on CUDA tensors
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, kv_mask, starts, scale, causal):
    """K4: ``(m [BH, Lq], l [BH, Lq], pv [BH, Lq, D])`` of one block.
    ``kv_mask`` is ``[BH, Lk]`` float (1 = attend); ``starts`` the global
    ``(q_start, k_start)`` offsets."""
    if _check(q, k, v, kv_mask) == 'cpu':
        return _fwd_plain(q, k, v, kv_mask, starts, scale, causal)
    bh, lq, d = q.shape
    m = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    pv = torch.empty_like(q)
    err = _kernels().kfac_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
        *_scalars(q, k, starts, scale, causal), m.data_ptr(), l.data_ptr(),
        pv.data_ptr(), _stream(q))
    _raise_on(err, 'K4 flash_fwd')
    _count(flash_fwd, q, k, starts, causal)
    return m, l, pv


flash_fwd.launches = 0
flash_fwd.by_kind = {}


def flash_bwd_dq(q, k, v, kv_mask, m, dl, dpv, starts, scale, causal):
    """K5a: ``dq [BH, Lq, D]`` from the forward's ``m`` and the cotangents
    ``dl [BH, Lq]``, ``dpv [BH, Lq, D]``."""
    if _check(q, k, v, kv_mask, m, dl, dpv) == 'cpu':
        return _bwd_dq_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale,
                             causal)
    dq = torch.empty_like(q)
    err = _kernels().kfac_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
        m.data_ptr(), dl.data_ptr(), dpv.data_ptr(),
        *_scalars(q, k, starts, scale, causal), dq.data_ptr(), _stream(q))
    _raise_on(err, 'K5a flash_bwd_dq')
    _count(flash_bwd_dq, q, k, starts, causal)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.by_kind = {}


def flash_bwd_dkv(q, k, v, kv_mask, m, dl, dpv, starts, scale, causal):
    """K5b: ``(dk, dv)``, each ``[BH, Lk, D]``, from the same inputs as
    :func:`flash_bwd_dq`."""
    if _check(q, k, v, kv_mask, m, dl, dpv) == 'cpu':
        return _bwd_dkv_plain(q, k, v, kv_mask, m, dl, dpv, starts, scale,
                              causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _kernels().kfac_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
        m.data_ptr(), dl.data_ptr(), dpv.data_ptr(),
        *_scalars(q, k, starts, scale, causal), dk.data_ptr(), dv.data_ptr(),
        _stream(q))
    _raise_on(err, 'K5b flash_bwd_dkv')
    _count(flash_bwd_dkv, q, k, starts, causal)
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.by_kind = {}


class FlashBlockAttn(torch.autograd.Function):
    """``(m, l, pv)`` of one attention block with the fused backward (the
    JAX ``flash_block_attn`` custom VJP): ``m`` is non-differentiable and
    ``dm`` ignored; ``(dl, dpv)`` go to K5a and K5b."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, starts, scale, causal):
        m, l, pv = flash_fwd(q, k, v, kv_mask, starts, scale, causal)
        ctx.mark_non_differentiable(m)
        ctx.save_for_backward(q, k, v, kv_mask, m)
        ctx.attrs = (starts, scale, causal)
        return m, l, pv

    @staticmethod
    def backward(ctx, dm, dl, dpv):
        q, k, v, kv_mask, m = ctx.saved_tensors
        args = (q, k, v, kv_mask, m, dl.contiguous(), dpv.contiguous(),
                *ctx.attrs)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_block_attn(q, k, v, kv_mask, starts, scale, causal):
    """Fused ``(m, l, pv)`` for one attention block, differentiable in
    ``q``, ``k``, ``v`` (see :class:`FlashBlockAttn`)."""
    return FlashBlockAttn.apply(q, k, v, kv_mask, tuple(starts), scale,
                                causal)
