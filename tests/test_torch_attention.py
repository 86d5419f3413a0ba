"""The port's flash-attention block (``ops/attention_kernels.py``, plain
versions on CPU tensors) and its world=1 ring dispatch
(``parallel/ring_attention.py``) against the JAX package: the Pallas
kernels in interpret mode, their custom VJP, and the JAX ring dispatch.

Tolerances are the JAX package's own for the same comparisons
(tests/test_pallas_attention.py): m and l 1e-5, pv 1e-4, gradients 5e-4
(fp32 sums in another order), ring outputs 2e-5.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.ops.pallas_attention import flash_block_attn as jflash
from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
from kfac_pytorch_tpu_torch.parallel import ring_attention as tring

jring = importlib.import_module('kfac_pytorch_tpu.parallel.ring_attention')

torch.set_num_threads(2)

BH, LQ, LK, D = 4, 32, 32, 16
SCALE = D ** -0.5


def _inputs(seed=0, lq=LQ, lk=LK):
    rng = np.random.RandomState(seed)
    return (rng.randn(BH, lq, D).astype(np.float32),
            rng.randn(BH, lk, D).astype(np.float32),
            rng.randn(BH, lk, D).astype(np.float32),
            (rng.rand(BH, lk) > 0.2).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('starts', [(0, 0), (64, 32)])
def test_forward_matches_pallas_interpret(causal, starts):
    q, k, v, mask = _inputs()
    jm, jl, jpv = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask), jnp.asarray(starts, jnp.int32),
                         SCALE, causal, True)
    m, l, pv = ak.flash_fwd(*_t(q, k, v, mask), starts, SCALE, causal)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize('bwd_impl', ['pallas', 'recompute'])
def test_backward_matches_jax_custom_vjp(monkeypatch, bwd_impl):
    """FlashBlockAttn's backward (the plain K5a/K5b) against the JAX
    custom VJP, with its fused Pallas backward and its blockwise
    recompute; causal, key masking and block offsets."""
    q, k, v, mask = _inputs(seed=5)
    starts = (64, 32)
    monkeypatch.setenv('KFAC_ATTN_BWD_IMPL', bwd_impl)

    def jloss(q, k, v):
        _, l, pv = jflash(q, k, v, jnp.asarray(mask),
                          jnp.asarray(starts, jnp.int32), SCALE, True, True)
        return (l ** 2).sum() + (pv ** 2).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v, grad=True)
    _, l, pv = ak.flash_block_attn(tq, tk, tv, torch.tensor(mask), starts,
                                   SCALE, True)
    ((l ** 2).sum() + (pv ** 2).sum()).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                                   rtol=5e-4)


@pytest.mark.parametrize('block_impl', ['pallas', 'xla'])
def test_ragged_length_dispatch_matches_jax(block_impl):
    """L=100: the JAX dispatch pads to its tile grid and masks the padded
    keys; the port's kernels bounds-check the ragged tile instead. Values
    and gradients of causal attention agree (test_non_tile_multiple_length
    _values_and_grads's tolerances)."""
    rng = np.random.RandomState(3)
    B, H, L = 1, 2, 100
    arrs = [rng.randn(B, H, L, D).astype(np.float32) for _ in range(3)]

    def jloss(q, k, v):
        out = jring.ring_attention(q, k, v, axis_name=None, causal=True,
                                   block_impl='pallas_interpret')
        return (out ** 2).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, arrs))
    tq, tk, tv = _t(*arrs, grad=True)
    out = tring.ring_attention(tq, tk, tv, causal=True,
                               block_impl=block_impl)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                                   rtol=5e-4)


def test_fully_future_block_is_skipped_like_pallas():
    """A causal block wholly in the queries' future: every tile is
    skipped, so (m, l, pv) = (-1e30, 0, 0) as the Pallas kernel emits,
    and the backward, even with non-zero cotangents, gives exact zeros."""
    q, k, v, mask = _inputs(seed=6)
    starts = (0, LQ)
    jm, jl, jpv = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask), jnp.asarray(starts, jnp.int32),
                         SCALE, True, True)
    tq, tk, tv = _t(q, k, v, grad=True)
    m, l, pv = ak.flash_block_attn(tq, tk, tv, torch.tensor(mask), starts,
                                   SCALE, True)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(l.detach().numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pv.detach().numpy(), np.asarray(jpv))
    assert float(m.max()) == np.float32(ak.NEG_INF)
    assert float(l.detach().abs().max()) == 0.0
    rng = np.random.RandomState(7)
    torch.autograd.backward(
        (l, pv), (torch.tensor(rng.randn(*l.shape).astype(np.float32)),
                  torch.tensor(rng.randn(*pv.shape).astype(np.float32))))
    for g in (tq.grad, tk.grad, tv.grad):
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize('causal', [False, True])
def test_flash_block_attn_grads_match_plain_block_autograd(causal):
    """FlashBlockAttn's backward against autograd of the plain block path
    (ring_attention's ``_block_attn``) in float64: the custom backward is
    the exact gradient of (l, pv) with m a constant shift. Ragged length
    (72 = one full and one partial tile), block offsets, key mask."""
    rng = np.random.RandomState(8)
    q, k, v, mask = _inputs(seed=9, lq=72, lk=72)
    starts = (64, 32)
    dl = rng.randn(BH, 72).astype(np.float32)
    dpv = rng.randn(BH, 72, D).astype(np.float32)
    tq, tk, tv = _t(q, k, v, grad=True)
    _, l, pv = ak.flash_block_attn(tq, tk, tv, torch.tensor(mask), starts,
                                   SCALE, causal)
    torch.autograd.backward((l, pv), (torch.tensor(dl), torch.tensor(dpv)))
    rq, rk, rv = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (q, k, v))
    bias = tring._bias_for_block(*starts, 72, 72, causal,
                                 torch.tensor(mask > 0.5), 'cpu')
    _, rl, rpv = tring._block_attn(rq[:, None], rk[:, None], rv[:, None],
                                   bias, SCALE)
    torch.autograd.backward((rl[:, 0], rpv[:, 0]),
                            (torch.tensor(dl, dtype=torch.float64),
                             torch.tensor(dpv, dtype=torch.float64)))
    for got, want in ((tq.grad, rq.grad), (tk.grad, rk.grad),
                      (tv.grad, rv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4,
                                   rtol=5e-4)


def test_merge_of_key_halves_equals_the_whole_block():
    """The ring's online-softmax merge over two key blocks (global key
    offsets) reproduces attention over the whole block, as in the JAX
    package's ring step."""
    q, k, v, mask = _inputs(seed=10, lq=48, lk=48)
    q, k, v, mask = _t(q, k, v, mask)
    m, l, pv = ak.flash_fwd(q, k, v, mask, (0, 0), SCALE, True)
    o, lo, mo = torch.zeros_like(pv), torch.zeros_like(l), \
        torch.full_like(m, ak.NEG_INF)
    for j0, j1 in ((0, 24), (24, 48)):
        mj, lj, pvj = ak.flash_fwd(q, k[:, j0:j1].contiguous(),
                                   v[:, j0:j1].contiguous(),
                                   mask[:, j0:j1].contiguous(), (0, j0),
                                   SCALE, True)
        o, lo, mo = tring._merge(o, lo, mo, pvj, lj, mj)
    np.testing.assert_allclose((o / lo[..., None]).numpy(),
                               (pv / l[..., None]).numpy(), atol=2e-5,
                               rtol=2e-5)
    # and the merge itself is the JAX one
    rng = np.random.RandomState(13)
    args = [rng.randn(BH, 8, D), rng.rand(BH, 8), rng.randn(BH, 8),
            rng.randn(BH, 8, D), rng.rand(BH, 8), rng.randn(BH, 8)]
    args = [a.astype(np.float32) for a in args]
    for got, want in zip(tring._merge(*_t(*args)),
                         jring._merge(*map(jnp.asarray, args))):
        # XLA's and PyTorch's exp may round one ulp apart
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_dispatch_folds_heads_and_mask_like_jax():
    """[B, H, L, D] with a per-sequence key mask through the port's
    dispatch (mask row b*H + h) against the JAX dispatch (jnp.repeat)."""
    rng = np.random.RandomState(11)
    B, H, L = 2, 3, 40
    arrs = [rng.randn(B, H, L, D).astype(np.float32) for _ in range(3)]
    kv = rng.rand(B, L) > 0.3
    # key 0 attended: no row is fully masked (such a row's result depends
    # on the tile size, which the two packages do not share)
    kv[:, 0] = True
    want = jring._block_attn_dispatch(*map(jnp.asarray, arrs), 0, 0, True,
                                      jnp.asarray(kv), SCALE,
                                      'pallas_interpret')
    got = tring._block_attn_dispatch(*_t(*arrs), 0, 0, True,
                                     torch.tensor(kv), SCALE, 'pallas')
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol)


def test_wrappers_take_contiguous_float32_only():
    q, k, v, mask = _t(*_inputs())
    with pytest.raises(TypeError, match='float32'):
        ak.flash_fwd(q.double(), k, v, mask, (0, 0), SCALE, True)
    with pytest.raises(ValueError, match='contiguous'):
        ak.flash_fwd(q.transpose(1, 2), k, v, mask, (0, 0), SCALE, True)
    with pytest.raises(ValueError, match='block_impl'):
        tring.ring_attention(q[None], k[None], v[None], block_impl='flash')
    # a process group of one rank runs the one-block path: the same bits
    # as no group, and no collective (several ranks: test_torch_ring.py)
    import torch.distributed as dist
    from kfac_pytorch_tpu_torch.parallel import collectives as coll
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.new_group([0])
        for fn in (tring.ring_attention, tring.ulysses_attention):
            with coll.ledger() as led:
                got = fn(q[None], k[None], v[None], group, causal=True)
            assert led == []
            assert torch.equal(got, fn(q[None], k[None], v[None],
                                       causal=True))
    finally:
        dist.destroy_process_group()


def test_ulysses_is_ring_at_world_1():
    q, k, v, _ = _t(*_inputs(seed=12))
    a = functools.partial(tring.ring_attention, causal=True)
    b = functools.partial(tring.ulysses_attention, causal=True)
    assert torch.equal(a(q[None], k[None], v[None]),
                       b(q[None], k[None], v[None]))
