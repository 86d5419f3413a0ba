"""The numerics of K4/K5a/K5b's split TF32 products, emulated on the CPU.

The attention kernels in ``csrc/attention.cu`` take every product on the
tensor cores as split TF32: each fp32 operand ``x`` becomes ``big =
cvt.rna.tf32.f32(x)`` and ``small = cvt.rna.tf32.f32(x - big)``, and a
product is ``small*big + big*small + big*big`` summed in fp32. This file
emulates the conversion in numpy (``tests/torch_tf32.py``: round to
nearest, ties away from zero, the 13 low mantissa bits dropped), checks
that ``big + small`` gives ``x`` back, reruns the plain backward
(``_bwd_dq_plain``, ``_bwd_dkv_plain``) with every matrix product taken
that way, and walks K4's loop (64-key tiles, the online softmax, each
tile's ``p v`` from a fresh product added in fp32) with its two products
taken that way; each is held to ``chip_smoke.py``'s ``ATTN_TOL`` against
the plain function in float64. One TF32 pass is run beside it and its
error printed, not asserted.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.overrides import TorchFunctionMode

from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
from torch_tf32 import split, split_matmul, tf32_matmul, tf32_rna

torch.set_num_threads(2)

#: chip_smoke.py's ATTN_TOL: |got - want| <= tol * (1 + |want|)
ATTN_TOL = {'m': 1e-5, 'l': 1e-5, 'pv': 1e-4, 'dq': 2e-4, 'dk': 2e-4,
            'dv': 2e-4}


class Products(TorchFunctionMode):
    """Every float32 matrix product in the block taken by ``mm``."""

    def __init__(self, mm):
        super().__init__()
        self.mm = mm
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, '__name__', None) in ('matmul', '__matmul__') \
                and args[0].dtype == torch.float32:
            self.calls += 1
            return self.mm(*args)
        return func(*args, **kwargs)


def test_rna_rounds_ties_away_from_zero():
    one = np.float32(1.0)
    half = np.float32(2.0 ** -11)  # half a TF32 unit in the last place at 1
    x = np.array([one + half, -(one + half), one + half / 2,
                  one + 3 * half, np.float32(np.inf), np.float32(-0.0)],
                 dtype=np.float32)
    want = np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                     1 + 2.0 ** -9, np.inf, -0.0], dtype=np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    assert np.isnan(tf32_rna(np.float32(np.nan)))


@settings(max_examples=500, deadline=None)
@given(st.floats(min_value=-2.0 ** 127, max_value=2.0 ** 127,
                 allow_nan=False, allow_infinity=False, width=32))
def test_split_reconstructs_fp32(x):
    """``big + small`` is ``x`` to 2^-22 of ``|x|`` (plus 2^-137 where the
    small half is subnormal), and both halves are TF32 values."""
    x = np.float32(x)
    big, small = split(x)
    assert (big.view(np.uint32) & 0x1FFF) == 0
    assert (small.view(np.uint32) & 0x1FFF) == 0
    err = abs(float(big) + float(small) - float(x))
    assert err <= 2.0 ** -22 * abs(float(x)) + 2.0 ** -137


def _inputs(bh, lq, lk, d, starts, causal, seed):
    rng = np.random.RandomState(seed)
    q, dpv = (rng.randn(bh, lq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, lk, d).astype(np.float32) for _ in range(2))
    mask = (rng.rand(bh, lk) > 0.2).astype(np.float32)
    mask[:, 3] = 0.0  # a masked key in every row's first tile
    dl = rng.randn(bh, lq).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    m = ak._fwd_plain(*[a.double() for a in t], starts, d ** -0.5,
                      causal)[0].float()
    return t + [m, torch.from_numpy(dl), torch.from_numpy(dpv)]


#: (BH, Lq, Lk, D, starts, causal): a causal block with offsets, ragged
#: lengths (not tile multiples) and a masked key; and a non-causal one at
#: head dim 16 with Lq != Lk
GEOMETRIES = [(2, 192, 160, 32, (64, 32), True),
              (2, 72, 40, 16, (0, 0), False)]


@pytest.mark.parametrize('geometry', GEOMETRIES)
@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
def test_split_backward_meets_attn_tol(kernel, geometry):
    bh, lq, lk, d, starts, causal = geometry
    x = _inputs(bh, lq, lk, d, starts, causal, seed=lq + d)
    fn = {'dq': ak._bwd_dq_plain, 'dkv': ak._bwd_dkv_plain}[kernel]
    names = {'dq': ('dq',), 'dkv': ('dk', 'dv')}[kernel]

    def run(args, mm=None):
        if mm is None:
            out = fn(*args, starts, d ** -0.5, causal)
        else:
            with Products(mm) as mode:
                out = fn(*args, starts, d ** -0.5, causal)
            assert mode.calls >= 2 * len(ak._key_blocks(lk))
        return out if isinstance(out, tuple) else (out,)

    want = run([a.double() for a in x])
    split3 = run(x, split_matmul)
    one_pass = run(x, tf32_matmul)
    for name, w, s, o in zip(names, want, split3, one_pass):
        err = float((s.double() - w).abs().max())
        err1 = float((o.double() - w).abs().max())
        excess = float(((s.double() - w).abs()
                        - ATTN_TOL[name] * (1 + w.abs())).max())
        print(f'{name} {geometry}: split TF32 max |err| {err:.3e}, one TF32 '
              f'pass {err1:.3e} (tolerance {ATTN_TOL[name]} * (1 + |want|))')
        assert torch.isfinite(s).all()
        assert excess <= 0, (name, err)


def _tiled_fwd(q, k, v, kv_mask, starts, scale, causal, mm):
    """K4's loop over 64-key tiles: ``s = mm(q, k^T) * scale`` plus the
    biases, the online softmax from ``m = -1e30``, and ``pv = pv * corr +
    mm(p, v)`` with each tile's product fresh. Where the causal skip drops
    a tile, its scores are -inf, which leaves the state as it is."""
    bh, lq, _ = q.shape
    lk = k.shape[1]
    q_start, k_start = starts
    m = torch.full((bh, lq), ak.NEG_INF, dtype=q.dtype)
    l = torch.zeros((bh, lq), dtype=q.dtype)
    pv = torch.zeros_like(q)
    qpos = q_start + torch.arange(lq)
    for j0 in range(0, lk, ak.TILE):
        j1 = min(j0 + ak.TILE, lk)
        s = mm(q, k[:, j0:j1].mT) * scale
        if causal:
            kpos = k_start + torch.arange(j0, j1)
            s = s + torch.where(qpos[:, None] >= kpos[None, :], 0.0,
                                ak.NEG_INF)
        s = s + torch.where(kv_mask[:, j0:j1] > 0.5, 0.0,
                            ak.NEG_INF)[:, None, :]
        if causal:
            s = s.masked_fill(~ak._tiles_computed(lq, j0, j1, q_start,
                                                  k_start, q.device),
                              float('-inf'))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = pv * corr[..., None] + mm(p, v[:, j0:j1])
        m = m_new
    return m, l, pv


@pytest.mark.parametrize('geometry', GEOMETRIES)
def test_split_forward_meets_attn_tol(geometry):
    bh, lq, lk, d, starts, causal = geometry
    q, k, v, mask = _inputs(bh, lq, lk, d, starts, causal, seed=lq + d)[:4]
    scale = d ** -0.5
    want = ak._fwd_plain(q.double(), k.double(), v.double(), mask.double(),
                         starts, scale, causal)
    split3 = _tiled_fwd(q, k, v, mask, starts, scale, causal, split_matmul)
    one_pass = _tiled_fwd(q, k, v, mask, starts, scale, causal, tf32_matmul)
    # the loop itself, in float64, is the plain forward
    exact = _tiled_fwd(q.double(), k.double(), v.double(), mask.double(),
                       starts, scale, causal, torch.matmul)
    for name, w, s, o, e in zip(('m', 'l', 'pv'), want, split3, one_pass,
                                exact):
        tol = ATTN_TOL[name]
        err = float((s.double() - w).abs().max())
        err1 = float((o.double() - w).abs().max())
        excess = float(((s.double() - w).abs() - tol * (1 + w.abs())).max())
        print(f'{name} {geometry}: split TF32 max |err| {err:.3e}, one TF32 '
              f'pass {err1:.3e} (tolerance {tol} * (1 + |want|))')
        assert s.dtype == torch.float32 and torch.isfinite(s).all()
        torch.testing.assert_close(e, w, rtol=1e-12, atol=1e-12)
        assert excess <= 0, (name, err)
