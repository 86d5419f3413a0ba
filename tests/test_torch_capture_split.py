"""K1's split-TF32 numerics emulated on the CPU, the launch plans of K1 and
K2, and the kernel build's cache key.

K1 (``csrc/capture.cu``) takes every product of the conv factor A on the
tensor cores as split TF32 (``big = cvt.rna.tf32(x)``, ``small =
cvt.rna.tf32(x - big)``, a product ``small*big + big*small + big*big``),
sums each 32-row tile in a zeroed accumulator, adds the tiles in order
into a running fp32 sum, and then sums the row splits in split order.
The emulation below reruns the statistic that way, every tile's product
taken by ``tests/torch_tf32.py``'s ``split_matmul``, and holds it to
``chip_smoke.py``'s tolerance against float64. It cannot model the
tensor cores' own rounding inside a tile (their fp32 accumulation over
the tile's eight k8 steps and three passes): the emulation sums a tile
as the CPU's matmul does, so the card's check in ``chip_smoke.py`` is
the real one. One TF32 pass is printed beside it, not asserted.

The plans (``_k1_plan``, ``_k2_plan``) are the pure Python that lays out
the kernels' grids; they are checked here at the main path's and the
off-path shapes.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch.ops import _cuda_build
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
from kfac_pytorch_tpu_torch.ops import factors
from torch_tf32 import split_matmul, tf32_matmul

torch.set_num_threads(2)

#: chip_smoke.py's RTOL and ATOL (in units of sqrt(F_ii F_jj))
RTOL, ATOL = 1e-5, 1e-6
SMS = 132

#: (N, H, W, C, kernel, strides, padding, bias): a ResNet stage-1 conv at
#: F = 144, and F = 289 (C = 32 with a bias column: a second chunk and an
#: odd width)
GEOMETRIES = [(8, 8, 8, 16, (3, 3), (1, 1), 'SAME', False),
              (4, 6, 6, 32, (3, 3), (1, 1), 'SAME', True)]


def _rows(x, ksize, strides, padding, bias):
    """The plain version's operands: patch rows / spatial (and the ones
    column / spatial), and those / N, in fp32."""
    n = x.shape[0]
    p = factors.extract_patches(x, ksize, strides, padding)
    spatial = p.shape[1] * p.shape[2]
    rows = p.reshape(-1, p.shape[-1])
    if bias:
        rows = torch.cat([rows, torch.ones(rows.shape[0], 1)], dim=1)
    u = rows / spatial
    return u, u / n


def _k1_emulated(u, w, mm):
    """``u^T w`` summed as K1 sums it: each item's region over 32-row tiles
    (zero past the rows), each product by ``mm``, the tiles of a split into
    an fp32 sum in order, the item's splits added in order."""
    f = u.shape[1]
    plan = ck._k1_plan(f, u.shape[0], SMS)
    rt = ck.K1_ROW_TILE
    total = torch.zeros(f, f)
    parts = {}
    for i0, j0, n, t0, t1, z, s in plan.blocks:
        part = torch.zeros(f, f)
        for t in range(t0, t1):
            ut, wt = u[t * rt:(t + 1) * rt], w[t * rt:(t + 1) * rt]
            part = part + mm(ut.T, wt)
        key = (i0, j0, n)
        parts[key] = part if z == 0 else parts[key] + part
    for (i0, j0, n), part in parts.items():
        total[i0:i0 + ck.K1_STRIP, j0:j0 + n] = part[i0:i0 + ck.K1_STRIP,
                                                    j0:j0 + n]
    upper = torch.triu(total)
    return upper + torch.triu(total, 1).T


@pytest.mark.parametrize('geometry', GEOMETRIES)
def test_k1_split_tf32_meets_tolerance(geometry):
    n, h, w, c, ksize, strides, padding, bias = geometry
    rng = np.random.RandomState(c + n)
    x = torch.from_numpy(np.maximum(rng.randn(n, h, w, c), 0)
                         .astype(np.float32))
    u, wr = _rows(x, ksize, strides, padding, bias)
    want = u.double().T @ wr.double()
    # the plain version agrees with the float64 reference, and so must
    # the split emulation
    plain = ck._conv_a_plain(x, ksize, strides, padding, bias)
    assert torch.allclose(plain.double(), want, rtol=1e-5, atol=1e-7)
    d = torch.diagonal(want).abs().sqrt()
    scale = d[:, None] * d[None, :]
    got = _k1_emulated(u, wr, split_matmul)
    one = _k1_emulated(u, wr, tf32_matmul)
    err = ((got.double() - want).abs() / scale).max().item()
    err1 = ((one.double() - want).abs() / scale).max().item()
    print(f'F={u.shape[1]}: split TF32 max |err| {err:.3e}, one TF32 pass '
          f'{err1:.3e} (x sqrt(F_ii F_jj); tolerance {ATOL} of it plus '
          f'{RTOL} relative)')
    assert torch.all((got.double() - want).abs()
                     <= ATOL * scale + RTOL * want.abs())


#: (F, rows) of K1 on the main path (ResNet-32 at batch 128) and off it:
#: F = 289 (bias, a second chunk), F not a multiple of 8 (55, 25, 180)
K1_SHAPES = [(27, 131072), (144, 131072), (144, 32768), (288, 32768),
             (288, 8192), (576, 8192), (289, 2304), (55, 200), (25, 64),
             (180, 36), (1025, 100)]
#: (F, rows) of K2: ResNet conv G, the FC layer's A and G, the LM's dense
#: A and G (R = 4), tall with a ones column, short and wide, small ones
K2_SHAPES = [(16, 131072), (32, 32768), (64, 8192), (65, 128), (10, 128),
             (257, 4), (1025, 4), (768, 4), (256, 4), (1024, 4),
             (65, 20000), (1025, 3), (13, 50), (3, 7), (88, 1000),
             (89, 5000), (65, 1000), (1, 1)]


def _want(f, full):
    ones = np.ones((f, f), dtype=np.int64)
    return ones if full else np.triu(ones)


@pytest.mark.parametrize('full', [False, True])
@pytest.mark.parametrize('f,nrows', K1_SHAPES)
def test_k1_plan(f, nrows, full):
    """Every entry the launch writes (the upper triangle, or all with
    ``full``) is computed by exactly one item."""
    plan = ck._k1_plan(f, nrows, SMS, full)
    cover = np.zeros((f, f), dtype=np.int64)
    for i0, j0, n in plan.items:
        assert n % 8 == 0 and n <= 256 and n in ck.K1_CHUNKS
        assert i0 % ck.K1_STRIP == 0 and (full or j0 >= i0)
        ii = np.arange(i0, min(f, i0 + ck.K1_STRIP))[:, None]
        jj = np.arange(j0, min(f, j0 + n))[None, :]
        keep = (jj >= ii) | full
        cover[np.broadcast_to(ii, keep.shape)[keep],
              np.broadcast_to(jj, keep.shape)[keep]] += 1
    assert np.array_equal(cover, _want(f, full))
    assert plan.nmax == max(n for _, _, n in plan.items)
    # each item's splits cover every row tile once, in whole tiles, one
    # block a split, about one block an SM in all
    tiles = -(-nrows // ck.K1_ROW_TILE)
    assert len(plan.splits) == len(plan.items) == len(plan.tiles_per_split)
    for item, s, per in zip(plan.items, plan.splits, plan.tiles_per_split):
        mine = [b for b in plan.blocks if b[:3] == item]
        assert [b[5] for b in mine] == list(range(s))
        assert all(b[6] == s for b in mine)
        covered = [t for b in mine for t in range(b[3], b[4])]
        assert covered == list(range(tiles))
        assert all(b[4] - b[3] <= per for b in mine)
    assert len(plan.blocks) <= max(SMS, len(plan.items))
    assert plan.smem_bytes <= ck.SMEM_LIMIT
    # the mbarriers, the split ring (a big and a small plane a stage) and
    # the raw ring (a 16-byte slot per four features and row)
    planes = 2 * ck.K1_STAGES + ck.K1_RAW_STAGES
    assert plan.smem_bytes == 128 + 4 * planes * (
        ck.K1_STRIP + plan.nmax) * ck.K1_ROW_TILE


@pytest.mark.parametrize('full', [False, True])
@pytest.mark.parametrize('f,nrows', K2_SHAPES)
def test_k2_plan(f, nrows, full):
    plan = ck._k2_plan(f, nrows, SMS, full)
    cover = np.zeros((f, f), dtype=np.int64)
    if not plan.wide:
        # one block holds every output: 4 x 4 thread tiles of the upper
        # triangle (of the whole output with ``full``), each thread set over
        # its share of the staged rows
        g = -(-f // 4)
        ntiles = g * g if full else g * (g + 1) // 2
        assert f <= (64 if full else 88) and ntiles <= ck.K2_THREADS
        assert 1 <= plan.sets and plan.sets * ntiles <= ck.K2_THREADS
        for ti in range(g):
            for tj in range(0 if full else ti, g):
                for a in range(4):
                    for b in range(4):
                        i, j = 4 * ti + a, 4 * tj + b
                        if i < f and j < f and (full or j >= i):
                            cover[i, j] += 1
        # a chunk of rows fits the threads' registers (16 values each)
        assert plan.rc * f <= ck.K2_CHUNK or plan.rc * (f - 1) <= ck.K2_CHUNK
        assert plan.rows_per_split % plan.rc == 0
        # a cooperative launch: at most one block an SM, so all are resident
        assert plan.splits <= SMS and plan.counters == 2
        assert plan.smem_bytes == 4 * 2 * plan.rc * 4 * g
    else:
        assert f > (64 if full else 88)
        # few rows: both triangles, as a mirror's scattered stores cost more
        full = full or nrows < ck.K2_MIRROR_MIN_ROWS
        g = -(-f // ck.K2_TILE)
        for bi in range(g):
            for bj in range(0 if full else bi, g):
                for i in range(bi * 64, min(f, bi * 64 + 64)):
                    lo = bj * 64 if full else max(i, bj * 64)
                    for j in range(lo, min(f, bj * 64 + 64)):
                        cover[i, j] += 1
        assert plan.rows_per_split % ck.K2_BK == 0
        assert plan.counters == (g * g if full else g * (g + 1) // 2)
    assert plan.full == full
    assert np.array_equal(cover, _want(f, full))
    assert plan.splits * plan.rows_per_split >= nrows
    assert (plan.splits - 1) * plan.rows_per_split < max(nrows, 1)
    assert plan.smem_bytes <= ck.SMEM_LIMIT


def test_full_only_for_bf16_with_a_denominator_not_a_power_of_two():
    assert not ck._full(torch.float32, 3)
    assert not ck._full(torch.bfloat16, 128)
    assert not ck._full(torch.bfloat16, 1)
    assert ck._full(torch.bfloat16, 3)
    assert ck._full(torch.bfloat16, 20000)


@pytest.mark.parametrize('plan', [ck._k1_plan, ck._k2_plan])
def test_plans_guard_int32_rows(plan):
    assert plan(64, ck.MAX_ROWS, SMS)
    with pytest.raises(ValueError, match='int32'):
        plan(64, ck.MAX_ROWS + 1, SMS)


def test_lib_path_follows_every_header(tmp_path):
    """An edited ``csrc/*.cuh`` header names a new library, so a source
    that includes it rebuilds; a file that is not a header does not."""
    csrc = tmp_path / 'csrc'
    shutil.copytree(_cuda_build.CSRC, csrc)
    src = os.path.join(csrc, 'capture.cu')
    before = _cuda_build._lib_path(src)
    assert before == _cuda_build._lib_path(src)
    (csrc / 'notes.txt').write_text('not a header')
    assert _cuda_build._lib_path(src) == before
    header = csrc / 'hopper.cuh'
    header.write_text(header.read_text() + '\n// edited\n')
    after = _cuda_build._lib_path(src)
    assert after != before
    (csrc / 'extra.cuh').write_text('// a new header\n')
    assert _cuda_build._lib_path(src) not in (before, after)
