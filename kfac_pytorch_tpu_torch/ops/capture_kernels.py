"""Fused capture kernels (port of ``kfac_pytorch_tpu/ops/pallas_capture.py``).

Three hand-written CUDA kernels for Hopper, in ``csrc/capture.cu``:

- K1, :func:`compute_a_conv`, replaces ``_conv_a_kernel``: conv factor A
  with the im2col patch rows built inside the kernel from the NHWC
  activation, so the ``[N*OH*OW, kh*kw*C]`` patch matrix never exists in
  device memory. Bound by operations at the ResNet-32 shapes, it runs on
  the tensor cores in split TF32 (fp32 accuracy) over the upper triangle;
  :func:`_k1_plan` lays out its strips, chunks and row split.
- K2, :func:`_stat_rows`, replaces ``_stat_kernel``: ``t^T (t / denom)``
  with the row prep (``x N``, ``x spatial``, ones column) applied at load.
  It serves :func:`compute_a_dense`, :func:`compute_g_dense` and
  :func:`compute_g_conv`; at their shapes it is bound by bytes and
  launches, so it stays on the fp32 FMA units, one launch a call with the
  split reduce and the EMA fused (:func:`_k2_plan`).
- K3, :func:`ef_quantize`, replaces ``_ef_kernel``: the error-feedback
  prep of the compressed factor reduce (``xc = x + r``, the bf16 wire,
  ``r' = xc - f32(wire)``) in one elementwise pass, bound by bytes. It
  agrees with its plain version bit for bit (NaN payloads aside).

K1 and K2 take ``ema=(current, alpha)`` and fold the factor EMA
``current * (1 - alpha) + stat * alpha`` into the kernel's epilogue. A
python-float ``alpha`` is folded; a tensor ``alpha`` runs the kernel
without the epilogue and then ``update_running_avg`` (the JAX package's
``_ema_static`` rule).

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version beside each wrapper (the same arithmetic, used by the tests); a
CUDA tensor launches the kernel or raises — there is no fallback, and no
cap on the factor dimension. Each wrapper counts its kernel launches in
its ``launches`` attribute.

Numbers: the kernel sums each output in a different order from the plain
version's matmul, so the two agree to fp32 summation error (not bitwise);
the EMA combine rounds exactly as the plain version's does.
"""

import collections
import ctypes
import functools
import math

import torch

from kfac_pytorch_tpu_torch.capture import canonical_padding
from kfac_pytorch_tpu_torch.ops import factors as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None

#: K1 (csrc/capture.cu): rows a staged tile (kRT), split tiles in the ring
#: to the consumer (kStages), gathered tiles in flight (kRawStages),
#: features of a strip (kStrip), the chunk widths it is built for, and its
#: threads (two producer warpgroups and a consumer)
K1_ROW_TILE = 32
K1_STAGES = 3
K1_RAW_STAGES = 3
#: a K1 tile's fixed cost (the handoffs, the consumer's wait for its
#: products) in features gathered a row: on the H100 about 0.8 us a tile
#: against 1.3 us more for 128 features
_K1_TILE_COST = 80
K1_STRIP = 64
K1_CHUNKS = (32, 64, 128)
K1_THREADS = 384
#: K2: the tall kernel (its 4 x 4 thread tiles of the output fit 256
#: threads) stages kChunk elements a round and takes up to this many
#: rounds in one block; the wide one takes 64 x 64 output tiles, 16 rows a
#: round
K2_ONE_BLOCK_CHUNKS = 4
#: the wide kernel computes both triangles (no mirrored stores) below this
#: many rows: at the LM's R = 4 the products cost less than the scattered
#: stores of a mirror
K2_MIRROR_MIN_ROWS = 256
K2_CHUNK = 4096
K2_THREADS = 256
K2_TILE = 64
K2_BK = 16
#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
#: the kernels index rows in int32, with headroom for a staged round
MAX_ROWS = 2 ** 31 - 2 ** 16

K1Plan = collections.namedtuple(
    'K1Plan', 'items splits tiles_per_split blocks nmax smem_bytes full')
K2Plan = collections.namedtuple(
    'K2Plan', 'wide splits rows_per_split rc sets smem_bytes counters full')


def _check_rows(nrows):
    if nrows > MAX_ROWS:
        raise ValueError(f'capture kernels index rows in int32; got {nrows}')


def _full(dtype, denom):
    """Whether a launch computes both triangles of the statistic: bf16
    operands divided by a denominator that is not a power of two are
    rounded apart (``round(u_j / n)`` is not ``u_j / n``), so the plain
    version's ``F_ij`` and ``F_ji`` differ at bf16's rounding; in fp32, or
    with a power of two, mirroring the upper triangle keeps the tolerance
    (or is exact)."""
    return dtype == torch.bfloat16 and math.frexp(float(denom))[0] != 0.5


def _k1_items(f, full=False):
    """K1's (strip row, chunk column, chunk width) items: the strips of 64
    features and, per strip s, chunks over columns [64 s, F) (over [0, F)
    when ``full``), each the narrowest of K1_CHUNKS that holds what is left
    (rounded up to 8), or the widest."""
    items = []
    for i0 in range(0, f, K1_STRIP):
        j = 0 if full else i0
        while j < f:
            left = -(-(f - j) // 8) * 8
            n = next((c for c in K1_CHUNKS if c >= left), K1_CHUNKS[-1])
            items.append((i0, j, n))
            j += n
    return tuple(items)


@functools.lru_cache(maxsize=None)
def _k1_plan(f, nrows, sms, full=False):
    """K1's launch: its items, each item's split of the rows (whole 32-row
    tiles) and the blocks that run them, and the shared memory. An item's
    work a tile is its chunk's width plus the strip's 64 features when it
    gathers the strip apart from the chunk (off the diagonal), plus a
    tile's fixed cost; the splits share one block an SM out in proportion
    to it, at least one an item, so that the blocks take about the same
    time."""
    _check_rows(nrows)
    items = _k1_items(f, full)
    tiles = max(1, -(-nrows // K1_ROW_TILE))
    work = [n + (0 if j0 == i0 else K1_STRIP) + _K1_TILE_COST
            for i0, j0, n in items]
    # one wave: at most one block an SM (where the items are fewer), the
    # largest time a tile count an item then goes first
    share = [max(1, min(tiles, sms * w // sum(work))) for w in work]
    while sum(share) < sms:
        k = max(range(len(work)), key=lambda i: work[i] / share[i])
        if share[k] >= tiles:
            break
        share[k] += 1
    per = [-(-tiles // s) for s in share]
    splits = tuple(-(-tiles // p) for p in per)
    blocks = tuple((i0, j0, n, z * p, min(tiles, (z + 1) * p), z, s)
                   for (i0, j0, n), s, p in zip(items, splits, per)
                   for z in range(s))
    nmax = max(n for _, _, n in items)
    smem = 128 + 4 * (K1_STAGES * 2 + K1_RAW_STAGES) * (
        K1_STRIP + nmax) * K1_ROW_TILE
    return K1Plan(items, splits, tuple(per), blocks, nmax, smem, full)


@functools.lru_cache(maxsize=None)
def _k2_plan(f, nrows, sms, full=False):
    """K2's launch: the tall kernel when its 4 x 4 thread tiles of the
    output (the upper triangle, or all with ``full``) fit one block (F up
    to 88, or 64), its rows staged rc at a time, ``sets`` thread sets over
    them, split across up to one block an SM; else the wide kernel (one
    block a 64 x 64 output tile, rows split only when the tiles leave the
    card idle; both triangles below K2_MIRROR_MIN_ROWS rows). ``counters``:
    the arrival counters the launch uses."""
    _check_rows(nrows)
    g = -(-f // 4)
    ntiles = g * g if full else g * (g + 1) // 2
    if ntiles <= K2_THREADS:
        # a few chunks of rows take one block; more take a chunk or more a
        # split, up to one block an SM: the splits share the reduce behind
        # a grid-wide barrier
        rc = K2_CHUNK // (4 * g)
        chunks = max(1, -(-nrows // rc))
        splits = 1 if chunks <= K2_ONE_BLOCK_CHUNKS else min(sms, chunks)
        per = -(-chunks // splits) * rc
        return K2Plan(False, -(-max(1, nrows) // per), per, rc,
                      K2_THREADS // ntiles, 4 * 2 * rc * 4 * g, 2, full)
    full = full or nrows < K2_MIRROR_MIN_ROWS
    g = -(-f // K2_TILE)
    ntri = g * g if full else g * (g + 1) // 2
    rounds = max(1, -(-nrows // K2_BK))
    want = 1 if ntri >= sms else min(rounds, -(-rounds // 32),
                                     -(-2 * sms // ntri))
    per = -(-rounds // max(1, want)) * K2_BK
    return K2Plan(True, -(-max(1, nrows) // per), per, 0, 0,
                  4 * 2 * 2 * K2_BK * K2_TILE, ntri, full)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


_tables = {}
_counters = {}


def _k1_table_on(device, plan):
    """The device copy of a plan's table (made once per plan): its blocks'
    rows, then its items' (strip row, chunk column, width, splits)."""
    key = (device, plan)
    table = _tables.get(key)
    if table is None:
        rows = [v for b in plan.blocks for v in b] + [
            v for it, s in zip(plan.items, plan.splits) for v in (*it, s)]
        table = torch.tensor(rows, dtype=torch.int32, device=device)
        _tables[key] = table
    return table


def _counters_on(device, n):
    """At least ``n`` zeroed int32 arrival counters on ``device``; the
    kernels leave them zeroed, so they are cleared only when made."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _kernels():
    global _lib
    if _lib is None:
        from kfac_pytorch_tpu_torch.ops import _cuda_build
        lib = _cuda_build.load('capture')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kfac_conv_a.argtypes = [p, i, i, i, i, i, i, i, i, i, i, i, i,
                                    i, i, p, i, i, i, i, i, p, f, i, p, p, p]
        lib.kfac_conv_a.restype = ctypes.c_int
        lib.kfac_conv_a_occupancy.argtypes = [i, i, p, p]
        lib.kfac_conv_a_occupancy.restype = ctypes.c_int
        lib.kfac_stat_rows.argtypes = [p, i, i, i, i, i, f, f, f, i, i, i,
                                       i, i, i, p, f, i, p, p, p, p]
        lib.kfac_stat_rows.restype = ctypes.c_int
        lib.kfac_ef_quantize.argtypes = [p, p, p, p, ctypes.c_longlong, i, p]
        lib.kfac_ef_quantize.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ema_static(ema):
    """A python-float decay folds into the kernel epilogue; a tensor decay
    two-passes (kernel, then ``update_running_avg``)."""
    return (ema is not None and isinstance(ema[1], (int, float))
            and not isinstance(ema[1], bool))


def _apply_ema(stat, ema):
    if ema is None:
        return stat
    cur, alpha = ema
    return _ref.update_running_avg(stat, cur, alpha)


def _check_cuda(x, ema, f):
    if x.dtype not in _DTYPES:
        raise TypeError(f'capture kernels take float32 or bfloat16, got '
                        f'{x.dtype}')
    if not x.is_contiguous():
        raise ValueError('capture kernels take a contiguous input')
    if ema is not None and _ema_static(ema):
        cur = ema[0]
        if (cur.device != x.device or cur.dtype != torch.float32
                or tuple(cur.shape) != (f, f) or not cur.is_contiguous()):
            raise ValueError(f'ema current must be a contiguous float32 '
                             f'[{f}, {f}] tensor on {x.device}, got '
                             f'{cur.dtype} {tuple(cur.shape)} on '
                             f'{cur.device}')


def _ema_args(ema):
    if ema is not None and _ema_static(ema):
        return ema[0].data_ptr(), float(ema[1]), 1
    return None, 0.0, 0


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError {err}')


# ---------------------------------------------------------------------------
# K2: row-tiled statistic GEMM (dense A/G, conv G)
# ---------------------------------------------------------------------------

def _stat_rows_plain(rows, denom, mults=(), append_ones=False, ema=None):
    """Plain PyTorch version of K2: the same scalings, in the same order
    and dtype, then ``t^T (t / denom)`` in fp32."""
    t = rows
    for m in mults:
        t = t * m
    if append_ones:
        t = _ref._append_ones_column(t)
    return _apply_ema(_ref._stat_gemm(t, denom), ema)


def _stat_rows(rows, denom, *, mults=(), append_ones=False, ema=None):
    """``rows^T @ (rows / denom)`` in fp32 with the row prep fused into the
    load: ``rows`` [R, d] is multiplied by each of ``mults`` in order
    (at most two) and gains a ones column when ``append_ones``."""
    if rows.device.type == 'cpu':
        return _stat_rows_plain(rows, denom, mults, append_ones, ema)
    if rows.device.type != 'cuda':
        raise RuntimeError(f'no capture kernel for device {rows.device}')
    if rows.ndim != 2 or len(mults) > 2:
        raise ValueError('_stat_rows takes [R, d] rows and at most two '
                         'multipliers')
    nrows, d = rows.shape
    f = d + (1 if append_ones else 0)
    _check_cuda(rows, ema, f)
    plan = _k2_plan(f, nrows, _sm_count(rows.device),
                    _full(rows.dtype, denom))
    part = (torch.empty((plan.splits, f, f), dtype=torch.float32,
                        device=rows.device) if plan.splits > 1 else None)
    out = torch.empty((f, f), dtype=torch.float32, device=rows.device)
    cur, alpha, has_ema = _ema_args(ema)
    m = list(mults) + [1.0] * (2 - len(mults))
    err = _kernels().kfac_stat_rows(
        rows.data_ptr(), _DTYPES[rows.dtype], nrows, d, int(append_ones),
        len(mults), float(m[0]), float(m[1]), float(denom), int(plan.wide),
        int(plan.full), plan.splits, plan.rows_per_split, plan.rc, plan.sets,
        cur, alpha, has_ema, None if part is None else part.data_ptr(),
        _counters_on(rows.device, plan.counters).data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(err, 'K2 stat_rows')
    _stat_rows.launches += 1
    if ema is not None and not has_ema:
        return _apply_ema(out, ema)
    return out


_stat_rows.launches = 0


def compute_a_dense(a, use_bias, *, ema=None):
    """:func:`factors.compute_a_dense` through K2, bias column fused."""
    if a.ndim > 2:
        a = a.mean(dim=tuple(range(1, a.ndim - 1)))
    return _stat_rows(a, a.shape[0], append_ones=use_bias, ema=ema)


def compute_g_dense(g, batch_averaged=True, *, ema=None):
    """:func:`factors.compute_g_dense` through K2 (``x N`` fused)."""
    if g.ndim > 2:
        g = g.mean(dim=tuple(range(1, g.ndim - 1)))
    n = g.shape[0]
    return _stat_rows(g, n, mults=((n,) if batch_averaged else ()), ema=ema)


def compute_g_conv(g, batch_averaged=True, *, ema=None):
    """:func:`factors.compute_g_conv` through K2 (``x N``, ``x spatial``
    fused, in that order)."""
    n = g.shape[0]
    spatial = g.shape[1] * g.shape[2]
    rows = g.reshape(-1, g.shape[-1])
    mults = (n, spatial) if batch_averaged else (spatial,)
    return _stat_rows(rows, rows.shape[0], mults=mults, ema=ema)


# ---------------------------------------------------------------------------
# K1: conv A with patch extraction fused into the covariance GEMM
# ---------------------------------------------------------------------------

def _conv_a_plain(a, kernel_size, strides, padding, use_bias, ema=None):
    """Plain PyTorch version of K1: :func:`factors.compute_a_conv` (patch
    matrix materialized) plus the EMA."""
    return _apply_ema(_ref.compute_a_conv(a, kernel_size, strides, padding,
                                          use_bias), ema)


def compute_a_conv(a, kernel_size, strides, padding, use_bias, *, ema=None):
    """:func:`factors.compute_a_conv` with patch extraction fused into the
    covariance GEMM: ``a`` is ``[N, H, W, C]``; the kernel reads each
    patch value straight from it, zero outside the padded border."""
    if a.device.type == 'cpu':
        return _conv_a_plain(a, kernel_size, strides, padding, use_bias, ema)
    if a.device.type != 'cuda':
        raise RuntimeError(f'no capture kernel for device {a.device}')
    if a.ndim != 4:
        raise ValueError(f'compute_a_conv takes NHWC [N, H, W, C], got '
                         f'{tuple(a.shape)}')
    n, h, w, c = a.shape
    kh, kw = kernel_size
    sh, sw = strides
    (pt, pb), (pl, pr) = canonical_padding((h, w), kernel_size, strides,
                                           padding)
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    f = kh * kw * c + (1 if use_bias else 0)
    _check_cuda(a, ema, f)
    nrows = n * oh * ow
    plan = _k1_plan(f, nrows, _sm_count(a.device), _full(a.dtype, n))
    smax = max(plan.splits)
    part = (torch.empty((smax, f, f), dtype=torch.float32, device=a.device)
            if smax > 1 else None)
    out = torch.empty((f, f), dtype=torch.float32, device=a.device)
    cur, alpha, has_ema = _ema_args(ema)
    err = _kernels().kfac_conv_a(
        a.data_ptr(), _DTYPES[a.dtype], n, h, w, c, kh, kw, sh, sw, pt, pl,
        oh, ow, int(use_bias), _k1_table_on(a.device, plan).data_ptr(),
        len(plan.blocks), len(plan.items), plan.nmax, smax, int(plan.full),
        cur, alpha, has_ema,
        None if part is None else part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, 'K1 conv_a')
    compute_a_conv.launches += 1
    if ema is not None and not has_ema:
        return _apply_ema(out, ema)
    return out


compute_a_conv.launches = 0


def conv_a_occupancy(dtype=torch.float32, nmax=K1_CHUNKS[-1]):
    """``(dynamic shared memory bytes, blocks resident per SM)`` of K1 for
    chunks up to ``nmax`` wide, from the CUDA occupancy calculator."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _kernels().kfac_conv_a_occupancy(
        _DTYPES[dtype], nmax, ctypes.addressof(smem),
        ctypes.addressof(blocks))
    _raise_on(err, f'conv_a_occupancy({dtype}, {nmax})')
    return smem.value, blocks.value


# ---------------------------------------------------------------------------
# K3: wire-quantize + error-feedback residual (the compressed-reduce prep)
# ---------------------------------------------------------------------------

#: K3 grid: blocks of 256 threads, enough for every SM several times over;
#: the kernel's grid-stride loop covers any size
_EF_THREADS = 256
_EF_MAX_BLOCKS = 132 * 16


def _ef_quantize_plain(x, residual):
    """Plain PyTorch version of K3: ``xc = x + r``, ``wire = bf16(xc)``
    (round to nearest even), ``r' = xc - f32(wire)``."""
    xc = x + residual
    wire = xc.to(torch.bfloat16)
    return wire, xc - wire.to(x.dtype)


def ef_quantize(x, residual):
    """``(wire bf16, new residual fp32)`` from the stacked stats ``x`` and
    the error-feedback residual, both fp32 of one shape, in one pass."""
    if x.device.type == 'cpu':
        return _ef_quantize_plain(x, residual)
    if x.device.type != 'cuda':
        raise RuntimeError(f'no capture kernel for device {x.device}')
    if (residual.device != x.device or x.dtype != torch.float32
            or residual.dtype != torch.float32
            or x.shape != residual.shape):
        raise ValueError(f'ef_quantize takes two float32 tensors of one '
                         f'shape on one device, got {x.dtype} '
                         f'{tuple(x.shape)} on {x.device} and '
                         f'{residual.dtype} {tuple(residual.shape)} on '
                         f'{residual.device}')
    if not (x.is_contiguous() and residual.is_contiguous()):
        raise ValueError('ef_quantize takes contiguous tensors')
    wire = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    new_residual = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return wire, new_residual
    blocks = max(1, min(_EF_MAX_BLOCKS,
                        -(-n // (4 * _EF_THREADS))))
    err = _kernels().kfac_ef_quantize(
        x.data_ptr(), residual.data_ptr(), wire.data_ptr(),
        new_residual.data_ptr(), n, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'K3 ef_quantize')
    ef_quantize.launches += 1
    return wire, new_residual


ef_quantize.launches = 0
