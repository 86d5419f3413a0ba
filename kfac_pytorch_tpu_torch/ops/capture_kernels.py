"""Fused capture kernels (port of ``kfac_pytorch_tpu/ops/pallas_capture.py``).

Three hand-written CUDA kernels for Hopper, in ``csrc/capture.cu``:

- K1, :func:`compute_a_conv`, replaces ``_conv_a_kernel``: conv factor A
  with the im2col patch rows built inside the kernel from the NHWC
  activation, so the ``[N*OH*OW, kh*kw*C]`` patch matrix never exists in
  device memory. Bound by fp32 FMA throughput at the ResNet-32 shapes.
- K2, :func:`_stat_rows`, replaces ``_stat_kernel``: ``t^T (t / denom)``
  with the row prep (``x N``, ``x spatial``, ones column) applied at load.
  It serves :func:`compute_a_dense`, :func:`compute_g_dense` and
  :func:`compute_g_conv`; at their shapes it is bound by bytes and
  launches.
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

import ctypes

import torch

from kfac_pytorch_tpu_torch.capture import canonical_padding
from kfac_pytorch_tpu_torch.ops import factors as _ref

#: rows a block stages per round (kBK in csrc/capture.cu)
_BK = 16
#: blocks in flight per SM that the row split aims for
_BLOCKS_PER_SM = 8
#: fewest rows a split takes, which bounds the reduce's serial sum
_MIN_SPLIT_ROWS = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from kfac_pytorch_tpu_torch.ops import _cuda_build
        lib = _cuda_build.load('capture')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kfac_conv_a.argtypes = [p, i, i, i, i, i, i, i, i, i, i, i, i,
                                    i, i, i, i, i, p, f, i, p, p, p]
        lib.kfac_conv_a.restype = ctypes.c_int
        lib.kfac_stat_rows.argtypes = [p, i, i, i, i, i, f, f, f, i, i, i,
                                       p, f, i, p, p, p]
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


def _split(f, nrows, device):
    """Per-thread tile width TM (tile = 16*TM) and the row split: enough
    (tile, split) blocks to keep every SM busy, each split a whole number
    of staged rounds. Returns ``(tm, splits, rows_per_split)``."""
    tm = 1 if f <= 16 else (2 if f <= 32 else 4)
    tile = 16 * tm
    tiles = (-(-f // tile)) ** 2
    if nrows >= 2 ** 31 - _MIN_SPLIT_ROWS:
        raise ValueError(f'capture kernels index rows in int32; got {nrows}')
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rounds = max(1, -(-nrows // _BK))
    splits = max(1, min(-(-nrows // _MIN_SPLIT_ROWS),
                        -(-sms * _BLOCKS_PER_SM // tiles)))
    per = -(-rounds // splits) * _BK
    return tm, -(-nrows // per), per


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
    tm, splits, per = _split(f, nrows, rows.device)
    part = torch.empty((splits, f, f), dtype=torch.float32,
                       device=rows.device)
    out = torch.empty((f, f), dtype=torch.float32, device=rows.device)
    cur, alpha, has_ema = _ema_args(ema)
    m = list(mults) + [1.0] * (2 - len(mults))
    err = _kernels().kfac_stat_rows(
        rows.data_ptr(), _DTYPES[rows.dtype], nrows, d, int(append_ones),
        len(mults), float(m[0]), float(m[1]), float(denom), tm, splits, per,
        cur, alpha, has_ema, part.data_ptr(), out.data_ptr(),
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
    tm, splits, per = _split(f, nrows, a.device)
    part = torch.empty((splits, f, f), dtype=torch.float32, device=a.device)
    out = torch.empty((f, f), dtype=torch.float32, device=a.device)
    cur, alpha, has_ema = _ema_args(ema)
    err = _kernels().kfac_conv_a(
        a.data_ptr(), _DTYPES[a.dtype], n, h, w, c, kh, kw, sh, sw, pt, pl,
        oh, ow, int(use_bias), tm, splits, per, cur, alpha, has_ema,
        part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, 'K1 conv_a')
    compute_a_conv.launches += 1
    if ema is not None and not has_ema:
        return _apply_ema(out, ema)
    return out


compute_a_conv.launches = 0


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
