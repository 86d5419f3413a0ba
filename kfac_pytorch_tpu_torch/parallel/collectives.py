"""Collectives over a torch process group, with a zero-comm world=1 path
(port of ``kfac_pytorch_tpu/parallel/collectives.py``).

The JAX package's "axis" is a ``torch.distributed`` process group here,
or ``None``: ``group=None`` is the identity path (no communication, no
compression, no residual change), as ``axis_name=None`` is there. A
group of size 1 is an axis like any other: its collectives run (and so
does the compressed wire's prep, K3).

Gloo takes CUDA tensors only for all-reduce and broadcast, so on a gloo
group every collective on a CUDA tensor stages through host memory: the
inputs are copied to the CPU, the collective runs there, and the result
is copied back. The choice is keyed on the group's backend, never taken
in reaction to an error. NCCL groups run on the device.

Wire dtypes of the factor collectives (``comm_precision``):

  'fp32'  exact: every function is the uncompressed collective;
  'bf16'  a bf16 wire (half the bytes), with an error-feedback residual
          on the reduce (:func:`pmean_scatter_ef`);
  'int8'  per-leading-row absmax int8 on the gathers (a quarter of the
          bytes, plus a ``[rows]`` fp32 scale). The reduce floors at
          bf16 (:func:`reduce_wire_dtype`): integer partial sums
          overflow.

A bf16 gather moves the tensor's bytes as ``uint8`` (NCCL has no 16-bit
integer type; a byte gather is exact on every backend). The gradient
all-reduce (:func:`average_grads`) is never compressed.

:func:`ledger` counts the payload bytes of every collective by the named
scope it ran in (:func:`named_scope`), the port's counterpart of the
JAX package's HLO byte ledger (``scripts/comm_count.py``): an
all-gather or reduce-scatter counts its result, an all-reduce its
operand.
"""

import contextlib

import torch
import torch.distributed as dist

WIRE_DTYPES = ('fp32', 'bf16', 'int8')

#: fp32 payload-byte multiplier per wire dtype (int8 leaves out its
#: O(rows) scale side channel)
WIRE_COMPRESSION = {'fp32': 1.0, 'bf16': 0.5, 'int8': 0.25}

_scopes = []
_ledger = None


# ---------------------------------------------------------------------------
# Axis queries and the byte ledger
# ---------------------------------------------------------------------------

def axis_size(group):
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group):
    return 0 if group is None else dist.get_rank(group)


@contextlib.contextmanager
def named_scope(name):
    """Tag the collectives run inside with ``name`` in :func:`ledger`."""
    _scopes.append(name)
    try:
        yield
    finally:
        _scopes.pop()


@contextlib.contextmanager
def ledger():
    """Record ``(scope, op, dtype, bytes)`` of every collective run inside
    (the innermost :func:`named_scope`, '' outside any)."""
    global _ledger
    prev, _ledger = _ledger, []
    try:
        yield _ledger
    finally:
        _ledger = prev


def _record(op, t):
    if _ledger is not None:
        _ledger.append((_scopes[-1] if _scopes else '', op, t.dtype,
                        t.numel() * t.element_size()))


def _staged(group, t):
    return t.device.type == 'cuda' and dist.get_backend(group) == 'gloo'


def _all_reduce_sum(x, group):
    """Sum all-reduce of ``x`` into a new tensor."""
    _record('all_reduce', x)
    out = x.cpu().clone() if _staged(group, x) else x.clone()
    dist.all_reduce(out, group=group)
    return out.to(x.device)


def _all_gather(x, group):
    """Device-major concatenation of every rank's ``x`` along axis 0."""
    n = axis_size(group)
    src = x.contiguous()
    if _staged(group, src):
        src = src.cpu()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _record('all_gather', out)
    gather = getattr(dist, 'all_gather_single', None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out.to(x.device)


def _reduce_scatter(x, group):
    """Sum over ranks of ``x``, each rank keeping its device-major row
    block (``x.shape[0] / size`` rows)."""
    n = axis_size(group)
    src = x.contiguous()
    if _staged(group, src):
        src = src.cpu()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _record('reduce_scatter', out)
    scatter = getattr(dist, 'reduce_scatter_single', None) \
        or dist.reduce_scatter_tensor
    scatter(out, src, group=group)
    return out.to(x.device)


# ---------------------------------------------------------------------------
# The uncompressed collectives
# ---------------------------------------------------------------------------

def pmean(x, group):
    if group is None:
        return x
    return _all_reduce_sum(x, group) / axis_size(group)


def psum(x, group):
    if group is None:
        return x
    return _all_reduce_sum(x, group)


def all_gather_rows(x, group):
    """Concatenate every rank's row block along axis 0, device-major: the
    owners hold their rows, the gather replicates all of them."""
    if group is None:
        return x
    return _all_gather(x, group)


def pmean_flat(tensors, group):
    """:func:`pmean` of a list of tensors through ONE all-reduce of their
    flat concatenation (one launch and one host round trip instead of one
    per tensor). Returns new tensors of the inputs' shapes and dtypes."""
    if group is None or not tensors:
        return list(tensors)
    dtype = tensors[0].dtype
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    flat = _all_reduce_sum(flat, group) / axis_size(group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def average_grads(grads, group):
    """Data-parallel gradient average of a ``{name: grad}`` dict: the sum
    all-reduce over the group divided by its size (Horovod's
    ``op=Average``), in fp32, never compressed. Each rank's grads are the
    gradient of its LOCAL-mean loss, so the result is the global-batch
    mean, the same bits on every rank."""
    if group is None:
        return grads
    keys = [k for k, g in grads.items() if g is not None]
    return {**grads, **dict(zip(keys, pmean_flat([grads[k] for k in keys],
                                                 group)))}


# ---------------------------------------------------------------------------
# Compression-aware collectives (comm_precision)
# ---------------------------------------------------------------------------

def check_wire_dtype(comm_precision):
    if comm_precision not in WIRE_DTYPES:
        raise ValueError(f'comm_precision must be one of {WIRE_DTYPES}, '
                         f'got {comm_precision!r}')
    return comm_precision


def reduce_wire_dtype(comm_precision):
    """Wire dtype of the REDUCE collectives: int8 floors to bf16 (integer
    partial sums overflow at world >= 2); the gathers keep int8, each
    element having one contributor."""
    return 'bf16' if comm_precision == 'int8' else comm_precision


def quantize_rows(x):
    """Per-leading-row symmetric int8: ``scale[r] = absmax(x[r]) / 127``,
    ``q = round(x / scale)`` (half to even), clipped to +-127. An all-zero
    row gets scale 0 and quantizes (and dequantizes) to exact zeros."""
    absmax = x.abs().amax(dim=tuple(range(1, x.ndim)))
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    shaped = safe.reshape(safe.shape + (1,) * (x.ndim - 1))
    q = torch.clamp(torch.round(x / shaped), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_rows(q, scale, dtype=torch.float32):
    shaped = scale.reshape(scale.shape + (1,) * (q.ndim - 1))
    return q.to(dtype) * shaped.to(dtype)


def _lossy(x, comm_precision):
    return comm_precision != 'fp32' and x.dtype.is_floating_point


def pmean_wire(x, group, comm_precision='fp32'):
    """pmean over a low-precision wire with no error feedback: cast to
    bf16, summed by the collective in bf16, the mean taken in fp32."""
    if group is None or not _lossy(x, comm_precision):
        return pmean(x, group)
    total = _all_reduce_sum(x.to(torch.bfloat16), group).to(x.dtype)
    return total / axis_size(group)


def pmean_scatter_ef(x, group, comm_precision, residual, fused=False):
    """Mean-reduce ``x`` over the group and return THIS rank's row block
    of the result (axis 0 device-major, the stacked-bucket layout): a
    reduce-scatter, since the factor statistics' only consumer is each
    owner's own rows.

    Lossy modes add error feedback: each rank sends ``Q(x + r)`` and
    keeps ``r' = (x + r) - Q(x + r)``, so the quantization error enters
    the next reduce instead of being lost. The wire is bf16 under 'bf16'
    and 'int8' alike (:func:`reduce_wire_dtype`); the collective sums in
    bf16, and the mean is taken in fp32.

    Returns ``(local mean rows, new residual)``; ``residual`` may be None
    at fp32 and passes through. ``group=None`` returns ``(x, residual)``
    untouched. ``fused=True`` runs the lossy prep as one kernel launch
    (K3, :func:`ops.capture_kernels.ef_quantize`): the same wire and
    residual bits as the three elementwise ops."""
    if group is None:
        return x, residual
    n = axis_size(group)
    if not _lossy(x, comm_precision):
        return _reduce_scatter(x, group) / n, residual
    if residual is None:
        raise ValueError('a lossy pmean_scatter_ef needs an error-feedback '
                         'residual (KFACState.comm_err)')
    if fused:
        from kfac_pytorch_tpu_torch.ops import capture_kernels
        wire, new_residual = capture_kernels.ef_quantize(x, residual)
    else:
        xc = x + residual
        wire = xc.to(torch.bfloat16)
        new_residual = xc - wire.to(x.dtype)
    red = _reduce_scatter(wire, group).to(x.dtype)
    return red / n, new_residual


def all_gather_rows_compressed(x, group, comm_precision='fp32'):
    """:func:`all_gather_rows` over a low-precision wire: bf16 moves the
    bf16 tensor's bytes (exact to bf16 rounding); int8 moves per-row
    absmax int8 plus the ``[rows]`` fp32 scales (a second, O(rows)
    gather). Every element has one contributor, its owner, so the only
    loss is the owner's own quantization. Non-float payloads and
    ``group=None`` pass uncompressed."""
    if group is None or not _lossy(x, comm_precision):
        return all_gather_rows(x, group)
    if comm_precision == 'bf16':
        wire = x.to(torch.bfloat16).contiguous()
        full = _all_gather(wire.view(torch.uint8), group)
        return full.view(torch.bfloat16).to(x.dtype)
    q, scale = quantize_rows(x)
    return dequantize_rows(_all_gather(q, group), _all_gather(scale, group),
                           x.dtype)
