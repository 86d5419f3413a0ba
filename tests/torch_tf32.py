"""Numpy emulation of the TF32 conversion the port's tensor-core kernels
use (``cvt.rna.tf32.f32``) and of their split-TF32 products, shared by the
CPU tests of K1 (``test_torch_capture_split.py``) and K5a/K5b
(``test_torch_attention_split.py``). Imports no JAX."""

import numpy as np
import torch


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on float32 values: round the magnitude to 10
    mantissa bits, ties away from zero (add half of the 13 dropped bits'
    range to the sign-magnitude pattern, then clear them). Inf and NaN
    pass through."""
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    special = (u & 0x7F800000) == 0x7F800000
    r = np.where(special, u, (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
    return r.astype(np.uint32).view(np.float32)


def split(x):
    """``(big, small)``, both TF32 values in float32."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_t(t):
    big, small = split(t.detach().numpy())
    return torch.from_numpy(big), torch.from_numpy(small)


def split_matmul(a, b):
    """``a @ b`` as the kernels take it: three TF32 passes summed in fp32
    (a product of two TF32 values is exact in fp32)."""
    ab, as_ = split_t(a)
    bb, bs = split_t(b)
    return as_ @ bb + ab @ bs + ab @ bb


def tf32_matmul(a, b):
    """One TF32 pass: both operands rounded, summed in fp32."""
    return split_t(a)[0] @ split_t(b)[0]
