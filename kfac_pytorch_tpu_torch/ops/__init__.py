"""K-FAC numeric ops: factor statistics and symmetric linear algebra. The
hand-written CUDA capture kernels are ``ops.capture_kernels`` (their
library builds at first use)."""

from kfac_pytorch_tpu_torch.ops.factors import (  # noqa: F401
    compute_a_conv, compute_a_dense, compute_g_conv, compute_g_dense,
    ekfac_scales, extract_patches, layer_rows_conv, layer_rows_dense,
    update_running_avg)
from kfac_pytorch_tpu_torch.ops.linalg import (  # noqa: F401
    add_scaled_identity, clamp_eigvals, fp32_matmul, identity_pad,
    jacobi_eigh, masked_trace, newton_schulz_inverse, psd_inverse,
    subspace_eigh, sym_eig, warm_inverse)
