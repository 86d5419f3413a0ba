"""The port's ImageNet slice against the JAX package, part 3: the narrow
network of ``tests/test_torch_imagenet_steps.py`` trained three
``eigen_dp`` steps in bf16, with and without gradient accumulation.

The same run in bf16 (both models with ``dtype=bf16``, the input cast
as the trainers cast it): losses rtol 2^-8 (one bf16 rounding);
parameters by the trajectory rule, the whole model's ``||p - p_jax|| /
||p_jax - p0||`` within 2x the same gap of JAX's own fp32 run. bf16
rounding of activations (~1e-3 of a factor's largest A entry, ~3e-2
of a G behind a BatchNorm's backward) moves the eigen-preconditioned
updates by ~10% in either package, so no tighter elementwise bound
holds.
"""

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import weights

from test_torch_imagenet import (BF16_LOSS_RTOL, BF16_TRAJ_FACTOR,
                                 _update_gap)
from test_torch_imagenet_steps import _jax_run, _port_run

torch.set_num_threads(2)


@pytest.fixture(scope='module', params=[1, 2], ids=['bpa1', 'bpa2'])
def jax_run_bf16(request):
    return _jax_run(request.param, 'bfloat16')


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_narrow_resnet_three_steps_match_jax_bf16(jax_run_bf16, capture_impl):
    """The trainer's bf16 step as one: the input cast, bf16 convolutions
    and BatchNorms, bf16 logits into the loss, bf16 captures into K-FAC,
    against JAX's bf16 run, with JAX's own fp32 run as the control."""
    k = jax_run_bf16['k']
    pre, state, losses, _ = _port_run(jax_run_bf16['init'], k, capture_impl,
                                      torch.bfloat16)
    assert pre.plan.bucket_dims == jax_run_bf16['plan'].bucket_dims
    np.testing.assert_allclose(losses, jax_run_bf16['losses'],
                               rtol=BF16_LOSS_RTOL)
    ref = weights.params_from_jax(jax_run_bf16['params'],
                                  jax_run_bf16['batch_stats'])
    init = weights.params_from_jax(*jax_run_bf16['init'])
    got = state.model.state_dict()
    assert set(got) == set(ref)
    fp32 = _jax_run(k)
    control = _update_gap(weights.params_from_jax(
        fp32['params'], fp32['batch_stats']), ref, init)
    gap = _update_gap(got, ref, init)
    assert gap <= BF16_TRAJ_FACTOR * control, (gap, control)
