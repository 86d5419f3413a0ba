"""The port's ``exclude_parts`` ablation at world 1 against the JAX
package (the oracle, sizes and tolerances of
``tests/test_torch_exclude_parts.py``, whose helpers run both sides):
the full run, ComputeInverse and all four parts together equal the JAX
run from the same weights and batch; ComputeFactor, CommunicateFactor
and CommunicateInverse equal, bit for bit, the port run that computes
the same at world 1; every run keeps the oracle's properties.
"""

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import weights

from test_torch_exclude_parts import (ALL_PARTS, EQUIVALENT, LOSS_RTOL,
                                      PARAM_RTOL, _assert_factors_close,
                                      _check_oracle, _jax_run,
                                      _layer_matrices, _port_run, _rebuilt,
                                      _rel_to_max)

torch.set_num_threads(2)


@pytest.mark.parametrize('parts', ['', 'ComputeInverse', ALL_PARTS],
                         ids=['none', 'ComputeInverse', 'all'])
def test_world1_matches_jax(parts):
    want = _jax_run(parts)
    got = _port_run(parts, want['init'])
    st = got['state']
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=LOSS_RTOL)
    # the step before the first parameter update (a later statistic
    # inherits the update's rounding, amplified by the damped eigenbasis)
    _assert_factors_close(got['factors'][0], want['factors'][0])
    for key, w in _rebuilt(want['decomp']).items():
        g = _rebuilt({p: {k: v.numpy() for k, v in t.items()}
                      for p, t in st.kfac_state.decomp.items()})[key]
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0), key
    ref = _layer_matrices(weights.params_from_jax(want['params']))
    mine = _layer_matrices(st.model.state_dict())
    for key, w in ref.items():
        err = _rel_to_max(mine[key].numpy(), w.numpy())
        assert err <= PARAM_RTOL, (key, err)
    _check_oracle(parts, got)


@pytest.mark.parametrize('parts', list(EQUIVALENT))
def test_world1_equals_its_equivalent_run(parts):
    """Each ablation bitwise equals the port run of :data:`EQUIVALENT`
    (that path is held against JAX by ``test_world1_matches_jax``), and
    keeps the oracle's properties; without CommunicateInverse the skipped
    clip parts the parameters from the full run's."""
    init = _jax_run('')['init']
    got = _port_run(parts, init)
    want = _port_run('', init, **EQUIVALENT[parts])
    for a, b in ((want['state'].model.state_dict(),
                  got['state'].model.state_dict()),
                 (want['state'].kfac_state.factors,
                  got['state'].kfac_state.factors)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _check_oracle(parts, got)
    if parts == 'CommunicateInverse':
        full = _layer_matrices(_port_run('', init)['state'].model
                               .state_dict())
        mine = _layer_matrices(got['state'].model.state_dict())
        assert any(_rel_to_max(mine[k].numpy(), full[k].numpy())
                   > 100 * PARAM_RTOL for k in full)
