"""The rest of the port's vision zoo (VGG, WRN-28-10, DenseNet-BC,
Inception-v4) against the JAX package: the full-depth layouts, the
blocks from the same parameters, and K1's plain version at
Inception-v4's conv geometries.

- Layouts at full depth, no weights: ``state_dict`` names and shapes
  against ``weights.params_from_jax`` of the JAX variables' shapes
  (``jax.eval_shape``), the K-FAC metas in call order (path, kind,
  bias, dims, kernel, strides, padding) and the ImageNet trainer's
  ``eigen_dp`` plan. Each net runs one forward at the smallest input it
  takes (75 x 75 for Inception-v4, 32 x 32 for the rest).
- Blocks (a narrow VGG whose last map is 2 x 2, so the NHWC flatten is
  exercised; ``WideBlock`` with the identity and the projection
  shortcut; ``DenseLayer``; ``Transition``; every Inception block at its
  real width on a small map) from the same seeded parameters, train and
  eval: outputs and BatchNorm running statistics within 1e-5 of each
  tensor's largest entry in fp32 (op order), 2e-2 in bf16
  (``tests/test_torch_imagenet.py``'s block tolerances).
- K1's plain version (a CPU tensor) against the JAX ``compute_a_conv``
  and its Pallas kernel in interpret mode at the (1,7), (7,1), (1,3) and
  (3,1) kernels with their (0,3)/(3,0)/(0,1)/(1,0) paddings and at a
  VALID 3x3 stride 2 on an odd map, fp32, two of them with the bias
  column: ``tests/test_torch_factors.py``'s tolerance, 1e-6 of
  sqrt(F_ii F_jj) plus 1e-5 relative.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import cifar_vgg as jvgg
from kfac_pytorch_tpu.models import cifar_wide_resnet as jwrn
from kfac_pytorch_tpu.models import densenet as jdense
from kfac_pytorch_tpu.ops import factors as jf
from kfac_pytorch_tpu.ops import pallas_capture as jpc
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_vgg as tvgg
from kfac_pytorch_tpu_torch.models import cifar_wide_resnet as twrn
from kfac_pytorch_tpu_torch.models import densenet as tdense
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
from tests.test_torch_factors import assert_factor_close
from tests.test_torch_imagenet import (BLOCK_TOL, DTYPES, _nchw,
                                       _randomized, _rel_to_max)

# (each package's ``models`` re-exports the constructor
# ``inception_v4`` over its module's name)
jinc = importlib.import_module('kfac_pytorch_tpu.models.inception_v4')
tinc = importlib.import_module('kfac_pytorch_tpu_torch.models.inception_v4')

torch.set_num_threads(2)

#: (JAX net, port net, input size); the port's nets are built without
#: weights (``torch.device('meta')``, then uninitialized CPU memory): a
#: forward for the shapes needs none
NETS = {
    'vgg16': (lambda: jvgg.vgg16(num_classes=100),
              lambda: tvgg.CifarVGG(tvgg._CFG['vgg16'], 100), 32),
    'wrn_28_10': (jwrn.wrn_28_10, twrn.WideResNet, 32),
    'densenet201': (jdense.densenet201,
                    lambda: tdense.DenseNet((6, 12, 48, 32)), 32),
    'inception_v4': (jinc.inception_v4, tinc.InceptionV4, 75),
}

META_FIELDS = ('path', 'kind', 'use_bias', 'in_dim', 'out_dim',
               'kernel_shape', 'kernel_size', 'strides', 'padding')


@pytest.fixture(scope='module', params=list(NETS))
def net_pair(request):
    jctor, tctor, size = NETS[request.param]
    jmodel = jctor()
    x = jnp.zeros((1, size, size, 3))
    # the layers report themselves while init traces (call order), as
    # capture.collect_layer_meta's trace records them
    with jcapture._record_layers() as layers:
        variables = jax.eval_shape(
            lambda: jcapture.init(jmodel, jax.random.PRNGKey(0), x))
    jmetas = dict(layers)
    with torch.device('meta'):
        tmodel = tctor()
    tmodel = tmodel.to_empty(device='cpu')
    tmetas = tcapture.collect_layer_meta(tmodel,
                                         torch.zeros((1, 3, size, size)))
    return variables, jmetas, tmodel, tmetas


def test_zoo_state_dict_matches_jax_shapes(net_pair):
    variables, _, tmodel, _ = net_pair
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
    sd = weights.params_from_jax(zeros['params'], zeros['batch_stats'])
    got = tmodel.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    tmodel.load_state_dict(sd)   # strict: every name converts


def test_zoo_kfac_plan_matches_jax(net_pair):
    _, jmetas, tmodel, tmetas = net_pair
    assert list(tmetas) == list(jmetas)
    for name, jm in jmetas.items():
        tm = tmetas[name]
        for field in META_FIELDS:
            assert getattr(tm, field) == getattr(jm, field), (name, field)
    # registration order is call order: the trainers' hooks and the JAX
    # registry see the layers in one order
    assert [n.replace('.', '/') for n, _ in tcapture.kfac_layers(tmodel)] \
        == list(jmetas)
    jpre = jkfac.KFAC(variant='eigen_dp', assignment='balanced')
    tpre = tkfac.KFAC(variant='eigen_dp', assignment='balanced')
    jp, tp = jpre.setup(jmetas), tpre.setup(tmetas)
    assert tp.bucket_dims == jp.bucket_dims
    assert tp.layer_rows == jp.layer_rows
    for bdim in jp.bucket_dims:
        jb, tb = jp.buckets[bdim], tp.buckets[bdim]
        assert (tb.per_dev, tb.n_rows) == (jb.per_dev, jb.n_rows)
        assert [None if s is None else (s.layer_idx, s.side, s.dim)
                for s in tb.slot_of_row] == \
            [None if s is None else (s.layer_idx, s.side, s.dim)
             for s in jb.slot_of_row]
    assert [(g.dg, g.da, list(g.layer_idx)) for g in tp.pred_groups] == \
        [(g.dg, g.da, list(g.layer_idx)) for g in jp.pred_groups]


def test_vgg_takes_only_its_input_size():
    model = tvgg.CifarVGG((8, 'M'), dtype=None, in_size=8)
    model(torch.zeros((1, 3, 8, 8)))
    with pytest.raises(RuntimeError):
        model(torch.zeros((1, 3, 16, 16)))


#: (name, JAX block factory, port block factory, input NHWC shape):
#: factories take the (JAX, torch) dtype
BLOCKS = [
    ('vgg-narrow', lambda d: jvgg.CifarVGG(cfg=(8, 8, 'M', 16, 'M'),
                                           dtype=d),
     lambda d: tvgg.CifarVGG((8, 8, 'M', 16, 'M'), dtype=d, in_size=8),
     (2, 8, 8, 3)),
    ('wide-identity', lambda d: jwrn.WideBlock(16, 1, dtype=d),
     lambda d: twrn.WideBlock(16, 16, 1, d), (2, 8, 8, 16)),
    ('wide-projection', lambda d: jwrn.WideBlock(16, 2, dtype=d),
     lambda d: twrn.WideBlock(8, 16, 2, d), (2, 8, 8, 8)),
    ('dense-layer', lambda d: jdense.DenseLayer(8, dtype=d),
     lambda d: tdense.DenseLayer(24, 8, d), (2, 8, 8, 24)),
    ('transition', lambda d: jdense.Transition(12, dtype=d),
     lambda d: tdense.Transition(24, 12, d), (2, 8, 8, 24)),
    ('stem', lambda d: jinc.Stem(dtype=d), lambda d: tinc.Stem(d),
     (2, 35, 35, 3)),
    ('inception-a', lambda d: jinc.InceptionA(dtype=d),
     lambda d: tinc.InceptionA(dtype=d), (2, 5, 5, 384)),
    ('reduction-a', lambda d: jinc.ReductionA(dtype=d),
     lambda d: tinc.ReductionA(dtype=d), (2, 7, 7, 384)),
    ('inception-b', lambda d: jinc.InceptionB(dtype=d),
     lambda d: tinc.InceptionB(dtype=d), (2, 3, 3, 1024)),
    ('reduction-b', lambda d: jinc.ReductionB(dtype=d),
     lambda d: tinc.ReductionB(dtype=d), (2, 7, 7, 1024)),
    ('inception-c', lambda d: jinc.InceptionC(dtype=d),
     lambda d: tinc.InceptionC(dtype=d), (2, 3, 3, 1536)),
]


def _compiled(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off, so each op
    rounds to its dtype as flax's op-by-op apply does (XLA's CPU fusions
    would otherwise keep bf16 intermediates in fp32), in one compile a
    block instead of one an op."""
    return jax.jit(fn).lower(*args).compile(
        {'xla_allow_excess_precision': False})(*args)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('spec', BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(spec, dtype):
    """Train, then eval on the statistics the train step left."""
    _, jfactory, tfactory, shape = spec
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    jblock = jfactory(jdt)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    params = _randomized(shapes['params'], rng)
    stats = _randomized(shapes['batch_stats'], rng)
    tblock = tfactory(tdt)
    tblock.load_state_dict(weights.params_from_jax(params, stats))
    tblock.to(memory_format=torch.channels_last)
    xj, xt = jnp.asarray(x, jdt), _nchw(x).to(tdt)
    tol = BLOCK_TOL[dtype]

    def train_then_eval(v, x):
        out, mutated = jblock.apply(v, x, True, mutable=['batch_stats'])
        trained = {'params': v['params'],
                   'batch_stats': mutated['batch_stats']}
        return out, trained['batch_stats'], jblock.apply(trained, x, False)

    out_train, stats, out_eval = _compiled(
        train_then_eval, {'params': params, 'batch_stats': stats}, xj)
    want_sd = weights.params_from_jax(params, stats)
    for train, out in ((True, out_train), (False, out_eval)):
        tblock.train(train)
        with torch.no_grad():
            got = tblock(xt)
        assert got.dtype == tdt
        got = got.float()
        if got.ndim == 4:
            got = got.permute(0, 2, 3, 1)
        want = np.asarray(jnp.asarray(out, jnp.float32))
        assert got.shape == want.shape
        err = _rel_to_max(got.numpy(), want)
        assert err <= tol, (train, 'output', err)
        for k, v in tblock.state_dict().items():
            if 'running' in k:
                err = _rel_to_max(v.numpy(), want_sd[k].numpy())
                assert err <= tol, (train, k, err)


#: Inception-v4's conv geometries (its convs have no bias; two cases add
#: the bias column): (input NHWC, kernel, strides, padding, bias)
K1_GEOMETRIES = [((2, 7, 7, 4), (1, 7), (1, 1), (0, 3), False),
                 ((2, 7, 7, 4), (7, 1), (1, 1), (3, 0), True),
                 ((2, 5, 5, 4), (1, 3), (1, 1), (0, 1), False),
                 ((2, 5, 5, 4), (3, 1), (1, 1), (1, 0), True),
                 ((2, 9, 9, 4), (3, 3), (2, 2), (0, 0), False)]


@pytest.mark.parametrize('geom', K1_GEOMETRIES,
                         ids=lambda g: f'{g[1][0]}x{g[1][1]}s{g[2][0]}')
def test_k1_plain_matches_jax_at_inception_geometries(geom):
    shape, ksize, strides, padding, use_bias = geom
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pads = tcapture.canonical_padding(shape[1:3], ksize, strides, padding)
    assert pads == jcapture.canonical_padding(shape[1:3], ksize, strides,
                                              padding)
    got = ck.compute_a_conv(xt, ksize, strides, pads, use_bias)
    assert got.shape == (ksize[0] * ksize[1] * shape[-1] + use_bias,) * 2
    assert_factor_close(got, jf.compute_a_conv(xj, ksize, strides, pads,
                                               use_bias))
    assert_factor_close(got, jpc.compute_a_conv(xj, ksize, strides, pads,
                                                use_bias, interpret=True))
