"""The port's ImageNet slice against the JAX package: the ResNet blocks,
the full ResNet-50 layout and K-FAC plan, label smoothing and the
trainer's data. A narrow stem + Bottleneck network trained three
``eigen_dp`` steps is in ``tests/test_torch_imagenet_steps.py`` (fp32)
and ``tests/test_torch_imagenet_bf16_steps.py`` (bf16).

Tolerances:

- blocks (``Bottleneck`` stride 1 and 2 with ``ds_conv``, ``BasicBlock``;
  planes 4-8, 16 x 16, batch 4; train and eval) from the same parameters:
  outputs and BatchNorm statistics within 1e-5 of each tensor's largest
  entry in fp32 (op order), 2e-2 in bf16 (a few bf16 roundings of
  2^-8 through three convolutions and normalizations);
- a bf16 BatchNorm (train and eval) against flax's ``BatchNorm(dtype=
  bf16)``: output and input gradient bitwise equal in all but 1% of the
  elements (summation order), every element within 2^-8 of the largest
  (one bf16 rounding); running statistics 1e-5. Flax rounds the input's
  gradient from the statistics and from the normalization to bf16 apart
  and adds them in bf16: with one fp32 copy of the input for both, 28%
  of the gradient's elements differ;
- the capture kernels' division by ResNet-50's divisors, none a power of
  two, and by divisors whose odd part nears 2^21 (``Divisor::div`` in
  ``csrc/capture.cu``: ``q = x * inv``, then ``q + (x - q d) * inv``,
  each step rounded once), emulated in exact rational arithmetic at
  random ``x`` and at ``x`` whose quotient lies next to a rounding
  midpoint: it must equal the IEEE quotient bit for bit, as the plain
  versions divide;
- label smoothing: fp32 rtol 1e-6; bf16 logits rtol 2^-7, two bf16
  roundings of the loss (the log-softmax runs in bf16 in both packages,
  rounded once in torch and at each op in JAX).
"""

import argparse
import importlib.util
import os
from fractions import Fraction

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import data as jdata
from kfac_pytorch_tpu.models import imagenet_resnet as jres
from kfac_pytorch_tpu.utils import losses as jlosses
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet as tres
from kfac_pytorch_tpu_torch.utils import losses as tlosses

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
LOSS_RTOL = 1e-5
FACTOR_RTOL, FACTOR_ATOL = 1e-5, 1e-6
PARAM_RTOL = 5e-4
BF16_LOSS_RTOL = 2.0 ** -8
BN_BF16_DIFFER = 0.01
BF16_TRAJ_FACTOR = 2
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _rel_to_max(got, want):
    """max |got - want| over max |want| (a tensor still all zeros, such
    as a BN bias behind a zero-initialized residual scale, must stay
    exactly zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _nchw(x):
    """A numpy NHWC batch as the port's channels_last NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _randomized(tree, rng):
    """``tree``'s shapes with seeded values: kernels N(0, 0.3), BN
    scales around 1, biases and means around 0, variances positive."""
    def leaf(path, v):
        name = path[-1].key
        if name == 'var':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (0.3 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


# (block, in planes, planes, stride, downsample)
BLOCKS = [('bottleneck', 16, 4, 1, False), ('bottleneck', 8, 4, 2, True),
          ('basic', 8, 8, 1, False), ('basic', 4, 8, 2, True)]


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('spec', BLOCKS, ids=lambda s: f'{s[0]}-s{s[3]}'
                         f'{"-ds" if s[4] else ""}')
def test_block_matches_jax(spec, dtype, train):
    kind, cin, planes, stride, ds = spec
    jdt, tdt = DTYPES[dtype]
    jcls = jres.Bottleneck if kind == 'bottleneck' else jres.BasicBlock
    tcls = tres.Bottleneck if kind == 'bottleneck' else tres.BasicBlock
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16, 16, cin).astype(np.float32)
    jblock = jcls(planes=planes, stride=stride, downsample=ds, dtype=jdt)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    params = _randomized(shapes['params'], rng)
    stats = _randomized(shapes['batch_stats'], rng)
    xj = jnp.asarray(x, jdt)
    if train:
        out, mutated = jblock.apply({'params': params, 'batch_stats': stats},
                                    xj, train=True, mutable=['batch_stats'])
        new_stats = mutated['batch_stats']
    else:
        out = jblock.apply({'params': params, 'batch_stats': stats}, xj,
                           train=False)
        new_stats = stats

    tblock = tcls(cin, planes, stride, ds, dtype=tdt)
    tblock.load_state_dict(weights.params_from_jax(params, stats))
    tblock.to(memory_format=torch.channels_last).train(train)
    with torch.no_grad():
        got = tblock(_nchw(x).to(tdt))
    assert got.dtype == tdt
    tol = BLOCK_TOL[dtype]
    want = np.asarray(jnp.asarray(out, jnp.float32))
    err = _rel_to_max(got.float().permute(0, 2, 3, 1).numpy(), want)
    assert err <= tol, ('output', err)
    want_sd = weights.params_from_jax(params, new_stats)
    for k, v in tblock.state_dict().items():
        if 'running' in k:
            err = _rel_to_max(v.numpy(), want_sd[k].numpy())
            assert err <= tol, (k, err)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_bf16_batchnorm_rounds_as_flax(train):
    rng = np.random.RandomState(4)
    x = jnp.asarray(3 * rng.randn(8, 8, 8, 16) + 1, jnp.bfloat16)
    ct = jnp.asarray(rng.randn(8, 8, 8, 16), jnp.bfloat16)
    variables = {'params': {'scale': rng.uniform(0.5, 1.5, 16),
                            'bias': rng.randn(16)},
                 'batch_stats': {'mean': rng.randn(16),
                                 'var': rng.uniform(0.5, 1.5, 16)}}
    variables = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                             variables)
    jbn = linen.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5, dtype=jnp.bfloat16)
    out, vjp = jax.vjp(lambda v: jbn.apply(variables, v,
                                           mutable=['batch_stats']), x)
    dx, = vjp((ct, jax.tree.map(jnp.zeros_like, out[1])))

    tbn = cifar_resnet.BatchNorm2d(16, dtype=torch.bfloat16)
    sd = {'weight': variables['params']['scale'],
          'bias': variables['params']['bias'],
          'running_mean': variables['batch_stats']['mean'],
          'running_var': variables['batch_stats']['var']}
    tbn.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()})
    tbn.train(train)
    xt = _nchw(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
    got = tbn(xt)
    got.backward(_nchw(np.asarray(ct, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    for what, g, want in (('output', got.detach(), out[0]),
                          ('input gradient', xt.grad, dx)):
        g = g.float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(want, np.float32)
        assert np.mean(g != want) <= BN_BF16_DIFFER, (what, np.mean(g != want))
        assert _rel_to_max(g, want) <= 2.0 ** -8, what
    for k, v in (('running_mean', 'mean'), ('running_var', 'var')):
        err = _rel_to_max(tbn.state_dict()[k].numpy(),
                          out[1]['batch_stats'][v])
        assert err <= BLOCK_TOL['float32'], (k, err)


@pytest.fixture(scope='module', params=['resnet50', 'resnext50_32x4d'])
def zoo_pair(request):
    name = request.param
    jmodel = getattr(jres, name)()
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax.eval_shape(
        lambda: jcapture.init(jmodel, jax.random.PRNGKey(0), x))
    jmetas = jcapture.collect_layer_meta(jmodel, variables, x)
    tmodel = getattr(tres, name)()
    tmetas = tcapture.collect_layer_meta(tmodel, torch.zeros((1, 3, 32, 32)))
    return variables, jmetas, tmodel, tmetas


def test_zoo_state_dict_matches_jax_shapes(zoo_pair):
    variables, _, tmodel, _ = zoo_pair
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
    sd = weights.params_from_jax(zeros['params'], zeros['batch_stats'])
    got = tmodel.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    tmodel.load_state_dict(sd)   # strict: every name converts


#: the JAX registry's nets the port has not ported yet, by constructor
#: name: none since the rest of the vision zoo (VGG, WRN-28-10,
#: DenseNet-BC, Inception-v4) was ported
ZOO_NOT_PORTED = set()


def _jax_registry():
    """``{--model name: constructor name}`` of the JAX package's
    ``models.get_model``, read from its source: no net is built."""
    import ast
    import inspect
    from kfac_pytorch_tpu import models as jmodels
    tree = ast.parse(inspect.getsource(jmodels.get_model))
    reg, = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
            and getattr(n.targets[0], 'id', None) == 'registry']
    return {k.value: v.id for k, v in zip(reg.keys, reg.values)}


@pytest.mark.parametrize('name,ctor', sorted(_jax_registry().items()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_jax_model_names_resolve_in_the_port(name, ctor):
    """Every name of the JAX registry names the same net in the port's
    (``'resnext50'`` -> ``resnext50_32x4d``, ``'inception-v4'`` ->
    ``inception_v4``); ``train_imagenet --model`` takes the name."""
    from kfac_pytorch_tpu_torch import models as tmodels, train_imagenet
    if ctor in ZOO_NOT_PORTED:
        assert name not in tmodels.REGISTRY
        return
    assert tmodels.REGISTRY[name] is getattr(tmodels, ctor)
    assert train_imagenet.parse_args(['--model', name]).model == name


def test_zoo_kfac_plan_matches_jax(zoo_pair):
    _, jmetas, _, tmetas = zoo_pair
    assert list(tmetas) == list(jmetas)
    for name, jm in jmetas.items():
        tm = tmetas[name]
        for field in ('path', 'kind', 'use_bias', 'in_dim', 'out_dim',
                      'kernel_shape', 'kernel_size', 'strides', 'padding'):
            assert getattr(tm, field) == getattr(jm, field), (name, field)
    # the ImageNet trainer's preconditioner
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


def _rn32(exact):
    """The float32 nearest the rational ``exact`` (ties to even)."""
    c = np.float32(float(exact))
    near = [np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                    int(np.float32(v).view(np.int32)) & 1))


def _fma32(a, b, c):
    return _rn32(Fraction(float(a)) * Fraction(float(b))
                 + Fraction(float(c)))


#: ResNet-50's output positions (112^2 ... 7^2) and conv G row counts at
#: batch 32, small odd divisors, and odd parts up to the bound 2^21 of
#: ``Divisor::div``'s comment
DIVISORS = [12544, 3136, 784, 196, 49, 401408, 100352, 25088, 6272, 1568,
            1000, 7, 3, 255255, 1048577, 1999999 * 4, 2 ** 21 - 1]


def _near_midpoints(d, rng, n):
    """``n`` float32 ``x`` whose ``x / d`` lies as near a rounding midpoint
    as any can: ``x = X 2^s`` with ``X d_odd^-1`` one away from an odd
    25-bit ``M``, that is ``D M - X 2^j = +-1`` for the odd part ``D`` of
    ``d``, so ``x / d`` is ``ulp / (2 D)`` from the midpoint ``M / 2``."""
    odd = d
    while odd % 2 == 0:
        odd //= 2
    out = []
    while len(out) < n:
        t = 1 if rng.rand() < 0.5 else -1
        j = odd.bit_length() + int(rng.randint(0, 2))
        m0 = (t * pow(odd, -1, 2 ** j)) % 2 ** j
        lo = -(-(2 ** 24 - m0) // 2 ** j)
        hi = (2 ** 25 - 1 - m0) // 2 ** j
        if lo > hi:
            continue
        m = m0 + int(rng.randint(lo, hi + 1)) * 2 ** j
        x = (odd * m - t) // 2 ** j
        if 2 ** 23 <= x < 2 ** 24:
            sign = 1 if rng.rand() < 0.5 else -1
            out.append(sign * np.ldexp(np.float32(x),
                                       int(rng.randint(-60, 40))))
    return np.array(out, np.float32)


@pytest.mark.parametrize('d', DIVISORS)
def test_kernel_division_is_the_ieee_quotient(d):
    rng = np.random.RandomState(d % 1000)
    xs = (rng.randn(500) * np.exp2(rng.randint(-60, 60, 500))).astype(
        np.float32)
    xs = np.concatenate([xs, _near_midpoints(d, rng, 300)])
    d32 = np.float32(d)
    inv = np.float32(1) / d32      # the host's correctly rounded 1 / d
    for x in xs:
        q = np.float32(x * inv)
        got = _fma32(_fma32(-q, d32, x), inv, q)
        assert got == np.float32(x / d32), (d, x)


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_label_smoothing_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(16, 1000)).astype(np.float32)
    labels = rng.randint(0, 1000, 16)
    want = jlosses.label_smoothing_cross_entropy(
        jnp.asarray(logits, jdt), jnp.asarray(labels), smoothing=0.1)
    got = tlosses.label_smoothing_cross_entropy(
        torch.from_numpy(logits).to(tdt), torch.from_numpy(labels),
        smoothing=0.1)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    rtol = 1e-6 if dtype == 'float32' else 2.0 ** -7
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def _jax_get_data():
    spec = importlib.util.spec_from_file_location(
        'jax_imagenet_example', os.path.join(ROOT, 'examples',
                                             'imagenet_resnet.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_data


@pytest.mark.parametrize('real', [False, True], ids=['synthetic', 'dir'])
def test_data_and_loader_match_jax(tmp_path, real):
    train_dir = None
    if real:
        train_dir = str(tmp_path)
        rng = np.random.RandomState(2)
        np.save(tmp_path / 'images.npy',
                rng.randint(0, 256, (40, 8, 8, 3)).astype(np.uint8))
        np.save(tmp_path / 'labels.npy', rng.randint(0, 1000, 40))
    args = argparse.Namespace(train_dir=train_dir, img_size=8,
                              synthetic_size=24)
    want = _jax_get_data()(args)
    got = tdata.get_imagenet(train_dir, 8, 24)
    for (wx, wy), (gx, gy) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
        np.testing.assert_array_equal(gy, wy)
    (x, y), _ = got
    jl = jdata.Loader(x, y, 4, train=True, seed=42, shard=(0, 1))
    tl = tdata.Loader(x, y, 4, train=True, seed=42)
    for _ in range(2):   # two epochs: the per-epoch child seeds agree
        for jb, tb in zip(jl.epoch(), tl.epoch()):
            np.testing.assert_array_equal(tb['input'], jb['input'])
            np.testing.assert_array_equal(tb['label'], jb['label'])


# -- shared by the narrow network's steps (test_torch_imagenet_steps.py,
# test_torch_imagenet_bf16_steps.py) and test_torch_zoo_train.py --

def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


def _update_gap(sd, ref, init):
    """The whole model's ``||p - p_ref|| / ||p_ref - p0||`` over the
    parameters: how far ``sd`` is from ``ref`` against ``ref``'s update
    from ``init``."""
    num = den = 0.0
    for key, want in ref.items():
        if 'running' in key:
            continue
        want = want.double()
        num += float((sd[key].double() - want).norm()) ** 2
        den += float((want - init[key].double()).norm()) ** 2
    return (num / den) ** 0.5
