"""The port's ImageNet slice against the JAX package: the ResNet blocks,
the full ResNet-50 layout and K-FAC plan, label smoothing, the trainer's
data, and a narrow stem + Bottleneck network trained three ``eigen_dp``
steps (``kfac_update_freq=1``) with and without gradient accumulation.

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
  rounded once in torch and at each op in JAX);
- the slice run (``tests/test_torch_slice.py``'s tolerances, fp32 op
  order): losses rtol 1e-5; factors 1e-5 relative plus 1e-6 of
  sqrt(F_ii F_jj); parameters and BatchNorm statistics 5e-4 of each
  tensor's largest entry (the damped eigenbasis amplifies factor
  rounding). As in ``tests/test_torch_lm_slice.py``, the factors are held
  after the steps whose statistics both packages take from the same
  weights: those before the first parameter update (one step, or two
  when two batches accumulate). With a decomposition every step
  (damping 0.002) the first update parts the parameters by ~1e-5 of
  their largest entry, and a later statistic inherits that (1.5e-5
  relative on a diagonal entry of step 3); the parameter bound holds
  it. The port runs ``capture_impl`` None and 'auto' (the capture
  kernels' plain versions on CPU tensors);
- the same run in bf16 (both models with ``dtype=bf16``, the input cast
  as the trainers cast it): losses rtol 2^-8 (one bf16 rounding);
  parameters by the trajectory rule, the whole model's ``||p - p_jax|| /
  ||p_jax - p0||`` within 2x the same gap of JAX's own fp32 run. bf16
  rounding of activations (~1e-3 of a factor's largest A entry, ~3e-2
  of a G behind a BatchNorm's backward) moves the eigen-preconditioned
  updates by ~10% in either package, so no tighter elementwise bound
  holds.
"""

import argparse
import functools
import importlib.util
import os
from fractions import Fraction

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import data as jdata
from kfac_pytorch_tpu import nn as jknn
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu.models import imagenet_resnet as jres
from kfac_pytorch_tpu.utils import losses as jlosses
from kfac_pytorch_tpu.utils import lr as jlr
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import nn as tknn
from kfac_pytorch_tpu_torch import training as ttraining
from kfac_pytorch_tpu_torch import weights
from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet as tres
from kfac_pytorch_tpu_torch.utils import losses as tlosses
from kfac_pytorch_tpu_torch.utils import lr as tlr

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


#: the JAX registry's nets the port has not ported yet (ROADMAP queue 1,
#: item 14), by constructor name
ZOO_NOT_PORTED = {'vgg11', 'vgg13', 'vgg16', 'vgg19', 'wrn_28_10',
                  'inception_v4', 'densenet121', 'densenet169',
                  'densenet201'}


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
    (``'resnext50'`` -> ``resnext50_32x4d``), unless the net is one of
    item 14's; ``train_imagenet --model`` takes the name."""
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


# -- the slice: a narrow stem + Bottleneck network, three eigen_dp steps --

STEPS, BS, HW, CLASSES = 3, 8, 32, 10
HP = dict(lr=0.0125, damping=0.002, kfac_update_freq=1, kl_clip=0.001,
          factor_decay=0.95, assignment='balanced')


class JNarrow(linen.Module):
    """The ImageNet ResNet's stem and two Bottlenecks (the second with a
    stride-2 3x3 and a 1x1 stride-2 shortcut), narrow, computing in
    ``dtype`` as ``ResNet`` does."""
    dtype: jnp.dtype = jnp.float32

    @linen.compact
    def __call__(self, x, train=True):
        x = jknn.Conv(8, (7, 7), strides=(2, 2), padding=(3, 3),
                      use_bias=False, kernel_init=jres._kaiming,
                      dtype=self.dtype, name='conv1')(x)
        x = linen.relu(jres._norm(train, self.dtype, 'bn1')(x))
        x = linen.max_pool(x, (3, 3), strides=(2, 2),
                           padding=((1, 1), (1, 1)))
        x = jres.Bottleneck(planes=4, stride=1, downsample=True,
                            dtype=self.dtype, name='layer1_0')(x, train=train)
        x = jres.Bottleneck(planes=4, stride=2, downsample=True,
                            dtype=self.dtype, name='layer2_0')(x, train=train)
        x = jnp.mean(x, axis=(1, 2))
        return jknn.Dense(CLASSES, kernel_init=jres._kaiming,
                          dtype=self.dtype, name='fc')(x)


class TNarrow(torch.nn.Module):
    input_layout = 'NHWC'

    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = tknn.Conv2d(3, 8, 7, stride=2, padding=3, bias=False,
                                 compute_dtype=dtype)
        self.bn1 = cifar_resnet.BatchNorm2d(8, dtype=dtype)
        self.layer1_0 = tres.Bottleneck(8, 4, 1, True, dtype=dtype)
        self.layer2_0 = tres.Bottleneck(16, 4, 2, True, dtype=dtype)
        self.fc = tknn.Linear(16, CLASSES, compute_dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer2_0(self.layer1_0(x))
        return self.fc(x.mean(dim=(2, 3)))


def _lr_fn(mod, k):
    # 4 steps an epoch, one warmup epoch, the trainer's batch scale
    return mod.warmup_multistep(HP['lr'], 4, 1, [35], scale=k)


def _batches():
    r = np.random.RandomState(3)
    return [{'input': r.randn(BS, HW, HW, 3).astype(np.float32),
             'label': r.randint(0, CLASSES, BS).astype(np.int64)}
            for _ in range(STEPS)]


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, copy=True), tree)


@functools.lru_cache(maxsize=None)
def _jax_run(k, dtype='float32'):
    """The JAX trainer's step on JNarrow: ``k`` batches a parameter
    update, the input cast to ``dtype`` as ``examples/imagenet_resnet.py``
    casts it."""
    jdt = DTYPES[dtype][0]
    model = JNarrow(dtype=jdt)
    lr_fn = _lr_fn(jlr, k)
    tx = jtraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-5)
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    hp = {n: v for n, v in HP.items() if n != 'lr'}
    pre = jkfac.KFAC(variant='eigen_dp', health=False, lr=HP['lr'], **hp)
    state = jax.jit(lambda key: jtraining.init_train_state(
        model, tx, pre, key, jnp.zeros((BS, HW, HW, 3))))(
            jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.extra_vars['batch_stats']))

    def loss_fn(out, batch):
        return jlosses.label_smoothing_cross_entropy(out, batch['label'],
                                                     smoothing=0.1)

    step = jtraining.build_train_step(model, tx, pre, loss_fn,
                                      extra_mutable=('batch_stats',))
    losses, factors = [], []
    for i, b in enumerate(_batches()):
        b = {'input': jnp.asarray(b['input'], jdt),
             'label': jnp.asarray(b['label'])}
        state, m = step(state, b, lr=float(lr_fn(i)), damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(_np_tree(state.kfac_state.factors))
    return {'k': k, 'init': init, 'losses': losses, 'plan': pre.plan,
            'params': _np_tree(state.params),
            'batch_stats': _np_tree(state.extra_vars['batch_stats']),
            'factors': factors}


@pytest.fixture(scope='module', params=[1, 2], ids=['bpa1', 'bpa2'])
def jax_run(request):
    return _jax_run(request.param)


@pytest.fixture(scope='module', params=[1, 2], ids=['bpa1', 'bpa2'])
def jax_run_bf16(request):
    return _jax_run(request.param, 'bfloat16')


def _port_run(init, k, capture_impl, dtype=None):
    model = TNarrow(dtype)
    model.load_state_dict(weights.params_from_jax(*init))
    lr_fn = _lr_fn(tlr, k)
    tx = ttraining.sgd(lr_fn, momentum=0.9, weight_decay=5e-5)
    if k > 1:
        tx = ttraining.MultiSteps(tx, k)
    pre = tkfac.KFAC(variant='eigen_dp', capture_impl=capture_impl, **HP)
    state = ttraining.init_train_state(model, tx, pre,
                                       np.zeros((BS, HW, HW, 3), np.float32),
                                       device='cpu')
    step = ttraining.build_train_step(
        model, tx, pre, lambda out, b: tlosses.label_smoothing_cross_entropy(
            out, b['label'], smoothing=0.1), input_dtype=dtype)
    losses, factors = [], []
    for i, b in enumerate(_batches()):
        state, m = step(state, {kk: torch.from_numpy(v)
                                for kk, v in b.items()},
                        lr=lr_fn(i), damping=HP['damping'])
        losses.append(float(m['loss']))
        factors.append(state.kfac_state.factors)
    return pre, state, losses, factors


@pytest.mark.parametrize('capture_impl', [None, 'auto'])
def test_narrow_resnet_three_steps_match_jax(jax_run, capture_impl):
    k = jax_run['k']
    pre, state, losses, factors = _port_run(jax_run['init'], k,
                                            capture_impl)
    assert [m.name for m in pre.plan.metas] == \
        [m.name for m in jax_run['plan'].metas]
    assert pre.plan.bucket_dims == jax_run['plan'].bucket_dims
    np.testing.assert_allclose(losses, jax_run['losses'], rtol=LOSS_RTOL)
    for i in range(k):   # the steps before the first parameter update
        for key, want in jax_run['factors'][i].items():
            got = factors[i][key].double().numpy()
            d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
            bound = (FACTOR_ATOL * d[:, :, None] * d[:, None, :]
                     + FACTOR_RTOL * np.abs(want))
            assert np.all(np.abs(got - want) <= bound), (i, key)
    want_sd = weights.params_from_jax(jax_run['params'],
                                      jax_run['batch_stats'])
    got_sd = state.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for key, want in want_sd.items():
        err = _rel_to_max(got_sd[key].numpy(), want.numpy())
        assert err <= PARAM_RTOL, (key, err)
    if k > 1:
        # the third call only accumulated: one inner update was applied
        assert state.opt_state['gradient_step'] == 1
        assert state.opt_state['mini_step'] == 1


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
