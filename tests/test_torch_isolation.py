"""The port stands alone and never quietly leaves the GPU.

1. Every module of kfac_pytorch_tpu_torch (and chip_smoke.py) imports in
   a process where jax, flax and optax cannot be imported, and no module
   of the JAX package ends up loaded (the control loop's ``autotune``,
   ``perfmodel`` and ``obs.drift`` among them).
2. Entry points asked for no device go to the GPU: without one they
   raise instead of running on the CPU.
3. The capture- and attention-kernel wrappers run their plain versions
   only for CPU tensors; any other device launches the kernel or raises.
4. The world>1 entry points (the launcher, the trainers at
   ``--num-devices`` > 1, the LM on a data x seq grid) raise without a
   GPU unless ``--device cpu``.
5. The ImageNet trainer raises NotImplementedError, naming its ROADMAP
   item, for every flag of the JAX trainer whose feature is not ported
   (``--io-retries`` and ``--num-devices`` are ported since the elastic
   lane, ``--trace``, ``--prom-file`` and ``--tb-dir`` since the
   observability slice, ``--kfac-autotune`` since the control loop's;
   they keep their cases).
6. ``--kfac-name ekfac_dp`` reaches ``KFAC`` in both trainers, and
   ``--kfac-stagger`` with E-KFAC raises.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import training
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.ops import attention_kernels as ak
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
import kfac_pytorch_tpu_torch as tkfac

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_or_the_jax_package():
    code = textwrap.dedent('''
        import importlib, pkgutil, re, sys
        for name in ('jax', 'jaxlib', 'flax', 'optax'):
            sys.modules[name] = None
        import kfac_pytorch_tpu_torch as pkg
        mods = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + '.')]
        for m in mods:
            importlib.import_module(m)
        importlib.import_module('chip_smoke')
        bad = [m for m in sys.modules
               if re.match(r'kfac_pytorch_tpu(?!_torch)', m)]
        assert not bad, bad
        # the sequence slices: the trainers, the models, and the ring,
        # Ulysses and grid modules of sequence parallelism
        seq = {pkg.__name__ + '.' + m for m in (
            'train_multi30k', 'train_squad', 'train_wikitext', 'train_lm',
            'models.transformer', 'models.translator', 'models.bert',
            'models.rnn', 'models.gpt', 'parallel.ring_attention',
            'parallel.collectives', 'parallel.mesh')}
        assert seq <= set(mods) and seq <= set(sys.modules), seq
        # the control loop: the arbiter and tuner, the perf model and the
        # drift gate, each the port's own copy
        ctl = {pkg.__name__ + '.' + m for m in (
            'autotune', 'perfmodel', 'obs.drift')}
        assert ctl <= set(mods) and ctl <= set(sys.modules), ctl
        print(len(mods))
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, 'PYTHONPATH': ROOT})
    assert out.returncode == 0, out.stderr
    # 37 modules since the ImageNet slice (models.imagenet_resnet,
    # utils.losses, utils.checkpoint, store, store.manifest,
    # store.posix, train_imagenet)
    assert int(out.stdout.split()[-1]) >= 37


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    model = cifar_resnet._make(1)
    tx = training.sgd(0.1)
    pre = tkfac.KFAC(variant='eigen_dp')
    sample = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        training.init_train_state(model, tx, pre, sample)
    from kfac_pytorch_tpu_torch import train_cifar
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cifar.main(['--model', 'resnet20', '--epochs', '1'])
    from kfac_pytorch_tpu_torch import train_lm
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_lm.main(['--seq-len', '16', '--n-layer', '1', '--epochs', '1'])
    from kfac_pytorch_tpu_torch import train_imagenet
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_imagenet.main(['--model', 'resnet18', '--img-size', '32',
                             '--batch-size', '4', '--epochs', '1'])
    # the same calls run when the CPU is asked for
    state = training.init_train_state(model, tx, pre, sample, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pre.init()
    assert state.kfac_state.factors['128'].device.type == 'cpu'


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one: the wrappers
    must take the kernel path (which fails here) and never the plain
    version."""
    device = torch.device('cuda')
    dtype = torch.float32
    ndim = 4
    shape = (2, 5, 5, 3)

    def is_contiguous(self):
        return True

    def reshape(self, *shape):
        return _FakeCuda2D()


class _FakeCuda2D(_FakeCuda):
    ndim = 2
    shape = (50, 3)


class _UsedPlain(Exception):
    pass


def test_wrappers_never_fall_back(monkeypatch):
    def plain(*a, **k):
        raise _UsedPlain('plain version used for a non-CPU tensor')

    monkeypatch.setattr(ck, '_conv_a_plain', plain)
    monkeypatch.setattr(ck, '_stat_rows_plain', plain)
    monkeypatch.setattr(ck, '_ef_quantize_plain', plain)
    calls = [
        lambda x: ck.compute_a_conv(x, (3, 3), (1, 1), (1, 1), False),
        lambda x: ck.compute_g_conv(x, True),
        lambda x: ck.ef_quantize(x, x),
    ]
    for call in calls:
        with pytest.raises(Exception) as info:
            call(_FakeCuda())
        assert not isinstance(info.value, _UsedPlain)
    for call in calls:
        with pytest.raises(RuntimeError, match='no capture kernel'):
            call(torch.zeros((2, 5, 5, 3), device='meta'))


class _FakeCudaSeq:
    """A [BH, L, D] float32 CUDA tensor stand-in for the attention
    wrappers."""
    device = torch.device('cuda')
    dtype = torch.float32

    def __init__(self, *shape):
        self.shape = shape
        self.ndim = len(shape)

    def is_contiguous(self):
        return True


def test_attention_wrappers_never_fall_back(monkeypatch):
    def plain(*a, **k):
        raise _UsedPlain('plain version used for a non-CPU tensor')

    for name in ('_fwd_plain', '_bwd_dq_plain', '_bwd_dkv_plain'):
        monkeypatch.setattr(ak, name, plain)
    qkv = [_FakeCudaSeq(2, 8, 16) for _ in range(3)]
    rest = [_FakeCudaSeq(2, 8), _FakeCudaSeq(2, 8), _FakeCudaSeq(2, 8),
            _FakeCudaSeq(2, 8, 16)]
    calls = [lambda: ak.flash_fwd(*qkv, rest[0], (0, 0), 0.25, True),
             lambda: ak.flash_bwd_dq(*qkv, *rest, (0, 0), 0.25, True),
             lambda: ak.flash_bwd_dkv(*qkv, *rest, (0, 0), 0.25, True)]
    for call in calls:
        with pytest.raises(Exception) as info:
            call()
        assert not isinstance(info.value, _UsedPlain)
    meta = [torch.zeros((2, 8, 16), device='meta') for _ in range(3)]
    with pytest.raises(RuntimeError, match='no attention kernel'):
        ak.flash_fwd(*meta, torch.zeros((2, 8), device='meta'), (0, 0), 0.25,
                     True)


@pytest.mark.parametrize('trainer,model', [
    ('train_cifar', 'vgg16'), ('train_cifar', 'wrn-28-10'),
    ('train_imagenet', 'densenet201'), ('train_imagenet', 'inception-v4')])
def test_zoo_entry_points_raise_without_gpu(no_gpu, trainer, model):
    # the rest of the vision zoo: no GPU, no run (and no net built)
    import importlib
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{trainer}')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(['--model', model, '--epochs', '1', '--exclude-parts',
                  'ComputeInverse'])


@pytest.mark.parametrize('trainer,argv', [
    ('train_multi30k', ['--d-model', '16', '--d-inner', '32', '--n-layers',
                        '1', '--n-head', '2', '--batch-size', '8',
                        '--synthetic-size', '16', '--steps-per-epoch', '1']),
    ('train_squad', ['--steps-per-epoch', '1', '--synthetic-size', '16']),
    ('train_wikitext', ['--embed-dim', '8', '--hidden-dim', '8', '--bptt',
                        '4', '--synthetic-vocab', '16', '--synthetic-tokens',
                        '400', '--steps-per-epoch', '1',
                        '--kfac-update-freq', '1'])])
def test_sequence_entry_points_raise_without_gpu(no_gpu, trainer, argv):
    # the sequence trainers: no GPU, no run; the CPU, asked for, runs
    import importlib
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{trainer}')
    argv = argv + ['--epochs', '1']
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(argv)
    tr = mod.main(argv + ['--device', 'cpu'])
    assert tr.device.type == 'cpu' and tr.state.step == 1
    assert all(p.device.type == 'cpu'
               for p in tr.state.model.parameters())


def test_world_gt1_entry_points_raise_without_gpu(no_gpu, monkeypatch):
    from kfac_pytorch_tpu_torch import launch, train_cifar
    started = []
    monkeypatch.setattr(launch.subprocess, 'call',
                        lambda cmd: started.append(cmd) or 0)
    for args in (['--kfac-name', 'eigen'], ['--dist-backend', 'gloo']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            launch.main(['--nproc', '2', '--', 'train_cifar', *args])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cifar.main(['--num-devices', '2', '--epochs', '1'])
    # the LM's grid, the sequence trainers at world>1
    from kfac_pytorch_tpu_torch import train_lm, train_multi30k
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_lm.main(['--seq-devices', '2', '--epochs', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_multi30k.main(['--num-devices', '2', '--epochs', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        launch.main(['--nproc', '2', '--', 'train_lm', '--seq-devices', '2'])
    assert not started
    # the CPU, asked for: the LM's grid is its world, no --num-devices
    assert launch.main(['--nproc', '4', '--', 'train_lm', '--device', 'cpu',
                        '--data-devices', '2', '--seq-devices', '2']) == 0
    cmd = started.pop()
    assert '--num-devices' not in cmd and cmd[-1] == '2'
    # the CPU, asked for, launches torchrun with the world set
    assert launch.main(['--nproc', '2', '--', 'train_cifar', '--device',
                        'cpu']) == 0
    cmd, = started
    assert cmd[-2:] == ['--num-devices', '2']
    assert 'torch.distributed.run' in cmd and '--nproc_per_node' in cmd


@pytest.mark.parametrize('argv', [
    ['--kfac-autotune'], ['--trace', 'x'], ['--prom-file', 'x'],
    ['--tb-dir', 'x'], ['--step-deadline', '5'],
    ['--straggler-budget', '1'], ['--io-retries', '3'],
    ['--exclude-parts', 'ComputeInverse'], ['--num-devices', '2']],
    ids=lambda a: a[0])
def test_imagenet_unported_flags_raise(argv):
    from kfac_pytorch_tpu_torch import train_imagenet
    if argv[0] == '--io-retries':
        # ported: the JAX trainers' retry policy, that many retries
        args = train_imagenet.parse_args(['--device', 'cpu', *argv])
        train_imagenet.check_ported(args)
        assert train_imagenet.io_retry(args).attempts == 4
    elif argv[0] == '--exclude-parts':
        # ported: the phase ablation reaches KFAC
        args = train_imagenet.parse_args(['--device', 'cpu', *argv])
        train_imagenet.check_ported(args)
        pre = train_imagenet.kfac_for(args, 1)
        assert pre.exclude_compute_inverse
        assert not (pre.exclude_compute_factor
                    or pre.exclude_communicate_factor
                    or pre.exclude_communicate_inverse)
    elif argv[0] == '--num-devices':
        # ported: world>1 needs the launcher's process group
        with pytest.raises(ValueError, match='WORLD_SIZE=1'):
            train_imagenet.main(['--device', 'cpu', *argv])
    elif argv[0] == '--kfac-autotune':
        # ported: the online tuner (autotune.controller_from_args)
        args = train_imagenet.parse_args(['--device', 'cpu', *argv])
        train_imagenet.check_ported(args)
        assert args.kfac_autotune and all(
            name != 'kfac_autotune' for name, _, _ in train_imagenet.UNPORTED)
    elif argv[0] in ('--trace', '--prom-file', '--tb-dir'):
        # ported: the observability flags (obs.setup_trainer and the
        # TensorBoard writer, train_imagenet.observed)
        args = train_imagenet.parse_args(['--device', 'cpu', *argv])
        train_imagenet.check_ported(args)
        assert all(name != argv[0][2:].replace('-', '_')
                   for name, _, _ in train_imagenet.UNPORTED)
    else:
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            train_imagenet.main(['--device', 'cpu', *argv])


@pytest.mark.parametrize('argv,attrs', [
    (['--kfac-basis-update-freq', '4'], {'basis_update_freq': 4}),
    (['--kfac-warm-start'], {'warm_start_basis': True}),
    (['--kfac-stagger'], {'stagger': True}),
    (['--kfac-decomp-impl', 'subspace'], {'decomp_impl': 'subspace'}),
    (['--kfac-decomp-shard'], {'decomp_shard': True, 'stagger': True}),
    (['--kfac-comm-prefetch', '--kfac-name', 'eigen'],
     {'comm_prefetch': True}),
    (['--exclude-parts', 'ComputeFactor,CommunicateInverse'],
     {'exclude_compute_factor': True, 'exclude_communicate_inverse': True,
      'exclude_compute_inverse': False})],
    ids=lambda a: a[0] if isinstance(a, list) else None)
@pytest.mark.filterwarnings('ignore:warm_start_basis')
def test_imagenet_decomp_flags_reach_kfac(argv, attrs):
    # the decomposition-ladder flags (once in the list above) are ported:
    # the three trainers pass them to KFAC as the JAX trainers do
    from kfac_pytorch_tpu_torch import train_cifar, train_imagenet, train_lm
    for mod in (train_imagenet, train_cifar, train_lm):
        args = mod.parse_args(['--device', 'cpu', *argv])
        if mod is train_imagenet:
            train_imagenet.check_ported(args)
        pre = tkfac.get_kfac_module(args.kfac_name)(
            **train_imagenet.decomp_kwargs(args))
        for k, v in attrs.items():
            assert getattr(pre, k) == v, (mod.__name__, k)


_TINY = {'train_cifar': ['--model', 'resnet20', '--batch-size', '8'],
         'train_imagenet': ['--model', 'resnet18', '--img-size', '32',
                            '--batch-size', '4', '--synthetic-size', '8']}


@pytest.mark.parametrize('trainer', list(_TINY))
@pytest.mark.filterwarnings('ignore:ekfac variants')
def test_ekfac_reaches_kfac_in_both_trainers(trainer):
    # --kfac-name ekfac_dp builds an E-KFAC preconditioner with moments in
    # its state; --kfac-stagger with E-KFAC raises JAX's ValueError
    import importlib
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{trainer}')
    argv = ['--device', 'cpu', '--kfac-name', 'ekfac_dp', *_TINY[trainer]]
    tr = mod.Trainer(mod.parse_args(argv))
    assert tr.precond.variant == 'ekfac_dp' and tr.precond.ekfac
    assert set(tr.state.kfac_state.decomp) == {'evals', 'evecs', 'scales'}
    with pytest.raises(ValueError, match='stagger is not supported'):
        mod.Trainer(mod.parse_args(argv + ['--kfac-stagger']))
