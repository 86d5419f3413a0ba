"""The port's checkpoints (``utils/checkpoint.py``, ``store/``) against
the contract of ``tests/test_checkpoint.py``: a bitwise round trip with
and without the K-FAC state, the downward resume scan, a torn commit
skipped, a corrupt committed epoch scanned past, retention, the
preemption guard, and a run through ``train_imagenet``'s trainer that
saves and restores mid-run and continues bit for bit. The JAX package's
own ``parse_manifest``/``verify_blob`` must accept what the port writes:
the on-disk manifest contract is the reference's.
"""

import json
import logging
import os
import signal

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.store import PosixStore as JaxPosixStore
from kfac_pytorch_tpu.store import manifest as jmanifest
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import nn as tknn
from kfac_pytorch_tpu_torch import train_imagenet, training
from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet
from kfac_pytorch_tpu_torch.store import manifest as tmanifest
from kfac_pytorch_tpu_torch.utils import checkpoint

torch.set_num_threads(2)


def _fresh_state():
    model = cifar_resnet._make(1)
    pre = tkfac.KFAC(variant='eigen_dp', lr=0.1, damping=0.003)
    tx = training.sgd(0.1, momentum=0.9, weight_decay=5e-4)
    sample = np.zeros((4, 16, 16, 3), np.float32)
    state = training.init_train_state(model, tx, pre, sample, device='cpu')
    return state, tx, pre


@pytest.fixture(scope='module')
def trained_state():
    state, tx, pre = _fresh_state()
    step = training.build_train_step(
        model=state.model, tx=tx, precond=pre,
        loss_fn=lambda out, b: F.cross_entropy(out, b['label']))
    r = np.random.RandomState(0)
    batch = {'input': torch.from_numpy(
        r.randn(4, 16, 16, 3).astype(np.float32)),
        'label': torch.tensor([0, 1, 2, 3])}
    state, _ = step(state, batch, lr=0.1, damping=0.003)
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif tree is not None:
        yield tree


def _assert_same_state(got, want):
    assert (got.step, got.decomposed) == (want.step, want.decomposed)
    for (k, a), (_, b) in zip(sorted(got.model.state_dict().items()),
                              sorted(want.model.state_dict().items())):
        assert torch.equal(a, b), k
    for a, b in zip(_leaves(got.opt_state), _leaves(want.opt_state)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    gk, wk = got.kfac_state, want.kfac_state
    assert gk.step == wk.step
    for part in ('factors', 'decomp', 'comm_err'):
        for a, b in zip(_leaves(getattr(gk, part)),
                        _leaves(getattr(wk, part))):
            assert torch.equal(a, b), part


def test_save_restore_roundtrip(tmp_path, trained_state):
    checkpoint.save_checkpoint(tmp_path, 3, trained_state)
    restored = checkpoint.restore_checkpoint(tmp_path, 3, _fresh_state()[0])
    assert restored.decomposed and restored.step == 1
    _assert_same_state(restored, trained_state)


def _health(values):
    from kfac_pytorch_tpu_torch.health import HealthState
    return HealthState(*[torch.tensor(v, dtype=torch.int32)
                         for v in values])


def test_health_counters_roundtrip(tmp_path, trained_state):
    """The guard's counters are saved and restored exactly."""
    import dataclasses
    state = dataclasses.replace(trained_state,
                                health=_health([1, 0, 2, 7, 3]))
    checkpoint.save_checkpoint(tmp_path, 2, state)
    restored = checkpoint.restore_checkpoint(tmp_path, 2, _fresh_state()[0])
    assert [(int(t), t.dtype) for t in restored.health.tensors()] == \
        [(v, torch.int32) for v in (1, 0, 2, 7, 3)]
    _assert_same_state(restored, state)


def test_blob_from_before_the_guard_restores(tmp_path):
    """A blob as the port wrote it before the health guard (no ``health``,
    ``MultiSteps``' counters as Python ints) restores with zeroed health
    counters and its counters in the optimizer's tensors."""
    import dataclasses
    import io
    model = cifar_resnet._make(1)
    pre = tkfac.KFAC(variant='eigen_dp', lr=0.1, damping=0.003)
    tx = training.MultiSteps(training.sgd(0.1, momentum=0.9), 2)
    sample = np.zeros((4, 16, 16, 3), np.float32)
    state = training.init_train_state(model, tx, pre, sample, device='cpu')
    checkpoint.save_checkpoint(tmp_path, 0, state)
    blob = torch.load(tmp_path / 'checkpoint-0.pt', weights_only=True)
    del blob['health']
    blob['opt_state']['mini_step'] = 1
    blob['opt_state']['gradient_step'] = 3
    buf = io.BytesIO()
    torch.save(blob, buf)
    store = checkpoint._store(tmp_path)
    store.put('checkpoint-0.pt', buf.getvalue())
    store.put(tmanifest.manifest_key(0), tmanifest.encode_manifest(
        tmanifest.build_manifest(0, checkpoint.KIND,
                                 {'checkpoint-0.pt': buf.getvalue()})))
    target = dataclasses.replace(state, health=_health([1, 1, 1, 1, 1]))
    restored = checkpoint.restore_checkpoint(tmp_path, 0, target)
    assert [int(t) for t in restored.health.tensors()] == [0] * 5
    assert int(restored.opt_state['mini_step']) == 1
    assert int(restored.opt_state['gradient_step']) == 3
    assert torch.is_tensor(restored.opt_state['mini_step'])


def test_restore_without_kfac_state(tmp_path, trained_state):
    # the reference's behaviour: the K-FAC state is not checkpointed, the
    # factors start again from the identity
    checkpoint.save_checkpoint(tmp_path, 1, trained_state,
                               include_kfac=False)
    target, _, _ = _fresh_state()
    fresh_factors = {k: v.clone() for k, v in
                     target.kfac_state.factors.items()}
    restored = checkpoint.restore_checkpoint(tmp_path, 1, target)
    assert restored.step == 1 and not restored.decomposed
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, trained_state.model.state_dict()[k]), k
    for k, v in restored.kfac_state.factors.items():
        assert torch.equal(v, fresh_factors[k])


def test_find_resume_epoch_scans_downward(tmp_path, trained_state):
    assert checkpoint.find_resume_epoch(tmp_path, 10) is None
    checkpoint.save_checkpoint(tmp_path, 2, trained_state)
    checkpoint.save_checkpoint(tmp_path, 5, trained_state)
    assert checkpoint.find_resume_epoch(tmp_path, 10) == 5
    assert checkpoint.find_resume_epoch(tmp_path, 4) == 2
    assert checkpoint.find_resume_epoch(tmp_path, 1) is None


def test_torn_commit_is_skipped(tmp_path, trained_state, caplog):
    checkpoint.save_checkpoint(tmp_path, 2, trained_state)
    # the writer died between the blob and the manifest of epoch 3
    (tmp_path / 'checkpoint-3.pt').write_bytes(b'torn')
    # a write in flight leaves a temp file that is never an object
    (tmp_path / 'checkpoint-4.pt.tmp-123').write_bytes(b'partial')
    with caplog.at_level(logging.WARNING):
        assert checkpoint.find_resume_epoch(tmp_path, 10) == 2
    assert any('checkpoint-3' in r.getMessage() and 'torn' in r.getMessage()
               for r in caplog.records)
    restored, epoch = checkpoint.auto_resume(tmp_path, 10,
                                             _fresh_state()[0])
    assert epoch == 2
    _assert_same_state(restored, trained_state)


def test_corrupt_manifested_epoch_scans_down(tmp_path, trained_state,
                                             caplog):
    checkpoint.save_checkpoint(tmp_path, 0, trained_state)
    checkpoint.save_checkpoint(tmp_path, 1, trained_state)
    raw = bytearray((tmp_path / 'checkpoint-1.pt').read_bytes())
    raw[-1] ^= 0xFF   # same length: only the content hash sees it
    (tmp_path / 'checkpoint-1.pt').write_bytes(bytes(raw))
    assert checkpoint.find_resume_epoch(tmp_path, 10) == 1
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore_checkpoint(tmp_path, 1, _fresh_state()[0])
    target = _fresh_state()[0]
    with caplog.at_level(logging.WARNING):
        restored, epoch = checkpoint.auto_resume(tmp_path, 10, target)
    assert epoch == 0
    _assert_same_state(restored, trained_state)
    assert any('ckpt: corrupt blob key=checkpoint-1.pt epoch=1 '
               'reason=hash_mismatch' in r.getMessage()
               for r in caplog.records)


def test_structure_mismatch_leaves_target_untouched(tmp_path,
                                                     trained_state):
    checkpoint.save_checkpoint(tmp_path, 0, trained_state)
    model = cifar_resnet._make(2)   # another depth: other names
    tx = training.sgd(0.1, momentum=0.9)
    pre = tkfac.KFAC(variant='eigen_dp')
    target = training.init_train_state(
        model, tx, pre, np.zeros((4, 16, 16, 3), np.float32), device='cpu')
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert checkpoint.auto_resume(tmp_path, 5, target) == (None, None)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_prune_checkpoints(tmp_path, trained_state):
    for e in (0, 1, 2, 10):
        checkpoint.save_checkpoint(tmp_path, e, trained_state)
    (tmp_path / 'checkpoint-11.pt.tmp-7').write_bytes(b'x')
    (tmp_path / 'other-file').write_text('x')
    checkpoint.prune_checkpoints(str(tmp_path), None)
    checkpoint.prune_checkpoints(str(tmp_path), 0)
    assert len(os.listdir(tmp_path)) == 10
    checkpoint.prune_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == [
        'checkpoint-10.manifest.json', 'checkpoint-10.pt',
        'checkpoint-11.pt.tmp-7', 'checkpoint-2.manifest.json',
        'checkpoint-2.pt', 'other-file']
    assert checkpoint.find_resume_epoch(tmp_path, 20) == 10


def test_jax_package_accepts_the_port_manifest(tmp_path, trained_state):
    checkpoint.save_checkpoint(tmp_path, 6, trained_state)
    raw = (tmp_path / 'checkpoint-6.manifest.json').read_bytes()
    manifest = jmanifest.parse_manifest(raw)
    assert manifest is not None and manifest['epoch'] == 6
    assert manifest['kind'] == checkpoint.KIND
    store = JaxPosixStore(str(tmp_path))
    assert jmanifest.manifest_epochs(store) == {
        6: 'checkpoint-6.manifest.json'}
    for key, spec in manifest['blobs'].items():
        assert jmanifest.verify_blob(store, key, spec) is None
    assert jmanifest.verify_epoch(store, manifest) == []
    # the encoding is the JAX package's, byte for byte
    assert jmanifest.encode_manifest(manifest) == raw
    assert tmanifest.encode_manifest(json.loads(raw)) == raw


def test_preemption_guard_uninstall():
    before = signal.getsignal(signal.SIGTERM)
    g1 = checkpoint.PreemptionGuard()
    assert signal.getsignal(signal.SIGTERM) == g1._handler
    g2 = checkpoint.PreemptionGuard()
    g2.uninstall()
    assert signal.getsignal(signal.SIGTERM) == g1._handler
    g1.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    g1.uninstall()   # idempotent
    assert signal.getsignal(signal.SIGTERM) == before


# -- through train_imagenet's trainer at a tiny size ------------------------

class _Tiny(torch.nn.Module):
    """The ImageNet ResNet's stem and one stride-2 Bottleneck, narrow, in
    ``dtype`` (the trainer's bf16)."""
    input_layout = 'NHWC'

    def __init__(self, num_classes, dtype):
        super().__init__()
        self.conv1 = tknn.Conv2d(3, 8, 7, stride=2, padding=3, bias=False,
                                 compute_dtype=dtype)
        self.bn1 = cifar_resnet.BatchNorm2d(8, dtype=dtype)
        self.layer1_0 = imagenet_resnet.Bottleneck(8, 4, 2, True,
                                                   dtype=dtype)
        self.fc = tknn.Linear(16, num_classes, compute_dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.fc(self.layer1_0(x).mean(dim=(2, 3)))


@pytest.fixture
def tiny_models(monkeypatch):
    def get_model(name, seed=0, num_classes=1000, dtype=None):
        return cifar_resnet.init_weights(_Tiny(num_classes, dtype), seed)
    monkeypatch.setattr(train_imagenet.models, 'get_model', get_model)


def _args(ckpt, *extra):
    return train_imagenet.parse_args(
        ['--device', 'cpu', '--img-size', '16', '--batch-size', '4',
         '--synthetic-size', '32', '--checkpoint-format', str(ckpt),
         *extra])


@pytest.mark.parametrize('bpa', [1, 3])
def test_trainer_resume_is_bitwise(tmp_path, tiny_models, bpa):
    """4 steps, against 2 steps, a save, a restore into a fresh trainer
    and 2 more steps: the same bits (with 3 batches accumulated the save
    falls between two inner updates, the accumulator half full)."""
    extra = ['--batches-per-allreduce', str(bpa)]
    whole = train_imagenet.Trainer(_args(tmp_path, *extra))
    batches = list(whole.train_loader.epoch())[:4]
    for b in batches:
        whole.train_step(b)
    first = train_imagenet.Trainer(_args(tmp_path, *extra))
    for b in batches[:2]:
        first.train_step(b)
    first.save(0)
    resumed = train_imagenet.Trainer(_args(tmp_path, *extra,
                                           '--epochs', '3'))
    assert resumed.resume() == 1
    assert resumed.state.step == 2
    for b in batches[2:]:
        resumed.train_step(b)
    _assert_same_state(resumed.state, whole.state)


def test_trainer_preemption_saves_exits_and_resumes(tmp_path, tiny_models,
                                                    monkeypatch, capsys):
    """SIGTERM in epoch 1: the trainer saves checkpoint-0, returns and
    puts the previous handler back; run again, it resumes from it."""
    before = signal.getsignal(signal.SIGTERM)
    real_step = train_imagenet.Trainer.train_step

    def step(self, batch):
        if self.state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_step(self, batch)

    monkeypatch.setattr(train_imagenet.Trainer, 'train_step', step)
    argv = ['--device', 'cpu', '--img-size', '16', '--batch-size', '4',
            '--synthetic-size', '32', '--steps-per-epoch', '2', '--epochs',
            '3', '--checkpoint-format', str(tmp_path)]
    train_imagenet.main(argv)
    out = capsys.readouterr().out
    assert 'preempted in epoch 1 (step 4)' in out, out
    assert signal.getsignal(signal.SIGTERM) == before
    assert checkpoint.find_resume_epoch(tmp_path, 10) == 0
    monkeypatch.setattr(train_imagenet.Trainer, 'train_step', real_step)
    train_imagenet.main(argv)
    out = capsys.readouterr().out
    assert 'resumed from checkpoint-0 (step 4)' in out, out
    assert 'epoch 2:' in out and checkpoint.find_resume_epoch(
        tmp_path, 10) == 2
