"""The port's durability plane and elastic lane against the JAX package.

- ``training.world_change_rescale`` (and its ``WORLD_RESCALE`` line)
  equals JAX's over linear/sqrt/none, a global or a per-rank batch,
  shrink and grow, and raises JAX's errors;
- ``RetryPolicy``/``call_with_retry``/``resumable_iter`` under
  ``ManualClock`` sleep the same delays and give up where JAX's do, and
  ``Loader.epoch(retry=)`` replays the unfaulted batches;
- ``world.json`` written by either package reads alike in the other; a
  stale lineage raises ``StaleLineageError`` in the writer and in
  ``elastic_resume``;
- ``elastic_resume`` of a host-built world-2 checkpoint (the MLP of
  ``torch_dist_workers``, ``eigen_dp`` and ``eigen`` in comm_mode
  'inverse') into world 1 and world 4 gives every rank exactly the rows of
  JAX's ``reshard_kfac_state`` (``carry_decomp``) on the same inputs;
- ``save_checkpoint(block=False)`` commits no manifest before
  ``wait_for_checkpoints()``, snapshots before it returns, and re-raises
  its writer's error there;
- a lossy checkpoint restores into an fp32 run without its residual, and
  an fp32 one into a lossy run with a zero residual (the spec of
  ``tests/test_comm_precision.py``'s downgrade test), neither scanned past;
- ``store.manifest.verify_epoch`` and ``PosixStore.head`` agree with
  JAX's on a port checkpoint, intact and corrupted.
"""

import dataclasses
import json
import os
import random
import threading

import numpy as np
import pytest
import torch

import kfac_pytorch_tpu as jkfac
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import training as jtraining
from kfac_pytorch_tpu.resilience import retry as jretry
from kfac_pytorch_tpu.store import PosixStore as JPosixStore
from kfac_pytorch_tpu.store import manifest as jmanifest
from kfac_pytorch_tpu.utils import checkpoint as jckpt
import kfac_pytorch_tpu_torch as tkfac
from kfac_pytorch_tpu_torch import capture as tcapture
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import resilience as tres
from kfac_pytorch_tpu_torch import training
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.preconditioner import KFACState
from kfac_pytorch_tpu_torch.resilience import retry as tretry
from kfac_pytorch_tpu_torch.store import PosixStore
from kfac_pytorch_tpu_torch.store import manifest as tmanifest
from kfac_pytorch_tpu_torch.utils import checkpoint as tckpt

import torch_dist_workers as workers

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# world_change_rescale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('scaling', ['linear', 'sqrt', 'none'])
@pytest.mark.parametrize('batch', ['global', 'per_host'])
@pytest.mark.parametrize('worlds', [(4, 2), (2, 4), (3, 1)],
                         ids=lambda w: f'{w[0]}to{w[1]}')
def test_world_change_rescale_matches_jax(worlds, batch, scaling):
    kw = dict(lr=0.1, lr_scaling=scaling,
              **({'global_batch': 130} if batch == 'global'
                 else {'per_host_batch': 32}))
    got = training.world_change_rescale(*worlds, **kw)
    want = jtraining.world_change_rescale(*worlds, **kw)
    assert tuple(got) == tuple(want)
    assert got.log_line() == want.log_line()


@pytest.mark.parametrize('args,kw', [
    ((0, 2), dict(global_batch=8)), ((2, 1), {}),
    ((2, 1), dict(global_batch=8, per_host_batch=4)),
    ((2, 1), dict(per_host_batch=4, lr_scaling='cube'))],
    ids=['world0', 'neither', 'both', 'scaling'])
def test_world_change_rescale_errors_match_jax(args, kw):
    errs = []
    for fn in (training.world_change_rescale,
               jtraining.world_change_rescale):
        with pytest.raises(ValueError) as e:
            fn(*args, lr=0.1, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

def _flaky(fails):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise OSError(f'transient {len(calls)}')
        return len(calls)
    return fn


def _run_retry(pkg, fails, policy_kw):
    clock = pkg.ManualClock()
    policy = pkg.RetryPolicy(**policy_kw)
    try:
        out = pkg.call_with_retry(_flaky(fails), policy=policy, clock=clock,
                                  rng=random.Random(7))
    except OSError as e:
        out = ('raised', str(e))
    return out, clock.sleeps


@pytest.mark.parametrize('fails,policy', [
    (2, dict(attempts=4)), (9, dict(attempts=3)),
    (9, dict(attempts=6, base_delay=1.0, deadline=5.0)),
    (3, dict(attempts=5, jitter=0.0, max_delay=1.5))],
    ids=['recovers', 'gives_up', 'deadline', 'capped'])
def test_call_with_retry_matches_jax(fails, policy):
    assert _run_retry(tretry, fails, policy) == \
        _run_retry(jretry, fails, policy)


def _flaky_iter(fail_at, state):
    def make():
        def gen():
            for i in range(6):
                if i in fail_at and state.setdefault(i, 0) < 1:
                    state[i] += 1
                    raise OSError(f'producer died at {i}')
                yield i
        return gen()
    return make


def test_resumable_iter_matches_jax():
    for fail_at, attempts in (({2, 4}, 4), ({1}, 1)):
        outs = []
        for pkg in (tretry, jretry):
            clock, got = pkg.ManualClock(), []
            try:
                for x in pkg.resumable_iter(
                        _flaky_iter(fail_at, {}), clock=clock,
                        rng=random.Random(3),
                        policy=pkg.RetryPolicy(attempts=attempts)):
                    got.append(x)
            except OSError as e:
                got.append(str(e))
            outs.append((got, clock.sleeps))
        assert outs[0] == outs[1]


def test_loader_epoch_retry_replays_the_unfaulted_batches():
    x = np.random.RandomState(0).rand(12, 8, 8, 3).astype(np.float32)
    y = np.arange(12)
    calls = []

    def augment(rng, bx):
        calls.append(1)
        if len(calls) == 3:
            raise OSError('transient read')
        return tdata.augment_cifar(rng, bx)

    want = [b['input'] for b in tdata.Loader(
        x, y, 3, augment=tdata.augment_cifar, seed=1).epoch(prefetch_depth=0)]
    policy = tres.RetryPolicy(attempts=2, base_delay=0.0, jitter=0.0)
    with tdata.Loader(x, y, 3, augment=augment, seed=1).epoch(
            prefetch_depth=2, retry=policy) as it:
        got = [b['input'] for b in it]
    assert len(got) == len(want) == 4
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the world stamp and the lineage fence
# ---------------------------------------------------------------------------

def test_world_stamp_reads_alike_in_both_packages(tmp_path):
    a, b = tmp_path / 'a', tmp_path / 'b'
    tckpt.write_world_stamp(str(a), 2, gen=5, lineage=3)
    jckpt.write_world_stamp(str(b), 2, gen=5, lineage=3)
    assert (a / 'world.json').read_text() == (b / 'world.json').read_text()
    for d in (a, b):
        assert tckpt.read_world_stamp_info(str(d)) == \
            jckpt.read_world_stamp_info(str(d)) == \
            {'num_devices': 2, 'gen': 5, 'lineage': 3}
        assert tckpt.read_world_stamp(str(d)) == 2
    # a newer lineage moves it on; an older one raises in both writers
    tckpt.write_world_stamp(str(a), 4, lineage=4)
    assert jckpt.read_world_stamp(str(a)) == 4
    for pkg in (tckpt, jckpt):
        with pytest.raises(pkg.StaleLineageError):
            pkg.write_world_stamp(str(a), 1, lineage=2)
    assert json.loads((a / 'world.json').read_text()) == \
        {'num_devices': 4, 'lineage': 4}
    (b / 'world.json').write_text('{not json')
    assert tckpt.read_world_stamp_info(str(b)) is None


def test_elastic_resume_refuses_a_stale_lineage(tmp_path, monkeypatch):
    tckpt.write_world_stamp(str(tmp_path), 2, lineage=5)
    with pytest.raises(tckpt.StaleLineageError, match='lineage 5'):
        tres.elastic_resume(str(tmp_path), 3, None, None,
                            make_precond=None, lineage=4)
    monkeypatch.setenv(tres.ENV_LINEAGE, '4')
    with pytest.raises(tckpt.StaleLineageError):
        tres.elastic_resume(str(tmp_path), 3, None, None,
                            make_precond=None)


# ---------------------------------------------------------------------------
# elastic_resume against JAX's reshard_kfac_state
# ---------------------------------------------------------------------------

def _metas():
    tm = tcapture.collect_layer_meta(workers.MLP(), torch.zeros(2, 5))
    jm = {k: jcapture.LayerMeta(**dataclasses.asdict(m))
          for k, m in tm.items()}
    return tm, jm


def _kw(variant, world, pkg):
    kw = dict(variant=variant, num_devices=world,
              bucket_fn=workers.bucket_tiny)
    if variant == 'eigen':
        kw['comm_mode'] = 'inverse'
    if pkg is jkfac and world > 1:
        kw['axis_name'] = 'batch'
    return kw


def _pres(variant, world):
    tm, jm = _metas()
    t = tkfac.KFAC(**_kw(variant, world, tkfac))
    j = jkfac.KFAC(**_kw(variant, world, jkfac))
    t.setup(tm)
    j.setup(jm)
    return t, j


def _seeded_global(jpre, seed):
    rng = np.random.RandomState(seed)
    init = jpre.init()

    def fill(x):
        return np.asarray(rng.randn(*x.shape), np.float32)
    return init.replace(
        step=np.int32(7),
        factors={k: fill(v) for k, v in init.factors.items()},
        decomp={p: {k: fill(v) for k, v in tree.items()}
                for p, tree in init.decomp.items()})


def _rank_states(tpre, jstate):
    """The global JAX state as the port's per-rank states."""
    P = tpre.plan.num_devices
    out = []
    for r in range(P):
        def mine(x, decomposition=False):
            x = torch.from_numpy(np.array(x))
            if decomposition and tpre.comm_mode == 'inverse':
                return x
            per = x.shape[0] // P
            return x[r * per:(r + 1) * per]
        out.append(KFACState(
            step=int(jstate.step),
            factors={k: mine(v) for k, v in jstate.factors.items()},
            decomp={p: {k: mine(v, True) for k, v in tree.items()}
                    for p, tree in jstate.decomp.items()}))
    return out


@pytest.mark.parametrize('new_world', [1, 4])
@pytest.mark.parametrize('variant', ['eigen_dp', 'eigen'])
def test_elastic_resume_matches_jax_reshard(tmp_path, monkeypatch, variant,
                                            new_world):
    t_old, j_old = _pres(variant, 2)
    t_new, j_new = _pres(variant, new_world)
    jstate = _seeded_global(j_old, 11)
    want = _rank_states(t_new, jckpt.reshard_kfac_state(
        j_old, j_new, jstate, carry_decomp=True))

    def state_for(pre):
        torch.manual_seed(0)
        return training.init_train_state(workers.MLP(), training.sgd(0.1),
                                         pre, torch.zeros(2, 5), 'cpu')

    saved = state_for(t_old)
    saved = dataclasses.replace(saved, step=7, decomposed=True,
                                kfac_state=_rank_states(t_old, jstate))
    with torch.no_grad():
        for p in saved.model.parameters():
            p.add_(1.0)
    tckpt.save_checkpoint(str(tmp_path), 0, saved)
    tckpt.write_world_stamp(str(tmp_path), 2)

    def make_old(world):
        pre = tkfac.KFAC(**_kw(variant, world, tkfac))
        pre.setup(t_new.plan.metas)
        return pre

    for r in range(new_world):
        # rank r of the new world takes entry r
        monkeypatch.setattr(coll, 'axis_index', lambda group, r=r: r)
        worlds = []
        got, epoch, old_world = tres.elastic_resume(
            str(tmp_path), 3, t_new, state_for(t_new), make_precond=make_old,
            on_world_change=lambda o, n: worlds.append((o, n)))
        assert (epoch, old_world, worlds) == (0, 2, [(2, new_world)])
        assert got.step == 7 and got.decomposed
        k, w = got.kfac_state, want[r]
        assert k.step == 7 and k.comm_err is None
        for part in ('factors', 'decomp'):
            a, b = dict(_flat(getattr(k, part))), dict(_flat(getattr(w, part)))
            assert sorted(a) == sorted(b)
            for key in a:
                assert torch.equal(a[key], b[key]), (r, part, key)
        for name, p in got.model.named_parameters():
            assert torch.equal(p, saved.model.state_dict()[name])


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------

def _mlp_state(variant='eigen', comm_precision='fp32', fill=0.0):
    torch.manual_seed(0)
    pre = tkfac.KFAC(variant=variant, comm_precision=comm_precision,
                     bucket_fn=workers.bucket_tiny)
    pre.setup(_metas()[0])
    state = training.init_train_state(workers.MLP(), training.sgd(0.1), pre,
                                      torch.zeros(2, 5), 'cpu')
    kst = state.kfac_state
    kst.factors = {k: v + fill for k, v in kst.factors.items()}
    if kst.comm_err is not None:
        kst.comm_err = {k: v + 0.25 for k, v in kst.comm_err.items()}
    return pre, state


_REAL_PUT = PosixStore.put


def test_async_save_defers_manifest_until_durable(tmp_path, monkeypatch):
    _, state = _mlp_state(fill=1.0)
    gate = threading.Event()

    def slow_put(self, key, data):
        assert gate.wait(30)
        return _REAL_PUT(self, key, data)

    monkeypatch.setattr(PosixStore, 'put', slow_put)
    tckpt.save_checkpoint(str(tmp_path), 1, state, block=False)
    # the snapshot was taken before the call returned: the live state may
    # change at once
    with torch.no_grad():
        for v in state.kfac_state.factors.values():
            v.add_(5.0)
    manifest = tmp_path / 'checkpoint-1.manifest.json'
    assert not manifest.exists()
    assert tckpt.find_resume_epoch(str(tmp_path), 5) is None
    gate.set()
    tckpt.wait_for_checkpoints()
    assert manifest.exists()
    _, target = _mlp_state()
    restored = tckpt.restore_checkpoint(str(tmp_path), 1, target)
    for k, v in restored.kfac_state.factors.items():
        assert torch.equal(v, state.kfac_state.factors[k] - 5.0)


def test_async_save_error_raises_at_wait(tmp_path, monkeypatch):
    _, state = _mlp_state()

    def broken(self, key, data):
        raise OSError('disk gone')

    monkeypatch.setattr(PosixStore, 'put', broken)
    tckpt.save_checkpoint(str(tmp_path), 0, state, block=False)
    with pytest.raises(OSError, match='disk gone'):
        tckpt.wait_for_checkpoints()
    tckpt.wait_for_checkpoints()        # reported once
    assert not (tmp_path / 'checkpoint-0.manifest.json').exists()
    # a retry policy that outlasts the fault commits the epoch
    calls = []

    def flaky(self, key, data):
        calls.append(key)
        if len(calls) == 1:
            raise OSError('transient')
        return _REAL_PUT(self, key, data)

    monkeypatch.setattr(PosixStore, 'put', flaky)
    tckpt.save_checkpoint(str(tmp_path), 0, state, block=False,
                          retry=tres.RetryPolicy(attempts=2, base_delay=0.0))
    tckpt.wait_for_checkpoints()
    assert (tmp_path / 'checkpoint-0.manifest.json').exists()


# ---------------------------------------------------------------------------
# the residual across comm precisions
# ---------------------------------------------------------------------------

def test_lossy_checkpoint_restores_into_fp32_run(tmp_path):
    pre16, state16 = _mlp_state(comm_precision='bf16', fill=2.0)
    assert pre16.tracks_comm_err and state16.kfac_state.comm_err
    tckpt.save_checkpoint(str(tmp_path), 0, state16)
    _, fresh32 = _mlp_state()
    assert fresh32.kfac_state.comm_err is None
    restored, epoch = tckpt.auto_resume(str(tmp_path), 5, fresh32)
    assert epoch == 0 and restored.kfac_state.comm_err is None
    for k, v in state16.kfac_state.factors.items():
        assert torch.equal(restored.kfac_state.factors[k], v)


def test_fp32_checkpoint_restores_into_lossy_run(tmp_path):
    _, state32 = _mlp_state(fill=3.0)
    tckpt.save_checkpoint(str(tmp_path), 0, state32)
    pre16, fresh16 = _mlp_state(comm_precision='bf16', fill=2.0)
    restored, epoch = tckpt.auto_resume(str(tmp_path), 5, fresh16)
    assert epoch == 0
    zero = pre16.zero_comm_err('cpu')
    assert set(restored.kfac_state.comm_err) == set(zero)
    for k, v in zero.items():
        assert torch.equal(restored.kfac_state.comm_err[k], v)
    for k, v in state32.kfac_state.factors.items():
        assert torch.equal(restored.kfac_state.factors[k], v)


# ---------------------------------------------------------------------------
# verify_epoch and the store
# ---------------------------------------------------------------------------

def test_verify_epoch_and_head_match_jax(tmp_path):
    _, state = _mlp_state(fill=1.0)
    tckpt.save_checkpoint(str(tmp_path), 2, state)
    tstore, jstore = PosixStore(str(tmp_path)), JPosixStore(str(tmp_path))
    manifest = tmanifest.read_manifest(tstore, 2)
    assert tmanifest.verify_epoch(tstore, manifest) == \
        jmanifest.verify_epoch(jstore, manifest) == []
    key = tckpt.blob_key(2)
    th, jh = tstore.head(key), jstore.head(key)
    assert (th.generation, th.size) == (jh.generation, jh.size)
    assert tstore.head('nothing.pt') is None is jstore.head('nothing.pt')
    raw = bytearray((tmp_path / key).read_bytes())
    raw[-1] ^= 0xFF
    (tmp_path / key).write_bytes(bytes(raw))
    assert tmanifest.verify_epoch(tstore, manifest) == \
        jmanifest.verify_epoch(jstore, manifest) == [(key, 'hash_mismatch')]
    assert tstore.delete(key) and not tstore.delete(key)
    assert tmanifest.verify_epoch(tstore, manifest) == [(key, 'missing')]
    assert not os.path.exists(tmp_path / key)


# ---------------------------------------------------------------------------
# end to end: train_cifar checkpoints at world 2 and resumes at world 1
# ---------------------------------------------------------------------------

def test_train_cifar_world2_checkpoint_resumes_at_world1(tmp_path, capsys):
    from kfac_pytorch_tpu_torch import launch, train_cifar
    argv = ['--model', 'resnet20', '--batch-size', '16', '--steps-per-epoch',
            '2', '--epochs', '1', '--kfac-name', 'eigen',
            '--kfac-update-freq', '2', '--checkpoint-dir', str(tmp_path)]
    ranks = launch.spawn(workers.cifar_main_run, 2, args=(
        argv + ['--kfac-comm-precision', 'bf16'],), timeout=300)
    assert tckpt.read_world_stamp(str(tmp_path)) == 2
    # the lossy world-2 checkpoint into an fp32 world-1 run
    tr = train_cifar.main(argv + ['--device', 'cpu', '--resume'])
    out = capsys.readouterr().out
    assert 'RESHARDED from_world=2 to_world=1 step=2' in out
    assert ('WORLD_RESCALE from_world=2 to_world=1 global_batch=16 lr=0.1 '
            'lr_factor=1') in out
    st = tr.state
    assert st.step == ranks[0]['step'] == 2 and st.decomposed
    assert st.kfac_state.comm_err is None
    from kfac_pytorch_tpu_torch.train_imagenet import kfac_for
    old_pre = kfac_for(tr.args, 2)
    old_pre.setup(tr.precond.plan.metas)
    new, old = tr.precond.plan, old_pre.plan
    for i, meta in enumerate(new.metas):
        for side, d in ((0, meta.in_dim), (1, meta.out_dim)):
            bn, rn = new.layer_rows[i][2 * side:2 * side + 2]
            bo, ro = old.layer_rows[i][2 * side:2 * side + 2]
            per = old.buckets[bo].per_dev
            owner = ranks[ro // per]
            assert np.array_equal(
                st.kfac_state.factors[str(bn)][rn, :d, :d].numpy(),
                owner['factors'][str(bo)][ro % per, :d, :d])
            # comm_mode 'inverse': every rank holds the whole decomposition
            for part in ('evals', 'evecs'):
                assert np.array_equal(
                    st.kfac_state.decomp[part][str(bn)][rn].numpy(),
                    owner['decomp'][part][str(bo)][ro])


def test_replan_with_a_live_group_matches_the_host_replan():
    from kfac_pytorch_tpu_torch import launch
    ranks = launch.spawn(workers.live_replans, 2, timeout=120)
    pre = tkfac.KFAC(variant='eigen', num_devices=2,
                     bucket_fn=workers.bucket_tiny)
    pre.setup(_metas()[0])
    states = [workers.seeded_kfac_state(pre, r) for r in range(2)]
    want = [pre.replan(states, variant='eigen_dp')]
    want.append(pre.replan(want[0], num_devices=1))
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got, (want[0][r], want[1]))):
            assert dict(_flat(g['factors'])).keys() == \
                dict(_flat(w.factors)).keys()
            for part in ('factors', 'decomp'):
                gw = dict(_flat(getattr(w, part)))
                for key, x in _flat(g[part]):
                    assert np.array_equal(x, gw[key].numpy()), (r, i, key)
        assert got[1]['world'] == 1 and got[1]['group']


def test_train_cifar_preempted_and_resumed_is_bitwise_uninterrupted(
        tmp_path, monkeypatch):
    """SIGTERM mid-epoch 2: the run saves (tagged epoch 1) and exits; a
    ``--resume`` run skips the batches the state already took and ends
    bitwise where the uninterrupted run ends."""
    import signal
    from kfac_pytorch_tpu_torch import train_cifar
    argv = ['--device', 'cpu', '--model', 'resnet20', '--batch-size', '16',
            '--steps-per-epoch', '2', '--epochs', '3', '--kfac-update-freq',
            '2', '--kfac-capture-impl', 'auto']
    whole = train_cifar.main(argv + ['--checkpoint-dir', str(tmp_path / 'a')])
    step = train_cifar.Trainer.train_step

    def preempting(self, batch):
        if self.state.step == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self, batch)

    ck = ['--checkpoint-dir', str(tmp_path / 'b')]
    monkeypatch.setattr(train_cifar.Trainer, 'train_step', preempting)
    cut = train_cifar.main(argv + ck)
    monkeypatch.setattr(train_cifar.Trainer, 'train_step', step)
    assert cut.state.step == 5 and tckpt.find_resume_epoch(
        str(tmp_path / 'b'), 9) == 1
    resumed = train_cifar.main(argv + ck + ['--resume'])
    assert resumed.state.step == whole.state.step == 6
    a = dict(_flat({'model': resumed.state.model.state_dict(),
                    'opt': resumed.state.opt_state,
                    'kfac': tckpt.kfac_tree(resumed.state.kfac_state)}))
    b = dict(_flat({'model': whole.state.model.state_dict(),
                    'opt': whole.state.opt_state,
                    'kfac': tckpt.kfac_tree(whole.state.kfac_state)}))
    assert a.keys() == b.keys()
    for k in a:
        assert (torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                else a[k] == b[k]), k
