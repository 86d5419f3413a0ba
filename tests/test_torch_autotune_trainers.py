"""The control loop in the port's trainers, on the CPU.

- Every trainer takes ``--kfac-autotune`` (the JAX trainers' help) and
  wires its tuner as its JAX counterpart does: ``obs.setup_trainer(
  tuner=)``, ``build_train_step(autotune=)``, the monitor's
  ``quality_signal`` late-bound as its quality gate; the registry exports
  its knob gauges. ``train_imagenet`` hands it the perf model's block on
  ResNet-50 at its batch only; a world-changing resume proposes
  ``'elastic'`` to the arbiter.
- ``train_cifar --device cpu --kfac-autotune --trace`` on an injected
  clock (a step's time falls with the cadence) for a few windows: the
  decision log, ``adopted-knobs.json``, the final knobs and the epoch
  line's counters agree.
- ``train_cifar`` refuses ``--step-deadline`` and ``--straggler-budget``
  (NotImplementedError naming ROADMAP slice G), as ``train_imagenet``
  does.
- At world=2 over gloo: a tuner's committed ``comm_mode`` switch (there
  and back) and a ``comm_precision`` step onto the bf16 wire (K3's plain
  version) are applied at the step boundary, bit for bit as the direct
  ``KFAC.replan`` and wire change, with one invalidation a commit; the
  carried decomposition is a rank's slice of the full table (inverse ->
  pred) and the ranks' rows in rank order (pred -> inverse).
- At world=2 over gloo, tuners whose ranks measure different times or
  health counters take the same decisions (the slowest rank's window,
  the largest counter), and one decision log is written.

No case compiles a JAX step.
"""

import argparse
import importlib
import json
import os
import re

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import autotune, launch, obs, training
from kfac_pytorch_tpu_torch import train_imagenet
from kfac_pytorch_tpu_torch.utils.metrics import HealthMonitor

import torch_dist_workers as workers
from test_torch_obs_trainers import ARGV, _clean_process_state  # noqa: F401
from test_torch_obs_trainers import tiny_imagenet  # noqa: F401

torch.set_num_threads(2)

#: the JAX trainer whose --kfac-autotune help each port trainer gives
JAX_HELP = {'train_cifar': 'examples/cifar10_resnet.py',
            'train_imagenet': 'examples/imagenet_resnet.py',
            'train_lm': 'examples/longcontext_lm.py',
            'train_multi30k': 'examples/multi30k_transformer.py',
            'train_squad': 'examples/squad_bert.py',
            'train_wikitext': 'examples/wikitext_rnn.py'}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_help(path):
    """The help string of ``--kfac-autotune`` in a JAX trainer's source."""
    src = open(os.path.join(ROOT, path)).read()
    m = re.search(r"'--kfac-autotune'.*?help=((?:'[^']*'\s*)+)\)", src,
                  re.S)
    return ''.join(re.findall(r"'([^']*)'", m.group(1)))


@pytest.mark.parametrize('trainer', list(ARGV))
def test_every_trainer_wires_its_tuner(trainer, tmp_path, tiny_imagenet,
                                       monkeypatch):
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{trainer}')
    # the flag, with the JAX trainer's help
    text = _jax_help(JAX_HELP[trainer])
    helps, add = [], argparse.ArgumentParser.add_argument

    def add_argument(self, *a, **kw):
        if '--kfac-autotune' in a:
            helps.append(kw.get('help'))
        return add(self, *a, **kw)
    monkeypatch.setattr(argparse.ArgumentParser, 'add_argument',
                        add_argument)
    assert mod.parse_args(ARGV[trainer] + ['--kfac-autotune']).kfac_autotune
    monkeypatch.setattr(argparse.ArgumentParser, 'add_argument', add)
    assert helps == [text]
    seen = {}
    setup, build = obs.setup_trainer, training.build_train_step

    def setup_trainer(**kw):
        seen['setup'] = kw.get('tuner')
        return setup(**kw)

    def build_train_step(*a, **kw):
        seen['step'] = kw.get('autotune')
        return build(*a, **kw)
    monkeypatch.setattr(obs, 'setup_trainer', setup_trainer)
    monkeypatch.setattr(training, 'build_train_step', build_train_step)
    argv = ARGV[trainer] + ['--epochs', '1', '--steps-per-epoch', '2',
                            '--kfac-update-freq', '2', '--kfac-autotune',
                            '--log-dir', str(tmp_path / 'logs'),
                            '--trace', str(tmp_path / 'trace')]
    if trainer == 'train_imagenet':
        argv += ['--checkpoint-format', str(tmp_path / 'ckpt')]
    tr = mod.main(argv)
    tuner = tr.tuner
    assert isinstance(tuner, autotune.KnobController)
    assert seen['setup'] is tuner and seen['step'] is tuner
    assert tuner.precond is tr.precond and tuner.variant == 'eigen_dp'
    assert tuner.platform == 'cpu' and tuner.predicted is None
    gate = tuner.quality_gate
    assert gate.__func__ is HealthMonitor.quality_signal
    assert isinstance(gate.__self__, HealthMonitor)
    assert tuner._step == 1           # the second step's tick recorded
    rows = [json.loads(ln) for ln in open(tmp_path / 'trace' /
                                          'metrics.jsonl')]
    assert rows[-1]['metrics']['autotune/kfac_update_freq'] == 2
    assert rows[-1]['metrics']['autotune/commits'] == 0
    # without the flag, no tuner
    off = mod.parse_args(ARGV[trainer])
    assert not off.kfac_autotune


def test_imagenet_gates_on_its_modeled_workload(monkeypatch):
    args = train_imagenet.parse_args(['--device', 'cpu', '--kfac-autotune'])
    block = train_imagenet.predicted_for(args)
    assert block['predicted_not_measured'] and 'error' not in block
    assert block['chip']['kind'].startswith('NVIDIA H100')
    for other in (['--model', 'resnet18'], ['--batch-size', '64']):
        assert train_imagenet.predicted_for(train_imagenet.parse_args(
            ['--device', 'cpu'] + other)) is None

    class _Tr:
        precond = workers.KFAC(variant='eigen_dp')
        log = None
    tuner = train_imagenet.tuner_for(_Tr, args, block)
    assert tuner.predicted is block and tuner.platform is None
    args.kfac_autotune = False
    assert train_imagenet.tuner_for(_Tr, args, block) is None


def test_world_change_resume_proposes_elastic(monkeypatch):
    pre = workers.KFAC(variant='eigen_dp')
    said = []

    class _Tr:
        args = train_imagenet.parse_args(['--device', 'cpu'])
        precond, state, io_retry, world = pre, None, None, 1

        def say(self, line):
            said.append(line)

    def elastic_resume(base, epochs, precond, state, make_precond, retry,
                       on_world_change):
        on_world_change(2, 1)
        return None, None, None
    monkeypatch.setattr(train_imagenet.resilience, 'elastic_resume',
                        elastic_resume)
    assert train_imagenet.resume_from(_Tr(), 'unused') is None
    rescale = training.world_change_rescale(
        2, 1, lr=_Tr.args.base_lr, global_batch=_Tr.args.batch_size)
    assert autotune.arbiter_for(pre).records == [rescale._asdict()]
    assert said == [rescale.log_line()]


def test_train_cifar_refuses_the_unported_flags():
    from kfac_pytorch_tpu_torch import train_cifar
    for flag, value in (('--step-deadline', '5'),
                        ('--straggler-budget', '1')):
        args = train_cifar.parse_args(['--device', 'cpu', flag, value])
        assert getattr(args, flag[2:].replace('-', '_')) == float(value)
        with pytest.raises(NotImplementedError, match='ROADMAP.*slice G'):
            train_cifar.main(['--device', 'cpu', flag, value])
    # the JAX defaults: off
    args = train_cifar.parse_args(['--device', 'cpu'])
    assert (args.step_deadline, args.straggler_budget) == (0, 0)


def test_train_cifar_autotune_run(tmp_path, monkeypatch, capsys):
    """A few windows of ``train_cifar --kfac-autotune`` (the narrow net of
    ``test_torch_checkpoint``) on an injected clock: a step costs 0.01 s +
    0.05 s over the cadence + 0.004 s times it, so 2 -> 4 commits and the
    moves from 4 revert. The decisions, the adopted knobs, the preconditioner's
    final knobs and the epoch line's counters agree."""
    from kfac_pytorch_tpu_torch import train_cifar
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from test_torch_checkpoint import _Tiny
    monkeypatch.setattr(
        train_cifar.models, 'get_model',
        lambda name, num_classes, seed: cifar_resnet.init_weights(
            _Tiny(num_classes, None), seed))
    made = []
    real = autotune.controller_from_args

    def controller_from_args(precond, **kw):
        ctl = real(precond, **kw)
        now = [0.0]

        def clock():
            f = precond.kfac_update_freq
            now[0] += 0.01 + 0.05 / f + 0.004 * f
            return now[0]
        ctl.clock, ctl.window, ctl.dwell_windows = clock, 3, 1
        made.append(ctl)
        return ctl
    monkeypatch.setattr(autotune, 'controller_from_args',
                        controller_from_args)
    trace = tmp_path / 'trace'
    tr = train_cifar.main(ARGV['train_cifar'] + [
        '--epochs', '1', '--steps-per-epoch', '44', '--kfac-update-freq',
        '2', '--kfac-capture-impl', 'pallas', '--kfac-decomp-impl', 'xla',
        '--kfac-autotune', '--trace', str(trace), '--log-dir',
        str(tmp_path / 'logs')])
    ctl, = made
    assert tr.tuner is ctl and ctl.windows >= 8
    decisions = [json.loads(ln) for ln in
                 open(trace / 'autotune-decisions.jsonl')]
    assert decisions == list(ctl.decisions)
    moves = [(d['kind'], d['knob'], d['frm'], d['to']) for d in decisions
             if d['kind'] in ('commit', 'revert')]
    assert moves[0] == ('commit', 'kfac_update_freq', 2, 4)
    assert ('revert', 'kfac_update_freq', 8, 4) in moves
    assert all(m[0] == 'revert' for m in moves[1:])
    # every rung of the ladder was probed and came back
    probed = {d['knob'] for d in decisions if d['kind'] == 'probe'}
    assert probed == {'kfac_update_freq', 'fac_update_freq', 'decomp_impl',
                      'capture_impl'}
    # the knobs in force: the last movement, the adopted snapshot and the
    # preconditioner agree
    knobs = autotune._capture(tr.precond)
    assert knobs[moves[-1][1]] == moves[-1][3]
    assert knobs['kfac_update_freq'] == 4
    adopted = json.load(open(trace / 'adopted-knobs.json'))
    assert adopted == {flag: knobs[k] for k, flag in
                       autotune.ADOPTED_KNOB_FLAGS.items()
                       if knobs[k] is not None}
    assert adopted['kfac_capture_impl'] == 'pallas'
    # the epoch line's resilience suffix counts them
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('epoch 0:')][-1]
    counts = dict(re.findall(r'(autotune_\w+)=(\d+)', line))
    assert counts == {k: str(v) for k, v in ctl.counts().items() if v}
    assert counts['autotune_commits'] == '1'


def test_world2_knob_commits_apply_at_the_step_boundary():
    runs = launch.spawn(workers.autotune_switch_routes, 2, timeout=300)
    for rank, out in enumerate(runs):
        tuner, direct = out['tuner'], out['direct']
        for i, (a, b) in enumerate(zip(tuner, direct)):
            assert a['loss'] == b['loss'], (rank, i)
            assert (a['comm_mode'], a['comm_precision']) == \
                (b['comm_mode'], b['comm_precision'])
            for part in ('params', 'factors'):
                for k in b[part]:
                    assert np.array_equal(a[part][k], b[part][k]), \
                        (rank, i, part, k)
            for p in b['decomp']:
                for k in b['decomp'][p]:
                    assert np.array_equal(a['decomp'][p][k],
                                          b['decomp'][p][k]), (rank, i, p)
            assert (a['comm_err'] is None) == (b['comm_err'] is None)
            if a['comm_err'] is not None:
                for k in a['comm_err']:
                    assert np.array_equal(a['comm_err'][k],
                                          b['comm_err'][k])
        # the commits: the comm-mode switches queue their replan, which
        # the next step applies without firing the invalidators again;
        # one invalidation a commit
        moves = workers.AUTOTUNE_MOVES
        assert [a['pending'] for a in tuner] == [
            {'comm_mode': moves[i][1], '_invalidate': False}
            if i in moves and moves[i][0] == 'comm_mode' else None
            for i in range(workers.AUTOTUNE_STEPS)]
        assert [a['fired'] for a in tuner] == [0, 0, 0, 1, 1, 2, 2, 3, 3]
        assert [a['comm_mode'] for a in tuner] == \
            ['inverse'] * 3 + ['pred'] * 4 + ['inverse'] * 2
        # the wire step: a residual from then on, K3's plain version
        # running on the statistics steps after it and never before
        assert [a['comm_err'] is not None for a in tuner] == \
            [False] * 5 + [True] * 4
        assert tuner[4]['k3_calls'] == 0 < tuner[-1]['k3_calls']
    # the carried decomposition against the tables before the switch:
    # inverse -> pred keeps rank r's rows [r*per, (r+1)*per) of the full
    # table, pred -> inverse gathers the ranks' rows in rank order
    moved = [i for i, (knob, _) in workers.AUTOTUNE_MOVES.items()
             if knob == 'comm_mode']
    for i in moved:
        to = workers.AUTOTUNE_MOVES[i][1]
        for rank, out in enumerate(runs):
            c = out['direct'][i]['carried']
            for part, tree in c['before'].items():
                for k, v in tree.items():
                    per, after = c['per'][k], c['after'][part][k]
                    if to == 'pred':
                        assert v.shape[0] == 2 * per
                        want = v[rank * per:(rank + 1) * per]
                    else:
                        want = np.concatenate(
                            [o['direct'][i]['carried']['before'][part][k]
                             for o in runs])
                    assert after.shape == want.shape, (i, rank, part, k)
                    assert np.array_equal(after, want), (i, rank, part, k)
    # the ranks agree
    assert runs[0]['tuner'][-1]['loss'] == runs[1]['tuner'][-1]['loss']
    for k, v in runs[0]['tuner'][-1]['params'].items():
        assert np.array_equal(v, runs[1]['tuner'][-1]['params'][k])


def test_world2_tuners_agree_on_rank_dependent_feeds(tmp_path):
    runs = launch.spawn(workers.autotune_ranks_agree, 2,
                        args=(str(tmp_path),), timeout=120)
    for case in ('time', 'quality'):
        a, b = runs[0][case], runs[1][case]
        assert a['knobs'] == b['knobs'] == [20, 5] + [10] * 4, case
        assert a['decisions'] == b['decisions'], case
        kinds = [d['kind'] for d in a['decisions']]
        # rank 0 alone would have committed the doubled cadence
        assert 'commit' not in kinds, case
    # the slowest rank's times: rank 1's baseline and probe windows
    rev = [d for d in runs[0]['time']['decisions'] if d['kind'] == 'revert']
    assert rev[0]['baseline_s'] == 1.0 + 0.001
    assert rev[0]['probe_s'] == 1.0 * 0.98 + 0.001
    # the largest counter: rank 1's rise vetoes the probe on both ranks
    veto = [d for d in runs[0]['quality']['decisions']
            if d['kind'] == 'veto']
    assert [v['reason'] for v in veto] == ['quality']
    # one writer: the log holds each decision once
    assert runs[0]['time']['log'] == runs[1]['time']['log'] == \
        runs[0]['time']['decisions']
