"""The observability of the port's six trainers on the CPU, and the
profiler ranges of the K-FAC step.

- Each trainer at a tiny size with ``--log-dir``, ``--trace``,
  ``--prom-file`` and ``--tb-dir``: the run log exists and its epoch
  line parses with the JAX trainers' own reader (``scripts/parse_logs``)
  in the JAX trainer's format (`` kfac_phase_ms=`` where the JAX trainer
  has ``PhaseTimers``: CIFAR and ImageNet); the trace's ``kfac.dispatch``
  spans (and ``kfac.step`` spans, CIFAR and ImageNet) carry each step's
  ``step_fn.last_phases`` in the exclude_parts taxonomy, step by step;
  the Prometheus and JSONL exports parse; the TensorBoard file holds the
  JAX trainer's scalars.
- The flags left in ``UNPORTED`` still raise, naming their items
  (``--kfac-autotune`` is accepted since the control loop's slice).
- Every profiler range the port opens is named after a
  ``jax.named_scope`` of the JAX package, and a CPU ``torch.profiler``
  run of an ``eigen_dp`` step opens ComputeFactor, ComputeInverse and
  Precondition on a decomposition step and no ComputeInverse on a plain
  one.
- The LM trainer's guard-skip repair: a NaN loss at the second step is
  skipped, counted on the epoch line, and training goes on.

No case compiles a JAX step.
"""

import glob
import json
import logging
import os
import re

import pytest
import torch

from kfac_pytorch_tpu.utils import runlog as jrunlog
from kfac_pytorch_tpu_torch import obs as tobs
from kfac_pytorch_tpu_torch import training
from kfac_pytorch_tpu_torch.obs.trace import taxonomy_phases
from kfac_pytorch_tpu_torch.utils import runlog as trunlog
from kfac_pytorch_tpu_torch.utils import summary as tsummary
from scripts import parse_logs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ['--device', 'cpu']
ARGV = {
    'train_cifar': CPU + ['--model', 'resnet20', '--batch-size', '8',
                          '--val-batch-size', '64'],
    'train_imagenet': CPU + ['--img-size', '16', '--batch-size', '4',
                             '--synthetic-size', '32'],
    'train_lm': CPU + ['--seq-len', '32', '--n-layer', '1', '--d-model',
                       '32', '--n-head', '4', '--synthetic-vocab', '40'],
    'train_multi30k': CPU + ['--d-model', '16', '--d-inner', '32',
                             '--n-layers', '1', '--n-head', '2', '--max-len',
                             '12', '--batch-size', '8', '--synthetic-vocab',
                             '40', '--synthetic-size', '64', '--dropout',
                             '0'],
    'train_squad': CPU + ['--batch-size', '4', '--max-seq-length', '24',
                          '--synthetic-size', '64', '--warmup-frac', '0.05'],
    'train_wikitext': CPU + ['--embed-dim', '16', '--hidden-dim', '16',
                             '--bptt', '8', '--batch-size', '4',
                             '--synthetic-vocab', '30', '--synthetic-tokens',
                             '2000', '--dropout', '0'],
}
#: the JAX trainers that wire PhaseTimers (kfac.step spans, the
#: kfac_phase_ms suffix, the step_seconds histogram, log_epoch_scalars)
TIMED = ('train_cifar', 'train_imagenet')
TB_TAGS = {
    'train_cifar': {'train/loss', 'train/lr', 'val/loss', 'val/accuracy'},
    'train_imagenet': {'train/loss', 'train/lr', 'val/loss', 'val/accuracy'},
    'train_lm': {'train/ppl', 'val/ppl'},
    'train_multi30k': {'train/loss', 'val/BLEU'},
    'train_squad': {'train/loss', 'val/F1', 'val/EM'},
    'train_wikitext': {'train/ppl', 'val/ppl'},
}
STEPS = 3


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The process-global state a trainer's ``main`` sets up (the root
    logger's handlers, the flush hooks, the default trace recorder)
    taken down after the case."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    tobs.trace.uninstall()
    trunlog.uninstall_flush_hooks()
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


class _Recorded:
    """A step function that records ``last_phases`` after each call."""

    def __init__(self, fn, seen):
        self._fn, self._seen = fn, seen

    def __call__(self, *args, **kw):
        out = self._fn(*args, **kw)
        self._seen.append(tuple(self._fn.last_phases))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


@pytest.fixture
def record_phases(monkeypatch):
    seen = []
    build = training.build_train_step

    def recorded(*args, **kw):
        return _Recorded(build(*args, **kw), seen)
    monkeypatch.setattr(training, 'build_train_step', recorded)
    return seen


@pytest.fixture
def tiny_imagenet(monkeypatch):
    from kfac_pytorch_tpu_torch import train_imagenet
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from test_torch_checkpoint import _Tiny

    # the registry module is shared by every trainer: only ResNet-50, the
    # ImageNet trainer's default, becomes the narrow net
    get = train_imagenet.models.get_model

    def get_model(name, *args, **kw):
        if name != 'resnet50':
            return get(name, *args, **kw)
        return cifar_resnet.init_weights(
            _Tiny(kw['num_classes'], kw['dtype']), kw['seed'])
    monkeypatch.setattr(train_imagenet.models, 'get_model', get_model)


def _prometheus(text):
    """``{sample: value}`` of a Prometheus textfile (a line per sample,
    ``# TYPE`` lines declaring each name)."""
    out, types = {}, {}
    for line in text.splitlines():
        if line.startswith('# TYPE '):
            _, _, name, kind = line.split(' ')
            types[name] = kind
            continue
        name, value = line.rsplit(' ', 1)
        out[name] = float(value)
        assert name.split('{')[0].removesuffix('_bucket').removesuffix(
            '_sum').removesuffix('_count') in types, line
    return out


@pytest.mark.parametrize('trainer', list(ARGV))
def test_trainer_observability_on_cpu(trainer, tmp_path, record_phases,
                                      tiny_imagenet, capsys):
    import importlib
    mod = importlib.import_module(f'kfac_pytorch_tpu_torch.{trainer}')
    argv = ARGV[trainer] + [
        '--epochs', '1', '--steps-per-epoch', str(STEPS),
        '--kfac-update-freq', '2', '--log-dir', str(tmp_path / 'logs'),
        '--trace', str(tmp_path / 'trace'), '--prom-file',
        str(tmp_path / 'm.prom'), '--tb-dir', str(tmp_path / 'tb')]
    if trainer == 'train_imagenet':
        argv += ['--checkpoint-format', str(tmp_path / 'ckpt')]
    tr = mod.main(argv)
    assert tr.state.step == STEPS and len(record_phases) == STEPS
    # the decomposition every second step, from the first
    assert [('decomp' in p) for p in record_phases] == [True, False, True]
    # stdout keeps the bare epoch line; the run log has it with its time
    out = capsys.readouterr().out.splitlines()
    line = [ln for ln in out if ln.startswith('epoch 0:')][-1]
    logs = glob.glob(str(tmp_path / 'logs' / '*.log'))
    assert len(logs) == 1
    text = open(logs[0]).read()
    assert line in text and re.search(r'^\S+ \S+ args: \{', text, re.M)
    run = parse_logs.parse(logs[0])
    assert [e[0] for e in run['epochs']] == [0] and run['args']
    if trainer in TIMED:
        body = re.search(r' kfac_phase_ms=(\S+)$', line).group(1)
        keys = {kv.split(':')[0] for kv in body.split(',')}
        assert {'step_mean', 'step_max', 'decomp'} <= keys, line
    else:
        assert 'kfac_phase_ms' not in line
    # the trace: a kfac.dispatch span a step (and a kfac.step span where
    # PhaseTimers is wired), phases as the step ran them
    events = [json.loads(ln) for ln in
              open(tmp_path / 'trace' / 'trace-host0.jsonl')]
    want = [taxonomy_phases(p) for p in record_phases]
    dispatch = [e for e in events if e['name'] == 'kfac.dispatch']
    assert [e['args']['phases'] for e in dispatch] == want
    assert [e['args']['step'] for e in dispatch] == list(range(STEPS))
    steps = [e['args']['phases'] for e in events if e['name'] == 'kfac.step']
    assert steps == (want if trainer in TIMED else [])
    # the exports parse; the step histogram counts every step
    prom = _prometheus((tmp_path / 'm.prom').read_text())
    rows = [json.loads(ln) for ln in open(tmp_path / 'trace' /
                                          'metrics.jsonl')]
    assert len(rows) == 1 and rows[0]['step'] == 0
    assert prom['kfac_health_skipped'] == 0
    if trainer in TIMED:
        assert prom['kfac_step_seconds_count'] == STEPS
        assert rows[0]['metrics']['step_seconds']['count'] == STEPS
    tags = set(tsummary.read_scalars(str(tmp_path / 'tb')))
    assert TB_TAGS[trainer] <= tags and 'health/skipped' in tags


@pytest.mark.parametrize('flag,value,item', [
    ('--kfac-autotune', None, 'slice F2'),
    ('--step-deadline', '5', 'slice G'),
    ('--straggler-budget', '1', 'slice G')])
def test_flags_left_unported_still_raise(flag, value, item):
    from kfac_pytorch_tpu_torch import train_imagenet
    names = [n for n, _, _ in train_imagenet.UNPORTED]
    assert names == ['step_deadline', 'straggler_budget']
    argv = CPU + [flag] + ([value] if value else [])
    if flag == '--kfac-autotune':
        # ported with slice F2: accepted (the tuner's wiring is
        # tests/test_torch_autotune_trainers.py's)
        args = train_imagenet.parse_args(argv)
        train_imagenet.check_ported(args)
        assert args.kfac_autotune
        return
    with pytest.raises(NotImplementedError, match=f'ROADMAP.*{item}'):
        train_imagenet.main(argv)


def _jax_scopes():
    names = set()
    for path in glob.glob(os.path.join(ROOT, 'kfac_pytorch_tpu', '**',
                                       '*.py'), recursive=True):
        names |= set(re.findall(r"jax\.named_scope\('(kfac\.[^']+)'\)",
                                open(path).read()))
    return names


def test_port_ranges_are_jax_named_scopes():
    jax_names = _jax_scopes()
    port = set()
    for path in glob.glob(os.path.join(ROOT, 'kfac_pytorch_tpu_torch', '**',
                                       '*.py'), recursive=True):
        src = open(path).read()
        port |= set(re.findall(r"_range\('([^']+)'\)", src))
        port |= set(re.findall(r"named_scope\('([^']+)',\s*profile=True",
                               src))
        port |= set(re.findall(r"record_function\('([^']+)'\)", src))
    # and every scope of the JAX package has its range in the port
    assert port == jax_names, (port - jax_names, jax_names - port)


def test_decomposition_and_plain_steps_open_their_ranges():
    from torch.profiler import ProfilerActivity, profile

    from kfac_pytorch_tpu_torch import train_cifar
    tr = train_cifar.Trainer(train_cifar.parse_args(
        ARGV['train_cifar'] + ['--kfac-update-freq', '2',
                               '--steps-per-epoch', '2']))
    batches = iter(tr.train_loader.epoch())
    opened = []
    for _ in range(2):
        batch = next(batches)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.train_step(batch)
        opened.append({e.name for e in prof.events()
                       if e.name.startswith('kfac.')})
    decomp, plain = opened
    assert tr.step_fn.last_phases == ('pred', 'stats')
    assert {'kfac.ComputeFactor', 'kfac.ComputeInverse',
            'kfac.Precondition'} <= decomp
    assert {'kfac.ComputeFactor', 'kfac.Precondition'} <= plain
    assert 'kfac.ComputeInverse' not in plain
    assert (decomp | plain) <= _jax_scopes()


def test_train_lm_keeps_training_after_a_skipped_batch(monkeypatch, capsys,
                                                       tmp_path):
    """ROADMAP queue 3, item 6: the run goes on past the guard's skip and
    reports it on the epoch line, as the JAX trainer does."""
    from kfac_pytorch_tpu_torch import train_lm
    calls = []
    loss_fn = train_lm.loss_fn

    def nan_at_second_step(outputs, batch):
        calls.append(1)
        loss = loss_fn(outputs, batch)
        return loss * float('nan') if len(calls) == 2 else loss
    monkeypatch.setattr(train_lm, 'loss_fn', nan_at_second_step)
    tr = train_lm.main(CPU + [
        '--n-layer', '1', '--n-head', '2', '--d-model', '32', '--seq-len',
        '64', '--batch-size', '2', '--steps-per-epoch', '4', '--epochs', '1',
        '--attn-impl', 'xla', '--kfac-update-freq', '1', '--log-dir',
        str(tmp_path)])
    assert tr.state.step == 4 and int(tr.state.health.skipped) == 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r'epoch 0: train_ppl nan val_ppl [\d.]+ '
                        r'\([\d.]+s\) \[health: skipped=1 sgd_fallbacks=0 '
                        r'max_rung=\d\]', line), line
    assert jrunlog.health_suffix(
        {'skipped': 1, 'fallbacks': 0,
         'max_rung': int(line[-2])}) in line
