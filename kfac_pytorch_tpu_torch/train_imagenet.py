"""ImageNet trainer of the port (counterpart of
``examples/imagenet_resnet.py``; ResNets, ResNeXts, DenseNet-BC,
Inception-v4): the JAX trainer's flag names and defaults (ResNet-50,
batch 32, 224 x 224, base lr 0.0125 scaled by the accumulated batches,
5 warmup epochs, wd 5e-5, label smoothing 0.1,
``eigen_dp`` with ``kfac_update_freq=1``, bf16 on), gradient accumulation
(``--batches-per-allreduce``), the K-FAC scheduler, auto-resume from
``--checkpoint-format`` at start, a checkpoint every epoch, retention
(``--keep-checkpoints``) and a SIGTERM save; plus ``--device`` (default
``cuda``), ``--dist-backend`` and ``--steps-per-epoch``.

  python -m kfac_pytorch_tpu_torch.train_imagenet --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_imagenet --kfac-name ekfac_dp \\
      --kfac-capture-impl pallas
  python -m kfac_pytorch_tpu_torch.train_imagenet --device cpu \\
      --model resnet18 --img-size 32 --batch-size 4 --steps-per-epoch 2 \\
      --epochs 1

Reads ``images.npy``/``labels.npy`` from ``--train-dir`` when present,
else the synthetic stand-in (``data.get_imagenet``), two batches ahead on
a background thread (``data.Loader.epoch``). The numerical-health guard
is on (``KFAC(health=True)``), its events logged at their step and
summarized on the epoch line. At ``--num-devices`` > 1 each rank is one
process (``python -m kfac_pytorch_tpu_torch.launch --nproc N --
train_imagenet``), ``--batch-size`` is the GLOBAL batch and rank r trains
on its rows, as in the CIFAR trainer; the run stamps its world beside its
checkpoints and resumes through ``resilience.elastic_resume``, at that
world or another. ``--io-retries`` retries checkpoint I/O and the next
batch. ``--exclude-parts`` leaves phases out of every K-FAC step
(``KFAC``'s ``exclude_parts``). Flags of the JAX trainer whose features
the port does not have yet raise NotImplementedError naming their
ROADMAP item.

Observability, as in the JAX trainer (:func:`add_obs_flags`,
:func:`observed`): every line the trainer prints also lands in a per-run
log file under ``--log-dir``; each step's wall time is split by K-FAC
phase set (``utils.PhaseTimers``: the epoch line's `` kfac_phase_ms=``
suffix); ``--trace DIR`` writes Chrome-trace spans (``kfac.step``,
``kfac.dispatch``) to ``DIR/trace-host<rank>.jsonl`` and the metrics
registry to ``DIR/metrics.jsonl``; ``--prom-file`` exports the registry
as a Prometheus textfile, ``--tb-dir`` as TensorBoard scalars beside the
epoch's loss, lr and validation scalars.

``--kfac-autotune`` (in every trainer, :func:`tuner_for`): the online
tuner hill-climbs the runtime knobs through the knob arbiter from measured
step times, its decisions in ``<--trace>/autotune-decisions.jsonl``; on
ResNet-50 at batch 32, the workload ``perfmodel`` describes, a commit
whose measured phases leave the perf model's band is vetoed on an H100
(the gate is advisory elsewhere).
"""

import argparse
import contextlib
import os
import time

import torch

import kfac_pytorch_tpu_torch as kfac
from kfac_pytorch_tpu_torch import data as kdata
from kfac_pytorch_tpu_torch import (autotune, models, obs, perfmodel,
                                    resilience, training, utils)
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.parallel import mesh as kmesh
from kfac_pytorch_tpu_torch.utils import checkpoint, profiling, runlog, summary
from kfac_pytorch_tpu_torch.utils.losses import label_smoothing_cross_entropy

#: flags of the JAX trainer the port does not honour yet: (flag, the value
#: that leaves the feature off, the ROADMAP item that brings it)
UNPORTED = [
    ('step_deadline', 0, 'queue 1, slice G item 23 (resilience: the step '
                         'watchdog)'),
    ('straggler_budget', 0, 'queue 1, slice G item 23 (resilience: the '
                            'straggler governor)'),
]
#: steps the --speed timer discards, then times (the JAX speed_report's)
SPEED_WARMUP, SPEED_ITERS = 5, 60


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='ImageNet K-FAC trainer '
                                            '(PyTorch)')
    p.add_argument('--model', default='resnet50')
    p.add_argument('--train-dir', default=None)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--val-batch-size', type=int, default=32)
    p.add_argument('--batches-per-allreduce', type=int, default=1)
    p.add_argument('--epochs', type=int, default=55)
    p.add_argument('--base-lr', type=float, default=0.0125)
    p.add_argument('--lr-decay', nargs='+', type=int,
                   default=[25, 35, 40, 45, 50])
    p.add_argument('--warmup-epochs', type=int, default=5)
    p.add_argument('--wd', type=float, default=5e-5)
    p.add_argument('--label-smoothing', type=float, default=0.1)
    p.add_argument('--img-size', type=int, default=224)
    add_kfac_flags(p, update_freq=1, damping=0.002, assignment='balanced')
    p.add_argument('--damping-alpha', type=float, default=0.5)
    p.add_argument('--damping-decay', nargs='+', type=int, default=None)
    p.add_argument('--kfac-update-freq-alpha', type=float, default=10)
    p.add_argument('--kfac-update-freq-decay', nargs='+', type=int,
                   default=None)
    p.add_argument('--num-devices', type=int, default=1,
                   help='ranks of the K-FAC world; > 1 must be launched '
                        '(python -m kfac_pytorch_tpu_torch.launch) and '
                        'equal WORLD_SIZE')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='process-group backend (default nccl on the GPU, '
                        'gloo with --device cpu)')
    p.add_argument('--io-retries', type=int, default=3,
                   help='retry budget for checkpoint I/O and next-batch '
                        'transients (0 = fail fast)')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--speed', action='store_true',
                   help='print images/s of warm, synchronized steps and '
                        'exit')
    p.add_argument('--bf16', action='store_true', default=True)
    p.add_argument('--checkpoint-format', default='./checkpoints',
                   help='checkpoint directory')
    p.add_argument('--keep-checkpoints', type=int, default=0,
                   help='retain only the N newest checkpoints (0 = all)')
    p.add_argument('--synthetic-size', type=int, default=1024)
    p.add_argument('--steps-per-epoch', type=int, default=None,
                   help='cut each epoch to this many steps (default: the '
                        'whole training set)')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    add_obs_flags(p)
    add_autotune_flag(p, '; on the modeled workload (resnet50 bs32) every '
                      'commit is vetoed by the perf-model drift band')
    add_unported_flags(p)
    return p.parse_args(argv)


#: ``--kfac-autotune``'s help in the JAX trainers, with the words each says
#: of the drift gate in its slot
AUTOTUNE_HELP = ('closed-loop autotuning: one online controller '
                 'hill-climbs kfac/fac_update_freq and the comm wire dtype '
                 'from measured step times through the knob arbiter{} '
                 '(defaults on when $KFAC_AUTOTUNE=1; see README '
                 '"Closed-loop autotuning")')


def add_autotune_flag(p, gate=''):
    """``--kfac-autotune``, the JAX trainers' flag (on by default when
    ``KFAC_AUTOTUNE=1``), its help saying ``gate`` of the drift gate."""
    p.add_argument('--kfac-autotune', action='store_true',
                   default=os.environ.get('KFAC_AUTOTUNE', '') == '1',
                   help=AUTOTUNE_HELP.format(gate))


def add_unported_flags(p):
    """The JAX trainers' ``--step-deadline`` and ``--straggler-budget``
    (their defaults, 0 = off), whose features are not ported
    (:data:`UNPORTED`: :func:`check_ported` refuses them)."""
    p.add_argument('--step-deadline', type=float, default=0)
    p.add_argument('--straggler-budget', type=float, default=0)


def tuner_for(tr, args, predicted=None):
    """Trainer ``tr``'s online tuner, as the JAX trainers build it
    (``autotune.controller_from_args``: the decision log under
    ``--trace``, the run log, the platform from the preconditioner's
    device), or None without ``--kfac-autotune`` or a preconditioner.
    ``predicted``: the perf model's block, only for the workload it
    describes (the drift gate)."""
    return autotune.controller_from_args(
        tr.precond, enabled=args.kfac_autotune, trace_dir=args.trace,
        predicted=predicted, variant=args.kfac_name, log=tr.log)


def predicted_for(args):
    """The perf model's block when this run is the workload it describes
    (ResNet-50 at its batch, ``perfmodel.BATCH``), else None: the tuner
    then runs without the drift gate."""
    if args.model == 'resnet50' and args.batch_size == perfmodel.BATCH:
        return perfmodel.predict_block()
    return None


def add_obs_flags(p):
    """The JAX trainers' observability flags (their names, defaults and
    help): ``--log-dir``, ``--tb-dir``, ``--trace`` and ``--prom-file``."""
    p.add_argument('--log-dir', default='./logs',
                   help='per-run log files land here (rank 0)')
    p.add_argument('--tb-dir', default=None,
                   help='write TensorBoard scalar summaries here (rank 0)')
    p.add_argument('--trace', default=None, metavar='DIR',
                   help='write Chrome-trace spans (per-step phase spans) '
                        'to DIR/trace-host<rank>.jsonl and epoch metric '
                        'snapshots to DIR/metrics.jsonl (defaults to '
                        '$KFAC_TRACE_DIR when set)')
    p.add_argument('--prom-file', default=os.environ.get('KFAC_PROM_FILE'),
                   metavar='PATH',
                   help='export the metrics registry as a Prometheus '
                        'textfile at PATH after every epoch (rank 0; '
                        'defaults to $KFAC_PROM_FILE; the path is '
                        'namespaced by $KFAC_TENANT/$KFAC_JOB_ID when set)')


@contextlib.contextmanager
def observed(args, *parts, trainer):
    """The JAX trainers' observability around a run, from
    :func:`add_obs_flags`' flags, in the JAX trainers' order: the run log
    (``runlog.setup_run_logging``: its file under ``--log-dir`` named by
    ``parts``, on rank 0) with the flags logged; the trainer,
    ``trainer(log)`` (its preconditioner and tuner: :func:`tuner_for`);
    the trace recorder and the metrics registry with the tuner's counts
    and gauges (``obs.setup_trainer(tuner=)``; ``tracer`` None without
    ``--trace``), handed to the trainer's step (``step_fn.set_tracer``); on
    rank 0 with ``--tb-dir`` a TensorBoard writer exporting the registry
    (else None). Yields ``(trainer, log, tracer, registry, tb)``. On the
    way out, however the run ends, the trace is flushed, the exporters
    closed and the run log's flush hooks removed (SIGTERM's handler as it
    was)."""
    log, _ = runlog.setup_run_logging(args.log_dir, *parts)
    log.info('args: %s', vars(args))
    tracer = reg = None
    try:
        tr = trainer(log)
        tracer, reg = obs.setup_trainer(trace_dir=args.trace,
                                        prom_file=args.prom_file,
                                        tuner=tr.tuner)
        tr.tracer = tracer
        tr.step_fn.set_tracer(tracer)
        tb = summary.maybe_writer(args.tb_dir)
        if tb is not None:
            reg.add_exporter(obs.metrics.TensorBoardExporter(tb))
        yield tr, log, tracer, reg, tb
    finally:
        if tracer is not None:
            tracer.flush()
        if reg is not None:
            reg.close()
        runlog.uninstall_flush_hooks()


def gate_tuner(tr, monitor):
    """Late-bind the health monitor's ``quality_signal`` as trainer
    ``tr``'s tuner's quality gate (the JAX trainers build the tuner before
    the monitor): a probe window that skipped batches or fell back to the
    raw gradients never commits."""
    if tr.tuner is not None:
        tr.tuner.quality_gate = monitor.quality_signal


def end_epoch(tr, line, epoch, monitor, reg, tracer):
    """The JAX trainers' epoch end: ``line`` with the registry's suffixes
    (health, resilience, the phase timers') said, the monitor's window
    reset, the registry exported and the trace flushed."""
    tr.say(line + reg.epoch_suffixes())
    monitor.epoch_flush()
    reg.export(step=epoch)
    if tracer is not None:
        tracer.flush()


def say(tr, *args, **kw):
    """``print`` on rank 0 of trainer ``tr``, the line also written to its
    run log's file (``tr.log``, when :func:`observed` gave it one)."""
    if tr.rank == 0:
        print(*args, flush=True, **kw)
        if tr.log is not None:
            tr.log.info(' '.join(map(str, args)), extra=runlog.PRINTED)


def add_kfac_flags(p, update_freq, damping, assignment='round_robin'):
    """The K-FAC flags of the port's trainers (the JAX trainers' names;
    ``update_freq``, ``damping`` and ``assignment`` their defaults), with
    the ladder's and ``--exclude-parts`` (:func:`add_decomp_flags`)."""
    p.add_argument('--kfac-update-freq', type=int, default=update_freq,
                   help='0 disables K-FAC (pure SGD)')
    p.add_argument('--kfac-cov-update-freq', type=int, default=1)
    p.add_argument('--kfac-capture-impl', default=None,
                   choices=['xla', 'pallas', 'auto'],
                   help="capture path: unset or 'xla' = plain torch ops; "
                        "'pallas'/'auto' = the fused CUDA capture kernels")
    p.add_argument('--kfac-comm-precision', default='fp32',
                   choices=['fp32', 'bf16', 'int8'],
                   help='wire dtype of the K-FAC factor collectives: bf16 '
                        'halves, int8 quarters the gather payloads; a lossy '
                        'stats reduce carries an error-feedback residual; '
                        'the gradient all-reduce is never compressed')
    p.add_argument('--kfac-comm-mode', default=None,
                   choices=['inverse', 'pred'],
                   help="override the variant's comm mode: 'inverse' "
                        "gathers decompositions once per refresh, 'pred' "
                        'gathers preconditioned gradients every step')
    p.add_argument('--kfac-name', default='eigen_dp',
                   choices=list(kfac.KFAC_VARIANTS))
    p.add_argument('--stat-decay', type=float, default=0.95)
    p.add_argument('--damping', type=float, default=damping)
    p.add_argument('--kl-clip', type=float, default=0.001)
    p.add_argument('--assignment', default=assignment,
                   choices=['round_robin', 'balanced'])
    add_decomp_flags(p)


def add_decomp_flags(p):
    """The decomposition-ladder flags of the JAX trainers and
    ``--exclude-parts``, shared by the port's trainers."""
    p.add_argument('--kfac-basis-update-freq', type=int, default=0,
                   help='full eigendecomposition cadence; intermediate '
                        'inverse updates refresh eigenvalues in the '
                        'retained basis (0 = always full)')
    p.add_argument('--kfac-warm-start', action='store_true',
                   help='warm-start decompositions from the stored one: '
                        'eigen variants track the previous eigenbasis '
                        '(KFAC_EIGH_IMPL=subspace|auto|jacobi), Cholesky '
                        'variants Newton-Schulz-iterate the previous '
                        'inverse')
    p.add_argument('--kfac-stagger', action='store_true',
                   help='staggered inverse refresh: decompose one cost-'
                        'balanced cohort of factors per step instead of '
                        'all factors every --kfac-update-freq steps, '
                        'preconditioning with the stored table')
    p.add_argument('--kfac-decomp-shard', action='store_true',
                   help='decompose each staggered cohort balanced across '
                        'all ranks instead of by its owners (two '
                        'DecompComm gathers a step; implies '
                        '--kfac-stagger)')
    p.add_argument('--kfac-comm-prefetch', action='store_true',
                   help="comm_mode 'inverse' variants only: publish each "
                        "inverse update's gathered decomposition for the "
                        'next step and precondition this one with the '
                        'stored table (one step of staleness)')
    p.add_argument('--kfac-decomp-impl', default=None,
                   choices=['xla', 'auto', 'jacobi', 'subspace',
                            'newton_schulz'],
                   help='decomposition kernel (unset = KFAC_EIGH_IMPL '
                        'decides): xla = cold eigh / Cholesky; subspace|'
                        'jacobi (eigh variants) and newton_schulz '
                        '(Cholesky variants) warm-start from the stored '
                        'decomposition; auto = subspace or newton_schulz')
    p.add_argument('--exclude-parts', default='',
                   help='phase ablation: any of ComputeFactor, '
                        'CommunicateFactor, ComputeInverse, '
                        'CommunicateInverse (comma-separated) left out of '
                        'every K-FAC step, to split its time by '
                        'subtraction')


def decomp_kwargs(args):
    """``KFAC`` keyword arguments of :func:`add_decomp_flags`' flags."""
    return dict(basis_update_freq=args.kfac_basis_update_freq or None,
                warm_start_basis=args.kfac_warm_start,
                stagger=args.kfac_stagger,
                decomp_impl=args.kfac_decomp_impl,
                decomp_shard=args.kfac_decomp_shard,
                comm_prefetch=args.kfac_comm_prefetch,
                exclude_parts=args.exclude_parts)


def check_ported(args):
    """Raise NotImplementedError for a flag whose feature the port lacks,
    naming the ROADMAP item that brings it."""
    for name, off, item in UNPORTED:
        if getattr(args, name) != off:
            flag = '--' + name.replace('_', '-')
            raise NotImplementedError(f'{flag} is not ported yet: ROADMAP '
                                      f'{item}')


def io_retry(args):
    """The ``resilience.RetryPolicy`` of ``--io-retries`` (that many
    retries after the first attempt), or None for 0: the JAX trainers'
    policy for checkpoint I/O and the next batch."""
    if args.io_retries <= 0:
        return None
    return resilience.RetryPolicy(attempts=args.io_retries + 1)


def kfac_for(args, world=1, group=None, exclude_vocabulary_size=None):
    """The trainers' preconditioner from their K-FAC flags
    (:func:`add_kfac_flags`), at ``world`` ranks (``group`` their process
    group; None for the groupless host structure of another world, as
    ``elastic_resume`` asks for), the pre-softmax head of
    ``exclude_vocabulary_size`` outputs left out."""
    return kfac.get_kfac_module(args.kfac_name)(
        lr=args.base_lr, damping=args.damping,
        fac_update_freq=args.kfac_cov_update_freq,
        kfac_update_freq=args.kfac_update_freq,
        capture_impl=args.kfac_capture_impl,
        comm_precision=args.kfac_comm_precision,
        comm_mode=args.kfac_comm_mode,
        kl_clip=args.kl_clip, factor_decay=args.stat_decay,
        num_devices=world, group=group,
        assignment=args.assignment,
        exclude_vocabulary_size=exclude_vocabulary_size,
        **decomp_kwargs(args))


def resume_from(tr, base_dir):
    """Resume trainer ``tr`` (``args``, ``precond``, ``state``,
    ``io_retry``, ``world``, ``say``) from the newest restorable
    checkpoint in ``base_dir``, at the stamped world or another
    (``resilience.elastic_resume``; a world change prints the
    ``WORLD_RESCALE`` and ``RESHARDED`` lines). Returns the checkpoint's
    epoch, or None without one."""
    args = tr.args

    def old_precond(world):
        pre = kfac_for(args, world)
        pre.setup(tr.precond.plan.metas)
        return pre

    def on_world_change(old_world, new_world):
        # the loaders yield the GLOBAL batch at any world: it is the
        # invariant, and the lr stays (lr_factor 1)
        res = training.world_change_rescale(
            old_world, new_world, lr=args.base_lr,
            global_batch=args.batch_size)
        tr.say(res.log_line())
        # provenance: the verdict rides the knob arbiter's records
        # (composes nothing: the lr schedule stays the trainer's)
        if tr.precond is not None:
            autotune.arbiter_for(tr.precond).propose('elastic',
                                                     **res._asdict())

    restored, epoch, old_world = resilience.elastic_resume(
        base_dir, args.epochs, tr.precond, tr.state,
        make_precond=old_precond, retry=tr.io_retry,
        on_world_change=on_world_change)
    if epoch is None:
        return None
    tr.state = restored
    if old_world is not None:
        tr.say(f'RESHARDED from_world={old_world} to_world={tr.world} '
               f'step={tr.state.step}')
    tr.say(f'resumed from checkpoint-{epoch} (step {tr.state.step})')
    return epoch


def stamp_world(tr, base_dir):
    """Stamp ``tr``'s world beside its checkpoints in ``base_dir``
    (``checkpoint.write_world_stamp``, with the pod generation and the
    lineage from the environment), once every rank has read the old stamp
    in its resume: a rank still resuming would otherwise read the new
    world as the checkpoints'."""
    if tr.group is not None:
        torch.distributed.barrier(group=tr.group)
    checkpoint.write_world_stamp(base_dir, tr.world,
                                 gen=os.environ.get('KFAC_POD_GEN'),
                                 lineage=os.environ.get('KFAC_LINEAGE'))


def init_world(args, group=None, local_rank=None, world=None):
    """``(group, rank, device)`` of a trainer at ``world`` ranks (default
    ``args.num_devices``): ``group`` if given (as ``launch.spawn`` gives
    one), else the default group initialized from the launcher's
    environment; the rank runs on ``cuda:local_rank`` (``LOCAL_RANK``
    unless given). Raises before any group is made when the GPU is asked
    for and absent."""
    utils.resolve_device(args.device)
    world = args.num_devices if world is None else world
    backend = args.dist_backend or ('gloo' if args.device == 'cpu'
                                    else 'nccl')
    if group is None and world > 1:
        group = kmesh.maybe_initialize_distributed(backend, world)
    if coll.axis_size(group) != world:
        raise ValueError(f'a world of {world} ranks asked for, but the '
                         f'process group has {coll.axis_size(group)}')
    if world > 1 and local_rank is None:
        local_rank = kmesh.local_rank()
    return group, coll.axis_index(group), utils.resolve_device(
        args.device, local_rank)


def add_world_flags(p):
    """``--device`` and ``--dist-backend``, the sequence trainers' flags
    beside their world flags (``--num-devices``, or the LM's grid)."""
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='process-group backend at world > 1 (default: '
                        'nccl on the GPU, gloo on the CPU)')


def end_world(tr, group):
    """At world>1: raise unless the replicas are bitwise equal, then
    leave the launcher's process group (not a ``group`` handed in)."""
    if tr.world == 1:
        return
    if not training.replicas_agree(tr.state.model, tr.group):
        raise RuntimeError('the ranks\' parameters and buffers differ')
    tr.say(f'replicas: {tr.world} ranks bitwise identical')
    if group is None:
        torch.distributed.destroy_process_group()

class Trainer:
    """Everything one run needs, built from the parsed flags: data,
    model (in bf16 unless ``args.bf16`` is off), optimizer (SGD, wrapped
    in ``training.MultiSteps`` when batches accumulate), preconditioner,
    scheduler, state and step. Matmuls and convolutions in fp32 run with
    TF32 off, the reference's precision."""

    log = None

    def __init__(self, args, group=None, local_rank=None, log=None):
        check_ported(args)
        self.args = args
        self.tracer = None
        self.log = log
        self.group, self.rank, self.device = init_world(args, group,
                                                        local_rank)
        self.world = args.num_devices
        self.io_retry = io_retry(args)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = torch.bfloat16 if args.bf16 else torch.float32
        (train_x, train_y), (val_x, val_y) = kdata.get_imagenet(
            args.train_dir, args.img_size, args.synthetic_size)
        # the global batch: each rank takes its rows in to_device
        self.train_loader = kdata.Loader(train_x, train_y, args.batch_size,
                                         train=True, seed=args.seed,
                                         shard=(0, 1))
        if args.steps_per_epoch is not None:
            self.train_loader.steps_per_epoch = min(
                args.steps_per_epoch, self.train_loader.steps_per_epoch)
        self.val_loader = kdata.Loader(val_x, val_y, args.val_batch_size,
                                       train=False, shard=(0, 1))
        model = models.get_model(args.model, num_classes=1000,
                                 seed=args.seed, dtype=self.dtype)
        self.lr_fn = utils.warmup_multistep(
            args.base_lr, self.train_loader.steps_per_epoch,
            args.warmup_epochs, args.lr_decay,
            scale=max(1, args.num_devices * args.batches_per_allreduce))
        self.tx = training.sgd(self.lr_fn, momentum=0.9,
                               weight_decay=args.wd)
        if args.batches_per_allreduce > 1:
            self.tx = training.MultiSteps(self.tx,
                                          args.batches_per_allreduce)
        self.precond = self.scheduler = None
        if args.kfac_update_freq > 0:
            self.precond = kfac_for(args, self.world, self.group)
            self.scheduler = kfac.KFACParamScheduler(
                self.precond, damping_alpha=args.damping_alpha,
                damping_schedule=args.damping_decay,
                update_freq_alpha=args.kfac_update_freq_alpha,
                update_freq_schedule=args.kfac_update_freq_decay)
        sample = torch.zeros((args.batch_size // self.world, args.img_size,
                              args.img_size, 3))
        self.state = training.init_train_state(model, self.tx, self.precond,
                                               sample, self.device)
        self.tuner = tuner_for(self, args, predicted_for(args))
        self.step_fn = training.build_train_step(
            model, self.tx, self.precond, self.loss_fn,
            input_dtype=self.dtype, group=self.group, autotune=self.tuner)

    def say(self, *args, **kw):
        say(self, *args, **kw)

    def loss_fn(self, outputs, batch):
        """Label-smoothed CE on the model's (bf16) logits."""
        return label_smoothing_cross_entropy(
            outputs, batch['label'], smoothing=self.args.label_smoothing)

    def to_device(self, batch):
        """This rank's rows of a global host batch, on the device."""
        if self.world > 1:
            batch = kmesh.shard_batch(batch, self.rank, self.world)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def kfac_lr(self, step):
        """The lr the step hands K-FAC (its KL clip) at ``step``: the
        schedule's."""
        return self.lr_fn(step)

    def train_step(self, batch):
        """One step on a host batch; returns the metrics dict."""
        self.state, m = self.step_fn(
            self.state, self.to_device(batch),
            lr=self.kfac_lr(self.state.step),
            damping=self.precond.damping if self.precond else 0.0)
        return m

    def evaluate(self):
        loss = acc = n = 0.0
        for batch in self.val_loader.epoch():
            l, a = training.eval_step(self.state.model,
                                      self.to_device(batch),
                                      training.fp32_cross_entropy,
                                      input_dtype=self.dtype)
            k = len(batch['label'])
            loss, acc, n = loss + float(l) * k, acc + float(a) * k, n + k
        return loss / n, acc / n

    def resume(self):
        """Auto-resume from ``--checkpoint-format`` (:func:`resume_from`):
        returns the epoch to start from (0 without a checkpoint). The
        scheduler steps to it and the loader draws the epochs it skips,
        so the resumed epochs see the batches an uninterrupted run
        would."""
        epoch = resume_from(self, self.args.checkpoint_format)
        if epoch is None:
            return 0
        start = epoch + 1
        if self.scheduler is not None:
            self.scheduler.step(start)
        for _ in range(start):
            self.train_loader.rng.randint(1 << 31)
        return start

    def save(self, epoch, block=True):
        """Checkpoint ``epoch`` of the state (every rank calls it; rank 0
        writes)."""
        checkpoint.save_checkpoint(self.args.checkpoint_format, epoch,
                                   self.state, block=block,
                                   retry=self.io_retry, group=self.group)


class _SayLog:
    """``log.info`` onto a trainer's :func:`say`."""

    def __init__(self, tr):
        self.tr = tr

    def info(self, fmt, *args):
        self.tr.say(fmt % args)


def speed(tr, batch=None, units=None, unit='imgs/sec'):
    """``unit`` a second over SPEED_ITERS synchronized steps on one host
    batch (default the loader's first) of ``units`` items (default its
    labels), after SPEED_WARMUP steps: ``utils.profiling.speed_report``
    (the JAX trainers' counts and line), each timed step a ``bench.iter``
    span of ``tr.tracer``."""
    if batch is None:
        batch = next(tr.train_loader.epoch())
    if units is None:
        units = len(batch['label'])

    def step(state, b):
        tr.state = state
        m = tr.train_step(b)
        return tr.state, m

    tr.state = profiling.speed_report(
        _SayLog(tr), step, tr.state, batch, units, unit=unit,
        iters=SPEED_ITERS, warmup=SPEED_WARMUP, tracer=tr.tracer)


def main(argv=None, group=None):
    """Run the trainer (in ``group`` if given, as ``launch.spawn`` gives
    one; else the launcher's group at world>1); returns it."""
    args = parse_args(argv)
    check_ported(args)
    with observed(
            args, 'imagenet', args.model, f'kfac{args.kfac_update_freq}',
            args.kfac_name,
            f'basis{args.kfac_basis_update_freq}'
            if args.kfac_basis_update_freq else None,
            'warm' if args.kfac_warm_start else None,
            f'bs{args.batch_size}', f'nd{args.num_devices}',
            trainer=lambda log: Trainer(args, group=group, log=log)) as (
                tr, log, tracer, reg, tb):
        start_epoch = tr.resume()
        if args.speed:
            speed(tr)
            return tr
        stamp_world(tr, args.checkpoint_format)
        guard = checkpoint.PreemptionGuard(group=tr.group)
        monitor = utils.HealthMonitor(log, state=tr.state, registry=reg)
        gate_tuner(tr, monitor)
        # each step's wall time by phase set (the epoch line's kfac_phase_ms=);
        # with a tracer every step is also a kfac.step span
        timers = utils.PhaseTimers(tracer=tracer, registry=reg, histogram=True)
        lr_now = args.base_lr
        try:
            for epoch in range(start_epoch, args.epochs):
                t0 = time.time()
                tm = utils.Metric('train_loss', group=tr.group)
                with tr.train_loader.epoch(retry=tr.io_retry) as batches:
                    for batch in batches:
                        if guard.should_stop(tr.state.step):
                            break
                        lr_now = tr.kfac_lr(tr.state.step)
                        t_step = time.perf_counter()
                        m = tr.train_step(batch)
                        # the loss read waits for the step: the wall time
                        # covers its dispatch and its device work
                        tm.update(m['loss'], len(batch['label']))
                        timers.record(tr.step_fn.last_phases,
                                      time.perf_counter() - t_step)
                        monitor.update(m, step=tr.state.step - 1)
                if guard.should_stop():
                    # tagged with the last completed epoch: the resume replays
                    # the interrupted one (the step count keeps the lr exact)
                    tag = max(epoch - 1, 0)
                    tr.save(tag)
                    tr.say(f'preempted in epoch {epoch} (step '
                           f'{tr.state.step}): state saved as '
                           f'checkpoint-{tag}, exiting')
                    return tr
                vl, va = tr.evaluate()
                tl = tm.sync().avg
                end_epoch(tr, f'epoch {epoch}: train_loss {tl:.4f} val_loss '
                              f'{vl:.4f} val_acc {va:.4f} '
                              f'({time.time() - t0:.1f}s)',
                          epoch, monitor, reg, tracer)
                summary.log_epoch_scalars(tb, epoch, tl, lr_now, vl, va)
                if tr.scheduler is not None:
                    tr.scheduler.step(epoch + 1)
                tr.save(epoch, block=False)
                checkpoint.prune_checkpoints(args.checkpoint_format,
                                             args.keep_checkpoints)
                if guard.should_stop():
                    checkpoint.wait_for_checkpoints()
                    tr.say(f'preempted after epoch {epoch}: exiting')
                    return tr
            checkpoint.wait_for_checkpoints()
            checkpoint.prune_checkpoints(args.checkpoint_format,
                                         args.keep_checkpoints)
            if group is None and tr.world > 1:
                torch.distributed.destroy_process_group()
        finally:
            guard.uninstall()
        return tr


if __name__ == '__main__':
    main()
