"""Rank functions for the port's world>1 CPU tests.

``launch.spawn`` runs these in fresh processes that import this module by
name, so it imports torch and the port only — never jax (a spawned rank
then starts in about two seconds). The test modules compute the JAX
oracles in the parent process and hand the inputs over as numpy arrays.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import capture, engine
from kfac_pytorch_tpu_torch import nn as knn
from kfac_pytorch_tpu_torch.models import tiny
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.preconditioner import KFAC


def bucket16(d):
    """All the MLP's factors in one 16 bucket."""
    return 16


def bucket_tiny(d):
    """TinyCNN's factors (28, 73, 129; 8, 10) in three buckets."""
    return 32 if d <= 32 else (80 if d <= 80 else 136)


BUCKETS = {'16': bucket16, 'tiny': bucket_tiny}


class MLP(torch.nn.Module):
    """``tests/test_distributed.py``'s MLP: fc1 (5 -> 8), relu, fc2 (-> 3)."""

    def __init__(self):
        super().__init__()
        self.fc1 = knn.Linear(5, 8)
        self.fc2 = knn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


#: ``kfac_pytorch_tpu.models.tiny.TinyCNN(batch_norm=True)`` on 7x7
#: inputs (odd, so its stride-2 SAME padding is symmetric): the package's
#: port of it
TinyCNN = functools.partial(tiny.TinyCNN, batch_norm=True, in_size=7)


MODELS = {'mlp': MLP, 'tiny': TinyCNN}


def model_input(kind, x):
    t = torch.from_numpy(x)
    if kind == 'tiny':   # NHWC batch -> its NCHW (channels_last) view
        return t.permute(0, 3, 1, 2)
    return t


def run_steps(rank, world, group, cfg):
    """``cfg['steps']`` K-FAC steps of ``cfg``'s model on this rank's shard
    of ``cfg['x']``/``cfg['y']`` (MSE, the local mean), every step a
    factor and inverse update: grads averaged over the group, then
    ``KFAC.step``. With ``cfg['sgd']`` the parameters take ``p -= lr *
    preconditioned grad`` after each step. Returns per step the
    preconditioned grads, this rank's factor rows, residual and E-KFAC
    moments (numpy) and the loss; the collectives of step
    ``cfg['ledger_step']`` (default the first) as a ledger.
    ``cfg['phases']`` (one ``(update_basis, warm_basis)`` a step) drives
    the decomposition ladder (with ``cfg['decomp_impl']``/
    ``cfg['basis_update_freq']``); then each step also returns the stored
    decomposition it started from (``'decomp_in'``). ``cfg['kfac']`` adds
    ``KFAC`` keyword arguments and ``cfg['ladder']`` (one dict a step)
    ``KFAC.step``'s; with either, each step also returns the
    decomposition it leaves (``'decomp'``)."""
    torch.manual_seed(0)
    kind = cfg['model']
    model = MODELS[kind]()
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in cfg['state_dict'].items()})
    model = model.to(memory_format=torch.channels_last)
    per = cfg['x'].shape[0] // world
    x = model_input(kind, cfg['x'][rank * per:(rank + 1) * per])
    y = torch.from_numpy(cfg['y'][rank * per:(rank + 1) * per])
    pre = KFAC(variant=cfg['variant'], num_devices=world, group=group,
               bucket_fn=BUCKETS[cfg['buckets']],
               comm_precision=cfg.get('comm_precision', 'fp32'),
               capture_impl=cfg.get('capture_impl'),
               assignment=cfg.get('assignment', 'round_robin'),
               decomp_impl=cfg.get('decomp_impl'),
               basis_update_freq=cfg.get('basis_update_freq'),
               **cfg.get('kfac', {}))
    pre.setup(capture.collect_layer_meta(model, x))
    state = pre.init('cpu')
    params = dict(model.named_parameters())
    out = {'steps': [], 'ledger': None}
    phases = cfg.get('phases')
    for i in range(cfg['steps']):
        ladder = {}
        if phases is not None:
            ladder = dict(zip(('update_basis', 'warm_basis'), phases[i]))
            decomp_in = _np_tree(state.decomp)
        if cfg.get('ladder') is not None:
            ladder.update(cfg['ladder'][i])
        model.zero_grad(set_to_none=True)
        with capture.Capture(model, pre.plan.metas) as cap:
            loss = ((model(x) - y) ** 2).mean()
            capture.check_local_mean_loss(loss, None, group)
            loss.backward()
        with coll.ledger() as led:
            grads = coll.average_grads(
                {k: p.grad for k, p in params.items()}, group)
            new_grads, state = pre.step(state, grads, cap.acts, cap.gs,
                                        **ladder)
        if i == cfg.get('ledger_step', 0):
            out['ledger'] = [(scope, op, str(dtype), n)
                             for scope, op, dtype, n in led]
        if cfg.get('sgd'):
            with torch.no_grad():
                for k, p in params.items():
                    p.add_(new_grads[k], alpha=-pre.lr)
        out['steps'].append({
            'loss': float(coll.pmean(loss.detach(), group)),
            'grads': {k: v.detach().numpy().copy()
                      for k, v in new_grads.items()},
            'factors': {k: v.numpy().copy() for k, v in state.factors.items()},
            'comm_err': (None if state.comm_err is None else
                         {k: v.numpy().copy()
                          for k, v in state.comm_err.items()}),
            'scales': ({k: v.numpy().copy()
                        for k, v in state.decomp['scales'].items()}
                       if 'scales' in state.decomp else None)})
        if phases is not None:
            out['steps'][-1]['decomp_in'] = decomp_in
        if 'kfac' in cfg or 'ladder' in cfg:
            out['steps'][-1]['decomp'] = _np_tree(state.decomp)
    return out


def _np_tree(decomp):
    return {part: {k: v.numpy().copy() for k, v in tree.items()}
            for part, tree in decomp.items()}


def run_many(rank, world, group, cfgs):
    """:func:`run_steps` of every config, in one process group (one
    thread a rank: the tensors are tiny, and the ranks share the cores)."""
    torch.set_num_threads(1)
    return [run_steps(rank, world, group, cfg) for cfg in cfgs]


def collective_inputs(world, seed):
    """Every rank's inputs of :func:`collective_cases`: random rows, rows
    of +-1 (alternating by rank, so they cancel in the sum) plus 1e-3
    noise, with bf16-visible rounding error but a sum whose bf16 output
    rounding is small beside it, and rows to gather."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(world, 4 * world, 3, 3).astype(np.float32)
    sign = np.where(np.arange(world) % 2, -1.0, 1.0)[:, None, None, None]
    near_one = (sign + 0.001 * rng.randn(world, 4 * world, 3, 3)
                ).astype(np.float32)
    gath = rng.randn(world, 2, 6, 6).astype(np.float32)
    return xs, near_one, gath


def collective_cases(rank, world, group, seed):
    """Every compression-aware collective on this rank's inputs (drawn
    from ``seed`` for every rank, each rank its own slice): returns
    numpy results the test holds to their contracts."""
    torch.set_num_threads(1)
    xs, near_one, gath = collective_inputs(world, seed)
    x = torch.from_numpy(xs[rank])
    out = {}
    got, _ = coll.pmean_scatter_ef(x, group, 'fp32', None)
    full = coll.pmean(x, group)
    out['scatter'] = got.numpy()
    out['pmean_rows'] = full[rank * 4:(rank + 1) * 4].numpy()

    # bf16 EF over 8 reduces of the same data, against the residual-free
    # reduce; the fused prep (K3's plain version on the CPU) bit for bit
    xb = torch.from_numpy(near_one[rank])
    r = torch.zeros_like(xb)
    tot_ef = tot_ne = 0.0
    firsts = None
    for _ in range(8):
        m, r_new = coll.pmean_scatter_ef(xb, group, 'bf16', r)
        mf, rf = coll.pmean_scatter_ef(xb, group, 'bf16', r, fused=True)
        assert torch.equal(m, mf) and torch.equal(r_new, rf)
        firsts = r_new if firsts is None else firsts
        r = r_new
        tot_ef = tot_ef + m
        mn, _ = coll.pmean_scatter_ef(xb, group, 'bf16', torch.zeros_like(xb))
        tot_ne = tot_ne + mn
    out.update(ef_mean=(tot_ef / 8).numpy(), ne_mean=(tot_ne / 8).numpy(),
               r1=firsts.numpy(), rk=r.numpy(),
               bf16_once=coll.pmean_scatter_ef(
                   xb, group, 'bf16', torch.zeros_like(xb))[0].numpy(),
               int8_once=coll.pmean_scatter_ef(
                   xb, group, 'int8', torch.zeros_like(xb))[0].numpy())

    g = torch.from_numpy(gath[rank])
    with coll.ledger() as led:
        for prec in ('fp32', 'bf16', 'int8'):
            out[f'gather_{prec}'] = coll.all_gather_rows_compressed(
                g, group, prec).numpy()
    out['gather_ledger'] = [(op, str(dt), n) for _, op, dt, n in led]
    out['wire_mean_bf16'] = coll.pmean_wire(x, group, 'bf16').numpy()
    out['psum'] = coll.psum(x, group).numpy()
    # the decomposition gather, and its no-communication ablation: each
    # rank's rows at its offset, zeros elsewhere
    decomp = {'evals': {'6': g[:, 0]}, 'evecs': {'6': g}}
    plan = type('Plan', (), {'num_devices': world})
    for communicate in (True, False):
        got = engine.gather_decomposition(plan, decomp, group, communicate,
                                          'bf16')
        out[f'gather_decomp_{communicate}'] = {
            part: {k: v.numpy() for k, v in tree.items()}
            for part, tree in got.items()}
    # a loss reduced over the group before its backward breaks the
    # local-mean convention
    w = torch.ones(3, requires_grad=True)
    import torch.distributed.nn.functional as dfn
    try:
        capture.check_local_mean_loss(
            dfn.all_reduce((w * 2).sum(), group=group), None, group)
        out['guard'] = 'passed'
    except ValueError:
        out['guard'] = 'raised'
    capture.check_local_mean_loss((w * 2).sum(), None, group)
    return out


def _digest(tensors, seed=''):
    import hashlib
    h = hashlib.sha1(seed.encode())
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _state_digests(state):
    """SHA-1s of a train state, bit for bit: ``'replica'`` of what every
    rank holds alike (parameters, buffers, momentum) and ``'kfac'`` of
    this rank's own K-FAC state (factor rows, decomposition, residual)."""
    from kfac_pytorch_tpu_torch import training
    ks = state.kfac_state
    return {'replica': _digest(capture.tensor_leaves(state.opt_state),
                               training.replica_digest(state.model)),
            'kfac': _digest(capture.tensor_leaves(
                [ks.factors, ks.decomp, ks.comm_err]))}


def guarded_runs(rank, world, group, cfgs):
    """Per config: TinyCNN trained through ``training.build_train_step``
    (the health guard on) on this rank's shard of every batch, the
    faulted run (``cfg['batches']``) and its control (the same batches
    without ``cfg['skip']``). Returns each run's per-step ``health/*``
    and the digests of its final state (:func:`_state_digests`)."""
    from kfac_pytorch_tpu_torch import training
    torch.set_num_threads(1)
    out = []
    for cfg in cfgs:
        runs = {}
        control = [b for i, b in enumerate(cfg['batches'])
                   if i != cfg['skip']]
        for name, batches in (('faulted', cfg['batches']),
                              ('control', control)):
            torch.manual_seed(0)
            model = TinyCNN().to(memory_format=torch.channels_last)
            pre = KFAC(variant=cfg['variant'], num_devices=world,
                       group=group, bucket_fn=bucket_tiny,
                       comm_precision=cfg['comm_precision'],
                       kfac_update_freq=1, damping=0.003, lr=0.1)
            tx = training.sgd(0.1, momentum=0.9, weight_decay=5e-4)
            per = batches[0]['input'].shape[0] // world
            shard = [{k: torch.from_numpy(v[rank * per:(rank + 1) * per])
                      for k, v in b.items()} for b in batches]
            state = training.init_train_state(model, tx, pre,
                                              shard[0]['input'], 'cpu')
            step = training.build_train_step(
                model, tx, pre,
                lambda o, b: F.cross_entropy(o, b['label']))
            mets = []
            for b in shard:
                state, m = step(state, b)
                mets.append({k[len('health/'):]: int(v)
                             for k, v in m.items() if k.startswith('health/')})
            runs[name] = {'mets': mets, **_state_digests(state)}
        out.append(runs)
    return out


def shard_module_runs(rank, world, group, cfgs, trainer_argv, steps):
    """:func:`run_many` of ``cfgs``, then ``train_cifar`` with
    ``trainer_argv`` for ``steps`` steps in the same group: per step the
    loss, the decomposition the step ran and this rank's replica digest
    (``training.replica_digest``)."""
    from kfac_pytorch_tpu_torch import train_cifar, training
    runs = run_many(rank, world, group, cfgs)
    args = train_cifar.parse_args(trainer_argv + ['--device', 'cpu',
                                                  '--num-devices', str(world)])
    tr = train_cifar.Trainer(args, group=group)
    trained = []
    with tr.train_loader.epoch() as batches:
        for _, batch in zip(range(steps), batches):
            m = tr.train_step(batch)
            trained.append((float(m['loss']), tr.step_fn.last_decomp,
                            training.replica_digest(tr.state.model)))
    return runs, {'steps': trained,
                  'stagger': tr.precond.stagger,
                  'shard': tr.precond.decomp_shard_plan is not None}


def cifar_main_run(rank, world, group, argv):
    """``train_cifar.main`` with ``argv`` at ``--num-devices world`` in
    ``group`` (on the CPU); returns this rank's K-FAC factor rows and
    decomposition (numpy) and whether the state holds a decomposition."""
    from kfac_pytorch_tpu_torch import train_cifar
    torch.set_num_threads(1)
    tr = train_cifar.main(argv + ['--device', 'cpu', '--num-devices',
                                  str(world)], group=group)
    st = tr.state.kfac_state
    return {'factors': {k: v.numpy().copy() for k, v in st.factors.items()},
            'decomp': _np_tree(st.decomp), 'decomposed': tr.state.decomposed,
            'step': tr.state.step}


def seeded_kfac_state(pre, rank, seed=0):
    """``pre.init('cpu')`` with factors and decomposition filled from a
    seeded stream of this rank's own."""
    st = pre.init('cpu')
    gen = torch.Generator().manual_seed(seed + 100 * rank)
    st.factors = {k: torch.randn(v.shape, generator=gen)
                  for k, v in st.factors.items()}
    st.decomp = {p: {k: torch.randn(v.shape, generator=gen)
                     for k, v in tree.items()}
                 for p, tree in st.decomp.items()}
    st.step = 5
    return st


def live_replans(rank, world, group):
    """Two replans of a world-2 ``eigen`` preconditioner with a live group,
    on seeded states (:func:`seeded_kfac_state`): to ``eigen_dp`` (this
    rank's entry comes back), then to one rank without a group (the whole
    world-1 state comes back on every rank). Returns both (numpy)."""
    torch.set_num_threads(1)
    pre = KFAC(variant='eigen', num_devices=world, group=group,
               bucket_fn=bucket_tiny)
    pre.setup(capture.collect_layer_meta(MLP(), torch.zeros(2, 5)))
    st = seeded_kfac_state(pre, rank)
    out = []
    st = pre.replan(st, variant='eigen_dp')
    out.append({'factors': {k: v.numpy() for k, v in st.factors.items()},
                'decomp': _np_tree(st.decomp)})
    st = pre.replan(st, num_devices=1, group=None)
    out.append({'factors': {k: v.numpy() for k, v in st.factors.items()},
                'decomp': _np_tree(st.decomp),
                'world': pre.num_devices, 'group': pre.group is None})
    return out


def exclude_parts_runs(rank, world, group, cfgs):
    """:func:`run_steps` of every config (``cfg['kfac']`` carries the
    ``exclude_parts``), each with the calls of K3's plain version (the
    error-feedback prep of the lossy stats reduce) it made."""
    torch.set_num_threads(1)
    plain, calls = ck._ef_quantize_plain, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    ck._ef_quantize_plain = counted
    try:
        out = []
        for cfg in cfgs:
            calls[0] = 0
            out.append({**run_steps(rank, world, group, cfg),
                        'k3_calls': calls[0]})
        return out
    finally:
        ck._ef_quantize_plain = plain
