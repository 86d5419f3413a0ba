"""K-FAC step phases over the stacked-bucket layout (port of
``kfac_pytorch_tpu/engine.py``).

  compute_layer_stats / stack_stats / update_factors   factor statistics
                           (pmean reduce-scatter for MPD; none for DP)
  update_factors_fused     world=1 local statistics with the EMA inside
                           the capture kernels
  compute_decomposition    batched eigh (or pi-damped Cholesky inverse)
                           of this rank's factor rows, cold or warm
  refresh_decomposition    eigenvalues only, in the retained basis
  compute/merge_cohort_decomposition   one staggered cohort's rows
  compute/merge_shard_decomposition    the same cohort decomposed
                           balanced across every rank (decomp_shard)
  gather_decomposition     all-gather of the decomposition (comm_inverse)
  update_ekfac_scales(_local) / rotate_ekfac_scales(_local)
                           E-KFAC moments in the eigenbasis and their
                           transport across a basis change
  compute_pred_replicated  every layer preconditioned on every rank
  compute_pred_local       owner-computes preconditioning + gather
                           (comm_pred)
  preconditioned_grads     KL clip + write-back

Every function is written per rank, as the JAX versions are per device:
``group`` is the K-FAC process group (``parallel.collectives``), and
``None`` is the world=1 path with zero communication. A rank holds its
own ``per_dev`` factor rows of each bucket; static ``[P, ...]`` plan
tables are read at this rank's row.

Gradients are a ``{torch parameter name: tensor}`` dict; a layer's matrix
form is ``[out, in(+bias)]`` with a conv weight (OIHW) flattened as
``w.permute(0, 2, 3, 1).reshape(c_out, -1)``, the ``(kh, kw, c_in)``
order of factor A. Functions return new tensors; the input state is not
modified.
"""

import torch

from kfac_pytorch_tpu_torch import capture, ops
from kfac_pytorch_tpu_torch.ops import capture_kernels
from kfac_pytorch_tpu_torch.parallel import collectives as coll


def _key(bdim):
    return str(bdim)


def _local_table(arr, group):
    """This rank's row of a static ``[P, ...]`` plan table."""
    return arr[coll.axis_index(group)]


def _long(x, device):
    return torch.as_tensor(x, device=device, dtype=torch.long)


# ---------------------------------------------------------------------------
# Grad matrix <-> grads dict
# ---------------------------------------------------------------------------

def layer_grad_matrix(meta, grads):
    """Matrix-form gradient ``[out_dim, in_dim(+bias col)]`` in fp32."""
    w = grads[meta.module_name + '.weight']
    gm = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1) if meta.kind == 'conv' \
        else w
    gm = gm.to(torch.float32)
    if meta.use_bias:
        b = grads[meta.module_name + '.bias'].to(torch.float32)
        gm = torch.cat([gm, b[:, None]], dim=1)
    return gm


def write_grad_matrix(meta, grads, mat):
    """Inverse of :func:`layer_grad_matrix`: a new grads dict with
    ``meta``'s weight (and bias) replaced by ``mat``."""
    out = dict(grads)
    wname = meta.module_name + '.weight'
    if meta.use_bias:
        bname = meta.module_name + '.bias'
        mat, b = mat[:, :-1], mat[:, -1]
        out[bname] = b.to(grads[bname].dtype)
    w = grads[wname]
    if meta.kind == 'conv':
        cout, cin, kh, kw = w.shape
        mat = mat.reshape(cout, kh, kw, cin).permute(0, 3, 1, 2)
    out[wname] = mat.to(w.dtype)
    return out


def _pad_mat(mat, dg, da):
    out, inn = mat.shape
    return torch.nn.functional.pad(mat, (0, da - inn, 0, dg - out))


# ---------------------------------------------------------------------------
# Phase 1: factor statistics
# ---------------------------------------------------------------------------

def compute_layer_stats(plan, acts, gs, batch_averaged=True,
                        capture_impl=None):
    """Per-layer factor statistics from captured ``(a, g)`` of this rank's
    batch. ``capture_impl='pallas'`` computes each through the capture
    kernels (K1 for a conv's A, K2 for the rest; their plain versions on
    CPU tensors), anything else through the plain ops."""
    back = capture_kernels if capture_impl == 'pallas' else ops
    a_list, g_list = [], []
    for meta in plan.metas:
        a = capture.layer_act(acts, meta).contiguous()
        g = capture.layer_g(gs, meta).contiguous()
        if meta.kind == 'dense':
            a_list.append(back.compute_a_dense(a, meta.use_bias))
            g_list.append(back.compute_g_dense(g, batch_averaged))
        else:
            a_list.append(back.compute_a_conv(
                a, meta.kernel_size, meta.strides, meta.padding,
                meta.use_bias))
            g_list.append(back.compute_g_conv(g, batch_averaged))
    return a_list, g_list


def stack_stats(plan, a_list, g_list):
    """Scatter per-layer stats into the global stacked-bucket layout
    (identity padding; dummy rows are the identity)."""
    out = {}
    device = a_list[0].device
    for bdim in plan.bucket_dims:
        rows = []
        for s in plan.buckets[bdim].slot_of_row:
            if s is None:
                rows.append(torch.eye(bdim, dtype=torch.float32,
                                      device=device))
            else:
                mat = a_list[s.layer_idx] if s.side == 'A' \
                    else g_list[s.layer_idx]
                rows.append(ops.identity_pad(mat, bdim))
        out[_key(bdim)] = torch.stack(rows)
    return out


def update_factors(plan, factors_local, stats_stacked, factor_decay,
                   stats_reduce, group, comm_precision='fp32',
                   comm_err=None, capture_impl=None):
    """Running-average update of this rank's factor rows.

    ``stats_reduce='pmean'`` (MPD): the factors average the statistics of
    the global batch — a reduce-scatter of the stacked stats
    (:func:`collectives.pmean_scatter_ef`), each rank receiving its own
    rows, over the ``comm_precision`` wire; lossy wires fold their
    rounding error into ``comm_err`` (this rank's residual, keyed like
    the stats) for the next reduce, and ``capture_impl='pallas'`` runs
    that prep as one kernel (K3). ``'local'`` (DP): this rank's rows of
    its own statistics, no communication.

    Returns ``(new factors, new comm_err)``; ``comm_err`` passes through
    on the fp32, local and ``group=None`` paths."""
    new = {}
    new_err = None if comm_err is None else dict(comm_err)
    idx = coll.axis_index(group)
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        b = plan.buckets[bdim]
        stats = stats_stacked[key]
        if stats_reduce == 'pmean':
            err_in = None if comm_err is None else comm_err[key]
            with coll.named_scope('kfac.CommunicateFactor', profile=True):
                local, err = coll.pmean_scatter_ef(
                    stats, group, comm_precision, err_in,
                    fused=(capture_impl == 'pallas'))
            if new_err is not None and err is not None:
                new_err[key] = err
        else:
            local = stats[idx * b.per_dev:(idx + 1) * b.per_dev]
        new[key] = ops.update_running_avg(local, factors_local[key],
                                          factor_decay)
    return new, new_err


def update_factors_fused(plan, factors_local, acts, gs, batch_averaged,
                         factor_decay):
    """World=1 local statistics with the EMA folded into the capture
    kernels: one K1/K2 launch per real factor row, whose epilogue emits
    ``update_running_avg(stat, current, factor_decay)``. Identity padding
    and dummy rows take the unfused arithmetic (EMA against the eye
    template), so the result matches ``stack_stats`` + ``update_factors``
    up to the statistic's summation order. Only for one rank: at world>1
    each rank keeps just its own rows of everyone's statistics."""
    if plan.num_devices != 1:
        raise ValueError('update_factors_fused is the world=1 path; at '
                         'world>1 use compute_layer_stats + update_factors')
    ck = capture_kernels
    new = {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        b = plan.buckets[bdim]
        cur_all = factors_local[key]
        # EMA of every row against its identity_pad template (eye on the
        # pad diagonal, zeros in the true block; the full eye on dummies)
        true = torch.as_tensor(
            [s.dim if s is not None else 0 for s in b.slot_of_row],
            device=cur_all.device)
        pad_diag = torch.arange(bdim, device=cur_all.device) >= true[:, None]
        out = ops.update_running_avg(
            torch.diag_embed(pad_diag.to(torch.float32)), cur_all,
            factor_decay)
        for r, s in enumerate(b.slot_of_row):
            if s is None:
                continue
            meta = plan.metas[s.layer_idx]
            f = s.dim
            ema = (cur_all[r, :f, :f].contiguous(), factor_decay)
            if s.side == 'A':
                a = capture.layer_act(acts, meta).contiguous()
                if meta.kind == 'dense':
                    stat = ck.compute_a_dense(a, meta.use_bias, ema=ema)
                else:
                    stat = ck.compute_a_conv(
                        a, meta.kernel_size, meta.strides, meta.padding,
                        meta.use_bias, ema=ema)
            else:
                g = capture.layer_g(gs, meta).contiguous()
                if meta.kind == 'dense':
                    stat = ck.compute_g_dense(g, batch_averaged, ema=ema)
                else:
                    stat = ck.compute_g_conv(g, batch_averaged, ema=ema)
            out[r, :f, :f] = stat
        new[key] = out
    return new


# ---------------------------------------------------------------------------
# Phase 2: decomposition (batched, on this rank's rows)
# ---------------------------------------------------------------------------

def _local_trace_avgs(plan, factors_local, group):
    """Per local slot ``trace / true_dim`` (flat, concatenated over
    buckets in bucket_dims order) — the pi-damping inputs."""
    trace_parts, dim_parts = [], []
    for bdim in plan.bucket_dims:
        b = plan.buckets[bdim]
        f = factors_local[_key(bdim)]
        tdl = torch.as_tensor(_local_table(
            b.true_dims.reshape(plan.num_devices, b.per_dev), group),
            device=f.device)
        trace_parts.append(ops.masked_trace(f, tdl))
        dim_parts.append(tdl)
    return torch.cat(trace_parts) / torch.cat(dim_parts).to(torch.float32)


#: Newton-Schulz acceptance threshold on the result's residual ``max |I -
#: A X|``: healthy tracking sits at fp32 noise, and a slot still 5% off
#: had too stale a seed, so the batched Cholesky recomputes that slot
NS_ACCEPT_RESID = 0.05


def _ns_iters(warm_sweeps):
    return 2 if warm_sweeps is None else max(int(warm_sweeps), 1)


def compute_decomposition(plan, factors_local, damping, method, eps,
                          group=None, basis_local=None, warm_sweeps=None,
                          invs_prev_local=None, impl=None):
    """Batched eigh (eigenvalues ``<= eps`` clamped to zero) or pi-damped
    Cholesky inverse of this rank's factor rows: both factor sides take
    ``sqrt(damping * own_trace_avg / mate_trace_avg)`` on the diagonal
    (the plan's mate maps keep a layer's two factors on one rank).

    ``basis_local`` (:func:`local_evecs`) warm-starts the eigh path when
    ``impl`` (``ops.sym_eig``'s; None reads ``KFAC_EIGH_IMPL``) is
    'subspace', 'auto' or 'jacobi'; ``invs_prev_local``
    (:func:`local_invs`) seeds the Cholesky path's Newton-Schulz warm
    inverse, each slot gated at ``NS_ACCEPT_RESID``. ``warm_sweeps``
    overrides the warm iteration count (None = the kernel's default)."""
    if method == 'eigh':
        evals, evecs = {}, {}
        for bdim in plan.bucket_dims:
            key = _key(bdim)
            basis = None if basis_local is None else basis_local[key]
            d, q = ops.sym_eig(factors_local[key], impl=impl, basis=basis,
                               sweeps=warm_sweeps if basis is not None
                               else None)
            evals[key] = ops.clamp_eigvals(d, eps)
            evecs[key] = q
        return {'evals': evals, 'evecs': evecs}

    invs = {}
    for key, lam in pi_damping(plan, factors_local, damping, group).items():
        damped = ops.add_scaled_identity(factors_local[key], lam)
        if invs_prev_local is None:
            invs[key] = ops.psd_inverse(damped)
        else:
            invs[key] = ops.warm_inverse(damped, invs_prev_local[key],
                                         iters=_ns_iters(warm_sweeps),
                                         accept_resid=NS_ACCEPT_RESID)
    return {'invs': invs}


def pi_damping(plan, factors_local, damping, group=None):
    """Per bucket, the Cholesky path's diagonal shift of each of this
    rank's factor rows, ``sqrt(damping * own_trace_avg /
    mate_trace_avg)``."""
    flat_avg = _local_trace_avgs(plan, factors_local, group)
    out = {}
    for bdim in plan.bucket_dims:
        b = plan.buckets[bdim]
        off = plan.local_flat_offsets[bdim]
        own_avg = flat_avg[off:off + b.per_dev]
        mate = _long(_local_table(b.mate_flat, group), flat_avg.device)
        out[_key(bdim)] = torch.sqrt(damping * own_avg / flat_avg[mate])
    return out


def _local_rows(plan, tree, group, comm_mode):
    """Per bucket: this rank's rows of a stored decomposition component
    (already local in 'pred' mode; sliced out of the gathered, replicated
    layout in 'inverse' mode)."""
    out = {}
    idx = coll.axis_index(group)
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        x = tree[key]
        if comm_mode == 'inverse':
            per_dev = plan.buckets[bdim].per_dev
            x = x[idx * per_dev:(idx + 1) * per_dev]
        out[key] = x
    return out


def local_decomposition(plan, decomp, group, comm_mode, method):
    """This rank's rows of a stored decomposition, raw (the guard below
    does its own cold handling)."""
    if method == 'eigh':
        return {'evals': _local_rows(plan, decomp['evals'], group,
                                     comm_mode),
                'evecs': _local_rows(plan, decomp['evecs'], group,
                                     comm_mode)}
    return {'invs': _local_rows(plan, decomp['invs'], group, comm_mode)}


def local_evecs(plan, decomp, group, comm_mode):
    """This rank's eigenbasis rows of a stored decomposition, a
    never-decomposed (all-zero) row as the identity: a warm request on a
    fresh state then degrades to a cold decomposition instead of rotating
    into a zero basis."""
    return {key: _zero_rows_as_identity(q) for key, q in
            _local_rows(plan, decomp['evecs'], group, comm_mode).items()}


def _zero_rows_as_identity(q):
    """``[rows, D, D]`` with every all-zero (never decomposed) row
    replaced by the identity."""
    valid = torch.any((q != 0).flatten(1), dim=1)[:, None, None]
    return torch.where(valid, q, torch.eye(q.shape[-1], dtype=q.dtype,
                                           device=q.device))


def local_invs(plan, decomp, group, comm_mode):
    """This rank's stored inverse rows, the Newton-Schulz seeds. A
    never-computed (all-zero) row stays zero: its residual ``||I|| = 1``
    fails the acceptance gate and the slot takes the Cholesky."""
    return _local_rows(plan, decomp['invs'], group, comm_mode)


def refresh_decomposition(plan, factors_local, decomp_prev, eps, group,
                          comm_mode, communicate=True, comm_precision='fp32'):
    """Eigenvalue-only refresh in the retained basis: ``d <- clamp(diag(Q^T
    F Q))`` per bucket, two batched matmuls instead of an eigh. In
    comm_mode 'inverse' only the eigenvalue vectors are re-gathered (the
    replicated basis stays put; with ``communicate=False``, the
    CommunicateInverse ablation, each rank places its own rows, zeros
    elsewhere). ``decomp_prev`` is the stored decomposition (this rank's
    rows in 'pred' mode, all rows in 'inverse'); the result has the same
    layout."""
    evecs_local = local_evecs(plan, decomp_prev, group, comm_mode)
    evals = {key: refresh_evals(factors_local[key], q, eps)
             for key, q in evecs_local.items()}
    if comm_mode == 'inverse':
        evals = gather_decomposition(plan, {'evals': evals}, group,
                                     communicate=communicate,
                                     comm_precision=comm_precision)['evals']
        return {'evals': evals, 'evecs': decomp_prev['evecs']}
    return {'evals': evals, 'evecs': evecs_local}


def refresh_evals(f, q, eps):
    """One bucket's refreshed eigenvalues ``clamp(diag(Q^T F Q))``."""
    with ops.fp32_matmul():
        return ops.clamp_eigvals(torch.sum(q * (f @ q), dim=1), eps)


def _cohort_rows(tbl, cohort_idx, group, device):
    """This rank's row of a static ``[F, P, R]`` cohort table at the
    step's cohort, on ``device``."""
    return _long(tbl[cohort_idx, coll.axis_index(group)], device)


def _cohort_sel(plan, cohorts, cohort_idx, group, device):
    """Per bucket, this rank's local rows of cohort ``cohort_idx``."""
    return {bdim: _cohort_rows(cohorts.rows[bdim], cohort_idx, group, device)
            for bdim in plan.bucket_dims}


def _damped_cohort_factors(plan, cohorts, factors_local, sel, cohort_idx,
                           damping, method, group):
    """This rank's cohort factor rows (``sel``), damped as the cohort
    decomposition damps them: the Cholesky path pi-damps with the traces
    of all local rows, as the full path would; eigh rows go out raw (the
    eigh path damps in the pred denominators). The sharded exchange sends
    these matrices, so a remote decomposition sees the owner's bits."""
    flat_avg = None
    if method != 'eigh':
        flat_avg = _local_trace_avgs(plan, factors_local, group)
    out = {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        f = factors_local[key][sel[bdim]]
        if flat_avg is not None:
            dev = f.device
            own = _cohort_rows(cohorts.own_flat[bdim], cohort_idx, group, dev)
            mate = _cohort_rows(cohorts.mate_flat[bdim], cohort_idx, group,
                                dev)
            f = ops.add_scaled_identity(
                f, torch.sqrt(damping * flat_avg[own] / flat_avg[mate]))
        out[key] = f
    return out


def compute_cohort_decomposition(plan, cohorts, factors_local, cohort_idx,
                                 damping, method, eps, group=None,
                                 impl=None, decomp_prev=None,
                                 comm_mode=None, warm_sweeps=None):
    """Decompose only cohort ``cohort_idx``'s rows of this rank's factors
    (``plan.build_cohorts``): ``R_b`` rows per bucket instead of
    ``per_dev``. Returns cohort-shaped components for
    :func:`merge_cohort_decomposition`; padding rows decompose a real
    row whose result the merge discards. The Cholesky path damps with
    the traces of all local rows, as the full path would
    (:func:`_damped_cohort_factors`). With an iterative ``impl`` and the
    stored ``decomp_prev`` (in ``comm_mode``'s layout) the rows
    warm-start from their own stored basis or inverse."""
    dev = next(iter(factors_local.values())).device
    sel = _cohort_sel(plan, cohorts, cohort_idx, group, dev)
    rows = _damped_cohort_factors(plan, cohorts, factors_local, sel,
                                  cohort_idx, damping, method, group)
    if method == 'eigh':
        basis_local = None
        if (impl in ('subspace', 'jacobi', 'auto')
                and decomp_prev is not None):
            basis_local = local_evecs(plan, decomp_prev, group, comm_mode)
        evals, evecs = {}, {}
        for bdim in plan.bucket_dims:
            key = _key(bdim)
            basis = (None if basis_local is None
                     else basis_local[key][sel[bdim]])
            d, q = ops.sym_eig(rows[key], impl=impl, basis=basis,
                               sweeps=warm_sweeps if basis is not None
                               else None)
            evals[key] = ops.clamp_eigvals(d, eps)
            evecs[key] = q
        return {'evals': evals, 'evecs': evecs}

    invs_prev = None
    if impl == 'newton_schulz' and decomp_prev is not None:
        invs_prev = local_invs(plan, decomp_prev, group, comm_mode)
    invs = {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        if invs_prev is None:
            invs[key] = ops.psd_inverse(rows[key])
        else:
            invs[key] = ops.warm_inverse(rows[key], invs_prev[key][sel[bdim]],
                                         iters=_ns_iters(warm_sweeps),
                                         accept_resid=NS_ACCEPT_RESID)
    return {'invs': invs}


def compute_shard_decomposition(plan, cohorts, shard, factors_local,
                                cohort_idx, damping, method, eps,
                                group=None, impl=None, decomp_prev=None,
                                comm_mode=None, warm_sweeps=None,
                                comm_precision='fp32'):
    """The sharded cohort decomposition (``plan.build_decomp_shard``):
    every owner damps its cohort rows (:func:`_damped_cohort_factors`),
    the cohort is all-gathered (``kfac.DecompComm``, ``P * R_b`` matrices
    a bucket) and this rank decomposes the ``S_b`` gathered slots its
    shard table names. Returns this rank's results, ``[S_b, ...]`` per
    bucket, for :func:`merge_shard_decomposition`.

    Warm seeds for an iterative ``impl`` come from the stored
    decomposition through ``src_global`` only in comm_mode 'inverse',
    where every rank holds every row; under 'pred' the stored rows are
    the owners', so the shard path always runs the cold kernel."""
    dev = next(iter(factors_local.values())).device
    sel = _cohort_sel(plan, cohorts, cohort_idx, group, dev)
    damped = _damped_cohort_factors(plan, cohorts, factors_local, sel,
                                    cohort_idx, damping, method, group)
    warm = (decomp_prev is not None and comm_mode == 'inverse'
            and impl in (('subspace', 'jacobi', 'auto') if method == 'eigh'
                         else ('newton_schulz',)))
    out_d, out_q, out_i = {}, {}, {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        gathered = coll.decomp_exchange_gather(damped[key], group,
                                               comm_precision)
        mine = gathered[_cohort_rows(shard.src[bdim], cohort_idx, group,
                                     dev)]
        if warm:
            rows = _cohort_rows(shard.src_global[bdim], cohort_idx, group,
                                dev)
        if method == 'eigh':
            basis = (_zero_rows_as_identity(decomp_prev['evecs'][key][rows])
                     if warm else None)
            d, q = ops.sym_eig(mine, impl=impl, basis=basis,
                               sweeps=warm_sweeps if warm else None)
            out_d[key] = ops.clamp_eigvals(d, eps)
            out_q[key] = q
        elif warm:
            out_i[key] = ops.warm_inverse(mine, decomp_prev['invs'][key][rows],
                                          iters=_ns_iters(warm_sweeps),
                                          accept_resid=NS_ACCEPT_RESID)
        else:
            out_i[key] = ops.psd_inverse(mine)
    if method == 'eigh':
        return {'evals': out_d, 'evecs': out_q}
    return {'invs': out_i}


def merge_shard_decomposition(plan, shard, decomp_stored, shard_new,
                              cohort_idx, group, comm_mode, method,
                              guard=True, comm_precision='fp32'):
    """Return the sharded cohort's results to their stored rows: the
    results are all-gathered (the second ``kfac.DecompComm`` leg) and
    every stored row gathers its fresh value through ``res_slot``; rows
    outside the cohort keep their stored bits. A merge by gather: no two
    writes meet. Under comm_mode 'pred' the tables are reshaped to ``[F,
    P, per_dev]`` and this rank takes its own block. With ``guard`` a row
    whose fresh value is not finite keeps its stored value (evals and
    evecs commit together, or not at all)."""
    P = plan.num_devices
    part = 'evals' if method == 'eigh' else 'invs'
    dev = next(iter(decomp_stored[part].values())).device

    def tables(bdim):
        slots = shard.res_slot[bdim][cohort_idx]
        valid = shard.res_valid[bdim][cohort_idx]
        if comm_mode != 'inverse':
            idx = coll.axis_index(group)
            slots, valid = slots.reshape(P, -1)[idx], valid.reshape(P, -1)[idx]
        return _long(slots, dev), torch.as_tensor(valid, device=dev)

    def pick(ok, fresh, stored):
        return torch.where(ok.reshape(ok.shape + (1,) * (stored.ndim - 1)),
                           fresh, stored)

    def gather(x):
        return coll.decomp_exchange_gather(x, group, comm_precision)

    out = dict(decomp_stored)
    if method == 'eigh':
        new_d, new_q = {}, {}
        for bdim in plan.bucket_dims:
            key = _key(bdim)
            slots, ok = tables(bdim)
            fresh_d = gather(shard_new['evals'][key])[slots]
            fresh_q = gather(shard_new['evecs'][key])[slots]
            if guard:
                ok = ok & _rows_finite(fresh_d) & _rows_finite(fresh_q)
            new_d[key] = pick(ok, fresh_d, decomp_stored['evals'][key])
            new_q[key] = pick(ok, fresh_q, decomp_stored['evecs'][key])
        out['evals'], out['evecs'] = new_d, new_q
        return out
    new_i = {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        slots, ok = tables(bdim)
        fresh = gather(shard_new['invs'][key])[slots]
        if guard:
            ok = ok & _rows_finite(fresh)
        new_i[key] = pick(ok, fresh, decomp_stored['invs'][key])
    out['invs'] = new_i
    return out


def merge_cohort_decomposition(plan, cohorts, decomp_stored, cohort_new,
                               cohort_idx, group, comm_mode, method,
                               communicate=True, guard=True,
                               comm_precision='fp32'):
    """Write the freshly decomposed cohort rows into the stored
    decomposition; every other row keeps its stored bits. comm_mode
    'pred': a local scatter; 'inverse': the cohort rows are all-gathered
    first (``sum_b R_b`` rows a step), or with ``communicate=False`` (the
    CommunicateInverse ablation) each rank writes only its own rows at
    their global offsets. With ``guard`` a row that is not
    finite keeps its stored value (the staggered form of
    :func:`guard_decomposition`; evals and evecs commit together); padding
    rows write their stored value back, so no two writes to a row
    differ."""
    part = 'evals' if method == 'eigh' else 'invs'
    dev = next(iter(decomp_stored[part].values())).device
    idx = coll.axis_index(group)
    if comm_mode == 'inverse' and communicate:
        rows = {b: _long(cohorts.global_rows[b][cohort_idx], dev)
                for b in plan.bucket_dims}
        valid = {b: torch.as_tensor(cohorts.global_valid[b][cohort_idx],
                                    device=dev) for b in plan.bucket_dims}

        def gather(x):
            with coll.named_scope('kfac.CommunicateInverse'):
                return coll.all_gather_rows_compressed(x, group,
                                                       comm_precision)
    else:
        if comm_mode == 'inverse':
            # this rank's stretch of the global cohort tables
            def own(tbl):
                f, pr = tbl.shape
                return tbl.reshape(f, plan.num_devices,
                                   pr // plan.num_devices)[cohort_idx, idx]
            rows = {b: _long(own(cohorts.global_rows[b]), dev)
                    for b in plan.bucket_dims}
            valid = {b: torch.as_tensor(own(cohorts.global_valid[b]),
                                        device=dev)
                     for b in plan.bucket_dims}
        else:
            rows = {b: _long(cohorts.rows[b][cohort_idx, idx], dev)
                    for b in plan.bucket_dims}
            valid = {b: torch.as_tensor(cohorts.valid[b][cohort_idx, idx],
                                        device=dev)
                     for b in plan.bucket_dims}

        def gather(x):
            return x

    def put(stored, r, ok, fresh):
        out = stored.clone()
        okr = ok.reshape(ok.shape + (1,) * (stored.ndim - 1))
        out[r] = torch.where(okr, fresh, stored[r])
        return out

    out = dict(decomp_stored)
    if method == 'eigh':
        new_d, new_q = {}, {}
        for bdim in plan.bucket_dims:
            key = _key(bdim)
            dn = gather(cohort_new['evals'][key])
            qn = gather(cohort_new['evecs'][key])
            ok = valid[bdim]
            if guard:
                ok = ok & _rows_finite(dn) & _rows_finite(qn)
            new_d[key] = put(decomp_stored['evals'][key], rows[bdim], ok, dn)
            new_q[key] = put(decomp_stored['evecs'][key], rows[bdim], ok, qn)
        out['evals'], out['evecs'] = new_d, new_q
        return out
    new_i = {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        xn = gather(cohort_new['invs'][key])
        ok = valid[bdim]
        if guard:
            ok = ok & _rows_finite(xn)
        new_i[key] = put(decomp_stored['invs'][key], rows[bdim], ok, xn)
    out['invs'] = new_i
    return out


def _layer_rows_padded(meta, acts, gs, batch_averaged, pg):
    """This layer's factor-convention rows (``ops.layer_rows_*``), their
    features zero-padded to the pred group's bucket dims: the one row and
    padding contract of both E-KFAC moment estimators."""
    a = capture.layer_act(acts, meta)
    g = capture.layer_g(gs, meta)
    if meta.kind == 'dense':
        arows, grows, n = ops.layer_rows_dense(a, g, meta.use_bias,
                                               batch_averaged)
    else:
        arows, grows, n = ops.layer_rows_conv(
            a, g, meta.kernel_size, meta.strides, meta.padding,
            meta.use_bias, batch_averaged)
    arows = torch.nn.functional.pad(arows, (0, pg.da - arows.shape[1]))
    grows = torch.nn.functional.pad(grows, (0, pg.dg - grows.shape[1]))
    return arows, grows, n


def _layer_scales(meta, acts, gs, batch_averaged, pg, qa, qg):
    """One layer's E-KFAC moments ``[dg, da]`` in the basis ``(qa, qg)``;
    its rows are freed before the next layer's are made."""
    arows, grows, n = _layer_rows_padded(meta, acts, gs, batch_averaged, pg)
    return ops.ekfac_scales(arows, grows, qa, qg, n)


def update_ekfac_scales(plan, decomp, acts, gs, batch_averaged,
                        scales_prev, factor_decay, stats_reduce, group,
                        comm_precision='fp32'):
    """E-KFAC second-moment update in the replicated eigenbasis (comm_mode
    'inverse'): per layer, project this rank's captured rows into the
    layer's Kronecker eigenbasis and take ``s = E[(Qg^T grad_b Qa)^2]``
    (:func:`ops.ekfac_scales`); ``stats_reduce='pmean'`` averages the
    moments over the group through ``coll.pmean_wire`` (a lossy wire
    without error feedback: squared projections have no sign structure to
    protect); then the EMA with ``factor_decay``. Returns ``{'g<i>': [M,
    dg, da]}`` in ``plan.pred_groups`` member order. A zero basis projects
    everything to zero, so the moments stay zero and the pred path keeps
    the Kronecker denominator."""
    new = {}
    for gi, pg in enumerate(plan.pred_groups):
        member = []
        for pos, i in enumerate(pg.layer_idx):
            qa = decomp['evecs'][_key(pg.da)][int(pg.row_a[pos])]
            qg = decomp['evecs'][_key(pg.dg)][int(pg.row_g[pos])]
            member.append(_layer_scales(plan.metas[int(i)], acts, gs,
                                        batch_averaged, pg, qa, qg))
        s_new = torch.stack(member)
        if stats_reduce == 'pmean':
            with coll.named_scope('kfac.CommunicateFactor.scales',
                                  profile=True):
                s_new = coll.pmean_wire(s_new, group, comm_precision)
        new[f'g{gi}'] = ops.update_running_avg(s_new, scales_prev[f'g{gi}'],
                                               factor_decay)
    return new


def update_ekfac_scales_local(plan, decomp_local, acts, gs, batch_averaged,
                              scales_prev, factor_decay, group):
    """Owner-local E-KFAC moments in the comm_mode 'pred' layout
    ('ekfac_dp'): each rank computes, from its own captures, the moments
    of the layers it owns only, each projected with the basis rows of its
    local slot; a pad slot's moments are zero. No communication. Returns
    ``{'g<i>': [K, dg, da]}`` in local slot order (the order of
    :func:`compute_pred_local`). The JAX version computes every layer and
    masks the unowned ones away (static shapes); the numbers are the
    same."""
    idx = coll.axis_index(group)
    new = {}
    for gi, pg in enumerate(plan.pred_groups):
        prev = scales_prev[f'g{gi}']
        slot_s = torch.zeros_like(prev)
        for k in range(pg.local_member.shape[1]):
            if not pg.local_valid[idx, k]:
                continue
            pos = int(pg.local_member[idx, k])
            qa = decomp_local['evecs'][_key(pg.da)][
                int(pg.local_row_a[idx, k])]
            qg = decomp_local['evecs'][_key(pg.dg)][
                int(pg.local_row_g[idx, k])]
            slot_s[k] = _layer_scales(plan.metas[int(pg.layer_idx[pos])],
                                      acts, gs, batch_averaged, pg, qa, qg)
        new[f'g{gi}'] = ops.update_running_avg(slot_s, prev, factor_decay)
    return new


def _transport(s, qa_o, qg_o, qa_n, qg_n):
    """Squared-overlap transport of diagonal moments ``s`` [m, dg, da]
    from the old bases to the new: ``(Rg^2)^T s (Ra^2)`` with ``R = Q_old^T
    Q_new``, in fp32."""
    with ops.fp32_matmul():
        ra = (qa_o.mT @ qa_n) ** 2
        rg = (qg_o.mT @ qg_n) ** 2
        return rg.mT @ s @ ra


def rotate_ekfac_scales(plan, scales, evecs_prev, evecs_new):
    """Re-express stored E-KFAC moments after a basis change (replicated
    layout): the EMA'd moments live in the old basis, and ``s' = (Rg^2)^T
    s (Ra^2)``, ``R = Q_old^T Q_new``, is the exact transport of the
    diagonal approximation between bases. It keeps the total mass, is
    exact under sign flips and is the identity when the basis did not
    move. ``evecs_prev``/``evecs_new`` are decompositions (their
    ``'evecs'``)."""
    out = {}
    for gi, pg in enumerate(plan.pred_groups):
        dev = scales[f'g{gi}'].device
        ra, rg = _long(pg.row_a, dev), _long(pg.row_g, dev)
        ka, kg = _key(pg.da), _key(pg.dg)
        out[f'g{gi}'] = _transport(
            scales[f'g{gi}'], evecs_prev['evecs'][ka][ra],
            evecs_prev['evecs'][kg][rg], evecs_new['evecs'][ka][ra],
            evecs_new['evecs'][kg][rg])
    return out


def rotate_ekfac_scales_local(plan, scales, evecs_prev_local,
                              evecs_new_local, group):
    """The per-slot transport of owner-local moments (comm_mode 'pred'):
    each local slot rotates by its own old and new basis rows."""
    out = {}
    for gi, pg in enumerate(plan.pred_groups):
        dev = scales[f'g{gi}'].device
        ra = _long(_local_table(pg.local_row_a, group), dev)
        rg = _long(_local_table(pg.local_row_g, group), dev)
        ka, kg = _key(pg.da), _key(pg.dg)
        out[f'g{gi}'] = _transport(
            scales[f'g{gi}'], evecs_prev_local[ka][ra],
            evecs_prev_local[kg][rg], evecs_new_local[ka][ra],
            evecs_new_local[kg][rg])
    return out


def _rows_finite(x):
    """``[rows, ...] -> [rows]`` bool: the row has no NaN/Inf."""
    return torch.isfinite(x).flatten(1).all(dim=1)


def where_finite_rows(new, prev, reinit_identity=False):
    """Rows of ``new`` with a NaN/Inf take ``prev``'s row; with
    ``reinit_identity`` a row whose ``prev`` is non-finite too becomes the
    identity (the factor-EMA heal path)."""
    out = {}
    for key, n in new.items():
        p = prev[key]
        fb = p
        if reinit_identity:
            eye = torch.eye(n.shape[-1], dtype=n.dtype, device=n.device)
            fb = torch.where(_rows_finite(p)[:, None, None], p, eye)
        good = _rows_finite(n).reshape((-1,) + (1,) * (n.ndim - 1))
        out[key] = torch.where(good, n, fb)
    return out


def guard_decomposition(decomp_new, decomp_prev, method):
    """Non-finite screen over a fresh decomposition: per row, fall back to
    the previous one, or to the identity when none exists yet (all-zero
    cold state). Pass-through when everything is finite."""
    if method == 'eigh':
        out_d, out_q = {}, {}
        for key in decomp_new['evecs']:
            dn, qn = decomp_new['evals'][key], decomp_new['evecs'][key]
            dp, qp = decomp_prev['evals'][key], decomp_prev['evecs'][key]
            good = _rows_finite(dn) & _rows_finite(qn)
            cold = ~torch.any((qp != 0).flatten(1), dim=1)
            eye = torch.eye(qn.shape[-1], dtype=qn.dtype, device=qn.device)
            fb_q = torch.where(cold[:, None, None], eye, qp)
            fb_d = torch.where(cold[:, None], torch.ones_like(dp), dp)
            out_d[key] = torch.where(good[:, None], dn, fb_d)
            out_q[key] = torch.where(good[:, None, None], qn, fb_q)
        return {**decomp_new, 'evals': out_d, 'evecs': out_q}
    out_i = {}
    for key, xn in decomp_new['invs'].items():
        xp = decomp_prev['invs'][key]
        cold = ~torch.any((xp != 0).flatten(1), dim=1)
        eye = torch.eye(xn.shape[-1], dtype=xn.dtype, device=xn.device)
        fb = torch.where(cold[:, None, None], eye, xp)
        out_i[key] = torch.where(_rows_finite(xn)[:, None, None], xn, fb)
    return {**decomp_new, 'invs': out_i}


def _place_own_rows(plan, x, group):
    """This rank's rows ``x`` at its offset of the all-gathered layout,
    zeros elsewhere: a gather's shapes with no communication."""
    idx = coll.axis_index(group)
    per_dev = x.shape[0]
    full = x.new_zeros((plan.num_devices * per_dev,) + tuple(x.shape[1:]))
    full[idx * per_dev:(idx + 1) * per_dev] = x
    return full


def gather_decomposition(plan, decomp_local, group, communicate=True,
                         comm_precision='fp32'):
    """All-gather every rank's decomposition rows to every rank
    (comm_inverse mode) over the ``comm_precision`` wire. With
    ``communicate=False`` (the CommunicateInverse ablation) each rank
    places its own rows at its offset, zeros elsewhere: global shapes,
    zero communication."""
    def gather(x):
        if communicate:
            return coll.all_gather_rows_compressed(x, group, comm_precision)
        return _place_own_rows(plan, x, group)

    with coll.named_scope('kfac.CommunicateInverse'):
        return {part: {k: gather(v) for k, v in tree.items()}
                for part, tree in decomp_local.items()}


# ---------------------------------------------------------------------------
# Phase 3: preconditioning
# ---------------------------------------------------------------------------

def _pred_eigh(qg, dg, qa, da, gstack, damping, scales=None):
    v1 = qg.mT @ gstack @ qa
    denom = dg[:, :, None] * da[:, None, :]
    if scales is not None:
        # E-KFAC: the second moments replace the eigenvalue products; a
        # member whose moments are all zero (none accumulated yet) keeps
        # the Kronecker denominator
        valid = torch.any((scales != 0).flatten(1), dim=1)[:, None, None]
        denom = torch.where(valid, scales, denom)
    v2 = v1 / (denom + damping)
    return qg @ v2 @ qa.mT


def _pred_inv(invg, inva, gstack):
    return invg @ gstack @ inva


def _group_grad_stack(pg, grad_mats):
    return torch.stack([_pad_mat(grad_mats[int(i)], pg.dg, pg.da)
                        for i in pg.layer_idx])


def compute_pred_replicated(plan, decomp, grad_mats, damping, method,
                            scales=None):
    """Preconditioning with the replicated (gathered) decomposition: every
    rank computes every layer's preconditioned gradient, no
    communication. ``scales``: the E-KFAC moments per pred group
    (:func:`update_ekfac_scales`), replacing the eigenvalue products."""
    preds = [None] * plan.num_layers
    for gi, pg in enumerate(plan.pred_groups):
        gstack = _group_grad_stack(pg, grad_mats)
        dev = gstack.device
        ra, rg = _long(pg.row_a, dev), _long(pg.row_g, dev)
        ka, kg = _key(pg.da), _key(pg.dg)
        if method == 'eigh':
            pred = _pred_eigh(decomp['evecs'][kg][rg], decomp['evals'][kg][rg],
                              decomp['evecs'][ka][ra], decomp['evals'][ka][ra],
                              gstack, damping,
                              None if scales is None else scales[f'g{gi}'])
        else:
            pred = _pred_inv(decomp['invs'][kg][rg], decomp['invs'][ka][ra],
                             gstack)
        for pos, i in enumerate(pg.layer_idx):
            meta = plan.metas[int(i)]
            preds[int(i)] = pred[pos, :meta.out_dim, :meta.in_dim]
    return preds


def compute_pred_local(plan, decomp_local, grad_mats, damping, method,
                       group=None, communicate=True, comm_precision='fp32',
                       scales=None):
    """Owner-computes preconditioning (comm_pred): each rank
    preconditions the layers it owns, batched per pred group, and the
    results are all-gathered over the ``comm_precision`` wire (with
    ``communicate=False``, the CommunicateInverse ablation, each rank
    keeps its own and the other layers' rows are zero).
    ``scales``: the owner-local E-KFAC moments in slot order
    (:func:`update_ekfac_scales_local`)."""
    preds = [None] * plan.num_layers
    for gi, pg in enumerate(plan.pred_groups):
        gstack = _group_grad_stack(pg, grad_mats)
        dev = gstack.device
        members = _long(_local_table(pg.local_member, group), dev)
        g_loc = gstack[members]
        ra = _long(_local_table(pg.local_row_a, group), dev)
        rg = _long(_local_table(pg.local_row_g, group), dev)
        ka, kg = _key(pg.da), _key(pg.dg)
        if method == 'eigh':
            pred = _pred_eigh(decomp_local['evecs'][kg][rg],
                              decomp_local['evals'][kg][rg],
                              decomp_local['evecs'][ka][ra],
                              decomp_local['evals'][ka][ra], g_loc, damping,
                              None if scales is None else scales[f'g{gi}'])
        else:
            pred = _pred_inv(decomp_local['invs'][kg][rg],
                             decomp_local['invs'][ka][ra], g_loc)
        if communicate:
            with coll.named_scope('kfac.Precondition'):
                gathered = coll.all_gather_rows_compressed(pred, group,
                                                           comm_precision)
        else:
            gathered = _place_own_rows(plan, pred, group)
        for pos, i in enumerate(pg.layer_idx):
            meta = plan.metas[int(i)]
            row = int(pg.gathered_row[pos])
            preds[int(i)] = gathered[row, :meta.out_dim, :meta.in_dim]
    return preds


# ---------------------------------------------------------------------------
# Phase 4: KL clip + write-back
# ---------------------------------------------------------------------------

def preconditioned_grads(plan, grads, grad_mats, preds, lr, kl_clip,
                         skip_clip=False):
    """Scale preds by the KL clip factor
    ``nu = min(1, sqrt(kl_clip / |sum(pred * grad) * lr^2|))`` and write
    them into a new grads dict; other parameters pass through.
    ``skip_clip`` (the CommunicateInverse ablation: the factor reads every
    layer's pred) writes them unscaled."""
    if kl_clip is not None and not skip_clip:
        vg = torch.zeros((), dtype=torch.float32, device=grad_mats[0].device)
        for p, g in zip(preds, grad_mats):
            vg = vg + torch.sum(p * g)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=vg.device)
        vg = vg * lr ** 2
        nu = torch.clamp(torch.sqrt(kl_clip / torch.abs(vg)), max=1.0)
    else:
        nu = 1.0
    new_grads = grads
    for meta, p in zip(plan.metas, preds):
        new_grads = write_grad_matrix(meta, new_grads, p * nu)
    return new_grads
