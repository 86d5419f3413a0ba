"""K-FAC step phases over the stacked-bucket layout (port of the world=1
subset of ``kfac_pytorch_tpu/engine.py``).

  compute_layer_stats / stack_stats / update_factors   factor statistics
  update_factors_fused     the same three with the EMA inside the kernels
  compute_decomposition    batched eigh (or pi-damped Cholesky inverse)
  compute_pred_local       owner-computes preconditioning (comm_pred)
  preconditioned_grads     KL clip + write-back

Gradients are a ``{torch parameter name: tensor}`` dict; a layer's matrix
form is ``[out, in(+bias)]`` with a conv weight (OIHW) flattened as
``w.permute(0, 2, 3, 1).reshape(c_out, -1)``, the ``(kh, kw, c_in)``
order of factor A. Functions return new tensors; the input state is not
modified.
"""

import torch

from kfac_pytorch_tpu_torch import capture, ops
from kfac_pytorch_tpu_torch.ops import capture_kernels


def _key(bdim):
    return str(bdim)


def _world1(plan):
    if plan.num_devices != 1:
        raise NotImplementedError('world>1 K-FAC (factor ownership and '
                                  'collectives) is port slice B')


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

def compute_layer_stats(plan, acts, gs, batch_averaged=True):
    """Per-layer factor statistics from captured ``(a, g)``, with the
    plain ops (the unfused path; at world=1 the capture kernels run
    through :func:`update_factors_fused`)."""
    a_list, g_list = [], []
    for meta in plan.metas:
        a = capture.layer_act(acts, meta).contiguous()
        g = capture.layer_g(gs, meta).contiguous()
        if meta.kind == 'dense':
            a_list.append(ops.compute_a_dense(a, meta.use_bias))
            g_list.append(ops.compute_g_dense(g, batch_averaged))
        else:
            a_list.append(ops.compute_a_conv(
                a, meta.kernel_size, meta.strides, meta.padding,
                meta.use_bias))
            g_list.append(ops.compute_g_conv(g, batch_averaged))
    return a_list, g_list


def stack_stats(plan, a_list, g_list):
    """Scatter per-layer stats into the stacked-bucket layout (identity
    padding; dummy rows are the identity)."""
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
                   stats_reduce='local'):
    """Running-average update of the factors from local statistics (DP
    semantics: no factor communication)."""
    _world1(plan)
    if stats_reduce != 'local':
        raise NotImplementedError("stats_reduce='pmean' (MPD factor "
                                  'averaging) is port slice B')
    return {k: ops.update_running_avg(stats_stacked[k], factors_local[k],
                                      factor_decay)
            for k in factors_local}


def update_factors_fused(plan, factors_local, acts, gs, batch_averaged,
                         factor_decay):
    """World=1 local statistics with the EMA folded into the capture
    kernels: one K1/K2 launch per real factor row, whose epilogue emits
    ``update_running_avg(stat, current, factor_decay)``. Identity padding
    and dummy rows take the unfused arithmetic (EMA against the eye
    template), so the result matches ``stack_stats`` + ``update_factors``
    up to the statistic's summation order."""
    _world1(plan)
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
# Phase 2: decomposition
# ---------------------------------------------------------------------------

def _local_trace_avgs(plan, factors_local):
    """Per-slot ``trace / true_dim`` (flat, concatenated over buckets in
    bucket_dims order) — the pi-damping inputs."""
    _world1(plan)
    trace_parts, dim_parts = [], []
    for bdim in plan.bucket_dims:
        f = factors_local[_key(bdim)]
        tdl = torch.as_tensor(plan.buckets[bdim].true_dims, device=f.device)
        trace_parts.append(ops.masked_trace(f, tdl))
        dim_parts.append(tdl)
    return torch.cat(trace_parts) / torch.cat(dim_parts).to(torch.float32)


def compute_decomposition(plan, factors_local, damping, method, eps):
    """Batched eigh (eigenvalues ``<= eps`` clamped to zero) or pi-damped
    Cholesky inverse of the factor rows."""
    if method == 'eigh':
        evals, evecs = {}, {}
        for bdim in plan.bucket_dims:
            key = _key(bdim)
            d, q = ops.sym_eig(factors_local[key])
            evals[key] = ops.clamp_eigvals(d, eps)
            evecs[key] = q
        return {'evals': evals, 'evecs': evecs}

    flat_avg = _local_trace_avgs(plan, factors_local)
    invs = {}
    for bdim in plan.bucket_dims:
        key = _key(bdim)
        b = plan.buckets[bdim]
        off = plan.local_flat_offsets[bdim]
        own_avg = flat_avg[off:off + b.per_dev]
        mate = torch.as_tensor(b.mate_flat[0], device=flat_avg.device,
                               dtype=torch.long)
        damp_vec = torch.sqrt(damping * own_avg / flat_avg[mate])
        invs[key] = ops.psd_inverse(
            ops.add_scaled_identity(factors_local[key], damp_vec))
    return {'invs': invs}


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


# ---------------------------------------------------------------------------
# Phase 3: preconditioning
# ---------------------------------------------------------------------------

def _pred_eigh(qg, dg, qa, da, gstack, damping):
    v1 = qg.mT @ gstack @ qa
    v2 = v1 / (dg[:, :, None] * da[:, None, :] + damping)
    return qg @ v2 @ qa.mT


def _pred_inv(invg, inva, gstack):
    return invg @ gstack @ inva


def compute_pred_local(plan, decomp_local, grad_mats, damping, method):
    """Owner-computes preconditioning (comm_pred), world=1: every layer's
    preconditioned gradient, batched per pred group."""
    _world1(plan)
    preds = [None] * plan.num_layers
    for pg in plan.pred_groups:
        dev = grad_mats[0].device
        members = torch.as_tensor(pg.local_member[0], device=dev,
                                  dtype=torch.long)
        gstack = torch.stack([_pad_mat(grad_mats[int(i)], pg.dg, pg.da)
                              for i in pg.layer_idx])[members]
        ra = torch.as_tensor(pg.local_row_a[0], device=dev, dtype=torch.long)
        rg = torch.as_tensor(pg.local_row_g[0], device=dev, dtype=torch.long)
        ka, kg = _key(pg.da), _key(pg.dg)
        if method == 'eigh':
            pred = _pred_eigh(decomp_local['evecs'][kg][rg],
                              decomp_local['evals'][kg][rg],
                              decomp_local['evecs'][ka][ra],
                              decomp_local['evals'][ka][ra], gstack, damping)
        else:
            pred = _pred_inv(decomp_local['invs'][kg][rg],
                             decomp_local['invs'][ka][ra], gstack)
        for pos, i in enumerate(pg.layer_idx):
            meta = plan.metas[int(i)]
            row = int(pg.gathered_row[pos])
            preds[int(i)] = pred[row, :meta.out_dim, :meta.in_dim]
    return preds


# ---------------------------------------------------------------------------
# Phase 4: KL clip + write-back
# ---------------------------------------------------------------------------

def preconditioned_grads(plan, grads, grad_mats, preds, lr, kl_clip):
    """Scale preds by the KL clip factor
    ``nu = min(1, sqrt(kl_clip / |sum(pred * grad) * lr^2|))`` and write
    them into a new grads dict; other parameters pass through."""
    if kl_clip is not None:
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
