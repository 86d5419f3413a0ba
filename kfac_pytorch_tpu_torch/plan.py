"""Static factor layout (port of ``kfac_pytorch_tpu/plan.py``).

Every Kronecker factor ("slot": one layer's A or G) is identity-padded to
a bucket dim and stacked into one ``[rows, D, D]`` tensor per bucket, rows
device-major (rank d owns rows ``[d*per_dev, (d+1)*per_dev)``);
preconditioning batches layers by their (G-bucket, A-bucket) pair. The
tables are built exactly as the JAX plan builds them, so they compare one
to one.
"""

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kfac_pytorch_tpu_torch.capture import LayerMeta
from kfac_pytorch_tpu_torch.parallel import collectives as coll
from kfac_pytorch_tpu_torch.parallel.partition import (balanced_assign,
                                                       round_robin_assign)


def default_bucket_fn(dim, min_bucket=128):
    """Pad dim -> bucket: {min, 1.5*2^k, 2^k} steps up to 1024, then
    multiples of 256 (ResNet-32's 27..576 land on 128/192/384/768)."""
    if dim <= min_bucket:
        return min_bucket
    if dim > 1024:
        return -(-dim // 256) * 256
    b = min_bucket
    while True:
        if dim <= b:
            return b
        if dim <= b + b // 2:
            return b + b // 2
        b *= 2


@dataclasses.dataclass(frozen=True)
class Slot:
    layer_idx: int
    side: str        # 'A' | 'G'
    dim: int         # true (unpadded) dim
    owner: int


@dataclasses.dataclass
class Bucket:
    """One stacked factor tensor: [n_rows, dim, dim], device-major rows."""
    dim: int
    per_dev: int
    n_rows: int
    slot_of_row: List[Optional[Slot]]       # None -> dummy pad row
    true_dims: np.ndarray                   # [n_rows]; dummies get dim
    valid: np.ndarray                       # [n_rows] bool
    # pi-damping mate maps (Cholesky variants): per row, the flat local
    # index (concat over buckets, per device) of the other factor of the
    # same layer
    mate_flat: Optional[np.ndarray] = None  # [P, per_dev]
    own_dim: Optional[np.ndarray] = None    # [P, per_dev]
    mate_dim: Optional[np.ndarray] = None   # [P, per_dev]
    side_is_a: Optional[np.ndarray] = None  # [P, per_dev] bool


@dataclasses.dataclass
class PredGroup:
    """Layers sharing (G-bucket, A-bucket): batched preconditioning unit."""
    dg: int
    da: int
    layer_idx: np.ndarray       # [M] global layer indices (static order)
    row_a: np.ndarray           # [M] global row in bucket da
    row_g: np.ndarray           # [M] global row in bucket dg
    # comm_pred (owner-computes) maps
    k_per_dev: int = 0
    local_member: Optional[np.ndarray] = None   # [P, K] index into layer_idx
    local_valid: Optional[np.ndarray] = None    # [P, K] bool
    local_row_a: Optional[np.ndarray] = None    # [P, K] row in local da shard
    local_row_g: Optional[np.ndarray] = None    # [P, K] row in local dg shard
    gathered_row: Optional[np.ndarray] = None   # [M] row in all-gathered P*K


@dataclasses.dataclass
class FactorPlan:
    metas: List[LayerMeta]
    num_devices: int
    comm_mode: str                      # 'inverse' | 'pred'
    buckets: Dict[int, Bucket]
    # per layer: (bucket_a, row_a_global, bucket_g, row_g_global, owner)
    layer_rows: List[Tuple[int, int, int, int, int]]
    pred_groups: List[PredGroup]
    bucket_dims: List[int]              # sorted bucket keys
    local_flat_offsets: Dict[int, int]  # bucket dim -> offset into the
                                        # per-device concatenated slots
    # the ownership rule the plan was built with ('round_robin' |
    # 'balanced'), so comm_volume can price the other comm mode's layout
    assignment: str = 'round_robin'

    @property
    def num_layers(self):
        return len(self.metas)

    def comm_volume(self, *, stats_reduce, method, comm_precision='fp32',
                    comm_mode=None, decomp_shard=None):
        """Payload bytes of the K-FAC collectives of ONE factor + inverse
        step on ONE rank under this layout, per phase:

        - FactorComm: the stats reduce-scatter's result (MPD variants
          only): each rank's own rows in the reduce wire dtype (int8
          floors at bf16);
        - InverseComm: the decomposition gather (comm_mode 'inverse'):
          every row of every bucket (and the eigenvalue vectors for
          eigh) in the gather wire dtype, int8 adding a 4-byte scale per
          row;
        - PredComm: the preconditioned-gradient gather (comm_mode 'pred'):
          ``P * K`` padded ``[dg, da]`` matrices per pred group;
        - DecompComm: the sharded decomposition's exchange (``decomp_shard``,
          a :class:`DecompShardPlan`) of one step: the damped cohort out
          (``P * R_b`` matrices a bucket) and the results back (``P * S_b``
          matrices, and the eigenvalue vectors for eigh). 0 without a
          shard plan; with one, InverseComm is 0: the exchange replaces
          the staggered merge's gather.

        ``comm_mode`` overrides the plan's own (both roads priced from one
        layout). The gradient all-reduce is not a K-FAC collective and is
        not counted. :func:`collectives.ledger` counts the same bytes at
        the collective calls."""
        coll.check_wire_dtype(comm_precision)
        wire = int(4 * coll.WIRE_COMPRESSION[comm_precision])
        reduce_wire = int(4 * coll.WIRE_COMPRESSION[
            coll.reduce_wire_dtype(comm_precision)])
        scale_b = 4 if comm_precision == 'int8' else 0
        factor = inverse = pred = decomp = 0
        if stats_reduce == 'pmean':
            factor = sum(b.per_dev * b.dim * b.dim * reduce_wire
                         for b in self.buckets.values())
        if (comm_mode or self.comm_mode) == 'inverse':
            for b in self.buckets.values():
                inverse += b.n_rows * (b.dim * b.dim * wire + scale_b)
                if method == 'eigh':
                    inverse += b.n_rows * (b.dim * wire + scale_b)
        else:
            pred_owners = None
            for pg in self.pred_groups:
                k = pg.k_per_dev
                if k == 0:
                    # an inverse-mode plan has no pred tables: K is what
                    # the pred layout (whole-layer ownership by the same
                    # rule) would pad to
                    if pred_owners is None:
                        pred_owners = _layer_owners(self.metas,
                                                    self.num_devices,
                                                    self.assignment)
                    owners = [pred_owners[int(i)] for i in pg.layer_idx]
                    k = max(1, max(owners.count(d)
                                   for d in range(self.num_devices)))
                pred += self.num_devices * k * (pg.dg * pg.da * wire
                                                + scale_b)
        if decomp_shard is not None:
            inverse = 0
            P = self.num_devices
            for bdim in self.bucket_dims:
                r_b = decomp_shard.gather_rows(bdim)
                s_b = decomp_shard.shard_rows(bdim)
                decomp += P * (r_b + s_b) * (bdim * bdim * wire + scale_b)
                if method == 'eigh':
                    decomp += P * s_b * (bdim * wire + scale_b)
        return {'FactorComm': factor, 'InverseComm': inverse,
                'PredComm': pred, 'DecompComm': decomp}


def _slot_cost(dim):
    # eigh / Cholesky cost ~ D^3
    return float(dim) ** 3


def _layer_owners(metas, num_devices, assignment):
    """Whole-layer ownership: round robin, or balanced by both factors'
    D^3 cost."""
    if assignment == 'balanced':
        owners = balanced_assign([_slot_cost(m.in_dim) + _slot_cost(m.out_dim)
                                  for m in metas], num_devices)
    else:
        owners = round_robin_assign(len(metas), num_devices)
    return [int(o) for o in owners]


def same_row_layout(plan_a: FactorPlan, plan_b: FactorPlan) -> bool:
    """Whether two plans place every factor row identically: the same
    world size, buckets (dims, rows a rank, validity, true dims) and
    per-layer row map. Then one plan's state tensors fit the other's and a
    replan can carry them verbatim. ``comm_mode`` is not part of the row
    layout."""
    if plan_a.num_devices != plan_b.num_devices:
        return False
    if plan_a.bucket_dims != plan_b.bucket_dims:
        return False
    for bdim in plan_a.bucket_dims:
        a, b = plan_a.buckets[bdim], plan_b.buckets[bdim]
        if (a.per_dev, a.n_rows) != (b.per_dev, b.n_rows):
            return False
        if not np.array_equal(a.valid, b.valid):
            return False
        if not np.array_equal(a.true_dims, b.true_dims):
            return False
    return plan_a.layer_rows == plan_b.layer_rows


ASSIGNMENTS = ('round_robin', 'balanced')


def build_plan(metas: Dict[str, LayerMeta], num_devices: int, comm_mode: str,
               assignment: str = 'round_robin',
               distribute_layer_factors: bool = False,
               bucket_fn: Callable[[int], int] = default_bucket_fn):
    """Build the static layout. Ownership: round robin over layers (the
    reference's rule; both factors of a layer on its owner) or 'balanced'
    (greedy LPT over the D^3 costs); with ``distribute_layer_factors``
    (comm_mode 'inverse' only) the interleaved A/G slot sequence is
    assigned instead, so a layer's two factors may live on two ranks."""
    if assignment not in ASSIGNMENTS:
        raise ValueError(f'assignment must be one of {ASSIGNMENTS}, got '
                         f'{assignment!r}')
    meta_list = list(metas.values())
    L = len(meta_list)
    P = num_devices
    if comm_mode == 'pred' and distribute_layer_factors:
        raise ValueError(
            'factor-wise distribution requires communicating inverses '
            '(the pred layout computes each layer on one rank, which must '
            'own both its factors)')

    # --- ownership ------------------------------------------------------
    if distribute_layer_factors:
        dims = []
        for m in meta_list:
            dims.extend([m.in_dim, m.out_dim])
        if assignment == 'balanced':
            owners = balanced_assign([_slot_cost(d) for d in dims], P)
        else:
            owners = round_robin_assign(2 * L, P)
        slot_owner = [(int(owners[2 * i]), int(owners[2 * i + 1]))
                      for i in range(L)]
        layer_owner = [a for a, _ in slot_owner]  # nominal (unused by pred)
    else:
        layer_owner = _layer_owners(meta_list, P, assignment)
        slot_owner = [(o, o) for o in layer_owner]

    # --- buckets --------------------------------------------------------
    slots: List[Slot] = []
    for i, m in enumerate(meta_list):
        oa, og = slot_owner[i]
        slots.append(Slot(i, 'A', m.in_dim, oa))
        slots.append(Slot(i, 'G', m.out_dim, og))

    by_bucket: Dict[int, List[Slot]] = {}
    for s in slots:
        by_bucket.setdefault(bucket_fn(s.dim), []).append(s)

    buckets: Dict[int, Bucket] = {}
    slot_row: Dict[Tuple[int, str], Tuple[int, int]] = {}
    for bdim in sorted(by_bucket):
        rows_by_dev: List[List[Slot]] = [[] for _ in range(P)]
        for s in by_bucket[bdim]:
            rows_by_dev[s.owner].append(s)
        per_dev = max(1, max(len(r) for r in rows_by_dev))
        n_rows = P * per_dev
        slot_of_row: List[Optional[Slot]] = [None] * n_rows
        true_dims = np.full(n_rows, bdim, dtype=np.int32)
        valid = np.zeros(n_rows, dtype=bool)
        for d in range(P):
            for k, s in enumerate(rows_by_dev[d]):
                r = d * per_dev + k
                slot_of_row[r] = s
                true_dims[r] = s.dim
                valid[r] = True
                slot_row[(s.layer_idx, s.side)] = (bdim, r)
        buckets[bdim] = Bucket(dim=bdim, per_dev=per_dev, n_rows=n_rows,
                               slot_of_row=slot_of_row, true_dims=true_dims,
                               valid=valid)

    bucket_dims = sorted(buckets)
    local_flat_offsets = {}
    off = 0
    for bdim in bucket_dims:
        local_flat_offsets[bdim] = off
        off += buckets[bdim].per_dev

    # --- pi-damping mate maps (a layer's two factors on one rank only) ----
    for bdim in (() if distribute_layer_factors else bucket_dims):
        b = buckets[bdim]
        mate_flat = np.zeros((P, b.per_dev), dtype=np.int32)
        own_dim = np.full((P, b.per_dev), bdim, dtype=np.int32)
        mate_dim = np.full((P, b.per_dev), bdim, dtype=np.int32)
        side_is_a = np.ones((P, b.per_dev), dtype=bool)
        for d in range(P):
            for k in range(b.per_dev):
                r = d * b.per_dev + k
                s = b.slot_of_row[r]
                if s is None:
                    mate_flat[d, k] = local_flat_offsets[bdim] + k
                    continue
                mate_side = 'G' if s.side == 'A' else 'A'
                mb, mr = slot_row[(s.layer_idx, mate_side)]
                md = mr // buckets[mb].per_dev
                mate_flat[d, k] = (local_flat_offsets[mb]
                                   + mr - md * buckets[mb].per_dev)
                own_dim[d, k] = s.dim
                mate_dim[d, k] = buckets[mb].true_dims[mr]
                side_is_a[d, k] = s.side == 'A'
        b.mate_flat, b.own_dim = mate_flat, own_dim
        b.mate_dim, b.side_is_a = mate_dim, side_is_a

    # --- per-layer row lookup ----------------------------------------------
    layer_rows = []
    for i in range(L):
        ba, ra = slot_row[(i, 'A')]
        bg, rg = slot_row[(i, 'G')]
        layer_rows.append((ba, ra, bg, rg, layer_owner[i]))

    # --- pred groups --------------------------------------------------------
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, m in enumerate(meta_list):
        groups.setdefault((bucket_fn(m.out_dim), bucket_fn(m.in_dim)),
                          []).append(i)

    pred_groups = []
    for (dg, da), lidx in sorted(groups.items()):
        lidx = np.asarray(lidx, dtype=np.int32)
        row_a = np.asarray([layer_rows[i][1] for i in lidx], dtype=np.int32)
        row_g = np.asarray([layer_rows[i][3] for i in lidx], dtype=np.int32)
        pg = PredGroup(dg=dg, da=da, layer_idx=lidx, row_a=row_a, row_g=row_g)
        if comm_mode == 'pred':
            members_by_dev: List[List[int]] = [[] for _ in range(P)]
            for mpos, i in enumerate(lidx):
                members_by_dev[layer_rows[i][4]].append(mpos)
            K = max(1, max(len(v) for v in members_by_dev))
            pg.k_per_dev = K
            pg.local_member = np.zeros((P, K), dtype=np.int32)
            pg.local_valid = np.zeros((P, K), dtype=bool)
            pg.local_row_a = np.zeros((P, K), dtype=np.int32)
            pg.local_row_g = np.zeros((P, K), dtype=np.int32)
            pg.gathered_row = np.zeros(len(lidx), dtype=np.int32)
            for d in range(P):
                for k, mpos in enumerate(members_by_dev[d]):
                    ba, ra, bg, rg, _ = layer_rows[int(lidx[mpos])]
                    pg.local_member[d, k] = mpos
                    pg.local_valid[d, k] = True
                    pg.local_row_a[d, k] = ra - d * buckets[ba].per_dev
                    pg.local_row_g[d, k] = rg - d * buckets[bg].per_dev
                    pg.gathered_row[mpos] = d * K + k
        pred_groups.append(pg)

    return FactorPlan(metas=meta_list, num_devices=P, comm_mode=comm_mode,
                      buckets=buckets, layer_rows=layer_rows,
                      pred_groups=pred_groups, bucket_dims=bucket_dims,
                      local_flat_offsets=local_flat_offsets,
                      assignment=assignment)


@dataclasses.dataclass
class CohortPlan:
    """Staggered-refresh layout: every rank's valid factor rows split into
    ``num_cohorts`` cost-balanced cohorts, cohort ``step % num_cohorts``
    decomposed each step (each row refreshed once a window). Per bucket
    ``R_b`` is the largest cohort's row count, so smaller cohorts carry
    padding rows: real rows outside the cohort whose results the merge
    discards. Tables are host arrays indexed by the step's cohort."""
    num_cohorts: int
    # per bucket dim, [F, P, R_b]: local row (within the rank's per_dev
    # rows) decomposed on cohort f by rank p, and whether it is real
    rows: Dict[int, np.ndarray]
    valid: Dict[int, np.ndarray]
    # comm_mode 'inverse' merge tables, device-major as all_gather_rows
    # returns them: [F, P*R_b] global row / validity
    global_rows: Dict[int, np.ndarray]
    global_valid: Dict[int, np.ndarray]
    # Cholesky pi-damping lookups, [F, P, R_b]: the flat local slot index
    # of the row and of its mate factor
    own_flat: Dict[int, np.ndarray]
    mate_flat: Dict[int, np.ndarray]
    cohort_cost: np.ndarray             # [P, F] sum of bucket_dim^3
    cohort_count: np.ndarray            # [P, F] valid rows
    # the base window the layout was built for and its {bucket dim:
    # stretch} overrides (num_cohorts = base * lcm(stretches))
    base_freq: int = 0
    bucket_freq: Dict[int, int] = dataclasses.field(default_factory=dict)

    def max_rows_per_step(self):
        """Most real rows one rank decomposes in one step."""
        return int(self.cohort_count.max()) if self.cohort_count.size else 0

    def padded_rows_per_step(self):
        """Rows a rank decomposes every step, padding included
        (``sum_b R_b``)."""
        return int(sum(t.shape[2] for t in self.rows.values()))

    def total_rows(self):
        """Valid rows a rank refreshes over a window."""
        return int(self.cohort_count.sum(axis=1).max()) \
            if self.cohort_count.size else 0


def build_cohorts(plan: FactorPlan, num_cohorts: int,
                  bucket_freq: Optional[Dict[int, int]] = None) -> CohortPlan:
    """Split each rank's valid factor rows into ``num_cohorts`` refresh
    cohorts, balanced by eigh cost ~ D^3: buckets largest first, each row
    to the cohort with the least (row count, cost, index).

    ``bucket_freq`` maps a bucket dim to a stretch ``m``: its rows refresh
    every ``num_cohorts * m`` steps, and the table window becomes the lcm
    ``W`` of those periods (at most 128 x ``num_cohorts``); a stretched row
    appears in ``W / (num_cohorts * m)`` cohorts and the greedy balances
    the sums over its appearances. Without overrides this is the
    one-appearance layout."""
    F = max(1, int(num_cohorts))
    P = plan.num_devices
    bucket_freq = {int(k): max(1, int(v))
                   for k, v in (bucket_freq or {}).items()}
    unknown = sorted(set(bucket_freq) - set(plan.bucket_dims))
    if unknown:
        raise ValueError(f'bucket_freq names unknown bucket dims '
                         f'{unknown} (plan has {plan.bucket_dims})')
    stretch = {b: bucket_freq.get(b, 1) for b in plan.bucket_dims}
    W = F
    for m in stretch.values():
        W = math.lcm(W, F * m)
    if W > 128 * F:
        raise ValueError(
            f'bucket_freq window {W} exceeds {128 * F} '
            f'(= 128 * base {F}): use power-of-two stretches '
            f'(got {bucket_freq})')

    def _appearances(bdim, c0):
        return range(c0, W, F * stretch[bdim])

    assign: Dict[int, np.ndarray] = {}
    cohort_cost = np.zeros((P, W), dtype=np.float64)
    cohort_count = np.zeros((P, W), dtype=np.int64)
    for bdim in plan.bucket_dims:
        assign[bdim] = np.full((P, plan.buckets[bdim].per_dev), -1,
                               dtype=np.int64)
    for d in range(P):
        loads = np.zeros(W, dtype=np.float64)
        counts = np.zeros(W, dtype=np.int64)
        for bdim in sorted(plan.bucket_dims, reverse=True):
            b = plan.buckets[bdim]
            period = F * stretch[bdim]
            for k in range(b.per_dev):
                if not b.valid[d * b.per_dev + k]:
                    continue
                c = min(range(period), key=lambda c0: (
                    sum(counts[a] for a in _appearances(bdim, c0)),
                    sum(loads[a] for a in _appearances(bdim, c0)), c0))
                assign[bdim][d, k] = c
                # cost at the padded dim: what the batched solver runs
                for a in _appearances(bdim, c):
                    loads[a] += _slot_cost(bdim)
                    counts[a] += 1
        cohort_cost[d] = loads
        cohort_count[d] = counts

    def _in_cohort(bdim, c0, f):
        return c0 >= 0 and (f - c0) % (F * stretch[bdim]) == 0

    rows, valid, grows, gvalid, own_flat, mate_flat = {}, {}, {}, {}, {}, {}
    for bdim in plan.bucket_dims:
        b = plan.buckets[bdim]
        counts = np.zeros((W, P), dtype=np.int64)
        for d in range(P):
            for k in range(b.per_dev):
                c = assign[bdim][d, k]
                if c >= 0:
                    for a in _appearances(bdim, c):
                        counts[a, d] += 1
        R = max(1, int(counts.max()))
        r_tbl = np.zeros((W, P, R), dtype=np.int32)
        v_tbl = np.zeros((W, P, R), dtype=bool)
        for f in range(W):
            for d in range(P):
                members = [k for k in range(b.per_dev)
                           if _in_cohort(bdim, assign[bdim][d, k], f)]
                # padding points at a row outside the cohort (compared
                # with the row's first cohort, as the reference does), so
                # padding writes never collide with real updates
                spare = next((k for k in range(b.per_dev)
                              if assign[bdim][d, k] != f), 0)
                for j in range(R):
                    if j < len(members):
                        r_tbl[f, d, j] = members[j]
                        v_tbl[f, d, j] = True
                    else:
                        r_tbl[f, d, j] = spare
        rows[bdim] = r_tbl
        valid[bdim] = v_tbl
        dev_off = (np.arange(P, dtype=np.int32) * b.per_dev)[None, :, None]
        grows[bdim] = (r_tbl + dev_off).reshape(W, P * R)
        gvalid[bdim] = v_tbl.reshape(W, P * R)
        own_flat[bdim] = (r_tbl + plan.local_flat_offsets[bdim]).astype(
            np.int32)
        if b.mate_flat is not None:
            mate_flat[bdim] = np.take_along_axis(
                np.broadcast_to(b.mate_flat[None], (W,) + b.mate_flat.shape),
                r_tbl, axis=2).astype(np.int32)
        else:
            # factor-wise layouts carry no mate maps (eigh only)
            mate_flat[bdim] = own_flat[bdim]
    return CohortPlan(num_cohorts=W, rows=rows, valid=valid,
                      global_rows=grows, global_valid=gvalid,
                      own_flat=own_flat, mate_flat=mate_flat,
                      cohort_cost=cohort_cost, cohort_count=cohort_count,
                      base_freq=F, bucket_freq=bucket_freq)


@dataclasses.dataclass
class DecompShardPlan:
    """Sharded decomposition layout: each cohort's rows decomposed
    balanced across all ``P`` ranks instead of by their owner. For cohort
    ``f`` the owners' damped cohort rows are all-gathered (rank d's slot
    j at flat index ``d*R_b + j``), rank p decomposes the ``S_b``
    gathered slots ``src[f, p]`` names, the results are all-gathered back
    (rank p's slot j at ``p*S_b + j``) and each stored row gathers its
    fresh value through ``res_slot``: a merge by gather, so no two writes
    meet. A rank's padded work a step drops from ``sum_b R_b D^3``
    (owner-local) to ``sum_b S_b D^3``, for the two DecompComm gathers
    (:meth:`FactorPlan.comm_volume`)."""
    num_cohorts: int
    # per bucket dim, [F, P, S_b]: index into the gathered cohort
    # [P*R_b] that rank p decomposes on cohort f, and whether it is real
    src: Dict[int, np.ndarray]
    src_valid: Dict[int, np.ndarray]
    # [F, P, S_b]: the stored global row each src slot refreshes (padding
    # at row 0): the warm seeds under comm_mode 'inverse'
    src_global: Dict[int, np.ndarray]
    # [F, n_rows]: where each stored global row's fresh value sits in the
    # result gather [P*S_b], and whether the row is in the cohort
    res_slot: Dict[int, np.ndarray]
    res_valid: Dict[int, np.ndarray]
    shard_cost: np.ndarray              # [F, P] sum of bucket_dim^3
    shard_count: np.ndarray             # [F, P] valid rows assigned
    # per bucket dim: R_b, the rows a rank sends in the cohort gather
    cohort_rows: Dict[int, int] = dataclasses.field(default_factory=dict)

    def gather_rows(self, bdim):
        """R_b: rows a rank sends in the damped-cohort gather."""
        return self.cohort_rows[bdim]

    def shard_rows(self, bdim):
        """S_b: rows a rank decomposes (and sends back)."""
        return self.src[bdim].shape[2]

    def max_rows_per_step(self):
        """Most real rows one rank decomposes in one step."""
        return int(self.shard_count.max()) if self.shard_count.size else 0

    def padded_rows_per_step(self):
        """Rows a rank decomposes every step, padding included
        (``sum_b S_b``)."""
        return int(sum(t.shape[2] for t in self.src.values()))


def build_decomp_shard(plan: FactorPlan,
                       cohorts: CohortPlan) -> DecompShardPlan:
    """Spread every cohort's valid rows over all ranks: per (cohort,
    bucket) round robin in owner-major order from start rank ``(f +
    b_idx) % P``, so ``S_b = ceil(cohort rows of b / P)`` and the
    remainders rotate instead of piling onto rank 0. Padding slots point
    at gathered slot 0 (a real matrix); no ``res_slot`` points at their
    results."""
    F, P = cohorts.num_cohorts, plan.num_devices
    shard_cost = np.zeros((F, P), dtype=np.float64)
    shard_count = np.zeros((F, P), dtype=np.int64)
    # bucket -> [cohort][rank] -> [(gathered slot, stored global row)]
    assigned = {b: [[[] for _ in range(P)] for _ in range(F)]
                for b in plan.bucket_dims}
    for f in range(F):
        for b_idx, bdim in enumerate(plan.bucket_dims):
            b = plan.buckets[bdim]
            rows, valid = cohorts.rows[bdim][f], cohorts.valid[bdim][f]
            R = rows.shape[1]
            items = [(d * R + j, d * b.per_dev + int(rows[d, j]))
                     for d in range(P) for j in range(R) if valid[d, j]]
            start = (f + b_idx) % P
            for i, item in enumerate(items):
                p = (start + i) % P
                assigned[bdim][f][p].append(item)
                shard_cost[f, p] += _slot_cost(bdim)
                shard_count[f, p] += 1

    src, src_valid, src_global, res_slot, res_valid = {}, {}, {}, {}, {}
    for bdim in plan.bucket_dims:
        n_rows = plan.buckets[bdim].n_rows
        S = max(1, max(len(assigned[bdim][f][p])
                       for f in range(F) for p in range(P)))
        s_tbl = np.zeros((F, P, S), dtype=np.int32)
        v_tbl = np.zeros((F, P, S), dtype=bool)
        g_tbl = np.zeros((F, P, S), dtype=np.int32)
        slot_tbl = np.zeros((F, n_rows), dtype=np.int32)
        rvalid_tbl = np.zeros((F, n_rows), dtype=bool)
        for f in range(F):
            for p in range(P):
                for j, (src_flat, grow) in enumerate(assigned[bdim][f][p]):
                    s_tbl[f, p, j] = src_flat
                    v_tbl[f, p, j] = True
                    g_tbl[f, p, j] = grow
                    slot_tbl[f, grow] = p * S + j
                    rvalid_tbl[f, grow] = True
        src[bdim], src_valid[bdim], src_global[bdim] = s_tbl, v_tbl, g_tbl
        res_slot[bdim], res_valid[bdim] = slot_tbl, rvalid_tbl
    return DecompShardPlan(
        num_cohorts=F, src=src, src_valid=src_valid, src_global=src_global,
        res_slot=res_slot, res_valid=res_valid, shard_cost=shard_cost,
        shard_count=shard_count,
        cohort_rows={b: cohorts.rows[b].shape[2] for b in plan.bucket_dims})
