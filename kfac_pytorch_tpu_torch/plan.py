"""Static factor layout (port of ``kfac_pytorch_tpu/plan.py``).

Every Kronecker factor ("slot": one layer's A or G) is identity-padded to
a bucket dim and stacked into one ``[rows, D, D]`` tensor per bucket, rows
device-major (rank d owns rows ``[d*per_dev, (d+1)*per_dev)``);
preconditioning batches layers by their (G-bucket, A-bucket) pair. The
tables are built exactly as the JAX plan builds them, so they compare one
to one.
"""

import dataclasses
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
                    comm_mode=None):
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
          ``P * K`` padded ``[dg, da]`` matrices per pred group.

        ``comm_mode`` overrides the plan's own (both roads priced from one
        layout). The gradient all-reduce is not a K-FAC collective and is
        not counted. :func:`collectives.ledger` counts the same bytes at
        the collective calls."""
        coll.check_wire_dtype(comm_precision)
        wire = int(4 * coll.WIRE_COMPRESSION[comm_precision])
        reduce_wire = int(4 * coll.WIRE_COMPRESSION[
            coll.reduce_wire_dtype(comm_precision)])
        scale_b = 4 if comm_precision == 'int8' else 0
        factor = inverse = pred = 0
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
        return {'FactorComm': factor, 'InverseComm': inverse,
                'PredComm': pred}


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
