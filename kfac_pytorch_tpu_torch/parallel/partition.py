"""Layer/factor -> device scheduling, host-side and static (port of
``kfac_pytorch_tpu/parallel/partition.py``). The assignment decides the
row order of the stacked factor buckets: "rank owns layer" becomes "rank
owns stacked rows"."""

import numpy as np


def round_robin_assign(n_items, num_devices):
    """Item i -> device i % P."""
    return np.arange(n_items, dtype=np.int64) % num_devices


def balanced_assign(costs, num_devices):
    """Greedy longest-processing-time assignment: items by cost,
    descending (stable), each on the least-loaded device."""
    costs = np.asarray(costs, dtype=np.float64)
    owners = np.zeros(len(costs), dtype=np.int64)
    load = np.zeros(num_devices, dtype=np.float64)
    for i in np.argsort(-costs, kind='stable'):
        d = int(np.argmin(load))
        owners[i] = d
        load[d] += costs[i]
    return owners


def block_partition(costs, num_devices):
    """Optimal contiguous bottleneck partition (dynamic programming):
    split an ordered cost list into ``num_devices`` contiguous blocks
    minimizing the largest block sum. Returns an owner array."""
    costs = np.asarray(costs, dtype=np.float64)
    n = len(costs)
    p = min(num_devices, n) if n else num_devices
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    dp = np.full((p + 1, n + 1), np.inf)
    cut = np.zeros((p + 1, n + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for k in range(1, p + 1):
        for i in range(1, n + 1):
            for j in range(k - 1, i):
                cand = max(dp[k - 1, j], prefix[i] - prefix[j])
                if cand < dp[k, i]:
                    dp[k, i] = cand
                    cut[k, i] = j
    owners = np.zeros(n, dtype=np.int64)
    i = n
    for k in range(p, 0, -1):
        j = cut[k, i]
        owners[j:i] = k - 1
        i = j
    return owners
