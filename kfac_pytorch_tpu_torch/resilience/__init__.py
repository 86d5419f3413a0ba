"""Process-level resilience of the port (its own copy of the parts of
``kfac_pytorch_tpu/resilience/`` the trainers use; stdlib only, apart
from :mod:`.elastic`, which works on the port's train state).

- :mod:`.retry`: retry with backoff and jitter for transient host-side
  I/O (checkpoint save and restore, the next batch), with an injectable
  clock so tests pin attempt counts and delays without sleeping.
- :mod:`.elastic`: :func:`~.elastic.elastic_resume`, the world-size-aware
  resume that carries a checkpoint taken at one world into another
  through ``KFAC.replan(num_devices=)``.

Each retry is logged as a WARNING. The JAX package's event counters
(and the run-log suffix that reads them), the pod supervisor, the
heartbeat, the step watchdog and the straggler governor are not ported
(ROADMAP queue 1, slice G).
"""

import json
import os


def atomic_write_json(path, obj, **dump_kw):
    """Write ``obj`` as JSON to ``path`` atomically (the whole file to a
    temp name, then ``os.replace``): a reader never sees a torn file, and
    a failed write leaves no temp file behind. Returns ``path``."""
    tmp = f'{path}.tmp-{os.getpid()}'
    try:
        with open(tmp, 'w') as f:
            json.dump(obj, f, **dump_kw)
            f.write('\n')
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


from kfac_pytorch_tpu_torch.resilience.retry import (  # noqa: E402
    ManualClock, RetryError, RetryPolicy, call_with_retry, resumable_iter)
from kfac_pytorch_tpu_torch.resilience.elastic import (  # noqa: E402
    ENV_LINEAGE, elastic_resume)

__all__ = ['atomic_write_json', 'ManualClock',
           'RetryError', 'RetryPolicy', 'call_with_retry', 'resumable_iter',
           'ENV_LINEAGE', 'elastic_resume']
