"""Run-log formatting (port of ``health_suffix`` in
``kfac_pytorch_tpu/utils/runlog.py``)."""


def health_suffix(epoch_counts):
    """An epoch's health-guard deltas for the epoch line:
    ``metrics.HealthMonitor.epoch_flush()``'s dict formats to '' for a
    clean epoch, else e.g. `` [health: skipped=2 sgd_fallbacks=1
    max_rung=1]`` (grep run logs for ``[health:``)."""
    if not epoch_counts or not any(epoch_counts.values()):
        return ''
    return (' [health: skipped=%d sgd_fallbacks=%d max_rung=%d]'
            % (epoch_counts['skipped'], epoch_counts['fallbacks'],
               epoch_counts['max_rung']))
