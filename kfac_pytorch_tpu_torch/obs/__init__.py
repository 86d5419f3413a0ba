"""Observability of the port: one schema for what a run did and how long
it took (the port's own stdlib copy of ``kfac_pytorch_tpu/obs/``, less
``aggregate``: ROADMAP queue 1, slice G).

- :mod:`.trace`: host-side spans and instants in the Chrome trace-event
  format (Perfetto and ``chrome://tracing`` load them), a bounded ring
  flushed on the run log's SIGTERM/atexit chain. A train step's span
  carries its phases in the ``exclude_parts`` taxonomy
  (ComputeFactor, ComputeInverse, CommunicateInverse, Precondition),
  the names of the ``torch.profiler`` ranges the preconditioner opens.
- :mod:`.metrics`: a typed registry (counter, gauge, watermark,
  histogram) with exporters gated to rank 0 (JSONL, the native
  TensorBoard writer, a Prometheus textfile) that also renders the epoch
  line's suffixes.
- :mod:`.drift`: measured per-phase wall time against ``perfmodel``'s
  predictions, as per-phase ratios and a band verdict (the tuner's commit
  veto on the card the model describes).

Stdlib only, apart from the profiler bridge (``torch`` imported where a
range is opened).
"""

import os as _os

from kfac_pytorch_tpu_torch.obs import drift, metrics, trace

__all__ = ['trace', 'metrics', 'drift', 'setup_trainer']


def setup_trainer(trace_dir=None, prom_file=None, tuner=None):
    """The trainers' observability bootstrap: installs the process's trace
    recorder (``trace_dir`` wins over ``KFAC_TRACE_DIR``; neither = no
    tracing) and builds the metrics registry with the resilience
    counters' collector (with an ``autotune.KnobController``'s counts when
    ``tuner`` is given, and its collector of the current knob gauges), a
    JSONL exporter to ``trace_dir/metrics.jsonl`` and a Prometheus
    textfile exporter at ``prom_file`` (namespaced by
    ``KFAC_TENANT``/``KFAC_JOB_ID`` when set). The trainer adds its
    TensorBoard exporter itself. Returns ``(tracer_or_None, registry)``.

    The JAX package's ``governor=`` (the straggler governor's counts)
    comes with that object (ROADMAP queue 1, slice G)."""
    if trace_dir:
        from kfac_pytorch_tpu_torch.utils.runlog import process_index
        tracer = trace.install(
            _os.path.join(trace_dir, f'trace-host{process_index()}.jsonl'))
    else:
        tracer = trace.install_from_env()
    reg = metrics.Registry()
    extra_counts = [tuner.counts] if tuner is not None else []
    reg.add_collector(metrics.resilience_collector(*extra_counts))
    if tuner is not None:
        reg.add_collector(tuner.collect)
    if trace_dir:
        reg.add_exporter(metrics.JsonlExporter(
            _os.path.join(trace_dir, 'metrics.jsonl')))
    if prom_file:
        reg.add_exporter(metrics.PrometheusTextfileExporter(
            metrics.namespaced_prom_path(prom_file)))
    return tracer, reg
