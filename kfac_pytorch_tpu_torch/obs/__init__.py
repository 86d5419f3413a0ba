"""Observability of the port: one schema for what a run did and how long
it took (the port's own stdlib copy of ``kfac_pytorch_tpu/obs/``, less
``aggregate`` and ``drift``: ROADMAP queue 1).

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

Stdlib only, apart from the profiler bridge (``torch`` imported where a
range is opened).
"""

import os as _os

from kfac_pytorch_tpu_torch.obs import metrics, trace

__all__ = ['trace', 'metrics', 'setup_trainer']


def setup_trainer(trace_dir=None, prom_file=None):
    """The trainers' observability bootstrap: installs the process's trace
    recorder (``trace_dir`` wins over ``KFAC_TRACE_DIR``; neither = no
    tracing) and builds the metrics registry with the resilience
    counters' collector, a JSONL exporter to ``trace_dir/metrics.jsonl``
    and a Prometheus textfile exporter at ``prom_file`` (namespaced by
    ``KFAC_TENANT``/``KFAC_JOB_ID`` when set). The trainer adds its
    TensorBoard exporter itself. Returns ``(tracer_or_None, registry)``.

    The JAX package's ``governor=`` and ``tuner=`` (the straggler
    governor's and the autotuner's counts) come with those objects
    (ROADMAP queue 1, slices G and F2)."""
    if trace_dir:
        from kfac_pytorch_tpu_torch.utils.runlog import process_index
        tracer = trace.install(
            _os.path.join(trace_dir, f'trace-host{process_index()}.jsonl'))
    else:
        tracer = trace.install_from_env()
    reg = metrics.Registry()
    reg.add_collector(metrics.resilience_collector())
    if trace_dir:
        reg.add_exporter(metrics.JsonlExporter(
            _os.path.join(trace_dir, 'metrics.jsonl')))
    if prom_file:
        reg.add_exporter(metrics.PrometheusTextfileExporter(
            metrics.namespaced_prom_path(prom_file)))
    return tracer, reg
