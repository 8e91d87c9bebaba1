"""Observability subsystem of the port: metrics, tracing and per-query
cost accounting.

- ``obs.metrics`` — the Prometheus-style registry rendered at
  ``GET /metrics`` (every family the port emits, declared at import)
  and the ``RegistryStatsClient`` bridge from the legacy StatsClient.
- ``obs.trace`` — one trace per query (spans at parse, admission,
  execute, commit, encode and each device dispatch), a bounded ring
  behind ``GET /debug/traces`` and Chrome trace-event export.
- ``obs.accounting`` — the per-query cost ledger: container ops by
  operand-kind pair, words scanned, bits written, kernel launches and
  device bytes, kernel build seconds; ``X-Pilosa-Stats`` and the
  ``?profile=1`` cost tree.

- the operator surface: ``obs.sampler`` and ``obs.diskring`` (tail
  sampling onto a crash-safe disk ring), ``obs.runtime`` (the periodic
  collector), ``obs.federate`` (the fleet view), ``obs.profile`` (the
  continuous host profiler), ``obs.slo`` (burn rates and readiness),
  ``obs.history`` (the on-disk metric history), ``obs.blackbox`` (the
  flight recorder), ``obs.watchdog`` (stall detectors),
  ``obs.sentinel`` (regression findings over the history),
  ``obs.capture`` and ``obs.replay`` (workload capture, replay and the
  shadow diff).

Copies of the JAX package's ``obs/`` modules.
"""
