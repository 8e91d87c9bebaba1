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

Copies of the JAX package's ``obs/`` modules; its samplers, history,
sentinel, capture, watchdog and federation wait for a later slice.
"""
