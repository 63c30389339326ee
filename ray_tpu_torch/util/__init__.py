"""Utilities of the port: `metrics` (Counter/Gauge/Histogram and the
Prometheus rendering), `tracing` (spans and their ring), `telemetry`
(the flight recorder, the stats bridge, the retrace sentinel, MFU),
`faults` (fault injection) and `storage` (the URI-keyed storage seam
checkpoints upload through)."""
