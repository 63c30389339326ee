"""Utilities of the port: `metrics` (Counter/Gauge/Histogram and the
Prometheus rendering), `tracing` (spans and their ring), `telemetry`
(the flight recorder, the stats bridge, the retrace sentinel, MFU) and
`faults` (fault injection)."""
