"""Utilities of the port: `telemetry` (the retrace sentinel)."""
