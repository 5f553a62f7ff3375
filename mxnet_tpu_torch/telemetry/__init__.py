"""Telemetry (only the percentile convention so far)."""
