"""Resilience (fault injection so far)."""
