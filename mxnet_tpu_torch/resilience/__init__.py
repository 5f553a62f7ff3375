"""Resilience: fault injection, checkpoints, bounded retry and the
preemption drain."""
