"""Operator plugins for ``mx.library.load``."""
