"""Fault tolerance (``fault``: preemption handler, step watchdog, retry)."""
