"""Fault tolerance for the serving loop (``fault``: the step watchdog)."""
