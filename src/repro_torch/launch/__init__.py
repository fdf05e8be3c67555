"""Entry points: ``serve`` (the serving driver and its CLI)."""
