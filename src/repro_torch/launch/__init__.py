"""Entry points: ``serve`` (the serving driver and its CLI), ``train`` (the
training driver and its CLI) and ``steps`` (the train step)."""
