"""Distributed runtime: the mesh context (``Dist``), the collectives the
model code calls (``collectives``), fault tolerance (``fault``:
preemption handler, step watchdog, retry)."""

from repro_torch.distributed.context import Dist  # noqa: F401
