"""Serving layer: the live engine with the semantic cache in front of the
model (``engine``). The reference's simulator and router are not ported
yet."""

from repro_torch.serving.engine import (EngineStats, Request, Response,  # noqa: F401
                                        ServingEngine)
