"""Serving layer: the paper's system context.

    simulator — discrete-event cache/LLM latency simulation (paper tables)
    engine    — live batched serving with the semantic cache over real models
    router    — multi-model routing + per-model adaptive policies (§7.5.5)
"""

from repro_torch.serving.engine import (EngineStats, Request, Response,  # noqa: F401
                                        ServingEngine)
from repro_torch.serving.router import ModelBackend, ModelRouter  # noqa: F401
from repro_torch.serving.simulator import (ServingSimulator, SimConfig,  # noqa: F401
                                           SimResult)
