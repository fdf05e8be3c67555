"""Three-term roofline of a dry-run cell on the H100.

The counterpart of ``repro.analysis.roofline``, with its fields and
formulas and an NVIDIA H100 SXM's constants in place of the TPU v5e's:

    compute_s    = flops / PEAK_FLOPS               (per rank)
    memory_s     = bytes / HBM_BW                   (per rank)
    collective_s = collective_bytes / LINK_BW       (per rank)

``flops``, ``bytes`` and ``collective_bytes`` are ``op_cost``'s per-rank
counts of one step (``launch/dryrun.py``'s payload ``op_cost``); the
fields keep the reference's names (``hlo_flops``, ``hlo_bytes``). These
are computed figures: nothing here is measured on a card.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import asdict, dataclass, field

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores (NVIDIA H100 SXM datasheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (NVIDIA H100 SXM datasheet)
# NVLink: 900 GB/s per SXM5 GPU, both directions together (NVIDIA H100
# datasheet, "NVLink: 900GB/s"); a rank receives at half of it. It holds
# inside one NVLink domain (8 GPUs of an HGX board); a mesh of 256 or 512
# ranks spans nodes whose network is slower, so collective_s is a floor.
LINK_BW = 450e9              # bytes/s a rank receives


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    hlo_flops: float                 # per rank (op_cost's count)
    hlo_bytes: float                 # per rank
    collective_bytes: float          # per rank
    collectives: dict = field(default_factory=dict)
    model_flops: float = 0.0         # 6·N·D or 2·N·D (global)
    n_devices: int = 256
    param_bytes: float = 0.0         # global (bf16)
    cache_bytes: float = 0.0         # global KV/SSM cache (decode cells)
    kind: str = "train"              # train | prefill | decode

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs × ranks): remat and redundant work."""
        total = self.hlo_flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def ideal_step_s(self) -> float:
        """The workload's own floor per rank: useful FLOPs at the peak
        (train, prefill); decode also streams the weights and the cache
        once."""
        compute = (self.model_flops / self.n_devices) / PEAK_FLOPS
        if self.kind != "decode":
            return compute
        bytes_ideal = (self.param_bytes + self.cache_bytes) / self.n_devices
        return max(compute, bytes_ideal / HBM_BW)

    @property
    def roofline_fraction(self) -> float:
        """ideal_step / roofline step: how close the counted step is to the
        workload's own floor (≈ MFU for train / prefill, bandwidth use for
        decode)."""
        if self.step_time_s == 0:
            return 0.0
        return self.ideal_step_s / self.step_time_s

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, bottleneck=self.bottleneck,
                 step_time_s=self.step_time_s, ideal_step_s=self.ideal_step_s,
                 useful_flops_fraction=self.useful_flops_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = cfg.active_param_count()
    return (6.0 if shape_kind == "train" else 2.0) * n * tokens


def report_from_dryrun(payload: dict) -> RooflineReport:
    shape = payload["shape"]
    kind = ("train" if "train" in shape
            else "prefill" if "prefill" in shape else "decode")
    cost = payload["op_cost"]
    coll_bytes = float(cost["total_collective_bytes"])
    return RooflineReport(
        arch=payload["arch"], shape=shape, mesh=payload["mesh"],
        hlo_flops=float(cost["flops"]), hlo_bytes=float(cost["bytes"]),
        collective_bytes=coll_bytes,
        collectives={"bytes": cost["collective_bytes"],
                     "counts": cost["collective_counts"], "total_bytes": coll_bytes},
        model_flops=float(payload.get("model_flops", 0.0)),
        n_devices=int(payload.get("n_devices", 256)),
        param_bytes=float(payload.get("active_params", 0)) * 2.0,
        cache_bytes=float(payload.get("cache_bytes", 0.0)),
        kind=kind)


def load_reports(path: str) -> list[RooflineReport]:
    reports = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            payload = json.load(fh)
        if "op_cost" in payload:
            reports.append(report_from_dryrun(payload))
    return reports
