"""Mesh and axis context threaded through model code.

The counterpart of ``repro.distributed.context``. ``Dist`` names the mesh
axes and carries the sizes model code needs for static shape math (MoE
capacities, padding). ``Dist.single()`` is the one-process stand-in:
model code never branches on "is distributed", only on axis sizes.

Axis convention, the reference's:
    pod    — outer data parallelism (slow inter-pod links), or the GPipe
             stages of ``launch/pipeline.py``; optional
    data   — intra-pod data parallelism / FSDP / MoE expert ownership
    model  — tensor parallelism (heads, ffn, vocab) / MoE ffn sharding

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` whose dim
names are among ``pod`` / ``data`` / ``model`` (``launch.mesh.make_mesh``
builds one). The port cannot import ``jax.sharding``, so it keeps its own
small spec type ``P``: a tuple whose entries are an axis name, ``None``
(replicated) or a tuple of names (the dim split over their product, the
first name major), as ``PartitionSpec`` holds them. ``sharding(*axes)``
returns such a spec where the reference returns a ``NamedSharding``.

``group(axes)`` returns the process group of this rank's coordinate line
along ``axes`` (one name, or a tuple of names) and ``coord(axes)`` its
index on that line, the first name major. A group over several names is
made at its first request, by every rank together (``new_group`` is
collective), so every rank asks for it in the same order: the model code
is one program on every rank, and it does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch.distributed as tdist


class P(tuple):
    """A partition spec: one entry per leading dim of a tensor, each an
    axis name, None or a tuple of names; dims past its length are
    replicated. A tuple of one name is stored as the name, as
    ``PartitionSpec`` stores it."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes))

    def __getnewargs__(self):            # pickles as P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def axis_names(axis) -> tuple:
    """An entry of a spec as a tuple of names: None -> (), "x" -> ("x",)."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


@dataclass(frozen=True)
class Dist:
    mesh: object | None = None          # torch.distributed DeviceMesh
    pod_axis: str | None = None
    data_axis: str = "data"
    model_axis: str = "model"
    _groups: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def single(cls) -> "Dist":
        return cls(mesh=None)

    @classmethod
    def from_mesh(cls, mesh) -> "Dist":
        names = mesh.mesh_dim_names
        return cls(mesh=mesh, pod_axis="pod" if "pod" in names else None,
                   data_axis="data", model_axis="model")

    # -- sizes -----------------------------------------------------------
    def axis_size(self, name) -> int:
        """The size of one axis, or the product over a tuple of names; 1
        without a mesh or for None."""
        if self.mesh is None:
            return 1
        size = 1
        for a in axis_names(name):
            size *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        return size

    @property
    def n_pod(self) -> int:
        return self.axis_size(self.pod_axis)

    @property
    def n_data(self) -> int:
        return self.axis_size(self.data_axis) if self.mesh is not None else 1

    @property
    def n_model(self) -> int:
        return self.axis_size(self.model_axis) if self.mesh is not None else 1

    @property
    def n_devices(self) -> int:
        return self.n_pod * self.n_data * self.n_model

    # -- batch/token axes --------------------------------------------------
    @property
    def batch_axes(self):
        """Mesh axes that shard the batch/token dimension."""
        if self.mesh is None:
            return None
        return ((self.pod_axis, self.data_axis) if self.pod_axis
                else (self.data_axis,))

    def spec(self, *axes) -> P:
        """Spec helper; None entries pass through."""
        return P(*axes)

    def sharding(self, *axes) -> P | None:
        if self.mesh is None:
            return None
        return P(*axes)

    # -- this rank on the mesh ---------------------------------------------
    def coord(self, axes) -> int:
        """This rank's index along ``axes`` (the first name major); 0
        without a mesh."""
        idx = 0
        for a in axis_names(axes):
            idx = idx * self.axis_size(a) + (
                self.mesh.get_local_rank(a) if self.mesh is not None else 0)
        return idx

    def _dims(self, axes) -> list[int]:
        names = axis_names(axes)
        dims = [self.mesh.mesh_dim_names.index(a) for a in names]
        if dims != sorted(dims):
            raise ValueError(f"axes {names} must follow the mesh's order "
                             f"{self.mesh.mesh_dim_names}")
        return dims

    def group(self, axes):
        """The process group along ``axes`` (names in the mesh's order): the
        mesh's own for one name, one made here (collectively, at the first
        request) for several. Its group ranks follow ``coord``."""
        names = axis_names(axes)
        if len(names) == 1:
            return self.mesh.get_group(names[0])
        if names not in self._groups:
            dims = self._dims(names)
            rest = [d for d in range(self.mesh.ndim) if d not in dims]
            lines = self.mesh.mesh.permute(*rest, *dims).reshape(-1, self.axis_size(names))
            mine = None
            for line in lines.tolist():
                g = tdist.new_group(line)
                if tdist.get_rank() in line:
                    mine = g
            self._groups[names] = mine
        return self._groups[names]

    def line_ranks(self, axes) -> list[int]:
        """The global ranks of this rank's line along ``axes`` (names in the
        mesh's order), in the order of ``coord``."""
        dims = self._dims(axes)
        index = tuple(slice(None) if d in dims
                      else self.mesh.get_local_rank(self.mesh.mesh_dim_names[d])
                      for d in range(self.mesh.ndim))
        return self.mesh.mesh[index].reshape(-1).tolist()
