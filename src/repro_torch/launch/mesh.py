"""Meshes, and the processes that hold their ranks.

The counterpart of ``repro.launch.mesh``. ``make_production_mesh`` is a
function, so importing this module touches no process group: single pod
16 × 16 = 256 ranks (data, model); multi-pod 2 × 16 × 16 = 512 (pod,
data, model). ``make_mesh`` builds a ``torch.distributed`` DeviceMesh
over the default process group, which must already span exactly the
mesh's ranks: a mesh whose size differs from the world size raises.

JAX drives every device from one controller; PyTorch runs one process a
rank. ``launch_ranks(fn, world, backend=, device=)`` is the port's stand-in
for that controller: it starts ``world`` processes (``spawn``), each joins
the default group over ``tcp://localhost:<a free port>``, takes its device
(rank r: ``cuda:(r % device_count)``, or the CPU where ``device="cpu"``,
which only ``gloo`` carries) and runs ``fn(rank, world, *args)``. It
returns the ranks' results in rank order. A rank that raises makes the
launcher stop every rank and raise with that rank's traceback, and so
does a rank that dies or a run past ``timeout``: nothing hangs and
nothing falls back to fewer ranks or to the CPU. Without a card and
without ``device="cpu"`` it raises, as the port's other entry points do.
"""

from __future__ import annotations

import datetime
import math
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A DeviceMesh of ``shape`` with dim names ``axes`` over the default
    process group (row-major: the last axis varies fastest over ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks; the "
                         f"world has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, timeout_s, jobs, results):
    try:
        fn, args = jobs.get()
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                 world_size=world, rank=rank,
                                 timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, *args)
        tdist.barrier()
        # by value: a tensor put on the queue as it is would be shared
        # memory that this process takes with it when it exits
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:                       # reported to the launcher, re-raised there
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def launch_ranks(fn, world: int, *, backend: str, device: str | None = None,
                 args: tuple = (), timeout: float = 900.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes of one process
    group (``backend``) and return their results in rank order. ``fn``
    and ``args`` must pickle (a module-level function). ``device`` None
    means the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("launch_ranks: no CUDA device available; pass "
                               "device='cpu' (gloo) to run the ranks on the CPU")
        device = "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"launch_ranks: device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cpu" and backend != "gloo":
        raise ValueError("launch_ranks: CPU ranks need the gloo backend")
    ctx = mp.get_context("spawn")
    # The function and its arguments go through a queue, whose feeder
    # thread writes while the ranks start: passed to the processes, they
    # would start one by one (each start waits while its rank imports).
    jobs, results = ctx.Queue(), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, device, timeout, jobs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    for _ in procs:
        jobs.put((fn, args))
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode != 0 and r not in out]
                if dead:
                    raise RuntimeError(f"launch_ranks: rank {dead[0]} died "
                                       f"(exit code {procs[dead[0]].exitcode})") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch_ranks: {world - len(out)} of {world} "
                                       f"ranks unfinished after {timeout} s") from None
                continue
            if status == "error":
                raise RuntimeError(f"launch_ranks: rank {rank} raised:\n{value}")
            out[rank] = pickle.loads(value)     # written by our own rank
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        jobs.close()
        results.close()
    return [out[r] for r in range(world)]
