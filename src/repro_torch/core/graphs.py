"""Captured programs: the port's counterpart of ``jax.jit``.

The reference compiles its device searches (``repro.core.hnsw``'s
``_flat_search_classified``, ``beam_search`` and ``beam_search_classified``)
and its generation (``repro.serving.engine``'s ``generate``) into one XLA
program per signature. The CUDA counterpart of such a program is a captured
``torch.cuda.CUDAGraph``: its kernels replay with one host call, so the
host no longer pays a launch for each of the dozens of small kernels of a
beam search or the thousands of a decode step.

``CapturedProgram`` holds the programs of one owner (an index, or an engine
and its model), one per key:

* **Static inputs.** A program's host inputs (numpy arrays) travel in one
  packed buffer on the device, filled from one pinned host buffer by one
  host-to-device copy per call; the program reads views of it.
* **Capture.** On the first use of a key on the card, ``fn(*views)`` runs
  once eagerly on a side stream (the warm-up: lazy set-up such as the
  kernel build, cuBLAS handles or the model's fp32 head copy happens
  there, with PyTorch's sync debug mode set to raise), then is captured
  on that stream. Every graph of one holder allocates from one memory
  pool. A capture or replay error raises: nothing carries on eagerly on
  the card.
* **Replay.** Later calls copy the inputs in and replay; the call returns
  the program's output tensors, which the next replay overwrites.
* **On the CPU** nothing is captured: ``fn`` runs eagerly on the same
  static buffers, so the copy-in plumbing is what the CPU tests check.
* **Launch accounting.** A kernel wrapper counts a launch where it makes
  it (``kernels._build.count``): in ``<wrapper>.launches`` when the kernel
  runs then (the warm-up's, an eager call's), in ``<wrapper>.recorded``
  when it is recorded into a graph being captured. A replay calls no
  wrapper. The holder keeps what each capture recorded, per wrapper
  (``recorded(key)``: the launches of one replay), and counts the
  replays; it never writes a counter.

``captures`` and ``replays`` count, per key, the captures and the replays
(on the CPU, the eager runs that stand in for replays).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import ops


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


class StaticInputs:
    """A program's inputs as views of ONE packed device buffer, filled
    from one host buffer (pinned on the card) by one copy. Every input
    starts on a 16-byte boundary."""

    def __init__(self, arrays: Sequence[np.ndarray], device: torch.device):
        arrays = [np.asarray(a) for a in arrays]
        self.layout, pos = [], 0
        for a in arrays:
            self.layout.append((pos, a.dtype, a.shape))
            pos = _round16(pos + a.nbytes)
        pin = device.type == "cuda"
        with torch.inference_mode(False):   # writable in and out of inference mode
            self.host = torch.zeros(max(pos, 16), dtype=torch.uint8, pin_memory=pin)
            self.buf = torch.zeros(self.host.shape, dtype=torch.uint8, device=device)
        raw = self.host.numpy()
        self._host_views = [raw[off:off + a.nbytes].view(dtype).reshape(shape)
                            for (off, dtype, shape), a in zip(self.layout, arrays)]
        self.views = [self.buf[off:off + a.nbytes].view(_torch_dtype(dtype)).view(shape)
                      for (off, dtype, shape), a in zip(self.layout, arrays)]
        # The host buffer is rewritten only after the last copy has read it.
        self._copied = torch.cuda.Event() if pin else None

    def fill(self, arrays: Sequence[np.ndarray]) -> None:
        arrays = [np.asarray(a) for a in arrays]
        if [(a.dtype, a.shape) for a in arrays] != [l[1:] for l in self.layout]:
            raise ValueError(f"static inputs are {[l[1:] for l in self.layout]}, got "
                             f"{[(a.dtype, a.shape) for a in arrays]}")
        if not arrays:
            return
        if self._copied is not None:
            self._copied.synchronize()
        for view, a in zip(self._host_views, arrays):
            view[...] = a
        self.buf.copy_(self.host, non_blocking=self._copied is not None)
        if self._copied is not None:
            self._copied.record()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


@dataclass
class _Program:
    inputs: StaticInputs
    graph: torch.cuda.CUDAGraph | None = None
    output: object = None
    # kernel wrapper -> the launches its capture recorded (one replay's)
    recorded: dict = field(default_factory=dict)


class CapturedProgram:
    """The captured programs of one owner, by key (see the module
    docstring). ``counters`` are the wrappers whose recorded launches a
    capture reads (default: every kernel wrapper of the port)."""

    def __init__(self, device: str | torch.device,
                 counters: Sequence[Callable] | None = None):
        self.device = torch.device(device)
        self.counters = tuple(ops.COUNTED if counters is None else counters)
        self.captures: dict = {}
        self.replays: dict = {}
        self._programs: dict = {}
        self._pool = None
        self._stream = None

    @property
    def graphs(self) -> bool:
        """Whether this holder captures graphs (on the card) or runs its
        programs eagerly (on the CPU)."""
        return self.device.type == "cuda"

    def ready(self, key) -> bool:
        """True when a run of ``key`` needs no capture: it was captured,
        or this holder captures nothing (the CPU)."""
        prog = self._programs.get(key)
        return not self.graphs or (prog is not None and prog.graph is not None)

    def keys(self) -> list:
        return list(self._programs)

    def recorded(self, key) -> dict:
        """The kernel launches the capture of ``key`` recorded, by wrapper:
        what one replay of its graph launches on the card."""
        return dict(self._programs[key].recorded)

    def clear(self) -> None:
        """Drop every program, its graph and its static buffers (the
        captures and replays counted so far stay)."""
        self._programs.clear()
        self._pool = None

    def capture(self, key, fn: Callable, inputs: Sequence[np.ndarray] = ()) -> None:
        """Copy ``inputs`` in and, on the card, warm ``fn`` up and capture
        it under ``key`` (once): no replay. On the CPU only the static
        inputs are set up."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(StaticInputs(inputs, self.device))
        prog.inputs.fill(inputs)
        if self.graphs and prog.graph is None:
            self._capture(key, prog, fn)

    def run(self, key, fn: Callable, inputs: Sequence[np.ndarray] = ()):
        """``fn(*static views of inputs)``: on the card a replay of the
        graph captured under ``key`` (captured on first use), on the CPU
        an eager call. Returns the program's output; on the card it is the
        graph's own output, which the next replay of ``key`` overwrites."""
        prog = self._programs.get(key)
        if prog is None or not self.ready(key):
            self.capture(key, fn, inputs)
            prog = self._programs[key]
        else:
            prog.inputs.fill(inputs)
        self.replays[key] = self.replays.get(key, 0) + 1
        if not self.graphs:
            return fn(*prog.inputs.views)
        prog.graph.replay()
        return prog.output

    def _capture(self, key, prog: _Program, fn: Callable) -> None:
        """Warm up, then capture, keeping the launches the capture
        recorded by wrapper."""
        self._warm_up(fn, prog.inputs.views)
        before = [w.recorded for w in self.counters]
        prog.graph, prog.output = self._record(fn, prog.inputs.views)
        prog.recorded = {w: w.recorded - b for w, b in zip(self.counters, before)
                         if w.recorded != b}
        self.captures[key] = self.captures.get(key, 0) + 1

    def _warm_up(self, fn: Callable, views: list) -> None:
        """``fn`` once, eagerly, on the side stream that captures, with a
        host sync raising (a sync would also fail the capture)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(self._stream):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*views)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    def _record(self, fn: Callable, views: list):
        """Capture ``fn`` on the side stream into this holder's pool:
        returns (graph, its output)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = fn(*views)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return graph, out
