"""Train steps captured as CUDA graphs: the port's counterpart of
``jax.jit(step, donate_argnums=(0,))``.

A step body ``body(owner, *inputs) -> metrics`` (*owner*: the train state
or the model it updates in place; *inputs*: tensors; *metrics*: a dict of
0-dim tensors, computed with no host sync) runs on a CUDA device as one
captured graph, replayed on every call. For each owner and each signature
of the inputs (shapes and dtypes), as jit traces once per signature:

1. the first call copies its inputs into static device buffers and runs
   the body eagerly on a side stream: a warm-up that is a real step, so
   that the optimizer state exists before the capture;
2. the second call copies its inputs in, captures the body with
   ``torch.cuda.graph`` into the memory pool that every graph of the step
   shares, and replays it once;
3. every later call copies its inputs in and replays.

So each call is exactly one step. The owner's tensors (parameters,
optimizer moments, batch-norm statistics, a tensor learning rate) are
updated in place, which keeps them at the addresses the graph captured:
the counterpart of donation. The graphs share one pool safely because they
run one at a time and keep nothing in it from one replay to the next but
their metrics, which each call clones at once: a caller who keeps one
step's loss does not see the next step's. A capture that fails raises;
nothing runs the body eagerly on CUDA after it. On the CPU the body runs
eagerly on every call.

The flash-attention wrappers count their launches in Python, which under
a capture runs once and launches nothing: the capture's counts are taken
back out and each replay adds them (``counting_capture``,
``count_replay``).

An input may be a ``DTensor`` (a sharded loader's global batch): the step
takes its local block. A body's collectives (the data-parallel step's
all-reduces, NCCL) are captured with it: the warm-up has run each once
before the capture, on the same communicator.

Captures run on a stream of their own (``capture_stream``). A capture may
run while other threads copy (a loader's batches), which its
``thread_local`` mode allows, but only if no other thread uses the stream
being captured. ``torch.cuda.Stream()`` does not make a stream: it hands
out the pool's 32 streams of its priority round-robin, and
``torch.cuda.graph`` captures by default on one of the default-priority
ones. So a data context's copy stream made anywhere in the process can be
that very stream, and a loader's copy and event wait on it then land in
the capture and invalidate it (``cudaErrorStreamCaptureInvalidated``).
Captures therefore take a higher-priority pool, from which the port hands
out nothing else.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import torch

from strom_torch.ops import flash_attention as fa
from strom_torch.parallel.sharding import local_tensor


# device index -> the stream every capture on that device runs on
_capture_streams: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream graphs on *device* are captured on: from the pool of
    priority -1, which no other stream of the port comes from (they all
    take the default priority's pool, shared round-robin; see the module's
    docstring). A capture runs on one thread at a time, so one a device
    will do."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    s = _capture_streams.get(index)
    if s is None:
        s = _capture_streams[index] = torch.cuda.Stream(index, priority=-1)
    return s


@dataclasses.dataclass
class _Graph:
    owner: Any                              # held: its tensors are the graph's
    inputs: tuple[torch.Tensor, ...]        # static input buffers
    graph: torch.cuda.CUDAGraph | None = None
    outputs: dict[str, torch.Tensor] | None = None
    launches: collections.Counter | None = None


class CapturedStep:
    """``step(owner, *inputs)``: *body* on *device*, captured and replayed
    on CUDA, eager on the CPU; ``finish(owner, metrics)`` (default: the
    metrics) runs on the host after each call and gives its result.

    ``eager`` runs the same body op by op on the device, never captured:
    the reference the checks hold the graphs to. ``last_call`` says what
    the last call did (``"eager"``, ``"warmup"``, ``"capture"``: captured
    and replayed once, or ``"replay"``) and ``graphs`` how many graphs
    exist."""

    def __init__(self, body: Callable[..., dict], device: torch.device, *,
                 finish: Callable[[Any, dict], Any] | None = None):
        self.body = body
        self.device = torch.device(device)
        self._finish = finish or (lambda owner, metrics: metrics)
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = None
        self.last_call: str | None = None

    @property
    def graphs(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def eager(self, owner: Any, *inputs: torch.Tensor) -> Any:
        inputs = tuple(local_tensor(t).to(self.device, non_blocking=True)
                       for t in inputs)
        self.last_call = "eager"
        return self._finish(owner, self.body(owner, *inputs))

    def __call__(self, owner: Any, *inputs: torch.Tensor) -> Any:
        if self.device.type != "cuda":
            return self.eager(owner, *inputs)
        inputs = tuple(local_tensor(t) for t in inputs)
        key = (id(owner),) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = _Graph(owner, tuple(
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in inputs))
            self._fill(entry, inputs)
            metrics = self._warmup(entry)
        else:
            self._fill(entry, inputs)
            first = entry.graph is None
            if first:
                self._capture(entry)
            entry.graph.replay()
            fa.count_replay(entry.launches)
            self.last_call = "capture" if first else "replay"
            metrics = {k: v.clone() for k, v in entry.outputs.items()}
        return self._finish(owner, metrics)

    @staticmethod
    def _fill(entry: _Graph, inputs: tuple[torch.Tensor, ...]) -> None:
        """The call's inputs into the static buffers, on the current stream
        (after whatever the caller ordered there, a delivered batch's copy
        included)."""
        for buf, t in zip(entry.inputs, inputs):
            buf.copy_(t, non_blocking=True)

    def _warmup(self, entry: _Graph) -> dict:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self.body(entry.owner, *entry.inputs)
        current.wait_stream(side)
        self.last_call = "warmup"
        return {k: v.clone() for k, v in metrics.items()}

    def _capture(self, entry: _Graph) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        try:
            # thread_local: the loader's threads keep copying on their own
            # streams while this thread captures
            with fa.counting_capture() as launches, torch.cuda.graph(
                    graph, pool=self._pool,
                    stream=capture_stream(self.device),
                    capture_error_mode="thread_local"):
                outputs = self.body(entry.owner, *entry.inputs)
        finally:
            # a capture that raised leaves its stream current
            torch.cuda.set_stream(current)
        entry.graph, entry.outputs, entry.launches = graph, outputs, launches
