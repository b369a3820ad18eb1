"""Decode programs captured as CUDA graphs: the counterpart of the JAX
serving layer's compiled programs (the token loop of
flash_attn_tpu/serving/generation.py, the engine's jitted decode block and
speculative round) and of the reference's ``capture_graph`` /
``update_graph_cache`` (one graph per decode shape, replayed every step).

A :class:`CapturedProgram` is empty until its first call. That call runs
the program eagerly on static copies of its inputs: the warm-up, which
loads the kernel library, sets each kernel's shared-memory attribute and
builds rotary tables and the matmul library's workspaces, and whose
result is the call's real result. It then captures the same program on a
side stream into a ``torch.cuda.CUDAGraph`` over those static inputs;
capture records the launches and runs none. Every later call copies its
inputs into the static buffers and replays the graph, returning the
graph's static outputs, which the next replay overwrites.

A replay runs no Python, so the kernel wrappers' launch counters
(:func:`flash_attn_tpu_torch.kernels.launch_counters`) would not move: the
program adds to each counter what the capture recorded. A capture
that fails raises; nothing falls back to eager dispatch. The program must
reach device state only through tensors whose storage outlives the graph
(the callers keep their caches, tables and counters in static buffers) and
must not read the device from the host. Random draws inside a graph come
from the default CUDA generator or from the generators the program
registers. The CPU path never captures: it is the plain path.
"""

from typing import Dict, Sequence, Tuple

import torch

from flash_attn_tpu_torch.kernels import launch_counters

__all__ = ["CapturedProgram"]


_capture_streams: Dict[int, torch.cuda.Stream] = {}


def _capture_stream() -> torch.cuda.Stream:
    """The one side stream of the current card that every capture runs on
    (as ``torch.cuda.graph``'s default capture stream): the matmul library
    keeps a workspace per stream, allocated at the first capture on it in
    that graph's pool, so a fresh stream per capture would leave one more
    workspace (32 MiB on an H100) behind at every capture."""
    dev = torch.cuda.current_device()
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream(dev)
    return _capture_streams[dev]


class CapturedProgram:
    """One program, warmed and captured at its first call and replayed at
    every later one. ``generators`` are registered with the graph so that
    their draws advance at each replay as they would eagerly."""

    def __init__(self, generators: Sequence[torch.Generator] = ()):
        self.generators = tuple(generators)
        self.graph = None
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.outputs = None
        self.launches: Dict[Tuple[object, str], int] = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, fn, *args):
        """``fn(*args)``: eagerly and then captured at the first call, by
        a replay at every later one (``fn`` is then not called; it is
        never kept, so the program holds no reference to what ``fn``
        closes over)."""
        if self.graph is None:
            return self._warm_and_capture(fn, args)
        return self.replay(*args)

    def replay(self, *args):
        for buf, x in zip(self.inputs, args, strict=True):
            buf.copy_(x)
        self.graph.replay()
        for (mod, attr), n in self.launches.items():
            setattr(mod, attr, getattr(mod, attr) + n)
        return self.outputs

    def _warm_and_capture(self, fn, args):
        if not all(x.is_cuda for x in args) or not torch.cuda.is_available():
            raise ValueError("CapturedProgram: CUDA graphs need the card and "
                             "CUDA tensors")
        self.inputs = tuple(x.clone() for x in args)
        result = fn(*self.inputs)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize()
        before = launch_counters()
        side = _capture_stream()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn(*self.inputs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        after = launch_counters()
        # capture launched nothing: take back what the wrappers counted and
        # add it at every replay instead
        for (mod, attr), n in before.items():
            setattr(mod, attr, n)
        self.launches = {key: after[key] - n for key, n in before.items()
                         if after[key] != n}
        self.graph, self.outputs = graph, outputs
        return result
