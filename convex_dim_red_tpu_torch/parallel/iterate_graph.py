"""One iteration of a chunk of restarts as a CUDA graph.

:func:`parallel.restarts._round_run` advances each chunk of restarts
through ``sharded_aa._keep_best_loop``: every iteration runs the
dictionary SPG, the grouped weights QPs (K1), the cost (K5 in the
residual form), the freezes and the stop test, some 200 kernels on the
HadISST fit's chunk.  Enqueued one call at a time, they keep the card
waiting on the host.  :class:`StepGraphs` runs every iteration of a
chunk shape after its first as one replay of a CUDA graph of that
iteration:

- the first iteration of a shape runs eagerly, as it does without a
  graph, and writes its states back into the ones it was given (a chunk
  just gathered, which nothing reads again); the second is captured on
  a side stream, into the graph's own memory pool, then replayed for
  its work; every later one of that shape is a replay.  Each runs the
  same kernels on the same operands in the same order, so the results
  are the eager loop's to the bit;
- the loop's carried tensors (the states, the cost, the frozen flags,
  the iteration counts) are the graph's inputs and outputs: a replay
  writes its results back into them, and :meth:`StepGraphs.gather`
  gathers the next chunk of the shape into them, so no second set of
  states is kept.  An iteration's cost deltas land in one (R,) tensor
  of the graph, which the loop copies into its trace;
- the kernels' launch counters (``ops.LAUNCH_COUNTERS``) advance at
  the capture by what one iteration launches; the capture's own
  advance is taken back and every replay adds it, so the counts are the
  eager loop's.
  ``utils/profiling.GRAPH_CAPTURES`` and ``GRAPH_REPLAYS`` count the
  captures and the replays.  The iteration's inner spans
  (``cdr.aa.dictionary``, ``.weights``, ``.cost``) appear only for the
  eager iteration and the capture; a capture is the span
  ``cdr.restarts.capture``, a replay ``cdr.restarts.replay``, both
  inside ``cdr.restarts.iteration``.

It engages only where the code can tell that an iteration reads nothing
on the host (:func:`capturable`): the tensors are on a CUDA device and
the iterate says so (``iterate.reads_host`` false, as
``sharded_aa._aa_iterate`` sets it from its solvers' caps).  Otherwise,
and on the CPU, :class:`StepGraphs` calls the iteration directly.  A
host read inside a capture raises (``utils/profiling.host_read``).

Memory: the states written back after the first iteration become the
graph's carried states, so the capture holds one set of a chunk's
states where the eager loop, from its second iteration on, holds two
(the gathered chunk and the last iteration's) besides the one it makes.
cuBLAS keeps a workspace for every stream it runs on, held in the
caching allocator.  The capture stream's would be a second one, so
the workspaces are let go around the capture (as PyTorch's own graph
trees do): the capture stream's is then taken inside the graph's pool,
and the current stream's is taken again at its next GEMM.  The graphs
and their pools go with the round runner, when the fit returns.
"""

import torch

from ..ops import LAUNCH_COUNTERS
from ..utils import profiling
from ..utils.profiling import span

__all__ = ["StepGraphs", "capturable"]

def capturable(iterate, device):
    """Whether iterations of ``iterate`` on ``device`` may run as a CUDA
    graph: ``device`` is a CUDA device and ``iterate.reads_host`` is
    false (an iterate that does not say is taken to read the host)."""
    return (torch.device(device).type == "cuda"
            and getattr(iterate, "reads_host", True) is False)


def _counts():
    return [getattr(module, attribute)
            for module, attribute, _ in LAUNCH_COUNTERS]


def _set_counts(values):
    for (module, attribute, _), value in zip(LAUNCH_COUNTERS, values):
        setattr(module, attribute, value)


def _recording_launches(fn):
    """``(fn(), launches)``: ``launches`` what ``fn`` added to each
    counter of ``ops.LAUNCH_COUNTERS``, taken back from the counters."""
    before = _counts()
    try:
        out = fn()
    finally:
        launches = [a - b for a, b in zip(_counts(), before)]
        _set_counts(before)
    return out, launches


def _add_launches(launches):
    _set_counts([a + b for a, b in zip(_counts(), launches)])


def _release_blas_workspaces():
    """Let go of cuBLAS's per-stream workspaces (the next GEMM on a
    stream takes one again)."""
    release = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if release is not None:
        release()


def _flat(carry):
    states, cost, done, n_iters = carry
    return (*states, cost, done, n_iters)


def _key(states):
    return tuple((tuple(s.shape), s.dtype, s.device) for s in states)


def _capture(step, carry):
    """A CUDA graph of ``step(carry)`` that writes the new carry back
    into ``carry``'s tensors, captured on a side stream of their device;
    returns ``(graph, delta)``, ``delta`` the graph's output of the cost
    deltas."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(carry[1].device)
    _release_blas_workspaces()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out, delta = step(carry)
                for static, new in zip(_flat(carry), _flat(out)):
                    static.copy_(new)
            finally:
                graph.capture_end()
    finally:
        _release_blas_workspaces()
    return graph, delta


def _written_back(step, carry):
    """``step(carry)`` with the new states copied into ``carry``'s
    states, which are returned in their place: the given states are
    read by this iteration alone, and the new ones go once copied."""
    (states, *rest), delta = step(carry)
    for given, new in zip(carry[0], states):
        given.copy_(new)
    return (carry[0], *rest), delta


class _Slot:
    """The graph of one chunk shape: its carried tensors, its output of
    the cost deltas and the launches a replay adds."""

    def __init__(self):
        self.warm = False
        self.graph = None
        self.carry = self.delta = self.launches = None

    def load(self, carry):
        """Copy each tensor of ``carry`` that is not the slot's own into
        the slot's carried tensor in its place."""
        for static, given in zip(_flat(self.carry), _flat(carry)):
            if given is not static:
                static.copy_(given)

    def replay(self):
        with span("cdr.restarts.replay"):
            self.graph.replay()
        _add_launches(self.launches)
        profiling.GRAPH_REPLAYS += 1


class StepGraphs:
    """The CUDA graphs of one round runner's iterations, one per chunk
    shape (the states' shapes, dtypes and device), for the iterate
    ``iterate``.

    ``advance(step, carry)``, as ``sharded_aa._keep_best_loop`` calls
    it, returns ``step(carry)`` where :func:`capturable` says no (the
    CPU, an iterate that reads the host), and for a shape's first
    iteration the same with its states written into ``carry``'s (which
    the graph then carries); from its second on, the carried tensors
    advanced in place by a replay, and the graph's cost deltas.
    :meth:`gather` and :meth:`own` keep the carried tensors the graph's
    own across the chunks and rounds of a fit."""

    def __init__(self, iterate):
        self._iterate = iterate
        self._slots = {}

    def _slot(self, key, create):
        if not capturable(self._iterate, key[0][2]):
            return None
        if create:
            return self._slots.setdefault(key, _Slot())
        return self._slots.get(key)

    def gather(self, states_all, idx):
        """The chunk ``idx`` of the population ``states_all``: gathered
        into the carried tensors of its shape's graph where there is
        one, else ``s[idx]`` of each."""
        slot = self._slot(tuple(
            ((int(idx.shape[0]),) + tuple(s.shape[1:]), s.dtype, s.device)
            for s in states_all), create=False)
        if slot is None or slot.graph is None:
            return tuple(s[idx] for s in states_all)
        statics = slot.carry[0]
        for s_all, static in zip(states_all, statics):
            torch.index_select(s_all, 0, idx, out=static)
        return statics

    def own(self, tensors):
        """``tensors``, each a copy where it is a graph's carried tensor
        (the next chunk of its shape overwrites those)."""
        statics = [t for slot in self._slots.values() if slot.carry
                   for t in _flat(slot.carry)]
        return tuple(t.clone() if any(t is s for s in statics) else t
                     for t in tensors)

    def __call__(self, step, carry):
        slot = self._slot(_key(carry[0]), create=True)
        if slot is None:
            return step(carry)
        if slot.graph is None:
            if not slot.warm:
                slot.warm = True
                return _written_back(step, carry)
            self._capture_slot(slot, step, carry)
        else:
            slot.load(carry)
        slot.replay()
        return slot.carry, slot.delta

    def _capture_slot(self, slot, step, carry):
        with span("cdr.restarts.capture"):
            (graph, delta), launches = _recording_launches(
                lambda: _capture(step, carry))
        slot.graph, slot.carry, slot.delta = graph, carry, delta
        slot.launches = launches
        profiling.GRAPH_CAPTURES += 1
