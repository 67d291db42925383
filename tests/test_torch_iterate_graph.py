"""A chunk-iteration of the restart runners as a CUDA graph
(``parallel/iterate_graph.py``).

On the CPU: which iterates may be captured (each family says so from its
solvers' caps; GPNH and the CPU never), the wrapper as the identity
there (the same bits and counters as the loop called directly), the
host read that raises under a capture, the launch counters a replay
adds, and the graph's bookkeeping run with a stand-in for the capture
that replays the iteration in place (the carried tensors gathered into,
written back and copied out where the next chunk would overwrite them).

Marked ``cuda`` (a graph needs a card; they skip without one): fits
whose chunk-iterations replay a graph against the same fits through the
loop without it, to the bit, with the same launch and slot counts, one
capture a fit and a replay for every iteration but the first; the host
read that raises inside a real capture; the memory a graphed fit takes.
This file imports no JAX; run the card's tests with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_iterate_graph.py
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import aa_fit_restarts, kernel_aa_fit_restarts
from convex_dim_red_tpu_torch.ops import (LAUNCH_COUNTERS, residual_cost,
                                          simplex_qp)
from convex_dim_red_tpu_torch.parallel import (iterate_graph, restarts,
                                               sharded_aa)
from convex_dim_red_tpu_torch.parallel.sharded_aa import _keep_best_loop
from convex_dim_red_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _data(n=40, d=12, seed=0, device='cpu', dtype=torch.float64):
    X = np.random.RandomState(seed).standard_normal((n, d))
    return torch.as_tensor(X, dtype=dtype, device=device)


def _aa_iterate(dict_cap=1, delta=0.0, scale_cap=1, has_data=True,
                backend='pallas', weights_cap=25):
    X = _data()
    K = X @ X.T
    iterate, _ = sharded_aa._aa_iterate(
        X if has_data else None, K, n_components=3, delta=delta,
        do_scale=delta != 0.0, sh=sharded_aa._Shard(device='cpu'),
        dictionary_solver_kwargs={'max_iterations': dict_cap},
        weights_solver_kwargs={'backend': backend,
                               'max_iterations': weights_cap},
        scale_factors_solver_kwargs={'max_iterations': scale_cap},
        trace_K=None if has_data else torch.trace(K))
    return iterate


def _gpnh_iterate():
    iterate, _ = sharded_aa._gpnh_iterate(
        _data(), lambda_W=0.0, n_components=3,
        sh=sharded_aa._Shard(device='cpu'),
        weights_solver_kwargs={'backend': 'pallas', 'max_iterations': 25})
    return iterate


@pytest.mark.parametrize("make,graphed", [
    (lambda: _aa_iterate(dict_cap=1), True),
    (lambda: _aa_iterate(dict_cap=8), True),
    (lambda: _aa_iterate(dict_cap=9), False),
    (lambda: _aa_iterate(dict_cap=1, delta=0.1, scale_cap=1), True),
    (lambda: _aa_iterate(dict_cap=1, delta=0.1, scale_cap=2), False),
    (lambda: _aa_iterate(dict_cap=1, has_data=False), True),
    (lambda: _aa_iterate(dict_cap=9, has_data=False), False),
    (lambda: _aa_iterate(dict_cap=1, backend='xla', weights_cap=25), False),
    (lambda: _aa_iterate(dict_cap=1, backend='xla', weights_cap=8), True),
    (_gpnh_iterate, False),
], ids=["aa-dict1", "aa-dict8", "aa-dict9", "delta-scale1",
        "delta-scale2", "kernel-aa-dict1", "kernel-aa-dict9",
        "row-solver-25", "row-solver-8", "gpnh"])
def test_capture_rule_of_each_iterate_family(make, graphed):
    iterate = make()
    assert iterate.reads_host is (not graphed)
    assert iterate_graph.capturable(iterate, 'cuda') is graphed
    assert iterate_graph.capturable(iterate, torch.device('cuda', 0)) \
        is graphed
    # Never on the CPU, and never for an iterate that does not say.
    assert iterate_graph.capturable(iterate, 'cpu') is False
    assert iterate_graph.capturable(lambda *s: s, 'cuda') is False


FIT = dict(init='random', tolerance=1e-6, max_iterations=30,
           stopping_criterion='rel_delta_f',
           dictionary_solver_kwargs={'max_iterations': 1},
           weights_solver_kwargs={'backend': 'pallas', 'max_iterations': 25},
           restart_chunk=3, compact_iterations=8)


def _direct_round_run(iterate, cost0, *, tolerance, criterion):
    """``restarts._round_run`` as the loop runs without the wrapper."""
    def run(states_all, idx, max_iterations):
        states = tuple(s[idx] for s in states_all)
        states, costs, trace, n_iters, done = _keep_best_loop(
            states, cost0(*states), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations)
        for s_all, s in zip(states_all, states):
            s_all[idx] = s
        return states_all, costs, trace, n_iters, done
    return run


def _assert_same_fit(a, b):
    for key in ('weights', 'dictionary', 'alpha', 'archetypes'):
        if key in a:
            assert torch.equal(a[key], b[key]), key
    for key in ('costs', 'n_iters', 'cost_deltas'):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a['cost'] == b['cost'] and a['n_iter'] == b['n_iter']
    assert a['best_index'] == b['best_index']


def _changes(fn):
    before = profiling.counters()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = profiling.counters()
    return out, {k: after[k] - before[k] for k in after}


def test_wrapper_is_the_identity_on_the_cpu(monkeypatch):
    X = _data(n=30, d=8, seed=3)
    calls = []
    real = iterate_graph.StepGraphs.__call__

    def spy(self, step, carry):
        calls.append(1)
        return real(self, step, carry)

    monkeypatch.setattr(iterate_graph.StepGraphs, "__call__", spy)
    wrapped, c_wrapped = _changes(
        lambda: aa_fit_restarts(X, 3, 5, 7, **FIT))
    assert calls and len(calls) * 3 == c_wrapped["RESTART_SLOTS"]
    monkeypatch.setattr(restarts, "_round_run", _direct_round_run)
    direct, c_direct = _changes(lambda: aa_fit_restarts(X, 3, 5, 7, **FIT))
    _assert_same_fit(wrapped, direct)
    assert c_wrapped == c_direct
    assert c_wrapped["GRAPH_CAPTURES"] == c_wrapped["GRAPH_REPLAYS"] == 0


def test_host_read_raises_while_the_stream_captures(monkeypatch):
    before = profiling.HOST_READS
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capturing"):
        profiling.host_read(torch.ones(()))
    with pytest.raises(RuntimeError, match="capturing"):
        profiling.host_read(torch.ones(3))
    assert profiling.HOST_READS == before
    # What is no tensor is handed back, as without a capture.
    assert profiling.host_read(3.5) == 3.5
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert profiling.host_read(torch.ones(())) == 1.0
    assert profiling.HOST_READS == before + 1


COUNTED = [name for _, _, name in LAUNCH_COUNTERS]


class _Replays:
    """A stand-in for a captured graph: counts its replays."""

    def __init__(self, on_replay=None):
        self.replays = 0
        self.on_replay = on_replay

    def replay(self):
        self.replays += 1
        if self.on_replay is not None:
            self.on_replay()


def test_a_replay_adds_the_launches_counted_at_the_capture():
    def captured():
        # What one iteration's wrappers count while it is captured.
        simplex_qp.LAUNCHES += 1
        simplex_qp.GROUPED_LAUNCHES += 2
        residual_cost.LAUNCHES += 1
        return "graph"

    before = profiling.counters()
    out, launches = iterate_graph._recording_launches(captured)
    assert out == "graph"
    # The capture ran nothing: its counts are taken back.
    assert profiling.counters() == before
    assert launches == [1, 0, 2, 0, 1]

    slot = iterate_graph._Slot()
    slot.graph, slot.launches = _Replays(), launches
    for _ in range(3):
        slot.replay()
    after = profiling.counters()
    change = {k: after[k] - before[k] for k in after}
    assert slot.graph.replays == 3
    assert [change[k] for k in COUNTED] == [3, 0, 6, 0, 3]
    assert change["GRAPH_REPLAYS"] == 3
    assert change["GRAPH_CAPTURES"] == 0


def test_launches_are_taken_back_when_the_capture_raises():
    before = profiling.counters()

    def failing():
        simplex_qp.LAUNCHES += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        iterate_graph._recording_launches(failing)
    assert profiling.counters() == before


def _stand_in_capture(step, carry):
    """What a graph of ``step(carry)`` does, replayed on the CPU: every
    replay runs the iteration on the carried tensors and writes the new
    ones back into them, and its cost deltas into one tensor."""
    delta = torch.zeros_like(carry[1])

    def replay():
        out, d = step(carry)
        for static, new in zip(iterate_graph._flat(carry),
                               iterate_graph._flat(out)):
            static.copy_(new)
        delta.copy_(d)

    return _Replays(replay), delta


@pytest.fixture
def stand_in(monkeypatch):
    """The graph's bookkeeping on the CPU: every iterate that reads no
    host may be captured, and a capture is :func:`_stand_in_capture`."""
    monkeypatch.setattr(
        iterate_graph, "capturable",
        lambda iterate, device: getattr(iterate, "reads_host", True)
        is False)
    monkeypatch.setattr(iterate_graph, "_capture", _stand_in_capture)


@pytest.mark.parametrize("kind", ["compacted", "screened", "delta",
                                  "kernel"])
def test_replayed_iterations_give_the_direct_loops_bits(stand_in,
                                                        monkeypatch, kind):
    X = _data(n=30, d=8, seed=4)
    kw = dict(FIT)
    fit = aa_fit_restarts
    if kind == "screened":
        # Both phases run chunks of 3: one shape, one capture.
        kw.update(compact_iterations=None, screen_iterations=10,
                  screen_keep=0.6)
    elif kind == "delta":
        kw.update(delta=0.1, scale_factors_solver_kwargs={
            'max_iterations': 1})
    elif kind == "kernel":
        fit, X = kernel_aa_fit_restarts, X @ X.T
    graphed, c_graphed = _changes(lambda: fit(X, 3, 11, 7, **kw))
    monkeypatch.setattr(restarts, "_round_run", _direct_round_run)
    direct, c_direct = _changes(lambda: fit(X, 3, 11, 7, **kw))
    _assert_same_fit(graphed, direct)
    steps = c_direct["RESTART_SLOTS"] // 3
    assert c_graphed["GRAPH_CAPTURES"] == 1
    # Every iteration but the first is a replay.
    assert c_graphed["GRAPH_REPLAYS"] == steps - 1
    assert c_graphed["RESTART_SLOTS"] == c_direct["RESTART_SLOTS"]
    assert c_graphed["HOST_READS"] == c_direct["HOST_READS"]


def test_each_chunk_shape_has_its_graph(stand_in, monkeypatch):
    """Screened with no chunk width: the screen runs all 8 restarts
    together and the resume the 4 kept, two shapes of one fit, each
    with its eager first iteration."""
    loops = []
    real = restarts._keep_best_loop

    def spy(states, cost0, iterate, **kw):
        loops.append((states[0].shape[0], kw['max_iterations']))
        return real(states, cost0, iterate, **kw)

    monkeypatch.setattr(restarts, "_keep_best_loop", spy)
    X = _data(n=30, d=8, seed=5)
    kw = dict(FIT, restart_chunk=None, compact_iterations=None,
              screen_iterations=6, screen_keep=0.5)
    _, change = _changes(lambda: aa_fit_restarts(X, 3, 2, 8, **kw))
    assert {width for width, _ in loops} == {8, 4}
    assert change["GRAPH_CAPTURES"] == 2
    assert change["GRAPH_REPLAYS"] == sum(m for _, m in loops) - 2


def test_step_graphs_gather_into_and_copy_out_of_the_carried_tensors(
        stand_in):
    X = _data(n=20, d=5, seed=6)
    iterate, cost0 = sharded_aa._aa_iterate(
        X, restarts._gram_once(X), n_components=3, delta=0.0,
        do_scale=False, sh=sharded_aa._Shard(device='cpu'),
        dictionary_solver_kwargs={'max_iterations': 1},
        weights_solver_kwargs={'backend': 'pallas', 'max_iterations': 25})
    run = restarts._round_run(iterate, cost0, tolerance=1e-6,
                              criterion='rel_delta_f')
    states = restarts._init_aa_state(
        torch.Generator().manual_seed(0), 6, 0.0, n_samples=20,
        n_components=3, init='random', diss=None, n_extra_steps=0,
        do_scale=False, dtype=X.dtype, device=X.device)
    population = tuple(s.clone() for s in states)
    first = torch.tensor([0, 1, 2])
    _, c1, _, _, _ = run(population, first, 3)   # eager, capture, replay
    _, c2, _, n2, d2 = run(population, torch.tensor([3, 4, 5]), 3)
    # The second chunk ran in the graph's carried tensors, and what it
    # returned is its own: a third chunk does not overwrite it.
    kept = (c2.clone(), n2.clone(), d2.clone())
    run(population, first, 2)
    assert torch.equal(c2, kept[0]) and torch.equal(n2, kept[1])
    assert torch.equal(d2, kept[2])
    assert not torch.equal(c1, c2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


CARD = dict(init='random', tolerance=1e-6, max_iterations=40,
            stopping_criterion='rel_delta_f',
            dictionary_solver_kwargs={'max_iterations': 1},
            weights_solver_kwargs={'max_iterations': 25})


def _card_cases():
    rng = np.random.RandomState(7)
    data = rng.standard_normal((300, 50))
    pcs = rng.standard_normal((732, 167))
    tail = dict(CARD, restart_chunk=4, compact_iterations=8)
    return {
        # 10 restarts in chunks of 4: the last chunk tiled.
        "tiled-float32": (aa_fit_restarts, data, torch.float32, 5, 10,
                          tail),
        "tiled-float64": (aa_fit_restarts, data, torch.float64, 5, 10,
                          tail),
        # The JRA-55 PC analysis' shape, both inner solvers at one step.
        "delta-jra55-pcs": (aa_fit_restarts, pcs, torch.float32, 4, 100,
                            dict(CARD, delta=0.1,
                                 scale_factors_solver_kwargs={
                                     'max_iterations': 1})),
        "kernel": (kernel_aa_fit_restarts, data @ data.T, torch.float32, 5,
                   10, tail),
        "screened": (aa_fit_restarts, data, torch.float32, 5, 12,
                     dict(CARD, restart_chunk=4, screen_iterations=10,
                          screen_keep=0.5)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_card_cases()))
def test_graphed_fit_gives_the_unwrapped_loops_bits(cuda, monkeypatch,
                                                    case):
    fit, data, dtype, k, n_init, kw = _card_cases()[case]
    X = torch.as_tensor(data, dtype=dtype, device=cuda)
    fit(X, k, 1, n_init, **dict(kw, max_iterations=2))  # builds, loads
    graphed, c_graphed = _changes(lambda: fit(X, k, 3, n_init, **kw))
    monkeypatch.setattr(restarts, "_round_run", _direct_round_run)
    direct, c_direct = _changes(lambda: fit(X, k, 3, n_init, **kw))
    _assert_same_fit(graphed, direct)
    for key in ("LAUNCHES", "COST_LAUNCHES", "RESTART_SLOTS",
                "RESTART_ADVANCES", "GROUPED_LAUNCHES"):
        assert c_graphed[key] == c_direct[key], key
    assert c_direct["GRAPH_CAPTURES"] == c_direct["GRAPH_REPLAYS"] == 0
    assert c_graphed["GRAPH_CAPTURES"] == 1
    # One K1 launch an iteration: every one but the first a replay.
    assert c_graphed["GRAPH_REPLAYS"] + 1 == c_graphed["LAUNCHES"]


@pytest.mark.cuda
def test_gpnh_and_uncapped_solvers_stay_eager_on_the_card(cuda):
    X = torch.as_tensor(np.random.RandomState(8).standard_normal((200, 30)),
                        dtype=torch.float32, device=cuda)
    from convex_dim_red_tpu_torch import gpnh_fit_restarts
    _, change = _changes(lambda: gpnh_fit_restarts(
        X, 4, 0, 8, max_iterations=20, restart_chunk=4))
    assert change["GRAPH_CAPTURES"] == change["GRAPH_REPLAYS"] == 0
    _, change = _changes(lambda: aa_fit_restarts(
        X, 4, 0, 8, **dict(CARD, dictionary_solver_kwargs={
            'max_iterations': 9})))
    assert change["GRAPH_CAPTURES"] == change["GRAPH_REPLAYS"] == 0
    assert change["LAUNCHES"] > 0


@pytest.mark.cuda
def test_host_read_in_a_capture_raises_and_the_card_goes_on(cuda):
    x = torch.ones(4, device=cuda)

    def reads(carry):
        profiling.host_read(carry[1].sum())
        return carry, carry[1]

    carry = ((x.clone(),), x.clone(), x > 0, x.int())
    with pytest.raises(RuntimeError, match="capturing"):
        iterate_graph._capture(reads, carry)
    assert torch.cuda.is_current_stream_capturing() is False
    assert float((x * 2).sum()) == 8.0


@pytest.mark.cuda
def test_graphed_fit_takes_no_more_memory(cuda, monkeypatch):
    X = torch.as_tensor(np.random.RandomState(9).standard_normal(
        (1788, 2000)), dtype=torch.float32, device=cuda)
    kw = dict(CARD, restart_chunk=25, compact_iterations=32)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def fit():
        aa_fit_restarts(X, 6, 4, 100, **kw)

    fit()
    graphed = peak(fit)
    monkeypatch.setattr(restarts, "_round_run", _direct_round_run)
    fit()
    direct = peak(fit)
    assert graphed <= direct + 2 ** 16, (graphed, direct)
