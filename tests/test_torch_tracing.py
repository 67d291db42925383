"""The port's tracing (``utils/profiling.py``): the spans of the fits and
the transform, the counters of restart slots, host reads and
host-to-device bytes, and :func:`profiling.span_summary`.

The spans are read from a CPU ``torch.profiler`` run; a span costs
nothing and changes no result when no profiler runs.  The case that
counts bytes copied to a card is marked ``cuda`` and skips without one.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from convex_dim_red_tpu_torch import (ArchetypalAnalysis, aa_fit_restarts,
                                      gpnh_fit_restarts)
from convex_dim_red_tpu_torch.ops import (LAUNCH_COUNTERS, residual_cost,
                                          simplex_qp)
from convex_dim_red_tpu_torch.parallel import restarts
from convex_dim_red_tpu_torch.utils import profiling

torch.set_num_threads(1)

#: A fit whose inner solvers never read their stop on the host: the
#: dictionary SPG at one step, the weights QPs at 8 (``quad_spg`` reads
#: every 8 steps, from the 8th on).
FIT = dict(init='random', max_iterations=20, restart_chunk=3,
           compact_iterations=4, tolerance=1e-5,
           stopping_criterion='rel_delta_f',
           dictionary_solver_kwargs={'max_iterations': 1},
           weights_solver_kwargs={'max_iterations': 8})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: host-to-device bytes are "
                    "counted only for a card")
    return torch.device("cuda")


def _data(n=40, d=12, seed=0, device='cpu'):
    X = np.random.RandomState(seed).standard_normal((n, d))
    return torch.as_tensor(X, device=device)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _spans(prof):
    """``(name, parent name)`` of every program span in the trace."""
    return collections.Counter(
        (e.name, e.cpu_parent.name if e.cpu_parent else None)
        for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX))


@pytest.fixture
def rounds(monkeypatch):
    """The (width, iterations) of every batched restart loop the
    schedulers run."""
    seen = []
    real = restarts._keep_best_loop

    def spy(states, cost0, iterate, **kw):
        seen.append((states[0].shape[0], kw['max_iterations']))
        return real(states, cost0, iterate, **kw)

    monkeypatch.setattr(restarts, "_keep_best_loop", spy)
    return seen


def test_span_is_a_shared_no_op_without_a_profiler():
    off = profiling.span("cdr.fit")
    assert off is profiling.span("cdr.aa.cost")
    with off as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("cdr.fit")
    assert on is not off
    assert isinstance(on, torch.profiler.record_function)


def _fit(X):
    return aa_fit_restarts(X, 3, 7, 5, **FIT)


def _transform(X):
    model = ArchetypalAnalysis(3, init='random', random_state=4,
                               max_iterations=15, device='cpu')
    model.fit(X)
    weights, cost = model.transform(X[:9] + 0.1)
    return {'archetypes': model.archetypes, 'fit_weights': model.weights,
            'weights': weights, 'cost': cost}


@pytest.mark.parametrize("run", [_fit, _transform],
                         ids=["aa_fit_restarts", "transform"])
def test_results_are_bit_equal_with_and_without_a_profiler(run):
    X = _data()
    plain = run(X)
    traced, _ = _profiled(lambda: run(X))
    assert plain.keys() == traced.keys()
    for key, value in plain.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, traced[key]), key
        elif isinstance(value, np.ndarray):
            assert np.array_equal(value, traced[key]), key
        else:
            assert value == traced[key], key


@pytest.mark.parametrize("family,steps", [
    ("aa", ("cdr.aa.dictionary", "cdr.aa.weights", "cdr.aa.cost")),
    ("aa_delta", ("cdr.aa.scale", "cdr.aa.dictionary", "cdr.aa.weights",
                  "cdr.aa.cost")),
    ("gpnh", ("cdr.gpnh.dictionary", "cdr.gpnh.weights",
              "cdr.gpnh.cost")),
])
def test_fit_spans_nest_once_per_iteration(family, steps, rounds):
    X = _data()

    def fit():
        if family == "gpnh":
            return gpnh_fit_restarts(
                X, 3, 7, 5, lambda_W=0.1, init='random', max_iterations=20,
                restart_chunk=3, compact_iterations=4,
                weights_solver_kwargs={'max_iterations': 8})
        return aa_fit_restarts(X, 3, 7, 5,
                               delta=0.2 if family == "aa_delta" else 0.0,
                               **FIT)

    _, prof = _profiled(fit)
    spans = _spans(prof)
    iterations = sum(m for _, m in rounds)
    n_rounds = len(rounds)
    assert spans[("cdr.fit", None)] == 1
    assert spans[("cdr.restarts.round", "cdr.fit")] == n_rounds
    assert spans[("cdr.restarts.read", "cdr.fit")] == n_rounds
    assert spans[("cdr.restarts.iteration",
                  "cdr.restarts.round")] == iterations
    for step in steps:
        assert spans[(step, "cdr.restarts.iteration")] == iterations, step
    # The initial cost of each round, outside its iterations.
    cost = steps[-1]
    assert spans[(cost, "cdr.restarts.round")] == n_rounds
    assert sum(spans.values()) == 1 + 3 * n_rounds + iterations * (
        1 + len(steps))


def test_transform_emits_its_stage_spans():
    X = _data()
    model = ArchetypalAnalysis(3, init='random', random_state=4,
                               max_iterations=15, device='cpu').fit(X)
    _, prof = _profiled(lambda: model.transform(X[:5].numpy()))
    assert _spans(prof) == collections.Counter({
        ("cdr.transform", None): 1,
        ("cdr.transform.input", "cdr.transform"): 1,
        ("cdr.transform.init", "cdr.transform"): 1,
        ("cdr.transform.weights", "cdr.transform"): 1,
        ("cdr.transform.cost", "cdr.transform"): 1})


def _restarts_run(screened):
    X = _data()
    if screened:
        kw = dict(FIT, compact_iterations=None, screen_iterations=6,
                  screen_keep=0.5)
        return aa_fit_restarts(X, 3, 7, 7, **kw)
    return aa_fit_restarts(X, 3, 7, 7, **FIT)


@pytest.mark.parametrize("screened", [False, True],
                         ids=["compacted", "screened"])
def test_restart_slot_counters(screened, rounds):
    before = profiling.counters()
    res = _restarts_run(screened)
    after = profiling.counters()
    assert after["RESTART_ADVANCES"] - before["RESTART_ADVANCES"] == int(
        res['n_iters'].sum())
    assert after["RESTART_SLOTS"] - before["RESTART_SLOTS"] == sum(
        width * m for width, m in rounds)
    # Tiled duplicates and frozen restarts run too.
    assert (after["RESTART_SLOTS"] - before["RESTART_SLOTS"]
            > after["RESTART_ADVANCES"] - before["RESTART_ADVANCES"])


def test_host_reads_of_a_fit_of_known_rounds(rounds):
    """The scheduler reads a chunk's costs, trace, iterations and stop
    flags once a round; nothing else in this fit reads the device."""
    before = profiling.HOST_READS
    _fit(_data())
    assert profiling.HOST_READS - before == 4 * len(rounds)


def test_host_reads_of_a_transform_and_of_a_dictionary_solve():
    X = _data()
    # The transform's row solver, capped at 8 steps, reads no stop: the
    # one read is the cost's.
    model = ArchetypalAnalysis(3, init='random', random_state=4,
                               max_iterations=8, device='cpu').fit(X)
    before = profiling.HOST_READS
    model.transform(X[:5])
    assert profiling.HOST_READS - before == 1
    # quad_spg reads its stop every ``check_every`` steps (not at 0).
    from convex_dim_red_tpu_torch.solvers.spg import quad_spg
    before = profiling.HOST_READS
    quad_spg(lambda x: 2.0 * x, torch.ones((2, 3), dtype=torch.float64),
             torch.zeros((2, 3), dtype=torch.float64), lambda x: x,
             max_iterations=17, check_every=8, epsilon_one=0.0,
             epsilon_two=0.0)
    assert profiling.HOST_READS - before in (1, 2)


def test_counters_snapshot_names_every_counter():
    snap = profiling.counters()
    assert list(snap) == ["RESTART_SLOTS", "RESTART_ADVANCES",
                          "HOST_READS", "H2D_BYTES", "GRAPH_CAPTURES",
                          "GRAPH_REPLAYS", "GRAM_FACTORS"] + [
                              name for _, _, name in LAUNCH_COUNTERS]
    for module, attribute, name in LAUNCH_COUNTERS:
        assert snap[name] == getattr(module, attribute)
    assert snap["LAUNCHES"] == simplex_qp.LAUNCHES
    assert snap["COST_LAUNCHES"] == residual_cost.LAUNCHES
    assert all(isinstance(v, int) for v in snap.values())


def test_no_bytes_are_counted_off_the_card():
    before = profiling.H2D_BYTES
    profiling.to_device(np.ones((4, 3)), 'cpu')
    profiling.to_device(torch.ones(5), 'cpu')
    assert profiling.H2D_BYTES == before


@pytest.mark.cuda
def test_h2d_bytes_of_a_transform_on_the_card(cuda):
    X = _data(n=60, d=16).float()
    model = ArchetypalAnalysis(4, init='random', random_state=4,
                               max_iterations=15, device='cuda').fit(X)
    new = X[:11].numpy() + np.float32(0.1)
    before = profiling.H2D_BYTES
    model.transform(new)
    torch.cuda.synchronize()
    # The rows, and the initial weights drawn on the host generator.
    assert profiling.H2D_BYTES - before == new.nbytes + 11 * 4 * 4


class _Event:
    """A Kineto event of a synthetic trace (ns), with its activity type
    (as the profiler of torch 2.13 gives it)."""

    def __init__(self, name, start, dur, activity, device="CPU", corr=0,
                 linked=0):
        self._v = (name, start, dur, activity, device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def activity_type(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType." + self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[3] in ("user_annotation", "gpu_user_annotation")


class _UntypedEvent(_Event):
    """The same event where the trace gives no activity type."""

    activity_type = None


def _kernel(start, dur, corr, linked=None):
    return _Event("k", start, dur, "kernel", "CUDA", corr,
                  corr if linked is None else linked)


@pytest.mark.parametrize("typed", [True, False],
                         ids=["activity_types", "names_only"])
def test_span_summary_attributes_device_time_by_launch(typed):
    events = [
        _Event("cdr.fit", 0, 1000, "user_annotation"),
        _Event("cdr.restarts.iteration", 100, 400, "user_annotation"),
        _Event("cdr.aa.cost", 200, 100, "user_annotation"),
        _Event("cdr.restarts.iteration", 600, 300, "user_annotation"),
        _Event("cdr.aa.cost", 700, 100, "user_annotation"),
        _Event("aten::mm", 210, 10, "cpu_op", corr=11),
        # Launches of kernels (their correlation ids) and a copy.
        _Event("cudaLaunchKernel", 150, 5, "cuda_runtime", corr=1),
        _Event("cudaLaunchKernel", 250, 5, "cuda_runtime", corr=2),
        _Event("cudaMemcpyAsync", 720, 5, "cuda_runtime", corr=3),
        _Event("cudaLaunchKernel", 950, 5, "cuda_runtime", corr=4),
        _Event("cudaLaunchKernel", 1500, 5, "cuda_runtime", corr=5),
        # The span's mirror on the device is not device work.
        _Event("cdr.aa.cost", 200, 100, "gpu_user_annotation", "CUDA"),
        _kernel(160, 40, 1),                   # iteration 1, self
        # Linked to the aten op that launched it, inside cost 1; it runs
        # past the span's end.
        _kernel(300, 200, 77, linked=11),
        _Event("Memcpy HtoD", 730, 20, "gpu_memcpy", "CUDA", 3, 3),
        _kernel(960, 30, 4),                   # fit, self
        _kernel(1510, 10, 5),                  # outside every span
        _kernel(800, 50, 99, linked=98),       # launch not in the trace
    ]
    if not typed:
        for e in events:
            e.__class__ = _UntypedEvent
    out = profiling.span_summary(events)
    spans = out["spans"]
    assert set(spans) == {"cdr.fit", "cdr.restarts.iteration",
                          "cdr.aa.cost"}
    it, cost, fit = (spans[n] for n in (
        "cdr.restarts.iteration", "cdr.aa.cost", "cdr.fit"))
    assert (it["count"], cost["count"], fit["count"]) == (2, 2, 1)
    assert it["host_s"] == pytest.approx(700e-9)
    assert it["host_p50_s"] == pytest.approx(350e-9)
    assert it["self_s"] == pytest.approx(500e-9)
    assert fit["self_s"] == pytest.approx(300e-9)
    assert it["device_s"] == pytest.approx(40e-9)
    assert cost["device_s"] == pytest.approx(220e-9)
    assert fit["device_s"] == pytest.approx(30e-9)
    assert it["device_total_s"] == pytest.approx(260e-9)
    assert fit["device_total_s"] == pytest.approx(290e-9)
    assert out["unattributed_s"] == pytest.approx(60e-9)
    assert out["unmatched_s"] == pytest.approx(50e-9)
    assert out["traced_s"] == pytest.approx(1000e-9)
    # Busy inside the root: [160, 200), [300, 500), [730, 750),
    # [800, 850), [960, 990).
    assert out["busy_s"] == pytest.approx(340e-9)
    # Each idle stretch goes to the span innermost at its start: [0,
    # 160), [500, 730) and [990, 1000) to the fit, [200, 300) and [750,
    # 800) to a cost, [850, 960) to iteration 2.
    assert fit["idle_s"] == pytest.approx(400e-9)
    assert cost["idle_s"] == pytest.approx(150e-9)
    assert it["idle_s"] == pytest.approx(110e-9)


def test_span_summary_reads_a_profiler():
    X = _data()
    _, prof = _profiled(lambda: _fit(X))
    out = profiling.span_summary(prof)
    spans = out["spans"]
    assert spans["cdr.fit"]["count"] == 1
    assert out["traced_s"] == pytest.approx(spans["cdr.fit"]["host_s"])
    children = sum(spans[n]["host_s"] for n in (
        "cdr.restarts.round", "cdr.restarts.read"))
    assert spans["cdr.fit"]["self_s"] == pytest.approx(
        spans["cdr.fit"]["host_s"] - children)
    # No device here: nothing launched, the roots all idle.
    assert out["busy_s"] == 0.0 and out["unattributed_s"] == 0.0
    assert sum(s["idle_s"] for s in spans.values()) == pytest.approx(
        out["traced_s"])
