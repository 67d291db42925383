"""The window's arithmetic: a whole number of calls, ``fit_s`` over all
of them, the p95 over every request, the per-layer counts over the calls
run without the profiler."""

import pytest

from port_bench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class FakeEntry:
    traced_calls = 0

    def __init__(self, clock, walls, kind="fit"):
        self.clock, self.walls, self.kind, self.n = clock, walls, kind, 0

    def call(self):
        self.clock.t += self.walls[self.n % len(self.walls)]
        self.n += 1
        return {"k1_launches": 10, "restart_iters": 100}


def metric(name, rec):
    return harness.read_metrics([{"name": name, "unit": "u"}], rec).get(
        name, {}).get("value")


def test_the_running_call_completes_and_counts():
    clock = Clock()
    entry = FakeEntry(clock, [4.0, 3.0])
    rec = harness.window(entry, 10.0, lambda: None, False, clock=clock)
    # 4 + 3 + 4 = 11 s: the third call starts at 7 s and completes.
    assert len(rec["calls"]) == 3
    assert rec["window_s"] == pytest.approx(11.0)
    rec["kind"] = "fit"
    assert metric("fit_s", rec) == pytest.approx(11.0 / 3)
    assert metric("k1_launches.fit", rec) == 10
    assert metric("step_ms.fit", rec) == pytest.approx(1e3 * 11.0 / 30)
    assert metric("request_p95_ms.transform", rec) is None


def test_p95_is_over_every_request():
    clock = Clock()
    walls = [0.001] * 19 + [0.1]
    entry = FakeEntry(clock, walls, kind="requests")
    rec = harness.window(entry, 0.1185, lambda: None, False,
                         clock=clock)
    rec["kind"] = "requests"
    lat = sorted(c["wall_s"] for c in rec["calls"])
    assert len(lat) == 20
    want = lat[18] + 0.05 * (lat[19] - lat[18])
    assert metric("request_p95_ms.transform", rec) == pytest.approx(1e3 * want)
    assert metric("transform_p50_ms", rec) == pytest.approx(1.0)
    assert metric("fit_s", rec) is None


def test_percentile_matches_numpy():
    np = pytest.importorskip("numpy")
    xs = [5.0, 1.0, 3.0, 2.0, 8.0, 13.0, 21.0]
    for q in (50, 95, 99):
        assert harness.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_untraced_counts_leave_out_the_profiled_call():
    rec = {"kind": "fit", "window_s": 30.0, "calls": [
        {"wall_s": 20.0, "k1_launches": 10, "restart_iters": 7,
         "traced": True},
        {"wall_s": 5.0, "k1_launches": 10, "restart_iters": 7,
         "traced": False},
        {"wall_s": 5.0, "k1_launches": 10, "restart_iters": 7,
         "traced": False}]}
    assert metric("step_ms.fit", rec) == pytest.approx(500.0)
    assert metric("restart_iters.fit", rec) == 7


def test_request_latencies_leave_out_the_profiled_requests():
    rec = {"kind": "requests", "window_s": 1.0, "calls": [
        {"wall_s": 0.5, "traced": True},
        {"wall_s": 0.002, "traced": False},
        {"wall_s": 0.002, "traced": False}]}
    assert metric("request_p95_ms.transform", rec) == pytest.approx(2.0)
    assert metric("transform_p50_ms", rec) == pytest.approx(2.0)


def test_busy_time_is_a_union_and_gaps_are_named():
    from port_bench import profile
    busy = profile.union([(0, 10), (5, 12), (20, 25)])
    assert busy == [[0, 12], [20, 25]]
    idle = profile.gaps(busy, 0, 30)
    assert idle == [(12, 20), (25, 30)]
    names = profile.name_gaps(idle, [(0, 30, "outer"), (11, 19, "inner")])
    assert names == ["inner", "outer"]
