"""``convex_dim_red_tpu_torch.aa_fit_restarts``: whole best-of-``n_init``
fits back to back, each call from initial states of its own
(:func:`port_bench.harness.call_seed`), on the data the run's seed
made."""

import torch

from port_bench.entries import _fits
from port_bench.harness import call_seed


class Entry:
    kind = "fit"
    traced_calls = 1

    def __init__(self, ctx):
        import convex_dim_red_tpu_torch
        self.port = convex_dim_red_tpu_torch
        self.ctx = ctx
        self.args = dict(ctx.args)
        self.X = torch.as_tensor(ctx.data["X"]).to(ctx.device)
        self.k1_launch = []
        self.results = []

    def _fit(self, seed, **over):
        args = dict(self.args, **over)
        k = args.pop("n_components")
        n_init = args.pop("n_init")
        return self.port.aa_fit_restarts(self.X, k, seed, n_init, **args)

    def warm(self):
        with _fits.first_k1_launch(self.k1_launch):
            self._fit(self.ctx.seed, max_iterations=int(
                self.ctx.traffic.get("warm_iterations", 2)))
        self.k1_launch = self.k1_launch[0] if self.k1_launch else None

    def call(self):
        before = _fits.k1_launches()
        res = self._fit(call_seed(self.ctx.seed, len(self.results)))
        self.results.append({k: _fits.host(res[k]) for k in (
            "weights", "dictionary", "alpha", "archetypes", "cost",
            "costs", "n_iters", "best_index")})
        return {"k1_launches": _fits.k1_launches() - before,
                "restart_iters": int(res["n_iters"].sum())}

    def free(self):
        self.X = None
        self.k1_launch = None

    def check(self):
        device = self.ctx.device
        delta = float(self.args.get("delta", 0.0))
        readings = []
        for i in _fits.sample(len(self.results), _fits.SAMPLE["calls"],
                              self.ctx.seed):
            r = self.results[i]
            nums = _fits.aa_numbers(self.ctx.data["X"], r["weights"],
                                    r["dictionary"], r["alpha"],
                                    r["archetypes"], r["cost"], device,
                                    delta)
            nums["selection"] = _fits.selection_mismatches(
                r["cost"], r["costs"], r["best_index"],
                self.args["n_init"])
            readings.append(nums)
        return _fits.worst(readings)


def prepare(ctx):
    return Entry(ctx)
