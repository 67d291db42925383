"""``ArchetypalAnalysis.transform``: a closed loop of one caller
projecting new months on archetypes fitted in set-up.

Set-up fits ``ArchetypalAnalysis`` (``random_state`` the run's seed)
on the configuration's field, with the arguments the traffic mix gives:
the configuration's stopping rule and caps, and K2 for the fit's
weights in place of the estimator's default row solver, which stops on
a device-side assert at some seeds (PERF.md, Open questions).  It
draws a bank of held-out months from the same model.  Each request
takes a block of the bank's rows, its size drawn log-uniformly from
``rows.low`` to ``rows.high`` and its place uniformly, both from the
seed, as a host float32 array, and brings the weights back to the host.
"""

import math

import numpy as np
import torch

from port_bench.entries import _fits
from port_bench.reference import fits


def request_sizes(seed, n, low, high):
    """``n`` request sizes, log-uniform on ``[low, high]``."""
    rng = np.random.RandomState(int(seed) % 2 ** 32)
    u = rng.uniform(math.log(low), math.log(high + 1), size=n)
    return np.clip(np.floor(np.exp(u)).astype(np.int64), low, high)


class Entry:
    kind = "requests"

    def __init__(self, ctx, recipe):
        from convex_dim_red_tpu_torch import ArchetypalAnalysis
        self.ctx = ctx
        t = ctx.traffic
        self.traced_calls = int(t.get("traced_requests", 200))
        rows = t["rows"]
        self.low, self.high = int(rows["low"]), int(rows["high"])
        data_cfg = dict(ctx.config["data"])
        bank_rows = int(t["bank_rows"])
        self.bank = recipe.held_out(ctx.data, ctx.seed + 1, bank_rows,
                                    noise=data_cfg["noise"],
                                    dtype=data_cfg["dtype"])
        self.model = ArchetypalAnalysis(random_state=ctx.seed,
                                        device=str(ctx.device),
                                        **ctx.args)
        # One draw of sizes and places from the seed; a run uses its head.
        rng = np.random.RandomState((int(ctx.seed) + 2) % 2 ** 32)
        n_max = int(t.get("max_requests", 200000))
        self.sizes = request_sizes(ctx.seed, n_max, self.low, self.high)
        self.places = (rng.uniform(size=n_max)
                       * (bank_rows - self.sizes + 1)).astype(np.int64)
        self.answers = []
        self.fitted = None

    def warm(self):
        X = torch.as_tensor(self.ctx.data["X"]).to(self.ctx.device)
        self.model.fit(X)
        m = self.model
        self.fitted = {"weights": _fits.host(m.weights),
                       "dictionary": _fits.host(m.dictionary),
                       "alpha": _fits.host(m.alpha),
                       "archetypes": _fits.host(m.archetypes),
                       "cost": float(m.cost)}
        del X
        for r in (self.low, self.high):
            self.model.transform(self.bank[:r])[0].cpu()

    def call(self):
        i = len(self.answers)
        o, r = int(self.places[i]), int(self.sizes[i])
        weights, cost = self.model.transform(self.bank[o:o + r])
        self.answers.append((o, r, weights.cpu().numpy(), cost))
        return {"rows": r}

    def free(self):
        self.model = None

    def check(self):
        """The set-up fit's archetypes, cost, weights and dictionary,
        then a sample of the answers (:data:`_fits.SAMPLE`) against the reference's
        archetypes ``D X``: each cost, and the weights against the
        optimum of each row's QP."""
        device = self.ctx.device
        f = self.fitted
        alpha = f["alpha"] if f["alpha"] is not None else torch.ones(
            f["dictionary"].shape[0])
        out = {"fit_" + k: v for k, v in _fits.aa_numbers(
            self.ctx.data["X"], f["weights"], f["dictionary"], alpha,
            f["archetypes"], f["cost"], device).items()}
        X = fits.f64(self.ctx.data["X"], device)
        P = fits.f64(f["dictionary"], device) @ X
        del X
        H = P @ P.T
        Bs, Zs, c, cost_err = [], [], [], 0.0
        for i in _fits.sample(len(self.answers), _fits.SAMPLE["requests"],
                              self.ctx.seed):
            o, r, Z, cost = self.answers[i]
            Y = fits.f64(self.bank[o:o + r], device)
            Z = fits.f64(Z, device)
            audit = fits.residual_cost(Y, Z, P)
            cost_err = max(cost_err, abs(cost - audit) / audit)
            Bs.append(-(Y @ P.T))
            Zs.append(Z)
            c.append(0.5 * torch.sum(Y * Y, dim=1))
        gap_sum, gap_max = fits.qp_gap(H, torch.cat(Bs), torch.cat(c),
                                       torch.cat(Zs))
        Zall = torch.cat(Zs)
        out.update(cost_err=cost_err, weights_gap=gap_sum,
                   weights_gap_row=gap_max,
                   simplex_err=fits.simplex_err(Zall))
        return out


def prepare(ctx):
    from port_bench.harness import recipe_of
    return Entry(ctx, recipe_of(ctx.config))
