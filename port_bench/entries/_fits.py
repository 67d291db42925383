"""What the fit entries share: K1's launch count and first operands,
and the reference's verdict on an AA or GPNH fit."""

import contextlib

import numpy as np
import torch

from port_bench.reference import fits

K1 = "quad_simplex_qp_packed_grouped"


def k1_launches():
    from convex_dim_red_tpu_torch.ops import simplex_qp
    return simplex_qp.LAUNCHES


@contextlib.contextmanager
def first_k1_launch(into):
    """Record the operands of the first K1 call the weights-QP dispatch
    makes inside the block: ``into[0] = (kernel, (As, Bs, X0s),
    kwargs)``."""
    from convex_dim_red_tpu_torch.ops import simplex_qp
    from convex_dim_red_tpu_torch.solvers import spg
    real = getattr(simplex_qp, K1)

    def recording(As, Bs, X0s, **kw):
        if not into:
            into.append((real, (As.clone(), Bs.clone(), X0s.clone()),
                         dict(kw)))
        return real(As, Bs, X0s, **kw)

    setattr(spg, K1, recording)
    try:
        yield
    finally:
        setattr(spg, K1, real)


#: Answers the reference judges in a run at most, drawn from the seed:
#: it runs after the window, in every run, so it is kept short of it.
SAMPLE = {"calls": 4, "requests": 1000}


def sample(n, k, seed):
    """Indices of ``k`` of ``n`` answers (all when ``n <= k``), drawn from
    ``seed``, in order."""
    if n <= k:
        return list(range(n))
    rng = np.random.RandomState((int(seed) + 3) % 2 ** 32)
    return sorted(rng.choice(n, size=k, replace=False).tolist())


def host(t):
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def selection_mismatches(cost, costs, best_index, n_init):
    """Exact: the reported winner is the argmin of the per-restart costs
    and carries its cost, over ``n_init`` restarts."""
    costs = np.asarray(costs, dtype=np.float64)
    return float((costs.shape != (n_init,))
                 + (float(cost) != float(costs.min()))
                 + (int(best_index) != int(np.argmin(costs))))


def aa_numbers(X, Z, D, alpha, archetypes, cost, device, delta=0.0):
    """The reference's readings on one AA result (float64 on
    ``device``): the archetypes ``D X``, the cost, the weights against
    the optimum of their QPs, the dictionary against the best one for
    those weights, the simplex rows and the scale factors' box."""
    X = fits.f64(X, device)
    Z, D = fits.f64(Z, device), fits.f64(D, device)
    a = fits.f64(alpha, device)
    P = D @ X
    audit = fits.residual_cost(X, Z, P)
    gap_sum, gap_max = fits.weights_gap(X, P, Z)
    C = D / a[:, None]
    out = {
        "archetypes_err": fits.rel_max_err(fits.f64(archetypes, device), P),
        "cost_err": abs(float(cost) - audit) / audit,
        "weights_gap": gap_sum,
        "weights_gap_row": gap_max,
        "dictionary_gap": fits.dictionary_gap(X, Z, D, a),
        "simplex_err": max(fits.simplex_err(Z), fits.simplex_err(C)),
    }
    alpha32 = torch.as_tensor(alpha)
    lo = torch.tensor(1.0 - delta, dtype=alpha32.dtype)
    hi = torch.tensor(1.0 + delta, dtype=alpha32.dtype)
    out["alpha_outside"] = float(torch.sum((alpha32 < lo) | (alpha32 > hi)))
    return out


def worst(readings):
    """Each number's worst reading over the calls (all are limits from
    above)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = v if k not in out else max(out[k], v)
    return out
