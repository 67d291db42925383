"""Keep-best convergence loop over a batch of restarts.

Port of ``_keep_best_loop`` from convex_dim_red_tpu/parallel/
sharded_aa.py.  The sharded SPMD fits of that module are a later slice
of the port (ROADMAP.md queue 1, item 17).
"""

import torch

from ..models._common import has_converged

__all__ = []


def _keep_best_loop(states, cost0, iterate_batch, *, tolerance, criterion,
                    max_iterations):
    """Advance a batch of restarts ``max_iterations`` alternating
    iterations, freezing each restart once it has converged.

    ``states`` is a tuple of tensors with a leading restart axis;
    ``iterate_batch(*states) -> (*states, costs)`` advances the whole
    batch one iteration.  Returns ``(states, costs, trace, n_iters,
    done)`` with ``trace (R, max_iterations)`` the per-iteration cost
    deltas (0 once frozen).

    The JAX loop leaves as soon as every restart is done.  Here all
    ``max_iterations`` run, so the round never waits on the host: a
    frozen restart does not change, so the outputs are the JAX loop's.
    """
    R = cost0.shape[0]
    device = cost0.device
    trace = torch.zeros((R, max_iterations), dtype=cost0.dtype,
                        device=device)
    n_iters = torch.zeros((R,), dtype=torch.int32, device=device)
    done = torch.zeros((R,), dtype=torch.bool, device=device)
    states = tuple(states)
    cost = cost0
    for it in range(max_iterations):
        out = iterate_batch(*states)
        new_states, new_cost = tuple(out[:-1]), out[-1]
        states = tuple(
            torch.where(done.view((-1,) + (1,) * (n.ndim - 1)), o, n)
            for o, n in zip(states, new_states))
        new_cost = torch.where(done, cost, new_cost)
        trace[:, it] = torch.where(done, 0.0, new_cost - cost)
        n_iters += (~done).to(torch.int32)
        done = done | has_converged(cost, new_cost, tolerance, criterion)
        cost = new_cost
    return states, cost, trace, n_iters, done
