"""A dry run of the multi-GPU layer: the sharded paths at tiny shapes in
a world of processes, each held to the single-device path.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
which checks only that the sharded programs run; this one asserts
numeric parity.  Run it as::

    python -m convex_dim_red_tpu_torch.parallel.dryrun [n_processes
        [backend [device_type]]]

It runs on the card unless the device type is ``cpu``: with no
arguments one process a card on NCCL (the production route), ``2 gloo``
shares one card between two processes, ``4 gloo cpu`` runs on the CPU.
With no card and no ``cpu`` it raises ``RuntimeError``.
"""

import sys

import numpy as np
import torch

from ..ops import simplex_qp
from .mesh import create_mesh, spawn
from .restarts import aa_fit_restarts
from .sharded_aa import (_aa_iterate, _gpnh_iterate, _keep_best_loop,
                         _Shard, sharded_aa_fit, sharded_aa_train_step,
                         sharded_gpnh_fit, sharded_kernel_aa_fit)

__all__ = ["dryrun_multichip"]

#: Relative limit of a sharded float64 run against the single-device run
#: (the reductions run in another order; see parallel/mesh.py).
RTOL = 1e-8
#: Absolute limit of the weights after one step: the weights QP stops at
#: a residual of ``epsilon_two`` = 1e-6, so a rounding-level change of
#: its Hessian moves a row along a flat direction by up to that much.
WEIGHTS_ATOL = 1e-6
#: The solvers' caps in the dry run's fits: the dictionary SPG's (each
#: of its steps is an all-reduce on the sample axis) and the weights
#: QP's, which runs the grouped kernels (K1 on a card, its plain
#: version on a CPU mesh).
DICT_KW = {'max_iterations': 10}
WEIGHTS_KW = {'backend': 'pallas', 'max_iterations': 200}


def planted_data(seed, n, d, k, noise=0.0):
    """Planted convex-hull data: rows are convex combinations of ``k``
    random vertices, each vertex present as a row, plus ``noise`` times
    standard normal draws."""
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(k, d))
    Z = rng.uniform(size=(n, k))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(n, size=k, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + noise * rng.standard_normal((n, d))


def random_states(seed, R, n, k, d=None):
    """Row-stochastic ``Zs (R, n, k)`` and ``Cs (R, k, n)``, ones
    ``alphas (R, k)`` and, given ``d``, a GPNH dictionary ``Ws (R, d,
    k)`` (else None)."""
    rng = np.random.RandomState(seed)
    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    Ws = None if d is None else rng.standard_normal((R, d, k))
    return Zs, Cs, np.ones((R, k)), Ws


def single_aa_fit(X, Zs, Cs, alphas, *, has_data=True, delta=0.0,
                  tolerance=1e-10, max_iterations=40, device='cpu',
                  dictionary_solver_kwargs=None, weights_solver_kwargs=None,
                  criterion='abs_delta_f'):
    """The single-device counterpart of :func:`sharded_aa_fit` (and, with
    ``has_data=False``, of the kernel fit): the restart runners' iterate
    on one device from the same states, every restart to its own
    convergence.  Returns ``(costs, n_iters, states)``."""
    X = torch.as_tensor(X, device=device)
    K = X @ X.T if has_data else X
    iterate, cost0 = _aa_iterate(
        X if has_data else None, K, n_components=np.shape(Zs)[-1],
        delta=float(delta), do_scale=float(delta) != 0.0,
        sh=_Shard(device=device),
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs or WEIGHTS_KW,
        trace_K=None if has_data else torch.trace(K))
    states = tuple(torch.as_tensor(a, dtype=X.dtype, device=device)
                   for a in (Zs, Cs, alphas))
    states, costs, _, n_iters, _ = _keep_best_loop(
        states, cost0(*states), iterate, tolerance=tolerance,
        criterion=criterion, max_iterations=max_iterations)
    return costs.cpu().numpy(), n_iters.cpu().numpy(), states


def single_gpnh_costs(X, Zs, Ws, *, lambda_W, tolerance=1e-10,
                      max_iterations=40, device='cpu',
                      weights_solver_kwargs=None):
    """The single-device counterpart of :func:`sharded_gpnh_fit`: the
    restart-grouped GPNH iterate from the same states.  Returns
    ``(costs, n_iters)``."""
    X = torch.as_tensor(X, device=device)
    iterate, cost0 = _gpnh_iterate(
        X, lambda_W=lambda_W, n_components=Zs.shape[-1],
        sh=_Shard(device=device),
        weights_solver_kwargs=weights_solver_kwargs or WEIGHTS_KW)
    states = tuple(torch.as_tensor(a, device=device) for a in (Zs, Ws))
    _, costs, _, n_iters, _ = _keep_best_loop(
        states, cost0(*states), iterate, tolerance=tolerance,
        criterion='abs_delta_f', max_iterations=max_iterations)
    return costs.cpu().numpy(), n_iters.cpu().numpy()


def _close(name, got, want, rtol=RTOL, atol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError("%s: sharded and single-device runs differ by "
                             "%.3e (rtol %.0e)" % (name, err, rtol))
    return err


def _world(device_type):
    """Every check of the dry run, in one rank of the world.  Returns the
    largest difference of each check and this rank's kernel launches."""
    world = torch.distributed.get_world_size()
    device = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == 'cuda' else torch.device('cpu')
    shapes = [(world, 1), (1, world)]
    if world % 2 == 0 and world > 2:
        shapes.append((2, world // 2))
    n, d, k = 8 * world, 6, 3
    X = planted_data(0, n, d, k, noise=0.05)
    errors = {}
    for shape in shapes:
        mesh = create_mesh(shape, device_type=device_type)
        tag = "%dx%d" % shape
        R = 2 * shape[0]
        Zs, Cs, alphas, Ws = random_states(1, R, n, k, d)

        # One alternating iteration: the grouped iterate, one step.
        Zn, Cn, an, costs = sharded_aa_train_step(
            mesh, X, Zs, Cs, alphas, dict_iterations=3,
            weights_iterations=20, weights_backend='pallas')
        Xt = torch.as_tensor(X, device=device)
        iterate, _ = _aa_iterate(
            Xt, Xt @ Xt.T, n_components=k, delta=0.0, do_scale=False,
            sh=_Shard(device=device),
            dictionary_solver_kwargs={'max_iterations': 3},
            weights_solver_kwargs={'backend': 'pallas',
                                   'max_iterations': 20})
        want = iterate(*(torch.as_tensor(a, device=device)
                         for a in (Zs, Cs, alphas)))
        errors[tag + " train step"] = max(
            _close(tag + " train step " + name, got.cpu(), w.cpu(),
                   atol=WEIGHTS_ATOL if name == "Z" else 1e-12)
            for name, got, w in zip(("Z", "C", "alpha", "cost"),
                                    (Zn, Cn, an, costs), want))

        # The full fits, AA (delta 0 and 0.3), kernel AA, GPNH.
        for delta in (0.0, 0.3):
            Xs = 1.2 * X if delta else X
            res = sharded_aa_fit(mesh, Xs, Zs, Cs, alphas, delta=delta,
                                 tolerance=1e-10, max_iterations=40,
                                 dictionary_solver_kwargs=DICT_KW,
                                 weights_solver_kwargs=WEIGHTS_KW)
            want_costs, want_iters, _ = single_aa_fit(
                Xs, Zs, Cs, alphas, delta=delta, device=device,
                dictionary_solver_kwargs=DICT_KW)
            errors["%s AA fit, delta %g" % (tag, delta)] = _close(
                tag + " AA costs", res['costs'], want_costs)
            if not np.array_equal(res['n_iters'], want_iters):
                raise AssertionError("%s AA n_iters %s != %s" % (
                    tag, res['n_iters'], want_iters))
        res = sharded_kernel_aa_fit(mesh, X @ X.T, Zs, Cs, alphas,
                                    tolerance=1e-10, max_iterations=40,
                                    dictionary_solver_kwargs=DICT_KW,
                                    weights_solver_kwargs=WEIGHTS_KW)
        want_costs, _, _ = single_aa_fit(X @ X.T, Zs, Cs, alphas,
                                         has_data=False, device=device,
                                         dictionary_solver_kwargs=DICT_KW)
        errors[tag + " kernel AA fit"] = _close(
            tag + " kernel AA costs", res['costs'], want_costs, atol=1e-10)
        res = sharded_gpnh_fit(mesh, X, Zs, Ws, lambda_W=1e-3,
                               tolerance=1e-10, max_iterations=40,
                               weights_solver_kwargs=WEIGHTS_KW)
        want_costs, _ = single_gpnh_costs(X, Zs, Ws, lambda_W=1e-3,
                                          device=device)
        errors[tag + " GPNH fit"] = _close(
            tag + " GPNH costs", res['costs'], want_costs, atol=1e-10)

    # The restart-sharded best of N against the single-device fit.
    mesh = create_mesh((world,), axis_names=("restarts",),
                       device_type=device_type)
    kw = dict(init='random', max_iterations=30, restart_chunk=2,
              dictionary_solver_kwargs=DICT_KW,
              weights_solver_kwargs=WEIGHTS_KW)
    got = aa_fit_restarts(X, k, 0, 2 * world + 1, mesh=mesh, **kw)
    want = aa_fit_restarts(X, k, 0, 2 * world + 1, device=device, **kw)
    errors["restart-sharded aa_fit_restarts"] = _close(
        "aa_fit_restarts costs", got['costs'], want['costs'])
    if got['best_index'] != want['best_index'] or not np.array_equal(
            got['n_iters'], want['n_iters']):
        raise AssertionError("aa_fit_restarts: winner or n_iters differ")
    return {'differences': errors,
            'launches': {'K1': simplex_qp.LAUNCHES,
                         'K3': simplex_qp.GROUPED_LAUNCHES}}


def dryrun_multichip(n_processes=None, backend=None, device_type='cuda',
                     timeout=600.0):
    """Run the sharded train step, the sharded AA (delta 0 and 0.3),
    kernel-AA and GPNH fits on meshes (n, 1), (1, n) and, for an even n
    above 2, (2, n/2), and the restart-sharded ``aa_fit_restarts``, in
    a world of ``n_processes`` (float64, tiny shapes), each held to the
    single-device path within :data:`RTOL`.  The world runs on the card
    (``device_type='cuda'``, the default: one process a card unless
    ``n_processes`` is given, NCCL unless ``backend`` says 'gloo'; raises
    ``RuntimeError`` where there is no CUDA device) or, with
    ``device_type='cpu'``, on the CPU on gloo (2 processes by default).
    Raises on a difference; returns every rank's ``{'differences':
    {check: largest difference}, 'launches': {kernel: count}}`` (the
    grouped kernels run on a card, their plain versions on a CPU
    mesh)."""
    if n_processes is None:
        n_processes = (torch.cuda.device_count() if device_type == 'cuda'
                       else 2)
    return spawn(_world, int(n_processes), args=(device_type,),
                 backend=backend, device_type=device_type,
                 timeout=timeout)


def main(argv):
    """``[n_processes [backend [device_type]]]``: the dry run, printed."""
    n_proc = int(argv[0]) if argv else None
    backend = argv[1] if len(argv) > 1 else None
    device_type = argv[2] if len(argv) > 2 else 'cuda'
    ranks = dryrun_multichip(n_proc, backend, device_type)
    n_proc = len(ranks)
    for name, err in ranks[0]['differences'].items():
        print("%-40s max |sharded - single| %.3e" % (name, err))
    print("kernel launches by rank: %s"
          % [r['launches'] for r in ranks])
    print("dry run passed on %d processes" % n_proc)


if __name__ == "__main__":
    main(sys.argv[1:])
