"""Distributed scaling tour: every model family over a mesh, on the port.

The port's counterpart of examples/distributed_scaling.py.  A world of
processes (``parallel.mesh.spawn``, one process a rank) walks the
surface on planted data, each rank passing the full inputs and getting
the whole result:

  1. estimator-level ``mesh=``: ArchetypalAnalysis, KernelAA and
     GPNHConvexCoding (sample-sharded fits), KMeans (restarts and
     samples), PCA (feature-sharded Gram path), a sharded transform;
  2. multi-restart keep-best over the restart axis
     (``aa_fit_restarts``), with screened restarts;
  3. a resumable k-means model-selection sweep with its gap-statistic
     trials over the mesh.

Run on the cards (one process a card, NCCL)::

    python -m convex_dim_red_tpu_torch.examples.distributed_scaling

with the JAX example's settings, or on the CPU in a gloo world of two
processes (no card needed; the fits cut to 100 iterations and 10
dictionary steps an iteration)::

    python -m convex_dim_red_tpu_torch.examples.distributed_scaling \
        --platform cpu [--world-size N]
"""

import argparse
import tempfile
import time

import torch

from ..parallel.dryrun import planted_data


#: The JAX example's settings for the AA, KernelAA and restart fits.
FIT = dict(tolerance=1e-8, max_iterations=300)
#: On the CPU the fits are cut: each step of the dictionary SPG is a
#: collective on the sample axis, which a gloo world on the CPU pays in
#: milliseconds.
CPU_FIT = dict(FIT, max_iterations=100,
               dictionary_solver_kwargs={'max_iterations': 10})


def tour(device_type):
    """One rank's walk over the surface: the lines it reports (the
    parent prints rank 0's)."""
    from .. import (ArchetypalAnalysis, GPNHConvexCoding, KernelAA, KMeans,
                    PCA)
    from ..parallel import (aa_fit_restarts, create_mesh,
                            kmeans_model_selection_sweep)
    from ..parallel.mesh import mesh_device

    n_dev = torch.distributed.get_world_size()
    lines = []

    say = lines.append

    settings = CPU_FIT if device_type == 'cpu' else FIT
    k = 4
    n = 64 * n_dev          # divisible by the sample axis
    d = 16 * n_dev          # divisible by the feature axis (PCA)
    X = planted_data(0, n, d, k)

    # 1-D mesh: every rank on the sample axis (estimator fits).
    mesh = create_mesh(shape=(n_dev,), axis_names=("samples",),
                       device_type=device_type)
    say("ranks: %d x %s" % (n_dev, mesh_device(mesh)))
    Xd = torch.as_tensor(X, device=mesh_device(mesh))

    t0 = time.perf_counter()
    aa = ArchetypalAnalysis(n_components=k, init='furthest_sum',
                            random_state=0, mesh=mesh, **settings).fit(Xd)
    say("AA (mesh=%d samples): cost=%.3e n_iter=%d [%.1fs]"
        % (n_dev, aa.cost, aa.n_iter, time.perf_counter() - t0))

    _, cost = aa.transform(Xd)   # sharded per-row QPs
    say("AA.transform (sharded): cost=%.3e" % cost)

    ka = KernelAA(n_components=k, init='random', random_state=0, mesh=mesh,
                  **settings)
    ka.fit(Xd @ Xd.T)
    say("KernelAA (mesh): cost=%.3e n_iter=%d" % (ka.cost, ka.n_iter))

    gp = GPNHConvexCoding(n_components=k, lambda_W=1e-3, init='random',
                          random_state=0, mesh=mesh,
                          **{key: settings[key] for key in FIT}).fit(Xd)
    say("GPNH (mesh): cost=%.3e n_iter=%d" % (gp.cost, gp.n_iter))

    # 2-D mesh: restarts x samples (KMeans shards its n_init too).
    r_axis = max(1, n_dev // 2)
    mesh2d = create_mesh(shape=(r_axis, n_dev // r_axis),
                         axis_names=("restarts", "samples"),
                         device_type=device_type)
    km = KMeans(n_clusters=2, n_init=2 * r_axis, random_state=0,
                mesh=mesh2d).fit(Xd)
    say("KMeans (mesh %dx%d): inertia=%.3e"
        % (r_axis, n_dev // r_axis, km.inertia_))

    pca = PCA(n_components=4, mesh=mesh)   # feature-sharded Gram path
    scores = pca.fit_transform(Xd)
    say("PCA (feature-sharded): explained[0]=%.3e scores=%s"
        % (pca.explained_variance_[0], tuple(scores.shape)))

    # Multi-restart keep-best over the restart axis, screened (screen ->
    # prune -> resume).
    mesh_r = create_mesh(shape=(n_dev,), axis_names=("restarts",),
                         device_type=device_type)
    t0 = time.perf_counter()
    best = aa_fit_restarts(Xd, k, 0, n_init=4 * n_dev, init='random',
                           mesh=mesh_r, screen_iterations=20, **settings)
    say("aa_fit_restarts (screened, %d restarts over %d ranks): best "
        "cost=%.3e [%.1fs]" % (4 * n_dev, n_dev, best['cost'],
                               time.perf_counter() - t0))

    # Resumable sweep with the gap trials over the mesh (a fresh
    # checkpoint directory a run; only the first rank reads and writes
    # it).
    with tempfile.TemporaryDirectory(
            prefix="distributed_scaling_sweep_") as ckpt:
        sweep = kmeans_model_selection_sweep(
            Xd, ks=[2, 3], seed=1, n_init=2 * r_axis, n_trials=2 * r_axis,
            mesh=mesh2d, checkpoint_dir=ckpt)
    for kk, entry in sorted(sweep.items()):
        say("kmeans sweep k=%d: gap=%.3f" % (kk, entry['gap']))
    say("distributed scaling tour OK")
    return lines


def main(argv=None):
    from ..parallel.mesh import spawn
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--platform', default='cuda', choices=['cuda', 'cpu'],
                        help="'cuda' (default): one process a card on "
                             "NCCL; 'cpu': a gloo world on the CPU")
    parser.add_argument('--world-size', type=int, default=None,
                        help='processes in the world (default: the cards '
                             'on cuda, 2 on the CPU)')
    parser.add_argument('--timeout', type=float, default=900.0,
                        help="the world's time limit (seconds)")
    args = parser.parse_args(argv)
    if args.platform == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass --platform "
                           "cpu to run on the CPU")
    world = args.world_size or (torch.cuda.device_count()
                                if args.platform == 'cuda' else 2)
    lines = spawn(tour, world, args=(args.platform,),
                  device_type=args.platform, timeout=args.timeout)[0]
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    main()
