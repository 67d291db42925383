"""Device meshes on ``torch.distributed`` for multi-GPU runs.

Port of convex_dim_red_tpu/parallel/mesh.py.  The problem has two
parallel axes: ``restarts`` (independent fits; the only traffic is the
final keep-best selection) and ``samples`` (rows of the data or kernel
matrix; the k-sized contractions of every iteration cross it).  A mesh
is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` are those axes.

The two packages run a mesh differently.  JAX is single-controller: one
process sees every device and ``shard_map`` runs a body once per device.
Here there is one process per rank, and the collectives go through the
mesh's process groups (``mesh.get_group(name)``).  The rules every
sharded function of the port keeps:

- **Inputs.** Every rank calls a function with the same full inputs, as
  a JAX caller passes global arrays, and slices its own shard: a rank's
  rows along ``samples`` are the ``mesh.get_local_rank('samples')``-th
  of ``mesh.size`` equal blocks, its restarts likewise along
  ``restarts``.
- **Outputs.** Every rank returns what the JAX function's global result
  holds.  Where the JAX ``out_specs`` shard an output (the best
  ``weights`` rows, per-restart ``costs`` and ``n_iters``, k-means
  ``labels``, PCA components over features) the port gathers it, so
  each rank holds the whole array.
- **Agreement.** Every stop decision read on the host is taken from
  all-reduced values or all-reduced itself, and a small replicated solve
  is the group's first rank's, broadcast (GPNH's k x k least squares,
  which every rank also solves; PCA's ``eigh``, which only the first
  rank runs), so no rank leaves a loop while another waits in a
  collective.  A host decision from outside the program (a sweep's
  checkpoint on disk) and a seed drawn per process are the mesh's first
  rank's.  Restart groups never communicate inside a loop.
- **Device.** The mesh's device type decides where the work runs: a
  ``'cuda'`` mesh on the rank's card (``cuda:{LOCAL_RANK %
  device_count()}``), a ``'cpu'`` mesh on the CPU (the caller asking for
  the CPU, as the tests do).  A mesh never falls back to another device
  or backend.
- **Order.** ``all_reduce`` sums in another order than a single device
  does, so a sharded float64 run agrees with the single-device run to
  rounding; an axis of size 1 runs no collective at all, so a (1, 1)
  mesh gives the single-device bits.

:func:`spawn` starts a world of processes on one host (a ``file://``
store in a temporary directory, a time limit on the whole world), for
tests, the dry run and the card's smoke.
"""

import datetime
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["create_mesh", "create_hybrid_mesh", "ensure_mesh_axes",
           "replicate", "shard_batch", "spawn", "mesh_device"]

#: Collective time limit of the groups a mesh creates: :func:`spawn`
#: sets it in its processes to the world's own limit (None, elsewhere:
#: the backend's default).
_GROUP_TIMEOUT = None


def _check_cuda(device_type):
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device, and none is "
                           "available: pass device_type='cpu' to run on "
                           "the CPU")


def _check_world():
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group (or "
                           "run under parallel.mesh.spawn) first")


def _set_rank_device(device_type):
    """Rank r works on ``cuda:{LOCAL_RANK % device_count()}``."""
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def _build_mesh(device_type, ranks, axis_names):
    """A DeviceMesh over the global ``ranks`` (an int array shaped like
    the mesh) whose groups carry :data:`_GROUP_TIMEOUT`.  Every rank of
    the world calls it with the same arguments (``new_group`` is
    collective)."""
    ranks = np.asarray(ranks, dtype=np.int64)
    if len(axis_names) != ranks.ndim:
        raise ValueError("axis_names %r do not match a mesh of shape %r"
                         % (tuple(axis_names), ranks.shape))
    if sorted(ranks.reshape(-1).tolist()) != list(
            range(dist.get_world_size())):
        raise ValueError("a mesh of shape %r needs exactly the %d ranks of "
                         "the world" % (ranks.shape, dist.get_world_size()))
    me = dist.get_rank()
    groups = []
    for dim in range(ranks.ndim):
        mine = None
        for sub in np.moveaxis(ranks, dim, -1).reshape(-1, ranks.shape[dim]):
            sub = sub.tolist()
            group = (dist.new_group(sub) if _GROUP_TIMEOUT is None
                     else dist.new_group(sub, timeout=_GROUP_TIMEOUT))
            if me in sub:
                mine = group
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.as_tensor(ranks),
                                 mesh_dim_names=tuple(axis_names))


def create_mesh(shape=None, axis_names=("restarts", "samples"),
                device_type="cuda"):
    """A mesh over the ranks of the initialised world.

    ``shape=None`` puts every rank on the first axis; for a 2-D mesh
    pass, e.g., ``shape=(2, 2)``.  ``device_type='cuda'`` (the default)
    sets rank r's device to ``cuda:{LOCAL_RANK % device_count()}`` and
    raises ``RuntimeError`` where there is no CUDA device; ``'cpu'``
    runs on the CPU.  Every rank calls it with the same arguments.
    """
    _check_cuda(device_type)
    _check_world()
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError("a mesh of shape %r needs %d ranks; the world "
                         "has %d" % (shape, int(np.prod(shape)), world))
    _set_rank_device(device_type)
    return _build_mesh(device_type, np.arange(world).reshape(shape),
                       axis_names)


def create_hybrid_mesh(axis_names=("restarts", "samples"),
                       slice_groups=None, device_type="cuda"):
    """Mesh for several hosts: restarts across hosts, samples within one.

    The restart axis carries independent fits (one keep-best selection a
    fit), which tolerates the slower network between hosts; the sample
    axis carries every iteration's collectives and stays inside a host,
    on its NVLink.  The GPU reading of the JAX package's "restarts over
    DCN, samples over ICI".  Ranks are grouped by host name, or by
    ``slice_groups``: equal-length sequences of global ranks, one per
    group.  On one host it is ``create_mesh(shape=(1, world))``.
    """
    _check_cuda(device_type)
    _check_world()
    _set_rank_device(device_type)
    if slice_groups is None:
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        groups = {}
        for rank, host in enumerate(hosts):
            groups.setdefault(host, []).append(rank)
        slice_groups = list(groups.values())
    slice_groups = [list(g) for g in slice_groups]
    if not slice_groups or any(len(g) == 0 for g in slice_groups):
        raise ValueError("slice_groups must be a non-empty sequence of "
                         "non-empty rank groups; got %r" % (slice_groups,))
    sizes = {len(g) for g in slice_groups}
    if len(sizes) != 1:
        raise ValueError(
            "slices must hold equally many ranks for a rectangular mesh; "
            "got group sizes %r" % sorted(len(g) for g in slice_groups))
    flat = [r for g in slice_groups for r in g]
    if len(set(flat)) != len(flat):
        raise ValueError("slice_groups contain duplicate ranks; each rank "
                         "may appear in exactly one slice group")
    return _build_mesh(device_type, np.asarray(slice_groups), axis_names)


def require_device_mesh(mesh):
    """Raise ``ValueError`` naming ``mesh`` unless it is a DeviceMesh."""
    if not isinstance(mesh, DeviceMesh):
        raise ValueError("mesh must be a torch.distributed.device_mesh."
                         "DeviceMesh (see parallel.mesh.create_mesh); got "
                         "%r" % (mesh,))


def check_mesh(mesh, restart_axis="restarts", sample_axis="samples"):
    """Raise ``ValueError`` naming ``mesh`` unless it is None or a
    DeviceMesh that :func:`ensure_mesh_axes` takes."""
    if mesh is None:
        return
    require_device_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if (restart_axis in names and sample_axis in names) or names in (
            (sample_axis,), (restart_axis,)):
        return
    raise ValueError(
        "mesh must carry axes (%r, %r) or be 1-D over one of them; got "
        "axis_names=%r" % (restart_axis, sample_axis, names))


def ensure_mesh_axes(mesh, restart_axis="restarts", sample_axis="samples"):
    """A mesh with both parallel axes, lifting 1-D meshes:

    - a 2-D mesh already carrying both axes is returned unchanged;
    - a 1-D mesh over ``sample_axis`` is lifted to ``(1, n_ranks)``;
    - a 1-D mesh over ``restart_axis`` is lifted to ``(n_ranks, 1)``.

    A lifted mesh is made once per mesh (its groups are collective to
    create) and kept on the mesh.
    """
    check_mesh(mesh, restart_axis, sample_axis)
    names = tuple(mesh.mesh_dim_names)
    if restart_axis in names and sample_axis in names:
        return mesh
    key = (restart_axis, sample_axis)
    lifted = getattr(mesh, "_lifted_meshes", {})
    if key not in lifted:
        ranks = mesh.mesh.numpy()
        shape = (1, -1) if names == (sample_axis,) else (-1, 1)
        lifted[key] = _build_mesh(mesh.device_type, ranks.reshape(shape),
                                  (restart_axis, sample_axis))
        mesh._lifted_meshes = lifted
    return lifted[key]


def mesh_device(mesh):
    """The torch device a mesh's work runs on in this process."""
    if mesh.device_type == "cuda":
        _check_cuda("cuda")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh, name):
    """``(size, local rank, group)`` of the mesh axis ``name``."""
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return 1, 0, None
    return size, mesh.get_local_rank(name), mesh.get_group(name)


def replicate(mesh, x):
    """This rank's copy of ``x`` on the mesh's device."""
    return torch.as_tensor(x, device=mesh_device(mesh)).clone()


def _block(n, size, index, what="rows"):
    if n % size:
        raise ValueError("%d %s do not divide over a mesh axis of %d ranks"
                         % (n, what, size))
    step = n // size
    return slice(index * step, (index + 1) * step)


def shard_batch(mesh, x, axis_name="restarts"):
    """This rank's block of the leading axis of ``x`` along the mesh
    axis ``axis_name``, on the mesh's device (the axis must divide)."""
    x = torch.as_tensor(x, device=mesh_device(mesh))
    size, index, _ = _axis(mesh, axis_name)
    return x[_block(x.shape[0], size, index)].clone()


# ---------------------------------------------------------------------------
# Collectives on one mesh axis (none at all on an axis of size 1)
# ---------------------------------------------------------------------------


def _psum(t, mesh, name):
    """Sum of ``t`` over the axis ``name`` (a new tensor)."""
    size, _, group = _axis(mesh, name)
    if size == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_true(flag, mesh, name):
    """Whether a host flag holds on every rank of the axis ``name``."""
    size, _, group = _axis(mesh, name)
    if size == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(int(t.item()))


def _all_gather(t, mesh, name, dim=0):
    """The blocks of every rank of the axis ``name``, concatenated along
    ``dim`` in rank order (equal shapes on every rank)."""
    size, _, group = _axis(mesh, name)
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _broadcast(t, mesh, name, src):
    """``t`` as rank ``src`` of the axis ``name`` holds it (every rank
    passes a tensor of the same shape and dtype)."""
    size, _, group = _axis(mesh, name)
    if size == 1:
        return t
    out = t.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, int(src)),
                   group=group)
    return out


def _agree_object(obj, mesh):
    """A picklable ``obj`` as the mesh's first rank holds it, on every
    rank (one ``broadcast_object_list`` from local rank 0 along each
    axis)."""
    for name in mesh.mesh_dim_names:
        size, _, group = _axis(mesh, name)
        if size > 1:
            box = [obj]
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0), group=group)
            obj = box[0]
    return obj


def _is_first_rank(mesh):
    """Whether this process is the mesh's first rank."""
    return dist.get_rank() == int(mesh.mesh.reshape(-1)[0])


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _world_entry(fn, args, rank, world_size, backend, device_type, timeout,
                 workdir):
    global _GROUP_TIMEOUT
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(1)
    limit = datetime.timedelta(seconds=float(timeout))
    _GROUP_TIMEOUT = limit
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(workdir, "store"),
            rank=rank, world_size=world_size, timeout=limit)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, "result_%d.pkl" % rank), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(workdir, "error_%d.txt" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, world_size, *, args=(), backend=None, device_type="cuda",
          timeout=120.0):
    """Run ``fn(*args)`` in a world of ``world_size`` processes and return
    the list of their results, rank by rank.

    Each process is started with ``torch.multiprocessing`` (``spawn``:
    ``fn`` must be a module-level function, and the module that defines
    it is imported afresh in every process), sets ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE``, one torch thread, and its card
    (``device_type='cuda'``, the default; ``RuntimeError`` where there
    is no CUDA device; ``'cpu'`` runs on the CPU), and joins the world
    through a ``file://`` store in a new temporary directory, so worlds
    can run side by side.  ``backend``: 'gloo' or 'nccl' (default: 'nccl' for
    ``'cuda'``, 'gloo' for ``'cpu'``).  Results come back through files
    in that directory (pickled; return host values).

    ``timeout`` (seconds) bounds the whole world and every collective
    (``init_process_group(timeout=...)`` and the groups of the meshes it
    creates): when it passes, or as soon as one process fails, every
    process still running is killed and ``RuntimeError`` (or
    ``TimeoutError``) is raised with the failing ranks' tracebacks.
    """
    _check_cuda(device_type)
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="world_") as workdir:
        procs = [ctx.Process(target=_world_entry, args=(
            fn, tuple(args), rank, int(world_size), backend, device_type,
            timeout, workdir)) for rank in range(int(world_size))]
        for p in procs:
            p.start()
        deadline = time.monotonic() + float(timeout)
        timed_out = False
        while True:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(
                    c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.02)
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join()

        errors = []
        for rank in range(int(world_size)):
            path = os.path.join(workdir, "error_%d.txt" % rank)
            if os.path.exists(path):
                with open(path) as f:
                    errors.append("rank %d:\n%s" % (rank, f.read()))
        if timed_out:
            raise TimeoutError(
                "a world of %d did not finish within %.0f s and was killed"
                "\n%s" % (world_size, timeout, "\n".join(errors)))
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(
                "a world of %d failed (exit codes %r)\n%s"
                % (world_size, [p.exitcode for p in procs],
                   "\n".join(errors)))
        results = []
        for rank in range(int(world_size)):
            with open(os.path.join(workdir, "result_%d.pkl" % rank),
                      "rb") as f:
                results.append(pickle.load(f))
        return results
