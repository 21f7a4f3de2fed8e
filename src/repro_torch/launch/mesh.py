"""Device meshes over ``torch.distributed`` ranks, and the ranks' launcher.

A :class:`Mesh` is this process's view of a ``data x model`` grid (``pod
x data x model`` for the twin-pod production shape) of ranks, one rank
per process: the axis sizes, this rank's coordinate on each axis, one
process group per axis (the ranks that differ from this one on that axis
only) and this rank's device.  Ranks are laid out row-major over the axes
in order, as ``jax.make_mesh`` lays out devices.

:func:`spawn` starts the ranks: one process each, ``spawn`` start method
(a child inherits no CUDA context), the default group initialised through
a ``file://`` store in a directory the caller gives (parallel runs never
collide on a port), and every rank joined within a timeout that fails the
call.  The backend is the caller's explicit choice.  On CUDA, rank r takes
card ``r % cards``: ``nccl`` needs one card per rank and refuses more
ranks than cards; ``gloo`` may put several ranks on one card, and carries
CUDA tensors through host memory (:mod:`repro_torch.dist.collectives`).

    mesh_run = spawn(fn, (1, 2), "gloo", tmp_dir, *args, device="cpu")
    # fn(mesh, *args) ran on each of 2 ranks; rank 0's return value is
    # mesh_run
"""
from __future__ import annotations

import itertools
import os
import pickle
import queue as queue_mod
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
PRODUCTION_AXES = ("pod", "data", "model")


class Mesh:
    """This rank's view of a grid of ranks (see the module docstring)."""

    def __init__(self, shape: Dict[str, int], rank: int, backend: str,
                 groups: Dict[str, object], device: torch.device):
        self.shape = dict(shape)
        self.rank = rank
        self.backend = backend
        self.groups = groups
        self.device = device
        self.coords = {}
        rest = rank
        for axis in reversed(list(self.shape)):
            self.coords[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]

    @property
    def n_ranks(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh lacks)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    def group(self, axis: Optional[str]):
        """The process group of ``axis``; ``None`` is every rank."""
        return self.groups[axis]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")


def _available() -> int:
    """Ranks this process can build a mesh over: the default group's size,
    or this process alone."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _take_ranks(shape, what: str) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    avail = _available()
    if avail < n:
        raise ValueError(
            f"{what}: mesh shape {tuple(shape)} requires {n} devices but "
            f"only {avail} are available "
            f"({dist.get_backend() if dist.is_initialized() else 'no'} "
            f"process group). Start one rank per device with "
            f"repro_torch.launch.mesh.spawn.")
    return n


def _build(shape: Tuple[int, ...], axes: Tuple[str, ...], what: str,
           device: Optional[torch.device] = None) -> Mesh:
    n = _take_ranks(shape, what)
    sizes = dict(zip(axes, (int(s) for s in shape)))
    if not dist.is_initialized():
        # one process, every axis of size 1: no group to talk to
        groups = {a: None for a in axes}
        groups[None] = None
        return Mesh(sizes, 0, "none", groups, torch.device("cpu"))
    rank = dist.get_rank()
    backend = dist.get_backend()
    groups = {None: dist.group.WORLD if n == dist.get_world_size()
              else dist.new_group(list(range(n)))}
    strides = [1] * len(axes)
    for i in range(len(axes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[axes[i + 1]]
    # every rank creates every group, in the same order (new_group is
    # collective); each keeps the one that holds it
    for i, axis in enumerate(axes):
        others = [range(sizes[a]) for a in axes if a != axis]
        for fixed in itertools.product(*others):
            coords = list(fixed)
            coords.insert(i, 0)
            base = sum(c * s for c, s in zip(coords, strides))
            members = [base + j * strides[i] for j in range(sizes[axis])]
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    if rank >= n:
        return None     # a rank past the mesh's (it took part in new_group)
    if device is None:
        # a group started outside spawn: nccl ranks on their current
        # card, gloo ranks on the CPU
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(sizes, rank, backend, groups, device)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: Optional[torch.device] = None) -> Mesh:
    """A ``data x model`` mesh over the first ``data * model`` ranks of the
    default process group (a single process on the CPU without one, for
    1 x 1); every rank of the group calls it, and a rank past the mesh
    gets None.  Refuses, naming both counts, when there are fewer ranks.
    ``device`` is this rank's (default: its current card on nccl, the CPU
    on gloo).  (Ranks that :func:`spawn` starts get their mesh from it;
    they may build another shape over the same ranks, passing
    ``mesh.device``.)"""
    return _build((data, model), AXES, "make_local_mesh", device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: 16 x 16 (data, model), or 2 x 16 x 16 (pod,
    data, model) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = PRODUCTION_AXES if multi_pod else AXES
    return _build(shape, axes, "make_production_mesh")


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def _rank_device(rank: int, backend: str, device: str) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank % cards``."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_ranks(n: int, backend: str, device: str):
    """Refuse a launch the backend cannot carry: ``nccl`` needs a card per
    rank (it refuses two ranks on one device), and every CUDA launch a
    card."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo "
                             "on the CPU")
        return
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but "
                           "torch.cuda.is_available() is False")
    cards = torch.cuda.device_count()
    if backend == "nccl" and n > cards:
        raise ValueError(f"nccl needs one card per rank: {n} ranks but "
                         f"only {cards} CUDA devices")


def _rank_main(call, shape, backend, store, rank, n, device, threads, out):
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        if threads is not None:
            torch.set_num_threads(threads)
        dev = _rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n)
        axes = PRODUCTION_AXES if len(shape) == 3 else AXES
        mesh = _build(tuple(shape), axes, "spawn", dev)
        result = fn(mesh, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, "ok", result if rank == 0 else None))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


_SPAWNS = itertools.count()


def spawn(fn, shape, backend: str, store_dir: str, *args,
          device: str = "cpu", timeout: float = 600.0,
          threads: Optional[int] = None):
    """Run ``fn(mesh, *args)`` on ``prod(shape)`` new ranks and return rank
    0's result.

    ``fn`` must be importable by name (the ``spawn`` start method pickles it
    by reference) and its result picklable.  ``store_dir`` holds the
    ``file://`` rendezvous store.  ``threads`` sets each rank's
    ``torch.set_num_threads``.  A rank that raises fails the call with its
    traceback; ranks that have not all finished within ``timeout`` seconds
    (a rank that diverged waits in a collective forever) are killed and the
    call raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    check_ranks(n, backend, device)
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{next(_SPAWNS)}_"
                                    f"{time.time_ns()}")
    # fn and its arguments go through a file, not the processes' start
    # pipes: a start blocks until the child has imported its modules and
    # read a payload past the pipe's buffer, which starts the ranks one
    # after another
    call = store + ".call"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(call, shape, backend, store, r, n, device,
                               threads, out), daemon=True)
             for r in range(n)]
    done, result, error = set(), None, None
    try:
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(done) < n and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn{shape}: ranks {sorted(set(range(n)) - done)} "
                    f"did not finish within {timeout:.0f} s")
            try:
                rank, status, payload = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    error = (f"rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode} before reporting")
                continue
            if status == "error":
                error = f"rank {rank} failed:\n{payload}"
            done.add(rank)
            if rank == 0:
                result = payload
        if error is not None:
            raise RuntimeError(f"spawn{shape}: {error}")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"spawn{shape}: a rank exited with code "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        out.close()
        for path in (store, call):
            if os.path.exists(path):
                os.remove(path)
    return result
