"""Atomic directory checkpoints of the port's tensor trees, in the
reference's on-disk format.

Layout: ``<dir>/step_XXXXXXXX/{manifest.json, data.bin}``.  ``data.bin``
holds every leaf's bytes back to back; ``manifest.json`` is ``{"step",
"leaves": [{key, dtype, shape, offset, nbytes}]}`` with ``key`` the leaf's
``jax.tree_util.keystr`` in the reference (:mod:`._tree` builds it from
the port's trees) and ``dtype`` numpy's name (``"bfloat16"`` is
ml_dtypes' name; its bytes cross through ``torch.int16``).  So a
checkpoint written by ``repro.dist.checkpoint`` restores here bit for bit,
and the reverse: params, optimizer NamedTuples, int32 counters and packed
:class:`~repro_torch.core.quantizer.QuantizedTensor` trees.

The write discipline is the reference's.  Writes land in a per-writer
``step_XXXXXXXX.<host>-<pid>-<n>.tmp`` scratch directory (data fsynced,
then the manifest through ``manifest.json.part`` and a rename) and are
renamed into place, retiring an existing step aside first, so a reader or
:func:`latest_step` never sees a partial checkpoint and a crash mid-save
leaves the previous step as the newest complete one.  Every save and
:func:`latest_step` sweeps crashed writers' tmps (a dead pid of this
host), recovering one that holds the only complete copy of its step;
this process's live writers, this host's live pids and other hosts' tmps
are never touched.  Restore is target-directed: the caller gives a tree of
the expected structure and gets the same structure back, dtypes from the
manifest, read leaf by leaf so only one host copy of a leaf is resident.

``save_async`` snapshots the tree to host memory before it returns (the
training loop may then overwrite its tensors) and writes on a background
thread; ``wait_pending`` joins every writer and re-raises the first
failure.

On a mesh (``mesh=``, ``specs=``: the ``{key: spec}`` of the leaves the
mesh cuts, :func:`repro_torch.dist.sharding.tree_specs`) every rank calls
``save`` / ``save_async``: each cut leaf is all-gathered to its logical
shape first, a collective run in the caller's thread (a background thread's
collective would race the training step's), and then rank 0 alone writes,
the bytes a single-device save of the gathered tree writes; the other ranks
touch no file.  ``restore(..., mesh=, specs=)`` reads each logical leaf and
keeps this rank's block of it, so a checkpoint written on one mesh resumes
on another or on one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from . import _tree
from .collectives import all_gather
from .sharding import Parts, axis_rules, cut_tensor

_STEP_RE = re.compile(r"^step_(\d{8,})$")   # 8+: steps >= 1e8 grow digits
# writer tmps are step_XXXXXXXX.<host>-<pid>-<n>.tmp; <host> is sanitized
# to contain no "-" so the parse is unambiguous.  A bare step_XXXXXXXX.tmp
# (no owner info) is always reclaimable.
_TMP_RE = re.compile(r"^(step_\d{8,})(?:\.(.+)-(\d+)-\d+)?\.tmp$")
_RAW_HOST = socket.gethostname() or "host"
# sanitized name + short hash: sanitization maps e.g. "gpu-01" and "gpu_01"
# to the same string, and a collision would let one host pid-check (and
# sweep) another's live tmp on a shared filesystem
_HOST = (re.sub(r"[^A-Za-z0-9_]", "_", _RAW_HOST) + "_"
         + hashlib.md5(_RAW_HOST.encode()).hexdigest()[:8])
_PENDING: list = []
_PENDING_LOCK = threading.Lock()
_ACTIVE_TMPS: set = set()
_ACTIVE_LOCK = threading.Lock()
_TMP_COUNTER = iter(range(1 << 62))

# numpy's dtype names (the manifest's) <-> torch dtypes
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
           torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_TORCH = {name: dt for dt, name in _DTYPES.items()}


def _step_name(step: int) -> str:
    return f"step_{step:08d}"


def _check_keep(keep: Optional[int]):
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1 (got {keep}); the checkpoint "
                         f"just written always survives GC")


def gather_to_host(tree, mesh=None, specs: Optional[dict] = None):
    """A host copy of every leaf (tensors detached and copied; numpy
    arrays and Python scalars as arrays), so the caller may overwrite its
    tensors as soon as this returns.  On a mesh each leaf ``specs`` names
    is gathered to its logical shape first (every rank calls this); ranks
    other than 0 keep no copy and get None."""
    def get(key, x):
        if isinstance(x, torch.Tensor):
            if mesh is not None and key in specs:
                x = _gather_leaf(x, specs[key], mesh)
            if mesh is not None and mesh.rank != 0:
                return None
            return x.detach().to("cpu", copy=True)
        return torch.from_numpy(np.array(x))
    host = _tree.map_with_keys(get, tree)
    return host if mesh is None or mesh.rank == 0 else None


@torch.no_grad()
def _gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The logical tensor of this rank's block ``x`` under ``spec``: each
    cut dimension all-gathered over its axes, the minor axis first (blocks
    are numbered row-major over an entry's axes); a dimension of parts
    (:class:`~repro_torch.dist.sharding.Parts`) part by part."""
    with axis_rules(mesh):
        for dim, entry in enumerate(spec):
            if isinstance(entry, Parts):
                x = torch.cat([_gather_leaf(p, (None,) * dim + (e,), mesh)
                               for p, e in zip(x.chunk(len(entry), dim),
                                               entry)], dim=dim)
                continue
            for axis in reversed((entry,) if isinstance(entry, str)
                                 else entry or ()):
                if mesh.size(axis) > 1:
                    x = all_gather(x, axis, dim)
    return x


def _leaf_bytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:          # numpy has no bf16: its int16 bits
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True           # exists, different user
    return True


def _proc_start_time(pid: int) -> Optional[float]:
    """Unix epoch start time of ``pid`` (Linux /proc; None if unknowable)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            # starttime is field 22 (1-indexed); split after the ')' that
            # ends comm so spaces in the process name can't shift fields
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def _writer_alive(pid: int, tmp_mtime: float) -> bool:
    """Is the tmp's recorded writer pid still that writer?  A pid that is
    alive but *started after the tmp was created* was recycled — the
    original writer is dead and its tmp is fair game."""
    if not _pid_alive(pid):
        return False
    start = _proc_start_time(pid)
    return start is None or start <= tmp_mtime + 1.0  # 1s clock slack


def _reclaim_stale_tmps(ckpt_dir: str):
    """Remove crashed-save scratch dirs for any step, never an in-flight
    writer's: this process's live writers are registered in
    ``_ACTIVE_TMPS`` before their mkdir; this host's other processes are
    recognized by the pid in the tmp's name and skipped while alive; other
    hosts' tmps are never touched.  A dead writer's tmp holding a complete
    checkpoint of a step with no final dir is recovered, not swept."""
    for d in os.listdir(ckpt_dir):
        m = _TMP_RE.match(d)
        if not m:
            continue
        path = os.path.join(ckpt_dir, d)
        with _ACTIVE_LOCK:
            if path in _ACTIVE_TMPS:
                continue
        host, pid = m.group(2), m.group(3)
        if host is not None:
            if host != _HOST:
                continue       # another machine's writer
            pid = int(pid)
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue       # vanished under us (racing reclaimer)
            if pid != os.getpid() and _writer_alive(pid, mtime):
                continue
        final = os.path.join(ckpt_dir, m.group(1))
        if not os.path.isdir(final) and _manifest_ok(path):
            try:
                os.replace(path, final)
                continue
            except OSError:
                pass           # lost the race to another recoverer
        shutil.rmtree(path, ignore_errors=True)


def _manifest_ok(path: str) -> bool:
    """True iff ``path`` holds a parseable manifest."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def _write_dir(ckpt_dir: str, step: int, host_tree, keep: Optional[int],
               fault_hook=None):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, _step_name(step))
    _reclaim_stale_tmps(ckpt_dir)
    # per-writer unique tmp: concurrent saves of the same step never share
    # a scratch directory (last os.replace wins)
    tmp = f"{final}.{_HOST}-{os.getpid()}-{next(_TMP_COUNTER)}.tmp"
    with _ACTIVE_LOCK:
        _ACTIVE_TMPS.add(tmp)
    os.makedirs(tmp)
    try:
        manifest = []
        with open(os.path.join(tmp, "data.bin"), "wb") as f:
            offset = 0
            for key, leaf in _tree.leaves_with_keys(host_tree):
                buf = _leaf_bytes(leaf)
                f.write(buf)
                manifest.append({"key": key, "dtype": _DTYPES[leaf.dtype],
                                 "shape": list(leaf.shape),
                                 "offset": offset, "nbytes": len(buf)})
                offset += len(buf)
            f.flush()
            os.fsync(f.fileno())
        if fault_hook is not None:
            # fault-injection seam (serve/faults.py): raises between the
            # data write and manifest promotion
            fault_hook()
        # the manifest lands by its own write-then-rename: a scratch dir is
        # a complete checkpoint iff manifest.json exists and parses
        with open(os.path.join(tmp, "manifest.json.part"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(tmp, "manifest.json.part"),
                   os.path.join(tmp, "manifest.json"))
        last_err = None
        for _ in range(3):
            try:
                if os.path.isdir(final):
                    # never destroy a complete checkpoint before its
                    # replacement is in place: retire it aside, promote,
                    # then drop the retired copy
                    retired = (f"{final}.{_HOST}-{os.getpid()}-"
                               f"{next(_TMP_COUNTER)}.tmp")
                    with _ACTIVE_LOCK:
                        _ACTIVE_TMPS.add(retired)
                    try:
                        os.replace(final, retired)
                        try:
                            os.replace(tmp, final)
                        except OSError:
                            os.replace(retired, final)   # roll back
                            raise
                        shutil.rmtree(retired, ignore_errors=True)
                    finally:
                        with _ACTIVE_LOCK:
                            _ACTIVE_TMPS.discard(retired)
                else:
                    os.replace(tmp, final)
                last_err = None
                break
            except OSError as e:   # racing promoter of the same step
                last_err = e
        if last_err is not None:
            raise last_err
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE_TMPS.discard(tmp)
    if keep is not None:
        _gc(ckpt_dir, keep, step)
    return final


def save(ckpt_dir: str, step: int, tree, *, keep: Optional[int] = None,
         fault_hook=None, mesh=None, specs: Optional[dict] = None) -> str:
    """Atomically write ``tree`` as ``<ckpt_dir>/step_XXXXXXXX``; returns
    its path.  ``keep`` retains only the newest ``keep`` complete
    checkpoints after a successful write.  ``fault_hook`` runs between the
    data write and manifest promotion; whatever it raises must leave no
    half-written step.  On a ``mesh`` every rank calls it with its shards
    and rank 0 writes the gathered tree (see the module docstring)."""
    _check_keep(keep)
    host_tree = gather_to_host(tree, mesh, specs)
    if host_tree is None:
        return os.path.join(ckpt_dir, _step_name(step))
    return _write_dir(ckpt_dir, step, host_tree, keep, fault_hook=fault_hook)


def save_async(ckpt_dir: str, step: int, tree, *,
               keep: Optional[int] = None, fault_hook=None, mesh=None,
               specs: Optional[dict] = None) -> Optional[threading.Thread]:
    """Like :func:`save` but the file I/O runs on a background thread.
    The host snapshot (on a mesh: the gather) is taken before returning;
    join with :func:`wait_pending`.  Ranks other than 0 start no thread and
    get None."""
    _check_keep(keep)
    host_tree = gather_to_host(tree, mesh, specs)
    if host_tree is None:
        return None
    record = {"exc": None}

    def work():
        try:
            _write_dir(ckpt_dir, step, host_tree, keep,
                       fault_hook=fault_hook)
        except BaseException as e:  # re-raised by wait_pending
            record["exc"] = e

    t = threading.Thread(target=work, daemon=True,
                         name=f"ckpt-save-{step}")
    # register and start under one lock: wait_pending swaps the list under
    # the same lock, so it can never join a not-yet-started thread
    with _PENDING_LOCK:
        _PENDING.append((t, record))
        t.start()
    return t


def wait_pending():
    """Block until every outstanding :func:`save_async` finishes; re-raise
    the first writer failure."""
    with _PENDING_LOCK:
        pending, _PENDING[:] = _PENDING[:], []
    first_exc = None
    for t, record in pending:
        t.join()
        if first_exc is None and record["exc"] is not None:
            first_exc = record["exc"]
    if first_exc is not None:
        raise first_exc


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *complete* checkpoint step in ``ckpt_dir`` (None if none).
    The dead-writer sweep runs first, so a complete step retired aside by
    a crashed re-save is recovered before the choice."""
    if not os.path.isdir(ckpt_dir):
        return None
    _reclaim_stale_tmps(ckpt_dir)
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d)) and
             os.path.isfile(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _gc(ckpt_dir: str, keep: int, written_step: int):
    # only complete checkpoints at or before the step just written count
    # toward keep (and only those are deleted): re-saving an older step
    # never GCs its own fresh checkpoint, and newer steps are the caller's
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(d)) and
                   int(m.group(1)) <= written_step and
                   os.path.isfile(os.path.join(ckpt_dir, d, "manifest.json")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, _step_name(s)),
                      ignore_errors=True)


def restore(ckpt_dir: str, step: int, target, *, device=None, mesh=None,
            specs: Optional[dict] = None):
    """Read ``step`` back in the shape of ``target`` (a tree whose
    structure, NamedTuples and QuantizedTensors included, defines the
    result's).  Dtypes and shapes come from the manifest, not the target.
    Leaves land on ``device`` (default: each target leaf's own device; a
    non-tensor leaf's is the CPU).  On a ``mesh`` each leaf ``specs``
    names (for this mesh) is cut to this rank's block; ranks other than 0
    only read."""
    dev = None if device is None else resolve_device(device)
    path = os.path.join(ckpt_dir, _step_name(step))
    man_path = os.path.join(path, "manifest.json")
    for _ in range(40):                 # ~2s bound on the promote window
        if os.path.isfile(man_path):
            break
        if os.path.isdir(ckpt_dir) and (mesh is None or mesh.rank == 0):
            _reclaim_stale_tmps(ckpt_dir)   # may recover a retired ckpt
        if os.path.isfile(man_path):
            break
        # a live writer mid-promote of exactly this step briefly leaves
        # only its (complete) .tmp on disk; wait for its rename to land
        if not (os.path.isdir(ckpt_dir) and any(
                (m := _TMP_RE.match(d)) and m.group(1) == _step_name(step)
                for d in os.listdir(ckpt_dir))):
            break
        time.sleep(0.05)
    if not os.path.isfile(man_path):
        raise FileNotFoundError(f"no checkpoint {_step_name(step)} "
                                f"in {ckpt_dir}")
    with open(man_path) as f:
        manifest = {e["key"]: e for e in json.load(f)["leaves"]}

    # per-leaf seek+read: one host copy of one leaf at a time
    with open(os.path.join(path, "data.bin"), "rb") as f:
        def read(key, leaf):
            entry = manifest.get(key)
            if entry is None:
                raise KeyError(f"checkpoint {_step_name(step)} has no leaf "
                               f"{key!r} (tree structure changed?)")
            f.seek(entry["offset"])
            buf = bytearray(f.read(entry["nbytes"]))
            dtype = _TORCH[entry["dtype"]]
            raw = torch.int16 if dtype == torch.bfloat16 else dtype
            t = torch.frombuffer(buf, dtype=raw) if buf else \
                torch.empty(0, dtype=raw)
            t = t.view(dtype).reshape(entry["shape"])
            if mesh is not None:
                t = cut_tensor(t, specs.get(key), mesh)
            to = dev if dev is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else None)
            return t if to is None or to.type == "cpu" else t.to(to)
        return _tree.map_with_keys(read, target)
