"""Rank plumbing for the grid-sharded layer (torch.distributed).

The framework's long axis is the real-space FFT grid (ngrids ~ 1e4-1e6
points): aoR and every grid-sized tensor is split into contiguous x-slabs,
one per rank. The AO/IP axes are small and stay replicated. The JAX package
drives every device from one process with ``shard_map``; here each rank is
a process, and this module gives it

  * :class:`RankGroup`, the handle the sharded functions take: the process
    group, this rank, the world size, and the bytes each kind of collective
    moved (``RankGroup.bytes``);
  * :func:`slab_bounds` / :func:`slab_rows`, the x-slab of a rank;
  * :func:`init_group`, which joins a process group at a
    ``torch.distributed.FileStore`` (no TCP port to collide on), and
    :func:`launch`, which starts ``world`` ranks with
    ``torch.multiprocessing`` and returns their results.

The backend is the caller's: ``nccl`` by default for CUDA, ``gloo`` for the
CPU or when asked for by name. Nothing here switches backend or device; a
collective the backend cannot take raises. Complex tensors travel as
``torch.view_as_real`` float pairs.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist

from pyscf_isdf_tpu_torch.device import resolve_device

_KINDS = ("all_to_all", "all_reduce", "all_gather")
# seconds launch waits for its ranks before it stops them
LAUNCH_TIMEOUT = 900.0


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class RankGroup:
    """One rank's view of a process group.

    ``group`` is the ``torch.distributed`` group (None: the default group),
    ``rank`` and ``world`` this rank and the group's size, ``device`` where
    this rank's tensors live. ``bytes`` counts the bytes this rank sent
    through each kind of collective.
    """

    def __init__(self, group, rank: int, world: int, device, backend: str):
        self.group = group
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.bytes = dict.fromkeys(_KINDS, 0)

    # ---------------------------------------------------------- collectives

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks (a new tensor; complex as real pairs)."""
        out = t.clone().contiguous()
        flat = torch.view_as_real(out) if out.is_complex() else out
        self.bytes["all_reduce"] += flat.numel() * flat.element_size()
        dist.all_reduce(flat, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t`` in rank order."""
        t = t.contiguous()
        src = torch.view_as_real(t) if t.is_complex() else t
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        self.bytes["all_gather"] += src.numel() * src.element_size()
        dist.all_gather_into_tensor(out, src, group=self.group)
        out = out.reshape((self.world,) + tuple(src.shape))
        return torch.view_as_complex(out) if t.is_complex() else out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (world, ...): chunk r goes to rank r; returns (world, ...)
        with chunk r received from rank r."""
        t = t.contiguous()
        src = torch.view_as_real(t) if t.is_complex() else t
        out = torch.empty_like(src)
        self.bytes["all_to_all"] += src.numel() * src.element_size()
        dist.all_to_all_single(out, src, group=self.group)
        return torch.view_as_complex(out) if t.is_complex() else out

    # ------------------------------------------------------------ lifetime

    def close(self):
        """Leave the process group (destroys the default group)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def grid_mesh(device=None, group=None) -> RankGroup:
    """The handle of an initialised process group (default: the default
    group) for tensors on ``device`` (default: CUDA; raises without it, pass
    ``device="cpu"`` for CPU tensors)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: use init_group or launch")
    return RankGroup(group, dist.get_rank(group), dist.get_world_size(group),
                     resolve_device(device), dist.get_backend(group))


def init_group(store_path: str, rank: int, world: int, device=None,
               backend: str | None = None) -> RankGroup:
    """Join the default process group at the FileStore ``store_path``
    (a file in a fresh directory, shared by the ``world`` ranks), for
    tensors on ``device`` (default: CUDA; raises without it)."""
    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu'")
    backend = backend or default_backend(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl takes CUDA tensors, not {device} ones: pass "
                         "backend='gloo'")
    store = dist.FileStore(store_path, world)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device if device.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    return RankGroup(None, rank, world, device, backend)


def slab_bounds(mesh3, rank: int, world: int) -> tuple:
    """[x0, x1): the x-planes of ``rank``'s slab. Both nx and ny must divide
    by ``world`` (the y-split of the distributed FFT's transpose)."""
    nx, ny, _ = mesh3
    if nx % world or ny % world:
        raise ValueError(f"mesh {tuple(mesh3)}: nx and ny must divide by the "
                         f"world size {world}")
    nxl = nx // world
    return rank * nxl, (rank + 1) * nxl


def slab_rows(mesh3, rank: int, world: int) -> slice:
    """The rows of a flat (C order, x slowest) grid array in ``rank``'s slab."""
    x0, x1 = slab_bounds(mesh3, rank, world)
    plane = mesh3[1] * mesh3[2]
    return slice(x0 * plane, x1 * plane)


def _rank_main(job_path, rank, world, store_path, device, backend, results):
    torch.set_num_threads(1)
    try:
        with open(job_path, "rb") as f:      # written by launch, below
            fn, args = pickle.load(f)
        with init_group(store_path, rank, world, device, backend) as grp:
            out = fn(grp, *args)
        results.put((rank, True, out))
    except BaseException:      # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world: int, device=None, backend: str | None = None,
           args=()) -> list:
    """Run ``fn(group, *args)`` on ``world`` new rank processes; return the
    results in rank order.

    ``fn`` must be importable (a module-level function) and its arguments
    and result picklable. Each rank joins a process group on ``device``
    (every rank the same device: CUDA by default, raising without it, or
    ``"cpu"``) with ``backend`` (default :func:`default_backend`) at a
    FileStore in a temporary directory, and runs on one intra-op thread. A
    rank's exception is raised here with its traceback; every rank is
    stopped before return.

    The ranks are forked from a ``forkserver`` process (started on the
    first call, ended with the caller) that has imported torch, this
    package and the first call's ``fn`` module once, so a rank starts
    without importing them again; the server holds no thread and no CUDA
    context when it forks.
    """
    import torch.multiprocessing as mp

    device = resolve_device(device)
    ctx = mp.get_context("forkserver")
    preload = ["torch", "torch.distributed", __name__]
    if fn.__module__ != "__main__":      # the server imports the main script
        preload.append(fn.__module__)
    ctx.set_forkserver_preload(preload)
    results = ctx.Queue()
    out, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        # the job goes through a file: a start blocks the parent while the
        # child imports, once its pickled arguments outgrow a pipe
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(job, r, world, store, str(device), backend,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            waited = 0.0
            while len(out) + len(errors) < world:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    waited += 1.0
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead or waited > LAUNCH_TIMEOUT:
                        errors.append(
                            f"rank process exit codes "
                            f"{[p.exitcode for p in procs]} after {waited:.0f} s")
                        break
                    continue
                if not ok:         # the other ranks may wait on it forever
                    errors.append(f"rank {rank}:\n{val}")
                    break
                out[rank] = val
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errors:
        raise RuntimeError("launch failed:\n" + "\n".join(errors))
    return [out[r] for r in range(world)]
