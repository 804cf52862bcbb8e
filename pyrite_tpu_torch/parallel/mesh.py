"""Sample-axis parallelism across devices: one process (a rank) per device
over ``torch.distributed`` (the PyTorch port of pyrite_tpu.parallel.mesh).

The JAX package replicates the scene to every device of a mesh, shards the
sample axis, keeps one partial film per device and sums the films once. The
port does the same with processes: each rank builds the scene on its own
device, renders its own share of the global sample indices into a film of
its own, and the films are merged by one all-reduce.

The JAX package gives each device its own RNG key (its ``step_keys``, a
``fold_in`` of the step). The port has no counterpart: its draws are keyed by
(pixel, global sample, bounce, purpose) (rng.py), so the ranks, which
together render exactly the samples [start, total), draw what one process
would, and the merged film is the one-process film up to the order of float
adds.

A ``Mesh`` of one rank (``local_mesh``) makes every collective here a no-op,
so the renderers' one-process ``render`` is their ``render_sharded`` on it.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# How long a collective may wait for the other ranks: one round of a rank's
# work (a regeneration launch, a sample) at the most, so generous.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
# Seconds the ranks of a failed or late world have to exit after a signal.
_GRACE = 2.0

# The film merges of this process since a caller last zeroed them: calls,
# bytes reduced and seconds spent (the all-reduce and its wait).
merges = {"calls": 0, "bytes": 0, "seconds": 0.0}


@dataclass
class Mesh:
    """One rank of a render: its ``rank`` of ``size``, its ``device``, the
    process group that carries device tensors (``group``: the films, the
    regeneration lane counts) and a gloo group for small host arrays
    (``host_group``: the continue flag, the pools' fill). One group serves
    both in an all-gloo world; a mesh of one rank has neither."""

    rank: int
    size: int
    device: torch.device
    group: object = None
    host_group: object = None


def local_mesh(device) -> Mesh:
    """The mesh of a process that renders alone on ``device``."""
    return Mesh(0, 1, torch.device(device))


def make_mesh(rank: int, size: int, device, backend: str, store, timeout=DEFAULT_TIMEOUT) -> Mesh:
    """Join the world of ``size`` ranks as ``rank`` on ``device`` through
    ``store`` (a torch.distributed store). ``backend`` is the caller's: nccl
    for one rank per card, gloo on the CPU and for ranks that share a card
    (NCCL refuses two ranks on one device). Nothing picks another backend
    when this one fails."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, store=store, rank=rank, world_size=size,
                            timeout=timeout)
    world = dist.group.WORLD
    host = world if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    return Mesh(rank, size, device, world, host)


def device_film_buffers(film, mesh: Mesh, resume=None):
    """The rank's partial film (acc, wt) [H, W, B] on its device: rank 0's
    starts from the checkpoint ``resume``'s film, the others' at zero (the
    JAX rule), so the merged film holds the checkpoint once."""
    acc, wt = film.new_buffers(mesh.device)
    if resume is not None and mesh.rank == 0:
        acc.copy_(torch.as_tensor(np.asarray(resume["acc"], np.float32)).view(acc.shape))
        wt.copy_(torch.as_tensor(np.asarray(resume["wt"], np.float32)).view(wt.shape))
    return acc, wt


def merge_films(acc, wt, mesh: Mesh):
    """The film summed over the ranks: one all_reduce(SUM) of a buffer
    holding a copy of acc and wt, returned as two views of it. A rank's own
    film stays as it is, so a merge for a preview does not count it twice at
    the next merge. On a mesh of one rank: acc and wt themselves."""
    if mesh.size == 1:
        return acc, wt
    started = time.perf_counter()
    flat = torch.cat([acc.reshape(-1), wt.reshape(-1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    merges["calls"] += 1
    merges["bytes"] += flat.numel() * flat.element_size()
    merges["seconds"] += time.perf_counter() - started
    n = acc.numel()
    return flat[:n].view(acc.shape), flat[n:].view(wt.shape)


def device_sum(tensor, mesh: Mesh):
    """A tensor on the rank's device summed over the ranks, in place (the
    films' group: NVLink under NCCL); returned."""
    if mesh.size > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor


def host_sum(values, mesh: Mesh) -> np.ndarray:
    """An int64 host array summed over the ranks (the host group)."""
    out = np.array(values, np.int64)
    if mesh.size > 1:
        t = torch.from_numpy(out)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.host_group)
    return out


def any_left(left: bool, mesh: Mesh) -> bool:
    """Whether any rank has work left: every rank calls it once a round,
    which keeps ranks whose shares end at different rounds in step."""
    return bool(host_sum([int(left)], mesh)[0])


def rank_share(group: int, mesh: Mesh):
    """Rank ``mesh.rank``'s contiguous slice [lo, hi) of a group of
    ``group`` items split as evenly as the count allows."""
    return group * mesh.rank // mesh.size, group * (mesh.rank + 1) // mesh.size


def rank_samples(mesh: Mesh, start: int, total: int, per_rank: int = 1):
    """The rounds of a sharded render of samples [start, total): yields
    (first, count, done) per round, the rank's share first .. first + count
    - 1 of the round's group of up to size x ``per_rank`` samples (count 0
    where the group is smaller than the mesh) and the samples done after the
    round. Every rank goes through the same rounds; after each, the ranks'
    samples together are a prefix of every pixel's samples."""
    done = start
    while any_left(done < total, mesh):
        group = min(mesh.size * per_rank, total - done)
        lo, hi = rank_share(group, mesh)
        yield done + lo, hi - lo, done + group
        done += group


def run_sharded(step, mesh: Mesh, acc, wt, start: int, total: int, per_rank: int = 1,
                progress=None):
    """The generic sharded loop (rank_samples): step(acc, wt, first, count)
    renders samples first .. first + count - 1 into the rank's film and
    returns it; a rank whose share of a round is empty launches nothing.
    With ``progress``, the films are merged after every round and rank 0
    alone calls progress(done, acc, wt) with the merged film. Returns the
    merged film."""
    for first, count, done in rank_samples(mesh, start, total, per_rank):
        if count:
            acc, wt = step(acc, wt, first, count)
        if progress is not None:
            merged = merge_films(acc, wt, mesh)
            if mesh.rank == 0:
                progress(done, *merged)
    return merge_films(acc, wt, mesh)


def merge_parts(mesh: Mesh, parts):
    """A rank entry for spawn: rank r's partial film is ``parts[r]`` (numpy
    acc, wt); returns the merged film as numpy arrays."""
    acc, wt = (torch.as_tensor(np.asarray(a, np.float32), device=mesh.device)
               for a in parts[mesh.rank])
    merged = merge_films(acc, wt, mesh)
    return tuple(m.cpu().numpy() for m in merged)


def _rank_main(rank, fn, devices, backend, directory, args, timeout):
    store = dist.FileStore(os.path.join(directory, "store"), len(devices))
    mesh = make_mesh(rank, len(devices), devices[rank], backend, store, timeout)
    result = fn(mesh, *args)
    path = os.path.join(directory, f"rank{rank}.pt")
    torch.save(result, path + ".tmp")
    os.replace(path + ".tmp", path)
    dist.destroy_process_group()


def spawn(fn, devices, backend: str, args=(), timeout=None):
    """Run fn(mesh, *args) in one process per entry of ``devices`` (rank r
    on devices[r]) over ``backend``; returns the ranks' return values, by
    rank. ``fn`` must be importable by its module (a function of this
    package) and ``args`` picklable.

    The rendezvous is a FileStore in a fresh temporary directory (no TCP
    port). The kernel library is built here first when a device is CUDA
    (ctypes only, no CUDA context), so that the ranks do not each run nvcc.
    ``timeout`` seconds (None: none) is the deadline of the whole world.
    Each collective waits DEFAULT_TIMEOUT longer than that, so that a world
    that is late ends at its deadline here and not at a rank's collective.
    Raises when a rank raises or exits, and TimeoutError when the world
    misses the deadline, also where a rank failed after it; every rank is
    stopped then."""
    from .. import _build

    if any(torch.device(d).type == "cuda" for d in devices):
        _build.load()
    collective = DEFAULT_TIMEOUT + datetime.timedelta(seconds=timeout or 0)
    directory = tempfile.mkdtemp(prefix="pyrite_mesh_")
    try:
        context = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, [str(d) for d in devices], backend, directory, tuple(args),
                              collective),
            nprocs=len(devices), join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        late = TimeoutError(f"{len(devices)} ranks missed their {timeout} s deadline")
        try:
            while True:
                left = 1.0 if deadline is None else min(1.0, deadline - time.monotonic())
                if left <= 0:
                    raise late
                try:
                    if context.join(timeout=left, grace_period=_GRACE):
                        break
                except (torch.multiprocessing.ProcessRaisedException,
                        torch.multiprocessing.ProcessExitedException) as error:
                    if deadline is not None and time.monotonic() > deadline:
                        raise late from error
                    raise
        finally:
            _stop(context.processes)
        return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _stop(processes):
    """Terminate the ranks still alive, then kill those alive after _GRACE
    seconds in all."""
    for process in processes:
        if process.is_alive():
            process.terminate()
    end = time.monotonic() + _GRACE
    for process in processes:
        process.join(max(0.0, end - time.monotonic()))
    for process in processes:
        if process.is_alive():
            process.kill()
            process.join()
