"""Multi-process execution (port of `genmap_tpu/parallel/dist.py`).

The map scales out as SPMD over processes, one per GPU:

  * every process runs the same host orchestration (deterministic block
    decomposition), holds the index parts its mesh position needs, and
    runs its own rows of every batch (`put_global_batch`)
  * per-part results merge by collectives over the mesh's part lines
    (parallel/partmesh.py) and every output is all-gathered over the data
    line (`fetch`), so each process holds the identical frequency vector;
    rank 0 writes the output files
  * NCCL carries CUDA tensors, gloo the CPU path (or CUDA tensors through
    the host, when asked for)

Start the processes with torchrun and GENMAP_DIST_AUTO=1 (torchrun's
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK), or export
GENMAP_DIST_COORDINATOR=host:port, GENMAP_DIST_NPROCS and
GENMAP_DIST_PROC_ID before launching each process (the CLI calls
`maybe_initialize()` on start-up); on one machine `launch_local` spawns
the ranks itself.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
import uuid

import torch
import torch.distributed as dist


def _bind(device, local_rank: int) -> str:
    """The backend for `device` (nccl for cuda, gloo for cpu); a cuda rank
    binds cuda:(local_rank % device_count)."""
    from genmap_tpu_torch.ops.rank import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        return "nccl"
    return "gloo"


def maybe_initialize(device="cuda", backend: str | None = None) -> bool:
    """Initialize torch.distributed from the environment (idempotent).

    `device` None is a host-only process (`index`): its group is gloo and
    no device is bound.  Returns False and does nothing when no
    GENMAP_DIST_* variable is set."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("GENMAP_DIST_COORDINATOR")
    if coord:
        rank = int(os.environ["GENMAP_DIST_PROC_ID"])
        world = int(os.environ["GENMAP_DIST_NPROCS"])
        init = f"tcp://{coord}"
        local = int(os.environ.get("LOCAL_RANK", rank))
    elif os.environ.get("GENMAP_DIST_AUTO"):
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init = "env://"
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        return False
    chosen = "gloo" if device is None else _bind(device, local)
    dist.init_process_group(backend or chosen, init_method=init, rank=rank,
                            world_size=world)
    return True


def is_writer() -> bool:
    """Whether this process writes output files (rank 0, or no world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def put_global_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch tensor that every rank holds whole."""
    return t[mesh.rows(t.shape[0])]


def fetch(out: dict, mesh) -> dict:
    """Every output of this rank's rows gathered over the data line: every
    rank then holds the whole batch's outputs (one all_gather of int32
    rows)."""
    from genmap_tpu_torch.parallel.mesh import pack_rows, unpack_rows

    buf, spec = pack_rows(out)
    return unpack_rows(mesh.all_gather(buf, "data"), spec)


# ---------------------------------------------------------------------------
# ranks on one machine
# ---------------------------------------------------------------------------


def _rank_main(rank, world, fn, args, device, backend, store_path, timeout_s, q):
    try:
        torch.set_num_threads(1)
        chosen = _bind(device, rank)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend or chosen, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            res = fn(*args)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, res))
    except BaseException:  # reported to the parent, which raises
        q.put((rank, False, traceback.format_exc()))


def launch_local(world: int, fn, *args, device="cuda", backend: str | None = None,
                 store_dir: str, timeout_s: float = 600.0) -> list:
    """Run fn(*args) on `world` ranks spawned on this machine and return
    each rank's result, in rank order.

    Ranks start with the `spawn` method (so `fn` and `args` must pickle),
    rendezvous through a FileStore in `store_dir` (no TCP port), use
    torch.set_num_threads(1), bind cuda:(rank % device_count) when `device`
    is cuda, and take nccl for cuda and gloo for cpu unless `backend` says
    otherwise (gloo on cuda stages every collective through the host).  A
    rank that raises, or a world that has not finished after `timeout_s`,
    ends every rank and raises here."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store_path = os.path.join(store_dir, f"genmap-store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn, args, device, backend, store_path,
                               timeout_s, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} "
                                   f"did not finish within {timeout_s} s")
            try:
                rank, ok, res = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                continue
            if ok:
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
                break  # the other ranks may wait forever in a collective
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30 if not errors and len(results) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        q.close()
        if os.path.exists(store_path):
            os.remove(store_path)
    return [results[r] for r in range(world)]
