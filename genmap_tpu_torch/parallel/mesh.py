"""Rank meshes and their collectives (port of `genmap_tpu/parallel/mesh.py`).

Every process of the torch.distributed world is one position of a grid:
axes ("data",) for a data mesh — the index replicated, the blocks of every
batch split over the ranks — or ("part", "data") for a part x data mesh,
where rank r holds index part r // D and rows r % D of every batch (D the
data size, the JAX package's device order).  The mesh holds one process
group per data line (the ranks of one part) and, on a part mesh, one per
part line (one rank of every part at the same data coordinate).

Collectives go through the mesh so that every one is counted (calls and
bytes in and out, the HBM traffic a single card would see).  NCCL takes
CUDA tensors as they are; under gloo a CUDA tensor is copied to the host
for the collective and back (gloo's support of CUDA tensors differs
between collectives), and never under NCCL.  The mesh never switches
backend.  NCCL has no 16-bit integer type, so per-block outputs travel as
int32 rows (`pack_rows`): bool, uint8, uint16 and int32 values widen to
int32 without loss and are cast back on arrival.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """This rank's place on an n_parts x n_data grid of the world's ranks.

    `axis_names` is ("data",) (n_parts = 1) or ("part", "data"); `shape`
    maps each axis to its size and `coords` to this rank's coordinate.
    Creating a mesh is collective: every rank creates every group, in the
    same order."""

    def __init__(self, n_parts: int, n_data: int, axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialized: start the ranks with "
                "genmap_tpu_torch.parallel.dist.launch_local, torchrun or the "
                "GENMAP_DIST_* variables (maybe_initialize)"
            )
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_parts * n_data != world:
            raise ValueError(f"a {n_parts} x {n_data} mesh needs {n_parts * n_data} "
                             f"ranks; the world has {world}")
        self.axis_names = axis_names
        self.shape = {"part": n_parts, "data": n_data}
        if "part" not in axis_names:
            del self.shape["part"]
        self.n_parts, self.n_data = n_parts, n_data
        self.coords = {"part": rank // n_data, "data": rank % n_data}
        self.backend = dist.get_backend()
        self.groups = {}
        for pi in range(n_parts):
            g = dist.new_group([pi * n_data + d for d in range(n_data)])
            if pi == self.coords["part"]:
                self.groups["data"] = g
        if "part" in axis_names:
            for di in range(n_data):
                g = dist.new_group([pi * n_data + di for pi in range(n_parts)])
                if di == self.coords["data"]:
                    self.groups["part"] = g
        self.collectives = 0
        self.wire_bytes = 0

    def rows(self, B: int) -> slice:
        """This rank's rows of a batch of B blocks (B divisible by the data
        size)."""
        if B % self.n_data:
            raise ValueError(f"batch of {B} blocks does not split over "
                             f"{self.n_data} data ranks")
        b = B // self.n_data
        d = self.coords["data"]
        return slice(d * b, (d + 1) * b)

    # -- collectives -------------------------------------------------------

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def _count(self, nbytes: int) -> None:
        self.collectives += 1
        self.wire_bytes += nbytes

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """SUM or MAX of `t` over the ranks of this rank's `axis` line.
        Integer sums wrap in two's complement (int32 holding uint32 wraps
        mod 2^32).  `t` may be overwritten."""
        w = self._stage(t)
        dist.all_reduce(w, op=_OPS[op], group=self.groups[axis])
        self._count(2 * t.numel() * t.element_size())
        return w.to(t.device) if w is not t else w

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """[n * rows, ...]: the line's tensors concatenated in coordinate
        order (equal shapes on every rank)."""
        w = self._stage(t)
        n = self.shape[axis]
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w.contiguous(), group=self.groups[axis])
        self._count((1 + n) * t.numel() * t.element_size())
        return torch.cat(parts).to(t.device)

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """`t` of the rank at coordinate `src` of this rank's `axis` line,
        on every rank of the line."""
        coords = dict(self.coords, **{axis: src})
        w = self._stage(t)
        dist.broadcast(w, src=coords["part"] * self.n_data + coords["data"],
                       group=self.groups[axis])
        self._count(2 * t.numel() * t.element_size())
        return w.to(t.device) if w is not t else w


def world_size() -> int:
    """Ranks of the torch.distributed world (1 before it is initialized,
    so that a mesh of it raises its own error)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def data_mesh(n_devices: int | None = None) -> Mesh:
    """A ("data",) mesh over the whole world (`n_devices`, when given, must
    be the world size: one rank per device)."""
    return Mesh(1, world_size() if n_devices is None else n_devices, ("data",))


def replicate_index(data, light: bool, device) -> list:
    """Every index part uploaded to this rank's device (each rank of a data
    mesh holds its own copy; one device holds them alone)."""
    from genmap_tpu_torch.ops.rank import DeviceIndex

    return [DeviceIndex.from_part(data, p, light=light, device=device)
            for p in data.parts]


# ---------------------------------------------------------------------------
# per-block outputs as int32 rows
# ---------------------------------------------------------------------------


def pack_rows(out: dict):
    """One int32 tensor [rows, W] holding every tensor of `out` (values are
    tensors or tuples of tensors whose first axis is the block), and the
    spec that `unpack_rows` reads."""
    cols, spec = [], []
    for key, val in out.items():
        for i, x in enumerate(val if isinstance(val, tuple) else (val,)):
            flat = x.reshape(x.shape[0], -1)
            spec.append((key, i if isinstance(val, tuple) else None, x.dtype,
                         tuple(x.shape[1:]), flat.shape[1]))
            cols.append(flat.to(torch.int32))
    return torch.cat(cols, dim=1), spec


def unpack_rows(buf: torch.Tensor, spec, cast: bool = True) -> dict:
    """Inverse of `pack_rows` for buf [rows, *lead, W]: each tensor comes
    back as [rows, *lead, *shape], cast to its dtype (or left int32)."""
    out: dict = {}
    lead, c = buf.shape[:-1], 0
    for key, i, dtype, shape, w in spec:
        x = buf[..., c : c + w].reshape(*lead, *shape)
        c += w
        if cast:
            x = x != 0 if dtype == torch.bool else x.to(dtype)
        if i is None:
            out[key] = x
        else:
            out[key] = out.get(key, ()) + (x,)
    return out
