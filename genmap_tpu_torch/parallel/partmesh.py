"""Part x data sharded execution (port of `genmap_tpu/parallel/partmesh.py`):
index parts across the mesh's part axis, k-mer blocks across its data
axis, per-part results merged by collectives over the part lines.

A genome whose both-strand symbol count exceeds uint32 splits into index
parts (index/fmindex.py).  On a ("part", "data") mesh each rank holds ONE
part (no copy of the large rank rows on the other parts' ranks) and maps
its rows of every batch against it; the exact per-part counts add up over
the part line (parts partition the sequences and matches never cross a
sentinel), and the merged outputs are gathered over the data line, so
every rank holds the whole batch's results and takes the same host
decisions.  The same machinery as on one device runs under the mesh:

  * the unique-infix probe: each part's [B, P + 1] mass accumulator
    (`kernels.probe_mass`, last=False) is summed over the part line and a
    `probe_mass` launch decides on the sum (PartProber)
  * occupancy calibration: per-step candidate counts take the MAX over the
    part line (the shared pool schedule must hold the widest part)
  * dedup keys and CSV states: the per-part zero-error intervals and final
    states are gathered over the part line
  * locate: LF walks run on the ranks of the rows' part, against its own
    sampled SA, and reach the other ranks by a broadcast (PartLocator)

Every rank runs the pool schedule and exact prefix of the largest part
(`n_max`) and seed tables of one shared depth, so every rank issues the
same collectives in the same order with the same shapes.
"""

from __future__ import annotations

import torch

from genmap_tpu_torch import kernels
from genmap_tpu_torch.ops.rank import DeviceIndex, locate, seed_depth
from genmap_tpu_torch.parallel.mesh import Mesh, pack_rows, unpack_rows, world_size
from genmap_tpu_torch.search.engine import BlockMapper


def part_data_mesh(n_parts: int, n_devices: int | None = None) -> Mesh:
    """A ("part", "data") mesh of n_parts x (n_devices / n_parts) ranks over
    the whole world (`n_devices` defaults to the world size)."""
    n = world_size() if n_devices is None else n_devices
    if n % n_parts:
        raise ValueError(f"{n} devices not divisible by {n_parts} parts")
    return Mesh(n_parts, n // n_parts, ("part", "data"))


def stack_parts(data, mesh: Mesh, light: bool = True, device="cuda") -> dict:
    """Upload this rank's index part, with the static values every rank
    shares: the seed depth (the smallest part's), the largest part's size,
    whether every part has dimer rows and their largest flagged fraction.

    `light=False` also uploads the sampled SA values and indicator rows,
    which only locate (CSV, exclude-pseudo) reads."""
    parts = data.parts
    if mesh.shape["part"] != len(parts):
        raise ValueError(f"mesh part axis {mesh.shape['part']} != "
                         f"{len(parts)} index parts")
    t0 = min(seed_depth(int(p.n_total)) for p in parts)
    pi = mesh.coords["part"]
    return dict(
        index=DeviceIndex.from_part(data, parts[pi], light=light, device=device,
                                    seed_t0=t0),
        part=pi,
        has_dimer=all(p.dimer is not None for p in parts),
        dimer_flag_frac=max(p.dimer_flag_frac for p in parts),
        seed_t0=t0,
        n_max=max(int(p.n_total) for p in parts),
        n_parts=len(parts),
        light=light,
    )


def merge_parts(mesh: Mesh, out: dict, cap: int) -> dict:
    """Merge one part's outputs of this rank's rows over the part line.

    hits widen to int32 and SUM (per-part counts cannot wrap), then clamp
    at `cap`; exact_size / exact_size_total SUM in int32, which wraps mod
    2^32 as JAX's uint32 psum does; overflow flags OR (a SUM tested > 0):
    one all_reduce.  occ / surv take the MAX (a second one).  exact_flo,
    exact_size_total and the states, where present, are gathered over the
    part line into [rows, n_parts, ...] as *_parts."""
    sums = {k: out[k] for k in ("hits", "overflow", "overflow_cap", "exact_size",
                                "exact_size_total") if k in out}
    buf, spec = pack_rows(sums)
    res = unpack_rows(mesh.all_reduce(buf, "part"), spec, cast=False)
    res["hits"] = res["hits"].clamp(max=cap).to(torch.uint16)
    res["overflow"] = res["overflow"] > 0
    res["overflow_cap"] = res["overflow_cap"] > 0
    if "occ" in out:
        buf, spec = pack_rows({"occ": out["occ"], "surv": out["surv"]})
        res.update(unpack_rows(mesh.all_reduce(buf, "part", "max"), spec))
    if "exact_flo" in out:
        per = {"exact_flo_parts": out["exact_flo"],
               "exact_size_total_parts": out["exact_size_total"]}
        if "states" in out:
            per["states_parts"] = out["states"]
        buf, spec = pack_rows(per)
        g = mesh.all_gather(buf, "part")  # [n_parts * rows, W], part-major
        res.update(unpack_rows(
            g.view(mesh.shape["part"], -1, g.shape[-1]).transpose(0, 1), spec))
    return res


class PartMapper(BlockMapper):
    """Part x data sharded block mapper (make_part_mapper): this rank's
    rows against its part, per-part outputs merged over the part line
    (`merge_parts`), all gathered over the data line (BlockMapper's mesh
    call).  Returns, on every
    rank, hits [B, J] uint16, overflow and overflow_cap [B] bool and, as
    asked, occ / surv (MAX over parts), exact_size / exact_size_total (SUM)
    and exact_flo_parts / exact_size_total_parts [B, n_parts, J] and
    states_parts (each [B, n_parts, J, Fe]).  `with_states` implies the
    per-part exact outputs (the CSV location lists read both)."""

    def __init__(self, stacked: dict, dtext, mesh: Mesh, *, K: int, errors: int,
                 overlap: int, J: int, B: int, tier, cap: int, rev_compl: bool,
                 pools=None, with_occ: bool = False, with_exact_parts: bool = False,
                 with_states: bool = False):
        if tier.dimer and not stacked["has_dimer"]:
            raise ValueError("dimer tier on a part without dimer rows")
        super().__init__(stacked["index"], dtext, K=K, errors=errors, overlap=overlap,
                         J=J, B=B, tier=tier, cap=cap, rev_compl=rev_compl,
                         with_exact=with_exact_parts or with_states,
                         with_states=with_states, pools=pools, with_occ=with_occ,
                         n_static=stacked["n_max"], mesh=mesh)

    def _run(self, starts, cnt, limit, acc=None, last: bool = True):
        return merge_parts(self.mesh, super()._run(starts, cnt, limit), self.cap)


class PartProber(BlockMapper):
    """The unique-infix probe under the part x data mesh
    (make_part_prober): this rank's rows scan its part, the [rows, P + 1]
    accumulator of per-plan masses and flags is summed over the part line
    (the soundness argument survives the sum: the self-match lives in
    exactly one part, any other part's surviving row is a genuine second
    occurrence), a `probe_mass` launch decides on the sum, and the skip
    bytes are gathered over the data line: dict(skip [B] uint8)."""

    def __init__(self, stacked: dict, dtext, mesh: Mesh, *, K: int, errors: int,
                 overlap: int, J: int, B: int, tier, cap: int, rev_compl: bool,
                 probe_cut=None):
        if tier.dimer and not stacked["has_dimer"]:
            raise ValueError("dimer tier on a part without dimer rows")
        super().__init__(stacked["index"], dtext, K=K, errors=errors, overlap=overlap,
                         J=J, B=B, tier=tier, cap=cap, rev_compl=rev_compl, probe=True,
                         probe_cut=probe_cut, n_static=stacked["n_max"], mesh=mesh)

    def _run(self, starts, cnt, limit, acc=None, last: bool = True):
        acc = super()._run(starts, cnt, limit, last=False)["acc"]
        skip = kernels.probe_mass(None, None, None, None, self.thr, False,
                                  acc=self.mesh.all_reduce(acc, "part"))
        return {"skip": skip}


class PartLocator:
    """locate() on the ranks of each part against their own sampled SA
    (make_part_locator): the rows of part pi are walked by the rank of
    part pi on this rank's part line and broadcast to the line, so every
    rank returns the same part-local (i1, i2)."""

    def __init__(self, stacked: dict, mesh: Mesh):
        if stacked["light"]:
            raise ValueError("the locator needs stack_parts(light=False)")
        self.index, self.mesh, self.part = stacked["index"], mesh, stacked["part"]

    def __call__(self, pi: int, pos: torch.Tensor, valid: torch.Tensor):
        if pi == self.part:
            i1, i2 = locate(self.index, pos, valid)
            both = torch.stack([i1, i2])
        else:
            both = torch.empty((2, pos.shape[0]), dtype=torch.int32, device=pos.device)
        both = self.mesh.broadcast(both, "part", pi)
        return both[0], both[1]
