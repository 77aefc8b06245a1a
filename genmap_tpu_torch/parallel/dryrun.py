"""One real multi-rank map on small shapes (port of `dryrun_multichip`,
`__graft_entry__.py`): the same workload, asserts and printed lines.

For an even rank count a 2-part index maps on a part(2) x data(n/2) mesh
(each rank holds one part, per-part counts merge over the part axis) with
the probe, tier escalation and the dimer rows; an odd count maps on a
data(n) mesh with the index replicated.  The second leg runs the probe on
data(n).  Run it on every rank:

    python -m genmap_tpu_torch.parallel.dryrun N [--device cpu|cuda]
        (spawns N local ranks: nccl on cuda, gloo on cpu)
    GENMAP_DIST_AUTO=1 torchrun --nproc-per-node N -m genmap_tpu_torch.parallel.dryrun N
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch.distributed as dist


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The map on this rank of an n_devices world; returns its stats and
    the lines it prints (on rank 0)."""
    from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
    from genmap_tpu_torch.index.build import build_index
    from genmap_tpu_torch.io.fasta import FastaFile
    from genmap_tpu_torch.parallel.mesh import data_mesh
    from genmap_tpu_torch.parallel.partmesh import part_data_mesh

    if dist.get_world_size() != n_devices:
        raise ValueError(f"need a world of {n_devices} ranks, have "
                         f"{dist.get_world_size()}")
    lines = []

    def say(line):
        lines.append(line)
        if dist.get_rank() == 0:
            print(line, flush=True)

    # a genome large enough for the unique-infix probe (>= 2^15 k-mers)
    # with a planted family of mutated repeat copies, so that some blocks
    # escape the probe and escalate through the tiers
    K, errors = 40, 1
    params = SearchParams(length=K, overlap=20, rev_compl=True)  # J = 21

    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, size=300, dtype=np.uint8)
    n_half = 50_000

    def seq_with_repeats():
        s = rng.integers(0, 4, size=n_half, dtype=np.uint8)
        for i in range(8):  # mutated family copies -> wide frontiers
            c = core.copy()
            idx = rng.integers(0, len(c), size=4)
            c[idx] = rng.integers(0, 4, size=4)
            p = 4_000 * i + 500
            s[p : p + len(c)] = c
        return s

    ff = FastaFile(name="synthetic.fa")
    ff.ids = ["chr1", "chr2"]
    ff.seqs = [seq_with_repeats() for _ in range(2)]

    if n_devices >= 2 and n_devices % 2 == 0:
        # force a 2-part split (both-strand symbols per part <= limit)
        data = build_index([ff], sampling=10, max_part_symbols=110_000)
        assert len(data.parts) == 2
        mesh = part_data_mesh(2, n_devices)
        eng = MappabilityEngine(data, batch_blocks=512, mesh=mesh, dedup=False,
                                device=device)
        assert eng.part_sharded
        assert eng.stacked["has_dimer"], "dimer rows missing on the mesh"
        mode = f"part(2) x data({n_devices // 2})"
    else:
        data = build_index([ff], sampling=10)
        mesh = data_mesh(n_devices)
        eng = MappabilityEngine(data, batch_blocks=512, mesh=mesh, dedup=False,
                                device=device)
        mode = f"data({n_devices})"
    res = eng.compute_file(eng.layouts[0], params, errors=errors, cap=65535)
    n_tot = 2 * n_half
    # every k-mer matches at least itself (k-mers spanning the chr1/chr2
    # boundary are zeroed by reset_limits)
    assert res.c.shape == (n_tot,)
    c = res.c.copy()
    assert (c[: n_half - K + 1] >= 1).all()
    assert (c[n_half : n_tot - K + 1] >= 1).all()
    assert (c >= 8).any(), "repeat family not found"
    tiers_hit = eng.stats["max_tier"]
    assert tiers_hit > 0, "no tier escalation exercised"
    assert eng.stats["probe_skipped"] > 0, "probe did not engage"
    say(f"dryrun_multichip({n_devices}): ok [{mode}], mean freq "
        f"{res.c[:100].mean():.2f}, tiers exercised 0..{tiers_hit}, "
        f"probe_skipped {eng.stats['probe_skipped']}, "
        f"ovf blocks {eng.stats['overflow_blocks']}")
    stats = dict(lines=lines, mode=mode, max_tier=tiers_hit,
                 probe_skipped=eng.stats["probe_skipped"],
                 overflow_blocks=eng.stats["overflow_blocks"],
                 tier_blocks=dict(eng.stats["tier_blocks"]),
                 collectives=mesh.collectives, wire_bytes=mesh.wire_bytes)

    # second leg: the unique-infix probe on the data mesh
    ff2 = FastaFile(name="probe.fa")
    ff2.ids = ["chrP"]
    ff2.seqs = [rng.integers(0, 4, size=90_000, dtype=np.uint8)]
    data2 = build_index([ff2], sampling=10)
    mesh2 = data_mesh(n_devices)
    eng2 = MappabilityEngine(data2, batch_blocks=512, mesh=mesh2, dedup=False,
                             device=device)
    K2 = 40
    params2 = SearchParams(length=K2, overlap=20, rev_compl=True)
    res2 = eng2.compute_file(eng2.layouts[0], params2, errors=1, cap=65535)
    assert (res2.c[: 90_000 - K2] >= 1).all()
    assert eng2.stats["probe_skipped"] > 0, "probe did not engage"
    say(f"dryrun_multichip({n_devices}): probe leg ok "
        f"[probe_skipped {eng2.stats['probe_skipped']} blocks]")
    stats["probe_leg_skipped"] = eng2.stats["probe_skipped"]
    return stats


def main(argv=None) -> int:
    from genmap_tpu_torch.parallel.dist import launch_local, maybe_initialize

    p = argparse.ArgumentParser(prog="python -m genmap_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks (one per device)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if maybe_initialize(args.device):  # under torchrun / GENMAP_DIST_*
        dryrun_multichip(args.n, args.device)
        dist.destroy_process_group()
        return 0
    if args.device != "cpu":
        from genmap_tpu_torch import kernels

        kernels.build()  # once, before the ranks start
    with tempfile.TemporaryDirectory(prefix="genmap_dryrun_") as d:
        launch_local(args.n, dryrun_multichip, args.n, args.device,
                     device=args.device, store_dir=d)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
