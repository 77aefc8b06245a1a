"""genmap-tpu-torch command line: `index` and `map` subcommands.

The flag surface mirrors the JAX package's `genmap-tpu` (and the reference
CLI, GenMap src/indexing.hpp:277-345, mappability.hpp:409-545); `map` adds
`--device` (default cuda).
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    from genmap_tpu_torch.hostmem import retain_heap

    retain_heap()
    argv = list(sys.argv[1:] if argv is None else argv)
    from genmap_tpu_torch.parallel.dist import maybe_initialize

    # a torch.distributed world from GENMAP_DIST_* (one process per GPU):
    # `map` binds its --device (nccl for cuda, gloo for cpu); `index` is
    # host work, so its world is gloo and binds no device
    device = None
    if argv and argv[0] == "map":
        dev = argparse.ArgumentParser(add_help=False)
        dev.add_argument("--device", default="cuda")
        device = dev.parse_known_args(argv[1:])[0].device
    maybe_initialize(device)
    if argv and argv[0] == "--version":
        from genmap_tpu_torch import __version__

        print(f"genmap-tpu-torch {__version__} — (k,e)-mappability on PyTorch/CUDA\n"
              "Capability-equivalent to GenMap (Pockrandt et al., "
              "Bioinformatics 2020, doi:10.1093/bioinformatics/btaa222).")
        return 0
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "genmap-tpu-torch — (k,e)-mappability on PyTorch/CUDA\n"
            "Usage: genmap-tpu-torch index|map [options]\n"
            "  index  build the bidirectional FM-index of fasta file(s)\n"
            "  map    compute mappability/frequency from an index"
        )
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        from genmap_tpu_torch.cli.index_cmd import index_main

        return index_main(rest)
    if cmd == "map":
        from genmap_tpu_torch.cli.map_cmd import map_main

        return map_main(rest)
    print(f"ERROR: unknown command '{cmd}' (expected 'index' or 'map')", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
