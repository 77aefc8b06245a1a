"""FASTA reading with the reference's semantics.

Behavioral spec (from GenMap src/indexing.hpp):
  - non-ACGTU characters convert to N (indexing.hpp:13-20)
  - empty sequences are skipped (indexing.hpp:228-231)
  - record ids are truncated at the first whitespace IF the truncated ids are
    still unique within the file; otherwise the full ids are kept
    (indexing.hpp:236-266)
  - an empty file produces a warning and is excluded (indexing.hpp:252-255)
  - directory scan picks up .fsa .fna .fastq .fasta .fas .faa .fa recursively,
    sorted by file name (indexing.hpp:290, 406-407); duplicate file names are
    an error (indexing.hpp:410-420)
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from genmap_tpu_torch.alphabet import encode_seq

FASTA_FILE_TYPES = ("fsa", "fna", "fastq", "fasta", "fas", "faa", "fa")


@dataclass
class FastaFile:
    """One parsed FASTA file: per-record ids and code arrays."""

    name: str  # file name without directory
    ids: list[str] = field(default_factory=list)
    seqs: list[np.ndarray] = field(default_factory=list)  # uint8 codes 0..4


def read_fasta(path: str, name: str | None = None) -> FastaFile:
    """Parse a FASTA/FASTQ file into code arrays (uint8, codes 0..4)."""
    if name is None:
        name = os.path.basename(path)
    out = FastaFile(name=name)
    full_ids: list[str] = []
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] == b"@":
        _parse_fastq(data, full_ids, out.seqs)
    else:
        _parse_fasta_bytes(data, full_ids, out.seqs)

    # skip empty sequences
    keep = [i for i, s in enumerate(out.seqs) if len(s) > 0]
    full_ids = [full_ids[i] for i in keep]
    out.seqs = [out.seqs[i] for i in keep]

    if not out.seqs:
        print(
            f"WARNING: The fasta file {path} seems to be empty. Excluded from indexing.",
            file=sys.stderr,
        )
        return out

    # truncate ids at first whitespace if still unique
    short_ids = [_truncate_id(i) for i in full_ids]
    out.ids = short_ids if len(set(short_ids)) == len(short_ids) else full_ids
    return out


def _truncate_id(rid: str) -> str:
    for pos, ch in enumerate(rid):
        if ch.isspace():
            return rid[:pos]
    return rid


def _parse_fasta_bytes(data: bytes, ids: list[str], seqs: list[np.ndarray]) -> None:
    cur_id: str | None = None
    chunks: list[bytes] = []
    for line in data.splitlines():
        if line.startswith(b">"):
            if cur_id is not None:
                seqs.append(encode_seq(b"".join(chunks)))
                ids.append(cur_id)
            cur_id = line[1:].decode(errors="replace")
            chunks = []
        elif cur_id is not None:
            chunks.append(line.strip())
    if cur_id is not None:
        seqs.append(encode_seq(b"".join(chunks)))
        ids.append(cur_id)


def _parse_fastq(data: bytes, ids: list[str], seqs: list[np.ndarray]) -> None:
    lines = data.splitlines()
    i = 0
    while i + 1 < len(lines):
        header = lines[i]
        if not header.startswith(b"@"):
            i += 1
            continue
        ids.append(header[1:].decode(errors="replace"))
        seqs.append(encode_seq(lines[i + 1]))
        i += 4


def find_fasta_files(directory: str) -> list[tuple[str, str]]:
    """Recursively list (dirpath, filename) of FASTA files, sorted by file name.

    Mirrors getFileNamesInDirectory + the sort at indexing.hpp:406-407.
    """
    found: list[tuple[str, str]] = []
    for root, _dirs, files in os.walk(directory):
        for fn in files:
            ext = fn.rsplit(".", 1)[-1] if "." in fn else ""
            if ext in FASTA_FILE_TYPES:
                found.append((root + "/", fn))
    found.sort(key=lambda pf: pf[1])
    return found
