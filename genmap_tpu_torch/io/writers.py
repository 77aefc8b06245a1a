"""Output writers: raw / txt / wig / bedgraph / bed / csv.

Byte-compatible with the reference writers (GenMap src/output.hpp):
  - floats are float32 reciprocals printed like C++ default operator<<
    (6 significant digits, general format == printf %g)
  - wig: variableStep run-length, 1-based, zero runs suppressed, span header
    only when the span changes between *emitted* runs (output.hpp:91-126)
  - bedgraph/bed: 0-based half-open runs, zero runs suppressed
  - csv: per-k-mer location lists, one column per fasta file per strand
"""

from __future__ import annotations

import numpy as np


def fmt_float(v: int) -> str:
    """1/v as the reference prints it: float32 value via C++ '<<' (== %g)."""
    f = float(np.float32(1.0) / np.float32(v)) if v != 0 else 0.0
    return f"{f:g}"


def _runs_arrays(values: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(run values, run starts, run ends) of a 1-D array, vectorized."""
    n = len(values)
    if n == 0:
        z = np.empty(0, np.int64)
        return z, z, z
    change = np.nonzero(values[1:] != values[:-1])[0] + 1
    starts = np.concatenate(([0], change)).astype(np.int64)
    ends = np.concatenate((change, [n])).astype(np.int64)
    return values[starts], starts, ends


def _int_chars(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Left-aligned decimal digits of non-negative ints: (chars [n,W], lens)."""
    a = a.astype(np.int64)
    n = len(a)
    nd = np.ones(n, np.int64)
    t = 10
    while t <= (int(a.max()) if n else 0):
        nd += a >= t
        t *= 10
    W = int(nd.max()) if n else 1
    chars = np.zeros((n, W), np.uint8)
    for j in range(W):
        e = nd - 1 - j
        div = np.power(10, np.maximum(e, 0)).astype(np.int64)
        chars[:, j] = np.where(e >= 0, (a // div) % 10 + 48, 0).astype(np.uint8)
    return chars, nd


def _assemble(n: int, fields: list) -> bytes:
    """Vectorized byte assembly of n lines from variable-width fields.

    Each field is (chars, lens, mask): `chars` is either constant bytes or a
    [n, W] uint8 matrix with per-line `lens`; `mask` (or None) selects the
    lines that emit the field.  Runs one numpy scatter per character column —
    this is what makes hg38-scale wig/bedgraph emission seconds instead of
    minutes (the reference streams through 32 KB buffers,
    GenMap src/output.hpp:6).
    """
    field_lens = []
    total = np.zeros(n, np.int64)
    for chars, lens, mask in fields:
        if isinstance(chars, bytes):
            l = np.full(n, len(chars), np.int64)
        else:
            l = lens.astype(np.int64)
        if mask is not None:
            l = np.where(mask, l, 0)
        field_lens.append(l)
        total += l
    offs = np.zeros(n, np.int64)
    if n:
        np.cumsum(total[:-1], out=offs[1:])
    buf = np.empty(int(total.sum()), np.uint8)
    cur = offs
    for (chars, lens, mask), l in zip(fields, field_lens):
        if isinstance(chars, bytes):
            arr = np.frombuffer(chars, np.uint8)
            base = cur if mask is None else cur[mask]
            for k in range(len(arr)):
                buf[base + k] = arr[k]
        else:
            for k in range(chars.shape[1]):
                m = lens > k
                if mask is not None:
                    m = m & mask
                buf[cur[m] + k] = chars[m, k]
        cur = cur + l
    return buf.tobytes()


def save_raw(c: np.ndarray, path: str, mappability: bool, small: bool) -> None:
    if mappability:
        f = np.where(c != 0, np.float32(1.0) / np.maximum(c, 1).astype(np.float32), np.float32(0.0))
        f.astype("<f4").tofile(path)
    else:
        c.astype("<u1" if small else "<u2").tofile(path)


def _value_strings_lut(max_value: int, mappability: bool) -> tuple[np.ndarray, np.ndarray]:
    """Byte LUT of formatted values: frequency values are bounded by the cap,
    so every possible printed token (value + trailing space) is precomputed
    and whole chromosomes are rendered with numpy indexing instead of a
    per-position Python loop."""
    toks = [
        (fmt_float(v) if mappability else str(v)) + " " for v in range(max_value + 1)
    ]
    width = max(len(t) for t in toks)
    lut = np.zeros((max_value + 1, width), dtype=np.uint8)
    lens = np.zeros(max_value + 1, dtype=np.int32)
    for v, t in enumerate(toks):
        b = t.encode()
        lut[v, : len(b)] = np.frombuffer(b, np.uint8)
        lens[v] = len(b)
    return lut, lens


def _render_values(vals: np.ndarray, lut: np.ndarray, lens: np.ndarray) -> bytes:
    """Space-separated rendering of vals (no trailing space)."""
    if len(vals) == 0:
        return b""
    chars = lut[vals]  # [n, width]
    width = chars.shape[1]
    vlens = lens[vals].astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(vlens[:-1])))
    out = np.empty(int(vlens.sum()), dtype=np.uint8)
    for k in range(width):  # one vectorized scatter per token column
        m = vlens > k
        out[offsets[m] + k] = chars[m, k]
    return out.tobytes()[:-1]  # drop final trailing space


def save_txt(
    c: np.ndarray, path: str, chrom_names, chrom_lens, mappability: bool
) -> None:
    lut, lens = _value_strings_lut(int(c.max(initial=0)), mappability)
    with open(path, "wb") as out:
        pos = 0
        for name, ln in zip(chrom_names, chrom_lens):
            ln = int(ln)
            vals = c[pos : pos + ln]
            pos += ln
            out.write(f">{name}\n".encode())
            out.write(_render_values(np.asarray(vals), lut, lens))
            out.write(b"\n")


def _value_tokens(vals: np.ndarray, mappability: bool) -> tuple[np.ndarray, np.ndarray]:
    """[n, W] byte matrix + lens of the formatted value of each run."""
    vmax = int(vals.max(initial=0))
    toks = [fmt_float(v) if mappability else str(v) for v in range(vmax + 1)]
    width = max(len(t) for t in toks)
    lut = np.zeros((vmax + 1, width), dtype=np.uint8)
    lens = np.zeros(vmax + 1, dtype=np.int64)
    for v, t in enumerate(toks):
        b = t.encode()
        lut[v, : len(b)] = np.frombuffer(b, np.uint8)
        lens[v] = len(b)
    return lut[vals], lens[vals]


def save_wig(
    c: np.ndarray, path_prefix: str, chrom_names, chrom_lens, mappability: bool
) -> None:
    with open(path_prefix + ".wig", "wb") as wig:
        pos = 0
        for name, ln in zip(chrom_names, chrom_lens):
            ln = int(ln)
            vals = c[pos : pos + ln]
            pos += ln
            v, starts, ends = _runs_arrays(np.asarray(vals))
            keep = v != 0
            v, starts, occ = v[keep], starts[keep], (ends - starts)[keep]
            n = len(v)
            if n == 0:
                continue
            # span header before every emitted run whose span differs from
            # the previous *emitted* run's span (initial last_occ = 0)
            hdr = np.empty(n, bool)
            hdr[0] = True
            hdr[1:] = occ[1:] != occ[:-1]
            occ_c, occ_l = _int_chars(occ)
            st_c, st_l = _int_chars(starts + 1)
            val_c, val_l = _value_tokens(v, mappability)
            wig.write(
                _assemble(
                    n,
                    [
                        (f"variableStep chrom={name} span=".encode(), None, hdr),
                        (occ_c, occ_l, hdr),
                        (b"\n", None, hdr),
                        (st_c, st_l, None),
                        (b" ", None, None),
                        (val_c, val_l, None),
                        (b"\n", None, None),
                    ],
                )
            )
    with open(path_prefix + ".chrom.sizes", "w") as cs:
        for name, ln in zip(chrom_names, chrom_lens):
            cs.write(f"{name}\t{int(ln)}\n")


def save_bedgraph(
    c: np.ndarray,
    path_prefix: str,
    chrom_names,
    chrom_lens,
    bedgraph_format: bool,
    mappability: bool,
) -> None:
    suffix = ".bedgraph" if bedgraph_format else ".bed"
    with open(path_prefix + suffix, "wb") as out:
        pos = 0
        for name, ln in zip(chrom_names, chrom_lens):
            ln = int(ln)
            vals = c[pos : pos + ln]
            pos += ln
            v, starts, ends = _runs_arrays(np.asarray(vals))
            keep = v != 0
            v, starts, ends = v[keep], starts[keep], ends[keep]
            n = len(v)
            if n == 0:
                continue
            st_c, st_l = _int_chars(starts)
            en_c, en_l = _int_chars(ends)
            val_c, val_l = _value_tokens(v, mappability)
            name_col = b"\t" if bedgraph_format else b"\t-\t"
            out.write(
                _assemble(
                    n,
                    [
                        (name.encode() + b"\t", None, None),
                        (st_c, st_l, None),
                        (b"\t", None, None),
                        (en_c, en_l, None),
                        (name_col, None, None),
                        (val_c, val_l, None),
                        (b"\n", None, None),
                    ],
                )
            )


def save_csv(
    path_prefix: str,
    locations: dict,
    rev_compl: bool,
    fasta_files: list[tuple[str, int]],  # (file name, last global seq index)
    csv_intervals: list[tuple[int, int, int]] | None,  # (chromId, begin, end) sorted
) -> None:
    """CSV location lists (output.hpp:189-288).

    `locations`: {(chrom_i1, pos_i2): ((f_i1, f_i2), (r_i1, r_i2))} where the
    key uses per-file chromosome ids and the value arrays use global sequence
    ids across all indexed files.
    """
    output_selection = csv_intervals is not None

    with open(path_prefix + ".csv", "w") as out:
        out.write('"k-mer"')
        for fname, _last in fasta_files:
            out.write(f';"+ strand {fname}"')
        if rev_compl:
            for fname, _last in fasta_files:
                out.write(f';"- strand {fname}"')
        out.write("\n")

        iv = 0
        ivs = csv_intervals or []

        def strand_cols(a1: np.ndarray, a2: np.ndarray) -> str:
            cols = []
            i = 0
            prev_chroms = 0
            for _fname, last in fasta_files:
                parts = []
                while i < len(a1) and a1[i] <= last:
                    parts.append(f"{int(a1[i]) - prev_chroms},{int(a2[i])}")
                    i += 1
                cols.append("|".join(parts))
                prev_chroms = last + 1
            return ";".join(cols)

        for (i1, i2) in sorted(locations):
            (f1, f2), (r1, r2) = locations[(i1, i2)]
            while iv < len(ivs) and (
                ivs[iv][0] < i1 or (ivs[iv][0] == i1 and ivs[iv][2] <= i2)
            ):
                iv += 1
            if output_selection and not (
                iv < len(ivs)
                and ivs[iv][0] == i1
                and ivs[iv][1] <= i2 < ivs[iv][2]
            ):
                continue
            out.write(f"{i1},{i2}")
            out.write(";" + strand_cols(f1, f2))
            if rev_compl:
                out.write(";" + strand_cols(r1, r2))
            out.write("\n")
