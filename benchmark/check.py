"""The comparison that decides `correct`: the program's filters, tables
and contigs against the plain reference (benchmark/reference.py) and the
genome the reads were drawn from.

Each number compared has its limit in LIMITS; a run is correct when every
number is at or under its limit. The limits and the readings they were
set from are in PERF.md.
"""
from __future__ import annotations

import torch

from benchmark import reference as R

# number -> limit. The first three are exact comparisons (limit 0). The
# contig numbers hold each assembly to the genome it was drawn from:
# bases in contigs that are not in the genome, the genome's k-mers that
# no contig holds, and contiguity (the N50 against that of an assembly
# broken only at the planted repeat). PERF.md has the readings of sound
# runs and of the faults that each limit was set from.
LIMITS = {
    "filter_words_differ": 0,
    "junction_rows_differ": 0,
    "sink_rows_differ": 0,
    "contig_untrue_share": 0.01,
    "genome_kmers_missing": 3,
    "contig_n50_shortfall": 0.3,
}

_BASES = "ACGT"


def table_rows(tbl, device) -> tuple:
    """(keys, [value columns]) of a program table's occupied rows, keys
    as hi << 32 | lo, values as int64; on `device`."""
    occ = tbl.keys_hi[:-1] != -1
    hi = tbl.keys_hi[:-1][occ].long() & R.M32
    lo = tbl.keys_lo[:-1][occ].long() & R.M32
    vals = [v[:-1][occ].long().to(device) for v in tbl.vals]
    return ((hi << 32) | lo).to(device), vals


def rows_differ(prog: tuple, ref: tuple) -> int:
    """Keys in one table only, plus common keys whose values differ."""
    pk, pv = prog
    rk, rv = ref
    ps, po = torch.sort(pk)
    rs, ro = torch.sort(rk)
    pm, rm = torch.isin(ps, rs), torch.isin(rs, ps)
    n = int(pm.sum())
    bad = torch.zeros(n, dtype=torch.bool, device=pk.device)
    for a, b in zip(pv, rv) if n else ():
        bad |= (a[po][pm].reshape(n, -1) != b[ro][rm].reshape(n, -1)).any(1)
    return int((~pm).sum()) + int((~rm).sum()) + int(bad.sum())


def state_numbers(prog: dict, ref: R.Reference) -> dict:
    """The load and scan layers: filter words and table rows that differ.
    prog: {"filters": {name: int32 words}, "junctions": rows, "sinks":
    rows} (rows as table_rows gives them)."""
    words = ref.filter_words()
    dev = next(iter(words.values())).device
    differ = sum(int((prog["filters"][n].to(dev) != w).sum())
                 for n, w in words.items())
    tables = ref.tables()
    on = lambda rows: (rows[0].to(dev), [v.to(dev) for v in rows[1]])
    return {"filter_words_differ": differ,
            "junction_rows_differ": rows_differ(on(prog["junctions"]),
                                                tables["junctions"]),
            "sink_rows_differ": rows_differ(on(prog["sinks"]),
                                            tables["sinks"])}


def genome_str(genome) -> str:
    return bytes(genome.cpu().numpy().astype("u1")).translate(
        bytes.maketrans(b"\0\1\2\3", b"ACGT")).decode()


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def genome_true_frac(contigs, genome: str) -> float:
    """Share of contig bases in contigs that are exact substrings of the
    circular genome or its reverse complement (chip_smoke.py's
    genome_true_frac)."""
    gg = genome + genome
    hay = gg + "\x00" + revcomp(gg)
    tot = sum(len(c) for c in contigs)
    good = sum(len(c) for c in contigs if c in hay)
    return good / max(tot, 1)


def n50(lengths) -> int:
    """chip_smoke.py's n50."""
    s = sorted(lengths, reverse=True)
    half, acc = sum(s) / 2, 0
    for x in s:
        acc += x
        if acc >= half:
            return x
    return 0


def _canon_keys(seq_codes, k: int):
    """Distinct canonical keys of the valid windows of one code row."""
    row = seq_codes[None, :]
    fwd, rc, valid = R.kmerize(row, torch.tensor([row.shape[1]],
                                                 device=row.device), k)
    canon = R.canonical(fwd, rc)[0]
    hi, lo = R.key(canon, k)
    return torch.unique(((hi << 32) | lo)[valid])


def contig_numbers(contigs, genome, k: int, chunk: int) -> dict:
    """The assembly against the genome: the share of contig bases in
    contigs that are not genome-true, the circular genome's distinct
    k-mers that no contig holds, and how far the N50 falls short of
    `chunk`, the N50 of contigs broken only at the planted repeat
    (gen.chunk_len), as a share of it."""
    g = genome_str(genome)
    dev = genome.device
    circ = torch.cat([genome, genome[:k - 1]])
    want = _canon_keys(circ, k)
    codes = torch.frombuffer(bytearray(("N".join(contigs) or "N").encode()),
                             dtype=torch.uint8)
    table = torch.full((256,), 4, dtype=torch.uint8)
    for i, c in enumerate(b"ACGT"):
        table[c] = i
    have = _canon_keys(table[codes.long()].to(dev), k) if len(codes) >= k \
        else torch.empty(0, dtype=torch.int64, device=dev)
    return {"contig_untrue_share": 1.0 - genome_true_frac(contigs, g),
            "genome_kmers_missing": int((~torch.isin(want, have)).sum()),
            "contig_n50_shortfall": 1.0 - n50([len(c) for c in contigs])
            / chunk}


def verdict(numbers: dict) -> bool:
    return all(numbers[n] <= LIMITS[n] for n in numbers)


def limits_line(numbers: dict) -> dict:
    """{name: {"value", "limit"}} in the order of LIMITS."""
    return {n: {"value": numbers[n], "limit": LIMITS[n]}
            for n in LIMITS if n in numbers}
