"""Pattern table construction (host): patterns -> device-ready arrays.

The device analog of engine ``init()``: where the reference builds automaton
nodes / bit masks per process (``shift_and.cc:53-202``,
``keyword_tree.t:190-217``), we build dense match tables that are replicated
to every chip:

- ``match``:  [P, Lmax, alpha] bool — pattern position j accepts alphabet
  code c (IUPAC wildcard expansion per ``shift_and.cc:108-117`` semantics:
  compat chars, text-N rule).
- ``weights``: same, as bf16 with an optional EOS "poison" row so a single
  correlation both counts matches and invalidates windows straddling
  entry boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.database import SeqDB
from ..io.patterns import PatternSet
from ..utils.iupac import COMPATIBLE


@dataclass
class PatternTables:
    match: np.ndarray  # [P, Lmax, alpha] bool
    lengths: np.ndarray  # [P] int32
    pat_codes: np.ndarray  # [P, Lmax] int16, -1 pad / unmappable
    Lmax: int
    alpha: int
    eos_code: int
    # producer alphabet chars per code (db.table), for structural
    # analyses like the wide-alphabet bit-plane embedding
    # (conv_scan.ConvScanner._bitplane_mode); None when unknown
    code_chars: bytes | None = None

    @property
    def P(self) -> int:
        return len(self.lengths)


def build_tables(ps: PatternSet, db: SeqDB, wc: bool, textn: bool) -> PatternTables:
    P = ps.n_total
    Lmax = max(ps.max_len, 1)
    alpha = db.alphabet_size
    match = np.zeros((P, Lmax, alpha), dtype=bool)
    lengths = np.zeros(P, dtype=np.int32)
    pat_codes = np.full((P, Lmax), -1, dtype=np.int16)
    for p in range(P):
        pat = ps.pattern(p + 1)
        lengths[p] = len(pat)
        for j, ch in enumerate(pat):
            compat = COMPATIBLE.get(ch.upper()) if wc else None
            if wc and compat is not None:
                for cch in compat:
                    code = db.nch(cch)
                    if code >= 0 and (cch != "N" or textn):
                        match[p, j, code] = True
            else:
                code = db.nch(ch)
                if code >= 0:
                    match[p, j, code] = True
                    pat_codes[p, j] = code
    return PatternTables(
        match=match,
        lengths=lengths,
        pat_codes=pat_codes,
        Lmax=Lmax,
        alpha=alpha,
        eos_code=db.eos_code,
        code_chars=bytes(db.table) if getattr(db, "table", None) else None,
    )


def conv_weights(tables: PatternTables, k: int, poison_eos: bool) -> np.ndarray:
    """bf16 correlation kernel [Lmax, alpha, P] (WIO layout for NWC conv).

    score(i, p) = sum_j W[j, text[i+j], p]; threshold at L_p - k.  With
    ``poison_eos``, EOS inside the first L_p window positions drives the score
    below any threshold (window straddles an entry boundary -> invalid,
    mirroring the DP's EOS constraint-violation)."""
    P, Lmax, alpha = tables.match.shape
    w = tables.match.astype(np.float32)
    if poison_eos:
        in_range = np.arange(Lmax)[None, :] < tables.lengths[:, None]  # [P, Lmax]
        w[..., tables.eos_code] = np.where(in_range, -(Lmax + k + 1.0), 0.0)
    return np.ascontiguousarray(w.transpose(1, 2, 0)).astype("bfloat16")
