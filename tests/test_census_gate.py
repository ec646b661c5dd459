"""The native census's inline prefix-extension gate
(native/shift_and.cpp::mer_gate_pass) is a SUPERSET filter: engine
output with the gate must equal the ungated run bit-for-bit — planted
true hits (substitutions, indels, near-edge windows) included."""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import PatternSet
from sequence_alignment_tools.models.primer_match import PrimerMatchModel


def _mutate(rng, pat, op):
    s = list(pat)
    i = int(rng.integers(1, len(s) - 1))
    if op == 0:
        s[i] = "ACGT"[(("ACGT".index(s[i])) + 1) % 4]
    elif op == 1:
        del s[i]
    else:
        s.insert(i, "ACGT"[int(rng.integers(0, 4))])
    return "".join(s)


@pytest.fixture(scope="module")
def census_db():
    rng = np.random.default_rng(99)
    n = 1 << 19
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    table = b"ACGT\n"
    db = SeqDB(codes=codes, table=table,
               entry_starts=np.array([0]), entry_lengths=np.array([n]),
               headers=["e1"])
    text = "".join("ACGT"[c] for c in codes[:400_000])
    # many patterns drawn from the text (so the census routes), plus
    # planted mutated occurrences elsewhere
    pats = []
    for i in range(3000):
        p = text[137 * i + 11 : 137 * i + 11 + 18]
        if len(p) == 18:
            pats.append(p)

    def plant(at, s):
        for j, ch in enumerate(s):
            if at + j < n:
                db.codes[at + j] = table.index(ch.encode())

    for i, op in enumerate([0, 1, 2, 0, 1, 2]):
        plant(420_000 + 400 * i, _mutate(rng, pats[i], op))
    # near-edge windows
    plant(0, pats[6][2:])
    plant(n - 16, pats[7][:16])
    return db, pats


def test_census_gate_output_identical(census_db):
    db, pats = census_db
    P = len(pats)
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (P + 1),
                    eeb=[0] * (P + 1), n_forward=P)
    outs = {}
    for gated in (True, False):
        model = PrimerMatchModel(db, ps, k=1, indels=True)
        model.use_host = False
        assert model.engine == "halves"
        if not gated:
            model._census_gate_c = (None, None)

            def nogate(scanner, dirs, ext_pats, hid_of):
                return None

            model._census_gate = nogate
        # pin the census path: this test is about scan_seed_arrays
        owner, scanner, batch, dirs, ext_pats, geomB = model._halves_ctx()
        arrays = scanner.scan_seed_arrays(
            np.asarray(db.codes), sort=False,
            gate=model._census_gate(scanner, dirs, ext_pats,
                                    lambda h: h + 1)
            if gated else None)
        assert arrays is not None, "census path did not engage"
        outs[gated] = sorted(model.engine_hits())
    assert outs[True] == outs[False]
    assert len(outs[True]) >= 6  # the planted mutations all surface


def test_census_gate_prunes(census_db):
    """The gate must actually reject a large share of random seed hits
    (otherwise it is dead weight)."""
    db, pats = census_db
    P = len(pats)
    ps = PatternSet(patterns=[""] + pats, esb=[0] * (P + 1),
                    eeb=[0] * (P + 1), n_forward=P)
    model = PrimerMatchModel(db, ps, k=1, indels=True)
    model.use_host = False
    owner, scanner, batch, dirs, ext_pats, geomB = model._halves_ctx()
    codes = np.asarray(db.codes)
    gate = model._census_gate(scanner, dirs, ext_pats, lambda h: h + 1)
    assert gate is not None
    raw = scanner.scan_seed_arrays(codes, sort=False, gate=None)
    gated = scanner.scan_seed_arrays(codes, sort=False, gate=gate)
    assert len(gated[0]) < len(raw[0]) * 0.6, (
        len(gated[0]), len(raw[0]))
