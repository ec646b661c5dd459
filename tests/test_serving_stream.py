"""Overlapped serving APIs (engine_hits_stream / pairs_stream /
scan_gated_stream): per-run outputs must be identical to the sequential
engine APIs, for every engine with a streamed path — the production
posture bench.py measures (see _model_bps/_stream_bps)."""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.models.primer_match import PrimerMatchModel


def _db(seed=3, n=1 << 17):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[n // 2] = 4  # one entry boundary
    return SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
                 entry_lengths=np.array([n]), headers=["x"]), codes


def _pats(db, codes, k):
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:60000])
    return [text[100:120], text[9000:9022], text[17000:17015]]


def _force_device(model):
    # route every scanner the model builds through the device pipelines
    model.use_host = False
    for ctx in ("_halves_ctx", "_bases_ctx", "_exact_ctx", "_filter_ctx"):
        try:
            parts = getattr(model, ctx)()
        except Exception:
            continue
        for p in parts:
            if hasattr(p, "force_device"):
                p.force_device = True
    return model


@pytest.mark.parametrize("kw,engine", [
    (dict(k=0), "exact"),
    (dict(k=1), "halves"),
    (dict(k=1, indels=False), "filter -K"),
    (dict(k=2), "filter -k2"),
])
def test_engine_stream_matches_sequential(kw, engine):
    db, codes = _db()
    ps = build_pattern_set(_pats(db, codes, kw.get("k", 0)), rev_comp=True)
    m = _force_device(PrimerMatchModel(db, ps, **kw))
    want = list(m.engine_hits())
    runs = list(m.engine_hits_stream(3))
    assert len(runs) == 3
    assert all(r == want for r in runs), engine
    assert want  # the planted patterns must actually hit


def test_pcr_pairs_stream_matches_sequential():
    from sequence_alignment_tools.models.pcr_match import PcrMatchModel
    from sequence_alignment_tools.utils.iupac import reverse_comp

    db, codes = _db(seed=9)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:40000])
    fwd = text[5000:5015]
    rev = reverse_comp(text[5800:5815])
    from sequence_alignment_tools.apps.pcr_match import (
        build_pair_pattern_set,
    )

    opts = {"ucdict": False, "rev_comp": True, "fplen": 0, "tplen": 0,
            "stlen": 0, "edlen": 0}
    ps = build_pair_pattern_set([fwd, rev], opts, [], [])
    m = PcrMatchModel(db, ps, k=0, maxdist=2000, rev_comp=True)
    m.inner.use_host = False
    want = [str(x) for x in m.pairs()]
    runs = [[str(x) for x in r] for r in m.pairs_stream(3)]
    assert len(runs) == 3
    assert all(r == want for r in runs)
    assert want  # the planted amplicon must be found
