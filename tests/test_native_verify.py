"""Native C++ verify DP vs the pure-Python reference implementation."""

import random

import pytest

from sequence_alignment_tools.engine.verify import EditDistAligner
from sequence_alignment_tools.native import load_verify_lib


def _cmp(ra, rb):
    assert ra.found == rb.found
    assert ra.value == rb.value
    assert ra.end == rb.end
    assert ra.start == rb.start
    assert ra.matching_text == rb.matching_text
    assert ra.codes == rb.codes
    assert (ra.stats == rb.stats).all()


@pytest.mark.skipif(load_verify_lib() is None, reason="no native toolchain")
def test_native_matches_python_fuzz():
    random.seed(1)
    for trial in range(800):
        k = random.choice([0, 1, 2, 3])
        indels = random.random() < 0.7
        dna_mut = random.random() < 0.2
        wc = random.random() < 0.3
        textn = wc and random.random() < 0.5
        yesno = random.random() < 0.3
        alpha = "ACDEFGHIKLMNPQRSTVWY" if dna_mut else "ACGT"
        patlen = random.randint(4, 18)
        pat = "".join(
            random.choice(alpha + ("RY" if wc and not dna_mut else ""))
            for _ in range(patlen)
        )
        textlen = random.randint(patlen + 5, 60)
        text = "".join(random.choice(alpha + "\n") for _ in range(textlen))
        end = random.randint(patlen, textlen - 2)
        posub = end + random.randint(0, 4)
        esb = random.choice([0, 0, 0, 3])
        eeb = random.choice([0, 0, 0, 3])

        def text_at(s, length, _t=text):
            seg = _t[max(s, 0) : max(s, 0) + length]
            return seg + "\n" * (length - len(seg))

        ap = EditDistAligner(k, "\n", wc, textn, indels, dna_mut, yesno)
        an = EditDistAligner(k, "\n", wc, textn, indels, dna_mut, yesno)
        ap._native = None
        assert an._native is not None
        _cmp(ap.align(text_at, pat, end, posub, esb=esb, eeb=eeb),
             an.align(text_at, pat, end, posub, esb=esb, eeb=eeb))


@pytest.mark.skipif(load_verify_lib() is None, reason="no native toolchain")
def test_native_matches_python_trans():
    random.seed(2)
    AAS = "ACDEFGHIKLMNPQRSTVWYX*"
    for trial in range(300):
        k = random.choice([1, 2, 3])
        pat = "".join(random.choice("ACDEFGHIKLMNPQRSTVWY")
                      for _ in range(random.randint(5, 12)))
        textlen = random.randint(20, 50)
        text = "".join(random.choice(AAS + "\n") for _ in range(textlen))
        cids = [random.randint(-1, 5) for _ in range(textlen)]
        end = random.randint(len(pat), textlen - 2)
        posub = end + random.randint(0, 2)

        def text_at(s, length, _t=text):
            seg = _t[max(s, 0) : max(s, 0) + length]
            return seg + "\n" * (length - len(seg))

        def codon_at(s, length, _c=cids):
            seg = _c[max(s, 0) : max(s, 0) + length]
            return seg + [-1] * (length - len(seg))

        ap = EditDistAligner(k, "\n", False, False, False, True, False,
                             trans=True)
        an = EditDistAligner(k, "\n", False, False, False, True, False,
                             trans=True)
        ap._native = None
        _cmp(ap.align(text_at, pat, end, posub, codon_at=codon_at),
             an.align(text_at, pat, end, posub, codon_at=codon_at))


def test_native_extend_fuzz():
    """sat_extend_align ≡ the pure-Python Extender.global_align across
    random anchored extensions in every mode."""
    import random

    from sequence_alignment_tools.engine.extend import Extender

    rng = random.Random(123)
    for trial in range(400):
        k = rng.choice([1, 2, 3])
        dna_mut = rng.random() < 0.25
        wc = rng.random() < 0.3
        indels = rng.random() < 0.8
        ext = Extender(k, "\n", wc=wc, textn=rng.random() < 0.5,
                       indels=indels, dna_mut=dna_mut)
        if ext._native is None:
            import pytest

            pytest.skip("native lib unavailable")
        alpha = "ACDEFGHIKLMNPQRSTVWY" if dna_mut else "ACGTN"
        pat = "".join(rng.choice(alpha) for _ in range(rng.randint(3, 14)))
        tlen = rng.randint(0, len(pat) + k + 3)
        text = "".join(rng.choice(alpha + "\n") for _ in range(tlen))
        dirn = rng.choice([1, -1])
        lm = rng.randint(-3, 6)
        rm = rng.randint(-3, 6)
        got = ext.global_align(text, pat, dirn, lm, rm)
        ext._native = None  # force the Python path
        want = ext.global_align(text, pat, dirn, lm, rm)
        assert got == want, (trial, k, dna_mut, wc, indels, pat, text,
                             dirn, lm, rm)
