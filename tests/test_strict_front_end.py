"""Targeted soundness tests for the extension-strict front end.

The strict group table + t16 position filter (ops/table._build_strict) are
active on the DEFAULT configuration (N=0, packed planes), so their
no-lost-hit claim needs direct adversarial coverage: every case here is
byte-equality vs the reference oracle (verify semantics: reference
engine.py:599-642), plus a strict-vs-loose A/B sweep on this engine
itself (same table, strict filtering toggled) proving the filters only
remove work, never hits.
"""

import random

import numpy as np
import pytest

import merpcr_tpu
from .conftest import needs_oracle, oracle_engine, run_search

pytestmark = [pytest.mark.integration]

BASES = "ACGT"


def _write(tmp_path, sts_text, fa_text):
    sts = tmp_path / "s.sts"
    fa = tmp_path / "g.fa"
    sts.write_text(sts_text)
    fa.write_text(fa_text)
    return str(sts), str(fa)


def _eng_out(sts, fa, force_loose=False, **params):
    eng = merpcr_tpu.MerPCR(**params)
    assert eng.load_sts_file(sts)
    if force_loose:
        eng._meta.strict = False
    elif params.get("mismatches", 0) == 0:
        # these tests exist to exercise the strict path — fail loudly if a
        # table-compiler change silently turned it off at default W
        assert eng._meta.strict or params.get("wordsize", 11) >= 14
    return run_search(eng, eng.load_fasta_file(fa))


def _ref_out(sts, fa, **params):
    eng = oracle_engine(**params)
    assert eng.load_sts_file(sts)
    return run_search(eng, eng.load_fasta_file(fa))


def _fa(genome, label="g"):
    lines = [f">{label} strict case"]
    lines += [genome[i : i + 70] for i in range(0, len(genome), 70)]
    return "\n".join(lines) + "\n"


@needs_oracle
def test_extension_base_mismatch_pruned_not_lost(tmp_path):
    """Genome windows whose first W bases equal a primer W-mer but whose
    extension bases differ: strict tables must prune them WITHOUT losing
    the genuine full match planted elsewhere (reference engine.py:599-642
    rejects the decoys at N=0 anyway — output must stay identical)."""
    rng = random.Random(11)
    p1 = "GGCTCAGAGTATTTGGGATGCA"  # 22 bp, W=11 key = first 11
    p2 = "CTCTTGGAATCCTATCTCACTG"
    g = list("".join(rng.choices(BASES, k=6000)))
    # 40 decoys: key matches, extension base (position 11..21) corrupted
    for i in range(40):
        pos = 100 + i * 120
        decoy = list(p1)
        j = rng.randrange(11, len(p1))
        decoy[j] = rng.choice([b for b in BASES if b != decoy[j]])
        g[pos : pos + len(p1)] = decoy
    # one genuine (+) amplicon at the end
    prod = 200
    pos = 5500
    g[pos : pos + len(p1)] = p1
    g[pos + prod - len(p2) : pos + prod] = p2
    sts, fa = _write(tmp_path, f"S1\t{p1}\t{p2}\t{prod}\n", _fa("".join(g)))
    ref = _ref_out(sts, fa)
    assert ref.count("\n") == 1  # only the genuine hit
    assert _eng_out(sts, fa) == ref


@needs_oracle
def test_iupac_nonpow4_insert_products(tmp_path):
    """Degenerate IUPAC primer letters whose allowed-code products are
    NOT powers of 4 (one 'H' -> 3, 'H'+'R' -> 6, one 'R' -> 2): the
    strict build's magnitude-bucketed enumeration previously SKIPPED
    every bucket holding a non-power-of-4 product (`lim < prod+1` exited
    before the prod=3 bucket at lim=4), silently dropping those phases'
    keys and with them real IUPAC hits on clean genome. Found round 5 by
    the arbitrary-content differential property; this is the
    deterministic pin. The old test's R,Y pair multiplied to exactly 4 —
    the one value that dodged the bug."""
    rng = random.Random(29)
    p2 = "CTCTTGGAATCCTATCTCACTG"
    prod = 180
    cases = [
        ("GGCTCAGAGTATTHGGGATGCA", {"H": "A"}),  # prod 3
        ("GGCTCAGAGTATTHGRGATGCA", {"H": "C", "R": "G"}),  # prod 6
        ("GGCTCAGAGTATTRGGGATGCA", {"R": "A"}),  # prod 2
        ("GGCTCAGAGTATTHGHGATHCA", {"H": "T"}),  # prod 27
    ]
    for p1, subs in cases:
        g = list("".join(rng.choices(BASES, k=3000)))
        site = p1
        for k, v in subs.items():
            site = site.replace(k, v)
        g[700 : 700 + len(site)] = site
        g[700 + prod - len(p2) : 700 + prod] = p2
        sts, fa = _write(
            tmp_path, f"S1\t{p1}\t{p2}\t{prod}\n", _fa("".join(g))
        )
        params = dict(iupac_mode=1)
        ref = _ref_out(sts, fa, **params)
        assert ref.count("\n") == 1, (p1, ref)  # the hit really exists
        assert _eng_out(sts, fa, **params) == ref, p1


def test_strict_build_key_completeness_vs_slow_enumeration():
    """Exhaustive check of _build_strict against an independent
    slow-path enumeration for a degenerate-letter-heavy entry: every
    (phase, consistent-window) key must be present (missing keys = lost
    hits; extra keys only cost compact lanes)."""
    import itertools

    from merpcr_tpu.ops.encoding import PRIMER_CODE_LUT, nib_match_matrix
    from merpcr_tpu.ops.table import PROJ_BASES, PROJ_UNIT_START, _build_strict

    p1 = "TCGAGATAATCTAAAHHTCXAC"  # the round-5 falsifying primer
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    W = 11
    ehash = np.zeros(1, np.uint64)
    for i, c in enumerate(p1[:W]):
        ehash[0] |= np.uint64(code[c]) << np.uint64(2 * i)
    p1b = np.zeros((1, 24), np.uint8)
    p1b[0, : len(p1)] = np.frombuffer(p1.encode(), np.uint8)
    qs, _t, _b, _r = _build_strict(
        ehash, np.zeros(1, np.int32), np.asarray([len(p1)], np.int32),
        p1b, W, True,
    )
    got = set()
    for w in np.nonzero(qs)[0]:
        word = int(qs[w])
        for b in range(32):
            if (word >> b) & 1:
                got.add(int(w) * 32 + b)

    nm = nib_match_matrix(True)[:4, :].astype(bool)
    C = PROJ_UNIT_START
    wcode = [(int(ehash[0]) >> (2 * i)) & 3 for i in range(C + PROJ_BASES)]
    slow = set()
    for d in range(8):
        t0 = C - d
        allowed, dead = [], False
        for k in range(PROJ_BASES):
            o = t0 + k
            if o < W:
                al = [wcode[o]]
            elif o < len(p1):
                pc = int(PRIMER_CODE_LUT[ord(p1[o])])
                al = [c for c in range(4) if nm[c, pc]]
            else:
                al = [0, 1, 2, 3]
            if not al:
                dead = True
                break
            allowed.append(al)
        if dead:
            continue
        for combo in itertools.product(*allowed):
            v = 0
            for k, c in enumerate(combo):
                v |= c << (2 * k)
            slow.add(v)
    assert slow, "slow enumeration produced nothing (test bug)"
    missing = slow - got
    assert not missing, f"{len(missing)} keys missing of {len(slow)}"


@needs_oracle
def test_hash_offset_nonzero_strict(tmp_path):
    """Primer1 with leading ambiguity: the W-mer key starts at
    hash_offset > 0, so strict extension indexing is shifted
    (reference engine.py:339-353 first-valid-offset rule)."""
    rng = random.Random(7)
    # hash_offset = 2 (leading NN); extension bases beyond key still real
    p1 = "NNGCTCAGAGTATTTGGGATGCA"
    p2 = "CTCTTGGAATCCTATCTCACTG"
    g = list("".join(rng.choices(BASES, k=4000)))
    prod = 180
    # the planted site must match p1 with N wildcards at its first 2 bases
    site = list(p1.replace("N", "A"))
    pos = 1500
    g[pos : pos + len(site)] = site
    g[pos + prod - len(p2) : pos + prod] = p2
    # decoy: key + shifted extension mismatch
    decoy = list(site)
    decoy[15] = "A" if decoy[15] != "A" else "C"
    g[300 : 300 + len(decoy)] = decoy
    sts_text = f"S1\t{p1}\t{p2}\t{prod}\n"
    fa_text = _fa("".join(g))
    sts, fa = _write(tmp_path, sts_text, fa_text)
    for params in (dict(), dict(iupac_mode=1), dict(three_prime_match=0)):
        assert _eng_out(sts, fa, **params) == _ref_out(sts, fa, **params), params


@needs_oracle
def test_iupac_letters_in_extension_positions(tmp_path):
    """IUPAC primer letters BEYOND the W-mer: in iupac mode the strict
    build must enumerate their expansions (multi-code extension bases are
    FREE, not FIXED); in non-iupac mode such letters can never match clean
    genome and the entry must only hit through dirty-genome bypass."""
    rng = random.Random(23)
    p1 = "GGCTCAGAGTATRYGGGATGCA"  # R,Y at extension positions 12,13
    p2 = "CTCTTGGAATCCTATCTCACTG"
    prod = 190
    g = list("".join(rng.choices(BASES, k=5000)))
    # plant a site compatible with R->A, Y->C
    site = p1.replace("R", "A").replace("Y", "C")
    g[800 : 800 + len(site)] = site
    g[800 + prod - len(p2) : 800 + prod] = p2
    # and one compatible with R->G, Y->T
    site2 = p1.replace("R", "G").replace("Y", "T")
    g[2800 : 2800 + len(site2)] = site2
    g[2800 + prod - len(p2) : 2800 + prod] = p2
    # ambiguous-genome site: N bases inside the extension span (bypass path)
    site3 = list(site)
    site3[14] = "N"
    g[4000 : 4000 + len(site3)] = site3
    g[4000 + prod - len(p2) : 4000 + prod] = p2
    sts, fa = _write(tmp_path, f"S1\t{p1}\t{p2}\t{prod}\n", _fa("".join(g)))
    for params in (dict(iupac_mode=1), dict(iupac_mode=0),
                   dict(iupac_mode=1, mismatches=1)):
        assert _eng_out(sts, fa, **params) == _ref_out(sts, fa, **params), params


@needs_oracle
@pytest.mark.parametrize("wordsize", [12, 13, 14])
def test_wordsize_strict_boundary(tmp_path, wordsize):
    """W=12/13 are the largest exact-group-table wordsizes (stride 2);
    W=14 uses the mult-hash loose front end — but the projection-strict
    table arms strict mode at EVERY wordsize (table.PROJ_START keying).
    All must stay byte-identical to the oracle."""
    rng = random.Random(wordsize)
    g = "".join(rng.choices(BASES, k=8000))
    p1, p2 = g[1000:1022], g[1160:1180]  # real (+) amplicon, size 180
    sts_text = f"S1\t{p1}\t{p2}\t180\nS2\t{p2}\t{p1}\t300\n"
    sts, fa = _write(tmp_path, sts_text, _fa(g))
    params = dict(wordsize=wordsize)
    eng = merpcr_tpu.MerPCR(**params)
    assert eng.load_sts_file(sts)
    assert eng._meta.strict  # projection table arms strict at every W
    assert run_search(eng, eng.load_fasta_file(fa)) == _ref_out(
        sts, fa, **params
    )


# A/B sweep state: the parametrized cases below record which seeds really
# exercised the strict tables; the trailing coverage test asserts the floor.
# Parametrized (not one looping test) so conftest's map-count fixture can
# clear XLA caches between cases — ~80 engines' worth of fresh executables
# in ONE test crossed vm.max_map_count and segfaulted the interpreter.
_ab_checked: list = []


@pytest.mark.parametrize("seed", range(40))
def test_strict_vs_loose_ab(tmp_path, seed):
    """A/B: the same engine with strict filtering forced OFF must produce
    byte-identical output on randomized corpora — the strict front end may
    only prune work the verify would reject (no-lost-hit invariant)."""
    import os
    import sys

    sys.path.insert(
        0,
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools"),
    )
    from difffuzz import gen_case

    rng = random.Random(900_000 + seed)
    sts_text, fa_text, params = gen_case(rng, seed)
    if params.get("mismatches", 0) != 0:
        params = dict(params, mismatches=0)  # strict only arms at N=0
    sts, fa = _write(tmp_path, sts_text, fa_text)
    eng = merpcr_tpu.MerPCR(**params)
    if not eng.load_sts_file(sts):
        pytest.skip("case generated no loadable STS records")
    if not eng._meta.strict:
        pytest.skip("W >= 14 — strict front end not armed, nothing to A/B")
    recs = eng.load_fasta_file(fa)
    strict_out = run_search(eng, recs)
    eng_loose = merpcr_tpu.MerPCR(**params)
    assert eng_loose.load_sts_file(sts)
    eng_loose._meta.strict = False
    assert run_search(eng_loose, recs) == strict_out, (seed, params)
    _ab_checked.append(seed)


def test_strict_vs_loose_ab_coverage():
    """The sweep must have really exercised strict tables — if a table-
    compiler change silently disarmed strict mode, every case above would
    skip and this guard fails instead of the suite going quietly green."""
    assert len(_ab_checked) >= 25


@needs_oracle
def test_t16_hash_collision_density(tmp_path):
    """Dense STS set at W=11 pushes the t16 filter toward its insert cap;
    hits planted for many entries must all survive (oracle equality)."""
    rng = random.Random(31)
    n_sts = 300
    g = list("".join(rng.choices(BASES, k=60000)))
    lines = []
    for i in range(n_sts):
        lp1 = rng.randrange(14, 26)
        lp2 = rng.randrange(14, 26)
        p1 = "".join(rng.choices(BASES, k=lp1))
        p2 = "".join(rng.choices(BASES, k=lp2))
        prod = rng.randrange(lp1 + lp2, 300)
        lines.append(f"D{i}\t{p1}\t{p2}\t{prod}")
        if i % 3 == 0:  # plant every third marker
            pos = rng.randrange(0, len(g) - prod)
            g[pos : pos + lp1] = p1
            g[pos + prod - lp2 : pos + prod] = p2
    sts, fa = _write(
        tmp_path, "\n".join(lines) + "\n", _fa("".join(g), "dense")
    )
    ref = _ref_out(sts, fa)
    assert ref.count("\n") >= 50  # really a dense-hit corpus
    assert _eng_out(sts, fa) == ref


@pytest.mark.parametrize("seed", range(12))
def test_strict_n1_vs_loose_ab(tmp_path, seed):
    """A/B at -N 1: the Hamming-1 strict front end (qbloom_s1/t16_1) must
    produce byte-identical output vs the same engine with strict forced
    off — the wildcard union may only prune work the verify rejects."""
    import os
    import sys

    sys.path.insert(
        0,
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools"),
    )
    from difffuzz import gen_case

    rng = random.Random(1_700_000 + seed)
    sts_text, fa_text, params = gen_case(rng, seed)
    params = dict(params, mismatches=1)
    sts, fa = _write(tmp_path, sts_text, fa_text)
    eng = merpcr_tpu.MerPCR(**params)
    if not eng.load_sts_file(sts):
        pytest.skip("case generated no loadable STS records")
    recs = eng.load_fasta_file(fa)
    strict_out = run_search(eng, recs)
    # strict1 builds lazily during the first -N 1 search
    if not eng._meta.strict1:
        pytest.skip("strict1 not armed for this set")
    eng_loose = merpcr_tpu.MerPCR(**params)
    assert eng_loose.load_sts_file(sts)
    eng_loose._meta.strict = False
    eng_loose._meta.strict1 = False
    assert run_search(eng_loose, recs) == strict_out, (seed, params)
