"""Parameter-extreme and API-edge tests, differentially validated against
the reference oracle where it is mounted."""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import merpcr_tpu
from merpcr_tpu.models import FASTARecord
from .conftest import REFERENCE_ROOT, needs_oracle, run_search

pytestmark = pytest.mark.integration

P1 = "GGCTCAGAGTATTTGGGATG"
P2 = "CTCTTGGAATCCTATCTCACTG"


def _oracle():
    sys.path.insert(0, os.path.join(REFERENCE_ROOT, "src"))
    import merpcr as ref

    return ref


def _both(sts_text, fa_text, params, tmp_path):
    sts = tmp_path / "t.sts"
    fa = tmp_path / "t.fa"
    sts.write_text(sts_text)
    fa.write_text(fa_text)
    outs = []
    for pkg in (_oracle(), merpcr_tpu):
        eng = pkg.MerPCR(**params)
        ok = eng.load_sts_file(str(sts))
        if not ok:
            outs.append(None)
            continue
        recs = eng.load_fasta_file(str(fa))
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(recs, None)
        outs.append(buf.getvalue())
    return outs


def _genome(seed=0, n=3000, plant=True):
    rng = np.random.default_rng(seed)
    g = list("".join(rng.choice(list("ACGT"), size=n)))
    if plant:
        amp = list("".join(rng.choice(list("ACGT"), size=200)))
        amp[: len(P1)] = P1
        amp[200 - len(P2) :] = P2
        g[500:700] = amp
    return "".join(g)


@needs_oracle
@pytest.mark.parametrize("w", [4, 8, 16])
def test_wordsize_extremes(w, tmp_path):
    ref_out, eng_out = _both(
        f"S1\t{P1}\t{P2}\t200\n", f">g\n{_genome()}\n", dict(wordsize=w), tmp_path
    )
    assert ref_out == eng_out
    assert len(ref_out.splitlines()) >= 1


@needs_oracle
@pytest.mark.slow
def test_wordsize_3_dense_buckets(tmp_path):
    # W=3: only 64 buckets — nearly every position is a candidate; the
    # capacity heuristics must absorb it (escalation allowed, output exact)
    ref_out, eng_out = _both(
        f"S1\t{P1}\t{P2}\t200\n",
        f">g\n{_genome(n=1200)}\n",
        dict(wordsize=3),
        tmp_path,
    )
    assert ref_out == eng_out


@needs_oracle
@pytest.mark.parametrize("m", [0, 1, 9999])
def test_margin_extremes(m, tmp_path):
    ref_out, eng_out = _both(
        f"S1\t{P1}\t{P2}\t200\n",
        f">g\n{_genome(seed=3, n=1500)}\n",
        dict(margin=m),
        tmp_path,
    )
    assert ref_out == eng_out


@needs_oracle
def test_mismatch_max_and_x_large(tmp_path):
    # N=10 with X larger than primer length => exact match required
    for params in (dict(mismatches=10), dict(mismatches=10, three_prime_match=50)):
        ref_out, eng_out = _both(
            f"S1\t{P1}\t{P2}\t200\n", f">g\n{_genome(seed=5)}\n", params, tmp_path
        )
        assert ref_out == eng_out, params


@needs_oracle
def test_direct_api_record_with_odd_chars(tmp_path):
    """API-constructed records bypass the FASTA filter; 'u'/'U' and other
    bytes must keep exact reference semantics (byte-pipeline fallback)."""
    g = _genome(seed=7, n=2000)
    # splice lowercase u's and junk into the sequence
    g = g[:100] + "uUuU" + g[104:300] + "EéZ9 " + g[305:]
    ref = _oracle()
    outs = []
    for pkg in (ref, merpcr_tpu):
        eng = pkg.MerPCR()
        sts = tmp_path / "s.sts"
        sts.write_text(f"S1\t{P1}\t{P2}\t200\n")
        assert eng.load_sts_file(str(sts))
        rec = pkg.FASTARecord(defline=">direct", sequence=g)
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search([rec], None)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@needs_oracle
def test_u_primers_iupac(tmp_path):
    # RNA-style primers (U instead of T) match DNA only in IUPAC mode
    p1u = P1.replace("T", "U")
    for iu in (0, 1):
        ref_out, eng_out = _both(
            f"S1\t{p1u}\t{P2}\t200\n",
            f">g\n{_genome(seed=9)}\n",
            dict(iupac_mode=iu),
            tmp_path,
        )
        assert ref_out == eng_out, f"iupac={iu}"


def test_threads_flag_is_output_invariant(tmp_path):
    outs = set()
    for t in (1, 2, 8):
        eng = merpcr_tpu.MerPCR(threads=t)
        sts = tmp_path / "s.sts"
        sts.write_text(f"S1\t{P1}\t{P2}\t200\n")
        eng.load_sts_file(str(sts))
        fa = tmp_path / "g.fa"
        fa.write_text(f">g\n{_genome(seed=11, n=120000)}\n")
        recs = eng.load_fasta_file(str(fa))
        outs.add(run_search(eng, recs))
    assert len(outs) == 1  # unlike the reference's T>1 halo-dup bug
