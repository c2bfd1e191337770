"""Differential tests against the reference implementation run in-process as
an oracle (the strongest correctness contract: byte-identical stdout on
randomized corpora across the full flag matrix). The heavy fuzzer lives in
tools/difffuzz.py; these are fixed-seed regression cases."""

import io
import os
import sys
from contextlib import redirect_stdout

import pytest

import merpcr_tpu
from .conftest import REFERENCE_ROOT, needs_oracle

pytestmark = [pytest.mark.integration, needs_oracle]

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


def _run(pkg, sts, fa, params):
    eng = pkg.MerPCR(**params)
    if not eng.load_sts_file(sts):
        return None
    recs = eng.load_fasta_file(fa)
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs, None)
    return buf.getvalue()


@pytest.fixture(scope="module")
def oracle_pkg():
    sys.path.insert(0, os.path.join(REFERENCE_ROOT, "src"))
    import merpcr as ref

    return ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_case_identical(seed, oracle_pkg, tmp_path):
    import random

    from difffuzz import gen_case

    rng = random.Random(seed * 1000 + 17)
    sts_text, fa_text, params = gen_case(rng, seed)
    sts = tmp_path / "t.sts"
    fa = tmp_path / "t.fa"
    sts.write_text(sts_text)
    fa.write_text(fa_text)
    ref_out = _run(oracle_pkg, str(sts), str(fa), params)
    eng_out = _run(merpcr_tpu, str(sts), str(fa), params)
    assert ref_out == eng_out


def test_multihit_margin_ordering(oracle_pkg, tmp_path):
    """Several primer2 matches inside one margin window: every match is a
    separate output line in expected-first-then-±i order (reference
    engine.py:543-593)."""
    p1 = "GGCTCAGAGTATTTGGGATG"
    p2 = "CCCCCCCCCCC"  # 11bp — can match at many window offsets
    sts = tmp_path / "t.sts"
    sts.write_text(f"S1\t{p1}\t{p2}\t60\n")
    genome = p1 + "C" * 80 + "ATATATATAT"
    fa = tmp_path / "t.fa"
    fa.write_text(f">g\n{genome}\n")
    params = dict(margin=20)
    ref_out = _run(oracle_pkg, str(sts), str(fa), params)
    eng_out = _run(merpcr_tpu, str(sts), str(fa), params)
    assert ref_out == eng_out
    assert len(ref_out.splitlines()) > 5  # really exercises multi-hit


def test_end_clamping(oracle_pkg, tmp_path):
    """Amplicon truncated by record end exercises the exp_size clamp
    (reference engine.py:527-541)."""
    p1 = "GGCTCAGAGTATTTGGGATG"
    p2 = "CTCTTGGAATCCTATCTCACTG"
    sts = tmp_path / "t.sts"
    sts.write_text(f"S1\t{p1}\t{p2}\t200\n")
    # genome ends exactly at primer2's end (product 150 < expected 200)
    import numpy as np

    rng = np.random.default_rng(0)
    mid = "".join(rng.choice(list("ACGT"), size=150 - len(p1) - len(p2)))
    genome = p1 + mid + p2
    fa = tmp_path / "t.fa"
    fa.write_text(f">g\n{genome}\n")
    for margin in (0, 50, 100):
        params = dict(margin=margin)
        assert _run(oracle_pkg, str(sts), str(fa), params) == _run(
            merpcr_tpu, str(sts), str(fa), params
        ), f"margin={margin}"


def test_extreme_params_identical(oracle_pkg, tmp_path):
    """Parameter extremes the fuzzer under-samples: giant margins (shape
    caps + windowed gather path), pcr_size clamping in both directions,
    and the wordsize bounds W=3 / W=16."""
    import random

    rng = random.Random(3)
    g = "".join(rng.choices("ACGT", k=3000))
    p1, p2 = g[500:522], g[700:720]  # real amplicon, size 220
    sts = tmp_path / "e.sts"
    sts.write_text(
        f"S1\t{p1}\t{p2}\t9000\n"      # expected size >> record: clamp path
        f"S2\t{p1}\t{p2}\t100-340\n"   # range average == exact size
        f"S3\t{p1}\t{p2}\t4\n"         # pcr_size < len(p1)+len(p2): clamp up
    )
    fa = tmp_path / "e.fa"
    fa.write_text(">edge rec\n" + "\n".join(
        g[i : i + 60] for i in range(0, len(g), 60)
    ) + "\n")
    for params in (
        dict(margin=2000),
        dict(margin=2000, wordsize=3),
        dict(wordsize=3),
        dict(margin=0, wordsize=16),
    ):
        ref_out = _run(oracle_pkg, str(sts), str(fa), params)
        eng_out = _run(merpcr_tpu, str(sts), str(fa), params)
        assert ref_out == eng_out, params
        assert ref_out  # non-degenerate: at least one hit somewhere


def test_anchor_chunk_boundary_ordering(oracle_pkg, tmp_path):
    """~90 anchors in one tile cross the margin stage's 32-anchor chunk
    boundaries (ops/scan.py anchor-chunked verify); several of them carry
    MULTIPLE margin-window products (multi-rank emission). The assembled
    emission order must stay byte-identical to the reference."""
    import random

    rng = random.Random(99)
    p1 = "GGCTCAGAGTATTTGGGATGCA"
    p2 = "CTCTTGGAATCCTATCTCACTG"
    n = 80_000
    g = list("".join(rng.choices("ACGT", k=n)))
    for i in range(90):
        s = 40 + i * 850
        g[s : s + len(p1)] = p1
        g[s + 200 - len(p2) : s + 200] = p2
        if i % 7 == 0:  # extra product in the same margin window
            g[s + 230 - len(p2) : s + 230] = p2
    sts = tmp_path / "t.sts"
    fa = tmp_path / "t.fa"
    sts.write_text(f"S1\t{p1}\t{p2}\t200\n")
    fa.write_text(">g\n" + "".join(g) + "\n")
    params = dict(margin=50)
    ref_out = _run(oracle_pkg, str(sts), str(fa), params)
    eng_out = _run(merpcr_tpu, str(sts), str(fa), params)
    assert ref_out.count("\n") > 95  # 90 plants + extra-window products
    assert ref_out == eng_out


def test_hit_overflow_escalates_byte_equal(oracle_pkg, tmp_path):
    """> hit_cap (256) hits inside ONE tile: per-chunk hit buffers
    truncate, the tile overflows, and the escalation rescan must emit the
    full byte-identical hit list (capacity invariant #4)."""
    import random

    rng = random.Random(7)
    p1 = "GGCTCAGAGTATTTGGGATGCA"
    p2 = "CTCTTGGAATCCTATCTCACTG"
    n = 120_000
    g = list("".join(rng.choices("ACGT", k=n)))
    for i in range(320):
        s = 11 + i * 370
        g[s : s + len(p1)] = p1
        g[s + 200 - len(p2) : s + 200] = p2
    sts = tmp_path / "t.sts"
    fa = tmp_path / "t.fa"
    sts.write_text(f"S1\t{p1}\t{p2}\t200\n")
    fa.write_text(">g\n" + "".join(g) + "\n")
    ref_out = _run(oracle_pkg, str(sts), str(fa), {})
    eng_out = _run(merpcr_tpu, str(sts), str(fa), {})
    assert ref_out.count("\n") >= 300
    assert ref_out == eng_out
