"""Oracle tests on realistic and adversarial genome CONTENT.

The reference's inner loop costs the same on any input
(/root/reference/src/merpcr/core/engine.py:481-505); this engine's capacity
heuristics were historically tuned on uniform-random ACGT only. These cases
pin byte-equality and bounded escalation on the content real genomes have:
soft-masked runs, megabase-style N-runs, low-complexity repeat tracts
colliding with repeat-bearing primers, and shared-W-mer-heavy STS sets
(the pathological many-entries-per-bucket table shape).
"""

import io
import os
import random
import sys
from contextlib import redirect_stdout

import pytest

import merpcr_tpu
from .conftest import REFERENCE_ROOT, needs_oracle

pytestmark = [pytest.mark.integration, needs_oracle]

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from workloads import (  # noqa: E402
    gen_lowcomplex,
    gen_masked_nruns,
    gen_shared_wmer_sts,
    gen_tandem_tract,
    sts_lines,
    sts_repeat_primers,
    write_fasta,
)


@pytest.fixture(scope="module")
def oracle_pkg():
    sys.path.insert(0, os.path.join(REFERENCE_ROOT, "src"))
    import merpcr as ref

    return ref


def _run(pkg, sts, fa, params):
    eng = pkg.MerPCR(**params)
    if not eng.load_sts_file(sts):
        return None, None
    recs = eng.load_fasta_file(fa)
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs, None)
    return buf.getvalue(), eng


def _case(tmp_path, sts_text, genome, params, oracle_pkg):
    sts = tmp_path / "w.sts"
    fa = tmp_path / "w.fa"
    sts.write_text(sts_text)
    write_fasta(str(fa), genome)
    ref_out, _ = _run(oracle_pkg, str(sts), str(fa), params)
    eng_out, eng = _run(merpcr_tpu, str(sts), str(fa), params)
    assert ref_out == eng_out
    return eng_out, eng


class TestDirtyBloomFilter:
    """The dirty-genome phase filter (ScanConfig.dirty_bloom, round 5):
    bypassed units' W-clean phases are pruned by exact W-mer-occupancy
    gathers. Deterministic byte-equality across the W tiers it touches —
    W<=12 (exact bloom), W=13 (exact, stride 2), W=14/16 (PREFIX-filter
    branch, shiftb > 0, and the non-exact_group `nbv & wbf` path)."""

    @pytest.mark.parametrize("wordsize", [11, 13, 14, 16])
    def test_dirty_genome_planted_hits_identical(
        self, oracle_pkg, tmp_path, wordsize
    ):
        rng = random.Random(41 + wordsize)
        n = 60_000
        g = list("".join(rng.choices("ACGT", k=n)))
        # 1% scattered ambiguity letters: arms dirty_bloom (w_pos >= 1/256)
        for _ in range(n // 100):
            g[rng.randrange(n)] = rng.choice("NRYKMSWBDHV")
        sts_lines = []
        for i in range(30):
            plen = rng.randrange(max(18, wordsize + 2), 26)
            p1 = "".join(rng.choices("ACGT", k=plen))
            p2 = "".join(rng.choices("ACGT", k=plen))
            size = rng.randrange(80, 300)
            if i < 12:  # plant; every 3rd site deliberately near dirt
                pos = rng.randrange(0, n - size - 1)
                g[pos : pos + plen] = p1
                g[pos + size - plen : pos + size] = p2
                if i % 3 == 0:
                    g[min(n - 1, pos + plen + 1)] = "R"
            sts_lines.append(f"D{i}\t{p1}\t{p2}\t{size}")
        for params in (
            dict(wordsize=wordsize, iupac_mode=1),
            dict(wordsize=wordsize, iupac_mode=0),
        ):
            out, eng = _case(
                tmp_path, "\n".join(sts_lines) + "\n", "".join(g),
                params, oracle_pkg,
            )
            assert out.count("\n") >= 6, (wordsize, params)  # real hits

    def test_corrupt_seed_store_survives(self, tmp_path, monkeypatch):
        """A corrupt/garbage rescan_seeds.json must never break a search
        (persistence is best-effort by contract)."""
        import merpcr_tpu.engine as E

        cache = tmp_path / "cache"
        cache.mkdir()
        (cache / "rescan_seeds.json").write_text("{not json!!")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
        monkeypatch.setattr(E, "_SEED_STORE", None)
        rng = random.Random(43)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 500, wordsize=11, n_buckets=1
        )
        genome = gen_tandem_tract(rng, 12_000, shared[0], tract_frac=0.12)
        sts = tmp_path / "w.sts"
        fa = tmp_path / "w.fa"
        sts.write_text(sts_text)
        write_fasta(str(fa), genome)
        out, eng = _run(
            merpcr_tpu, str(sts), str(fa), dict(margin=50, mismatches=2)
        )
        assert out is not None and eng._rescan_count >= 1
        monkeypatch.setattr(E, "_SEED_STORE", None)  # reload: now valid?
        out2, _ = _run(
            merpcr_tpu, str(sts), str(fa), dict(margin=50, mismatches=2)
        )
        assert out2 == out


class TestMaskedNRuns:
    def test_nrun_softmask_genome_identical(self, oracle_pkg, tmp_path):
        """GRCh38-like composition at test scale: long N-runs (~5%) +
        soft-masked runs (~50%), plus planted amplicons straddling run
        boundaries via lowercase-preserving content."""
        rng = random.Random(11)
        g = list(gen_masked_nruns(rng, 150_000, run_len=(2_000, 40_000)))
        sts_text = sts_lines(rng, 30)
        # plant a few real amplicons in whatever content is there (some
        # land inside N-runs -> no hit; some in masked runs -> hits, since
        # matching is case-insensitive)
        lines = [ln.split("\t") for ln in sts_text.strip().split("\n")]
        for i in range(0, 30, 3):
            _id, p1, p2, size = lines[i]
            pos = rng.randrange(0, len(g) - int(size) - 1)
            g[pos : pos + len(p1)] = p1.lower() if i % 2 else p1
            g[pos + int(size) - len(p2) : pos + int(size)] = p2
        _out, eng = _case(
            tmp_path, sts_text, "".join(g), dict(margin=50), oracle_pkg
        )
        # content must not trigger an escalation storm
        assert getattr(eng, "_rescan_count", 0) <= 2

    def test_n_run_boundary_windows(self, oracle_pkg, tmp_path):
        """W-mer validity at N-run edges: amplicons planted to start/end
        exactly at run boundaries."""
        rng = random.Random(12)
        g = list(rng.choices("ACGT", k=40_000))
        g[10_000:18_000] = ["N"] * 8_000
        sts_text = sts_lines(rng, 8)
        lines = [ln.split("\t") for ln in sts_text.strip().split("\n")]
        for i, pos in enumerate((9_700, 18_001, 9_950, 17_800)):
            _id, p1, p2, size = lines[i]
            g[pos : pos + len(p1)] = p1
            g[pos + int(size) - len(p2) : pos + int(size)] = p2
        _case(tmp_path, sts_text, "".join(g), dict(margin=50), oracle_pkg)


class TestLowComplexity:
    def test_repeat_genome_vs_repeat_primers_identical(
        self, oracle_pkg, tmp_path
    ):
        """(AC)n/(AT)n tracts against an STS set whose primers carry the
        same tracts: candidate/anchor floods must escalate, converge, and
        stay byte-identical."""
        rng = random.Random(13)
        genome = gen_lowcomplex(rng, 100_000, tract_frac=0.25)
        sts_text = sts_repeat_primers(rng, 50, repeat_frac=0.4)
        out, eng = _case(
            tmp_path, sts_text, genome, dict(margin=50), oracle_pkg
        )
        # escalation must have converged within the measured-total bound
        assert getattr(eng, "_rescan_count", 0) <= 15

    def test_homopolymer_tract_identical(self, oracle_pkg, tmp_path):
        rng = random.Random(14)
        g = list(rng.choices("ACGT", k=30_000))
        g[5_000:9_000] = ["A"] * 4_000
        sts_text = sts_lines(rng, 10, p1s=["A" * 21] + [None] * 9)
        _case(tmp_path, sts_text, "".join(g), dict(margin=50), oracle_pkg)


class TestSharedWmerFlood:
    """The VERDICT-prescribed adversarial shape: many STS sharing one
    W-mer, scanned against a tandem tract of that W-mer — the per-tile
    candidate load is positions_in_bucket x entries_in_bucket, far past
    every default capacity."""

    def test_loose_flood_converges_and_matches(self, oracle_pkg, tmp_path):
        rng = random.Random(15)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 1000, wordsize=11, n_buckets=1
        )
        genome = gen_tandem_tract(rng, 20_000, shared[0], tract_frac=0.12)
        # -N 2 runs the loose front end: every aligned tract position
        # expands the full 1000-entry bucket
        _out, eng = _case(
            tmp_path, sts_text, genome,
            dict(margin=50, mismatches=2), oracle_pkg,
        )
        assert eng._rescan_count >= 1  # the flood really overflowed
        assert eng._rescan_count <= 10  # and converged without a storm

    def test_strict_flood_with_matching_extensions(
        self, oracle_pkg, tmp_path
    ):
        """N=0 strict front end: entries whose whole primer1 is the tandem
        continuation survive t16 and flood the anchor stage."""
        rng = random.Random(16)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 500, wordsize=11, n_buckets=1, ext_match_frac=0.2
        )
        genome = gen_tandem_tract(rng, 20_000, shared[0], tract_frac=0.1)
        _case(tmp_path, sts_text, genome, dict(margin=50), oracle_pkg)

    def test_hit_flood_emission_order_under_escalation(
        self, oracle_pkg, tmp_path
    ):
        """Tandem primer1 AND primer2 on a tandem tract: every margin rank
        matches, so hits explode past hit_cap — ordering and content must
        survive the escalated rescan byte-identically."""
        rng = random.Random(17)
        unit = "ACGTACGTACG"  # 11-mer
        tandem = (unit * 3)[:20]
        sts_text = sts_lines(
            rng, 6, p1s=[tandem] * 3 + [None] * 3,
            p2s=[tandem] * 3 + [None] * 3,
        )
        g = list(rng.choices("ACGT", k=6_000))
        g[1_000:1_900] = (unit * 100)[:900]
        _out, eng = _case(
            tmp_path, sts_text, "".join(g), dict(margin=20), oracle_pkg
        )
        assert _out.count("\n") > 300  # really a hit flood
        assert eng._rescan_count >= 1

    def test_budget_split_rescan_identical(self, oracle_pkg, tmp_path,
                                           monkeypatch):
        """A flooded tile whose measured totals exceed the per-program
        HBM budget must split into subtiles (engine._rescan_span) and
        still emit byte-identical, correctly ordered output. Budget caps
        are shrunk so the split path runs at test scale."""
        from merpcr_tpu.engine import MerPCR

        monkeypatch.setattr(MerPCR, "MAX_CAND_CAP", 1 << 13)
        monkeypatch.setattr(MerPCR, "MAX_ANCH_CAP", 1 << 10)
        monkeypatch.setattr(MerPCR, "MAX_HIT_CAP", 1 << 12)
        monkeypatch.setattr(MerPCR, "MIN_SPLIT_LEN", 1 << 9)
        rng = random.Random(21)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 600, wordsize=11, n_buckets=1, ext_match_frac=0.15
        )
        genome = gen_tandem_tract(rng, 24_000, shared[0], tract_frac=0.25)
        _out, eng = _case(
            tmp_path, sts_text, genome,
            dict(margin=30, mismatches=2), oracle_pkg,
        )
        assert eng._rescan_count >= 2  # splitting really happened

    def test_repeat_search_uses_capacity_seeds(self, oracle_pkg, tmp_path):
        """A second search over the same flooded plane must converge with
        at most one rescan per overflowing tile (remembered exact totals
        seed the wave — engine._rescan_seeds)."""
        rng = random.Random(23)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 800, wordsize=11, n_buckets=1
        )
        genome = gen_tandem_tract(rng, 16_000, shared[0], tract_frac=0.12)
        sts = tmp_path / "w.sts"
        fa = tmp_path / "w.fa"
        sts.write_text(sts_text)
        write_fasta(str(fa), genome)
        out1, eng = _run(
            merpcr_tpu, str(sts), str(fa), dict(margin=50, mismatches=2)
        )
        r1 = eng._rescan_count
        assert r1 >= 1
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(eng.load_fasta_file(str(fa)), None)
        assert buf.getvalue() == out1
        r2 = eng._rescan_count - r1
        # seeded second search: no capacity re-discovery waves
        assert r2 <= r1, (r1, r2)

    def test_capacity_seeds_persist_across_processes(
        self, tmp_path, monkeypatch
    ):
        """Measured flood totals persist to <cache_dir>/rescan_seeds.json
        keyed by (table content, params) digest, and a FRESH engine in a
        fresh seed-store state picks them up: its discovery converges in
        at most one wave per overflowing span with byte-identical output
        (engine._seed_store; round-5 cold-flood fix)."""
        import json

        import merpcr_tpu.engine as E

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
        monkeypatch.setattr(E, "_SEED_STORE", None)  # fresh store state
        rng = random.Random(31)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 700, wordsize=11, n_buckets=1
        )
        genome = gen_tandem_tract(rng, 14_000, shared[0], tract_frac=0.12)
        sts = tmp_path / "w.sts"
        fa = tmp_path / "w.fa"
        sts.write_text(sts_text)
        write_fasta(str(fa), genome)
        out1, eng1 = _run(
            merpcr_tpu, str(sts), str(fa), dict(margin=50, mismatches=2)
        )
        r1 = eng1._rescan_count
        assert r1 >= 1  # the flood really overflowed
        store_path = tmp_path / "cache" / "rescan_seeds.json"
        assert store_path.exists()
        assert json.load(open(store_path))  # non-empty

        # "fresh process": new engine + module store reloaded from disk
        monkeypatch.setattr(E, "_SEED_STORE", None)
        out2, eng2 = _run(
            merpcr_tpu, str(sts), str(fa), dict(margin=50, mismatches=2)
        )
        assert out2 == out1
        # seeded discovery: one sized dispatch per overflowing span, no
        # escalation ladder (eng1 paid the multi-wave discovery)
        assert eng2._rescan_count <= r1, (r1, eng2._rescan_count)

    def test_many_buckets_shared(self, oracle_pkg, tmp_path):
        """Shared-W-mer-heavy set spread over several buckets (the
        realistic version: primer libraries share W-mers heavily)."""
        rng = random.Random(18)
        sts_text, shared = gen_shared_wmer_sts(
            rng, 400, wordsize=11, n_buckets=8
        )
        g = list(rng.choices("ACGT", k=50_000))
        for i, s in enumerate(shared):
            start = 5_000 * (i + 1)
            g[start : start + 3 * len(s)] = s * 3
        _case(tmp_path, sts_text, "".join(g), dict(margin=50), oracle_pkg)
