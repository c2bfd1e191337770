"""Host (NumPy) small-input fast path: byte-equality with the device
pipeline and with the reference oracle, flood fallback, and the
no-jax-import guarantee (ops/host_scan.py)."""

import io
import os
import random
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

import merpcr_tpu
from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, needs_golden, needs_oracle

pytestmark = pytest.mark.integration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _search(eng, recs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs, None)
    return buf.getvalue()


def _run_both_paths(monkeypatch, sts, fa, **params):
    """Search the same corpus with host routing on and off."""
    outs = {}
    for mode, limit in (("host", "1000000000"), ("device", "0")):
        monkeypatch.setenv("MERPCR_TPU_HOST_MAX", limit)
        eng = merpcr_tpu.MerPCR(**params)
        if not eng.load_sts_file(sts):  # malformed generated STS: both
            outs[mode] = None  # paths must agree on the failure
            continue
        outs[mode] = _search(eng, eng.load_fasta_file(fa))
    return outs


@needs_golden
def test_golden_on_host_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "1000000000")
    eng = merpcr_tpu.MerPCR()
    assert eng.load_sts_file(GOLDEN_STS)
    out = _search(eng, eng.load_fasta_file(GOLDEN_FA))
    assert out == GOLDEN_LINE + "\n"


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_host_equals_device(seed, monkeypatch, tmp_path):
    """Randomized corpora (incl. planted hits, IUPAC, mismatches,
    margins): host rows must produce byte-identical output to the
    device pipeline."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from difffuzz import gen_case

    rng = random.Random(seed * 7919 + 3)
    sts_text, fa_text, params = gen_case(rng, seed)
    sts = tmp_path / "h.sts"
    fa = tmp_path / "h.fa"
    sts.write_text(sts_text)
    fa.write_text(fa_text)
    outs = _run_both_paths(monkeypatch, str(sts), str(fa), **params)
    assert outs["host"] == outs["device"]


def test_flood_falls_back_to_device(monkeypatch, tmp_path):
    """Candidate floods past the host caps must fall back to the device
    path (and still match it exactly)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import workloads

    rng = random.Random(99)
    sts_text, shared = workloads.gen_shared_wmer_sts(rng, 800, n_buckets=1)
    genome = workloads.gen_tandem_tract(rng, 15_000, shared[0], tract_frac=0.2)
    sts = tmp_path / "f.sts"
    fa = tmp_path / "f.fa"
    sts.write_text(sts_text)
    workloads.write_fasta(str(fa), genome)
    outs = _run_both_paths(
        monkeypatch, str(sts), str(fa), mismatches=2, margin=50
    )
    assert outs["host"] == outs["device"]


def test_host_cap_escape_returns_none():
    from merpcr_tpu.ops import host_scan

    # sanity on the escape contract itself: a None return is the ONLY
    # non-array outcome (the engine relies on it)
    assert host_scan.MAX_CANDIDATES > 0 and host_scan.MAX_WINDOW_WORK > 0


@needs_golden
def test_small_run_never_imports_jax():
    """The whole point of the host path: a small one-shot CLI run must
    not import jax (startup dominates small workloads)."""
    code = (
        "import sys\n"
        "from merpcr_tpu.cli import main\n"
        f"rc = main(['{GOLDEN_STS}', '{GOLDEN_FA}', '-O', 'out.tmp'])\n"
        "assert rc == 0\n"
        "assert 'jax' not in sys.modules, 'jax imported on host path'\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO, "MERPCR_TPU_HOST_MAX": "2000000"}
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr


@needs_oracle
@pytest.mark.parametrize("flags", [
    dict(),
    dict(margin=0),
    dict(mismatches=1, three_prime_match=0),
    dict(iupac_mode=1, mismatches=1),
    dict(wordsize=8),
])
def test_host_path_vs_reference(flags, monkeypatch, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "reference_src_unused"))
    sys.path.insert(0, os.path.join("/root/reference", "src"))
    import merpcr as ref

    rng = random.Random(hash(tuple(sorted(flags.items()))) & 0xFFFF)
    p1 = "".join(rng.choices("ACGT", k=20))
    p2 = "".join(rng.choices("ACGT", k=20))
    g = list(rng.choices("ACGT", k=30_000))
    for pos in (500, 7_000, 22_000):
        g[pos : pos + 20] = p1
        g[pos + 180 - 20 : pos + 180] = p2
    sts = tmp_path / "r.sts"
    fa = tmp_path / "r.fa"
    sts.write_text(f"R1\t{p1}\t{p2}\t180\n")
    fa.write_text(">r\n" + "".join(g) + "\n")

    def run(pkg):
        eng = pkg.MerPCR(**flags)
        assert eng.load_sts_file(str(sts))
        return _search(eng, eng.load_fasta_file(str(fa)))

    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "1000000000")
    assert run(merpcr_tpu) == run(ref)


@pytest.mark.parametrize("mismatches", [0, 1])
def test_uncapped_host_scan_equals_device(mismatches, monkeypatch, tmp_path):
    """A flood corpus past the small-input caps: the capped scan bows out
    (None), and the lifted-cap scan (the reference chip_smoke.py compares
    device output with) emits exactly what the device pipeline does."""
    sys.path.insert(0, REPO)
    import bench
    from merpcr_tpu.io.fasta import record_seq_bytes
    from merpcr_tpu.ops.host_scan import host_scan_record

    sts, fa, _n = bench.gen_data(
        str(tmp_path), 0.05, 1000, planted=5,
        content="lowcomplex", stsgen="repeat",
    )
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    eng = merpcr_tpu.MerPCR(mismatches=mismatches)
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    device = _search(eng, recs)
    args = (eng._table_host, eng._meta, record_seq_bytes(recs[0]),
            eng.margin, eng.mismatches, eng.three_prime_match)
    assert host_scan_record(*args) is None
    buf = io.StringIO()
    eng.emit_hits(recs[0].label, host_scan_record(*args, capped=False), buf)
    assert buf.getvalue() == device
    assert device.count("\n") >= 5
