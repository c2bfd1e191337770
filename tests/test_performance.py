"""Performance smoke thresholds (mirrors reference tests/test_performance.py
structure; generous CI-safe bounds — the real perf tracking is bench.py)."""

import io
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

import merpcr_tpu

pytestmark = pytest.mark.performance

P1 = "GGCTCAGAGTATTTGGGATG"
P2 = "CTCTTGGAATCCTATCTCACTG"


def test_sts_load_speed(tmp_path):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(1000):
        a = "".join(rng.choice(list("ACGT"), size=22))
        b = "".join(rng.choice(list("ACGT"), size=22))
        lines.append(f"S{i}\t{a}\t{b}\t{150 + i % 200}")
    sts = tmp_path / "big.sts"
    sts.write_text("\n".join(lines) + "\n")
    eng = merpcr_tpu.MerPCR()
    t0 = time.time()
    assert eng.load_sts_file(str(sts))
    assert time.time() - t0 < 5.0
    assert len(eng.sts_records) == 2000


def test_search_100kb(tmp_path):
    rng = np.random.default_rng(1)
    g = "".join(rng.choice(list("ACGT"), size=100_000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">g\n{g}\n")
    sts = tmp_path / "s.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\n")
    eng = merpcr_tpu.MerPCR()
    eng.load_sts_file(str(sts))
    recs = eng.load_fasta_file(str(fa))
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs, None)  # warm/compile
    t0 = time.time()
    with redirect_stdout(buf):
        eng.search(recs, None)
    assert time.time() - t0 < 10.0


def test_length_scaling(tmp_path):
    """Warm-path time must scale sub-linearly x2 vs a 10x length increase
    (reference test_performance.py:254-265 allows ratio < 2x size ratio)."""
    rng = np.random.default_rng(2)
    sts = tmp_path / "s.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\n")

    def timed(n):
        g = "".join(rng.choice(list("ACGT"), size=n))
        fa = tmp_path / f"g{n}.fa"
        fa.write_text(f">g\n{g}\n")
        eng = merpcr_tpu.MerPCR()
        eng._tile_len_override = 1 << 15
        eng.load_sts_file(str(sts))
        recs = eng.load_fasta_file(str(fa))
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(recs, None)
        t0 = time.time()
        with redirect_stdout(buf):
            eng.search(recs, None)
        return time.time() - t0

    t_small = timed(1 << 15)
    t_big = timed(10 * (1 << 15))
    assert t_big < max(t_small, 0.05) * 20 * 2


def test_multi_size_scaling_ratios(tmp_path):
    """Reference test_performance.py:225-265 (TestScalability): warm-path
    time across 3 increasing sizes; every step's time ratio must stay
    under 2x the size ratio."""
    rng = np.random.default_rng(3)
    sts = tmp_path / "s.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\n")
    sizes = [1 << 15, 1 << 17, 1 << 19]
    times = []
    for n in sizes:
        g = "".join(rng.choice(list("ACGT"), size=n))
        fa = tmp_path / f"sc{n}.fa"
        fa.write_text(f">g\n{g}\n")
        eng = merpcr_tpu.MerPCR()
        eng._tile_len_override = 1 << 15
        eng.load_sts_file(str(sts))
        recs = eng.load_fasta_file(str(fa))
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(recs, None)  # compile warmup
        t0 = time.time()
        with redirect_stdout(buf):
            eng.search(recs, None)
        times.append(max(time.time() - t0, 0.02))  # timer-noise floor
    for i in range(1, len(sizes)):
        size_ratio = sizes[i] / sizes[i - 1]
        time_ratio = times[i] / times[i - 1]
        assert time_ratio < size_ratio * 2, (
            f"time scaling {time_ratio:.2f}x vs {size_ratio:.0f}x size"
        )


def test_memory_efficiency(tmp_path):
    """Reference test_performance.py:162-222: RSS growth across a search
    must stay bounded (<500 MB for a 1 Mbp x 1000-STS workload)."""
    psutil = pytest.importorskip("psutil")
    rng = np.random.default_rng(4)
    lines = []
    for i in range(1000):
        a = "".join(rng.choice(list("ACGT"), size=20))
        b = "".join(rng.choice(list("ACGT"), size=20))
        lines.append(f"S{i}\t{a}\t{b}\t{150 + i % 200}")
    sts = tmp_path / "mem.sts"
    sts.write_text("\n".join(lines) + "\n")
    g = "".join(rng.choice(list("ACGT"), size=1_000_000))
    fa = tmp_path / "mem.fa"
    fa.write_text(f">g\n{g}\n")

    proc = psutil.Process()
    eng = merpcr_tpu.MerPCR()
    assert eng.load_sts_file(str(sts))
    recs = eng.load_fasta_file(str(fa))
    before = proc.memory_info().rss / 1e6
    with open(os.devnull, "w") as devnull, redirect_stdout(devnull):
        eng.search(recs, None)
    grown = proc.memory_info().rss / 1e6 - before
    assert grown < 500, f"search grew RSS by {grown:.0f} MB"


def test_mesh_not_slower_than_single(tmp_path):
    """Device analogue of the reference's multi-thread-vs-single check
    (test_performance.py:150-158 allows multi <= 1.5x single): the 8-way
    sharded mesh warm path must not be catastrophically slower than the
    single-device path on the same record (virtual CPU devices give no
    real speedup — this guards dispatch/merge overhead regressions)."""
    import jax

    from merpcr_tpu.parallel.sharded import make_mesh

    rng = np.random.default_rng(5)
    sts = tmp_path / "s.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\n")
    g = "".join(rng.choice(list("ACGT"), size=1 << 19))
    fa = tmp_path / "m.fa"
    fa.write_text(f">g\n{g}\n")

    def timed(mesh):
        eng = merpcr_tpu.MerPCR()
        eng._tile_len_override = 1 << 15
        eng.load_sts_file(str(sts))
        if mesh is not None:
            eng.use_mesh(mesh)
        recs = eng.load_fasta_file(str(fa))
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(recs, None)
        t0 = time.time()
        with redirect_stdout(buf):
            eng.search(recs, None)
        return max(time.time() - t0, 0.02), buf.getvalue()

    t_single, _ = timed(None)
    t_mesh, _ = timed(make_mesh(jax.devices()))
    # 8 virtual devices timeshare 4 real cores: allow generous headroom,
    # still catches order-of-magnitude dispatch/merge regressions
    assert t_mesh < t_single * 6 + 1.0, (t_mesh, t_single)
