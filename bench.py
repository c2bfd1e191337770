"""Benchmark: Mbp scanned/sec/chip on synthetic genome x STS workload.

Matches the reference baseline measurement (BASELINE.md: 10 Mbp random
genome x 1000 random STS, W=11 N=0 M=50 T=1 -> ~3.2 Mbp/s/core in pure
Python). Prints ONE JSON line with the north-star metric.

Usage: python bench.py [--mbp 10] [--nsts 1000] [--repeat 3]
       python bench.py --matrix          # every README row -> one JSON line
                                         # each + BENCH_MATRIX.json artifact
"""

from __future__ import annotations

import argparse
import io
import json
import os
import random
import sys
import tempfile
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_MBP_PER_S = 3.2  # BASELINE.md measured: reference CPU, T=1


def gen_data(
    tmpdir: str, n_mbp: float, n_sts: int, seed: int = 42, planted: int = 0,
    n_records: int = 1, content: str = "random", stsgen: str = "random",
    iupac_genome: float = 0.0,
):
    """Synthetic genome x STS; ``planted`` of the STS additionally get
    one real amplicon written into the genome (spread evenly), so the
    anchor/margin/emission stages do real work instead of scanning 0 hits.

    ``content`` picks the genome composition (uniform ``random``;
    ``masked_nruns`` = GRCh38-like ~5% N-runs + 50% soft-mask;
    ``lowcomplex`` = ~20% (AC)n/(AT)n/homopolymer tracts); ``stsgen``
    picks the STS shape (``random``; ``repeat`` = 20% repeat-tract
    primers; ``shared`` = heavy W-mer sharing across entries).
    ``iupac_genome`` scatters that fraction of IUPAC ambiguity letters
    into the genome (the dirty-genome IUPAC verify cost)."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    import workloads

    rng = random.Random(seed)
    n = int(n_mbp * 1e6)
    bases = "ACGT"
    if content == "masked_nruns":
        genome = list(workloads.gen_masked_nruns(rng, n))
    elif content == "lowcomplex":
        # GRCh38-like simple-repeat fraction (~3-5% of the genome)
        genome = list(workloads.gen_lowcomplex(rng, n, tract_frac=0.05))
    else:
        genome = list("".join(rng.choices(bases, k=n)))
    if iupac_genome > 0:
        ambigs = "NRYKMSWBDHV"
        for _ in range(int(n * iupac_genome)):
            genome[rng.randrange(n)] = rng.choice(ambigs)

    shared_wmers = [
        "".join(rng.choices(bases, k=11)) for _ in range(max(1, n_sts // 100))
    ]
    sts_path = os.path.join(tmpdir, "bench.sts")
    with open(sts_path, "w") as fh:
        for i in range(n_sts):
            p1 = "".join(rng.choices(bases, k=rng.randrange(18, 26)))
            if stsgen == "repeat" and i % 10 == 0:
                # realistic repeat-bearing primers: tract-prefixed with a
                # unique tail (front-end floods, verify prunes); every
                # 50th is a WHOLE tract (anchor flood — the reference's
                # own bucket loop would grind for hours on these)
                if i % 50 == 0:
                    p1 = workloads._tract(rng, len(p1))
                else:
                    head = workloads._tract(rng, 13)
                    p1 = (head + p1)[: len(p1)]
            elif stsgen == "shared":
                w = shared_wmers[i % len(shared_wmers)]
                p1 = (w + p1)[: len(p1)]
            p2 = "".join(rng.choices(bases, k=rng.randrange(18, 26)))
            size = rng.randrange(100, 400)
            if i < planted:
                pos = (n // (planted + 1)) * (i + 1)
                genome[pos : pos + len(p1)] = p1
                genome[pos + size - len(p2) : pos + size] = p2
            fh.write(f"BENCH{i}\t{p1}\t{p2}\t{size}\n")

    fa_path = os.path.join(tmpdir, "bench.fa")
    genome = "".join(genome)
    per = max(1, n // n_records)
    with open(fa_path, "w") as fh:
        for r in range(n_records):
            lo = r * per
            hi = n if r == n_records - 1 else lo + per
            fh.write(f">bench_seq_{r} synthetic\n")
            for i in range(lo, hi, 80):
                fh.write(genome[i : min(i + 80, hi)] + "\n")
    return sts_path, fa_path, n


def _cold_runs(sts_path, fa_path, margin, mismatches, three_prime, wordsize,
               iupac):
    """One-shot FRESH-PROCESS CLI wall times (interpreter + load + compile
    + scan + emit — what a run-once user actually pays): with the
    persistent XLA cache warm, and with it disabled.

    Each child takes the accelerator for itself, so the calling process
    must never have initialized JAX (``--cold-only``): a second process
    on a card fails for want of device memory."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    pp = os.environ.get("PYTHONPATH", "")
    pythonpath = here + (os.pathsep + pp if pp else "")
    cli = [
        sys.executable, "-m", "merpcr_tpu.cli", sts_path, fa_path,
        "-M", str(margin), "-N", str(mismatches), "-X", str(three_prime),
        "-W", str(wordsize), "-O", os.devnull,
    ]
    if iupac:
        cli += ["-I", "1"]
    out = {}
    keys = (
        ("cold_s", {}),
        # a SECOND fresh process: the first run persisted its rescan-
        # capacity seeds (engine._seed_store), so flood-content rows
        # converge in one wave here — the steady per-machine one-shot cost
        ("cold_repeat_s", {}),
        ("cold_nocache_s", {"MERPCR_TPU_CACHE": "0"}),
    )
    for key, extra in keys:
        t0 = time.perf_counter()
        r = subprocess.run(
            cli,
            env={**os.environ, **extra, "PYTHONPATH": pythonpath},
            capture_output=True,
            timeout=1800,
        )
        out[key] = round(time.perf_counter() - t0, 2)
        if r.returncode != 0:
            out[key + "_rc"] = r.returncode
    return out


def run_config(
    mbp=47.0, nsts=1000, repeat=3, mismatches=0, three_prime=1, iupac=0,
    margin=50, planted=0, records=1, wordsize=11, row=None,
    content="random", stsgen="random", iupac_genome=0.0,
):
    """Measure one workload; returns the one-line JSON result dict."""
    import merpcr_tpu

    with tempfile.TemporaryDirectory() as td:
        sts_path, fa_path, n = gen_data(
            td, mbp, nsts, planted=planted, n_records=records,
            content=content, stsgen=stsgen, iupac_genome=iupac_genome,
        )

        eng = merpcr_tpu.MerPCR(
            wordsize=wordsize,
            margin=margin,
            mismatches=mismatches,
            three_prime_match=three_prime,
            iupac_mode=iupac,
        )
        if os.environ.get("MERPCR_TPU_TILE_LEN"):  # tuning experiments
            eng._tile_len_override = int(os.environ["MERPCR_TPU_TILE_LEN"])
        assert eng.load_sts_file(sts_path)
        recs = eng.load_fasta_file(fa_path)

        # Warmup (compile + first run)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(recs, None)
        warmup_s = time.perf_counter() - t0

        times = []
        for _ in range(repeat):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with redirect_stdout(buf):
                hits = eng.search(recs, None)
            times.append(time.perf_counter() - t0)

        best = min(times)
        mbp_per_s = (n / 1e6) / best
        result = {
            "metric": "Mbp_scanned_per_sec_per_chip",
            "value": round(mbp_per_s, 2),
            "unit": "Mbp/s/chip",
            "vs_baseline": round(mbp_per_s / REF_MBP_PER_S, 2),
            "detail": {
                "genome_mbp": mbp,
                "n_sts": nsts,
                "records": records,
                "params": {
                    "W": wordsize, "M": margin, "N": mismatches,
                    "X": three_prime, "I": iupac, "planted": planted,
                },
                "best_s": round(best, 4),
                "all_s": [round(t, 4) for t in times],
                "warmup_s": round(warmup_s, 2),
                "hits": hits,
                "rescans": eng._rescan_count,
                "content": content,
                "stsgen": stsgen,
                "backend": __import__("jax").default_backend(),
            },
        }
        if row:
            result["detail"]["row"] = row
        return result


# Named workload rows for `python bench.py --matrix` (the reference's
# baseline-manager pattern, performance_baseline.py:233-302: store what
# you claim).
MATRIX = [
    ("sparse_100", dict(nsts=100)),
    ("sparse_1k", dict(nsts=1000)),
    ("sparse_10k", dict(nsts=10000)),
    ("chr1_250mbp", dict(mbp=250.0, nsts=1000)),
    ("dense_50k", dict(nsts=50000)),
    ("planted_200", dict(nsts=1000, planted=200)),
    ("iupac", dict(nsts=1000, iupac=1)),
    ("iupac_dirty", dict(nsts=1000, iupac=1, iupac_genome=0.01)),
    ("mismatch_1", dict(nsts=1000, mismatches=1)),
    ("mismatch_2", dict(nsts=1000, mismatches=2)),
    ("x0_no3prime", dict(nsts=1000, three_prime=0)),
    ("scaffolds_3000", dict(mbp=30.0, nsts=1000, records=3000)),
    # matched-size control for the stream row: the honest baseline for
    # "scaffold overhead" is a single record of the SAME 30 Mbp (fixed
    # per-search costs make smaller genomes read lower regardless of path)
    ("single_30mbp", dict(mbp=30.0, nsts=1000)),
    ("w12", dict(nsts=1000, wordsize=12)),
    ("w13", dict(nsts=1000, wordsize=13)),
    ("w14_multhash", dict(nsts=1000, wordsize=14)),
    ("w16_multhash", dict(nsts=1000, wordsize=16)),
    ("margin_1000", dict(nsts=1000, margin=1000, planted=100)),
    ("margin_10000", dict(nsts=1000, margin=10000, planted=100)),
    # realistic/adversarial CONTENT rows (reference is content-insensitive;
    # these prove the capacity model holds off uniform-random ACGT)
    ("masked_nruns", dict(nsts=1000, content="masked_nruns")),
    ("lowcomplex_repeat", dict(nsts=1000, content="lowcomplex",
                               stsgen="repeat")),
    ("shared_wmer_10k", dict(nsts=10000, stsgen="shared")),
]


def main():
    ap = argparse.ArgumentParser()
    # default mirrors BASELINE.json config #2 scale (human chr21 ~47 Mbp)
    ap.add_argument("--mbp", type=float, default=47.0)
    ap.add_argument("--nsts", type=int, default=1000)
    ap.add_argument("--repeat", type=int, default=3)
    # the other BASELINE.json config axes
    ap.add_argument("--mismatches", type=int, default=0, help="-N (config #3)")
    ap.add_argument("--three-prime", type=int, default=1, help="-X")
    ap.add_argument("--iupac", type=int, default=0, help="-I (config #4)")
    ap.add_argument("--margin", type=int, default=50, help="-M")
    ap.add_argument("--wordsize", type=int, default=11, help="-W")
    ap.add_argument(
        "--planted", type=int, default=0,
        help="plant this many real amplicons (hit-bearing workload)",
    )
    ap.add_argument(
        "--records", type=int, default=1,
        help="split the genome into this many FASTA records "
        "(scaffold-heavy workload: exercises record batching)",
    )
    ap.add_argument(
        "--matrix", nargs="?", const="BENCH_MATRIX.json", default=None,
        metavar="OUT.json",
        help="run every README row; one JSON line each + artifact file",
    )
    ap.add_argument(
        "--rows", default=None,
        help="with --matrix: comma-separated row names to run (default all)",
    )
    ap.add_argument(
        "--cold-only", nargs="?", const="BENCH_COLD.json", default=None,
        metavar="OUT.json",
        help="cold measurement pass: generate each matrix row's data and "
        "time fresh-process CLI runs ONLY (this process never initializes "
        "JAX, so each child can take the accelerator)",
    )
    ap.add_argument("--content", default="random",
                    help="genome content: random|masked_nruns|lowcomplex")
    ap.add_argument("--stsgen", default="random",
                    help="STS shape: random|repeat|shared")
    args = ap.parse_args()

    if args.cold_only:
        want = set(args.rows.split(",")) if args.rows else None
        results = []
        for row, cfg in MATRIX:
            if want and row not in want:
                continue
            with tempfile.TemporaryDirectory() as td:
                sts_path, fa_path, n = gen_data(
                    td, cfg.get("mbp", 47.0), cfg.get("nsts", 1000),
                    planted=cfg.get("planted", 0),
                    n_records=cfg.get("records", 1),
                    content=cfg.get("content", "random"),
                    stsgen=cfg.get("stsgen", "random"),
                    iupac_genome=cfg.get("iupac_genome", 0.0),
                )
                res = {
                    "row": row,
                    "genome_mbp": cfg.get("mbp", 47.0),
                    **_cold_runs(
                        sts_path, fa_path, cfg.get("margin", 50),
                        cfg.get("mismatches", 0),
                        cfg.get("three_prime", 1),
                        cfg.get("wordsize", 11), cfg.get("iupac", 0),
                    ),
                }
            print(json.dumps(res), flush=True)
            results.append(res)
        with open(args.cold_only, "w") as fh:
            json.dump(results, fh, indent=1)
        return

    if args.matrix:
        want = set(args.rows.split(",")) if args.rows else None
        # --rows refreshes the named rows IN PLACE when the artifact
        # already exists (partial reruns after a targeted change must not
        # drop the other rows); a full run still rewrites the file.
        prior = {}
        if want and os.path.exists(args.matrix):
            with open(args.matrix) as fh:
                for res in json.load(fh):
                    rname = res.get("detail", {}).get("row")
                    if rname is None:
                        print(
                            "warning: dropping matrix entry without "
                            "detail.row (old/hand-edited artifact?)",
                            file=sys.stderr,
                        )
                        continue
                    prior[rname] = res
        for row, cfg in MATRIX:
            if want and row not in want:
                continue
            res = run_config(repeat=args.repeat, row=row, **cfg)
            print(json.dumps(res), flush=True)
            prior[row] = res
        results = [prior[row] for row, _ in MATRIX if row in prior]
        with open(args.matrix, "w") as fh:
            json.dump(results, fh, indent=1)
        return

    result = run_config(
        mbp=args.mbp, nsts=args.nsts, repeat=args.repeat,
        mismatches=args.mismatches, three_prime=args.three_prime,
        iupac=args.iupac, margin=args.margin, planted=args.planted,
        records=args.records, wordsize=args.wordsize,
        content=args.content, stsgen=args.stsgen,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
