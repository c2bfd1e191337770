#!/usr/bin/env python3
"""Performance baseline manager (parity with the reference's
scripts/performance_baseline.py:27-468): establish / compare / report
JSON baselines per platform, with synthetic dataset generation and
multi-run statistics.

Usage:
  python scripts/performance_baseline.py establish [--runs 5]
  python scripts/performance_baseline.py compare [--threshold 20]
  python scripts/performance_baseline.py report
"""

from __future__ import annotations

import argparse
import io
import json
import os
import platform
import random
import statistics
import sys
import tempfile
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "performance_baselines")


def platform_key() -> str:
    try:
        import jax

        backend = jax.default_backend()
    except Exception:
        backend = "none"
    return f"{platform.system().lower()}_{platform.machine()}_{backend}"


def gen_dataset(tmpdir: str, n_sts: int, fa_kb: int, seed: int = 42):
    rng = random.Random(seed)
    sts_path = os.path.join(tmpdir, f"sts_{n_sts}.sts")
    with open(sts_path, "w") as fh:
        for i in range(n_sts):
            p1 = "".join(rng.choices("ACGT", k=rng.randrange(18, 26)))
            p2 = "".join(rng.choices("ACGT", k=rng.randrange(18, 26)))
            fh.write(f"PB{i}\t{p1}\t{p2}\t{rng.randrange(100, 400)}\n")
    n = fa_kb * 1000
    fa_path = os.path.join(tmpdir, f"genome_{fa_kb}kb.fa")
    with open(fa_path, "w") as fh:
        fh.write(">pb_seq synthetic\n")
        g = "".join(rng.choices("ACGT", k=n))
        for i in range(0, n, 80):
            fh.write(g[i : i + 80] + "\n")
    return sts_path, fa_path


def run_benchmarks(runs: int) -> dict:
    import merpcr_tpu

    results = {}
    configs = [
        ("sts_load_1000", dict(n_sts=1000, fa_kb=10), "load"),
        ("search_500kb_100sts", dict(n_sts=100, fa_kb=500), "search"),
        ("search_500kb_1000sts", dict(n_sts=1000, fa_kb=500), "search"),
    ]
    with tempfile.TemporaryDirectory() as td:
        for name, cfg, kind in configs:
            sts, fa = gen_dataset(td, cfg["n_sts"], cfg["fa_kb"])
            times = []
            for r in range(runs):
                eng = merpcr_tpu.MerPCR()
                if kind == "load":
                    t0 = time.perf_counter()
                    assert eng.load_sts_file(sts)
                    times.append(time.perf_counter() - t0)
                else:
                    assert eng.load_sts_file(sts)
                    recs = eng.load_fasta_file(fa)
                    buf = io.StringIO()
                    with redirect_stdout(buf):
                        eng.search(recs, None)  # warm (compile)
                    t0 = time.perf_counter()
                    buf = io.StringIO()
                    with redirect_stdout(buf):
                        eng.search(recs, None)
                    times.append(time.perf_counter() - t0)
            results[name] = {
                "mean_s": statistics.mean(times),
                "median_s": statistics.median(times),
                "stdev_s": statistics.stdev(times) if len(times) > 1 else 0.0,
                "min_s": min(times),
                "runs": runs,
            }
    return results


def baseline_path() -> str:
    os.makedirs(BASELINE_DIR, exist_ok=True)
    return os.path.join(BASELINE_DIR, f"baseline_{platform_key()}.json")


def cmd_establish(args) -> int:
    results = run_benchmarks(args.runs)
    payload = {
        "platform": platform_key(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "python": platform.python_version(),
        "results": results,
    }
    with open(baseline_path(), "w") as fh:
        json.dump(payload, fh, indent=2)
    print(f"Baseline established: {baseline_path()}")
    for k, v in results.items():
        print(f"  {k}: {v['median_s']*1e3:.1f} ms (median of {v['runs']})")
    return 0


def cmd_compare(args) -> int:
    path = baseline_path()
    if not os.path.exists(path):
        print(f"No baseline for platform {platform_key()}; run 'establish' first")
        return 2
    with open(path) as fh:
        base = json.load(fh)
    current = run_benchmarks(args.runs)
    worst = 0.0
    for name, cur in current.items():
        old = base["results"].get(name)
        if not old:
            continue
        delta_pct = 100.0 * (cur["median_s"] - old["median_s"]) / old["median_s"]
        worst = max(worst, delta_pct)
        flag = "REGRESSION" if delta_pct > args.threshold else "ok"
        print(f"  {name}: {old['median_s']*1e3:.1f} -> {cur['median_s']*1e3:.1f} ms "
              f"({delta_pct:+.1f}%) [{flag}]")
    if worst > args.threshold:
        print(f"FAIL: worst regression {worst:.1f}% > threshold {args.threshold}%")
        return 1
    print("PASS: within threshold")
    return 0


def cmd_report(args) -> int:
    if not os.path.isdir(BASELINE_DIR):
        print("No baselines recorded")
        return 0
    for f in sorted(os.listdir(BASELINE_DIR)):
        with open(os.path.join(BASELINE_DIR, f)) as fh:
            data = json.load(fh)
        print(f"{f} ({data.get('timestamp')}):")
        for k, v in data.get("results", {}).items():
            print(f"  {k}: median {v['median_s']*1e3:.1f} ms ± {v['stdev_s']*1e3:.1f}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("establish")
    p.add_argument("--runs", type=int, default=5)
    p.set_defaults(fn=cmd_establish)
    p = sub.add_parser("compare")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--threshold", type=float, default=20.0)
    p.set_defaults(fn=cmd_compare)
    p = sub.add_parser("report")
    p.set_defaults(fn=cmd_report)
    args = ap.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
