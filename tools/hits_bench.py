"""Throughput with REAL hits present (bench.py's random STS never match).

Plants one amplicon per STS across the genome at ~1 hit / 47 kb (about
human STS density), so anchor verify, margin pairing, and hit emission
all do real work, then measures search the same way bench.py does.

Usage: python tools/hits_bench.py [n_planted=1000] [mbp=47]
"""
import io
import random
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merpcr_tpu.engine import MerPCR  # noqa: E402

N_PLANT = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
MBP = float(sys.argv[2]) if len(sys.argv) > 2 else 47.0

rng = random.Random(11)
bases = "ACGT"
n = int(MBP * 1e6)
g = [rng.choice(bases) for _ in range(n)]
sts_lines = []
step = n // (N_PLANT + 1)
for i in range(N_PLANT):
    pos = step * (i + 1)
    p1 = "".join(rng.choice(bases) for _ in range(20))
    p2 = "".join(rng.choice(bases) for _ in range(20))
    size = rng.randrange(120, 350)
    g[pos : pos + 20] = list(p1)
    g[pos + size - 20 : pos + size] = list(p2)
    sts_lines.append(f"P{i}\t{p1}\t{p2}\t{size}")
for i in range(N_PLANT):
    p1 = "".join(rng.choice(bases) for _ in range(rng.randrange(18, 26)))
    p2 = "".join(rng.choice(bases) for _ in range(rng.randrange(18, 26)))
    sts_lines.append(f"R{i}\t{p1}\t{p2}\t{rng.randrange(100, 400)}")

td = tempfile.mkdtemp(prefix="hitsbench_")
fa, sp = td + "/g.fa", td + "/g.sts"
with open(fa, "w") as f:
    f.write(">hits synthetic\n")
    s = "".join(g)
    for j in range(0, n, 80):
        f.write(s[j : j + 80] + "\n")
with open(sp, "w") as f:
    f.write("\n".join(sts_lines) + "\n")

e = MerPCR(wordsize=11, margin=50)
assert e.load_sts_file(sp)
recs = e.load_fasta_file(fa)
with redirect_stdout(io.StringIO()):
    hits = e.search(recs, None)
best = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        e.search(recs, None)
    best = min(best, time.perf_counter() - t0)
print(
    f"hits={hits}  {best*1e3:8.1f} ms  {n/1e6/best:7.1f} Mbp/s"
)
