"""Sweep MerPCR.TILE_GROUP on the real bench path (dense + sparse).

lax.map carries a per-iteration floor (see profile_stages.py); smaller
groups trade that floor for
more host-side async dispatches, which pipelining should hide. This
measures the end-to-end effect at both bench densities.

Usage: python tools/tile_group_sweep.py [groups...]
"""
import io
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import gen_data  # noqa: E402
from merpcr_tpu.engine import MerPCR  # noqa: E402

GROUPS = [int(g) for g in sys.argv[1:]] or [1, 2, 4, 8, 16, 32]

for n_sts in (1000, 50000):
    td = tempfile.mkdtemp(prefix=f"tgsweep{n_sts}_")
    sp, fp, n = gen_data(td, 47.0, n_sts)
    for g in GROUPS:
        MerPCR.TILE_GROUP = g
        e = MerPCR(wordsize=11, margin=50)
        assert e.load_sts_file(sp)
        recs = e.load_fasta_file(fp)
        with redirect_stdout(io.StringIO()):
            e.search(recs, None)  # warm: compile + plane cache
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                e.search(recs, None)
            best = min(best, time.perf_counter() - t0)
        print(
            f"n_sts={n_sts:6d} G={g:3d}  {best*1e3:8.1f} ms"
            f"  {n/1e6/best:7.1f} Mbp/s",
            flush=True,
        )
