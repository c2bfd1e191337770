"""Sweep tile_len on the real bench path (sparse + dense + hits).

Larger tiles amortize per-tile fixed costs (dispatch, lax.map/cond
machinery, stage prologues) against linear gather work; smaller tiles
bound capacity sizes. Run on the GPU to decide TILE_LEN_BUCKETS' top end.

Usage: python tools/tile_len_sweep.py [log2_lens...]   (default 20 21 22)
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

LOGS = [int(g) for g in sys.argv[1:]] or [20, 21, 22]

for n_sts, planted in ((1000, 0), (50000, 0), (1000, 1000)):
    td = tempfile.mkdtemp(prefix=f"tlsweep{n_sts}_{planted}_")
    sp, fp, n = gen_data(td, 47.0, n_sts, planted=planted)
    for lg in LOGS:
        e = MerPCR(wordsize=11, margin=50)
        e._tile_len_override = 1 << lg
        assert e.load_sts_file(sp)
        recs = e.load_fasta_file(fp)
        with redirect_stdout(io.StringIO()):
            hits = e.search(recs, None)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                e.search(recs, None)
            best = min(best, time.perf_counter() - t0)
        print(
            f"n_sts={n_sts:6d} planted={planted:5d} L=2^{lg}"
            f"  {best*1e3:8.1f} ms  {n/1e6/best:7.1f} Mbp/s  hits={hits}",
            flush=True,
        )
