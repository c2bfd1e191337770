"""Actual per-tile stage totals (c/pos/pair/anch/hit) for the scaffold
stream vs the single-record control — what do the 3000 record gaps REALLY
add per tile, vs the capacity model's 3*gpt / 10*gpt terms?

Device diagnostic; not part of the test suite.
"""

import io
import os
import sys
import tempfile
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench
import merpcr_tpu

import jax

td = tempfile.mkdtemp()

for name, records in (("scaffolds", 3000), ("single", 1)):
    os.makedirs(td + f"/{name}", exist_ok=True)
    sts_path, fa_path, n = bench.gen_data(td + f"/{name}", 30.0, 1000,
                                          n_records=records)
    eng = merpcr_tpu.MerPCR()
    assert eng.load_sts_file(sts_path)
    recs = eng.load_fasta_file(fa_path)
    with redirect_stdout(io.StringIO()):
        eng.search(recs, None)
    plan = eng._plan_cache[1]
    if plan[0][0] == "stream":
        ctx = eng._dispatch_stream(plan[0][2])
        cfg0, pend = ctx[1], ctx[4]
        out = eng._fetch_outs(pend)
    else:
        from merpcr_tpu.io.fasta import record_packed, record_seq_bytes

        rec = recs[0]
        ctx = eng._dispatch_record(record_seq_bytes(rec), record_packed(rec))
        cfg0, pend = ctx[1], ctx[3]
        out = eng._fetch_outs(pend)
    print(f"{name}: caps cpos={cfg0.cpos_cap} pos={cfg0.pos_cap} "
          f"cand={cfg0.cand_cap} tile={cfg0.tile_len}")
    for f in ("c_total", "pos_total", "pair_total", "anch_total",
              "hit_total"):
        v = np.asarray(getattr(out, f))
        print(f"  {f:10s} max={v.max():>7} mean={v.mean():8.1f} all={list(v)}")
