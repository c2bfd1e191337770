"""A/B: unrolled record-scan group (Python loop in one jit) vs lax.map.

lax.map pays a per-tile iteration cost (tile_group_sweep.py measures
it); unrolling keeps one dispatch per group without the scan machinery, at
the price of compiling the tile body G times.

Usage: python tools/unroll_sweep.py [groups...]
"""
import io
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout
from functools import lru_cache

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import gen_data  # noqa: E402
import merpcr_tpu.ops.scan as scan_mod  # noqa: E402
from merpcr_tpu.engine import MerPCR  # noqa: E402

GROUPS = [int(g) for g in sys.argv[1:]] or [4, 8]


@lru_cache(maxsize=64)
def get_unrolled_fn(cfg, n_tiles):
    stride = cfg.tile_len // 2 if cfg.packed else cfg.tile_len

    def f(table, padded, start0, total_scan, record_len, rt):
        outs = []
        for t in range(n_tiles):
            tb = jax.lax.dynamic_slice(
                padded, (t * stride,), (cfg.tile_buf_in,)
            )
            gstart = start0 + jnp.int32(t * cfg.tile_len)
            n_scan = jnp.clip(total_scan - gstart, 0, cfg.tile_len)
            outs.append(
                scan_mod._scan_tile(
                    cfg, table, tb, gstart, n_scan, record_len, rt
                )
            )
        return scan_mod.ScanOut(
            *(jnp.stack(cols) for cols in zip(*outs))
        )

    return jax.jit(f)


scan_mod.get_record_scan_fn = get_unrolled_fn
import merpcr_tpu.engine as eng_mod  # noqa: E402

for n_sts in (50000, 1000):
    td = tempfile.mkdtemp(prefix=f"unroll{n_sts}_")
    sp, fp, n = gen_data(td, 47.0, n_sts)
    for g in GROUPS:
        MerPCR.TILE_GROUP = g
        e = MerPCR(wordsize=11, margin=50)
        assert e.load_sts_file(sp)
        recs = e.load_fasta_file(fp)
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            e.search(recs, None)  # warm: compile + plane cache
        warm = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                e.search(recs, None)
            best = min(best, time.perf_counter() - t0)
        print(
            f"n_sts={n_sts:6d} G={g:3d} unrolled  {best*1e3:8.1f} ms"
            f"  {n/1e6/best:7.1f} Mbp/s   (warm+compile {warm:.1f}s)",
            flush=True,
        )
