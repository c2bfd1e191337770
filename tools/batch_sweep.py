"""Batched small-record scan: lax.map vs vmap (scaffold-heavy workload).

Scaffold-heavy input (bench.py --records 3000) pays per-tile fixed cost
inside the batched lax.map (sequential per-iteration machinery
+ the margin stage's cond). vmap vectorizes the 64-row batch front end into
one wide program (the cond becomes select: padding rows compute, but there
are at most 2x-1 of them). This tool times both forms at production shapes.

Usage: python tools/batch_sweep.py [n_sts] [log2_tile] [batch]
"""

import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from merpcr_tpu.io.sts import STSLoader
from merpcr_tpu.ops import scan as S
from merpcr_tpu.ops.table import compile_table

N_STS = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
LOG2L = int(sys.argv[2]) if len(sys.argv) > 2 else 15
B = int(sys.argv[3]) if len(sys.argv) > 3 else 64

rng = random.Random(0)
td = tempfile.mkdtemp()
sp = os.path.join(td, "b.sts")
with open(sp, "w") as fh:
    for i in range(N_STS):
        p1 = "".join(rng.choices("ACGT", k=22))
        p2 = "".join(rng.choices("ACGT", k=22))
        fh.write(f"S{i}\t{p1}\t{p2}\t{rng.randrange(100, 400)}\n")
res = STSLoader.load_file(sp, 11, 240)
table, meta = compile_table(res, 11, False)
L = 1 << LOG2L
cfg = S.default_config(
    11, 50, 0, 1, meta.lead, res.max_pcr_size, meta.p1_max,
    meta.p2_max, meta.bloom_bits, tile_len=L, n_entries=meta.n_entries,
    stride=meta.stride, qbloom_bits=meta.qbloom_bits, n_unique=meta.n_unique,
    exact_group=meta.exact_group, strict=meta.strict, t16_bits=meta.t16_bits,
    q_density=meta.q_density,
    sq_density=meta.sq_density, sp_density=meta.sp_density,
    t16_real=meta.t16_real, t16_fp=meta.t16_fp,
)
print(f"n_sts={N_STS} L=2^{LOG2L} B={B} caps: {cfg.cpos_cap} {cfg.pos_cap} "
      f"{cfg.cand_cap} {cfg.anch_cap}")

planes = np.random.default_rng(0).integers(
    0, 255, (B, cfg.tile_buf_in), dtype=np.uint8
)
planes_d = jax.device_put(planes)
tile_start = np.zeros(B, dtype=np.int32)
total_scan = np.full(B, L, dtype=np.int32)
record_len = np.full(B, L + 11 - 1, dtype=np.int32)
rt = np.asarray([50, 0, 1], dtype=np.int32)


def run_map(table, planes, tile_start, total_scan, record_len, rt):
    def body(b):
        n_scan = jnp.clip(total_scan[b] - tile_start[b], 0, cfg.tile_len)
        return S._scan_tile(
            cfg, table, planes[b], tile_start[b], n_scan, record_len[b], rt
        )

    return jax.lax.map(body, jnp.arange(B, dtype=jnp.int32))


def run_vmap(table, planes, tile_start, total_scan, record_len, rt):
    def body(plane, ts, tot, rl):
        n_scan = jnp.clip(tot - ts, 0, cfg.tile_len)
        return S._scan_tile(cfg, table, plane, ts, n_scan, rl, rt)

    return jax.vmap(body, in_axes=(0, 0, 0, 0))(
        planes, tile_start, total_scan, record_len
    )


for name, fn in (("lax.map", run_map), ("vmap", run_vmap)):
    f = jax.jit(fn)
    t0 = time.perf_counter()
    out = jax.device_get(
        f(table, planes_d, tile_start, total_scan, record_len, rt)
    )
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        out = jax.device_get(
            f(table, planes_d, tile_start, total_scan, record_len, rt)
        )
        best = min(best, time.perf_counter() - t0)
    per_rec = best / B
    print(
        f"{name:8s} {best * 1e3:9.3f} ms/batch  {per_rec * 1e3:7.3f} ms/rec"
        f"  {B * L / best / 1e6:8.0f} Mbp/s  (compile {compile_s:.1f}s)"
    )
