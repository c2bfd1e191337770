"""Per-stage timing of the PRODUCTION tile scan pipeline via the stop= hook
in _scan_tile_impl, using on-device loop chaining (one dispatch runs N
iterations, so dispatch latency stays out of the measurements).

Usage: python tools/profile_stages.py [n_sts] [log2_tile_len]
"""

import sys, os, time, tempfile, random

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax, jax.numpy as jnp
from merpcr_tpu.ops import scan as S
from merpcr_tpu.ops.table import compile_table
from merpcr_tpu.io.sts import STSLoader

N_STS = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
LOG2L = int(sys.argv[2]) if len(sys.argv) > 2 else 21

rng = random.Random(0)
td = tempfile.mkdtemp()
sp = os.path.join(td, "b.sts")
with open(sp, "w") as fh:
    for i in range(N_STS):
        p1 = "".join(rng.choices("ACGT", k=22))
        p2 = "".join(rng.choices("ACGT", k=22))
        fh.write(f"S{i}\t{p1}\t{p2}\t{rng.randrange(100,400)}\n")
res = STSLoader.load_file(sp, 11, 240)
table, meta = compile_table(res, 11, False)
L = 1 << LOG2L
cfg = S.default_config(
    11, 50, 0, 1, meta.lead, res.max_pcr_size, meta.p1_max,
    meta.p2_max, meta.bloom_bits, tile_len=L, n_entries=meta.n_entries,
    stride=meta.stride, qbloom_bits=meta.qbloom_bits, n_unique=meta.n_unique,
    exact_group=meta.exact_group,
    # production front end: strict + t16 exactly as engine._base_config
    strict=meta.strict, t16_bits=meta.t16_bits,
    q_density=meta.q_density,
    sq_density=meta.sq_density, sp_density=meta.sp_density,
    t16_real=meta.t16_real, t16_fp=meta.t16_fp,
)
if os.environ.get("PROFILE_LOOSE"):
    import dataclasses

    cfg = dataclasses.replace(cfg, strict=False, t16_bits=0)
print(f"n_sts={N_STS} L=2^{LOG2L} packed={cfg.packed} "
      f"stride={cfg.stride} qbits={cfg.qbloom_bits} strict={cfg.strict} "
      f"t16={cfg.t16_bits}")
print("caps:", cfg.cpos_cap, cfg.cand_cap, cfg.anch_cap, cfg.hit_cap)
rt = jnp.asarray([50, 0, 1], dtype=jnp.int32)

# random packed genome bytes (2 bases/byte, codes 0..3)
nbytes = cfg.tile_buf_in
raw = np.asarray(
    [rng.randrange(4) | (rng.randrange(4) << 4) for _ in range(nbytes)],
    dtype=np.uint8,
)
tbd = jax.device_put(raw)
n_scan = jnp.int32(L)
record_len = jnp.int32(100_000_000)
tile_start = jnp.int32(0)
N = 20


def timeit(name, body):
    def outer(tb):
        def it(i, acc):
            tb2 = tb ^ (acc & 1).astype(jnp.uint8)  # defeat CSE across iters
            return acc + body(tb2)
        return jax.lax.fori_loop(0, N, it, jnp.int32(0))

    f = jax.jit(outer)
    _ = jax.device_get(f(tbd))  # compile + warm
    best = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        _ = jax.device_get(f(tbd))
        best = min(best, time.perf_counter() - t0)
    dt = best / N
    print(f"{name:20s} {dt*1e3:9.3f} ms/tile  {L/dt/1e6:8.0f} Mbp/s")
    return dt


def staged(stage):
    def body(tb):
        o = S._scan_tile_impl(cfg, table, tb, tile_start, n_scan, record_len,
                              rt, stop=stage)
        return o.c_total
    return body


def full(tb):
    o = S._scan_tile_impl(cfg, table, tb, tile_start, n_scan, record_len, rt)
    return (
        o.c_total + o.pair_total + o.anch_total + o.hit_total + jnp.sum(o.pos1)
    ).astype(jnp.int32)


ALL_STAGES = ["hash", "bloom", "words", "nonzero", "compact", "nb",
              "posrank", "posg2", "pos", "expand", "p1"]
stages = (
    os.environ["PROFILE_STAGES"].split(",")
    if os.environ.get("PROFILE_STAGES")
    else ALL_STAGES
)


def _floor(tb):
    return jnp.sum(tb.astype(jnp.int32))


if stages is ALL_STAGES or "floor" in stages:
    timeit("(harness floor)", _floor)
prev = 0.0
for st in stages:
    if st == "floor":
        continue
    dt = timeit(st, staged(st))
    print(f"{'':20s} {'':>9s}  delta {max(dt-prev,0)*1e3:7.3f} ms")
    prev = dt
timeit("FULL", full)
