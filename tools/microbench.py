#!/usr/bin/env python3
"""Consolidated microbenchmark lab: gather rate vs table size, bloom shape,
row gathers and scan primitives, on whatever device JAX picks.

Every mode uses the fori_loop-chained harness (the body iterated N times
inside ONE jit program with a data dependency), so per-dispatch launch
latency — often larger than the bodies under test — stays out of the
numbers.

Usage:
  python tools/microbench.py gather-size [--keys-log2 19]
  python tools/microbench.py bloom-shape
  python tools/microbench.py row-gather
  python tools/microbench.py scan-prims
  python tools/microbench.py all
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

ITERS = 20
rng = np.random.default_rng(0)


def timeit(name: str, body, n_items: int, *args) -> float:
    """Best-of-3 of ITERS chained body evaluations; prints per-iteration
    time and per-item rate. body(carry_scalar, *args) -> int32-summable."""

    def outer(*a):
        def it(i, acc):
            return acc + body(acc, *a).astype(jnp.int32)

        return jax.lax.fori_loop(0, ITERS, it, jnp.int32(0))

    f = jax.jit(outer)
    jax.device_get(f(*args))  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.device_get(f(*args))
        best = min(best, time.perf_counter() - t0)
    dt = best / ITERS
    rate = n_items / dt / 1e6
    print(f"{name:52s} {dt * 1e3:8.3f} ms  {rate:8.0f} M items/s"
          f"  ({dt / n_items * 1e9:5.2f} ns/item)")
    return dt


def mode_gather_size(keys_log2: int = 19) -> None:
    """Random-gather rate vs u32 table size, 0.25 MB .. 128 MB.

    The scan front end does one bit-table gather per stride-group
    (2^19 per 2-Mbp tile at S=4); this sweep exposes the VMEM/HBM rate
    cliffs that size the group/strict tables (ops/table.py)."""
    nk = 1 << keys_log2
    idx = jax.device_put(rng.integers(0, 1 << 28, size=nk, dtype=np.uint32))
    print(f"# gather-size: {nk} keys per iteration")
    for logbytes in (18, 20, 21, 22, 23, 24, 25, 26, 27):
        nwords = (1 << logbytes) // 4
        tab = jax.device_put(
            rng.integers(0, 1 << 31, size=nwords, dtype=np.uint32)
        )
        sh = 28 - (logbytes - 2)

        def g(acc, t, ix, sh=sh):
            ixx = (ix ^ acc.astype(jnp.uint32)) >> sh
            return jnp.sum(t[ixx.astype(jnp.int32)] & 1)

        mb = (1 << logbytes) / (1 << 20)
        timeit(f"u32 gather, {mb:6.2f} MB table", g, nk, tab, idx)


def mode_bloom_shape() -> None:
    """The production bloom-stage shape: 2 parity streams x 2^18 gathers
    (one 2-Mbp packed tile at stride 4) against each candidate table size,
    plus the nibble-fold arithmetic tail."""
    nk = 1 << 18
    print(f"# bloom-shape: 2 x {nk} keys per iteration")
    idx_a = jax.device_put(rng.integers(0, 1 << 28, size=nk, dtype=np.uint32))
    idx_b = jax.device_put(rng.integers(0, 1 << 28, size=nk, dtype=np.uint32))
    for logbytes in (21, 23, 25, 27):
        nwords = (1 << logbytes) // 4
        tab = jax.device_put(
            rng.integers(0, 1 << 31, size=nwords, dtype=np.uint32)
        )
        sh = 28 - (logbytes - 2)

        def g2(acc, t, ia, ib, sh=sh):
            s = jnp.int32(0)
            for ix in (ia, ib):
                ixx = (ix ^ acc.astype(jnp.uint32)) >> sh
                s = s + jnp.sum(t[ixx.astype(jnp.int32)] & 1)
            return s

        mb = (1 << logbytes) / (1 << 20)
        timeit(f"2-parity gather, {mb:6.1f} MB table", g2, 2 * nk, tab,
               idx_a, idx_b)

    # phase-nibble extraction tail (4 flag streams from one gathered word)
    nwords = (1 << 25) // 4
    tab = jax.device_put(rng.integers(0, 1 << 31, size=nwords, dtype=np.uint32))

    def gph(acc, t, ix):
        ixx = ix ^ acc.astype(jnp.uint32)
        word = t[((ixx >> 3) & jnp.uint32(nwords - 1)).astype(jnp.int32)]
        nb = word >> ((ixx & 7) * jnp.uint32(4))
        s = jnp.int32(0)
        for d in range(4):
            s = s + jnp.sum(((nb >> d) & 1).astype(jnp.int32))
        return s

    timeit("32 MB gather + nibble extract + 4 flags", gph, nk, tab, idx_a)


def mode_row_gather() -> None:
    """u8/u32 ROW gathers (the verify stage's primer-byte reads): gather
    cost on this hardware is per ROW, not per element — wide rows are
    nearly free (drives the one-gather-per-candidate verify layout,
    ops/scan.py)."""
    TB = 1 << 21
    nc = 1 << 17
    plane8 = jnp.asarray(rng.integers(0, 255, (TB // 8, 8), dtype=np.uint8))
    print(f"# row-gather: {nc} rows per iteration")
    for width in (8, 16, 32):
        plane = plane8.reshape(TB // width, width)
        ridx = jnp.asarray(
            rng.integers(0, TB // width - 4, nc, dtype=np.int32)
        )

        def rowg(acc, ridx, plane):
            r = plane[ridx ^ (acc & 1)]
            return jnp.sum(r.astype(jnp.int32))

        timeit(f"u8 row-gather width={width}", rowg, nc * width, ridx, plane)

    tabw = jnp.asarray(
        rng.integers(0, 1 << 31, (1 << 14, 16), dtype=np.uint32)
    )
    ridx = jnp.asarray(rng.integers(0, 1 << 14, nc, dtype=np.int32))

    def rowg32(acc, ridx, tab):
        return jnp.sum(tab[ridx ^ (acc & 1)]).astype(jnp.int32)

    timeit("u32 row-gather width=16", rowg32, nc * 16, ridx, tabw)


def mode_scan_prims() -> None:
    """Compaction-pipeline primitives: scatter-set, cummax/cumsum,
    searchsorted (rank inversion) — the building blocks of the
    count/compact stages in ops/scan.py."""
    print("# scan-prims")
    for logN in (15, 17):
        N = 1 << logN
        idx = jnp.asarray(
            np.sort(rng.choice(1 << 20, N, replace=False)).astype(np.int32)
        )
        val = jnp.asarray(rng.integers(0, 1 << 20, N, dtype=np.int32))

        def scatter_set(acc, idx, val):
            out = jnp.zeros((1 << 20,), jnp.int32)
            out = out.at[idx ^ acc].set(val)
            return jnp.sum(out)

        timeit(f"scatter-set N=2^{logN} into 2^20", scatter_set, N, idx, val)

    x = jnp.asarray(rng.integers(0, 1 << 20, 1 << 17, dtype=np.int32))

    def cmax(acc, x):
        return jnp.sum(jax.lax.cummax(x ^ acc, axis=0))

    def csum(acc, x):
        return jnp.sum(jnp.cumsum(x ^ acc))

    timeit("cummax 2^17", cmax, 1 << 17, x)
    timeit("cumsum 2^17", csum, 1 << 17, x)

    cum = jnp.asarray(
        np.cumsum(rng.integers(0, 4, 1 << 17, dtype=np.int32)).astype(np.int32)
    )
    q = jnp.asarray(np.arange(1 << 17, dtype=np.int32))

    def ssort(acc, cum, q):
        return jnp.sum(jnp.searchsorted(cum, q ^ acc, side="right"))

    timeit("searchsorted 2^17 q / 2^17 tab", ssort, 1 << 17, cum, q)


def mode_blocked_scan() -> None:
    """1-D cummax/cumsum vs blocked 2-D relayout scans at the compaction-
    stage sizes (rank inversion over cpos/pos caps, ~8k-32k lanes) — and
    variable-amount shifts vs constant-shift binary selects (the
    scan-pipeline bit tests)."""
    print("# blocked-scan")
    IMIN = jnp.int32(-(1 << 31))

    def blocked_cummax(x, lanes=512):
        n = x.shape[0]
        r = n // lanes
        x2 = x.reshape(r, lanes)
        k = 1
        while k < lanes:
            sh = jnp.pad(x2, ((0, 0), (k, 0)), constant_values=-(1 << 31))[
                :, :lanes
            ]
            x2 = jnp.maximum(x2, sh)
            k *= 2
        row_pre = jax.lax.cummax(x2[:, -1], axis=0)
        excl = jnp.concatenate([IMIN[None], row_pre[:-1]])
        return jnp.maximum(x2, excl[:, None]).reshape(n)

    for logN in (13, 14, 15):
        N = 1 << logN
        x = jnp.asarray(rng.integers(0, 1 << 20, N, dtype=np.int32))

        def cmax(acc, x):
            return jnp.sum(jax.lax.cummax(x ^ (acc & 1), axis=0))

        def bmax(acc, x):
            return jnp.sum(blocked_cummax(x ^ (acc & 1)))

        timeit(f"lax.cummax 2^{logN}", cmax, N, x)
        timeit(f"blocked cummax 2^{logN} (512 lanes)", bmax, N, x)

    # variable vs constant-shift bit extraction at front-end scale
    N = 1 << 19
    w = jnp.asarray(rng.integers(0, 1 << 31, N, dtype=np.int64).astype(np.int32))
    b = jnp.asarray(rng.integers(0, 32, N, dtype=np.int32))

    def var_shift(acc, w, b):
        return jnp.sum((w >> (b ^ (acc & 1))) & 1)

    def const_sel(acc, w, b):
        bb = b ^ (acc & 1)
        x = w
        for k in (16, 8, 4, 2, 1):
            x = jnp.where((bb & k) != 0, x >> k, x)
        return jnp.sum(x & 1)

    timeit("variable-amount shift 2^19", var_shift, N, w, b)
    timeit("constant-shift select 2^19", const_sel, N, w, b)


MODES = {
    "gather-size": mode_gather_size,
    "bloom-shape": mode_bloom_shape,
    "row-gather": mode_row_gather,
    "scan-prims": mode_scan_prims,
    "blocked-scan": mode_blocked_scan,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=[*MODES, "all"])
    ap.add_argument("--keys-log2", type=int, default=19)
    args = ap.parse_args()
    print(f"backend: {jax.default_backend()}, devices: {len(jax.devices())}")
    if args.mode == "all":
        for name, fn in MODES.items():
            print(f"\n=== {name} ===")
            fn(args.keys_log2) if name == "gather-size" else fn()
    elif args.mode == "gather-size":
        mode_gather_size(args.keys_log2)
    else:
        MODES[args.mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
