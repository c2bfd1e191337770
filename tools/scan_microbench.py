"""Microbench: ``_rank_invert`` as shipped vs the blocked-scan variant.

``_rank_invert`` (ops/scan.py) runs at every compaction/expansion stage of
a tile: units, positions, pairs and hits. This times it at the capacities
the chr21-scale workload compiles (47 Mbp single record, 1,000 random STS,
W=11 M=50 N=0, one 2^23-position tile — the smoke test's phase 2) in two
forms:

  * shipped: 1-D ``lax.cumsum`` / ``lax.cummax`` left to XLA;
  * blocked: log-shifted ``op`` steps on a (n/128, 128) relayout, no scan
    primitive (the form the pipeline used before it ran on GPUs; it lost
    to the shipped form on an H100 at every stage but the 8-source hits
    inversion, where the two tied).

Each form chains N_ITER data-dependent calls inside one jitted fori_loop,
so the time per call excludes dispatch. Prints one line per (stage, form)
on whatever device JAX picks, with the device kind.

Usage: python tools/scan_microbench.py
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from merpcr_tpu.ops.scan import _rank_invert  # noqa: E402

N_ITER = 50
REPEAT = 5


def _blocked_scan(x, op, unit):
    """Inclusive prefix scan via log-shifted ``op`` steps on a 2-D
    relayout: minor-axis scan by padded shifts, then the row totals scan
    the same way along the major axis. Needs len(x) % 128 == 0."""
    n = x.shape[0]
    L = 128
    x2 = x.reshape(-1, L)
    k = 1
    while k < L:
        sh = jnp.pad(x2, ((0, 0), (k, 0)), constant_values=unit)[:, :L]
        x2 = op(x2, sh)
        k *= 2
    rows = x2.shape[0]
    tot = x2[:, -1]
    k = 1
    while k < rows:
        sh = jnp.pad(tot, (k, 0), constant_values=unit)[:rows]
        tot = op(tot, sh)
        k *= 2
    pre = jnp.pad(tot, (1, 0), constant_values=unit)[:rows]
    return op(x2, pre[:, None]).reshape(n)


def rank_invert_blocked(cnt, cap_out):
    S = cnt.shape[0]
    scan_ok = S % 128 == 0 and cap_out % 128 == 0
    csum = _blocked_scan(cnt, jnp.add, 0) if scan_ok else jnp.cumsum(cnt)
    excl = csum - cnt
    tgt = jnp.where(cnt > 0, excl, cap_out)
    ids = jnp.arange(1, S + 1, dtype=jnp.int32)
    seed = jnp.zeros((cap_out,), jnp.int32).at[tgt].max(ids, mode="drop")
    run = (
        _blocked_scan(seed, jnp.maximum, -(1 << 31))
        if scan_ok
        else jax.lax.cummax(seed)
    )
    src = jnp.clip(run - 1, 0, S - 1)
    return src, excl[src]


def phase2_caps():
    """(stage, n_sources, cap_out) at each _rank_invert call site of the
    chr21-scale N=0 program."""
    import bench
    from merpcr_tpu import MerPCR

    with tempfile.TemporaryDirectory() as td:
        sts, _fa, _n = bench.gen_data(td, 0.001, 1000)
        eng = MerPCR()
        assert eng.load_sts_file(sts)
    cfg = eng._base_config(1 << 23, packed=True)
    # the margin stage runs anchors in AC-sized chunks; hits invert over
    # the per-chunk counts (scan.py _margin_stage)
    n_ac = cfg.anch_cap // 32
    return cfg, [
        ("units", cfg.cpos_cap, cfg.cpos_cap),
        ("positions", cfg.cpos_cap, cfg.pos_cap),
        ("pairs", cfg.pos_cap, cfg.cand_cap),
        ("hits", n_ac, cfg.hit_cap),
    ]


def time_per_call(fn, cnt):
    """Seconds per call: N_ITER data-dependent calls in one dispatch."""

    def outer(c):
        def it(i, acc):
            src, excl = fn(c ^ (acc & 1))
            return acc + src[-1] + excl[-1]

        return jax.lax.fori_loop(0, N_ITER, it, jnp.int32(0))

    f = jax.jit(outer)
    jax.block_until_ready(f(cnt))
    times = []
    for _ in range(REPEAT):
        t0 = time.perf_counter()
        jax.block_until_ready(f(cnt))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / N_ITER


def main():
    dev = jax.devices()[0]
    cfg, sites = phase2_caps()
    print(f"device: {dev.platform} {dev.device_kind}; tile_len={cfg.tile_len}")
    rng = np.random.default_rng(0)
    for stage, n_src, cap in sites:
        # sparse non-negative counts summing to about half the capacity
        cnt = np.zeros(n_src, np.int32)
        hot = rng.choice(n_src, size=min(n_src, max(1, cap // 4)), replace=False)
        cnt[hot] = rng.integers(1, 4, hot.size)
        cnt = jax.device_put(cnt)
        for form, fn in (
            ("shipped", lambda c, cap=cap: _rank_invert(c, cap)),
            ("blocked", lambda c, cap=cap: rank_invert_blocked(c, cap)),
        ):
            s = time_per_call(fn, cnt)
            print(
                f"{stage:10s} S={n_src:8d} cap={cap:8d} {form:8s} "
                f"{s * 1e6:10.2f} us/call"
            )


if __name__ == "__main__":
    main()
