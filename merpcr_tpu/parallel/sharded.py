"""Mesh-sharded genome scan (the multi-device replacement for the reference's
ProcessPoolExecutor halo chunking, engine.py:381-431).

Strategy (SURVEY.md §2.2/§2.3): scan positions of a record are partitioned
into contiguous spans, one span per device along a 1-D 'shard' mesh axis.
Each device receives its halo-padded byte buffer (halos are materialized
read-only overlaps — communication-free, like the reference's chunking) and
the W-mer table replicated; per-shard hit buffers are merged with a single
``lax.all_gather`` over the mesh (the only collective this workload needs).

Because scan positions are partitioned (not overlapped), no dedup pass is
required and output ordering is reproduced exactly by sorting on global
(pos1, shard, tile, pair, rank) keys — matching the reference's T=1 ground
truth rather than its buggy T>1 overlap filter (SURVEY.md §2.1).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.scan import ScanConfig, _scan_tile
from ..ops.table import DeviceTable


def make_mesh(devices=None, axis: str = "shard") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


@lru_cache(maxsize=32)
def _get_sharded_fn(cfg: ScanConfig, n_shards: int, group: int,
                    axis: str = "shard", gather: bool = True):
    """Compiled shard_map program for one GROUP of ``group`` tiles per
    shard, at group offset ``goff`` scan positions into each shard's span.
    Groups are dispatched back-to-back like the single-device path so
    their compute pipelines. ``gather=True`` all-gathers the hit buffers
    (required multihost: every process sees the full set); single-process
    meshes skip the collective — out_specs P(axis) concatenates the
    shard results and the host reads them directly."""

    stride = cfg.tile_len // 2 if cfg.packed else cfg.tile_len

    def per_shard(table, padded, tile_start0, goff, total_scan,
                  record_len, rt):
        # NB: slice the (1, buf) shard block 2-D and squeeze only the
        # small tile slice — squeezing the whole plane first makes XLA
        # re-materialize the multi-MB copy inside the tile loop.
        start0 = tile_start0[0]
        boff = goff // 2 if cfg.packed else goff

        def body(t):
            tb = jax.lax.dynamic_slice(
                padded, (0, boff + t * stride), (1, cfg.tile_buf_in)
            )[0]
            gstart = start0 + goff + t * cfg.tile_len
            n_scan = jnp.clip(total_scan - gstart, 0, cfg.tile_len)
            return _scan_tile(cfg, table, tb, gstart, n_scan, record_len, rt)

        out = jax.lax.map(body, jnp.arange(group, dtype=jnp.int32))
        if gather:
            # (G, ...) -> (n_shards, G, ...), replicated on every shard
            return jax.tree.map(lambda x: jax.lax.all_gather(x, axis), out)
        return out  # out_specs P(axis): global (n_shards*G, ...)

    def run(mesh, table, padded_shards, tile_start0, goff, total_scan,
            record_len, rt):
        fn = jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(), P(), P(), P()),
            out_specs=P() if gather else P(axis),
            check_vma=False,
        )
        return fn(table, padded_shards, tile_start0, goff, total_scan,
                  record_len, rt)

    return jax.jit(run, static_argnums=0)


def shard_planes(
    cfg: ScanConfig,
    seq: np.ndarray,
    wordsize: int,
    n_shards: int,
    packed_rec: np.ndarray | None = None,
    group: int = 1,
):
    """Host-side prep: cut a record into per-shard halo-padded byte planes.

    Builds ONE packed plane (reusing the record's cached nibble packing
    when ``packed_rec`` is given — the loader memoizes it) and takes
    per-shard slices, exactly like ``shard_stream_planes`` — the per-shard
    repack this replaced was a serial O(genome x shards) NumPy cost per
    search. Returns (padded_shards uint8[n_shards, buf], tile_start0
    int32[n_shards], total_scan, tiles_per_shard)."""
    n = len(seq)
    total_scan = n - wordsize + 1
    L = cfg.tile_len
    n_tiles = -(-total_scan // L)
    # round tiles/shard up to a GROUP multiple so grouped dispatch keeps
    # flattened row index == real tile index (padding tiles scan nothing)
    tiles_per_shard = -(-(-(-n_tiles // n_shards)) // group) * group
    span = tiles_per_shard * L  # scan positions per shard

    d = 2 if cfg.packed else 1
    plane_len = (cfg.lead + n_shards * span + cfg.tail) // d
    if cfg.packed and packed_rec is not None:
        plane = np.zeros(plane_len, dtype=np.uint8)
        plane[cfg.lead // 2 : cfg.lead // 2 + len(packed_rec)] = packed_rec
    else:
        from ..ops.encoding import NIB_LUT, pack_nibbles

        pos = np.zeros(plane_len * d, dtype=np.uint8)
        pos[cfg.lead : cfg.lead + n] = NIB_LUT[seq] if cfg.packed else seq
        plane = pack_nibbles(pos) if cfg.packed else pos

    buf_len = (cfg.lead + span + cfg.tail) // d
    padded_shards = np.zeros((n_shards, buf_len), dtype=np.uint8)
    tile_start0 = np.zeros((n_shards,), dtype=np.int32)
    for s in range(n_shards):
        tile_start0[s] = s * span  # first scan position owned by shard s
        chunk = plane[s * span // d : s * span // d + buf_len]
        padded_shards[s, : len(chunk)] = chunk
    return padded_shards, tile_start0, total_scan, tiles_per_shard


@lru_cache(maxsize=32)
def _get_sharded_stream_fn(cfg: ScanConfig, n_shards: int, group: int,
                           axis: str = "shard", gather: bool = True):
    """Compiled shard_map program for STREAM planes (cfg.stream): one
    GROUP of tiles per shard of a concatenated multi-record plane, rmeta
    and the block->record map replicated; hit buffers all-gathered only
    when ``gather`` (multihost — see _get_sharded_fn)."""

    stride = cfg.tile_len // 2 if cfg.packed else cfg.tile_len

    def per_shard(table, padded, tile_start0, goff, total_scan, stream_len,
                  rmeta, recmap, rt):
        start0 = tile_start0[0]
        boff = goff // 2 if cfg.packed else goff

        def body(t):
            # 2-D slice + small squeeze (see record per_shard note)
            tb = jax.lax.dynamic_slice(
                padded, (0, boff + t * stride), (1, cfg.tile_buf_in)
            )[0]
            gstart = start0 + goff + t * cfg.tile_len
            n_scan = jnp.clip(total_scan - gstart, 0, cfg.tile_len)
            return _scan_tile(cfg, table, tb, gstart, n_scan, stream_len,
                              rt, rmeta=rmeta, recmap=recmap)

        out = jax.lax.map(body, jnp.arange(group, dtype=jnp.int32))
        if gather:
            return jax.tree.map(lambda x: jax.lax.all_gather(x, axis), out)
        return out

    def run(mesh, table, padded_shards, tile_start0, goff, total_scan,
            stream_len, rmeta, recmap, rt):
        fn = jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(), P(), P(), P(), P(), P()),
            out_specs=P() if gather else P(axis),
            check_vma=False,
        )
        return fn(table, padded_shards, tile_start0, goff, total_scan,
                  stream_len, rmeta, recmap, rt)

    return jax.jit(run, static_argnums=0)


def shard_stream_planes(cfg: ScanConfig, plane: np.ndarray,
                        total_scan: int, n_shards: int, group: int = 1):
    """Cut a prebuilt stream plane (lead + positions + tail, packed bytes)
    into per-shard halo-padded slices. Returns
    (padded_shards, tile_start0, tiles_per_shard)."""
    L = cfg.tile_len
    n_tiles = -(-total_scan // L)
    tiles_per_shard = -(-(-(-n_tiles // n_shards)) // group) * group
    span = tiles_per_shard * L
    d = 2 if cfg.packed else 1
    buf_len = (cfg.lead + span + cfg.tail) // d
    padded_shards = np.zeros((n_shards, buf_len), dtype=np.uint8)
    tile_start0 = np.zeros((n_shards,), dtype=np.int32)
    for s in range(n_shards):
        gstart = s * span
        tile_start0[s] = gstart
        # plane position of scan pos p is lead + p: shard s's buffer
        # starts at plane position gstart (== lead + gstart - lead)
        a = gstart // d
        chunk = plane[a : a + buf_len]
        padded_shards[s, : len(chunk)] = chunk
    return padded_shards, tile_start0, tiles_per_shard


def sharded_scan_stream(
    cfg: ScanConfig,
    table: DeviceTable,
    plane: np.ndarray,
    rmeta: np.ndarray,
    total_scan: int,
    stream_len: int,
    mesh: Mesh,
    axis: str = "shard",
    rt: np.ndarray | None = None,
    recmap: np.ndarray | None = None,
    planes=None,
    group: int = 1,
    gather: bool | None = None,
):
    """Scan a concatenated multi-record stream plane across a device mesh.

    Returns (outs, n_shards, tiles_per_shard, group, gathered) — the
    per-group device results (global tile = shard * tps + goff/L + t;
    assemble with ``engine.MerPCR._fetch_sharded``)."""
    if rt is None:
        rt = np.asarray([cfg.margin, 0, 1], dtype=np.int32)
    if gather is None:
        gather = jax.process_count() > 1
    if recmap is None:
        # block->record map (see engine._dispatch_stream): starts 8-aligned
        n_blocks = -(-stream_len // 8)
        live = rmeta[:, 0] != np.iinfo(np.int32).max
        counts = np.diff(
            rmeta[live, 0].astype(np.int64) // 8, append=n_blocks
        )
        recmap = np.repeat(
            np.arange(int(live.sum()), dtype=np.int32), counts
        )
    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if planes is None:
        planes = shard_stream_planes(
            cfg, plane, total_scan, n_shards, group=group
        )
    padded_shards, tile_start0, tps = planes
    G = group if tps % group == 0 else tps
    fn = _get_sharded_stream_fn(cfg, n_shards, G, axis, gather)
    outs = [
        fn(mesh, table, padded_shards, tile_start0,
           np.int32(g * G * cfg.tile_len),
           np.int32(total_scan), np.int32(stream_len), rmeta, recmap, rt)
        for g in range(tps // G)
    ]
    return outs, n_shards, tps, G, gather


def sharded_scan_record(
    cfg: ScanConfig,
    table: DeviceTable,
    seq: np.ndarray,
    wordsize: int,
    mesh: Mesh,
    axis: str = "shard",
    rt: np.ndarray | None = None,
    packed_rec: np.ndarray | None = None,
    planes=None,
    group: int = 1,
    gather: bool | None = None,
):
    """Scan one record across a device mesh.

    Dispatches ``tiles_per_shard // group`` grouped programs back-to-back
    (their device compute pipelines like the single-device grouped path).
    Returns (outs, n_shards, tiles_per_shard, group, gathered): ``outs``
    is the per-group list of device results — feed to
    ``engine.MerPCR._fetch_sharded`` to assemble host arrays with global
    tile index = shard * tiles_per_shard + t, matching single-device
    ordering exactly. ``planes`` (a prior ``shard_planes`` result,
    possibly device_put with a sharded layout) skips the host prep — the
    engine caches it across searches. ``gather=None`` auto-selects: the
    all_gather collective only when multiple processes must each hold the
    full hit set."""
    if rt is None:
        rt = np.asarray([cfg.margin, 0, 1], dtype=np.int32)
    if gather is None:
        gather = jax.process_count() > 1
    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if planes is None:
        planes = shard_planes(
            cfg, seq, wordsize, n_shards, packed_rec, group=group
        )
    padded_shards, tile_start0, total_scan, tiles_per_shard = planes
    G = group if tiles_per_shard % group == 0 else tiles_per_shard
    fn = _get_sharded_fn(cfg, n_shards, G, axis, gather)
    outs = [
        fn(mesh, table, padded_shards, tile_start0,
           np.int32(g * G * cfg.tile_len),
           np.int32(total_scan), np.int32(len(seq)), rt)
        for g in range(tiles_per_shard // G)
    ]
    return outs, n_shards, tiles_per_shard, G, gather
