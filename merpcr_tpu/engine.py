"""MerPCR engine: the user-facing orchestration class.

API parity with the reference ``src/merpcr/core/engine.py`` class ``MerPCR``
(engine.py:44-97): same constructor parameters, same bounds validation, same
``load_sts_file`` / ``load_fasta_file`` / ``search`` methods, same output
format — but the search path is a jitted JAX array program (see
``merpcr_tpu.ops.scan``) instead of interpreted per-character loops.

Output contract: byte-identical to the reference CLI run with T=1 (the
reference's T>1 path can duplicate halo hits — SURVEY.md §2.1; T=1 is ground
truth). The ``threads`` parameter is accepted for flag compatibility; device
tiling replaces host threading and never changes the output.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np

from .io.fasta import FASTALoader, record_seq_bytes
from .io.sts import STSLoader
from .models import FASTARecord
from .utils.cache import cache_dir, enable_compilation_cache

# NB: jax-importing modules (.ops.scan, the device side of .ops.table)
# are imported lazily inside methods — small inputs served by the host
# fast path (.ops.host_scan) never pay jax startup (~1.5 s import +
# ~1 s first-trace even with a warm persistent cache).
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .ops.scan import ScanConfig

# Constants (reference engine.py:17-39)
AMBIG = 100
MIN_FILESIZE_FOR_THREADING = 100000

DEFAULT_MARGIN = 50
DEFAULT_WORDSIZE = 11
DEFAULT_MISMATCHES = 0
DEFAULT_THREE_PRIME_MATCH = 1
DEFAULT_IUPAC_MODE = 0
DEFAULT_THREADS = 1
DEFAULT_PCR_SIZE = 240

MIN_WORDSIZE = 3
MAX_WORDSIZE = 16
MIN_MISMATCHES = 0
MAX_MISMATCHES = 10
MIN_MARGIN = 0
MAX_MARGIN = 10000
MIN_THREE_PRIME_MATCH = 0
MIN_PCR_SIZE = 1
MAX_PCR_SIZE = 10000

# Tile-length buckets: smallest bucket covering the record is used, so small
# inputs compile small programs; large genomes scan 8M-position tiles so
# per-tile fixed costs amortize. STREAMS cap at 2^21: their per-tile cost
# grows with the gap-driven dirty-bypass machinery. (Both ends were tuned
# on the previous accelerator; re-derive them on the GPU with
# tools/tile_len_sweep.py.)
TILE_LEN_BUCKETS = (1 << 15, 1 << 17, 1 << 19, 1 << 21, 1 << 23)
STREAM_MAX_TILE = 1 << 21
MAX_ESCALATIONS = 12

logger = logging.getLogger(__name__)

# Global device-plane cache (see MerPCR.__init__); bounded, keyed by the
# owning host array's id + buffer geometry.
_DEVICE_PLANE_CACHE: dict = {}

# ---- persisted rescan-capacity seeds --------------------------------------
# Flood-content capacity discovery (engine._rescan_wave) measures each
# overflowing span's true stage totals; remembering them makes the SECOND
# search converge in one sized wave. Persisting them next to the XLA cache
# extends that to fresh PROCESSES: a one-shot CLI user on the same content
# + table + params pays discovery once per machine, not once per run.
# Seeds only steer capacity sizing — output bytes never depend on them.
_SEED_STORE: Optional[dict] = None
_SEED_STORE_LIMIT = 16384


def _seed_store_path() -> Optional[str]:
    """rescan_seeds.json in the compile-cache directory (None: disabled)."""
    d = cache_dir()
    return None if d is None else os.path.join(d, "rescan_seeds.json")


def _seed_store() -> dict:
    global _SEED_STORE
    if _SEED_STORE is None:
        _SEED_STORE = {}
        path = _seed_store_path()
        if path is not None:
            try:
                import json

                with open(path) as fh:
                    _SEED_STORE = {
                        str(k): tuple(v) for k, v in json.load(fh).items()
                    }
            except Exception:
                pass
    return _SEED_STORE


def _seed_store_save() -> None:
    path = _seed_store_path()
    if path is None:
        return
    try:
        import json
        import tempfile

        store = _seed_store()
        if len(store) > _SEED_STORE_LIMIT:  # drop oldest insertions
            for k in list(store)[: len(store) - _SEED_STORE_LIMIT]:
                del store[k]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as fh:
            json.dump({k: list(v) for k, v in store.items()}, fh)
        os.replace(tmp, path)
    except Exception:  # pragma: no cover - persistence is best-effort
        pass


class MerPCR:
    """Accelerated e-PCR engine (API parity: reference engine.py:44-97)."""

    def __init__(
        self,
        wordsize: int = DEFAULT_WORDSIZE,
        margin: int = DEFAULT_MARGIN,
        mismatches: int = DEFAULT_MISMATCHES,
        three_prime_match: int = DEFAULT_THREE_PRIME_MATCH,
        iupac_mode: int = DEFAULT_IUPAC_MODE,
        default_pcr_size: int = DEFAULT_PCR_SIZE,
        threads: int = DEFAULT_THREADS,
        max_sts_line_length: int = 1022,
    ):
        self.wordsize = wordsize
        self.margin = margin
        self.mismatches = mismatches
        self.three_prime_match = three_prime_match
        self.iupac_mode = iupac_mode
        self.default_pcr_size = default_pcr_size
        self.threads = threads
        # Accepted-but-unused in the reference too (SURVEY.md §2.1, cli.py:202-208)
        self.max_sts_line_length = max_sts_line_length

        self.sts_records = []
        self.max_pcr_size = 0
        self.total_hits = 0
        # Observability: tiles retried with escalated capacities (bench
        # logs this to prove adversarial content causes no rescan storm)
        self._rescan_count = 0

        self._table_host = None  # DeviceTable pytree of HOST numpy arrays
        self._table_dev = None  # lazy device conversion (see _table)
        self._meta = None  # TableMeta
        self._strict1_tried = False  # lazy N=1 strict variant guard
        # Test hook: force a specific tile length (exercises multi-tile
        # paths on small inputs). None -> TILE_LEN_BUCKETS heuristic.
        self._tile_len_override: Optional[int] = None
        # Optional jax.sharding.Mesh: shard records across devices
        # (set via use_mesh(); output is identical to single-device).
        self.mesh = None
        # True after enable_multihost(): search() emits output only on
        # host 0 (every process still computes the full merged hit set).
        self._multihost = False
        # Device-resident genome plane cache: repeated searches over the
        # same records (e.g. margin/mismatch parameter sweeps) skip the
        # host->device transfer entirely. Module-global so sweeps that
        # build a fresh MerPCR per setting still share planes.
        self._device_plane_cache = _DEVICE_PLANE_CACHE

        self._validate_parameters()

    def use_mesh(self, mesh) -> "MerPCR":
        """Shard the scan across a 1-D device mesh (tiles partitioned by
        scan position, table replicated, hits all-gathered). Output is
        byte-identical to the single-device path."""
        self.mesh = mesh
        return self

    def enable_multihost(
        self,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
    ) -> "MerPCR":
        """Run the search over every chip in a (possibly multi-host) slice.

        Accelerator replacement for the reference's ProcessPoolExecutor
        fan-out wired into ``search`` (reference engine.py:414-434): calls
        ``jax.distributed.initialize`` (no-op when single-host / already
        initialized), shards scan positions over a global 1-D mesh, and
        gates emission in :meth:`search` so exactly one process (host 0)
        writes output. All per-shard hit buffers are ``all_gather``-merged
        inside the sharded program, so every host computes the same
        ``total_hits`` return value.
        """
        from .parallel import distributed

        distributed.initialize(coordinator_address, num_processes, process_id)
        self._multihost = True
        return self.use_mesh(distributed.global_mesh())

    def _validate_parameters(self):
        """Bounds validation (reference engine.py:80-97)."""
        if not (MIN_WORDSIZE <= self.wordsize <= MAX_WORDSIZE):
            raise ValueError(
                f"Word size must be between {MIN_WORDSIZE} and {MAX_WORDSIZE}"
            )
        if not (MIN_MISMATCHES <= self.mismatches <= MAX_MISMATCHES):
            raise ValueError(
                f"Number of mismatches must be between {MIN_MISMATCHES} and {MAX_MISMATCHES}"
            )
        if not (MIN_MARGIN <= self.margin <= MAX_MARGIN):
            raise ValueError(f"Margin must be between {MIN_MARGIN} and {MAX_MARGIN}")
        if self.three_prime_match < MIN_THREE_PRIME_MATCH:
            raise ValueError(
                f"Three prime match must be at least {MIN_THREE_PRIME_MATCH}"
            )
        if not (MIN_PCR_SIZE <= self.default_pcr_size <= MAX_PCR_SIZE):
            raise ValueError(
                f"Default PCR size must be between {MIN_PCR_SIZE} and {MAX_PCR_SIZE}"
            )

    @property
    def _table(self):
        """Device-resident table, converted lazily from the host compile
        on first device use (host-fast-path runs never touch jax)."""
        if self._table_dev is None and self._table_host is not None:
            import jax.numpy as jnp

            enable_compilation_cache()
            self._table_dev = type(self._table_host)(
                *(jnp.asarray(x) for x in self._table_host)
            )
        return self._table_dev

    # ------------------------------------------------------------------ load
    def load_sts_file(self, filename: str) -> bool:
        """Load + compile the STS set (reference engine.py:193-302)."""
        from .ops.table import compile_table

        res = STSLoader.load_file(filename, self.wordsize, self.default_pcr_size)
        if not res.ok:
            return False
        self.sts_records = res.records
        self.max_pcr_size = res.max_pcr_size
        self._table_host, self._meta = compile_table(
            res, self.wordsize, bool(self.iupac_mode), device=False
        )
        self._table_dev = None
        self._strict1_tried = False  # lazy N=1 variant (see _base_config)
        return True

    def load_fasta_file(self, filename: str) -> List[FASTARecord]:
        """Reference engine.py:361-363."""
        return FASTALoader.load_file(filename)

    # ---------------------------------------------------------------- search
    @staticmethod
    def _quantize_dirty(d: float, floor: float = 1e-3) -> float:
        """Quantize a measured dirty-base rate to log2 buckets so nearby
        genomes share one compiled program (caps depend on it). Streams
        pass a finer floor: their inter-record gap bytes are dirty by
        construction and even a 1e-4 rate is thousands of bypassing
        units per big tile."""
        if d < floor:
            return 0.0
        import math

        return min(0.5, 2.0 ** round(math.log2(d)))

    @staticmethod
    def _dirty_of(seq: np.ndarray, packed_rec) -> tuple:
        """(w_unit, w_pos) WINDOW dirty rates of one record, measured
        with the scan's unit structure (never derived from the base
        rate — derivations are wrong by an order of magnitude for
        run-clustered dirt):

        * ``w_unit`` — fraction of u32-unit windows whose KEYED bases
          (~7..19) contain a non-ACGT base while SOME phase's W-mer
          window is clean: exactly the units the strict front end flags
          for table bypass (``flag = pvU & (hitu | ~vq)``). Scattered 1%
          ambiguity: ~12% (most dirty-keyed units keep a clean phase);
          N-run genomes: ~0 (runs have no valid phase at all).
        * ``w_pos`` — fraction of positions dirty-in-16 but
          clean-in-~11: the ones that expand phases through the exact
          CSR with no table filter.
        """
        if packed_rec is not None and len(packed_rec):
            b = packed_rec
            db = (((b & 0xF) >= 4) | ((b >> 4) >= 4)).astype(np.int32)
            cs = np.concatenate(([0], np.cumsum(db)))
            if len(cs) <= 13:
                any_d = bool(db.any())
                return (float(any_d), 0.0)
            # byte granularity: 1 byte = 2 bases. Unit key bases 7..19
            # ~ bytes 3..9; phase W-mer windows ~ 6-byte windows at byte
            # offsets 0..4; position windows: 8 B = 16 bases, 6 B ~ 11.
            idx = np.arange(0, len(cs) - 13, max(1, len(cs) >> 14))
            key_d = (cs[idx + 10] - cs[idx + 3]) > 0
            phase_c = np.zeros(len(idx), dtype=bool)
            for d in range(5):
                phase_c |= (cs[idx + d + 6] - cs[idx + d]) == 0
            w_unit = float((key_d & phase_c).mean())
            w16 = (cs[idx + 8] - cs[idx]) > 0
            w11 = (cs[idx + 6] - cs[idx]) > 0
            return (w_unit, float((w16 & ~w11).mean()))
        if seq is None or not len(seq):
            return (0.0, 0.0)
        from .ops.encoding import SCODE

        db = (SCODE[seq] == AMBIG).astype(np.int32)
        cs = np.concatenate(([0], np.cumsum(db)))
        if len(cs) <= 27:
            return (float(db.any()), 0.0)
        idx = np.arange(0, len(cs) - 27, max(1, len(cs) >> 15))
        key_d = (cs[idx + 20] - cs[idx + 7]) > 0
        phase_c = np.zeros(len(idx), dtype=bool)
        for d in range(8):
            phase_c |= (cs[idx + d + 11] - cs[idx + d]) == 0
        w_unit = float((key_d & phase_c).mean())
        w16 = (cs[idx + 16] - cs[idx]) > 0
        w11 = (cs[idx + 11] - cs[idx]) > 0
        return (w_unit, float((w16 & ~w11).mean()))

    def _base_config(
        self, tile_len: int, packed: bool = True, stream: bool = False,
        dirty: float = 0.0, dirty_pos: float = 0.0,
        gaps_per_tile: float = 0.0,
    ) -> "ScanConfig":
        from .ops.scan import default_config

        m = self._meta
        # The strict front end bakes a mismatch budget into its tables, so
        # the variant must match the runtime -N exactly: N=0 -> qbloom_s,
        # N=1 -> qbloom_s1 (ext positions Hamming-1-wildcarded at build),
        # anything else -> loose. Read at search time so N sweeps across
        # searches stay correct.
        if packed and self.mismatches == 0 and m.strict:
            strict, strict_n = True, 0
        elif packed and self.mismatches == 1 and m.strict:
            if not self._strict1_tried:
                # N=1 variant builds lazily on the first -N 1 search so
                # N=0 runs never pay for it (host table; device copy is
                # invalidated and reconverts on next use)
                from .ops.table import build_strict1

                self._table_host, self._meta = build_strict1(
                    self._table_host, m, bool(self.iupac_mode)
                )
                self._table_dev = None
                self._strict1_tried = True
                m = self._meta
            strict, strict_n = (True, 1) if m.strict1 else (False, 0)
        else:
            strict, strict_n = False, 0
        return default_config(
            wordsize=self.wordsize,
            margin=self.margin,
            mismatches=self.mismatches,
            three_prime_match=self.three_prime_match,
            lead=m.lead,
            max_pcr_size=self.max_pcr_size,
            p1_max=m.p1_max,
            p2_max=m.p2_max,
            bloom_bits=m.bloom_bits,
            tile_len=tile_len,
            n_entries=m.n_entries,
            iupac=bool(self.iupac_mode),
            packed=packed,
            stride=m.stride,
            qbloom_bits=m.qbloom_bits,
            exact_group=m.exact_group,
            n_unique=m.n_unique,
            strict=strict,
            strict_n=strict_n,
            t16_bits=(
                (m.t16_1_bits if strict_n == 1 else m.t16_bits)
                if strict
                else 0
            ),
            stream=stream,
            q_density=m.q_density,
            sq_density=m.sq1_density if strict_n == 1 else m.sq_density,
            sp_density=m.sp_density,
            t16_real=m.t16_1_real if strict_n == 1 else m.t16_real,
            t16_fp=m.t16_1_fp if strict_n == 1 else m.t16_fp,
            dirty_rate=dirty,
            dirty_pos_rate=dirty_pos,
            gaps_per_tile=gaps_per_tile,
        )

    @staticmethod
    def _plane(
        seq: np.ndarray,
        packed_rec: Optional[np.ndarray],
        pos_len: int,
        lead: int,
    ) -> np.ndarray:
        """Host-side input plane: the cached nibble-packed record memcpy'd
        into a zero-padded buffer (lead is even, so the record stays
        byte-aligned in packed space), or raw bytes for the fallback path."""
        if packed_rec is not None:
            buf = np.zeros(pos_len // 2, dtype=np.uint8)
            buf[lead // 2 : lead // 2 + len(packed_rec)] = packed_rec
            return buf
        buf = np.zeros(pos_len, dtype=np.uint8)
        buf[lead : lead + len(seq)] = seq
        return buf

    def _runtime_params(self) -> np.ndarray:
        """Runtime (-M, -N, -X) vector: these don't affect program shapes,
        so parameter sweeps reuse one compiled program + device planes."""
        return np.asarray(
            [self.margin, self.mismatches, self.three_prime_match],
            dtype=np.int32,
        )

    @staticmethod
    def _pick_tile_len(total_scan: int, max_tile: int | None = None) -> int:
        buckets = [
            b for b in TILE_LEN_BUCKETS if max_tile is None or b <= max_tile
        ]
        for b in buckets:
            if total_scan <= b:
                return b
        return buckets[-1]

    # Tiles are dispatched in fixed-size groups: one compiled program
    # regardless of record length, and group g+1's host->device transfer
    # overlaps group g's compute (async dispatch). Padding tiles inside the
    # last group short-circuit via lax.cond (~free). Both policy constants
    # date from the previous accelerator and are not yet re-derived on the
    # GPU: tools/tile_group_sweep.py measures them, the env vars override.
    TILE_GROUP = int(os.environ.get("MERPCR_TPU_TILE_GROUP", "8"))

    # Only floor-cap configs group: lax.map's per-iteration machinery grows
    # with the scan body's internal buffers once they pass the floor caps.
    # Measure this in FRESH processes (one engine per process, like the
    # CLI) — later engines in one process can read up to 2x slower.
    GROUP_POS_CAP_LIMIT = int(os.environ.get("MERPCR_TPU_GROUP_LIMIT", "1024"))

    def _tile_group(self, cfg) -> int:
        big = max(cfg.pos_cap, cfg.cpos_cap) > self.GROUP_POS_CAP_LIMIT
        return 1 if big else self.TILE_GROUP

    def _scan_record(
        self, seq: np.ndarray, packed_rec: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Run the device pipeline over one record (dispatch + collect)."""
        return self._collect_record(self._dispatch_record(seq, packed_rec))

    def _dispatch_record(
        self, seq: np.ndarray, packed_rec: Optional[np.ndarray] = None
    ):
        """Phase 1: enqueue ALL device work for one record without
        blocking, so the next record's host-side prep (plane packing,
        dispatch) overlaps this record's device compute. Returns an
        opaque context for :meth:`_collect_record`.

        The mesh (shard_map) path currently collects inline — multi-chip
        dispatch already amortizes across shards."""
        from .ops.scan import get_record_scan_fn

        n = len(seq)
        if n <= self.wordsize:  # reference engine.py:458-459 (note <=)
            return ("empty",)
        total_scan = n - self.wordsize + 1
        tile_len = self._tile_len_override or self._pick_tile_len(total_scan)
        # packed (4-bit) plane whenever the sequence is within the 16-letter
        # FASTA alphabet (always true for loader output); raw-byte fallback
        # keeps exact reference semantics for arbitrary API-supplied strings
        packed = packed_rec is not None
        # window dirty rates are cached per record (a cumsum over the
        # whole plane — cheap once, not per search)
        owner0 = packed_rec if packed_rec is not None else seq
        dcache = self._device_plane_cache.setdefault(id(owner0), {})
        dcache["_owner"] = owner0
        dw = dcache.get("_dirty")
        if dw is None:
            dw = dcache["_dirty"] = self._dirty_of(seq, packed_rec)
        cfg0 = self._base_config(
            tile_len, packed=packed,
            dirty=self._quantize_dirty(dw[0]),
            dirty_pos=self._quantize_dirty(dw[1]),
        )
        L = cfg0.tile_len
        n_tiles = -(-total_scan // L)

        if self.mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec

            from .parallel.sharded import shard_planes, sharded_scan_record

            axis = self.mesh.axis_names[0]
            n_shards = int(
                np.prod([self.mesh.shape[a] for a in self.mesh.axis_names])
            )
            G = self._tile_group(cfg0)
            # per-shard planes cached ACROSS searches, device_put with the
            # sharded layout so repeat searches ship no bytes at all
            owner = packed_rec if packed_rec is not None else seq
            cache = self._device_plane_cache.setdefault(id(owner), {})
            cache["_owner"] = owner
            mk = ("mesh", cfg0.lead, cfg0.tail, L, n_shards, G)
            planes = cache.get(mk)
            if planes is None:
                ps, t0s, tsc, tps = shard_planes(
                    cfg0, seq, self.wordsize, n_shards, packed_rec, group=G
                )
                spec = NamedSharding(self.mesh, PartitionSpec(axis))
                planes = (
                    jax.device_put(ps, spec),
                    jax.device_put(t0s, spec),
                    tsc,
                    tps,
                )
                cache[mk] = planes
            souts, n_shards, tps, G, gathered = sharded_scan_record(
                cfg0, self._table, seq, self.wordsize, self.mesh,
                axis=axis, rt=self._runtime_params(), planes=planes,
                group=G, gather=True if self._multihost else None,
            )
            # collection is deferred (ScanOut stays on device): the next
            # plan item's dispatch overlaps this one's mesh compute, same
            # depth-1 prefetch as the single-device path
            n_tiles = min(n_tiles, n_shards * tps)
            return (
                "mesh", cfg0, n_tiles,
                (souts, n_shards, tps, G, gathered), seq, n,
            )
        else:
            G = self._tile_group(cfg0)
            n_groups = -(-n_tiles // G)
            d = 2 if packed else 1  # positions per input byte
            glen = (cfg0.lead + G * L + cfg0.tail) // d
            ck = (n, cfg0.lead, cfg0.tail, L, G, packed)
            # cache device planes on the sequence-owning array object so the
            # cache lifetime follows the data (no id-reuse hazards)
            owner = packed_rec if packed_rec is not None else seq
            cache = self._device_plane_cache.setdefault(id(owner), {})
            cache["_owner"] = owner  # keep alive while cached
            groups = cache.get(ck)
            if groups is None:
                plane = self._plane(
                    seq, packed_rec, cfg0.lead + n_groups * G * L + cfg0.tail,
                    cfg0.lead,
                )
                groups = [
                    plane[g * G * L // d : g * G * L // d + glen]
                    for g in range(n_groups)
                ]
                import jax

                groups = [jax.device_put(s) for s in groups]
                if len(self._device_plane_cache) > 64:
                    self._device_plane_cache.clear()
                    cache = self._device_plane_cache.setdefault(id(owner), {})
                    cache["_owner"] = owner
                cache[ck] = groups
            fn = get_record_scan_fn(cfg0, G)
            # dispatch all groups without blocking; jax pipelines the
            # per-group H2D transfers with earlier groups' compute
            pend = [
                fn(
                    self._table,
                    groups[g],
                    np.int32(g * G * L),
                    np.int32(total_scan),
                    np.int32(n),
                    self._runtime_params(),
                )
                for g in range(n_groups)
            ]
            return ("pend", cfg0, n_tiles, pend, seq, n)

    @staticmethod
    def _fetch_sharded(souts, n_shards, tps, G, gather):
        """Fetch a deferred per-group list of sharded ScanOuts and
        assemble (n_shards*tps, ...) host arrays — global tile index
        = shard*tps + group*G + t keeps single-device ordering. Group
        leaves are (n_shards, G, ...) when gathered (replicated via
        all_gather) or (n_shards*G, ...) when read sharded."""
        import jax

        host = jax.device_get(souts)

        def asm(cols):
            cols = [
                np.asarray(c).reshape(
                    (n_shards, G) + np.asarray(c).shape[2 if gather else 1:]
                )
                for c in cols
            ]
            cat = cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)
            return cat.reshape((n_shards * cat.shape[1],) + cat.shape[2:])

        return type(host[0])(*(asm(cols) for cols in zip(*host)))

    @staticmethod
    def _fetch_outs(pend):
        """Fetch a list of per-group ScanOut pytrees as ONE ScanOut of
        host arrays (tiles concatenated along axis 0). One bulk D2H for
        all groups; jax pipelines the per-array transfers (measured: a
        device-side pre-concatenate buys nothing over this)."""
        import jax

        host = jax.device_get(pend)
        return type(pend[0])(*(np.concatenate(cols) for cols in zip(*host)))

    def _collect_record(self, ctx) -> np.ndarray:
        """Phase 2: block on the record's device results and post-process.

        Returns an int64 array of shape (n_hits, 6) with columns
        (pos1, pos2, entry, tile_idx, pair_order, rank), global 0-based.
        The rare tile that overflows a fixed buffer capacity is retried
        individually with escalated capacities."""
        if ctx[0] == "empty":
            return np.zeros((0, 6), dtype=np.int64)
        _, cfg0, n_tiles, payload, seq, n = ctx
        if ctx[0] == "pend":
            out = self._fetch_outs(payload)
        else:  # "mesh": deferred sharded result, fetched + flattened here
            out = self._fetch_sharded(*payload)

        c_tot = np.asarray(out.c_total)
        x_tot = np.asarray(out.pos_total)
        p_tot = np.asarray(out.pair_total)
        a_tot = np.asarray(out.anch_total)
        h_tot = np.asarray(out.hit_total)
        overflow = (
            (c_tot > cfg0.cpos_cap)
            | (x_tot > cfg0.pos_cap)
            | (p_tot > cfg0.cand_cap)
            | (a_tot > cfg0.anch_cap)
            | (h_tot > cfg0.hit_cap)
        )

        cols = {
            "pos1": np.asarray(out.pos1),
            "pos2": np.asarray(out.pos2),
            "entry": np.asarray(out.entry),
            "pair_order": np.asarray(out.pair_order),
            "rank": np.asarray(out.rank),
        }

        # First-wave rescans dispatch ASYNC for every overflowing tile
        # (measured seeding makes one sized retry almost always final),
        # then ONE bulk fetch — sequential per-tile round trips would pay
        # the full host<->device latency per tile.
        wave = self._rescan_wave(
            cfg0, overflow,
            (c_tot, x_tot, p_tot, a_tot, h_tot),
            lambda cfg, s0: self._run_tile(cfg, seq, n, s0),
            # stable content key (object ids change across searches)
            seed_key=(n, int(seq[:: max(1, n // 64)].sum()) if n else 0),
        )

        chunks = []
        for t in range(n_tiles):
            if not overflow[t]:
                ht = int(h_tot[t])
                if not ht:
                    continue
                rows = np.empty((ht, 6), dtype=np.int64)
                rows[:, 0] = cols["pos1"][t, :ht]
                rows[:, 1] = cols["pos2"][t, :ht]
                rows[:, 2] = cols["entry"][t, :ht]
                rows[:, 3] = t
                rows[:, 4] = cols["pair_order"][t, :ht]
                rows[:, 5] = cols["rank"][t, :ht]
                chunks.append(rows)
            else:
                done = wave.get(t)
                if done is not None:
                    rows7 = done
                    rows7[:, 3] = t
                    rows7[:, 4] = np.arange(len(rows7), dtype=np.int64)
                    chunks.append(rows7[:, :6])
                    continue
                meas = (
                    int(c_tot[t]), int(x_tot[t]), int(p_tot[t]),
                    int(a_tot[t]), int(h_tot[t]),
                )
                chunks.append(self._rescan_tile(cfg0, seq, n, t, meas))
        if not chunks:
            return np.zeros((0, 6), dtype=np.int64)
        return np.concatenate(chunks, axis=0)

    def _seed_digest(self) -> str:
        """Namespace for persisted rescan seeds: span totals depend on the
        table content and the runtime parameters, so both go into the
        key (cheap sampled hash; computed only on overflow paths)."""
        import hashlib

        h = hashlib.sha1()
        th = self._table_host
        if th is not None:
            uh = np.asarray(th.uhash)
            h.update(uh[:: max(1, len(uh) // 1024)].tobytes())
            h.update(str(len(uh)).encode())
        h.update(
            repr(
                (
                    self.wordsize,
                    self.margin,
                    self.mismatches,
                    self.three_prime_match,
                    self.iupac_mode,
                )
            ).encode()
        )
        return h.hexdigest()[:16]

    def _rescan_wave(self, cfg0, overflow, totals, runner, seed_key=None):
        """Iterated async rescan waves over SPANS: every still-unresolved
        span's next sized attempt dispatches CONCURRENTLY, then one bulk
        fetch per wave — capacity discovery costs waves x (RTT + slowest
        span) instead of spans x attempts serial round trips. Spans whose
        needed capacities exceed the HBM budget split in half INSIDE the
        wave (the halves ride the same round), so budget-split floods
        pipeline too. Resolved spans' exact totals are remembered per
        plane content (``seed_key``): repeat searches re-split and size
        in one wave. Returns {tile: (n,7) rows} covering every
        overflowing tile, or raises after MAX_ESCALATIONS waves (hits
        are never silently truncated). ``runner(cfg, span_start)`` must
        dispatch WITHOUT blocking."""
        import jax

        if MAX_ESCALATIONS < 1:  # exhaustion guard (tests pin it to 0):
            return {}  # the sequential path raises, never truncates
        L = cfg0.tile_len
        c_tot, x_tot, p_tot, a_tot, h_tot = totals
        seeds = getattr(self, "_rescan_seeds", None)
        if seeds is None:
            seeds = self._rescan_seeds = {}
        # Persisted tier: same lookups keyed under a (table, params)
        # digest so a FRESH process on the same content converges in one
        # wave too (see _seed_store).
        store = _seed_store()
        pdig = self._seed_digest() if seed_key else ""

        def skey(s0, sl):
            return f"{pdig}|{seed_key!r}|{s0}|{sl}"

        def seed_of(s0, sl):
            if not seed_key:
                return None
            got = seeds.get((seed_key, s0, sl))
            if got is None:
                got = store.get(skey(s0, sl))
            return got

        store_dirty = False
        spans = {}  # (start, len) -> (cfg_prev, meas, exact)
        for t in np.nonzero(overflow)[0]:
            meas = (
                int(c_tot[t]), int(x_tot[t]), int(p_tot[t]),
                int(a_tot[t]), int(h_tot[t]),
            )
            prev = seed_of(int(t) * L, L)
            if prev:
                meas = tuple(max(a, b) for a, b in zip(meas, prev))
            spans[(int(t) * L, L)] = (cfg0, meas, prev is not None)

        done_spans = {}
        for _ in range(MAX_ESCALATIONS + 8):
            # split pass: replace over-budget spans with seeded halves
            # (repeated until everything fits a compilable program)
            changed = True
            while changed:
                changed = False
                for (s0, sl), (cfg_prev, meas, exact) in list(spans.items()):
                    cfgp = self._with_tile_len(cfg_prev, sl)
                    cfg_t = cfgp.escalate_measured(*meas, exact=exact)
                    if cfg_t is None:
                        cfg_t = cfgp
                    if (
                        self._over_budget(cfg_t)
                        and sl > self.MIN_SPLIT_LEN
                    ):
                        del spans[(s0, sl)]
                        half = sl // 2
                        for h0 in (s0, s0 + half):
                            prev = seed_of(h0, half)
                            if prev:
                                spans[(h0, half)] = (cfg0, prev, True)
                            else:
                                # half the parent's totals: an unbiased
                                # ESTIMATE, not a truncation-biased lower
                                # bound — exact=True so the sizing skips
                                # the ratio scaling (which compounds /2
                                # estimates into maximal splitting)
                                hm = tuple(max(1, m // 2) for m in meas)
                                spans[(h0, half)] = (cfg0, hm, True)
                        changed = True
            if not spans:
                break
            # dispatch pass: every span concurrently, ONE bulk fetch
            pend = {}
            for (s0, sl), (cfg_prev, meas, exact) in spans.items():
                cfgp = self._with_tile_len(cfg_prev, sl)
                cfg_t = cfgp.escalate_measured(*meas, exact=exact)
                if cfg_t is None:
                    cfg_t = cfgp
                self._rescan_count += 1
                pend[(s0, sl)] = (cfg_t, runner(cfg_t, s0))
            self._maybe_clear_caches()
            fetched = jax.device_get({k: p for k, (c, p) in pend.items()})
            for k, out in fetched.items():
                cfg_t = pend[k][0]
                meas = tuple(
                    int(np.asarray(getattr(out, f)).reshape(-1)[0])
                    for f in ("c_total", "pos_total", "pair_total",
                              "anch_total", "hit_total")
                )
                if seed_key:  # remember totals for resolved AND
                    # unresolved spans: repeat searches re-derive the
                    # whole split structure without dispatching parents
                    old = seeds.get((seed_key, k[0], k[1])) or store.get(
                        skey(k[0], k[1])
                    )
                    if old:
                        meas_s = tuple(max(a, b) for a, b in zip(old, meas))
                    else:
                        meas_s = meas
                    seeds[(seed_key, k[0], k[1])] = meas_s
                    store[skey(k[0], k[1])] = meas_s
                    store_dirty = True
                    if len(seeds) > 8192:
                        seeds.clear()
                if cfg_t.escalate_measured(*meas) is not None:
                    spans[k] = (cfg_t, meas, False)  # next wave
                    continue
                del spans[k]
                ht = meas[4]
                rows = np.empty((ht, 7), dtype=np.int64)
                for col, name in (
                    (0, "pos1"), (1, "pos2"), (2, "entry"),
                    (4, "pair_order"), (5, "rank"), (6, "rec"),
                ):
                    rows[:, col] = np.asarray(
                        getattr(out, name)
                    ).reshape(-1)[:ht]
                rows[:, 3] = 0
                done_spans[k] = rows
        if store_dirty:
            _seed_store_save()
        if spans:
            raise RuntimeError(
                "tile capacity escalation failed to converge"
            )
        # group spans back into tiles, span-ascending (emission order)
        out = {}
        for (s0, sl) in sorted(done_spans):
            out.setdefault(s0 // L, []).append(done_spans[(s0, sl)])
        return {
            t: (parts[0] if len(parts) == 1 else np.concatenate(parts))
            for t, parts in out.items()
        }

    # Stream-mode limits: records per stream chunk (rmeta row bucket) and
    # scan positions per chunk (plane memory + int32 coordinate safety).
    STREAM_MAX_RECORDS = 1 << 16
    STREAM_MAX_POSITIONS = 1 << 28

    @staticmethod
    def _stream_layout(items):
        """Concatenated-record layout: each record starts at a multiple of
        8 positions (u32-unit + nibble-byte alignment) with at least one
        gap position after its predecessor. Gap bytes are dirty nibbles
        (0xFF), so no scan window crosses a record boundary — and every
        candidate is record-bounds-checked on device anyway (scan.py
        stream mode). Returns (rmeta int32[R, 2], stream_len)."""
        rmeta = np.empty((len(items), 2), dtype=np.int32)
        cur = 0
        for i, (seq, _p) in enumerate(items):
            start = -(-(cur + 1) // 8) * 8 if i else 0
            rmeta[i, 0] = start
            rmeta[i, 1] = len(seq)
            cur = start + len(seq)
        return rmeta, cur

    def _dispatch_stream(self, items):
        """Phase 1 for a RUN of consecutive packed records of ANY sizes:
        concatenate them (gap-separated) into one nibble plane and scan it
        as ordinary big tiles — all per-tile/per-dispatch fixed costs
        amortize across the whole run (scaffold-heavy FASTA would
        otherwise pay a dispatch per tiny record).

        ``items``: list of (seq_bytes, packed_rec)."""
        import jax

        from .ops.scan import get_stream_scan_fn

        owner0 = items[0][1]
        cache = self._device_plane_cache.setdefault(id(owner0), {})
        cache["_owner"] = owner0
        ids = tuple(id(p) for _, p in items)

        # layout (rmeta + padded variant) depends only on the item run:
        # cache it so repeat searches skip the O(n_items) Python loop
        lk = ("layout", ids)
        layout = cache.get(lk)
        if layout is None:
            rmeta, stream_len = self._stream_layout(items)
            # rmeta rows pad to a power-of-two bucket (jit retraces per
            # bucket, not per record count); padding rows start at
            # INT32_MAX so the on-device searchsorted never selects them.
            rb = 1
            while rb < len(items):
                rb *= 2
            rmeta_p = np.full(
                (rb, 2), np.iinfo(np.int32).max, dtype=np.int32
            )
            rmeta_p[:, 1] = 0
            rmeta_p[: len(items)] = rmeta
            # Block->record map: record starts are 8-aligned, so block b
            # (positions [8b, 8b+8)) belongs to exactly one record (gap
            # blocks can never anchor a candidate). ONE device gather
            # replaces a log2(RB)-step searchsorted per candidate.
            n_blocks = -(-stream_len // 8)
            counts = np.diff(
                rmeta[:, 0].astype(np.int64) // 8, append=n_blocks
            )
            recmap = np.repeat(
                np.arange(len(items), dtype=np.int32), counts
            )
            # length-weighted sampled CONTENT window-dirty rates over the
            # run (sets the front-end capacity model; see default_config
            # dirty_rate — inter-record gap bytes are modeled separately
            # via gaps_per_tile, they are clustered, not scattered)
            w16s = wps = tsum = 0.0
            for seq_b, pk in items:
                n_i = len(seq_b)
                w16, wp = self._dirty_of(seq_b, pk)
                w16s += w16 * n_i
                wps += wp * n_i
                tsum += n_i
            dirty = (
                (w16s / tsum, wps / tsum) if tsum else (0.0, 0.0)
            )
            layout = (rmeta, stream_len, rmeta_p, recmap, dirty)
            cache[lk] = layout
        rmeta, stream_len, rmeta_p, recmap, dirty = layout

        total_scan = stream_len - self.wordsize + 1
        tile_len = self._tile_len_override or self._pick_tile_len(
            total_scan, max_tile=STREAM_MAX_TILE
        )
        gpt = int(len(items) * tile_len / max(total_scan, 1)) + 1
        cfg0 = self._base_config(
            tile_len, packed=True, stream=True,
            dirty=self._quantize_dirty(dirty[0]),
            dirty_pos=self._quantize_dirty(dirty[1]),
            # pow2-ceiling quantized so nearby record counts share one
            # compiled program
            gaps_per_tile=float(1 << (gpt - 1).bit_length()),
        )
        L = cfg0.tile_len
        n_tiles = -(-total_scan // L)
        G = self._tile_group(cfg0)
        n_groups = -(-n_tiles // G)
        glen = (cfg0.lead + G * L + cfg0.tail) // 2

        mesh_mode = self.mesh is not None
        ck = ("stream", cfg0.lead, cfg0.tail, L, G, mesh_mode, ids)
        cached = cache.get(ck)
        if cached is None:
            # dirty-fill, then overwrite record spans (records are byte-
            # aligned in packed space: starts are multiples of 8 positions
            # and lead is a multiple of 32)
            plane = np.full(
                (cfg0.lead + n_groups * G * L + cfg0.tail) // 2,
                0xFF,
                dtype=np.uint8,
            )
            lead_b = cfg0.lead // 2
            for (seq, packed_rec), (start, _len) in zip(items, rmeta):
                b0 = lead_b + int(start) // 2
                plane[b0 : b0 + len(packed_rec)] = packed_rec
            groups = (
                []
                if mesh_mode
                else [
                    jax.device_put(
                        plane[g * G * L // 2 : g * G * L // 2 + glen]
                    )
                    for g in range(n_groups)
                ]
            )
            if len(self._device_plane_cache) > 64:
                self._device_plane_cache.clear()
                cache = self._device_plane_cache.setdefault(id(owner0), {})
                cache["_owner"] = owner0
            # keep the host plane for overflow rescans + packed recs alive
            mesh_planes = None
            if mesh_mode:
                rmeta_dev = recmap_dev = None
                # per-shard slices device_put with the sharded layout so
                # repeat mesh searches ship no plane bytes
                from jax.sharding import NamedSharding, PartitionSpec

                from .parallel.sharded import shard_stream_planes

                axis = self.mesh.axis_names[0]
                n_shards = int(
                    np.prod(
                        [self.mesh.shape[a] for a in self.mesh.axis_names]
                    )
                )
                ps, t0s, tps = shard_stream_planes(
                    cfg0, plane, total_scan, n_shards, group=G
                )
                spec = NamedSharding(self.mesh, PartitionSpec(axis))
                mesh_planes = (
                    jax.device_put(ps, spec), jax.device_put(t0s, spec), tps,
                )
            else:
                rmeta_dev = jax.device_put(rmeta_p)
                recmap_dev = jax.device_put(recmap)
            cached = (
                groups, plane, [p for _, p in items], rmeta_dev, recmap_dev,
                mesh_planes,
            )
            cache[ck] = cached
        groups, plane_host = cached[0], cached[1]
        rmeta_dev, recmap_dev, mesh_planes = cached[3], cached[4], cached[5]
        rescan_ctx = (plane_host, rmeta_p, total_scan, stream_len, recmap)

        if mesh_mode:
            from .parallel.sharded import sharded_scan_stream

            souts, n_shards, tps, SG, gathered = sharded_scan_stream(
                cfg0, self._table, plane_host, rmeta_p,
                total_scan, stream_len, self.mesh,
                rt=self._runtime_params(), recmap=recmap, group=G,
                planes=mesh_planes,
                gather=True if self._multihost else None,
            )
            # deferred collection (see _fetch_sharded): dispatch returns
            # without blocking so the prefetch overlap works under a mesh
            return (
                "stream", cfg0, len(items), n_tiles,
                ("sharded", souts, n_shards, tps, SG, gathered), rescan_ctx,
            )

        fn = get_stream_scan_fn(cfg0, G)
        pend = [
            fn(
                self._table,
                groups[g],
                np.int32(g * G * L),
                np.int32(total_scan),
                np.int32(stream_len),
                rmeta_dev,
                recmap_dev,
                self._runtime_params(),
            )
            for g in range(n_groups)
        ]
        return ("stream", cfg0, len(items), n_tiles, pend, rescan_ctx)

    def _collect_stream(self, ctx):
        """Phase 2 for a stream: one (n_hits, 7) row array per item, split
        by the on-device record index (column 6)."""
        import jax

        _, cfg0, n_items, n_tiles, pend, rescan_ctx = ctx
        if isinstance(pend, tuple) and pend and pend[0] == "sharded":
            out = self._fetch_sharded(*pend[1:])
        else:
            out = self._fetch_outs(pend)
        overflow = (
            (np.asarray(out.c_total) > cfg0.cpos_cap)
            | (np.asarray(out.pos_total) > cfg0.pos_cap)
            | (np.asarray(out.pair_total) > cfg0.cand_cap)
            | (np.asarray(out.anch_total) > cfg0.anch_cap)
            | (np.asarray(out.hit_total) > cfg0.hit_cap)
        )
        wave = self._rescan_wave(
            cfg0, overflow,
            (np.asarray(out.c_total), np.asarray(out.pos_total),
             np.asarray(out.pair_total), np.asarray(out.anch_total),
             np.asarray(out.hit_total)),
            lambda cfg, s0: self._run_stream_tile(cfg, rescan_ctx, s0),
            # CONTENT-stable key (a sampled sum, like the record path's):
            # persisted seeds must survive process restarts, which an
            # id()-based key cannot
            seed_key=(
                len(rescan_ctx[0]),
                int(
                    rescan_ctx[0][
                        :: max(1, len(rescan_ctx[0]) // 4096)
                    ].astype(np.int64).sum()
                )
                if len(rescan_ctx[0])
                else 0,
            ),
        )

        chunks = []
        h_tot = np.asarray(out.hit_total)
        for t in range(n_tiles):
            if not overflow[t]:
                ht = int(h_tot[t])
                if not ht:
                    continue
                rows = np.empty((ht, 7), dtype=np.int64)
                rows[:, 0] = out.pos1[t, :ht]
                rows[:, 1] = out.pos2[t, :ht]
                rows[:, 2] = out.entry[t, :ht]
                rows[:, 3] = t
                rows[:, 4] = out.pair_order[t, :ht]
                rows[:, 5] = out.rank[t, :ht]
                rows[:, 6] = out.rec[t, :ht]
                chunks.append(rows)
            else:
                done = wave.get(t)
                if done is not None:
                    done[:, 3] = t
                    done[:, 4] = np.arange(len(done), dtype=np.int64)
                    chunks.append(done)
                    continue
                meas = (
                    int(out.c_total[t]), int(out.pos_total[t]),
                    int(out.pair_total[t]), int(out.anch_total[t]),
                    int(out.hit_total[t]),
                )
                chunks.append(
                    self._rescan_stream_tile(cfg0, rescan_ctx, t, meas)
                )
        allrows = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.zeros((0, 7), dtype=np.int64)
        )
        # Partition rows by record with ONE stable argsort + searchsorted
        # (a per-record boolean scan would cost O(n_items * n_hits) —
        # scaffold-heavy FASTA has thousands of items). Within-record
        # order need not be preserved here: the emitter re-sorts by the
        # carried (pos1, tile, pair, rank) keys, which are unique.
        if not len(allrows):
            empty = allrows[:, :6]
            return [empty] * n_items
        srt = allrows[np.argsort(allrows[:, 6], kind="stable")]
        bounds = np.searchsorted(srt[:, 6], np.arange(n_items + 1))
        return [srt[bounds[i] : bounds[i + 1], :6] for i in range(n_items)]

    def _run_stream_tile(self, cfg, rescan_ctx, span_start):
        """Dispatch ONE stream span at the given config (non-blocking;
        returns device arrays)."""
        from .ops.scan import get_stream_scan_fn

        plane_host, rmeta_p, total_scan, stream_len, recmap = rescan_ctx
        # plane_host includes cfg.lead of left padding, and escalation
        # never changes lead/tail — the span's buffer is the plane bytes
        # [span_start // 2, + tile_buf_in)
        src0 = span_start // 2
        buf = plane_host[src0 : src0 + cfg.tile_buf_in]
        if len(buf) < cfg.tile_buf_in:
            buf = np.concatenate(
                [buf, np.zeros(cfg.tile_buf_in - len(buf), np.uint8)]
            )
        fn = get_stream_scan_fn(cfg, 1)
        return fn(
            self._table,
            buf,
            np.int32(span_start),
            np.int32(total_scan),
            np.int32(stream_len),
            rmeta_p,
            recmap,
            self._runtime_params(),
        )

    def _rescan_stream_tile(self, cfg0, rescan_ctx, tile_idx, measured):
        """Retry one overflowing STREAM tile with measured-total
        escalation + budget splitting (see :meth:`_rescan_tile`)."""
        import jax

        def run_span(cfg, span_start):
            return jax.device_get(
                self._run_stream_tile(cfg, rescan_ctx, span_start)
            )

        rows = self._rescan_span(
            cfg0, run_span, tile_idx * cfg0.tile_len, cfg0.tile_len, measured
        )
        rows[:, 3] = tile_idx
        rows[:, 4] = np.arange(len(rows), dtype=np.int64)
        return rows

    # HBM budget for a single rescan program's capacities: a tile whose
    # MEASURED workload needs more splits into position-partitioned
    # subtiles instead (each within budget). Without this, a genuinely
    # flooded 2M-position tile (low-complexity tract x repeat primers:
    # tens of millions of true candidates) would ask XLA for a 30+ GB
    # program. Positions partition cleanly, so splitting changes nothing
    # but the dispatch count; emission order is restored by renumbering
    # the pair key over the assembled tile rows (device hit buffers are
    # already emission-ordered: pair asc, rank asc).
    # (XLA pads the big verify intermediates up to ~5-30x, so these stay
    # well under the naive arithmetic; they were sized for a 16 GB device
    # and are not yet re-derived for the H100's 80 GB. The anchor stage's
    # memory is mostly per-CHUNK bounded — [anch_cap/32, min(hit_cap, 32R)]
    # hloc stack + a few [anch_cap] columns — so its cap can sit far
    # above cand_cap's; a low anch budget makes every anchor-flood tile
    # split needlessly, and each split level re-discovers caps with
    # fresh compiles, which is what flood warmup actually pays for.)
    MAX_CAND_CAP = 1 << 20
    MAX_ANCH_CAP = 1 << 19
    MAX_HIT_CAP = 1 << 20
    MIN_SPLIT_LEN = 1 << 13

    # Kernel memory-map guard: every compiled XLA executable mmaps ~9+
    # regions, and flood content compiles MANY distinct rescan programs
    # (cap/tile-len variants). A process crossing vm.max_map_count
    # (65530 default) SEGFAULTS inside jaxlib (observed at maps=60k on
    # a 47 Mbp low-complexity genome). jax.clear_caches() releases
    # executables; live jitted wrappers recompile transparently.
    MAPS_CLEAR_THRESHOLD = 40_000

    @staticmethod
    def _maybe_clear_caches() -> None:
        try:
            with open("/proc/self/maps") as fh:
                n = sum(1 for _ in fh)
        except OSError:  # non-Linux: no map-count limit of this kind
            return
        if n > MerPCR.MAPS_CLEAR_THRESHOLD:
            import jax

            logger.debug("map count %d; clearing XLA caches", n)
            jax.clear_caches()

    def _over_budget(self, cfg) -> bool:
        return (
            cfg.cand_cap > self.MAX_CAND_CAP
            or cfg.anch_cap > self.MAX_ANCH_CAP
            or cfg.hit_cap > self.MAX_HIT_CAP
        )

    @staticmethod
    def _with_tile_len(cfg, span_len: int):
        if cfg.tile_len == span_len:
            return cfg
        from .ops.scan import ScanConfig

        return ScanConfig(**{**cfg.__dict__, "tile_len": span_len})

    def _rescan_tile(
        self,
        cfg0: ScanConfig,
        seq: np.ndarray,
        n: int,
        tile_idx: int,
        measured: tuple,
    ) -> np.ndarray:
        """Retry one overflowing tile with capacities sized from the
        MEASURED stage totals (``ScanConfig.escalate_measured``): each
        retry fixes at least the first truncated stage exactly, so the
        loop converges in <= 5 recompiles and every buffer stays bounded
        by the tile's true workload (split into subtiles past the HBM
        budget)."""

        def run_span(cfg, span_start):
            import jax

            return jax.device_get(self._run_tile(cfg, seq, n, span_start))

        rows = self._rescan_span(
            cfg0, run_span, tile_idx * cfg0.tile_len, cfg0.tile_len, measured
        )
        rows[:, 3] = tile_idx
        # renumber the within-tile emission key over the span-ordered rows
        rows[:, 4] = np.arange(len(rows), dtype=np.int64)
        return rows[:, :6]

    def _rescan_span(
        self, cfg0, run_span, span_start, span_len, measured
    ) -> np.ndarray:
        """Rescan scan positions [span_start, span_start + span_len) with
        measured-total escalation, splitting in half whenever the needed
        capacities exceed the per-program HBM budget. Returns (n, 7)
        rows (incl. the stream rec column; zeros otherwise) in emission
        order — cols 3 and 4 are overwritten by the caller."""
        cfg = self._with_tile_len(cfg0, span_len)
        nxt = cfg.escalate_measured(*measured)
        if nxt is not None:
            cfg = nxt
        self._rescan_count = getattr(self, "_rescan_count", 0)
        for _ in range(MAX_ESCALATIONS):
            if self._over_budget(cfg) and span_len > self.MIN_SPLIT_LEN:
                half = span_len // 2
                logger.debug(
                    "span @%d len %d needs over-budget caps; splitting",
                    span_start, span_len,
                )
                zero = (0, 0, 0, 0, 0)
                left = self._rescan_span(
                    cfg0, run_span, span_start, half, zero
                )
                right = self._rescan_span(
                    cfg0, run_span, span_start + half, half, zero
                )
                return np.concatenate([left, right], axis=0)
            self._rescan_count += 1
            self._maybe_clear_caches()
            # ONE bulk D2H: per-field int() reads would each pay a full
            # host<->device round trip
            out = run_span(cfg, span_start)
            meas = (
                int(np.asarray(out.c_total).reshape(-1)[0]),
                int(np.asarray(out.pos_total).reshape(-1)[0]),
                int(np.asarray(out.pair_total).reshape(-1)[0]),
                int(np.asarray(out.anch_total).reshape(-1)[0]),
                int(np.asarray(out.hit_total).reshape(-1)[0]),
            )
            nxt = cfg.escalate_measured(*meas)
            if nxt is None:
                ht = meas[4]
                rows = np.empty((ht, 7), dtype=np.int64)
                for col, name in (
                    (0, "pos1"), (1, "pos2"), (2, "entry"),
                    (4, "pair_order"), (5, "rank"), (6, "rec"),
                ):
                    rows[:, col] = np.asarray(getattr(out, name)).reshape(
                        -1
                    )[:ht]
                rows[:, 3] = 0
                return rows
            logger.debug(
                "span @%d overflow (cpos %d/%d pos %d/%d cand %d/%d anch"
                " %d/%d hit %d/%d); escalating to measured totals",
                span_start, meas[0], cfg.cpos_cap, meas[1], cfg.pos_cap,
                meas[2], cfg.cand_cap, meas[3], cfg.anch_cap,
                meas[4], cfg.hit_cap,
            )
            cfg = nxt
        raise RuntimeError("tile capacity escalation failed to converge")

    def _run_tile(self, cfg: ScanConfig, seq: np.ndarray, n: int, tile_start: int):
        from .ops.encoding import NIB_LUT, pack_nibbles
        from .ops.scan import get_scan_fn

        total_scan = n - self.wordsize + 1
        n_scan = min(cfg.tile_len, total_scan - tile_start)
        pos = np.zeros(cfg.tile_buf, dtype=np.uint8)
        src0 = tile_start - cfg.lead
        a = max(0, src0)
        b = min(n, src0 + cfg.tile_buf)
        if b > a:
            chunk = seq[a:b]
            pos[a - src0 : b - src0] = NIB_LUT[chunk] if cfg.packed else chunk
        buf = pack_nibbles(pos) if cfg.packed else pos
        fn = get_scan_fn(cfg)
        return fn(
            self._table,
            buf,
            np.int32(tile_start),
            np.int32(n_scan),
            np.int32(n),
            self._runtime_params(),
        )

    def emit_hits(self, seq_label: str, rows: np.ndarray, output) -> int:
        """Write one record's hit rows (the (n, 6) schema of the device
        and host scans) as reference output lines; returns the count.

        Reproduces T=1 ordering: stable sort by pos1 over hits emitted in
        scan order (tile, pair, rank) — reference engine.py:434 and the
        SURVEY.md §2.1 emission contract."""
        if not len(rows):
            return 0
        rows = rows[np.lexsort((rows[:, 5], rows[:, 4], rows[:, 3], rows[:, 0]))]
        e2r = self._meta.entry_to_record
        for pos1, pos2, entry, _t, _o, _r in rows:
            sts = self.sts_records[int(e2r[int(entry)])]
            print(
                f"{seq_label}\t{pos1 + 1}..{pos2 + 1}\t{sts.id}\t{sts.alias}\t({sts.direct})",
                file=output,
            )
        return len(rows)

    def search(
        self, fasta_records: List[FASTARecord], output_file: Optional[str] = None
    ) -> int:
        """Search all records; emit 5-field tab-delimited hits
        (reference engine.py:365-451; line format engine.py:442)."""
        total_hits = 0
        # Multi-host: every process runs the sharded search (all must join
        # the collectives) but only host 0 emits — the all_gather merge
        # already replicated the full hit set to every process.
        emit_here = True
        if self._multihost:
            from .parallel.distributed import is_output_host

            emit_here = is_output_host()
        # None or the literal string "stdout" (any case) -> stdout
        # (reference engine.py:368-371)
        if not emit_here:
            output = open(os.devnull, "w")
        elif output_file and output_file.lower() != "stdout":
            output = open(output_file, "w")
        else:
            output = sys.stdout

        # Observability: optional XLA profiler trace directory
        # (view with tensorboard / xprof).
        trace_dir = os.environ.get("MERPCR_TPU_TRACE")
        profiler_ctx = None
        if trace_dir:
            import jax

            profiler_ctx = jax.profiler.trace(trace_dir)
            profiler_ctx.__enter__()
        search_t0 = time.time()
        total_bp = 0

        have_table = self._meta is not None and self._meta.n_entries > 0
        if have_table:
            from .io.fasta import record_packed

        # Dispatch plan: RUNS of consecutive packed records (any sizes)
        # concatenate into one gap-separated stream plane scanned as big
        # tiles (scaffold-heavy FASTA would otherwise pay a dispatch +
        # per-tile fixed cost per tiny record) — sharded across the mesh
        # when one is set; lone or unpackable records go through the
        # per-record path. Order == FASTA order throughout. The plan
        # (including each stream run's prebuilt item list) is cached per
        # record-set identity: repeat searches over the same records skip
        # the O(n_records) packing/plan Python entirely.
        # Small-input HOST fast path (ops.host_scan): identical semantics
        # in pure NumPy — a one-shot run on a small genome skips jax
        # startup and program tracing entirely (several seconds). Dense
        # floods fall back to the device path per record.
        host_max = int(os.environ.get("MERPCR_TPU_HOST_MAX", "2000000"))
        use_host = (
            have_table
            and self.mesh is None
            and not self._multihost
            and sum(len(r.sequence) for r in fasta_records) <= host_max
        )

        plan = []
        if use_host:
            plan = [("host", i) for i in range(len(fasta_records))]
        elif have_table:
            pkey = tuple(
                (id(r), len(r.sequence)) for r in fasta_records
            )
            pc = getattr(self, "_plan_cache", None)
            if pc is not None and pc[0] == pkey:
                plan = pc[1]
            else:
                run: List[int] = []
                run_items: List[tuple] = []
                run_pos = 0

                def _flush():
                    nonlocal run_pos
                    if len(run) >= 2:
                        plan.append(("stream", run.copy(), run_items.copy()))
                    else:
                        plan.extend(("single", j) for j in run)
                    run.clear()
                    run_items.clear()
                    run_pos = 0

                for i, rec in enumerate(fasta_records):
                    n = len(rec.sequence)
                    packed = record_packed(rec) if n > 0 else None
                    if packed is not None:
                        if (
                            run_pos + n + 8 > self.STREAM_MAX_POSITIONS
                            or len(run) >= self.STREAM_MAX_RECORDS
                        ):
                            _flush()
                        run.append(i)
                        run_items.append((record_seq_bytes(rec), packed))
                        run_pos += n + 8
                    else:
                        _flush()
                        plan.append(("single", i))
                _flush()
                self._plan_cache = (pkey, plan)
        else:
            plan = [("single", i) for i in range(len(fasta_records))]

        def _dispatch_item(item):
            if not have_table:
                return None
            if item[0] == "host":
                from .ops.host_scan import host_scan_record

                rec = fasta_records[item[1]]
                rows = host_scan_record(
                    self._table_host, self._meta, record_seq_bytes(rec),
                    self.margin, self.mismatches, self.three_prime_match,
                )
                if rows is not None:
                    return ("hostrows", rows)
                # workload past the small-input caps: device path
                return self._dispatch_record(
                    record_seq_bytes(rec), record_packed(rec)
                )
            if item[0] == "single":
                rec = fasta_records[item[1]]
                return self._dispatch_record(
                    record_seq_bytes(rec), record_packed(rec)
                )
            return self._dispatch_stream(item[2])

        log_info = logger.isEnabledFor(logging.INFO)
        log_debug = logger.isEnabledFor(logging.DEBUG)
        try:
            # depth-1 prefetch: the next plan item's host-side prep +
            # dispatch overlap this item's device compute and host post-
            # processing (per-record serialization otherwise dominates
            # many-contig workloads — dispatch latency + D2H per record)
            ctx_next = _dispatch_item(plan[0]) if plan else None
            for pi, item in enumerate(plan):
                t0 = time.time() if log_debug else 0.0
                ctx = ctx_next
                ctx_next = (
                    _dispatch_item(plan[pi + 1])
                    if pi + 1 < len(plan)
                    else None
                )
                if item[0] != "stream":
                    idxs = [item[1]]
                    if ctx is None:
                        arrs = [np.zeros((0, 6), dtype=np.int64)]
                    elif ctx[0] == "hostrows":
                        arrs = [ctx[1]]
                    else:
                        arrs = [self._collect_record(ctx)]
                else:
                    idxs = item[1]
                    arrs = self._collect_stream(ctx)

                for j, arr in zip(idxs, arrs):
                    record = fasta_records[j]
                    seq_label = record.label
                    seq_len = len(record.sequence)
                    if log_info:
                        logger.info(
                            "Processing sequence: %s (%d bp)",
                            seq_label, seq_len,
                        )
                    total_hits += self.emit_hits(seq_label, arr, output)
                    total_bp += seq_len
                    if log_debug:
                        logger.debug(
                            "searched %s (%d bp) in %.3fs",
                            seq_label, seq_len, time.time() - t0,
                        )
        finally:
            if output is not sys.stdout:
                output.close()
            if profiler_ctx is not None:
                profiler_ctx.__exit__(None, None, None)

        elapsed = time.time() - search_t0
        if elapsed > 0 and total_bp:
            logger.info(
                "Throughput: %.2f Mbp/s (%d bp in %.3fs)",
                total_bp / 1e6 / elapsed, total_bp, elapsed,
            )
        logger.info(f"Total hits found: {total_hits}")
        self.total_hits = total_hits
        return total_hits
