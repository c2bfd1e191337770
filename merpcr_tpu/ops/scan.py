"""The tile scan pipeline — the accelerator replacement for the reference's
interpreted hot loops (engine.py:453-505 `_process_thread`,
engine.py:507-597 `_match_sts`, engine.py:599-642 `_compare_seqs`).

Design (array program, everything static-shaped and jit-compiled once):

  tile bytes (uint8[TB], halo-padded; packed = 2 bases/byte)
    │ 1. u32-unit decode: 8 LSB-first 2-bit codes per unit; stride-S
    │    group registers come from consecutive unit slices — no rolling
    │    hash, no strided relayouts; W-mer values derive arithmetically
    │ 2. ambiguity masks aligned with the code bits (dirty base -> 11)
    │ 3. ONE any-phase table bit per S positions (exact direct-mapped
    │    1-bit table when the span fits; mult-hash bloom for large W) —
    │    the hot gather stays on the SMALLEST table (small tables stay
    │    cache-resident)
    ▼
  compacted candidate groups (word-bitpack + scatter-max rank inversion)
    │ 4. phase-bit nibble: ONE exact phase-table gather per compacted
    │    group says WHICH phases hold real bucket keys (zero false
    │    phases; validity-bit fallback for dirty spans / large W)
    │ 5. (group, phase) -> position and (position, slot) -> pair
    │    expansions via scatter-max rank inversion; one exact-CSR
    │    (start,count) row gather per position
    ▼
  candidate pairs (cap CAND) ── 6. primer1 verify: 16-byte row gathers +
    │                              byte barrel shift + nibble interleave;
    │                              mismatch budget + 3' tail protection
    ▼
  anchors (nonzero, cap ANCH) ─ 7. margin-window primer2 verify over all
    │                              2*margin+1 offsets at once (+ head 3'
    │                              protection), reference clamp semantics
    ▼
  hits (nonzero, cap HIT): pos1/pos2/entry + emission-order keys

Semantics notes (each is load-bearing for byte-identical output):
* A scan window is usable iff it contains no ambiguous base — provably
  equivalent to the reference's N-countdown (engine.py:462-478, 496-503):
  N==0 at pos p iff no AMBIG base in [p, p+W-1].
* Scan positions are partitioned across tiles (each position owned by
  exactly one tile), so cross-tile hits are never duplicated and no dedup
  pass is needed; halos only provide read-only context. Coordinates and
  end-of-sequence clamps are computed in GLOBAL record coordinates, so
  tiling is invisible to the output (unlike the reference's T>1 chunking
  bug, SURVEY.md §2.1 — we match its T=1 ground truth).
* Emission order: the reference appends hits scanning pos ascending, bucket
  slots in file order, and window offsets expected-first-then ±1, ±2, …
  (engine.py:543-593), then stable-sorts by pos1 (engine.py:434). We carry
  (pair_order, rank) keys per hit; the host sorts by
  (pos1, tile, pair_order, rank) to reproduce the exact order.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .encoding import AMBIG, iupac_exp_masks
from .table import PROJ_UNIT_START, DeviceTable

_EXP_NIB = iupac_exp_masks()[0]  # uint32[16] genome-letter expansion masks


def _exp_nib_select(sb: jnp.ndarray) -> jnp.ndarray:
    """EXP_NIB[sb] for 4-bit codes WITHOUT a gather: a 15-`where` binary
    select tree over broadcast constants (pure elementwise ops; a
    per-element LUT gather here would dominate IUPAC-mode verify)."""
    e = [jnp.uint32(int(v)) for v in _EXP_NIB]
    sel = (sb & 1) != 0
    lvl = [jnp.where(sel, e[i + 1], e[i]) for i in range(0, 16, 2)]
    sel = (sb & 2) != 0
    lvl = [jnp.where(sel, lvl[i + 1], lvl[i]) for i in range(0, 8, 2)]
    sel = (sb & 4) != 0
    lvl = [jnp.where(sel, lvl[i + 1], lvl[i]) for i in range(0, 4, 2)]
    return jnp.where((sb & 8) != 0, lvl[1], lvl[0])


@dataclass(frozen=True)
class ScanConfig:
    """Static (compile-time) scan parameters."""

    wordsize: int
    margin: int  # margin CAP: sets window shapes; the actual -M value (and
    #              -N / -X, which affect no shapes) are RUNTIME scalars, so
    #              parameter sweeps share one compiled program
    iupac: bool  # -I: verify via 256x256 LUT; else arithmetic case-fold
    packed: bool  # genome shipped as 4-bit nibbles, 2 bases/byte
    stride: int  # packed path: scan positions covered per group lookup (2|4)
    qbloom_bits: int  # log2 bits of the group table
    exact_group: bool  # direct-mapped exact group table vs mult-hash bloom
    tile_len: int  # scan positions per tile (L)
    lead: int  # left halo bytes  = max hash_offset over entries
    tail: int  # right halo bytes = max_pcr_size + margin
    p1_max: int
    p2_max: int
    bloom_bits: int
    cpos_cap: int
    pos_cap: int  # packed path: (group, phase) candidate positions
    cand_cap: int
    anch_cap: int
    hit_cap: int
    # Strict (N==0) mode: the front end gathers the extension-strict group
    # table (table.qbloom_s), and — when t16_bits > 0 — one
    # hashed 16-base-window gather per expanded position filters candidates
    # to ~real-match density before pair expansion (see table._build_strict).
    strict: bool = False
    strict_n: int = 0  # mismatch budget baked into the strict tables the
    #                    scan gathers (0: qbloom_s/t16; 1: qbloom_s1/t16_1
    #                    — ext positions Hamming-1-wildcarded at build)
    t16_bits: int = 0
    # Dirty-genome phase filter (strict mode): units whose KEYED bases are
    # dirty bypass the strict table (semantics — a dirty base can match
    # through IUPAC expansion or literal equality), and without a filter
    # every W-clean phase of every bypassed unit expands through the CSR:
    # a 1%-scattered-IUPAC genome flags ~12% of units and pos machinery
    # explodes. A valid phase's W-mer WINDOW is clean by definition, so
    # its W-mer value is real — one ``bloom`` gather per (unit, phase) at
    # compacted-unit granularity prunes dirty-span phases to actual
    # bucket keys (exact for W <= 12; sound prefix filter above). Armed
    # by default_config when the measured dirty rate is non-trivial, so
    # clean-genome programs are unchanged.
    dirty_bloom: bool = False
    # Stream mode: the tile holds MANY concatenated records separated by
    # dirty-nibble gaps (which the ambiguity masks already exclude, so no
    # scan window or candidate ever crosses a boundary). Per-candidate
    # record identity is recovered with one searchsorted over the packed
    # record-start column of ``rmeta`` (int32[RB, 2] = global start, len);
    # all bounds/margin clamps then run in record-local coordinates and
    # hits carry a record index. Amortizes every per-tile and per-dispatch
    # fixed cost across scaffold-sized records.
    stream: bool = False

    @property
    def tile_buf(self) -> int:
        """Tile buffer length in POSITIONS (bases)."""
        return self.lead + self.tile_len + self.tail

    @property
    def tile_buf_in(self) -> int:
        """Tile buffer length in INPUT BYTES (2 bases/byte when packed)."""
        return self.tile_buf // 2 if self.packed else self.tile_buf

    @property
    def n_ranks(self) -> int:
        return 2 * self.margin + 1

    @property
    def front_stride(self) -> int:
        """Scan positions covered per front-end table lookup: the strict
        unit-projection flags whole u32 units (8 positions); the loose
        path flags stride-groups."""
        if not self.packed:
            return 1
        return 8 if self.strict else self.stride

    def escalate(self, factor: int = 4) -> "ScanConfig":
        """Larger capacities for tiles that overflow the fixed buffers."""
        units = self.tile_len // self.front_stride
        return ScanConfig(
            **{
                **self.__dict__,
                "cpos_cap": min(self.cpos_cap * factor, units),
                "pos_cap": min(self.pos_cap * factor, self.tile_len),
                "cand_cap": self.cand_cap * factor,
                "anch_cap": self.anch_cap * factor,
                "hit_cap": self.hit_cap * factor,
            }
        )

    def escalate_measured(
        self, c: int, x: int, p: int, a: int, h: int, exact: bool = False
    ) -> "ScanConfig | None":
        """Capacity escalation sized by the tile's MEASURED stage totals.

        The ``*_total`` counters are full-tile reductions computed before
        any truncation, so the FIRST overflowing stage's total is always
        exact (downstream totals can only underestimate while an upstream
        stage is truncated). Growing each overflowing stage to its
        measured total therefore fixes at least the first broken stage
        per retry — convergence in <= 5 recompiles — and every capacity is
        bounded by the tile's true workload (rounded up to the next power
        of two, so tiles/subtiles with similar floods share ONE compiled
        program — flood rescans are compile-bound otherwise), never a
        blind geometric blowup. Returns None when all stages fit (the
        caller's result is complete)."""
        units = self.tile_len // self.front_stride

        def up(total, cap, hard):
            if total <= cap:
                return cap
            p = 1024
            while p < total:
                p <<= 1
            return min(p, hard)

        # A truncated upstream stage makes every DOWNSTREAM total a lower
        # bound; scale them by the worst upstream truncation ratio so one
        # retry discovers the whole pipeline's needs instead of one stage
        # per recompile (flood rescans are compile-bound — each distinct
        # cap combo is a fresh program). ``exact=True`` says the totals
        # were measured WITHOUT truncation (e.g. remembered from a prior
        # resolved rescan of the same tile) — scaling those compounds
        # into absurd caps, so they size directly.
        ratio = 1.0
        scaled = []
        for total, cap in ((c, self.cpos_cap), (x, self.pos_cap),
                           (p, self.cand_cap), (a, self.anch_cap),
                           (h, self.hit_cap)):
            scaled.append(int(total * ratio))
            if total > cap and not exact:
                ratio = max(ratio, total / float(cap))
        c2, x2, p2, a2, h2 = scaled

        caps = {
            "cpos_cap": up(c2, self.cpos_cap, units),
            "pos_cap": up(x2, self.pos_cap, self.tile_len),
            # pairs/anchors/hits have no static ceiling below their true
            # totals (sum of bucket counts over the tile's W-mers); the
            # measured total IS the provable bound
            "cand_cap": up(p2, self.cand_cap, 1 << 30),
            "anch_cap": up(a2, self.anch_cap, 1 << 30),
            "hit_cap": up(h2, self.hit_cap, 1 << 30),
        }
        # the unscaled totals decide WHETHER anything grew (scaling must
        # not manufacture an escalation when every stage already fits)
        if (c <= self.cpos_cap and x <= self.pos_cap and p <= self.cand_cap
                and a <= self.anch_cap and h <= self.hit_cap):
            return None
        return ScanConfig(**{**self.__dict__, **caps})


class ScanOut(NamedTuple):
    """Per-tile scan results (fixed capacity; *_total give true counts)."""

    c_total: jnp.ndarray  # int32 — candidate groups flagged
    pos_total: jnp.ndarray  # int32 — (group, phase) positions expanded
    pair_total: jnp.ndarray  # int32 — (pos, slot) pairs expanded
    anch_total: jnp.ndarray  # int32 — primer1-passing anchors
    hit_total: jnp.ndarray  # int32 — hits emitted
    pos1: jnp.ndarray  # int32[hit_cap] RECORD-local 0-based anchor position
    pos2: jnp.ndarray  # int32[hit_cap] record-local amplicon end (inclusive)
    entry: jnp.ndarray  # int32[hit_cap] device entry index
    pair_order: jnp.ndarray  # int32[hit_cap] within-tile emission key (major)
    rank: jnp.ndarray  # int32[hit_cap] within-anchor emission key (minor)
    rec: jnp.ndarray  # int32[hit_cap] rmeta row of the hit (0 single-record)


def _bit_at(word: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Extract bit ``b`` (0..31) of each ``word`` via a 5-level
    CONSTANT-shift binary select instead of a per-lane variable-amount
    shift (``word >> b``) — the form the pipeline was tuned with on its
    first accelerator; not yet re-measured on the GPU."""
    w = word
    for k in (16, 8, 4, 2, 1):
        w = jnp.where((b & k) != 0, w >> k, w)
    return w & 1


def _byte_fold(b: jnp.ndarray) -> jnp.ndarray:
    """Uppercase-fold a byte vector arithmetically (ASCII letters only),
    matching the reference's ``.upper()`` comparisons (engine.py:631)."""
    is_lower = (b >= ord("a")) & (b <= ord("z"))
    return jnp.where(is_lower, b - 32, b)


def _encode_codes(tile_bytes: jnp.ndarray) -> jnp.ndarray:
    """Exact scode semantics (reference engine.py:102-109) without a gather:
    A/a->0 C/c->1 G/g->2 T/t/U/u->3, everything else AMBIG."""
    b = tile_bytes.astype(jnp.int32)
    folded = b | 32  # lowercase letters unchanged; uppercase -> lowercase
    is_letter = (folded >= ord("a")) & (folded <= ord("z"))
    b5 = b & 0x1F
    code = jnp.where(
        b5 == 1, 0,
        jnp.where(
            b5 == 3, 1,
            jnp.where(b5 == 7, 2, jnp.where((b5 == 20) | (b5 == 21), 3, AMBIG)),
        ),
    )
    return jnp.where(is_letter, code, AMBIG)


def _rank_invert(cnt: jnp.ndarray, cap_out: int):
    """Invert a monotone rank map with one scatter-max + cummax instead of
    a log-depth ``searchsorted`` over ``cap_out`` lanes.

    ``cnt``: int32[S] non-negative counts per source. Output slot q in
    [0, sum(cnt)) belongs to the source i with
    excl[i] <= q < excl[i] + cnt[i], where excl is the exclusive prefix
    sum. Returns ``(src, excl_at_src)`` — both int32[cap_out]; entries at
    q >= sum(cnt) are garbage (callers mask by total).
    """
    S = cnt.shape[0]
    csum = jax.lax.cumsum(cnt)
    excl = csum - cnt
    # Scatter i+1 at excl[i] for every source with cnt>0 (their excl values
    # are strictly increasing, hence unique); empty sources go to the
    # out-of-bounds dump slot and are dropped.
    tgt = jnp.where(cnt > 0, excl, cap_out)
    ids = jnp.arange(1, S + 1, dtype=jnp.int32)
    seed = jnp.zeros((cap_out,), jnp.int32).at[tgt].max(ids, mode="drop")
    src = jnp.clip(jax.lax.cummax(seed) - 1, 0, S - 1)
    return src, excl[src]


def _rank_d(r: int) -> int:
    """Rank -> margin-window offset: 0, -1, +1, -2, +2, … (the reference's
    expected-first-then-±i order, engine.py:543-593)."""
    return -((r + 1) // 2) if r % 2 == 1 else r // 2


def _row_window(
    tile_bytes: jnp.ndarray, TB: int, pos0: jnp.ndarray, n_out: int
) -> jnp.ndarray:
    """Gather [cap, n_out] 4-bit letter codes starting at local positions
    ``pos0`` from the packed nibble plane, at per-ROW gather cost.

    Fetches NR aligned 16-byte rows per lane, barrel-rotates by the byte
    offset, and interleaves nibbles — replacing n_out per-element gathers
    with NR row gathers per lane.

    ``pos0`` is clamped so every fetched row is in range; callers must mask
    lanes whose true window is out of bounds (clamped lanes read shifted
    data, never fault).
    """
    RB = 16
    cap = pos0.shape[0]
    rows2d = tile_bytes.reshape(TB // 2 // RB, RB)
    spanb = n_out // 2 + 1
    NR = -(-(RB - 1 + spanb) // RB)
    p0 = jnp.clip(pos0, 0, TB - 32 * NR)  # keeps row0 + NR within the plane
    byte0 = p0 >> 1
    row0 = byte0 >> 4
    g = rows2d[row0[:, None] + jax.lax.broadcasted_iota(jnp.int32, (1, NR), 1)]
    x = g.reshape(cap, NR * RB).astype(jnp.int32)
    boff = (byte0 & (RB - 1))[:, None]
    for k in (8, 4, 2, 1):  # barrel rotate left by boff bytes
        x = jnp.where((boff & k) != 0, jnp.roll(x, -k, axis=1), x)
    il = jnp.stack([x & 15, x >> 4], axis=-1).reshape(cap, 2 * NR * RB)
    return jnp.where(
        ((p0 & 1) == 0)[:, None],
        il[:, :n_out],
        il[:, 1 : n_out + 1],
    )


def _empty_out(cfg: ScanConfig) -> ScanOut:
    z = jnp.int32(0)
    zh = jnp.zeros((cfg.hit_cap,), jnp.int32)
    return ScanOut(z, z, z, z, z, zh, zh, zh, zh, zh, zh)


def _scan_tile(
    cfg: ScanConfig,
    table: DeviceTable,
    tile_bytes: jnp.ndarray,  # uint8[TB]
    tile_start: jnp.ndarray,  # int32 scalar: global scan pos of local index 0
    n_scan: jnp.ndarray,  # int32 scalar: valid scan positions (<= tile_len)
    record_len: jnp.ndarray,  # int32 scalar: global record/stream length
    rt: jnp.ndarray,  # int32[3]: runtime (-M margin <= cap, -N, -X)
    rmeta: jnp.ndarray | None = None,  # stream mode: int32[RB, 2] (start, len)
    recmap: jnp.ndarray | None = None,  # stream: int32[ceil(len/8)] block->rec
) -> ScanOut:
    """Scan one tile; padding tiles (n_scan <= 0) short-circuit via cond."""
    return jax.lax.cond(
        n_scan > 0,
        lambda: _scan_tile_impl(
            cfg, table, tile_bytes, tile_start, n_scan, record_len, rt,
            rmeta=rmeta, recmap=recmap,
        ),
        lambda: _empty_out(cfg),
    )


def _scan_tile_impl(
    cfg: ScanConfig,
    table: DeviceTable,
    tile_bytes: jnp.ndarray,
    tile_start: jnp.ndarray,
    n_scan: jnp.ndarray,
    record_len: jnp.ndarray,
    rt=None,  # int32[3] runtime (margin, mismatches, three_prime); None ->
    #           (cap, 0, 1) — only used by profiling harnesses
    stop: str | None = None,  # profiling hook: truncate after a stage
    rmeta: jnp.ndarray | None = None,  # stream mode (cfg.stream)
    recmap: jnp.ndarray | None = None,  # stream mode: block->record map
) -> ScanOut:
    def _stopped(*vals):
        acc = jnp.int32(0)
        for v in vals:
            acc = acc + jnp.sum(v.astype(jnp.int32))
        o = _empty_out(cfg)
        return o._replace(c_total=acc)
    W = cfg.wordsize
    L = cfg.tile_len
    LEAD = cfg.lead
    TB = cfg.tile_buf
    M = cfg.margin  # shape cap
    if rt is None:
        rt = jnp.asarray([M, 0, 1], dtype=jnp.int32)
    Mdyn, NMM, X = rt[0], rt[1], rt[2]
    R = cfg.n_ranks
    E = table.hash_offset.shape[0]
    U = table.uhash.shape[0]

    # ---- 0-3. hash + validity + occupancy flags ---------------------------
    def bloom_flag(h, pvalid):
        shift = 2 * W - cfg.bloom_bits  # >= 0
        bk = (h >> shift) if shift else h
        word = table.bloom[(bk >> 5).astype(jnp.int32)]
        return pvalid & (_bit_at(word, bk & 31) == 1)

    NW = L // 32
    if cfg.packed:
        # u32-unit front end. The packed nibble plane is bitcast to uint32
        # "units" of 8 bases (base k of a unit in nibble k), and 2-bit
        # codes are extracted with three mask-shift compaction steps —
        # ~9 elementwise ops per 8 bases vs ~26 for a per-nibble loop. Everything
        # is LSB-first (base j of a value at bits [2j, 2j+2)), so each
        # phase's W-mer bucket value is ONE shift-and of the group
        # register and the group-table index is a mask of it; table.py
        # compiles bucket keys and the group table under the same
        # convention (see table._lsb_keys).
        #
        # A group of S consecutive scan positions does ONE table lookup.
        # With the exact direct-mapped table (cfg.exact_group) the bit is
        # "some phase of this exact span value starts a bucket key" — no
        # false positives. The mult-hash fallback (large W) only ever
        # over-approximates; either way the per-phase exact CSR below
        # removes false positives, so candidates are never dropped.
        S_ = cfg.stride
        Q = L // S_  # groups per tile (one table lookup each)
        P = 8 // S_  # groups (parities) per u32 unit
        QP = Q // P  # groups per parity == u32 units in the scan span
        span = W + S_ - 1
        KB = span if cfg.exact_group else min(16, span)  # key bases
        m2w = jnp.uint32(((1 << (2 * W)) - 1) & 0xFFFFFFFF)
        m2kb = jnp.uint32(((1 << (2 * KB)) - 1) & 0xFFFFFFFF)

        u32 = jax.lax.bitcast_convert_type(
            tile_bytes.reshape(-1, 4), jnp.uint32
        )
        m = u32 & 0x33333333
        m = (m | (m >> 2)) & 0x0F0F0F0F
        m = (m | (m >> 4)) & 0x00FF00FF
        cw = (m | (m >> 8)) & 0x0000FFFF  # 8 LSB-first 2-bit codes/unit
        a = (u32 >> 2) & 0x33333333  # non-ACGT nibble (>= 4) leaves bits
        a = (a | (a >> 2)) & 0x0F0F0F0F
        a = (a | (a >> 4)) & 0x00FF00FF
        aw = (a | (a >> 8)) & 0x0000FFFF  # nonzero 2-bit field = dirty base

        u0 = LEAD // 8
        c0 = jax.lax.dynamic_slice(cw, (u0,), (QP,))
        c1 = jax.lax.dynamic_slice(cw, (u0 + 1,), (QP,))
        c2 = jax.lax.dynamic_slice(cw, (u0 + 2,), (QP,))
        a0 = jax.lax.dynamic_slice(aw, (u0,), (QP,))
        a1 = jax.lax.dynamic_slice(aw, (u0 + 1,), (QP,))
        a2 = jax.lax.dynamic_slice(aw, (u0 + 2,), (QP,))
        W0 = c0 | (c1 << 16)  # bases 0..15 from the unit start
        Wa = a0 | (a1 << 16)
        # group state rows: the expand stage rebuilds any parity's
        # registers from ONE row gather of [c0 c1 c2 a0 a1 a2]
        gstate = jnp.stack([c0, c1, c2, a0, a1, a2], axis=-1)

        if cfg.strict:
            qb_tab = table.qbloom_s1 if cfg.strict_n == 1 else table.qbloom_s
        else:
            qb_tab = table.qbloom
        # Exact group tables may be host-truncated (table._truncate_group_
        # table); the strict unit-projection table keys window bases
        # C..C+12 (table.PROJ_UNIT_START). Deriving the key width from
        # the table's actual (trace-time) shape makes a config/table
        # mismatch impossible — an oversized mask would gather out of
        # bounds (clamped -> wrong flags -> lost candidates).
        gq = (int(qb_tab.shape[0]) * 32).bit_length() - 1
        m2q = jnp.uint32(((1 << min(gq, 32)) - 1) & 0xFFFFFFFF)
        # multiply by 2^lane instead of shifting by a per-lane amount
        # (see _bit_at on variable-amount shifts)
        wpow = jnp.asarray(
            np.uint32(1) << np.arange(32, dtype=np.uint32)
        ).reshape(1, 32)
        rlane = jax.lax.broadcasted_iota(jnp.int32, (QP,), 0)

        if cfg.strict:
            # ---- unit-projection front end: ONE gather per u32 UNIT ----
            # (8 scan positions). The 26-bit key = window bases C..C+12,
            # assembled from the W0/c2 registers; truncated tables keep
            # the low gq bits (top bases folded away). Bypass (dirty keyed
            # bases) and per-phase validity follow the loose semantics.
            C2 = 2 * PROJ_UNIT_START
            hi_m = jnp.uint32((1 << (2 * (PROJ_UNIT_START - 3))) - 1)
            kfull = (W0 >> C2) | ((c2 & hi_m) << (32 - C2))
            vfull = (Wa >> C2) | ((a2 & hi_m) << (32 - C2))
            bk = kfull & m2q
            vq = (vfull & m2q) == 0
            qword = qb_tab[(bk >> 5).astype(jnp.int32)]
            hitu = _bit_at(qword, bk & 31) == 1
            # Any-phase W-mer validity via an exact-width OR-smear: smear
            # the dirty 2-bit fields left over exactly W bases (binary
            # decomposition of W; bits flow in from the a2 register at
            # each step), so field d of the result is nonzero iff window
            # d..d+W-1 contains a dirty base. ~12 elementwise ops instead of an
            # 8-iteration per-phase loop (the decode stage is op-count-
            # bound). Per-phase scan bounds are enforced exactly by the
            # nbv masks downstream; here a whole-unit bound suffices
            # (over-flagging the tile's tail unit only costs one
            # compacted lane).
            sm = {1: (Wa, a2)}
            for w in (2, 4, 8, 16):
                lo, hi = sm[w // 2]
                s = w  # shift = 2 * (w // 2)
                sm[w] = (lo | ((lo >> s) | (hi << (32 - s))), hi | (hi >> s))
            need, got = W, 0
            acc_lo = jnp.uint32(0)
            for w in (16, 8, 4, 2, 1):
                if need & w:
                    lo, hi = sm[w]
                    s = 2 * got
                    acc_lo = acc_lo | (
                        lo if s == 0 else (lo >> s) | (hi << (32 - s))
                    )
                    got += w
            dirty2 = (acc_lo | (acc_lo >> 1)) & jnp.uint32(0x5555)
            pvU = (dirty2 != jnp.uint32(0x5555)) & (rlane * 8 < n_scan)
            if stop == "hash":
                return _stopped(kfull, pvU)
            # Units whose keyed bases contain an ambiguous base skip the
            # table (their value bits are garbage) and go straight to the
            # exact per-phase machinery — only costs capacity near
            # ambiguity runs (and keeps IUPAC dirty-genome matches).
            flag = pvU & (hitu | ~vq)
            if stop == "bloom":
                return _stopped(flag)
            c_total = jnp.sum(flag.astype(jnp.int32))
            NWU = QP // 32
            words = jnp.sum(
                flag.reshape(NWU, 32).astype(jnp.uint32) * wpow,
                axis=1,
                dtype=jnp.uint32,
            )
        else:
            AV, pvs, vcs = [], [], []
            for p in range(P):  # parity p: groups at unit base S_*p
                sh = 2 * S_ * p
                if sh == 0:
                    A, Aa = W0, Wa
                else:
                    A = (W0 >> sh) | (c2 << (32 - sh))
                    Aa = (Wa >> sh) | (a2 << (32 - sh))
                Ba = a2 >> sh  # shifted-window bits 32.. (W-mer spill, W=16)
                pv = jnp.zeros((QP,), jnp.bool_)
                for d in range(S_):
                    va = (Aa >> (2 * d)) & m2w
                    if 2 * (d + W) > 32:  # only possible for d >= 1
                        va = va | ((Ba << (32 - 2 * d)) & m2w)
                    pv = pv | (
                        (va == 0) & (rlane * 8 + S_ * p + d < n_scan)
                    )
                AV.append((A & m2kb))
                pvs.append(pv)
                vcs.append((Aa & m2kb) == 0)
            if stop == "hash":
                return _stopped(*AV, *pvs)

            flags_p = []
            for p in range(P):
                if cfg.exact_group:
                    # truncated tables drop top span bases: low gq bits
                    bk = AV[p] & m2q
                else:
                    bk = (AV[p] * jnp.uint32(0x9E3779B1)) >> (
                        32 - cfg.qbloom_bits
                    )
                qword = qb_tab[(bk >> 5).astype(jnp.int32)]
                hit = _bit_at(qword, bk & 31) == 1
                # Groups whose key span contains an ambiguous base skip
                # the table and go straight to the exact per-phase CSR.
                flags_p.append(pvs[p] & (hit | ~vcs[p]))
            if stop == "bloom":
                return _stopped(*flags_p)
            c_total = jnp.int32(0)
            for f in flags_p:
                c_total = c_total + jnp.sum(f.astype(jnp.int32))

            # Pack each parity's flags into 32-bit words over r, then bit-
            # interleave the P parity streams into GROUP-ordered words
            # (group q = r*P + p), preserving the ascending-position
            # emission order through the word-level compaction below.
            QPW = QP // 32
            NWU = Q // 32
            pw = [
                jnp.sum(
                    f.reshape(QPW, 32).astype(jnp.uint32) * wpow,
                    axis=1,
                    dtype=jnp.uint32,
                )
                for f in flags_p
            ]

            def _spread(x, step):
                """Zero-interleave the low 32//step bits to stride step."""
                if step == 2:
                    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
                    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
                    x = (x | (x << 2)) & jnp.uint32(0x33333333)
                    x = (x | (x << 1)) & jnp.uint32(0x55555555)
                else:  # step == 4
                    x = (x | (x << 12)) & jnp.uint32(0x000F000F)
                    x = (x | (x << 6)) & jnp.uint32(0x03030303)
                    x = (x | (x << 3)) & jnp.uint32(0x11111111)
                return x

            parts = []
            for s in range(P):  # s-th group-word from each parity word
                width = 32 // P
                sub = [(w >> (width * s)) & ((1 << width) - 1) for w in pw]
                acc = _spread(sub[0], P)
                for i in range(1, P):
                    acc = acc | (_spread(sub[i], P) << i)
                parts.append(acc)
            words = jnp.stack(parts, axis=-1).reshape(NWU)
    else:
        codes = _encode_codes(tile_bytes)
        isamb = codes == AMBIG
        cc = jnp.where(isamb, 0, codes).astype(jnp.uint32)
        h = jnp.zeros((L,), dtype=jnp.uint32)
        amb = jnp.zeros((L,), dtype=jnp.bool_)
        for i in range(W):  # static unroll: W <= 16 shifted ORs
            # LSB-first: base i of the window at bits [2i, 2i+2)
            h = h | (jax.lax.dynamic_slice(cc, (LEAD + i,), (L,)) << (2 * i))
            amb = amb | jax.lax.dynamic_slice(isamb, (LEAD + i,), (L,))
        lane = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
        flag = bloom_flag(h, (~amb) & (lane < n_scan))
        c_total = jnp.sum(flag.astype(jnp.int32))
        NWU = NW
        fb = flag.reshape(NWU, 32).astype(jnp.uint32)
        wpow = jnp.asarray(
            np.uint32(1) << np.arange(32, dtype=np.uint32)
        ).reshape(1, 32)
        words = jnp.sum(fb * wpow, axis=1, dtype=jnp.uint32)

    # ---- 4. compact candidate units + exact CSR lookup --------------------
    # Hierarchical compaction: flags are packed into 32-bit words (cheap elementwise
    # reduce), nonzero runs over the 32x-smaller word array, then the (rare)
    # non-empty words' bits are expanded. A word with any bit set implies
    # >= 1 candidate unit, so w_total <= c_total and cpos_cap bounds both —
    # no new overflow mode. Order (word asc, bit asc) == unit asc,
    # preserving the emission-order contract. A "unit" is a position-pair
    # in packed mode, a single position otherwise.
    if stop == "words":
        return _stopped(words)
    (widx,) = jnp.nonzero(words != 0, size=cfg.cpos_cap, fill_value=NWU - 1)
    wordsel = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (cfg.cpos_cap,), 0)
        < jnp.sum((words != 0).astype(jnp.int32)),
        words[widx],
        0,
    )
    # Expand set bits to unit indices without a (cap x 32)-lane nonzero:
    # popcount prefix sums assign each output slot q its (word, rank), and
    # a 5-level binary search selects the rank-th set bit — all elementwise ops.
    pc = jax.lax.population_count(wordsel).astype(jnp.int32)
    q = jax.lax.broadcasted_iota(jnp.int32, (cfg.cpos_cap,), 0)
    wsel, wexcl = _rank_invert(pc, cfg.cpos_cap)
    r = q - wexcl
    wq = wordsel[wsel]
    b = jnp.zeros_like(r)
    for half in (16, 8, 4, 2, 1):
        lowmask = jnp.uint32((1 << half) - 1)
        clow = jax.lax.population_count(wq & lowmask).astype(jnp.int32)
        go_hi = r >= clow
        b = b + jnp.where(go_hi, half, 0)
        r = r - jnp.where(go_hi, clow, 0)
        wq = jnp.where(go_hi, wq >> half, wq & lowmask)
    cpos = widx[wsel] * 32 + b  # ascending unit indices
    if stop == "nonzero":
        return _stopped(widx, wordsel)
    if stop == "compact":
        return _stopped(cpos)
    clane = jax.lax.broadcasted_iota(jnp.int32, (cfg.cpos_cap,), 0)
    cvalid = clane < c_total

    def exact_csr(hq, mask):
        """Exact bucket lookup; returns (start, count).

        W <= 11: ONE row gather into the dense (start, count) pair
        table. W == 12:
        two gathers into bucket_start. Larger W: log2(U)-step binary
        search over sorted unique hashes."""
        if W <= 11:  # table.bsc is (4^W, 2) [start, count] rows
            sc = table.bsc[hq.astype(jnp.int32)]
            return sc[:, 0], jnp.where(mask, sc[:, 1], 0)
        if W == 12:  # table.bstart has 4^W + 1 entries
            hi = hq.astype(jnp.int32)
            start = table.bstart[hi]
            cnt = jnp.where(mask, table.bstart[hi + 1] - start, 0)
            return start, cnt
        u = jnp.searchsorted(table.uhash, hq)
        uc = jnp.clip(u, 0, U - 1)
        found = (u < U) & (table.uhash[uc] == hq) & mask
        start = table.ustart[uc]
        cnt = jnp.where(found, table.ustart[uc + 1] - start, 0)
        return start, cnt

    # ---- 5. (unit, slot) -> candidate expansion ---------------------------
    if cfg.packed:

        def plane_at(idx):
            """Gather 4-bit letter codes at (clipped) position indices."""
            ic = jnp.clip(idx, 0, TB - 1)
            pkb = tile_bytes[ic >> 1].astype(jnp.int32)
            return jnp.where((ic & 1) == 0, pkb & 15, pkb >> 4)

    else:

        def plane_at(idx):
            return tile_bytes[jnp.clip(idx, 0, TB - 1)].astype(jnp.int32)

    if cfg.packed:
        # Each compacted unit/group contributes its phases' bucket
        # candidates in phase order d (ascending scan position — the
        # emission-order contract). Which phases participate is decided by
        # the phase-bit nibble nb (bit d = phase d may anchor a bucket
        # key): for clean spans in exact mode, gathers of the exact phase
        # table (zero false phases, so the expansion below tracks real
        # density); otherwise the per-phase validity bits (the exact CSR
        # probe then rejects non-keys). SPH = phases per compacted item:
        # the strict front end compacts whole u32 UNITS (8 positions),
        # the loose front end stride-groups.
        if cfg.strict:
            SPH = 8
            gs = gstate[cpos]  # ONE row gather: [c0 c1 c2 a0 a1 a2]
            Ac = gs[:, 0] | (gs[:, 1] << 16)  # unit window bases 0..15
            Aac = gs[:, 3] | (gs[:, 4] << 16)
            Bc = gs[:, 2]  # bases 16..23
            Bac = gs[:, 5]
        else:
            SPH = S_
            gs = gstate[cpos // P]  # ONE row gather: [c0 c1 c2 a0 a1 a2]
            # NOTE: variable-amount shifts are kept here: these small-lane
            # stages are op-count-bound, and constant-shift where-selects
            # cost more ops.
            shv = jnp.uint32(2 * S_) * (cpos % P).astype(jnp.uint32)
            W0c = gs[:, 0] | (gs[:, 1] << 16)
            Wac = gs[:, 3] | (gs[:, 4] << 16)
            # shv == 0 guard: a shift by 32 is undefined, but that lane
            # takes the where's other branch, so the garbage is discarded
            Ac = jnp.where(
                shv == 0, W0c, (W0c >> shv) | (gs[:, 2] << (32 - shv))
            )
            Aac = jnp.where(
                shv == 0, Wac, (Wac >> shv) | (gs[:, 5] << (32 - shv))
            )
            Bc = gs[:, 2] >> shv
            Bac = gs[:, 5] >> shv
        nbv = jnp.zeros_like(Ac)
        for d in range(SPH):
            pha = (Aac >> (2 * d)) & m2w
            if 2 * (d + W) > 32:  # W-mer spill past bit 32
                pha = pha | ((Bac << (32 - 2 * d)) & m2w)
            ok_d = (pha == 0) & (cpos * SPH + d < n_scan)
            nbv = nbv | (ok_d.astype(jnp.uint32) << d)
        if cfg.strict and cfg.dirty_bloom:
            # Dirty-span phase filter: a valid (W-clean) phase's W-mer is
            # a real value even when the unit's keyed window is dirty —
            # one bloom gather per (compacted unit, phase) keeps only
            # actual bucket keys (exact occupancy at W <= 12; sound
            # prefix filter above). Garbage W-mers of invalid phases are
            # masked by nbv. SPH * cpos_cap gathers — compacted-lane
            # granularity, armed only for dirty genomes.
            shiftb = 2 * W - cfg.bloom_bits
            wbf = jnp.zeros_like(nbv)
            for d in range(SPH):
                wm = (Ac >> (2 * d)) & m2w
                if 2 * (d + W) > 32:
                    wm = wm | ((Bc << (32 - 2 * d)) & m2w)
                bkd = (wm >> shiftb) if shiftb else wm
                word_d = table.bloom[(bkd >> 5).astype(jnp.int32)]
                okd = _bit_at(word_d, bkd & 31) == 1
                wbf = wbf | (okd.astype(jnp.uint32) << d)
        else:
            wbf = None
        if cfg.exact_group:
            NPS = 5 - (S_.bit_length() - 1)  # log2(32 / S)
            # ptab is build-time FOLDED (top span base(s) dropped — only
            # the last phase's key touches them, so only its bits
            # over-approximate); the table's own trace-time shape says
            # how many span bases survived, making a mismatch impossible
            pf_bits = (int(table.ptab.shape[0]) * 32 // S_).bit_length() - 1
            m2pf = jnp.uint32(((1 << min(pf_bits, 32)) - 1) & 0xFFFFFFFF)

            def ptab_bits(keyc):
                """Phase bits for one stride-group span key (exact for
                all but the last phase; see table.py ptab notes)."""
                kf = keyc & m2pf
                wordc = table.ptab[(kf >> NPS).astype(jnp.int32)]
                return (
                    wordc >> ((kf & ((1 << NPS) - 1)) * jnp.uint32(S_))
                ) & jnp.uint32((1 << S_) - 1)

            if cfg.strict:
                # A compacted UNIT holds P stride-groups (parities); each
                # gets its exact phase-table gather — at compacted-unit
                # granularity these are cheap. Clean span => trust the
                # phase bits; dirty span => keep the validity bits.
                ms = jnp.uint32((1 << S_) - 1)
                nb = jnp.zeros_like(nbv)
                for p2 in range(P):
                    shp = 2 * S_ * p2
                    if shp == 0:
                        Akp, Aakp = Ac, Aac
                    else:
                        Akp = (Ac >> shp) | (Bc << (32 - shp))
                        Aakp = (Aac >> shp) | (Bac << (32 - shp))
                    nbt_p = ptab_bits(Akp & m2kb)
                    vcc_p = (Aakp & m2kb) == 0
                    nbv_p = (nbv >> (S_ * p2)) & ms
                    dirty_p = nbv_p
                    if wbf is not None:  # dirty-span phases: bloom-filter
                        dirty_p = nbv_p & ((wbf >> (S_ * p2)) & ms)
                    sub = jnp.where(vcc_p, nbt_p & nbv_p, dirty_p)
                    nb = nb | (sub << (S_ * p2))
            else:
                keyc = Ac & m2kb
                nbt = ptab_bits(keyc)
                # clean span => every phase ambiguity-free, so nbv holds
                # just the in-bounds bits there and nbt & nbv is "real
                # key, in bounds"; dirty spans (garbage key) keep the
                # validity bits
                vcc = (Aac & m2kb) == 0
                nb = jnp.where(vcc, nbt & nbv, nbv)
        else:
            # W >= 14 strict fallback has no exact phase table; the bloom
            # prefix filter (when armed) prunes dirty-span phases here too
            nb = nbv if wbf is None else (nbv & wbf)
        nb = jnp.where(cvalid, nb, 0)
        if stop == "nb":
            return _stopped(nb)

        # ---- 5a. (unit, phase) -> position expansion -----------------------
        pcnt = jax.lax.population_count(nb).astype(jnp.int32)
        pos_total = jnp.sum(pcnt)
        srcg, gexcl = _rank_invert(pcnt, cfg.pos_cap)
        tq = jax.lax.broadcasted_iota(jnp.int32, (cfg.pos_cap,), 0)
        pos_valid = tq < pos_total
        if stop == "posrank":
            return _stopped(srcg, gexcl)
        # everything the position stage needs from its unit in ONE 4-col
        # row gather: the B
        # registers and their ambiguity bits are <= 16 bits each (spill
        # past the 32-bit A register), and the SPH-bit phase nibble packs
        # into the unit index's high byte (cpos < 2^24 at every tile size)
        g2 = jnp.stack(
            [
                Ac,
                Aac,
                Bc | (Bac << 16),
                cpos.astype(jnp.uint32) | (nb << 24),
            ],
            axis=-1,
        )[srcg]
        Acg, Aacg = g2[:, 0], g2[:, 1]
        Bcg = g2[:, 2] & jnp.uint32(0xFFFF)
        Bacg = g2[:, 2] >> 16
        nbg = g2[:, 3] >> 24
        gposg = (g2[:, 3] & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
        # select the rank-th set bit of the SPH-bit nibble -> phase
        rb = tq - gexcl
        ph = jnp.zeros_like(rb)
        w2 = nbg
        half = SPH >> 1
        while half:
            lowmask = jnp.uint32((1 << half) - 1)
            clow = jax.lax.population_count(w2 & lowmask).astype(jnp.int32)
            go_hi = rb >= clow
            ph = ph + jnp.where(go_hi, half, 0)
            rb = rb - jnp.where(go_hi, clow, 0)
            w2 = jnp.where(go_hi, w2 >> half, w2 & lowmask)
            half >>= 1
        phh = jnp.zeros_like(Acg)
        for d in range(SPH):
            v = (Acg >> (2 * d)) & m2w
            if 2 * (d + W) > 32:
                v = v | ((Bcg << (32 - 2 * d)) & m2w)
            phh = jnp.where(ph == d, v, phh)
        pposx = gposg * SPH + ph  # local scan position of each candidate
        if stop == "posg2":
            return _stopped(phh, pposx)
        if cfg.strict and cfg.t16_bits:
            # ONE hashed gather per expanded position: does the FULL
            # 16-base window starting here match some entry's primer1
            # prefix (key + extension)? Dirty windows (va16 != 0) bypass —
            # their candidates keep the reference's ambiguity semantics
            # through the exact verify. False positives only cost pairs;
            # false negatives are impossible (table._build_strict).
            sh16 = jnp.uint32(2) * ph.astype(jnp.uint32)
            v16 = jnp.where(
                ph == 0, Acg, (Acg >> sh16) | (Bcg << (32 - sh16))
            )
            va16 = jnp.where(
                ph == 0, Aacg, (Aacg >> sh16) | (Bacg << (32 - sh16))
            )
            bk16 = (v16 * jnp.uint32(0x9E3779B1)) >> (32 - cfg.t16_bits)
            t16_tab = table.t16_1 if cfg.strict_n == 1 else table.t16
            w16 = t16_tab[(bk16 >> 5).astype(jnp.int32)]
            keep16 = (((w16 >> (bk16 & 31)) & 1) == 1) | (va16 != 0)
            pos_keep = pos_valid & keep16
        else:
            pos_keep = pos_valid
        if stop == "pos":
            return _stopped(phh, pposx, pos_keep)

        # ---- 5b. (position, slot) -> pair expansion ------------------------
        start, cnt = exact_csr(phh, pos_keep)
        pair_total = jnp.sum(cnt)
        j = jax.lax.broadcasted_iota(jnp.int32, (cfg.cand_cap,), 0)
        srcc, jexcl = _rank_invert(cnt, cfg.cand_cap)
        pair_valid = j < pair_total
        slot = j - jexcl
        sp2 = jnp.stack([start, pposx], axis=-1)[srcc]  # one 2-col row gather
        entry = jnp.clip(sp2[:, 0] + slot, 0, E - 1)
        ppos = sp2[:, 1]
        if stop == "expand":
            return _stopped(entry, ppos)
    else:
        hc = h[cpos]
        pos_total = jnp.int32(0)  # no separate position stage on this path
        start, cnt = exact_csr(hc, cvalid)
        pair_total = jnp.sum(cnt)
        j = jax.lax.broadcasted_iota(jnp.int32, (cfg.cand_cap,), 0)
        srcc, jexcl = _rank_invert(cnt, cfg.cand_cap)
        pair_valid = j < pair_total
        slot = j - jexcl
        entry = jnp.clip(start[srcc] + slot, 0, E - 1)
        ppos = cpos[srcc]  # local scan position of each unit
        if stop == "expand":
            return _stopped(entry, ppos)

    # ---- 6. primer1 verify (reference engine.py:486-515, 599-642 '+') -----
    em = table.emeta[entry]  # one row gather for all per-entry scalars
    hoff = em[:, 0]
    kg = tile_start + ppos - hoff  # global (stream) anchor: plane math
    kl = ppos - hoff + LEAD  # local buffer index of anchor
    l1 = em[:, 1]
    if cfg.stream:
        # Record identity per candidate: record starts are 8-aligned in
        # the stream, so ONE gather into the precomputed block->record map
        # resolves it (a searchsorted over RB rows would pay log2(RB)
        # gathers per lane — the fallback when no map is shipped). Every
        # bound below then runs in RECORD-local coordinates — windows
        # reaching into a gap or the next record are structurally masked,
        # so gap bytes never matter.
        RB = rmeta.shape[0]
        gpos = tile_start + ppos
        if recmap is not None:
            blk = jnp.clip(gpos >> 3, 0, recmap.shape[0] - 1)
            rid = jnp.clip(recmap[blk], 0, RB - 1)
        else:
            rid = jnp.clip(
                jnp.searchsorted(rmeta[:, 0], gpos, side="right") - 1,
                0, RB - 1,
            )
        rrow = rmeta[rid]  # one 2-col row gather: (start, len)
        kg_rec = kg - rrow[:, 0]
        rlen_c = rrow[:, 1]
    else:
        rid = jnp.zeros_like(kg)
        kg_rec = kg
        rlen_c = jnp.broadcast_to(record_len, kg.shape)
    inb = (kg_rec >= 0) & (kg_rec + l1 <= rlen_c)  # engine.py:487

    ii = jax.lax.broadcasted_iota(jnp.int32, (cfg.cand_cap, cfg.p1_max), 1)
    if cfg.packed and TB % 32 == 0:
        # Row-gather verify: fetch the whole window as NR 16-byte rows,
        # then byte barrel-shift + nibble
        # interleave in lanes — replaces n_out per-element gathers.
        sb = _row_window(tile_bytes, TB, kl, cfg.p1_max)
    else:
        sb = plane_at(kl[:, None] + ii)
    if cfg.packed:
        if cfg.iupac:  # expansion-set intersection, all-arithmetic
            m1 = (_exp_nib_select(sb) & table.p1_exp[entry]) != 0
        else:  # genome nibble == primer code (codes >= 16 never match)
            pb = table.p1_codes[entry].astype(jnp.int32)
            m1 = sb == pb
    else:
        pb = table.p1_bytes[entry].astype(jnp.int32)
        if cfg.iupac:
            m1 = table.match[sb * 256 + pb] != 0
        else:  # non-IUPAC match is exactly case-insensitive equality
            m1 = _byte_fold(sb) == _byte_fold(pb)
    act1 = ii < l1[:, None]
    mm1 = act1 & ~m1
    prot1 = ii >= (l1[:, None] - X)  # '+' strand: last X bases (engine.py:609)
    p1_ok = (
        pair_valid
        & inb
        & ~jnp.any(mm1 & prot1, axis=1)
        & (jnp.sum(mm1, axis=1) <= NMM)
    )
    if stop == "p1":
        return _stopped(p1_ok)

    # ---- compact anchors ---------------------------------------------------
    anch_total = jnp.sum(p1_ok.astype(jnp.int32))

    def _margin_stage():
        """Anchor compaction + margin-window primer2 verify + emission.

        Runs only when the tile has >= 1 real anchor (lax.cond below):
        in random-STS workloads virtually no candidate survives the full
        primer1 verify, so nearly every tile skips all O(anch_cap) work
        here at runtime."""
        (a_idx,) = jnp.nonzero(p1_ok, size=cfg.anch_cap, fill_value=0)
        alane = jax.lax.broadcasted_iota(jnp.int32, (cfg.anch_cap,), 0)
        avalid = alane < anch_total

        ak = kg[a_idx]  # global/plane anchor (window gather math)
        ak_rec = kg_rec[a_idx]  # record-local anchor (bounds + output)
        arl = rlen_c[a_idx]  # record length per anchor
        arec = rid[a_idx]
        aentry = entry[a_idx]
        al1 = l1[a_idx]
        aem = table.emeta[aentry]
        al2 = aem[:, 2]
        aorder = a_idx  # pair index == within-tile emission major key

        # ---- 7. margin-window primer2 verify (engine.py:517-593) ----------
        # All clamps in RECORD-local coordinates (reference semantics).
        exp0 = aem[:, 3]
        avail = arl - (ak_rec + al1)
        room = avail >= al2  # engine.py:524-525
        actual = arl - ak_rec  # engine.py:528
        clamped = exp0 > actual
        exp = jnp.where(clamped, actual, exp0)  # engine.py:531-535
        hi = jnp.where(clamped, 0, jnp.minimum(Mdyn, arl - ak_rec - exp))
        lo = jnp.clip(jnp.minimum(Mdyn, exp - al1 - al2), 0)  # engine.py:538-540

        # rank r -> window offset d: r=0 -> 0; odd -> -(r+1)//2; even -> r//2
        # (expected first, then -1, +1, -2, +2, … — engine.py:543-593)
        ranks = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
        dmag = (ranks + 1) // 2
        d = jnp.where(ranks % 2 == 1, -dmag, dmag)  # int32[R]

        span = 2 * M + cfg.p2_max
        wbase_l = (ak + exp - al2 - M) - tile_start + LEAD

        # ---- anchor-CHUNKED window verify ---------------------------------
        # The window work is O(anchors x R x p2_max) but real anchor
        # counts are tiny (a few per tile) while anch_cap is provisioned
        # for bursts, so anchors run through lax.map in chunks of AC with
        # a cond that skips chunks past anch_total — the verify cost
        # tracks the ACTUAL anchor count. Nothing [anch_cap, R]-shaped is
        # ever materialized (at -M 10000 that would be ~5M lanes; p2 is
        # recomputed arithmetically at emission instead).
        # Anchor chunk size: 32 at floor caps (hit-free tiles skip all
        # chunks; small fixed cost), but GROWN with escalated anch_cap —
        # an anchor-flood tile (tens of thousands of real anchors) at
        # AC=32 would pay thousands of sequential lax.map iterations.
        # Bounded by an ~8M-lane per-chunk memory model so large margins
        # (R up to 20001, rank-chunked at RC=8192) stay in budget.
        # Rank lanes ACTUALLY materialized per chunk: the static-slice
        # path (R <= 257) allocates [AC, R, P2MAX]; the rank-chunked path
        # pads to [AC, RC, P2MAX] with RC a pow2 >= R capped at 8192 —
        # the budget below must divide by that padded width, not R, or
        # 257 < R < 8192 would overshoot the budget by up to ~32x.
        if R <= 257:
            r_lanes = R
            RC = 0  # unused on the static-slice path
        else:
            RC = min(8192, 1 << (R - 1).bit_length())
            r_lanes = RC
        if cfg.anch_cap % 32:
            AC = cfg.anch_cap
        else:
            # ~8M-lane per-chunk budget: [AC, r_lanes, p2_max] int32 is
            # <= 32 MB. Floor-cap configs still get AC=32 via the
            # anch_cap//128 term.
            mem_lanes = (1 << 23) // max(r_lanes * cfg.p2_max, 1)
            ac = min(4096, max(32, cfg.anch_cap // 128), max(32, mem_lanes))
            AC = 1 << (ac.bit_length() - 1)  # pow2 => divides anch_cap
        n_ac = cfg.anch_cap // AC
        # A chunk emits at most AC*R hits, so its hloc buffer never needs
        # more lanes than that — keeps the [n_ac, hl_cap] stack bounded
        # when hit_cap escalates far past per-chunk reality.
        hl_cap = min(cfg.hit_cap, AC * R)

        def _p2_ok_of(sb2, aentry_c, al2_c):
            """primer2 match mask over an [AC, r, P2MAX] window stack ->
            [AC, r] (mismatch budget + head-X 3' protection,
            engine.py:599-642 '-' strand)."""
            i2c = jax.lax.broadcasted_iota(jnp.int32, sb2.shape, 2)
            if cfg.packed:
                if cfg.iupac:  # expansion-set intersection, all-arithmetic
                    m2 = (
                        _exp_nib_select(sb2)
                        & table.p2_exp[aentry_c][:, None, :]
                    ) != 0
                else:
                    pb2 = table.p2_codes[aentry_c].astype(jnp.int32)
                    m2 = sb2 == pb2[:, None, :]
            else:
                pb2 = table.p2_bytes[aentry_c].astype(jnp.int32)
                if cfg.iupac:
                    m2 = table.match[sb2 * 256 + pb2[:, None, :]] != 0
                else:
                    m2 = _byte_fold(sb2) == _byte_fold(pb2)[:, None, :]
            act2 = i2c < al2_c[:, None, None]
            mm2 = act2 & ~m2
            prot2 = i2c < X  # '-': first X bases (engine.py:610-611)
            return ~jnp.any(mm2 & prot2, axis=2) & (
                jnp.sum(mm2, axis=2) <= NMM
            )

        def _chunk_hits(ci):
            """(hit count, chunk-local flat hit indices) for anchors
            [ci*AC, ci*AC + AC)."""

            def _live():
                def sl(x):
                    return jax.lax.dynamic_slice_in_dim(x, ci * AC, AC, 0)

                aentry_c = sl(aentry)
                al1_c, al2_c = sl(al1), sl(al2)
                akr_c, arl_c = sl(ak_rec), sl(arl)
                exp_c, hi_c, lo_c = sl(exp), sl(hi), sl(lo)
                wbase_c = sl(wbase_l)
                NRw = -(-(15 + span // 2 + 1) // 16)
                if cfg.packed and TB % 32 == 0 and TB >= 32 * NRw:
                    # AC * NRw row gathers instead of AC * span
                    # element gathers (default_config sizes the
                    # halos so every real anchor's window stays in-plane)
                    wb = _row_window(tile_bytes, TB, wbase_c, span)
                else:
                    jjj = jax.lax.broadcasted_iota(jnp.int32, (AC, span), 1)
                    wb = plane_at(wbase_c[:, None] + jjj)  # [AC, span]

                if R <= 257:
                    # rank offsets are compile-time constants, so each
                    # rank's window is a contiguous STATIC slice of wb
                    # (vector loads). Only worth it while R stays small
                    # (compile time scales with R).
                    sb2 = jnp.stack(
                        [
                            jax.lax.slice_in_dim(
                                wb,
                                M + _rank_d(r),
                                M + _rank_d(r) + cfg.p2_max,
                                axis=1,
                            )
                            for r in range(R)
                        ],
                        axis=1,
                    )  # [AC, R, P2MAX]
                    p2_ok = _p2_ok_of(sb2, aentry_c, al2_c)
                else:
                    # Large margins: the rank axis runs in CHUNKS of RC
                    # through ONE nested lax.map body — peak intermediate
                    # is [AC, RC, P2MAX] and compile time is chunk-count-
                    # independent. Offsets are a static host-side table.
                    # RC (set with AC above) is a pow2 >= R capped at
                    # 8192 — at -M 10000 that is [AC, 8192, P2MAX], the
                    # 8M-lane budget; fewer chunks keep the lax.map
                    # iteration count low.
                    n_ck = -(-R // RC)
                    offs = np.zeros((n_ck, RC), dtype=np.int32)
                    for r in range(n_ck * RC):
                        # pad ranks past R reuse offset 0 (in-bounds;
                        # masked by rmask/struct: rank >= R never emits)
                        offs[r // RC, r % RC] = M + (
                            _rank_d(r) if r < R else 0
                        )
                    offs_d = jnp.asarray(offs)
                    i2w = jax.lax.broadcasted_iota(
                        jnp.int32, (RC, cfg.p2_max), 1
                    )

                    def _rchunk(ck):
                        o = offs_d[ck]  # int32[RC]
                        sb2c = wb[:, o[:, None] + i2w]  # [AC, RC, P2MAX]
                        return _p2_ok_of(sb2c, aentry_c, al2_c)

                    p2_ok = (
                        jax.lax.map(
                            _rchunk, jnp.arange(n_ck, dtype=jnp.int32)
                        )
                        .transpose(1, 0, 2)
                        .reshape(AC, n_ck * RC)[:, :R]
                    )

                p2c = (
                    akr_c[:, None] + exp_c[:, None] - al2_c[:, None]
                    + d[None, :]
                )
                struct = p2c + al2_c[:, None] <= arl_c[:, None]
                # k + len_p1 <= p2 is checked for d <= 0 only
                # (engine.py:546, 568; the hi loop at :581-583 omits it)
                struct &= jnp.where(
                    d[None, :] <= 0,
                    p2c >= akr_c[:, None] + al1_c[:, None],
                    True,
                )
                rmask = jnp.where(
                    d[None, :] == 0,
                    True,
                    jnp.where(
                        d[None, :] < 0,
                        dmag[None, :] <= lo_c[:, None],
                        dmag[None, :] <= hi_c[:, None],
                    ),
                )
                hm = (
                    sl(avalid)[:, None]
                    & sl(room)[:, None]
                    & rmask
                    & struct
                    & p2_ok
                )
                flat = hm.reshape(-1)  # anchor-major, rank-minor
                (hloc,) = jnp.nonzero(flat, size=hl_cap, fill_value=0)
                return (
                    jnp.sum(flat.astype(jnp.int32)),
                    hloc.astype(jnp.int32),
                )

            return jax.lax.cond(
                ci * AC < anch_total,
                _live,
                lambda: (
                    jnp.int32(0),
                    jnp.zeros((hl_cap,), jnp.int32),
                ),
            )

        hc, hloc = jax.lax.map(
            _chunk_hits, jnp.arange(n_ac, dtype=jnp.int32)
        )  # [n_ac], [n_ac, hit_cap]
        hit_total = jnp.sum(hc)

        # ---- hit emission --------------------------------------------------
        # Global slot q belongs to chunk srcc2 with excl <= q < excl+hc;
        # chunk-ascending + within-chunk flat-ascending == the (anchor,
        # rank) emission order. Chunks with hc > hl_cap truncate their
        # hloc, but that needs hc > hit_cap, so hit_total > hit_cap too
        # and the host discards the tile and escalates — truncation is
        # never silent.
        q = jax.lax.broadcasted_iota(jnp.int32, (cfg.hit_cap,), 0)
        srcc2, hexcl = _rank_invert(hc, cfg.hit_cap)
        slotc = jnp.clip(q - hexcl, 0, hl_cap - 1)
        hidx = hloc[srcc2, slotc]  # chunk-local flat index
        a_of = srcc2 * AC + hidx // R
        r_of = hidx % R
        dmag_of = (r_of + 1) // 2
        d_of = jnp.where(r_of % 2 == 1, -dmag_of, dmag_of)
        hp2 = ak_rec[a_of] + exp[a_of] - al2[a_of] + d_of
        return (
            hit_total,
            ak_rec[a_of],
            hp2 + al2[a_of] - 1,
            aentry[a_of],
            aorder[a_of],
            r_of,
            arec[a_of],
        )

    def _no_anchors():
        zh = jnp.zeros((cfg.hit_cap,), jnp.int32)
        return jnp.int32(0), zh, zh, zh, zh, zh, zh

    hit_total, pos1, pos2, entry_o, pair_order, rank, rec = jax.lax.cond(
        anch_total > 0, _margin_stage, _no_anchors
    )
    return ScanOut(
        c_total=c_total,
        pos_total=pos_total,
        pair_total=pair_total,
        anch_total=anch_total,
        hit_total=hit_total,
        pos1=pos1,
        pos2=pos2,
        entry=entry_o,
        pair_order=pair_order,
        rank=rank,
        rec=rec,
    )


@lru_cache(maxsize=64)
def get_scan_fn(cfg: ScanConfig):
    """One compiled tile-scan function per static config."""

    def f(table, tile_bytes, tile_start, n_scan, record_len, rt):
        return _scan_tile(
            cfg, table, tile_bytes, tile_start, n_scan, record_len, rt
        )

    return jax.jit(f)


@lru_cache(maxsize=64)
def get_record_scan_fn(cfg: ScanConfig, n_tiles: int):
    """Whole-record scan: ONE device call runs all tiles via lax.map over
    device-side dynamic slices of the halo-padded record buffer.

    This is the host/device split that matters on real hardware: shipping
    one record buffer and fetching one stacked result amortizes transfer +
    dispatch latency over all tiles instead of paying a host round trip
    per tile.

    padded layout: [lead zeros][record bytes][tail zeros / next bucket pad],
    total length lead + n_tiles*tile_len + tail. Tile t's buffer is the
    slice [t*L, t*L + tile_buf); padding tiles see n_scan <= 0 and emit
    nothing.
    """

    stride = cfg.tile_len // 2 if cfg.packed else cfg.tile_len

    def f(table, padded, start0, total_scan, record_len, rt):
        def body(t):
            tb = jax.lax.dynamic_slice(padded, (t * stride,), (cfg.tile_buf_in,))
            gstart = start0 + t * cfg.tile_len
            n_scan = jnp.clip(total_scan - gstart, 0, cfg.tile_len)
            return _scan_tile(cfg, table, tb, gstart, n_scan, record_len, rt)

        # sequential map rather than vmap: the L-wide hash / bloom stages
        # batch poorly and the backend stages are already small
        return jax.lax.map(body, jnp.arange(n_tiles, dtype=jnp.int32))

    return jax.jit(f)


@lru_cache(maxsize=64)
def get_stream_scan_fn(cfg: ScanConfig, n_tiles: int):
    """Stream scan: ONE device call runs n_tiles tiles of a CONCATENATED
    multi-record plane (records separated by dirty-nibble gaps; per-hit
    record identity recovered on-device via rmeta — see ScanConfig.stream).

    This replaces per-record dispatch for scaffold-heavy FASTA: all
    per-tile and per-dispatch fixed costs amortize over ~2M positions per
    tile regardless of record sizes. cfg must have stream=True."""

    stride = cfg.tile_len // 2 if cfg.packed else cfg.tile_len

    def f(table, padded, start0, total_scan, stream_len, rmeta, recmap, rt):
        def body(t):
            tb = jax.lax.dynamic_slice(
                padded, (t * stride,), (cfg.tile_buf_in,)
            )
            gstart = start0 + t * cfg.tile_len
            n_scan = jnp.clip(total_scan - gstart, 0, cfg.tile_len)
            return _scan_tile(
                cfg, table, tb, gstart, n_scan, stream_len, rt,
                rmeta=rmeta, recmap=recmap,
            )

        return jax.lax.map(body, jnp.arange(n_tiles, dtype=jnp.int32))

    return jax.jit(f)




def margin_cap(margin: int) -> int:
    """Shape cap for a runtime margin: next multiple of 64, so nearby
    margins (e.g. a 50..100 sweep) share one compiled program."""
    return max(64, -(-margin // 64) * 64)


def default_config(
    wordsize: int,
    margin: int,
    mismatches: int,
    three_prime_match: int,
    lead: int,
    max_pcr_size: int,
    p1_max: int,
    p2_max: int,
    bloom_bits: int,
    tile_len: int = 1 << 19,
    n_entries: int = 0,
    iupac: bool = False,
    packed: bool = True,
    stride: int = 2,
    qbloom_bits: int = 22,
    exact_group: bool = False,
    n_unique: int = 0,
    strict: bool = False,
    strict_n: int = 0,
    t16_bits: int = 0,
    stream: bool = False,
    q_density: float = -1.0,
    sq_density: float = 1.0,
    sp_density: float = 1.0,
    t16_real: float = 0.0,
    t16_fp: float = 1.0,
    dirty_rate: float = 0.0,
    dirty_pos_rate: float = 0.0,
    gaps_per_tile: float = 0.0,
) -> ScanConfig:
    """Capacity heuristics.

    The verify stages cost ~O(cap), so capacities are sized from the
    expected table hit density (E entries spread over 4^W buckets => about
    L*E/4^W candidate positions per tile) with generous headroom; the rare
    tile that still overflows is retried with escalated capacities, so
    undersizing costs a retry, never correctness.

    ``dirty_rate`` is the genome's measured UNIT bypass rate (keyed
    bases dirty AND some phase's W-mer clean — the exact flag condition;
    positions fully inside an N-run have no valid phase and cost
    nothing) and ``dirty_pos_rate`` the dirty-in-16-clean-in-11 POSITION
    rate (phases that expand through the exact CSR with no table
    filter). Both are measured with the scan's window structure, never
    derived from the base rate — derivations are wrong by an order of
    magnitude for run-clustered dirt. Without these terms a
    1%-scattered-IUPAC genome rescans every tile; with a naive
    derivation an N-run genome compiles monster programs.

    ``gaps_per_tile`` is the stream path's expected inter-record gap
    count per tile. Gaps are CLUSTERED dirt — running them through the
    scattered dirty_rate model overestimates ~5x and measurably slows
    the scaffold scan through oversized pos machinery. The per-gap
    coefficients are MEASURED on the 3000-scaffold bench workload
    (tools/exp_gap_totals.py): ~1.1 flagged units and ~2.1 expanded
    positions per gap; 1.5/2.5 below carry ~35% headroom on top of the
    pow2 gap-count quantization (+27%) and the 1.5x sizing multiplier —
    the old 3/10 estimates pushed pos_cap to ~4x reality, which both
    forced G=1 dispatch and paid oversized pos-stage lanes every tile.
    """
    # The margin is a RUNTIME value; shapes use the bucketed cap so nearby
    # margins share one compiled program AND one buffer geometry (device
    # plane caches stay warm across parameter sweeps).
    # lead rounded to 32 positions = 16 packed bytes, so the tile buffer
    # reshapes exactly into the verify stage's 16-byte rows.
    mcap = margin_cap(margin)
    # The halos cover every ACTIVE primer read PLUS the full row-gathered
    # margin window: the verify stage fetches all 2*mcap + p2_max window
    # positions as aligned 16-byte rows whose whole extent must stay
    # inside the plane (see _row_window). The window's low edge starts
    # mcap + len_p2 before the anchor (which itself sits up to the max
    # hash offset before a scan position -> the `lead` argument), so the
    # left halo needs lead + mcap + p2_max; the right needs
    # max_pcr_size + 2*mcap + p2_max past the last scan position.
    lead = -(-(lead + mcap + p2_max) // 32) * 32
    tail = -(-(max_pcr_size + 2 * mcap + p2_max + 64) // 256) * 256
    # Candidate-unit expectation. Real bucket hits ~ L*E/4^W; pair mode adds
    # ~4 predecessor bits/key of false positives over L/2 pairs. Escalation
    # recompiles are far more expensive than slack capacity, so size with
    # ~1.6x headroom over the estimate.
    E = max(n_entries, 1)
    E1 = max(n_unique, 1)
    p_real = E / float(4**wordsize)
    # the occupancy bitmask is exact when it covers all 2W hash bits;
    # truncation false positives only exist for W > bloom_bits/2
    trunc_fp = E / float(1 << bloom_bits) if bloom_bits < 2 * wordsize else 0.0
    strict = strict and packed  # strict front end exists only packed
    d = min(max(dirty_rate, 0.0), 1.0)  # unit bypass rate (measured)
    if packed:
        # unit/group flagged if any of its phases is a real bucket key,
        # plus (mult-hash fallback only) bloom false positives, PLUS
        # dirty-keyed spans (which bypass the table — semantics); the
        # exact direct-mapped tables have no false positives. Strict mode
        # uses the MEASURED set-bit density of the unit-projection table,
        # whose flags cover whole u32 units (8 positions per lookup).
        if strict:
            p_unit = sq_density + d
            units = tile_len // 8
        else:
            if exact_group:
                # measured set-bit fraction when available (accounts for
                # truncation false flags); model estimate otherwise
                p_unit = (
                    q_density if q_density >= 0 else min(1.0, stride * p_real)
                ) + d
            else:
                fp_q = min(
                    1.0,
                    stride * 4 ** (stride - 1) * E1 / float(1 << qbloom_bits),
                )
                p_unit = fp_q + min(1.0, stride * p_real) + d
            units = tile_len // stride
    else:
        p_unit = p_real + trunc_fp + d
        units = tile_len
    expect_units = int(units * min(p_unit, 1.0) + 1.5 * gaps_per_tile)
    # position expectation (packed expand stage): with the exact phase
    # table a position expands iff its W-mer is a real bucket key (strict:
    # AND its extension bases are consistent), so the count tracks the
    # phase-table density; the fallback expands every valid phase of a
    # flagged group
    # dirty-keyed spans with a CLEAN W-mer window expand their phases
    # through the exact CSR (no table filter) — unless the dirty_bloom
    # phase filter is armed, which prunes them to actual bucket keys at
    # the nb stage (rate ~ SPH * E1 / 2^bloom_bits + the real-key rate,
    # which sp_density already covers)
    dirty_pos = min(max(dirty_pos_rate, 0.0), 1.0) if packed else 0.0
    dirty_bloom = bool(strict and dirty_pos >= 1.0 / 256)
    if dirty_bloom:
        dirty_pos = min(
            dirty_pos, 8.0 * E1 / float(1 << min(2 * wordsize, 24))
        )
    if packed and strict:
        # Positions only expand inside strict-FLAGGED units (the expand
        # stage masks nb by the compacted strict flags), so the realistic
        # expectation is flagged-unit count x loose phase bits per
        # flagged unit (>= 1 by construction, + background over the 8
        # phases) — far tighter than the raw loose-phase bound on dense
        # sets, and the pos stage costs O(pos_cap) lanes regardless of
        # actual counts. The loose bound stays as an upper clamp;
        # undersizing only costs an escalation retry, never correctness.
        per_group = 1.0 + 8 * min(1.0, sp_density)
        expect_pos = int(
            tile_len
            * min(sp_density + dirty_pos,
                  (sq_density / 8) * per_group + dirty_pos, 1.0)
        )
    elif packed and exact_group:
        # the folded phase table's LAST phase over-approximates 4x (its
        # key lost the top span base at build), so the real-key phase
        # rate is (stride-1+4)/stride x the exact-key rate
        fold = (stride + 3.0) / stride
        expect_pos = int(
            tile_len
            * min(1.0, fold * E1 / float(4**wordsize) + dirty_pos)
        )
    else:
        expect_pos = stride * expect_units if packed else expect_units
    expect_pos = int(expect_pos + 2.5 * gaps_per_tile)
    # E[sum of bucket counts] over the tile is exactly L * E / 4^W; in
    # strict mode only t16-passing positions (real 16-base matches + hash
    # false positives among expanded positions) reach pair expansion
    avg_bucket = E / float(E1)
    if strict and t16_bits:
        expect_cands = int(
            tile_len * min(1.0, t16_real + sp_density * t16_fp) * avg_bucket
        )
    elif strict:
        expect_cands = int(tile_len * min(1.0, sp_density) * avg_bucket)
    else:
        expect_cands = int(tile_len * (p_real + trunc_fp))
    # Capacity floors stay at 1024/2048 even for small tiles: the
    # compact/expand stages' fixed cost is not lane-bound at these sizes.
    # Caps round UP to multiples of 128 — a layout rule from the previous
    # accelerator that only changes shapes here (ROADMAP C2 re-derives
    # both on the GPU).
    def _al(x):
        return -(-x // 128) * 128

    cpos_cap = min(_al(max(1024, int(1.5 * expect_units) + 256)), units)
    pos_cap = min(_al(max(1024, int(1.5 * expect_pos) + 256)), tile_len)
    cand_cap = min(
        _al(max(2048, int(1.3 * expect_cands) + 512)), 4 * tile_len
    )
    return ScanConfig(
        wordsize=wordsize,
        margin=mcap,
        iupac=iupac,
        packed=packed,
        stride=stride,
        qbloom_bits=qbloom_bits,
        exact_group=exact_group,
        strict=strict,
        strict_n=strict_n if strict else 0,
        t16_bits=t16_bits,
        dirty_bloom=dirty_bloom,
        stream=stream,
        tile_len=tile_len,
        lead=lead,
        tail=tail,
        p1_max=p1_max,
        p2_max=p2_max,
        bloom_bits=bloom_bits,
        cpos_cap=cpos_cap,
        pos_cap=pos_cap,
        cand_cap=cand_cap,
        # Anchors/hits come from REAL primer matches, which the random-
        # density model above cannot predict. 256/tile = one anchor per
        # 8 kb — 5-10x real STS density (human: ~1 per 30-50 kb). The
        # anchor stage costs O(anch_cap) even with zero anchors, so this
        # balances headroom against the zero-hit scan rate; the rare
        # denser tile escalates (engine._rescan_tile, one extra dispatch).
        anch_cap=256,
        hit_cap=256,
    )
