"""Host (NumPy) scan fast path for SMALL inputs.

A one-shot CLI run on a small genome pays far more for the jax runtime
(import and program trace — the persistent XLA cache cannot skip
tracing) than for the scan itself. This module is a pure-NumPy
implementation of the identical match semantics — same LSB-first W-mer
keys and CSR as the device table, same 256x256 match matrix (so IUPAC and
case folding CANNOT diverge), same margin clamps and emission-rank order
as ``ops.scan`` (reference engine.py:453-642) — used by the engine when
the total workload is tiny and no mesh is attached. jax is never imported
on this path.

Correctness containment: the row schema and ordering keys are exactly
those of the device pipeline, the same emitter consumes them, and the
differential fuzzer runs every case through BOTH paths against the
reference oracle (tools/difffuzz.py). Dense floods (candidates or
anchor-window work past a cap) return None — the engine falls back to
the device path, which owns all heavy machinery.
"""

from __future__ import annotations

import numpy as np

from .encoding import AMBIG, SCODE

# Escape hatches: past these, the device path is both faster and the
# better-tested flood machinery (measured-total escalation etc.).
MAX_CANDIDATES = 20_000
MAX_WINDOW_WORK = 400_000  # anchors x (2*margin + 1)


def host_scan_record(
    table,  # DeviceTable NamedTuple holding HOST numpy arrays
    meta,
    seq_bytes: np.ndarray,  # uint8[n], raw record bytes
    margin: int,
    mismatches: int,
    three_prime: int,
    capped: bool = True,
) -> np.ndarray | None:
    """Scan one record on the host; returns int64[(n_hits, 6)] rows
    (pos1, pos2, entry, tile=0, pair_order, rank) in the device
    pipeline's schema, or None when the workload exceeds the small-input
    caps (caller falls back to the device path). ``capped=False`` lifts
    the caps: the scan then always completes, however long it takes —
    the plain reference that device results are checked against."""
    W = meta.wordsize
    n = len(seq_bytes)
    empty = np.zeros((0, 6), dtype=np.int64)
    if n <= W or meta.n_entries == 0:
        return empty
    total = n - W + 1

    code = SCODE[seq_bytes]
    amb = code == AMBIG
    c2 = np.where(amb, 0, code).astype(np.uint64)
    # LSB-first W-mer value per scan position (base i at bits [2i, 2i+2))
    # — the device table's bucket-key convention (table._lsb_keys)
    h = np.zeros(total, dtype=np.uint64)
    bad = np.zeros(total, dtype=bool)
    for i in range(W):
        h |= c2[i : i + total] << np.uint64(2 * i)
        bad |= amb[i : i + total]

    uh = np.asarray(table.uhash).astype(np.uint64)
    ustart = np.asarray(table.ustart)
    idx = np.searchsorted(uh, h)
    idxc = np.minimum(idx, len(uh) - 1)
    found = (~bad) & (idx < len(uh)) & (uh[idxc] == h)
    pos = np.nonzero(found)[0]
    if not len(pos):
        return empty
    starts = ustart[idx[pos]]
    counts = ustart[idx[pos] + 1] - starts
    if capped and int(counts.sum()) > MAX_CANDIDATES:
        return None

    M = np.asarray(table.match).reshape(256, 256)
    emeta = np.asarray(table.emeta)
    p1b = np.asarray(table.p1_bytes)
    p2b = np.asarray(table.p2_bytes)
    Mdyn, NMM, X = int(margin), int(mismatches), int(three_prime)
    R = 2 * Mdyn + 1

    rows = []
    pair_order = 0
    window_work = 0
    for p, s0, c in zip(pos.tolist(), starts.tolist(), counts.tolist()):
        for e in range(s0, s0 + c):
            order = pair_order
            pair_order += 1
            hoff, l1, l2, exp0 = (int(v) for v in emeta[e, :4])
            k = p - hoff
            if k < 0 or k + l1 > n:  # reference engine.py:487
                continue
            mm = M[seq_bytes[k : k + l1], p1b[e, :l1]] == 0
            if X > 0 and mm[max(l1 - X, 0) :].any():  # '+': last X bases
                continue
            if int(mm.sum()) > NMM:
                continue
            # margin window (reference engine.py:517-593 clamps, in the
            # same form the device stage uses)
            if n - (k + l1) < l2:  # room
                continue
            actual = n - k
            clamped = exp0 > actual
            exp = actual if clamped else exp0
            hi = 0 if clamped else min(Mdyn, n - k - exp)
            lo = max(0, min(Mdyn, exp - l1 - l2))
            window_work += R
            if capped and window_work > MAX_WINDOW_WORK:
                return None
            pb2 = p2b[e, :l2]
            for r in range(R):
                dmag = (r + 1) // 2
                d = -dmag if r % 2 == 1 else r // 2
                if d < 0 and dmag > lo:
                    continue
                if d > 0 and dmag > hi:
                    continue
                p2 = k + exp - l2 + d
                if p2 + l2 > n:
                    continue
                # k + len_p1 <= p2 is checked for d <= 0 only
                # (engine.py:546,568; the hi loop omits it)
                if d <= 0 and p2 < k + l1:
                    continue
                mm2 = M[seq_bytes[p2 : p2 + l2], pb2] == 0
                if X > 0 and mm2[:X].any():  # '-': first X bases
                    continue
                if int(mm2.sum()) > NMM:
                    continue
                rows.append((k, p2 + l2 - 1, e, 0, order, r))
    if not rows:
        return empty
    return np.asarray(rows, dtype=np.int64)
