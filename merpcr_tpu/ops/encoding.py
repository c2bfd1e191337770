"""Byte-level encoding tables, built once as NumPy arrays.

The reference engine works character-by-character with Python dicts/lists
(engine.py:99-191, utils.py:11-40). Here every rule is compiled into a flat
byte LUT so that both the host loaders (vectorized NumPy) and the device
kernels (gathers) consume the exact same semantics:

* ``SCODE``      — base byte -> 2-bit code, A=0 C=1 G=2 T=3, U->T, both cases,
                   everything else AMBIG=100       (reference engine.py:102-109)
* ``COMPL``      — base byte -> complement byte, IUPAC-aware, case-preserving,
                   unknown -> 'N'                  (reference engine.py:112-135, 357-359)
* ``match_matrix(iupac)`` — 256x256 uint8 match table with the reference's
                   ``_compare_seqs`` per-position semantics
                                                    (reference engine.py:614-631)
* ``FASTA_KEEP`` — bytes kept by the FASTA sequence filter
                   (upper in "ACGTBDHKMNRSVWXY")    (reference fasta.py:60)
* ``IUPAC_MAPPING`` — expansion strings             (reference engine.py:138-172)

Text <-> bytes uses latin-1 so every byte value 0..255 round-trips; real
inputs are ASCII.
"""

from __future__ import annotations

import numpy as np

AMBIG = 100  # reference engine.py:18

# ---------------------------------------------------------------------------
# 2-bit base codes (reference engine.py:102-109)
# ---------------------------------------------------------------------------
SCODE = np.full(256, AMBIG, dtype=np.int32)
for _b, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    SCODE[ord(_b)] = SCODE[ord(_b.lower())] = _c

# ---------------------------------------------------------------------------
# Complement byte map (reference engine.py:112-135). Unknown bases map to 'N'
# (reference engine.py:357-359 uses compl.get(base, "N") — note the fallback
# is uppercase 'N' regardless of input case).
# ---------------------------------------------------------------------------
_COMPL_PAIRS = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "B": "V", "D": "H", "H": "D", "K": "M", "M": "K",
    "N": "N", "R": "Y", "S": "S", "V": "B", "W": "W",
    "X": "X", "Y": "R",
}
COMPL = np.full(256, ord("N"), dtype=np.uint8)
for _k, _v in _COMPL_PAIRS.items():
    COMPL[ord(_k)] = ord(_v)
    COMPL[ord(_k.lower())] = ord(_v.lower())

# ---------------------------------------------------------------------------
# IUPAC expansion map (reference engine.py:138-172). Lowercase keys map to the
# same (uppercase) expansion strings.
# ---------------------------------------------------------------------------
IUPAC_MAPPING = {
    "A": "A", "C": "C", "G": "G", "T": "TU", "U": "TU",
    "R": "AGR", "Y": "CTUY", "M": "ACM", "K": "GTUK", "S": "CGS",
    "W": "ATUW", "B": "CGTUYKSB", "D": "AGTURKWD", "H": "ACTUYMWH",
    "V": "ACGRMSV", "N": "ACGTURYMKSWBDHVN",
}
for _k in list(IUPAC_MAPPING):
    IUPAC_MAPPING[_k.lower()] = IUPAC_MAPPING[_k]

# ---------------------------------------------------------------------------
# FASTA sequence-character filter (reference fasta.py:60): keep c iff
# c.upper() in "ACGTBDHKMNRSVWXY", original case preserved.
# ---------------------------------------------------------------------------
FASTA_KEEP = np.zeros(256, dtype=bool)
for _c in "ACGTBDHKMNRSVWXY":
    FASTA_KEEP[ord(_c)] = FASTA_KEEP[ord(_c.lower())] = True

# Bytes considered ambiguous for hashing purposes == SCODE[b] == AMBIG on the
# sequence alphabet; the reference's explicit set (engine.py:189-191) is only
# used for bookkeeping, hashing relies on scode (engine.py:345-347, 472-478).

_UPPER = np.arange(256, dtype=np.uint8)
_lower = (_UPPER >= ord("a")) & (_UPPER <= ord("z"))
_UPPER = np.where(_lower, _UPPER - 32, _UPPER)


def _byte_upper(b: int) -> int:
    return b - 32 if ord("a") <= b <= ord("z") else b


def match_matrix(iupac_mode: bool) -> np.ndarray:
    """256x256 uint8 table: M[s, p] == 1 iff sequence byte s matches primer
    byte p under the reference's per-position rule (engine.py:607-631).

    Non-IUPAC: case-insensitive byte equality (engine.py:631).
    IUPAC: if both uppercased chars are IUPAC codes, match iff their
    expansion sets intersect; otherwise case-insensitive equality
    (engine.py:614-629). Note 'X' is NOT an IUPAC code in the reference's
    mapping, so in IUPAC mode 'X' only matches 'X'.
    """
    up = _UPPER.astype(np.int32)
    eq = up[:, None] == up[None, :]
    if not iupac_mode:
        return eq.astype(np.uint8)

    # Bitset per byte: bit i set for the i-th possible interpretation letter.
    letters = sorted(set("".join(IUPAC_MAPPING.values())))
    bit = {c: 1 << i for i, c in enumerate(letters)}
    sets = np.zeros(256, dtype=np.int64)
    known = np.zeros(256, dtype=bool)
    for k, v in IUPAC_MAPPING.items():
        m = 0
        for c in set(v.upper()):
            m |= bit[c]
        sets[ord(k)] = m
        known[ord(k)] = True
    # Apply per uppercased char: byte b behaves as chr(b).upper()
    sets_u = sets[_UPPER]
    known_u = known[_UPPER]
    inter = (sets_u[:, None] & sets_u[None, :]) != 0
    both_known = known_u[:, None] & known_u[None, :]
    return np.where(both_known, inter, eq).astype(np.uint8)


# ---------------------------------------------------------------------------
# Nibble (4-bit) genome plane. After the FASTA filter the sequence alphabet
# is exactly 16 letters (case-folded), so each base fits in 4 bits — halving
# host->device transfer and device reads. Codes 0-3 are A,C,G,T (== 2-bit
# hash codes); 4+ are the ambiguity letters.
# ---------------------------------------------------------------------------
NIB_ALPHABET = "ACGTBDHKMNRSVWXY"
NIB_LUT = np.full(256, 255, dtype=np.uint8)  # 255 = not representable
for _i, _c in enumerate(NIB_ALPHABET):
    NIB_LUT[ord(_c)] = NIB_LUT[ord(_c.lower())] = _i

# Primer-side codes: 16 alphabet letters, 16='U', 17=anything else.
# ('U' needs its own code: IUPAC-mode U matches T/Y/K/... while a primer
# byte outside the genome alphabet can never match a filtered genome.)
PRIMER_CODE_LUT = np.full(256, 17, dtype=np.uint8)
for _i, _c in enumerate(NIB_ALPHABET):
    PRIMER_CODE_LUT[ord(_c)] = PRIMER_CODE_LUT[ord(_c.lower())] = _i
PRIMER_CODE_LUT[ord("U")] = PRIMER_CODE_LUT[ord("u")] = 16
N_PRIMER_CODES = 32  # padded to a power of two for flat-index gathers


def nib_match_matrix(iupac_mode: bool) -> np.ndarray:
    """16 x N_PRIMER_CODES uint8 table with the same semantics as
    ``match_matrix`` restricted to (genome alphabet) x (primer codes)."""
    byte_m = match_matrix(iupac_mode)
    out = np.zeros((16, N_PRIMER_CODES), dtype=np.uint8)
    for s, sc in enumerate(NIB_ALPHABET):
        for p in range(N_PRIMER_CODES):
            if p < 16:
                pc = NIB_ALPHABET[p]
            elif p == 16:
                pc = "U"
            else:
                pc = "\x01"  # never matches any genome letter
            out[s, p] = byte_m[ord(sc), ord(pc)]
    return out


def iupac_exp_masks() -> tuple[np.ndarray, np.ndarray]:
    """Bitmask formulation of the IUPAC match: 17-bit expansion masks over
    the 16 expansion letters + 'X' (which the reference treats as a
    non-IUPAC code matching only itself — match_matrix docstring), such
    that nib_match_matrix(True)[s, p] == ((EXP_NIB[s] & EXP_PRIMER[p]) != 0).

    Verified exhaustively by tests; lets the verify stages replace the
    per-element 16x32 LUT gather with a few elementwise select/and passes.
    """
    letters = sorted(set("".join(IUPAC_MAPPING.values()))) + ["X"]
    bit = {c: 1 << i for i, c in enumerate(letters)}

    def mask_of(ch: str) -> int:
        if ch in IUPAC_MAPPING:
            return sum(bit[c] for c in set(IUPAC_MAPPING[ch].upper()))
        if ch == "X":
            return bit["X"]
        return 0  # unknown primer byte: never matches a genome letter

    exp_nib = np.array([mask_of(c) for c in NIB_ALPHABET], dtype=np.uint32)
    pcodes = [NIB_ALPHABET[p] if p < 16 else ("U" if p == 16 else "\x01")
              for p in range(N_PRIMER_CODES)]
    exp_primer = np.array([mask_of(c) for c in pcodes], dtype=np.uint32)
    return exp_nib, exp_primer


def pack_nibbles(nib: np.ndarray) -> np.ndarray:
    """Pack a 4-bit code array (even length) two-per-byte, low nibble first."""
    assert len(nib) % 2 == 0
    return (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)


def encode_bytes(text: str) -> np.ndarray:
    """Encode a Python string to a uint8 array (latin-1)."""
    return np.frombuffer(text.encode("latin-1", errors="replace"), dtype=np.uint8)


def decode_bytes(arr: np.ndarray) -> str:
    return arr.tobytes().decode("latin-1")


def reverse_complement_bytes(arr: np.ndarray) -> np.ndarray:
    """Reverse complement on a byte array (reference engine.py:357-359)."""
    return COMPL[arr][::-1]


def hash_value_bytes(primer: np.ndarray, wordsize: int) -> tuple[int, int]:
    """First-valid-W-mer hash of a primer byte array.

    Mirrors reference engine.py:331-355: scan offsets left to right, return
    (offset, hash) of the first window of `wordsize` bases that contains no
    ambiguous base; the hash packs 2-bit codes big-endian. Returns (-1, 0)
    when no window qualifies. Case-insensitive via SCODE.
    """
    n = primer.shape[0]
    if n < wordsize:
        return -1, 0
    codes = SCODE[primer]
    ok = codes != AMBIG
    # Sliding AND over the window: valid[o] == all ok[o:o+W]
    c = np.cumsum(np.concatenate(([0], ok.astype(np.int64))))
    wins = c[wordsize:] - c[:-wordsize]  # length n-W+1
    valid = wins == wordsize
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return -1, 0
    off = int(idx[0])
    h = 0
    for i in range(wordsize):
        h = (h << 2) | int(codes[off + i])
    return off, h
