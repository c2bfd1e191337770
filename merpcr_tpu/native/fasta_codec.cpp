// Native host codec for merpcr_tpu: the host-side hot loops that feed the
// accelerator — FASTA byte filtering and 4-bit nibble packing — as a small C++
// library loaded via ctypes (built from this file on first use by
// merpcr_tpu/native/__init__.py; a NumPy
// fallback in Python keeps everything working without it).
//
// Parity contract:
//  * fasta_filter matches the reference filter (fasta.py:60): keep bytes
//    whose uppercase is in "ACGTBDHKMNRSVWXY", preserving case.
//  * nibble_pack produces the same layout as ops/encoding.py pack_nibbles
//    (NIB_LUT codes, low nibble = even position).

#include <cstdint>
#include <cstring>

extern "C" {

// 256-entry tables are built once on the Python side and passed in, so the
// semantics live in exactly one place (ops/encoding.py).

// Filter src[0..n) into dst keeping bytes where keep[b] != 0.
// Returns number of bytes written. dst may alias src.
int64_t mp_fasta_filter(const uint8_t* src, int64_t n, const uint8_t* keep,
                        uint8_t* dst) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t b = src[i];
    dst[w] = b;
    w += keep[b] != 0;
  }
  return w;
}

// Map src bytes through lut into 4-bit codes and pack two per byte
// (low nibble = even index). n must be even. Returns 0, or -1 if any byte
// maps to 255 (not representable; caller falls back to the byte pipeline).
int32_t mp_nibble_pack(const uint8_t* src, int64_t n, const uint8_t* lut,
                       uint8_t* dst) {
  uint8_t bad = 0;
  for (int64_t i = 0; i < n; i += 2) {
    uint8_t a = lut[src[i]];
    uint8_t b = lut[src[i + 1]];
    bad |= a | b;
    dst[i >> 1] = (uint8_t)((a & 15) | (b << 4));
  }
  return (bad & 0x80) ? -1 : 0;  // 255 has the high bit set; codes 0..15 don't
}

// Combined FASTA line scan: strip/concatenate sequence lines of one record
// is left in Python (cheap); the per-byte work above is the hot part.

}  // extern "C"
