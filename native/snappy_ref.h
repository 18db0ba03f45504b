// Clean-room C++ Snappy codec — the golden-reference native component.
//
// Plays the role of the google/snappy submodule + tests/swcompression.cc in
// the reference repo (both unavailable here): an implementation of the public
// Snappy wire format that is fully independent of the JAX codec, used
// by the test tiers to certify that device-produced streams are bit-for-bit
// decompressible and that compressed sizes meet the software-Snappy ratio bar.
//
// Two encoder modes:
//   SR_MODE_BASELINE — emulates software Snappy's parse (sparse hash table
//     with skip acceleration, <=14-bit table). Defines the ratio baseline.
//   SR_MODE_DENSE    — inserts every position (denser table), closer to what
//     the device matcher does.
//
// C ABI so Python binds via ctypes (no pybind11 in this image).

#ifndef TPU_SNAPPY_NATIVE_SNAPPY_REF_H_
#define TPU_SNAPPY_NATIVE_SNAPPY_REF_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

enum {
  SR_OK = 0,
  SR_ERR_TRUNCATED = 1,
  SR_ERR_BAD_OFFSET = 2,
  SR_ERR_LENGTH_MISMATCH = 3,
  SR_ERR_CAPACITY = 4,
  SR_ERR_BAD_VARINT = 5,
  SR_ERR_CRC = 6,
  SR_ERR_BAD_CHUNK = 7,
};

enum {
  SR_MODE_BASELINE = 0,
  SR_MODE_DENSE = 1,
};

// Worst-case compressed size for n input bytes (preamble included).
size_t sr_max_compressed_length(size_t n);

// Compress n bytes of `in` into `out` (capacity must be at least
// sr_max_compressed_length(n)). Returns the compressed size.
size_t sr_compress(const uint8_t* in, size_t n, uint8_t* out, int mode);

// Read the uncompressed-length preamble. Returns SR_OK or an error code.
int sr_uncompressed_length(const uint8_t* in, size_t n, uint64_t* result);

// Strict decompression with validation. `out_cap` must be at least the
// preamble length. On success writes the output size to *out_len.
int sr_uncompress(const uint8_t* in, size_t n, uint8_t* out, size_t out_cap,
                  uint64_t* out_len);

// Scan the element chain of a stream (after the preamble, i.e. in[start..n))
// and emit the fragment table used by the parallel decoder: fragments are
// maximal element runs whose output ends on a 64 KB boundary (or stream
// end). For each fragment i writes comp_off[i] (offset into `in`) and
// out_len[i]; both arrays must hold `max_frags` entries. Writes the fragment
// count to *num_frags. Returns SR_OK, or an error if the chain is malformed,
// an element straddles a 64 KB output boundary, or max_frags is exceeded
// (callers then fall back to sequential decode).
int sr_scan_index(const uint8_t* in, size_t n, size_t start,
                  uint64_t expected_out, uint32_t* comp_off,
                  uint32_t* out_len, size_t max_frags, uint32_t* num_frags);

// Root map of one element stream (no preamble, <= 64 KB output): for every
// output byte, the index into `elems` of the literal byte that ultimately
// supplies it, as maximal affine pieces (start, root, slope in {0, 1};
// slope 0 = offset-1 RLE). All three arrays must hold max_pieces entries;
// writes the piece count to *num_pieces. Used by the framed sidecar
// encoder (framing.py) — the decode side then skips parse+resolve and
// runs one gather. Returns SR_OK or an error (capacity when elems exceeds
// 64 KB - 1 or the piece arrays are too small).
int sr_root_map(const uint8_t* elems, size_t n, uint64_t expected_out,
                uint16_t* piece_start, uint16_t* piece_root,
                uint8_t* piece_slope, size_t max_pieces,
                uint32_t* num_pieces);

// Per-tile resolve depth hints for a tile-sequential resolve tail (the
// framed 0x81 "tpD1" sidecar, sidecar.py): simulates that resolve
// pipeline on one element stream — one-step source map
// with periodic-run collapse, pointer-doubling rounds while the moving
// count exceeds tail_cap (capped at 16), then per-tile local doubling to
// each tile's local fixpoint — and writes each tile's exact local round
// count (65536/tile entries, depths fit u8: local depth <= log2(tile)).
// A tile-sequential decoder can then run exactly depths[t] rounds per tile
// with no detect body; the current decoder validates hints but does not
// need them.
// Returns SR_OK or an error for malformed streams/capacity.
int sr_depth_hints(const uint8_t* elems, size_t n, uint64_t expected_out,
                   uint32_t tail_cap, uint32_t tile, uint8_t* depths);

// Brute-force round-by-round simulation form of sr_depth_hints
// (bit-identical by construction; the analytic sr_depth_hints derives
// both doubling phases from per-lane chain depths instead). Kept as the
// cross-check oracle for corpus + fuzz tests.
int sr_depth_hints_sim(const uint8_t* elems, size_t n, uint64_t expected_out,
                       uint32_t tail_cap, uint32_t tile, uint8_t* depths);

// ---- Framing format (the official Snappy streaming container) ----
// Spec: google/snappy framing_format.txt — chunked stream with per-chunk
// CRC-32C (Castagnoli) checksums, masked as ((crc>>15)|(crc<<17))+0xa282ead8.

// CRC-32C of n bytes (unmasked).
uint32_t sr_crc32c(const uint8_t* in, size_t n);

// Worst-case framed size for n input bytes (all-uncompressed chunks).
size_t sr_max_framed_length(size_t n);

// Compress n bytes into a framed stream (stream-identifier chunk + one
// data chunk per 64 KB; compressed chunks only where compression saves).
// Returns the framed size. `mode` as for sr_compress.
size_t sr_compress_framed(const uint8_t* in, size_t n, uint8_t* out,
                          int mode);

// Decompress a framed stream with full validation (chunk structure, CRCs).
// Writes the output size to *out_len. Returns SR_OK or an error code
// (SR_ERR_CRC on checksum mismatch, SR_ERR_BAD_CHUNK on a reserved
// unskippable chunk or a malformed stream identifier).
int sr_uncompress_framed(const uint8_t* in, size_t n, uint8_t* out,
                         size_t out_cap, uint64_t* out_len);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // TPU_SNAPPY_NATIVE_SNAPPY_REF_H_
