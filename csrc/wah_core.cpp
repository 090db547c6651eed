// Native host-side WAH codec core.
//
// The framework's C++ runtime component: the reference implements
// its host layer in C++/CUDA (compress.cu:41-209, decompress.cu:18-141);
// here the host-side counterpart is a fast scalar CPU codec used for
// (a) host validation of device streams, (b) golden cross-checks in the
// differential test harness, and (c) a no-device fallback path. The
// format contract is SURVEY.md §0.1: 31-bit chunks, literal/fill words,
// complete RLE coalescing within 1024-chunk blocks, runs never crossing
// block boundaries (reference: kernels.cu:93-262, tests.cpp:227-239).
//
// Exposed as a C ABI consumed from Python via ctypes (wah_tpu/native.py).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t ONES31 = 0x7FFFFFFFu;
constexpr uint32_t BIT31 = 0x80000000u;
constexpr uint32_t BIT3130 = 0xC0000000u;
constexpr uint32_t LEN_MASK = 0x3FFFFFFFu;
constexpr int64_t BLOCK_CHUNKS = 1024;

// 31-bit chunk k of the bitmap: logical bits [31k, 31k+31), LSB-first
// (reference repartition formula, kernels.cu:79 / tests.cpp:94-97).
inline uint32_t chunk_at(const uint32_t* ints, int64_t n, int64_t k) {
  const int64_t bit = 31 * k;
  const int64_t w = bit >> 5;
  const int sh = static_cast<int>(bit & 31);
  uint64_t lo = (w < n) ? ints[w] : 0u;
  uint64_t hi = (w + 1 < n) ? ints[w + 1] : 0u;
  return static_cast<uint32_t>(((lo >> sh) | (hi << (32 - sh))) & ONES31);
}

}  // namespace

extern "C" {

// Number of chunks for n input words: pad to a multiple of 31 words,
// every 31 words -> 32 chunks (reference warp geometry, kernels.cu:67-79).
int64_t wah_chunk_count(int64_t n_ints) {
  const int64_t n31 = (n_ints + 30) / 31 * 31;
  return n31 * 32 / 31;
}

// Encode: returns number of words written to out (capacity must be
// >= wah_chunk_count(n)). Complete RLE within each 1024-chunk block.
int64_t wah_encode(const uint32_t* ints, int64_t n_ints, uint32_t* out) {
  const int64_t nc = wah_chunk_count(n_ints);
  int64_t w = 0;
  int64_t k = 0;
  while (k < nc) {
    const int64_t block_end =
        (k / BLOCK_CHUNKS + 1) * BLOCK_CHUNKS < nc
            ? (k / BLOCK_CHUNKS + 1) * BLOCK_CHUNKS
            : nc;
    const uint32_t c = chunk_at(ints, n_ints, k);
    if (c != 0u && c != ONES31) {
      out[w++] = c;
      ++k;
      continue;
    }
    // fill run: extend while same filler, stop at block boundary
    const uint32_t filler = c;
    int64_t run = 1;
    while (k + run < block_end &&
           chunk_at(ints, n_ints, k + run) == filler) {
      ++run;
    }
    out[w++] = (filler ? BIT3130 : BIT31) | static_cast<uint32_t>(run);
    k += run;
  }
  return w;
}

// Expanded chunk count of a stream; -1 if a fill has zero run length.
int64_t wah_decoded_chunks(const uint32_t* words, int64_t m) {
  int64_t total = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (words[i] & BIT31) {
      const int64_t len = words[i] & LEN_MASK;
      if (len == 0) return -1;
      total += len;
    } else {
      total += 1;
    }
  }
  return total;
}

// Decode into out (capacity out_ints words, zero-initialized by callee);
// returns number of output words = ceil(31*chunks/32) clamped to
// capacity, or -1 on invalid stream.
int64_t wah_decode(const uint32_t* words, int64_t m, uint32_t* out,
                   int64_t out_ints) {
  std::memset(out, 0, static_cast<size_t>(out_ints) * 4);
  int64_t k = 0;  // chunk cursor
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t word = words[i];
    int64_t len;
    uint32_t payload;
    if (word & BIT31) {
      len = word & LEN_MASK;
      if (len == 0) return -1;
      payload = ((word & BIT3130) == BIT3130) ? ONES31 : 0u;
    } else {
      len = 1;
      payload = word;
    }
    if (payload != 0u) {
      for (int64_t r = 0; r < len; ++r) {
        const int64_t bit = 31 * (k + r);
        const int64_t w = bit >> 5;
        const int sh = static_cast<int>(bit & 31);
        const uint64_t v = static_cast<uint64_t>(payload) << sh;
        if (w < out_ints) out[w] |= static_cast<uint32_t>(v);
        if (w + 1 < out_ints)
          out[w + 1] |= static_cast<uint32_t>(v >> 32);
      }
    }
    k += len;
  }
  return (31 * k + 31) / 32 < out_ints ? (31 * k + 31) / 32 : out_ints;
}

// Stream validation (api.validate_stream semantics): 0 = ok,
// 1 = literal-valued fill word present (0x0 / 0x7FFFFFFF),
// 2 = fill length out of [1, 1024].
int32_t wah_validate(const uint32_t* words, int64_t m) {
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t word = words[i];
    if (word == 0u || word == ONES31) return 1;
    if (word & BIT31) {
      const uint32_t len = word & LEN_MASK;
      if (len < 1 || len > BLOCK_CHUNKS) return 2;
    }
  }
  return 0;
}

}  // extern "C"
