"""WAH word-format constants.

The reference format constants (reference: const.h:3-16). The compressed stream is a sequence of
uint32 words:

  | word kind | bit 31 | bit 30 | bits 29..0 | meaning                         |
  |-----------|--------|--------|------------|---------------------------------|
  | literal   |   0    |  (payload: one 31-bit chunk, LSB-first)                |
  | zero fill |   1    |   0    | run len N  | N all-zero 31-bit chunks        |
  | one  fill |   1    |   1    | run len N  | N all-one  31-bit chunks        |

Bit order: logical bit *i* of the bitmap is bit (i % 32), LSB-first, of
input uint32 word i // 32. 31-bit chunk *k* covers logical bits
[31k, 31k+30], stored LSB-first in the low 31 bits
(reference: kernels.cu:79, validated by tests.cpp:94-97).

Fill runs never cross a BLOCK_CHUNKS-chunk block boundary: run-length
coalescing is complete *within* each block of 1024 chunks (= 992 input
uint32 = 31744 logical bits) and never extends across blocks
(reference: kernels.cu:51-262 performs all merging inside one CUDA
thread block; tests.cpp:227-239 pins no-merge-across-blocks).
Hence the max in-stream run length is 1024, far below the 2^30 - 1
format limit, and the words 0x00000000 / 0x7FFFFFFF never appear in a
compressed stream (an all-zero/all-one chunk is always emitted as a
fill of length >= 1; reference: kernels.cu:93-112).
"""

# --- word-format bit masks (reference: const.h:3-12) ---
ZEROS = 0x00000000
ONES31 = 0x7FFFFFFF  # low 31 bits set; also the one-fill chunk payload
ONES = 0xFFFFFFFF
BIT31 = 0x80000000  # fill-word flag
BIT30 = 0x40000000  # one-fill flag (only meaningful when BIT31 set)
BIT3130 = 0xC0000000  # one-fill word prefix
LEN_MASK = BIT30 - 1  # 0x3FFFFFFF: 30-bit run length (reference: kernels.cu:300,334)

# --- chunk type codes (reference: const.h:14-16) ---
WORD_ZEROS = 0
WORD_ONES = 1
WORD_LITERAL = 2

# --- geometry ---
CHUNK_BITS = 31  # logical payload bits per chunk
WORD_BITS = 32  # storage bits per input/output word
# One block: the semantic coalescing unit. 1024 chunks = 992 uint32 = 31744 bits
# (reference: grid math compress.cu:62-67, dim3(32,32) => 32 warps x 32 chunks).
BLOCK_CHUNKS = 1024
BLOCK_INTS = 992  # BLOCK_CHUNKS * 31 // 32
WARP_CHUNKS = 32  # chunks per reference warp (32 chunks = 31 ints); kept for tests
WARP_INTS = 31
