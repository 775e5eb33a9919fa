// Dictionary-string kernels (K4 match table, K5 LIKE table, K6
// substring) for Hopper (sm_90a).
//
// Both work on a dictionary's padded char table: chars uint8[n, L] (L a
// power of two <= 512, each entry's UTF-8 bytes zero-padded) and lens
// int32[n]. The per-row work of a string expression stays a gather by
// code; these kernels do the per-entry work once per dictionary.
//
// K4 replaces spark_rapids_tpu/native/kernels/strings.py: _match_table.
// It answers starts / ends / contains for one needle of m bytes
// (1 <= m <= L) per entry. The TPU kernel materialized an (n, L-m+1, m)
// window tensor for contains, capped by a 64 MiB budget; this one builds
// nothing, so it takes every table the encoder accepts. Bound: the
// table's bytes (n*L + 4n read, n written). Design:
// - the needle reaches the card by value in the launch's parameters
//   (with its shift-and table, built on the host), so a call makes no
//   host-to-device copy; each block copies both to shared memory;
// - rows are read with 16-byte loads (narrower for L < 16). For L <= 64
//   a thread holds its row in registers; for L >= 128 a group of L/16
//   lanes of one warp shares a row, each load of the group covering the
//   row's consecutive bytes, and stages it in shared memory;
// - starts compares 16-byte words with the needle's, the tail masked;
// - contains, for m <= 64, is shift-and (bitap) over the row's len
//   bytes: a 64-bit state, one shift, OR and AND per byte against the
//   table of the byte's needle positions. In a group each lane runs it
//   over its own 16 bytes and the up to 64 before them, so every window
//   is seen by the lane holding its last byte. Longer needles compare
//   windows from shared memory, each lane the windows that start in its
//   16 bytes, stopping at the first mismatch;
// - ends is the shift-and state after the row's last byte for a thread's
//   row, and a byte compare of the window at len - m for a group;
// - only bytes below len are read for a match, so a zero byte in the
//   needle never meets the padding.
//
// K5 replaces strings.py: _like_table (SQL LIKE). The host parses the
// pattern into its non-empty %-separated segments, each with its branch of
// the TPU kernel: an anchored first segment matches at byte 0, an anchored
// last one the window at len-m (starting at or after the cursor), any other
// one takes its leftmost window at or after the cursor (greedy is exact for
// segments of fixed length); a pattern without % also needs the exact
// length. '_' matches one byte (the host keeps it off non-ASCII tables).
// Matched segments never overlap, so a pattern whose bytes exceed L
// matches nothing and the host launches nothing. The TPU kernel built an
// (n, L-m+1, m) window tensor per segment under a 64 MiB budget; this one
// builds nothing and has no budget. Bound: the table's bytes (n*L + 4n
// read, n written), or the byte comparisons of this data where those are
// larger. Design:
// - the parsed pattern reaches the card by value in the launch's
//   parameters (K5Pattern, built by the C entry point: the segments as
//   bit masks of their first and last body bytes, the concatenated body,
//   the '_' mask, and a 256-entry table of position masks over the body,
//   '_' setting its bit for every byte), so a call makes no copy; each
//   block copies the table to shared memory;
// - a body of up to 64 bytes (every pattern the query paths use) is one
//   shift-and pass over the row, segment after segment: a floating
//   segment injects its first bit at every byte at or after the cursor,
//   and its first end bit is its leftmost match, the reference's greedy
//   choice, after which the next segment starts; an anchored first
//   segment injects at byte 0 only, and an anchored last one is decided
//   by its end bit after the row's last byte, which is a window at
//   len-m starting at or after the cursor. A 32-bit state serves bodies
//   of up to 32 bytes. A byte is an extract, a shared load and a few
//   logic operations; a segment's end is one rare branch, so the lanes of
//   a warp stay together, and the anchored first segment's failure is
//   read once a chunk;
// - a thread walks its own row in 16-byte __ldg loads (narrower for
//   L < 16, as K4), the next chunk's load issued before the current one
//   is scanned, only the chunks below len read, and it stops as soon as
//   the row is decided;
// - a longer body compares bytes against the struct's copy in shared
//   memory, segment by segment; it is correct, not fast (no query uses
//   one).
//
// K6 replaces strings.py: substring_colv's kernel: Spark's substring(pos,
// len) of every entry, the end derived from the unclamped start. One
// thread per 16-byte output chunk (a thread per row for L < 16), indexed
// with shifts: it computes its entry's clamped start and new length once,
// reads the one or two aligned 16-byte source chunks that cover its
// output, aligns them with __funnelshift_r on the run-time offset (no
// local array: ptxas reports a 0-byte stack frame), zeroes the bytes past
// the new length and writes one 16-byte store; the chunk-0 thread writes
// the new length. Bound: n*L bytes read and written plus the lengths.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NEEDLE = 512;

enum Kind { STARTS = 0, ENDS = 1, CONTAINS = 2 };

// The needle, by value in the kernel's parameters (2,576 bytes of the
// 4 KB parameter space).
struct K4Needle {
  unsigned long long table[256];  // bit k: needle byte k (k < 64) is c
  uint4 bytes[MAX_NEEDLE / 16];   // zero past m
  int m, kind;
};

__device__ __forceinline__ unsigned word_of(const uint4& c, int w) {
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

__device__ __forceinline__ int byte_of(const uint4& c, int j) {
  return (word_of(c, j >> 2) >> (8 * (j & 3))) & 0xff;
}

// Do bytes [0, nbytes) of chunk c (nbytes may pass 16) equal those of
// the needle's chunk nd?
__device__ __forceinline__ bool chunk_eq(const uint4& c, const uint4& nd,
                                         int nbytes) {
  unsigned diff = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int k = nbytes - 4 * w;
    const unsigned mask = k >= 4 ? 0xffffffffu : k <= 0 ? 0u
                                                 : (1u << (8 * k)) - 1u;
    diff |= (word_of(c, w) ^ word_of(nd, w)) & mask;
  }
  return diff == 0;
}

// Shift-and over the first nb bytes of chunk c (FULL: all 16): d is the
// state (bit k: the needle's first k + 1 bytes end here), acc ORs every
// state, so a window ended in the chunk when acc holds bit m - 1. W is
// 32 bits for needles up to 32 bytes, else 64.
template <typename W, bool FULL>
__device__ __forceinline__ void bitap_chunk(const uint4& c, int nb,
                                            const W* tab, W& d, W& acc) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (FULL || j < nb) {
      d = ((d << 1) | W(1)) & tab[byte_of(c, j)];
      acc |= d;
    }
  }
}

template <typename W>
__device__ __forceinline__ void bitap_any(const uint4& c, int nb,
                                          const W* tab, W& d, W& acc) {
  if (nb >= 16)
    bitap_chunk<W, true>(c, 16, tab, d, acc);
  else if (nb > 0)
    bitap_chunk<W, false>(c, nb, tab, d, acc);
}

// Row i's chunks for L <= 64: min(L, 16)-byte pieces, zero-extended.
template <int L>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ chars,
                                         long long i, uint4* c) {
  if (L >= 16) {
    const uint4* r = reinterpret_cast<const uint4*>(chars + i * L);
#pragma unroll
    for (int q = 0; q < L / 16; ++q) c[q] = __ldg(r + q);
  } else if (L == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(chars) + i);
    c[0] = make_uint4(v.x, v.y, 0u, 0u);
  } else if (L == 4) {
    c[0] = make_uint4(__ldg(reinterpret_cast<const unsigned*>(chars) + i),
                      0u, 0u, 0u);
  } else if (L == 2) {
    c[0] = make_uint4(
        __ldg(reinterpret_cast<const unsigned short*>(chars) + i), 0u, 0u,
        0u);
  } else {
    c[0] = make_uint4(__ldg(chars + i), 0u, 0u, 0u);
  }
}

struct K4Shared {
  unsigned long long tab64[256];
  unsigned tab32[256];  // the low halves, for needles up to 32 bytes
  uint4 needle[MAX_NEEDLE / 16];
};

__device__ __forceinline__ void k4_stage_needle(const K4Needle& p,
                                                K4Shared& sh) {
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    sh.tab64[k] = p.table[k];
    sh.tab32[k] = (unsigned)p.table[k];
  }
  for (int k = threadIdx.x; k < MAX_NEEDLE / 16; k += blockDim.x)
    sh.needle[k] = p.bytes[k];
  __syncthreads();
}

template <typename W>
__device__ __forceinline__ const W* table_of(const K4Shared& sh);
template <>
__device__ __forceinline__ const unsigned* table_of<unsigned>(
    const K4Shared& sh) {
  return sh.tab32;
}
template <>
__device__ __forceinline__ const unsigned long long* table_of<
    unsigned long long>(const K4Shared& sh) {
  return sh.tab64;
}

// contains / ends of one row held in registers (m <= L <= 64): shift-and
// over its len bytes, chunk by chunk.
template <typename W, int NC, int NB>
__device__ __forceinline__ bool row_bitap(const uint4* c, int len, int m,
                                          int kind, const W* tab) {
  W d = 0, acc = 0;
#pragma unroll
  for (int q = 0; q < NC; ++q) bitap_any<W>(c[q], min(NB, len - 16 * q),
                                            tab, d, acc);
  const W hi = W(1) << (m - 1);
  return ((kind == ENDS ? d : acc) & hi) != 0;
}

// L <= 64: one thread per row, the row in registers; grid-stride.
template <int L>
__global__ void __launch_bounds__(THREADS)
    k4_rows(const uint8_t* __restrict__ chars, const int* __restrict__ lens,
            int n, const __grid_constant__ K4Needle p,
            uint8_t* __restrict__ out) {
  constexpr int NC = L >= 16 ? L / 16 : 1;  // chunks a row
  constexpr int NB = L >= 16 ? 16 : L;      // bytes a chunk
  __shared__ K4Shared sh;
  k4_stage_needle(p, sh);
  const int m = p.m, kind = p.kind;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const int len = __ldg(lens + i);
    bool hit = false;
    if (len >= m) {
      uint4 c[NC];
      load_row<L>(chars, i, c);
      if (kind == STARTS) {
        hit = true;
#pragma unroll
        for (int q = 0; q < NC; ++q)
          if (16 * q < m) hit &= chunk_eq(c[q], sh.needle[q], m - 16 * q);
      } else if (m <= 32) {
        hit = row_bitap<unsigned, NC, NB>(c, len, m, kind, sh.tab32);
      } else {
        hit = row_bitap<unsigned long long, NC, NB>(c, len, m, kind,
                                                    sh.tab64);
      }
    }
    out[i] = hit ? 1 : 0;
  }
}

// contains (m <= 64) for lane g of a group: shift-and from the chunk
// holding the window's earliest possible start to its own chunk's end.
template <typename W>
__device__ __forceinline__ bool lane_bitap(const uint4* row, int g, int len,
                                           int m, const W* tab) {
  W d = 0, acc = 0;
  for (int q = max(0, g - (m + 14) / 16); q <= g; ++q)
    bitap_any<W>(row[q], min(16, len - 16 * q), tab, d, acc);
  return (acc & (W(1) << (m - 1))) != 0;
}

// L >= 128: a group of G = L/16 lanes per row, the row staged in shared
// memory (256/G rows a block, 4 KB); grid-stride over rows.
template <int L>
__global__ void __launch_bounds__(THREADS)
    k4_groups(const uint8_t* __restrict__ chars,
              const int* __restrict__ lens, int n,
              const __grid_constant__ K4Needle p,
              uint8_t* __restrict__ out) {
  constexpr int G = L / 16;            // lanes a row: 8, 16 or 32
  constexpr int RPB = THREADS / G;     // rows a block
  __shared__ K4Shared sh;
  __shared__ uint4 s_rows[RPB][G];
  k4_stage_needle(p, sh);
  const int m = p.m, kind = p.kind;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x % G;       // this lane's chunk of the row
  const int r = threadIdx.x / G;       // this group's row in the block
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  const int gshift = lane & ~(G - 1);
  const uint8_t* s_bytes = reinterpret_cast<const uint8_t*>(s_rows[r]);
  const uint8_t* s_needle = reinterpret_cast<const uint8_t*>(sh.needle);
  // every lane runs every round, so the ballots see whole warps
  for (long long base = (long long)blockIdx.x * RPB; base < n;
       base += (long long)gridDim.x * RPB) {
    const long long i = base + r;
    const bool live = i < n;
    const int len = live ? __ldg(lens + i) : 0;
    const uint4 c = live ? __ldg(reinterpret_cast<const uint4*>(
                               chars + i * L) + g)
                         : make_uint4(0u, 0u, 0u, 0u);
    s_rows[r][g] = c;
    __syncwarp();
    bool mine;  // this lane's part: AND over lanes for starts / ends,
                // OR for contains
    if (kind == STARTS) {
      mine = 16 * g >= m || chunk_eq(c, sh.needle[g], m - 16 * g);
    } else if (kind == ENDS) {
      mine = true;
      const int w0 = len - m;
      for (int k = 16 * g; k < min(16 * g + 16, m) && w0 >= 0; ++k)
        mine &= s_bytes[w0 + k] == s_needle[k];
    } else if (16 * g >= len) {
      mine = false;
    } else if (m <= 32) {
      mine = lane_bitap<unsigned>(s_rows[r], g, len, m, sh.tab32);
    } else if (m <= 64) {
      mine = lane_bitap<unsigned long long>(s_rows[r], g, len, m,
                                            sh.tab64);
    } else {
      mine = false;
      for (int s0 = 16 * g; s0 < 16 * g + 16 && s0 + m <= len && !mine;
           ++s0) {
        int k = 0;
        while (k < m && s_bytes[s0 + k] == s_needle[k]) ++k;
        mine = k == m;
      }
    }
    const bool any_rule = kind == CONTAINS;
    const unsigned votes =
        (__ballot_sync(0xffffffffu, any_rule ? mine : !mine) >> gshift) &
        gmask;
    const bool hit = len >= m && (any_rule ? votes != 0u : votes == 0u);
    if (live && g == 0) out[i] = hit ? 1 : 0;
    __syncwarp();  // s_rows[r] is rewritten next round
  }
}

// ---- K5 --------------------------------------------------------------------

// The parsed pattern, by value in the launch's parameters.
struct K5Pattern {
  unsigned long long table[256];   // bit k: body byte k (k < 64) takes c
  unsigned long long starts[MAX_NEEDLE / 64];  // bit k: a segment's first
  unsigned long long ends[MAX_NEEDLE / 64];    //   / last byte is body k
  unsigned long long wild[MAX_NEEDLE / 64];    // bit k: body byte k is '_'
  uint8_t body[MAX_NEEDLE];  // the segments' bytes, concatenated
  int nbytes, nseg;
  int first_prefix;  // the first segment is anchored at byte 0
  int last_suffix;   // the last segment is anchored at the row's end
  int exact_len;     // -1, or the length a pattern without % needs
};
static_assert(sizeof(K5Pattern) <= 4096,
              "K5Pattern must fit the 4 KB kernel parameter space");

template <typename W>
__device__ __forceinline__ W lowest_bit(W x) {
  return x & (W(0) - x);
}

enum { K5_GO = 0, K5_TRUE = 1, K5_FALSE = 2 };

// Where the shift-and scan of one row stands. d: bit k set when the body
// bytes from the current segment's first to k match ending here; inj: the
// segment's first bit, injected at the next byte; keep: all ones, or 0
// while the anchored first segment runs (it injects at byte 0 only); chk:
// the segment's last bit, or 0 for an anchored last segment (decided
// after the row's last byte); rest_s / rest_e: the segments to come.
template <typename W>
struct K5Scan {
  W d, inj, keep, ebit, chk, rest_s, rest_e;
  bool last, suffix;

  __device__ __forceinline__ void next_segment(int last_suffix) {
    inj = lowest_bit(rest_s);
    rest_s ^= inj;
    ebit = lowest_bit(rest_e);
    rest_e ^= ebit;
    last = rest_s == W(0);
    suffix = last && last_suffix;
    chk = suffix ? W(0) : ebit;
    d = W(0);
  }

  // One byte (its table entry t). The rare branch: the segment ended, and
  // the next one starts at the next byte.
  __device__ __forceinline__ int step(W t, int last_suffix) {
    d = ((d << 1) | inj) & t;
    inj &= keep;
    if ((d & chk) != W(0)) {
      if (last) return K5_TRUE;
      next_segment(last_suffix);
      keep = ~W(0);
    }
    return K5_GO;
  }
};

// Bytes [0, nb) of chunk c, nb <= 16 (guards, not branches, for the
// partial last chunk). An anchored first segment that failed leaves d at
// 0 for good, so the chunk's end tells.
template <typename W>
__device__ __forceinline__ int k5_chunk(K5Scan<W>& st, const W* tab,
                                        const uint4& c, int nb,
                                        int last_suffix) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < nb) {
      const int r = st.step(tab[byte_of(c, j)], last_suffix);
      if (r != K5_GO) return r;
    }
  }
  return (st.d | st.keep) == W(0) ? K5_FALSE : K5_GO;
}

template <typename W, int L>
__device__ __forceinline__ bool k5_row(const uint8_t* __restrict__ chars,
                                       long long i, int len,
                                       const K5Pattern& p, const W* tab) {
  if (p.exact_len >= 0 && len != p.exact_len) return false;
  if (p.nseg == 0) return true;
  K5Scan<W> st;
  st.rest_s = (W)p.starts[0];
  st.rest_e = (W)p.ends[0];
  st.next_segment(p.last_suffix);
  st.keep = p.first_prefix ? W(0) : ~W(0);
  int r = K5_GO;
  if (L < 16) {
    uint4 c[1];
    load_row<L>(chars, i, c);
    r = k5_chunk<W>(st, tab, c[0], len, p.last_suffix);
  } else {
    const uint4* row = reinterpret_cast<const uint4*>(chars + i * L);
    const int nch = (len + 15) >> 4;
    uint4 c = __ldg(row);
    for (int q = 0; q < nch && r == K5_GO; ++q) {
      const uint4 nx = q + 1 < nch ? __ldg(row + q + 1) : c;
      r = k5_chunk<W>(st, tab, c, len - 16 * q, p.last_suffix);
      c = nx;
    }
  }
  if (r != K5_GO) return r == K5_TRUE;
  return st.suffix && (st.d & st.ebit) != W(0);
}

// Bodies of up to 64 bytes (W: 32 bits up to 32): one thread per row,
// grid-stride.
template <typename W, int L>
__global__ void __launch_bounds__(THREADS)
    k5_like_rows(const uint8_t* __restrict__ chars,
                 const int* __restrict__ lens, int n,
                 const __grid_constant__ K5Pattern p,
                 uint8_t* __restrict__ out) {
  __shared__ W tab[256];
  for (int k = threadIdx.x; k < 256; k += THREADS) tab[k] = (W)p.table[k];
  __syncthreads();
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    out[i] = k5_row<W, L>(chars, i, __ldg(lens + i), p, tab) ? 1 : 0;
}

__device__ __forceinline__ bool bit_at(const unsigned long long* bits,
                                       int k) {
  return (bits[k >> 6] >> (k & 63)) & 1ull;
}

// Bodies past 64 bytes: segment by segment, each window compared byte by
// byte against the body in shared memory.
__global__ void __launch_bounds__(THREADS)
    k5_like_bytes(const uint8_t* __restrict__ chars,
                  const int* __restrict__ lens, int n, int L,
                  const __grid_constant__ K5Pattern p,
                  uint8_t* __restrict__ out) {
  __shared__ uint8_t body[MAX_NEEDLE];
  __shared__ unsigned long long wild[MAX_NEEDLE / 64];
  __shared__ unsigned long long ends[MAX_NEEDLE / 64];
  for (int k = threadIdx.x; k < MAX_NEEDLE; k += THREADS) body[k] = p.body[k];
  for (int k = threadIdx.x; k < MAX_NEEDLE / 64; k += THREADS) {
    wild[k] = p.wild[k];
    ends[k] = p.ends[k];
  }
  __syncthreads();
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const uint8_t* row = chars + i * (long long)L;
    const int len = __ldg(lens + i);
    bool ok = p.exact_len < 0 || len == p.exact_len;
    int cur = 0, off = 0;
    for (int s = 0; s < p.nseg && ok; ++s) {
      int m = 1;
      while (!bit_at(ends, off + m - 1)) ++m;
      const bool prefix = s == 0 && p.first_prefix;
      const bool suffix = s == p.nseg - 1 && p.last_suffix;
      int at = prefix ? 0 : suffix ? len - m : cur;
      const int last_at = prefix || suffix ? at : len - m;
      ok = false;
      for (; at <= last_at && at >= cur && at + m <= len && !ok; ++at) {
        int k = 0;
        while (k < m && (bit_at(wild, off + k) ||
                         __ldg(row + at + k) == body[off + k]))
          ++k;
        ok = k == m;
      }
      cur = at - 1 + m;
      off += m;
    }
    out[i] = ok ? 1 : 0;
  }
}

// ---- K6 --------------------------------------------------------------------

// Spark's slice of an entry of len bytes (strings.py:306-317: the end
// derives from the unclamped start): its clamped start and length.
__device__ __forceinline__ void k6_bounds(long long len, long long pos,
                                          long long length, int has_length,
                                          int& start_c, int& out_len) {
  const long long start = pos > 0 ? pos - 1 : (pos < 0 ? len + pos : 0);
  const long long end = has_length ? start + length : len;
  const long long sc = start < 0 ? 0 : (start > len ? len : start);
  long long ec = end < len ? end : len;
  ec = ec < 0 ? 0 : ec;
  start_c = (int)sc;
  out_len = (int)(ec - sc > 0 ? ec - sc : 0);
}

__device__ __forceinline__ unsigned pick4(unsigned a, unsigned b, unsigned c,
                                          unsigned d, int k) {
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

// Bytes [off, off + 16) of the 32 bytes a:b, the bytes from keep on
// zeroed (off in [0, 16), keep in [0, 16]).
// The low kb bytes of a word kept (kb may be out of [0, 4]).
__device__ __forceinline__ unsigned keep_bytes(unsigned w, int kb) {
  return w & (kb >= 4 ? 0xffffffffu : kb <= 0 ? 0u : (1u << (8 * kb)) - 1u);
}

__device__ __forceinline__ uint4 k6_align(const uint4& a, const uint4& b,
                                          int off, int keep) {
  const int ws = off >> 2, bs = (off & 3) * 8;
  const unsigned v0 = pick4(a.x, a.y, a.z, a.w, ws);
  const unsigned v1 = pick4(a.y, a.z, a.w, b.x, ws);
  const unsigned v2 = pick4(a.z, a.w, b.x, b.y, ws);
  const unsigned v3 = pick4(a.w, b.x, b.y, b.z, ws);
  const unsigned v4 = pick4(b.x, b.y, b.z, b.w, ws);
  return make_uint4(keep_bytes(__funnelshift_r(v0, v1, bs), keep),
                    keep_bytes(__funnelshift_r(v1, v2, bs), keep - 4),
                    keep_bytes(__funnelshift_r(v2, v3, bs), keep - 8),
                    keep_bytes(__funnelshift_r(v3, v4, bs), keep - 12));
}

// L >= 16: one thread per 16-byte output chunk, grid-stride; G = L / 16
// chunks a row, lg = log2(G).
template <int L>
__global__ void __launch_bounds__(THREADS)
    k6_substring(const uint8_t* __restrict__ chars,
                 const int* __restrict__ lens, long long total, long long pos,
                 long long length, int has_length, uint8_t* __restrict__ out,
                 int* __restrict__ out_lens) {
  constexpr int G = L / 16;
  constexpr int LG = G == 1 ? 0 : G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3
                   : G == 16 ? 4 : 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
       t < total; t += (long long)gridDim.x * THREADS) {
    const long long i = t >> LG;
    const int q = (int)(t & (G - 1));
    int start_c, out_len;
    k6_bounds(__ldg(lens + i), pos, length, has_length, start_c, out_len);
    const int o0 = 16 * q;
    uint4 res = zero;
    if (o0 < out_len) {
      const int s0 = start_c + o0;
      const int keep = min(16, out_len - o0);
      const int a = s0 >> 4, off = s0 & 15;
      const uint4* row = reinterpret_cast<const uint4*>(chars + i * L);
      const uint4 lo = __ldg(row + a);
      const uint4 hi = off + keep > 16 ? __ldg(row + a + 1) : zero;
      res = k6_align(lo, hi, off, keep);
    }
    reinterpret_cast<uint4*>(out + i * L)[q] = res;
    if (q == 0) out_lens[i] = out_len;
  }
}

// L < 16: one thread per row, the row in one chunk.
template <int L>
__global__ void __launch_bounds__(THREADS)
    k6_substring_rows(const uint8_t* __restrict__ chars,
                      const int* __restrict__ lens, int n, long long pos,
                      long long length, int has_length,
                      uint8_t* __restrict__ out, int* __restrict__ out_lens) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    int start_c, out_len;
    k6_bounds(__ldg(lens + i), pos, length, has_length, start_c, out_len);
    uint4 c[1];
    load_row<L>(chars, i, c);
    const uint4 r = k6_align(c[0], zero, start_c, out_len);
    if (L == 8) {
      reinterpret_cast<uint2*>(out)[i] = make_uint2(r.x, r.y);
    } else if (L == 4) {
      reinterpret_cast<unsigned*>(out)[i] = r.x;
    } else if (L == 2) {
      reinterpret_cast<unsigned short*>(out)[i] = (unsigned short)r.x;
    } else {
      out[i] = (uint8_t)r.x;
    }
    out_lens[i] = out_len;
  }
}

// Blocks for a grid-stride launch of ``work`` threads: at most 8 a
// streaming multiprocessor.
int grid_blocks(long long work) {
  static int sms_of[64];  // per device, once
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
  return (int)std::min<long long>((work + THREADS - 1) / THREADS, 8ll * sms);
}

}  // namespace

extern "C" {

// chars: uint8[n, L], 16-byte aligned; lens: int32[n]; needle: m bytes
// in HOST memory, 1 <= m <= L <= 512, L a power of two; kind 0 starts,
// 1 ends, 2 contains; out: bool[n]. The needle travels in the launch's
// parameters: one launch, no copy.
int srt_k4_match_table(const void* chars, const void* lens, int n, int L,
                       const void* needle, int m, int kind, void* out,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > MAX_NEEDLE || m > L || (L & (L - 1)) != 0 ||
      ((uintptr_t)chars & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  K4Needle p;
  memset(&p, 0, sizeof(p));
  memcpy(p.bytes, needle, (size_t)m);
  for (int k = 0; k < m && k < 64; ++k)
    p.table[((const uint8_t*)needle)[k]] |= 1ull << k;
  p.m = m;
  p.kind = kind;
  // a thread a row up to L = 64, a group of L / 16 lanes a row past it
  const int blocks = grid_blocks((long long)n * (L <= 64 ? 1 : L / 16));
  const uint8_t* c = (const uint8_t*)chars;
  const int* ln = (const int*)lens;
  uint8_t* o = (uint8_t*)out;
  switch (L) {
#define K4_ROWS(LL) \
  case LL:          \
    k4_rows<LL><<<blocks, THREADS, 0, s>>>(c, ln, n, p, o); \
    break;
#define K4_GROUPS(LL) \
  case LL:            \
    k4_groups<LL><<<blocks, THREADS, 0, s>>>(c, ln, n, p, o); \
    break;
    K4_ROWS(1) K4_ROWS(2) K4_ROWS(4) K4_ROWS(8) K4_ROWS(16) K4_ROWS(32)
    K4_ROWS(64) K4_GROUPS(128) K4_GROUPS(256) K4_GROUPS(512)
#undef K4_ROWS
#undef K4_GROUPS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// chars: uint8[n, L], 16-byte aligned; lens: int32[n]; the parsed
// pattern in HOST memory: body (nbytes bytes, the non-empty segments
// concatenated), wild (nbytes flags: the byte is '_'), seg_lens (int32
// [nseg], each >= 1, summing to nbytes <= L <= 512), whether the first
// segment is anchored at byte 0 and the last at the end, exact_len (-1 for
// none); out: bool[n]. The pattern travels in the launch's parameters:
// one launch, no copy.
int srt_k5_like_table(const void* chars, const void* lens, int n, int L,
                      const void* body, const void* wild, int nbytes,
                      const void* seg_lens, int nseg, int first_prefix,
                      int last_suffix, int exact_len, void* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (nseg < 0 || nbytes < nseg || nbytes > L || L > MAX_NEEDLE ||
      (L & (L - 1)) != 0 || ((uintptr_t)chars & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  K5Pattern p;
  memset(&p, 0, sizeof(p));
  const uint8_t* b = (const uint8_t*)body;
  const uint8_t* w = (const uint8_t*)wild;
  memcpy(p.body, b, (size_t)nbytes);
  for (int k = 0; k < nbytes; ++k) {
    if (w[k]) p.wild[k >> 6] |= 1ull << (k & 63);
    if (k >= 64) continue;
    if (w[k]) {
      for (int c = 0; c < 256; ++c) p.table[c] |= 1ull << k;
    } else {
      p.table[b[k]] |= 1ull << k;
    }
  }
  int at = 0;
  for (int g = 0; g < nseg; ++g) {
    const int m = ((const int*)seg_lens)[g];
    if (m < 1 || at + m > nbytes) return (int)cudaErrorInvalidValue;
    p.starts[at >> 6] |= 1ull << (at & 63);
    p.ends[(at + m - 1) >> 6] |= 1ull << ((at + m - 1) & 63);
    at += m;
  }
  if (at != nbytes) return (int)cudaErrorInvalidValue;
  p.nbytes = nbytes;
  p.nseg = nseg;
  p.first_prefix = first_prefix;
  p.last_suffix = last_suffix;
  p.exact_len = exact_len;
  const int blocks = grid_blocks(n);
  const uint8_t* c = (const uint8_t*)chars;
  const int* ln = (const int*)lens;
  uint8_t* o = (uint8_t*)out;
  if (nbytes > 64) {
    k5_like_bytes<<<blocks, THREADS, 0, s>>>(c, ln, n, L, p, o);
    return (int)cudaGetLastError();
  }
  switch (L) {
#define K5_ROWS(LL)                                                         \
  case LL:                                                                  \
    if (nbytes <= 32)                                                       \
      k5_like_rows<unsigned, LL><<<blocks, THREADS, 0, s>>>(c, ln, n, p, o); \
    else                                                                    \
      k5_like_rows<unsigned long long, LL><<<blocks, THREADS, 0, s>>>(      \
          c, ln, n, p, o);                                                  \
    break;
    K5_ROWS(1) K5_ROWS(2) K5_ROWS(4) K5_ROWS(8) K5_ROWS(16) K5_ROWS(32)
    K5_ROWS(64) K5_ROWS(128) K5_ROWS(256) K5_ROWS(512)
#undef K5_ROWS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// chars: uint8[n, L], 16-byte aligned; lens: int32[n]; out: uint8[n, L];
// out_lens: int32[n]. has_length 0 means "to the end" (length is then
// ignored).
int srt_k6_substring(const void* chars, const void* lens, int n, int L,
                     long long pos, long long length, int has_length,
                     void* out, void* out_lens, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (L < 1 || L > MAX_NEEDLE || (L & (L - 1)) != 0 ||
      ((uintptr_t)chars & 15u) != 0 || ((uintptr_t)out & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* c = (const uint8_t*)chars;
  const int* ln = (const int*)lens;
  uint8_t* o = (uint8_t*)out;
  int* ol = (int*)out_lens;
  const long long total = L >= 16 ? (long long)n * (L / 16) : n;
  const int blocks = grid_blocks(total);
  switch (L) {
#define K6_ROWS(LL)                                                      \
  case LL:                                                               \
    k6_substring_rows<LL><<<blocks, THREADS, 0, s>>>(c, ln, n, pos, length, \
                                                     has_length, o, ol); \
    break;
#define K6_CHUNKS(LL)                                                     \
  case LL:                                                                \
    k6_substring<LL><<<blocks, THREADS, 0, s>>>(c, ln, total, pos, length, \
                                                has_length, o, ol);       \
    break;
    K6_ROWS(1) K6_ROWS(2) K6_ROWS(4) K6_ROWS(8) K6_CHUNKS(16) K6_CHUNKS(32)
    K6_CHUNKS(64) K6_CHUNKS(128) K6_CHUNKS(256) K6_CHUNKS(512)
#undef K6_ROWS
#undef K6_CHUNKS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
