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
// the TPU kernel: an anchored first segment compares bytes 0..m-1, an
// anchored last one the window at len-m (starting at or after the cursor),
// any other one takes its leftmost window at or after the cursor (greedy is
// exact for segments of fixed length); a pattern without % also needs the
// exact length. '_' matches one byte (the host keeps it off non-ASCII
// tables). One thread per entry; the segment table (offset, length,
// branch) and the pattern bytes (0x100 = wildcard) are copied once per
// block into shared memory sized at launch. Matched segments never
// overlap, so a pattern whose bytes exceed L matches nothing and the host
// launches nothing: the shared copy is at most (3 + 1) * 4 * 512 bytes,
// and every pattern the parser gives runs here. The TPU kernel built an
// (n, L-m+1, m) window tensor per segment under a 64 MiB budget; this one
// builds nothing and has no budget. Bound: the table's bytes (n*L + 4n
// read, n written), or the byte comparisons of this data where those are
// larger; like K4, each thread walks its own row and stops a window at its
// first mismatch and the search at its first hit.
//
// K6 replaces strings.py: substring_colv's kernel. One thread per output
// byte (entry i, byte j) computes its entry's clamped slice (Spark's
// 1-based or negative pos, optional length), writes the byte or zero
// padding, and byte 0 writes the new length. Bound: n*L bytes read and
// written plus the lengths; reads and writes are coalesced along j.
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

constexpr int LIKE_WILD = 0x100;
enum LikeMode { LIKE_PREFIX = 0, LIKE_SUFFIX = 1, LIKE_SEARCH = 2 };

__device__ __forceinline__ bool like_eq(const uint8_t* __restrict__ row,
                                        int p, const int* seg, int m) {
  for (int k = 0; k < m; ++k) {
    const int t = seg[k];
    if (t != LIKE_WILD && row[p + k] != t) return false;
  }
  return true;
}

__global__ void k5_like_table(const uint8_t* __restrict__ chars,
                              const int* __restrict__ lens, int n, int L,
                              const int* __restrict__ spec, int nseg,
                              int nbytes, int exact_len,
                              uint8_t* __restrict__ out) {
  // 3 * nseg ints of (offset, length, mode), then nbytes pattern entries
  extern __shared__ int sp[];
  const int total = 3 * nseg + nbytes;
  for (int k = threadIdx.x; k < total; k += blockDim.x) sp[k] = spec[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = chars + i * (long long)L;
  const int len = lens[i];
  const int* pat = sp + 3 * nseg;
  bool ok = true;
  int cur = 0;
  for (int s = 0; s < nseg && ok; ++s) {
    const int* seg = pat + sp[3 * s];
    const int m = sp[3 * s + 1];
    const int mode = sp[3 * s + 2];
    if (mode == LIKE_PREFIX) {
      ok = len >= m && like_eq(row, 0, seg, m);
      cur = m;
    } else if (mode == LIKE_SUFFIX) {
      ok = len - m >= cur && like_eq(row, len - m, seg, m);
      cur = len;
    } else {
      int p = cur;
      while (p + m <= len && !like_eq(row, p, seg, m)) ++p;
      ok = p + m <= len;
      cur = p + m;
    }
  }
  if (exact_len >= 0) ok = ok && len == exact_len;
  out[i] = ok ? 1 : 0;
}

__global__ void k6_substring(const uint8_t* __restrict__ chars,
                             const int* __restrict__ lens, int n, int L,
                             long long pos, long long length, int has_length,
                             uint8_t* __restrict__ out,
                             int* __restrict__ out_lens) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * L) return;
  const long long i = t / L;
  const int j = (int)(t - i * L);
  const long long len = lens[i];
  // strings.py:306-317: end derives from the unclamped start
  long long start = pos > 0 ? pos - 1 : (pos < 0 ? len + pos : 0);
  long long end = has_length ? start + length : len;
  long long start_c = start < 0 ? 0 : (start > len ? len : start);
  long long end_c = end < len ? end : len;
  end_c = end_c < 0 ? 0 : end_c;
  long long out_len = end_c - start_c;
  out_len = out_len < 0 ? 0 : out_len;
  out[t] = j < out_len ? chars[i * L + start_c + j] : 0;
  if (j == 0) out_lens[i] = (int)out_len;
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
  static int sms_of[64];  // per device, once
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
  const int rows_per_block = L <= 64 ? THREADS : THREADS / (L / 16);
  const int blocks = (int)std::min<long long>(
      ((long long)n + rows_per_block - 1) / rows_per_block, 8ll * sms);
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

// chars: uint8[n, L]; lens: int32[n]; spec: int32[3 * nseg + nbytes], the
// segments' (offset, length, mode) then the pattern entries (byte, or 0x100
// for '_'); every segment non-empty, nbytes <= L; exact_len -1 for none;
// out: bool[n].
int srt_k5_like_table(const void* chars, const void* lens, int n, int L,
                      const void* spec, int nseg, int nbytes, int exact_len,
                      void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (nseg < 0 || nbytes < nseg || nbytes > L || L > MAX_NEEDLE)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  const size_t smem = (size_t)(3 * nseg + nbytes) * sizeof(int);
  k5_like_table<<<blocks, THREADS, smem, s>>>(
      (const uint8_t*)chars, (const int*)lens, n, L, (const int*)spec, nseg,
      nbytes, exact_len, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// chars: uint8[n, L]; lens: int32[n]; out: uint8[n, L]; out_lens: int32[n].
// has_length 0 means "to the end" (length is then ignored).
int srt_k6_substring(const void* chars, const void* lens, int n, int L,
                     long long pos, long long length, int has_length,
                     void* out, void* out_lens, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const long long total = (long long)n * L;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  k6_substring<<<(unsigned)blocks, THREADS, 0, s>>>(
      (const uint8_t*)chars, (const int*)lens, n, L, pos, length, has_length,
      (uint8_t*)out, (int*)out_lens);
  return (int)cudaGetLastError();
}

}  // extern "C"
