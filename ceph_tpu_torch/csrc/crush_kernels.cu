// The straw2 draw of CRUSH for Hopper (sm_90a): bucket_straw2_choose
// (mapper.c:361-384) for a batch of (lane, candidate) draws.
//
// Thread t draws once from one bucket row for input x and replica r: for
// each of the row's first szi columns (columns past the bucket's size carry
// weight 0 and never win, so it stops at the size) it takes
// u = hash3(x, id, r) & 0xffff, ln = crush_ln(u) - 2^48, the quotient of ln
// by the item weight truncated toward zero (div64_s64), and keeps the first
// column whose draw is strictly greater than every earlier one.  A column of
// weight 0 draws S64_MIN, so it never beats the initial S64_MIN: it is
// skipped, and a row with no live column gives column 0, as an argmax over
// S64_MIN does.  The thread writes the winning column and, where asked, the
// item in it.
//
// It replaces the hash, crush_ln and draw of the JAX package's
// ceph_tpu/crush/jaxmap.py rule_fn (straw2_draw, an XLA function, not a
// Pallas kernel), which the port ran as ~1,000 separate torch integer passes
// over (lanes, candidates, width) tensors, each a round trip through device
// memory.  Here nothing per item leaves registers: the bucket row is read in
// place from the compiled map's dense tables, through a row index per thread
// or one row shared by all (the root), and the three crush_ln tables
// (ln._tables(), 4.1 KB) sit in shared memory.  So the kernel is bound by
// the instructions it issues: a live column takes 282 (sm_90a SASS: 214 of
// the loop body, the rjenkins hash the most of them, crush_ln, the loads
// and the compare, and 68 in the 64-bit division routine).  At the H100's
// issue rate (4 warp instructions a clock on each of 132 SMs) the 466 M
// live draws of one remap of 2^20 PGs on the 10,000-OSD map take 3.9 ms at
// the least.  PERF.md has the times.
//
// The entry returns cudaGetLastError(); it launches on the given stream and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSeed = 1315423911u;  // crush_hash_seed, hash.c:24

struct DrawArgs {
  const int32_t* x;      // input of each thread, through its strides (x0, x1)
  long long x0, x1;
  const int32_t* r;      // replica rank
  long long r0, r1;
  const int64_t* rows;   // bucket row, or nullptr: row_const for every thread
  long long w0, w1, row_const;
  const int64_t* pos;    // choose_args position, or nullptr: the bucket row's own
  long long p0, p1;
  int positions;         // weight row = row * positions + clamp(pos, 0, positions - 1)
  const int32_t* ids;    // (nb, width) hash ids
  const int64_t* wdiv;   // (weight rows, width) divisors, 1 where the weight is 0
  const uint8_t* wlive;  // (weight rows, width) weight > 0
  const int64_t* sizes;  // (nb,)
  const int64_t* items;  // (nb, width) items, read only where item != nullptr
  long long nb, width;
  int szi;
  const int64_t* rh;     // crush_ln's tables: RH, LH (129 each), LL (256)
  const int64_t* lh;
  const int64_t* ll;
  long long n, c;        // threads: n * c, thread t = (t / c, t % c)
  int64_t* col;          // (n * c,) winning column
  int64_t* item;         // (n * c,) its item, or nullptr
};

// crush_hashmix (hash.c:12-22)
__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

// crush_hash32_rjenkins1_3 (hash.c:48-59)
__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kSeed ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// crush_ln (mapper.c:248-290): 2^44 * log2(u + 1) for u in [0, 0xffff]
__device__ __forceinline__ int64_t crush_ln(uint32_t u, const int64_t* rh, const int64_t* lh,
                                            const int64_t* ll) {
  uint32_t x = u + 1;
  int shift = 0;
  if (!(x & 0x18000u)) {
    shift = __clz(x) - 16;
    x <<= shift;
  }
  const int k = (int)(x >> 8) - 128;
  // the C's x * RH wraps in 64 bits; bits 48-55 survive either way
  const int index2 = (int)(((uint64_t)x * (uint64_t)rh[k]) >> 48) & 0xff;
  return ((int64_t)(15 - shift) << 44) + ((lh[k] + ll[index2]) >> 4);
}

__global__ void __launch_bounds__(kThreads) straw2_draw_kernel(DrawArgs a) {
  __shared__ int64_t s_rh[129], s_lh[129], s_ll[256];
  for (int k = threadIdx.x; k < 256; k += kThreads) {
    if (k < 129) {
      s_rh[k] = a.rh[k];
      s_lh[k] = a.lh[k];
    }
    s_ll[k] = a.ll[k];
  }
  __syncthreads();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n * a.c) return;
  const long long i = t / a.c, j = t - i * a.c;
  const uint32_t x = (uint32_t)a.x[i * a.x0 + j * a.x1];
  const uint32_t r = (uint32_t)a.r[i * a.r0 + j * a.r1];
  long long row = a.rows ? a.rows[i * a.w0 + j * a.w1] : a.row_const;
  if (row < 0) row += a.nb;  // a negative row indexes from the end, as in torch
  long long wrow = row;
  if (a.pos) {
    long long p = a.pos[i * a.p0 + j * a.p1];
    p = p < 0 ? 0 : p > a.positions - 1 ? a.positions - 1 : p;
    wrow = row * a.positions + p;
  }
  const int32_t* ids = a.ids + row * a.width;
  const int64_t* wdiv = a.wdiv + wrow * a.width;
  const uint8_t* wlive = a.wlive + wrow * a.width;
  const long long size = a.sizes[row];
  const int end = size < a.szi ? (int)size : a.szi;
  int64_t best = INT64_MIN;
  int win = 0;
  for (int k = 0; k < end; ++k) {
    if (!wlive[k]) continue;
    const uint32_t u = hash3(x, (uint32_t)ids[k], r) & 0xffffu;
    // ln - 2^48 lies in [-2^48, 0] and the weight in [1, 2^32): the
    // quotient truncated toward zero is minus that of the magnitudes
    const uint64_t mag = (uint64_t)((1ll << 48) - crush_ln(u, s_rh, s_lh, s_ll));
    const int64_t q = -(int64_t)(mag / (uint64_t)wdiv[k]);
    if (q > best) {
      best = q;
      win = k;
    }
  }
  a.col[t] = win;
  if (a.item) a.item[t] = a.items[row * a.width + win];
}

}  // namespace

extern "C" {

int crush_straw2_draw(const int32_t* x, long long x0, long long x1, const int32_t* r,
                      long long r0, long long r1, const int64_t* rows, long long w0,
                      long long w1, long long row_const, const int64_t* pos, long long p0,
                      long long p1, int positions, const int32_t* ids, const int64_t* wdiv,
                      const uint8_t* wlive, const int64_t* sizes, const int64_t* items,
                      long long nb, long long width, int szi, const int64_t* rh,
                      const int64_t* lh, const int64_t* ll, long long n, long long c,
                      int64_t* col, int64_t* item, void* stream) {
  if (n < 0 || c < 1 || nb < 1 || szi < 1 || szi > width || (pos && positions < 1) ||
      (item && !items) || (!rows && (row_const < -nb || row_const >= nb)))
    return (int)cudaErrorInvalidValue;
  const long long threads = n * c;
  if (threads == 0) return (int)cudaGetLastError();
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const DrawArgs a{x,   x0,   x1,    r,     r0,    r1,    rows, w0, w1, row_const,
                   pos, p0,   p1,    positions,
                   ids, wdiv, wlive, sizes, items, nb,    width, szi,
                   rh,  lh,   ll,    n,     c,     col,   item};
  straw2_draw_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* crush_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
