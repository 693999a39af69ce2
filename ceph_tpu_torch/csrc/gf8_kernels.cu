// GF(2^8) region product for Hopper (sm_90a): parity[i] = XOR_j M[i][j] * data[j].
//
// Both kernels apply an (m*8, k*8) GF(2) bitmatrix bm -- the bit-level lift
// of a GF(2^8) coding or decoding matrix (gf.jerasure_bitmatrix) -- to a
// batch of stripes: in (B, k, chunk) bytes, read in place through its batch
// and row strides (unit stride along the chunk), out (B, m, chunk)
// contiguous.  Column j*8+b of bm is bit b of input byte j, row i*8+l is
// bit l of output byte i.
//
// Both run one arithmetic core, accumulate_row.  For each input column
// (j, b) it builds one full-byte mask M, each byte 0xFF where bit b of that
// input byte is set: x << (7 - b) brings bit b to bit 7 of every byte, and
// PRMT's sign-replicate selectors (0xBA98) spread bit 7 over its byte.  M is
// shared by every output row i, which then takes one LOP3, acc_i ^= M & rep,
// where rep is the column byte cb = bits bm[i*8+0..7][j*8+b] replicated into
// the four byte fields.  XOR accumulates, so no carry bound applies.  Each
// block folds the rows it computes from the cached 0/1 bitmatrix into a rep
// table in shared memory (fold_rep), and the grid is one resident wave of
// blocks looping over tiles of 256 items (resident_wave: the occupancy
// query, not a fixed count per SM, since a second partial wave would double
// some blocks' share).
//
// The least time for either is set by bytes moved: (k + m) * B * chunk at
// 3.35 TB/s on an H100 SXM (about 0.44 ms for 1 GiB of k=8 m=3 data).  Per
// item of four bytes at k=8 m=3 the core issues 64 masks (a shift, which
// ptxas puts on the FMA pipe as IMAD.SHL, and a PRMT) and 192 LOP3s: 256
// integer-pipe instructions, about 0.51 ms for 1 GiB at the card's 32-bit
// integer rate, above the byte bound.  So both designs keep everything but
// that arithmetic off the integer pipe.  PERF.md has the times.
//
// Entries return cudaGetLastError(); they launch on the given stream and
// allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
// dynamic shared memory one block can use on an H100 (227 KB)
constexpr int kMaxShared = 232448;
// rep table bytes per (output row, input row): eight words, one per bit
constexpr int kRepBytes = 8 * sizeof(uint32_t);

// Each byte of the result is 0xFF where bit 7 of that byte of v is set.
__device__ __forceinline__ uint32_t byte_sign_mask(uint32_t v) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(v), "r"(0u), "r"(0xBA98u));
  return r;
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Output rows row0 .. row0 + rows - 1 into the rep table: word
// (r*k + j)*8 + b is the column byte of (row0 + r, j, b) in all four fields.
__device__ __forceinline__ void fold_rep(uint32_t* rep, const uint8_t* __restrict__ bm,
                                         int row0, int rows, int k) {
  const int C = k * 8;
  for (int t = threadIdx.x; t < rows * C; t += blockDim.x) {
    const int r = t / C, c = t - r * C;
    const uint8_t* col = bm + (long long)(row0 + r) * 8 * C + c;
    uint32_t cb = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) cb |= (uint32_t)(col[l * C] & 1) << l;
    rep[t] = cb * 0x01010101u;
  }
  __syncthreads();
}

// The core: the W words x of input row j into the R output rows in acc.
// rep_j is row 0's pair of uint4 (bits 0-3, 4-7) for input row j; row r's
// pair lies 2*r*k further on.  Each rep uint4, one shared-memory load,
// serves all W words.
template <int R, int W>
__device__ __forceinline__ void accumulate_row(uint32_t (&acc)[R][W], const uint32_t (&x)[W],
                                               const uint4* rep_j, int k) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t mask[4][W];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < W; ++w) mask[q][w] = byte_sign_mask(x[w] << (7 - (h * 4 + q)));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint4 rv = rep_j[2 * r * k + h];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[r][w] ^= mask[q][w] & lane(rv, q);
    }
  }
}

template <int W>
struct Words {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Words<W> load_words(const uint8_t* p) {
  Words<W> x;
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x.w[0] = v.x;
    x.w[1] = v.y;
    x.w[2] = v.z;
    x.w[3] = v.w;
  } else {
    x.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  return x;
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&a)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
  else
    *p = a[0];
}

// K1 -- replaces ceph_tpu/ops/packed_gf.py _make_kernel (launched at :179).
//
// Four bytes per 32-bit word, as on the TPU.  An item is W words read
// across the k input rows, through the core above: 320 instructions per
// word at k=8 m=3 (the first K1 design took 512: a shift, an AND, then an
// IMUL and an XOR per row).
//  - R output rows are a template parameter (1..8) held in registers; m <= 8
//    takes R = m (no dead rows), and every input is read once.  m > 8 goes
//    in groups of eight, and the rest in one more launch.
//  - W words per thread: W = 4 (one 16-byte load per input row, one
//    16-byte store per output row) when the base pointers, the strides and
//    the chunk are all multiples of 16 (gf8_words_per_thread), else W = 1.
//  - The next input row is loaded while the current one is computed.
//  - The rep table holds every group's rows, m*k*8 words (32 KiB at most).
//    Each block loops over tiles, stripe by stripe: one 64-bit division per
//    tile, 32-bit word indices within a stripe.
// Limits: k <= 32, m <= 32, chunk % 4 == 0, 4-byte aligned rows.
//
// Output rows row0 .. row0 + groups*R - 1 of every stripe.
template <int R, int W>
__global__ void __launch_bounds__(kThreads)
gf8_packed_kernel(const uint8_t* __restrict__ in, long long in_sb, long long in_sk,
                  uint8_t* __restrict__ out, int k, int m, int row0, int groups,
                  unsigned nw, long long tiles, unsigned tiles_per_stripe,
                  const uint8_t* __restrict__ bm) {
  extern __shared__ uint4 rep4[];  // word (r*k + j)*8 + b, r < groups*R
  fold_rep(reinterpret_cast<uint32_t*>(rep4), bm, row0, groups * R, k);
  const unsigned nv = nw / W;  // items of W words per row
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / tiles_per_stripe;
    const unsigned v = (unsigned)(t - b * tiles_per_stripe) * kThreads + threadIdx.x;
    if (v >= nv) continue;
    const uint8_t* src = in + b * in_sb + (long long)v * (4 * W);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out) + (b * m + row0) * (long long)nw +
                    (long long)v * W;
    for (int g = 0; g < groups; ++g) {
      const uint4* rg = rep4 + 2 * g * R * k;  // two uint4 per (row, j)
      uint32_t acc[R][W];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[r][w] = 0u;
      Words<W> x = load_words<W>(src);
      for (int j = 0; j < k; ++j) {
        Words<W> next = x;
        if (j + 1 < k) next = load_words<W>(src + (j + 1) * in_sk);
        accumulate_row<R, W>(acc, x.w, rg + 2 * j, k);
        x = next;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) store_words<W>(dst + (long long)(g * R + r) * nw, acc[r]);
    }
  }
}

// K2 -- replaces ceph_tpu/ops/pallas_gf.py _kernel (launched at :60).
//
// What K2 keeps from the TPU kernel is the bitmatrix product: (m*8, k*8)
// 0/1 bits times the k*8 bit planes of a tile, & 1, repacked into bytes.
// The planes, the per-bit popcounts and the bf16 dot do not pay on this
// card.  Every route needs one AND-XOR per (output bit, input bit, byte
// column), 32 of them to a LOP3, so 2*m*k LOP3s per byte column (48 at k=8
// m=3); routes differ in the cost of getting into and out of that form:
//  - the core above (K1's form): the masks cost 16*k instructions per four
//    columns, and no repack, since the outputs are already bytes;
//  - a 32-column bit-sliced form: an 8x32 bit transpose in and out, about
//    40 to 60 instructions per column at k=8 m=3;
//  - int8 mma: unpacking nibbles into 0/1 bytes, then parity and repack,
//    about 70 to 80 integer instructions per column before any tensor-core
//    work (and b1 mma is not among the H100's tensor-core types);
//  - one popcount per output bit, as the first K2 did: each thread
//    gathered one column's k bytes into 32-bit groups, and per output bit
//    ran eight shared-load/AND/XOR steps (mostly dead at k=8), one POPC, an
//    AND, a shift and an OR, with single-byte loads and stores: several
//    hundred instructions per column.
// So K2 takes the core, and keeps its own contract, which is wider than K1's:
//  - any chunk and any byte alignment of the rows.  W = 4 (16 bytes a
//    thread) where the base pointers, both strides and the chunk are
//    16-byte multiples, as K1's.  Else W = 1: four byte columns a thread,
//    the word built with PRMT from the aligned words that cover it
//    (load_any), stored as one word where the output row is word-aligned,
//    else as bytes (store_any); the ragged edge is masked by the loop bound.
//  - any k and m: R rows (1..8) per launch, in registers; the rep table
//    holds only those R*k*8 words, so k <= 7264 always fits (every code of
//    GF(2^8) has k + m <= 256), and m > R takes one launch per group.
// Per item at k=8 m=3 it issues what K1 does: 256 integer-pipe instructions
// per four columns (64 per byte column), plus at W = 1 one PRMT per input
// row and a second load where the row is not word-aligned.

// Four bytes from any address p, of which the first n (1..4) are the
// tensor's, built with PRMT from the aligned words that cover them.  Only
// an aligned word holding one of those n bytes is read, and such a word
// lies inside the tensor's allocation: CUDA allocations are at least
// 256-byte aligned, and PyTorch's allocator rounds their sizes up to
// multiples of 512 bytes.
__device__ __forceinline__ uint32_t load_any(const uint8_t* p, int n) {
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(p) & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - a);
  const uint32_t lo = __ldg(w);
  const uint32_t hi = a + n > 4 ? __ldg(w + 1) : lo;
  return __byte_perm(lo, hi, 0x3210u + 0x1111u * a);
}

// The first n bytes of v to p: one word where p is word-aligned and n = 4.
__device__ __forceinline__ void store_any(uint8_t* p, uint32_t v, int n) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
  for (int q = 0; q < n; ++q) p[q] = (uint8_t)(v >> (8 * q));
}

// K2's item: 16 bytes at a 16-byte aligned p (W = 4), or the first n bytes
// at any p (W = 1).
template <int W>
__device__ __forceinline__ Words<W> load_item(const uint8_t* p, int n) {
  if constexpr (W == 4) {
    return load_words<4>(p);
  } else {
    Words<1> x;
    x.w[0] = load_any(p, n);
    return x;
  }
}

template <int W>
__device__ __forceinline__ void store_item(uint8_t* p, const uint32_t (&a)[W], int n) {
  if constexpr (W == 4)
    store_words<4>(reinterpret_cast<uint32_t*>(p), a);
  else
    store_any(p, a[0], n);
}

// Output rows row0 .. row0 + R - 1 of every stripe.
template <int R, int W>
__global__ void __launch_bounds__(kThreads)
gf8_bitplane_kernel(const uint8_t* __restrict__ in, long long in_sb, long long in_sk,
                    uint8_t* __restrict__ out, int k, int m, int row0, long long chunk,
                    long long tiles, long long tiles_per_stripe,
                    const uint8_t* __restrict__ bm) {
  extern __shared__ uint4 rep4[];  // word (r*k + j)*8 + b, r < R
  fold_rep(reinterpret_cast<uint32_t*>(rep4), bm, row0, R, k);
  const long long nv = W == 4 ? chunk / 16 : (chunk + 3) / 4;  // items per row
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / tiles_per_stripe;
    const long long v = (t - b * tiles_per_stripe) * kThreads + threadIdx.x;
    if (v >= nv) continue;
    const long long left = chunk - v * (4 * W);
    const int n = left < 4 * W ? (int)left : 4 * W;  // bytes of this item in the row
    const uint8_t* src = in + b * in_sb + v * (4 * W);
    uint8_t* dst = out + (b * m + row0) * chunk + v * (4 * W);
    uint32_t acc[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[r][w] = 0u;
    Words<W> x = load_item<W>(src, n);
    for (int j = 0; j < k; ++j) {
      Words<W> next = x;
      if (j + 1 < k) next = load_item<W>(src + (j + 1) * in_sk, n);
      accumulate_row<R, W>(acc, x.w, rep4 + 2 * j, k);
      x = next;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) store_item<W>(dst + r * chunk, acc[r], n);
  }
}

struct StripeArgs {
  const uint8_t* in;
  long long in_sb, in_sk;
  uint8_t* out;
  int B, k, m;
  long long chunk;
  const uint8_t* bm;
  cudaStream_t stream;
};

// Blocks in one resident wave of one kernel instance at this shared-memory
// size: the occupancy query times the SMs, asked once per size and kept in
// the instance's table `known` (one slot per kRepBytes of shared memory).
// Blocks loop over tiles, so any grid is correct; this one fills the card
// once.  Above 48 KB the instance is first allowed the card's full dynamic
// shared memory.
template <typename Kernel>
cudaError_t resident_wave(Kernel kernel, std::atomic<int>* known, size_t shm, int* blocks) {
  std::atomic<int>& slot = known[shm / kRepBytes];
  int v = slot.load(std::memory_order_relaxed);
  if (v == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && shm > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shm);
    if (e != cudaSuccess) return e;
    v = (per_sm > 0 ? per_sm : 1) * sms;
    slot.store(v, std::memory_order_relaxed);
  }
  *blocks = v;
  return cudaSuccess;
}

enum class Kind { kPacked, kBitplane };

// One launch of K1 (groups of R rows from row0) or K2 (R rows from row0,
// groups == 1).
template <Kind K, int R, int W>
cudaError_t launch(const StripeArgs& a, int row0, int groups) {
  static std::atomic<int> known[kMaxShared / kRepBytes + 1];
  const size_t shm = (size_t)groups * R * a.k * kRepBytes;
  const long long nv = W == 4 ? a.chunk / 16 : (a.chunk + 3) / 4;  // items per row
  const long long tiles_per_stripe = (nv + kThreads - 1) / kThreads;
  const long long tiles = (long long)a.B * tiles_per_stripe;
  int wave = 0;
  cudaError_t e;
  if constexpr (K == Kind::kPacked)
    e = resident_wave(gf8_packed_kernel<R, W>, known, shm, &wave);
  else
    e = resident_wave(gf8_bitplane_kernel<R, W>, known, shm, &wave);
  if (e != cudaSuccess) return e;
  const int grid = (int)(tiles < wave ? tiles : wave);
  if constexpr (K == Kind::kPacked)
    gf8_packed_kernel<R, W><<<grid, kThreads, shm, a.stream>>>(
        a.in, a.in_sb, a.in_sk, a.out, a.k, a.m, row0, groups, (unsigned)(a.chunk / 4), tiles,
        (unsigned)tiles_per_stripe, a.bm);
  else
    gf8_bitplane_kernel<R, W><<<grid, kThreads, shm, a.stream>>>(
        a.in, a.in_sb, a.in_sk, a.out, a.k, a.m, row0, a.chunk, tiles, tiles_per_stripe, a.bm);
  return cudaGetLastError();
}

template <Kind K, int W>
cudaError_t launch_rows(const StripeArgs& a, int R, int row0, int groups) {
  switch (R) {
    case 1: return launch<K, 1, W>(a, row0, groups);
    case 2: return launch<K, 2, W>(a, row0, groups);
    case 3: return launch<K, 3, W>(a, row0, groups);
    case 4: return launch<K, 4, W>(a, row0, groups);
    case 5: return launch<K, 5, W>(a, row0, groups);
    case 6: return launch<K, 6, W>(a, row0, groups);
    case 7: return launch<K, 7, W>(a, row0, groups);
    case 8: return launch<K, 8, W>(a, row0, groups);
  }
  return cudaErrorInvalidValue;
}

template <Kind K>
cudaError_t launch_rows(const StripeArgs& a, bool vec, int R, int row0, int groups) {
  return vec ? launch_rows<K, 4>(a, R, row0, groups) : launch_rows<K, 1>(a, R, row0, groups);
}

}  // namespace

extern "C" {

// Words per thread either kernel takes for these stripes and this output:
// 4 when every address it forms is 16-byte aligned, else 1.
int gf8_words_per_thread(const void* in, long long in_sb, long long in_sk, const void* out,
                         long long chunk) {
  const unsigned long long any =
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
      (unsigned long long)in_sb | (unsigned long long)in_sk | (unsigned long long)chunk;
  return any % 16 == 0 ? 4 : 1;
}

int gf8_packed_stripes(const void* in, long long in_sb, long long in_sk, void* out,
                       int B, int k, int m, long long chunk, const void* bm,
                       void* stream) {
  if (k < 1 || k > 32 || m < 1 || m > 32 || B < 0 || chunk < 0 || chunk % 4 ||
      chunk / 4 > 0x7fffffffLL || in_sb % 4 || in_sk % 4 ||
      reinterpret_cast<uintptr_t>(in) % 4 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || chunk == 0) return (int)cudaGetLastError();
  const StripeArgs a{(const uint8_t*)in, in_sb, in_sk, (uint8_t*)out, B, k, m,
                     chunk, (const uint8_t*)bm, (cudaStream_t)stream};
  const bool vec = gf8_words_per_thread(in, in_sb, in_sk, out, chunk) == 4;
  // groups of eight rows in one launch, and the rest (m % 8) in a second
  const int full = m <= 8 ? 1 : m / 8, R = m <= 8 ? m : 8, rest = m <= 8 ? 0 : m % 8;
  cudaError_t e = launch_rows<Kind::kPacked>(a, vec, R, 0, full);
  if (e == cudaSuccess && rest) e = launch_rows<Kind::kPacked>(a, vec, rest, full * 8, 1);
  return (int)e;
}

// Output rows K2 computes per launch: at most 8, and no more than the rep
// table of shared memory holds (R*k*8 words); 0 where not even one fits.
int gf8_bitplane_rows(int k, int m) {
  if (k < 1 || m < 1) return 0;
  const long long fit = kMaxShared / ((long long)k * kRepBytes);
  const long long r = fit < 8 ? fit : 8;
  return (int)(r < m ? r : m);
}

int gf8_bitplane_stripes(const void* in, long long in_sb, long long in_sk, void* out,
                         int B, int k, int m, long long chunk, const void* bm,
                         void* stream) {
  const int R = gf8_bitplane_rows(k, m);
  if (R < 1 || B < 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || chunk == 0) return (int)cudaGetLastError();
  const StripeArgs a{(const uint8_t*)in, in_sb, in_sk, (uint8_t*)out, B, k, m,
                     chunk, (const uint8_t*)bm, (cudaStream_t)stream};
  const bool vec = gf8_words_per_thread(in, in_sb, in_sk, out, chunk) == 4;
  cudaError_t e = cudaSuccess;
  for (int row0 = 0; row0 < m && e == cudaSuccess; row0 += R)
    e = launch_rows<Kind::kBitplane>(a, vec, m - row0 < R ? m - row0 : R, row0, 1);
  return (int)e;
}

const char* gf8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
