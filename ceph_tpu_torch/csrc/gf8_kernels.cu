// GF(2^8) region product for Hopper (sm_90a): parity[i] = XOR_j M[i][j] * data[j].
//
// Both kernels apply an (m*8, k*8) GF(2) bitmatrix bm -- the bit-level lift
// of a GF(2^8) coding or decoding matrix (gf.jerasure_bitmatrix) -- to a
// batch of stripes: in (B, k, chunk) bytes, read in place through its batch
// and row strides (unit stride along the chunk), out (B, m, chunk)
// contiguous.  Column j*8+b of bm is bit b of input byte j, row i*8+l is
// bit l of output byte i.  The bitmatrix comes as the contiguous 0/1 byte
// matrix the package caches per coding matrix; each block folds it into the
// form its loop wants in shared memory, and blocks walk the byte axis in a
// loop so that fold is paid once per block, not per word.
//
// The least time for either is set by bytes moved: (k + m) * B * chunk at
// 3.35 TB/s on an H100 SXM (about 0.44 ms for 1 GiB of k=8 m=3 data).
// What holds each one back is written beside it; PERF.md has the times.
//
// Entries return cudaGetLastError(); they launch on the given stream and
// allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

int grid_for(long long items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (items + kThreads - 1) / kThreads;
  long long cap = 8LL * sms;
  return (int)(blocks < cap ? blocks : cap);
}

// K1 -- replaces ceph_tpu/ops/packed_gf.py _make_kernel (launched at :179).
//
// Four bytes per 32-bit word, as on the TPU.  An item is one word position
// read across the k input rows.  For each input column (j, b) the kernel
// builds one full-byte mask M, each byte 0xFF where bit b of that input byte
// is set: x << (7 - b) brings bit b to bit 7 of every byte, and PRMT's
// sign-replicate selectors (0xBA98) spread bit 7 over its byte.  M is shared
// by every output row i, which then takes one LOP3, acc_i ^= M & rep, where
// rep is the column byte cb = bits bm[i*8+0..7][j*8+b] replicated into the
// four byte fields.  XOR accumulates, so no carry bound applies.
//
// It is bound by integer instructions, not bytes: per item, k*8 masks at two
// instructions and k*8*m LOP3s -- 320 at k=8 m=3 (the first K1 design took
// 512: a shift, an AND, then an IMUL and an XOR per row).  2^25 items of
// 1 GiB at k=8 m=3 make 1.1e10 instructions, about 0.64 ms at the card's
// 32-bit integer rate, above the 0.44 ms byte bound.  So the design keeps
// everything but that arithmetic off the integer pipe:
//  - R output rows are a template parameter (1..8) held in registers; m <= 8
//    takes R = m (no dead rows), and every input is read once.  m > 8 goes
//    in groups of eight, and the rest in one more launch.
//  - W words per thread: W = 4 (one 16-byte load per input row, one
//    16-byte store per output row) when the base pointers, the strides and
//    the chunk are all multiples of 16 (gf8_packed_words), else W = 1.
//    Each rep word, loaded from shared memory four at a time, serves W
//    words.
//  - The next input row is loaded while the current one is computed.
//  - The rep table, m*k*8 words (32 KiB at most), is folded from the 0/1
//    bitmatrix once per block.  The grid is one resident wave (the
//    occupancy query, not a fixed 8 blocks per SM: a second partial wave
//    would double some blocks' share), and each block loops over tiles of
//    256 items, stripe by stripe: one 64-bit division per tile, 32-bit word
//    indices within a stripe.
// Limits: k <= 32, m <= 32, chunk % 4 == 0, 4-byte aligned rows.

// Each byte of the result is 0xFF where bit 7 of that byte of v is set.
__device__ __forceinline__ uint32_t byte_sign_mask(uint32_t v) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(v), "r"(0u), "r"(0xBA98u));
  return r;
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
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

// Output rows row0 .. row0 + groups*R - 1 of every stripe.
template <int R, int W>
__global__ void __launch_bounds__(kThreads)
gf8_packed_kernel(const uint8_t* __restrict__ in, long long in_sb, long long in_sk,
                  uint8_t* __restrict__ out, int k, int m, int row0, int groups,
                  unsigned nw, long long tiles, unsigned tiles_per_stripe,
                  const uint8_t* __restrict__ bm) {
  extern __shared__ uint4 rep4[];  // word (r*k + j)*8 + b, r < groups*R
  uint32_t* rep = reinterpret_cast<uint32_t*>(rep4);
  const int C = k * 8;
  for (int t = threadIdx.x; t < groups * R * C; t += blockDim.x) {
    const int r = t / C, c = t - r * C;
    const uint8_t* col = bm + (long long)(row0 + r) * 8 * C + c;
    uint32_t cb = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) cb |= (uint32_t)(col[l * C] & 1) << l;
    rep[t] = cb * 0x01010101u;
  }
  __syncthreads();
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
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t mask[4][W];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int w = 0; w < W; ++w)
              mask[q][w] = byte_sign_mask(x.w[w] << (7 - (h * 4 + q)));
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const uint4 rv = rg[2 * (r * k + j) + h];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int w = 0; w < W; ++w) acc[r][w] ^= mask[q][w] & lane(rv, q);
          }
        }
        x = next;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) store_words<W>(dst + (long long)(g * R + r) * nw, acc[r]);
    }
  }
}

struct PackedArgs {
  const uint8_t* in;
  long long in_sb, in_sk;
  uint8_t* out;
  int B, k, m;
  unsigned nw;
  const uint8_t* bm;
  cudaStream_t stream;
};

// Blocks in one resident wave of one instance at this shared-memory size
// (rows*k words of rep table): the occupancy query times the SMs, asked
// once per size and kept.  Blocks loop over tiles, so any grid is correct;
// this one fills the card once.
template <int R, int W>
cudaError_t resident_wave(size_t shm, int* blocks) {
  static std::atomic<int> known[32 * 32 + 1];
  std::atomic<int>& slot = known[shm / (8 * sizeof(uint32_t))];
  int v = slot.load(std::memory_order_relaxed);
  if (v == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf8_packed_kernel<R, W>,
                                                        kThreads, shm);
    if (e != cudaSuccess) return e;
    v = (per_sm > 0 ? per_sm : 1) * sms;
    slot.store(v, std::memory_order_relaxed);
  }
  *blocks = v;
  return cudaSuccess;
}

template <int R, int W>
cudaError_t launch_packed(const PackedArgs& a, int row0, int groups) {
  const size_t shm = (size_t)groups * R * a.k * 8 * sizeof(uint32_t);
  const unsigned nv = a.nw / W;
  const unsigned tiles_per_stripe = (nv + kThreads - 1) / kThreads;
  const long long tiles = (long long)a.B * tiles_per_stripe;
  int wave = 0;
  const cudaError_t e = resident_wave<R, W>(shm, &wave);
  if (e != cudaSuccess) return e;
  const int grid = (int)(tiles < wave ? tiles : wave);
  gf8_packed_kernel<R, W><<<grid, kThreads, shm, a.stream>>>(
      a.in, a.in_sb, a.in_sk, a.out, a.k, a.m, row0, groups, a.nw, tiles,
      tiles_per_stripe, a.bm);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_packed_rows(const PackedArgs& a, int R, int row0, int groups) {
  switch (R) {
    case 1: return launch_packed<1, W>(a, row0, groups);
    case 2: return launch_packed<2, W>(a, row0, groups);
    case 3: return launch_packed<3, W>(a, row0, groups);
    case 4: return launch_packed<4, W>(a, row0, groups);
    case 5: return launch_packed<5, W>(a, row0, groups);
    case 6: return launch_packed<6, W>(a, row0, groups);
    case 7: return launch_packed<7, W>(a, row0, groups);
    case 8: return launch_packed<8, W>(a, row0, groups);
  }
  return cudaErrorInvalidValue;
}

// K2 -- replaces ceph_tpu/ops/pallas_gf.py _kernel (launched at :60).
//
// The same product in bitplane form, without the planes: a thread owns one
// byte column n, and the k input bytes of that column ARE its k*8-bit column
// of the unpacked bit planes.  Gathered into 32-bit groups (byte j at bits
// 8*(j%4) of group j/4) they meet the bitmatrix rows, packed the same way
// into per-row masks in shared memory: output bit r is the parity of
// popc(row_r & col), which is the TPU's bf16 dot followed by & 1, exactly.
// Groups go eight at a time in registers, so there is no limit on k; a
// column's later groups XOR into the byte the first group wrote.  The ragged
// edge is masked by the loop bound, so any width works (the TPU's
// N % 4096 == 0 was a tiling artefact).
__global__ void __launch_bounds__(kThreads)
gf8_bitplane_kernel(const uint8_t* __restrict__ in, long long in_sb, long long in_sk,
                    uint8_t* __restrict__ out, int k, int m, long long chunk,
                    long long total, const uint8_t* __restrict__ bm) {
  extern __shared__ uint32_t mask[];  // mask[r*G + g], r < m*8
  const int C = k * 8, G = (k + 3) / 4;
  for (int t = threadIdx.x; t < m * 8 * G; t += blockDim.x) {
    int r = t / G, g = t - r * G;
    uint32_t v = 0;
    for (int s = 0; s < 32 && g * 32 + s < C; ++s)
      v |= (uint32_t)(bm[r * C + g * 32 + s] & 1) << s;
    mask[t] = v;
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += step) {
    const long long b = idx / chunk, n = idx - b * chunk;
    const uint8_t* src = in + b * in_sb + n;
    uint8_t* dst = out + b * m * chunk + n;
    for (int g0 = 0; g0 < G; g0 += 8) {
      uint32_t col[8];
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) {
        uint32_t v = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = (g0 + gg) * 4 + q;
          if (j < k) v |= (uint32_t)__ldg(src + j * in_sk) << (8 * q);
        }
        col[gg] = v;
      }
      for (int i = 0; i < m; ++i) {
        uint32_t byte = 0;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const uint32_t* row = mask + (i * 8 + l) * G + g0;
          uint32_t x = 0;
#pragma unroll
          for (int gg = 0; gg < 8; ++gg)
            if (g0 + gg < G) x ^= row[gg] & col[gg];
          byte |= (__popc(x) & 1u) << l;
        }
        uint8_t* o = dst + (long long)i * chunk;
        *o = g0 == 0 ? (uint8_t)byte : (uint8_t)(*o ^ byte);
      }
    }
  }
}

}  // namespace

extern "C" {

// K1's words per thread for these stripes and this output: 4 when every
// address it forms is 16-byte aligned, else 1.
int gf8_packed_words(const void* in, long long in_sb, long long in_sk, const void* out,
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
  const PackedArgs a{(const uint8_t*)in, in_sb, in_sk, (uint8_t*)out, B, k, m,
                     (unsigned)(chunk / 4), (const uint8_t*)bm, (cudaStream_t)stream};
  const bool vec = gf8_packed_words(in, in_sb, in_sk, out, chunk) == 4;
  // groups of eight rows in one launch, and the rest (m % 8) in a second
  const int full = m <= 8 ? 1 : m / 8, R = m <= 8 ? m : 8, rest = m <= 8 ? 0 : m % 8;
  cudaError_t e =
      vec ? launch_packed_rows<4>(a, R, 0, full) : launch_packed_rows<1>(a, R, 0, full);
  if (e == cudaSuccess && rest)
    e = vec ? launch_packed_rows<4>(a, rest, full * 8, 1)
            : launch_packed_rows<1>(a, rest, full * 8, 1);
  return (int)e;
}

int gf8_bitplane_stripes(const void* in, long long in_sb, long long in_sk, void* out,
                         int B, int k, int m, long long chunk, const void* bm,
                         void* stream) {
  if (k < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * chunk;
  if (total == 0) return (int)cudaGetLastError();
  const size_t shm = (size_t)m * 8 * ((k + 3) / 4) * sizeof(uint32_t);
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf8_bitplane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  gf8_bitplane_kernel<<<grid_for(total), kThreads, shm, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_sb, in_sk, (uint8_t*)out, k, m, chunk, total,
      (const uint8_t*)bm);
  return (int)cudaGetLastError();
}

const char* gf8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
