// GF(2^8) region product for Hopper (sm_90a): parity[i] = XOR_j M[i][j] * data[j].
//
// Both kernels apply an (m*8, k*8) GF(2) bitmatrix bm -- the bit-level lift
// of a GF(2^8) coding or decoding matrix (gf.jerasure_bitmatrix) -- to a
// batch of stripes: in (B, k, chunk) bytes, read in place through its batch
// and row strides (unit stride along the chunk), out (B, m, chunk)
// contiguous.  Column j*8+b of bm is bit b of input byte j, row i*8+l is
// bit l of output byte i.  The bitmatrix comes as the contiguous 0/1 byte
// matrix the package caches per coding matrix; each block folds it into the
// form its loop wants in shared memory, and blocks walk the byte axis with a
// grid-stride loop so that fold is paid once per block, not per word.
//
// Both are bound by bytes moved: (k + m) * B * chunk at 3.35 TB/s on an
// H100 SXM (about 0.44 ms for 1 GiB of k=8 m=3 data).  Each thread reads its
// inputs once per group of output rows, with neighbouring threads on
// neighbouring addresses, writes each output once, and keeps the arithmetic
// in registers and shared memory; neither kernel is yet near that bound
// (PERF.md has the times).
//
// Entries return cudaGetLastError(); they launch on the given stream and
// allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kLsb = 0x01010101u;

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
// Four bytes per 32-bit lane, as on the TPU: (x >> b) & 0x01010101 holds
// bit b of the four bytes, one 0/1 per byte field.  Where the TPU unrolls
// one ADD-chain per output bit for each matrix, this kernel multiplies that
// plane by the column byte cb = bits bm[i*8+0..7][j*8+b] of output block i:
// a field of 0 or 1 times a byte never carries into the next field, so one
// multiply deposits all 8 output bits of the four bytes at once, and XOR
// (not ADD) accumulates them, so no popcount bound applies.  The work per
// 32-bit word is k*8 shift/ands plus k*m*8 multiply/XORs, uniform across the
// warp, for any matrix.  Output rows go four at a time so the accumulators
// stay in registers for any m <= 32; inputs are re-read (from L1/L2) once
// per group of four rows.  Limits: k <= 32, m <= 32, chunk % 4 == 0, and
// 4-byte aligned rows.
__global__ void __launch_bounds__(kThreads)
gf8_packed_kernel(const uint8_t* __restrict__ in, long long in_sb, long long in_sk,
                  uint8_t* __restrict__ out, int k, int m, long long nw,
                  long long total, const uint8_t* __restrict__ bm) {
  extern __shared__ uint32_t cb[];  // cb[i*C + c], C = k*8
  const int C = k * 8;
  for (int t = threadIdx.x; t < m * C; t += blockDim.x) {
    int i = t / C, c = t - i * C;
    uint32_t v = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) v |= (uint32_t)(bm[(i * 8 + l) * C + c] & 1) << l;
    cb[t] = v;
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += step) {
    const long long b = idx / nw, w = idx - b * nw;
    const uint8_t* src = in + b * in_sb + w * 4;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out) + b * m * nw + w;
    for (int i0 = 0; i0 < m; i0 += 4) {
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < k; ++j) {
        const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(src + j * in_sk));
        const uint32_t* col = cb + i0 * C + j * 8;
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const uint32_t p = (x >> bit) & kLsb;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (i0 + r < m) acc[r] ^= p * col[r * C + bit];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r < m) dst[(long long)(i0 + r) * nw] = acc[r];
    }
  }
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

int gf8_packed_stripes(const void* in, long long in_sb, long long in_sk, void* out,
                       int B, int k, int m, long long chunk, const void* bm,
                       void* stream) {
  if (k < 1 || k > 32 || m < 1 || m > 32 || chunk % 4 || in_sb % 4 || in_sk % 4 ||
      reinterpret_cast<uintptr_t>(in) % 4 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  const long long nw = chunk / 4, total = (long long)B * nw;
  if (total == 0) return (int)cudaGetLastError();
  const size_t shm = (size_t)m * k * 8 * sizeof(uint32_t);
  gf8_packed_kernel<<<grid_for(total), kThreads, shm, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_sb, in_sk, (uint8_t*)out, k, m, nw, total,
      (const uint8_t*)bm);
  return (int)cudaGetLastError();
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
