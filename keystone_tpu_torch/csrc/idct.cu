// Batched 8x8 inverse DCT of dequantised JPEG coefficient blocks.
//
// Replaces keystone_tpu/ops/jpeg_device.py::idct_blocks_pallas (the Pallas
// kernel `_idct_kernel`): for blocks x[N, 8, 8] (f32, row-major) it writes
// out[N, 8, 8] = A^T X A per block, A the orthonormal 8-point DCT-II basis
// passed in by the wrapper (jpeg_device._idct_basis, the same f32 constants
// as the plain version), with no level shift.
//
// Bound: memory.  Each block reads and writes 256 bytes and takes 2 * 512
// FMAs (two 8x8x8 products), 4 flops per byte moved, far below the card's
// ~20 f32 flop/byte ridge.  A 64-image chunk at 375x500 4:2:0 has 196,608
// luma blocks: 100.7 MB moved, about 30 us at an H100 SXM's 3.35 TB/s.
//
// Design (simple first): 64 threads per 8x8 block, four blocks per
// 256-thread CTA.  Each thread loads one coefficient, so a CTA reads 1 KB of
// contiguous memory and a warp 128 contiguous bytes.  The basis is staged in
// shared memory once per CTA.  A row pass T = A^T X (thread (i, l) sums
// A[j][i] * X[j][l] over j) goes to shared memory; a column pass T A gives
// the thread's output element, stored back coalesced.  f32 FMAs only, no
// tensor cores; the Pallas kernel's padding to tiles of 256 blocks becomes
// a bounds check on the last CTA.  Later work: fuse dequantisation, level
// shift, the block-to-plane layout, chroma upsampling and the colour
// conversion into the kernel, and vector loads.

#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 4;

__global__ void idct_kernel(const float* __restrict__ x,
                            const float* __restrict__ a,
                            float* __restrict__ out, long long n) {
  __shared__ float sa[64];
  __shared__ float sx[kBlocksPerCta][64];
  __shared__ float st[kBlocksPerCta][64];
  const int tid = threadIdx.x;
  const int local = tid >> 6;  // which of the CTA's blocks
  const int e = tid & 63;      // element (i, l) of that block
  const int i = e >> 3;
  const int l = e & 7;
  const long long b = (long long)blockIdx.x * kBlocksPerCta + local;
  const bool valid = b < n;
  if (tid < 64) sa[tid] = a[tid];
  sx[local][e] = valid ? x[b * 64 + e] : 0.f;
  __syncthreads();
  // Row pass: T[i][l] = sum_j A[j][i] * X[j][l].
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) t = fmaf(sa[j * 8 + i], sx[local][j * 8 + l], t);
  st[local][e] = t;
  __syncthreads();
  // Column pass: out[i][l] = sum_k T[i][k] * A[k][l].
  float o = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) o = fmaf(st[local][i * 8 + k], sa[k * 8 + l], o);
  if (valid) out[b * 64 + e] = o;
}

}  // namespace

// x, out: n contiguous f32 8x8 blocks; a: the 8x8 f32 basis.  Launches on
// `stream`, allocates nothing, and returns the launch's cudaError_t (0 on
// success).
extern "C" int idct_launch(const void* x, const void* a, void* out,
                           long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long ctas = (n + kBlocksPerCta - 1) / kBlocksPerCta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  idct_kernel<<<(unsigned)ctas, 64 * kBlocksPerCta, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (float*)out, n);
  return (int)cudaGetLastError();
}
