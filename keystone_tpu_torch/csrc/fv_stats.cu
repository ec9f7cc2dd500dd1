// Fisher-vector sufficient statistics in one pass over the descriptors.
//
// Replaces keystone_tpu/ops/fv_pallas.py::fv_stats_pallas (the Pallas
// kernel `_fv_stats_kernel`).  For descriptor matrices x[n, d, D] (f32,
// descriptors as columns) and a diagonal GMM of k components it computes,
// per image i,
//
//   logit[j, col] = sum_r w[r, j] * x2[r, col] + c[j]      (r < 2d)
//   q[:, col]     = softmax over j of logit[:, col], zeroed for col >= counts[i]
//   s0[i, j]      = sum_col q[j, col]
//   s1[i, r, j]   = sum_col x[r, col]   * q[j, col]
//   s2[i, r, j]   = sum_col x[r, col]^2 * q[j, col]
//
// where x2 = [x; x*x] stacks the descriptors over their squares, and the
// wrapper (ops/fv_stats.py) passes w = [mu/var; -1/(2 var)] ([2d, k]) and
// c = log w_j - (sum mu^2/var + sum log var + d log 2pi)/2 ([k]): the
// parameterisation of the Pallas kernel with the -1/2 folded into w.
//
// Bound: operations.  Per image the two contractions of each kind are
// 8*k*d*D flops plus k*D exps, against 4*d*D bytes read: at the VOC
// production shape (d=80, k=256, D=73,866) 12.1 GFLOP per image against
// 23.6 MB, about 0.18 ms at an H100 SXM's 67 TFLOP/s f32 (CUDA cores) and
// 7 us at its 3.35 TB/s.
//
// Design (simple first):
// - Grid (image, split of the D columns).  A split walks a fixed run of
//   column tiles of kTile (the caller fixes the run's length, not the
//   number of splits, so an image's sums do not depend on the batch).  Each
//   tile of x and x*x is staged in shared memory once and read by every
//   component.
// - Thread j owns component j.  It computes the tile's logits for j in
//   registers (w read through the L1/L2 cache, coalesced over j), a
//   column softmax over the components runs one warp per column in shared
//   memory, and thread j accumulates s0[j] in a register and its column of
//   [s1; s2] in shared memory (2d*k floats: 160 KB at d=80, k=256).
// - Per-split partials go to a workspace; a second kernel sums them in
//   split order, so the result is deterministic.
// What holds it back (PERF.md): each broadcast float4 read of the tile
// feeds only four FMAs of one thread, so shared-memory loads, not FMAs, set
// the pace; loading w ahead from L2 measured no gain.  Later work: a
// register tile of several components by several columns per thread, then
// tensor cores (the two contractions are GEMMs) and double-buffered tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;     // descriptor columns per tile
constexpr int kRowStep = 8;   // rows of [s1; s2] per accumulation step
constexpr int kMaxK = 256;    // one thread per component
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit

// Dynamic shared memory, in floats: xs [2d][kTile] (x then x*x), then
// acc [2d][k] (the block's running s1 and s2), then qs [k][kTile + 1]
// (logits, then posteriors; the +1 keeps the column reads conflict-free).
size_t smem_bytes(int d, int k) {
  const size_t rows = 2 * (size_t)d;
  return (rows * kTile + rows * k + (size_t)k * (kTile + 1)) * sizeof(float);
}

__global__ void __launch_bounds__(kMaxK)
fv_stats_kernel(const float* __restrict__ x, const int* __restrict__ counts,
                const float* __restrict__ w, const float* __restrict__ c,
                float* __restrict__ ws, int d, int D, int k, int splits,
                int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int rows = 2 * d;
  float* acc = xs + rows * kTile;
  float* qs = acc + rows * k;

  const int img = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nthreads / 32;
  const int j = tid;
  const bool active = j < k;
  const int count = counts != nullptr ? counts[img] : D;
  const float* xi = x + (size_t)img * d * D;
  const float cj = active ? c[j] : 0.f;

  for (int e = tid; e < rows * k; e += nthreads) acc[e] = 0.f;
  float s0 = 0.f;

  const int total_tiles = (D + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(total_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * kTile;
    __syncthreads();  // the previous tile's reads of xs and qs are done
    for (int e = tid; e < d * kTile; e += nthreads) {
      const int r = e / kTile;
      const int cc = e % kTile;
      const int col = col0 + cc;
      const float v = col < D ? xi[(size_t)r * D + col] : 0.f;
      xs[r * kTile + cc] = v;
      xs[(d + r) * kTile + cc] = v * v;
    }
    __syncthreads();

    if (active) {
      float lg[kTile];
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) lg[cc] = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float wr = __ldg(w + (size_t)r * k + j);
        const float4* xr = reinterpret_cast<const float4*>(xs + r * kTile);
#pragma unroll
        for (int c4 = 0; c4 < kTile / 4; ++c4) {
          const float4 v = xr[c4];
          lg[4 * c4 + 0] = fmaf(wr, v.x, lg[4 * c4 + 0]);
          lg[4 * c4 + 1] = fmaf(wr, v.y, lg[4 * c4 + 1]);
          lg[4 * c4 + 2] = fmaf(wr, v.z, lg[4 * c4 + 2]);
          lg[4 * c4 + 3] = fmaf(wr, v.w, lg[4 * c4 + 3]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) qs[j * (kTile + 1) + cc] = lg[cc] + cj;
    }
    __syncthreads();

    // Column softmax over the k components, masked past counts[img].
    for (int cc = warp; cc < kTile; cc += nwarps) {
      float m = -INFINITY;
      for (int jj = lane; jj < k; jj += 32) m = fmaxf(m, qs[jj * (kTile + 1) + cc]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
      for (int jj = lane; jj < k; jj += 32) {
        const float e = expf(qs[jj * (kTile + 1) + cc] - m);
        qs[jj * (kTile + 1) + cc] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const bool valid = col0 + cc < count;
      for (int jj = lane; jj < k; jj += 32) {
        float* p = qs + jj * (kTile + 1) + cc;
        *p = valid ? *p / sum : 0.f;
      }
    }
    __syncthreads();

    if (active) {
      float q[kTile];
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) {
        q[cc] = qs[j * (kTile + 1) + cc];
        s0 += q[cc];
      }
      for (int r0 = 0; r0 < rows; r0 += kRowStep) {
        float part[kRowStep];
#pragma unroll
        for (int rr = 0; rr < kRowStep; ++rr) part[rr] = 0.f;
#pragma unroll
        for (int rr = 0; rr < kRowStep; ++rr) {
          if (r0 + rr < rows) {
            const float4* xr = reinterpret_cast<const float4*>(xs + (r0 + rr) * kTile);
#pragma unroll
            for (int c4 = 0; c4 < kTile / 4; ++c4) {
              const float4 v = xr[c4];
              part[rr] = fmaf(v.x, q[4 * c4 + 0], part[rr]);
              part[rr] = fmaf(v.y, q[4 * c4 + 1], part[rr]);
              part[rr] = fmaf(v.z, q[4 * c4 + 2], part[rr]);
              part[rr] = fmaf(v.w, q[4 * c4 + 3], part[rr]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kRowStep; ++rr) {
          if (r0 + rr < rows) acc[(r0 + rr) * k + j] += part[rr];
        }
      }
    }
  }
  __syncthreads();

  // Partials of this split: [s0 (k) | s1 (d*k) | s2 (d*k)], acc's order.
  float* out = ws + ((size_t)img * splits + split) * ((size_t)k + (size_t)rows * k);
  if (active) out[j] = s0;
  for (int e = tid; e < rows * k; e += nthreads) out[k + e] = acc[e];
}

// out[i, e] = sum over splits, in split order, of ws[i, split, e].
__global__ void fv_stats_reduce(const float* __restrict__ ws,
                                float* __restrict__ out, int n, int splits,
                                int per_image) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * per_image) return;
  const size_t i = idx / per_image;
  const size_t e = idx % per_image;
  const float* p = ws + i * splits * (size_t)per_image + e;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += p[(size_t)sp * per_image];
  out[idx] = s;
}

}  // namespace

// x [n, d, D] f32; counts [n] int32 or null (all D columns valid);
// w [2d, k] and c [k] f32 (see above); out [n, k + 2dk] f32 receives
// s0 | s1 | s2 per image; workspace [n, splits, k + 2dk] f32.  Split s covers
// column tiles [s * tiles_per_split, (s + 1) * tiles_per_split).  Launches
// on `stream`, allocates nothing, and returns the first cudaError_t of the
// two launches (0 on success).
extern "C" int fv_stats_launch(const void* x, const void* counts, const void* w,
                               const void* c, void* out, void* workspace, int n,
                               int d, int D, int k, int splits,
                               int tiles_per_split, void* stream) {
  if (n <= 0 || d <= 0 || D <= 0 || k <= 0 || k > kMaxK || splits <= 0 ||
      tiles_per_split <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(d, k);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fv_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = ((k + 31) / 32) * 32;
  fv_stats_kernel<<<dim3(n, splits), threads, smem, s>>>(
      (const float*)x, (const int*)counts, (const float*)w, (const float*)c,
      (float*)workspace, d, D, k, splits, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_image = k + 2 * d * k;
  const size_t total = (size_t)n * per_image;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  fv_stats_reduce<<<blocks, 256, 0, s>>>((const float*)workspace, (float*)out, n,
                                         splits, per_image);
  return (int)cudaGetLastError();
}
