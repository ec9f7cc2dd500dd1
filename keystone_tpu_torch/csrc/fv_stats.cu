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
// where x2 = [x; x*x] stacks the descriptors over their squares,
// w = [mu/var; -1/(2 var)] and c = log w_j - (sum mu^2/var + sum log var +
// d log 2pi)/2: the parameterisation of the Pallas kernel with the -1/2
// folded into w.  fv_stats_prepare computes w and c from the GMM on the
// card, padded to [kRows, kMaxK] and [kMaxK] (zero rows and columns, c =
// -inf past k).  The [n, k, D] posteriors never leave the block.
//
// Bound: operations.  Per image the two contractions of each kind are
// 8*k*d*D flops plus k*D exps, against 4*d*D bytes read: at the VOC
// production shape (d=80, k=256, D=73,866) 12.1 GFLOP per image against
// 23.6 MB, about 0.18 ms at an H100 SXM's 67 TFLOP/s f32 (CUDA cores) and
// 7 us at its 3.35 TB/s.  Both contractions are f32 FMAs on the CUDA cores.
// The logits cancel (mu x/var against x^2/(2 var)), so TF32 is out for
// them; the moment contraction as three TF32 mma.sync products (hi*hi +
// hi*lo + lo*hi) was faster but put the assembled VOC features four times
// further from f64 than the plain f32 chain (s2 - 2 mu s1 + (mu^2 - var)
// s0 cancels too), so it is not used (PERF.md).
//
// Design.  The first version (one thread per component, [s1; s2] in
// shared memory) ran at 18 % of the bound: each shared-memory load fed 4
// FMAs, and 213 KB of shared memory left one block of 8 warps per SM with
// nothing to hide the plain loads of each tile.  This one:
// - One block of 256 threads per (image, split of D); a split is a fixed
//   run of tiles_per_split (set by the wrapper) 32-column tiles, short
//   enough that one image fills most of the 132 SMs.
// - The [s1; s2] accumulators, [2d, k] <= [160, 256], live in registers
//   spread over the block: thread (rg, mg) owns rows rg + 16 ii (ii < 10)
//   and components mg*4 + 64 h + e (h, e < 4), 160 floats.
// - w [160, 256] and c stay resident in shared memory (160 KB, loaded once
//   per block with 16-byte cp.async), so the logit loop reads no L2.
// - x tiles come in through 4-byte cp.async into a staging buffer while
//   the previous tile is computed (two stages: staging and x2).  4 bytes
//   because a row of x starts only 4-byte aligned for odd D (8 for
//   D = 73,866), and these are 10 copies a thread per tile against 10,240
//   FMAs; nothing pads or copies x beforehand.  x*x is formed once per
//   tile in shared memory.
// - Logits: thread (jg, lc) owns components jg*4 + 128 h + e (h < 2) by
//   columns lc + e, a register tile of 8 x 4: per row, two 16-byte loads
//   of w and one of x2 feed 32 FMAs.
// - Softmax in the same registers: maxima and sums over the thread's 8
//   components, the warp's 8 lanes of the same columns (3 shuffles) and
//   the 4 warps of the same columns (shared memory, in warp order).  __expf
//   keeps base e (ex2.approx of (l - m) log2 e); log2 e is not folded into
//   w and c, whose terms are large and cancel.  Posteriors go to shared
//   memory as [column][component]; each thread keeps its components' mass.
// - Moments: per column, ten x2 loads and four 16-byte loads of q feed 160
//   FMAs into the register accumulators.
// - No atomics.  Per-split partials go to a workspace and a second kernel
//   sums them in split order; s0's partials are summed in a fixed order.
//   So an image's statistics are the same bits whatever else is in the
//   batch (the wrapper fixes the split length, not the split count).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                 // descriptor columns per tile
constexpr int kMaxD = 80;
constexpr int kRows = 2 * kMaxD;          // rows of [x; x*x]
constexpr int kMaxK = 256;
constexpr int kXStride = kTile + 4;       // x2 row stride: a warp's two moment rows hit other banks
constexpr int kRowsPer = 10;              // moment tile: rows per thread (16 row groups)
constexpr int kRowGroups = kRows / kRowsPer;

// Shared memory, in floats: w [kRows][kMaxK], c [kMaxK], the tile's
// posteriors qt [kTile][kMaxK], x2 [kRows][kXStride], the staging buffer of
// the next tile's x [kMaxD][kTile], and per-column partial maxima and sums
// of the softmax [2][4][kTile] (four warps share a column).
constexpr int kWOff = 0;
constexpr int kCOff = kWOff + kRows * kMaxK;
constexpr int kQOff = kCOff + kMaxK;
constexpr int kXOff = kQOff + kTile * kMaxK;
constexpr int kStageOff = kXOff + kRows * kXStride;
constexpr int kRedOff = kStageOff + kMaxD * kTile;
constexpr int kSmemFloats = kRedOff + 2 * 4 * kTile;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kSmemBytes <= 232448, "227 KB is an H100 block's limit");
static_assert(kRowGroups * 16 == kThreads, "moment tile covers the block");
static_assert(kThreads == 8 * 32 && kTile == 32, "the logit tile's thread layout");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  // src-size 0 fills the destination with zero and reads nothing.
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// x[:, col0 : col0 + kTile] of one image into stage [d][kTile], zero past D.
__device__ __forceinline__ void load_tile(float* stage, const float* xi, int d, int D, int col0,
                                          int tid) {
  for (int e = tid; e < d * kTile; e += kThreads) {
    const int r = e / kTile;
    const int col = col0 + e % kTile;
    const bool valid = col < D;
    cp_async4(stage + e, valid ? xi + (size_t)r * D + col : xi, valid);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fv_stats_kernel(const float* __restrict__ x, const int* __restrict__ counts,
                const float* __restrict__ w, const float* __restrict__ c,
                float* __restrict__ ws, int d, int D, int k, int splits,
                int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w_s = sm + kWOff;
  float* cs = sm + kCOff;
  float* qt = sm + kQOff;
  float* x2 = sm + kXOff;
  float* stage = sm + kStageOff;
  float* red_max = sm + kRedOff;
  float* red_sum = red_max + 4 * kTile;

  const int img = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rows = 2 * d;
  const int rows4 = (rows + 3) & ~3;
  const int count = counts != nullptr ? counts[img] : D;
  const float* xi = x + (size_t)img * d * D;

  // Tiles past counts[img] carry no posterior mass: skip them.
  const int total_tiles = (count + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(total_tiles, t_begin + tiles_per_split);

  for (int e = tid; e < kRows * kMaxK / 4; e += kThreads) cp_async16(w_s + 4 * e, w + 4 * e);
  for (int e = tid; e < kMaxK / 4; e += kThreads) cp_async16(cs + 4 * e, c + 4 * e);
  if (t_begin < t_end) load_tile(stage, xi, d, D, t_begin * kTile, tid);
  cp_async_commit();
  // x2 rows past 2d stay zero: the moment tile reads them (and w's are zero).
  for (int e = tid; e < (kRows - rows) * kXStride; e += kThreads) x2[rows * kXStride + e] = 0.f;

  // Logit tile of thread (jg, lc); moment tile of thread (rg, mg).
  const int jg = (warp % 4) * 8 + lane % 8;
  const int lc = ((warp / 4) * 4 + lane / 8) * 4;
  const int rg = 2 * warp + lane / 16;
  const int mg = lane % 16;

  float acc[kRowsPer][16];
#pragma unroll
  for (int ii = 0; ii < kRowsPer; ++ii) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[ii][j] = 0.f;
  }
  float s0p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s0p[j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait_all();
    __syncthreads();  // stage holds tile t; the last tile's reads of x2 and qt are done
    for (int e = tid; e < d * kTile; e += kThreads) {
      const int r = e / kTile;
      const int cc = e % kTile;
      const float v = stage[e];
      x2[r * kXStride + cc] = v;
      x2[(d + r) * kXStride + cc] = v * v;
    }
    __syncthreads();  // x2 ready, stage free
    if (t + 1 < t_end) load_tile(stage, xi, d, D, (t + 1) * kTile, tid);
    cp_async_commit();

    {  // Logits: [8 components x 4 columns] per thread.
      float lg[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) lg[a][b] = 0.f;
      }
      const float* wp = w_s + jg * 4;
      const float* xp = x2 + lc;
#pragma unroll 2
      for (int r0 = 0; r0 < rows4; r0 += 4) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = r0 + rr;
          const float4 w0 = *reinterpret_cast<const float4*>(wp + r * kMaxK);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + r * kMaxK + 128);
          const float4 xv = *reinterpret_cast<const float4*>(xp + r * kXStride);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int a = 0; a < 8; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) lg[a][b] = fmaf(wv[a], xs[b], lg[a][b]);
          }
        }
      }
      // Softmax over the components of each column: over this thread's 8,
      // the warp's 8 lanes of the same columns (shuffles), then the 4 warps
      // of the same columns (shared memory, summed in warp order).
      const float4 c0 = *reinterpret_cast<const float4*>(cs + jg * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + 128 + jg * 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const int part = (warp % 4) * kTile + lc;
      float red[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        red[b] = -INFINITY;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          lg[a][b] += cv[a];
          red[b] = fmaxf(red[b], lg[a][b]);
        }
#pragma unroll
        for (int off = 1; off < 8; off *= 2) red[b] = fmaxf(red[b], __shfl_xor_sync(0xffffffffu, red[b], off));
      }
      if (lane % 8 == 0) *reinterpret_cast<float4*>(red_max + part) = make_float4(red[0], red[1], red[2], red[3]);
      __syncthreads();
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float m = fmaxf(fmaxf(red_max[lc + b], red_max[kTile + lc + b]),
                              fmaxf(red_max[2 * kTile + lc + b], red_max[3 * kTile + lc + b]));
        red[b] = 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          lg[a][b] = __expf(lg[a][b] - m);
          red[b] += lg[a][b];
        }
#pragma unroll
        for (int off = 1; off < 8; off *= 2) red[b] += __shfl_xor_sync(0xffffffffu, red[b], off);
      }
      if (lane % 8 == 0) *reinterpret_cast<float4*>(red_sum + part) = make_float4(red[0], red[1], red[2], red[3]);
      __syncthreads();
      const int col0 = t * kTile;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float sum = ((red_sum[lc + b] + red_sum[kTile + lc + b]) + red_sum[2 * kTile + lc + b]) +
                          red_sum[3 * kTile + lc + b];
        const float inv = col0 + lc + b < count ? 1.f / sum : 0.f;  // masked past counts[img]
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          lg[a][b] *= inv;
          s0p[a] += lg[a][b];
        }
        float* q = qt + (lc + b) * kMaxK + jg * 4;
        *reinterpret_cast<float4*>(q) = make_float4(lg[0][b], lg[1][b], lg[2][b], lg[3][b]);
        *reinterpret_cast<float4*>(q + 128) = make_float4(lg[4][b], lg[5][b], lg[6][b], lg[7][b]);
      }
    }
    __syncthreads();

    // Moments: [s1; s2][rows rg + 16 ii][components mg*4 + 64 h + e] += x2 * q.
    const float* xr = x2 + rg * kXStride;
    const float* qr = qt + mg * 4;
#pragma unroll 2
    for (int cc = 0; cc < kTile; ++cc) {
      float xv[kRowsPer];
#pragma unroll
      for (int ii = 0; ii < kRowsPer; ++ii) xv[ii] = xr[ii * kRowGroups * kXStride + cc];
      float qv[16];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float4 q = *reinterpret_cast<const float4*>(qr + cc * kMaxK + 64 * h);
        qv[4 * h + 0] = q.x;
        qv[4 * h + 1] = q.y;
        qv[4 * h + 2] = q.z;
        qv[4 * h + 3] = q.w;
      }
#pragma unroll
      for (int ii = 0; ii < kRowsPer; ++ii) {
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[ii][j] = fmaf(xv[ii], qv[j], acc[ii][j]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // Partials of this split: [s0 (k) | s1 (d*k) | s2 (d*k)], x2's row order.
  // s0: the mass of each logit tile's columns per component, through qt,
  // summed over the 8 column groups in order.
  float* s0w = qt + (lc / 4) * kMaxK + jg * 4;
  *reinterpret_cast<float4*>(s0w) = make_float4(s0p[0], s0p[1], s0p[2], s0p[3]);
  *reinterpret_cast<float4*>(s0w + 128) = make_float4(s0p[4], s0p[5], s0p[6], s0p[7]);
  __syncthreads();
  float* out = ws + ((size_t)img * splits + split) * ((size_t)k + (size_t)rows * k);
  if (tid < k) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kTile / 4; ++g) s += qt[g * kMaxK + tid];
    out[tid] = s;
  }
#pragma unroll
  for (int ii = 0; ii < kRowsPer; ++ii) {
    const int r = rg + kRowGroups * ii;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int comp = mg * 4 + 64 * (j / 4) + j % 4;
        if (comp < k) out[k + (size_t)r * k + comp] = acc[ii][j];
      }
    }
  }
}

// params = [w (kRows x kMaxK) | c (kMaxK)] from the GMM, as the plain
// version's _logit_terms computes them: block r < kRows fills row r of w,
// block kRows fills c; zero past 2d rows and k columns, c = -inf past k.
__global__ void fv_stats_prepare_kernel(const float* __restrict__ means,
                                        const float* __restrict__ variances,
                                        const float* __restrict__ weights,
                                        float* __restrict__ params, int d, int k) {
  const int r = blockIdx.x;
  const int j = threadIdx.x;
  if (r < kRows) {
    float v = 0.f;
    if (j < k && r < d) v = means[r * k + j] * (1.f / variances[r * k + j]);
    if (j < k && r >= d && r < 2 * d) v = -0.5f * (1.f / variances[(r - d) * k + j]);
    params[r * kMaxK + j] = v;
    return;
  }
  float cj = -INFINITY;
  if (j < k) {
    float quad = 0.f;
    float logdet = 0.f;
    for (int i = 0; i < d; ++i) {
      const float m = means[i * k + j];
      const float var = variances[i * k + j];
      quad += m * m * (1.f / var);
      logdet += logf(var);
    }
    cj = logf(weights[j]) - 0.5f * (quad + logdet + d * 1.8378770664093453f);  // log(2 pi)
  }
  params[kRows * kMaxK + j] = cj;
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

// means, variances [d, k] and weights [k] f32 -> params [kRows * kMaxK +
// kMaxK] f32 (w and c, padded).  Returns the cudaError_t of the launch.
extern "C" int fv_stats_prepare(const void* means, const void* variances, const void* weights,
                                void* params, int d, int k, void* stream) {
  if (d <= 0 || d > kMaxD || k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  fv_stats_prepare_kernel<<<kRows + 1, kMaxK, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)variances, (const float*)weights, (float*)params, d, k);
  return (int)cudaGetLastError();
}

// x [n, d, D] f32; counts [n] int32 or null (all D columns valid); params
// from fv_stats_prepare; out [n, k + 2dk] f32 receives s0 | s1 | s2 per
// image; workspace [n, splits, k + 2dk] f32.  Split s covers column tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split).  Launches on `stream`,
// allocates nothing, and returns the first cudaError_t of the two launches
// (0 on success).
extern "C" int fv_stats_launch(const void* x, const void* counts, const void* params,
                               void* out, void* workspace, int n, int d, int D, int k,
                               int splits, int tiles_per_split, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || D <= 0 || k <= 0 || k > kMaxK || splits <= 0 ||
      tiles_per_split <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fv_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = (const float*)params;
  fv_stats_kernel<<<dim3(n, splits), kThreads, kSmemBytes, s>>>(
      (const float*)x, (const int*)counts, w, w + kRows * kMaxK, (float*)workspace, d, D, k,
      splits, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_image = k + 2 * d * k;
  const size_t total = (size_t)n * per_image;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  fv_stats_reduce<<<blocks, 256, 0, s>>>((const float*)workspace, (float*)out, n,
                                         splits, per_image);
  return (int)cudaGetLastError();
}
