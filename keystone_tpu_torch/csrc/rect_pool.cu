// Symmetric rectify + sum-pool over the Pooler windows, one read of the
// activations, with the Convolver's per-element epilogue optionally fused in.
//
// Replaces keystone_tpu/ops/rect_pool_pallas.py::rect_pool_pallas (the
// Pallas kernel `_kernel`).  Two entries share one pooling body:
//
// * rect_pool_launch: activations z[N, oh, ow, F] (NHWC, bf16 or f32), as
//   the Pallas kernel takes them;
// * conv_rect_pool_launch: the Convolver's raw terms, cuDNN's f32 output
//   conv[N, oh, ow, F], the per-pixel mu and sigma [N, oh, ow] and the
//   per-filter fsum and fmd [F], from which each element's activation is
//   z = ((conv - mu*fsum[c]) / sigma) - fmd[c], in the PyTorch epilogue's
//   operation order with IEEE round-to-nearest intrinsics (nvcc would
//   otherwise contract conv - mu*fsum into an FMA and change the bits), then
//   rounded to bf16 when the featurizer keeps bf16 activations.  mu/sigma
//   absent: no patch normalisation; fmd absent: no whitener means.  On the
//   TPU the Pallas custom call stopped XLA from fusing this epilogue and the
//   cast into the consumer; here the kernel is the consumer.
//
// Both write out[N, npools, 2, F] in f32, i.e. the unfused element order
// [N, npools*2F]: position-major, then the pos block, then the neg block,
// where pos = max(max_val, z - alpha), neg = max(max_val, -z - alpha), each
// summed over the window of its pool position.  Windows start at p*stride
// and span pool_size pixels (even) or 2*(pool_size/2) (odd), truncated at
// the high edge.
//
// Bound: memory.  At the production chunk the fused entry reads conv
// [2048, 27, 27, 100] f32 (597 MB) plus mu and sigma (12 MB) and writes
// 6.6 MB: about 0.184 ms at an H100 SXM's 3.35 TB/s.  About ten flops per
// element stay under the f32 rate, but the IEEE division is a dozen
// instructions with a branch, so issue competes with the loads.
//
// Design: one block per (image, pool window, chunk of at most 256
// channels); within it each thread owns a fixed group of 4 channels (one
// 16-byte load of f32, 8 bytes of bf16) and one of `lanes` pixel lanes, and
// walks the window's pixels lane by lane, keeping 2 signs x 4 channels in
// registers.  F = 100 gives 25 groups x 10 lanes, every lane busy.  A
// thread first loads the raw words of its next few pixels (conv, mu and
// sigma), then runs the epilogue on them, so its loads are in flight
// together; two pixels for the fused entry (more registers cost the
// occupancy that hides the division), four for rect_pool.  The lanes'
// partial sums are combined in shared memory in lane order, so every sum
// has a fixed order that depends on the geometry only, never on the batch.
// The overlap of neighbouring windows (one row and one column at the
// production shape) is read again by the neighbouring block, which runs
// next to it and finds the row in L2.  F not a multiple of 4, or a
// misaligned pointer, takes the same body with one channel per group.
// Tried and dropped: a per-thread cp.async ring through shared memory (no
// gain: the loads were not the wait) and a reciprocal-based division that
// is bit-equal to __fdiv_rn (no gain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 64;  // channel groups per block
constexpr int kThreads = 256;   // target threads per block

struct Geometry {
  int oh, ow, f;       // activations [n, oh, ow, f]
  int stride, span;    // pool windows
  int npx, npools;     // windows along x, in all
  int groups, gb;      // channel groups in all, per block
  int chunks, lanes;   // channel chunks per window, pixel lanes per block
};

// The raw words of one pixel's VEC channels (and, for the Convolver's
// terms, its mu and sigma), loaded in one vector access: the loads of all
// a thread's pixels go out before any arithmetic waits on them.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Words {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_words(const T* p, Words<T, VEC>& w) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<float4*>(w.v) = *reinterpret_cast<const float4*>(p);
  } else if constexpr (VEC * sizeof(T) == 8) {
    *reinterpret_cast<uint2*>(w.v) = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) w.v[k] = p[k];
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rect_pool's input: the activations themselves.
template <typename T, int VEC>
struct ZSource {
  static constexpr int kUnroll = 4;  // pixels whose loads are in flight
  struct Raw {
    Words<T, VEC> z;
  };
  const T* z;
  const T* zi;  // this block's image

  __device__ void prepare(long long n, int plane, int f, int) {
    zi = z + n * plane * f;
  }
  __device__ void fetch(int, int elem, Raw& r) const {
    load_words(zi + elem, r.z);
  }
  __device__ void apply(const Raw& r, float (&v)[VEC]) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_f32(r.z.v[k]);
  }
};

// The Convolver's terms: the epilogue and the bf16 rounding per element.
template <int VEC>
struct ConvSource {
  // Two pixels in flight: more registers would cost occupancy, which the
  // epilogue's arithmetic needs to hide the loads.
  static constexpr int kUnroll = 2;
  struct Raw {
    Words<float, VEC> conv;
    float m, s;
  };
  const float* conv;
  const float* mu;     // null: no patch normalisation
  const float* sigma;
  const float* fsum;
  const float* fmd;    // null: no whitener means
  int round_bf16;
  const float* ci;     // this block's image
  const float* mi;
  const float* si;
  float fs[VEC];
  float fm[VEC];

  __device__ void prepare(long long n, int plane, int f, int c0) {
    ci = conv + n * plane * f;
    mi = mu != nullptr ? mu + n * plane : nullptr;
    si = mu != nullptr ? sigma + n * plane : nullptr;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      fs[k] = mu != nullptr ? fsum[c0 + k] : 0.f;
      fm[k] = fmd != nullptr ? fmd[c0 + k] : 0.f;
    }
  }

  __device__ void fetch(int pixel, int elem, Raw& r) const {
    load_words(ci + elem, r.conv);
    if (mi != nullptr) {
      r.m = mi[pixel];
      r.s = si[pixel];
    }
  }

  __device__ void apply(const Raw& r, float (&v)[VEC]) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = r.conv.v[k];
    if (mi != nullptr) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        v[k] = __fdiv_rn(__fsub_rn(v[k], __fmul_rn(r.m, fs[k])), r.s);
    }
    if (fmd != nullptr) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __fsub_rn(v[k], fm[k]);
    }
    if (round_bf16) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        v[k] = __bfloat162float(__float2bfloat16_rn(v[k]));
    }
  }
};

// The one pooling body.  Block b covers pool window b % npools of channel
// chunk (b / npools) % chunks of image b / (npools * chunks).
template <int VEC, typename Src>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(Src src, float* __restrict__ out, Geometry g, float alpha,
                float max_val) {
  extern __shared__ float part[];  // [lanes][2][VEC][gb]
  const int pool = blockIdx.x % g.npools;
  const int rest = blockIdx.x / g.npools;
  const int chunk = rest % g.chunks;
  const long long n = rest / g.chunks;
  const int tid = threadIdx.x;
  const int gi = tid % g.gb;
  const int lane = tid / g.gb;
  const int group = chunk * g.gb + gi;
  const int c0 = group * VEC;
  const int y0 = (pool / g.npx) * g.stride;
  const int x0 = (pool % g.npx) * g.stride;
  const int wy = min(y0 + g.span, g.oh) - y0;
  const int wx = min(x0 + g.span, g.ow) - x0;

  float pos[VEC], neg[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) pos[k] = neg[k] = 0.f;
  if (group < g.groups) {
    src.prepare(n, g.oh * g.ow, g.f, c0);
    // This lane's pixels, lane, lane + lanes, ... of the window in
    // row-major order, walked as (dy, dx) without a division per pixel.
    int dy = lane / wx;
    int dx = lane - dy * wx;
    while (dy < wy) {
      typename Src::Raw raw[Src::kUnroll];
      int live = 0;
#pragma unroll
      for (int u = 0; u < Src::kUnroll; ++u) {
        if (dy < wy) {
          const int pixel = (y0 + dy) * g.ow + x0 + dx;
          src.fetch(pixel, pixel * g.f + c0, raw[u]);
          ++live;
          dx += g.lanes;
          while (dx >= wx) {
            dx -= wx;
            ++dy;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < Src::kUnroll; ++u) {
        if (u < live) {
          float v[VEC];
          src.apply(raw[u], v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            pos[k] += fmaxf(max_val, v[k] - alpha);
            neg[k] += fmaxf(max_val, -v[k] - alpha);
          }
        }
      }
    }
  }
  const int width = VEC * g.gb;
  float* mine = part + (size_t)lane * 2 * width;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mine[k * g.gb + gi] = pos[k];
    mine[width + k * g.gb + gi] = neg[k];
  }
  __syncthreads();
  float* o = out + ((size_t)n * g.npools + pool) * 2 * g.f;
  for (int i = tid; i < 2 * width; i += blockDim.x) {
    const int sign = i / width;
    const int k = (i % width) / g.gb;
    const int gj = chunk * g.gb + i % g.gb;
    if (gj >= g.groups) continue;
    float acc = 0.f;
    for (int r = 0; r < g.lanes; ++r) acc += part[(size_t)r * 2 * width + i];
    o[sign * g.f + gj * VEC + k] = acc;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int VEC, typename Src>
int launch(const Src& src, void* out, int n, int oh, int ow, int f,
           int stride, int pool_size, float alpha, float max_val,
           void* stream) {
  const int half = pool_size / 2;
  Geometry g;
  g.oh = oh;
  g.ow = ow;
  g.f = f;
  g.stride = stride;
  g.span = (pool_size % 2 == 1) ? 2 * half : pool_size;
  if (n <= 0 || f <= 0 || oh <= 0 || ow <= 0 || stride <= 0 || g.span <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int npy = ceil_div(oh - half, stride);
  g.npx = ceil_div(ow - half, stride);
  if (npy <= 0 || g.npx <= 0) return (int)cudaErrorInvalidValue;
  g.npools = npy * g.npx;
  g.groups = f / VEC;
  g.gb = g.groups < kMaxGroups ? g.groups : kMaxGroups;
  g.chunks = ceil_div(g.groups, g.gb);
  g.lanes = kThreads / g.gb;
  if ((long long)oh * ow * f > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n * g.chunks * g.npools;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)g.lanes * 2 * VEC * g.gb * sizeof(float);
  pool_kernel<VEC, Src><<<(unsigned)blocks, g.gb * g.lanes, smem,
                          (cudaStream_t)stream>>>(src, (float*)out, g, alpha,
                                                  max_val);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

template <typename T>
int launch_z(const void* z, void* out, int n, int oh, int ow, int f,
             int stride, int pool_size, float alpha, float max_val,
             void* stream) {
  if (f % 4 == 0 && aligned(z, 4 * sizeof(T))) {
    return launch<4>(ZSource<T, 4>{(const T*)z}, out, n, oh, ow, f, stride,
                     pool_size, alpha, max_val, stream);
  }
  return launch<1>(ZSource<T, 1>{(const T*)z}, out, n, oh, ow, f, stride,
                   pool_size, alpha, max_val, stream);
}

template <int VEC>
ConvSource<VEC> conv_source(const void* conv, const void* mu,
                            const void* sigma, const void* fsum,
                            const void* fmd, int round_bf16) {
  ConvSource<VEC> s;
  s.conv = (const float*)conv;
  s.mu = (const float*)mu;
  s.sigma = (const float*)sigma;
  s.fsum = (const float*)fsum;
  s.fmd = (const float*)fmd;
  s.round_bf16 = round_bf16;
  return s;
}

}  // namespace

// z: [n, oh, ow, f]; dtype: 0 = float32, 1 = bfloat16.  Launches on
// `stream`, allocates nothing, and returns the launch's cudaError_t (0 on
// success).
extern "C" int rect_pool_launch(const void* z, void* out, int n, int oh,
                                int ow, int f, int stride, int pool_size,
                                float alpha, float max_val, int dtype,
                                void* stream) {
  if (dtype == 0) {
    return launch_z<float>(z, out, n, oh, ow, f, stride, pool_size, alpha,
                           max_val, stream);
  }
  if (dtype == 1) {
    return launch_z<__nv_bfloat16>(z, out, n, oh, ow, f, stride, pool_size,
                                   alpha, max_val, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// conv: [n, oh, ow, f] f32; mu, sigma: [n, oh, ow] f32, both null for no
// patch normalisation; fsum: [f] f32 (read only with mu); fmd: [f] f32 or
// null; round_bf16: 1 to round each activation to bf16 before pooling.
// Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 on success).
extern "C" int conv_rect_pool_launch(const void* conv, const void* mu,
                                     const void* sigma, const void* fsum,
                                     const void* fmd, void* out, int n,
                                     int oh, int ow, int f, int stride,
                                     int pool_size, float alpha,
                                     float max_val, int round_bf16,
                                     void* stream) {
  if ((mu == nullptr) != (sigma == nullptr) || (mu != nullptr && !fsum)) {
    return (int)cudaErrorInvalidValue;
  }
  if (f % 4 == 0 && aligned(conv, 16)) {
    return launch<4>(conv_source<4>(conv, mu, sigma, fsum, fmd, round_bf16),
                     out, n, oh, ow, f, stride, pool_size, alpha, max_val,
                     stream);
  }
  return launch<1>(conv_source<1>(conv, mu, sigma, fsum, fmd, round_bf16),
                   out, n, oh, ow, f, stride, pool_size, alpha, max_val,
                   stream);
}
