// Batched 8x8 inverse DCT of dequantised JPEG coefficient blocks, and the
// whole pixel decode around it.
//
// Replaces keystone_tpu/ops/jpeg_device.py::idct_blocks_pallas (the Pallas
// kernel `_idct_kernel`).  Three entries share one IDCT device function
// (`idct_8x8`, the same summation order everywhere):
//
// * idct_launch: blocks x[N, 8, 8] (f32, row-major) -> out[N, 8, 8] =
//   A^T X A per block, A the orthonormal 8-point DCT-II basis passed in by
//   the wrapper (jpeg_device._idct_basis, the same f32 constants as the
//   plain version), with no level shift; the counterpart of the Pallas
//   kernel, same API.
// * decode_planes_launch + decode_pixels_launch: what
//   jpeg_device.decode_pixels_reference computes from the int16
//   coefficients, bit for bit, in two launches.  (a) Every component's
//   blocks in one launch: dequantise (int16 -> f32, times the image's quant
//   table), IDCT, + 128, and store straight into the component's plane
//   cropped to its true sample grid (the block-to-plane permute is the
//   store's index).  (b) Each output pixel: libjpeg's fancy
//   upsampling read straight off the cropped chroma planes, horizontal then
//   vertical, each step (3*s + n) * 0.25 with the edges replicated at the
//   cropped size, then YCbCr -> BGR, round half-to-even, clamp to
//   [0, 255], and an interleaved [B, H, W, 3] store.  Every step uses IEEE
//   round-to-nearest intrinsics in the PyTorch composition's operation
//   order, so nvcc cannot contract a product into an FMA and change a bit.
//
// Bound: memory.  An IDCT block reads and writes 256 bytes and takes
// 2 * 512 FMAs, 4 flops per byte, far below the card's ~20 f32 flop/byte
// ridge: the luma of a 64-image 375x500 4:2:0 chunk (196,608 blocks) is
// 100.7 MB moved, about 30 us at an H100 SXM's 3.35 TB/s.  The whole decode
// of that chunk reads 37.8 MB of int16 coefficients and writes 144 MB of f32
// BGR pixels: about 54 us; the f32 planes between the two launches add
// 72 MB written and read again (97 us in all).
//
// Design: 64 threads per 8x8 block, four blocks per 256-thread CTA.  Each
// thread loads one coefficient, so a warp reads contiguous memory, and
// holds the two basis columns it needs in registers.  A row pass T = A^T X
// (thread (i, l) sums A[j][i] * X[j][l] over j, reading X's column l as
// two 16-byte vectors from a transposed copy in shared memory) goes to
// shared memory; a column pass T A gives the thread's output element.  f32
// FMAs only, no tensor cores; the Pallas kernel's padding to tiles of 256
// blocks becomes a bounds check on the last CTA.  In the decode, a planes
// CTA covers up to 32 consecutive blocks of one block row of one component,
// so the component, the row and the quant table are the same for all its
// threads, and each thread issues its eight coefficient loads before the
// first transform.  A pixels thread computes four consecutive pixels whose
// 48 bytes leave through shared memory as coalesced 16-byte stores; the
// chroma samples neighbouring pixels share come from L1.  Per-component
// fields are read with constant indices (`pick`): a runtime index into the
// kernel's parameter arrays made every thread copy them to local memory,
// which cost more than the transforms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocksPerCta = 4;

// The basis columns thread (i, l) needs, in registers: A[j][i] for the row
// pass and A[k][l] for the column pass.
struct BasisCols {
  float ai[8];
  float al[8];
};

__device__ __forceinline__ BasisCols basis_cols(const float* a, int e) {
  BasisCols b;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b.ai[j] = a[j * 8 + (e >> 3)];
    b.al[j] = a[j * 8 + (e & 7)];
  }
  return b;
}

// The IDCT of one 8x8 block, element (i, l) = e of block `local` of the
// CTA.  Every thread of the CTA calls it (it synchronises twice).  X is
// stored transposed (sx[l][j] = X[j][l]) so that both passes read their
// eight operands as two 16-byte vectors.
__device__ __forceinline__ float idct_8x8(float x, const BasisCols& b,
                                          float (*sx)[64], float (*st)[64],
                                          int local, int e) {
  const int i = e >> 3;
  const int l = e & 7;
  sx[local][l * 8 + i] = x;  // thread (j, l) = e holds X[j][l]: j is e >> 3
  __syncthreads();
  // Row pass: T[i][l] = sum_j A[j][i] * X[j][l].
  const float4* xc = reinterpret_cast<const float4*>(&sx[local][l * 8]);
  const float4 x0 = xc[0];
  const float4 x1 = xc[1];
  const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) t = fmaf(b.ai[j], xs[j], t);
  st[local][e] = t;
  __syncthreads();
  // Column pass: out[i][l] = sum_k T[i][k] * A[k][l].
  const float4* tr = reinterpret_cast<const float4*>(&st[local][i * 8]);
  const float4 t0 = tr[0];
  const float4 t1 = tr[1];
  const float ts[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
  float o = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) o = fmaf(ts[k], b.al[k], o);
  return o;
}

__global__ void idct_kernel(const float* __restrict__ x,
                            const float* __restrict__ a,
                            float* __restrict__ out, long long n) {
  __shared__ __align__(16) float sx[kBlocksPerCta][64];
  __shared__ __align__(16) float st[kBlocksPerCta][64];
  const int tid = threadIdx.x;
  const int local = tid >> 6;  // which of the CTA's blocks
  const int e = tid & 63;      // element (i, l) of that block
  const long long b = (long long)blockIdx.x * kBlocksPerCta + local;
  const bool valid = b < n;
  const BasisCols cols = basis_cols(a, e);
  const float o = idct_8x8(valid ? x[b * 64 + e] : 0.f, cols, sx, st, local, e);
  if (valid) out[b * 64 + e] = o;
}

constexpr int kMaxComps = 3;
constexpr int kMaxImages = 65535;  // images per launch (gridDim.y)
constexpr int kGroupsPerCta = 8;   // launch (a): block groups a CTA walks
constexpr int kPixelsPerThread = 4;  // launch (b): consecutive pixels
constexpr int kPixelThreads = 256;   // launch (b): threads per CTA

// Launch (a): CTA x of image blockIdx.y (offset by `image0`) covers up to
// kGroupsPerCta * kBlocksPerCta consecutive blocks of one block row of one
// component: component c owns the CTAs [first[c], first[c] + by[c] *
// chunks[c]), chunks[c] per block row.  Its coefficients are [batch, by, bx,
// 8, 8] in coeffs[c], its plane [batch, h, w].  Everything that picks the
// component is uniform over the CTA, and no thread divides per element.
struct PlaneArgs {
  const short* coeffs[kMaxComps];
  float* plane[kMaxComps];
  int first[kMaxComps];  // first CTA; the total for components past ncomp
  int chunks[kMaxComps];
  int by[kMaxComps], bx[kMaxComps];
  int h[kMaxComps], w[kMaxComps];
  int ncomp;
  long long image0;
};

// Field c of a per-component array, read with constant indices: indexing
// a kernel parameter array with a runtime value makes every thread copy the
// whole parameter block to local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxComps], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}

__global__ void decode_planes_kernel(PlaneArgs p,
                                     const float* __restrict__ qt,
                                     const float* __restrict__ a) {
  __shared__ __align__(16) float sx[kBlocksPerCta][64];
  __shared__ __align__(16) float st[kBlocksPerCta][64];
  const int tid = threadIdx.x;
  const int local = tid >> 6;
  const int e = tid & 63;
  const long long img = p.image0 + blockIdx.y;
  const int cta = blockIdx.x;
  const int c = (cta >= p.first[1]) + (cta >= p.first[2]);
  const int chunks = pick(p.chunks, c);
  const int row = (cta - pick(p.first, c)) / chunks;
  const int bx0 = (cta - pick(p.first, c) - row * chunks) * kGroupsPerCta * kBlocksPerCta;
  const int by = pick(p.by, c);
  const int bx = pick(p.bx, c);
  const int h = pick(p.h, c);
  const int w = pick(p.w, c);
  const short* cf = pick(p.coeffs, c) + ((img * by + row) * bx + bx0 + local) * 64 + e;
  float* plane = pick(p.plane, c) + img * h * w;
  const float q = qt[(img * p.ncomp + c) * 64 + e];
  const BasisCols cols = basis_cols(a, e);
  const int y = row * 8 + (e >> 3);
  // Every group's coefficient is loaded before the first transform, so a
  // thread has kGroupsPerCta loads in flight at once.
  short raw[kGroupsPerCta];
#pragma unroll
  for (int g = 0; g < kGroupsPerCta; ++g) {
    raw[g] = bx0 + g * kBlocksPerCta + local < bx ? cf[g * kBlocksPerCta * 64] : 0;
  }
#pragma unroll
  for (int g = 0; g < kGroupsPerCta; ++g) {
    if (bx0 + g * kBlocksPerCta >= bx) break;  // the same for the whole CTA
    const int bxi = bx0 + g * kBlocksPerCta + local;
    const float x = bxi < bx ? __fmul_rn((float)raw[g], q) : 0.f;
    const float o = idct_8x8(x, cols, sx, st, local, e);
    const int xx = bxi * 8 + (e & 7);
    if (bxi < bx && y < h && xx < w) plane[(long long)y * w + xx] = __fadd_rn(o, 128.f);
  }
}

// Launch (b): plane c is [batch, h, w], upsampled 2x along x when up_h[c]
// and along y when up_v[c].  blockIdx.y is the image (offset by `image0`).
struct PixelArgs {
  const float* plane[kMaxComps];
  int h[kMaxComps], w[kMaxComps];
  int up_h[kMaxComps], up_v[kMaxComps];
  int ncomp;
  int height, width;
  long long image0;
};

// libjpeg's triangular step: (3 * s + n) * 0.25, in that rounding order.
__device__ __forceinline__ float tri(float s, float n) {
  return __fmul_rn(__fadd_rn(__fmul_rn(3.f, s), n), 0.25f);
}

// Column x of row `row` (w samples) after the horizontal step, if any.
__device__ __forceinline__ float row_sample(const float* row, int w, bool up,
                                            int x) {
  if (!up) return row[x];
  const int i = x >> 1;
  const int j = (x & 1) ? min(i + 1, w - 1) : max(i - 1, 0);
  return tri(row[i], row[j]);
}

// Sample (y, x) of component c of image img, upsampled as the geometry says.
__device__ __forceinline__ float sample(const PixelArgs& p, int c,
                                        long long img, int y, int x) {
  const int h = p.h[c];
  const int w = p.w[c];
  const float* pl = p.plane[c] + img * h * w;
  const bool uh = p.up_h[c];
  if (!p.up_v[c]) return row_sample(pl + (long long)y * w, w, uh, x);
  const int i = y >> 1;
  const int j = (y & 1) ? min(i + 1, h - 1) : max(i - 1, 0);
  return tri(row_sample(pl + (long long)i * w, w, uh, x),
             row_sample(pl + (long long)j * w, w, uh, x));
}

__device__ __forceinline__ float to_level(float v) {
  return fminf(fmaxf(rintf(v), 0.f), 255.f);
}

// The BGR levels of pixel (y, x) of image img.
__device__ __forceinline__ void bgr_at(const PixelArgs& p, long long img,
                                       int y, int x, float* o) {
  const float luma = sample(p, 0, img, y, x);
  if (p.ncomp == 1) {
    const float v = to_level(luma);
    o[0] = v;
    o[1] = v;
    o[2] = v;
    return;
  }
  // The constants as PyTorch applies a Python float to an f32 tensor: the
  // double rounded once to f32.
  const float cb = __fsub_rn(sample(p, 1, img, y, x), 128.f);
  const float cr = __fsub_rn(sample(p, 2, img, y, x), 128.f);
  const float r = __fadd_rn(luma, __fmul_rn((float)1.40200, cr));
  const float g = __fsub_rn(__fsub_rn(luma, __fmul_rn((float)0.344136, cb)),
                            __fmul_rn((float)0.714136, cr));
  const float bl = __fadd_rn(luma, __fmul_rn((float)1.77200, cb));
  o[0] = to_level(bl);
  o[1] = to_level(g);
  o[2] = to_level(r);
}

// Each thread computes kPixelsPerThread consecutive pixels (row-major
// within the image).  A warp's 32 x 48 contiguous bytes go out through
// shared memory as coalesced 16-byte stores when they are aligned and all
// in the image; otherwise each thread stores its own floats.
__global__ void __launch_bounds__(kPixelThreads)
    decode_pixels_kernel(PixelArgs p, float* __restrict__ out) {
  constexpr int kFloats = kPixelsPerThread * 3;
  __shared__ float4 stage[kPixelThreads / 32][8 * kFloats];
  const int hw = p.height * p.width;
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPixelsPerThread;
  const int lane = threadIdx.x & 31;
  const int warp_i0 = i0 - lane * kPixelsPerThread;
  if (warp_i0 >= hw) return;  // the whole warp is past the image
  const long long img = p.image0 + blockIdx.y;
  float v[kFloats];
  int y = i0 / p.width;
  int x = i0 - y * p.width;
#pragma unroll
  for (int u = 0; u < kPixelsPerThread; ++u) {
    if (i0 + u < hw) bgr_at(p, img, y, x, v + 3 * u);
    if (++x == p.width) {
      x = 0;
      ++y;
    }
  }
  float* wo = out + (img * hw + warp_i0) * 3;
  if (warp_i0 + 32 * kPixelsPerThread <= hw &&
      reinterpret_cast<uintptr_t>(wo) % 16 == 0) {
    float4* st4 = stage[threadIdx.x >> 5];
#pragma unroll
    for (int k = 0; k < kFloats / 4; ++k) {
      st4[lane * (kFloats / 4) + k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    __syncwarp();
    float4* wo4 = reinterpret_cast<float4*>(wo);
#pragma unroll
    for (int k = 0; k < kFloats / 4; ++k) wo4[k * 32 + lane] = st4[k * 32 + lane];
  } else if (i0 < hw) {
    float* o = out + (img * hw + i0) * 3;
    for (int k = 0; k < 3 * min(kPixelsPerThread, hw - i0); ++k) o[k] = v[k];
  }
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

// coeffs[c]: [batch, dims[4c], dims[4c+1], 8, 8] int16; planes[c]:
// [batch, dims[4c+2], dims[4c+3]] f32 (the cropped plane); qt:
// [batch, ncomp, 8, 8] f32; a: the 8x8 f32 basis.  Launches on `stream`,
// allocates nothing, and returns the launch's cudaError_t (0 on success).
extern "C" int decode_planes_launch(const void* const* coeffs,
                                    void* const* planes, const int* dims,
                                    int ncomp, long long batch,
                                    const void* qt, const void* a,
                                    void* stream) {
  if (ncomp < 1 || ncomp > kMaxComps || batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  PlaneArgs p = {};
  p.ncomp = ncomp;
  constexpr int kPerCta = kBlocksPerCta * kGroupsPerCta;
  long long ctas = 0;
  for (int c = 0; c < ncomp; ++c) {
    p.coeffs[c] = (const short*)coeffs[c];
    p.plane[c] = (float*)planes[c];
    p.by[c] = dims[4 * c];
    p.bx[c] = dims[4 * c + 1];
    p.h[c] = dims[4 * c + 2];
    p.w[c] = dims[4 * c + 3];
    if (p.by[c] <= 0 || p.bx[c] <= 0 || p.h[c] <= 0 || p.w[c] <= 0 ||
        p.h[c] > 8 * p.by[c] || p.w[c] > 8 * p.bx[c] ||
        (long long)p.h[c] * p.w[c] > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    p.first[c] = (int)ctas;
    p.chunks[c] = (p.bx[c] + kPerCta - 1) / kPerCta;
    ctas += (long long)p.by[c] * p.chunks[c];
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  // Components past ncomp start at the total, so no CTA falls in them.
  for (int c = ncomp; c < kMaxComps; ++c) p.first[c] = (int)ctas;
  for (long long i0 = 0; i0 < batch; i0 += kMaxImages) {
    p.image0 = i0;
    const long long images = batch - i0 < kMaxImages ? batch - i0 : kMaxImages;
    decode_planes_kernel<<<dim3((unsigned)ctas, (unsigned)images), 64 * kBlocksPerCta, 0,
                           (cudaStream_t)stream>>>(p, (const float*)qt,
                                                   (const float*)a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// planes[c]: [batch, dims[4c], dims[4c+1]] f32, upsampled 2x along x when
// dims[4c+2] and along y when dims[4c+3]; out: [batch, height, width, 3]
// f32 BGR.  Launches on `stream`, allocates nothing, and returns the
// launch's cudaError_t (0 on success).
extern "C" int decode_pixels_launch(const void* const* planes,
                                    const int* dims, int ncomp,
                                    long long batch, int height, int width,
                                    void* out, void* stream) {
  if ((ncomp != 1 && ncomp != 3) || batch <= 0 || height <= 0 || width <= 0 ||
      (long long)height * width > 0x7fffffffLL - 256) {
    return (int)cudaErrorInvalidValue;
  }
  PixelArgs p;
  p.ncomp = ncomp;
  p.height = height;
  p.width = width;
  for (int c = 0; c < ncomp; ++c) {
    p.plane[c] = (const float*)planes[c];
    p.h[c] = dims[4 * c];
    p.w[c] = dims[4 * c + 1];
    p.up_h[c] = dims[4 * c + 2];
    p.up_v[c] = dims[4 * c + 3];
    if ((p.up_h[c] ? 2 : 1) * p.w[c] < width ||
        (p.up_v[c] ? 2 : 1) * p.h[c] < height) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int per_cta = kPixelThreads * kPixelsPerThread;
  const int ctas = (height * width + per_cta - 1) / per_cta;
  for (long long i0 = 0; i0 < batch; i0 += kMaxImages) {
    p.image0 = i0;
    const long long images = batch - i0 < kMaxImages ? batch - i0 : kMaxImages;
    decode_pixels_kernel<<<dim3(ctas, (unsigned)images), kPixelThreads, 0,
                           (cudaStream_t)stream>>>(p, (float*)out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
