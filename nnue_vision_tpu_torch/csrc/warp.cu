// The composed-geometry bilinear warp for Hopper (sm_90a).
//
//   warp_kernel       replaces nnue_vision_tpu/ops/warp_kernel.py
//                     _lerp_pass_kernel (lerp_pass, driven by
//                     warp_bilinear): the whole two-pass warp of one image
//                     in one launch.
//   lerp_pass_kernel  one pass alone, the TPU kernel at its own
//     <true>          granularity (lerp_pass): for the profiling probe.
//   lerp_pass_kernel  replaces scripts/profile_warp_split.py
//     <false>         _nogather_kernel (_nogather_pass): the same pass with
//                     the two reads at the computed positions replaced by a
//                     read of the output's own position, to price the
//                     gather.
//
// All three run one index arithmetic (taps() below) and one blend, so the
// probe prices the arithmetic the shipped kernel runs.
//
// What it computes, for a square (n, n, c) image and its packed parameters
// p = [swap, k1_row, k1_lane, k1_c, k2_row, k2_lane, k2_c, 0]
// (warp_coefficients in ops/warp_kernel.py):
//   src(y, x)      = swap ? in(x, y) : in(y, x)             (axis swap)
//   tmp(yi, xo)    = lerp of src row yi at  q = k1_row*yi + k1_lane*xo + k1_c
//   out(yo, xo)    = lerp of tmp column xo at p = k2_row*xo + k2_lane*yo + k2_c
// where lerp(row, pos) = row[i0]*(1 - fr) + row[i0 + 1]*fr, i0 = floor(pos),
// fr = pos - i0, a corner outside [0, n) reading 0. The products and sums
// are spelled __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order
// (warp_bilinear_reference, two eager lerp passes), so nvcc cannot contract
// them into FMAs and the kernel is bit-equal to it. The build does not use
// --use_fast_math.
//
// One block per image: the image (after the swap, applied as an index) and
// the pass-1 intermediate stay in shared memory (2 x 12 KB at 32x32x3), so
// the image is read once and the result written once. The TPU kernel ran
// each pass as a separate launch over (B, R, N*C) rows with lane gathers
// inside one vector register, and XLA transposed between the passes; here
// the transpose is an index into shared memory.
//
// What bounds it on the card: bytes and latency. At B = 1024 it reads and
// writes 12.6 MB each, ~8 us at 3.35 TB/s; per image the two passes are
// ~6k gathers from shared memory, so at this size launch and latency weigh
// as much as the bytes.
//
// lerp_pass_kernel runs one thread per output value of a (B, R, N*C)
// float32 batch, 256 threads a block over the flattened batch (about 2.7
// packed 96-value rows per block at 32x32x3). What bounds it: bytes, 12.6
// MB read and 12.6 MB written at B = 1024, ~7.5 us at 3.35 TB/s; its reads
// at the computed positions hit the rows its own block just brought into
// L1, which is what the no-gather control shows.
//
// C interface (ctypes): each launcher returns cudaGetLastError() after the
// launch. The kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 8;

// The two taps of a linear resample at `pos` along an axis of extent n:
// i0 = floor(pos), its weight fraction, and which taps lie inside [0, n).
struct Taps {
  int i0;
  float fr;
  bool in0, in1;
};

__device__ inline Taps taps(float pos, int n) {
  const float i0f = floorf(pos);
  Taps t;
  t.i0 = static_cast<int>(i0f);
  t.fr = __fsub_rn(pos, i0f);
  t.in0 = t.i0 >= 0 && t.i0 < n;
  t.in1 = t.i0 + 1 >= 0 && t.i0 + 1 < n;
  return t;
}

// v0*(1 - fr) + v1*fr; the caller reads 0 for a tap outside the axis.
__device__ inline float blend(const Taps& t, float v0, float v1) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, t.fr)), __fmul_rn(v1, t.fr));
}

__device__ inline float lerp_at(const float* base, int stride, int n,
                                float pos) {
  const Taps t = taps(pos, n);
  return blend(t, t.in0 ? base[t.i0 * stride] : 0.0f,
               t.in1 ? base[(t.i0 + 1) * stride] : 0.0f);
}

__device__ inline float position(float k_row, float row, float k_lane,
                                 float lane, float k_c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k_row, row), __fmul_rn(k_lane, lane)), k_c);
}

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ x, const float* __restrict__ params,
            int n, int c, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int size = n * n * c;
  const int row_len = n * c;
  float* src = sm;
  float* tmp = sm + size;
  const int b = blockIdx.x;
  const float* img = x + static_cast<size_t>(b) * size;
  const float* p = params + b * kParams;
  const bool swap = p[0] > 0.5f;
  const float k1r = p[1], k1l = p[2], k1c = p[3];
  const float k2r = p[4], k2l = p[5], k2c = p[6];

  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int y = e / row_len;
    const int rem = e - y * row_len;
    const int xx = rem / c;
    const int ch = rem - xx * c;
    src[e] = swap ? __ldg(img + xx * row_len + y * c + ch) : __ldg(img + e);
  }
  __syncthreads();

  // pass 1: resample each row yi along x
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int yi = e / row_len;
    const int rem = e - yi * row_len;
    const int xo = rem / c;
    const int ch = rem - xo * c;
    const float q = position(k1r, static_cast<float>(yi), k1l,
                             static_cast<float>(xo), k1c);
    tmp[e] = lerp_at(src + yi * row_len + ch, c, n, q);
  }
  __syncthreads();

  // pass 2: resample each column xo along y
  float* dst = out + static_cast<size_t>(b) * size;
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int yo = e / row_len;
    const int rem = e - yo * row_len;
    const int xo = rem / c;
    const int ch = rem - xo * c;
    const float q = position(k2r, static_cast<float>(xo), k2l,
                             static_cast<float>(yo), k2c);
    dst[e] = lerp_at(tmp + xo * c + ch, row_len, n, q);
  }
}

// One resample pass over (B, rows, n*c) packed rows: lane l = x*c + ch of
// row r reads positions k_row*r + k_lane*x + k_c of its row (kGather), or
// its own value in their place (the no-gather control).
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
lerp_pass_kernel(const float* __restrict__ x, const float* __restrict__ coef,
                 int batch, int rows, int n, int c, float* __restrict__ out) {
  const int lanes = n * c;
  const int per_img = rows * lanes;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(batch) * per_img) return;
  const int b = static_cast<int>(e / per_img);
  const int rem = static_cast<int>(e - static_cast<size_t>(b) * per_img);
  const int r = rem / lanes;
  const int l = rem - r * lanes;
  const int xo = l / c;
  const int ch = l - xo * c;
  const float* k = coef + 3 * b;
  const float pos = position(k[0], static_cast<float>(r), k[1],
                             static_cast<float>(xo), k[2]);
  if constexpr (kGather) {
    out[e] = lerp_at(x + (e - l) + ch, c, n, pos);
  } else {
    const float v = __ldg(x + e);
    const Taps t = taps(pos, n);
    out[e] = blend(t, t.in0 ? v : 0.0f, t.in1 ? v : 0.0f);
  }
}

}  // namespace

extern "C" {

int warp_launch(const void* x, int batch, int n, int c, const void* params,
                void* out, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * n * n * c * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  warp_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(params), n, c,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int lerp_pass_launch(const void* x, int batch, int rows, int n, int c,
                     const void* coef, int gather, void* out, void* stream) {
  if (batch <= 0 || rows <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(batch) * rows * n * c;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(coef);
  float* o = static_cast<float*>(out);
  if (gather)
    lerp_pass_kernel<true><<<blocks, kThreads, 0, s>>>(xf, cf, batch, rows, n, c, o);
  else
    lerp_pass_kernel<false><<<blocks, kThreads, 0, s>>>(xf, cf, batch, rows, n, c, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
