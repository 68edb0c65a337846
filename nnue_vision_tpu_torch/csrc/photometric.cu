// The gated photometric chain of one augmentation block for Hopper (sm_90a).
//
//   photometric_kernel  replaces nnue_vision_tpu/ops/photometric_kernel.py
//                       _photometric_kernel (photometric_block), both
//                       variants:
//     bc -> HSV -> separable 3x3 blur -> gaussian noise -> cutout, then
//     medium:      HSV -> shadow -> fog -> posterize -> equalize
//     heavy_extra: a second cutout
//   Every op is gated per image; all randomness comes in as arguments
//   (fparams (B, F) float32, iparams (B, I) int32, the unit-normal noise
//   (B, H, W, 3)), in the JAX package's column layouts.
//
// Each op is spelled with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn in the
// order of the plain version (photometric_block_reference in
// ops/photometric_kernel.py, which follows the TPU kernel's order: the blur
// as two separable [1, 2, 1] passes, not XLA's 9-term window), rintf rounds
// half to even like torch.round, and the equalize min/max is an exact block
// reduction, so the kernel is bit-equal to the plain version. The build does
// not use --use_fast_math.
//
// One block per image. The image stays in shared memory for the whole chain
// (two 12 KB buffers at 32x32x3): the blur's neighbour reads and the
// equalize's per-image min/max need it there, and everything else runs in
// registers, one pixel (three channels) per thread step. The TPU kernel held
// a batch tile of packed rows in vector registers and read neighbours with
// lane and sublane rolls; here neighbours are shared-memory reads.
//
// What bounds it on the card: bytes. At B = 1024 it reads the image and the
// noise and writes the result, 3 x 12.6 MB, ~11 us at 3.35 TB/s; the ~60
// float ops per value are far below the card's rate.
//
// C interface (ctypes): the launcher returns cudaGetLastError() after the
// launch. The kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct PhotoArgs {
  const float* x;      // (batch, h, w, 3)
  const float* noise;  // (batch, h, w, 3)
  const float* fp;     // (batch, nf)
  const int* ip;       // (batch, ni)
  int h, w, nf, ni;
  int medium;          // 1: the medium variant, 0: heavy_extra
  float* out;          // (batch, h, w, 3)
};

__device__ inline float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// brightness/contrast: clip((x - 0.5)*contr + 0.5 + bright, 0, 1)
__device__ inline float bc(float v, float bright, float contr) {
  return clamp01(__fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(v, 0.5f), contr), 0.5f), bright));
}

// HSV jitter on one pixel: luma = 0.299 r + 0.587 g + 0.114 b (left to
// right), r += hue, b -= hue, clip((luma + (v - luma)*sat)*val, 0, 1)
__device__ inline void hsv(float* p, float hue, float sat, float val) {
  const float luma = __fadd_rn(__fadd_rn(__fmul_rn(p[0], 0.299f), __fmul_rn(p[1], 0.587f)),
                               __fmul_rn(p[2], 0.114f));
  const float shifted[3] = {__fadd_rn(p[0], hue), p[1], __fsub_rn(p[2], hue)};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = clamp01(__fmul_rn(__fadd_rn(luma, __fmul_rn(__fsub_rn(shifted[c], luma), sat)), val));
}

__device__ inline bool in_hole(int y, int x, const int* r) {
  return y >= r[0] && y < r[0] + r[1] && x >= r[2] && x < r[2] + r[3];
}

__global__ void __launch_bounds__(kThreads)
photometric_kernel(PhotoArgs a) {
  extern __shared__ float sm[];
  const int npix = a.h * a.w;
  const int size = npix * 3;
  float* s_x = sm;
  float* s_t = sm + size;
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  const int b = blockIdx.x;
  const float* xin = a.x + static_cast<size_t>(b) * size;
  const float* nz = a.noise + static_cast<size_t>(b) * size;
  const float* f = a.fp + b * a.nf;
  const int* ip = a.ip + b * a.ni;
  auto gate = [&](int i) { return f[i] > 0.5f; };

  // 1. brightness/contrast, 2. HSV
  for (int px = threadIdx.x; px < npix; px += blockDim.x) {
    float p[3] = {xin[3 * px], xin[3 * px + 1], xin[3 * px + 2]};
    if (gate(0))
      for (int c = 0; c < 3; ++c) p[c] = bc(p[c], f[1], f[2]);
    if (gate(3)) hsv(p, f[4], f[5], f[6]);
    for (int c = 0; c < 3; ++c) s_x[3 * px + c] = p[c];
  }
  __syncthreads();

  // 3. blur: horizontal (xl + 2x) + xr into s_t, then vertical
  // ((tu + 2t) + td) / 16, zero outside the frame
  const bool blur = gate(7);
  if (blur) {
    for (int e = threadIdx.x; e < size; e += blockDim.x) {
      const int px = e / 3;
      const int xx = px % a.w;
      const float v = s_x[e];
      const float xl = xx > 0 ? s_x[e - 3] : 0.0f;
      const float xr = xx < a.w - 1 ? s_x[e + 3] : 0.0f;
      s_t[e] = __fadd_rn(__fadd_rn(xl, __fmul_rn(2.0f, v)), xr);
    }
    __syncthreads();
  }

  // 3 (vertical) .. 9: per pixel in registers
  for (int px = threadIdx.x; px < npix; px += blockDim.x) {
    const int y = px / a.w;
    const int xx = px - y * a.w;
    float p[3];
    for (int c = 0; c < 3; ++c) {
      const int e = 3 * px + c;
      if (blur) {
        const float t = s_t[e];
        const float tu = y > 0 ? s_t[e - 3 * a.w] : 0.0f;
        const float td = y < a.h - 1 ? s_t[e + 3 * a.w] : 0.0f;
        p[c] = __fmul_rn(__fadd_rn(__fadd_rn(tu, __fmul_rn(2.0f, t)), td), 0.0625f);
      } else {
        p[c] = s_x[e];
      }
    }
    // 4. gaussian noise
    if (gate(8))
      for (int c = 0; c < 3; ++c)
        p[c] = clamp01(__fadd_rn(p[c], __fmul_rn(nz[3 * px + c], f[9])));
    // 5. cutout
    if (gate(10) && in_hole(y, xx, ip))
      for (int c = 0; c < 3; ++c) p[c] = 0.0f;
    if (a.medium) {
      // 6. second HSV
      if (gate(11)) hsv(p, f[12], f[13], f[14]);
      // 7. shadow: darken where cos*xn + sin*yn > offset
      if (gate(15)) {
        const float yn = __fsub_rn(__fdiv_rn(static_cast<float>(y), static_cast<float>(a.h)), 0.5f);
        const float xn = __fsub_rn(__fdiv_rn(static_cast<float>(xx), static_cast<float>(a.w)), 0.5f);
        if (__fadd_rn(__fmul_rn(f[16], xn), __fmul_rn(f[17], yn)) > f[18])
          for (int c = 0; c < 3; ++c) p[c] = __fmul_rn(p[c], f[19]);
      }
      // 8. fog: x*(1 - amount) + amount
      if (gate(20)) {
        const float keep = __fsub_rn(1.0f, f[21]);
        for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(__fmul_rn(p[c], keep), f[21]);
      }
      // 9. posterize to 4 bits, round half to even
      if (gate(22))
        for (int c = 0; c < 3; ++c) p[c] = __fdiv_rn(rintf(__fmul_rn(p[c], 15.0f)), 15.0f);
    } else if (gate(11) && in_hole(y, xx, ip + 4)) {
      // heavy_extra: the second cutout
      for (int c = 0; c < 3; ++c) p[c] = 0.0f;
    }
    for (int c = 0; c < 3; ++c) s_x[3 * px + c] = p[c];
  }
  __syncthreads();

  float* dst = a.out + static_cast<size_t>(b) * size;
  // 10. equalize (medium): (x - lo) / max(hi - lo, 1e-6) over the image
  if (a.medium && gate(23)) {
    float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);
    for (int e = threadIdx.x; e < size; e += blockDim.x) {
      lo = fminf(lo, s_x[e]);
      hi = fmaxf(hi, s_x[e]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) { s_lo[warp] = lo; s_hi[warp] = hi; }
    __syncthreads();
    lo = s_lo[0];
    hi = s_hi[0];
    for (int i = 1; i < static_cast<int>(blockDim.x / 32); ++i) {
      lo = fminf(lo, s_lo[i]);
      hi = fmaxf(hi, s_hi[i]);
    }
    const float range = fmaxf(__fsub_rn(hi, lo), 1e-6f);
    for (int e = threadIdx.x; e < size; e += blockDim.x)
      dst[e] = __fdiv_rn(__fsub_rn(s_x[e], lo), range);
  } else {
    for (int e = threadIdx.x; e < size; e += blockDim.x) dst[e] = s_x[e];
  }
}

}  // namespace

extern "C" {

int photometric_launch(const void* x, const void* noise, const void* fp,
                       const void* ip, int batch, int h, int w, int nf, int ni,
                       int medium, void* out, void* stream) {
  if (batch <= 0 || h < 3 || w < 3) return static_cast<int>(cudaErrorInvalidValue);
  if (nf < (medium ? 24 : 12) || ni < (medium ? 4 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  PhotoArgs a;
  a.x = static_cast<const float*>(x);
  a.noise = static_cast<const float*>(noise);
  a.fp = static_cast<const float*>(fp);
  a.ip = static_cast<const int*>(ip);
  a.h = h; a.w = w; a.nf = nf; a.ni = ni; a.medium = medium;
  a.out = static_cast<float*>(out);
  const int smem = 2 * h * w * 3 * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        photometric_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  photometric_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
