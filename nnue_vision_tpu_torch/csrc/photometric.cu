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
// half to even like torch.round, and the equalize min/max is exact in any
// order, so the kernel is bit-equal to the plain version. The build does not
// use --use_fast_math.
//
// What bounds it on the card: bytes. At B = 8192 it reads the image and
// writes the result, 2 x 100.7 MB, and reads the noise of the images whose
// noise gate is on (a fifth of them under the medium draw); the ~60 float
// operations per value are far below the card's rate. Nothing in the chain
// is a matrix product, so tensor cores do not apply.
//
// The design (csrc/bulk_ring.cuh): a persistent grid, as many blocks per SM
// as fit (ops/_ring.py), whose blocks walk their images through one
// shared-memory slot each; the resident blocks overlap one another's
// copies, chains and stores. Warp 0 reads an image's fparams and iparams
// into the parameter area, a word a lane, and its lane 0 brings the image
// into the slot with a 1-D bulk copy. Per image:
//   - with the blur on: bc and HSV in place in the slot, then the
//     horizontal [1, 2, 1] into T, which carries a zero row above and below
//     (zeroed once per block) so that the vertical pass needs no frame test;
//   - then, per pixel in registers, the rest of the chain, written back
//     into the slot (with the blur off, bc and HSV run here too). The noise
//     is read by the threads, and only for an image whose gate 8 is on: a
//     warp reads 384 contiguous bytes. It is not staged in shared memory, so
//     that a slot is one image (12 KB at 32x32x3) and more blocks fit on an
//     SM;
//   - the equalize (medium, gate 23): min and max by warp shuffles and one
//     block step, then the stretch over the slot, 16 bytes a thread;
//   - one bulk store of the slot.
// A thread handles a pixel (three channels) per step, walking (row, pixel)
// with no index division (ring::Walk); the divisions left are the ops' own
// (the shadow's coordinates, posterize's k / 15). The TPU kernel held a
// batch tile of packed rows in vector registers and read neighbours with
// lane and sublane rolls; here neighbours are shared-memory reads.
//
// C interface (ctypes): the launcher returns cudaGetLastError() after the
// launch. The kernel launches on the caller's stream and allocates nothing.
// The host (ops/photometric_kernel.py) picks the grid;
// photometric_blocks_per_sm reports the occupancy it sizes the grid with.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

using ring::kThreads;
constexpr int kC = 3;
constexpr int kHeader = 256;  // the barrier and the image's parameters (<= 32 words)
constexpr int kWarps = kThreads / 32;

struct PhotoArgs {
  const float* x;      // (batch, h, w, 3)
  const float* noise;  // (batch, h, w, 3)
  const float* fp;     // (batch, nf)
  const int* ip;       // (batch, ni)
  int batch, h, w, nf, ni;
  int medium;          // 1: the medium variant, 0: heavy_extra
  float* out;          // (batch, h, w, 3)
};

// the header, the slot and T (the blur's rows with a zero row above and
// below)
int photometric_smem_bytes(int h, int w) {
  return kHeader + h * w * kC * 4 + (h + 2) * w * kC * 4;
}

__device__ __forceinline__ bool gate(const float* f, int k) { return f[k] > 0.5f; }

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// brightness/contrast: clip((x - 0.5)*contr + 0.5 + bright, 0, 1)
__device__ __forceinline__ float bc(float v, float bright, float contr) {
  return clamp01(__fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(v, 0.5f), contr), 0.5f), bright));
}

// HSV jitter on one pixel: luma = 0.299 r + 0.587 g + 0.114 b (left to
// right), r += hue, b -= hue, clip((luma + (v - luma)*sat)*val, 0, 1)
__device__ __forceinline__ void hsv(float* p, float hue, float sat, float val) {
  const float luma = __fadd_rn(__fadd_rn(__fmul_rn(p[0], 0.299f), __fmul_rn(p[1], 0.587f)),
                               __fmul_rn(p[2], 0.114f));
  const float shifted[3] = {__fadd_rn(p[0], hue), p[1], __fsub_rn(p[2], hue)};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = clamp01(__fmul_rn(__fadd_rn(luma, __fmul_rn(__fsub_rn(shifted[c], luma), sat)), val));
}

__device__ __forceinline__ bool in_hole(int y, int x, const int* r) {
  return y >= r[0] && y < r[0] + r[1] && x >= r[2] && x < r[2] + r[3];
}

// 1. brightness/contrast, 2. HSV
__device__ __forceinline__ void head(float* p, const float* f) {
  if (gate(f, 0)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = bc(p[c], f[1], f[2]);
  }
  if (gate(f, 3)) hsv(p, f[4], f[5], f[6]);
}

// 4. noise .. 9 (medium) or the second cutout (heavy_extra), in registers
__device__ __forceinline__ void tail(float* p, int y, int x, int h, int w, bool medium,
                                     const float* f, const int* ip, const float* nz) {
  // 4. gaussian noise
  if (gate(f, 8)) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[c] = clamp01(__fadd_rn(p[c], __fmul_rn(__ldg(nz + c), f[9])));
  }
  // 5. cutout
  if (gate(f, 10) && in_hole(y, x, ip)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = 0.0f;
  }
  if (medium) {
    // 6. second HSV
    if (gate(f, 11)) hsv(p, f[12], f[13], f[14]);
    // 7. shadow: darken where cos*xn + sin*yn > offset
    if (gate(f, 15)) {
      const float yn = __fsub_rn(__fdiv_rn(static_cast<float>(y), static_cast<float>(h)), 0.5f);
      const float xn = __fsub_rn(__fdiv_rn(static_cast<float>(x), static_cast<float>(w)), 0.5f);
      if (__fadd_rn(__fmul_rn(f[16], xn), __fmul_rn(f[17], yn)) > f[18]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) p[c] = __fmul_rn(p[c], f[19]);
      }
    }
    // 8. fog: x*(1 - amount) + amount
    if (gate(f, 20)) {
      const float keep = __fsub_rn(1.0f, f[21]);
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(__fmul_rn(p[c], keep), f[21]);
    }
    // 9. posterize to 4 bits, round half to even
    if (gate(f, 22)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = __fdiv_rn(rintf(__fmul_rn(p[c], 15.0f)), 15.0f);
    }
  } else if (gate(f, 11) && in_hole(y, x, ip + 4)) {
    // heavy_extra: the second cutout
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
photometric_kernel(PhotoArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* f = reinterpret_cast<float*>(smem + 64);  // the image's fparams,
  int* ip = reinterpret_cast<int*>(f + a.nf);       // then its iparams
  float* io = reinterpret_cast<float*>(smem + kHeader);  // the slot
  const int h = a.h, w = a.w;
  const int img = h * w * kC;
  const int ts = w * kC;  // T's row stride
  float* st = io + img;
  const uint32_t img_bytes = static_cast<uint32_t>(img) * 4u;
  const int nlocal = ring::local_items(a.batch);

  // warp 0: image i's fparams and iparams into the parameter area, a word
  // a lane; then lane 0 brings the image into the slot
  auto issue = [&](int i) {
    const size_t b = blockIdx.x + static_cast<size_t>(i) * gridDim.x;
    const int k = threadIdx.x;
    if (k < a.nf) f[k] = __ldg(a.fp + b * a.nf + k);
    else if (k < a.nf + a.ni) ip[k - a.nf] = __ldg(a.ip + b * a.ni + k - a.nf);
    __syncwarp();
    if (k == 0) {
      ring::mbar_expect_tx(bar, img_bytes);
      ring::bulk_load(io, a.x + b * img, img_bytes, bar);
    }
  };

  // T's padding rows stay zero: the horizontal pass writes only its interior
  for (int e = threadIdx.x; e < ts; e += kThreads) st[e] = st[(h + 1) * ts + e] = 0.0f;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      ring::mbar_init(bar, 1);
      ring::fence_mbar_init();
    }
    __syncwarp();
    issue(0);  // the grid is at most the batch: every block has an image
  }
  __syncthreads();

  const ring::Walk walk(w);
  for (int i = 0; i < nlocal; ++i) {
    ring::mbar_wait(bar, i & 1);
    const float* nz = a.noise + static_cast<size_t>(blockIdx.x + i * gridDim.x) * img;
    const bool blur = gate(f, 7);

    if (blur) {
      // 1, 2 in place; 3 (horizontal): (xl + 2x) + xr into T
      for (int y = walk.a0, x = walk.l0; y < h; walk.next(y, x)) {
        float* px = io + (y * w + x) * kC;
        float p[3] = {px[0], px[1], px[2]};
        head(p, f);
#pragma unroll
        for (int c = 0; c < 3; ++c) px[c] = p[c];
      }
      __syncthreads();
      for (int y = walk.a0, x = walk.l0; y < h; walk.next(y, x)) {
        const float* m = io + (y * w + x) * kC;
        float* d = st + (y + 1) * ts + x * kC;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float xl = x > 0 ? m[c - kC] : 0.0f;
          const float xr = x < w - 1 ? m[c + kC] : 0.0f;
          d[c] = __fadd_rn(__fadd_rn(xl, __fmul_rn(2.0f, m[c])), xr);
        }
      }
      __syncthreads();
    }

    // 3 (vertical): ((tu + 2t) + td) / 16, then 4 .. 9, back into the slot;
    // the noise is read from device memory, for a gated image only
    float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);
    for (int y = walk.a0, x = walk.l0; y < h; walk.next(y, x)) {
      float* px = io + (y * w + x) * kC;
      float p[3];
      if (blur) {
        const float* t = st + (y + 1) * ts + x * kC;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          p[c] = __fmul_rn(__fadd_rn(__fadd_rn(t[c - ts], __fmul_rn(2.0f, t[c])), t[c + ts]),
                           0.0625f);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) p[c] = px[c];
        head(p, f);
      }
      tail(p, y, x, h, w, a.medium, f, ip, nz + (y * w + x) * kC);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        px[c] = p[c];
        lo = fminf(lo, p[c]);
        hi = fmaxf(hi, p[c]);
      }
    }

    // 10. equalize (medium): (x - lo) / max(hi - lo, 1e-6) over the image
    if (a.medium && gate(f, 23)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if ((threadIdx.x & 31) == 0) {
        s_lo[threadIdx.x / 32] = lo;
        s_hi[threadIdx.x / 32] = hi;
      }
      __syncthreads();
      lo = s_lo[0];
      hi = s_hi[0];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        lo = fminf(lo, s_lo[k]);
        hi = fmaxf(hi, s_hi[k]);
      }
      const float range = fmaxf(__fsub_rn(hi, lo), 1e-6f);
      float4* v4 = reinterpret_cast<float4*>(io);
      for (int e = threadIdx.x; e < img / 4; e += kThreads) {
        float4 v = v4[e];
        v.x = __fdiv_rn(__fsub_rn(v.x, lo), range);
        v.y = __fdiv_rn(__fsub_rn(v.y, lo), range);
        v.z = __fdiv_rn(__fsub_rn(v.z, lo), range);
        v.w = __fdiv_rn(__fsub_rn(v.w, lo), range);
        v4[e] = v;
      }
    }
    ring::fence_async_shared();
    __syncthreads();

    if (threadIdx.x < 32) {
      const bool next = i + 1 < nlocal;
      if (threadIdx.x == 0) {
        const int b = blockIdx.x + i * gridDim.x;
        ring::bulk_store(a.out + static_cast<size_t>(b) * img, io, img_bytes);
        // the next image, once the store has read the slot
        if (next) ring::bulk_wait_read();
      }
      if (next) {
        __syncwarp();
        issue(i + 1);
      }
    }
  }
  if (threadIdx.x == 0) ring::bulk_wait_all();
}

unsigned g_smem_set = 0;

}  // namespace

extern "C" {

int photometric_blocks_per_sm(int h, int w) {
  if (h < 3 || w < 3) return 0;
  return ring::blocks_per_sm(photometric_kernel, &g_smem_set, photometric_smem_bytes(h, w));
}

// a = [x, noise, fparams, iparams, batch, h, w, nf, ni, medium, grid, out,
// stream]: one packed argument, so that the host's call converts one
// pointer
int photometric_launch(const int64_t* p) {
  PhotoArgs a;
  a.x = reinterpret_cast<const float*>(p[0]);
  a.noise = reinterpret_cast<const float*>(p[1]);
  a.fp = reinterpret_cast<const float*>(p[2]);
  a.ip = reinterpret_cast<const int*>(p[3]);
  a.batch = static_cast<int>(p[4]);
  a.h = static_cast<int>(p[5]);
  a.w = static_cast<int>(p[6]);
  a.nf = static_cast<int>(p[7]);
  a.ni = static_cast<int>(p[8]);
  a.medium = static_cast<int>(p[9]);
  const int grid = static_cast<int>(p[10]);
  a.out = reinterpret_cast<float*>(p[11]);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(p[12]);
  // images of whole 16-byte units (h*w % 4 == 0) at 16-byte aligned
  // addresses: what the bulk copies take (the noise is read by the threads)
  if (a.batch <= 0 || a.h < 3 || a.w < 3 || (a.h * a.w) % 4 || grid <= 0 ||
      grid > a.batch || !ring::aligned16(a.x) || !ring::aligned16(a.out))
    return static_cast<int>(cudaErrorInvalidValue);
  // the variant's columns, and at most 32 words of parameters (warp 0 reads
  // one a lane)
  if (a.nf < (a.medium ? 24 : 12) || a.ni < (a.medium ? 4 : 8) || a.nf + a.ni > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = photometric_smem_bytes(a.h, a.w);
  if (smem > ring::kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ring::allow_max_smem(photometric_kernel, &g_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  photometric_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
