// The fused light-tier input pipeline for Hopper (sm_90a).
//
//   light_pipeline_kernel  replaces nnue_vision_tpu/ops/input_pipeline.py
//                          _gather_augment_kernel (fused_light_pipeline):
//                          gather B rows of the dataset (flip folded into the
//                          index as +N), clip(x*alpha + beta, 0, 1), zero a
//                          cutout rectangle, ImageNet normalize.
//
// What it computes, element by element, for output (b, y, x, c):
//   r = idx[b] < N ? idx[b] : idx[b] - N,  xs = idx[b] < N ? x : W-1-x
//   v = dataset[r, y, xs, c]
//   v = min(max(fadd_rn(fmul_rn(v, alpha_b), beta_b), 0), 1)
//   v = (y0_b <= y < y1_b && x0_b <= x < x1_b) ? 0 : v
//   out = fdiv_rn(fsub_rn(v, mean[c]), std[c])
// The intrinsics keep nvcc from contracting the product and sum into an FMA
// and from replacing the division: eager torch rounds each step, so the
// kernel is bit-equal to the plain version in ops/input_pipeline.py. The
// build does not use --use_fast_math.
//
// What bounds it on the card: bytes. At the flagship step (B = 512, 32x32x3
// float32) it reads 6.3 MB of gathered rows and writes 6.3 MB, ~4 us at the
// H100's 3.35 TB/s, so at this size the launch and its latency dominate;
// at B = 8192 it moves 200 MB. The TPU kernel DMA-gathered tiles of rows
// from a W-flipped, 128-lane padded second copy of the dataset through a
// sequential grid with semaphores. Here the dataset is held once, as
// (N, H, W, 3), and one block per image reads its row directly: a reversed
// column index replaces the flipped copy, and nothing carries between
// blocks. Each thread takes every blockDim-th value of the image, so a warp
// reads and writes 128 contiguous bytes (the flipped read walks the same
// bytes in reverse pixel order).
//
// An index outside [0, 2N) writes NaN to its image instead of reading
// outside the dataset; the Python caller checks indices on the host.
//
// C interface (ctypes): the launcher returns cudaGetLastError() after the
// launch. The kernel launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct LightArgs {
  const float* dataset;  // (n, h, w, 3)
  int n, h, w;
  const int* idx;        // (batch,) in [0, 2n)
  const float* pf;       // (batch, 2) [alpha, beta]
  const int* pi;         // (batch, 4) [y0, y1, x0, x1]
  float m0, m1, m2, s0, s1, s2;  // ImageNet mean and std per channel
  float* out;            // (batch, h, w, 3)
};

__global__ void __launch_bounds__(kThreads)
light_pipeline_kernel(LightArgs a) {
  const int b = blockIdx.x;
  const int row_len = a.w * 3;
  const int size = a.h * row_len;
  float* dst = a.out + static_cast<size_t>(b) * size;

  const int idx = a.idx[b];
  if (idx < 0 || idx >= 2 * a.n) {
    for (int e = threadIdx.x; e < size; e += blockDim.x) dst[e] = __int_as_float(0x7fc00000);
    return;
  }
  const bool flip = idx >= a.n;
  const float* src = a.dataset + static_cast<size_t>(flip ? idx - a.n : idx) * size;
  const float alpha = a.pf[2 * b], beta = a.pf[2 * b + 1];
  const int y0 = a.pi[4 * b], y1 = a.pi[4 * b + 1];
  const int x0 = a.pi[4 * b + 2], x1 = a.pi[4 * b + 3];

  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int y = e / row_len;
    const int rem = e - y * row_len;
    const int x = rem / 3;
    const int c = rem - x * 3;
    const int xs = flip ? a.w - 1 - x : x;
    float v = __ldg(src + y * row_len + xs * 3 + c);
    v = fminf(fmaxf(__fadd_rn(__fmul_rn(v, alpha), beta), 0.0f), 1.0f);
    if (y >= y0 && y < y1 && x >= x0 && x < x1) v = 0.0f;
    // selects, not an indexed array: indexing the parameters by c would
    // copy them to local memory
    const float mean = c == 0 ? a.m0 : (c == 1 ? a.m1 : a.m2);
    const float stdev = c == 0 ? a.s0 : (c == 1 ? a.s1 : a.s2);
    dst[e] = __fdiv_rn(__fsub_rn(v, mean), stdev);
  }
}

}  // namespace

extern "C" {

int light_pipeline_launch(
    const void* dataset, int n, int h, int w, const void* idx, const void* pf,
    const void* pi, int batch, float mean0, float mean1, float mean2,
    float std0, float std1, float std2, void* out, void* stream) {
  if (batch <= 0 || n <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  LightArgs a;
  a.dataset = static_cast<const float*>(dataset);
  a.n = n; a.h = h; a.w = w;
  a.idx = static_cast<const int*>(idx);
  a.pf = static_cast<const float*>(pf);
  a.pi = static_cast<const int*>(pi);
  a.m0 = mean0; a.m1 = mean1; a.m2 = mean2;
  a.s0 = std0; a.s1 = std1; a.s2 = std2;
  a.out = static_cast<float*>(out);
  light_pipeline_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
