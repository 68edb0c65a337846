// One EtinyNet int8 LB block for Hopper (sm_90a).
//
//   etiny_block_kernel  replaces nnue_vision_tpu/ops/etiny_pallas.py
//                       _lb_block_kernel (lb_block_pallas, driven by
//                       etiny_forward_pallas): pw-expand + bias, truncating
//                       /s_expand, clamp [0, 6] -> depthwise 3x3 pad 1 at the
//                       block's stride, /s_dw, clamp [0, 6] -> pw-project,
//                       /s_project, clamp +-127 (the engine's LB block,
//                       nnue_engine.cpp:906-973).
//
// Every value is an integer and every sum is exact in int32: pw-expand
// |acc| <= 127*127*in + |bias|, depthwise |acc| <= 9*6*127, pw-project
// |acc| <= 6*127*mid. Division is C's, which truncates toward zero like the
// engine's. So the kernel equals the int64 engine sim (ops/engine_sim.py
// lb_block_plain) bit for bit, with no float anywhere.
//
// One block of threads per image. The block's input (H*W*in int8), its
// expanded activations (H*W*mid, values 0..6, int8) and its depthwise output
// (oh*ow*mid) all stay in shared memory: for the 0.98M variant at 32x32 the
// largest is 16*16*28 bytes. The two pointwise convs are int8 dot products,
// four lanes per __dp4a, with each position's channels padded to a multiple
// of four (zeros). The TPU kernel ran every block at stride 1 over
// (B*H*W, C) rows, with the depthwise taps as shifted rows, and the caller
// subsampled stride-2 outputs; here the depthwise conv reads its taps at
// the block's stride directly, and nothing carries between blocks.
//
// What bounds it on the card: the weights. Activations are a few KB per
// image, but each block re-reads its pointwise weights from L2 for every
// image; the synthetic final block's 1120x1120 projection (1.25 MB) is the
// largest share.
//
// C interface (ctypes): the launcher returns cudaGetLastError() after the
// launch. The kernel launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct BlockArgs {
  const int8_t* x;        // (batch, h, w, cin)
  int h, w, cin, cin_pad, mid, mid_pad, cout, stride, oh, ow;
  int s_expand, s_dw, s_project;
  const int8_t* we;       // (mid, cin_pad), zero padded
  const int* be;          // (mid,)
  const int8_t* dw;       // (mid, 3, 3)
  const int8_t* wp;       // (cout, mid_pad), zero padded
  int8_t* out;            // (batch, oh, ow, cout)
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

__global__ void __launch_bounds__(kThreads)
etiny_block_kernel(BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int hw = a.h * a.w;
  const int ohw = a.oh * a.ow;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int8_t* h1 = xs + align16(hw * a.cin_pad);
  int8_t* h2 = h1 + align16(hw * a.mid);

  const int8_t* xg = a.x + static_cast<size_t>(b) * hw * a.cin;
  for (int e = threadIdx.x; e < hw * a.cin_pad; e += blockDim.x) {
    const int p = e / a.cin_pad;
    const int c = e - p * a.cin_pad;
    xs[e] = c < a.cin ? xg[p * a.cin + c] : static_cast<int8_t>(0);
  }
  __syncthreads();

  // pw-expand + bias, /s_expand, ReLU6
  const int kc = a.cin_pad / 4;
  for (int e = threadIdx.x; e < hw * a.mid; e += blockDim.x) {
    const int p = e / a.mid;
    const int m = e - p * a.mid;
    const int* xv = reinterpret_cast<const int*>(xs + p * a.cin_pad);
    const int* wv = reinterpret_cast<const int*>(a.we + static_cast<size_t>(m) * a.cin_pad);
    int acc = 0;
    for (int k = 0; k < kc; ++k) acc = __dp4a(xv[k], __ldg(wv + k), acc);
    const int v = (acc + __ldg(a.be + m)) / a.s_expand;
    h1[e] = static_cast<int8_t>(min(max(v, 0), 6));
  }
  __syncthreads();

  // depthwise 3x3, zero padding, at the block's stride; /s_dw, ReLU6
  for (int e = threadIdx.x; e < ohw * a.mid_pad; e += blockDim.x) {
    const int op = e / a.mid_pad;
    const int m = e - op * a.mid_pad;
    if (m >= a.mid) {
      h2[e] = 0;
      continue;
    }
    const int oy = op / a.ow;
    const int ox = op - oy * a.ow;
    int acc = 0;
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = oy * a.stride + ky - 1;
      if (iy < 0 || iy >= a.h) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = ox * a.stride + kx - 1;
        if (ix < 0 || ix >= a.w) continue;
        acc += static_cast<int>(h1[(iy * a.w + ix) * a.mid + m]) *
               static_cast<int>(__ldg(a.dw + m * 9 + ky * 3 + kx));
      }
    }
    const int v = acc / a.s_dw;
    h2[e] = static_cast<int8_t>(min(max(v, 0), 6));
  }
  __syncthreads();

  // pw-project, /s_project, clamp +-127
  const int km = a.mid_pad / 4;
  int8_t* og = a.out + static_cast<size_t>(b) * ohw * a.cout;
  for (int e = threadIdx.x; e < ohw * a.cout; e += blockDim.x) {
    const int op = e / a.cout;
    const int o = e - op * a.cout;
    const int* hv = reinterpret_cast<const int*>(h2 + op * a.mid_pad);
    const int* wv = reinterpret_cast<const int*>(a.wp + static_cast<size_t>(o) * a.mid_pad);
    int acc = 0;
    for (int k = 0; k < km; ++k) acc = __dp4a(hv[k], __ldg(wv + k), acc);
    const int v = acc / a.s_project;
    og[e] = static_cast<int8_t>(min(max(v, -127), 127));
  }
}

}  // namespace

extern "C" {

// Shared memory one image of the block needs, in bytes.
int etiny_block_smem(int h, int w, int cin_pad, int mid, int mid_pad, int oh, int ow) {
  return align16(h * w * cin_pad) + align16(h * w * mid) + align16(oh * ow * mid_pad);
}

int etiny_block_launch(
    const void* x, int batch, int h, int w, int cin, int mid, int cout,
    int stride, int oh, int ow, int s_expand, int s_dw, int s_project,
    const void* we, const void* be, const void* dw, const void* wp, void* out,
    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || mid <= 0 || cout <= 0 ||
      stride <= 0 || s_expand <= 0 || s_dw <= 0 || s_project <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.h = h; a.w = w; a.cin = cin; a.cin_pad = (cin + 3) & ~3;
  a.mid = mid; a.mid_pad = (mid + 3) & ~3; a.cout = cout;
  a.stride = stride; a.oh = oh; a.ow = ow;
  a.s_expand = s_expand; a.s_dw = s_dw; a.s_project = s_project;
  a.we = static_cast<const int8_t*>(we);
  a.be = static_cast<const int*>(be);
  a.dw = static_cast<const int8_t*>(dw);
  a.wp = static_cast<const int8_t*>(wp);
  a.out = static_cast<int8_t*>(out);
  const int smem = etiny_block_smem(h, w, a.cin_pad, mid, a.mid_pad, oh, ow);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        etiny_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  etiny_block_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
