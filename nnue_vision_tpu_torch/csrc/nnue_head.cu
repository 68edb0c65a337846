// Bit-exact int8 NNUE inference kernels for Hopper (sm_90a).
//
// Two kernels share one __device__ head routine:
//
//   nnue_mega_kernel  replaces nnue_vision_tpu/ops/pallas_kernels.py
//                     _mega_kernel + _head_body (nnue_engine_forward_mega):
//                     flat HWC image -> logits (+ active count).
//   nnue_head_kernel  replaces _head_kernel + _head_body (_fused_head_call,
//                     behind nnue_engine_forward_fused and fused_nnue_head):
//                     int32 conv accumulator -> logits (+ active count).
//
// nnue_mega_kernel is a template on the last stage it runs (Stage below).
// The full instantiation is the serving kernel. The cut ones,
// nnue_mega_stage_kernel in the launch counts, replace the profiling probe
// scripts/profile_mega_bisect.py make_stage_call (its inner `kernel`): they
// run the same code up to the end of one stage, for every feature, and
// write the first 128 values that stage left in shared memory as float32
// (exact: every integer there is below 2^24). A cut kernel is bound like
// the full one, by the image read and then by the head's L2 reads; the
// stage split measures where the full kernel's time goes, one block of 256
// threads per image, not the TPU's tiled matmul form. Every stage writes
// shared memory that later threads read after a barrier, so nvcc cannot
// drop a cut stage's work.
//
// Both compute the engine's integers directly in int32, as the C++ engine
// does. The TPU version lifted the conv to a dense (H*W*3, FR) matrix
// (conv_as_matrix, ~100x FLOP padding, 3 MB operand) and fed every dot in
// bf16 inside its exact-integer window; neither is needed here, so neither
// the |qx| <= 256 precondition nor the f32 fallback carries over.
//
// What bounds these kernels on the card, and what the design does about it:
// * The image read. At batch 8192 the f32 images are 100 MB, read once from
//   HBM. One block per image stages its image in shared memory (12 KB at
//   32x32) with coalesced loads; the conv then reads only shared memory.
//   (input_mode="qbf16" halves those bytes.)
// * L2 traffic of the weights. Every block reads the rows of the int16 FT
//   table for its active features (~20-30% of FR at the flagship) and the
//   int8 dense weights (fc1 is 128 KB). The whole table (1.6 MB) and the
//   dense weights stay resident in the 50 MB L2, so these reads are L2
//   hits: ~400 KB per image. The FT is a sparse row sum over the compacted
//   active list rather than a dense masked matmul, as in the C++ engine's
//   accumulator: at ~25% density it reads a quarter of the table. Loads are
//   wide (8 bytes of FT row, 16 bytes of dense weights with __dp4a) so that
//   the L2's bandwidth, not the count of load instructions, is the limit.
// * Launch and synchronisation overhead at small batch: one launch per
//   forward, no intermediate ever goes to device memory.
// Tensor cores (wgmma on int8), TMA and persistent blocks are later work.
//
// C interface (ctypes): each launcher returns cudaGetLastError() after the
// launch; the Python wrapper raises if it is not 0. Kernels launch on the
// caller's stream and allocate nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStaticSmem = 48 * 1024;

// The stages of nnue_mega_kernel, in order; the template argument names the
// last one run. kStage stages the raw image, kQuant quantizes it as it is
// staged, kConv adds the conv, kFT the epilogue, threshold and FT, kFull the
// pairwise and dense layers (the serving kernel).
enum Stage : int { kStage = 0, kQuant = 1, kConv = 2, kFT = 3, kFull = 4 };
constexpr int kStageOut = 128;  // values a cut kernel writes per image

// out[img, :kStageOut] = float(v[:kStageOut]) for a cut kernel.
template <typename T>
__device__ inline void write_stage(const T* v, int img, float* out) {
  for (int t = threadIdx.x; t < kStageOut; t += blockDim.x)
    out[static_cast<size_t>(img) * kStageOut + t] = static_cast<float>(v[t]);
}

struct HeadArgs {
  float thresh;          // engine threshold as float32
  int n_pad;             // zero-valued padding features (F - FR)
  int fr, l1, l2, l3, nc;
  int qone, s1, s2, conv_scale;
  float out_scale;
  const int* padsum;     // (l1,) sum of ft_w rows FR..F-1
  const int16_t* ft_w;   // (F, l1); rows < FR are read
  const int* ft_b;       // (l1,)
  const int8_t* fc1_w;   // (l2, l1)
  const int* fc1_b;
  const int8_t* fc2_w;   // (l3, l2)
  const int* fc2_b;
  const int8_t* out_w;   // (nc, l3)
  const int* out_b;
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared-memory bytes of the head routine (mirrored by the Python wrapper's
// _head_smem_bytes, which checks the 48 KB limit before launching): active
// list, FT accumulator and counter as int32, then the int8 activations.
__host__ __device__ inline int head_smem_bytes(int fr, int l1, int l2, int l3) {
  return align16(4 * (fr + l1 + 1)) + align16(l1) + align16(l2) + align16(l3);
}

__device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int16 wraparound of an accumulator whose low 16 bits are exact, then the
// clipped ReLU [0, qone].
__device__ inline int wrap16_relu(uint32_t s, int qone) {
  int v = static_cast<int>(s & 0xFFFFu);
  if (v >= 32768) v -= 65536;
  return clampi(v, 0, qone);
}

__device__ inline int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// x . w for one output row, summed over the warp (lane 0 holds the result).
// Activations are int8 in [0, 127]; with n_in a multiple of 16 each lane
// takes 16 bytes at a time and multiplies with __dp4a.
__device__ inline int dense_row(const int8_t* x, const int8_t* w, int n_in, int lane) {
  int s = 0;
  if ((n_in & 15) == 0) {
    const int4* x4 = reinterpret_cast<const int4*>(x);
    const int4* w4 = reinterpret_cast<const int4*>(w);
    for (int i = lane; i < (n_in >> 4); i += 32) {
      const int4 xv = x4[i];
      const int4 wv = __ldg(w4 + i);
      s = __dp4a(xv.x, wv.x, s);
      s = __dp4a(xv.y, wv.y, s);
      s = __dp4a(xv.z, wv.z, s);
      s = __dp4a(xv.w, wv.w, s);
    }
  } else {
    for (int i = lane; i < n_in; i += 32) s += static_cast<int>(x[i]) * static_cast<int>(w[i]);
  }
  return warp_sum(s);
}

// The engine's post-conv pipeline for one image (block). `acc` holds the FR
// int32 conv accumulators (shared or global memory); `smem` has
// head_smem_bytes() of 16-byte aligned scratch. With kStop == kFT it stops
// after the FT and writes the clipped FT to `logits` as (B, kStageOut).
template <int kStop>
__device__ void head_routine(const HeadArgs& a, const int* acc, unsigned char* smem,
                             int img, float* logits, int* count) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  int* s_idx = reinterpret_cast<int*>(smem);  // active feature indices
  int* s_ft = s_idx + a.fr;                   // clipped FT accumulator
  int* s_cnt = s_ft + a.l1;
  int8_t* s_pw = reinterpret_cast<int8_t*>(smem + align16(4 * (a.fr + a.l1 + 1)));
  int8_t* s_h1 = s_pw + align16(a.l1);
  int8_t* s_h2 = s_h1 + align16(a.l2);

  if (tid == 0) *s_cnt = 0;
  __syncthreads();

  // 1-3. epilogue clamp(acc / scale, +-127) (C division truncates), float
  // threshold compare, compaction of the active features.
  for (int f = tid; f < a.fr; f += blockDim.x) {
    int v = acc[f];
    if (a.conv_scale != 1) v = clampi(v / a.conv_scale, -127, 127);
    if (static_cast<float>(v) > a.thresh) s_idx[atomicAdd(s_cnt, 1)] = f;
  }
  __syncthreads();
  const int n_act = *s_cnt;
  const bool pad_active = 0.0f > a.thresh;  // padding features hold 0

  // 4-5. FT as a sparse row sum over the active rows. Each thread owns four
  // adjacent columns, read as one 8-byte load per row; the sums are unsigned
  // and add each weight's low 16 bits, so the int16 wrap of the engine's
  // accumulator is exact for any weights. Requires l1 % 4 == 0.
  const int groups = a.l1 >> 2;
  const uint2* w4 = reinterpret_cast<const uint2*>(a.ft_w);
  for (int g = tid; g < groups; g += blockDim.x) {
    const int j = g << 2;
    uint32_t s0 = a.ft_b[j], s1 = a.ft_b[j + 1], s2 = a.ft_b[j + 2], s3 = a.ft_b[j + 3];
    if (pad_active) {
      s0 += a.padsum[j]; s1 += a.padsum[j + 1]; s2 += a.padsum[j + 2]; s3 += a.padsum[j + 3];
    }
#pragma unroll 4
    for (int k = 0; k < n_act; ++k) {
      const uint2 v = __ldg(w4 + static_cast<size_t>(s_idx[k]) * groups + g);
      s0 += v.x & 0xFFFFu;
      s1 += v.x >> 16;
      s2 += v.y & 0xFFFFu;
      s3 += v.y >> 16;
    }
    s_ft[j] = wrap16_relu(s0, a.qone);
    s_ft[j + 1] = wrap16_relu(s1, a.qone);
    s_ft[j + 2] = wrap16_relu(s2, a.qone);
    s_ft[j + 3] = wrap16_relu(s3, a.qone);
  }
  __syncthreads();
  if constexpr (kStop == kFT) {
    write_stage(s_ft, img, logits);
    return;
  }

  // 6. pairwise: clamp((a*b)/128, 0, 127) || clamp(a, 0, 127), as int8.
  const int half = a.l1 / 2;
  for (int j = tid; j < half; j += blockDim.x) {
    const int x = s_ft[j], y = s_ft[half + j];
    s_pw[j] = static_cast<int8_t>(clampi((x * y) / 128, 0, 127));
    s_pw[half + j] = static_cast<int8_t>(clampi(x, 0, 127));
  }
  __syncthreads();

  // 7. one warp per output row: fc1 /s1 clamp [0,127]; fc2 /s2 clamp +-127
  // then ReLU; out.
  for (int o = warp; o < a.l2; o += nwarps) {
    const int s = dense_row(s_pw, a.fc1_w + static_cast<size_t>(o) * a.l1, a.l1, lane);
    if (lane == 0) s_h1[o] = static_cast<int8_t>(clampi((s + a.fc1_b[o]) / a.s1, 0, 127));
  }
  __syncthreads();
  for (int o = warp; o < a.l3; o += nwarps) {
    const int s = dense_row(s_h1, a.fc2_w + static_cast<size_t>(o) * a.l2, a.l2, lane);
    if (lane == 0) s_h2[o] = static_cast<int8_t>(clampi((s + a.fc2_b[o]) / a.s2, 0, 127));
  }
  __syncthreads();
  // 8. logits (float)acc / out_scale (IEEE division: built without fast math).
  for (int o = warp; o < a.nc; o += nwarps) {
    const int s = dense_row(s_h2, a.out_w + static_cast<size_t>(o) * a.l3, a.l3, lane);
    if (lane == 0)
      logits[static_cast<size_t>(img) * a.nc + o] =
          static_cast<float>(s + a.out_b[o]) / a.out_scale;
  }
  if (count != nullptr && tid == 0) count[img] = n_act + (pad_active ? a.n_pad : 0);
}

struct ConvArgs {
  const void* images;   // (B, H*W*3) float32, or int-valued bfloat16
  int bf16_input;
  int h, w, stride, oh, ow, channels;
  float in_scale;
  const int* conv_w;    // (C, 3, 3, 3) OIHW
  const int* conv_b;    // (C,)
};

__host__ __device__ inline int mega_smem_bytes(int hw3, int channels, int fr, int l1,
                                               int l2, int l3) {
  return align16(4 * (hw3 + channels * 27 + fr)) + head_smem_bytes(fr, l1, l2, l3);
}

// int32(x * scale): an f32 multiply (never fused), then C truncation
// (engine_sim.py:115-117).
__device__ inline int quantize(float x, float scale) {
  return static_cast<int>(__fmul_rn(x, scale));
}

// An integer-valued bfloat16 (its bits) as int32; exact.
__device__ inline int bf16_int(uint32_t bits) {
  return static_cast<int>(__uint_as_float((bits & 0xFFFFu) << 16));
}

// 3x3 pad-1 strided conv + bias in int32 from the staged image `s_q` and
// weights `s_cw` into `s_acc`, feature f = (i*ow + j)*C + ch (NHWC flat
// order of the engine's conv buffer).
__device__ inline void conv_stage(const ConvArgs& c, int fr, const int* s_q,
                                  const int* s_cw, int* s_acc) {
  for (int f = threadIdx.x; f < fr; f += blockDim.x) {
    const int ch = f % c.channels, pos = f / c.channels;
    const int i = pos / c.ow, j = pos % c.ow;
    const int* wc = s_cw + ch * 27;  // [cin][kh][kw]
    int acc = c.conv_b[ch];
    for (int kh = 0; kh < 3; ++kh) {
      const int y = i * c.stride + kh - 1;
      if (y < 0 || y >= c.h) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int x = j * c.stride + kw - 1;
        if (x < 0 || x >= c.w) continue;
        const int* px = s_q + (y * c.w + x) * 3;
        const int k = kh * 3 + kw;
        acc += px[0] * wc[k] + px[1] * wc[9 + k] + px[2] * wc[18 + k];
      }
    }
    s_acc[f] = acc;
  }
}

template <int kStop>
__global__ void __launch_bounds__(kThreads)
nnue_mega_kernel(ConvArgs c, HeadArgs a, float* logits, int* count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x;
  const int hw3 = c.h * c.w * 3;
  int* s_q = reinterpret_cast<int*>(smem);  // quantized image, (H, W, 3)
  int* s_cw = s_q + hw3;                    // conv weights
  int* s_acc = s_cw + c.channels * 27;      // FR conv accumulators

  // Stage the quantized image in shared memory, 16 bytes per thread and
  // load where the image is a multiple of 4 values (kStage: the raw float
  // bits, unquantized).
  const float* xf = static_cast<const float*>(c.images) + static_cast<size_t>(img) * hw3;
  const uint16_t* xb = static_cast<const uint16_t*>(c.images) + static_cast<size_t>(img) * hw3;
  if ((hw3 & 3) == 0) {
    for (int v = threadIdx.x; v < (hw3 >> 2); v += blockDim.x) {
      int4 q;
      if (c.bf16_input) {
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(xb) + v);
        q = make_int4(bf16_int(b.x), bf16_int(b.x >> 16), bf16_int(b.y), bf16_int(b.y >> 16));
      } else {
        const float4 f = __ldg(reinterpret_cast<const float4*>(xf) + v);
        if constexpr (kStop == kStage)
          q = make_int4(__float_as_int(f.x), __float_as_int(f.y),
                        __float_as_int(f.z), __float_as_int(f.w));
        else
          q = make_int4(quantize(f.x, c.in_scale), quantize(f.y, c.in_scale),
                        quantize(f.z, c.in_scale), quantize(f.w, c.in_scale));
      }
      reinterpret_cast<int4*>(s_q)[v] = q;
    }
  } else {
    for (int v = threadIdx.x; v < hw3; v += blockDim.x)
      s_q[v] = c.bf16_input ? bf16_int(xb[v])
               : kStop == kStage ? __float_as_int(xf[v]) : quantize(xf[v], c.in_scale);
  }
  for (int t = threadIdx.x; t < c.channels * 27; t += blockDim.x) s_cw[t] = c.conv_w[t];
  __syncthreads();
  if constexpr (kStop == kStage) {
    write_stage(reinterpret_cast<const float*>(s_q), img, logits);
  } else if constexpr (kStop == kQuant) {
    write_stage(s_q, img, logits);
  } else {
    conv_stage(c, a.fr, s_q, s_cw, s_acc);
    __syncthreads();
    if constexpr (kStop == kConv)
      write_stage(s_acc, img, logits);
    else
      head_routine<kStop>(a, s_acc, smem + align16(4 * (hw3 + c.channels * 27 + a.fr)),
                          img, logits, count);
  }
}

__global__ void __launch_bounds__(kThreads)
nnue_head_kernel(const int* acc, HeadArgs a, float* logits, int* count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x;
  head_routine<kFull>(a, acc + static_cast<size_t>(img) * a.fr, smem, img, logits, count);
}

HeadArgs make_head(float thresh, int n_pad, int fr, int l1, int l2, int l3, int nc,
                   int qone, int s1, int s2, int conv_scale, float out_scale,
                   const void* padsum, const void* ft_w, const void* ft_b,
                   const void* fc1_w, const void* fc1_b, const void* fc2_w,
                   const void* fc2_b, const void* out_w, const void* out_b) {
  HeadArgs a;
  a.thresh = thresh; a.n_pad = n_pad;
  a.fr = fr; a.l1 = l1; a.l2 = l2; a.l3 = l3; a.nc = nc;
  a.qone = qone; a.s1 = s1; a.s2 = s2; a.conv_scale = conv_scale;
  a.out_scale = out_scale;
  a.padsum = static_cast<const int*>(padsum);
  a.ft_w = static_cast<const int16_t*>(ft_w);
  a.ft_b = static_cast<const int*>(ft_b);
  a.fc1_w = static_cast<const int8_t*>(fc1_w);
  a.fc1_b = static_cast<const int*>(fc1_b);
  a.fc2_w = static_cast<const int8_t*>(fc2_w);
  a.fc2_b = static_cast<const int*>(fc2_b);
  a.out_w = static_cast<const int8_t*>(out_w);
  a.out_b = static_cast<const int*>(out_b);
  return a;
}

// nnue_mega_kernel<stop> on `stream`: its shared memory and argument checks,
// then cudaGetLastError().
int mega_launch(
    int stop, const void* images, int bf16_input, int batch, int h, int w,
    int stride, int oh, int ow, int channels, float in_scale, const void* conv_w,
    const void* conv_b,
    float thresh, int n_pad, int fr, int l1, int l2, int l3, int nc,
    int qone, int s1, int s2, int conv_scale, float out_scale,
    const void* padsum, const void* ft_w, const void* ft_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* out_w, const void* out_b,
    void* logits, void* count, void* stream) {
  const int smem = mega_smem_bytes(h * w * 3, channels, fr, l1, l2, l3);
  if (smem > kMaxStaticSmem || batch <= 0 || (l1 & 3)) return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs c;
  c.images = images; c.bf16_input = bf16_input;
  c.h = h; c.w = w; c.stride = stride; c.oh = oh; c.ow = ow; c.channels = channels;
  c.in_scale = in_scale;
  c.conv_w = static_cast<const int*>(conv_w);
  c.conv_b = static_cast<const int*>(conv_b);
  const HeadArgs a = make_head(thresh, n_pad, fr, l1, l2, l3, nc, qone, s1, s2,
                               conv_scale, out_scale, padsum, ft_w, ft_b, fc1_w,
                               fc1_b, fc2_w, fc2_b, out_w, out_b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(logits);
  int* cnt = static_cast<int*>(count);
  switch (stop) {
    case kStage: nnue_mega_kernel<kStage><<<batch, kThreads, smem, s>>>(c, a, out, cnt); break;
    case kQuant: nnue_mega_kernel<kQuant><<<batch, kThreads, smem, s>>>(c, a, out, cnt); break;
    case kConv: nnue_mega_kernel<kConv><<<batch, kThreads, smem, s>>>(c, a, out, cnt); break;
    case kFT: nnue_mega_kernel<kFT><<<batch, kThreads, smem, s>>>(c, a, out, cnt); break;
    case kFull: nnue_mega_kernel<kFull><<<batch, kThreads, smem, s>>>(c, a, out, cnt); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* nnue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int nnue_mega_launch(
    const void* images, int bf16_input, int batch, int h, int w, int stride,
    int oh, int ow, int channels, float in_scale, const void* conv_w,
    const void* conv_b,
    float thresh, int n_pad, int fr, int l1, int l2, int l3, int nc,
    int qone, int s1, int s2, int conv_scale, float out_scale,
    const void* padsum, const void* ft_w, const void* ft_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* out_w, const void* out_b,
    void* logits, void* count, void* stream) {
  return mega_launch(kFull, images, bf16_input, batch, h, w, stride, oh, ow, channels,
                     in_scale, conv_w, conv_b, thresh, n_pad, fr, l1, l2, l3, nc, qone,
                     s1, s2, conv_scale, out_scale, padsum, ft_w, ft_b, fc1_w, fc1_b,
                     fc2_w, fc2_b, out_w, out_b, logits, count, stream);
}

// The cut kernel nnue_mega_kernel<level>, level 0..3, on float32 images:
// out (B, 128) float32. Needs H*W*3, FR and L1 all >= 128.
int nnue_mega_stage_launch(
    int level, const void* images, int batch, int h, int w, int stride,
    int oh, int ow, int channels, float in_scale, const void* conv_w,
    const void* conv_b,
    float thresh, int n_pad, int fr, int l1, int l2, int l3, int nc,
    int qone, int s1, int s2, int conv_scale, float out_scale,
    const void* padsum, const void* ft_w, const void* ft_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* out_w, const void* out_b,
    void* out, void* stream) {
  if (level < kStage || level >= kFull || h * w * 3 < kStageOut || fr < kStageOut ||
      l1 < kStageOut)
    return static_cast<int>(cudaErrorInvalidValue);
  return mega_launch(level, images, 0, batch, h, w, stride, oh, ow, channels,
                     in_scale, conv_w, conv_b, thresh, n_pad, fr, l1, l2, l3, nc, qone,
                     s1, s2, conv_scale, out_scale, padsum, ft_w, ft_b, fc1_w, fc1_b,
                     fc2_w, fc2_b, out_w, out_b, out, nullptr, stream);
}

int nnue_head_launch(
    const void* acc, int batch,
    float thresh, int n_pad, int fr, int l1, int l2, int l3, int nc,
    int qone, int s1, int s2, int conv_scale, float out_scale,
    const void* padsum, const void* ft_w, const void* ft_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* out_w, const void* out_b,
    void* logits, void* count, void* stream) {
  const int smem = head_smem_bytes(fr, l1, l2, l3);
  if (smem > kMaxStaticSmem || batch <= 0 || (l1 & 3)) return static_cast<int>(cudaErrorInvalidValue);
  const HeadArgs a = make_head(thresh, n_pad, fr, l1, l2, l3, nc, qone, s1, s2,
                               conv_scale, out_scale, padsum, ft_w, ft_b, fc1_w,
                               fc1_b, fc2_w, fc2_b, out_w, out_b);
  nnue_head_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), a, static_cast<float*>(logits),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
