// Bit-exact int8 NNUE inference kernels for Hopper (sm_90a), on the int8
// tensor cores.
//
// Two kernels share one __device__ head routine (head_tail):
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
// run the same code up to the end of one stage, for every feature of every
// image of the tile, and write the first 128 values per image that stage
// left (the staged image, the quantized image, the conv accumulator, the
// clipped FT) as float32 (exact: every integer there is below 2^24).
//
// Both compute the engine's integers exactly, as the C++ engine does: the
// conv and the CUDA-core layers in int32, the FT and fc1 as int8 x int8
// tensor-core products summed in int32 (int8_mma.cuh). The TPU version
// lifted the conv to a dense (H*W*3, FR) matrix and fed every dot in bf16
// inside its exact-integer window; neither is needed here, so neither the
// |qx| <= 256 precondition nor the f32 fallback carries over.
//
// What bounded them before: the head's cache reads, one block of threads
// per image summing its ~216 active rows of the FT table (2 KB each) and
// reading all of fc1 (128 KB) again for every image. The design, after the
// TPU kernel's dense mask . table product on its matrix unit: one block of
// threads takes a tile of T images (63 at batch 8192; at a small batch a
// tile of at most 8 images is split over a cluster of 2-8 blocks, so that
// the grid still fills the card), and the tile reads each weight once.
// * Two images at a time are staged in shared memory by cp.async, two
//   pairs ahead of the pair being used, then quantized once into int32;
//   the conv reads them from there (a thread keeps its channel's weights in
//   registers), and its epilogue and the float threshold write the tile's
//   0/1 mask rows (FR bytes each). The active count is the mask row's sum,
//   plus n_pad when 0 > thresh.
// * The FT is a dense product on the tensor cores: mask (T x FR, 0/1) times
//   the int16 table as two byte planes, lo = w & 0xFF (u8) and hi = w >> 8
//   (s8), so w = 256*hi + lo exactly. FT = lo_sum + 256*hi_sum + ft_b
//   (+ padsum) is exact in int32 (|sum| <= F*32768 + |bias|), and the
//   engine's int16 accumulator is its low 16 bits, then the clipped ReLU.
//   Each chunk of the product covers 32 columns of each half of L1, so the
//   pairwise layer (int8, into shared memory) follows each chunk.
// * fc1 is the second product, (T x L1 int8) . (L1 x L2 int8), its tiles
//   streamed once per tile of images. fc2 and the output layer stay on CUDA
//   cores (__dp4a); logits are (float)acc / out_scale, IEEE division.
//
// What bounds them now (PERF.md, PR 5, batch 8192): the FT product, about
// half of the kernel, at the rate mma.sync and its ldmatrix feeds reach
// with one block of 8 warps per SM; then the conv and the image read from
// device memory (100 MB of f32; input_mode="qbf16" halves it), which a
// block does before its products, so the two do not overlap.
//
// C interface (ctypes): each launcher takes one packed argument
// (launch_args.cuh) and returns cudaGetLastError() after the launch; the
// Python wrapper raises if it is not 0. Kernels launch on the
// caller's stream and allocate nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "launch_args.cuh"

namespace {

using namespace int8mma;

constexpr int kMaxSmem = 232448;  // what a block may use on sm_90
constexpr int kMaxTile = 64;      // images per block of threads
constexpr int kSplitTile = 8;     // images per tile split over a cluster, at most
constexpr int kMaxPairBufs = 3;   // staged pairs of images: two load ahead
constexpr int kStgStride = 136;   // int32 per row of a chunk's raw sums
constexpr int kFtChunkCols = 32;  // L1 columns of each half per FT chunk

// The stages of nnue_mega_kernel, in order; the template argument names the
// last one run. kStage stages the raw image, kQuant quantizes what it
// writes, kConv adds the conv, its epilogue and the threshold (the mask),
// kFT the FT product and the pairwise layer, kFull fc1, fc2 and the output
// layer (the serving kernel).
enum Stage : int { kStage = 0, kQuant = 1, kConv = 2, kFT = 3, kFull = 4 };
constexpr int kStageOut = 128;  // values a cut kernel writes per image

struct HeadArgs {
  float thresh;          // engine threshold as float32
  int n_pad;             // zero-valued padding features (F - FR)
  int fr, l1, l2, l3, nc;
  int qone, s1, s2, conv_scale;
  float out_scale;
  int ft_steps;          // K stages per chunk of ft_tiles: k_stages(F)
  const int* padsum;     // (l1,) sum of ft_w rows FR..F-1
  const uint8_t* ft_tiles;  // the FT byte planes as mma tiles
  const int* ft_b;       // (l1,)
  const uint8_t* fc1_tiles;  // fc1 (l2, l1) as mma tiles
  const int* fc1_b;
  const int8_t* fc2_w;   // (l3, l2)
  const int* fc2_b;
  const int8_t* out_w;   // (nc, l3)
  const int* out_b;
};

struct TileArgs {
  int batch;      // images in all
  int tile;       // images per block of threads
  int rows;       // rows of the products' A operands: 16, 32 or 64 >= tile
  int pair_bufs;  // buffers of two staged images (mega kernel): 1 to 3
  int slots;      // weight ring slots the products may use: 2 to kMaxSlots
  int split;      // blocks of threads per tile, one cluster: 1, 2, 4 or 8
};

// A block's tile and its rank among the tile's `split` blocks.
__device__ inline int tile_index(const TileArgs& t) { return blockIdx.x / t.split; }
__device__ inline int tile_rank(const TileArgs& t) { return blockIdx.x % t.split; }

__host__ __device__ inline int align128(int bytes) { return round_up(bytes, 128); }

// The mask's row stride: FR columns, zero up to the FT's K stages (rows
// FR.. of the FT table are the padding features' weights, not zeros).
__host__ __device__ inline int mask_stride(int fr) { return round_up(fr, kStageK) + 16; }

__host__ __device__ inline int ft_chunks(int l1) { return (l1 / 2 + kFtChunkCols - 1) / kFtChunkCols; }

// Row stride of fc1's and fc2's int8 outputs: whole words, and one word
// more so that rows read at the same column lie in different banks.
__host__ __device__ inline int dense_stride(int n) { return round_up(n, 16) + 4; }

// Shared-memory regions (mirrored by ops/nnue_kernels.py _smem_bytes):
// conv weights and biases and each feature's conv geometry (mega kernel
// only), the FT bias (+ padding sum) and fc1's bias, the mask, the pairwise activations, and one area
// that first holds the staged images (pair_bufs pairs) and the quantized
// pair, then a chunk's raw FT sums (later fc1's and fc2's int8 outputs)
// and the weight ring.
struct HeadSmem {
  int cw, feat, bias, mask, pw, sums, area, total;
  __host__ __device__ HeadSmem(int rows, int fr, int l1, int l2, int l3, int channels,
                               int image_bytes, int hw3, int pair_bufs, int slots) {
    cw = align128(4 * channels * 28);
    feat = channels > 0 ? align128(4 * fr) : 0;
    bias = align128(4 * (l1 + l2));
    mask = align128(rows * mask_stride(fr));
    pw = align128(a_region(rows, l1));
    const int stg = align128(4 * rows * kStgStride);
    const int dense = align128(rows * dense_stride(l2)) + align128(rows * dense_stride(l3));
    sums = stg > dense ? stg : dense;
    const int ft_slots = ring_slots(ft_chunks(l1) * k_stages(fr), slots);
    const int fc1_slots = ring_slots((l2 + kCols - 1) / kCols * k_stages(l1), slots);
    const int ring = (ft_slots > fc1_slots ? ft_slots : fc1_slots) * kSlotBytes;
    const int images = 2 * pair_bufs * align128(image_bytes) + 2 * align128(4 * hw3);
    area = sums + ring > images ? sums + ring : images;
    total = cw + feat + bias + mask + pw + area;
  }
  __host__ __device__ int mask_at() const { return cw + feat + bias; }
  __host__ __device__ int area_at() const { return cw + feat + bias + mask + pw; }
};

__device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int16 wraparound of a sum whose low 16 bits are exact, then the clipped
// ReLU [0, qone].
__device__ inline int wrap16_relu(uint32_t s, int qone) {
  int v = static_cast<int>(s & 0xFFFFu);
  if (v >= 32768) v -= 65536;
  return clampi(v, 0, qone);
}

__device__ inline int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// x . w over n int8 values, x in shared memory, w in device memory.
__device__ inline int dot(const int8_t* x, const int8_t* w, int n) {
  int s = 0;
  if ((n & 3) == 0) {
    const int* x4 = reinterpret_cast<const int*>(x);
    const int* w4 = reinterpret_cast<const int*>(w);
    for (int i = 0; i < (n >> 2); ++i) s = __dp4a(x4[i], __ldg(w4 + i), s);
  } else {
    for (int i = 0; i < n; ++i) s += static_cast<int>(x[i]) * static_cast<int>(w[i]);
  }
  return s;
}

// The conv epilogue and threshold of one feature: clamp(acc / scale, +-127)
// (C division truncates; skipped at scale 1), then the float compare.
__device__ inline int8_t active(int acc, const HeadArgs& a) {
  if (a.conv_scale != 1) acc = clampi(acc / a.conv_scale, -127, 127);
  return static_cast<float>(acc) > a.thresh ? 1 : 0;
}

// Everything after the mask, for the tile's n_img images: the active
// counts, the FT product and pairwise layer, fc1, fc2, the logits. With
// kStop == kFT it stops after the FT and writes the first 128 clipped FT
// values per image to `out` as (B, 128).
//
// A tile split over a cluster of t.split blocks (small batches, so that
// the FT table's reads spread over more SMs): every block holds the tile's
// mask, rank r multiplies FT chunks r, r + split, ... and stores their
// pairwise values into rank 0's shared memory; after the cluster's
// barrier rank 0 alone runs fc1 onwards.
template <int kStop, int kMW, int kWM>
__device__ void head_tail(const HeadArgs& a, const TileArgs& t, const HeadSmem& sm,
                          unsigned char* smem, int img0, int n_img, float* out, int* count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldm = mask_stride(a.fr), ldp = a_stride(a.l1);
  int* bias = reinterpret_cast<int*>(smem + sm.cw + sm.feat);
  const int8_t* mask = reinterpret_cast<const int8_t*>(smem + sm.mask_at());
  int8_t* pw = reinterpret_cast<int8_t*>(smem + sm.mask_at() + sm.mask);
  unsigned char* area = smem + sm.area_at();
  int* stg = reinterpret_cast<int*>(area);
  unsigned char* ring = area + sm.sums;
  const bool pad_active = 0.0f > a.thresh;  // padding features hold 0
  const int rank = tile_rank(t);
  namespace cg = cooperative_groups;
  if (t.split > 1) {
    cg::this_cluster().sync();  // every block of the cluster runs
    pw = cg::this_cluster().map_shared_rank(pw, 0);
  }

  // the FT bias, with the padding rows' sum when they are active, and
  // fc1's bias, in shared memory (the products' first barrier orders these
  // stores before their reads; an epilogue reading device memory would
  // wait on it once per value)
  for (int j = tid; j < a.l1; j += kThreads)
    bias[j] = __ldg(a.ft_b + j) + (pad_active ? __ldg(a.padsum + j) : 0);
  int* fc1_bias = bias + a.l1;
  for (int n = tid; n < a.l2; n += kThreads) fc1_bias[n] = __ldg(a.fc1_b + n);

  // the active count: the mask row's sum (+ n_pad)
  if (count != nullptr && rank == 0) {
    const int words = round_up(a.fr, 4) >> 2;
    for (int row = warp; row < n_img; row += kThreads / 32) {
      const int* m4 = reinterpret_cast<const int*>(mask + row * ldm);
      int s = 0;
      for (int k = lane; k < words; k += 32) s = __dp4a(m4[k], 0x01010101, s);
      s = warp_sum(s);
      if (lane == 0) count[img0 + row] = s + (pad_active ? a.n_pad : 0);
    }
  }

  // FT: mask . (lo, hi) planes. A chunk's 128 columns are the lo plane of
  // L1 columns 32c..32c+31 and half+32c.., then the hi plane of the same.
  const int half = a.l1 >> 1;
  const int* __restrict__ ft_bias = bias;
  auto ft_value = [&](int lo, int hi, int j) {
    const uint32_t s = static_cast<uint32_t>(lo) + static_cast<uint32_t>(hi) * 256u +
                       static_cast<uint32_t>(ft_bias[j]);
    return wrap16_relu(s, a.qone);
  };
  const Chunks mine{rank, t.split, (ft_chunks(a.l1) - rank + t.split - 1) / t.split};
  if (mine.count > 0) stream_gemm<kMW, kWM>(
      mask, ldm, 1, a.ft_tiles, mine, a.fr, ft_chunks(a.l1) * kCols, a.ft_steps, 64, ring,
      t.slots, tile_index(t), [] {},
      [&](int, int c, const auto& acc, int row0, int col0) {
        for_each_sum(acc, row0, col0, [&](int r, int col, int v) { stg[r * kStgStride + col] = v; });
        __syncthreads();
        // 6. pairwise: clamp((x*y)/128, 0, 127) || clamp(x, 0, 127), as int8.
        const int* __restrict__ sums = stg;
        int8_t* __restrict__ pwd = pw;
        for (int e = tid; e < n_img * kFtChunkCols; e += kThreads) {
          const int row = e / kFtChunkCols, i = e % kFtChunkCols, j = c * kFtChunkCols + i;
          if (j >= half) continue;
          const int* sr = sums + row * kStgStride;
          const int x = ft_value(sr[i], sr[64 + i], j);
          const int y = ft_value(sr[32 + i], sr[96 + i], half + j);
          pwd[row * ldp + j] = static_cast<int8_t>(clampi((x * y) / 128, 0, 127));
          pwd[row * ldp + half + j] = static_cast<int8_t>(clampi(x, 0, 127));
          if constexpr (kStop == kFT) {
            float* o = out + static_cast<size_t>(img0 + row) * kStageOut;
            if (j < kStageOut) o[j] = static_cast<float>(x);
            if (half + j < kStageOut) o[half + j] = static_cast<float>(y);
          }
        }
      });
  if (t.split > 1) {
    cg::this_cluster().sync();  // rank 0 holds every pairwise value
    if (rank != 0) return;
    pw = reinterpret_cast<int8_t*>(smem + sm.mask_at() + sm.mask);
  }
  if constexpr (kStop == kFT) return;

  // 7. fc1 on the tensor cores: /s1, clamp [0, 127].
  const int l2s = dense_stride(a.l2), l3s = dense_stride(a.l3);
  int8_t* h1 = reinterpret_cast<int8_t*>(area);
  int8_t* h2 = h1 + align128(t.rows * l2s);
  const int l1_steps = k_stages(a.l1);
  stream_gemm<kMW, kWM>(
      pw, ldp, 1, a.fc1_tiles, Chunks{0, 1, (a.l2 + kCols - 1) / kCols}, a.l1, a.l2, l1_steps, 0,
      ring, t.slots, tile_index(t), [] {},
      [&](int, int c, const auto& acc, int row0, int col0) {
        for_each_sum_col(
            acc, row0, c * kCols + col0, [&](int n) { return n < a.l2 ? fc1_bias[n] : 0; },
            [&](int r, int n, int v, int bias_n) {
              if (n < a.l2)
                h1[r * l2s + n] = static_cast<int8_t>(clampi((v + bias_n) / a.s1, 0, 127));
            });
      });

  // fc2 /s2 clamp +-127 then ReLU, on CUDA cores: neighbouring threads take
  // neighbouring images and one output row, read once for all of them.
  for (int e = tid; e < n_img * a.l3; e += kThreads) {
    const int o = e / n_img, row = e - o * n_img;
    const int s = dot(h1 + row * l2s, a.fc2_w + static_cast<size_t>(o) * a.l2, a.l2);
    h2[row * l3s + o] = static_cast<int8_t>(clampi((s + __ldg(a.fc2_b + o)) / a.s2, 0, 127));
  }
  __syncthreads();
  // 8. logits (float)acc / out_scale (IEEE division: built without fast math).
  for (int e = tid; e < n_img * a.nc; e += kThreads) {
    const int o = e / n_img, row = e - o * n_img;
    const int s = dot(h2 + row * l3s, a.out_w + static_cast<size_t>(o) * a.l3, a.l3);
    out[static_cast<size_t>(img0 + row) * a.nc + o] =
        static_cast<float>(s + __ldg(a.out_b + o)) / a.out_scale;
  }
}

// Zero the tile's mask (its padding columns and rows must read as inactive).
__device__ inline void zero_mask(unsigned char* mask, int bytes) {
  int4* m = reinterpret_cast<int4*>(mask);
  for (int i = threadIdx.x; i < (bytes >> 4); i += blockDim.x) m[i] = make_int4(0, 0, 0, 0);
}

struct ConvArgs {
  const void* images;   // (B, H*W*3) float32, or int-valued bfloat16
  int bf16_input;
  int h, w, stride, oh, ow, channels;
  float in_scale;
  const int* conv_w;    // (C, 3, 3, 3) OIHW
  const int* conv_b;    // (C,)
};

// int32(x * scale): an f32 multiply (never fused), then C truncation
// (engine_sim.py _quantize_input).
__device__ inline int quantize(float x, float scale) {
  return static_cast<int>(__fmul_rn(x, scale));
}

// An integer-valued bfloat16 (its bits) as int32; exact.
__device__ inline int bf16_int(uint32_t bits) {
  return static_cast<int>(__uint_as_float((bits & 0xFFFFu) << 16));
}

// The quantized value v of a staged image.
template <bool kBf16>
__device__ inline int pixel(const unsigned char* img, int v, float scale) {
  if constexpr (kBf16) return bf16_int(reinterpret_cast<const uint16_t*>(img)[v]);
  else return quantize(reinterpret_cast<const float*>(img)[v], scale);
}

// A feature's conv geometry, packed: channel, top row and left column of
// its 3x3 window (+1, so that they are >= 0).
__device__ inline int pack_feature(int f, const ConvArgs& c) {
  const int ch = f % c.channels, pos = f / c.channels;
  const int y0 = (pos / c.ow) * c.stride, x0 = (pos % c.ow) * c.stride;
  return ch | (y0 << 8) | (x0 << 20);
}

// 3x3 pad-1 conv + bias of a packed feature on one or two quantized
// images (kTwo), in int32; `w` holds the feature's channel's 27 weights
// and its bias.
template <bool kTwo>
__device__ inline void conv_feature(const ConvArgs& c, const int (&w)[28], int packed,
                                    const int* q0, const int* q1, int* acc0, int* acc1) {
  const int y0 = ((packed >> 8) & 0xFFF) - 1, x0 = (packed >> 20) - 1;
  int s0 = w[27], s1 = s0;  // the bias
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int y = y0 + kh;
    if (y < 0 || y >= c.h) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int x = x0 + kw;
      if (x < 0 || x >= c.w) continue;
      const int p = (y * c.w + x) * 3, k = kh * 3 + kw;  // w is [cin][kh][kw]
      s0 += q0[p] * w[k] + q0[p + 1] * w[9 + k] + q0[p + 2] * w[18 + k];
      if constexpr (kTwo) s1 += q1[p] * w[k] + q1[p + 1] * w[9 + k] + q1[p + 2] * w[18 + k];
    }
  }
  *acc0 = s0;
  *acc1 = s1;
}

// The conv, its epilogue and threshold of a pair's features into the mask
// rows (and the first 128 accumulators to `out0` at kConv). A thread keeps
// its channel's weights in registers (one channel per thread when the
// channel count divides the block).
template <int kStop, bool kTwo>
__device__ inline void conv_pair(const ConvArgs& c, const HeadArgs& a,
                                 const int* __restrict__ s_cw, const int* __restrict__ s_feat,
                                 const int* __restrict__ q0, const int* __restrict__ q1,
                                 int8_t* __restrict__ mrow0, int8_t* __restrict__ mrow1,
                                 float* __restrict__ out0) {
  int w[28];
  int wch = -1;
  for (int f = threadIdx.x; f < a.fr; f += kThreads) {
    const int packed = s_feat[f];
    if ((packed & 0xFF) != wch) {
      wch = packed & 0xFF;
#pragma unroll
      for (int k = 0; k < 27; ++k) w[k] = s_cw[wch * 27 + k];
      w[27] = s_cw[c.channels * 27 + wch];
    }
    int acc0, acc1;
    conv_feature<kTwo>(c, w, packed, q0, q1, &acc0, &acc1);
    if constexpr (kStop == kConv) {
      if (f < kStageOut) {
        out0[f] = static_cast<float>(acc0);
        if constexpr (kTwo) out0[kStageOut + f] = static_cast<float>(acc1);
      }
    }
    mrow0[f] = active(acc0, a);
    if constexpr (kTwo) mrow1[f] = active(acc1, a);
  }
}

// One pair of staged images (the second may be absent): the cut stage's
// output, or the quantized pair and then the conv, its epilogue and
// threshold into the mask rows.
template <int kStop>
__device__ inline void image_pair(const ConvArgs& c, const HeadArgs& a, const int* s_cw,
                                  const int* s_feat, const unsigned char* img0, bool two,
                                  int img_stride, int* q0, int8_t* mrow0, int ldm, float* out0) {
  const int hw3 = c.h * c.w * 3;
  int* q1 = q0 + hw3;
  const unsigned char* img1 = img0 + img_stride;
  if constexpr (kStop == kStage) {
    for (int v = threadIdx.x; v < kStageOut; v += kThreads) {
      out0[v] = reinterpret_cast<const float*>(img0)[v];
      if (two) out0[kStageOut + v] = reinterpret_cast<const float*>(img1)[v];
    }
    return;
  }
  {
    const unsigned char* __restrict__ i0 = img0;
    const unsigned char* __restrict__ i1 = img1;
    int* __restrict__ d0 = q0;
    int* __restrict__ d1 = q1;
#pragma unroll 4
    for (int v = threadIdx.x; v < hw3; v += kThreads) {
      if (c.bf16_input) {
        d0[v] = pixel<true>(i0, v, c.in_scale);
        if (two) d1[v] = pixel<true>(i1, v, c.in_scale);
      } else {
        d0[v] = pixel<false>(i0, v, c.in_scale);
        if (two) d1[v] = pixel<false>(i1, v, c.in_scale);
      }
    }
  }
  __syncthreads();
  if constexpr (kStop == kQuant) {
    for (int v = threadIdx.x; v < kStageOut; v += kThreads) {
      out0[v] = static_cast<float>(q0[v]);
      if (two) out0[kStageOut + v] = static_cast<float>(q1[v]);
    }
    return;
  }
  if (two)
    conv_pair<kStop, true>(c, a, s_cw, s_feat, q0, q1, mrow0, mrow0 + ldm, out0);
  else
    conv_pair<kStop, false>(c, a, s_cw, s_feat, q0, q1, mrow0, mrow0 + ldm, out0);
}

template <int kStop, int kMW, int kWM>
__global__ void __launch_bounds__(kThreads)
nnue_mega_kernel(ConvArgs c, HeadArgs a, TileArgs t, float* out, int* count) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw3 = c.h * c.w * 3;
  const int img_bytes = hw3 * (c.bf16_input ? 2 : 4);
  const HeadSmem sm(t.rows, a.fr, a.l1, a.l2, a.l3, c.channels, img_bytes, hw3, t.pair_bufs,
                    t.slots);
  int* s_cw = reinterpret_cast<int*>(smem);
  int* s_feat = reinterpret_cast<int*>(smem + sm.cw);
  unsigned char* mask = smem + sm.mask_at();
  unsigned char* bufs = smem + sm.area_at();
  const int ldm = mask_stride(a.fr);
  const int img0 = tile_index(t) * t.tile;
  const int n_img = min(t.tile, t.batch - img0);
  const int n_pairs = (n_img + 1) / 2;

  for (int i = threadIdx.x; i < c.channels * 27; i += kThreads) s_cw[i] = __ldg(c.conv_w + i);
  for (int i = threadIdx.x; i < c.channels; i += kThreads) s_cw[c.channels * 27 + i] = __ldg(c.conv_b + i);
  for (int f = threadIdx.x; f < a.fr; f += kThreads) s_feat[f] = pack_feature(f, c);
  zero_mask(mask, t.rows * ldm);

  // The image ring: pair p (images 2p, 2p + 1) lands in buffers 2(p % pb)
  // and 2(p % pb) + 1 by cp.async (16- or 4-byte pieces as the addresses
  // allow; 2-byte loads otherwise), pb - 1 pairs ahead of the pair used.
  const int buf_bytes = align128(img_bytes);
  const unsigned char* gimg =
      static_cast<const unsigned char*>(c.images) + static_cast<size_t>(img0) * img_bytes;
  const uintptr_t base = reinterpret_cast<uintptr_t>(c.images);
  const int piece = ((img_bytes | base) & 15) == 0 ? 16 : (((img_bytes | base) & 3) == 0 ? 4 : 2);
  const int pb = t.pair_bufs;
  int* qbuf = reinterpret_cast<int*>(bufs + 2 * pb * buf_bytes);  // the quantized pair
  auto issue = [&](int p) {
    for (int i = 2 * p; i < 2 * p + 2 && i < n_img; ++i) {
      unsigned char* dst = bufs + (2 * (p % pb) + (i & 1)) * buf_bytes;
      const unsigned char* src = gimg + static_cast<size_t>(i) * img_bytes;
      if (piece == 16) {
        for (int o = threadIdx.x * 16; o < img_bytes; o += kThreads * 16) cp_async16(dst + o, src + o);
      } else if (piece == 4) {
        for (int o = threadIdx.x * 4; o < img_bytes; o += kThreads * 4) cp_async4(dst + o, src + o);
      } else {
        for (int o = threadIdx.x; o < (img_bytes >> 1); o += kThreads)
          reinterpret_cast<uint16_t*>(dst)[o] = reinterpret_cast<const uint16_t*>(src)[o];
      }
    }
    cp_async_commit();
  };
  for (int p = 0; p < pb - 1; ++p) issue(p);

  for (int p = 0; p < n_pairs; ++p) {
    if (pb == 1) issue(p);  // one buffer pair: no load ahead
    cp_async_wait_upto(pb == 1 ? 0 : pb - 2);
    __syncthreads();  // pair p landed; the buffers of pair p - 1 are free
    if (pb > 1) issue(p + pb - 1);
    const int i = 2 * p;
    image_pair<kStop>(c, a, s_cw, s_feat, bufs + 2 * (p % pb) * buf_bytes, i + 1 < n_img,
                      buf_bytes, qbuf, reinterpret_cast<int8_t*>(mask + i * ldm), ldm,
                      out + static_cast<size_t>(img0 + i) * kStageOut);
    if (pb == 1) __syncthreads();  // the next pair reuses these buffers
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kStop >= kFT)
    head_tail<kStop, kMW, kWM>(a, t, sm, smem, img0, n_img, out, count);
}

template <int kMW, int kWM>
__global__ void __launch_bounds__(kThreads)
nnue_head_kernel(const int* acc, HeadArgs a, TileArgs t, float* logits, int* count) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadSmem sm(t.rows, a.fr, a.l1, a.l2, a.l3, 0, 0, 0, 0, t.slots);
  unsigned char* mask = smem + sm.mask_at();
  const int ldm = mask_stride(a.fr);
  const int img0 = tile_index(t) * t.tile;
  const int n_img = min(t.tile, t.batch - img0);
  zero_mask(mask, t.rows * ldm);
  __syncthreads();
  const int* __restrict__ ag = acc + static_cast<size_t>(img0) * a.fr;
  unsigned char* __restrict__ md = mask;
#pragma unroll 4
  for (int e = threadIdx.x; e < n_img * a.fr; e += kThreads) {
    const int row = e / a.fr, f = e - row * a.fr;
    md[row * ldm + f] = active(__ldg(ag + e), a);
  }
  __syncthreads();
  head_tail<kFull, kMW, kWM>(a, t, sm, smem, img0, n_img, logits, count);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// The tile. At a large batch: enough images per block of threads that the
// grid fills the SMs, at most kMaxTile. At a small one, the tile is split
// over a cluster of 2, 4 or 8 blocks, the most that still leaves tiles of
// at most kSplitTile images with a grid of one block per SM, so that the
// FT's table reads spread over more SMs (at batch 512 on the H100: 2
// blocks of 8 images each; at batch 1: 8 blocks). Then rows (16, 32 or 64) for the
// products, weight ring slots (kMaxSlots down to 2) and, in the mega kernel
// (hw3 > 0), up to kMaxPairBufs staged pairs: fewer pairs, then fewer
// slots, then fewer rows while the shared memory would not fit; false if
// nothing does. No split where `split_ok` is false (the cut kernels before
// the FT, whose blocks would all write the same values).
bool pick_tile(int batch, int fr, int l1, int l2, int l3, int channels, int image_bytes,
               int hw3, bool split_ok, TileArgs* t, int* smem) {
  const int sms = sm_count();
  int split = split_ok ? 8 : 1, tile = 0;
  for (; split > 1; split /= 2) {
    tile = (batch * split + sms - 1) / sms;
    if (tile <= kSplitTile) break;
  }
  if (split == 1) tile = (batch + sms - 1) / sms;
  if (tile > kMaxTile) tile = kMaxTile;
  for (int rows = tile <= 16 ? 16 : (tile <= 32 ? 32 : 64); rows >= 16; rows /= 2) {
    for (int slots = kMaxSlots; slots >= 2; --slots) {
      for (int pb = hw3 > 0 ? kMaxPairBufs : 0; pb >= (hw3 > 0 ? 1 : 0); --pb) {
        const int bytes =
            HeadSmem(rows, fr, l1, l2, l3, channels, image_bytes, hw3, pb, slots).total;
        if (bytes <= kMaxSmem) {
          t->batch = batch;
          t->tile = tile < rows ? tile : rows;
          t->rows = rows;
          t->pair_bufs = pb;
          t->slots = slots;
          t->split = split;
          *smem = bytes;
          return true;
        }
      }
    }
  }
  return false;
}

// Launch `kernel` over the tiles of `t`, a cluster of t.split blocks each.
template <class Kernel, class... Args>
cudaError_t launch_tiles(Kernel kernel, const TileArgs& t, int smem, cudaStream_t s,
                         Args... args) {
  if (t.split == 1) {
    kernel<<<(t.batch + t.tile - 1) / t.tile, kThreads, smem, s>>>(args...);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((t.batch + t.tile - 1) / t.tile * t.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  *done = err == cudaSuccess;
  return err;
}

template <int kStop, int kMW, int kWM>
cudaError_t run_mega(const ConvArgs& c, const HeadArgs& a, const TileArgs& t, int smem,
                     cudaStream_t s, float* out, int* cnt) {
  static bool done = false;
  const cudaError_t err = allow_smem(nnue_mega_kernel<kStop, kMW, kWM>, &done);
  if (err != cudaSuccess) return err;
  const cudaError_t launched = launch_tiles(nnue_mega_kernel<kStop, kMW, kWM>, t, smem, s, c, a,
                                            t, out, cnt);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// The mega kernel's instantiation for the tile's rows; the stages before
// the FT have no product and take one instantiation.
template <int kStop>
cudaError_t run_mega_rows(const ConvArgs& c, const HeadArgs& a, const TileArgs& t, int smem,
                          cudaStream_t s, float* out, int* cnt) {
  if constexpr (kStop < kFT) {
    return run_mega<kStop, 1, 1>(c, a, t, smem, s, out, cnt);
  } else {
    if (t.rows == 64) return run_mega<kStop, 2, 2>(c, a, t, smem, s, out, cnt);
    if (t.rows == 32) return run_mega<kStop, 2, 1>(c, a, t, smem, s, out, cnt);
    return run_mega<kStop, 1, 1>(c, a, t, smem, s, out, cnt);
  }
}

template <int kMW, int kWM>
cudaError_t run_head(const int* acc, const HeadArgs& a, const TileArgs& t, int smem,
                     cudaStream_t s, float* logits, int* cnt) {
  static bool done = false;
  const cudaError_t err = allow_smem(nnue_head_kernel<kMW, kWM>, &done);
  if (err != cudaSuccess) return err;
  const cudaError_t launched = launch_tiles(nnue_head_kernel<kMW, kWM>, t, smem, s, acc, a, t,
                                            logits, cnt);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// The 22 head words of a launcher's argument, in order: [thresh (f32),
// n_pad, fr, l1, l2, l3, nc, qone, s1, s2, conv_scale, out_scale (f32),
// ft_steps, padsum, ft_tiles, ft_b, fc1_tiles, fc1_b, fc2_w, fc2_b, out_w,
// out_b].
HeadArgs read_head(ArgReader& r) {
  HeadArgs a;
  a.thresh = r.f(); a.n_pad = r.i();
  a.fr = r.i(); a.l1 = r.i(); a.l2 = r.i(); a.l3 = r.i(); a.nc = r.i();
  a.qone = r.i(); a.s1 = r.i(); a.s2 = r.i(); a.conv_scale = r.i();
  a.out_scale = r.f(); a.ft_steps = r.i();
  a.padsum = r.ptr<const int>();
  a.ft_tiles = r.ptr<const uint8_t>();
  a.ft_b = r.ptr<const int>();
  a.fc1_tiles = r.ptr<const uint8_t>();
  a.fc1_b = r.ptr<const int>();
  a.fc2_w = r.ptr<const int8_t>();
  a.fc2_b = r.ptr<const int>();
  a.out_w = r.ptr<const int8_t>();
  a.out_b = r.ptr<const int>();
  return a;
}

bool head_ok(int batch, int fr, int l1) {
  return batch > 0 && fr > 0 && l1 > 0 && (l1 & 3) == 0;
}

// nnue_mega_kernel<stop> on the images at `images`, the rest of its words
// read from `r`: [batch, h, w, stride, oh, ow, channels, in_scale (f32),
// conv_w, conv_b, the head's 22, out, count (kFull only), stream]. Its
// tile, shared memory and argument checks, then cudaGetLastError().
int mega_launch(int stop, const void* images, int bf16_input, ArgReader& r) {
  ConvArgs c;
  c.images = images; c.bf16_input = bf16_input;
  const int batch = r.i();
  c.h = r.i(); c.w = r.i(); c.stride = r.i(); c.oh = r.i(); c.ow = r.i();
  c.channels = r.i();
  c.in_scale = r.f();
  c.conv_w = r.ptr<const int>();
  c.conv_b = r.ptr<const int>();
  const HeadArgs a = read_head(r);
  float* out = r.ptr<float>();
  int* cnt = stop == kFull ? r.ptr<int>() : nullptr;
  const cudaStream_t s = r.ptr<CUstream_st>();
  // a cut kernel writes kStageOut values of H*W*3, FR and L1 per image
  if (stop < kFull && (c.h * c.w * 3 < kStageOut || a.fr < kStageOut || a.l1 < kStageOut))
    return static_cast<int>(cudaErrorInvalidValue);
  TileArgs t;
  int smem = 0;
  // pack_feature's fields: channel < 256, window corner < 4096 / 2048
  if (!head_ok(batch, a.fr, a.l1) || c.channels <= 0 || c.channels > 255 || c.h >= 4096 ||
      c.w >= 2048 ||
      !pick_tile(batch, a.fr, a.l1, a.l2, a.l3, c.channels,
                 c.h * c.w * 3 * (bf16_input ? 2 : 4), c.h * c.w * 3, stop >= kFT, &t, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (stop) {
    case kStage: return static_cast<int>(run_mega_rows<kStage>(c, a, t, smem, s, out, cnt));
    case kQuant: return static_cast<int>(run_mega_rows<kQuant>(c, a, t, smem, s, out, cnt));
    case kConv: return static_cast<int>(run_mega_rows<kConv>(c, a, t, smem, s, out, cnt));
    case kFT: return static_cast<int>(run_mega_rows<kFT>(c, a, t, smem, s, out, cnt));
    case kFull: return static_cast<int>(run_mega_rows<kFull>(c, a, t, smem, s, out, cnt));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* nnue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The mega kernel's tile at this batch and image size, for a report:
// info = {images per tile, product rows, ring slots, staged pairs, blocks
// per tile, shared-memory bytes}. Returns 0, or -1 if nothing fits.
int nnue_mega_tile(int batch, int fr, int l1, int l2, int l3, int channels, int h, int w,
                   int* info) {
  TileArgs t;
  int smem = 0;
  if (!pick_tile(batch, fr, l1, l2, l3, channels, h * w * 12, h * w * 3, true, &t, &smem))
    return -1;
  const int v[6] = {t.tile, t.rows, t.slots, t.pair_bufs, t.split, smem};
  for (int i = 0; i < 6; ++i) info[i] = v[i];
  return 0;
}

// a = [images, bf16_input, then mega_launch's words with logits and count
// (0: none)]
int nnue_mega_launch(const int64_t* p) {
  ArgReader r{p};
  const void* images = r.ptr<const void>();
  const int bf16_input = r.i();
  return mega_launch(kFull, images, bf16_input, r);
}

// The cut kernel nnue_mega_kernel<level>, level 0..3, on float32 images:
// out (B, 128) float32. Needs H*W*3, FR and L1 all >= 128.
// a = [level, images, then mega_launch's words with out]
int nnue_mega_stage_launch(const int64_t* p) {
  ArgReader r{p};
  const int level = r.i();
  if (level < kStage || level >= kFull) return static_cast<int>(cudaErrorInvalidValue);
  const void* images = r.ptr<const void>();
  return mega_launch(level, images, 0, r);
}

// a = [acc, batch, the head's 22 words, logits, count (0: none), stream]
int nnue_head_launch(const int64_t* p) {
  ArgReader r{p};
  const int* ag = r.ptr<const int>();
  const int batch = r.i();
  const HeadArgs a = read_head(r);
  float* out = r.ptr<float>();
  int* cnt = r.ptr<int>();
  const cudaStream_t s = r.ptr<CUstream_st>();
  TileArgs t;
  int smem = 0;
  if (!head_ok(batch, a.fr, a.l1) ||
      !pick_tile(batch, a.fr, a.l1, a.l2, a.l3, 0, 0, 0, true, &t, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (t.rows == 64) err = run_head<2, 2>(ag, a, t, smem, s, out, cnt);
  else if (t.rows == 32) err = run_head<2, 1>(ag, a, t, smem, s, out, cnt);
  else err = run_head<1, 1>(ag, a, t, smem, s, out, cnt);
  return static_cast<int>(err);
}

}  // extern "C"
