// EtinyNet int8 serving's stem and tail for Hopper (sm_90a), on CUDA cores.
//
//   etiny_stem_kernel  the stem conv (nnue_engine.cpp:1341-1351): int32(x *
//                      scale) of the float32 normalized image, 3x3 pad 1
//                      stride 2 over 3 channels, + bias, truncating /scale,
//                      clamp +-127, written as int8 NHWC, the input of K6's
//                      first launch.
//   etiny_tail_kernel  the global average pool (int sum, truncating /(H*W),
//                      clamp +-127; cpp:1452-1463) and the classifier,
//                      (float)(pooled . w + b) / scale (cpp:1028-1040).
//
// They replace no TPU kernel: the JAX package runs both in XLA
// (nnue_vision_tpu/ops/etiny_pallas.py etiny_forward_pallas, :301-308 and
// :333-338), and the port ran them as the engine sim's plain int64 code
// (ops/engine_sim.py etiny_stem, etiny_tail): a float64 padded copy of the
// input, unfolded patches, float64 GEMMs and int64 elementwise passes, each
// a full-size tensor, over half of the int8 forward's device time. Each
// kernel reads its input once and writes its output once.
//
// Exactness. Both equal the sim bit for bit. The stem's input is quantized
// with the f32 multiply and the saturating truncation (cvt.rzi) that
// torch's cast uses on the card. Its sums are exact in int32 where every
// partial sum is bounded: |q| * max_c sum_t |w[c][t]| + max |b| < 2^31.
// The wrapper (ops/etiny_kernels.py etiny_kernel_params) computes, once per
// model, the largest |q| for which that holds, capped at 32767, the int16
// operand of __dp2a; each block of threads compares its input's largest
// |q| with it and sums that block in int64 where it is exceeded. Normalized
// images (|q| <= ~200 at scale 64) never take the int64 path. The tail's
// pooled sums are exact in int32 (H*W*127 < 2^31, checked by the launcher);
// its classifier sums in int32 where 127 * max_k sum_c |w[k][c]| + max |b|
// < 2^31, else in the int64 instance, chosen once per model. Logits are
// __int2float_rn (or __ll2float_rn) of the sum over the float scale by
// IEEE division: the library is built without --use_fast_math.
//
// What bounds them on this card, and the design:
// * The stem at 224x224 reads 600 KB of float32 an image and writes 401 KB
//   of int8, with 10.8 M multiply-adds (32 channels x 27 taps x 112^2). A
//   block of threads takes a band of output rows of one image (the whole
//   image at 32x32) and quantizes its 2R+1 input rows once into shared
//   memory as int32, with a zero border; the weights and bias sit there
//   too. A thread takes 2 output pixels, packs each pixel's 27 taps as 14
//   pairs of int16, and sums 8 channels at a time with __dp2a: one
//   instruction, two taps of one channel, whose weights come four channel
//   pairs to a 16-byte broadcast load. The band's int8 output is staged in
//   shared memory and written with 16-byte stores. __dp2a's issue rate
//   bounds it (PERF.md §6, an H100: 0.74 ms for 1024 images at 224 against
//   0.31 ms of bytes; 27 IMADs a channel ran at 1.52 ms, and the products
//   on the int8 tensor cores, q as two byte planes, at 0.73 ms and slower
//   at 32x32, bound by the quantizing pass and the epilogue instead).
// * The tail reads the last block's int8 output once (62.7 KB an image at
//   224, 1.1 KB at 32) and does 1.3 M multiply-adds an image at 1,000
//   classes: bytes and latency. A block of threads takes 8 images: it pools
//   them into shared memory (16 channels a 16-byte load), then each thread
//   takes a class and sums its 8 images' logits with __dp4a, the weights
//   laid out class-minor so that a warp's loads are one contiguous line.
//
// C interface (ctypes): each launcher takes one packed argument
// (launch_args.cuh) and returns cudaGetLastError() after the launch. The
// kernels launch on the caller's stream and allocate nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_args.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // what a block may use on sm_90
constexpr int kStemThreads = 256;
constexpr int kMinBlocks = 4;     // resident blocks of threads an SM: 64 registers a thread
constexpr int kPix = 2;           // output pixels a thread per pass
constexpr int kTaps = 27;         // 3x3 taps of 3 channels, in (kh, kw, ci) order
constexpr int kPairs = 14;        // taps in pairs, the last padded with a zero weight
constexpr int kChunk = 8;         // output channels a pass of the accumulators
constexpr int kBandPixels = 512;  // output pixels a band aims for
constexpr int kTailThreads = 256;
constexpr int kTailImages = 8;    // images a block of the tail

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <typename T>
__device__ inline T tdiv_pow2(T v, int k) {
  return (v + ((v >> (8 * sizeof(T) - 1)) & ((T(1) << k) - 1))) >> k;
}

template <typename T>
__device__ inline int clamp127(T v) {
  return static_cast<int>(v < -127 ? T(-127) : (v > 127 ? T(127) : v));
}

// The low bytes of four values as one word, the first lowest.
__device__ inline uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// ---------------------------------------------------------------------------
// stem
// ---------------------------------------------------------------------------

struct StemArgs {
  const float* x;   // (batch, h, w, 3)
  int batch, h, w, oh, ow, c;
  int band, bands;  // output rows a block of threads, bands an image
  int rs;           // int32s a row of the quantized input in shared memory
  float scale;      // stem scale, a power of two
  int k_scale;      // its log2
  int q_max;        // the largest |q| the int32 path takes (-1: none)
  const int4* wp;   // (chunks, kPairs) words of 4 channel pairs x 2 taps, int8
  const int* bias;  // (chunks * kChunk,), zero padded
  int8_t* out;      // (batch, oh, ow, c)
};

// Shared memory of a band of `band` output rows: the packed weights and
// bias, the quantized input rows (2*band + 1, rs) and the output stage
// with 16 bytes of slack to match the output's alignment.
__host__ __device__ inline int stem_rs(int w) { return round_up((w + 2) * 3, 2); }
__host__ __device__ inline int stem_smem(int band, int w, int ow, int c) {
  const int chunks = (c + kChunk - 1) / kChunk;
  return chunks * (kPairs * 16 + kChunk * 4) + round_up((2 * band + 1) * stem_rs(w) * 4, 16) +
         band * ow * c + 16;
}

// Weight byte of channel c, tap t in the packed layout.
__device__ inline int stem_w(const int4* wp, int c, int t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(wp);
  return b[((c / kChunk) * kPairs + t / 2) * 16 + ((c % kChunk) / 2) * 4 + (c % 2) * 2 + t % 2];
}

__global__ void __launch_bounds__(kStemThreads, kMinBlocks)
etiny_stem_kernel(StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (a.c + kChunk - 1) / kChunk;
  int4* s_w = reinterpret_cast<int4*>(smem);                    // (chunks, kPairs)
  int* s_b = reinterpret_cast<int*>(s_w + chunks * kPairs);     // (chunks * kChunk,)
  int* qs = s_b + chunks * kChunk;                              // (2 * band + 1, rs)
  int8_t* stage = reinterpret_cast<int8_t*>(qs) + round_up((2 * a.band + 1) * a.rs * 4, 16);

  const int img = blockIdx.x / a.bands;
  const int oy0 = (blockIdx.x - img * a.bands) * a.band;
  const int rows = min(a.band, a.oh - oy0);
  const int iy_top = 2 * oy0 - 1;       // the image row of local row 0
  const int nloc = 2 * rows + 1;        // local rows
  const int iy0 = max(iy_top, 0), iy1 = min(iy_top + nloc, a.h);  // those in the image
  const int rowlen = a.w * 3;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < chunks * kPairs; i += nthr) s_w[i] = __ldg(a.wp + i);
  for (int i = tid; i < chunks * kChunk; i += nthr) s_b[i] = __ldg(a.bias + i);
  // zeros: local rows outside the image, and each row's border columns
  // (x = -1, x = w, and the slack to rs)
  for (int e = tid; e < (iy0 - iy_top) * a.rs; e += nthr) qs[e] = 0;
  for (int e = (iy1 - iy_top) * a.rs + tid; e < nloc * a.rs; e += nthr) qs[e] = 0;
  for (int e = tid; e < nloc * 8; e += nthr) {
    const int r = e >> 3, j = e & 7;
    const int col = j < 3 ? j : rowlen + j;
    if (col < a.rs) qs[r * a.rs + col] = 0;
  }

  // the band's input rows, quantized once: q = cvt.rzi(x * scale)
  const float* src = a.x + (static_cast<size_t>(img) * a.h + iy0) * rowlen;
  int* qrow = qs + (iy0 - iy_top) * a.rs + 3;
  const int n = (iy1 - iy0) * rowlen;
  unsigned int m = 0;  // the largest |q| this thread wrote
  auto put = [&](int r, int col, float v) {
    const int q = __float2int_rz(__fmul_rn(v, a.scale));
    qrow[r * a.rs + col] = q;
    const unsigned int u = q < 0 ? 0u - static_cast<unsigned int>(q) : static_cast<unsigned int>(q);
    m = u > m ? u : m;
  };
  int tail0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    tail0 = n & ~3;
#pragma unroll 4
    for (int i = tid; i < (n >> 2); i += nthr) {
      const float4 v = __ldg(src4 + i);
      int r = (4 * i) / rowlen, col = 4 * i - r * rowlen;
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        put(r, col, vs[j]);
        if (++col == rowlen) { col = 0; ++r; }
      }
    }
  }
  for (int e = tail0 + tid; e < n; e += nthr) {
    const int r = e / rowlen;
    put(r, e - r * rowlen, __ldg(src + e));
  }
  const bool wide = __syncthreads_or(static_cast<long long>(m) > a.q_max);

  const int npix = rows * a.ow;
  int8_t* og = a.out + (static_cast<size_t>(img) * a.oh + oy0) * a.ow * a.c;
  int8_t* st = stage + (reinterpret_cast<uintptr_t>(og) & 15);  // st = og mod 16
  if (!wide) {
    // int32: 14 int16 tap pairs a pixel, __dp2a into 8 channels at a time
    for (int p0 = tid; p0 < npix; p0 += nthr * kPix) {
      uint32_t qp[kPix][kPairs];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        int p = p0 + k * nthr;
        if (p >= npix) p = p0;  // computed, never stored
        const int oy = p / a.ow, ox = p - oy * a.ow;
        const int* s = qs + 2 * oy * a.rs + 6 * ox;
        int v[kTaps + 1];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int2 d = *reinterpret_cast<const int2*>(s + kh * a.rs + 2 * j);
            v[kh * 9 + 2 * j] = d.x;
            v[kh * 9 + 2 * j + 1] = d.y;
          }
          v[kh * 9 + 8] = s[kh * a.rs + 8];
        }
        v[kTaps] = 0;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) qp[k][i] = __byte_perm(v[2 * i], v[2 * i + 1], 0x5410);
      }
      for (int ch = 0; ch < chunks; ++ch) {
        int acc[kPix][kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int b = s_b[ch * kChunk + j];
#pragma unroll
          for (int k = 0; k < kPix; ++k) acc[k][j] = b;
        }
#pragma unroll
        for (int t = 0; t < kPairs; ++t) {
          const int4 wv = s_w[ch * kPairs + t];
          const int ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const int q = static_cast<int>(qp[k][t]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[k][2 * j] = __dp2a_lo(q, ws[j], acc[k][2 * j]);
              acc[k][2 * j + 1] = __dp2a_hi(q, ws[j], acc[k][2 * j + 1]);
            }
          }
        }
        const int c0 = ch * kChunk;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int p = p0 + k * nthr;
          if (p >= npix) continue;
          int o[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) o[j] = clamp127(tdiv_pow2(acc[k][j], a.k_scale));
          int8_t* dst = st + p * a.c + c0;
          if ((a.c & 3) == 0) {  // st + p*c + c0 is 4-byte aligned
            reinterpret_cast<uint32_t*>(dst)[0] = pack4(o[0], o[1], o[2], o[3]);
            if (c0 + 4 < a.c) reinterpret_cast<uint32_t*>(dst)[1] = pack4(o[4], o[5], o[6], o[7]);
          } else {
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              if (c0 + j < a.c) dst[j] = static_cast<int8_t>(o[j]);
          }
        }
      }
    }
  } else {
    // int64, one output value a thread at a time
    for (int e = tid; e < npix * a.c; e += nthr) {
      const int p = e / a.c, c = e - p * a.c;
      const int oy = p / a.ow, ox = p - oy * a.ow;
      const int* s = qs + 2 * oy * a.rs + 6 * ox;
      long long acc = s_b[c];
      for (int kh = 0; kh < 3; ++kh)
        for (int j = 0; j < 9; ++j)
          acc += static_cast<long long>(s[kh * a.rs + j]) * stem_w(s_w, c, kh * 9 + j);
      st[e] = static_cast<int8_t>(clamp127(tdiv_pow2(acc, a.k_scale)));
    }
  }
  __syncthreads();

  // the band's output, contiguous in NHWC: 16-byte stores between the
  // unaligned head and tail
  const int bytes = npix * a.c;
  const int head = min(bytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(og) & 15)) & 15));
  const int body = (bytes - head) >> 4;
  for (int e = tid; e < head; e += nthr) og[e] = st[e];
  int4* og4 = reinterpret_cast<int4*>(og + head);
  const int4* st4 = reinterpret_cast<const int4*>(st + head);
  for (int e = tid; e < body; e += nthr) og4[e] = st4[e];
  for (int e = head + 16 * body + tid; e < bytes; e += nthr) og[e] = st[e];
}

// ---------------------------------------------------------------------------
// tail
// ---------------------------------------------------------------------------

struct TailArgs {
  const int8_t* x;  // (batch, hw, c)
  int batch, hw, c, classes;
  int cw;           // 16-channel words of the padded classifier row
  const int4* w;    // (cw, classes) words: cls_w (classes, 16 * cw) class-minor
  const int* b;     // (classes,)
  float scale;
  float* out;       // (batch, classes)
};

// Acc: int (the sums fit int32) or long long.
template <typename Acc>
__global__ void __launch_bounds__(kTailThreads)
etiny_tail_kernel(TailArgs a) {
  extern __shared__ __align__(16) int4 s_pool[];  // (kTailImages, cw) int8 words
  int8_t* pooled = reinterpret_cast<int8_t*>(s_pool);
  const int img0 = blockIdx.x * kTailImages;
  const int n_img = min(kTailImages, a.batch - img0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cp = 16 * a.cw;

  // 1. pool: per image and channel, the int32 sum over the positions,
  // truncating /hw, clamp +-127; channels past c are zero
  if ((a.c & 15) == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0) {
    const int words = a.c >> 4;
    for (int e = tid; e < kTailImages * a.cw; e += nthr) {
      const int g = e / a.cw, j = e - g * a.cw;
      int s[16] = {};
      if (g < n_img && j < words) {
        const int4* src = reinterpret_cast<const int4*>(
            a.x + static_cast<size_t>(img0 + g) * a.hw * a.c) + j;
#pragma unroll 4
        for (int p = 0; p < a.hw; ++p) {
          const int4 v = __ldg(src + static_cast<size_t>(p) * words);
          const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i] += static_cast<int8_t>(vs[i / 4] >> (8 * (i % 4)));
        }
      }
      int o[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] = clamp127(s[i] / a.hw);
      s_pool[e] = make_int4(pack4(o[0], o[1], o[2], o[3]), pack4(o[4], o[5], o[6], o[7]),
                            pack4(o[8], o[9], o[10], o[11]), pack4(o[12], o[13], o[14], o[15]));
    }
  } else {
    for (int e = tid; e < kTailImages * cp; e += nthr) {
      const int g = e / cp, c = e - g * cp;
      int s = 0;
      if (g < n_img && c < a.c) {
        const int8_t* src = a.x + static_cast<size_t>(img0 + g) * a.hw * a.c + c;
        for (int p = 0; p < a.hw; ++p) s += src[static_cast<size_t>(p) * a.c];
      }
      pooled[e] = static_cast<int8_t>(clamp127(s / a.hw));
    }
  }
  __syncthreads();

  // 2. the classifier: a class a thread, its 8 images' sums together;
  // four int8 products summed by __dp4a are exact in int32 (|sum| <= 65024)
  for (int k = tid; k < a.classes; k += nthr) {
    Acc acc[kTailImages];
    const int bias = __ldg(a.b + k);
#pragma unroll
    for (int g = 0; g < kTailImages; ++g) acc[g] = bias;
    for (int j = 0; j < a.cw; ++j) {
      const int4 w = __ldg(a.w + static_cast<size_t>(j) * a.classes + k);
#pragma unroll
      for (int g = 0; g < kTailImages; ++g) {
        const int4 p = s_pool[g * a.cw + j];
        if constexpr (sizeof(Acc) == 4) {
          acc[g] = __dp4a(p.x, w.x, acc[g]);
          acc[g] = __dp4a(p.y, w.y, acc[g]);
          acc[g] = __dp4a(p.z, w.z, acc[g]);
          acc[g] = __dp4a(p.w, w.w, acc[g]);
        } else {
          acc[g] += __dp4a(p.w, w.w, __dp4a(p.z, w.z, __dp4a(p.y, w.y, __dp4a(p.x, w.x, 0))));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kTailImages; ++g) {
      if (g >= n_img) break;
      const float f = sizeof(Acc) == 4 ? __int2float_rn(static_cast<int>(acc[g]))
                                       : __ll2float_rn(static_cast<long long>(acc[g]));
      a.out[static_cast<size_t>(img0 + g) * a.classes + k] = __fdiv_rn(f, a.scale);
    }
  }
}

// log2 of a power of two in 1..2^30, else -1.
int log2_exact(int s) {
  for (int k = 0; k < 31; ++k)
    if (s == (1 << k)) return k;
  return -1;
}

// Output rows a band of the stem: enough for about kBandPixels pixels, as
// many as fit in shared memory; 0 if one row does not.
int stem_band_rows(int oh, int ow, int w, int c) {
  int band = kBandPixels / ow;
  if (band < 1) band = 1;
  if (band > oh) band = oh;
  const int bands = (oh + band - 1) / band;  // the same bands, evened out
  band = (oh + bands - 1) / bands;
  while (band > 0 && stem_smem(band, w, ow, c) > kMaxSmem) --band;
  return band;
}

cudaError_t stem_allow_max_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      etiny_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

// (B, h, w, 3) float32 -> (B, oh, ow, c) int8, oh = (h - 1) / 2 + 1;
// `q_max` from the wrapper (the largest |q| the int32 path takes).
// a = [x, batch, h, w, c, stem_scale, q_max, wp, bias, out, stream]
int etiny_stem_launch(const int64_t* p) {
  ArgReader r{p};
  StemArgs a;
  a.x = r.ptr<const float>();
  a.batch = r.i(); a.h = r.i(); a.w = r.i(); a.c = r.i();
  const int stem_scale = r.i();
  a.q_max = r.i();
  a.wp = r.ptr<const int4>();
  a.bias = r.ptr<const int>();
  a.out = r.ptr<int8_t>();
  const cudaStream_t stream = r.ptr<CUstream_st>();
  a.k_scale = log2_exact(stem_scale);
  a.oh = (a.h - 1) / 2 + 1;
  a.ow = (a.w - 1) / 2 + 1;
  if (a.batch <= 0 || a.h <= 0 || a.w <= 0 || a.c <= 0 || a.k_scale < 0 || a.q_max < -1 ||
      a.q_max > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  a.band = stem_band_rows(a.oh, a.ow, a.w, a.c);
  if (a.band <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.bands = (a.oh + a.band - 1) / a.band;
  if (static_cast<long long>(a.batch) * a.bands > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = stem_allow_max_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.rs = stem_rs(a.w);
  a.scale = static_cast<float>(stem_scale);
  const int pixels = a.band * a.ow;
  int threads = round_up((pixels + kPix - 1) / kPix, 32);
  if (threads > kStemThreads) threads = kStemThreads;
  etiny_stem_kernel<<<a.batch * a.bands, threads, stem_smem(a.band, a.w, a.ow, a.c), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (B, hw, c) int8 -> (B, classes) float32; `wide` picks the int64 sums.
// a = [x, batch, hw, c, classes, wide, w, b, scale (f32), out, stream]
int etiny_tail_launch(const int64_t* p) {
  ArgReader r{p};
  TailArgs a;
  a.x = r.ptr<const int8_t>();
  a.batch = r.i(); a.hw = r.i(); a.c = r.i(); a.classes = r.i();
  const int wide = r.i();
  a.w = r.ptr<const int4>();
  a.b = r.ptr<const int>();
  a.scale = r.f();
  a.out = r.ptr<float>();
  const cudaStream_t s = r.ptr<CUstream_st>();
  if (a.batch <= 0 || a.hw <= 0 || a.c <= 0 || a.classes <= 0 || a.hw > 0x7fffffff / 128)
    return static_cast<int>(cudaErrorInvalidValue);
  a.cw = (a.c + 15) / 16;
  const int blocks = (a.batch + kTailImages - 1) / kTailImages;
  const int smem = kTailImages * a.cw * 16;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = wide
        ? cudaFuncSetAttribute(etiny_tail_kernel<long long>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
        : cudaFuncSetAttribute(etiny_tail_kernel<int>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (wide)
    etiny_tail_kernel<long long><<<blocks, kTailThreads, smem, s>>>(a);
  else
    etiny_tail_kernel<int><<<blocks, kTailThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
