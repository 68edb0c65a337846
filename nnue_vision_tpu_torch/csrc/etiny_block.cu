// EtinyNet int8 LB blocks for Hopper (sm_90a), on the int8 tensor cores:
// one block a launch, or a run of consecutive blocks a launch.
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
// |acc| <= 127*127*in + |bias| (below 2^31 for in <= 1120), depthwise
// |acc| <= 9*6*127, pw-project |acc| <= 6*127*mid. Division truncates
// toward zero like the engine's (by a power of two, as a shift: the sim
// admits no other scale). So the kernel equals the int64 engine sim
// (ops/engine_sim.py lb_block_plain) bit for bit, with no float anywhere.
//
// What bounded it before: the pointwise weights, re-read from L2 for every
// image by one block of threads per image (the synthetic final block's
// 224x1120 expand and 1120x1120 projection are 1.5 MB). What the design
// does about it, as the TPU kernel did with its ~4,096-row tiles on the
// matrix unit: one block of threads takes a tile of T images, up to 256
// GEMM rows (image x position), and each weight stage that reaches shared
// memory serves every row of the tile. At batch 8192: T = 1 at 16x16, 4 at
// 8x8, 16 at 4x4, 63 at 2x2 and 1x1; the launcher caps T so that the grid
// still fills the SMs, and lowers it while the tile would not fit in
// shared memory. The last tile is ragged: its missing images are never
// stored.
//   1. The tile's input (T*h*w rows of cin int8), the pw-expand bias and
//      the depthwise weights are copied to shared memory by cp.async while
//      the first weight stages load.
//   2. pw-expand is one tensor-core product (int8_mma.cuh: mma.sync
//      m16n8k32 s8, weights streamed through a cp.async ring), rows x K =
//      cin x N = mid; its epilogue writes int8 values 0..6.
//   3. The depthwise 3x3 runs on CUDA cores from shared memory, at the
//      block's stride.
//   4. pw-project is the second product, K = mid; its epilogue writes the
//      output tile to shared memory, which then goes to device memory 16
//      bytes at a time.
// Intermediates never leave shared memory. The input tile and the
// depthwise output share one region (the input is dead after step 2), as
// do the expanded activations and the output tile.
//
// Row bands with a halo (etiny_block_kernel<true>). Where one image's
// tile does not fit in shared memory (EtinyNet-1.0 at 224x224: the first
// block's 112x112x32 input and expansion, the 56x56 and 28x28 blocks), a
// block of threads takes one band of R output rows of one image. It reads
// the input rows the band's depthwise needs, (R-1)*stride + 3 of them
// clipped at the image's edges (zero padding outside, as on the tile
// path), recomputes pw-expand on those halo rows, and writes only its own
// R output rows; the image's last band may be shorter. Steps 1-4 are the
// tile path's on a tile of one image cut to those rows, so the band path
// is exact in the same way. The caller (ops/etiny_kernels.py band_plan)
// picks R, the most rows that fit with 2 weight-ring slots, and passes it
// as `band`; 0 keeps the tile path, whose grid, tile, ring slots and
// shared memory do not depend on the band path. Any block side and stride
// works on both paths: the output side is (side - 1) / stride + 1.
//
// Runs of blocks (etiny_block_kernel_run). Launched one block at a time,
// the blocks at 16x16, 8x8 and 4x4 (b0-b5 of the 0.98M model) took two
// thirds of the 12 blocks' time at batch 8192: 15,360 blocks of threads,
// each reading its tile from device memory, streaming two whole 16 KB
// weight stages and writing its output for the next launch to read back
// (PERF.md). A run launch carries a tile of images through
// consecutive blocks: it reads the run's input tile once, each block's
// pw-project epilogue writes the next block's input into shared memory in
// the operand layout that block's pw-expand reads (a_stride(cin)), and
// only the run's last output goes to device memory. The arithmetic is the
// tile path's, so the run is exact in the same way. The caller
// (ops/etiny_kernels.py run_plan) picks the runs and their tile, at which
// every product keeps at least kSuperRows GEMM rows; a run of one block
// is the single-block launch above.
//
// Both kernels run one block body (lb_block) on the loops they share, one
// copy each, and differ only in their set-up: a product copies of each
// weight stage only what it reads and, where its stages stay resident,
// meets the block's barrier once; a product of at most 32 columns takes a
// layout whose every warp holds real columns (run_product); the
// epilogues store two values at a time (expand_epilogue,
// project_epilogue); the depthwise takes four channels a thread with
// __dp4a and walks its positions by carries, with no division
// (run_depthwise, which tests a band's windows against the image); the
// input lands by cp.async, walked the same way (load_rows). On the bands
// of EtinyNet-1.0 at 224, whose 32-channel blocks at 112 and 56 had two
// working warps a block of threads, one block of threads an SM, they cut
// the nine band launches about 3.3x (PERF.md).
//
// What bounds it now (PERF.md): on the bands, one block of threads an SM
// (a band fills shared memory), whose steps follow one another behind
// barriers with eight warps to hide each one's latency, and the stride-2
// blocks, which expand every input position; in the runs, the CUDA-core
// work, the depthwise and the epilogues, and the products' latency chains
// with 8 warps a block of threads and 2 blocks an SM; and the final block
// alone (224 -> 1120 -> 1120 at 8192, 256 -> 1280 -> 1280 at 224), whose
// weights, 1.5 and 1.97 MB, each block of threads streams through the
// ring. Loops that read shared or device memory and write shared memory
// name their regions __restrict__ (they never overlap), so that a value's
// reads are not held behind the last value's store.
//
// C interface (ctypes): each launcher (etiny_block_launch, one block;
// etiny_run_launch, a run) takes one packed argument (launch_args.cuh)
// and returns cudaGetLastError() after the launch. The kernels launch on
// the caller's stream and allocate nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "launch_args.cuh"

namespace {

using namespace int8mma;

constexpr int kMaxSmem = 232448;  // what a block may use on sm_90
constexpr int kRowTarget = 256;   // GEMM rows a tile aims for
constexpr int kSuperRows = 64;    // rows per product super-tile (either layout)

// One LB block: its shape, its scales' log2, its weights, and (in a run)
// where its bias and depthwise weights lie in the run's constants.
struct LbBlock {
  const uint8_t* we;      // pw-expand (mid, cin) as mma tiles
  const int* be;          // (mid,)
  const int8_t* dw;       // (mid, 3, 3)
  const uint8_t* wp;      // pw-project (cout, mid) as mma tiles
  int h, w, cin, mid, cout, stride, oh, ow;
  int k_expand, k_dw, k_project;  // the scales' log2 (they are powers of two)
  int consts;             // run path: byte offset in the constants region
};

struct BlockArgs {
  const int8_t* x;        // (batch, h, w, cin)
  int8_t* out;            // (batch, oh, ow, cout)
  int batch, tile;        // images in all, images per block of threads
  int slots;              // weight ring slots: 2 to kMaxSlots
  int band, band_in;      // band path: output rows a band, its most input rows
  int bands;              // band path: bands per image
  LbBlock b;
};

__host__ __device__ inline int align128(int n) { return round_up(n, 128); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The shared-memory regions of a tile of `tile` images: the input / the
// depthwise output, the expanded activations / the output tile, the
// pw-expand bias and depthwise weights, the weight ring.
struct Smem {
  int x_and_h2, h1, consts, total;
  __host__ __device__ Smem(int tile, int h, int w, int cin, int mid, int cout, int oh,
                           int ow, int slots) {
    const int rows = round_up(tile * h * w, kSuperRows);
    const int orows = round_up(tile * oh * ow, kSuperRows);
    const int a = a_region(rows, cin), b = a_region(orows, mid);
    x_and_h2 = align128(a > b ? a : b);
    h1 = align128(rows * mid > orows * cout ? rows * mid : orows * cout);
    consts = align128(4 * mid) + align128(9 * mid);
    const int expand = ring_slots((mid + kCols - 1) / kCols * k_stages(cin), slots);
    const int project = ring_slots((cout + kCols - 1) / kCols * k_stages(mid), slots);
    total = x_and_h2 + h1 + consts + (expand > project ? expand : project) * kSlotBytes;
  }
};

__device__ inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The input rows a band of output rows [oy0, oy0 + rows) reads, clipped to
// the image: the first, and one past the last.
__host__ __device__ inline int band_first_in(int oy0, int stride) {
  return oy0 * stride > 0 ? oy0 * stride - 1 : 0;
}
__host__ __device__ inline int band_end_in(int oy0, int rows, int stride, int h) {
  const int end = (oy0 + rows - 1) * stride + 2;
  return end < h ? end : h;
}

// ---- The loops both kernels share -----------------------------------------

constexpr int kNarrow = 32;  // a product with at most this many columns takes <1, 4, 32>
static_assert(Layout<1, 4, kNarrow>::kRows == kSuperRows && Layout<2, 2>::kRows == kSuperRows,
              "both layouts cover the super-tile that Smem and RunSmem round rows to");

// f(row, col, value at col, value at col + 1, cv(col), cv(col + 1)) for
// each pair of neighbouring columns a thread holds (cv read first).
template <int kMW, int kNW, class CV, class F>
__device__ inline void for_each_pair(const int (&acc)[kMW][kNW][4], int row0, int col0, CV&& cv,
                                     F&& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int v[kNW][2];
#pragma unroll
  for (int j = 0; j < kNW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) v[j][e] = cv(col0 + j * 8 + 2 * t + e);
#pragma unroll
  for (int i = 0; i < kMW; ++i)
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      const int r = row0 + i * 16 + g, c = col0 + j * 8 + 2 * t;
      f(r, c, acc[i][j][0], acc[i][j][1], v[j][0], v[j][1]);
      f(r + 8, c, acc[i][j][2], acc[i][j][3], v[j][0], v[j][1]);
    }
}

// clamp(v / 2^k, 0, 6) with C's truncating division: for v < 0 both the
// truncated and the floored quotient clamp to 0, so a shift does.
__device__ inline int relu6_shift(int v, int k) { return min(max(v >> k, 0), 6); }

// Two int8 values at dst[0] and dst[1]: one 16-bit store where both
// columns exist and the address is even, else a byte each that exists.
__device__ inline void store_pair(int8_t* dst, int c, int n, int q0, int q1) {
  if (c + 1 < n && (reinterpret_cast<uintptr_t>(dst) & 1) == 0) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
  } else if (c < n) {
    dst[0] = static_cast<int8_t>(q0);
    if (c + 1 < n) dst[1] = static_cast<int8_t>(q1);
  }
}

// The pw-expand epilogue of the sums a thread holds (chunk column col0):
// + bias, /2^k, ReLU6 into `rows` dense rows of mid values at dst.
template <int kMW, int kNW>
__device__ __forceinline__ void expand_epilogue(const int (&acc)[kMW][kNW][4], int row0,
                                                int col0, int8_t* dst, int rows, int mid,
                                                const int* be, int k) {
  for_each_pair(acc, row0, col0, [&](int m) { return m < mid ? be[m] : 0; },
                [&](int r, int m, int v0, int v1, int b0, int b1) {
                  if (r < rows)
                    store_pair(dst + r * mid + m, m, mid, relu6_shift(v0 + b0, k),
                               relu6_shift(v1 + b1, k));
                });
}

// The pw-project epilogue: /2^k, clamp +-127 into `rows` rows of n values
// at dst, ld bytes apart.
template <int kMW, int kNW>
__device__ __forceinline__ void project_epilogue(const int (&acc)[kMW][kNW][4], int row0,
                                                 int col0, int8_t* dst, int ld, int rows, int n,
                                                 int k) {
  for_each_pair(acc, row0, col0, [](int) { return 0; },
                [&](int r, int o, int v0, int v1, int, int) {
                  if (r < rows)
                    store_pair(dst + r * ld + o, o, n, clampi(tdiv_pow2(v0, k), -127, 127),
                               clampi(tdiv_pow2(v1, k), -127, 127));
                });
}

// C = A . W^T for a block's product, n columns of k bytes, with the
// layout its width calls for; each stage copied only as far as read.
template <class Before, class Epi>
__device__ __forceinline__ void run_product(const int8_t* a, int lda, int rows, const uint8_t* w,
                                            int k, int n, unsigned char* ring, int slots,
                                            Before&& before, Epi&& epi) {
  const int n_super = (rows + kSuperRows - 1) / kSuperRows;
  if (n <= kNarrow)
    stream_gemm<1, 4, kNarrow, true>(a, lda, n_super, w, Chunks{0, 1, 1}, k, n, k_stages(k), 0,
                                     ring, slots, blockIdx.x, before, epi);
  else
    stream_gemm<2, 2, kCols, true>(a, lda, n_super, w, Chunks{0, 1, (n + kCols - 1) / kCols}, k,
                                   n, k_stages(k), 0, ring, slots, blockIdx.x, before, epi);
}

// A block's pw-expand bias (mid int32) and depthwise weights (mid x 9
// int8) into shared memory by cp.async (the weights a byte at a time
// where mid % 4 != 0). The copy loops here and in load_rows stay rolled:
// unrolled, they add about a thousand instructions to each kernel and
// save no measured time.
__device__ __forceinline__ void load_consts(unsigned char* be, unsigned char* dw,
                                            const int* be_g, const int8_t* dw_g, int mid) {
#pragma unroll 1
  for (int m = threadIdx.x; m < mid; m += kThreads) cp_async4(be + 4 * m, be_g + m);
  if ((mid & 3) == 0) {
#pragma unroll 1
    for (int e = threadIdx.x; e < mid * 9 / 4; e += kThreads) cp_async4(dw + 4 * e, dw_g + 4 * e);
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < mid * 9; e += kThreads)
      reinterpret_cast<int8_t*>(dw)[e] = dw_g[e];
  }
}

// `rows` dense rows of k bytes at src into shared memory, ld bytes a row:
// a word at a time by cp.async where k % 4 == 0 (word e of the rows is row
// r's word c; the walk adds kThreads by carries), else a byte at a time.
__device__ __forceinline__ void load_rows(int8_t* dst, int ld, const int8_t* src, int rows,
                                          int k) {
  if ((k & 3) == 0) {
    const int words = k >> 2, dr = kThreads / words, dc = kThreads - dr * words;
    int r = threadIdx.x / words, c = threadIdx.x - r * words;
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * words; e += kThreads) {
      cp_async4(dst + r * ld + 4 * c, src + 4 * e);
      r += dr;
      c += dc;
      if (c >= words) { c -= words; ++r; }
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * k; e += kThreads) {
      const int r = e / k, c = e - r * k;
      dst[r * ld + c] = src[e];
    }
  }
}

// The 4x4 byte transpose: o[c] byte i = byte c of the i-th word.
__device__ inline void transpose4(uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3,
                                  uint32_t (&o)[4]) {
  const uint32_t x01 = __byte_perm(q0, q1, 0x5140), y01 = __byte_perm(q2, q3, 0x5140);
  const uint32_t x23 = __byte_perm(q0, q1, 0x7362), y23 = __byte_perm(q2, q3, 0x7362);
  o[0] = __byte_perm(x01, y01, 0x5410);
  o[1] = __byte_perm(x01, y01, 0x7632);
  o[2] = __byte_perm(x23, y23, 0x5410);
  o[3] = __byte_perm(x23, y23, 0x7632);
}

// 3x3 depthwise, zero padding, at `stride`, of n_img images of h x w
// positions in h1 (mid values a row, dense) into h2 (ldh bytes a row), oh
// x ow outputs an image; /2^k_dw, clamp [0, 6]. A band (one image) holds
// the image's rows iy0.. in h1 and computes its output rows oy0..: the
// windows are tested against the image's height h_img. The tile and run
// paths pass oy0 = iy0 = 0 and h_img = h. A thread takes one group of
// channels (four where mid allows, else one) at positions p0, p0 + step,
// ..., its weights held in registers; it walks the positions by carries,
// with no division in the loop. Four channels are read as one word a tap;
// the four words of taps 0-3 (and of 4-7) are transposed with byte
// permutes into one word a channel, so that __dp4a sums four taps at once,
// and tap 8's word meets a weight word that holds the channel's weight at
// its own byte. Values 0..6 times int8 weights, nine a sum: exact in
// int32.
__device__ __forceinline__ void run_depthwise(const int8_t* __restrict__ h1,
                                              const int8_t* __restrict__ wdw,
                                              int8_t* __restrict__ h2, int ldh, int n_img, int h,
                                              int w, int oh, int ow, int mid, int stride,
                                              int k_dw, int oy0, int iy0, int h_img) {
  const bool quads = (mid & 3) == 0;
  const int groups = quads ? mid >> 2 : mid;
  const int step = groups < kThreads ? kThreads / groups : 1;  // positions in parallel
  const int ohw = oh * ow, total = n_img * ohw;
  const int di = step / ohw, dy = (step - di * ohw) / ow, dx = step - di * ohw - dy * ow;
  // tap t's offset from the window's first tap; the centre tap lies in
  // the image at any stride, so only the outer rows and columns are tested
  int off[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) off[t] = ((t / 3) * w + t % 3) * mid;
  // (img, oy, ox) of the position `step` further on
  auto advance = [&](int& img, int& oy, int& ox) {
    ox += dx;
    if (ox >= ow) { ox -= ow; ++oy; }
    oy += dy;
    if (oy >= oh) { oy -= oh; ++img; }
    img += di;
  };
  for (int item = threadIdx.x; item < groups * step; item += kThreads) {
    const int g = item % groups, p0 = item / groups;
    int img = p0 / ohw, oy = (p0 - img * ohw) / ow, ox = p0 - img * ohw - oy * ow;
    if (quads) {
      uint32_t w0[4], w1[4], w2[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int8_t* wc = wdw + (4 * g + c) * 9;
        uint32_t a = 0, b = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          a |= static_cast<uint32_t>(static_cast<uint8_t>(wc[t])) << (8 * t);
          b |= static_cast<uint32_t>(static_cast<uint8_t>(wc[4 + t])) << (8 * t);
        }
        w0[c] = a;
        w1[c] = b;
        w2[c] = static_cast<uint32_t>(static_cast<uint8_t>(wc[8])) << (8 * c);
      }
      for (int p = p0; p < total; p += step) {
        // the window's first row and column in the image
        const int iy = (oy0 + oy) * stride - 1, ix0 = ox * stride - 1;
        const int8_t* win = h1 + ((img * h + iy - iy0) * w + ix0) * mid + 4 * g;
        const bool rows_ok[3] = {iy >= 0, true, iy + 2 < h_img};
        const bool cols_ok[3] = {ix0 >= 0, true, ix0 + 2 < w};
        uint32_t v[9];
#pragma unroll
        for (int t = 0; t < 9; ++t)
          v[t] = rows_ok[t / 3] && cols_ok[t % 3]
                     ? *reinterpret_cast<const uint32_t*>(win + off[t])
                     : 0u;
        // one word a channel: taps 0-3 (t) and 4-7 (u), tap i at byte i
        uint32_t t[4], u[4];
        transpose4(v[0], v[1], v[2], v[3], t);
        transpose4(v[4], v[5], v[6], v[7], u);
        uint32_t packed = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int acc = __dp4a(static_cast<int>(t[c]), static_cast<int>(w0[c]),
                                 __dp4a(static_cast<int>(u[c]), static_cast<int>(w1[c]),
                                        __dp4a(static_cast<int>(v[8]), static_cast<int>(w2[c]), 0)));
          packed |= static_cast<uint32_t>(relu6_shift(acc, k_dw)) << (8 * c);
        }
        *reinterpret_cast<uint32_t*>(h2 + p * ldh + 4 * g) = packed;
        advance(img, oy, ox);
      }
    } else {
      int wt[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wt[t] = wdw[g * 9 + t];
      for (int p = p0; p < total; p += step) {
        const int iy = (oy0 + oy) * stride - 1, ix0 = ox * stride - 1;
        const int8_t* win = h1 + ((img * h + iy - iy0) * w + ix0) * mid + g;
        const bool rows_ok[3] = {iy >= 0, true, iy + 2 < h_img};
        const bool cols_ok[3] = {ix0 >= 0, true, ix0 + 2 < w};
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          if (rows_ok[t / 3] && cols_ok[t % 3]) acc += static_cast<int>(win[off[t]]) * wt[t];
        h2[p * ldh + g] = static_cast<int8_t>(relu6_shift(acc, k_dw));
        advance(img, oy, ox);
      }
    }
  }
}

// ---- The body of both kernels ---------------------------------------------

// Block b on n_img images of in_rows x b.w input positions in x
// (a_stride(cin) bytes a row), o_rows x b.ow outputs an image: 2. (while
// the first weight stages load, `load`, which lands the input and the
// constants) pw-expand + bias, /s_expand, ReLU6 into y; 3. the depthwise
// from y into x (the input is dead), at the block's stride, /s_dw, ReLU6,
// its windows tested against the image's b.h rows, of which a band holds
// rows iy0.. and computes output rows oy0..; 4. pw-project, /s_project,
// clamp +-127 into y (the expansion is dead), ldo bytes a row. be and dw
// are the block's bias and depthwise weights in shared memory.
template <class Load>
__device__ __forceinline__ void lb_block(const LbBlock& b, int n_img, int in_rows, int o_rows,
                                         int oy0, int iy0, int8_t* x, int8_t* y, int ldo,
                                         const int* be, const int8_t* dw, unsigned char* ring,
                                         int slots, Load&& load) {
  const int rows = n_img * in_rows * b.w, orows = n_img * o_rows * b.ow;
  run_product(x, a_stride(b.cin), rows, b.we, b.cin, b.mid, ring, slots, load,
              [&](int, int c, const auto& acc, int row0, int col0) {
                expand_epilogue(acc, row0, c * kCols + col0, y, rows, b.mid, be, b.k_expand);
              });
  run_depthwise(y, dw, x, a_stride(b.mid), n_img, in_rows, b.w, o_rows, b.ow, b.mid, b.stride,
                b.k_dw, oy0, iy0, b.h);
  __syncthreads();
  run_product(x, a_stride(b.mid), orows, b.wp, b.mid, b.cout, ring, slots, [] {},
              [&](int, int c, const auto& acc, int row0, int col0) {
                project_epilogue(acc, row0, c * kCols + col0, y, ldo, orows, b.cout,
                                 b.k_project);
              });
}

// `bytes` bytes of an output tile at src to device memory at dst, 16 bytes
// a store where the address and the size allow, else a byte at a time.
__device__ __forceinline__ void store_out(int8_t* dst, const int8_t* src, int bytes) {
  if (((reinterpret_cast<uintptr_t>(dst) | bytes) & 15) == 0) {
    for (int e = threadIdx.x; e < (bytes >> 4); e += blockDim.x)
      reinterpret_cast<int4*>(dst)[e] = reinterpret_cast<const int4*>(src)[e];
  } else {
    for (int e = threadIdx.x; e < bytes; e += blockDim.x) dst[e] = src[e];
  }
}

// ---- One block a launch (etiny_block_kernel) ------------------------------

// kBand: one band of a.band output rows of one image a block of threads;
// else a tile of a.tile whole images.
template <bool kBand>
__global__ void __launch_bounds__(kThreads)
etiny_block_kernel(const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LbBlock& b = a.b;
  const Smem sm(kBand ? 1 : a.tile, kBand ? a.band_in : b.h, b.w, b.cin, b.mid, b.cout,
                kBand ? a.band : b.oh, b.ow, a.slots);
  int8_t* x = reinterpret_cast<int8_t*>(smem);     // the input, then the depthwise output
  int8_t* y = x + sm.x_and_h2;                     // the expansion, then the output tile
  unsigned char* be = smem + sm.x_and_h2 + sm.h1;  // (mid,) int32
  unsigned char* dw = be + align128(4 * b.mid);    // (mid, 9)

  // This block's images, and per image its input rows [iy0, iy0 + in_rows)
  // and output rows [oy0, oy0 + o_rows): the whole image on the tile path.
  const int img0 = kBand ? blockIdx.x / a.bands : blockIdx.x * a.tile;
  const int n_img = kBand ? 1 : min(a.tile, a.batch - img0);
  const int oy0 = kBand ? (blockIdx.x - img0 * a.bands) * a.band : 0;
  const int o_rows = kBand ? min(a.band, b.oh - oy0) : b.oh;
  const int iy0 = kBand ? band_first_in(oy0, b.stride) : 0;
  const int in_rows = kBand ? band_end_in(oy0, o_rows, b.stride, b.h) - iy0 : b.h;

  // 1. The bias, the depthwise weights and the input tile land while the
  // first weight stages load.
  lb_block(b, n_img, in_rows, o_rows, oy0, iy0, x, y, b.cout, reinterpret_cast<const int*>(be),
           reinterpret_cast<const int8_t*>(dw), be + sm.consts, a.slots, [&] {
             load_consts(be, dw, b.be, b.dw, b.mid);
             load_rows(x, a_stride(b.cin),
                       a.x + (static_cast<size_t>(img0) * b.h + iy0) * b.w * b.cin,
                       n_img * in_rows * b.w, b.cin);
             cp_async_commit();
             cp_async_wait<0>();
           });
  store_out(a.out + (static_cast<size_t>(img0) * b.oh + oy0) * b.ow * b.cout, y,
            n_img * o_rows * b.ow * b.cout);
}

// ---- Runs of blocks (etiny_block_kernel_run) ------------------------------

constexpr int kMaxRun = 16;  // blocks a run carries at most

struct RunArgs {
  const int8_t* x;  // (batch, h, w, cin) of the run's first block
  int8_t* out;      // (batch, oh, ow, cout) of its last
  int batch, tile, slots, n;
  int q, consts, ring;  // byte offsets of region Q, the constants and the ring
  LbBlock b[kMaxRun];
};

// The shared memory of a run at `tile` images (host side; the launcher
// hands the kernel the offsets). Two regions take turns: block k reads its
// input from one (P for even k) and leaves its depthwise output there;
// its expanded activations, then its output, go to the other, in the
// operand layout that block k + 1's pw-expand reads (the run's last
// output densely, for the copy out). Then every block's bias and
// depthwise weights, then the weight ring.
struct RunSmem {
  int p, q, consts, slots_used, total;
  RunSmem(int tile, const int (*shape)[6], int n, int slots) {
    int reg[2] = {0, 0};
    consts = slots_used = 0;
    for (int k = 0; k < n; ++k) {
      const int h = shape[k][0], w = shape[k][1], cin = shape[k][2], mid = shape[k][3];
      const int cout = shape[k][4], stride = shape[k][5];
      const int oh = (h - 1) / stride + 1, ow = (w - 1) / stride + 1;
      const int rows = round_up(tile * h * w, kSuperRows);
      const int orows = round_up(tile * oh * ow, kSuperRows);
      const int in = imax(a_region(rows, cin), a_region(orows, mid));
      const int out = imax(rows * mid, k + 1 < n ? a_region(orows, cout) : orows * cout);
      reg[k & 1] = imax(reg[k & 1], in);
      reg[~k & 1] = imax(reg[~k & 1], out);
      consts += align128(4 * mid) + align128(9 * mid);
      slots_used = imax(slots_used,
                        imax(ring_slots((mid + kCols - 1) / kCols * k_stages(cin), slots),
                             ring_slots((cout + kCols - 1) / kCols * k_stages(mid), slots)));
    }
    p = align128(reg[0]);
    q = align128(reg[1]);
    total = p + q + consts + slots_used * kSlotBytes;
  }
};

// A tile of a.tile images through the a.n consecutive blocks of a run:
// each block's steps 1-4 as the tile path's, its output written by the
// pw-project epilogue straight into shared memory as the next block's
// input; only the last block's output goes to device memory.
__global__ void __launch_bounds__(kThreads)
etiny_block_kernel_run(const __grid_constant__ RunArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* const rp = reinterpret_cast<int8_t*>(smem);
  int8_t* const rq = reinterpret_cast<int8_t*>(smem + a.q);
  unsigned char* const consts = smem + a.consts;
  unsigned char* const ring = smem + a.ring;
  const int img0 = blockIdx.x * a.tile;
  const int n_img = min(a.tile, a.batch - img0);

  for (int k = 0; k < a.n; ++k) {
    const LbBlock& b = a.b[k];
    int8_t* const in = k & 1 ? rq : rp;   // the input, then the depthwise output
    int8_t* const oth = k & 1 ? rp : rq;  // the expansion, then the output
    const unsigned char* s_be = consts + b.consts;

    // 1. (first block) every block's bias and depthwise weights and the
    // run's input tile land while the first weight stages load; block k's
    // output goes into `oth` as block k + 1's input, or the run's output
    // tile.
    lb_block(b, n_img, b.h, b.oh, 0, 0, in, oth, k + 1 < a.n ? a_stride(b.cout) : b.cout,
             reinterpret_cast<const int*>(s_be),
             reinterpret_cast<const int8_t*>(s_be + align128(4 * b.mid)), ring, a.slots, [&] {
               if (k != 0) return;
               for (int j = 0; j < a.n; ++j) {
                 const LbBlock& c = a.b[j];
                 unsigned char* be = consts + c.consts;
                 load_consts(be, be + align128(4 * c.mid), c.be, c.dw, c.mid);
               }
               load_rows(in, a_stride(b.cin),
                         a.x + static_cast<size_t>(img0) * b.h * b.w * b.cin,
                         n_img * b.h * b.w, b.cin);
               // everything above, and the first weight stages, landed
               cp_async_commit();
               cp_async_wait<0>();
             });
  }

  const LbBlock& l = a.b[a.n - 1];
  store_out(a.out + static_cast<size_t>(img0) * l.oh * l.ow * l.cout, a.n & 1 ? rq : rp,
            n_img * l.oh * l.ow * l.cout);
}

// log2 of a power of two in 1..2^30, else -1 (the engine sim's scales are
// powers of two: ops/engine_sim.py _check_pow2).
int log2_exact(int s) {
  for (int k = 0; k < 31; ++k)
    if (s == (1 << k)) return k;
  return -1;
}

// Ring slots for a tile: as many as fit, kMaxSlots at most.
int ring_slots_fit(int tile, int h, int w, int cin, int mid, int cout, int oh, int ow) {
  int slots = kMaxSlots;
  while (slots > 2 && Smem(tile, h, w, cin, mid, cout, oh, ow, slots).total > kMaxSmem) --slots;
  return slots;
}

// Lets etiny_block_kernel<kBand> take kMaxSmem bytes, once per process.
template <bool kBand>
cudaError_t allow_max_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      etiny_block_kernel<kBand>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

// Lets etiny_block_kernel_run take kMaxSmem bytes, once per process.
cudaError_t allow_max_smem_run() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      etiny_block_kernel_run, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
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

}  // namespace

extern "C" {

// Shared memory of a tile of `tile` images with the fewest ring slots (2),
// in bytes.
int etiny_block_smem(int tile, int h, int w, int cin, int mid, int cout, int oh, int ow) {
  return Smem(tile, h, w, cin, mid, cout, oh, ow, 2).total;
}

// The widest product, in columns, that takes the narrow warp layout.
int etiny_narrow_columns() { return kNarrow; }

// Images per block of threads: ~kRowTarget GEMM rows, no more than fill
// the SMs, and no more than fit in shared memory with 2 ring slots (0 if
// one does not).
int etiny_block_tile(int batch, int h, int w, int cin, int mid, int cout, int oh, int ow) {
  int tile = kRowTarget / (h * w);
  if (tile < 1) tile = 1;
  const int fill = (batch + sm_count() - 1) / sm_count();
  if (tile > fill) tile = fill;
  while (tile > 0 && etiny_block_smem(tile, h, w, cin, mid, cout, oh, ow) > kMaxSmem) --tile;
  return tile;
}

// a = [x, batch, h, w, cin, mid, cout, stride, oh, ow, s_expand, s_dw,
// s_project, band, we, be, dw, wp, out, stream]: `band` output rows a
// block of threads (the band path), or 0 for tiles of whole images; the
// band must fit with 2 ring slots.
int etiny_block_launch(const int64_t* p) {
  ArgReader r{p};
  const int8_t* x = r.ptr<const int8_t>();
  const int batch = r.i(), h = r.i(), w = r.i(), cin = r.i(), mid = r.i(), cout = r.i();
  const int stride = r.i(), oh = r.i(), ow = r.i();
  const int s_expand = r.i(), s_dw = r.i(), s_project = r.i(), band = r.i();
  const uint8_t* we = r.ptr<const uint8_t>();
  const int* be = r.ptr<const int>();
  const int8_t* dw = r.ptr<const int8_t>();
  const uint8_t* wp = r.ptr<const uint8_t>();
  int8_t* out = r.ptr<int8_t>();
  const cudaStream_t s = r.ptr<CUstream_st>();
  const int k_expand = log2_exact(s_expand), k_dw = log2_exact(s_dw),
            k_project = log2_exact(s_project);
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || mid <= 0 || cout <= 0 ||
      stride <= 0 || k_expand < 0 || k_dw < 0 || k_project < 0 || band < 0 || band > oh ||
      oh != (h - 1) / stride + 1 || ow != (w - 1) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a;
  int blocks, smem;
  if (band == 0) {
    const int tile = etiny_block_tile(batch, h, w, cin, mid, cout, oh, ow);
    if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
    a.tile = tile;
    a.slots = ring_slots_fit(tile, h, w, cin, mid, cout, oh, ow);
    a.band = a.band_in = a.bands = 0;
    smem = Smem(tile, h, w, cin, mid, cout, oh, ow, a.slots).total;
    blocks = (batch + tile - 1) / tile;
  } else {
    // the most input rows a band reads: an interior band's
    const int in_max = (band - 1) * stride + 3 < h ? (band - 1) * stride + 3 : h;
    if (etiny_block_smem(1, in_max, w, cin, mid, cout, band, ow) > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    a.tile = 1;
    a.slots = ring_slots_fit(1, in_max, w, cin, mid, cout, band, ow);
    a.band = band;
    a.band_in = in_max;
    a.bands = (oh + band - 1) / band;
    if (static_cast<long long>(batch) * a.bands > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = Smem(1, in_max, w, cin, mid, cout, band, ow, a.slots).total;
    blocks = batch * a.bands;
  }
  const cudaError_t err = band ? allow_max_smem<true>() : allow_max_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.x = x;
  a.out = out;
  a.batch = batch;
  a.b = LbBlock{we, be, dw, wp, h, w, cin, mid, cout, stride, oh, ow,
                k_expand, k_dw, k_project, 0};
  if (band)
    etiny_block_kernel<true><<<blocks, kThreads, smem, s>>>(a);
  else
    etiny_block_kernel<false><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a run at `tile` images with the fewest ring slots (2),
// in bytes; -1 for a run of no blocks or of more than kMaxRun. p = [tile,
// n, then n x (h, w, cin, mid, cout, stride)].
int etiny_run_smem(const int64_t* p) {
  ArgReader r{p};
  const int tile = r.i(), n = r.i();
  if (tile <= 0 || n <= 0 || n > kMaxRun) return -1;
  int shape[kMaxRun][6];
  for (int k = 0; k < n; ++k)
    for (int f = 0; f < 6; ++f) shape[k][f] = r.i();
  return RunSmem(tile, shape, n, 2).total;
}

// One launch of a run of 2 to kMaxRun consecutive tile-path blocks, each
// block of threads a tile of `tile` images through all of them (the
// caller's plan, ops/etiny_kernels.py run_plan, picks the run and the
// tile, which must fit with 2 ring slots). a = [x, batch, tile, n, then n
// x (h, w, cin, mid, cout, stride, s_expand, s_dw, s_project, we, be, dw,
// wp), out, stream]; each block's input is the block before it's output.
int etiny_run_launch(const int64_t* p) {
  ArgReader r{p};
  RunArgs a;
  a.x = r.ptr<const int8_t>();
  a.batch = r.i();
  a.tile = r.i();
  a.n = r.i();
  if (a.batch <= 0 || a.tile <= 0 || a.n < 2 || a.n > kMaxRun)
    return static_cast<int>(cudaErrorInvalidValue);
  int shape[kMaxRun][6];
  int consts = 0;
  for (int k = 0; k < a.n; ++k) {
    LbBlock& b = a.b[k];
    b.h = r.i(); b.w = r.i(); b.cin = r.i(); b.mid = r.i(); b.cout = r.i(); b.stride = r.i();
    b.k_expand = log2_exact(r.i());
    b.k_dw = log2_exact(r.i());
    b.k_project = log2_exact(r.i());
    b.we = r.ptr<const uint8_t>();
    b.be = r.ptr<const int>();
    b.dw = r.ptr<const int8_t>();
    b.wp = r.ptr<const uint8_t>();
    if (b.h <= 0 || b.w <= 0 || b.cin <= 0 || b.mid <= 0 || b.cout <= 0 || b.stride <= 0 ||
        b.k_expand < 0 || b.k_dw < 0 || b.k_project < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    b.oh = (b.h - 1) / b.stride + 1;
    b.ow = (b.w - 1) / b.stride + 1;
    if (k > 0 && (b.h != a.b[k - 1].oh || b.w != a.b[k - 1].ow || b.cin != a.b[k - 1].cout))
      return static_cast<int>(cudaErrorInvalidValue);
    b.consts = consts;
    consts += align128(4 * b.mid) + align128(9 * b.mid);
    const int row[6] = {b.h, b.w, b.cin, b.mid, b.cout, b.stride};
    for (int f = 0; f < 6; ++f) shape[k][f] = row[f];
  }
  a.out = r.ptr<int8_t>();
  const cudaStream_t s = r.ptr<CUstream_st>();
  if (RunSmem(a.tile, shape, a.n, 2).total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  a.slots = kMaxSlots;
  while (a.slots > 2 && RunSmem(a.tile, shape, a.n, a.slots).total > kMaxSmem) --a.slots;
  const RunSmem sm(a.tile, shape, a.n, a.slots);
  a.q = sm.p;
  a.consts = sm.p + sm.q;
  a.ring = sm.p + sm.q + sm.consts;
  const cudaError_t err = allow_max_smem_run();
  if (err != cudaSuccess) return static_cast<int>(err);
  etiny_block_kernel_run<<<(a.batch + a.tile - 1) / a.tile, kThreads, sm.total, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
