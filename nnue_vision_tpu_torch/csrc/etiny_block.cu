// One EtinyNet int8 LB block for Hopper (sm_90a), on the int8 tensor cores.
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
//      the depthwise weights are copied to shared memory while the first
//      weight stages load.
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
// What bounds it now (PERF.md, PR 5): the blocks at 16x16 and 8x8 with 28
// channels, half of the 12 blocks' time at batch 8192, where the
// CUDA-core work per row (epilogues, depthwise) and each tile's latencies
// weigh more than the products; the final block's weights the most of the
// rest. Loops that read shared or device memory and write shared memory
// name their regions __restrict__ (they never overlap), so that a value's
// reads are not held behind the last value's store.
//
// C interface (ctypes): the launcher returns cudaGetLastError() after the
// launch. The kernel launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using namespace int8mma;

constexpr int kMaxSmem = 232448;  // what a block may use on sm_90
constexpr int kRowTarget = 256;   // GEMM rows a tile aims for
constexpr int kSuperRows = 64;    // rows per product super-tile (<2, 2>)

struct BlockArgs {
  const int8_t* x;        // (batch, h, w, cin)
  int batch, tile;        // images in all, images per block of threads
  int slots;              // weight ring slots: 2 to kMaxSlots
  int h, w, cin, mid, cout, stride, oh, ow;
  int k_expand, k_dw, k_project;  // the scales' log2 (they are powers of two)
  const uint8_t* we;      // pw-expand (mid, cin) as mma tiles
  const int* be;          // (mid,)
  const int8_t* dw;       // (mid, 3, 3)
  const uint8_t* wp;      // pw-project (cout, mid) as mma tiles
  int8_t* out;            // (batch, oh, ow, cout)
};

__host__ __device__ inline int align128(int n) { return round_up(n, 128); }

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

__global__ void __launch_bounds__(kThreads)
etiny_block_kernel(BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm(a.tile, a.h, a.w, a.cin, a.mid, a.cout, a.oh, a.ow, a.slots);
  int8_t* xs = reinterpret_cast<int8_t*>(smem);    // (rows, a_stride(cin))
  int8_t* h2 = xs;                                 // (orows, a_stride(mid))
  int8_t* h1 = xs + sm.x_and_h2;                   // (rows, mid)
  int8_t* os = h1;                                 // (orows, cout), after h1
  int* s_be = reinterpret_cast<int*>(smem + sm.x_and_h2 + sm.h1);  // (mid,)
  int8_t* s_dw = reinterpret_cast<int8_t*>(s_be) + align128(4 * a.mid);  // (mid, 9)
  unsigned char* ring = smem + sm.x_and_h2 + sm.h1 + sm.consts;

  const int hw = a.h * a.w, ohw = a.oh * a.ow;
  const int img0 = blockIdx.x * a.tile;
  const int n_img = min(a.tile, a.batch - img0);
  const int rows = n_img * hw, orows = n_img * ohw;
  const int ldx = a_stride(a.cin), ldh = a_stride(a.mid);
  const int cin_steps = k_stages(a.cin);  // K stages of pw-expand
  const int mid_steps = k_stages(a.mid);  // and of pw-project

  // 1 + 2. The input tile, the bias and the depthwise weights land while
  // the first weight stages load (the epilogues would otherwise wait on a
  // device-memory read per value); then pw-expand + bias, /s_expand, ReLU6
  // into h1.
  auto load_x = [&] {
    for (int m = threadIdx.x; m < a.mid; m += blockDim.x) s_be[m] = __ldg(a.be + m);
    for (int e = threadIdx.x; e < a.mid * 9; e += blockDim.x) s_dw[e] = a.dw[e];
    const int8_t* xg = a.x + static_cast<size_t>(img0) * hw * a.cin;
    if ((a.cin & 3) == 0) {
      const int words = a.cin >> 2;
      const int* __restrict__ xw = reinterpret_cast<const int*>(xg);
      int* __restrict__ xd = reinterpret_cast<int*>(xs);
#pragma unroll 4
      for (int e = threadIdx.x; e < rows * words; e += blockDim.x) {
        const int r = e / words, k = e - r * words;
        xd[(r * ldx >> 2) + k] = __ldg(xw + e);
      }
    } else {
      for (int e = threadIdx.x; e < rows * a.cin; e += blockDim.x) {
        const int r = e / a.cin, k = e - r * a.cin;
        xs[r * ldx + k] = xg[e];
      }
    }
  };
  stream_gemm<2, 2>(
      xs, ldx, (rows + kSuperRows - 1) / kSuperRows, a.we, Chunks{0, 1, (a.mid + kCols - 1) / kCols},
      a.cin, a.mid, cin_steps, 0, ring, a.slots, blockIdx.x, load_x,
      [&](int, int c, const auto& acc, int row0, int col0) {
        for_each_sum_col(
            acc, row0, c * kCols + col0, [&](int m) { return m < a.mid ? s_be[m] : 0; },
            [&](int r, int m, int v, int bias) {
              if (r < rows && m < a.mid)
                h1[r * a.mid + m] = static_cast<int8_t>(clampi(tdiv_pow2(v + bias, a.k_expand), 0, 6));
            });
      });

  // 3. depthwise 3x3, zero padding, at the block's stride; /s_dw, ReLU6.
  // (The regions do not overlap: said so, the compiler may batch one
  // value's reads ahead of the last value's store.)
  {
  const int8_t* __restrict__ hsrc = h1;
  const int8_t* __restrict__ wsrc = s_dw;
  int8_t* __restrict__ hdst = h2;
#pragma unroll 2
  for (int e = threadIdx.x; e < orows * a.mid; e += blockDim.x) {
    const int orow = e / a.mid, m = e - orow * a.mid;
    const int img = orow / ohw, op = orow - img * ohw;
    const int oy = op / a.ow, ox = op - oy * a.ow;
    const int8_t* hin = hsrc + img * hw * a.mid + m;
    const int8_t* wd = wsrc + m * 9;
    int acc = 0;
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = oy * a.stride + ky - 1;
      if (iy < 0 || iy >= a.h) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = ox * a.stride + kx - 1;
        if (ix < 0 || ix >= a.w) continue;
        acc += static_cast<int>(hin[(iy * a.w + ix) * a.mid]) *
               static_cast<int>(wd[ky * 3 + kx]);
      }
    }
    hdst[orow * ldh + m] = static_cast<int8_t>(clampi(tdiv_pow2(acc, a.k_dw), 0, 6));
  }
  }
  __syncthreads();

  // 4. pw-project, /s_project, clamp +-127 into the output tile, which then
  // goes to device memory in 16-byte stores where the addresses allow.
  int8_t* og = a.out + static_cast<size_t>(img0) * ohw * a.cout;
  stream_gemm<2, 2>(
      h2, ldh, (orows + kSuperRows - 1) / kSuperRows, a.wp, Chunks{0, 1, (a.cout + kCols - 1) / kCols},
      a.mid, a.cout, mid_steps, 0, ring, a.slots, blockIdx.x, [] {},
      [&](int, int c, const auto& acc, int row0, int col0) {
        for_each_sum(acc, row0, c * kCols + col0, [&](int r, int o, int v) {
          if (r < orows && o < a.cout)
            os[r * a.cout + o] = static_cast<int8_t>(clampi(tdiv_pow2(v, a.k_project), -127, 127));
        });
      });
  const int bytes = orows * a.cout;
  if (((reinterpret_cast<uintptr_t>(og) | bytes) & 15) == 0) {
    for (int e = threadIdx.x; e < (bytes >> 4); e += blockDim.x)
      reinterpret_cast<int4*>(og)[e] = reinterpret_cast<const int4*>(os)[e];
  } else {
    for (int e = threadIdx.x; e < bytes; e += blockDim.x) og[e] = os[e];
  }
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

int etiny_block_launch(
    const void* x, int batch, int h, int w, int cin, int mid, int cout,
    int stride, int oh, int ow, int s_expand, int s_dw, int s_project,
    const void* we, const void* be, const void* dw, const void* wp, void* out,
    void* stream) {
  const int k_expand = log2_exact(s_expand), k_dw = log2_exact(s_dw),
            k_project = log2_exact(s_project);
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || mid <= 0 || cout <= 0 ||
      stride <= 0 || k_expand < 0 || k_dw < 0 || k_project < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = etiny_block_tile(batch, h, w, cin, mid, cout, oh, ow);
  if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        etiny_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  BlockArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.batch = batch; a.tile = tile;
  a.slots = ring_slots_fit(tile, h, w, cin, mid, cout, oh, ow);
  a.h = h; a.w = w; a.cin = cin; a.mid = mid; a.cout = cout;
  a.stride = stride; a.oh = oh; a.ow = ow;
  a.k_expand = k_expand; a.k_dw = k_dw; a.k_project = k_project;
  a.we = static_cast<const uint8_t*>(we);
  a.be = static_cast<const int*>(be);
  a.dw = static_cast<const int8_t*>(dw);
  a.wp = static_cast<const uint8_t*>(wp);
  a.out = static_cast<int8_t*>(out);
  const int smem = Smem(tile, h, w, cin, mid, cout, oh, ow, a.slots).total;
  const int blocks = (batch + tile - 1) / tile;
  etiny_block_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
