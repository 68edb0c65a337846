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
// H100's 3.35 TB/s; at B = 8192 it moves 200 MB, ~60 us. Per value it does
// a multiply, an add, two clamps, a subtract and a division, far below the
// card's float32 rate. The TPU kernel DMA-gathered tiles of rows from a
// W-flipped, 128-lane padded second copy of the dataset through a
// sequential grid with semaphores. Here the dataset is held once, as
// (N, H, W, 3), and a reversed column index replaces the flipped copy.
//
// The design (csrc/bulk_ring.cuh): a persistent grid, as many blocks per SM
// as fit (ops/_ring.py), whose blocks walk items blockIdx.x,
// blockIdx.x + gridDim.x, ... An item is a band of one image: at most 1024
// pixels (ops/input_pipeline.py band_plan), whole rows of the image, or for
// a row wider than that, a segment of one row. A flip stays inside a row,
// so the flipped source of an item is one contiguous run too (the mirrored
// columns of the same rows), and the bands of an image are independent. A
// 32x32 image is one item of 12,288 bytes. Per item:
//   - thread 0 reads the image's index, alpha, beta and hole into the
//     parameter area, then brings the item's source bytes into `in` with one
//     1-D bulk copy; the slot's mbarrier releases both (bulk_ring.cuh);
//   - every thread walks (row, pixel) cells with no division per cell
//     (ring::Walk), reads the three channels of the mirrored or direct
//     pixel from `in` (a stride of three words: no bank conflict), and
//     writes the three results into `res`, the block's second region, with
//     each channel's mean and std fixed at compile time by the unrolled
//     channel loop. `in` and `res` are apart, so a flipped read never sees a
//     result;
//   - thread 0 issues the next item's copy into `in` at once, then stores
//     `res` with one bulk store; before the block writes `res` again, it
//     waits until that store has read it. So the next item's load overlaps
//     this item's store.
// At B = 8192 a block walks ~8 items and bytes bound the kernel. At B = 512
// a block has one item, and its time is a chain: the index read before the
// copy has an address, the copy, the division value by value (each
// __fdiv_rn's branch to its slow path keeps a thread's values apart) and
// the store; light_pipeline_phases reads it (PERF.md).
// An index outside [0, 2N) issues no copy: its item is written as NaN. The
// Python caller checks indices on the host.
//
// For the profiling probe (ops/input_pipeline.py light_pipeline_phases) the
// kernel records, when given a clock buffer, each block's SM clock at its
// start, when its first item's copy is issued, when that copy has landed,
// when the item's results are in `res`, and at the block's end after its
// stores are done. The main path passes none: one branch per block.
//
// Alignment: a bulk copy moves whole 16-byte units between 16-byte aligned
// addresses. Every item is, when H*W % 4 == 0 (and, for rows split into
// segments, W % 4 == 0). For other shapes (10x10 is, 77x77 is not) the same
// kernel places an item in its region at the source's offset modulo 16
// bytes, copies the aligned interior in bulk, and thread 0 moves the head
// and the tail (at most three values each) with plain loads before the
// copy's arrive, and with plain stores beside the bulk store. No shape is
// refused.
//
// C interface (ctypes): the launcher returns cudaGetLastError() after the
// launch. The kernel launches on the caller's stream and allocates nothing.
// The host (ops/input_pipeline.py) picks the bands and the grid;
// light_pipeline_blocks_per_sm reports the occupancy it sizes the grid with.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bulk_ring.cuh"

namespace {

using ring::kThreads;
constexpr int kC = 3;
constexpr int kCells = 1024;  // pixels per item at most (ops/input_pipeline.py BAND_CELLS)
constexpr int kHeader = 128;  // the barrier and the item's parameters

struct LightArgs {
  const float* dataset;  // (n, h, w, 3)
  const int* idx;        // (batch,) in [0, 2n)
  const float* pf;       // (batch, 2) [alpha, beta]
  const int* pi;         // (batch, 4) [y0, y1, x0, x1]
  int n, h, w, batch;
  int band_rows, band_cols;  // an item's extent: band_cols < w only when band_rows == 1
  int nby, nbx;              // items per image: nby x nbx
  float mean[kC], stdev[kC];  // ImageNet mean and std per channel
  float* out;            // (batch, h, w, 3)
  long long* stamps;     // (grid, 5) or null: a block's clocks, see below
};

// An item's scalars, written by thread 0 into the parameter area before the
// item's bulk copy is issued.
struct Item {
  float alpha, beta;
  int hy0, hy1, hx0, hx1;  // the hole
  int y0, x0, rows, cols;  // the item's output pixels: rows x cols from (y0, x0)
  int b, flip, ok;         // ok == 0: index out of range, the item is NaN
  int in_at, out_at;       // floats from a region's start to the item's first value
};

// floats per region: an item and up to three values of offset, in whole
// 16-byte units
__host__ __device__ constexpr int region_floats(int cells) { return (cells * kC + 7) & ~3; }

int light_smem_bytes(int rows, int cols) {
  return kHeader + 2 * region_floats(rows * cols) * 4;
}

// `vals` values at global address g, split for a bulk copy: the first value
// sits `at` floats past a 16-byte boundary, so it goes `at` floats into a
// region; `head` values up to the boundary and the tail past the `body`
// (whole 16-byte units) move with plain loads and stores
struct Split {
  int at, head, body;
};

__device__ __forceinline__ Split split(const float* g, int vals) {
  Split s;
  s.at = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3u);
  s.head = min((4 - s.at) & 3, vals);
  s.body = (vals - s.head) & ~3;
  return s;
}

// one pixel's three channels, from its source pixel p to its result q;
// `zero`: the pixel lies in the hole
__device__ __forceinline__ void light_pixel(const LightArgs& a, const float* p, float* q,
                                            float alpha, float beta, bool zero) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float v = fminf(fmaxf(__fadd_rn(__fmul_rn(p[c], alpha), beta), 0.0f), 1.0f);
    if (zero) v = 0.0f;
    q[c] = __fdiv_rn(__fsub_rn(v, a.mean[c]), a.stdev[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
light_pipeline_kernel(LightArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Item* item = reinterpret_cast<Item*>(smem + 16);
  float* in = reinterpret_cast<float*>(smem + kHeader);
  float* res = in + region_floats(a.band_rows * a.band_cols);
  const size_t img = static_cast<size_t>(a.h) * a.w * kC;
  const int per_image = a.nby * a.nbx;
  const int nlocal = ring::local_items(a.batch * per_image);

  // thread 0: item i's scalars into the parameter area, then its bytes
  auto issue = [&](int i) {
    const int it = blockIdx.x + i * gridDim.x;
    const int b = it / per_image;  // once per item
    const int j = it - b * per_image;
    const int jy = j / a.nbx;
    const int y0 = jy * a.band_rows, x0 = (j - jy * a.nbx) * a.band_cols;
    const int rows = min(a.band_rows, a.h - y0), cols = min(a.band_cols, a.w - x0);
    const int vals = rows * cols * kC;
    const int e = __ldg(a.idx + b);
    const bool ok = e >= 0 && e < 2 * a.n;
    const bool flip = ok && e >= a.n;
    item->alpha = __ldg(a.pf + 2 * static_cast<size_t>(b));
    item->beta = __ldg(a.pf + 2 * static_cast<size_t>(b) + 1);
    item->hy0 = __ldg(a.pi + 4 * static_cast<size_t>(b));
    item->hy1 = __ldg(a.pi + 4 * static_cast<size_t>(b) + 1);
    item->hx0 = __ldg(a.pi + 4 * static_cast<size_t>(b) + 2);
    item->hx1 = __ldg(a.pi + 4 * static_cast<size_t>(b) + 3);
    item->y0 = y0;
    item->x0 = x0;
    item->rows = rows;
    item->cols = cols;
    item->b = b;
    item->flip = flip;
    item->ok = ok;
    const size_t at = static_cast<size_t>(y0) * a.w;
    item->out_at = split(a.out + b * img + (at + x0) * kC, vals).at;
    if (!ok) {
      item->in_at = 0;
      ring::mbar_expect_tx(bar, 0);  // no copy: the arrive completes the phase
      return;
    }
    // the mirrored columns of the same rows, for a flip
    const float* src = a.dataset + static_cast<size_t>(flip ? e - a.n : e) * img +
                       (at + (flip ? a.w - x0 - cols : x0)) * kC;
    const Split s = split(src, vals);
    float* dst = in + s.at;
    item->in_at = s.at;
    for (int k = 0; k < s.head; ++k) dst[k] = __ldg(src + k);
    for (int k = s.head + s.body; k < vals; ++k) dst[k] = __ldg(src + k);
    const uint32_t bytes = static_cast<uint32_t>(s.body) * 4u;
    ring::mbar_expect_tx(bar, bytes);
    if (bytes) ring::bulk_load(dst + s.head, src + s.head, bytes, bar);
  };

  long long* stamp = a.stamps ? a.stamps + 5 * static_cast<size_t>(blockIdx.x) : nullptr;
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    ring::mbar_init(bar, 1);
    ring::fence_mbar_init();
    issue(0);  // the grid is at most the item count: every block has an item
    if (stamp) {
      stamp[0] = t0;
      stamp[1] = clock64();
    }
  }
  __syncthreads();

  for (int i = 0; i < nlocal; ++i) {
    if (i > 0) {
      // the last item's store has read `res`
      if (threadIdx.x == 0) ring::bulk_wait_read();
      __syncthreads();
    }
    ring::mbar_wait(bar, i & 1);
    if (stamp && i == 0 && threadIdx.x == 0) stamp[2] = clock64();
    // the item's scalars into registers: the stores into `res` below would
    // otherwise make the compiler read them again
    const float alpha = item->alpha, beta = item->beta;
    const int hy0 = item->hy0, hy1 = item->hy1, hx0 = item->hx0, hx1 = item->hx1;
    const int y0 = item->y0, x0 = item->x0, rows = item->rows, cols = item->cols;
    const bool flip = item->flip, ok = item->ok;
    const float* src = in + item->in_at;
    float* dst = res + item->out_at;
    if (ok) {
      const ring::Walk walk(cols);  // two divisions per thread and item
      for (int r = walk.a0, x = walk.l0; r < rows; walk.next(r, x)) {
        const int cell = r * cols + x;
        const int y = y0 + r, xg = x0 + x;
        light_pixel(a, src + (flip ? cell + cols - 1 - 2 * x : cell) * kC, dst + cell * kC,
                    alpha, beta, y >= hy0 && y < hy1 && xg >= hx0 && xg < hx1);
      }
    } else {
      for (int k = threadIdx.x; k < rows * cols * kC; k += kThreads)
        dst[k] = __int_as_float(0x7fc00000);
    }
    ring::fence_async_shared();
    __syncthreads();
    if (stamp && i == 0 && threadIdx.x == 0) stamp[3] = clock64();

    if (threadIdx.x == 0) {
      // this item's destination, before issue() rewrites the parameter area
      const int vals = rows * cols * kC;
      float* out = a.out + item->b * img + (static_cast<size_t>(y0) * a.w + x0) * kC;
      if (i + 1 < nlocal) issue(i + 1);  // `in` is free: its load overlaps the store
      const Split s = split(out, vals);  // s.at == the item's out_at
      for (int k = 0; k < s.head; ++k) out[k] = dst[k];
      for (int k = s.head + s.body; k < vals; ++k) out[k] = dst[k];
      if (s.body) ring::bulk_store(out + s.head, dst + s.head, static_cast<uint32_t>(s.body) * 4u);
    }
  }
  if (threadIdx.x == 0) {
    ring::bulk_wait_all();
    if (stamp) stamp[4] = clock64();
  }
}

unsigned g_smem_set = 0;

}  // namespace

extern "C" {

int light_pipeline_blocks_per_sm(int band_rows, int band_cols) {
  if (band_rows <= 0 || band_cols <= 0 || static_cast<int64_t>(band_rows) * band_cols > kCells)
    return 0;
  return ring::blocks_per_sm(light_pipeline_kernel, &g_smem_set,
                             light_smem_bytes(band_rows, band_cols));
}

// a = [dataset, n, h, w, idx, pf, pi, batch, band_rows, band_cols, grid, out,
// mean and std as six float32 in three words, stamps (0: none), stream]: one
// packed argument, so that the host's call converts one pointer
int light_pipeline_launch(const int64_t* p) {
  LightArgs a;
  a.dataset = reinterpret_cast<const float*>(p[0]);
  a.n = static_cast<int>(p[1]);
  a.h = static_cast<int>(p[2]);
  a.w = static_cast<int>(p[3]);
  a.idx = reinterpret_cast<const int*>(p[4]);
  a.pf = reinterpret_cast<const float*>(p[5]);
  a.pi = reinterpret_cast<const int*>(p[6]);
  a.batch = static_cast<int>(p[7]);
  a.band_rows = static_cast<int>(p[8]);
  a.band_cols = static_cast<int>(p[9]);
  const int grid = static_cast<int>(p[10]);
  a.out = reinterpret_cast<float*>(p[11]);
  memcpy(a.mean, p + 12, sizeof a.mean);
  memcpy(a.stdev, reinterpret_cast<const char*>(p + 12) + sizeof a.mean, sizeof a.stdev);
  a.stamps = reinterpret_cast<long long*>(p[15]);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(p[16]);
  // whole rows, or one row's segment; at most kCells pixels
  if (a.batch <= 0 || a.n <= 0 || a.n > 0x3fffffff || a.h <= 0 || a.w <= 0 ||
      a.band_rows <= 0 || a.band_cols <= 0 || a.band_rows > a.h || a.band_cols > a.w ||
      (a.band_cols < a.w && a.band_rows != 1) ||
      static_cast<int64_t>(a.band_rows) * a.band_cols > kCells)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nby = (a.h + a.band_rows - 1) / a.band_rows;
  a.nbx = (a.w + a.band_cols - 1) / a.band_cols;
  const int64_t items = static_cast<int64_t>(a.batch) * a.nby * a.nbx;
  // blockIdx.x + i * gridDim.x stays an int
  if (grid <= 0 || grid > items || items + grid > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = light_smem_bytes(a.band_rows, a.band_cols);
  const cudaError_t err = ring::allow_max_smem(light_pipeline_kernel, &g_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  light_pipeline_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
