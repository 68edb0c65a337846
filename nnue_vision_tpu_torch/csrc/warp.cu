// The composed-geometry bilinear warp for Hopper (sm_90a).
//
//   warp_kernel       replaces nnue_vision_tpu/ops/warp_kernel.py
//                     _lerp_pass_kernel (lerp_pass, driven by
//                     warp_bilinear): the whole two-pass warp of an image
//                     in one launch.
//   lerp_pass_kernel  one pass alone, the TPU kernel at its own
//     <true>          granularity (lerp_pass): for the profiling probe.
//   lerp_pass_kernel  replaces scripts/profile_warp_split.py
//     <false>         _nogather_kernel (_nogather_pass): the same pass with
//                     the two reads at the computed positions replaced by a
//                     read of the output's own position, to price the
//                     gather.
//
// All three run one position, tap and blend arithmetic (position(), taps()
// and blend() below), so the probe prices the arithmetic the shipped kernel
// runs.
//
// What it computes, for a square (n, n, 3) image and its packed parameters
// p = [swap, k1_row, k1_lane, k1_c, k2_row, k2_lane, k2_c, 0]
// (warp_coefficients in ops/warp_kernel.py):
//   src(y, x)      = swap ? in(x, y) : in(y, x)             (axis swap)
//   tmp(yi, xo)    = lerp of src row yi at  q = k1_row*yi + k1_lane*xo + k1_c
//   out(yo, xo)    = lerp of tmp column xo at p = k2_row*xo + k2_lane*yo + k2_c
// where lerp(row, pos) = row[i0]*(1 - fr) + row[i0 + 1]*fr, i0 = floor(pos),
// fr = pos - i0, a corner outside [0, n) reading 0. The products and sums
// are spelled __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order
// (warp_bilinear_reference, two eager lerp passes), so nvcc cannot contract
// them into FMAs and the kernel is bit-equal to it. The build does not use
// --use_fast_math.
//
// What bounds it on the card: bytes. At B = 8192 the warp reads and writes
// 100.7 MB each way, 0.060 ms at 3.35 TB/s; per value it does ~18 float
// operations and ~6 shared-memory accesses, below both rates. Tensor cores
// do not apply: nothing in the warp is a product of two matrices, only
// per-value blends at data-dependent positions.
//
// The design (csrc/bulk_ring.cuh): a persistent grid, as many blocks per
// SM as fit (ops/_ring.py), whose blocks walk their images through one
// shared-memory slot each. One thread brings a whole image (12,288 bytes at
// 32x32x3) into the slot with a 1-D bulk copy; the result goes back into
// the slot and out with one bulk store. The resident blocks overlap one
// another's copies and compute. Per image:
//   - pass 1 reads the slot and writes the intermediate into `tmp`, whose
//     rows are padded to 3n + 1 floats, so that a walk down a column of it
//     touches 32 different banks. The swap is an index into the slot, and
//     the threads walk the axis that is contiguous in the slot: x for an
//     image read as it is, y for a swapped one (a swapped row is a column
//     of the slot, 3n floats apart: the same bank at n = 32);
//   - pass 2 reads `tmp` down its columns and writes the output pixels into
//     the slot, which pass 1 no longer needs.
// A thread handles a (row, pixel) cell with the three channels in
// registers, computing the position and the taps once per cell; cells are
// walked without a division per cell (ring::Walk). The TPU kernel ran each
// pass as a separate launch over (B, R, N*C) rows with lane gathers inside
// one vector register, and XLA transposed between the passes.
//
// lerp_pass_kernel runs one pass over a (B, R, n*3) float32 batch of packed
// rows, in tiles of at most 1024 cells (32 rows of 384 bytes at n = 32)
// through the same slot; the issuing warp also writes each tile row's
// coefficients and row index into the parameter area, a row a lane, so no
// thread divides to find its image. A thread computes its (at most 4) cells into
// registers, the block syncs, and the results replace the tile in the slot
// for the bulk store. Bound: bytes, 12.6 MB each way at B = 1024, 0.0075 ms.
//
// C interface (ctypes): each launcher returns cudaGetLastError() after the
// launch. The kernels launch on the caller's stream and allocate nothing.
// The host (ops/warp_kernel.py) picks the grid and the tile;
// *_blocks_per_sm report the occupancy it sizes the grid with.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

using ring::kThreads;
constexpr int kC = 3;          // channels
constexpr int kParams = 8;     // packed warp parameters per image
constexpr int kHeader = 128;   // the barrier and the image's parameters
constexpr int kTileCells = 1024;
constexpr int kCellsPerThread = kTileCells / kThreads;
constexpr int kRowParams = 4;  // k_row, k_lane, k_c, row index

// The two taps of a linear resample at `pos` along an axis of extent n:
// i0 = floor(pos), its weight fraction, and which taps lie inside [0, n).
struct Taps {
  int i0;
  float fr;
  bool in0, in1;
};

__device__ __forceinline__ Taps taps(float pos, int n) {
  const float i0f = floorf(pos);
  Taps t;
  t.i0 = static_cast<int>(i0f);
  t.fr = __fsub_rn(pos, i0f);
  t.in0 = t.i0 >= 0 && t.i0 < n;
  t.in1 = t.i0 + 1 >= 0 && t.i0 + 1 < n;
  return t;
}

// v0*(1 - fr) + v1*fr; the caller reads 0 for a tap outside the axis.
__device__ __forceinline__ float blend(const Taps& t, float v0, float v1) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, t.fr)), __fmul_rn(v1, t.fr));
}

__device__ __forceinline__ float position(float k_row, float row, float k_lane,
                                          float lane, float k_c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k_row, row), __fmul_rn(k_lane, lane)), k_c);
}

// The three channels of a resample along an axis whose taps lie `step`
// floats apart in `base` (channel ch at base[i*step + ch]).
__device__ __forceinline__ void lerp3(const float* base, int step, const Taps& t,
                                      float* out) {
  const float* p0 = base + t.i0 * step;
  const float* p1 = p0 + step;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch)
    out[ch] = blend(t, t.in0 ? p0[ch] : 0.0f, t.in1 ? p1[ch] : 0.0f);
}

// the header, the slot and tmp
int warp_smem_bytes(int n) { return kHeader + n * n * kC * 4 + n * (kC * n + 1) * 4; }

// the header, the slot and its rows' parameters
int pass_smem_bytes(int n, int tile_rows) {
  return kHeader + tile_rows * (n * kC + kRowParams) * 4;
}

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ x, const float* __restrict__ params,
            int batch, int n, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* prm = reinterpret_cast<float*>(smem + 64);
  float* slot = reinterpret_cast<float*>(smem + kHeader);
  const int img = n * n * kC;
  const int tstride = kC * n + 1;
  float* tmp = slot + img;
  const uint32_t img_bytes = static_cast<uint32_t>(img) * 4u;
  const int nlocal = ring::local_items(batch);

  // one thread: image i's parameters (eight loads, one round trip), then
  // its bytes
  auto issue = [&](int i) {
    const size_t b = blockIdx.x + static_cast<size_t>(i) * gridDim.x;
    const float* p = params + b * kParams;
#pragma unroll
    for (int k = 0; k < kParams; ++k) prm[k] = __ldg(p + k);
    ring::mbar_expect_tx(bar, img_bytes);
    ring::bulk_load(slot, x + b * img, img_bytes, bar);
  };

  if (threadIdx.x == 0) {
    ring::mbar_init(bar, 1);
    ring::fence_mbar_init();
    issue(0);  // the grid is at most the batch: every block has an image
  }
  __syncthreads();

  const ring::Walk walk(n);
  for (int i = 0; i < nlocal; ++i) {
    ring::mbar_wait(bar, i & 1);
    const bool swap = prm[0] > 0.5f;
    const float k1r = prm[1], k1l = prm[2], k1c = prm[3];
    const float k2r = prm[4], k2l = prm[5], k2c = prm[6];

    // pass 1: tmp(yi, xo) = lerp along x of src row yi; the walk's fast
    // index l is the slot's contiguous axis
    const int row_step = swap ? kC : n * kC;  // src(yi, .) row start, per yi
    const int tap_step = swap ? n * kC : kC;  // src(yi, x) -> src(yi, x + 1)
    for (int a = walk.a0, l = walk.l0; a < n; walk.next(a, l)) {
      const int yi = swap ? l : a;
      const int xo = swap ? a : l;
      const Taps t = taps(position(k1r, static_cast<float>(yi), k1l,
                                   static_cast<float>(xo), k1c), n);
      lerp3(slot + yi * row_step, tap_step, t, tmp + yi * tstride + xo * kC);
    }
    __syncthreads();

    // pass 2: out(yo, xo) = lerp along y of tmp column xo, into the slot
    for (int yo = walk.a0, xo = walk.l0; yo < n; walk.next(yo, xo)) {
      const Taps t = taps(position(k2r, static_cast<float>(xo), k2l,
                                   static_cast<float>(yo), k2c), n);
      lerp3(tmp + xo * kC, tstride, t, slot + (yo * n + xo) * kC);
    }
    ring::fence_async_shared();
    __syncthreads();

    if (threadIdx.x == 0) {
      const int b = blockIdx.x + i * gridDim.x;
      ring::bulk_store(out + static_cast<size_t>(b) * img, slot, img_bytes);
      // the next image, once the store has read the slot
      if (i + 1 < nlocal) {
        ring::bulk_wait_read();
        issue(i + 1);
      }
    }
  }
  if (threadIdx.x == 0) ring::bulk_wait_all();
}

// One resample pass over (B, rows, n*3) packed rows: lane l = x*3 + ch of
// row r reads positions k_row*r + k_lane*x + k_c of its row (kGather), or
// its own value in their place (the no-gather control). Items are tiles of
// `tile_rows` consecutive rows of the flattened batch.
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
lerp_pass_kernel(const float* __restrict__ x, const float* __restrict__ coef,
                 int batch, int rows, int n, int tile_rows, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int lanes = n * kC;
  float* slot = reinterpret_cast<float*>(smem + kHeader);
  float* prm = slot + tile_rows * lanes;  // [tile row][k_row, k_lane, k_c, r]
  const int total = batch * rows;
  const int items = (total + tile_rows - 1) / tile_rows;
  const int nlocal = ring::local_items(items);
  const uint32_t row_bytes = static_cast<uint32_t>(lanes) * 4u;

  auto tile_rows_of = [&](int i) {
    const int row0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    return min(tile_rows, total - row0);
  };
  // warp 0: tile i's rows' coefficients and row indices into the parameter
  // area (lane k: rows k, k + 32, ..., one division a row), then lane 0
  // brings the tile into the slot
  auto issue = [&](int i) {
    const int row0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const int nr = tile_rows_of(i);
    for (int k = threadIdx.x; k < nr; k += 32) {
      const int b = (row0 + k) / rows;
      const float* kc = coef + 3 * b;
      prm[k * kRowParams + 0] = __ldg(kc);
      prm[k * kRowParams + 1] = __ldg(kc + 1);
      prm[k * kRowParams + 2] = __ldg(kc + 2);
      prm[k * kRowParams + 3] = static_cast<float>(row0 + k - b * rows);
    }
    __syncwarp();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nr) * row_bytes;
      ring::mbar_expect_tx(bar, bytes);
      ring::bulk_load(slot, x + static_cast<size_t>(row0) * lanes, bytes, bar);
    }
  };

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      ring::mbar_init(bar, 1);
      ring::fence_mbar_init();
    }
    __syncwarp();
    issue(0);  // the grid is at most the tile count: every block has a tile
  }
  __syncthreads();

  const ring::Walk walk(n);
  for (int i = 0; i < nlocal; ++i) {
    ring::mbar_wait(bar, i & 1);
    const int nr = tile_rows_of(i);

    float res[kCellsPerThread][kC];
    {
      int a = walk.a0, l = walk.l0;
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k, walk.next(a, l)) {
        if (a >= nr) break;
        const float* kr = prm + a * kRowParams;
        const Taps t = taps(position(kr[0], kr[3], kr[1], static_cast<float>(l),
                                     kr[2]), n);
        const float* row = slot + a * lanes;
        if constexpr (kGather) {
          lerp3(row, kC, t, res[k]);
        } else {
#pragma unroll
          for (int ch = 0; ch < kC; ++ch) {
            const float v = row[l * kC + ch];
            res[k][ch] = blend(t, t.in0 ? v : 0.0f, t.in1 ? v : 0.0f);
          }
        }
      }
    }
    __syncthreads();  // every read of the tile is done: overwrite it
    {
      int a = walk.a0, l = walk.l0;
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k, walk.next(a, l)) {
        if (a >= nr) break;
#pragma unroll
        for (int ch = 0; ch < kC; ++ch) slot[a * lanes + l * kC + ch] = res[k][ch];
      }
    }
    ring::fence_async_shared();
    __syncthreads();

    if (threadIdx.x < 32) {
      const bool next = i + 1 < nlocal;
      if (threadIdx.x == 0) {
        const size_t row0 = static_cast<size_t>(blockIdx.x + i * gridDim.x) * tile_rows;
        ring::bulk_store(out + row0 * lanes, slot, static_cast<uint32_t>(nr) * row_bytes);
        // the next tile, once the store has read the slot
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

unsigned g_warp_smem_set = 0, g_pass_smem_set[2] = {0, 0};

}  // namespace

extern "C" {

int warp_blocks_per_sm(int n) {
  if (n <= 0) return 0;
  return ring::blocks_per_sm(warp_kernel, &g_warp_smem_set, warp_smem_bytes(n));
}

int lerp_pass_blocks_per_sm(int n, int tile_rows, int gather) {
  if (n <= 0 || tile_rows <= 0) return 0;
  const int smem = pass_smem_bytes(n, tile_rows);
  return gather ? ring::blocks_per_sm(lerp_pass_kernel<true>, &g_pass_smem_set[1], smem)
                : ring::blocks_per_sm(lerp_pass_kernel<false>, &g_pass_smem_set[0], smem);
}

// a = [x, batch, n, c, params, grid, out, stream]: one packed argument, so
// that the host's call converts one pointer
int warp_launch(const int64_t* a) {
  const float* x = reinterpret_cast<const float*>(a[0]);
  const int batch = static_cast<int>(a[1]), n = static_cast<int>(a[2]);
  const int c = static_cast<int>(a[3]);
  const float* params = reinterpret_cast<const float*>(a[4]);
  const int grid = static_cast<int>(a[5]);
  float* out = reinterpret_cast<float*>(a[6]);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[7]);
  // C = 3, and an image of whole 16-byte units (n even) at 16-byte aligned
  // addresses: what the bulk copies take
  if (batch <= 0 || n <= 0 || n % 2 || c != kC || grid <= 0 || grid > batch ||
      !ring::aligned16(x) || !ring::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = warp_smem_bytes(n);
  if (smem > ring::kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ring::allow_max_smem(warp_kernel, &g_warp_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_kernel<<<grid, kThreads, smem, stream>>>(x, params, batch, n, out);
  return static_cast<int>(cudaGetLastError());
}

// a = [x, batch, rows, n, c, coef, gather, tile_rows, grid, out, stream]
int lerp_pass_launch(const int64_t* a) {
  const float* x = reinterpret_cast<const float*>(a[0]);
  const int batch = static_cast<int>(a[1]), rows = static_cast<int>(a[2]);
  const int n = static_cast<int>(a[3]), c = static_cast<int>(a[4]);
  const float* coef = reinterpret_cast<const float*>(a[5]);
  const bool gather = a[6] != 0;
  const int tile_rows = static_cast<int>(a[7]), grid = static_cast<int>(a[8]);
  float* out = reinterpret_cast<float*>(a[9]);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[10]);
  // C = 3, rows of whole 16-byte units (n % 4 == 0), tiles of at most
  // kTileCells cells
  if (batch <= 0 || rows <= 0 || n <= 0 || n % 4 || c != kC || tile_rows <= 0 ||
      tile_rows * n > kTileCells || !ring::aligned16(x) || !ring::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * rows;
  const long long items = (total + tile_rows - 1) / tile_rows;
  if (total > (1LL << 31) - 1 || grid <= 0 || grid > items)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pass_smem_bytes(n, tile_rows);
  if (smem > ring::kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (gather) {
    err = ring::allow_max_smem(lerp_pass_kernel<true>, &g_pass_smem_set[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    lerp_pass_kernel<true><<<grid, kThreads, smem, stream>>>(x, coef, batch, rows, n,
                                                             tile_rows, out);
  } else {
    err = ring::allow_max_smem(lerp_pass_kernel<false>, &g_pass_smem_set[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    lerp_pass_kernel<false><<<grid, kThreads, smem, stream>>>(x, coef, batch, rows, n,
                                                              tile_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
