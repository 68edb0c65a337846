// The int8 tensor-core building block shared by the serving kernels
// (nnue_head.cu, etiny_block.cu).
//
// A block of 256 threads (8 warps) multiplies an int8 A operand held in
// shared memory, (rows, K) row-major, by a weight matrix W (N, K) streamed
// from device memory, and hands each warp's int32 sums to an epilogue. The
// products are exact: int8 x int8 summed in int32 with no saturation (no
// .satfinite).
//
// The product is mma.sync.aligned.m16n8k32 (s8.s8 or u8.u8 into s32), fed
// by ldmatrix. It was taken over wgmma because the serving kernels' tiles
// are small and ragged: a tile of NNUE images has 1-64 rows (fewer at a
// small batch, so that the grid fills the card), and an EtinyNet block's
// rows are images x positions; mma.sync takes 16-row pieces, where wgmma
// needs a 64-row warpgroup tile and descriptors for its shared-memory
// layout. At these sizes the weights' trip from L2, not the tensor-core
// rate, is the limit (see each kernel's notes).
//
// Weight layout (built once per model by the Python wrappers,
// ops/nnue_kernels.py mma_tiles): W padded with zeros to N a multiple of
// 128 and K a multiple of 128, stored as (N/128, K/128, 128, 128) bytes, so
// that one stage, 128 K-bytes of 128 columns, is 16 KB contiguous. The
// stages reach shared memory through a ring of 2 to kMaxSlots slots filled
// by cp.async (commit_group / wait_group): the next stages load while the
// current one is multiplied. Where every stage of one super-tile fits in
// the ring, it stays there and serves the later super-tiles without a
// reload. Each block starts at its own chunk and stage (`rot`), so that the
// SMs do not all ask L2 for the same lines at once; integer sums do not
// depend on the order. In a slot each column's 128 bytes are padded to 144
// so that ldmatrix reads without bank conflicts; A's row stride is
// round_up(K, 32) + 16 bytes for the same reason. The products skip the
// 32-byte K steps past K; within the last one, A's bytes past K (the next
// row's, or slack at the region's end) meet zero weights and add nothing.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace int8mma {

constexpr int kThreads = 256;                // the block: 8 warps
constexpr int kCols = 128;                   // W columns per stage
constexpr int kDepth = 32;                   // K bytes per mma
constexpr int kStageK = 128;                 // K bytes per stage
constexpr int kSlotRow = kStageK + 16;       // a column's bytes in a slot
constexpr int kSlotBytes = kCols * kSlotRow;
constexpr int kStageBytes = kCols * kStageK;  // one stage in device memory
constexpr int kMaxSlots = 8;                 // ring slots (7 stages in flight)
constexpr int kSlack = kStageK;              // bytes after an A region

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Row stride in shared memory of an A operand with k bytes per row, and
// the bytes of a region of `rows` such rows (with the slack that the last
// row's reads up to round_up(k, kStageK) may reach).
__host__ __device__ constexpr int a_stride(int k) { return round_up(k, kDepth) + 16; }
__host__ __device__ constexpr int a_region(int rows, int k) { return rows * a_stride(k) + kSlack; }

// K stages of a product over k bytes.
__host__ __device__ constexpr int k_stages(int k) { return round_up(k, kStageK) / kStageK; }

// Ring slots for `per_super` stages per super-tile when the kernel can
// spare `slots` (2..kMaxSlots): all of them when they fit (they then stay
// resident), else `slots`.
__host__ __device__ constexpr int ring_slots(int per_super, int slots) {
  return per_super <= slots ? per_super : slots;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// wait_group with a pending count known only at run time (0..6).
__device__ inline void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x32, row) . b (32x8, col), exact in int32.
template <bool kU8>
__device__ inline void mma_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (kU8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// The warps' layout over one super-tile of kRows rows x kCols columns:
// kWM warps down, 8 / kWM across; each warp owns kMW x kNW fragments of
// 16 x 8. <2, 2> covers 64 rows, <2, 1> 32 and <1, 1> 16.
template <int kMW, int kWM>
struct Layout {
  static constexpr int kWarpsN = 8 / kWM;
  static constexpr int kNW = kCols / 8 / kWarpsN;
  static constexpr int kRows = kMW * kWM * 16;
  static_assert(kNW % 2 == 0, "ldmatrix.x4 loads two 8-column fragments");
};

// f(row, col, value) for each sum a warp holds; row0/col0 are the warp's
// origin in the super-tile and chunk.
template <int kMW, int kNW, class F>
__device__ inline void for_each_sum(const int (&acc)[kMW][kNW][4], int row0, int col0, F&& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMW; ++i) {
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      const int r = row0 + i * 16 + g, c = col0 + j * 8 + 2 * t;
      f(r, c, acc[i][j][0]);
      f(r, c + 1, acc[i][j][1]);
      f(r + 8, c, acc[i][j][2]);
      f(r + 8, c + 1, acc[i][j][3]);
    }
  }
}

// for_each_sum with a per-column value: cv(col) is read for each of the
// thread's columns first (so that the stores of f do not hold back those
// reads), then f(row, col, value, cv(col)) for each sum.
template <int kMW, int kNW, class CV, class F>
__device__ inline void for_each_sum_col(const int (&acc)[kMW][kNW][4], int row0, int col0,
                                        CV&& cv, F&& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int v[kNW][2];
#pragma unroll
  for (int j = 0; j < kNW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) v[j][e] = cv(col0 + j * 8 + 2 * t + e);
#pragma unroll
  for (int i = 0; i < kMW; ++i)
#pragma unroll
    for (int j = 0; j < kNW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + i * 16 + g, c = col0 + j * 8 + 2 * t + e;
        f(r, c, acc[i][j][e], v[j][e]);
        f(r + 8, c, acc[i][j][2 + e], v[j][e]);
      }
}

// C's truncating v / 2^k (the engine's integer division by a power of two).
__device__ inline int tdiv_pow2(int v, int k) { return (v + ((v >> 31) & ((1 << k) - 1))) >> k; }

// One stage's copy: 256 threads, four 16-byte pieces each.
__device__ inline void load_stage(unsigned char* slot, const uint8_t* src) {
#pragma unroll
  for (int i = 0; i < kStageBytes / 16 / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;  // column p / 8, piece p % 8
    cp_async16(slot + (p >> 3) * kSlotRow + (p & 7) * 16, src + p * 16);
  }
}

// The chunks of 128 columns of W a product covers: first, first + step, ...
struct Chunks {
  int first, step, count;
};

// C = A . W^T over `n_super` super-tiles of A's rows and the chunks `ch`
// of 128 columns of W, with `k_steps` stages of K each (K = k_bytes; the
// zero padding past it is not multiplied, nor columns from n_cols on, which
// a warp skips when all of its columns lie there); W's chunks lie
// `chunk_steps` stages apart (>= k_steps). Chunk columns below `u8_cols`
// are multiplied as u8 x u8, the rest as s8 x s8 (a warp's columns lie on
// one side: u8_cols is 0, 64 or 128). After the last K stage of each
// (super-tile, chunk) every thread calls epi(super, chunk, acc, row0, col0),
// all threads together, so the epilogue may hold barriers. `before` runs
// once between issuing the first loads and the first wait: the A operand
// may be written then. The ring holds ring_slots(ch.count * k_steps,
// max_slots) slots. Every thread of the block calls this; it starts and
// ends with the ring free.
template <int kMW, int kWM, class Before, class Epi>
__device__ void stream_gemm(const int8_t* a, int lda, int n_super, const uint8_t* w,
                            Chunks ch, int k_bytes, int n_cols, int chunk_steps, int u8_cols,
                            unsigned char* ring, int max_slots, int rot, Before&& before,
                            Epi&& epi) {
  using L = Layout<kMW, kWM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / L::kWarpsN, wn = warp % L::kWarpsN;
  const int n_chunks = ch.count;
  const int k_steps = k_stages(k_bytes);
  const int per_super = n_chunks * k_steps;
  const int slots = ring_slots(per_super, max_slots);
  const bool resident = per_super <= max_slots;
  const int total = n_super * per_super;
  const int loads = resident ? per_super : total;
  const int c0 = rot % n_chunks, s0 = rot % k_steps;
  auto wrap = [](int v, int n) { return v + 1 == n ? 0 : v + 1; };

  // the stage to load next: local chunk lc, K stage ls (starting at c0, s0;
  // ln counts the chunk's stages), into slot lslot
  int lc = c0, ls = s0, ln = 0, lq = 0, lslot = 0;
  auto load_next = [&] {
    if (lq < loads) {
      load_stage(ring + lslot * kSlotBytes,
                 w + (static_cast<size_t>(ch.first + ch.step * lc) * chunk_steps + ls) *
                         kStageBytes);
      ls = wrap(ls, k_steps);
      if (++ln == k_steps) {
        ln = 0;
        lc = wrap(lc, n_chunks);
      }
      lslot = wrap(lslot, slots);
    }
    ++lq;
    cp_async_commit();
  };
  // resident: every stage now; streaming: all but one slot ahead
  for (int q = 0; q < (resident ? per_super : slots - 1); ++q) load_next();
  before();
  const bool u8 = wn * L::kNW * 8 < u8_cols;
  int acc[kMW][L::kNW][4];
#pragma unroll
  for (int i = 0; i < kMW; ++i)
#pragma unroll
    for (int j = 0; j < L::kNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the stage multiplied: super-tile st, local chunk ci, K stage si (cn
  // counts the chunk's stages), in slot cslot
  int st = 0, ci = c0, si = s0, cn = 0, cslot = 0;
  for (int q = 0; q < total; ++q) {
    if (!resident) cp_async_wait_upto(slots - 2);
    else if (q == 0) cp_async_wait<0>();
    __syncthreads();  // stage q landed for all; the slot of stage q - 1 is free
    if (!resident) load_next();

    const unsigned char* slot = ring + cslot * kSlotBytes;
    const int row0 = st * L::kRows + wm * kMW * 16;
    const int kbase = si * kStageK;
    const bool busy = (ch.first + ch.step * ci) * kCols + wn * L::kNW * 8 < n_cols;
#pragma unroll
    for (int kk = 0; kk < kStageK / kDepth; ++kk) {
      if (!busy || kbase + kk * kDepth >= k_bytes) break;
      uint32_t af[kMW][4];
#pragma unroll
      for (int i = 0; i < kMW; ++i)
        ldmatrix_x4(af[i], a + static_cast<size_t>(row0 + i * 16 + (lane & 15)) * lda + kbase +
                               kk * kDepth + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < L::kNW; j += 2) {
        uint32_t bf[4];
        const int n = (wn * L::kNW + j) * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bf, slot + n * kSlotRow + kk * kDepth + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < kMW; ++i) {
          if (u8) {
            mma_16832<true>(acc[i][j], af[i], bf[0], bf[1]);
            mma_16832<true>(acc[i][j + 1], af[i], bf[2], bf[3]);
          } else {
            mma_16832<false>(acc[i][j], af[i], bf[0], bf[1]);
            mma_16832<false>(acc[i][j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    si = wrap(si, k_steps);
    cslot = wrap(cslot, slots);
    if (++cn == k_steps) {
      cn = 0;
      epi(st, ch.first + ch.step * ci, acc, row0, wn * L::kNW * 8);
#pragma unroll
      for (int i = 0; i < kMW; ++i)
#pragma unroll
        for (int j = 0; j < L::kNW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
      ci = wrap(ci, n_chunks);
      if (ci == c0) ++st;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace int8mma
