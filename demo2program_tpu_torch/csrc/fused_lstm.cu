// Fused LSTM step for NVIDIA Hopper (sm_90a) on the tensor cores.
//
// Replaces the Pallas TPU kernel demo2program_tpu/ops/pallas_lstm.py:
// _pallas_forward (body _kernel). Same semantics, gate order (i, f, g, o):
//
//     z  = [x, h] @ W + b                 accumulated in f32
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')          gate math in f32, stored in T
//
// x is (B, D), h and c are (B, H), W is (D+H, 4H), b is (4H,); all
// row-major, contiguous, of one element type T (float or bf16).
//
// What bounds it on an H100. The eval path runs three shapes with H = 512:
// B = 320 with K = D+H = 560 or 1024, and the program decoder's B = 32 with
// K = 1024; N = 4H = 2048 always. At B = 320, K = 1024 a step is 1.34 GFLOP
// (x3 for the f32 split below) against 8.4 MB of W in f32: the tensor
// cores and the L2 -> SM traffic of the A and W tiles (84 MB in f32 over
// the grid) bound it. At B = 32 it is 16 FLOP/byte: the read of W and the
// launch bound it, and only a grid that spreads W over every SM reads it
// fast.
//
// Design:
//   * Tensor cores through mma.sync (PTX), one mainloop for both types:
//       - bf16: mma.m16n8k16 bf16 x bf16 -> f32 (Pallas's
//         preferred_element_type=f32). Fragments come from shared memory by
//         ldmatrix; W's tile is stored k-major rows of N, so its fragments
//         use ldmatrix.trans.
//       - f32: mma.m16n8k8 tf32 with the 3xTF32 split. Each operand a is
//         split in registers into big = tf32(a) and small = a - big, and
//         the sum takes small*big + big*small + big*big in f32. One TF32
//         pass keeps ~3 decimal digits (~1e-3 absolute on z over K = 1024),
//         which would break the f32 tolerance of 1e-4; 3xTF32 keeps ~f32
//         accuracy. The tensor cores round their running sum toward zero,
//         so each K tile is summed into a fresh f32 partial that is then
//         added to the block's accumulator with an ordinary
//         round-to-nearest add (every 32 values of K for f32).
//     wgmma is not used: TF32 wgmma reads B from shared memory K-major
//     only, W is stored N-major, and the split needs B in registers. bf16
//     wgmma would take W as it is, and B = 320 is 5 x 64 rows, but B = 32
//     fills half a 64-row wgmma tile; one mma.sync mainloop serves both
//     types and both batch sizes.
//   * cp.async 16-byte copies into a ring of STAGES = 4 shared-memory
//     stages, so the copies of tile k+3 run under the MMAs of tile k.
//     Rows are padded by 16-32 bytes so that every fragment load, plain
//     or ldmatrix, is free of bank conflicts. Shapes whose rows are not
//     16-byte aligned (D or H not a multiple of 4 in f32, 8 in bf16) take
//     an edge instance that fills the same ring with plain loads.
//   * Gate-interleaved N tile: a block owns BNH = 16 hidden columns j and
//     takes columns g*H + j of all four gates, so its 64-column tile holds
//     z_i, z_f, z_g, z_o of the same j. Each warp's four n8 MMA tiles are
//     the four gates of the same 8 columns, so one thread's accumulators
//     hold all four gates of the same (row, j). z never reaches device
//     memory.
//   * No concat: the K loop walks the x tiles (k < D) and then the h tiles,
//     each part zero-filled at its own end, so no tile straddles k = D.
//   * Split-K across a thread block cluster, always: the blocks of a
//     cluster of (1, 1, SPLIT) share one output tile and take consecutive
//     shares of its K tiles. Each leaves its partial z tile in its own
//     shared memory; after a cluster barrier each block reads all SPLIT
//     partials through distributed shared memory, adds them in rank order
//     and runs the gate epilogue on 1/SPLIT of the tile. One launch, no
//     workspace, no atomics: deterministic. Two variants, chosen from the
//     shape in the entry point (compile-time instances, no flag):
//       - wide: BM = 64 rows, clusters of 2: 32 x 5 x 2 = 320 blocks of
//         128 threads at B = 320, H = 512, up to 3 on an SM. With the whole
//         K in each of 160 blocks, 28 SMs ran two blocks and the rest one;
//         the split evens that out (f32 52.7 -> 40.3 us, bf16 22.1 -> 18.6
//         us at B = 320, D = 512 on an H100). Blocks of 32 hidden columns
//         (8 warps, 63 instead of 84 MB of tile traffic) fit one block on
//         an SM and were slower.
//       - narrow, when the wide grid has fewer blocks than the card has
//         SMs (the program decoder's B = 32 would have 64): BM = 32,
//         clusters of 4: 32 x 1 x 4 = 128 blocks at B = 32.
//   * Every ragged edge (B, D, H) is masked in the kernel.
//
// Each C entry point launches on the given stream, writes the launch
// configuration it took to plan_out (unless null) and returns the CUDA
// error of the launch (0 on success); it never synchronises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;     // 4 warps: 2 along rows x 2 along columns
constexpr int BNH = 16;          // hidden columns per block
constexpr int BN = 4 * BNH;      // columns of z per block, gate-interleaved
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int ROW_BYTES = 128;   // one K tile of one row: 32 f32 or 64 bf16
constexpr int MAX_DEVICES = 64;

// The two variants: rows per block, blocks per cluster along K.
constexpr int WIDE_BM = 64, WIDE_SPLIT = 2;
constexpr int NARROW_BM = 32, NARROW_SPLIT = 4;

// Tile geometry of one instance. A warp owns BM / 2 rows and 8 hidden
// columns of all four gates.
template <typename T, int BM_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int MT = BM / 32;                  // m16 tiles per warp
  static constexpr int CHUNK = 16 / sizeof(T);        // elements per cp.async
  static constexpr int BK = ROW_BYTES / sizeof(T);    // K depth of a tile
  static constexpr int A_LD = BK + CHUNK;             // +16 B of padding
  static constexpr int W_LD = BN + 8;                 // +32 B f32, +16 B bf16
  static constexpr int RED_LD = BN + 4;               // partial z rows (f32)
  static constexpr int STAGE = BM * A_LD + BK * W_LD;  // elements
  static constexpr int SMEM_BYTES = STAGES * STAGE * static_cast<int>(sizeof(T));
  static_assert(BM % 32 == 0, "whole warp tiles");
  static_assert(BM * RED_LD * sizeof(float) <= SMEM_BYTES,
                "the partial z tile must fit in the ring");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float load_or_zero(const float* p, bool ok) {
  return ok ? *p : 0.0f;
}
__device__ __forceinline__ __nv_bfloat16 load_or_zero(const __nv_bfloat16* p,
                                                      bool ok) {
  return ok ? *p : __float2bfloat16(0.0f);
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a = big + small for 3xTF32. big is a rounded to the nearest tf32 (10
// mantissa bits) by integer ops; small = a - big is exact in f32, and the
// tensor core reads its top 10 mantissa bits. cvt.rna.tf32.f32 rounds as
// well, but it runs on the slower conversion pipe (two per operand cost
// the f32 step 21% at B = 320, D = 512 on an H100).
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// One K tile of MMAs for this warp: acc[mi][gate] (16 x 8 each) over the
// warp's MT m16 row tiles and the four gates of its 8 hidden columns.
// a_s: the block's BM rows (A_LD), w_s: BK rows of BN columns (W_LD);
// m0, n0: the warp's first row and hidden column.
template <typename L, typename T>
__device__ __forceinline__ void mma_tile(const T* a_s, const T* w_s, int m0,
                                         int n0, int lane,
                                         float (&acc)[L::MT][4][4]) {
  constexpr int MT = L::MT, A_LD = L::A_LD, W_LD = L::W_LD;
  if constexpr (std::is_same_v<T, float>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 8) {
      uint32_t a_big[MT][4], a_small[MT][4], b_big[4][2], b_small[4][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* p = a_s + (m0 + mi * 16 + g) * A_LD + kk + t;
        split_tf32(p[0], a_big[mi][0], a_small[mi][0]);
        split_tf32(p[8 * A_LD], a_big[mi][1], a_small[mi][1]);
        split_tf32(p[4], a_big[mi][2], a_small[mi][2]);
        split_tf32(p[8 * A_LD + 4], a_big[mi][3], a_small[mi][3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* p = w_s + (kk + t) * W_LD + q * BNH + n0 + g;
        split_tf32(p[0], b_big[q][0], b_small[q][0]);
        split_tf32(p[4 * W_LD], b_big[q][1], b_small[q][1]);
      }
      // the small terms first, into independent accumulators per (mi, q)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_tf32(acc[mi][q], a_small[mi], b_big[q]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_tf32(acc[mi][q], a_big[mi], b_small[q]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(acc[mi][q], a_big[mi], b_big[q]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      uint32_t a[MT][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], a_s + (m0 + mi * 16 + (lane & 15)) * A_LD + kk +
                               (lane >> 4) * 8);
      // matrices (k 0-7, gate q), (k 8-15, q), (k 0-7, q+1), (k 8-15, q+1)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, w_s + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                       W_LD +
                                 (q + (lane >> 4)) * BNH + n0);
        b[q][0] = r[0];
        b[q][1] = r[1];
        b[q + 1][0] = r[2];
        b[q + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_bf16(acc[mi][q], a[mi], b[q]);
    }
  }
}

// Fill one ring stage with K tile `tile`: x tiles first, then h tiles.
// VEC: 16-byte cp.async (rows 16-byte aligned); else plain loads.
template <typename L, bool VEC, typename T>
__device__ __forceinline__ void load_tile(T* a_s, T* w_s, const T* x,
                                          const T* h, const T* w, int tile,
                                          int nx, int r0, int j0, int B, int D,
                                          int H) {
  constexpr int BM = L::BM, BK = L::BK;
  const bool in_x = tile < nx;
  const T* src = in_x ? x : h;
  const int ld = in_x ? D : H;                     // row stride and K extent
  const int k0 = (in_x ? tile : tile - nx) * BK;
  const int wrow = (in_x ? 0 : D) + k0;
  const size_t ldw = 4 * static_cast<size_t>(H);
  if constexpr (VEC) {
    constexpr int A_CHUNKS = ROW_BYTES / 16;
    constexpr int W_CHUNKS = BN / L::CHUNK;
    for (int i = threadIdx.x; i < BM * A_CHUNKS; i += THREADS) {
      const int rr = i / A_CHUNKS, k = (i % A_CHUNKS) * L::CHUNK;
      const bool ok = r0 + rr < B && k0 + k < ld;
      cp_async16(a_s + rr * L::A_LD + k,
                 ok ? src + static_cast<size_t>(r0 + rr) * ld + k0 + k : src,
                 ok);
    }
    for (int i = threadIdx.x; i < BK * W_CHUNKS; i += THREADS) {
      const int kk = i / W_CHUNKS, n = (i % W_CHUNKS) * L::CHUNK;
      const int gate = n / BNH, j = j0 + n % BNH;
      const bool ok = k0 + kk < ld && j < H;
      cp_async16(w_s + kk * L::W_LD + n,
                 ok ? w + static_cast<size_t>(wrow + kk) * ldw +
                          static_cast<size_t>(gate) * H + j
                    : w,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int rr = i / BK, k = i % BK;
      const bool ok = r0 + rr < B && k0 + k < ld;
      a_s[rr * L::A_LD + k] = load_or_zero(
          src + (ok ? static_cast<size_t>(r0 + rr) * ld + k0 + k : 0), ok);
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN;
      const int gate = n / BNH, j = j0 + n % BNH;
      const bool ok = k0 + kk < ld && j < H;
      w_s[kk * L::W_LD + n] = load_or_zero(
          w + (ok ? static_cast<size_t>(wrow + kk) * ldw +
                        static_cast<size_t>(gate) * H + j
                  : 0),
          ok);
    }
  }
}

template <typename T>
__device__ __forceinline__ void lstm_gates(const float (&z)[4], const T* c,
                                           T* h_out, T* c_out, size_t off) {
  const float c_new =
      sigmoid_f32(z[1]) * to_f32(c[off]) + sigmoid_f32(z[0]) * tanhf(z[2]);
  const float h_new = sigmoid_f32(z[3]) * tanhf(c_new);
  store_f32(c_out + off, c_new);
  store_f32(h_out + off, h_new);
}

// grid (ceil(H / BNH), ceil(B / BM), SPLIT) in clusters of (1, 1, SPLIT)
// blocks, one per share of the K tiles.
template <typename T, int BM, int SPLIT, bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_lstm_step_kernel(const T* __restrict__ x, const T* __restrict__ h,
                       const T* __restrict__ c, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ h_out,
                       T* __restrict__ c_out, int B, int D, int H) {
  using L = Tile<T, BM>;
  constexpr int MT = L::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * (BM / 2);   // warp's first row in the tile
  const int n0 = (warp >> 1) * 8;         // warp's first hidden column
  const int j0 = blockIdx.x * BNH;
  const int r0 = blockIdx.y * BM;

  const int nx = (D + L::BK - 1) / L::BK;
  const int n_tiles = nx + (H + L::BK - 1) / L::BK;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t_begin = rank * n_tiles / SPLIT;
  const int count = (rank + 1) * n_tiles / SPLIT - t_begin;

  auto stage_a = [&](int s) { return ring + s * L::STAGE; };
  auto stage_w = [&](int s) { return ring + s * L::STAGE + BM * L::A_LD; };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count)
      load_tile<L, VEC>(stage_a(s), stage_w(s), x, h, w, t_begin + s, nx, r0,
                        j0, B, D, H);
    cp_async_commit();
  }

  float acc[MT][4][4] = {};
  for (int i = 0; i < count; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile i landed; every warp is done with tile i-1
    const int next = i + STAGES - 1;
    if (next < count)
      load_tile<L, VEC>(stage_a(next % STAGES), stage_w(next % STAGES), x, h,
                        w, t_begin + next, nx, r0, j0, B, D, H);
    cp_async_commit();
    float part[MT][4][4] = {};
    mma_tile<L>(stage_a(i % STAGES), stage_w(i % STAGES), m0, n0, lane, part);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][q][e] += part[mi][q][e];
  }

  // The cluster's partial z tiles meet in distributed shared memory.
  // Accumulator element e of tile (mi, q) is row g + 8 * (e / 2), column
  // 2t + e % 2 of the warp's 16 x 8 tile, the same for all four gates.
  const int g = lane >> 2, t = lane & 3;
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it now holds this block's partial z
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(m0 + mi * 16 + g + 8 * (e >> 1)) * L::RED_LD + q * BNH + n0 +
            2 * t + (e & 1)] = acc[mi][q][e];
  cluster.sync();
  const float* parts[SPLIT];
#pragma unroll
  for (int s = 0; s < SPLIT; ++s) parts[s] = cluster.map_shared_rank(red, s);
  for (int p = rank * THREADS + threadIdx.x; p < BM * BNH;
       p += SPLIT * THREADS) {
    const int rr = p / BNH, jj = p % BNH;
    const int row = r0 + rr, j = j0 + jj;
    if (row >= B || j >= H) continue;
    float z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < SPLIT; ++s)
        sum += parts[s][rr * L::RED_LD + q * BNH + jj];
      z[q] = sum + to_f32(b[q * H + j]);
    }
    lstm_gates(z, c, h_out, c_out, static_cast<size_t>(row) * H + j);
  }
  cluster.sync();   // no block leaves while another still reads its tile
}

// A launch configuration: grid (ceil(H / BNH), ceil(B / BM), split) in
// clusters of (1, 1, split). split names the variant: WIDE_SPLIT or
// NARROW_SPLIT.
struct Plan {
  dim3 grid;
  int split;       // blocks per cluster along K
  int smem_bytes;
  bool vec;        // 16-byte cp.async copies (else the edge instance)
};

template <typename T, int BM, int SPLIT>
Plan variant_plan(int B, int H, bool vec) {
  return {dim3((H + BNH - 1) / BNH, (B + BM - 1) / BM, SPLIT), SPLIT,
          Tile<T, BM>::SMEM_BYTES, vec};
}

// The wide variant, unless its grid has fewer blocks than the card has SMs:
// then the narrow split-K one. aligned: x, h and W start 16-byte aligned.
template <typename T>
Plan make_plan(int B, int D, int H, int sms, bool aligned) {
  constexpr int chunk = 16 / sizeof(T);
  const bool vec = aligned && D % chunk == 0 && H % chunk == 0;
  const Plan wide = variant_plan<T, WIDE_BM, WIDE_SPLIT>(B, H, vec);
  if (static_cast<long long>(wide.grid.x) * wide.grid.y * wide.grid.z >= sms)
    return wide;
  return variant_plan<T, NARROW_BM, NARROW_SPLIT>(B, H, vec);
}

template <typename T, int BM, int SPLIT, bool VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fused_lstm_step_kernel<T, BM, SPLIT, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<T, BM>::SMEM_BYTES);
}

template <typename T>
cudaError_t allow_smem_all() {
  cudaError_t errs[] = {allow_smem<T, WIDE_BM, WIDE_SPLIT, true>(),
                        allow_smem<T, WIDE_BM, WIDE_SPLIT, false>(),
                        allow_smem<T, NARROW_BM, NARROW_SPLIT, true>(),
                        allow_smem<T, NARROW_BM, NARROW_SPLIT, false>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// Per device, once: the SM count, and the dynamic shared memory every
// instance needs (above the 48 KB default).
struct DeviceInfo {
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

cudaError_t device_info(DeviceInfo* out) {
  static std::once_flag once[MAX_DEVICES];
  static DeviceInfo info[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    DeviceInfo& d = info[dev];
    d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (d.err == cudaSuccess) d.err = allow_smem_all<float>();
    if (d.err == cudaSuccess) d.err = allow_smem_all<__nv_bfloat16>();
  });
  *out = info[dev];
  return out->err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int BM, int SPLIT, bool VEC>
cudaError_t launch_instance(const Plan& plan, const void* x, const void* h,
                            const void* c, const void* w, const void* b,
                            void* h_out, void* c_out, int B, int D, int H,
                            cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = plan.grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = plan.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = SPLIT;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, fused_lstm_step_kernel<T, BM, SPLIT, VEC>,
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(h_out), static_cast<T*>(c_out),
      B, D, H);
}

template <typename T, int BM, int SPLIT>
cudaError_t launch_variant(const Plan& plan, const void* x, const void* h,
                           const void* c, const void* w, const void* b,
                           void* h_out, void* c_out, int B, int D, int H,
                           cudaStream_t stream) {
  return plan.vec ? launch_instance<T, BM, SPLIT, true>(
                        plan, x, h, c, w, b, h_out, c_out, B, D, H, stream)
                  : launch_instance<T, BM, SPLIT, false>(
                        plan, x, h, c, w, b, h_out, c_out, B, D, H, stream);
}

// plan_out, unless null, receives the launch configuration taken: {grid x,
// grid y, grid z, blocks per cluster, threads per block, dynamic shared
// memory bytes, 16-byte copies (1) or the edge instance (0)}.
template <typename T>
int launch(const void* x, const void* h, const void* c, const void* w,
           const void* b, void* h_out, void* c_out, int B, int D, int H,
           void* stream_ptr, int* plan_out) {
  if (B <= 0 || D < 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned =
      (D == 0 || aligned16(x)) && aligned16(h) && aligned16(w);
  const Plan plan = make_plan<T>(B, D, H, info.sms, aligned);
  if (plan_out != nullptr) {
    const int vals[] = {static_cast<int>(plan.grid.x),
                        static_cast<int>(plan.grid.y),
                        static_cast<int>(plan.grid.z), plan.split, THREADS,
                        plan.smem_bytes, plan.vec ? 1 : 0};
    for (int i = 0; i < 7; ++i) plan_out[i] = vals[i];
  }
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  err = plan.split == WIDE_SPLIT
            ? launch_variant<T, WIDE_BM, WIDE_SPLIT>(plan, x, h, c, w, b, h_out,
                                                     c_out, B, D, H, stream)
            : launch_variant<T, NARROW_BM, NARROW_SPLIT>(
                  plan, x, h, c, w, b, h_out, c_out, B, D, H, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" int d2p_fused_lstm_step_f32(const void* x, const void* h,
                                       const void* c, const void* w,
                                       const void* b, void* h_out,
                                       void* c_out, int B, int D, int H,
                                       void* stream, int* plan_out) {
  return launch<float>(x, h, c, w, b, h_out, c_out, B, D, H, stream,
                       plan_out);
}

extern "C" int d2p_fused_lstm_step_bf16(const void* x, const void* h,
                                        const void* c, const void* w,
                                        const void* b, void* h_out,
                                        void* c_out, int B, int D, int H,
                                        void* stream, int* plan_out) {
  return launch<__nv_bfloat16>(x, h, c, w, b, h_out, c_out, B, D, H, stream,
                               plan_out);
}
