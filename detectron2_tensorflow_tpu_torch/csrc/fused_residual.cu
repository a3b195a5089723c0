// The ResNet bottleneck tail, relu((x @ W^T) * scale + shift + shortcut), as
// one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas/fused_residual.py
// fused_conv1x1_bn_add_relu (kernel body _epilogue_kernel, launched by
// _launch). With the activations in channels_last memory a 1x1 stride-1 conv
// is a matrix product: x [M = B*H*W, K] row-major, the weight [N, K]
// row-major, the shortcut and the output [M, N] row-major. As the Pallas
// kernel does, the products are summed in float32, scale and shift (the
// folded FrozenBN affine) are float32 per output column, the shortcut is
// widened to float32, and the result is rounded once to the input dtype:
//     out[m, n] = relu((sum_k x[m, k] * w[n, k]) * scale[n] + shift[n] + sc[m, n])
// (the multiply and the two adds are rounded one by one, in that order, as
// the plain version computes them; no contraction into an FMA).
//
// What bounds it on the H100: bytes. At every R50 tail shape the kernel
// moves about 2*M*N + M*K elements (shortcut in, output out, x in) against
// 2*M*N*K operations: at 2 bytes an element that is at most ~205 operations
// a byte (res5), under the ~295 where bf16 tensor cores, not memory, become
// the limit. So the conv's result stays out of device memory (the unfused
// tail writes it and reads it back three times), the shortcut is read and
// the output written once, and the reads have to be in flight all the time.
//
// Three kernels; ops/fused_residual.py plan_tail picks one from the shape,
// dtype and alignment and hands the path and the persistent grid to the C
// entry:
//   * wgmma (bf16, K % 8 == 0, N % 8 == 0, 16-byte-aligned operands: every
//     R50 tail): persistent, warp-specialized. At most one block per SM
//     walks 64 x 256 output tiles, N fastest (neighbours share x rows in
//     L2). One producer thread keeps TMA loads in flight: x and W tiles of
//     64 along K (128 bytes, the 128-byte swizzle) into a ring of 4 stages
//     behind full/empty mbarriers, and, right behind a tile's first K stage,
//     the tile's shortcut (four 64 x 64 boxes) into one of two buffers, so
//     the shortcut's read runs under the product, not after it. Two
//     consumer warpgroups, 128 columns each, run wgmma m64n128k16 (float32
//     accumulators in registers; the weight [N, K] row-major is the K-major
//     B operand as it is). The epilogue works on the accumulator fragments:
//     scale and shift read once per tile, the shortcut read from shared
//     memory at the fragment's (swizzled) positions, tail() applied, bf16
//     written back in place, and TMA stores the tile (clipped at M and N)
//     while the next tile's loads run. A shortcut buffer is refilled once
//     the stores that read it are done. The two shortcut buffers (64 KB)
//     and the 4-stage ring (160 KB) fill the 227 KB a block may use; a
//     128 x 256 tile leaves room for 2 stages only, and measured slower.
//     With 64-row tiles the blocks' rounds, over all of them, are at least
//     99% full at every R50 tail at batch 2 and 8 (tiles / (rounds * grid);
//     res2 at batch 2: 2100 / 2112, its last round 120 of 132 blocks; res5
//     at batch 1: 136 tiles, 2 rounds):
//   stage batch       M     K     N   tile     tiles  grid rounds
//   res2      1   67200    64   256   64x256   1050   132      8
//   res2      2  134400    64   256   64x256   2100   132     16
//   res2      8  537600    64   256   64x256   8400   132     64
//   res3      1   16800   128   512   64x256    526   132      4
//   res3      2   33600   128   512   64x256   1050   132      8
//   res3      8  134400   128   512   64x256   4200   132     32
//   res4      1    4200   256  1024   64x256    264   132      2
//   res4      2    8400   256  1024   64x256    528   132      4
//   res4      8   33600   256  1024   64x256   2100   132     16
//   res5      1    1050   512  2048   64x256    136   132      2
//   res5      2    2100   512  2048   64x256    264   132      2
//   res5      8    8400   512  2048   64x256   1056   132      8
//     (res2's K is one stage: its overlap comes from persistence alone.)
//     What bounds it (chip_smoke.py's times, batch 8): at res2-res3 the
//     HBM bytes. At res4-res5 the operand tiles: each block reads its x and
//     W tiles from L2, (64 + 256) * K * 2 bytes a 64 x 256 output tile, the
//     same 344 MB at every stage at batch 8, against res5's 79.5 MB of HBM
//     bytes, so res5 runs at the L2's rate, not HBM's. 168 registers a
//     thread (setmaxnreg: 232 for the consumers, 40 for the producer), no
//     spills, 230,496 bytes of shared memory, one block per SM.
//   * mma (any other bf16): one block per 128 x 128 output tile, 8 warps as
//     2 (M) x 4 (N), each warp 64 x 32 with mma.sync m16n8k16 (bf16 in,
//     float32 accumulators). Tiles of 32 along K are staged in shared memory
//     by cp.async in two stages (16-byte copies, zero-filled past M, N and
//     K). The float32 tile goes through shared memory, then each thread
//     takes 16-byte chunks of output rows. Ragged M, N and K are masked; a K
//     or N that breaks 16-byte alignment takes element loads.
//   * ffma (float32): one block per 64 x 64 output tile, 256 threads, each
//     4 x 4 outputs by FFMA from shared-memory tiles of 16 along K (no
//     TF32), the same epilogue as mma.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float tail(float acc, float scale, float shift, float sc) {
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(acc, scale), shift), sc);
  return y < 0.f ? 0.f : y;  // NaN passes, as torch.relu and jnp.maximum do
}

// out[m0 + r, n0 + c] for the float32 tile cs [TBM][ldc] of accumulators.
// Each thread takes 16-byte chunks (8 bf16 or 4 float32) along a row.
template <typename T, int TBM, int TBN, int NT>
__device__ __forceinline__ void epilogue(const float* cs, int ldc, const T* __restrict__ shortcut,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift, T* __restrict__ out,
                                         int m0, int n0, int M, int N, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CHUNKS = TBN / V;
  for (int id = threadIdx.x; id < TBM * CHUNKS; id += NT) {
    const int r = id / CHUNKS;
    const int c = (id - r * CHUNKS) * V;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float* acc = cs + r * ldc + c;
    const size_t off = (size_t)gm * N + gn;
    if (vec && gn + V <= N) {
      const uint4 in = *reinterpret_cast<const uint4*>(shortcut + off);
      uint4 res;
      const T* ie = reinterpret_cast<const T*>(&in);
      T* re = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        re[j] = from_f32<T>(tail(acc[j], scale[gn + j], shift[gn + j], to_f32(ie[j])));
      }
      *reinterpret_cast<uint4*>(out + off) = res;
    } else {
      for (int j = 0; j < V && gn + j < N; ++j) {
        out[off + j] = from_f32<T>(tail(acc[j], scale[gn + j], shift[gn + j],
                                        to_f32(shortcut[off + j])));
      }
    }
  }
}

// ------------------------------------------------------ bf16, mma.sync --

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLds = kBK + 8;   // bf16 per staged row: 80 bytes, no bank conflicts on fragment loads
constexpr int kLdc = kBN + 4;   // float32 per row of the epilogue tile
constexpr int kThreadsMma = 256;
constexpr int kStageElems = (kBM + kBN) * kLds;
constexpr size_t kSmemMma =
    (2 * kStageElems * 2 > kBM * kLdc * 4) ? 2 * kStageElems * 2 : (size_t)kBM * kLdc * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Stage rows [r0, r0 + ROWS) x columns [k0, k0 + kBK) of the row-major
// [rows, K] matrix src into dst [ROWS][kLds], zero outside it.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                           int r0, int rows, int k0, int K) {
  constexpr int CH = kBK / 8;
  for (int id = threadIdx.x; id < ROWS * CH; id += kThreadsMma) {
    const int r = id / CH;
    const int c = (id - r * CH) * 8;
    const int gr = r0 + r;
    const int gk = k0 + c;
    __nv_bfloat16* d = dst + r * kLds + c;
    if (VEC) {
      const bool ok = gr < rows && gk < K;  // K % 8 == 0: a chunk is all in or all out
      cp_async16(d, ok ? src + (size_t)gr * K + gk : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[j] = (gr < rows && gk + j < K) ? src[(size_t)gr * K + gk + j] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreadsMma)
fused_epilogue_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          const __nv_bfloat16* __restrict__ shortcut, __nv_bfloat16* __restrict__ out,
                          int M, int K, int N, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int n0 = blockIdx.x * kBN;  // blocks along N first: neighbours share x rows in L2
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wm0 = (warp >> 2) * 64;
  const int wn0 = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + kBK - 1) / kBK;
  auto load = [&](int kt, int s) {
    __nv_bfloat16* a = stages + s * kStageElems;
    stage_tile<kBM, VEC>(a, x, m0, M, kt * kBK, K);
    stage_tile<kBN, VEC>(a + kBM * kLds, w, n0, N, kt * kBK, K);
  };
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest has landed: tile kt is in
    __syncthreads();
    const __nv_bfloat16* as = stages + (kt & 1) * kStageElems;
    const __nv_bfloat16* bs = as + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = as + (wm0 + i * 16 + grp) * kLds + kk + tig * 2;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * kLds);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * kLds + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = bs + (wn0 + j * 8 + grp) * kLds + kk + tig * 2;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]), "+f"(acc[i][j][3])
              : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                "r"(bf[j][0]), "r"(bf[j][1]));
        }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  float* cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm0 + i * 16 + grp;
      const int c = wn0 + j * 8 + tig * 2;
      *reinterpret_cast<float2*>(cs + r * kLdc + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * kLdc + c) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  epilogue<__nv_bfloat16, kBM, kBN, kThreadsMma>(cs, kLdc, shortcut, scale, shift, out, m0, n0,
                                                 M, N, vec_out);
}

// ------------------------------------------------------------- float32 --

constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;
constexpr int kThreadsF = 256;

__global__ void __launch_bounds__(kThreadsF)
fused_epilogue_ffma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ scale, const float* __restrict__ shift,
                           const float* __restrict__ shortcut, float* __restrict__ out,
                           int M, int K, int N, bool vec_out) {
  __shared__ __align__(16) float as[kFK][kFM + 4];  // k-major: a thread reads 4 rows as one float4
  __shared__ __align__(16) float bs[kFK][kFN + 4];
  __shared__ __align__(16) float cs[kFM][kFN + 4];
  const int n0 = blockIdx.x * kFN;
  const int m0 = blockIdx.y * kFM;
  const int tx = threadIdx.x & 15;  // output columns tx*4 .. tx*4+3
  const int ty = threadIdx.x >> 4;  // output rows ty*4 .. ty*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Loads: thread t stages row t / 4, columns (t % 4) * 4 .. + 3 of both tiles.
  const int lr = threadIdx.x >> 2;
  const int lk = (threadIdx.x & 3) * 4;
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + lk + j;
      const int gm = m0 + lr;
      const int gn = n0 + lr;
      as[lk + j][lr] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      bs[lk + j][lr] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&cs[ty * 4 + i][tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  epilogue<float, kFM, kFN, kThreadsF>(&cs[0][0], kFN + 4, shortcut, scale, shift, out, m0, n0,
                                       M, N, vec_out);
}

// ------------------------------------------------------- bf16, wgmma --

constexpr int kWgBM = 64;                       // output tile: 64 rows
constexpr int kWgBN = 256;                      // x 256 columns, 128 for each consumer warpgroup
constexpr int kWgWN = kWgBN / 2;
constexpr int kWgK = 64;                        // K per ring stage: one 128-byte swizzle row
constexpr int kWgStages = 4;                    // ring stages
constexpr int kBox = 64;                        // shortcut and output boxes: 64 x 64 bf16
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kWgThreads = 384;                 // consumer warpgroups 0-1, producer warpgroup 2
constexpr int kABytes = kWgBM * kWgK * 2;
constexpr int kStageBytes = kABytes + kWgBN * kWgK * 2;
constexpr int kScBytes = kWgBM * kWgBN * 2;
// 1024 bytes to align the swizzled tiles, two shortcut buffers, the ring, the barriers.
constexpr size_t kSmemWg = 1024 + 2 * kScBytes + kWgStages * kStageBytes + (2 * kWgStages + 4) * 8;
static_assert(kSmemWg <= 232448, "more shared memory than a block may use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// The box at (column c0, row c1) of `map` into shared memory, reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, const void* src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(smem_u32(src))
               : "memory");
}

// wgmma descriptor of a K-major tile that TMA wrote with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// field), layout 1 = 128-byte swizzle; the leading field is unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence, commit and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] * B[16 x 128]: A and B K-major in shared memory; scale_d 0
// overwrites d. Accumulator i of a thread holds row 16 * warp + lane / 4
// (+ 8 for i % 4 >= 2) and column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Output tile t (N fastest): rows from (t / tiles_n) * 64, columns from
// (t % tiles_n) * 256. Block b takes tiles b, b + gridDim.x, ... (the walk
// tests/test_torch_fused_residual.py models).
__global__ void __launch_bounds__(kWgThreads, 1)
fused_epilogue_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            const __grid_constant__ CUtensorMap tm_sc,
                            const __grid_constant__ CUtensorMap tm_out,
                            const float* __restrict__ scale, const float* __restrict__ shift,
                            int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sc_buf = smem;                   // 2 x 4 boxes of 64 x 64
  unsigned char* ring = smem + 2 * kScBytes;      // kWgStages x (x [64][64], w [256][64])
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kStageBytes);
  uint64_t* empty = full + kWgStages;
  uint64_t* sc_full = empty + kWgStages;
  uint64_t* sc_empty = sc_full + 2;

  const int tiles_n = (N + kWgBN - 1) / kWgBN;
  const int tiles = (M + kWgBM - 1) / kWgBM * tiles_n;
  const int ktiles = (K + kWgK - 1) / kWgK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sc_full[b], 1);
      mbar_init(&sc_empty[b], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread issues every load; the use u of a ring stage or
    // shortcut buffer waits for the release of use u - 1 (parity trick).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int t = blockIdx.x, j = 0; t < tiles; t += gridDim.x, ++j) {
      const int m0 = t / tiles_n * kWgBM;
      const int n0 = t % tiles_n * kWgBN;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kWgStages;
        mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
        unsigned char* a = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(a, &tm_x, kt * kWgK, m0, &full[s]);
        tma_load(a + kABytes, &tm_w, kt * kWgK, n0, &full[s]);
        if (kt == 0) {  // the shortcut right behind the first operands; boxes past N skipped
          const int b = j & 1;
          const int boxes = min(kWgBN, N - n0 + kBox - 1) / kBox;
          mbar_wait(&sc_empty[b], ((j >> 1) & 1) ^ 1);
          mbar_expect_tx(&sc_full[b], boxes * kBoxBytes);
          for (int cb = 0; cb < boxes; ++cb)
            tma_load(sc_buf + b * kScBytes + cb * kBoxBytes, &tm_sc, n0 + cb * kBox, m0,
                     &sc_full[b]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const bool leader = tid == 0;
    const int col0 = wg * kWgWN;  // this warpgroup's columns of the tile
    // Rows r and r + 8 of the tile; r & 7 == lane / 4 is the swizzle's XOR.
    const int r = warp * 16 + lane / 4;
    const int swz = lane / 4;
    float acc[kWgWN / 2];
#pragma unroll
    for (int i = 0; i < kWgWN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x, j = 0; t < tiles; t += gridDim.x, ++j) {
      const int m0 = t / tiles_n * kWgBM;
      const int n0 = t % tiles_n * kWgBN;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kWgStages;
        mbar_wait(&full[s], (it / kWgStages) & 1);
        const unsigned char* a = ring + s * kStageBytes;
        const unsigned char* bw = a + kABytes + col0 * 128;
        __syncwarp();  // the .aligned instructions need the warp converged
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kWgK / 16; ++kk)
          wgmma_k16(acc, sw128_desc(a + kk * 32), sw128_desc(bw + kk * 32), kt > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        if (kt > 0) {  // the previous stage's products are done: release it
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_acc(acc);
          if (leader) mbar_arrive(&empty[(it - 1) % kWgStages]);
        } else if (j > 0 && leader) {
          // The previous tile's stores have read their buffer: the tile
          // after this one may take its shortcut there.
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(&sc_empty[(j - 1) & 1]);
        }
      }
      __syncwarp();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (leader) mbar_arrive(&empty[(it - 1) % kWgStages]);

      const int b = j & 1;
      mbar_wait(&sc_full[b], (j >> 1) & 1);
      unsigned char* tile = sc_buf + b * kScBytes + r * 128;
#pragma unroll
      for (int jj = 0; jj < kWgWN / 8; ++jj) {
        const int c = col0 + jj * 8 + (lane % 4) * 2;
        const int gc = n0 + c;
        if (gc < N) {  // N % 8 == 0: a pair is all in or all out
          const float s0 = __ldg(scale + gc), s1 = __ldg(scale + gc + 1);
          const float h0 = __ldg(shift + gc), h1 = __ldg(shift + gc + 1);
          unsigned char* p =
              tile + (c / kBox) * kBoxBytes + ((((c % kBox) / 8) ^ swz) << 4) + (c % 8) * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p + h * 8 * 128);
            const float2 v = __bfloat1622float2(*q);
            *q = __floats2bfloat162_rn(tail(acc[jj * 4 + h * 2], s0, h0, v.x),
                                       tail(acc[jj * 4 + h * 2 + 1], s1, h1, v.y));
          }
        }
      }
      // The output is in shared memory: make it visible to TMA, then one
      // thread stores this warpgroup's two boxes (TMA clips them at M and N).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
      if (leader) {
        for (int cb = col0 / kBox; cb < (col0 + kWgWN) / kBox; ++cb)
          if (n0 + cb * kBox < N)
            tma_store(&tm_out, n0 + cb * kBox, m0, sc_buf + b * kScBytes + cb * kBoxBytes);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                        cudaSuccess &&
                    q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// TMA map of the row-major bf16 [rows, cols] matrix at `base`, in boxes of
// box_rows x 64 columns with the 128-byte swizzle; out of bounds reads zero.
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWgK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int launch_wgmma(const void* x, const void* w, const float* scale, const float* shift,
                 const void* shortcut, void* out, int m, int k, int n, int grid,
                 cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(  // once
      fused_epilogue_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemWg));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap mx, mw, msc, mout;
  if (!bf16_map(&mx, x, m, k, kWgBM) || !bf16_map(&mw, w, n, k, kWgBN) ||
      !bf16_map(&msc, shortcut, m, n, kBox) || !bf16_map(&mout, out, m, n, kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  fused_epilogue_wgmma_kernel<<<grid, kWgThreads, kSmemWg, st>>>(mx, mw, msc, mout, scale, shift,
                                                                 m, k, n);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x [m, k], w [n, k], shortcut and out [m, n], all row-major, bf16 for the
// paths wgmma (2) and mma (1), float32 for ffma (0); scale and shift float32
// [n]. `path` and `blocks` (the wgmma path's persistent grid) are
// ops/fused_residual.py plan_tail's; each kernel's tile and stages are the
// constants above, and the one-tile-a-block paths size their own grids.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// refuses).
extern "C" int fused_conv1x1_bn_add_relu_launch(const void* x, const void* w, const void* scale,
                                                const void* shift, const void* shortcut,
                                                void* out, int m, int k, int n, int path,
                                                int blocks, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  if (path == 2) {
    const bool tma = k % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(w) &&
                     aligned16(shortcut) && aligned16(out);
    if (!tma || blocks <= 0) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, w, sp, hp, shortcut, out, m, k, n, blocks, st);
  }
  if (path == 1) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const bool vec_in = k % 8 == 0 && aligned16(x) && aligned16(w);
    const bool vec_out = n % 8 == 0 && aligned16(shortcut) && aligned16(out);
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    const auto* cp = static_cast<const __nv_bfloat16*>(shortcut);
    auto* op = static_cast<__nv_bfloat16*>(out);
    auto kernel = vec_in ? fused_epilogue_mma_kernel<true> : fused_epilogue_mma_kernel<false>;
    static const cudaError_t attr[2] = {  // once per instantiation
        cudaFuncSetAttribute(fused_epilogue_mma_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMma),
        cudaFuncSetAttribute(fused_epilogue_mma_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMma)};
    if (attr[vec_in] != cudaSuccess) return (int)attr[vec_in];
    kernel<<<grid, kThreadsMma, kSmemMma, st>>>(xp, wp, sp, hp, cp, op, m, k, n, vec_out);
    return (int)cudaGetLastError();
  }
  if (path == 0) {
    const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const bool vec_out = n % 4 == 0 && aligned16(shortcut) && aligned16(out);
    fused_epilogue_ffma_kernel<<<grid, kThreadsF, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sp, hp,
        static_cast<const float*>(shortcut), static_cast<float*>(out), m, k, n, vec_out);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
