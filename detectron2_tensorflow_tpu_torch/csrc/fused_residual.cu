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
// 2*M*N*K operations, K/2 operations per element at most 256 here: at 2 bytes
// an element that is far below the 295 operations per byte where bf16 tensor
// cores, not memory, become the limit. So the design keeps the conv's result
// out of device memory (the unfused tail writes it and reads it back three
// times) and reads the shortcut and writes the output once, coalesced.
//
// Design (simple first; wgmma/TMA are later work):
//   * bf16: one block per 128 x 128 output tile, 8 warps as 2 (M) x 4 (N),
//     each warp 64 x 32 with mma.sync m16n8k16 (bf16 in, float32
//     accumulators). Tiles of 32 along K are staged in shared memory by
//     cp.async in two stages (16-byte copies, zero-filled past M, N and K).
//     The weight [N, K] row-major is exactly the "col" B operand of
//     mma.sync: no transpose.
//   * float32: one block per 64 x 64 output tile, 256 threads, each 4 x 4
//     outputs by FFMA from shared-memory tiles of 16 along K (no TF32).
//   * Epilogue (both): the float32 tile goes through shared memory, then each
//     thread takes 16-byte chunks of output rows: the shortcut is read along
//     N (contiguous: channels_last) and the output written the same way.
//   * Ragged M, N and K are masked; a K or N that breaks 16-byte alignment
//     takes element loads instead of vector ones.

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

// ---------------------------------------------------------------- bf16 --

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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x [m, k], w [n, k], shortcut and out [m, n], all row-major in one dtype
// (0: float32, 1: bfloat16); scale and shift float32 [n]. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
extern "C" int fused_conv1x1_bn_add_relu_launch(const void* x, const void* w, const void* scale,
                                                const void* shift, const void* shortcut,
                                                void* out, int m, int k, int n, int dtype,
                                                void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  if (dtype == 1) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const bool vec_in = k % 8 == 0 && aligned16(x) && aligned16(w);
    const bool vec_out = n % 8 == 0 && aligned16(shortcut) && aligned16(out);
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    const auto* cp = static_cast<const __nv_bfloat16*>(shortcut);
    auto* op = static_cast<__nv_bfloat16*>(out);
    auto kernel = vec_in ? fused_epilogue_mma_kernel<true> : fused_epilogue_mma_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemMma);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreadsMma, kSmemMma, st>>>(xp, wp, sp, hp, cp, op, m, k, n, vec_out);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
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
