// ROIAlign forward and backward on a row-concatenated pyramid plane, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas/roi_patch.py
// roi_patch_interpolate (kernel body _make_kernel). For ROI n of image b it
// reads the [P, P, C] patch at (row, tx) of the NHWC plane [B, Htot, Wm, C]
// and computes
//     out[b, n, o, u, c] = sum_p sum_q wy[b,n,o,p] * wx[b,n,u,q] * plane[b, row+p, tx+q, c]
// as the Pallas kernel does: wy rounded to the plane's dtype, both
// contractions accumulated in float32, the float32 intermediate
// a = Wy . patch kept in shared memory, and the result rounded once to the
// plane's dtype. Slots whose tier class (starts[..., 2]) is the skip
// sentinel (>= n_classes) issue no loads and write exact zeros.
//
// What bounds it on the H100: reading patches. A [32, 32, 256] bf16 patch is
// 512 KB, more than the 227 KB of shared memory a block may hold (the TPU
// kernel keeps it whole in VMEM), so the work is tiled over channels: one
// block per (ROI, 32-channel tile, image), 256 threads. Lane l of each warp
// owns channel l of the tile, so every patch load is a 64-byte coalesced
// row segment, and each of the 8 warps walks every eighth patch column q,
// accumulating a[o, q, c] for all o in registers; the a tile ([S, P, 32]
// f32, 57 KB at S = 14) then goes through shared memory to the second
// contraction over q. Products are dense (no skipping of zero hat weights):
// the simple design reads every patch element once per block.
//
// The backward (roi_patch_bwd_kernel, below) replaces the TPU kernel
// ops/pallas/roi_patch.py roi_patch_backward (body _make_bwd_kernel). Per
// ROI it forms
//     gp[p, q, c] = sum_o sum_u wy[o, p] * g[o, u, c] * wx[u, q]
// in float32 (g widened exactly, wy and wx unrounded, as the Pallas kernel
// does) and adds it into a float32 plane [B, Htot, Wm, C] at (row+p, tx+q).
// The TPU kernel serializes that read-modify-write on a sequential grid
// (region sort, round-robin groups, a hazard flag, tier-narrowed DMA
// windows); none of that carries over. Here blocks run in parallel and
// overlapping ROIs meet in float32 atomicAdd, chosen over a sorted
// segmented reduction because it is simple and needs no scratch: the price
// is a summation order that changes from run to run (the plain version
// agrees to float32 rounding of the sums, not bit for bit).
// Design: one block per (ROI, 32-channel tile, image), 256 threads, lane l
// owning channel l. The g tile [S, S, 32] is widened into shared memory;
// each warp takes patch rows p, forms t[u] = sum_o wy[o, p] g[o, u, c] in
// registers, then for every column q adds sum_u t[u] wx[u, q] with one
// coalesced 128-byte atomic per warp. Exact-zero products (cells outside
// the ROI's hat support) are not added: adding +0 changes no sum.
// What bounds it on the H100: the atomics into device memory (P*P*C per
// ROI), then the P*P*S FMAs per channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCT = 32;       // channels per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kCT * kWarps;
constexpr int kMaxS = 16;
constexpr int kMaxP = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_patch_fwd_kernel(const T* __restrict__ plane, const int* __restrict__ starts,
                     const float* __restrict__ wy, const float* __restrict__ wx,
                     T* __restrict__ out, int n, int htot, int wm, int c,
                     int p, int s, int n_classes) {
  extern __shared__ float smem[];
  float* wy_s = smem;                 // [S, P], rounded to T
  float* wx_s = wy_s + s * p;         // [S, P]
  float* a_s = wx_s + s * p;          // [S, P, kCT]

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * kCT;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = c0 + lane;
  const bool ch_ok = ch < c;

  const size_t slot = (size_t)b * n + roi;
  const int row = starts[slot * 3 + 0];
  const int tx = starts[slot * 3 + 1];
  const int cls = starts[slot * 3 + 2];
  T* o_ptr = out + slot * s * s * c;

  if (cls >= n_classes) {  // skip sentinel: no loads, exact zeros
    for (int i = warp; i < s * s; i += kWarps) {
      if (ch_ok) o_ptr[(size_t)i * c + ch] = from_f32<T>(0.f);
    }
    return;
  }

  const float* wy_g = wy + slot * s * p;
  const float* wx_g = wx + slot * s * p;
  for (int i = threadIdx.x; i < s * p; i += kThreads) {
    wy_s[i] = to_f32(from_f32<T>(wy_g[i]));
    wx_s[i] = wx_g[i];
  }
  __syncthreads();

  // a[o, q, c] = sum_p wy[o, p] * patch[p, q, c]
  const T* base = plane + (size_t)b * htot * wm * c;
  for (int q = warp; q < p; q += kWarps) {
    float acc[kMaxS];
#pragma unroll
    for (int o = 0; o < kMaxS; ++o) acc[o] = 0.f;
    const int col = tx + q;
    const bool col_ok = col >= 0 && col < wm;
    for (int pp = 0; pp < p; ++pp) {
      const int r = row + pp;
      float v = 0.f;
      if (ch_ok && col_ok && r >= 0 && r < htot) {
        v = to_f32(base[((size_t)r * wm + col) * c + ch]);
      }
#pragma unroll
      for (int o = 0; o < kMaxS; ++o) {
        if (o < s) acc[o] += wy_s[o * p + pp] * v;
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxS; ++o) {
      if (o < s) a_s[(o * p + q) * kCT + lane] = acc[o];
    }
  }
  __syncthreads();

  // out[o, u, c] = sum_q wx[u, q] * a[o, q, c]
  for (int i = warp; i < s * s; i += kWarps) {
    const int o = i / s;
    const int u = i - o * s;
    float acc = 0.f;
    for (int q = 0; q < p; ++q) acc += wx_s[u * p + q] * a_s[(o * p + q) * kCT + lane];
    if (ch_ok) o_ptr[(size_t)i * c + ch] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* plane, const int* starts, const float* wy, const float* wx,
           void* out, int batch, int n, int htot, int wm, int c, int p, int s,
           int n_classes, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * s * p + s * p * kCT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      roi_patch_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n, (c + kCT - 1) / kCT, batch);
  roi_patch_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(plane), starts, wy, wx, static_cast<T*>(out), n,
      htot, wm, c, p, s, n_classes);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_patch_bwd_kernel(const T* __restrict__ g, const int* __restrict__ starts,
                     const float* __restrict__ wy, const float* __restrict__ wx,
                     float* __restrict__ acc, int n, int htot, int wm, int c,
                     int p, int s, int n_classes) {
  extern __shared__ float smem[];
  float* wy_s = smem;                 // [S, P]
  float* wx_s = wy_s + s * p;         // [S, P]
  float* g_s = wx_s + s * p;          // [S, S, kCT]

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * kCT;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = c0 + lane;
  const bool ch_ok = ch < c;

  const size_t slot = (size_t)b * n + roi;
  const int row = starts[slot * 3 + 0];
  const int tx = starts[slot * 3 + 1];
  const int cls = starts[slot * 3 + 2];
  if (cls >= n_classes) return;  // skip sentinel: no loads, no adds

  const float* wy_g = wy + slot * s * p;
  const float* wx_g = wx + slot * s * p;
  for (int i = threadIdx.x; i < s * p; i += kThreads) {
    wy_s[i] = wy_g[i];
    wx_s[i] = wx_g[i];
  }
  const T* g_g = g + slot * s * s * c;
  for (int i = warp; i < s * s; i += kWarps) {
    g_s[i * kCT + lane] = ch_ok ? to_f32(g_g[(size_t)i * c + ch]) : 0.f;
  }
  __syncthreads();
  if (!ch_ok) return;

  float* base = acc + (size_t)b * htot * wm * c;
  for (int pp = warp; pp < p; pp += kWarps) {
    const int r = row + pp;
    if (r < 0 || r >= htot) continue;
    // t[u] = sum_o wy[o, pp] * g[o, u, c]
    float t[kMaxS];
#pragma unroll
    for (int u = 0; u < kMaxS; ++u) t[u] = 0.f;
    for (int o = 0; o < s; ++o) {
      const float w = wy_s[o * p + pp];
#pragma unroll
      for (int u = 0; u < kMaxS; ++u) {
        if (u < s) t[u] += w * g_s[(o * s + u) * kCT + lane];
      }
    }
    float* row_ptr = base + (size_t)r * wm * c;
    for (int q = 0; q < p; ++q) {
      const int col = tx + q;
      if (col < 0 || col >= wm) continue;
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxS; ++u) {
        if (u < s) v += t[u] * wx_s[u * p + q];
      }
      if (v != 0.f) atomicAdd(row_ptr + (size_t)col * c + ch, v);
    }
  }
}

template <typename T>
int launch_bwd(const void* g, const int* starts, const float* wy, const float* wx,
               float* acc, int batch, int n, int htot, int wm, int c, int p, int s,
               int n_classes, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * s * p + s * s * kCT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      roi_patch_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n, (c + kCT - 1) / kCT, batch);
  roi_patch_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), starts, wy, wx, acc, n, htot, wm, c, p, s, n_classes);
  return (int)cudaGetLastError();
}

}  // namespace

// g [batch, n, s, s, c] (dtype 0: float32, 1: bfloat16), starts [batch, n, 3]
// int32, wy/wx [batch, n, s, p] float32; adds every ROI's patch gradient into
// the float32 plane acc [batch, htot, wm, c], which the caller zeroes or
// passes in holding earlier sums. Returns cudaGetLastError().
extern "C" int roi_patch_bwd_launch(const void* g, const void* starts,
                                    const void* wy, const void* wx, void* acc,
                                    int batch, int n, int htot, int wm, int c,
                                    int p, int s, int n_classes, int dtype,
                                    void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return (int)cudaGetLastError();
  if (s > kMaxS || p > kMaxP || batch > 65535 || (c + kCT - 1) / kCT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  const float* wyp = static_cast<const float*>(wy);
  const float* wxp = static_cast<const float*>(wx);
  float* ap = static_cast<float*>(acc);
  if (dtype == 0) {
    return launch_bwd<float>(g, sp, wyp, wxp, ap, batch, n, htot, wm, c, p, s, n_classes, st);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(g, sp, wyp, wxp, ap, batch, n, htot, wm, c, p, s,
                                     n_classes, st);
  }
  return (int)cudaErrorInvalidValue;
}

// plane [batch, htot, wm, c] (dtype 0: float32, 1: bfloat16), starts
// [batch, n, 3] int32 (row, tx, tier class), wy/wx [batch, n, s, p] float32,
// out [batch, n, s, s, c] in the plane's dtype. Returns cudaGetLastError().
extern "C" int roi_patch_fwd_launch(const void* plane, const void* starts,
                                    const void* wy, const void* wx, void* out,
                                    int batch, int n, int htot, int wm, int c,
                                    int p, int s, int n_classes, int dtype,
                                    void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return (int)cudaGetLastError();
  if (s > kMaxS || p > kMaxP || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  const float* wyp = static_cast<const float*>(wy);
  const float* wxp = static_cast<const float*>(wx);
  if (dtype == 0) {
    return launch<float>(plane, sp, wyp, wxp, out, batch, n, htot, wm, c, p, s, n_classes, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(plane, sp, wyp, wxp, out, batch, n, htot, wm, c, p, s,
                                 n_classes, st);
  }
  return (int)cudaErrorInvalidValue;
}
