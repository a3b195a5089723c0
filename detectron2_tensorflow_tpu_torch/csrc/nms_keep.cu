// Greedy-NMS keep mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas/nms_keep.py
// greedy_keep (kernel body _make_kernel). Same result: keep[b, i] is true iff
// box i is valid and no earlier kept box of image b overlaps it with IoU >
// threshold; with max_keep the sweep stops once max_keep boxes are kept.
// The TPU kernel's lane-major [4, N] layout, 128-row blocks, 2048-wide
// column chunks and SMEM counter do not carry over.
//
// What bounds it on the H100: not arithmetic (N^2/2 IoUs are a few million
// flops) but the greedy sweep, which is serial in score order. Design:
//   1. nms_mask_kernel, grid (column block, row block, image), 64 threads:
//      one thread per row i writes a 64-bit word per column block whose bit
//      k says box (64*cb + k) > i overlaps box i. All pairs in parallel.
//   2. nms_sweep_kernel, one warp per image: walks the rows in score order,
//      keeps a "removed" bit-vector spread over the warp's registers (lane l
//      owns words l, l+32, ...), reads bit i with one shuffle, and ORs a kept
//      row's words in. The next row's words are loaded before the current
//      decision, so the sweep waits on a load only once per row.
// The batch is the grid's z dimension (pass 1) and x dimension (pass 2).
//
// Bit-equality with the JAX package: the IoU uses pairwise_iou's float32
// operations in the same order (max/min, (a1 + a2) - inter, division by
// max(union, 1e-8)) with explicitly rounded intrinsics, and the file is also
// built with -fmad=false, so no product is contracted into an FMA. Columns
// past N read the JAX package's far-away padding box (-1e8, ...), which never
// overlaps anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxWordsPerLane = 8;  // N <= 64 * 32 * 8 = 16384
constexpr int kMaxN = kTile * 32 * kMaxWordsPerLane;
constexpr float kEps = 1e-8f;
constexpr float kPad = -1e8f;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  float iou = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, kEps)) : 0.f;
  return iou > thr;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int col_blocks, float thr,
                                unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int rb = blockIdx.y;
  const int cb = blockIdx.x;
  const int t = threadIdx.x;
  const float4* bx = boxes + (size_t)b * n;

  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const int j = cb * kTile + t;
  float4 v = make_float4(kPad, kPad, kPad, kPad);
  if (j < n) v = bx[j];
  cbox[t] = v;
  carea[t] = box_area(v);
  __syncthreads();

  const int i = rb * kTile + t;
  if (i >= n) return;
  unsigned long long bits = 0ull;
  if (cb >= rb) {  // only later boxes (j > i) can be suppressed by i
    const float4 a = bx[i];
    const float aa = box_area(a);
    const int start = (cb == rb) ? t + 1 : 0;
    for (int k = start; k < kTile; ++k) {
      if (iou_over(a, aa, cbox[k], carea[k], thr)) bits |= 1ull << k;
    }
  }
  mask[((size_t)b * n + i) * col_blocks + cb] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int n,
                                 int col_blocks, int max_keep,
                                 uint8_t* __restrict__ keep) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * col_blocks;
  const uint8_t* vb = valid + (size_t)b * n;
  uint8_t* kb = keep + (size_t)b * n;

  __shared__ uint8_t vs[kMaxN];
  for (int i = lane; i < n; i += 32) {
    vs[i] = vb[i];
    kb[i] = 0;
  }
  __syncwarp();

  unsigned long long removed[kMaxWordsPerLane];
  unsigned long long cur[kMaxWordsPerLane];
#pragma unroll
  for (int s = 0; s < kMaxWordsPerLane; ++s) {
    removed[s] = 0ull;
    const int w = lane + 32 * s;
    cur[s] = (n > 0 && w < col_blocks) ? m[w] : 0ull;
  }

  int kept = 0;
  for (int i = 0; i < n && kept < max_keep; ++i) {
    // Prefetch row i + 1 before deciding row i.
    unsigned long long nxt[kMaxWordsPerLane];
#pragma unroll
    for (int s = 0; s < kMaxWordsPerLane; ++s) {
      const int w = lane + 32 * s;
      nxt[s] = (i + 1 < n && w < col_blocks) ? m[(size_t)(i + 1) * col_blocks + w] : 0ull;
    }
    const int word = i >> 6;
    const int slot = word >> 5;
    unsigned long long mine = 0ull;
#pragma unroll
    for (int s = 0; s < kMaxWordsPerLane; ++s) {
      if (s == slot) mine = removed[s];
    }
    const unsigned long long rw = __shfl_sync(0xffffffffu, mine, word & 31);
    const bool alive = vs[i] && !((rw >> (i & 63)) & 1ull);
    if (alive) {  // uniform across the warp
      if (lane == 0) kb[i] = 1;
      ++kept;
#pragma unroll
      for (int s = 0; s < kMaxWordsPerLane; ++s) removed[s] |= cur[s];
    }
#pragma unroll
    for (int s = 0; s < kMaxWordsPerLane; ++s) cur[s] = nxt[s];
  }
}

}  // namespace

// boxes [batch, n, 4] f32 (score-sorted per image), valid [batch, n] bytes,
// mask scratch [batch, n, ceil(n / 64)] u64, keep [batch, n] bytes (out).
// Returns cudaGetLastError() after both launches.
extern "C" int nms_keep_launch(const void* boxes, const void* valid, void* mask,
                               void* keep, int batch, int n, float thr,
                               int max_keep, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kTile - 1) / kTile;
  dim3 grid(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const float4*>(boxes), n, col_blocks, thr,
      static_cast<unsigned long long*>(mask));
  nms_sweep_kernel<<<batch, 32, 0, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, col_blocks, max_keep,
      static_cast<uint8_t*>(keep));
  return (int)cudaGetLastError();
}
