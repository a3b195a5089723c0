// Greedy-NMS keep mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas/nms_keep.py
// greedy_keep (kernel body _make_kernel). Same result: keep[r, i] is true iff
// box i of batch row r is valid and no earlier kept box of that row overlaps
// it with IoU > threshold; with max_keep exactly the first max_keep
// survivors are kept. A batch row is one image, or one (image, RPN level)
// pair: the RPN hands all its levels over in one launch. The TPU kernel's
// lane-major [4, N] layout, 128-row blocks, 2048-wide column chunks and
// SMEM counter do not carry over.
//
// What bounds it on the H100: not memory (a few hundred KB) and not at first
// the arithmetic (N^2/2 IoUs a row), but the greedy sweep, which is serial in
// score order: a sweep that decides one row at a time waits on a dependent
// load per row (~0.3 us, so ~0.3 ms at N = 1000). Here the dependent chain
// is ceil(N / 64) steps of about 1 us each (a barrier, an L2 round trip,
// the in-block settle); after it, the mask pass's IoU arithmetic, which
// dominates at training's 40 x 2000. Design:
//   1. nms_mask_kernel, grid (upper-triangle tile, batch row), 64 threads:
//      one thread per row i writes one 64-bit word per column block cb >=
//      i's block, whose bit k says box 64*cb + k (> i) overlaps box i. Tiles
//      below the diagonal are never launched, written or read. An invalid
//      row writes zero words; on the diagonal a valid row also sets its own
//      bit, so the diagonal words carry the validity mask. The threshold
//      test needs no division (see Threshold).
//   2. nms_sweep_kernel, one block of 256 threads per batch row, settles 64
//      rows a step, with one barrier a step: warp 0 settles the block in
//      registers and shared memory from words it loaded a step ahead, and
//      ORs the kept rows' words of the next column block into "removed"; the
//      other warps meanwhile OR the previous block's kept rows' words of the
//      later column blocks, as independent loads.
// Computing each word inside the sweep instead, with no mask pass (so that
// rows past a max_keep exit cost nothing), puts all of a batch row's IoUs on
// one SM, and was slower at every shape the model runs.
//
// Bit-equality with the JAX package: the IoU uses pairwise_iou's float32
// operations in the same order (max/min, (a1 + a2) - inter, then the test
// of inter / max(union, 1e-8) against the threshold) with explicitly
// rounded intrinsics, and the file is also built with -fmad=false, so no
// product is contracted into an FMA. A pair with no intersection has IoU
// exactly 0. Columns past N never overlap anything (the JAX package pads
// them with a far-away box).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;
constexpr int kMaxN = 16384;
constexpr int kMaxBlocks = kMaxN / kTile;
constexpr int kSweepThreads = 256;
constexpr int kFarWarps = kSweepThreads / 32 - 1;  // warps 1-7 of the sweep
constexpr int kFarRows = (kTile + kFarWarps - 1) / kFarWarps;  // kept rows a thread ORs per word
constexpr int kSettleBatch = 4;  // diagonal words read before they are applied
constexpr float kEps = 1e-8f;
constexpr float kPad = -1e8f;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// The threshold test without a division. iou = RN(inter / u), u =
// max(union, 1e-8), and RN(x) > thr iff x > mid, the midpoint between thr
// and the next float up (x == mid cannot occur: inter = mid * u would need
// more than 24 significant bits). mid has 25 significant bits and u 24, so
// mid * u is exact in double, and the test is exact where both are finite;
// elsewhere it divides as pairwise_iou does.
struct Threshold {
  float thr;
  double mid;
  bool exact;
};

__device__ __forceinline__ Threshold make_threshold(float thr) {
  const double mid = 0.5 * ((double)thr + (double)nextafterf(thr, INFINITY));
  return {thr, mid, isfinite(mid) != 0};
}

__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b,
                                         float area_b, const Threshold& t) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(inter > 0.f) || !(uni > 0.f)) return 0.f > t.thr;  // IoU exactly 0
  const float u = fmaxf(uni, kEps);
  if (t.exact && u < INFINITY) return (double)inter > t.mid * (double)u;
  return __fdiv_rn(inter, u) > t.thr;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const uint8_t* __restrict__ valid, int n,
                                int col_blocks, float thr, u64* __restrict__ mask) {
  // Tile blockIdx.x of the upper triangle (cb >= rb), counted from its end:
  // the r-th row block from the last holds r + 1 tiles.
  const int u = col_blocks * (col_blocks + 1) / 2 - 1 - blockIdx.x;
  int r = (int)((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= u) ++r;
  while (r * (r + 1) / 2 > u) --r;
  const int rb = col_blocks - 1 - r;
  const int cb = col_blocks - 1 - (u - r * (r + 1) / 2);
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float4* bx = boxes + (size_t)b * n;

  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const int j = cb * kTile + t;
  const float4 v = j < n ? bx[j] : make_float4(kPad, kPad, kPad, kPad);
  cbox[t] = v;
  carea[t] = box_area(v);
  __syncthreads();

  const int i = rb * kTile + t;
  if (i >= n) return;
  u64 bits = 0ull;
  if (valid[(size_t)b * n + i]) {
    const Threshold th = make_threshold(thr);
    const float4 a = bx[i];
    const float aa = box_area(a);
    const int first = cb == rb ? t + 1 : 0;
#pragma unroll 16
    for (int k = 0; k < kTile; ++k) {
      if (k >= first && iou_over(a, aa, cbox[k], carea[k], th)) bits |= 1ull << k;
    }
    if (cb == rb) bits |= 1ull << t;  // the validity bit
  }
  mask[((size_t)b * n + i) * col_blocks + cb] = bits;
}

// Row i's word for column block cb from the mask pass; zero past N or past
// the last column block.
__device__ __forceinline__ u64 row_word(const u64* __restrict__ m, int n, int col_blocks,
                                        int i, int cb) {
  return i < n && cb < col_blocks ? m[(size_t)i * col_blocks + cb] : 0ull;
}

// One block of 256 threads per batch row. Step rb, between two barriers:
//   warp 0 settles row block rb. Its candidates are the diagonal words' own
//   bits not in removed[rb]. Only candidates that overlap a later candidate
//   can change the outcome, so it visits those alone, in order, reading
//   four of their words before applying any (the reads do not wait on the
//   decisions); each one still present removes what it overlaps. What is
//   left is kept, cut to the first max_keep - kept rows (a rank by
//   __popcll, two ballots). It writes the block's keep bytes and kept-row
//   list, and ORs the kept rows' words of column block rb + 1 into removed
//   from registers loaded a step ahead (a warp reduction), so the next step
//   never waits on a load;
//   warps 1-7 meanwhile OR block rb - 1's kept rows' words of column blocks
//   rb + 1 onwards into removed; their loads are independent.
// removed[c] is complete when step c starts: blocks up to c - 2 were ORed
// in by warps 1-7, block c - 1 by warp 0.
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const u64* __restrict__ mask, int n, int col_blocks, int max_keep,
                 uint8_t* __restrict__ keep) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const u64* m = mask + (size_t)b * n * col_blocks;
  uint8_t* kb = keep + (size_t)b * n;

  __shared__ u64 removed[kMaxBlocks];
  __shared__ u64 diag[kTile];
  __shared__ int rows[2][kTile];  // a settled block's kept rows in order, by parity
  __shared__ int counts[2];

  for (int w = tid; w < col_blocks; w += kSweepThreads) removed[w] = 0ull;
  // Warp 0's words of rows (lane, lane + 32) of the block to settle: the
  // diagonal ones and those of the next column block.
  u64 d_lo = 0ull, d_hi = 0ull, x_lo = 0ull, x_hi = 0ull;
  if (warp == 0) {
    d_lo = row_word(m, n, col_blocks, lane, 0);
    d_hi = row_word(m, n, col_blocks, lane + 32, 0);
    x_lo = row_word(m, n, col_blocks, lane, 1);
    x_hi = row_word(m, n, col_blocks, lane + 32, 1);
  }
  __syncthreads();

  int kept = 0;
  int rb = 0;
  for (; rb < col_blocks; ++rb) {
    if (rb > 0) {
      kept += counts[(rb - 1) & 1];
      if (kept >= max_keep) break;
    }
    if (warp == 0) {
      const int base = rb * kTile;
      const int next = base + kTile;
      const u64 nd_lo = row_word(m, n, col_blocks, next + lane, rb + 1);
      const u64 nd_hi = row_word(m, n, col_blocks, next + lane + 32, rb + 1);
      const u64 nx_lo = row_word(m, n, col_blocks, next + lane, rb + 2);
      const u64 nx_hi = row_word(m, n, col_blocks, next + lane + 32, rb + 2);
      const u64 lo = __ballot_sync(0xffffffffu, (d_lo >> lane) & 1ull);
      const u64 hi = __ballot_sync(0xffffffffu, (d_hi >> (lane + 32)) & 1ull);
      u64 word = (lo | (hi << 32)) & ~removed[rb];  // the candidates
      // Only candidates that overlap a later candidate can change the
      // outcome: visit those in order, each removing what it overlaps if it
      // is still there. What is left is the block's keep word.
      const u64 ov_lo = ((word >> lane) & 1ull) ? d_lo & word & ~(1ull << lane) : 0ull;
      const u64 ov_hi =
          ((word >> (lane + 32)) & 1ull) ? d_hi & word & ~(1ull << (lane + 32)) : 0ull;
      diag[lane] = ov_lo;
      diag[lane + 32] = ov_hi;
      u64 todo = __ballot_sync(0xffffffffu, ov_lo != 0ull)
               | ((u64)__ballot_sync(0xffffffffu, ov_hi != 0ull) << 32);
      __syncwarp();
      while (todo != 0ull) {
        int k[kSettleBatch];
        u64 d[kSettleBatch];
#pragma unroll
        for (int u = 0; u < kSettleBatch; ++u) {
          k[u] = __ffsll((long long)todo) - 1;  // -1 once todo is empty
          todo &= todo - 1ull;
          d[u] = k[u] >= 0 ? diag[k[u]] : 0ull;
        }
#pragma unroll
        for (int u = 0; u < kSettleBatch; ++u) {
          if (k[u] >= 0 && ((word >> k[u]) & 1ull)) word &= ~d[u];
        }
      }
      // max_keep: the first max_keep - kept survivors of the block.
      const int limit = max_keep - kept;
      const bool keep_lo = ((word >> lane) & 1ull)
          && __popcll(word & ((1ull << lane) - 1ull)) < limit;
      const bool keep_hi = ((word >> (lane + 32)) & 1ull)
          && __popcll(word & ((1ull << (lane + 32)) - 1ull)) < limit;
      word = (u64)__ballot_sync(0xffffffffu, keep_lo)
           | ((u64)__ballot_sync(0xffffffffu, keep_hi) << 32);
      const int count = __popcll(word);
      if (base + lane < n) kb[base + lane] = (word >> lane) & 1ull;
      if (base + lane + 32 < n) kb[base + lane + 32] = (word >> (lane + 32)) & 1ull;
      if ((word >> lane) & 1ull) rows[rb & 1][__popcll(word & ((1ull << lane) - 1ull))] = lane;
      if ((word >> (lane + 32)) & 1ull)
        rows[rb & 1][__popcll(word & ((1ull << (lane + 32)) - 1ull))] = lane + 32;
      if (lane == 0) counts[rb & 1] = count;
      if (count > 0 && rb + 1 < col_blocks) {
        const u64 acc = (((word >> lane) & 1ull) ? x_lo : 0ull)
                      | (((word >> (lane + 32)) & 1ull) ? x_hi : 0ull);
        const unsigned alo = __reduce_or_sync(0xffffffffu, (unsigned)acc);
        const unsigned ahi = __reduce_or_sync(0xffffffffu, (unsigned)(acc >> 32));
        if (lane == 0) atomicOr(&removed[rb + 1], (u64)alo | ((u64)ahi << 32));
      }
      d_lo = nd_lo;
      d_hi = nd_hi;
      x_lo = nx_lo;
      x_hi = nx_hi;
    } else if (rb > 0 && counts[(rb - 1) & 1] > 0) {
      const int* prev = rows[(rb - 1) & 1];
      const int count = counts[(rb - 1) & 1];
      const int pbase = (rb - 1) * kTile;
      for (int w = rb + 1 + lane; w < col_blocks; w += 32) {
        u64 got[kFarRows];
#pragma unroll
        for (int s = 0; s < kFarRows; ++s) {
          const int j = warp - 1 + s * kFarWarps;
          got[s] = j < count ? row_word(m, n, col_blocks, pbase + prev[j], w) : 0ull;
        }
        u64 acc = 0ull;
#pragma unroll
        for (int s = 0; s < kFarRows; ++s) acc |= got[s];
        if (acc != 0ull) atomicOr(&removed[w], acc);
      }
    }
    __syncthreads();
  }
  for (int i = rb * kTile + tid; i < n; i += kSweepThreads) kb[i] = 0;  // past the exit
}

}  // namespace

// boxes [batch, n, 4] f32 (score-sorted per batch row), valid [batch, n]
// bytes, mask scratch [batch, n, ceil(n / 64)] u64, keep [batch, n] bytes
// (out). Returns cudaGetLastError() after the launches.
extern "C" int nms_keep_launch(const void* boxes, const void* valid, void* mask,
                               void* keep, int batch, int n, float thr,
                               int max_keep, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kTile - 1) / kTile;
  u64* m = static_cast<u64*>(mask);
  dim3 grid(col_blocks * (col_blocks + 1) / 2, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(static_cast<const float4*>(boxes),
                                         static_cast<const uint8_t*>(valid), n, col_blocks,
                                         thr, m);
  nms_sweep_kernel<<<batch, kSweepThreads, 0, s>>>(m, n, col_blocks, max_keep,
                                                   static_cast<uint8_t*>(keep));
  return (int)cudaGetLastError();
}
