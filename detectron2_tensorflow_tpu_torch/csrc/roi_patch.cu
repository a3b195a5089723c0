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
// Hat support. A ROI's bilinear hat weights are nonzero only on a few rows
// of wy and columns of wx: on serving plans at 800x1344 (P = 32) the rows
// [p0, p1) and columns [q0, q1) where any of the S weights is nonzero span
// about 11 x 12 cells on average, 13-15% of the patch. Every block derives
// that support from the weights themselves (two warp ballots over P <= 64
// positions), never from the tier class, which some callers set to 0 over
// dense weights, and loops over it alone. The products it leaves out are
// exact zeros, so no float32 sum changes; an all-zero support (a zero-area
// box) gives exact zeros forward and adds nothing backward.
//
// Forward (roi_patch_fwd_kernel). What bounds it on the H100: not the bytes
// (the union of the supports read once and the output written once take
// 0.026 ms at the serving box set, 2 x 1000 ROIs) but the chain each ROI
// walks, small chunk by small chunk: copies in flight, a barrier, the
// contractions' instructions, a barrier. The design shortens and
// overlaps that chain. One block per (ROI, group of 32-channel tiles,
// image), 256 threads: the group is all of the ROI's tiles unless that
// leaves under two waves of blocks on the card (then it is halved), so the
// weights, the support and the mma's B operand are set up once per ROI. The
// block walks tile by tile over the support in chunks of 16 columns x 16
// rows, double-buffered: the next chunk's 16-byte cp.async copies (8 bf16 or
// 4 float32 channels each; element by element where C is not a multiple of
// that) are in flight while the current one computes, zero-filled past the
// support's rows, the plane and C. The first contraction a[o, q, c] =
// sum_p wy[o, p] patch[p, q, c] runs on the tensor cores for a bf16 plane:
// mma.sync m16n8k16 (bf16 in, float32 accumulators), M = the chunk's
// (column, channel) pairs (16 per m-tile, loaded with ldmatrix.trans: the
// stage is [row][column][channel], rows padded 16 bytes so an ldmatrix phase
// hits 8 bank groups), N = S padded to 8 or 16, K = 16 rows (zero wy rows
// past p1), each warp holding 4 m-tiles' accumulators across the row
// chunks. A bf16 x bf16 product is exact in float32, so only the summation
// order differs from the plain version. A float32 plane takes the same
// staging with an FFMA first contraction (no TF32). a goes through shared
// memory ([S][16 columns][32 channels] float32, rows padded 4 words so the
// fragment stores are conflict-free) to the second contraction
// out[o, u, c] = sum_q wx[u, q] a[o, q, c], float32 FFMA over the support's
// columns: warp w owns o = w (and w + 8), lane l channel l, all u in
// registers across the column chunks. Shared memory is 50 KB at S = 7 and
// 67 KB at S = 14 (P = 32, bf16); registers are capped at 64 a thread for
// S <= 8, so 4 blocks share an SM there (2 at S = 14). Rows stream through
// the 16-row stages, so P = 64 fits too.
//
// Backward (roi_patch_bwd_kernel) replaces the TPU kernel
// ops/pallas/roi_patch.py roi_patch_backward (body _make_bwd_kernel). Per
// ROI it forms
//     gp[p, q, c] = sum_o sum_u wy[o, p] * g[o, u, c] * wx[u, q]
// in float32 (g widened exactly, wy and wx unrounded, as the Pallas kernel
// does) and adds it into a float32 plane [B, Htot, Wm, C] at (row+p, tx+q).
// The TPU kernel serializes that read-modify-write on a sequential grid
// (region sort, round-robin groups, a hazard flag, tier-narrowed DMA
// windows); none of that carries over. Here blocks run in parallel and
// overlapping ROIs meet in float32 atomics, chosen over a sorted segmented
// reduction because it is simple and needs no scratch: the price is a
// summation order that changes from run to run (the plain version agrees to
// float32 rounding of the sums, not bit for bit). What bounds it on the
// H100: the atomics, one per support cell and channel. Design: one block per
// (ROI, 128-channel tile, image), 256 threads, lane l owning channels
// 4l..4l+3, so each warp-wide add is one 16-byte vector atomic per lane
// (atomicAdd on float4, sm_90), a 512-byte segment, and a quarter of the
// scalar atomics (scalar atomics where C is not a multiple of 4). The
// cotangent tile [S, S, 128] stays in its dtype in shared memory; each warp
// takes support rows p, forms t[u] = sum_o wy[o, p] g[o, u, c] over the
// o whose weight at p is nonzero, then adds sum_u t[u] wx[u, q] for every
// support column q. Exact-zero sums are not added: adding +0 changes no sum.
//
// The forward kernel takes a compile-time variant, the GPU counterpart of
// the ablations of the TPU kernel's body in the JAX package's
// tools/exp_roi_variants.py make_kernel, so that the ablations measure this
// kernel itself (kFull is the production instantiation). A block computes
// its ROI one 32-channel tile at a time, so "the first element" and
// "out[0, 0, 0]" of the TPU kernel's per-ROI block are, here, those of each
// channel tile (channel c0, the tile's first):
//   kNoDma   no patch reads, writes 1.0;
//   kOneDma  every block of a group of 4 ROIs stages the group's first ROI's
//            support window (its channel tile) and writes that patch's
//            element [0, 0, c0];
//   kNoDot   stages patch[:S, :S] and writes it cast (no weights read);
//   kM1Only  the first contraction only, over columns [0, S), writes
//            a[:, :S] of a = Wy . patch;
//   kNoSwap  both contractions, written [u, o, c] instead of [o, u, c];
//   kNoWrite both contractions, writes the constant out[0, 0, c0];
//   kFull    the production output.
// Values an ablation computes but does not write are kept alive by a store
// under a condition no float32 sum can meet (a signalling-NaN bit pattern),
// so the compiler cannot drop the work being measured.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 16;
constexpr int kMaxP = 64;
constexpr int kCT = 32;   // forward: channels per block, lane l owns channel l
constexpr int kQC = 16;   // forward: patch columns per staged chunk
constexpr int kKC = 16;   // forward: patch rows per staged chunk (one mma k-step)
constexpr int kMT = 2 * kQC / kWarps;  // forward: m-tiles (16 channels of a column) per warp
constexpr int kLdA = kQC * kCT + 4;    // floats per o-row of the a tile
// forward: blocks per SM the registers are capped for (S <= 8: 64 a thread)
template <int NT>
constexpr int kFwdBlocksPerSm = NT == 1 ? 4 : 2;
constexpr int kBCT = 128;  // backward: channels per block, lane l owns 4l..4l+3

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

enum Variant { kFull = 0, kNoDma, kOneDma, kNoDot, kM1Only, kNoSwap, kNoWrite, kNumVariants };

// A store no float32 sum can trigger: adds and FMAs never return a
// signalling NaN (the card gives the canonical quiet NaN 0x7fffffff).
template <typename T>
__device__ __forceinline__ void keep_alive(float v, T* dst) {
  if (__float_as_uint(v) == 0x7f800001u) *dst = from_f32<T>(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// [lo, hi) of the positions i < P at which some w[o * P + i] (o < S) is
// nonzero, from two warp ballots (P <= 64); [0, 0) where none is. One warp
// calls it; lane 0 writes range[0..1].
__device__ __forceinline__ void hat_support(const float* __restrict__ w, int s, int p, int lane,
                                            int* range) {
  bool nz0 = false, nz1 = false;
  for (int o = 0; o < s; ++o) {
    if (lane < p) nz0 |= w[o * p + lane] != 0.f;
    if (lane + 32 < p) nz1 |= w[o * p + lane + 32] != 0.f;
  }
  const unsigned long long m = (unsigned long long)__ballot_sync(0xffffffffu, nz0) |
                               ((unsigned long long)__ballot_sync(0xffffffffu, nz1) << 32);
  if (lane == 0) {
    range[0] = m ? __ffsll((long long)m) - 1 : 0;
    range[1] = m ? 64 - __clzll((long long)m) : 0;
  }
}

// ---------------------------------------------------------------- forward

// Bytes of one staged patch row: kQC columns x kCT channels; bf16 rows get
// 16 bytes more, so the 8 rows one ldmatrix phase reads (1040 bytes apart)
// fall in 8 distinct 16-byte bank groups.
template <typename T>
constexpr int kRowBytes = kQC * kCT * (int)sizeof(T) + (sizeof(T) == 2 ? 16 : 0);

// Dynamic shared memory of the forward kernel, in bytes from its start.
struct FwdLayout {
  int kb;  // bf16 per row of the mma's B (wy from p0, zero past p1)
  int wxT, wy, wyb, stage, a, total;
  __host__ __device__ FwdLayout(int p, int s, int ku, int esize) {
    kb = ((p + 15) & ~15) + 8;  // + 8: the B fragment loads hit 32 distinct banks
    wxT = 0;                                       // [P][ku] f32, wx transposed, 0 for u >= S
    wy = wxT + align16(p * ku * 4);                // [S][P] f32, rounded to the plane's dtype
    wyb = wy + align16(s * p * 4);                 // [ku][kb] bf16 (bf16 plane only)
    stage = wyb + (esize == 2 ? align16(ku * kb * 2) : 0);
    a = stage + 2 * kKC * (kQC * kCT * esize + (esize == 2 ? 16 : 0));  // 2 stages of kKC rows
    total = a + s * kLdA * 4;                      // [S][kLdA] f32
  }
};

// Stage plane[r0 + k, col0 + q, ch0 + cc] for k < kKC, q < qn, cc < kCT
// into dst ([k] rows of kRowBytes<T>, each [q][cc] in T): zero for k >= kn,
// outside the plane and at channels >= c. vec: 16-byte cp.async copies (C a
// multiple of a copy's channels, the plane 16-byte aligned), committed as
// one group; otherwise element by element. The caller waits and
// synchronizes.
template <typename T>
__device__ __forceinline__ void stage_window(unsigned char* dst, const T* __restrict__ base,
                                             int htot, int wm, int c, int ch0, int r0, int kn,
                                             int col0, int qn, bool vec) {
  if (vec) {
    // Thread -> (column q, copy j) of the chunk, and every kRowStep-th row.
    constexpr int kPer = 16 / (int)sizeof(T);  // channels per copy
    constexpr int kPieces = kCT / kPer;        // copies per cell
    constexpr int kRowStep = kThreads / (kQC * kPieces);
    const int j = threadIdx.x % kPieces;
    const int q = threadIdx.x / kPieces % kQC;
    const int k0 = threadIdx.x / (kQC * kPieces);
    if (q < qn) {
      const int col = col0 + q, ch = ch0 + j * kPer;
      const bool col_ok = col >= 0 && col < wm && ch < c;
      const long long step = (long long)kRowStep * wm * c;
      long long off = ((long long)(r0 + k0) * wm + col) * c + ch;
      unsigned char* d = dst + k0 * kRowBytes<T> + (q * kCT + j * kPer) * (int)sizeof(T);
#pragma unroll
      for (int k = k0; k < kKC; k += kRowStep) {
        const bool ok = col_ok && k < kn && r0 + k >= 0 && r0 + k < htot;
        cp_async16(d, ok ? base + off : base, ok);
        off += step;
        d += kRowStep * kRowBytes<T>;
      }
    }
  } else {
    const int total = kKC * qn * kCT;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int cc = i % kCT;
      const int cell = i / kCT;
      const int k = cell / qn;
      const int q = cell - k * qn;
      const int r = r0 + k, col = col0 + q, ch = ch0 + cc;
      const bool ok = k < kn && r >= 0 && r < htot && col >= 0 && col < wm && ch < c;
      reinterpret_cast<T*>(dst + k * kRowBytes<T>)[q * kCT + cc] =
          ok ? base[((size_t)r * wm + col) * c + ch] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

template <typename T, int NT, int V>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm<NT>)
roi_patch_fwd_kernel(const T* __restrict__ plane, const int* __restrict__ starts,
                     const float* __restrict__ wy, const float* __restrict__ wx,
                     T* __restrict__ out, int n, int htot, int wm, int c,
                     int p, int s, int n_classes, int tiles, bool vec) {
  constexpr int kU = 8 * NT;  // S padded: the mma's N
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kStageBytes = kKC * kRowBytes<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L(p, s, kU, sizeof(T));
  float* wxT = reinterpret_cast<float*>(smem + L.wxT);
  float* wy_s = reinterpret_cast<float*>(smem + L.wy);
  __nv_bfloat16* wyb = reinterpret_cast<__nv_bfloat16*>(smem + L.wyb);
  float* a_s = reinterpret_cast<float*>(smem + L.a);
  __shared__ int sup[4];  // rows [p0, p1), columns [q0, q1) of the hat support
  __shared__ float konst;  // kNoWrite: out[0, 0, c0] of the tile

  const int roi = blockIdx.x;
  const int tile0 = blockIdx.y * tiles;  // the block's channel tiles [tile0, tile0 + nt)
  const int nt = min(tiles, (c + kCT - 1) / kCT - tile0);
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const size_t slot = (size_t)b * n + roi;
  int row = starts[slot * 3 + 0];
  int tx = starts[slot * 3 + 1];
  const int cls = starts[slot * 3 + 2];
  T* o_ptr = out + slot * s * s * c;
  auto fill = [&](int t, T v) {  // every output of tile t
    const int ch = (tile0 + t) * kCT + lane;
    for (int i = warp; i < s * s; i += kWarps) {
      if (ch < c) o_ptr[(size_t)i * c + ch] = v;
    }
  };
  const T* base = plane + (size_t)b * htot * wm * c;

  if (V == kNoDma || V == kNoDot) {
    for (int t = 0; t < nt; ++t) {
      if (cls >= n_classes) {  // skip sentinel: no loads, exact zeros
        fill(t, from_f32<T>(0.f));
      } else if (V == kNoDma) {
        fill(t, from_f32<T>(1.f));
      } else {
        const int ch = (tile0 + t) * kCT + lane;
        stage_window<T>(smem + L.stage, base, htot, wm, c, ch - lane, row, s, tx, s, vec);
        cp_async_wait_all();
        __syncthreads();
        for (int i = warp; i < s * s; i += kWarps) {
          const int o = i / s;
          const int u = i - o * s;
          const T v = reinterpret_cast<const T*>(smem + L.stage + o * kRowBytes<T>)[u * kCT + lane];
          if (ch < c) o_ptr[(size_t)i * c + ch] = v;
        }
        __syncthreads();
      }
    }
    return;
  }

  // The weights' loads start before the skip test waits on `cls`: a
  // skipped slot's weights are zeros (plan_rois), read and left unused.
  size_t wslot = slot;
  if (V == kOneDma) {  // the group's first ROI: its patch, its support
    wslot = (size_t)b * n + (roi / 4) * 4;
    row = starts[wslot * 3 + 0];
    tx = starts[wslot * 3 + 1];
  }
  const float* wy_g = wy + wslot * s * p;
  const float* wx_g = wx + wslot * s * p;
  for (int i = threadIdx.x; i < s * p; i += kThreads) wy_s[i] = to_f32(from_f32<T>(wy_g[i]));
  for (int i = threadIdx.x; i < p * kU; i += kThreads) {
    const int q = i / kU;
    const int u = i - q * kU;
    wxT[i] = u < s ? wx_g[u * p + q] : 0.f;
  }
  if (warp == 0) hat_support(wy_g, s, p, lane, sup);
  if (warp == 1) hat_support(wx_g, s, p, lane, sup + 2);
  if (cls >= n_classes) {  // skip sentinel: no patch loads, exact zeros
    for (int t = 0; t < nt; ++t) fill(t, from_f32<T>(0.f));
    return;
  }
  __syncthreads();
  const int p0 = sup[0], p1 = sup[1];
  const int q0 = V == kM1Only ? 0 : sup[2];
  const int q1 = V == kM1Only ? s : sup[3];
  const int nk = (p1 - p0 + kKC - 1) / kKC;  // row chunks
  const int nq = (q1 - q0 + kQC - 1) / kQC;  // column chunks
  if (nk == 0 || nq == 0) {  // an all-zero support: a = 0, out = 0
    for (int t = 0; t < nt; ++t) {
      const bool in0 = row >= 0 && row < htot && tx >= 0 && tx < wm;
      const int c0 = (tile0 + t) * kCT;
      fill(t, V == kOneDma && in0 ? base[((size_t)row * wm + tx) * c + c0] : from_f32<T>(0.f));
    }
    return;
  }
  if constexpr (kMma) {  // read after the first barrier below
    for (int i = threadIdx.x; i < kU * L.kb; i += kThreads) {
      const int o = i / L.kb;
      const int k = i - o * L.kb;
      wyb[i] = __float2bfloat16_rn(o < s && p0 + k < p1 ? wy_s[o * p + p0 + k] : 0.f);
    }
  }

  // Step i stages (and contracts) row chunk k of column chunk qi of channel
  // tile t, (k, qi, t) counting up in that order, in stage i % 2; the next
  // step's copies are in flight while a step computes.
  const int steps = nt * nq * nk;
  auto stage_of = [&](int i) { return smem + L.stage + (i & 1) * kStageBytes; };
  auto load_chunk = [&](int i, int k, int qi, int t) {
    const int kc = p0 + k * kKC;
    const int qc = q0 + qi * kQC;
    stage_window<T>(stage_of(i), base, htot, wm, c, (tile0 + t) * kCT, row + kc,
                    min(kKC, p1 - kc), tx + qc, min(kQC, q1 - qc), vec);
  };
  auto advance = [&](int& k, int& qi, int& t) {
    if (++k == nk) {
      k = 0;
      if (++qi == nq) {
        qi = 0;
        ++t;
      }
    }
  };

  const int grp = lane >> 2;
  const int tig = lane & 3;
  // Contraction 1 accumulators: mma m-tile mt = warp + x * kWarps (column
  // mt / 2, channels (mt % 2) * 16 + [0, 16)) in [x][y * 4 + e]; FFMA
  // columns warp + x * kWarps (x < 2), outputs o in [x][o].
  float acc1[kMma ? kMT : 2][kMma ? 4 * NT : kU];
  float acc2[NT][kU];  // out[o = warp + j * kWarps, u, c = lane] of the tile
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc2[j][u] = 0.f;

  int k = 0, qi = 0, t = 0;     // this step's chunk
  int kn1 = 0, qn1 = 0, tn1 = 0;  // the next step's
  load_chunk(0, k, qi, t);
  advance(kn1, qn1, tn1);
  for (int i = 0; i < steps; ++i) {
    const int kc = p0 + k * kKC;
    const int qc = q0 + qi * kQC;
    const int qn = min(kQC, q1 - qc);
    const int ch = (tile0 + t) * kCT + lane;
    if (i + 1 < steps) {
      load_chunk(i + 1, kn1, qn1, tn1);
      advance(kn1, qn1, tn1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const unsigned char* st = stage_of(i);
    if (k == 0) {
#pragma unroll
      for (int x = 0; x < (kMma ? kMT : 2); ++x)
#pragma unroll
        for (int y = 0; y < (kMma ? 4 * NT : kU); ++y) acc1[x][y] = 0.f;
    }

    if (V != kOneDma) {
      // a[o, q, c] += sum_p wy[o, p] * patch[p, q, c] over the chunk's rows
      if constexpr (kMma) {
        const int jm = lane >> 3;  // ldmatrix: this lane's row address is of matrix jm
#pragma unroll
        for (int x = 0; x < kMT; ++x) {
          const int mt = warp + x * kWarps;
          if (mt < 2 * qn) {
            uint32_t af[4];
            ldmatrix_x4_trans(af, st + ((jm >> 1) * 8 + (lane & 7)) * kRowBytes<T> +
                                      ((mt >> 1) * kCT + (mt & 1) * 16 + (jm & 1) * 8) * 2);
#pragma unroll
            for (int y = 0; y < NT; ++y) {
              const __nv_bfloat16* bp = wyb + (y * 8 + grp) * L.kb + (kc - p0) + tig * 2;
              mma_bf16(&acc1[x][4 * y], af, ld32(bp), ld32(bp + 8));
            }
          }
        }
      } else {
        const float* stf = reinterpret_cast<const float*>(st);
        const int kn = min(kKC, p1 - kc);
        for (int r = 0; r < kn; ++r) {
          const float* w = wy_s + kc + r;
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int q = warp + x * kWarps;
            if (q < qn) {
              const float v = stf[(r * kQC + q) * kCT + lane];
#pragma unroll
              for (int o = 0; o < kU; ++o) {
                if (o < s) acc1[x][o] += w[o * p] * v;
              }
            }
          }
        }
      }

      if (k == nk - 1) {  // a of this column chunk is complete: to shared memory
        if constexpr (kMma) {
#pragma unroll
          for (int x = 0; x < kMT; ++x) {
            const int mt = warp + x * kWarps;
            if (mt < 2 * qn) {
              float* d = a_s + (mt >> 1) * kCT + (mt & 1) * 16 + grp;
#pragma unroll
              for (int y = 0; y < NT; ++y) {
                const int o = y * 8 + tig * 2;
                if (o < s) {
                  d[o * kLdA] = acc1[x][4 * y];
                  d[o * kLdA + 8] = acc1[x][4 * y + 2];
                }
                if (o + 1 < s) {
                  d[(o + 1) * kLdA] = acc1[x][4 * y + 1];
                  d[(o + 1) * kLdA + 8] = acc1[x][4 * y + 3];
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int q = warp + x * kWarps;
            if (q < qn) {
#pragma unroll
              for (int o = 0; o < kU; ++o) {
                if (o < s) a_s[o * kLdA + q * kCT + lane] = acc1[x][o];
              }
            }
          }
        }
        __syncthreads();

        if (V == kM1Only) {  // one column chunk, [0, S): write a[:, :S]
          for (int e = warp; e < s * s; e += kWarps) {
            const int o = e / s;
            const int u = e - o * s;
            if (ch < c) o_ptr[(size_t)e * c + ch] = from_f32<T>(a_s[o * kLdA + u * kCT + lane]);
          }
        } else {
          // out[o, u, c] += sum_q wx[u, q] * a[o, q, c] over the chunk's columns
          for (int q = 0; q < qn; ++q) {
            float wv[kU];
            const float4* w4 = reinterpret_cast<const float4*>(wxT + (qc + q) * kU);
#pragma unroll
            for (int v = 0; v < kU / 4; ++v) {
              const float4 f = w4[v];
              wv[4 * v] = f.x;
              wv[4 * v + 1] = f.y;
              wv[4 * v + 2] = f.z;
              wv[4 * v + 3] = f.w;
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int o = warp + j * kWarps;
              if (o < s) {
                const float av = a_s[o * kLdA + q * kCT + lane];
#pragma unroll
                for (int u = 0; u < kU; ++u) acc2[j][u] += wv[u] * av;
              }
            }
          }
          if (qi == nq - 1) {  // the tile's output is complete
            if (V == kNoWrite) {
              if (threadIdx.x == 0) konst = acc2[0][0];
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                  if (ch < c) keep_alive(acc2[j][u], o_ptr + ch);
                }
              __syncthreads();
              fill(t, from_f32<T>(konst));
            } else {
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const int o = warp + j * kWarps;
                if (o < s && ch < c) {
#pragma unroll
                  for (int u = 0; u < kU; ++u) {
                    if (u < s) {
                      const int e = V == kNoSwap ? u * s + o : o * s + u;
                      o_ptr[(size_t)e * c + ch] = from_f32<T>(acc2[j][u]);
                    }
                  }
                }
              }
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int u = 0; u < kU; ++u) acc2[j][u] = 0.f;
          }
        }
      }
    } else if (k == nk - 1 && qi == nq - 1) {  // kOneDma: the tile's patch is staged
      const bool in0 = row >= 0 && row < htot && tx >= 0 && tx < wm;
      fill(t, in0 ? base[((size_t)row * wm + tx) * c + ch - lane] : from_f32<T>(0.f));
    }
    __syncthreads();  // stage i % 2 and a are free for the next steps
    advance(k, qi, t);
  }
}

// Channel tiles per forward block (*tiles): all of a ROI's, unless that
// leaves fewer than two waves of blocks on the card, then halved until it
// does not.
template <typename Kernel>
cudaError_t fwd_tiles(Kernel kernel, int smem, int rois, int ctiles, int* tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long want = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  *tiles = ctiles;
  while (*tiles > 1 && (long long)rois * ((ctiles + *tiles - 1) / *tiles) < want) {
    *tiles = (*tiles + 1) / 2;
  }
  return cudaSuccess;
}

template <typename T, int NT, int V>
int launch_fwd(const void* plane, const int* starts, const float* wy, const float* wx,
               void* out, int batch, int n, int htot, int wm, int c, int p, int s,
               int n_classes, cudaStream_t stream) {
  const FwdLayout L(p, s, 8 * NT, sizeof(T));
  auto kernel = roi_patch_fwd_kernel<T, NT, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  const int ctiles = (c + kCT - 1) / kCT;
  int tiles = 1;
  err = fwd_tiles(kernel, L.total, batch * n, ctiles, &tiles);
  if (err != cudaSuccess) return (int)err;
  const bool vec = c % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(plane) % 16 == 0;
  dim3 grid(n, (ctiles + tiles - 1) / tiles, batch);
  kernel<<<grid, kThreads, L.total, stream>>>(static_cast<const T*>(plane), starts, wy, wx,
                                              static_cast<T*>(out), n, htot, wm, c, p, s,
                                              n_classes, tiles, vec);
  return (int)cudaGetLastError();
}

template <int V>
int launch_dtype(const void* plane, const void* starts, const void* wy, const void* wx,
                 void* out, int batch, int n, int htot, int wm, int c, int p, int s,
                 int n_classes, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  const float* wyp = static_cast<const float*>(wy);
  const float* wxp = static_cast<const float*>(wx);
#define D2_FWD(T)                                                                            \
  return s <= 8 ? launch_fwd<T, 1, V>(plane, sp, wyp, wxp, out, batch, n, htot, wm, c, p, s, \
                                      n_classes, st)                                         \
                : launch_fwd<T, 2, V>(plane, sp, wyp, wxp, out, batch, n, htot, wm, c, p, s, \
                                      n_classes, st)
  if (dtype == 0) D2_FWD(float);
  if (dtype == 1) D2_FWD(__nv_bfloat16);
#undef D2_FWD
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- backward

// Dynamic shared memory of the backward kernel, in bytes from its start.
struct BwdLayout {
  int wxT, wy, g, total;
  __host__ __device__ BwdLayout(int p, int s, int ku, int esize) {
    wxT = 0;                           // [P][ku] f32, wx transposed, 0 for u >= S
    wy = align16(p * ku * 4);          // [S][P] f32
    g = wy + align16(s * p * 4);       // [S * S][kBCT] in g's dtype
    total = g + s * s * kBCT * esize;
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
roi_patch_bwd_kernel(const T* __restrict__ g, const int* __restrict__ starts,
                     const float* __restrict__ wy, const float* __restrict__ wx,
                     float* __restrict__ acc, int n, int htot, int wm, int c,
                     int p, int s, int n_classes, bool vec) {
  constexpr int kU = 8 * NT;
  // 4 channels of g: 8 bytes in bf16, 16 in float32
  using Vec4 = typename std::conditional<sizeof(T) == 2, uint2, float4>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(p, s, kU, sizeof(T));
  float* wxT = reinterpret_cast<float*>(smem + L.wxT);
  float* wy_s = reinterpret_cast<float*>(smem + L.wy);
  T* g_s = reinterpret_cast<T*>(smem + L.g);
  __shared__ int sup[4];

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * kBCT;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const size_t slot = (size_t)b * n + roi;
  const int row = starts[slot * 3 + 0];
  const int tx = starts[slot * 3 + 1];
  const int cls = starts[slot * 3 + 2];
  if (cls >= n_classes) return;  // skip sentinel: no loads, no adds

  const float* wy_g = wy + slot * s * p;
  const float* wx_g = wx + slot * s * p;
  for (int i = threadIdx.x; i < s * p; i += kThreads) wy_s[i] = wy_g[i];
  for (int i = threadIdx.x; i < p * kU; i += kThreads) {
    const int q = i / kU;
    const int u = i - q * kU;
    wxT[i] = u < s ? wx_g[u * p + q] : 0.f;
  }
  const T* g_g = g + slot * s * s * c;
  for (int i = threadIdx.x; i < s * s * 32; i += kThreads) {
    const int e = i >> 5;
    const int l4 = (i & 31) * 4;
    const int chi = c0 + l4;
    T* d = g_s + e * kBCT + l4;
    const T* src = g_g + (size_t)e * c + chi;
    if (vec) {  // C % 4 == 0: the 4 channels are all in or all out
      Vec4 v{};
      if (chi < c) v = *reinterpret_cast<const Vec4*>(src);
      *reinterpret_cast<Vec4*>(d) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = chi + j < c ? src[j] : from_f32<T>(0.f);
    }
  }
  if (warp == 0) hat_support(wy_g, s, p, lane, sup);
  if (warp == 1) hat_support(wx_g, s, p, lane, sup + 2);
  __syncthreads();
  const int p0 = sup[0], p1 = sup[1], q0 = sup[2], q1 = sup[3];

  const int ch = c0 + 4 * lane;
  if (ch >= c) return;
  float* base = acc + (size_t)b * htot * wm * c + ch;
  for (int pp = p0 + warp; pp < p1; pp += kWarps) {
    const int r = row + pp;
    if (r < 0 || r >= htot) continue;
    // t[u] = sum_o wy[o, pp] * g[o, u, c], over the o whose weight is nonzero
    float4 t[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) t[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int o = 0; o < s; ++o) {
      const float w = wy_s[o * p + pp];
      if (w == 0.f) continue;
      const T* gr = g_s + o * s * kBCT + 4 * lane;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (u < s) {
          const float4 gv = load4(gr + u * kBCT);
          t[u].x += w * gv.x;
          t[u].y += w * gv.y;
          t[u].z += w * gv.z;
          t[u].w += w * gv.w;
        }
      }
    }
    float* rp = base + (size_t)r * wm * c;
    for (int q = q0; q < q1; ++q) {
      const int col = tx + q;
      if (col < 0 || col >= wm) continue;
      const float4* w4 = reinterpret_cast<const float4*>(wxT + q * kU);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kU / 4; ++k) {
        const float4 ww = w4[k];
        const float wk[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 tu = t[4 * k + e];
          v.x += tu.x * wk[e];
          v.y += tu.y * wk[e];
          v.z += tu.z * wk[e];
          v.w += tu.w * wk[e];
        }
      }
      if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
      float* d = rp + (size_t)col * c;
      if (vec) {
        atomicAdd(reinterpret_cast<float4*>(d), v);
      } else {
        atomicAdd(d, v.x);
        if (ch + 1 < c) atomicAdd(d + 1, v.y);
        if (ch + 2 < c) atomicAdd(d + 2, v.z);
        if (ch + 3 < c) atomicAdd(d + 3, v.w);
      }
    }
  }
}

template <typename T, int NT>
int launch_bwd(const void* g, const int* starts, const float* wy, const float* wx,
               float* acc, int batch, int n, int htot, int wm, int c, int p, int s,
               int n_classes, cudaStream_t stream) {
  const BwdLayout L(p, s, 8 * NT, sizeof(T));
  auto kernel = roi_patch_bwd_kernel<T, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  dim3 grid(n, (c + kBCT - 1) / kBCT, batch);
  kernel<<<grid, kThreads, L.total, stream>>>(static_cast<const T*>(g), starts, wy, wx, acc, n,
                                              htot, wm, c, p, s, n_classes, vec);
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
  if (s > kMaxS || p > kMaxP || batch > 65535 || (c + kBCT - 1) / kBCT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  const float* wyp = static_cast<const float*>(wy);
  const float* wxp = static_cast<const float*>(wx);
  float* ap = static_cast<float*>(acc);
#define D2_BWD(T)                                                                              \
  return s <= 8 ? launch_bwd<T, 1>(g, sp, wyp, wxp, ap, batch, n, htot, wm, c, p, s, n_classes, \
                                   st)                                                         \
                : launch_bwd<T, 2>(g, sp, wyp, wxp, ap, batch, n, htot, wm, c, p, s, n_classes, \
                                   st)
  if (dtype == 0) D2_BWD(float);
  if (dtype == 1) D2_BWD(__nv_bfloat16);
#undef D2_BWD
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
  return launch_dtype<kFull>(plane, starts, wy, wx, out, batch, n, htot, wm, c, p, s,
                             n_classes, dtype, stream);
}

// roi_patch_fwd_launch with the ablation `variant` (enum Variant above:
// 0 full, 1 nodma, 2 onedma, 3 nodot, 4 m1only, 5 noswap, 6 nowrite).
extern "C" int roi_patch_variant_launch(const void* plane, const void* starts,
                                        const void* wy, const void* wx, void* out,
                                        int batch, int n, int htot, int wm, int c,
                                        int p, int s, int n_classes, int dtype,
                                        int variant, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return (int)cudaGetLastError();
  if (s > kMaxS || p > kMaxP || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
#define D2_VARIANT(V)                                                                   \
  case V:                                                                               \
    return launch_dtype<V>(plane, starts, wy, wx, out, batch, n, htot, wm, c, p, s,     \
                           n_classes, dtype, stream);
  switch (variant) {
    D2_VARIANT(kFull)
    D2_VARIANT(kNoDma)
    D2_VARIANT(kOneDma)
    D2_VARIANT(kNoDot)
    D2_VARIANT(kM1Only)
    D2_VARIANT(kNoSwap)
    D2_VARIANT(kNoWrite)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef D2_VARIANT
}
