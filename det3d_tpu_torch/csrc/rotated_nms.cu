// Greedy rotated-box NMS keep mask for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel det3d_tpu/ops/nms_pallas.py::_nms_kernel
// (reached through rotated_nms_keep, nms_pallas.py:90). Same function: for
// boxes already sorted by descending score, box j is dropped when a kept
// box i < j overlaps it with IoU > thr and both are valid.
//
// What bounds it. Two things, one per kernel:
//   (a) the pair work: K boxes give K(K-1)/2 pairs, and a pair IoU is the
//       Liang-Barsky clip of 8 edges against 4 half-planes, ~250 fp32
//       flops with 32 divisions. Detector candidates are mostly far apart:
//       at the flagship's N=8, K=1000 only ~2.6% of the 3.6M valid pairs
//       have intersecting circumcircles. So the work these inputs need is a
//       ~10-flop distance test per valid pair plus a full IoU for the near
//       pairs: ~60 MFLOP, against 300 KB of input.
//   (b) the greedy order: box j's fate depends on every kept box before it,
//       a serial chain over K rows per sample.
//
// What the design does about each.
//   (a) nms_mask_kernel: one block of 256 threads per (sample, 64x64 tile
//       on or above the diagonal); no block is launched below it, where no
//       pair i < j lies. The prologue stages both blocks' corners, areas
//       and a circumcircle per box (centre the midpoint of corners 0 and 2,
//       radius the farthest corner from it; packed with a valid / area
//       flag into one float4) in shared memory. Every pair of the tile is
//       then culled cheaply: a pair is dropped without an IoU only when
//       both areas are > 0, thr >= 0 and the squared centre distance
//       exceeds (r_i + r_j)^2 (1 + 1e-4), the margin absorbing the test's
//       own rounding. Such boxes are disjoint, the plain twin's IoU for
//       them is exactly 0, and 0 > thr is false (tests/test_torch_nms_
//       design.py holds near_pairs, this test in PyTorch, to that). Points
//       (area 0) always take the full IoU, whose result against a box
//       depends on rounding. The surviving pairs are appended to a list in
//       shared memory (a ballot a round, one atomic a warp for its 16
//       rounds); the block's threads then take one pair each from it, so
//       no lane idles behind another's IoU. Set bits are ORed into the
//       tile's 64 row words in shared memory and stored once.
//   (b) nms_scan_kernel: one warp per sample walks its W = ceil(K/64) row
//       blocks in order. For block w it
//         - resolves the 64 rows in registers from the block's diagonal
//           words, two rows a lane: kept = open & ~(OR of the kept rows'
//           words), one warp reduction a round, iterated to its fixpoint.
//           A row's word has bits only above it, so the fixpoint is unique
//           and is the greedy set; the rounds follow the chains of
//           suppression inside the block, a few, where a row-by-row walk
//           pays a dependent shared-memory load for every kept row;
//         - ORs the kept rows' later words into `removed`, a lane per
//           word, over a list of the kept rows (independent loads);
//         - writes the block's 64 keep bytes.
//       A block's 64 rows of W words are one contiguous run of the mask; a
//       two-stage cp.async ring brings block w+1's run into shared memory
//       while block w is resolved, so no step of the chain waits on device
//       memory. Two stages of 64 * W words bound K at MAX_K = 14400 in
//       the 227 KB of shared memory a block may have.
// One call launches both kernels once for all N samples. The TPU kernel
// kept a (K, K) f32 suppression matrix in VMEM and resolved the greedy
// order as a matvec fixpoint on the MXU; the greedy solution is unique, so
// this keep set is the same.
//
// Rounding. The IoU below repeats det3d_tpu/core/geometry.py::_clip_contrib
// operation for operation. Build with --fmad=false, so that no a*b - c*d is
// fused into an FMA; every operation then rounds as the plain PyTorch
// version (det3d_tpu_torch/ops/nms_cuda.py::rotated_nms_keep_ref) rounds it,
// and both give the same keep mask bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;          // boxes per row / column block
constexpr int kThreads = 256;       // mask kernel threads per tile
constexpr int kMaxW = 225;          // row blocks at MAX_K = 14400
constexpr int kScanSmem = (2 * kBlock + 1) * kMaxW * 8;   // 232,200 bytes
constexpr float kEps = 1e-8f;       // geometry.py::_EPS
constexpr float kCullScale = 1.0001f;  // 1 + the cull's rounding margin

// Shoelace contribution of quad P's edges clipped to quad Q (both CCW).
// open_side: clip against Q's open interior (geometry.py::_clip_contrib).
// A parallel edge (!moving) computes no division: its quotient is unused.
__device__ __forceinline__ float clip_contrib(const float* px, const float* py,
                                              const float* qx, const float* qy,
                                              bool open_side) {
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x1 = px[i], y1 = py[i];
    const float x2 = px[(i + 1) & 3], y2 = py[(i + 1) & 3];
    const float dx = x2 - x1, dy = y2 - y1;
    float t_lo = 0.0f, t_hi = 1.0f;
    bool ok = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ex = qx[(j + 1) & 3] - qx[j];
      const float ey = qy[(j + 1) & 3] - qy[j];
      const float a = ex * (y1 - qy[j]) - ey * (x1 - qx[j]);
      const float b = ex * dy - ey * dx;
      const bool moving = fabsf(b) > kEps;
      if (moving) {
        const float tj = -a / b;
        if (b > 0.0f) t_lo = fmaxf(t_lo, tj);
        else t_hi = fminf(t_hi, tj);
      }
      const bool border_ok = open_side ? (a > kEps) : (a >= -kEps);
      ok = ok && (moving || border_ok);
    }
    const bool valid = ok && (t_lo < t_hi);
    const float sx1 = x1 + t_lo * dx;
    const float sy1 = y1 + t_lo * dy;
    const float sx2 = x1 + t_hi * dx;
    const float sy2 = y1 + t_hi * dy;
    total = total + (valid ? (sx1 * sy2 - sx2 * sy1) : 0.0f);
  }
  return total;
}

// One 64-box block of a tile, staged in shared memory. circ: the cull's
// operands in one 16-byte load, centre x, y, radius and a flag: 0 an
// invalid box (or past K), 1 a valid box of positive area, 2 a valid point
// (or an area that is not > 0, NaN included).
struct Boxes {
  float4 circ[kBlock];
  float x[kBlock][4], y[kBlock][4];
  float area[kBlock];
};

__device__ __forceinline__ void stage_box(Boxes& s, int b, const float* c,
                                          float area, bool valid) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    s.x[b][v] = c[2 * v];
    s.y[b][v] = c[2 * v + 1];
  }
  // circumcircle: centre between corners 0 and 2, radius to the farthest
  // corner (ops/nms_cuda.py::near_pairs repeats this in PyTorch)
  const float cx = 0.5f * (c[0] + c[4]);
  const float cy = 0.5f * (c[1] + c[5]);
  float r2 = 0.0f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float ddx = c[2 * v] - cx, ddy = c[2 * v + 1] - cy;
    r2 = fmaxf(r2, ddx * ddx + ddy * ddy);
  }
  s.area[b] = area;
  s.circ[b] = make_float4(cx, cy, sqrtf(r2),
                          valid ? (area > 0.0f ? 1.0f : 2.0f) : 0.0f);
}

// Row block rb and column block cb >= rb of upper-triangle tile t, tiles
// numbered row by row: row rb holds the W - rb tiles cb = rb .. W-1.
__device__ __forceinline__ void tile_coords(int t, int W, int& rb, int& cb) {
  const int u = W * (W + 1) / 2 - 1 - t;    // from the end: rows of 1, 2, ..
  int q = static_cast<int>((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
  while ((q + 1) * (q + 2) / 2 <= u) ++q;
  while (q * (q + 1) / 2 > u) --q;
  rb = W - 1 - q;
  cb = W - 1 - (u - q * (q + 1) / 2);
}

// corners: (N, K, 8) f32 CCW [x0 y0 x1 y1 x2 y2 x3 y3]; area: (N, K) f32;
// valid: (N, K) u8. mask: (N, 64 W, W) u64: word (n 64 W + i) W + cb
// holds row i's bits against the boxes of column block cb. Only tiles
// cb >= rb are written, rows past K too (as 0).
// grid (N, W (W + 1) / 2), kThreads threads: N on x, whose limit is
// 2^31 - 1, the tiles on y (25,425 at MAX_K); at most 40 registers, so
// that six blocks share an SM, not five (7% faster at the flagship's
// 1088 tiles on the H100).
__global__ void __launch_bounds__(kThreads, 6)
nms_mask_kernel(const float* __restrict__ corners,
                const float* __restrict__ area,
                const uint8_t* __restrict__ valid, int K, int W, float thr,
                u64* __restrict__ mask) {
  __shared__ Boxes s_box[2];                 // [0] rows, [1] columns
  __shared__ uint16_t s_list[kBlock * kBlock];
  __shared__ u64 s_bits[kBlock];
  __shared__ int s_count;

  const int n = blockIdx.x;
  int rb, cb;
  tile_coords(blockIdx.y, W, rb, cb);
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(n) * K;

  if (tid < 2 * kBlock) {
    const int side = tid / kBlock, b = tid % kBlock;
    const int i = (side ? cb : rb) * kBlock + b;
    if (i < K) {
      stage_box(s_box[side], b, corners + (base + i) * 8, area[base + i],
                valid[base + i] != 0);
    } else {
      s_box[side].circ[b].w = 0.0f;
    }
  }
  if (tid < kBlock) s_bits[tid] = 0ull;
  if (tid == 0) s_count = 0;
  __syncthreads();

  // the cull: every pair (i, j) of the tile, j > i on the diagonal tile;
  // a warp's 16 ballots, then one atomic for its run of the list
  const Boxes& R = s_box[0];
  const Boxes& C = s_box[1];
  const bool cull = thr >= 0.0f;
  const int lane = tid & 31;
  const float4 cj = C.circ[tid % kBlock];      // this thread's column
  constexpr int kRounds = kBlock * kBlock / kThreads;
  unsigned ballots[kRounds];
  int total_need = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int p = tid + k * kThreads;
    const int i = p / kBlock, j = p % kBlock;
    const float4 ci = R.circ[i];               // a broadcast
    bool need = false;
    if (ci.w != 0.0f && cj.w != 0.0f && (cb != rb || j > i)) {
      const float dx = ci.x - cj.x;
      const float dy = ci.y - cj.y;
      const float d2 = dx * dx + dy * dy;
      const float s = ci.z + cj.z;
      const bool far = cull && ci.w == 1.0f && cj.w == 1.0f &&
                       d2 > s * s * kCullScale;
      need = !far;
    }
    ballots[k] = __ballot_sync(0xffffffffu, need);
    total_need += __popc(ballots[k]);
  }
  int at = 0;
  if (lane == 0 && total_need) at = atomicAdd(&s_count, total_need);
  at = __shfl_sync(0xffffffffu, at, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if ((ballots[k] >> lane) & 1u)
      s_list[at + __popc(ballots[k] & below)] =
          static_cast<uint16_t>(tid + k * kThreads);
    at += __popc(ballots[k]);
  }
  __syncthreads();

  // the full IoU of each near pair, one pair a thread
  const int count = s_count;
  for (int e = tid; e < count; e += kThreads) {
    const int p = s_list[e];
    const int i = p / kBlock, j = p % kBlock;
    float ax[4], ay[4], bx[4], by[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      ax[v] = R.x[i][v];
      ay[v] = R.y[i][v];
      bx[v] = C.x[j][v];
      by[v] = C.y[j][v];
    }
    const float total = clip_contrib(ax, ay, bx, by, false) +
                        clip_contrib(bx, by, ax, ay, true);
    const float inter = fmaxf(0.5f * total, 0.0f);
    const float uni = R.area[i] + C.area[j] - inter;
    const float iou = uni > 0.0f ? inter / uni : 0.0f;
    if (iou > thr) atomicOr(&s_bits[i], 1ull << j);
  }
  __syncthreads();
  if (tid < kBlock)
    mask[(static_cast<size_t>(n) * W * kBlock + rb * kBlock + tid) * W + cb] =
        s_bits[tid];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ unsigned or_lanes(unsigned x) {
  return __reduce_or_sync(0xffffffffu, x);
}

// Bits of block w's 64 rows that start out removed: invalid rows and the
// padding past K. Every lane gets the word.
__device__ __forceinline__ u64 invalid_bits(bool lo_ok, bool hi_ok) {
  const unsigned lo = __ballot_sync(0xffffffffu, !lo_ok);
  const unsigned hi = __ballot_sync(0xffffffffu, !hi_ok);
  return static_cast<u64>(lo) | (static_cast<u64>(hi) << 32);
}

// One warp per sample. mask: as nms_mask_kernel writes it; keep: (N, K) u8.
// Dynamic shared memory: two stages of 64 * W words, then removed[W].
__global__ void __launch_bounds__(32)
nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                int K, int W, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ uint8_t kept_rows[kBlock];     // bytes: 232,264 in all at MAX_K
  u64* ring = smem;                          // 2 * 64 * W words
  u64* removed = smem + 2 * kBlock * W;      // W words
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(n) * K;
  const u64* m = mask + static_cast<size_t>(n) * W * W * kBlock;

  // block w's 64 rows of W words: one contiguous run
  auto issue = [&](int w) {
    u64* dst = ring + (w & 1) * kBlock * W;
    const u64* src = m + static_cast<size_t>(w) * kBlock * W;
    const int pieces = kBlock * W / 2;                // 16 bytes each
    for (int e = lane; e < pieces; e += 32) cp_async16(dst + 2 * e, src + 2 * e);
    cp_async_commit();
  };
  auto valid_at = [&](int row) {
    return row < K && valid[base + row] != 0;
  };

  issue(0);
  for (int v = lane; v < W; v += 32) removed[v] = 0ull;
  bool lo_ok = valid_at(lane), hi_ok = valid_at(32 + lane);

  for (int w = 0; w < W; ++w) {
    u64 cur = invalid_bits(lo_ok, hi_ok);
    if (w + 1 < W) {
      issue(w + 1);
      lo_ok = valid_at((w + 1) * kBlock + lane);
      hi_ok = valid_at((w + 1) * kBlock + 32 + lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const u64* st = ring + (w & 1) * kBlock * W;   // [row b][word v]
    cur |= removed[w];

    // (b) the block's greedy keep set: the fixpoint of kept = open & ~(OR
    // of the kept rows' diagonal words), each OR a warp reduction over the
    // lanes' rows lane and 32 + lane. A row's word has bits only above it,
    // so row b is final after b + 1 rounds at most; the first round that
    // changes nothing has reached the unique fixpoint, the greedy set.
    const u64 d_lo = st[lane * W + w], d_hi = st[(32 + lane) * W + w];
    const u64 open = ~cur;
    u64 kept = open;
    for (int round = 0; round <= kBlock; ++round) {
      const u64 x = (((kept >> lane) & 1ull) ? d_lo : 0ull) |
                    (((kept >> (32 + lane)) & 1ull) ? d_hi : 0ull);
      const u64 sup = static_cast<u64>(or_lanes(static_cast<unsigned>(x))) |
                      (static_cast<u64>(or_lanes(
                           static_cast<unsigned>(x >> 32))) << 32);
      const u64 next = open & ~sup;
      if (next == kept) break;   // kept is the same in every lane
      kept = next;
    }

    // (c) the kept rows' later words, a lane per word, over a list of the
    // kept rows (independent loads, not a walk over the bits)
    const int n_kept = __popcll(kept);
    const u64 below = (1ull << lane) - 1ull;
    if ((kept >> lane) & 1ull) kept_rows[__popcll(kept & below)] = lane;
    if ((kept >> (32 + lane)) & 1ull)
      kept_rows[__popcll(kept & ((below << 32) | 0xffffffffull))] = 32 + lane;
    __syncwarp();
    for (int v = w + 1 + lane; v < W; v += 32) {
      u64 acc = 0ull;
#pragma unroll 8
      for (int t = 0; t < n_kept; ++t) acc |= st[kept_rows[t] * W + v];
      removed[v] |= acc;
    }

    // (d) the block's keep bytes
    const int r0 = w * kBlock + lane;
    if (r0 < K) keep[base + r0] = (kept >> lane) & 1ull;
    if (r0 + 32 < K) keep[base + r0 + 32] = (kept >> (32 + lane)) & 1ull;
    __syncwarp();   // stage w & 1 and removed[] read before they change
  }
}

}  // namespace

extern "C" {

// Largest K a launch takes: two stages of 64 x ceil(K / 64) mask words fit
// the scan's shared memory.
int rotated_nms_max_k() { return kMaxW * kBlock; }

// Launches both kernels on `stream`; returns cudaGetLastError() after them
// (0 on success), cudaErrorInvalidValue for K above rotated_nms_max_k().
// All pointers are device pointers; `mask` is caller-owned scratch of
// n * W * W * 64 64-bit words, W = ceil(k / 64).
int rotated_nms_keep_launch(const float* corners, const float* area,
                            const uint8_t* valid, int n, int k, float thr,
                            void* mask, uint8_t* keep, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (k > kMaxW * kBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (k + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* m = static_cast<u64*>(mask);

  static bool smem_set[64] = {};       // the scan's attribute, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && !smem_set[device]) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kScanSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }

  nms_mask_kernel<<<dim3(n, W * (W + 1) / 2), kThreads, 0, s>>>(
      corners, area, valid, k, W, thr, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(2 * kBlock + 1) * W * 8;
  nms_scan_kernel<<<n, 32, smem, s>>>(m, valid, k, W, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
