// Greedy rotated-box NMS keep mask for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel det3d_tpu/ops/nms_pallas.py::_nms_kernel
// (reached through rotated_nms_keep, nms_pallas.py:89). Same function: for
// boxes already sorted by descending score, box j is dropped when a kept
// box i < j overlaps it with IoU > thr and both are valid.
//
// What bounds it. K boxes give K*K/2 pairs; each pair IoU is the
// Liang-Barsky clip of 8 edges against 4 half-planes, about 250 flops with
// 32 divisions. At K = 1000 and N = 8 samples that is ~4M pair IoUs and
// ~1 GFLOP of fp32 work against 256 KB of input: the mask pass is compute
// bound. The greedy pass is a sequential dependence chain over K rows.
//
// Why it is shaped so. The TPU kernel keeps a (K, K) f32 suppression
// matrix in VMEM and resolves the greedy order as a matvec fixpoint on the
// MXU. Hopper has neither the VMEM nor a reason for the fixpoint, so this
// is the bitmask form of the reference CUDA kernel (Det3D
// ops/nms/nms_gpu.py:420):
//   (a) nms_mask_kernel: grid (N, ceil(K/64), ceil(K/64)), 64 threads. The
//       column block's corners and areas are staged in shared memory; each
//       thread computes its row's IoU against the 64 columns and writes one
//       64-bit word of suppression bits. Blocks below the diagonal write 0.
//   (b) nms_scan_kernel: one warp per sample walks i = 0..K-1 in order with
//       a `removed` bitmask in shared memory; a kept row ORs its mask row in.
//       The keep set equals the TPU kernel's Jacobi fixpoint (the greedy
//       solution is unique).
// One call launches both kernels once for all N samples.
//
// Rounding. The IoU below repeats det3d_tpu/core/geometry.py::_clip_contrib
// operation for operation. Build with --fmad=false, so that no a*b - c*d is
// fused into an FMA; every operation then rounds as the plain PyTorch
// version (det3d_tpu_torch/ops/nms_cuda.py::rotated_nms_keep_ref) rounds it,
// and both give the same keep mask bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;          // boxes per row / column block
constexpr float kEps = 1e-8f;       // geometry.py::_EPS

// Shoelace contribution of quad P's edges clipped to quad Q (both CCW).
// open_side: clip against Q's open interior (geometry.py::_clip_contrib).
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
      const float b_safe = moving ? b : 1.0f;
      const float tj = -a / b_safe;
      if (moving && b > 0.0f) t_lo = fmaxf(t_lo, tj);
      if (moving && b < 0.0f) t_hi = fminf(t_hi, tj);
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

// corners: (N, K, 8) f32 CCW [x0 y0 x1 y1 x2 y2 x3 y3]; area: (N, K) f32;
// valid: (N, K) u8; mask: (N, K, col_blocks) u64.
__global__ void nms_mask_kernel(const float* __restrict__ corners,
                                const float* __restrict__ area,
                                const uint8_t* __restrict__ valid, int K,
                                int col_blocks, float thr,
                                unsigned long long* __restrict__ mask) {
  const int n = blockIdx.x;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.z;
  const int row = row_block * kBlock + threadIdx.x;
  const size_t base = static_cast<size_t>(n) * K;
  unsigned long long* out =
      mask + (base + row) * static_cast<size_t>(col_blocks) + col_block;

  if (col_block < row_block) {  // below the diagonal: no j > i here
    if (row < K) *out = 0ull;
    return;
  }

  __shared__ float s_x[kBlock][4];
  __shared__ float s_y[kBlock][4];
  __shared__ float s_area[kBlock];
  __shared__ uint8_t s_valid[kBlock];

  const int col0 = col_block * kBlock;
  const int n_cols = min(kBlock, K - col0);
  if (threadIdx.x < n_cols) {
    const float* c = corners + (base + col0 + threadIdx.x) * 8;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s_x[threadIdx.x][v] = c[2 * v];
      s_y[threadIdx.x][v] = c[2 * v + 1];
    }
    s_area[threadIdx.x] = area[base + col0 + threadIdx.x];
    s_valid[threadIdx.x] = valid[base + col0 + threadIdx.x];
  }
  __syncthreads();
  if (row >= K) return;

  unsigned long long bits = 0ull;
  if (valid[base + row]) {
    float ax[4], ay[4];
    const float* c = corners + (base + row) * 8;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      ax[v] = c[2 * v];
      ay[v] = c[2 * v + 1];
    }
    const float area_a = area[base + row];
    const int start = (col_block == row_block) ? threadIdx.x + 1 : 0;
    for (int t = start; t < n_cols; ++t) {
      if (!s_valid[t]) continue;
      const float total = clip_contrib(ax, ay, s_x[t], s_y[t], false) +
                          clip_contrib(s_x[t], s_y[t], ax, ay, true);
      const float inter = fmaxf(0.5f * total, 0.0f);
      const float uni = area_a + s_area[t] - inter;
      const float iou = uni > 0.0f ? inter / uni : 0.0f;
      if (iou > thr) bits |= 1ull << t;
    }
  }
  *out = bits;
}

// One warp per sample. keep: (N, K) u8.
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int K,
                                int col_blocks, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(n) * K;
  // invalid boxes, and the padding past K, start out removed
  for (int w = lane; w < col_blocks; w += 32) {
    unsigned long long bits = 0ull;
    for (int b = 0; b < kBlock; ++b) {
      const int i = w * kBlock + b;
      if (i >= K || !valid[base + i]) bits |= 1ull << b;
    }
    removed[w] = bits;
  }
  __syncwarp();

  const unsigned long long* m = mask + base * col_blocks;
  for (int i = 0; i < K; ++i) {
    const int w = i >> 6;
    const bool kept = !((removed[w] >> (i & 63)) & 1ull);
    __syncwarp();  // every lane has read removed[w] before any lane writes
    if (lane == 0) keep[base + i] = kept ? 1 : 0;
    if (kept) {
      const unsigned long long* row = m + static_cast<size_t>(i) * col_blocks;
      for (int v = w + lane; v < col_blocks; v += 32) removed[v] |= row[v];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() after them
// (0 on success). All pointers are device pointers; `mask` is caller-owned
// scratch of n * k * ceil(k / 64) 64-bit words.
int rotated_nms_keep_launch(const float* corners, const float* area,
                            const uint8_t* valid, int n, int k, float thr,
                            void* mask, uint8_t* keep, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const int col_blocks = (k + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  dim3 grid(n, col_blocks, col_blocks);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(corners, area, valid, k, col_blocks,
                                          thr, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<n, 32, col_blocks * sizeof(unsigned long long), s>>>(
      m, valid, k, col_blocks, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
