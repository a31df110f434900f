// Sparse 3-D convolution over a packed window rulebook, for sm_90a.
//
// Replaces det3d_tpu/ops/band_conv.py::band_window_conv (the Pallas TPU
// kernel _band_kernel). The TPU kernel fetches rows through one-hot
// matmuls over a DMA'd band of ranks because the TPU has no per-lane
// gather; on Hopper a gather is cheap, so this kernel gathers directly and
// needs no band: it reads the packed plan words as they are.
//
// Function (ops/sparse.py::window_conv_ref is the plain version):
//   features x (B, V, Cin) fp32 or bf16; packed (B, O, K) int32 words
//   r0 | pres << 24; weights w (kz*K, Cin, Cout) z-major, the features'
//   type; out (B, O, Cout) fp32.
//   out[o] = sum over columns k, taps j with pres[o,k,j] of
//            x[row] @ w[j*K + k], row = min(r0, V-1) + popcount(pres[0:j]),
//   rows >= V reading zero. With center_shift (submanifold convs, O == V)
//   the center column k = K/2 reads rows o-1, o, o+1 instead.
//
// Design: one block of 256 threads owns a tile of TO output rows of one
// sample and all COUT output channels. Thread (r, g) keeps RPT x CPT fp32
// accumulators: rows r, r + S, ..., r + (RPT-1) S (S = 256 / G thread rows,
// G = COUT / CPT channel groups) and channels [g*CPT, (g+1)*CPT), CPT = 8.
// For each tap the block gathers the TO input rows into shared memory
// (fp32, zeros where absent) and stages the tap's (Cin, COUT) weight slice
// beside them; then every thread runs a Cin-long loop that reads RPT row
// values and two float4 weight vectors and issues RPT x CPT fused
// multiply-adds. A tap that no row of the tile has is skipped. Each output
// row is written once.
//
// Bound: at SECOND's shapes the useful work is a few GFLOP per conv and
// the bytes are a few MB, so the ideal is microseconds. This kernel runs
// on the fp32 CUDA cores and is limited by shared-memory reads (RPT + 2
// per RPT x 8 FMAs) and by gathering each tap's rows anew through shared
// memory. Tensor-core tiles (mma / wgmma) over the gathered rows and TMA
// staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCpt = 8;                 // output channels per thread
constexpr int kPackShift = 24;
constexpr unsigned kPackMask = (1u << kPackShift) - 1u;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int COUT>
struct Tile {
  static constexpr int G = COUT / kCpt;           // channel groups
  static constexpr int S = kThreads / G;          // thread rows
  static constexpr int RPT = COUT / 16;          // rows per thread
  static constexpr int TO = S * RPT;              // output rows per block
};

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
window_conv_kernel(const T* __restrict__ x, const int32_t* __restrict__ packed,
                   const T* __restrict__ w, float* __restrict__ out,
                   int V, int O, int K, int kz, int cin, int center_shift) {
  using Tl = Tile<COUT>;
  constexpr int G = Tl::G, S = Tl::S, RPT = Tl::RPT, TO = Tl::TO;
  extern __shared__ __align__(16) float smem[];
  const int ldx = cin | 1;              // odd row stride: no bank conflicts
  float* xs = smem;                     // (TO, ldx) gathered rows
  float* ws = xs + ((TO * ldx + 3) & ~3);   // (cin, COUT), 16-byte aligned
  int* word = reinterpret_cast<int*>(ws + cin * COUT);   // (TO,)
  int* src = word + TO;                                  // (TO,)

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TO;
  const int tid = threadIdx.x;
  const int r = tid / G;
  const int g = tid % G;
  const int cc = K / 2;
  const T* xb = x + static_cast<size_t>(b) * V * cin;

  float acc[RPT][kCpt];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int q = 0; q < kCpt; ++q) acc[i][q] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();                    // word[] is still read below
    for (int t = tid; t < TO; t += kThreads) {
      const int o = o0 + t;
      word[t] = o < O ? packed[(static_cast<size_t>(b) * O + o) * K + k]
                      : 0;              // absent: no present bit
    }
    __syncthreads();
    const bool center = center_shift && k == cc;
    for (int j = 0; j < kz; ++j) {
      int have = 0;
      for (int t = tid; t < TO; t += kThreads) {
        const unsigned wd = static_cast<unsigned>(word[t]);
        const unsigned pres = wd >> kPackShift;
        int row = -1;
        if ((pres >> j) & 1u) {
          if (center) {
            row = o0 + t + j - 1;
          } else {
            const int r0 = min(static_cast<int>(wd & kPackMask), V - 1);
            row = r0 + __popc(pres & ((1u << j) - 1u));
          }
          if (row < 0 || row >= V) row = -1;
        }
        src[t] = row;
        have |= row >= 0;
      }
      if (!__syncthreads_or(have)) continue;   // no row of the tile has it
      for (int i = tid; i < TO * cin; i += kThreads) {
        const int rr = i / cin, c = i - rr * cin;
        const int s = src[rr];
        xs[rr * ldx + c] =
            s >= 0 ? to_float(xb[static_cast<size_t>(s) * cin + c]) : 0.f;
      }
      const T* wt = w + static_cast<size_t>(j * K + k) * cin * COUT;
      for (int i = tid; i < cin * COUT; i += kThreads) ws[i] = to_float(wt[i]);
      __syncthreads();
      const float* xr = xs + r * ldx;
      const float* wg = ws + g * kCpt;
      for (int c = 0; c < cin; ++c) {
        const float4 w0 = *reinterpret_cast<const float4*>(wg + c * COUT);
        const float4 w1 = *reinterpret_cast<const float4*>(wg + c * COUT + 4);
        const float wv[kCpt] = {w0.x, w0.y, w0.z, w0.w,
                                w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = xr[i * S * ldx + c];
#pragma unroll
          for (int q = 0; q < kCpt; ++q) acc[i][q] = fmaf(a, wv[q], acc[i][q]);
        }
      }
      __syncthreads();                  // before xs/ws/src are overwritten
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int o = o0 + r + i * S;
    if (o < O) {
      float4* dst = reinterpret_cast<float4*>(
          out + (static_cast<size_t>(b) * O + o) * COUT + g * kCpt);
      dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <typename T, int COUT>
int launch(const void* x, const void* packed, const void* w, void* out,
           int B, int V, int O, int K, int kz, int cin, int center_shift,
           cudaStream_t stream) {
  constexpr int TO = Tile<COUT>::TO;
  const size_t smem = (((static_cast<size_t>(TO) * (cin | 1) + 3) & ~3) +
                       static_cast<size_t>(cin) * COUT) * sizeof(float) +
                      2 * TO * sizeof(int);
  auto kern = window_conv_kernel<T, COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((O + TO - 1) / TO, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(packed),
      static_cast<const T*>(w), static_cast<float*>(out), V, O, K, kz, cin,
      center_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* packed, const void* w, void* out,
             int B, int V, int O, int K, int kz, int cin, int cout,
             int center_shift, cudaStream_t stream) {
  switch (cout) {
    case 16: return launch<T, 16>(x, packed, w, out, B, V, O, K, kz, cin,
                                  center_shift, stream);
    case 32: return launch<T, 32>(x, packed, w, out, B, V, O, K, kz, cin,
                                  center_shift, stream);
    case 64: return launch<T, 64>(x, packed, w, out, B, V, O, K, kz, cin,
                                  center_shift, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The wrapper
// (ops/window_conv_cuda.py) checks shapes, types and the supported COUT
// values {16, 32, 64} (SECOND's middle) before calling.
extern "C" int window_conv_launch(const void* x, const void* packed,
                                  const void* w, void* out, int B, int V,
                                  int O, int K, int kz, int cin, int cout,
                                  int center_shift, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, packed, w, out, B, V, O, K, kz, cin,
                                   cout, center_shift, s);
  return dispatch<float>(x, packed, w, out, B, V, O, K, kz, cin, cout,
                         center_shift, s);
}
