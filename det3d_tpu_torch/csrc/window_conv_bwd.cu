// The window convolution's backward in fp32, for sm_90a: d(weights) of
// every window conv, and d(features) of a strided one over its inverse
// rulebook. (A submanifold conv's d(features) is the forward kernel of
// window_conv.cu run over dY with mirrored, transposed weights.)
//
// Replaces the JAX package's XLA backward of the window conv, which has no
// Pallas kernel: det3d_tpu/ops/sparse.py::_window_conv_dw (and the dW half
// of _window_conv_bwd_fused) and _strided_inverse_df, the custom VJPs of
// apply_conv_window and apply_conv_window_inv. The plain versions are
// ops/sparse.py::window_conv_dw_ref and window_conv_inv_ref; the wrappers
// ops/window_conv_cuda.py::window_conv_dw and window_conv_inv.
//
// Bound: each does the products of the forward at its layer over the same
// (row, tap) pairs, 2 Cin Cout flops a pair, on the fp32 CUDA cores (67
// TFLOP/s on the H100; the tensor cores would compute fp32 as TF32 and
// change the results), which at the middles' shapes lie above the bytes:
// operations bound. dW's bytes also count its workspace written and read
// back once. Both kernels are the simple first versions: what separates
// them from that bound is in PERF.md.
//
// dW, window_conv_dw_kernel + window_conv_dw_sum_kernel:
//   dW[t] (Cin, Cout) = sum over output rows o (all B*O) with tap t
//   present of x[src_t(o)]^T dy[o], t = j*K + k z-major; src as in the
//   forward (min(r0, V-1) + popcount(pres[0:j]), the center column's
//   o + j - 1 with center_shift, rows outside [0, V) absent). The sum runs
//   over every row of the batch, across blocks. No atomics: block (c, t)
//   sums tap t over chunk c of the rows into its own slice of a workspace
//   (nchunks, kvol, Cin, Cout) that the wrapper allocates, and a second
//   kernel sums the slices in chunk order. Every sum has a fixed order, so
//   two calls give the same bits, and a captured step the eager step's.
//   A block walks its chunk in tiles of 64 rows: the first two warps find
//   each row's source row and compact the present ones (ballots), the
//   block copies their x rows (Cin zero-padded to 4) and dy rows into
//   shared memory, and each thread accumulates 4 x 4 blocks of dW[t] in
//   registers (BPT of them where Cin*Cout > 4096; where it is smaller, S
//   slices of threads split the rows and add their blocks in slice order
//   at the end).
//
// dX of a strided conv, window_conv_inv_kernel, over the packed inverse
//   rulebook (B, V, Kc) (bits 0..23 r0i, 24.. the ncz candidate bits,
//   28..30 the row's (z, y, x) stride parities, read from column 0):
//     dX[q] = sum over taps kk = (jz, jy, jx) with j mod s == par(q) per
//             dim of dy[row_kk(q)] @ W[kk]^T,
//   row_kk(q) = min(r0i, O-1) + popcount(pres[0:m]) of candidate column
//   ci = (jy / sy) * ncx + jx / sx, window tap m = ncz-1-jz/sz, present
//   where pres bit m is set and the row lies below O. The weight a row
//   needs depends on its parity, and the 27 fp32 weight slices of a
//   (64, 64) conv take 442 KB, more than a block's shared memory: so a
//   block owns 128 rows and walks the taps one at a time, staging tap kk's
//   slice (transposed) and the dy rows of the rows whose parity matches
//   (compacted by ballots), and adds their products into the rows' sums,
//   which stay in shared memory for the whole walk. Each row's sum takes
//   the taps in order: no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackShift = 24;
constexpr unsigned kPackMask = (1u << kPackShift) - 1u;
constexpr int kParShift = 28;
constexpr int kThreads = 256;
constexpr int kDwTile = 64;      // dW: output rows staged per pass
constexpr int kInvTile = 128;    // dX: input rows a block owns

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Compacts the present rows of a tile: warps 0 .. TILE/32-1 each hold one
// candidate row a lane (present where a >= 0); the present rows' (a, b)
// go to list_a / list_b in row order. Every thread of the block must call
// it. Returns the number of present rows.
template <int TILE>
__device__ __forceinline__ int compact(int a, int b, int* list_a, int* list_b,
                                       int* counts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned mask = 0;
  if (tid < TILE) {
    mask = __ballot_sync(0xffffffffu, a >= 0);
    if (lane == 0) counts[warp] = __popc(mask);
  }
  __syncthreads();
  int n = 0, before = 0;
  for (int w = 0; w < TILE / 32; ++w) {
    if (w < warp) before += counts[w];
    n += counts[w];
  }
  if (tid < TILE && a >= 0) {
    const int pos = before + __popc(mask & ((1u << lane) - 1u));
    list_a[pos] = a;
    list_b[pos] = b;
  }
  __syncthreads();
  return n;
}

// --------------------------------------------------------------------------
// dW
// --------------------------------------------------------------------------

// Block (chunk c, tap t): ws[c][t] = sum over the chunk's rows of
// x[src]^T dy[o]. BPT: 4 x 4 blocks of dW a thread (nb = Cin/4 * Cout/4
// blocks; BPT = 1 with S = 256 / nb row slices where nb < 256).
template <int BPT>
__global__ void __launch_bounds__(kThreads)
window_conv_dw_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ packed,
                      const float* __restrict__ dy, float* __restrict__ ws,
                      int V, int O, int rows, int K, int cin, int cout,
                      int center_shift, int chunk, int slices) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_x[kDwTile], s_o[kDwTile], s_counts[kDwTile / 32];
  const int cinp = (cin + 3) & ~3;
  const int lx = cinp + 4, ly = cout + 4;     // row strides, in floats
  float* xs = smem;                           // (kDwTile, lx)
  float* ys = smem + kDwTile * lx;            // (kDwTile, ly)

  const int tid = threadIdx.x;
  const int t = blockIdx.y, k = t % K, j = t / K;
  const bool center = center_shift && k == K / 2;
  const int c4n = cinp / 4, d4n = cout / 4, nb = c4n * d4n;
  const int slice = tid / nb;                 // BPT == 1 only
  const bool active = BPT > 1 || slice < slices;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, rows);

  float acc[BPT][4][4];
#pragma unroll
  for (int q = 0; q < BPT; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][r][c] = 0.f;

  for (int base = begin; base < end; base += kDwTile) {
    // the source row of each output row of the tile, or -1
    int src = -1, g = base + tid;
    if (tid < kDwTile && g < end) {
      const int b = g / O, o = g - b * O;
      const unsigned wd = static_cast<unsigned>(packed[g * K + k]);
      const unsigned pres = wd >> kPackShift;
      if ((pres >> j) & 1u) {
        const int row = center ? o + j - 1
                               : min(static_cast<int>(wd & kPackMask), V - 1) +
                                     __popc(pres & ((1u << j) - 1u));
        if (row >= 0 && row < V) src = b * V + row;
      }
    }
    const int n = compact<kDwTile>(src, g, s_x, s_o, s_counts);
    if (n == 0) continue;
    for (int e = tid; e < n * cinp; e += kThreads) {
      const int i = e / cinp, c = e - i * cinp;
      xs[i * lx + c] = c < cin ? x[static_cast<size_t>(s_x[i]) * cin + c]
                               : 0.f;
    }
    for (int e = tid; e < n * d4n; e += kThreads) {
      const int i = e / d4n, d = (e - i * d4n) * 4;
      st4(ys + i * ly + d, ld4(dy + static_cast<size_t>(s_o[i]) * cout + d));
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int q = 0; q < BPT; ++q) {
        const int blk = BPT > 1 ? tid + q * kThreads : tid % nb;
        if (blk < nb) {
          const int c0 = (blk / d4n) * 4, d0 = (blk % d4n) * 4;
          const int step = BPT > 1 ? 1 : slices;
          for (int i = BPT > 1 ? 0 : slice; i < n; i += step) {
            const float4 xv = ld4(xs + i * lx + c0);
            const float4 yv = ld4(ys + i * ly + d0);
            const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
            const float yr[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[q][r][c] = fmaf(xr[r], yr[c], acc[q][r][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = ws + (static_cast<size_t>(blockIdx.x) * gridDim.y + t) *
                        static_cast<size_t>(cin) * cout;
  if (BPT == 1 && slices > 1) {
    // slices add their blocks in slice order, through shared memory
    float* red = smem;                        // (slices, nb, 16)
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[(slice * nb + tid % nb) * 16 + r * 4 + c] = acc[0][r][c];
    }
    __syncthreads();
    if (tid < nb) {
      for (int s = 1; s < slices; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[0][r][c] += red[(s * nb + tid) * 16 + r * 4 + c];
    }
  }
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    // with BPT == 1, thread tid < nb holds block tid's sum over slices
    const int blk = BPT > 1 ? tid + q * kThreads : tid;
    if (blk >= nb) continue;
    const int c0 = (blk / d4n) * 4, d0 = (blk % d4n) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (c0 + r < cin)
        st4(out + static_cast<size_t>(c0 + r) * cout + d0,
            make_float4(acc[q][r][0], acc[q][r][1], acc[q][r][2],
                        acc[q][r][3]));
  }
}

// dw[e] = sum over chunks c, in order, of ws[c][e].
__global__ void __launch_bounds__(kThreads)
window_conv_dw_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                          int nchunks, int n) {
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += ws[static_cast<size_t>(c) * n + e];
    dw[e] = s;
  }
}

// --------------------------------------------------------------------------
// dX of a strided conv over the inverse rulebook
// --------------------------------------------------------------------------

struct InvGeom {
  int kz, ky, kx;       // kernel
  int sz, sy, sx;       // stride (1 or 2)
  int ncz, ncx, kc;     // candidates: z, x, BEV columns
};

__global__ void __launch_bounds__(kThreads)
window_conv_inv_kernel(const float* __restrict__ dy,
                       const int32_t* __restrict__ inv,
                       const float* __restrict__ w, float* __restrict__ dx,
                       int rows, int V, int O, int cin, int cout, InvGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_i[kInvTile], s_y[kInvTile], s_counts[kInvTile / 32];
  const int la = cin + 4, ly = cout + 4, lw = cin + 4;
  float* acc = smem;                          // (kInvTile, la)
  float* ys = acc + kInvTile * la;            // (kInvTile, ly)
  float* wt = ys + kInvTile * ly;             // (cout, lw): W[kk]^T

  const int tid = threadIdx.x;
  const int base = blockIdx.x * kInvTile;
  const int c4n = cin / 4, d4n = cout / 4;
  for (int e = tid; e < kInvTile * c4n; e += kThreads) {
    const int i = e / c4n, c = (e - i * c4n) * 4;
    st4(acc + i * la + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  // this thread's row: its batch, parities and inverse words' offset
  const int q = base + tid;
  const bool mine = tid < kInvTile && q < rows;
  int b = 0, pz = 0, py = 0, px = 0;
  if (mine) {
    b = q / V;
    const unsigned w0 = static_cast<unsigned>(inv[static_cast<size_t>(q) *
                                                  g.kc]);
    pz = (w0 >> kParShift) & 1u;
    py = (w0 >> (kParShift + 1)) & 1u;
    px = (w0 >> (kParShift + 2)) & 1u;
  }

  const int kvol = g.kz * g.ky * g.kx;
  for (int kk = 0; kk < kvol; ++kk) {
    const int jz = kk / (g.ky * g.kx), jy = (kk / g.kx) % g.ky,
              jx = kk % g.kx;
    // the dy row tap kk brings to this thread's row, or -1
    int src = -1;
    if (mine && jz % g.sz == pz && jy % g.sy == py && jx % g.sx == px) {
      const int ci = (jy / g.sy) * g.ncx + jx / g.sx;
      const int m = g.ncz - 1 - jz / g.sz;
      const unsigned wd = static_cast<unsigned>(
          inv[static_cast<size_t>(q) * g.kc + ci]);
      const unsigned pres = (wd >> kPackShift) & ((1u << g.ncz) - 1u);
      if ((pres >> m) & 1u) {
        const int row = min(static_cast<int>(wd & kPackMask), O - 1) +
                        __popc(pres & ((1u << m) - 1u));
        if (row < O) src = b * O + row;
      }
    }
    const int n = compact<kInvTile>(src, tid, s_y, s_i, s_counts);
    if (n == 0) continue;
    const float* wk = w + static_cast<size_t>(kk) * cin * cout;
    for (int e = tid; e < cin * cout; e += kThreads) {
      const int c = e / cout, d = e - c * cout;
      wt[d * lw + c] = wk[e];
    }
    for (int e = tid; e < n * d4n; e += kThreads) {
      const int i = e / d4n, d = (e - i * d4n) * 4;
      st4(ys + i * ly + d, ld4(dy + static_cast<size_t>(s_y[i]) * cout + d));
    }
    __syncthreads();
    for (int e = tid; e < n * c4n; e += kThreads) {
      const int i = e / c4n, c = (e - i * c4n) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* yr = ys + i * ly;
      for (int d = 0; d < cout; ++d) {
        const float yv = yr[d];
        const float4 wv = ld4(wt + d * lw + c);
        a.x = fmaf(yv, wv.x, a.x);
        a.y = fmaf(yv, wv.y, a.y);
        a.z = fmaf(yv, wv.z, a.z);
        a.w = fmaf(yv, wv.w, a.w);
      }
      float* ar = acc + s_i[i] * la + c;
      const float4 old = ld4(ar);
      st4(ar, make_float4(old.x + a.x, old.y + a.y, old.z + a.z,
                          old.w + a.w));
    }
    __syncthreads();
  }
  for (int e = tid; e < kInvTile * c4n; e += kThreads) {
    const int i = e / c4n, c = (e - i * c4n) * 4;
    if (base + i < rows)
      st4(dx + static_cast<size_t>(base + i) * cin + c, ld4(acc + i * la + c));
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// Lets kern use smem bytes of dynamic shared memory on the current device,
// set once per kernel, device and size (see window_conv.cu::allow_smem),
// so that a launch inside a CUDA graph capture makes no other CUDA call.
template <int ID>
cudaError_t allow_smem(const void* kern, size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

template <int BPT>
int launch_dw(const float* x, const int32_t* packed, const float* dy,
              float* ws, int B, int V, int O, int K, int kz, int cin,
              int cout, int center_shift, int chunk, int nchunks,
              cudaStream_t stream) {
  const int cinp = (cin + 3) & ~3;
  const int nb = cinp / 4 * (cout / 4);
  const int slices = BPT > 1 ? 1 : kThreads / nb;
  const size_t tiles = static_cast<size_t>(kDwTile) *
                       ((cinp + 4) + (cout + 4));
  const size_t red = BPT == 1 && slices > 1
                         ? static_cast<size_t>(slices) * nb * 16
                         : 0;
  const size_t smem = (tiles > red ? tiles : red) * sizeof(float);
  auto kern = window_conv_dw_kernel<BPT>;
  cudaError_t err = allow_smem<BPT>(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(nchunks, kz * K);
  kern<<<grid, kThreads, smem, stream>>>(x, packed, dy, ws, V, O, B * O, K,
                                         cin, cout, center_shift, chunk,
                                         slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d(weights), first pass: ws (nchunks, kz*K, Cin, Cout) per-chunk
// partials. Returns the cudaError_t of the launch (0 on success). The
// wrapper (ops/window_conv_cuda.py::window_conv_dw) checks shapes, types,
// 16-byte alignment, Cin 1-128 and Cout a multiple of 4 up to 128, and
// picks chunk (a multiple of 64 rows) and nchunks = ceil(B*O / chunk).
extern "C" int window_conv_dw_launch(const void* x, const void* packed,
                                     const void* dy, void* ws, int B, int V,
                                     int O, int K, int kz, int cin, int cout,
                                     int center_shift, int chunk, int nchunks,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = ((cin + 3) & ~3) / 4 * (cout / 4);
  const float* xf = static_cast<const float*>(x);
  const int32_t* pk = static_cast<const int32_t*>(packed);
  const float* dyf = static_cast<const float*>(dy);
  float* wsf = static_cast<float*>(ws);
  if (nb <= kThreads)
    return launch_dw<1>(xf, pk, dyf, wsf, B, V, O, K, kz, cin, cout,
                        center_shift, chunk, nchunks, s);
  if (nb <= 2 * kThreads)
    return launch_dw<2>(xf, pk, dyf, wsf, B, V, O, K, kz, cin, cout,
                        center_shift, chunk, nchunks, s);
  if (nb <= 4 * kThreads)
    return launch_dw<4>(xf, pk, dyf, wsf, B, V, O, K, kz, cin, cout,
                        center_shift, chunk, nchunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// d(weights), second pass: dw[e] = sum over c < nchunks of ws[c][e], for
// e < n = kz*K*Cin*Cout.
extern "C" int window_conv_dw_sum_launch(const void* ws, void* dw, int nchunks,
                                         int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  window_conv_dw_sum_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), nchunks, n);
  return static_cast<int>(cudaGetLastError());
}

// d(features) of a strided conv over its packed inverse rulebook (B, V,
// Kc): dx (B, V, Cin). Returns the cudaError_t of the launch. The wrapper
// (ops/window_conv_cuda.py::window_conv_inv) checks shapes, types,
// 16-byte alignment, Cin and Cout multiples of 4 up to 128, a kernel of at
// most 3 and strides of 1 or 2 a dim (ncand <= 2).
extern "C" int window_conv_inv_launch(const void* dy, const void* inv,
                                      const void* w, void* dx, int B, int V,
                                      int O, int cin, int cout, int kz,
                                      int ky, int kx, int sz, int sy, int sx,
                                      int ncz, void* stream) {
  InvGeom g;
  g.kz = kz;
  g.ky = ky;
  g.kx = kx;
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  g.ncz = ncz;
  g.ncx = (kx + sx - 1) / sx;
  g.kc = ((ky + sy - 1) / sy) * g.ncx;
  const size_t smem = (static_cast<size_t>(kInvTile) * ((cin + 4) + (cout + 4)) +
                       static_cast<size_t>(cout) * (cin + 4)) *
                      sizeof(float);
  auto kern = window_conv_inv_kernel;
  cudaError_t err = allow_smem<0>(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * V;
  kern<<<(rows + kInvTile - 1) / kInvTile, kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const int32_t*>(inv),
      static_cast<const float*>(w), static_cast<float*>(dx), rows, V, O, cin,
      cout, g);
  return static_cast<int>(cudaGetLastError());
}
