// The window convolution's backward in fp32, for sm_90a: d(weights) of
// every window conv, and d(features) of a strided one over its inverse
// rulebook. (A submanifold conv's d(features) is the forward kernel of
// window_conv.cu run over dY with mirrored, transposed weights.)
//
// Replaces the JAX package's XLA backward of the window conv, which has no
// Pallas kernel: det3d_tpu/ops/sparse.py:883 _window_conv_dw (and the dW
// half of _window_conv_bwd_fused) and :1033 _strided_inverse_df, the
// custom VJPs of apply_conv_window and apply_conv_window_inv. The plain
// versions are ops/sparse.py::window_conv_dw_ref and window_conv_inv_ref;
// the wrappers ops/window_conv_cuda.py::window_conv_dw and
// window_conv_inv, whose CPU models of the schedules below (dw_geometry,
// dw_chunks, dw_grid, inv_geometry, inverse_classes, inverse_blocks)
// the tests hold to these kernels.
//
// Bound: each does the products of the forward at its layer over the same
// (row, tap) pairs, 2 Cin Cout flops a pair, on the fp32 CUDA cores (67
// TFLOP/s on the H100; the tensor cores would compute fp32 as TF32 and
// change the results). At the middles' widths from (32, 32) up that lies
// above the bytes (each input read once, each output written once):
// operations bound; the stems and the (16, 32) convs are bytes bound.
// Both kernels keep every sum in a fixed order: no atomics, two calls give
// the same bits, and a captured step the eager step's.
//
// dW, window_conv_dw_kernel + window_conv_dw_sum_kernel:
//   dW[t] (Cin, Cout) = sum over output rows o (all B*O) with tap t
//   present of x[src_t(o)]^T dy[o], t = j*K + k z-major; src as in the
//   forward (min(r0, V-1) + popcount(pres[0:j]), the center column's
//   o + j - 1 with center_shift, rows outside [0, V) absent).
//   Grid (chunk, tap): the rows are cut into 256-row tiles and chunk c of
//   a tap's chunks takes tiles c, c + C, c + 2C, ... (dw_chunks: a
//   function of the shapes alone), so that every chunk holds as many
//   padded rows as the others. Heavier grid rows run first: a
//   submanifold conv reads its center tap at every row, so that tap comes
//   first, cut into 4C chunks over 4 grid rows, then the other taps of the
//   center's z level (on a scan's surfaces the next most present), then
//   the rest. A block walks its chunk in segments of 8 tiles: (1) it finds
//   its tap's source row for each row of the segment (one word a thread a
//   tile, all loads in flight at once) and compacts the present (source,
//   output) pairs in row order into shared memory (ballots, one scan);
//   (2) it gathers the pairs' x and dy rows, 64 or more pairs a stage,
//   through a 3-stage cp.async ring (16-byte pieces, one piece of every
//   k-th pair a thread where the pieces a row are a power of two; 4-byte
//   ones where Cin % 4, the stems' Cin 5 and 6), so that the next stages'
//   gathers run under this stage's FMAs. Each thread keeps a TM x TN block
//   of dW in registers (8 x 8 from 32 channels up, the channels padded to
//   8, whose pad sums are never written: 64 FMAs for four LDS.128,
//   broadcast across the warp), and the 256 / team teams of the block
//   split the pairs (team = the threads that cover dW[t]). (3) The teams'
//   blocks are added in team order through shared memory (float4 a
//   thread, consecutive in a warp) and the partial dW[t] written into the
//   block's slice of a workspace (C, kvol + split - 1, Cin, Cout) from the
//   wrapper. A second kernel sums each tap's slices in chunk order.
//   What bounds it now (PERF.md has the numbers): per block, the serial
//   latency of each segment's word loads and compaction and of the first
//   gather, paid again by each of the ~900 blocks; the products run at
//   about half the FMA rate when fed; the blocks' work follows each tap's
//   presence, so blocks of one launch differ in length.
//
// dX of a strided conv, window_conv_inv_count_kernel +
//   window_conv_inv_kernel, over the packed inverse rulebook (B, V, Kc)
//   (bits 0..23 r0i, 24.. the ncz candidate bits, 28..30 the row's
//   (z, y, x) stride parities, read from column 0):
//     dX[q] = sum over taps kk = (jz, jy, jx) with j mod s == par(q) per
//             dim of dy[row_kk(q)] @ W[kk]^T,
//   row_kk(q) = min(r0i, O-1) + popcount(pres[0:m]) of candidate column
//   ci = (jy / sy) * ncx + jx / sx, window tap m = ncz-1-jz/sz, present
//   where pres bit m is set and the row lies below O. A row's parity class
//   decides which taps it takes (1, 2, 4 or 8 of 27 at (3, 3, 3) / (2, 2,
//   2)), so the rows are grouped by class, stably, on the device: the
//   count kernel writes each row's class (8: no candidate present; such
//   rows it writes as zeros) and each 1024-row tile's rows of each class.
//   The main kernel's block b owns RB consecutive rows of one class in
//   that order (classes in turn, rows in row order): it sums the counts
//   to find its class and range, walks the tiles from the first that
//   holds it to list its rows, finds each row's dy row for each of the
//   class's taps, and then visits only those taps, in tap order, through
//   a 2-stage cp.async ring of (the RB gathered dy rows, zero where
//   absent; the tap's (Cin, Cout) weight slice), staged once a block.
//   Each thread keeps a TM-row x 4-channel block: per tap a fresh sum over
//   Cout in order, then added to the row's running sum, as the plain
//   version adds tap by tap (the card gives its bits). Rows are written
//   once, through shared memory, in full rows.
//   What bounds it now: its FMAs, with the weights staged once per RB
//   rows per tap, and each block's serial start (the counts' sums, the
//   walk to its rows, the first gather); the last block of each class is
//   partly empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackShift = 24;
constexpr unsigned kPackMask = (1u << kPackShift) - 1u;
constexpr int kParShift = 28;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvStages = 2;       // the inverse dX's cp.async ring depth
constexpr int kMaxSmem = 232448;    // bytes a block may use (H100)
constexpr int kTwoBlocks = 113 * 1024;  // at most this for 2 blocks an SM

// dW
constexpr int kDwTile = 256;        // rows a tile: one a thread
constexpr int kDwSegTiles = 8;      // tiles a segment of a chunk's rows
constexpr int kDwMinPairs = 64;     // pairs a ring stage holds at least
constexpr int kDwStages = 3;        // its cp.async ring depth
constexpr int kDwCenterSplit = 4;   // a subm conv's center tap: 4C chunks
static_assert(kDwSegTiles * kThreads / 32 <= 64,
              "a warp scans a segment's (tile, warp) counts, 2 a lane");

// dX over the inverse rulebook
constexpr int kInvCountRows = 1024;  // rows a count tile: four a thread
constexpr int kInvClasses = 8;
constexpr int kInvMaxTaps = 8;       // taps a class at most (ncand <= 2)
constexpr int kInvMaxRows = 256;     // rows a block at most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (source size 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Channel i < T of a thread's T-channel block at thread column u of a
// row of n channels: T == 8 takes 4 at u*4 and 4 at n/2 + u*4 (a warp's
// float4 loads then cover consecutive 16-byte pieces), T == 4 takes u*4.
template <int T>
__device__ __forceinline__ int block_col(int u, int i, int n) {
  return T == 8 ? (i < 4 ? u * 4 + i : n / 2 + u * 4 + i - 4) : u * 4 + i;
}

template <int T>
__device__ __forceinline__ void load_block(float (&v)[T], const float* row,
                                           int u, int n) {
  const float4 a = ld4(row + u * 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  if constexpr (T == 8) {
    const float4 b = ld4(row + n / 2 + u * 4);
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// --------------------------------------------------------------------------
// dW
// --------------------------------------------------------------------------

// The dW kernel's geometry, a function of the shapes alone
// (ops/window_conv_cuda.py::dw_geometry is its CPU model).
struct DwGeom {
  int V, O, rows, K, kvol, cin, cinp, cout, coutp, center;
  int nchunks, ntiles;            // chunks; 256-row tiles
  int split, ytaps;               // center tap's chunks / C; grid rows
  int tm, tn;                     // a thread's block of dW
  int nci, ndi, team, slices;     // thread columns; threads a team; teams
  int pairs;                      // pairs a ring stage
  int lx, ly;                     // row strides of the staged x, dy rows
  int xpieces;                    // copies of an x row: 16 B, or 4 B
  int xshift, yshift;             // log2 of the x, dy copies a row, or -1
  long long smem;                 // dynamic shared memory, bytes
};

// log2(n) where n is a power of two up to 256, else -1.
int pow2_shift(int n) {
  for (int sh = 0; sh <= 8; ++sh)
    if (n == 1 << sh) return sh;
  return -1;
}

// Row stride (floats, a multiple of 4) of n staged channels of which a
// team reads cols 16-byte pieces a row: consecutive rows 4 * cols banks
// apart (mod 32), so that the teams of one warp, on consecutive rows,
// read distinct banks.
int staged_stride(int n, int cols) {
  return n + (((cols * 4 - n) % 32) + 32) % 32;
}

DwGeom dw_geometry(int B, int V, int O, int K, int kz, int cin, int cout,
                   int center, int nchunks) {
  DwGeom g{};
  g.V = V;
  g.O = O;
  g.rows = B * O;
  g.K = K;
  g.kvol = kz * K;
  g.cin = cin;
  g.cout = cout;
  g.center = center;
  g.nchunks = nchunks;
  g.ntiles = (g.rows + kDwTile - 1) / kDwTile;
  g.split = center ? kDwCenterSplit : 1;
  g.ytaps = g.kvol + g.split - 1;
  // 8 x 8 blocks from 32 channels up, the channels padded to 8 (the pad
  // columns' sums are never written); 4 below, padded to 4
  g.tm = cin >= 32 ? 8 : 4;
  g.tn = cout >= 32 ? 8 : 4;
  g.cinp = (cin + g.tm - 1) / g.tm * g.tm;
  g.coutp = (cout + g.tn - 1) / g.tn * g.tn;
  g.nci = g.cinp / g.tm;
  g.ndi = g.coutp / g.tn;
  g.team = g.nci * g.ndi;
  g.slices = g.team > 0 ? kThreads / g.team : 0;
  g.pairs = g.slices * 4 > kDwMinPairs ? g.slices * 4 : kDwMinPairs;
  g.lx = staged_stride(g.cinp, g.nci);
  g.ly = staged_stride(g.coutp, g.ndi);
  g.xpieces = cin % 4 ? cin : cin / 4;
  g.xshift = cin % 4 ? -1 : pow2_shift(g.xpieces);
  g.yshift = pow2_shift(cout / 4);
  const long long lists = 2LL * kDwSegTiles * kDwTile * sizeof(int);
  const long long ring = static_cast<long long>(kDwStages) * g.pairs *
                         (g.lx + g.ly) * sizeof(float);
  const long long red = static_cast<long long>(g.slices) * g.cinp *
                        g.coutp * sizeof(float);
  g.smem = lists + ring > red ? lists + ring : red;
  return g;
}

// dW's grid rows: 0 .. split-1 hold the center tap tc = kz/2 * K + K/2
// (split * C chunks), then one row each for the other taps of the center's
// z level (j = kz/2; on a lidar scan's surfaces the most present after
// it), then the taps of the other levels in order: heavier rows first.
__host__ __device__ inline int dw_row_tap(int idx, int K, int kz) {
  const int jm = kz / 2;
  if (idx < K - 1) return jm * K + (idx < K / 2 ? idx : idx + 1);
  const int i2 = idx - (K - 1), jj = i2 / K;
  return (jj < jm ? jj : jj + 1) * K + i2 % K;
}

__host__ __device__ inline int dw_tap_row(int t, int K, int kz) {
  const int jm = kz / 2, j = t / K, k = t % K;
  if (j == jm) return k < K / 2 ? k : k - 1;
  return K - 1 + (j < jm ? j : j - 1) * K + k;
}

// Block (chunk, grid row y): ws[blockIdx.x][y] = sum over the chunk's rows
// with tap t present of x[src]^T dy[o] (see the note at the top).
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
window_conv_dw_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ packed,
                      const float* __restrict__ dy, float* __restrict__ ws,
                      DwGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_cnt[kDwSegTiles * kWarps];
  __shared__ int s_off[kDwSegTiles * kWarps];
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // grid rows 0 .. split-1: the center tap in split * C chunks; then the
  // other taps, C chunks each (dw_row_tap)
  const int kz = g.kvol / g.K;
  const int tc = (kz / 2) * g.K + g.K / 2;
  const int y = blockIdx.y;
  const int t = y < g.split ? tc : dw_row_tap(y - g.split, g.K, kz);
  const int chunks = y < g.split ? g.split * g.nchunks : g.nchunks;
  const int c = y < g.split ? y * g.nchunks + blockIdx.x : blockIdx.x;
  const int k = t % g.K, j = t / g.K;
  const bool center = g.center && k == g.K / 2;
  int* s_src = reinterpret_cast<int*>(smem);           // x rows of pairs
  int* s_o = s_src + kDwSegTiles * kDwTile;            // their dy rows
  float* ring = reinterpret_cast<float*>(s_o + kDwSegTiles * kDwTile);

  const int s = tid / g.team;                 // this thread's team
  const int ti = tid - s * g.team;
  const int ci = ti / g.ndi, di = ti - ci * g.ndi;
  const bool active = s < g.slices;
  const int stage = g.pairs * (g.lx + g.ly);
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  // the chunk's tiles c, c + chunks, ..., in segments of kDwSegTiles
  const int ntc = c < g.ntiles ? (g.ntiles - c + chunks - 1) / chunks : 0;
  for (int seg = 0; seg < ntc; seg += kDwSegTiles) {
    // (1) the segment's present pairs, in row order
    const int nts = min(kDwSegTiles, ntc - seg);
    int src[kDwSegTiles];
#pragma unroll
    for (int i = 0; i < kDwSegTiles; ++i) {
      src[i] = -1;
      const int r = (c + (seg + i) * chunks) * kDwTile + tid;
      if (i < nts && r < g.rows) {
        const int b = r / g.O, o = r - b * g.O;
        const unsigned wd = static_cast<unsigned>(
            packed[static_cast<size_t>(r) * g.K + k]);
        const unsigned pres = wd >> kPackShift;
        if ((pres >> j) & 1u) {
          const int row = center ? o + j - 1
                                 : min(static_cast<int>(wd & kPackMask),
                                       g.V - 1) +
                                       __popc(pres & ((1u << j) - 1u));
          if (row >= 0 && row < g.V) src[i] = b * g.V + row;
        }
      }
    }
    unsigned mask[kDwSegTiles];
#pragma unroll
    for (int i = 0; i < kDwSegTiles; ++i) {
      mask[i] = 0;
      if (i < nts) {
        mask[i] = __ballot_sync(kFull, src[i] >= 0);
        if (lane == 0) s_cnt[i * kWarps + warp] = __popc(mask[i]);
      }
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the (tile, warp) counts, 2 a lane
      const int m = nts * kWarps;
      const int v0 = lane * 2 < m ? s_cnt[lane * 2] : 0;
      const int v1 = lane * 2 + 1 < m ? s_cnt[lane * 2 + 1] : 0;
      int incl = v0 + v1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      const int run = incl - v0 - v1;
      if (lane * 2 < m) s_off[lane * 2] = run;
      if (lane * 2 + 1 < m) s_off[lane * 2 + 1] = run + v0;
      if (lane == 31) s_n = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < kDwSegTiles; ++i) {
      if (i < nts && src[i] >= 0) {
        const int pos = s_off[i * kWarps + warp] + __popc(mask[i] & below);
        s_src[pos] = src[i];
        s_o[pos] = (c + (seg + i) * chunks) * kDwTile + tid;
      }
    }
    const int n = s_n;
    __syncthreads();

    // (2) the pairs' products through the ring, teams splitting the pairs
    const int nsub = (n + g.pairs - 1) / g.pairs;
    auto fetch = [&](int sub) {
      float* xs = ring + (sub % kDwStages) * stage;
      float* ys = xs + g.pairs * g.lx;
      const int base = sub * g.pairs;
      const int cnt = min(g.pairs, n - base);
      // x rows: g.xpieces copies a pair; dy rows: Cout / 4. Where a count
      // is a power of two, thread tid takes one piece of every 256 /
      // count-th pair (no division).
      if (g.xshift >= 0) {
        const int q = tid & (g.xpieces - 1);
        for (int p = tid >> g.xshift; p < cnt; p += kThreads >> g.xshift) {
          const float* xr = x + static_cast<size_t>(s_src[base + p]) * g.cin;
          cp_async16(xs + p * g.lx + q * 4, xr + q * 4);
        }
      } else {
        for (int e = tid; e < cnt * g.xpieces; e += kThreads) {
          const int p = e / g.xpieces, q = e - p * g.xpieces;
          const float* xr = x + static_cast<size_t>(s_src[base + p]) * g.cin;
          if (g.cin % 4)
            cp_async4(xs + p * g.lx + q, xr + q);
          else
            cp_async16(xs + p * g.lx + q * 4, xr + q * 4);
        }
      }
      const int q = tid & (g.cout / 4 - 1);
      if (g.yshift >= 0) {
        for (int p = tid >> g.yshift; p < cnt; p += kThreads >> g.yshift)
          cp_async16(ys + p * g.ly + q * 4,
                     dy + static_cast<size_t>(s_o[base + p]) * g.cout + q * 4);
      } else {
        for (int e = tid; e < cnt * (g.cout / 4); e += kThreads) {
          const int p = e / (g.cout / 4), d = (e - p * (g.cout / 4)) * 4;
          cp_async16(ys + p * g.ly + d,
                     dy + static_cast<size_t>(s_o[base + p]) * g.cout + d);
        }
      }
    };
#pragma unroll
    for (int sub = 0; sub < kDwStages - 1; ++sub) {
      if (sub < nsub) fetch(sub);
      cp_async_commit();
    }
    for (int sub = 0; sub < nsub; ++sub) {
      cp_async_wait<kDwStages - 2>();   // this stage's copies have landed
      __syncthreads();                  // everyone's; stage sub-1 is free
      if (sub + kDwStages - 1 < nsub) fetch(sub + kDwStages - 1);
      cp_async_commit();
      const float* xs = ring + (sub % kDwStages) * stage;
      const float* ys = xs + g.pairs * g.lx;
      const int cnt = min(g.pairs, n - sub * g.pairs);
      if (active) {
        for (int p = s; p < cnt; p += g.slices) {
          float xv[TM], yv[TN];
          load_block<TM>(xv, xs + p * g.lx, ci, g.cinp);
          load_block<TN>(yv, ys + p * g.ly, di, g.coutp);
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              acc[r][q] = fmaf(xv[r], yv[q], acc[r][q]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                    // the lists and the ring are free
  }

  // (3) the teams' blocks added in team order; the partial written once.
  // red holds float4 i of thread ti of team s at ((s * NI + i) * team +
  // ti) * 4: a warp's stores and loads fall on consecutive 16 bytes.
  constexpr int NI = TM * TN / 4;
  float* red = smem;
  if (active) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        st4(red + ((s * NI + r * (TN / 4) + h) * g.team + ti) * 4,
            make_float4(acc[r][h * 4], acc[r][h * 4 + 1], acc[r][h * 4 + 2],
                        acc[r][h * 4 + 3]));
  }
  __syncthreads();
  float* out = ws + (static_cast<size_t>(blockIdx.x) * g.ytaps + y) *
                        static_cast<size_t>(g.cin) * g.cout;
  for (int e = tid; e < g.team * NI; e += kThreads) {
    const int i = e / g.team, u = e - i * g.team;
    const int r = i / (TN / 4), h = i - r * (TN / 4);
    const int row = block_col<TM>(u / g.ndi, r, g.cinp);
    const int col = block_col<TN>(u % g.ndi, h * 4, g.coutp);
    if (row >= g.cin || col >= g.cout) continue;
    float4 v = ld4(red + e * 4);
    for (int q = 1; q < g.slices; ++q) {
      const float4 w4 = ld4(red + ((q * NI + i) * g.team + u) * 4);
      v.x += w4.x;
      v.y += w4.y;
      v.z += w4.z;
      v.w += w4.w;
    }
    st4(out + static_cast<size_t>(row) * g.cout + col, v);
  }
}

// dw[t] = sum over tap t's chunks, in chunk order, of their slices of
// ws (C, ytaps, Cin, Cout): the center tap's split * C chunks are grid
// rows 0 .. split-1 (chunk y*C + c), tap t's C chunks grid row
// split + dw_tap_row(t).
__global__ void __launch_bounds__(kThreads)
window_conv_dw_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                          DwGeom g) {
  const int plane = g.cin * g.cout, n = g.kvol * plane;
  const int kz = g.kvol / g.K;
  const int tc = (kz / 2) * g.K + g.K / 2;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += gridDim.x * kThreads) {
    const int t = e / plane, r = e - t * plane;
    const int y0 = t == tc ? 0 : g.split + dw_tap_row(t, g.K, kz);
    const int y1 = t == tc ? g.split : y0 + 1;
    float s = 0.f;
    for (int y = y0; y < y1; ++y)
      for (int c = 0; c < g.nchunks; ++c)
        s += ws[(static_cast<size_t>(c) * g.ytaps + y) * plane + r];
    dw[e] = s;
  }
}

// --------------------------------------------------------------------------
// dX of a strided conv over the inverse rulebook
// --------------------------------------------------------------------------

// The inverse dX kernels' geometry, a function of the shapes alone
// (ops/window_conv_cuda.py::inv_geometry is its CPU model).
struct InvGeom {
  int kz, ky, kx;       // kernel
  int sz, sy, sx;       // stride (1 or 2)
  int ncz, ncx, kc;     // candidates: z, x, BEV columns
  int rows, V, O, cin, cout;
  int ntiles;           // 1024-row count tiles
  int tm, nci, nr, rb;  // a thread's rows; thread columns, thread rows
                        // used; rows a block (nr * tm)
  int blocks;           // the main kernel's grid (blocks past need exit)
  int ly;               // row stride of the staged dy rows and weights
  long long smem;       // dynamic shared memory, bytes
};

// Ints before the ring: a block's rows and their dy rows for each tap,
// rounded up to 16 bytes.
__host__ __device__ inline int inv_lists(int rb) {
  return ((1 + kInvMaxTaps) * rb + 3) & ~3;
}

long long inv_smem(int rb, int cin, int cout) {
  const long long ly = cout + 4;
  const long long ring = kInvStages * (static_cast<long long>(rb) + cin) * ly;
  const long long out = static_cast<long long>(rb) * (cin + 4);
  return ((ring > out ? ring : out) + inv_lists(rb)) * sizeof(float);
}

InvGeom inv_geometry(int cin, int cout) {
  InvGeom g{};
  g.cin = cin;
  g.cout = cout;
  g.ly = cout + 4;
  g.nci = cin / 4;
  const int nri = g.nci > 0 ? kThreads / g.nci : 0;
  // the most rows a thread (at most 8; a block at most 256) that leave
  // room for two blocks an SM, else for one; where even one row a thread
  // does not fit, fewer thread rows
  for (int pass = 0; pass < 2 && !g.tm; ++pass) {
    const long long cap = pass == 0 ? kTwoBlocks : kMaxSmem;
    for (int nr = nri; nr >= 1 && !g.tm; nr /= 2)
      for (int tm = nr == nri ? 8 : 1; tm >= 1 && !g.tm; tm /= 2)
        if (nr * tm <= kInvMaxRows && inv_smem(nr * tm, cin, cout) <= cap) {
          g.tm = tm;
          g.nr = nr;
        }
  }
  g.rb = g.nr * g.tm;
  g.smem = g.tm ? inv_smem(g.rb, cin, cout) : 0;
  return g;
}

// Counts each 1024-row tile's rows of each parity class, writes each
// row's class to cls (8: no candidate present) and writes those rows of
// dx as zeros.
__global__ void __launch_bounds__(kThreads)
window_conv_inv_count_kernel(const int32_t* __restrict__ inv,
                             uint8_t* __restrict__ cls,
                             int32_t* __restrict__ counts,
                             float* __restrict__ dx, InvGeom g) {
  __shared__ int s_cnt[kWarps][kInvClasses];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned pmask = ((1u << g.ncz) - 1u) << kPackShift;
  int cnt[kInvClasses] = {};
  for (int i = 0; i < kInvCountRows / kThreads; ++i) {
    const int q = blockIdx.x * kInvCountRows + i * kThreads + tid;
    int cl = -1;
    if (q < g.rows) {
      const int32_t* wq = inv + static_cast<size_t>(q) * g.kc;
      unsigned any = 0;
      for (int m = 0; m < g.kc; ++m) any |= static_cast<unsigned>(wq[m]);
      cl = any & pmask ? (static_cast<unsigned>(wq[0]) >> kParShift) & 7u
                       : kInvClasses;
      cls[q] = static_cast<uint8_t>(cl);
      if (cl == kInvClasses) {
        float* row = dx + static_cast<size_t>(q) * g.cin;
        for (int c4 = 0; c4 < g.cin; c4 += 4)
          st4(row + c4, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
#pragma unroll
    for (int c8 = 0; c8 < kInvClasses; ++c8)
      cnt[c8] += __popc(__ballot_sync(kFull, cl == c8));
  }
  if (lane == 0) {
#pragma unroll
    for (int c8 = 0; c8 < kInvClasses; ++c8) s_cnt[warp][c8] = cnt[c8];
  }
  __syncthreads();
  if (tid < kInvClasses) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_cnt[w][tid];
    counts[tid * g.ntiles + blockIdx.x] = s;
  }
}

// Block b: rows [i0, i0 + n) of class cl in the stable class order, their
// dX summed over the class's taps in tap order (see the note at the top).
template <int TM>
__global__ void __launch_bounds__(kThreads)
window_conv_inv_kernel(const float* __restrict__ dy,
                       const int32_t* __restrict__ inv,
                       const uint8_t* __restrict__ cls,
                       const int32_t* __restrict__ counts,
                       const float* __restrict__ w, float* __restrict__ dx,
                       InvGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tot[kInvClasses];
  __shared__ int s_info[4];
  __shared__ int s_taps[27];
  __shared__ int s_ntaps;
  __shared__ int s_wsum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the classes' sizes, then this block's class and rank range
  if (warp < kInvClasses) {
    int s = 0;
    for (int tile = lane; tile < g.ntiles; tile += 32)
      s += counts[warp * g.ntiles + tile];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    if (lane == 0) s_tot[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    int start = 0, cl = -1, i0 = 0;
    for (int c8 = 0; c8 < kInvClasses; ++c8) {
      const int nb = (s_tot[c8] + g.rb - 1) / g.rb;
      if (static_cast<int>(blockIdx.x) < start + nb) {
        cl = c8;
        i0 = (blockIdx.x - start) * g.rb;
        break;
      }
      start += nb;
    }
    s_info[0] = cl;
    s_info[1] = i0;
    int nt = 0;
    if (cl >= 0) {
      const int pz = cl & 1, py = (cl >> 1) & 1, px = (cl >> 2) & 1;
      const int kvol = g.kz * g.ky * g.kx;
      for (int kk = 0; kk < kvol; ++kk) {
        const int jz = kk / (g.ky * g.kx), jy = (kk / g.kx) % g.ky,
                  jx = kk % g.kx;
        if (jz % g.sz == pz && jy % g.sy == py && jx % g.sx == px)
          s_taps[nt++] = kk;
      }
    }
    s_ntaps = nt;
  }
  __syncthreads();
  const int cl = s_info[0];
  if (cl < 0) return;                         // past the last class block
  const int i0 = s_info[1];
  const int n = min(g.rb, s_tot[cl] - i0);
  const int ntaps = s_ntaps;

  // the first count tile that holds class rank i0
  if (warp == 0) {
    int before = 0, found = -1, pre = 0;
    for (int base = 0; base < g.ntiles && found < 0; base += 32) {
      const int tile = base + lane;
      const int v = tile < g.ntiles ? counts[cl * g.ntiles + tile] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      const int excl = before + incl - v;
      const unsigned hit = __ballot_sync(kFull, tile < g.ntiles &&
                                                    excl + v > i0);
      if (hit) {
        const int l = __ffs(hit) - 1;
        found = base + l;
        pre = __shfl_sync(kFull, excl, l);
      }
      before += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      s_info[2] = found;
      s_info[3] = pre;
    }
  }
  __syncthreads();

  // this block's rows, walking the tiles from that one: thread tid holds
  // rows tile*1024 + tid*4 + 0..3, so ranks follow the rows
  int* s_q = reinterpret_cast<int*>(smem);          // (rb) rows
  int* s_src = s_q + g.rb;                          // (ntaps, rb) dy rows
  float* ring = smem + inv_lists(g.rb);
  {
    int tile = s_info[2], rank = s_info[3];
    while (rank < i0 + n) {
      const int q0 = tile * kInvCountRows + tid * 4;
      int mine = 0;
      uint8_t cb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cb[u] = q0 + u < g.rows ? cls[q0 + u] : 0xff;
        mine += cb[u] == cl;
      }
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      if (lane == 31) s_wsum[warp] = incl;
      __syncthreads();
      int pos = rank + incl - mine, total = 0;
      for (int wv = 0; wv < kWarps; ++wv) {
        const int ws_ = s_wsum[wv];
        if (wv < warp) pos += ws_;
        total += ws_;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (cb[u] == cl) {
          if (pos >= i0 && pos < i0 + n) s_q[pos - i0] = q0 + u;
          ++pos;
        }
      }
      rank += total;
      ++tile;
      __syncthreads();
    }
  }

  // each row's dy row for each of the class's taps (-1: absent)
  for (int r = tid; r < g.rb; r += kThreads) {
    const int q = r < n ? s_q[r] : -1;
    const int b = q >= 0 ? q / g.V : 0;
    for (int m = 0; m < ntaps; ++m) {
      int src = -1;
      if (q >= 0) {
        const int kk = s_taps[m];
        const int jz = kk / (g.ky * g.kx), jy = (kk / g.kx) % g.ky,
                  jx = kk % g.kx;
        const unsigned word = static_cast<unsigned>(
            inv[static_cast<size_t>(q) * g.kc + (jy / g.sy) * g.ncx +
                jx / g.sx]);
        const int mz = g.ncz - 1 - jz / g.sz;
        const unsigned pres = (word >> kPackShift) & ((1u << g.ncz) - 1u);
        if ((pres >> mz) & 1u) {
          const int row = min(static_cast<int>(word & kPackMask), g.O - 1) +
                          __popc(pres & ((1u << mz) - 1u));
          if (row < g.O) src = b * g.O + row;
        }
      }
      s_src[m * g.rb + r] = src;
    }
  }
  __syncthreads();

  // the taps through the ring: stage = (rb dy rows, the tap's weights)
  const int ri = tid / g.nci, ci = tid - ri * g.nci;
  const bool active = ri < g.nr;
  const int stage = (g.rb + g.cin) * g.ly;
  const int yp = g.cout / 4;
  auto fetch = [&](int m) {
    float* ys = ring + (m % kInvStages) * stage;
    float* wt = ys + g.rb * g.ly;
    const float* wk = w + static_cast<size_t>(s_taps[m]) * g.cin * g.cout;
    for (int e = tid; e < (g.rb + g.cin) * yp; e += kThreads) {
      const int r = e / yp, d = (e - r * yp) * 4;
      if (r < g.rb) {
        const int src = s_src[m * g.rb + r];
        cp_async16(ys + r * g.ly + d,
                   dy + static_cast<size_t>(src < 0 ? 0 : src) * g.cout + d,
                   src >= 0);
      } else {
        const int c = r - g.rb;
        cp_async16(wt + c * g.ly + d, wk + static_cast<size_t>(c) * g.cout + d);
      }
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int mm = 0; mm < TM; ++mm)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[mm][u] = 0.f;
  if (ntaps > 0) fetch(0);
  cp_async_commit();
  for (int m = 0; m < ntaps; ++m) {
    cp_async_wait<0>();               // tap m's copies have landed
    __syncthreads();                  // everyone's; the other stage is free
    if (m + 1 < ntaps) fetch(m + 1);
    cp_async_commit();
    if (active) {
      const float* ys = ring + (m % kInvStages) * stage;
      const float* wt = ys + g.rb * g.ly;
      float part[TM][4];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[mm][u] = 0.f;
      for (int d = 0; d < g.cout; d += 4) {
        float4 wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wv[u] = ld4(wt + (ci + g.nci * u) * g.ly + d);
#pragma unroll
        for (int mm = 0; mm < TM; ++mm) {
          const float4 yv = ld4(ys + (ri + g.nr * mm) * g.ly + d);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float a = part[mm][u];
            a = fmaf(yv.x, wv[u].x, a);
            a = fmaf(yv.y, wv[u].y, a);
            a = fmaf(yv.z, wv[u].z, a);
            a = fmaf(yv.w, wv[u].w, a);
            part[mm][u] = a;
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < TM; ++mm)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mm][u] += part[mm][u];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the rows, through shared memory, written whole
  const int lo = g.cin + 4;
  float* outs = ring;                               // (rb, cin + 4)
  if (active) {
#pragma unroll
    for (int mm = 0; mm < TM; ++mm)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        outs[(ri + g.nr * mm) * lo + ci + g.nci * u] = acc[mm][u];
  }
  __syncthreads();
  const int c4n = g.cin / 4;
  for (int e = tid; e < n * c4n; e += kThreads) {
    const int r = e / c4n, c = (e - r * c4n) * 4;
    st4(dx + static_cast<size_t>(s_q[r]) * g.cin + c, ld4(outs + r * lo + c));
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

template <int TM, int TN>
int launch_dw(const float* x, const int32_t* packed, const float* dy,
              float* ws, float* dw, const DwGeom& g, cudaStream_t stream) {
  auto kern = window_conv_dw_kernel<TM, TN>;
  cudaError_t err = allow_smem<TM * 10 + TN>(
      reinterpret_cast<const void*>(kern), static_cast<size_t>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(g.nchunks, g.ytaps);
  kern<<<grid, kThreads, g.smem, stream>>>(x, packed, dy, ws, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = g.kvol * g.cin * g.cout;
  window_conv_dw_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(ws, dw, g);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_inv(const float* dy, const int32_t* inv, const float* w, float* dx,
               uint8_t* cls, int32_t* counts, const InvGeom& g,
               cudaStream_t stream) {
  auto kern = window_conv_inv_kernel<TM>;
  cudaError_t err = allow_smem<100 + TM>(reinterpret_cast<const void*>(kern),
                                         static_cast<size_t>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_conv_inv_count_kernel<<<g.ntiles, kThreads, 0, stream>>>(
      inv, cls, counts, dx, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<g.blocks, kThreads, g.smem, stream>>>(dy, inv, cls, counts, w, dx, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dW kernel's geometry for these shapes into out[0..11]: tiles, TM,
// TN, team, slices, pairs a stage, the x and dy row strides, x copies a
// row, the center tap's split, and the shared memory (bytes, split in two
// ints: low 31 bits, high). Returns 0.
extern "C" int window_conv_dw_geometry(int B, int V, int O, int K, int kz,
                                       int cin, int cout, int center_shift,
                                       int nchunks, int* out) {
  const DwGeom g = dw_geometry(B, V, O, K, kz, cin, cout, center_shift,
                               nchunks);
  const int v[] = {g.ntiles, g.tm, g.tn, g.team, g.slices, g.pairs, g.lx,
                   g.ly, g.xpieces, g.split,
                   static_cast<int>(g.smem & 0x7fffffff),
                   static_cast<int>(g.smem >> 31)};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// d(weights): the first pass into ws (nchunks, kz*K + split - 1, Cin,
// Cout), then its sum in chunk order into dw (kz*K, Cin, Cout). Returns the cudaError_t of
// the launches (0 on success). The wrapper (ops/window_conv_cuda.py::
// window_conv_dw) checks shapes, types, 16-byte alignment, Cin 1-128 and
// Cout a multiple of 4 up to 128, and picks nchunks (dw_chunks: at most
// one chunk a tile).
extern "C" int window_conv_dw_launch(const void* x, const void* packed,
                                     const void* dy, void* ws, void* dw,
                                     int B, int V, int O, int K, int kz,
                                     int cin, int cout, int center_shift,
                                     int nchunks, void* stream) {
  const DwGeom g = dw_geometry(B, V, O, K, kz, cin, cout, center_shift,
                               nchunks);
  if (nchunks < 1 || nchunks > g.ntiles || g.slices < 1 || g.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* pk = static_cast<const int32_t*>(packed);
  const float* dyf = static_cast<const float*>(dy);
  float* wsf = static_cast<float*>(ws);
  float* dwf = static_cast<float*>(dw);
  if (g.tm == 8 && g.tn == 8)
    return launch_dw<8, 8>(xf, pk, dyf, wsf, dwf, g, s);
  if (g.tm == 8)
    return launch_dw<8, 4>(xf, pk, dyf, wsf, dwf, g, s);
  if (g.tn == 8)
    return launch_dw<4, 8>(xf, pk, dyf, wsf, dwf, g, s);
  return launch_dw<4, 4>(xf, pk, dyf, wsf, dwf, g, s);
}

// The taps of dW's first kvol + split - 1 grid rows into taps (the
// center tap split times, then dw_row_tap's order). Returns 0.
extern "C" int window_conv_dw_rows(int K, int kz, int center_shift,
                                   int* taps) {
  const int split = center_shift ? kDwCenterSplit : 1;
  const int tc = (kz / 2) * K + K / 2;
  for (int y = 0; y < kz * K + split - 1; ++y)
    taps[y] = y < split ? tc : dw_row_tap(y - split, K, kz);
  return 0;
}

// The inverse dX kernels' geometry at (Cin, Cout) into out[0..4]: a
// thread's rows TM, thread columns, thread rows used, rows a block, and
// the shared memory (bytes) a block. Returns 0, or -1 where none fits.
extern "C" int window_conv_inv_geometry(int cin, int cout, int* out) {
  const InvGeom g = inv_geometry(cin, cout);
  const int v[] = {g.tm, g.nci, g.nr, g.rb, static_cast<int>(g.smem)};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return g.tm ? 0 : -1;
}

// d(features) of a strided conv over its packed inverse rulebook (B, V,
// Kc): dx (B, V, Cin). cls (B*V bytes) and counts (8 * ceil(B*V / 1024)
// ints) are the wrapper's workspace. Returns the cudaError_t of the
// launches. The wrapper (ops/window_conv_cuda.py::window_conv_inv) checks
// shapes, types, 16-byte alignment, Cin and Cout multiples of 4 up to 128,
// a kernel of at most 3 and strides of 1 or 2 a dim (ncand <= 2).
extern "C" int window_conv_inv_launch(const void* dy, const void* inv,
                                      const void* w, void* dx, void* cls,
                                      void* counts, int B, int V, int O,
                                      int cin, int cout, int kz, int ky,
                                      int kx, int sz, int sy, int sx,
                                      int ncz, void* stream) {
  InvGeom g = inv_geometry(cin, cout);
  if (!g.tm || kz * ky * kx > 27)
    return static_cast<int>(cudaErrorInvalidValue);
  g.kz = kz;
  g.ky = ky;
  g.kx = kx;
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  g.ncz = ncz;
  g.ncx = (kx + sx - 1) / sx;
  g.kc = ((ky + sy - 1) / sy) * g.ncx;
  g.rows = B * V;
  g.V = V;
  g.O = O;
  g.ntiles = (g.rows + kInvCountRows - 1) / kInvCountRows;
  g.blocks = (g.rows + g.rb - 1) / g.rb + kInvClasses;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dyf = static_cast<const float*>(dy);
  const int32_t* iv = static_cast<const int32_t*>(inv);
  const float* wf = static_cast<const float*>(w);
  float* dxf = static_cast<float*>(dx);
  uint8_t* cb = static_cast<uint8_t*>(cls);
  int32_t* cn = static_cast<int32_t*>(counts);
  switch (g.tm) {
    case 8: return launch_inv<8>(dyf, iv, wf, dxf, cb, cn, g, s);
    case 4: return launch_inv<4>(dyf, iv, wf, dxf, cb, cn, g, s);
    case 2: return launch_inv<2>(dyf, iv, wf, dxf, cb, cn, g, s);
    default: return launch_inv<1>(dyf, iv, wf, dxf, cb, cn, g, s);
  }
}
