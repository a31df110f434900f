// Sparse 3-D convolution over a packed window rulebook, for sm_90a.
//
// Replaces det3d_tpu/ops/band_conv.py:216 band_window_conv (the Pallas TPU
// kernel _band_kernel). The TPU kernel fetches rows through one-hot
// matmuls over a DMA'd band of ranks because the TPU has no per-lane
// gather; on Hopper a gather is cheap, so these kernels gather directly and
// need no band: they read the packed plan words as they are.
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
// Two kernels, chosen by the operands' type.
//
// The tile prologue is the same in both: a block reads its tile's packed
// words once (coalesced), ORs the presence bits of each column over the
// tile (warp reductions), lists the taps that any row has (ballots; absent
// taps cost nothing) and finds every row's source row for each listed tap,
// once, into shared memory. The listed taps then run through a ring of 2
// shared-memory stages, each holding one tap's gathered rows and its
// (Cin, COUT) weight slice, both copied global -> shared by cp.async (an
// absent row or one past V is a zero-fill copy of source size 0). Tap
// q+1's copies are in flight while tap q multiplies, with one barrier per
// tap. Each output row is written once; no atomics. COUT is 16, 32, 64 or
// 128, Cin at most 128, kz at most 7.
//
// bf16 (the path SECOND and CBGS serve): window_conv_bf16_kernel, on the
// tensor cores. A block of 4 warps owns 64 output rows (COUT 16, 32, 128;
// 16 a warp) or 128 (COUT 64: two m16 tiles a warp, so that each weight
// fragment serves both), and all COUT channels. Rows are copied in 16-byte
// pieces (8-byte where Cin = 4; plain loads where rows are not 8-byte
// aligned). The products are mma.sync.m16n8k16 bf16 -> fp32: A fragments
// by ldmatrix from the gathered rows, B fragments by ldmatrix.trans from
// the row-major weights. Shared rows are padded by 16 bytes (row stride an
// odd multiple of 16 bytes), so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups. Cin is zero-padded to the MMA depth of 16 in
// shared memory (Cin = 4 runs 4x the useful products; the first conv is
// paced by its 27 taps' round trips, not by them). Outputs are float2
// stores. mma.sync and not wgmma: a wgmma version of this kernel (gathered
// rows K-major and weights N-major in unswizzled core-matrix layouts, one
// descriptor pair per k-step, an async-proxy fence and a wait on each
// tap's products) gave the same results and ran slower on the H100 at
// SECOND's shapes, where the gather, not the products, paces it.
//
// Bound (bf16, SECOND's shapes, B=2, O=V=20000): a (64,64) conv must read
// the ~39000 input rows its taps reach (128 B each) and the plan once and
// write 10 MB of fp32 output, ~16 MB and ~5 us at 3.35 TB/s; its present
// taps are ~2.6 GFLOP, ~3 us at the bf16 tensor rate: bytes bound. What
// still separates the bf16 kernel from that bound (PERF.md has its times):
// every tile restages each tap's weights from L2 (~69 MB a (64,64) conv
// at 128-row tiles, more than the ~41 MB of rows its taps gather, each
// input row once per tap that reaches it); the products run densely over
// the tile for every tap any row has (8.9 GFLOP where 2.6 are useful); and
// each tile pays a prologue (words, tap list, source rows) and one round
// trip per tap with one tap of copies in flight.
//
// fp32 (the path the Lyft and KITTI 3-class configs serve):
// window_conv_f32_kernel, full fp32 products on the CUDA cores (the tensor
// cores would compute fp32 as TF32 and change the results). Bound on the
// H100: fp32 operations at 67 TFLOP/s (2 Cin COUT flops a tap that reads a
// row: Lyft's 11 convs ~0.19 ms, KITTI 3-class's 10 ~0.16 ms), above the
// bytes. A block of 4 warps owns 64 output rows (COUT 16, 32) or 32
// (COUT 64); one of 8 warps, 64 rows at COUT 128. Each thread keeps an
// RM-row x RN-channel block of sums in registers (4 x 4 at COUT 16 and
// 32, 4 x 8 at 64 and 128): for every 4 input channels it loads one
// float4 per row and RN / 4 float4s per weight row and runs 4 RM RN FMAs
// (128 FMAs per 12 LDS.128 at COUT 64; the earlier kernel issued 32 FMAs
// per 6 loads). At COUT 16 and 64 two
// lanes split the input channels (KS = 2) and sum their partial blocks
// by a shuffle at the end, which keeps the blocks 4 x 4 or 4 x 8 with
// narrower warp bands. A thread's rows are TR apart, so each warp covers
// one band of contiguous rows (16 at COUT 16 and 32, 8 at 64 and 128) and
// all COUT channels, and a quarter warp reads consecutive rows (the row
// stride, Cin rounded up to 4 KS and padded, is an odd multiple of 16
// bytes) or consecutive weights: no bank conflicts. Per-warp tap skip: the
// prologue marks, per listed tap, the warps whose band has a row that
// reads an input row; any other warp skips the tap's FMAs (warp-uniform,
// no barrier) and its rows are not copied. The products run are then
// those of the bands, not of the tile (ops/window_conv_cuda.py::
// f32_schedule models the schedule on the CPU; chip_smoke prints its
// executed / useful ratio: ~3x on Lyft's and KITTI's plans). Rows are
// copied in 16-byte pieces where Cin % 4 == 0 and the features are 16-byte
// aligned, else by 4-byte cp.async (Cin 5, the stem of CBGS and Lyft),
// zero-padded in shared memory; the weights in 16-byte pieces (the wrapper
// requires 16-byte aligned weights). Outputs are float4 stores. The
// geometry was chosen per COUT on the H100 among variants of rows per
// thread, lanes per row, warps per block and ring depth: 4-warp blocks
// read fastest (more blocks an SM, fewer warps a barrier); deeper rings,
// 8 x 8 blocks, 16-warp blocks, and sorting a tile's rows by the taps
// they read (~20% fewer products) read no faster. What still separates it
// from its bound (PERF.md has its times): the products of the rows of a
// band that read no row (~2-4x the useful ones, ~4-10x in the strided
// convs), the FMA pipes at ~30% of their rate on the products they run,
// and each tile restaging each tap's weights.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kPackShift = 24;
constexpr unsigned kPackMask = (1u << kPackShift) - 1u;
constexpr int kStages = 2;               // cp.async ring depth, in taps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Input row that tap j of column k reads for tile row r (output o), or -1.
__device__ __forceinline__ int source_row(const int* word, int r, int k,
                                          int j, int K, int o, int V,
                                          bool center) {
  const unsigned wd = static_cast<unsigned>(word[r * K + k]);
  const unsigned pres = wd >> kPackShift;
  if (!((pres >> j) & 1u)) return -1;
  const int row =
      center ? o + j - 1
             : min(static_cast<int>(wd & kPackMask), V - 1) +
                   __popc(pres & ((1u << j) - 1u));
  return row >= 0 && row < V ? row : -1;
}

// --------------------------------------------------------------------------
// The tile prologue of both kernels
// --------------------------------------------------------------------------

// Run by all NT threads of the block that owns output rows [o0, o0 + TO)
// of sample b: reads the tile's packed words once into word (TO x K; rows
// past O have no present bit), lists the taps that any row has, in bit
// order k * kz + j (taps: the weight row j * K + k; tapjk: k | j << 16),
// and finds every row's source row for each listed tap into srcs (listed
// tap x TO; -1: none). tapm holds (K kz + 31) / 32 words of tap bits and
// ntaps the count. Returns the number of listed taps, after a barrier.
template <int NT, int TO>
__device__ int tile_taps(const int32_t* __restrict__ packed, int b, int o0,
                         int V, int O, int K, int kz, int center_shift,
                         int* word, int* srcs, unsigned* tapm, int* taps,
                         int* tapjk, int* ntaps) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nbits = K * kz;             // tap bit k * kz + j
  const int nwords = (nbits + 31) / 32;
  for (int i = tid; i < nwords; i += NT) tapm[i] = 0u;
  const int live = min(TO, O - o0) * K;
  const int32_t* pb = packed + (static_cast<size_t>(b) * O + o0) * K;
  for (int i = tid; i < TO * K; i += NT)
    word[i] = i < live ? pb[i] : 0;     // rows past O: no present bit
  __syncthreads();

  // The taps any row of the tile has: per-thread ORs over its rows, 64
  // tap bits at a time, then one OR per warp into tapm.
  const unsigned tapbits = (1u << kz) - 1u;
  for (int base = 0; base < nbits; base += 64) {
    unsigned long long m = 0;
    for (int r = tid; r < TO; r += NT)
      for (int k = 0; k < K; ++k) {
        const unsigned long long p =
            (static_cast<unsigned>(word[r * K + k]) >> kPackShift) & tapbits;
        const int at = k * kz - base;
        if (at >= 0 && at < 64) m |= p << at;
        else if (at < 0 && at + kz > 0) m |= p >> -at;
      }
    const unsigned lo = __reduce_or_sync(0xffffffffu,
                                         static_cast<unsigned>(m));
    const unsigned hi = __reduce_or_sync(0xffffffffu,
                                         static_cast<unsigned>(m >> 32));
    if (lane == 0) {
      if (lo) atomicOr(&tapm[base / 32], lo);
      if (hi) atomicOr(&tapm[base / 32 + 1], hi);
    }
  }
  __syncthreads();
  if (warp == 0) {                      // list them in bit order
    int n = 0;
    for (int wi = 0; wi < nwords; ++wi) {
      const bool has = (tapm[wi] >> lane) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, has);
      if (has) {
        const int bit = wi * 32 + lane;
        const int k = bit / kz, j = bit - k * kz;
        const int at = n + __popc(bal & ((1u << lane) - 1u));
        taps[at] = j * K + k;
        tapjk[at] = k | j << 16;
      }
      n += __popc(bal);
    }
    if (lane == 0) *ntaps = n;
  }
  __syncthreads();
  const int n = *ntaps;
  // Every row's source row for every listed tap, once.
  for (int i = tid; i < n * TO; i += NT) {
    const int q = i / TO, r = i - q * TO;
    const int k = tapjk[q] & 0xffff, j = tapjk[q] >> 16;
    srcs[i] = source_row(word, r, k, j, K, o0 + r, V,
                         center_shift && k == K / 2);
  }
  __syncthreads();
  return n;
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = kWarps * 32;
// m16 tiles per warp: 2 at COUT = 64 (128-row tiles, each weight fragment
// serves two), else 1 (64-row tiles).
template <int COUT>
constexpr int kMt = COUT == 64 ? 2 : 1;
template <int COUT>
constexpr int kTileRows = kWarps * 16 * kMt<COUT>;   // output rows a block

// One piece of VEC bf16 values global -> shared; zeros where !valid.
// VEC 8 and 4 are cp.async (16 and 8 bytes, source size 0 = zero fill);
// VEC 1, for rows that are not 8-byte aligned, is a plain load and store.
template <int VEC>
__device__ __forceinline__ void copy_piece(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  if constexpr (VEC == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    *dst = valid ? *src : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// Gathers the tile's rows of one tap into As (rows of lda) from srcs,
// their source rows (-1: none), in pieces of VEC values, P = cin / VEC a
// row; consecutive threads take consecutive pieces of a row. pshift =
// log2 P where P is a power of two, else -1.
template <int VEC, int ROWS>
__device__ __forceinline__ void gather_rows(__nv_bfloat16* As, int lda,
                                            const __nv_bfloat16* xb,
                                            const int* srcs, int cin,
                                            int pshift) {
  const int per_row = cin / VEC;
  for (int i = threadIdx.x; i < ROWS * per_row; i += kMmaThreads) {
    const int r = pshift >= 0 ? i >> pshift : i / per_row;
    const int c = (i - r * per_row) * VEC;
    const int s = srcs[r];
    copy_piece<VEC>(As + r * lda + c,
                    xb + static_cast<size_t>(s < 0 ? 0 : s) * cin + c,
                    s >= 0);
  }
}

// Stages one tap's (cin, COUT) weight slice into Ws (rows of COUT + 8) in
// 16-byte pieces (the wrapper requires 16-byte aligned weights).
template <int COUT>
__device__ __forceinline__ void stage_weights(__nv_bfloat16* Ws,
                                              const __nv_bfloat16* wt,
                                              int cin) {
  constexpr int LDW = COUT + 8;
  constexpr int PER_ROW = COUT / 8;
  for (int i = threadIdx.x; i < cin * PER_ROW; i += kMmaThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * 8;
    copy_piece<8>(Ws + r * LDW + c, wt + r * COUT + c, true);
  }
}

// Launch geometry of the bf16 kernel, set by the host.
struct Geometry {
  int cin_pad, lda;          // Cin rounded up to 16; A row stride
  int a_elems, tap_elems;    // one stage: A (tile rows x lda), then W
  int xvec, pshift;          // row piece size; log2(cin / xvec) or -1
};

template <int COUT>
__global__ void __launch_bounds__(kMmaThreads)
window_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int32_t* __restrict__ packed,
                        const __nv_bfloat16* __restrict__ w,
                        float* __restrict__ out, int V, int O, int K, int kz,
                        int cin, int center_shift, Geometry geo) {
  constexpr int MT = kMt<COUT>;
  constexpr int TO = kTileRows<COUT>;
  constexpr int LDW = COUT + 8;
  constexpr int NT = COUT / 8;          // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = geo.lda;
  const int nbits = K * kz;
  const int nwords = (nbits + 31) / 32;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  int* word = reinterpret_cast<int*>(stages + kStages * geo.tap_elems);
  int* srcs = word + TO * K;            // (listed tap, row) source rows
  unsigned* tapm = reinterpret_cast<unsigned*>(srcs + nbits * TO);
  int* taps = reinterpret_cast<int*>(tapm + nwords);   // j * K + k
  int* tapjk = taps + nbits;                           // k | j << 16
  int* ntaps = tapjk + nbits;

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TO;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Where Cin is not a multiple of 16, zero the stages once: the pad
  // columns (cin..cin_pad) of the rows and the pad rows of the weights are
  // never copied and must read zero.
  if (cin != geo.cin_pad) {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kStages * geo.tap_elems * 2 / 16; i += kMmaThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int n = tile_taps<kMmaThreads, TO>(packed, b, o0, V, O, K, kz,
                                           center_shift, word, srcs, tapm,
                                           taps, tapjk, ntaps);

  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * V * cin;
  // Copies of listed tap q into stage q % kStages; one commit group per
  // call, empty past the list, so that wait_group counts taps.
  auto copy_tap = [&](int q) {
    if (q < n) {
      __nv_bfloat16* As = stages + (q % kStages) * geo.tap_elems;
      const int* st = srcs + q * TO;
      if (geo.xvec == 8)
        gather_rows<8, TO>(As, lda, xb, st, cin, geo.pshift);
      else if (geo.xvec == 4)
        gather_rows<4, TO>(As, lda, xb, st, cin, geo.pshift);
      else
        gather_rows<1, TO>(As, lda, xb, st, cin, geo.pshift);
      stage_weights<COUT>(As + geo.a_elems,
                          w + static_cast<size_t>(taps[q]) * cin * COUT, cin);
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.f;

  // ldmatrix row addresses: A rows warp*16*MT + (lane & 15), k half
  // lane >> 4; B (k, n) rows (lane & 7) + 8 * ((lane >> 3) & 1), n half
  // lane >> 4.
  const int wrow = warp * 16 * MT;
  const int a_off = (wrow + (lane & 15)) * lda + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDW +
                    (lane >> 4) * 8;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) copy_tap(q);
  for (int q = 0; q < n; ++q) {
    cp_async_wait<kStages - 2>();       // tap q's copies have landed
    __syncthreads();                    // for every thread; stage q-1 free
    copy_tap(q + kStages - 1);
    const __nv_bfloat16* As = stages + (q % kStages) * geo.tap_elems;
    const __nv_bfloat16* Ws = As + geo.a_elems;
    for (int k0 = 0; k0 < geo.cin_pad; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(a[m], As + a_off + m * 16 * lda + k0);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Ws + b_off + k0 * LDW + np * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * np], a[m], bf[0], bf[1]);
          mma_bf16(acc[m][2 * np + 1], a[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 at row lane / 4, columns 2 (lane % 4) + {0, 1};
  // c2, c3 eight rows below.
  float* ob = out + static_cast<size_t>(b) * O * COUT + (lane & 3) * 2;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = o0 + wrow + m * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (row < O)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * COUT +
                                   nt * 8) = make_float2(acc[m][nt][0],
                                                         acc[m][nt][1]);
      if (row + 8 < O)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(row + 8) * COUT +
                                   nt * 8) = make_float2(acc[m][nt][2],
                                                         acc[m][nt][3]);
    }
  }
}

// --------------------------------------------------------------------------
// fp32: CUDA cores
// --------------------------------------------------------------------------

constexpr int kSkip = -2;   // source row of a band that skips the tap

// Per COUT: a thread's block of partial sums (RM rows x RN channels over
// 1 / KS of the input channels) and the warps of a block.
template <int COUT> struct F32Block;
template <> struct F32Block<16> {
  static constexpr int RM = 4, RN = 4, KS = 2, WARPS = 4;
};
template <> struct F32Block<32> {
  static constexpr int RM = 4, RN = 4, KS = 1, WARPS = 4;
};
template <> struct F32Block<64> {
  static constexpr int RM = 4, RN = 8, KS = 2, WARPS = 4;
};
template <> struct F32Block<128> {
  static constexpr int RM = 4, RN = 8, KS = 1, WARPS = 8;
};

// G = COUT / RN threads share a row and a split of the input channels; a
// warp is KS splits of TR = 32 / (G KS) rows of threads, whose rows (TR
// apart) make its band of BAND contiguous rows; a tile is WARPS bands.
// ops/window_conv_cuda.py::F32_GEOMETRY holds (TO, BAND).
template <int COUT>
struct F32Tile : F32Block<COUT> {
  using F32Block<COUT>::RM;
  using F32Block<COUT>::RN;
  using F32Block<COUT>::KS;
  using F32Block<COUT>::WARPS;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int G = COUT / RN;
  static constexpr int TR = 32 / (G * KS);
  static constexpr int BAND = TR * RM;
  static constexpr int TO = WARPS * BAND;
};

// One piece of VEC fp32 values global -> shared by cp.async (16 or 4
// bytes); source size 0 (zero fill) where !valid.
template <int VEC>
__device__ __forceinline__ void copy_f32(float* dst, const float* src,
                                         bool valid) {
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// Gathers the rows of one tap into As (rows of lda floats) from srcs in
// pieces of VEC values, consecutive threads on consecutive pieces of a
// row: a row of source -1 is zero-filled, one of a band that skips the
// tap (kSkip) is not copied. pshift as gather_rows's.
template <int VEC, int TO, int NT>
__device__ __forceinline__ void gather_f32(float* As, int lda,
                                           const float* xb, const int* srcs,
                                           int cin, int pshift) {
  const int per_row = cin / VEC;
  for (int i = threadIdx.x; i < TO * per_row; i += NT) {
    const int r = pshift >= 0 ? i >> pshift : i / per_row;
    const int s = srcs[r];
    if (s == kSkip) continue;
    const int c = (i - r * per_row) * VEC;
    copy_f32<VEC>(As + r * lda + c,
                  xb + static_cast<size_t>(s < 0 ? 0 : s) * cin + c, s >= 0);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Launch geometry of the fp32 kernel, set by the host.
struct F32Layout {
  int cinp, lda;             // Cin rounded up to 4 KS; row stride (floats)
  int a_elems, tap_elems;    // one stage: rows (TO x lda), W (cinp x COUT)
  int xvec, pshift;          // row piece (4 or 1 floats); as Geometry's
};

template <int COUT>
__global__ void __launch_bounds__(F32Tile<COUT>::THREADS)
window_conv_f32_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ packed,
                       const float* __restrict__ w, float* __restrict__ out,
                       int V, int O, int K, int kz, int cin,
                       int center_shift, F32Layout lay) {
  using T = F32Tile<COUT>;
  constexpr int RM = T::RM, RN = T::RN, G = T::G, TR = T::TR;
  constexpr int BAND = T::BAND, TO = T::TO, NT = T::THREADS;
  constexpr int WARPS = T::WARPS, KS = T::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nbits = K * kz;
  const int nwords = (nbits + 31) / 32;
  float* stages = reinterpret_cast<float*>(smem);
  int* word = reinterpret_cast<int*>(stages + kStages * lay.tap_elems);
  int* srcs = word + TO * K;            // (listed tap, row) source rows
  unsigned* tapm = reinterpret_cast<unsigned*>(srcs + nbits * TO);
  int* taps = reinterpret_cast<int*>(tapm + nwords);   // j * K + k
  int* tapjk = taps + nbits;                           // k | j << 16
  int* ntaps = tapjk + nbits;
  // (listed tap, warp): does any row of the warp's band read a row
  unsigned char* runs = reinterpret_cast<unsigned char*>(ntaps + 1);

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TO;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Where Cin is not a multiple of 4 KS, zero the stages once: the pad
  // columns of the rows and the pad rows of the weights are never copied.
  if (cin != lay.cinp) {
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < kStages * lay.tap_elems / 4; i += NT)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n = tile_taps<NT, TO>(packed, b, o0, V, O, K, kz, center_shift,
                                  word, srcs, tapm, taps, tapjk, ntaps);
  // The warps that run each listed tap; the rows of the others' bands are
  // marked kSkip and not copied.
  for (int i = tid; i < n * WARPS; i += NT) {
    int* s = srcs + (i / WARPS) * TO + (i % WARPS) * BAND;
    bool any = false;
#pragma unroll
    for (int r = 0; r < BAND; ++r) any |= s[r] >= 0;
    runs[i] = any;
    if (!any)
#pragma unroll
      for (int r = 0; r < BAND; ++r) s[r] = kSkip;
  }
  __syncthreads();

  const float* xb = x + static_cast<size_t>(b) * V * cin;
  // Copies of listed tap q into stage q % kStages; one commit group per
  // call, empty past the list, so that wait_group counts taps.
  auto copy_tap = [&](int q) {
    if (q < n) {
      float* As = stages + (q % kStages) * lay.tap_elems;
      const int* st = srcs + q * TO;
      if (lay.xvec == 4)
        gather_f32<4, TO, NT>(As, lay.lda, xb, st, cin, lay.pshift);
      else
        gather_f32<1, TO, NT>(As, lay.lda, xb, st, cin, lay.pshift);
      float* Ws = As + lay.a_elems;
      const float* wt = w + static_cast<size_t>(taps[q]) * cin * COUT;
      for (int i = tid; i < cin * (COUT / 4); i += NT)
        copy_f32<4>(Ws + 4 * i, wt + 4 * i, true);
    }
    cp_async_commit();
  };

  // Thread (ks, rr, g) of a warp: rows band + rr + i TR (i < RM), output
  // channels g * 4 + p * G * 4 + {0..3} (p < RN / 4), input channels
  // [ks, ks + 1) * kper: a quarter warp reads one or two rows and up to 8
  // consecutive float4s of a weight row.
  const int g = lane % G, rr = (lane / G) % TR, ks = lane / (G * TR);
  const int row0 = warp * BAND + rr;
  const int kper = lay.cinp / KS;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) copy_tap(q);
  for (int q = 0; q < n; ++q) {
    cp_async_wait<kStages - 2>();       // tap q's copies have landed
    __syncthreads();                    // for every thread; stage q-1 free
    copy_tap(q + kStages - 1);
    if (!runs[q * WARPS + warp]) continue;      // warp-uniform
    const float* As = stages + (q % kStages) * lay.tap_elems +
                      row0 * lay.lda + ks * kper;
    const float* Ws = stages + (q % kStages) * lay.tap_elems + lay.a_elems +
                      ks * kper * COUT + g * 4;
    for (int c = 0; c < kper; c += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + i * TR * lay.lda + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[RN];
#pragma unroll
        for (int p = 0; p < RN / 4; ++p) {
          const float4 t = *reinterpret_cast<const float4*>(
              Ws + (c + kk) * COUT + p * G * 4);
          wv[4 * p] = t.x;
          wv[4 * p + 1] = t.y;
          wv[4 * p + 2] = t.z;
          wv[4 * p + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = lane_of(a[i], kk);
#pragma unroll
          for (int n2 = 0; n2 < RN; ++n2)
            acc[i][n2] = fmaf(av, wv[n2], acc[i][n2]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // Sum the KS splits' partial sums (lanes G TR apart); split ks writes
  // the rows i = ks mod KS.
#pragma unroll
  for (int off = G * TR; off < 32; off *= 2)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);

  float* ob = out + (static_cast<size_t>(b) * O + o0) * COUT + g * 4;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + i * TR;
    if (i % KS == ks && o0 + r < O) {
#pragma unroll
      for (int p = 0; p < RN / 4; ++p)
        *reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * COUT +
                                   p * G * 4) =
            make_float4(acc[i][4 * p], acc[i][4 * p + 1], acc[i][4 * p + 2],
                        acc[i][4 * p + 3]);
    }
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// Lets kern use smem bytes of dynamic shared memory on the current device.
// The attribute is set once per kernel, device and size, not at every
// launch, so that a launch inside a CUDA graph capture makes no other CUDA
// call.
template <int COUT, bool BF16>
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

// Widest piece (8, 4 or 1 bf16 values) that every row of n values starting
// at p allows.
int piece(const void* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n % 8 == 0 && a % 16 == 0) return 8;
  if (n % 4 == 0 && a % 8 == 0) return 4;
  return 1;
}

// log2(n) where n is a power of two, else -1.
int log2_exact(int n) { return n & (n - 1) ? -1 : __builtin_ctz(n); }

template <int COUT>
Geometry geometry(int cin) {
  Geometry geo;
  geo.cin_pad = (cin + 15) & ~15;
  geo.lda = geo.cin_pad + 8;
  geo.a_elems = kTileRows<COUT> * geo.lda;
  geo.tap_elems = geo.a_elems + geo.cin_pad * (COUT + 8);
  geo.xvec = geo.pshift = 0;
  return geo;
}

// Shared memory of the prologue: words, source rows, tap mask, tap lists.
size_t prologue_bytes(int rows, int K, int kz) {
  const size_t nbits = static_cast<size_t>(K) * kz;
  return (rows * (K + nbits) + (nbits + 31) / 32 + 2 * nbits + 1) *
         sizeof(int);
}

// Dynamic shared memory of one bf16 block: the ring of stages, then the
// prologue's arrays.
template <int COUT>
size_t smem_bf16(int cin, int K, int kz) {
  return kStages * static_cast<size_t>(geometry<COUT>(cin).tap_elems) *
             sizeof(__nv_bfloat16) +
         prologue_bytes(kTileRows<COUT>, K, kz);
}

template <int COUT>
int launch_bf16(const void* x, const void* packed, const void* w, void* out,
                int B, int V, int O, int K, int kz, int cin, int center_shift,
                cudaStream_t stream) {
  constexpr int TO = kTileRows<COUT>;
  Geometry geo = geometry<COUT>(cin);
  geo.xvec = piece(x, cin);
  geo.pshift = log2_exact(cin / geo.xvec);
  const size_t smem = smem_bf16<COUT>(cin, K, kz);
  auto kern = window_conv_bf16_kernel<COUT>;
  cudaError_t err =
      allow_smem<COUT, true>(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((O + TO - 1) / TO, B);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int32_t*>(packed),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), V, O, K,
      kz, cin, center_shift, geo);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
F32Layout f32_layout(int cin) {
  F32Layout lay;
  constexpr int step = 4 * F32Tile<COUT>::KS;
  lay.cinp = (cin + step - 1) / step * step;
  lay.lda = lay.cinp + 4;                 // an odd number of float4s
  if ((lay.lda / 4) % 2 == 0) lay.lda += 4;
  lay.a_elems = F32Tile<COUT>::TO * lay.lda;
  lay.tap_elems = lay.a_elems + lay.cinp * COUT;
  lay.xvec = lay.pshift = 0;
  return lay;
}

// Dynamic shared memory of one fp32 block: the ring of stages, the
// prologue's arrays, then a byte per (tap, warp).
template <int COUT>
size_t smem_f32(int cin, int K, int kz) {
  using T = F32Tile<COUT>;
  return kStages * static_cast<size_t>(f32_layout<COUT>(cin).tap_elems) *
             sizeof(float) +
         prologue_bytes(T::TO, K, kz) + static_cast<size_t>(K) * kz * T::WARPS;
}

template <int COUT>
int launch_f32(const void* x, const void* packed, const void* w, void* out,
               int B, int V, int O, int K, int kz, int cin, int center_shift,
               cudaStream_t stream) {
  constexpr int TO = F32Tile<COUT>::TO;
  F32Layout lay = f32_layout<COUT>(cin);
  lay.xvec = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 4 : 1;
  lay.pshift = log2_exact(cin / lay.xvec);
  const size_t smem = smem_f32<COUT>(cin, K, kz);
  auto kern = window_conv_f32_kernel<COUT>;
  cudaError_t err =
      allow_smem<COUT, false>(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((O + TO - 1) / TO, B);
  kern<<<grid, F32Tile<COUT>::THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(packed),
      static_cast<const float*>(w), static_cast<float*>(out), V, O, K, kz, cin,
      center_shift, lay);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
int launch(const void* x, const void* packed, const void* w, void* out,
           int B, int V, int O, int K, int kz, int cin, int center_shift,
           int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<COUT>(x, packed, w, out, B, V, O, K, kz, cin,
                             center_shift, stream);
  return launch_f32<COUT>(x, packed, w, out, B, V, O, K, kz, cin,
                          center_shift, stream);
}

template <int COUT>
long long smem_bytes(int cin, int K, int kz, int bf16) {
  return static_cast<long long>(bf16 ? smem_bf16<COUT>(cin, K, kz)
                                     : smem_f32<COUT>(cin, K, kz));
}

// Blocks of the kernel one SM holds at these operands (registers, threads
// and shared memory), or -1 on a CUDA error.
template <int COUT>
int blocks_per_sm(int cin, int K, int kz, int bf16) {
  const size_t smem = static_cast<size_t>(smem_bytes<COUT>(cin, K, kz, bf16));
  const void* kern =
      bf16 ? reinterpret_cast<const void*>(window_conv_bf16_kernel<COUT>)
           : reinterpret_cast<const void*>(window_conv_f32_kernel<COUT>);
  cudaError_t err = bf16 ? allow_smem<COUT, true>(kern, smem)
                         : allow_smem<COUT, false>(kern, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, bf16 ? kMmaThreads : F32Tile<COUT>::THREADS, smem);
  return err == cudaSuccess ? n : -1;
}

template <int COUT>
void f32_geometry(int* g) {
  using T = F32Tile<COUT>;
  const int vals[] = {T::TO, T::WARPS, T::BAND, kStages, T::RM, T::RN, T::KS};
  for (int i = 0; i < 7; ++i) g[i] = vals[i];
}

}  // namespace

#define WINDOW_CONV_COUTS(X) X(16) X(32) X(64) X(128)

// Bytes of dynamic shared memory one block of the kernel for these
// operands needs (-1 for an unsupported COUT). The wrapper holds it
// against the card's opt-in limit per block before launching.
extern "C" long long window_conv_smem(int cin, int cout, int K, int kz,
                                      int bf16) {
#define CASE(C) case C: return smem_bytes<C>(cin, K, kz, bf16);
  switch (cout) {
    WINDOW_CONV_COUTS(CASE)
    default: return -1;
  }
#undef CASE
}

// Blocks of the kernel for these operands that one SM of the current
// device holds at once (0: none fits; -1: unsupported COUT or a CUDA
// error).
extern "C" int window_conv_blocks_per_sm(int cin, int cout, int K, int kz,
                                         int bf16) {
#define CASE(C) case C: return blocks_per_sm<C>(cin, K, kz, bf16);
  switch (cout) {
    WINDOW_CONV_COUTS(CASE)
    default: return -1;
  }
#undef CASE
}

// The fp32 kernel's geometry at COUT into g[0..6]: tile rows, warps, band
// rows (the rows a warp multiplies), stages, a thread's rows and channels,
// and the lanes that split the input channels. Returns 0, or -1 for an
// unsupported COUT.
extern "C" int window_conv_geometry(int cout, int* g) {
#define CASE(C) case C: f32_geometry<C>(g); return 0;
  switch (cout) {
    WINDOW_CONV_COUTS(CASE)
    default: return -1;
  }
#undef CASE
}

// Returns the cudaError_t of the launch (0 on success). The wrapper
// (ops/window_conv_cuda.py) checks shapes, types, the supported COUT
// values {16, 32, 64, 128}, 16-byte aligned weights and the shared memory
// (window_conv_smem) before calling.
extern "C" int window_conv_launch(const void* x, const void* packed,
                                  const void* w, void* out, int B, int V,
                                  int O, int K, int kz, int cin, int cout,
                                  int center_shift, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(C)                                                       \
  case C:                                                             \
    return launch<C>(x, packed, w, out, B, V, O, K, kz, cin,          \
                     center_shift, bf16, s);
  switch (cout) {
    WINDOW_CONV_COUTS(CASE)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
