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
// bf16 (the path SECOND serves): window_conv_bf16_kernel, on the tensor
// cores. A block of 4 warps owns a tile of output rows of one sample and
// all COUT channels: 64 rows for COUT 16 and 32 (16 a warp), 128 for COUT
// 64 (two m16 tiles a warp, so that each weight fragment serves both).
// Each warp keeps fp32 accumulators for its rows over every tap. The block
// reads its tile's packed words once, ORs the presence bits of each column
// over the tile (warp reductions), lists the taps that any row has
// (ballots; absent taps cost nothing) and finds every row's source row for
// each listed tap, once, into shared memory. The listed taps then run
// through a ring of 2 shared-memory stages, each holding one tap's
// gathered rows (tile x Cin) and its (Cin, COUT) weight slice, both copied
// global -> shared by cp.async in 16-byte pieces (8-byte where Cin = 4;
// consecutive threads on consecutive pieces of a row; an absent row or one
// past V is a zero-fill copy of source size 0). Tap q+1's copies are in
// flight while tap q multiplies, with one barrier per tap. The products are
// mma.sync.m16n8k16 bf16 -> fp32: A fragments by ldmatrix from the
// gathered rows, B fragments by ldmatrix.trans from the row-major weights.
// Shared rows are padded by 16 bytes (row stride an odd multiple of 16
// bytes), so the 8 rows an ldmatrix reads fall in 8 distinct bank groups.
// Cin is zero-padded to the MMA depth of 16 in shared memory (Cin = 4 runs
// 4x the useful products; the first conv is paced by its 27 taps' round
// trips, not by them). Each output row is written once, as float2 stores;
// no atomics. mma.sync and not wgmma: a wgmma version of this kernel
// (gathered rows K-major and weights N-major in unswizzled core-matrix
// layouts, one descriptor pair per k-step, an async-proxy fence and a wait
// on each tap's products) gave the same results and ran slower on the
// H100 at SECOND's shapes, where the gather, not the products, paces it.
//
// fp32: window_conv_f32_kernel, the previous (v2) design on the fp32 CUDA
// cores, not redesigned: the tensor cores would compute fp32 as TF32 and
// change its results. Only the card-vs-CPU check and the fp32 tests run it.
// A block of 256 threads owns 128 output rows; thread (r, g) keeps 4 rows x
// 8 channels; each tap's rows are gathered into shared memory as fp32.
//
// Bound (bf16, SECOND's shapes, B=2, O=V=20000): a (64,64) conv must read
// the ~39000 input rows its taps reach (128 B each) and the plan once and
// write 10 MB of fp32 output, ~16 MB and ~5 us at 3.35 TB/s; its present
// taps are ~2.6 GFLOP, ~3 us at the bf16 tensor rate: bytes bound. What
// still separates the bf16 kernel from that bound (PERF.md has its times):
// every tile restages each tap's weights from L2 (~69 MB a (64,64) conv
// at 128-row tiles, more than the ~41 MB of rows its taps gather, each
// input row once per tap that reaches it); the products run densely over
// the tile for every tap any row has (8.9 GFLOP where 2.6 are useful);
// and
// each tile pays a prologue (words, tap list, source rows) and one round
// trip per tap with one tap of copies in flight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kPackShift = 24;
constexpr unsigned kPackMask = (1u << kPackShift) - 1u;

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
constexpr int kStages = 2;               // cp.async ring depth, in taps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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
  const int nbits = K * kz;             // tap bit k * kz + j
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
  for (int i = tid; i < nwords; i += kMmaThreads) tapm[i] = 0u;
  const int live = min(TO, O - o0) * K;
  const int32_t* pb = packed + (static_cast<size_t>(b) * O + o0) * K;
  for (int i = tid; i < TO * K; i += kMmaThreads)
    word[i] = i < live ? pb[i] : 0;     // rows past O: no present bit
  __syncthreads();

  // The taps any row of the tile has: per-thread ORs over its rows, 64
  // tap bits at a time, then one OR per warp into tapm.
  const unsigned tapbits = (1u << kz) - 1u;
  for (int base = 0; base < nbits; base += 64) {
    unsigned long long m = 0;
    for (int r = tid; r < TO; r += kMmaThreads)
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
  for (int q = 0; q < n; ++q) {
    const int k = tapjk[q] & 0xffff, j = tapjk[q] >> 16;
    const bool center = center_shift && k == K / 2;
    for (int r = tid; r < TO; r += kMmaThreads)
      srcs[q * TO + r] = source_row(word, r, k, j, K, o0 + r, V, center);
  }
  __syncthreads();

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

// Lets kern (the kernel of COUT and BF16) use smem bytes of dynamic shared
// memory on the current device. The attribute is set once per device and
// size, not at every launch, so that a launch inside a CUDA graph capture
// makes no other CUDA call.
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

// Dynamic shared memory of one bf16 block: the ring of stages, then the
// tile's packed words, source rows, tap mask and tap lists.
template <int COUT>
size_t smem_bf16(int cin, int K, int kz) {
  const size_t nbits = static_cast<size_t>(K) * kz;
  return kStages * static_cast<size_t>(geometry<COUT>(cin).tap_elems) *
             sizeof(__nv_bfloat16) +
         (kTileRows<COUT> * (K + nbits) + (nbits + 31) / 32 + 2 * nbits + 1) *
             sizeof(int);
}

template <int COUT>
int launch_bf16(const void* x, const void* packed, const void* w, void* out,
                int B, int V, int O, int K, int kz, int cin, int center_shift,
                cudaStream_t stream) {
  constexpr int TO = kTileRows<COUT>;
  Geometry geo = geometry<COUT>(cin);
  geo.xvec = piece(x, cin);
  const int per_row = cin / geo.xvec;
  geo.pshift = per_row & (per_row - 1) ? -1 : __builtin_ctz(per_row);
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

// --------------------------------------------------------------------------
// fp32: CUDA cores (v2, not redesigned)
// --------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kCpt = 8;                 // output channels per thread

template <int COUT>
struct Tile {
  static constexpr int G = COUT / kCpt;           // channel groups
  static constexpr int S = kThreads / G;          // thread rows
  static constexpr int RPT = COUT / 16;          // rows per thread
  static constexpr int TO = S * RPT;              // output rows per block
};

template <int COUT>
__global__ void __launch_bounds__(kThreads)
window_conv_f32_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ packed,
                       const float* __restrict__ w, float* __restrict__ out,
                       int V, int O, int K, int kz, int cin,
                       int center_shift) {
  using Tl = Tile<COUT>;
  constexpr int G = Tl::G, S = Tl::S, RPT = Tl::RPT, TO = Tl::TO;
  extern __shared__ __align__(16) float smem_f[];
  const int ldx = cin | 1;              // odd row stride: no bank conflicts
  float* xs = smem_f;                   // (TO, ldx) gathered rows
  float* ws = xs + ((TO * ldx + 3) & ~3);   // (cin, COUT), 16-byte aligned
  int* word = reinterpret_cast<int*>(ws + cin * COUT);   // (TO,)
  int* src = word + TO;                                  // (TO,)

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TO;
  const int tid = threadIdx.x;
  const int r = tid / G;
  const int g = tid % G;
  const int cc = K / 2;
  const float* xb = x + static_cast<size_t>(b) * V * cin;

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
        xs[rr * ldx + c] = s >= 0 ? xb[static_cast<size_t>(s) * cin + c] : 0.f;
      }
      const float* wt = w + static_cast<size_t>(j * K + k) * cin * COUT;
      for (int i = tid; i < cin * COUT; i += kThreads) ws[i] = wt[i];
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

// Dynamic shared memory of one fp32 block: gathered rows, weights, words
// and source rows.
template <int COUT>
size_t smem_f32(int cin) {
  constexpr int TO = Tile<COUT>::TO;
  return (((static_cast<size_t>(TO) * (cin | 1) + 3) & ~3) +
          static_cast<size_t>(cin) * COUT) * sizeof(float) +
         2 * TO * sizeof(int);
}

template <int COUT>
int launch_f32(const void* x, const void* packed, const void* w, void* out,
               int B, int V, int O, int K, int kz, int cin, int center_shift,
               cudaStream_t stream) {
  constexpr int TO = Tile<COUT>::TO;
  const size_t smem = smem_f32<COUT>(cin);
  auto kern = window_conv_f32_kernel<COUT>;
  cudaError_t err =
      allow_smem<COUT, false>(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((O + TO - 1) / TO, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(packed),
      static_cast<const float*>(w), static_cast<float*>(out), V, O, K, kz, cin,
      center_shift);
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
                                     : smem_f32<COUT>(cin));
}

}  // namespace

// Bytes of dynamic shared memory one block of the kernel for these
// operands needs (-1 for an unsupported COUT). The wrapper holds it
// against the card's opt-in limit per block before launching.
extern "C" long long window_conv_smem(int cin, int cout, int K, int kz,
                                      int bf16) {
  switch (cout) {
    case 16: return smem_bytes<16>(cin, K, kz, bf16);
    case 32: return smem_bytes<32>(cin, K, kz, bf16);
    case 64: return smem_bytes<64>(cin, K, kz, bf16);
    default: return -1;
  }
}

// Returns the cudaError_t of the launch (0 on success). The wrapper
// (ops/window_conv_cuda.py) checks shapes, types, the supported COUT
// values {16, 32, 64} (SECOND's middle), 16-byte aligned bf16 weights and
// the shared memory (window_conv_smem) before calling.
extern "C" int window_conv_launch(const void* x, const void* packed,
                                  const void* w, void* out, int B, int V,
                                  int O, int K, int kz, int cin, int cout,
                                  int center_shift, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch<16>(x, packed, w, out, B, V, O, K, kz, cin,
                               center_shift, bf16, s);
    case 32: return launch<32>(x, packed, w, out, B, V, O, K, kz, cin,
                               center_shift, bf16, s);
    case 64: return launch<64>(x, packed, w, out, B, V, O, K, kz, cin,
                               center_shift, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
