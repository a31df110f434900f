// Native host-plan builders and host voxelizers: the C++ twins of the numpy
// plain versions in ops/sparse_host.py (point_lin_ref ... build_plan_ref)
// and ops/voxelize_host.py (host_voxelize_ref). Built with g++ at first use
// and bound over a C ABI by csrc/__init__.py::load("hostplan");
// ops/sparse_host.py::_lib() declares each function's argument types.
//
// A copy of det3d_tpu/csrc/hostplan.cc without hp_block_band: that function
// sized the row bands of the TPU's band kernel, and the port's window conv
// (csrc/window_conv.cu) reads any row.
//
// The rulebook plan is pure integer work (quantize, stable sorts, per-column
// bitmap ranks, window queries, candidate dedup) that numpy executes as ~40
// full-array passes per stage; here each stage is one cache-friendly loop.
// Bit-exactness contract: every function mirrors its numpy twin exactly
// (same floor/modulo semantics, same pack layout, same tie-breaking), and
// tests/test_torch_hostplan_native.py asserts raw equality of every plan
// and voxel array against the numpy twins and the JAX package's builders.
//
// Hot-loop choices:
//   * point sort: LSD radix over a 63-bit (key, lin) composite, in place of
//     a comparison stable_sort;
//   * transition dedup: occupancy bitset over output cells scanned in zyx
//     order (replaces sort+unique of ~8V candidates);
//   * bitmap: one 16-byte {base, epoch, bits} struct per BEV column, so a
//     window query costs one cache line, not two array fetches.
//
// hp_transition keeps the inverse rulebook of training behind its
// build_inverse flag; the port does not bind that half yet (build_plan
// raises for train=True). No threads, no OpenMP (fork-safe for loader
// workers).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kSentinel = INT32_MAX;
constexpr int64_t kPackShift = 24;
constexpr int64_t kPackMask = (int64_t{1} << kPackShift) - 1;

inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

inline int64_t floormod(int64_t a, int64_t b) {
  int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Murmur3 finalizer (core/voxelize.py::mix32)
inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Epoch-tagged per-column bitmap: build O(V), query O(1), no per-call
// allocation or clearing of the (h*w)-sized table. Twin of
// sparse_host.py::host_bitmap; base/bits are only ever consumed at columns
// whose presence bits survive packing, so stale slots are unreachable.
// One struct per column = one cache line per query.
struct Col {
  int32_t base;
  uint32_t epoch;
  uint64_t bits;
};

struct Bitmap {
  std::vector<Col> col;
  uint32_t cur = 0;
  int64_t d = 0, h = 0, w = 0;

  void init(int64_t d_, int64_t h_, int64_t w_) {
    d = d_; h = h_; w = w_;
    size_t n = static_cast<size_t>(h * w);
    if (col.size() < n) {
      col.assign(n, Col{0, 0, 0});
      cur = 0;
    }
    if (++cur == 0) {  // epoch wrap: one-time clear
      for (auto& c : col) c.epoch = 0;
      cur = 1;
    }
  }

  // keys: ascending yxz rank keys (sentinel-tailed). rank of a key == its
  // index, so base = index of the column's first key.
  void build(const int64_t* keys, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      if (keys[i] == kSentinel) break;  // sentinels sort last
      Col& c = col[keys[i] / d];
      uint64_t bit = uint64_t{1} << static_cast<uint64_t>(keys[i] % d);
      if (c.epoch != cur) {
        c.epoch = cur;
        c.base = static_cast<int32_t>(i);
        c.bits = bit;
      } else {
        c.bits |= bit;
      }
    }
  }

  inline uint64_t word(int64_t i) const {
    return col[i].epoch == cur ? col[i].bits : 0;
  }
  inline int64_t rank0(int64_t i) const {
    return col[i].epoch == cur ? col[i].base : 0;
  }
};

thread_local Bitmap g_bm_a;  // input-resolution bitmap
thread_local Bitmap g_bm_b;  // transition-output bitmap
thread_local std::vector<uint64_t> g_occ;        // transition occupancy bits
thread_local std::vector<uint64_t> g_radix[2];   // radix sort ping-pong

// yxz rank key of one zyx coord row; kSentinel when out of range / padding.
inline int64_t yxz_key(const int32_t* co, int64_t d, int64_t h, int64_t w) {
  int64_t z = co[0], y = co[1], x = co[2];
  if (z < 0 || z >= d || y < 0 || y >= h || x < 0 || x >= w) return kSentinel;
  return (y * w + x) * d + z;
}

void build_from_coords(Bitmap& bm, const int32_t* coords, int64_t v,
                       int64_t d, int64_t h, int64_t w,
                       std::vector<int64_t>& keys_buf) {
  keys_buf.resize(v);
  for (int64_t i = 0; i < v; ++i)
    keys_buf[i] = yxz_key(coords + 3 * i, d, h, w);
  bm.init(d, h, w);
  bm.build(keys_buf.data(), v);
}

// One packed window entry over K = ky*kx columns with kz presence bits each.
// Twin of _column_windows + _pack_windows: r0 = base + popcount below z0
// (z0 clipped to [0, d-1]), presence = bounds & bit, r0 zeroed when the
// column has no present tap.
inline int32_t packed_column(const Bitmap& bm, int64_t qy, int64_t qx,
                             int64_t z0, int64_t kz, bool row_valid) {
  int64_t d = bm.d, h = bm.h, w = bm.w;
  bool okc = qy >= 0 && qy < h && qx >= 0 && qx < w;
  uint64_t wrd = okc ? bm.word(qy * w + qx) : 0;
  int64_t zc = z0 < 0 ? 0 : (z0 > d - 1 ? d - 1 : z0);
  int64_t r0 = 0;
  if (okc) {
    uint64_t below = wrd & ((uint64_t{1} << static_cast<uint64_t>(zc)) - 1);
    r0 = bm.rank0(qy * w + qx) + __builtin_popcountll(below);
  }
  int32_t pres = 0;
  if (okc && row_valid) {
    for (int64_t j = 0; j < kz; ++j) {
      int64_t zj = z0 + j;
      if (zj >= 0 && zj < d && ((wrd >> static_cast<uint64_t>(zj)) & 1))
        pres |= int32_t{1} << (kPackShift + j);
    }
  }
  if (pres == 0) r0 = 0;  // canonical form (sparse_host.py::_pack_windows)
  return static_cast<int32_t>(r0 & kPackMask) | pres;
}

// Stable LSD radix sort of packed (sortkey, original index) words.
// Entries are (key << kIdxBits) | idx with idx < 2^kIdxBits; counting sort
// per byte is stable, so equal keys keep ascending idx — exactly
// np.lexsort's tie behavior. Skips constant-byte passes.
constexpr int kIdxBits = 22;  // up to 4M points per cloud
void radix_sort(std::vector<uint64_t>& a, std::vector<uint64_t>& tmp) {
  const size_t n = a.size();
  tmp.resize(n);
  uint64_t all_or = 0, all_and = ~uint64_t{0};
  for (size_t i = 0; i < n; ++i) { all_or |= a[i]; all_and &= a[i]; }
  uint64_t varying = all_or ^ all_and;
  size_t count[256];
  for (int pass = 0; pass < 8; ++pass) {
    int shift = pass * 8;
    if (((varying >> shift) & 0xFF) == 0) continue;  // constant byte
    std::memset(count, 0, sizeof(count));
    for (size_t i = 0; i < n; ++i) ++count[(a[i] >> shift) & 0xFF];
    size_t sum = 0;
    for (int b = 0; b < 256; ++b) { size_t c = count[b]; count[b] = sum; sum += c; }
    for (size_t i = 0; i < n; ++i) tmp[count[(a[i] >> shift) & 0xFF]++] = a[i];
    a.swap(tmp);
  }
}

}  // namespace

extern "C" {

// points (P, C) f32 -> (P,) int32 xyz-major linear voxel ids (twin of
// sparse_host.py::point_lin_ref; fp32 subtract/divide/floor like the device).
void hp_point_lin(const float* pts, int64_t p_rows, int64_t c,
                  int64_t n_valid, const float* vmin, const float* vs,
                  int64_t gx, int64_t gy, int64_t gz, int32_t* out) {
  for (int64_t i = 0; i < p_rows; ++i) {
    if (i >= n_valid) { out[i] = kSentinel; continue; }
    const float* pt = pts + i * c;
    int64_t cc[3];
    bool ok = true;
    const int64_t g[3] = {gx, gy, gz};
    for (int64_t dd = 0; dd < 3; ++dd) {
      float q = (pt[dd] - vmin[dd]) / vs[dd];
      cc[dd] = static_cast<int64_t>(std::floor(q));
      ok &= cc[dd] >= 0 && cc[dd] < g[dd];
    }
    out[i] = ok ? static_cast<int32_t>(cc[0] + cc[1] * gx + cc[2] * gx * gy)
                : kSentinel;
  }
}

// Stable lexsort of points by (key, lin) — twin of point_order_ref.
// mode: 0 = hashed (murmur3 of lin), 1 = yxz. Sort key fits 41 bits
// (sortkey 32 + lin-rank bits folded below, see pack), so the packed
// (key, lin, idx) word is radix-sortable in one array.
void hp_point_order(const int32_t* lin, int64_t p_rows, int64_t gx,
                    int64_t gy, int64_t gz, int32_t mode, int32_t* out) {
  // pack: (key, lin) lexicographic == single composite because both are
  // bounded: key < 2^32, lin < 2^31. Composite (key << 31 | lin) < 2^63
  // would overflow the idx field, so sort in two chained stable passes:
  // first by lin (radix over (lin << kIdxBits) | idx), then by key.
  // One combined pass is possible when key < 2^(42-kIdxBits); instead we
  // exploit that idx needs 22 bits and (key, lin) needs 63 — too many —
  // so run TWO stable radix sorts: by lin, then by key (LSD composition
  // of stable sorts == lexsort by (key, lin)).
  std::vector<uint64_t>& a = g_radix[0];
  std::vector<uint64_t>& tmp = g_radix[1];
  a.resize(p_rows);
  // pass 1: stable sort by lin (lin >= 0, < 2^31)
  for (int64_t i = 0; i < p_rows; ++i)
    a[i] = (static_cast<uint64_t>(static_cast<uint32_t>(lin[i]))
            << kIdxBits) | static_cast<uint64_t>(i);
  radix_sort(a, tmp);
  // pass 2: stable sort by key, carrying the lin-sorted order
  for (int64_t i = 0; i < p_rows; ++i) {
    int64_t j = static_cast<int64_t>(a[i] & ((uint64_t{1} << kIdxBits) - 1));
    int64_t l = lin[j];
    uint64_t key;
    if (mode == 1) {
      key = l == kSentinel
                ? static_cast<uint64_t>(kSentinel)
                : static_cast<uint64_t>(
                      ((l / gx) % gy * gx + l % gx) * gz + l / (gx * gy));
    } else {
      key = l == kSentinel
                ? uint64_t{0xFFFFFFFF}
                : static_cast<uint64_t>(mix32(static_cast<uint32_t>(l)));
    }
    a[i] = (key << kIdxBits) | static_cast<uint64_t>(j);
  }
  radix_sort(a, tmp);
  for (int64_t i = 0; i < p_rows; ++i)
    out[i] = static_cast<int32_t>(a[i] & ((uint64_t{1} << kIdxBits) - 1));
}

// Voxel coord rows from sorted ids — twin of voxel_coords_ref.
void hp_voxel_coords(const int32_t* lin, const int32_t* perm, int64_t p_rows,
                     int64_t gx, int64_t gy, int64_t max_voxels,
                     int32_t* out) {
  for (int64_t i = 0; i < max_voxels * 3; ++i) out[i] = -1;
  int64_t n = 0, prev = -1;
  for (int64_t i = 0; i < p_rows && n < max_voxels; ++i) {
    int64_t l = lin[perm[i]];
    if (l == kSentinel) break;
    if (l != prev) {
      out[n * 3 + 0] = static_cast<int32_t>(l / (gx * gy));
      out[n * 3 + 1] = static_cast<int32_t>((l / gx) % gy);
      out[n * 3 + 2] = static_cast<int32_t>(l % gx);
      ++n;
      prev = l;
    }
  }
}

// Packed submanifold window rulebook — twin of subm_windows_ref. coords
// must be in yxz rank order; out is (V, k1*k2) int32.
void hp_subm_windows(const int32_t* coords, int64_t v, int64_t d, int64_t h,
                     int64_t w, int64_t k0, int64_t k1, int64_t k2,
                     int32_t* out) {
  std::vector<int64_t> keys;
  build_from_coords(g_bm_a, coords, v, d, h, w, keys);
  const int64_t p0 = k0 / 2, p1 = k1 / 2, p2 = k2 / 2;
  for (int64_t i = 0; i < v; ++i) {
    const int32_t* co = coords + 3 * i;
    bool row_valid = co[0] >= 0;
    int64_t z0 = co[0] - p0;
    int32_t* row = out + i * k1 * k2;
    for (int64_t a = 0; a < k1; ++a)
      for (int64_t b = 0; b < k2; ++b)
        row[a * k2 + b] = packed_column(g_bm_a, co[1] + a - p1,
                                        co[2] + b - p2, z0, k0, row_valid);
  }
}

// Packed strided-conv window rulebook in INPUT rank space — twin of
// down_windows_ref. in_coords must be in yxz rank order at (d, h, w).
void hp_down_windows(const int32_t* out_coords, int64_t vo,
                     const int32_t* in_coords, int64_t vi, int64_t d,
                     int64_t h, int64_t w, const int64_t* k, const int64_t* s,
                     const int64_t* p, int32_t* out) {
  std::vector<int64_t> keys;
  build_from_coords(g_bm_a, in_coords, vi, d, h, w, keys);
  for (int64_t i = 0; i < vo; ++i) {
    const int32_t* oc = out_coords + 3 * i;
    bool row_valid = oc[0] >= 0;
    int64_t sz = oc[0] * s[0], sy = oc[1] * s[1], sx = oc[2] * s[2];
    int64_t z0 = sz - p[0];
    int32_t* row = out + i * k[1] * k[2];
    for (int64_t a = 0; a < k[1]; ++a)
      for (int64_t b = 0; b < k[2]; ++b)
        row[a * k[2] + b] = packed_column(g_bm_a, sy + a - p[1],
                                          sx + b - p[2], z0, k[0], row_valid);
  }
}

// Downsample transition — twin of transition_ref(): dedup candidate outputs
// in zyx cell order, cap at max_out, emit rows in yxz rank order; optionally
// the packed inverse rulebook (train). Returns n_kept; *inv_built = 1 when
// the inverse was produced (ncand <= 2 per dim, matching numpy).
int64_t hp_transition(const int32_t* coords, int64_t v, int64_t d, int64_t h,
                      int64_t w, const int64_t* k, const int64_t* s,
                      const int64_t* p, int64_t max_out, int32_t build_inverse,
                      int32_t* out_coords, int32_t* inv, int32_t* inv_built) {
  const int64_t os[3] = {(d + 2 * p[0] - k[0]) / s[0] + 1,
                         (h + 2 * p[1] - k[1]) / s[1] + 1,
                         (w + 2 * p[2] - k[2]) / s[2] + 1};
  int64_t nc[3];
  for (int64_t dd = 0; dd < 3; ++dd) nc[dd] = (k[dd] + s[dd] - 1) / s[dd];
  const int64_t do_ = os[0], ho = os[1], wo = os[2];

  // candidate enumeration (twin of _down_candidates): per dim,
  // o = floor((pd + p)/s) - i, valid iff 0 <= pd + p - o*s < k and in
  // bounds. Dedup + zyx-ascending order via an occupancy bitset over the
  // output grid (cells are zyx-major-linear, so a word scan IS the order).
  const int64_t cells = do_ * ho * wo;
  const size_t nwords = static_cast<size_t>((cells + 63) / 64);
  g_occ.assign(nwords, 0);
  for (int64_t i = 0; i < v; ++i) {
    const int32_t* co = coords + 3 * i;
    if (co[0] < 0 || co[1] < 0 || co[2] < 0) continue;
    int64_t bz = floordiv(co[0] + p[0], s[0]);
    int64_t by = floordiv(co[1] + p[1], s[1]);
    int64_t bx = floordiv(co[2] + p[2], s[2]);
    for (int64_t iz = 0; iz < nc[0]; ++iz) {
      int64_t oz = bz - iz, jz = co[0] + p[0] - oz * s[0];
      if (oz < 0 || oz >= do_ || jz < 0 || jz >= k[0]) continue;
      for (int64_t iy = 0; iy < nc[1]; ++iy) {
        int64_t oy = by - iy, jy = co[1] + p[1] - oy * s[1];
        if (oy < 0 || oy >= ho || jy < 0 || jy >= k[1]) continue;
        for (int64_t ix = 0; ix < nc[2]; ++ix) {
          int64_t ox = bx - ix, jx = co[2] + p[2] - ox * s[2];
          if (ox < 0 || ox >= wo || jx < 0 || jx >= k[2]) continue;
          int64_t cell = (oz * ho + oy) * wo + ox;
          g_occ[cell >> 6] |= uint64_t{1} << (cell & 63);
        }
      }
    }
  }
  std::vector<int64_t> cand;  // zyx-ascending kept prefix (== occ[:max_out])
  cand.reserve(static_cast<size_t>(max_out));
  for (size_t wi = 0; wi < nwords && (int64_t)cand.size() < max_out; ++wi) {
    uint64_t word = g_occ[wi];
    while (word && (int64_t)cand.size() < max_out) {
      int b = __builtin_ctzll(word);
      word &= word - 1;
      cand.push_back(static_cast<int64_t>(wi) * 64 + b);
    }
  }
  const int64_t n = static_cast<int64_t>(cand.size());

  // rows in yxz rank order over the kept zyx-ascending prefix
  std::vector<std::pair<int64_t, int64_t>> yxz(n);  // (key, kept idx)
  for (int64_t i = 0; i < n; ++i) {
    int64_t zz = cand[i] / (ho * wo), yy = (cand[i] / wo) % ho,
            xx = cand[i] % wo;
    yxz[i] = {(yy * wo + xx) * do_ + zz, i};
  }
  std::stable_sort(yxz.begin(), yxz.end());
  for (int64_t i = 0; i < max_out * 3; ++i) out_coords[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t cz = cand[yxz[i].second];
    out_coords[i * 3 + 0] = static_cast<int32_t>(cz / (ho * wo));
    out_coords[i * 3 + 1] = static_cast<int32_t>((cz / wo) % ho);
    out_coords[i * 3 + 2] = static_cast<int32_t>(cz % wo);
  }

  *inv_built = 0;
  if (!build_inverse || nc[0] > 2 || nc[1] > 2 || nc[2] > 2) return n;

  // inverse rulebook against the KEPT output set (twin of the inverse
  // branch of det3d_tpu/ops/sparse_host.py::transition): bitmap over the
  // kept yxz keys, rank at the iz = ncz-1 candidate, presence per (window
  // j = iy*ncx+ix, tap z'), tap z' <-> candidate iz = ncz-1-z'; parity
  // bits at 28+dim.
  g_bm_b.init(do_, ho, wo);
  {
    std::vector<int64_t> keys(n);
    for (int64_t i = 0; i < n; ++i) keys[i] = yxz[i].first;  // sorted asc
    g_bm_b.build(keys.data(), n);
  }
  const int64_t ncz = nc[0], ncy = nc[1], ncx = nc[2];
  const int64_t kw = ncy * ncx;
  for (int64_t i = 0; i < v; ++i) {
    const int32_t* co = coords + 3 * i;
    bool row_valid = co[0] >= 0;
    int64_t bz = floordiv(co[0] + p[0], s[0]);
    int64_t by = floordiv(co[1] + p[1], s[1]);
    int64_t bx = floordiv(co[2] + p[2], s[2]);
    int32_t par = static_cast<int32_t>(
        (floormod(co[0] + p[0], s[0]) & 1) << 28 |
        (floormod(co[1] + p[1], s[1]) & 1) << 29 |
        (floormod(co[2] + p[2], s[2]) & 1) << 30);
    int32_t* row = inv + i * kw;
    for (int64_t iy = 0; iy < ncy; ++iy) {
      int64_t oy = by - iy;
      bool okby = oy >= 0 && oy < ho && co[1] >= 0;
      for (int64_t ix = 0; ix < ncx; ++ix) {
        int64_t ox = bx - ix;
        bool okbx = ox >= 0 && ox < wo && co[2] >= 0;
        bool okb_yx = okby && okbx;
        int64_t colq = okb_yx ? oy * wo + ox : 0;
        uint64_t wrd = g_bm_b.word(colq);
        int64_t r0 = 0;
        int32_t pres = 0;
        for (int64_t iz = 0; iz < ncz; ++iz) {
          int64_t oz = bz - iz;
          bool okbz = oz >= 0 && oz < do_ && row_valid;
          // numpy: zc = clip(oz, 0, 31); rank only consumed at iz == ncz-1
          if (iz == ncz - 1) {
            int64_t zc = oz < 0 ? 0 : (oz > 31 ? 31 : oz);
            uint64_t below =
                wrd & ((uint64_t{1} << static_cast<uint64_t>(zc)) - 1);
            r0 = g_bm_b.rank0(colq) + __builtin_popcountll(below);
          }
          bool inz = oz >= 0 && oz < do_;
          bool present =
              inz && ((wrd >> static_cast<uint64_t>(inz ? oz : 0)) & 1);
          // kept_c = okb(all dims) & present — the inverse mirrors numpy's
          // okb & present exactly (the in-kernel j-bounds live only in the
          // candidate enumeration above)
          bool kept = okb_yx && okbz && present;
          if (kept) pres |= int32_t{1} << (kPackShift + (ncz - 1 - iz));
        }
        if (pres == 0) r0 = 0;
        row[iy * ncx + ix] =
            (static_cast<int32_t>(r0 & kPackMask) | pres | par);
      }
    }
  }
  *inv_built = 1;
  return n;
}

// ---------------------------------------------------------------------------
// Host voxelization twins (ops/voxelize_host.py; device: core/voxelize.py)
// ---------------------------------------------------------------------------

// Sorted (hashed/yxz) voxelization: fill the (V, T, C) buffer (or (V, C)
// sums when fuse_mean), coords, counts. perm must be the stable
// (key, lin)-lexsort from hp_point_order (or np.argsort(lin) for
// "appearance" — see hp_voxelize_appearance). Returns num_voxels.
int64_t hp_voxelize_sorted(const float* pts, int64_t p_rows, int64_t c,
                           const int32_t* lin, const int32_t* perm,
                           int64_t gx, int64_t gy, int64_t v_cap,
                           int64_t t_cap, int32_t fuse_mean, float* voxels,
                           int32_t* coords, int32_t* counts) {
  const int64_t vox_row = fuse_mean ? c : t_cap * c;
  std::memset(voxels, 0, sizeof(float) * v_cap * vox_row);
  std::memset(counts, 0, sizeof(int32_t) * v_cap);
  for (int64_t i = 0; i < v_cap * 3; ++i) coords[i] = -1;

  int64_t n_heads = 0, seg = -1, start = 0;
  int64_t prev = -1;
  for (int64_t i = 0; i < p_rows; ++i) {
    int64_t l = lin[perm[i]];
    if (l == kSentinel) break;  // sentinels sort last under both keys
    if (l != prev) {
      ++n_heads;
      seg = n_heads - 1;
      start = i;
      prev = l;
      if (seg < v_cap) {
        coords[seg * 3 + 0] = static_cast<int32_t>(l / (gx * gy));
        coords[seg * 3 + 1] = static_cast<int32_t>((l / gx) % gy);
        coords[seg * 3 + 2] = static_cast<int32_t>(l % gx);
      }
    }
    int64_t slot = i - start;
    if (seg >= v_cap || slot >= t_cap) continue;
    const float* src = pts + static_cast<int64_t>(perm[i]) * c;
    ++counts[seg];
    if (fuse_mean) {
      float* dst = voxels + seg * c;
      for (int64_t ch = 0; ch < c; ++ch) dst[ch] += src[ch];
    } else {
      std::memcpy(voxels + (seg * t_cap + slot) * c, src,
                  sizeof(float) * c);
    }
  }
  if (fuse_mean) {  // means = sums / max(counts, 1) — fp32 DIVISION, not
    for (int64_t s = 0; s < v_cap; ++s) {  // reciprocal-multiply (device)
      float n = static_cast<float>(counts[s] > 1 ? counts[s] : 1);
      for (int64_t ch = 0; ch < c; ++ch) voxels[s * c + ch] /= n;
    }
  }
  return n_heads < v_cap ? n_heads : v_cap;
}

// Appearance-ordered voxelization (twin of voxelize_host.py::_appearance /
// core/voxelize.py::voxelize_appearance): voxel rows in first-come
// order. order must be the stable argsort of lin. Returns num_voxels.
int64_t hp_voxelize_appearance(const float* pts, int64_t p_rows, int64_t c,
                               const int32_t* lin, const int32_t* order,
                               int64_t gx, int64_t gy, int64_t v_cap,
                               int64_t t_cap, float* voxels, int32_t* coords,
                               int32_t* counts) {
  std::memset(voxels, 0, sizeof(float) * v_cap * t_cap * c);
  std::memset(counts, 0, sizeof(int32_t) * v_cap);
  for (int64_t i = 0; i < v_cap * 3; ++i) coords[i] = -1;

  // pass 1: segments of the lin-sorted order; first original index per
  // segment == order[segment start] (stable sort keeps original order
  // within equal lin)
  std::vector<int64_t> seg_start, seg_first, seg_lin;
  int64_t prev = -1;
  for (int64_t i = 0; i < p_rows; ++i) {
    int64_t l = lin[order[i]];
    if (l == kSentinel) break;
    if (l != prev) {
      seg_start.push_back(i);
      seg_first.push_back(order[i]);
      seg_lin.push_back(l);
      prev = l;
    }
  }
  const int64_t n_seg = static_cast<int64_t>(seg_start.size());

  // rank segments by first appearance
  std::vector<int32_t> by_first(n_seg);
  for (int64_t s = 0; s < n_seg; ++s) by_first[s] = static_cast<int32_t>(s);
  std::stable_sort(by_first.begin(), by_first.end(),
                   [&](int32_t a, int32_t b) {
                     return seg_first[a] < seg_first[b];
                   });
  std::vector<int32_t> rank(n_seg);
  for (int64_t r = 0; r < n_seg; ++r) rank[by_first[r]] = (int32_t)r;

  // pass 2: fill
  for (int64_t s = 0; s < n_seg; ++s) {
    int64_t slot_v = rank[s];
    if (slot_v >= v_cap) continue;
    int64_t l = seg_lin[s];
    coords[slot_v * 3 + 0] = static_cast<int32_t>(l / (gx * gy));
    coords[slot_v * 3 + 1] = static_cast<int32_t>((l / gx) % gy);
    coords[slot_v * 3 + 2] = static_cast<int32_t>(l % gx);
    int64_t end = s + 1 < n_seg ? seg_start[s + 1] : p_rows;
    int64_t n = 0;
    for (int64_t i = seg_start[s]; i < end; ++i) {
      int64_t l2 = lin[order[i]];
      if (l2 != l) break;  // (only hit at the sentinel tail boundary)
      if (n >= t_cap) { ++n; continue; }
      std::memcpy(voxels + (slot_v * t_cap + n) * c,
                  pts + static_cast<int64_t>(order[i]) * c,
                  sizeof(float) * c);
      ++n;
    }
    counts[slot_v] = static_cast<int32_t>(n < t_cap ? n : t_cap);
  }
  return n_seg < v_cap ? n_seg : v_cap;
}

// Stable argsort of lin alone (appearance order's point perm).
void hp_argsort_lin(const int32_t* lin, int64_t p_rows, int32_t* out) {
  std::vector<uint64_t>& a = g_radix[0];
  std::vector<uint64_t>& tmp = g_radix[1];
  a.resize(p_rows);
  for (int64_t i = 0; i < p_rows; ++i)
    a[i] = (static_cast<uint64_t>(static_cast<uint32_t>(lin[i]))
            << kIdxBits) | static_cast<uint64_t>(i);
  radix_sort(a, tmp);
  for (int64_t i = 0; i < p_rows; ++i)
    out[i] = static_cast<int32_t>(a[i] & ((uint64_t{1} << kIdxBits) - 1));
}

}  // extern "C"
