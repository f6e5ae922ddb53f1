// Native host-side components (C ABI, loaded via ctypes — see build.py).
//
// The reference implements these host-side pieces in C++ too: the linear
// scan oracle (core.cu:11-54), the recursive KD-tree build with
// max-variance split + nth_element median (core.cu:1092-1114), and the
// octree build (core.cu:1525-1566). These are fresh implementations with
// the framework's own layouts (flat arrays fit for device upload), OpenMP
// where it pays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// v0: exact linear scan, lowest-index tie-break, OpenMP over queries.
// ---------------------------------------------------------------------------
void nns_linear_scan(int k, int m, int n, const float* q, const float* r,
                     int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < m; ++i) {
    const float* qi = q + (size_t)i * k;
    float best = INFINITY;
    int best_j = 0;
    for (int j = 0; j < n; ++j) {
      const float* rj = r + (size_t)j * k;
      float d = 0.f;
      for (int d_i = 0; d_i < k; ++d_i) {
        float t = qi[d_i] - rj[d_i];
        d += t * t;
      }
      if (d < best) {
        best = d;
        best_j = j;
      }
    }
    out[i] = best_j;
  }
}

// ---------------------------------------------------------------------------
// KD-tree build: implicit heap (root 1, children 2r/2r+1), max-variance
// split dim, median at beg + len/2 via nth_element. perm/dims must hold
// 4 * next_pow2(n) entries; empty slots get -1.
// ---------------------------------------------------------------------------
namespace {

struct KDCtx {
  const float* refs;
  int k;
  int32_t* perm;
  int32_t* dims;
  int64_t heap_len;
};

void kd_rec(KDCtx& ctx, int32_t* idx, int64_t beg, int64_t end, int64_t node,
            int depth) {
  if (beg >= end || node >= ctx.heap_len) return;
  const int k = ctx.k;
  const int64_t len = end - beg;

  // Split dimension = max variance (reference behavior, core.cu:1096-1108).
  int best_d = 0;
  double best_var = -1.0;
  for (int d = 0; d < k; ++d) {
    double s = 0.0, s2 = 0.0;
    for (int64_t i = beg; i < end; ++i) {
      double v = ctx.refs[(size_t)idx[i] * k + d];
      s += v;
      s2 += v * v;
    }
    double var = s2 - s * s / (double)len;
    if (var > best_var) {
      best_var = var;
      best_d = d;
    }
  }

  const int64_t mid = beg + len / 2;
  std::nth_element(idx + beg, idx + mid, idx + end,
                   [&](int32_t a, int32_t b) {
                     return ctx.refs[(size_t)a * k + best_d] <
                            ctx.refs[(size_t)b * k + best_d];
                   });
  ctx.perm[node] = idx[mid];
  ctx.dims[node] = best_d;

  // Parallelize the top of the tree only (task overhead below that).
  if (depth < 4 && len > 4096) {
#pragma omp task shared(ctx)
    kd_rec(ctx, idx, beg, mid, node * 2, depth + 1);
#pragma omp task shared(ctx)
    kd_rec(ctx, idx, mid + 1, end, node * 2 + 1, depth + 1);
#pragma omp taskwait
  } else {
    kd_rec(ctx, idx, beg, mid, node * 2, depth + 1);
    kd_rec(ctx, idx, mid + 1, end, node * 2 + 1, depth + 1);
  }
}

}  // namespace

int nns_kd_build(int k, int n, const float* refs, int32_t* perm,
                 int32_t* dims) {
  int64_t size = 1;
  while (size < n) size <<= 1;
  const int64_t heap_len = 4 * size;
  std::fill(perm, perm + heap_len, -1);
  std::fill(dims, dims + heap_len, 0);
  std::vector<int32_t> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  KDCtx ctx{refs, k, perm, dims, heap_len};
#pragma omp parallel
  {
#pragma omp single
    kd_rec(ctx, idx.data(), 0, n, 1, 0);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// KD-tree query: per-query iterative best-first descent with hyperplane
// pruning (the reference's ask(), core.cu:1123-1138, made stackless),
// OpenMP over queries. Exact under ties (returns a true nearest neighbor;
// strict-< keeps the first optimum encountered in traversal order).
// ---------------------------------------------------------------------------
void nns_kd_query(int k, int m, int64_t heap_len, const float* refs,
                  const float* queries, const int32_t* perm,
                  const int32_t* dims, int32_t* out) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int i = 0; i < m; ++i) {
    const float* q = queries + (size_t)i * k;
    int64_t stack_n[96];
    float stack_b[96];
    int sp = 0;
    stack_n[sp] = 1;
    stack_b[sp++] = 0.f;
    float best = INFINITY;
    int32_t best_i = 0;
    while (sp) {
      --sp;
      const int64_t node = stack_n[sp];
      const float bound = stack_b[sp];
      if (bound >= best) continue;
      const int32_t p = perm[node];
      if (p < 0) continue;
      const float* rp = refs + (size_t)p * k;
      float d = 0.f;
      for (int di = 0; di < k; ++di) {
        const float t = q[di] - rp[di];
        d += t * t;
      }
      if (d < best) {
        best = d;
        best_i = p;
      }
      const int dim = dims[node];
      const float delta = q[dim] - rp[dim];
      const int64_t near_c = 2 * node + (delta >= 0 ? 1 : 0);
      const int64_t far_c = near_c ^ 1;
      if (far_c < heap_len && perm[far_c] >= 0 && delta * delta < best) {
        stack_n[sp] = far_c;
        stack_b[sp++] = delta * delta;
      }
      if (near_c < heap_len && perm[near_c] >= 0) {
        stack_n[sp] = near_c;
        stack_b[sp++] = bound;
      }
    }
    out[i] = best_i;
  }
}

// ---------------------------------------------------------------------------
// Octree query: per-query DFS with cube-distance pruning + leaf scans
// (exact, unlike the reference's 3-face-neighbor heuristic), OpenMP over
// queries (the reference parallelizes octree queries too, core.cu:1654).
// Works on trees from either the native or the numpy build.
// ---------------------------------------------------------------------------
void nns_octree_query(int m, const float* refs, const float* queries,
                      const int32_t* children, const float* centers,
                      const float* radii, const int32_t* starts,
                      const int32_t* counts, const int32_t* order,
                      int32_t* out) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int i = 0; i < m; ++i) {
    const float* q = queries + (size_t)i * 3;
    int32_t stack_n[256];
    float stack_b[256];
    int sp = 0;
    stack_n[sp] = 0;
    stack_b[sp++] = 0.f;
    float best = INFINITY;
    int32_t best_i = 0;
    while (sp) {
      --sp;
      const int32_t node = stack_n[sp];
      if (stack_b[sp] >= best) continue;
      const int32_t* ch = children + 8 * (size_t)node;
      bool leaf = true;
      for (int o = 0; o < 8; ++o)
        if (ch[o] >= 0) { leaf = false; break; }
      if (leaf) {
        const int32_t s = starts[node], c = counts[node];
        for (int32_t j = 0; j < c; ++j) {
          const int32_t p = order[s + j];
          const float* rp = refs + (size_t)p * 3;
          float d = 0.f;
          for (int di = 0; di < 3; ++di) {
            const float t = q[di] - rp[di];
            d += t * t;
          }
          if (d < best || (d == best && p < best_i)) {
            best = d;
            best_i = p;
          }
        }
        continue;
      }
      // Compute child bounds; push far-to-near so nearest pops first.
      float cb[8];
      int ord[8];
      int nc = 0;
      for (int o = 0; o < 8; ++o) {
        if (ch[o] < 0) continue;
        const float* cc = centers + 3 * (size_t)ch[o];
        const float cr = radii[ch[o]];
        float b = 0.f;
        for (int di = 0; di < 3; ++di) {
          float g = std::fabs(q[di] - cc[di]) - cr;
          if (g > 0) b += g * g;
        }
        if (b < best) {
          cb[nc] = b;
          ord[nc++] = o;
        }
      }
      for (int a = 1; a < nc; ++a)  // tiny insertion sort, descending bound
        for (int b2 = a; b2 > 0 && cb[b2] > cb[b2 - 1]; --b2) {
          std::swap(cb[b2], cb[b2 - 1]);
          std::swap(ord[b2], ord[b2 - 1]);
        }
      for (int a = 0; a < nc; ++a) {
        stack_n[sp] = ch[ord[a]];
        stack_b[sp++] = cb[a];
      }
    }
    out[i] = best_i;
  }
}

// ---------------------------------------------------------------------------
// Octree build (3-D): Morton-sorted linear octree — children[8], center,
// radius, leaf point ranges over a permutation array. One 63-bit Morton
// sort replaces the recursive per-node partition passes of the classic
// build (measured 3.7 s -> sub-second at 1M clustered points): points are
// sorted once by interleaved 21-bit grid coordinates over the tight root
// box, after which every node's range is contiguous and each split is a
// run-scan of the sorted keys. Splits skip empty levels (a node splits at
// the FIRST 3-bit group where its keys differ), and a node whose points
// exhaust the 21-bit grid resolution (all keys equal but points distinct —
// e.g. a dense cluster dwarfed by one far outlier in the root box) is
// RE-QUANTIZED over its own tight box and built recursively, so clusters
// keep resolving at any coordinate scale — the same adaptivity the
// tight-center recursive build had. One split counts as one depth unit
// against max_depth; leaf when depth >= max_depth, count <= 1, or all
// points identical. Returns node count, or -1 on overflow / bad input.
// ---------------------------------------------------------------------------
namespace {

// Spread the low 21 bits of v so bit i lands at bit 3*i.
inline uint64_t oct_expand21(uint64_t v) {
  v &= 0x1fffff;
  v = (v | v << 32) & 0x1f00000000ffffULL;
  v = (v | v << 16) & 0x1f0000ff0000ffULL;
  v = (v | v << 8) & 0x100f00f00f00f00fULL;
  v = (v | v << 4) & 0x10c30c30c30c30c3ULL;
  v = (v | v << 2) & 0x1249249249249249ULL;
  return v;
}

// Tight f32-SOUND geometry for points pts[3*b .. 3*e): the node box comes
// from the node's OWN points (double accumulation), never halved from the
// parent cube — at large coordinate magnitudes the f32 rounding of a
// halved center exceeds deep-node nominal radii, and the query's
// cube-distance prune becomes unsound (misses true neighbors;
// range-robustness fuzz). The radius is inflated by a few ulps of the
// coordinate magnitude so |q - c| - r stays a true lower bound under f32
// query arithmetic. Tight boxes also prune strictly harder than nominal
// octant cubes.
inline void oct_node_geom(const float* pts, int64_t b, int64_t e,
                          float* c_out, float* rad_out) {
  double lo[3] = {INFINITY, INFINITY, INFINITY};
  double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = b; i < e; ++i) {
    const float* pt = pts + 3 * i;
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], (double)pt[d]);
      hi[d] = std::max(hi[d], (double)pt[d]);
    }
  }
  double radd = 0.0, cmag = 0.0;
  for (int d = 0; d < 3; ++d) {
    c_out[d] = (float)((lo[d] + hi[d]) * 0.5);
    radd = std::max(radd,
                    std::max(hi[d] - (double)c_out[d], (double)c_out[d] - lo[d]));
    cmag = std::max(cmag, std::fabs((double)c_out[d]));
  }
  *rad_out = (float)(radd + 1.2e-6 * (cmag + radd) + 1e-30);
}

struct OctSeg {
  int64_t beg, end;
  int32_t node;
};

struct OctBuild {
  int32_t* children;
  float* centers;
  float* radii;
  int32_t* starts;
  int32_t* counts;
  int32_t* order;     // (n,) permutation, kept in sync with pts
  float* pts;         // (n, 3) points physically reordered to match order
  uint64_t* key;      // (n,) Morton keys, current for each built range
  int64_t max_nodes;
  int64_t n_nodes;
  int max_depth;
  // radix / permutation scratch, each n-sized
  uint64_t* key2;
  int32_t* idx;
  int32_t* idx2;
  int32_t* ord2;
  float* pts2;
};

// Quantize pts[beg..end) to 63-bit Morton keys over the subrange's own
// tight box, LSD-radix-sort the subrange, and apply the permutation to
// order/pts in place. Stable with slot-ascending tie ids, so equal keys
// (duplicate points) keep the id-ascending order the initial range had.
void oct_quantize_sort(OctBuild& B, int64_t beg, int64_t end) {
  const int64_t L = end - beg;
  double lo[3] = {INFINITY, INFINITY, INFINITY};
  double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = beg; i < end; ++i)
    for (int d = 0; d < 3; ++d) {
      const double v = B.pts[3 * i + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  double scale[3];
  for (int d = 0; d < 3; ++d) {
    const double ext = hi[d] - lo[d];
    scale[d] = ext > 0 ? 2097151.0 / ext : 0.0;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = beg; i < end; ++i) {
    uint64_t u[3];
    for (int d = 0; d < 3; ++d) {
      double g = ((double)B.pts[3 * i + d] - lo[d]) * scale[d];
      g = std::min(std::max(g, 0.0), 2097151.0);
      u[d] = (uint64_t)g;
    }
    B.key[i] = oct_expand21(u[0]) | (oct_expand21(u[1]) << 1) |
               (oct_expand21(u[2]) << 2);
    B.idx[i] = (int32_t)(i - beg);
  }
  // 4 passes x 16 bits over (key, slot) pairs.
  int64_t hist[65536];
  uint64_t* ka = B.key + beg;
  uint64_t* kb = B.key2 + beg;
  int32_t* ia = B.idx + beg;
  int32_t* ib = B.idx2 + beg;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 16 * pass;
    std::fill(hist, hist + 65536, 0);
    for (int64_t i = 0; i < L; ++i) hist[(ka[i] >> shift) & 0xffff]++;
    int64_t run = 0;
    for (int b = 0; b < 65536; ++b) {
      const int64_t c = hist[b];
      hist[b] = run;
      run += c;
    }
    for (int64_t i = 0; i < L; ++i) {
      const int64_t dst = hist[(ka[i] >> shift) & 0xffff]++;
      kb[dst] = ka[i];
      ib[dst] = ia[i];
    }
    std::swap(ka, kb);
    std::swap(ia, ib);
  }
  if (ka != B.key + beg) {
    std::memcpy(B.key + beg, ka, (size_t)L * sizeof(uint64_t));
    std::memcpy(B.idx + beg, ia, (size_t)L * sizeof(int32_t));
  }
  // Apply the permutation to order and pts (one gather each, via scratch).
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < L; ++i) {
    const int64_t src = beg + B.idx[beg + i];
    B.ord2[beg + i] = B.order[src];
    B.pts2[3 * (beg + i) + 0] = B.pts[3 * src + 0];
    B.pts2[3 * (beg + i) + 1] = B.pts[3 * src + 1];
    B.pts2[3 * (beg + i) + 2] = B.pts[3 * src + 2];
  }
  std::memcpy(B.order + beg, B.ord2 + beg, (size_t)L * sizeof(int32_t));
  std::memcpy(B.pts + 3 * beg, B.pts2 + 3 * beg, (size_t)L * 3 * sizeof(float));
}

// Level-by-level construction of the subtree under `parent` covering
// [beg, end) whose node was created at depth0, using the range's current
// keys. Saturated leaves (count > 1, depth budget left, but all keys
// equal while points differ) are re-quantized over their own tight box
// and recursed. Returns false on node overflow.
bool oct_build_subtree(OctBuild& B, int32_t parent, int64_t beg, int64_t end,
                       int depth0) {
  struct Sat {
    int64_t beg, end;
    int32_t node;
    int depth;
  };
  std::vector<OctSeg> cur, next;
  std::vector<Sat> sats;
  if (end - beg > 1 && depth0 < B.max_depth &&
      B.key[beg] != B.key[end - 1])
    cur.push_back({beg, end, parent});
  else if (end - beg > 1 && depth0 < B.max_depth)
    sats.push_back({beg, end, parent, depth0});

  struct SegKids {
    int64_t beg[8], end[8];
    int oct[8];
    int cnt;
  };
  std::vector<SegKids> kids;
  std::vector<int64_t> base;
  for (int depth = depth0 + 1; !cur.empty(); ++depth) {
    const int64_t S = (int64_t)cur.size();
    kids.assign((size_t)S, SegKids{});
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t s = 0; s < S; ++s) {
      const OctSeg seg = cur[(size_t)s];
      // First 3-bit group (from the top) where the segment's keys differ.
      const uint64_t x = B.key[seg.beg] ^ B.key[seg.end - 1];
      const int g = ((63 - __builtin_clzll(x)) / 3) * 3;
      SegKids& sk = kids[(size_t)s];
      int64_t i = seg.beg;
      while (i < seg.end) {
        const uint64_t v = (B.key[i] >> g) & 7;
        int64_t j = i + 1;
        while (j < seg.end && ((B.key[j] >> g) & 7) == v) ++j;
        sk.beg[sk.cnt] = i;
        sk.end[sk.cnt] = j;
        sk.oct[sk.cnt++] = (int)v;
        i = j;
      }
    }
    // Allocate ids (serial prefix over segments, BFS order).
    base.assign((size_t)S, 0);
    for (int64_t s = 0; s < S; ++s) {
      base[(size_t)s] = B.n_nodes;
      B.n_nodes += kids[(size_t)s].cnt;
    }
    if (B.n_nodes > B.max_nodes) return false;
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t s = 0; s < S; ++s) {
      const SegKids& sk = kids[(size_t)s];
      for (int c = 0; c < sk.cnt; ++c) {
        const int64_t node = base[(size_t)s] + c;
        B.children[8 * (size_t)cur[(size_t)s].node + sk.oct[c]] =
            (int32_t)node;
        B.starts[node] = (int32_t)sk.beg[c];
        B.counts[node] = (int32_t)(sk.end[c] - sk.beg[c]);
        oct_node_geom(B.pts, sk.beg[c], sk.end[c], B.centers + 3 * node,
                      B.radii + node);
        for (int o = 0; o < 8; ++o) B.children[8 * (size_t)node + o] = -1;
      }
    }
    next.clear();
    if (depth < B.max_depth)
      for (int64_t s = 0; s < S; ++s) {
        const SegKids& sk = kids[(size_t)s];
        for (int c = 0; c < sk.cnt; ++c) {
          if (sk.end[c] - sk.beg[c] <= 1) continue;
          const int32_t node = (int32_t)(base[(size_t)s] + c);
          if (B.key[sk.beg[c]] != B.key[sk.end[c] - 1])
            next.push_back({sk.beg[c], sk.end[c], node});
          else
            sats.push_back({sk.beg[c], sk.end[c], node, depth});
        }
      }
    cur.swap(next);
  }
  // Saturated ranges: identical keys at the current grid, distinct points
  // (zero tight extent in every dim means true duplicates -> real leaf).
  // Re-quantizing over the range's own tight box always separates the
  // extremes (min/max land in grid cells 0 and 2^21-1), so each level of
  // recursion splits at least once and the depth budget bounds it.
  for (const Sat& sat : sats) {
    const float* p0 = B.pts + 3 * sat.beg;
    bool distinct = false;
    for (int64_t i = sat.beg + 1; i < sat.end && !distinct; ++i)
      for (int d = 0; d < 3; ++d)
        if (B.pts[3 * i + d] != p0[d]) {
          distinct = true;
          break;
        }
    if (!distinct) continue;
    oct_quantize_sort(B, sat.beg, sat.end);
    if (!oct_build_subtree(B, sat.node, sat.beg, sat.end, sat.depth))
      return false;
  }
  return true;
}

}  // namespace

// The caller passes its actual node allocation (max_nodes) so the bound
// can never silently diverge between the Python buffers and this library
// (a stale .so with a baked-in larger bound would otherwise overrun them).
int nns_octree_build_v2(int k, int n, const float* refs, int32_t* children,
                        float* centers, float* radii, int32_t* starts,
                        int32_t* counts, int32_t* order, int max_depth,
                        int64_t max_nodes) {
  if (k != 3 || n < 1 || max_nodes < 1) return -1;

  std::vector<float> pts(3 * (size_t)n), pts2(3 * (size_t)n);
  std::vector<uint64_t> key((size_t)n), key2((size_t)n);
  std::vector<int32_t> idx((size_t)n), idx2((size_t)n), ord2((size_t)n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    order[i] = (int32_t)i;
    pts[3 * i + 0] = refs[3 * i + 0];
    pts[3 * i + 1] = refs[3 * i + 1];
    pts[3 * i + 2] = refs[3 * i + 2];
  }
  OctBuild B{children, centers,    radii,       starts,
             counts,   order,      pts.data(),  key.data(),
             max_nodes, 0,         max_depth,   key2.data(),
             idx.data(), idx2.data(), ord2.data(), pts2.data()};

  starts[0] = 0;
  counts[0] = n;
  oct_node_geom(pts.data(), 0, n, centers, radii);
  for (int o = 0; o < 8; ++o) children[o] = -1;
  B.n_nodes = 1;

  oct_quantize_sort(B, 0, n);
  if (!oct_build_subtree(B, 0, 0, n, 0)) return -1;
  return (int)B.n_nodes;
}

// Legacy entry (pre-v2 ABI): assumes the caller allocated 2n + 64 nodes.
int nns_octree_build(int k, int n, const float* refs, int32_t* children,
                     float* centers, float* radii, int32_t* starts,
                     int32_t* counts, int32_t* order, int max_depth) {
  return nns_octree_build_v2(k, n, refs, children, centers, radii, starts,
                             counts, order, max_depth, 2 * (int64_t)n + 64);
}

}  // extern "C" (reopened below — templates cannot have C linkage)

// ---------------------------------------------------------------------------
// Supercell halo build (3-D): enumerate each point's halo-set memberships
// (<= 8 supercells within `halo` of the point) and fill the dense
// (G, R_cap, 3) halo tensors by counting sort — replaces the numpy
// argsort-based build (O(n log n) + fancy indexing) with two O(8n) passes.
// Within each group, slots are in ascending point-id order (outer loop);
// the numpy fallback uses octant-block order — both are valid (same sets).
// ---------------------------------------------------------------------------
namespace {

template <typename F>
inline void cells_for_each_membership(int n, const float* refs, int D,
                                      double halo, const double* mn,
                                      const double* w, F&& fn) {
  for (int p = 0; p < n; ++p) {
    int64_t lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      const double rel = (double)refs[3 * (size_t)p + d] - mn[d];
      int64_t l = (int64_t)std::floor((rel - halo) / w[d]);
      int64_t h = (int64_t)std::floor((rel + halo) / w[d]);
      lo[d] = std::min<int64_t>(std::max<int64_t>(l, 0), D - 1);
      hi[d] = std::min<int64_t>(std::max<int64_t>(h, 0), D - 1);
    }
    for (int64_t gx = lo[0];; gx = hi[0]) {
      for (int64_t gy = lo[1];; gy = hi[1]) {
        for (int64_t gz = lo[2];; gz = hi[2]) {
          fn(p, (gx * D + gy) * D + gz);
          if (gz == hi[2]) break;
        }
        if (gy == hi[1]) break;
      }
      if (gx == hi[0]) break;
    }
  }
}

}  // namespace

extern "C" {

int nns_cells_count(int n, const float* refs, int D, double halo,
                    const double* mn, const double* w, int32_t* counts) {
  const int64_t G = (int64_t)D * D * D;
  std::fill(counts, counts + G, 0);
  cells_for_each_membership(n, refs, D, halo, mn, w,
                            [&](int, int64_t gid) { counts[gid]++; });
  return 0;
}

// Query staging: bucket queries by supercell with a stable counting sort.
// Writes packed (m, 5) f32 [qx, qy, qz, sid, slot] in group-sorted order
// plus the permutation (original index per output row). Returns the
// maximum per-group count (q_max before pow2 rounding).
int nns_cells_stage(int m, const float* queries, int D, const double* mn,
                    const double* w, float* packed, int32_t* order) {
  const int64_t G = (int64_t)D * D * D;
  std::vector<int32_t> sid(m);
  std::vector<int32_t> counts(G, 0);
  for (int i = 0; i < m; ++i) {
    int64_t g = 0;
    for (int d = 0; d < 3; ++d) {
      int64_t c = (int64_t)std::floor(((double)queries[3 * (size_t)i + d] - mn[d]) / w[d]);
      c = std::min<int64_t>(std::max<int64_t>(c, 0), D - 1);
      g = g * D + c;
    }
    sid[i] = (int32_t)g;
    counts[g]++;
  }
  int32_t q_max = 0;
  for (int64_t g = 0; g < G; ++g) q_max = std::max(q_max, counts[g]);
  std::vector<int64_t> start(G + 1, 0);
  for (int64_t g = 0; g < G; ++g) start[g + 1] = start[g] + counts[g];
  std::vector<int64_t> cursor(start.begin(), start.end() - 1);
  for (int i = 0; i < m; ++i) {  // stable: ascending original index
    const int32_t g = sid[i];
    const int64_t row = cursor[g]++;
    float* dst = packed + 5 * row;
    const float* src = queries + 3 * (size_t)i;
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
    dst[3] = (float)g;
    dst[4] = (float)(row - start[g]);
    order[row] = i;
  }
  return q_max;
}

// halo_pts_dm is DIM-MAJOR (G, 3, r_cap) — the exact device layout the scan
// kernel consumes, so the Python side never pays a strided transpose copy.
int nns_cells_fill(int n, const float* refs, int D, double halo,
                   const double* mn, const double* w, int r_cap,
                   float* halo_pts_dm, int32_t* halo_ids) {
  const int64_t G = (int64_t)D * D * D;
  std::vector<int32_t> cursor(G, 0);
  bool overflow = false;
  cells_for_each_membership(
      n, refs, D, halo, mn, w, [&](int p, int64_t gid) {
        const int32_t c = cursor[gid]++;
        if (c >= r_cap) {
          overflow = true;
          return;
        }
        float* base = halo_pts_dm + (size_t)gid * 3 * r_cap + c;
        const float* src = refs + 3 * (size_t)p;
        base[0 * r_cap] = src[0];
        base[1 * r_cap] = src[1];
        base[2 * r_cap] = src[2];
        halo_ids[(size_t)gid * r_cap + c] = p;
      });
  return overflow ? -1 : 0;
}

}  // extern "C"
