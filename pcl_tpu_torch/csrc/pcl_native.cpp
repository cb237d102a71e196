// pcl_tpu_torch native host runtime (C++17, no external deps; OpenMP where
// the compiler has it).
//
// The device path is PyTorch and CUDA; this library is the *host-side*
// runtime the reference implements in C++ (FLANN kd-tree at
// kdtree/include/pcl/kdtree/kdtree_flann.h:132, voxel spreadsort at
// filters/impl/voxel_grid.hpp:725, morton keys at gpu/octree's
// octree_builder.cu), the same algorithm as the JAX package's copy. It serves:
//   * exact kd-tree kNN/radius: a CPU oracle for the device searches, and
//     host-resident pipelines (IO-side preprocessing, out-of-core indexing);
//   * 64-bit morton encode + argsort: spatial ordering for octree/outofcore
//     builds and locality-preserving upload order;
//   * voxel binning (unique voxel ids + segment boundaries): a host-side
//     VoxelGrid before upload.
//
// All entry points are extern "C" with flat float/int buffers so they bind
// via ctypes. Built at first use by ops/_build.host_library into build/kernels/.
//
// Traits kept from the JAX package's copy (the port's tests pin them):
//   * pcl_morton_argsort is std::sort on the codes alone: not stable;
//   * pcl_voxel_centroids bins relative to the cloud's minimum, by a product
//     with 1 / leaf, not on voxel_downsample's absolute floor(xyz / leaf) grid;
//   * among equally distant points the kd-tree returns whichever its
//     traversal meets first.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct KdNode {
  float split;
  int32_t axis;      // -1 for leaf
  int32_t left;      // node index
  int32_t right;     // node index
  int32_t begin;     // leaf: range into index array
  int32_t end;
};

struct KdTree {
  std::vector<float> pts;       // n * 3
  std::vector<int32_t> idx;     // permutation
  std::vector<KdNode> nodes;
  int32_t n = 0;
  static constexpr int kLeaf = 16;

  const float* p(int32_t i) const { return &pts[3 * (size_t)i]; }

  int32_t build(int32_t begin, int32_t end) {
    KdNode node{};
    node.begin = begin;
    node.end = end;
    int32_t id = (int32_t)nodes.size();
    nodes.push_back(node);
    if (end - begin <= kLeaf) {
      nodes[id].axis = -1;
      return id;
    }
    // pick widest axis
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = begin; i < end; ++i) {
      const float* q = p(idx[i]);
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], q[a]);
        hi[a] = std::max(hi[a], q[a]);
      }
    }
    int axis = 0;
    float w = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > w) { w = hi[a] - lo[a]; axis = a; }
    if (w <= 0.f) {  // all points identical: leaf
      nodes[id].axis = -1;
      return id;
    }
    int32_t mid = begin + (end - begin) / 2;
    std::nth_element(idx.begin() + begin, idx.begin() + mid, idx.begin() + end,
                     [&](int32_t a, int32_t b) { return p(a)[axis] < p(b)[axis]; });
    float split = p(idx[mid])[axis];
    int32_t l = build(begin, mid);
    int32_t r = build(mid, end);
    nodes[id].axis = axis;
    nodes[id].split = split;
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  // kNN into (dist2, index) max-heap arrays of size k; returns found count.
  int32_t knn(const float* q, int32_t k, float* out_d2, int32_t* out_i) const {
    using Pair = std::pair<float, int32_t>;
    std::priority_queue<Pair> heap;  // max-heap on dist2
    search_knn(0, q, k, heap);
    int32_t m = (int32_t)heap.size();
    for (int32_t j = m - 1; j >= 0; --j) {
      out_d2[j] = heap.top().first;
      out_i[j] = heap.top().second;
      heap.pop();
    }
    return m;
  }

  void search_knn(int32_t nid, const float* q, int32_t k,
                  std::priority_queue<std::pair<float, int32_t>>& heap) const {
    const KdNode& nd = nodes[nid];
    if (nd.axis < 0) {
      for (int32_t i = nd.begin; i < nd.end; ++i) {
        const float* t = p(idx[i]);
        float d2 = 0;
        for (int a = 0; a < 3; ++a) { float d = q[a] - t[a]; d2 += d * d; }
        if ((int32_t)heap.size() < k) heap.emplace(d2, idx[i]);
        else if (d2 < heap.top().first) { heap.pop(); heap.emplace(d2, idx[i]); }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int32_t near = diff < 0 ? nd.left : nd.right;
    int32_t far = diff < 0 ? nd.right : nd.left;
    search_knn(near, q, k, heap);
    if ((int32_t)heap.size() < k || diff * diff < heap.top().first)
      search_knn(far, q, k, heap);
  }

  // Radius search keeping the `cap` NEAREST hits (bounded max-heap, same
  // overflow semantics as the numpy fallback in native/__init__.py), sorted
  // ascending. Returns the TRUE hit count (may exceed cap -> overflow
  // detectable by the caller).
  int32_t radius(const float* q, float r2, int32_t cap, float* out_d2,
                 int32_t* out_i) const {
    using Pair = std::pair<float, int32_t>;
    std::priority_queue<Pair> heap;  // max-heap on dist2, size <= cap
    int32_t count = 0;
    search_radius(0, q, r2, cap, heap, count);
    int32_t m = (int32_t)heap.size();
    for (int32_t j = m - 1; j >= 0; --j) {
      out_d2[j] = heap.top().first;
      out_i[j] = heap.top().second;
      heap.pop();
    }
    return count;  // may exceed cap: caller learns overflow
  }

  void search_radius(int32_t nid, const float* q, float r2, int32_t cap,
                     std::priority_queue<std::pair<float, int32_t>>& heap,
                     int32_t& count) const {
    const KdNode& nd = nodes[nid];
    if (nd.axis < 0) {
      for (int32_t i = nd.begin; i < nd.end; ++i) {
        const float* t = p(idx[i]);
        float d2 = 0;
        for (int a = 0; a < 3; ++a) { float d = q[a] - t[a]; d2 += d * d; }
        if (d2 <= r2) {
          if ((int32_t)heap.size() < cap) heap.emplace(d2, idx[i]);
          else if (d2 < heap.top().first) { heap.pop(); heap.emplace(d2, idx[i]); }
          ++count;
        }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int32_t near = diff < 0 ? nd.left : nd.right;
    int32_t far = diff < 0 ? nd.right : nd.left;
    search_radius(near, q, r2, cap, heap, count);
    if (diff * diff <= r2) search_radius(far, q, r2, cap, heap, count);
  }
};

uint64_t expand_bits_21(uint64_t v) {
  // spread 21 bits to every third bit position
  v &= 0x1fffff;
  v = (v | (v << 32)) & 0x1f00000000ffffULL;
  v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
  v = (v | (v << 8)) & 0x100f00f00f00f00fULL;
  v = (v | (v << 4)) & 0x10c30c30c30c30c3ULL;
  v = (v | (v << 2)) & 0x1249249249249249ULL;
  return v;
}

}  // namespace

extern "C" {

// ---- kd-tree ----

void* pcl_kdtree_build(const float* pts, int32_t n) {
  KdTree* t = new KdTree();
  t->n = n;
  t->pts.assign(pts, pts + 3 * (size_t)n);
  t->idx.resize(n);
  for (int32_t i = 0; i < n; ++i) t->idx[i] = i;
  if (n > 0) t->build(0, n);
  return t;
}

void pcl_kdtree_free(void* h) { delete (KdTree*)h; }

// queries: m x 3; out_d2/out_i: m x k. Returns nothing; counts into out_cnt.
void pcl_kdtree_knn(void* h, const float* queries, int32_t m, int32_t k,
                    float* out_d2, int32_t* out_i, int32_t* out_cnt) {
  KdTree* t = (KdTree*)h;
  if (t->n == 0) { for (int32_t j = 0; j < m; ++j) out_cnt[j] = 0; return; }
#pragma omp parallel for schedule(static)
  for (int32_t j = 0; j < m; ++j)
    out_cnt[j] = t->knn(queries + 3 * (size_t)j, k,
                        out_d2 + (size_t)j * k, out_i + (size_t)j * k);
}

void pcl_kdtree_radius(void* h, const float* queries, int32_t m, float radius,
                       int32_t cap, float* out_d2, int32_t* out_i,
                       int32_t* out_cnt) {
  KdTree* t = (KdTree*)h;
  if (t->n == 0) { for (int32_t j = 0; j < m; ++j) out_cnt[j] = 0; return; }
  float r2 = radius * radius;
#pragma omp parallel for schedule(dynamic, 16)
  for (int32_t j = 0; j < m; ++j)
    out_cnt[j] = t->radius(queries + 3 * (size_t)j, r2, cap,
                           out_d2 + (size_t)j * cap, out_i + (size_t)j * cap);
}

// ---- morton ordering ----

// 21-bit-per-axis morton codes over the point bbox; out_codes: n.
void pcl_morton_encode(const float* pts, int32_t n, uint64_t* out_codes) {
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int32_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      float v = pts[3 * (size_t)i + a];
      lo[a] = std::min(lo[a], v);
      hi[a] = std::max(hi[a], v);
    }
  float scale[3];
  for (int a = 0; a < 3; ++a) {
    float w = hi[a] - lo[a];
    scale[a] = w > 0 ? (float)((1 << 21) - 1) / w : 0.f;
  }
#pragma omp parallel for schedule(static)
  for (int32_t i = 0; i < n; ++i) {
    uint64_t c = 0;
    for (int a = 0; a < 3; ++a) {
      uint64_t q = (uint64_t)((pts[3 * (size_t)i + a] - lo[a]) * scale[a]);
      c |= expand_bits_21(q) << a;
    }
    out_codes[i] = c;
  }
}

// argsort by morton code; out_order: n int32 permutation.
void pcl_morton_argsort(const float* pts, int32_t n, int32_t* out_order) {
  std::vector<uint64_t> codes(n);
  pcl_morton_encode(pts, n, codes.data());
  for (int32_t i = 0; i < n; ++i) out_order[i] = i;
  std::sort(out_order, out_order + n,
            [&](int32_t a, int32_t b) { return codes[a] < codes[b]; });
}

// ---- voxel binning (host VoxelGrid) ----
// Assigns each point a voxel id on an integer grid of cell size `leaf`,
// sorts points by id, and emits per-voxel centroids. Returns #voxels.
int32_t pcl_voxel_centroids(const float* pts, int32_t n, float leaf,
                            float* out_centroids /* n x 3 cap */) {
  if (n == 0 || leaf <= 0.f) return 0;
  float lo[3] = {1e30f, 1e30f, 1e30f};
  for (int32_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) lo[a] = std::min(lo[a], pts[3 * (size_t)i + a]);
  std::vector<std::pair<uint64_t, int32_t>> keyed(n);
  float inv = 1.f / leaf;
  for (int32_t i = 0; i < n; ++i) {
    uint64_t k = 0;
    for (int a = 0; a < 3; ++a) {
      uint64_t q = (uint64_t)((pts[3 * (size_t)i + a] - lo[a]) * inv);
      k = k * 2097152ULL + q;  // 21 bits per axis
    }
    keyed[i] = {k, i};
  }
  std::sort(keyed.begin(), keyed.end());
  int32_t nv = 0;
  int32_t i = 0;
  while (i < n) {
    int32_t j = i;
    double acc[3] = {0, 0, 0};
    while (j < n && keyed[j].first == keyed[i].first) {
      const float* p = pts + 3 * (size_t)keyed[j].second;
      for (int a = 0; a < 3; ++a) acc[a] += p[a];
      ++j;
    }
    for (int a = 0; a < 3; ++a)
      out_centroids[3 * (size_t)nv + a] = (float)(acc[a] / (j - i));
    ++nv;
    i = j;
  }
  return nv;
}

}  // extern "C"
