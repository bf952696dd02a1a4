// Adapted from opencl_path_tracer_tpu/native/bvh_builder.cpp.
//
// Native median-split BVH builder (host runtime component): the C++ twin
// of accel/median_tree.py's split='median' (which re-implements the
// reference's recursive host builder, NodeOnHost::build at
// main.cpp:210-262, in the flat pointer format of accel/types.py), for
// large scenes at load time. Iterative explicit stack, leaves padded to a
// fixed stride. Output layout identical to the Python builder: nodes (N,
// 8) float32 [lo3 hi3 a b], a < 0 internal (left = -a, right = left + 1),
// a >= 0 leaf [a, a + count); the reordered triangle index list with a
// padding mask.
//
// Where it differs from the JAX package's copy, so that its tree is the
// Python builder's bit for bit (nodes, order, padding, depth): the boxes,
// extents and midpoints are double (the Python builder's float64; the
// midpoints come from the caller), the axis is the first longest extent
// (numpy's argmax), and the split is a stable sort of the range by the
// axis' midpoint (numpy's stable argsort), so each leaf keeps its
// triangles in the Python builder's order; the JAX package's copy
// partitions with nth_element on float32 midpoints, which matches its
// Python builder's hits, not its order.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Builder {
  const double* lo;   // (T, 3)
  const double* hi;
  const double* mid;
  int leaf_size;
  std::vector<float> nodes;       // 8 per node
  std::vector<int32_t> order;     // padded reordered indices
  std::vector<uint8_t> pad;
  std::vector<int32_t> idx;       // work buffer
  int max_depth = 0;
};

struct Task {
  int slot;
  int begin, end;  // range in b->idx
  int depth;
};

void set_box(float* n, const double* lo, const double* hi) {
  for (int a = 0; a < 3; ++a) {
    n[a] = static_cast<float>(lo[a]);
    n[3 + a] = static_cast<float>(hi[a]);
  }
}

void fill_leaf(Builder* b, int slot, int begin, int end, const double* lo,
               const double* hi) {
  int start = (int)b->order.size();
  int k = end - begin;
  for (int i = begin; i < end; ++i) b->order.push_back(b->idx[i]);
  for (int i = k; i < b->leaf_size; ++i) b->order.push_back(0);
  for (int i = 0; i < k; ++i) b->pad.push_back(0);
  for (int i = k; i < b->leaf_size; ++i) b->pad.push_back(1);
  float* n = &b->nodes[slot * 8];
  set_box(n, lo, hi);
  n[6] = (float)start;
  n[7] = (float)(start + k);
}

}  // namespace

extern "C" {

// tris_lo/hi/mid: (T, 3) float64 (the float32 vertices' bounds and the
// float64 vertex means). Outputs are read back through the calls below.
void* ptx_build_bvh(const double* tris_lo, const double* tris_hi,
                    const double* tris_mid, int t, int leaf_size) {
  Builder* b = new Builder();
  b->lo = tris_lo;
  b->hi = tris_hi;
  b->mid = tris_mid;
  b->leaf_size = leaf_size;
  b->idx.resize(t);
  for (int i = 0; i < t; ++i) b->idx[i] = i;
  b->nodes.resize(8, 0.0f);  // slot 0 = root
  b->order.reserve((size_t)t + t / leaf_size + 8);
  b->pad.reserve(b->order.capacity());

  std::vector<Task> stack;
  stack.push_back({0, 0, t, 0});
  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    if (task.depth > b->max_depth) b->max_depth = task.depth;

    double lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
      lo[a] = b->lo[b->idx[task.begin] * 3 + a];
      hi[a] = b->hi[b->idx[task.begin] * 3 + a];
    }
    for (int i = task.begin + 1; i < task.end; ++i) {
      const double* tl = &b->lo[b->idx[i] * 3];
      const double* th = &b->hi[b->idx[i] * 3];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], tl[a]);
        hi[a] = std::max(hi[a], th[a]);
      }
    }

    int count = task.end - task.begin;
    if (count <= b->leaf_size) {
      fill_leaf(b, task.slot, task.begin, task.end, lo, hi);
      continue;
    }

    int axis = 0;
    double best = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > best) {
        best = hi[a] - lo[a];
        axis = a;
      }
    int half = count / 2;
    const double* mid = b->mid;
    std::stable_sort(
        b->idx.begin() + task.begin, b->idx.begin() + task.end,
        [mid, axis](int32_t x, int32_t y) {
          return mid[x * 3 + axis] < mid[y * 3 + axis];
        });

    int left_slot = (int)(b->nodes.size() / 8);
    b->nodes.resize(b->nodes.size() + 16, 0.0f);
    float* n = &b->nodes[task.slot * 8];
    set_box(n, lo, hi);
    n[6] = -(float)left_slot;
    n[7] = 0.0f;
    stack.push_back({left_slot + 1, task.begin + half, task.end,
                     task.depth + 1});
    stack.push_back({left_slot, task.begin, task.begin + half,
                     task.depth + 1});
  }
  return b;
}

void ptx_bvh_counts(void* h, int* num_nodes, int* padded_t, int* depth) {
  Builder* b = (Builder*)h;
  *num_nodes = (int)(b->nodes.size() / 8);
  *padded_t = (int)b->order.size();
  *depth = b->max_depth;
}

void ptx_bvh_data(void* h, float* nodes_out, int32_t* order_out,
                  uint8_t* pad_out) {
  Builder* b = (Builder*)h;
  std::memcpy(nodes_out, b->nodes.data(),
              b->nodes.size() * sizeof(float));
  std::memcpy(order_out, b->order.data(),
              b->order.size() * sizeof(int32_t));
  std::memcpy(pad_out, b->pad.data(), b->pad.size());
}

void ptx_bvh_free(void* h) { delete (Builder*)h; }

}  // extern "C"
