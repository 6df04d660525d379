// MAC marking of mark_macs for NVIDIA Hopper (sm_90a): every tree node that
// fails the minimum-distance MAC against any target (focus leaf), found by
// one depth-first walk a target, all targets in one launch.
//
// Replaces no TPU kernel. The JAX package walks batched_mark as plain JAX
// (a lax.while_loop over a 128-entry stack that drops pushes past it); the
// port's plain walk under mark_macs (traversal/macs.mark_walk_plain, over
// traversal.batched_mark) is breadth first over a flat list of (target,
// node) pairs, materialised in device memory chunk by chunk, with two host
// reads a chunk to compact the frontier by boolean indexing. This kernel
// computes the same marks with no host read and no materialised pair.
//
// What bounds it (H100 SXM, 700 W; a rank of 8M uniform particles on four
// cards, about 400k nodes): at most ~0.93e9 MAC tests of ~25 FP32
// operations (minimum image, clamp, squared norm, compare), 2.3e10
// operations, 0.35 ms at 67 TFLOP/s; the node inputs, 24 bytes a node,
// ~10 MB, stay in the 50 MB L2. A walk is a chain of dependent loads (a
// node's children are known only once the node passed), so the latency of
// the gathers, not the arithmetic, sets the pace.
//
// Design:
// - One thread a target, targets in leaf (SFC) order, so the lanes of a
//   warp walk neighbouring subtrees and their node gathers hit the same
//   L1 and L2 lines. Inactive targets (leaves interior to the focus, slots
//   past n_focus) carry max_level -1 and return at once.
// - Depth first from the root. A node that passes is descended by testing
//   its eight children at once: the eight (float4 centre and mac_sq, int2
//   child offset and level) loads are independent, so their latencies
//   overlap. Each passing child is marked, and the passing internal ones
//   form an 8-bit mask of children still to descend into.
// - The stack holds one (first child, pending mask) entry a tree level, so
//   DEPTH = max_tree_level + 1 entries (11 for 32-bit keys, 22 for 64-bit)
//   hold every pending visit: a pushed node is internal, hence above the
//   deepest level, and the walk drops no visit (the JAX walk's 128-entry
//   stack drops pushes on deep trees; this one cannot overflow).
// - Marks are an order-free OR: a store is skipped where the node is
//   already marked, and racing stores write the same 1, so the marks equal
//   the plain walk's in any visiting order.
// - The node's `outside` flag is folded into its level by the wrapper
//   (level 127 where the node lies inside the focus): `level <= max_level`
//   then tests both, since max_level <= 21.
//
// Rounding: the plain criterion's operations in its order, each rounded on
// its own (--fmad=false): d = t_center - s_center; the minimum image
// d - (pbc * length) * rint(d * (1 / length)) (rint: round half to even,
// as torch.round); g = max(|d| - t_size, 0); r2 = (gx*gx + gy*gy) + gz*gz;
// violates = r2 < |mac_sq|. The lengths and their inverses are read as
// torch computed them, so marks are bit-equal to the plain walk's.
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() (0 on success). It allocates nothing; `marks` comes
// zeroed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;

struct Target {
    float cx, cy, cz, sx, sy, sz;
    int max_level;
};

struct Image {
    float pl[3];  // pbc * length: 0 in an open dimension
    float il[3];  // 1 / length
};

// min_distance_point_box along one axis, apply_pbc included
__device__ __forceinline__ float gap(float t, float s, float size, float pl, float il) {
    const float d0 = __fsub_rn(t, s);
    const float d = __fsub_rn(d0, __fmul_rn(pl, rintf(__fmul_rn(d0, il))));
    const float g = __fsub_rn(fabsf(d), size);
    return g < 0.0f ? 0.0f : g;  // torch.clamp(min=0), NaN kept
}

__device__ __forceinline__ bool violates(const float4 src, const Target& t, const Image& im) {
    const float gx = gap(t.cx, src.x, t.sx, im.pl[0], im.il[0]);
    const float gy = gap(t.cy, src.y, t.sy, im.pl[1], im.il[1]);
    const float gz = gap(t.cz, src.z, t.sz, im.pl[2], im.il[2]);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
    return r2 < fabsf(src.w);
}

__device__ __forceinline__ void mark(int32_t* marks, int node) {
    if (marks[node] == 0) marks[node] = 1;
}

// Tests the eight children of a passed node (first child `first`, indices
// clamped to the last slot as the plain walk clamps them), marks those that
// pass, and returns the mask of those that pass and are internal.
__device__ __forceinline__ unsigned expand(const float4* __restrict__ geo, const int2* __restrict__ meta,
                                           int first, int last, const Target& t, const Image& im,
                                           int32_t* marks) {
    unsigned push = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int c = min(first + k, last);
        const int2 m = __ldg(&meta[c]);
        const float4 g = __ldg(&geo[c]);
        if (m.y <= t.max_level && violates(g, t, im)) {
            mark(marks, c);
            if (m.x != 0) push |= 1u << k;
        }
    }
    return push;
}

template <int DEPTH>
__global__ void __launch_bounds__(BLOCK) mark_macs_kernel(
    const float4* __restrict__ geo, const int2* __restrict__ meta, const float* __restrict__ t_center,
    const float* __restrict__ t_size, const int32_t* __restrict__ max_level, int n_targets, int cap_nodes,
    const float* __restrict__ lengths, int periodic, int32_t* marks) {
    const int q = blockIdx.x * BLOCK + threadIdx.x;
    if (q >= n_targets) return;
    Target t;
    t.max_level = max_level[q];
    if (t.max_level < 0) return;  // inactive
    t.cx = t_center[3 * q];
    t.cy = t_center[3 * q + 1];
    t.cz = t_center[3 * q + 2];
    t.sx = t_size[3 * q];
    t.sy = t_size[3 * q + 1];
    t.sz = t_size[3 * q + 2];
    Image im;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        im.pl[d] = (periodic >> d) & 1 ? lengths[d] : 0.0f;
        im.il[d] = lengths[3 + d];
    }

    const int2 root = __ldg(&meta[0]);
    if (!(root.y <= t.max_level && violates(__ldg(&geo[0]), t, im))) return;
    mark(marks, 0);
    if (root.x == 0) return;  // the root is a leaf

    const int last = cap_nodes - 1;
    int first[DEPTH];
    unsigned pending[DEPTH];
    int top = 0;
    first[0] = root.x;
    pending[0] = expand(geo, meta, root.x, last, t, im, marks);
    while (true) {
        const unsigned m = pending[top];
        if (m == 0) {
            if (top == 0) break;
            --top;
            continue;
        }
        pending[top] = m & (m - 1);
        const int c = min(first[top] + __ffs(m) - 1, last);
        // a pushed node is internal, so on a cornerstone tree its level is
        // below max_tree_level and top + 1 < DEPTH always holds
        if (top + 1 < DEPTH) {
            const int child = __ldg(&meta[c]).x;
            ++top;
            first[top] = child;
            pending[top] = expand(geo, meta, child, last, t, im, marks);
        }
    }
}

}  // namespace

extern "C" int cstone_mark_macs(const float* geo, const int32_t* meta, const float* t_center,
                                const float* t_size, const int32_t* max_level, int n_targets, int cap_nodes,
                                const float* lengths, int periodic, int key_levels, int32_t* marks,
                                void* stream) {
    const int grid = (n_targets + BLOCK - 1) / BLOCK;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto g = reinterpret_cast<const float4*>(geo);
    const auto m = reinterpret_cast<const int2*>(meta);
    if (key_levels != 10 && key_levels != 21) return static_cast<int>(cudaErrorInvalidValue);
    if (n_targets > 0 && cap_nodes > 0) {
        if (key_levels == 10) {
            mark_macs_kernel<11><<<grid, BLOCK, 0, s>>>(g, m, t_center, t_size, max_level, n_targets,
                                                        cap_nodes, lengths, periodic, marks);
        } else {
            mark_macs_kernel<22><<<grid, BLOCK, 0, s>>>(g, m, t_center, t_size, max_level, n_targets,
                                                        cap_nodes, lengths, periodic, marks);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
