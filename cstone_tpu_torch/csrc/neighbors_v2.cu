// Run-streaming pairwise neighbour counts and lists for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel cstone_tpu/ops/pallas_neighbors_v2.py:103
// _kernel (_call :251-283, wrapper pairwise_count_runs :206), the default
// counts path of find_neighbors. The list mode (cstone_list_runs, no TPU
// counterpart) is the same tile loop writing each target's neighbours.
//
// Per group of G SFC-consecutive targets, the group's candidate particles
// are a few contiguous runs of the SFC-sorted coordinate arrays
// (merge_leaf_runs). Target t of group g (global index g*G + t) counts the
// candidates c of the group's runs with c != g*G + t and d2 < r2_t, where
// each displacement takes the minimum image exactly as the TPU kernel
// does: k = floor(d * (1/L) + 0.5), d -= (p * L) * k, with p = 1 on
// periodic dims and 0 on open ones. Targets with r2 < 0 count 0.
//
// Design: one CTA per group, two targets per thread (targets t and t + S
// of a CTA of S threads, S a multiple of 32; on the H100 this beat one
// target per thread, which reloads each candidate for every target). The
// CTA walks the group's runs in tiles of 2 * S candidates, each staged as
// float4 (x, y, z, -) with double-buffered 4-byte cp.async, so one
// broadcast 16-byte load feeds two tests. A thread owns its outputs: no atomics, deterministic.
// The TPU kernel's 1024-element window alignment, clamped-window mask and
// group_block padding are HBM-slice workarounds and are not needed here.
//
// The image once per tile and axis, exactly. fsub, fmul by 1/L > 0, fadd
// and floor are each monotone, so over a tile k = floor(d / L + 1/2) lies
// between its values at d_min = t_min - c_max and d_max = t_max - c_min,
// where [t_min, t_max] is the extent of the group's live targets (r2 > 0;
// the others count nothing whatever their d2) and [c_min, c_max] that of
// the tile. Where both ends give one k0, every pair of the tile has
// k = k0, and d - (p L) k equals d - s for the hoisted s = (p L) k0, bit
// for bit; where s = 0 the subtraction is skipped (d - 0 = d). Only a tile
// whose k range holds two values on some axis takes the per-pair image.
// Likewise the self test c != g*G + t runs only in tiles whose index range
// meets the group's own. Each choice is uniform over the CTA, so each is a
// template instance of the test loop, and counts stay bit-equal to the
// per-pair formula of pairwise_count_runs_plain.
//
// Bound on the H100 (SXM, 700 W) at chip_smoke's phase-6 shape (1M uniform
// particles, 3907 groups of 256, about 2.6e9 tests): FP32 issue on the
// pair tests, d2 and one compare (9 operations) a test; the coordinates
// are read once per group from device memory (L2-resident for neighbouring
// groups). With the image hoisted a test is a broadcast shared load shared
// by two tests, 3 sub, 3 mul, 2 add, a compare and the count: about 11
// instructions, where the per-pair image took about 34.
//
// Rounding: each operation is rounded on its own (__f*_rn, --fmad=false),
// in the operation order of the plain PyTorch version.
//
// List mode: the same template with LIST set. A thread owns its targets'
// rows of ng_max int64 slots, so on a hit it writes the candidate's index
// at the row's next slot while the count is below ng_max, and counts on
// (counts may exceed ng_max; a pair is listed exactly when count mode
// counts it). Tiles are taken in run order, and runs from merge_leaf_runs
// are sorted and disjoint, so each row is ascending. After the walk the
// CTA pads the rows with -1, a warp a row at a time over its tail: a
// group's G rows are one contiguous block, so these writes coalesce.
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TPT = 2;  // targets per thread

// how a tile's displacements take their image: not at all (k = 0 for every
// pair), one hoisted shift per axis (one k per axis), or per pair
enum Image { IMAGE_NONE, IMAGE_SHIFT, IMAGE_EACH };

__device__ __forceinline__ float min_image(float d, float il, float pl) {
    const float k = floorf(__fadd_rn(__fmul_rn(d, il), 0.5f));
    return __fsub_rn(d, __fmul_rn(pl, k));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// min and max of v over the warp, in every lane
__device__ __forceinline__ void warp_extent(float& lo, float& hi) {
    for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
    }
}

// box: Lx Ly Lz iLx iLy iLz px py pz (the JAX kernel's box_params)
struct Box {
    float il[3];  // 1 / L
    float pl[3];  // p * L
};

struct Targets {
    float x[TPT], y[TPT], z[TPT], r2[TPT];
    int self_j[TPT];  // this target's slot in the current tile (when it holds it)
    int count[TPT];
    int64_t* row[TPT];  // list mode: the target's ng_max slots
};

// The tests of one staged tile of m candidates c0 .. c0 + m - 1 against
// the thread's targets.
template <int MODE, bool SELF, bool LIST>
__device__ __forceinline__ void test_tile(const float4* __restrict__ c4, int m, Targets& q,
                                          float sx, float sy, float sz, const Box& box,
                                          int64_t c0, int ng_max) {
#pragma unroll 4  // overlaps the independent tests of consecutive candidates
    for (int j = 0; j < m; ++j) {
        const float4 c = c4[j];
#pragma unroll
        for (int u = 0; u < TPT; ++u) {
            float dx = __fsub_rn(q.x[u], c.x);
            float dy = __fsub_rn(q.y[u], c.y);
            float dz = __fsub_rn(q.z[u], c.z);
            if (MODE == IMAGE_SHIFT) {
                dx = __fsub_rn(dx, sx);
                dy = __fsub_rn(dy, sy);
                dz = __fsub_rn(dz, sz);
            } else if (MODE == IMAGE_EACH) {
                dx = min_image(dx, box.il[0], box.pl[0]);
                dy = min_image(dy, box.il[1], box.pl[1]);
                dz = min_image(dz, box.il[2], box.pl[2]);
            }
            const float d2 =
                __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
            const bool hit = (d2 < q.r2[u]) && (!SELF || j != q.self_j[u]);
            if (LIST) {
                if (hit) {
                    if (q.count[u] < ng_max) q.row[u][q.count[u]] = c0 + j;
                    ++q.count[u];
                }
            } else {
                q.count[u] += hit;
            }
        }
    }
}

template <int MODE, bool LIST>
__device__ __forceinline__ void run_tile(bool self, const float4* __restrict__ c4, int m,
                                         Targets& q, float sx, float sy, float sz,
                                         const Box& box, int64_t c0, int ng_max) {
    if (self) test_tile<MODE, true, LIST>(c4, m, q, sx, sy, sz, box, c0, ng_max);
    else test_tile<MODE, false, LIST>(c4, m, q, sx, sy, sz, box, c0, ng_max);
}

// LIST: lists holds G rows of ng_max slots a group, written as above
template <bool LIST>
__global__ void __launch_bounds__(1024 / TPT)
runs_kernel(const float* __restrict__ targets, const float* __restrict__ r2, int G,
            const int32_t* __restrict__ run_start, const int32_t* __restrict__ run_len, int R,
            const float* __restrict__ xs, const float* __restrict__ ys,
            const float* __restrict__ zs, const float* __restrict__ box_params,
            int32_t* __restrict__ out, int ng_max, int64_t* __restrict__ lists) {
    extern __shared__ float4 tiles[];  // [2][TILE]
    __shared__ float warp_ext[6][32];
    const int S = blockDim.x;
    const int TILE = S * TPT;
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5, n_warps = S >> 5;
    const int64_t g = blockIdx.x;
    const int64_t g0 = g * G;  // the group's first target = its own particle range
    Box box;
    for (int a = 0; a < 3; ++a) {
        box.il[a] = box_params[3 + a];
        box.pl[a] = __fmul_rn(box_params[6 + a], box_params[a]);
    }

    // the targets, and the extent of the live ones (r2 > 0) over the CTA
    Targets q;
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
        const int i = t + u * S;
        q.x[u] = q.y[u] = q.z[u] = 0.0f;
        q.r2[u] = -1.0f;
        q.count[u] = 0;
        q.row[u] = LIST && i < G ? lists + (g0 + i) * ng_max : nullptr;
        if (i < G) {
            q.x[u] = targets[3 * (g0 + i) + 0];
            q.y[u] = targets[3 * (g0 + i) + 1];
            q.z[u] = targets[3 * (g0 + i) + 2];
            q.r2[u] = r2[g0 + i];
        }
        if (q.r2[u] > 0.0f) {
            lo[0] = fminf(lo[0], q.x[u]), hi[0] = fmaxf(hi[0], q.x[u]);
            lo[1] = fminf(lo[1], q.y[u]), hi[1] = fmaxf(hi[1], q.y[u]);
            lo[2] = fminf(lo[2], q.z[u]), hi[2] = fmaxf(hi[2], q.z[u]);
        }
    }
    for (int a = 0; a < 3; ++a) {
        warp_extent(lo[a], hi[a]);
        if (lane == 0) warp_ext[a][wid] = lo[a], warp_ext[3 + a][wid] = hi[a];
    }
    __syncthreads();
    for (int a = 0; a < 3; ++a) {
        for (int w = 0; w < n_warps; ++w) {
            lo[a] = fminf(lo[a], warp_ext[a][w]);
            hi[a] = fmaxf(hi[a], warp_ext[3 + a][w]);
        }
    }

    const int32_t* rs = run_start + g * R;
    const int32_t* rl = run_len + g * R;
    // from (r, base), the first tile of the walk that holds candidates
    auto skip_empty = [&](int& r, int& base) {
        while (r < R && base >= rl[r]) {
            ++r;
            base = 0;
        }
    };
    auto stage = [&](int r, int base, int buf) {
        const int m = min(TILE, rl[r] - base);
        const int64_t c0 = static_cast<int64_t>(rs[r]) + base;
        for (int j = t; j < m; j += S) {
            float* d = reinterpret_cast<float*>(&tiles[buf * TILE + j]);
            cp_async4(d + 0, xs + c0 + j);
            cp_async4(d + 1, ys + c0 + j);
            cp_async4(d + 2, zs + c0 + j);
        }
    };

    int r = 0, base = 0, buf = 0;
    skip_empty(r, base);
    // CTA-uniform: no live target (lo > hi) or no candidate counts nothing
    if (lo[0] <= hi[0] && r < R) {
        stage(r, base, 0);
        cp_async_commit();
    } else {
        r = R;
    }
    while (r < R) {
        int nr = r, nbase = base + TILE;
        skip_empty(nr, nbase);
        if (nr < R) stage(nr, nbase, buf ^ 1);
        cp_async_commit();
        cp_async_wait_one();  // this thread's copies of the current tile are in
        __syncthreads();      // and every thread's

        const float4* c4 = tiles + buf * TILE;
        const int m = min(TILE, rl[r] - base);
        const int64_t c0 = static_cast<int64_t>(rs[r]) + base;
        // the tile's extent, reduced by every warp on its own
        float clo[3] = {INFINITY, INFINITY, INFINITY}, chi[3] = {-INFINITY, -INFINITY, -INFINITY};
        for (int j = lane; j < m; j += 32) {
            const float4 c = c4[j];
            clo[0] = fminf(clo[0], c.x), chi[0] = fmaxf(chi[0], c.x);
            clo[1] = fminf(clo[1], c.y), chi[1] = fmaxf(chi[1], c.y);
            clo[2] = fminf(clo[2], c.z), chi[2] = fmaxf(chi[2], c.z);
        }
        bool each = false, shift = false;
        float s[3] = {0.0f, 0.0f, 0.0f};
        for (int a = 0; a < 3; ++a) {
            warp_extent(clo[a], chi[a]);
            if (box.pl[a] == 0.0f) continue;  // open: d - 0 * k = d
            const float k_lo = floorf(__fadd_rn(__fmul_rn(__fsub_rn(lo[a], chi[a]), box.il[a]), 0.5f));
            const float k_hi = floorf(__fadd_rn(__fmul_rn(__fsub_rn(hi[a], clo[a]), box.il[a]), 0.5f));
            if (k_lo != k_hi) {
                each = true;
            } else {
                s[a] = __fmul_rn(box.pl[a], k_lo);
                shift = shift || s[a] != 0.0f;
            }
        }
        // the group's own particles are targets g0 .. g0 + G - 1
        const bool self = c0 < g0 + G && c0 + m > g0;
        if (self) {
#pragma unroll
            for (int u = 0; u < TPT; ++u) q.self_j[u] = static_cast<int>(g0 + t + u * S - c0);
        }
        if (each) run_tile<IMAGE_EACH, LIST>(self, c4, m, q, 0.0f, 0.0f, 0.0f, box, c0, ng_max);
        else if (shift) run_tile<IMAGE_SHIFT, LIST>(self, c4, m, q, s[0], s[1], s[2], box, c0, ng_max);
        else run_tile<IMAGE_NONE, LIST>(self, c4, m, q, 0.0f, 0.0f, 0.0f, box, c0, ng_max);
        __syncthreads();  // the tile is read before the next stage overwrites it
        r = nr;
        base = nbase;
        buf ^= 1;
    }
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
        const int i = t + u * S;
        if (i < G) out[g0 + i] = q.count[u];
    }
    if (LIST) {
        // the tiles are read (the loop's last barrier): their memory holds
        // each row's first free slot
        int* filled = reinterpret_cast<int*>(tiles);
#pragma unroll
        for (int u = 0; u < TPT; ++u) {
            const int i = t + u * S;
            if (i < G) filled[i] = min(q.count[u], ng_max);
        }
        __syncthreads();
        for (int i = wid; i < G; i += n_warps) {
            int64_t* row = lists + (g0 + i) * ng_max;
            for (int k = filled[i] + lane; k < ng_max; k += 32) row[k] = -1;
        }
    }
}

}  // namespace

// The CTA has S = 32 * ceil(G / 64) threads and tiles of 2 * S candidates,
// staged in 2 * 16 * 2 * S bytes of dynamic shared memory.
extern "C" int cstone_count_runs(const float* targets, const float* r2, const int32_t* run_start,
                                 const int32_t* run_len, int n_groups, int group_size, int R,
                                 const float* xs, const float* ys, const float* zs,
                                 const float* box, int32_t* out, void* stream) {
    const int S = 32 * ((group_size + 32 * TPT - 1) / (32 * TPT));
    const size_t smem = static_cast<size_t>(2) * S * TPT * sizeof(float4);
    runs_kernel<false><<<n_groups, S, smem, static_cast<cudaStream_t>(stream)>>>(
        targets, r2, group_size, run_start, run_len, R, xs, ys, zs, box, out, 0, nullptr);
    return static_cast<int>(cudaGetLastError());
}

// The list mode on the same grid: counts as above, and lists
// (n_groups * G rows of ng_max int64) the first ng_max neighbours of each
// target in run order, padded with -1.
extern "C" int cstone_list_runs(const float* targets, const float* r2, const int32_t* run_start,
                                const int32_t* run_len, int n_groups, int group_size, int R,
                                const float* xs, const float* ys, const float* zs,
                                const float* box, int ng_max, int32_t* out, int64_t* lists,
                                void* stream) {
    const int S = 32 * ((group_size + 32 * TPT - 1) / (32 * TPT));
    const size_t smem = static_cast<size_t>(2) * S * TPT * sizeof(float4);
    runs_kernel<true><<<n_groups, S, smem, static_cast<cudaStream_t>(stream)>>>(
        targets, r2, group_size, run_start, run_len, R, xs, ys, zs, box, out, ng_max, lists);
    return static_cast<int>(cudaGetLastError());
}
