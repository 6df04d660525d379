// The cornerstone fixed point of tree/csarray.py for NVIDIA Hopper
// (sm_90a): its three integer functions, compute_node_counts,
// rebalance_decision and rebalance_tree, as three kernels (csarray.hpp:
// 187-254 computeNodeCounts, 269-348 siblingAndLevel and rebalanceDecision,
// 350-409 rebalanceTree).
//
// Replaces no TPU kernel. The JAX package runs the fixed point in plain JAX,
// and the port's plain functions (the version CPU tensors take) dispatch
// about 600 small integer torch operations in a warm one-card sync: wheres,
// casts, emulated unsigned shifts and the 25-operation count-leading-zeros
// inside tree_level, octal_digit and log8_ceil, each a pass over the tree's
// node slots that does almost no device work. Every sync runs the fixed
// point, so those operations, not the card, set the pace of a one-card step.
//
// What bounds it (H100 SXM, 700 W; the main path's capacity 131,072 node
// slots, 2M sorted uint64 particle keys): bytes, and in practice launch
// latency. The counts read 8 bytes a node boundary and write 8 a slot; each
// boundary's binary search touches 21 of the 16 MB of particle keys, which
// stay in the 50 MB L2. The decision reads a slot's key, its group's two
// boundary keys and at most 8 counts, and writes 4 bytes; the emission
// reads the keys and op codes, the scan, and writes 8 bytes a slot. About
// 7 MB in all, 2 us at 3.35 TB/s. The design answers the launch latency:
// one launch a function, no host read, no temporaries beyond the scan.
//
// Design:
// - counts: one thread a node slot (grid-stride) binary-searches both of
//   its boundary keys among the particle keys, as torch.searchsorted's own
//   lower bound does (so even keys past n_codes give the plain function's
//   answer), limits both to n_codes (read on the card, or passed by value),
//   and writes their difference clipped to max_count. A slot whose two
//   boundaries are equal (the padding) counts 0 without a search.
// - decide: one thread a node slot: the level from __clz / __clzll of the
//   key range, the sibling digit, the 8-sibling group test of
//   siblingAndLevel, the split codes, and the merge test on the parent's
//   count, the direct sum of the at most 8 counts counts[first ..
//   min(first + 8, cap) - 1] (equal to the plain function's difference of
//   an inclusive scan, so none is needed). Slots at or past n_nodes (read
//   on the card) write 0. Any valid slot whose op is not 1 clears the
//   convergence flag, which the wrapper sets once per call beforehand.
// - emit: over the wrapper's inclusive scan of the op codes (torch.cumsum),
//   one thread an output slot binary-searches the scan for its source node,
//   as the plain function does, with the same clamp of the source to the
//   last slot, and writes the source's start key plus the offset times the
//   source's new node range; slots at or past the new total, and the
//   terminal slot, take the end key nodeRange(0).
// - Keys are templated on width: uint32 keys with maxLevel 10 (2 unused
//   leading bits), uint64 keys with maxLevel 21 (1), in the int32 / int64
//   storage of ops/keys64.py, compared unsigned. Counts, scans and node
//   counts are int64, op codes int32.
//
// Contract: every output equals the plain function's bit for bit over the
// whole padded capacity, the new node count included where it passes the
// capacity.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for arguments it
// does not take. It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

template <typename Key>
struct Keys;

template <>
struct Keys<uint32_t> {
    static constexpr int LMAX = 10;
    static constexpr int UNUSED = 2;
    __device__ static int clz(uint32_t x) { return __clz(static_cast<int>(x)); }
};

template <>
struct Keys<uint64_t> {
    static constexpr int LMAX = 21;
    static constexpr int UNUSED = 1;
    __device__ static int clz(uint64_t x) { return __clzll(static_cast<long long>(x)); }
};

// floor division by 3, as torch.div(..., rounding_mode="floor")
__device__ __forceinline__ int floor_div3(int a) {
    const int q = a / 3;
    return (a % 3 != 0 && a < 0) ? q - 1 : q;
}

// the level of a node spanning `range` keys (sfc/keys.tree_level)
template <typename Key>
__device__ __forceinline__ int tree_level(Key range) {
    return floor_div3(Keys<Key>::clz(range - 1) - Keys<Key>::UNUSED);
}

// the key range of a node at `level` (sfc/keys.node_range)
template <typename Key>
__device__ __forceinline__ Key node_range(int level) {
    return Key(1) << (3 * (Keys<Key>::LMAX - level));
}

// ceil(log8(n)), 0 for n == 0 (sfc/keys.log8_ceil)
template <typename Key>
__device__ __forceinline__ int log8_ceil(Key n) {
    return n == 0 ? 0 : Keys<Key>::LMAX - floor_div3(Keys<Key>::clz(n - 1) - Keys<Key>::UNUSED);
}

// first index in [0, n) whose key is >= q, unsigned (torch.searchsorted's
// lower bound, step for step)
template <typename Key>
__device__ __forceinline__ int64_t lower_bound(const Key* __restrict__ a, int64_t n, Key q) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (!(a[mid] >= q)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// first index in [0, n) whose entry is > q, unsigned (torch.searchsorted's
// upper bound over primitives.searchsorted's flipped int64)
__device__ __forceinline__ int64_t upper_bound(const int64_t* __restrict__ a, int64_t n, int64_t q) {
    const uint64_t uq = static_cast<uint64_t>(q);
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (!(static_cast<uint64_t>(a[mid]) > uq)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// computeNodeCounts (csarray.hpp:187-254) as tree/csarray.py writes it
template <typename Key>
__global__ void __launch_bounds__(BLOCK) counts_kernel(const Key* __restrict__ keys, int64_t cap,
                                                       const Key* __restrict__ codes, int64_t n_len,
                                                       const int64_t* __restrict__ n_codes_p, int64_t n_codes_host,
                                                       int64_t max_count, int64_t* __restrict__ counts) {
    const int64_t limit = n_codes_p != nullptr ? *n_codes_p : n_codes_host;
    for (int64_t i = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; i < cap;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        const Key a = keys[i];
        const Key b = keys[i + 1];
        int64_t c = 0;
        if (a != b) {
            int64_t ea = lower_bound(codes, n_len, a);
            int64_t eb = lower_bound(codes, n_len, b);
            ea = ea < limit ? ea : limit;
            eb = eb < limit ? eb : limit;
            c = eb - ea;
        }
        counts[i] = c < max_count ? c : max_count;
    }
}

// siblingAndLevel and rebalanceDecision (csarray.hpp:269-348)
template <typename Key>
__global__ void __launch_bounds__(BLOCK) decide_kernel(const Key* __restrict__ keys,
                                                       const int64_t* __restrict__ counts,
                                                       const int64_t* __restrict__ n_nodes_p, int64_t cap,
                                                       int64_t bucket, int32_t* __restrict__ ops,
                                                       bool* __restrict__ converged) {
    constexpr int LMAX = Keys<Key>::LMAX;
    const Key end_key = node_range<Key>(0);
    const int64_t n_nodes = *n_nodes_p;
    for (int64_t i = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; i < cap;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        if (i >= n_nodes) {
            ops[i] = 0;
            continue;
        }
        const Key key = keys[i];
        const Key rng = keys[i + 1] - key;
        const int level = tree_level<Key>(rng != 0 ? rng : Key(1));

        // the sibling digit; the 8-sibling group is complete where its end
        // lies one parent range past its start
        const int64_t sib = static_cast<int64_t>((key >> (3 * (LMAX - level))) & Key(7));
        const int64_t lo = i - sib;
        const int64_t hi = i + 8 - sib;
        const Key group = lo >= 0 ? keys[lo] : end_key;
        const Key group_end = hi < cap ? keys[hi] : end_key;
        const bool ok = group_end == group + node_range<Key>((level > 1 ? level : 1) - 1) && level > 0 && sib <= i;

        const int64_t c = counts[i];
        int32_t op = 1;
        if (c > bucket && level < LMAX) op = 8;
        if (c > bucket * 8 && level + 1 < LMAX) op = 64;
        if (c > bucket * 64 && level + 2 < LMAX) op = 512;
        if (c > bucket * 512 && level + 3 < LMAX) op = 4096;
        if (ok && sib > 0) {
            const int64_t last = lo + 8 < cap ? lo + 8 : cap;
            uint64_t parent = 0;  // wraps as the plain function's int64 scan does
            for (int64_t k = lo; k < last; ++k) parent += static_cast<uint64_t>(counts[k]);
            if (static_cast<int64_t>(parent) <= bucket) op = 0;
        }
        ops[i] = op;
        if (op != 1) *converged = false;
    }
}

// rebalanceTree (csarray.hpp:350-409) over the inclusive scan of the ops
template <typename Key>
__global__ void __launch_bounds__(BLOCK) emit_kernel(const Key* __restrict__ keys, const int32_t* __restrict__ ops,
                                                     const int64_t* __restrict__ inc, int64_t cap,
                                                     Key* __restrict__ new_keys) {
    constexpr int LMAX = Keys<Key>::LMAX;
    const Key end_key = node_range<Key>(0);
    const int64_t total = inc[cap - 1];
    for (int64_t j = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; j <= cap;
         j += static_cast<int64_t>(gridDim.x) * BLOCK) {
        Key out = end_key;
        if (j < cap && j < total) {
            int64_t src = upper_bound(inc, cap, j);
            src = src < cap - 1 ? src : cap - 1;
            const int64_t op = ops[src];
            const Key offset = static_cast<Key>(j - (inc[src] - op));
            const Key key = keys[src];
            const Key rng = keys[src + 1] - key;
            int new_level = tree_level<Key>(rng != 0 ? rng : Key(1)) + log8_ceil<Key>(static_cast<Key>(op));
            new_level = new_level < LMAX ? new_level : LMAX;
            out = key + offset * node_range<Key>(new_level);
        }
        new_keys[j] = out;
    }
}

int blocks_for(int64_t n) {
    const int64_t b = (n + BLOCK - 1) / BLOCK;
    return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// keys: (cap + 1,) node boundaries; codes: (n_len,) sorted particle keys,
// both uint32 (key64 = 0) or uint64. n_codes: one int64 on the card, or
// null to take n_codes_host. Writes counts (cap, int64).
extern "C" int cstone_csarray_counts(const void* keys, int64_t cap, const void* codes, int64_t n_len,
                                     const int64_t* n_codes, int64_t n_codes_host, int64_t max_count, int key64,
                                     int64_t* counts, void* stream) {
    if (cap < 1 || n_len < 0) return invalid();
    const auto s = static_cast<cudaStream_t>(stream);
    if (key64) {
        counts_kernel<uint64_t><<<blocks_for(cap), BLOCK, 0, s>>>(static_cast<const uint64_t*>(keys), cap,
                                                                  static_cast<const uint64_t*>(codes), n_len,
                                                                  n_codes, n_codes_host, max_count, counts);
    } else {
        counts_kernel<uint32_t><<<blocks_for(cap), BLOCK, 0, s>>>(static_cast<const uint32_t*>(keys), cap,
                                                                  static_cast<const uint32_t*>(codes), n_len,
                                                                  n_codes, n_codes_host, max_count, counts);
    }
    return static_cast<int>(cudaGetLastError());
}

// keys: (cap + 1,) node boundaries; counts: (cap,) int64; n_nodes: one
// int64 on the card. Writes ops (cap, int32) and clears *converged (one
// bool, set by the caller) where a valid slot's op is not 1.
extern "C" int cstone_csarray_decide(const void* keys, const int64_t* counts, const int64_t* n_nodes, int64_t cap,
                                     int64_t bucket, int key64, int32_t* ops, bool* converged, void* stream) {
    if (cap < 1) return invalid();
    const auto s = static_cast<cudaStream_t>(stream);
    if (key64) {
        decide_kernel<uint64_t><<<blocks_for(cap), BLOCK, 0, s>>>(static_cast<const uint64_t*>(keys), counts,
                                                                  n_nodes, cap, bucket, ops, converged);
    } else {
        decide_kernel<uint32_t><<<blocks_for(cap), BLOCK, 0, s>>>(static_cast<const uint32_t*>(keys), counts,
                                                                  n_nodes, cap, bucket, ops, converged);
    }
    return static_cast<int>(cudaGetLastError());
}

// keys: (cap + 1,) node boundaries; ops: (cap,) int32; inc: their
// inclusive scan (cap, int64). Writes new_keys (cap + 1, the key width).
extern "C" int cstone_csarray_emit(const void* keys, const int32_t* ops, const int64_t* inc, int64_t cap, int key64,
                                   void* new_keys, void* stream) {
    if (cap < 1) return invalid();
    const auto s = static_cast<cudaStream_t>(stream);
    if (key64) {
        emit_kernel<uint64_t><<<blocks_for(cap + 1), BLOCK, 0, s>>>(static_cast<const uint64_t*>(keys), ops, inc,
                                                                    cap, static_cast<uint64_t*>(new_keys));
    } else {
        emit_kernel<uint32_t><<<blocks_for(cap + 1), BLOCK, 0, s>>>(static_cast<const uint32_t*>(keys), ops, inc,
                                                                    cap, static_cast<uint32_t*>(new_keys));
    }
    return static_cast<int>(cudaGetLastError());
}
