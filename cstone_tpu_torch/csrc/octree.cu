// The linked-octree build of tree/octree.py (build_linked_octree) for
// NVIDIA Hopper (sm_90a): two launches around one library sort, in the
// shape of the reference's GPU build (octree.hpp:55-214: create the
// unsorted layout, sort by key, link the tree and find the level ranges).
//
// Replaces no TPU kernel. The JAX package builds the linked octree in
// plain JAX, and the port's plain build (the version CPU tensors take) is
// 616 small integer torch operations a build: the 21-round binary key
// weight loop, three count-leading-zeros emulations of 25 operations each,
// the int64 emulation of unsigned shifts, sort and searchsorted, and 3
// host reads (two boolean selects in the leaf_to_internal scatter and the
// upload of the level start keys). One-card syncs rebuild the tree every
// warm step, so those operations, not the card, set the pace there.
//
// What bounds it (H100 SXM, 700 W; the main path's cap_leaf 131,072,
// uint64 keys): bytes. The build reads 8 bytes a leaf and writes the
// linked arrays, about 33 bytes a node slot (cap_nodes is 1.14 cap_leaf):
// 6.0 MB, 1.8 us at 3.35 TB/s; the rows, the sort's passes and the zeroed
// scatter target add a few times that. The integer work (a binary key
// weight of at most 21 rounds a leaf, a binary search of 18 steps a node
// and one an 8-sibling group) is smaller still. In practice launch
// latency bounds it: the design answers that with two launches and one
// sort in place of 616 passes, and reads nothing back to the host.
//
// Design:
// - layout: one thread a cornerstone leaf (grid-stride). It computes the
//   leaf's level and prefix, the common prefix with the next key and
//   whether it hosts an internal node (is_oct), the binary key weight as
//   a register loop up to the prefix's level with __clz / __clzll, the
//   internal node's slot and prefix, and writes the 2 * cap_leaf (prefix,
//   id) rows in the plain code's torch.cat order: leaf rows first, then
//   internal rows, sentinels (all ones) where a row is empty, prefixes
//   stored sign-flipped (ops/keys64.flip) so that one signed sort orders
//   them as unsigned keys. The same threads zero leaf_to_internal, the
//   scatter target of the link, and thread 0 writes n_internal.
// - sort: the wrapper's one stable torch.sort of the flipped rows. The
//   plain build sorts the same rows with the same call, so the
//   permutation, and with it every padding slot, is the same.
// - link: one thread a sorted node slot (grid-stride over the larger of
//   cap_nodes, cap_parents and maxLevel + 2). It un-flips the prefix,
//   gathers the slot's id, writes internal_to_leaf, scatters
//   leaf_to_internal where the id lies below cap_nodes (ids are unique,
//   so no two threads write one slot), and binary-searches the sorted
//   rows for the first child p << 3 (the child exists where the lower
//   bound holds it: lower and upper bound differ exactly then), for the
//   parent p >> 3 of each 8-sibling group's first child, and, in threads
//   0..maxLevel, for each level's start key 1 << 3l.
// - n_leaf is read on the card by both kernels; n_internal = (n_leaf - 1)
//   // 7 and n_nodes are computed there.
// - Keys are templated on width: uint32 keys with maxLevel 10 (2 unused
//   leading bits), uint64 keys with maxLevel 21 (1), in the int32 / int64
//   storage of ops/keys64.py. Index arrays are int64.
//
// Contract: leaves[0..n_leaf] is a cornerstone array (n_leaf >= 1); every
// output equals the plain build's bit for bit over its whole capacity.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for arguments
// it does not take. It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

template <typename Key>
struct Keys;

template <>
struct Keys<uint32_t> {
    using Signed = int32_t;
    static constexpr int BITS = 32;
    static constexpr int LMAX = 10;
    static constexpr int UNUSED = 2;
    __device__ static int clz(uint32_t x) { return __clz(static_cast<int>(x)); }
};

template <>
struct Keys<uint64_t> {
    using Signed = int64_t;
    static constexpr int BITS = 64;
    static constexpr int LMAX = 21;
    static constexpr int UNUSED = 1;
    __device__ static int clz(uint64_t x) { return __clzll(static_cast<long long>(x)); }
};

// unsigned key -> signed storage whose signed order is the keys' unsigned order
template <typename Key>
__device__ __forceinline__ typename Keys<Key>::Signed flip(Key k) {
    return static_cast<typename Keys<Key>::Signed>(k ^ (Key(1) << (Keys<Key>::BITS - 1)));
}

template <typename Key>
__device__ __forceinline__ Key unflip(typename Keys<Key>::Signed s) {
    return static_cast<Key>(s) ^ (Key(1) << (Keys<Key>::BITS - 1));
}

// floor division by 7, as torch.div(..., rounding_mode="floor")
__device__ __forceinline__ int64_t floor_div7(int64_t a) {
    const int64_t q = a / 7;
    return (a % 7 != 0 && a < 0) ? q - 1 : q;
}

// first index in [0, n) whose row is >= q (torch.searchsorted, side left)
template <typename Signed>
__device__ __forceinline__ int64_t lower_bound(const Signed* __restrict__ rows, int64_t n, Signed q) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (rows[mid] < q) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// createUnsortedLayout (octree.hpp:95-118) as tree/octree.py writes it
template <typename Key>
__global__ void __launch_bounds__(BLOCK) layout_kernel(const Key* __restrict__ leaves,
                                                       const int64_t* __restrict__ n_leaf_p, int64_t cap_leaf,
                                                       int64_t cap_nodes, typename Keys<Key>::Signed* __restrict__ rows,
                                                       int64_t* __restrict__ ids,
                                                       int64_t* __restrict__ leaf_to_internal,
                                                       int64_t* __restrict__ n_internal_out) {
    using K = Keys<Key>;
    using Signed = typename K::Signed;
    constexpr int LMAX = K::LMAX;
    const Signed sentinel = flip<Key>(~Key(0));
    const int64_t n_leaf = *n_leaf_p;
    const int64_t n_internal = floor_div7(n_leaf - 1);
    const int64_t n = cap_leaf > cap_nodes ? cap_leaf : cap_nodes;
    for (int64_t tid = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; tid < n;
         tid += static_cast<int64_t>(gridDim.x) * BLOCK) {
        if (tid == 0) *n_internal_out = n_internal;
        if (tid < cap_nodes) leaf_to_internal[tid] = 0;
        if (tid >= cap_leaf) continue;

        const Key key = leaves[tid];
        const Key next = leaves[tid + 1];

        // the leaf: its level from its key range, its placeholder-bit prefix
        Signed leaf_row = sentinel;
        if (tid < n_leaf) {
            const Key rng = next - key;
            const Key safe_rng = rng != 0 ? rng : Key(1);
            const int level = (K::clz(safe_rng - 1) - K::UNUSED) / 3;
            const Key prefix = (key >> (3 * (LMAX - level))) | (Key(1) << (3 * level));
            leaf_row = flip<Key>(prefix);
        }
        rows[tid] = leaf_row;
        ids[tid] = n_internal + tid;

        // the internal node this leaf hosts where its common prefix with the
        // next leaf has full-octal length: slot (tid + weight) / 7
        Signed internal_row = sentinel;
        int64_t id = cap_nodes;
        if (tid < n_leaf - 1) {
            const int plen = K::clz(key ^ next) - K::UNUSED;
            if (plen % 3 == 0) {
                const int level = plen / 3;
                int weight = 0;  // binaryKeyWeight (octree.hpp:72-82)
                for (int l = 1; l <= level + 1; ++l) {
                    const int digit = static_cast<int>((key >> (3 * (LMAX - l))) & 7u);
                    weight += digit >= 4 ? 7 - digit : -digit;
                }
                id = floor_div7(tid + weight);
                internal_row = flip<Key>((key >> (3 * LMAX - plen)) | (Key(1) << plen));
            }
        }
        rows[cap_leaf + tid] = internal_row;
        ids[cap_leaf + tid] = id;
    }
}

// linkOctree and getLevelRange (octree.hpp:132-178) over the sorted rows
template <typename Key>
__global__ void __launch_bounds__(BLOCK) link_kernel(
    const typename Keys<Key>::Signed* __restrict__ sorted, const int64_t* __restrict__ order,
    const int64_t* __restrict__ ids, const int64_t* __restrict__ n_leaf_p, int64_t cap_nodes, int64_t cap_parents,
    Key* __restrict__ prefixes, int64_t* __restrict__ child_offsets, int64_t* __restrict__ parents,
    int64_t* __restrict__ level_range, int64_t* __restrict__ internal_to_leaf,
    int64_t* __restrict__ leaf_to_internal) {
    using K = Keys<Key>;
    using Signed = typename K::Signed;
    constexpr int LMAX = K::LMAX;
    const Signed sentinel = flip<Key>(~Key(0));
    const int64_t n_leaf = *n_leaf_p;
    const int64_t n_internal = floor_div7(n_leaf - 1);
    const int64_t n_nodes = n_leaf + n_internal;
    const int64_t par_count = (cap_nodes - 1) / 8 + 1;
    int64_t n = cap_nodes > cap_parents ? cap_nodes : cap_parents;
    n = n > LMAX + 2 ? n : LMAX + 2;
    for (int64_t i = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        if (i < cap_nodes) {
            const Key p = unflip<Key>(sorted[i]);
            prefixes[i] = p;
            const int64_t id = ids[order[i]];
            internal_to_leaf[i] = id - n_internal;
            if (id >= 0 && id < cap_nodes) leaf_to_internal[id] = i;

            // first child: the node whose prefix is p << 3, where p is above
            // the deepest level
            int64_t child = 0;
            const int plen = K::BITS - 1 - K::clz(p);
            if (plen <= 3 * LMAX - 3 && i < n_nodes) {
                const Signed q = flip<Key>(p << 3);
                const int64_t lo = lower_bound(sorted, cap_nodes, q);
                if (lo < cap_nodes && sorted[lo] == q) child = lo;
            }
            child_offsets[i] = child;
        }
        if (i < cap_parents) {
            // parent of sibling group i: the node whose prefix is the group's
            // first child's p >> 3
            int64_t parent = 0;
            const int64_t first = 8 * i + 1;
            if (i < par_count && first < n_nodes) {
                const Signed s = first < cap_nodes ? sorted[first] : sentinel;
                if (s != sentinel) parent = lower_bound(sorted, cap_nodes, flip<Key>(unflip<Key>(s) >> 3));
            }
            parents[i] = parent;
        }
        if (i <= LMAX) {
            const int64_t start = lower_bound(sorted, cap_nodes, flip<Key>(Key(1) << (3 * i)));
            level_range[i] = start < n_nodes ? start : n_nodes;
        } else if (i == LMAX + 1) {
            level_range[i] = n_nodes;
        }
    }
}

int blocks_for(int64_t n) {
    const int64_t b = (n + BLOCK - 1) / BLOCK;
    return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// leaves: (cap_leaf + 1,) uint32 (key64 = 0) or uint64 keys; n_leaf: one
// int64 on the card. Writes rows (2 cap_leaf, flipped prefixes in the key
// width), ids (2 cap_leaf, int64), zeroes leaf_to_internal (cap_nodes) and
// writes n_internal (one int64).
extern "C" int cstone_linked_octree_layout(const void* leaves, const int64_t* n_leaf, int64_t cap_leaf,
                                           int64_t cap_nodes, int key64, void* rows, int64_t* ids,
                                           int64_t* leaf_to_internal, int64_t* n_internal, void* stream) {
    if (cap_leaf < 1 || cap_nodes < 1 || cap_nodes > 2 * cap_leaf) return invalid();
    const auto s = static_cast<cudaStream_t>(stream);
    const int blocks = blocks_for(cap_leaf > cap_nodes ? cap_leaf : cap_nodes);
    if (key64) {
        layout_kernel<uint64_t><<<blocks, BLOCK, 0, s>>>(static_cast<const uint64_t*>(leaves), n_leaf, cap_leaf,
                                                         cap_nodes, static_cast<int64_t*>(rows), ids,
                                                         leaf_to_internal, n_internal);
    } else {
        layout_kernel<uint32_t><<<blocks, BLOCK, 0, s>>>(static_cast<const uint32_t*>(leaves), n_leaf, cap_leaf,
                                                         cap_nodes, static_cast<int32_t*>(rows), ids,
                                                         leaf_to_internal, n_internal);
    }
    return static_cast<int>(cudaGetLastError());
}

// sorted: the first cap_nodes of the layout's rows after the stable sort;
// order: their positions among the rows (int64); ids: the layout's ids.
// Writes prefixes (cap_nodes, key width), child_offsets, internal_to_leaf
// (cap_nodes), parents (cap_parents), level_range (maxLevel + 2), all
// int64, and scatters into leaf_to_internal (cap_nodes, zeroed by the layout).
extern "C" int cstone_linked_octree_link(const void* sorted, const int64_t* order, const int64_t* ids,
                                         const int64_t* n_leaf, int64_t cap_nodes, int64_t cap_parents, int key64,
                                         void* prefixes, int64_t* child_offsets, int64_t* parents,
                                         int64_t* level_range, int64_t* internal_to_leaf,
                                         int64_t* leaf_to_internal, void* stream) {
    if (cap_nodes < 1 || cap_parents < 1) return invalid();
    const auto s = static_cast<cudaStream_t>(stream);
    int64_t n = cap_nodes > cap_parents ? cap_nodes : cap_parents;
    n = n > 23 ? n : 23;  // maxLevel + 2 of uint64 keys, the larger of the two
    if (key64) {
        link_kernel<uint64_t><<<blocks_for(n), BLOCK, 0, s>>>(
            static_cast<const int64_t*>(sorted), order, ids, n_leaf, cap_nodes, cap_parents,
            static_cast<uint64_t*>(prefixes), child_offsets, parents, level_range, internal_to_leaf,
            leaf_to_internal);
    } else {
        link_kernel<uint32_t><<<blocks_for(n), BLOCK, 0, s>>>(
            static_cast<const int32_t*>(sorted), order, ids, n_leaf, cap_nodes, cap_parents,
            static_cast<uint32_t*>(prefixes), child_offsets, parents, level_range, internal_to_leaf,
            leaf_to_internal);
    }
    return static_cast<int>(cudaGetLastError());
}
