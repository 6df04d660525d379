// Host-side native kernels of the PyTorch port (cstone_tpu_torch), the
// port's own copy of cstone_tpu/native/csrc/cstone_host.cpp.
//
// The reference does this work on the CPU (the OpenMP paths of
// include/cstone/{sfc,tree}): Hilbert keys of float coordinates and the
// cornerstone tree of sorted keys, on host buffers without a device round
// trip. It serves as an oracle: tests/test_torch_leaves.py holds it
// against the port's sfc/encode.py and tree/csarray.py. No card path
// calls it.
//
// Build: cstone_tpu_torch/native/__init__.py compiles this with g++ on
// first use into cstone_tpu_torch/_build/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr unsigned kMaxLevel64 = 21;
constexpr unsigned kMaxLevel32 = 10;

inline uint64_t expand3_64(uint64_t v)
{
    uint64_t x = v & 0x1fffffULL;
    x = (x | x << 32) & 0x001f00000000ffffULL;
    x = (x | x << 16) & 0x001f0000ff0000ffULL;
    x = (x | x << 8) & 0x100f00f00f00f00fULL;
    x = (x | x << 4) & 0x10c30c30c30c30c3ULL;
    x = (x | x << 2) & 0x1249249249249249ULL;
    return x;
}

inline unsigned mortonToHilbert(unsigned octant)
{
    // gray(o) ^ (o >> 2), see cstone_tpu_torch/sfc/hilbert.py
    return (octant ^ (octant >> 1)) ^ (octant >> 2);
}

template<class KeyT, unsigned kLevels>
KeyT hilbertKey(unsigned px, unsigned py, unsigned pz)
{
    KeyT key = 0;
    for (int level = int(kLevels) - 1; level >= 0; --level)
    {
        unsigned xi = (px >> level) & 1u;
        unsigned yi = (py >> level) & 1u;
        unsigned zi = (pz >> level) & 1u;
        unsigned octant = (xi << 2) | (yi << 1) | zi;
        key = (key << 3) + mortonToHilbert(octant);

        px ^= -(xi & ((!yi) | zi));
        py ^= -((xi & (yi | zi)) | (yi & (!zi)));
        pz ^= -((xi & (!yi) & (!zi)) | (yi & (!zi)));

        if (zi)
        {
            unsigned t = px;
            px = py;
            py = pz;
            pz = t;
        }
        else if (!yi)
        {
            unsigned t = px;
            px = pz;
            pz = t;
        }
    }
    return key;
}

template<class F>
void parallelFor(int64_t n, F&& f)
{
    unsigned nt = std::max(1u, std::thread::hardware_concurrency());
    if (n < 4096 || nt == 1)
    {
        for (int64_t i = 0; i < n; ++i)
            f(i);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t)
    {
        int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([=, &f] {
            for (int64_t i = lo; i < hi; ++i)
                f(i);
        });
    }
    for (auto& th : threads)
        th.join();
}

template<class KeyT, unsigned kLevels>
void encodeHilbert(const float* x, const float* y, const float* z, int64_t n,
                   const float* boxLimits, KeyT* out)
{
    const float xmin = boxLimits[0], xmax = boxLimits[1];
    const float ymin = boxLimits[2], ymax = boxLimits[3];
    const float zmin = boxLimits[4], zmax = boxLimits[5];
    const float cube = float(1u << kLevels);
    const float mx = cube / (xmax - xmin);
    const float my = cube / (ymax - ymin);
    const float mz = cube / (zmax - zmin);
    const int mcoord = (1 << kLevels) - 1;

    parallelFor(n, [&](int64_t i) {
        int ix = int(std::floor(x[i] * mx) - xmin * mx);
        int iy = int(std::floor(y[i] * my) - ymin * my);
        int iz = int(std::floor(z[i] * mz) - zmin * mz);
        ix = std::min(ix, mcoord);
        iy = std::min(iy, mcoord);
        iz = std::min(iz, mcoord);
        out[i] = hilbertKey<KeyT, kLevels>(unsigned(ix), unsigned(iy), unsigned(iz));
    });
}

// ---- cornerstone tree build (host) ---------------------------------------

template<class KeyT, unsigned kLevels>
unsigned treeLevelOf(KeyT range)
{
    // range is a power of 8 <= 2^(3*kLevels); a leaf at the deepest level
    // has range 1, and __builtin_clz of 0 is undefined
    unsigned lz;
    if constexpr (sizeof(KeyT) == 8) { lz = range > 1 ? __builtin_clzll(range - 1) : 64; }
    else { lz = range > 1 ? __builtin_clz(range - 1) : 32; }
    unsigned unused = sizeof(KeyT) == 8 ? 1 : 2;
    return (lz - unused) / 3;
}

template<class KeyT, unsigned kLevels>
int64_t computeOctree(const KeyT* codes, int64_t nCodes, unsigned bucket,
                      KeyT* treeKeys, uint32_t* counts, int64_t cap)
{
    const KeyT endKey = KeyT(1) << (3 * kLevels);
    std::vector<KeyT> tree = {0, endKey};
    std::vector<uint32_t> cnt = {uint32_t(std::min<int64_t>(nCodes, 0xFFFFFFFF))};

    auto count = [&](std::vector<KeyT>& t, std::vector<uint32_t>& c) {
        int64_t nn = int64_t(t.size()) - 1;
        c.resize(nn);
        parallelFor(nn, [&](int64_t i) {
            auto lo = std::lower_bound(codes, codes + nCodes, t[i]);
            auto hi = std::lower_bound(codes, codes + nCodes, t[i + 1]);
            c[i] = uint32_t(std::min<int64_t>(hi - lo, 0xFFFFFFFF));
        });
    };
    count(tree, cnt);

    for (int iter = 0; iter < 128; ++iter)
    {
        int64_t nn = int64_t(tree.size()) - 1;
        std::vector<int64_t> ops(nn + 1, 0);
        std::atomic<bool> converged{true};
        parallelFor(nn, [&](int64_t i) {
            KeyT range = tree[i + 1] - tree[i];
            unsigned level = treeLevelOf<KeyT, kLevels>(range);
            int op = 1;
            // merge check: sibling group sum <= bucket
            if (level > 0)
            {
                unsigned sib = unsigned((tree[i] >> (3 * (kLevels - level))) & 7u);
                int64_t g = i - sib;
                if (sib > 0 && g + 8 <= nn &&
                    tree[g + 8] == tree[g] + (KeyT(1) << (3 * (kLevels - level + 1))))
                {
                    uint64_t parentCount = 0;
                    for (int k = 0; k < 8; ++k)
                        parentCount += cnt[g + k];
                    if (parentCount <= bucket) op = 0;
                }
            }
            if (op != 0)
            {
                uint64_t c = cnt[i];
                if (c > uint64_t(bucket) * 512 && level + 3 < kLevels) op = 4096;
                else if (c > uint64_t(bucket) * 64 && level + 2 < kLevels) op = 512;
                else if (c > uint64_t(bucket) * 8 && level + 1 < kLevels) op = 64;
                else if (c > bucket && level < kLevels) op = 8;
            }
            if (op != 1) converged.store(false, std::memory_order_relaxed);
            ops[i] = op;
        });

        // exclusive scan + emit
        int64_t total = 0;
        for (int64_t i = 0; i < nn; ++i)
        {
            int64_t v = ops[i];
            ops[i] = total;
            total += v;
        }
        ops[nn] = total;
        std::vector<KeyT> newTree(total + 1);
        parallelFor(nn, [&](int64_t i) {
            int64_t opCode = ops[i + 1] - ops[i];
            if (opCode == 0) return;
            KeyT thisKey = tree[i];
            unsigned level = treeLevelOf<KeyT, kLevels>(tree[i + 1] - thisKey);
            unsigned levelDiff = 0;
            for (int64_t v = opCode; v > 1; v /= 8)
                ++levelDiff;
            KeyT step = KeyT(1) << (3 * (kLevels - level - levelDiff));
            for (int64_t s = 0; s < opCode; ++s)
                newTree[ops[i] + s] = thisKey + KeyT(s) * step;
        });
        newTree.back() = endKey;
        tree.swap(newTree);
        count(tree, cnt);
        if (converged.load()) break;
    }

    int64_t nn = int64_t(tree.size()) - 1;
    if (nn + 1 > cap) return -nn;  // caller must grow
    std::memcpy(treeKeys, tree.data(), (nn + 1) * sizeof(KeyT));
    std::memcpy(counts, cnt.data(), nn * sizeof(uint32_t));
    return nn;
}

} // namespace

extern "C" {

void cst_hilbert_encode_u64(const float* x, const float* y, const float* z,
                            int64_t n, const float* box_limits, uint64_t* out)
{
    encodeHilbert<uint64_t, kMaxLevel64>(x, y, z, n, box_limits, out);
}

void cst_hilbert_encode_u32(const float* x, const float* y, const float* z,
                            int64_t n, const float* box_limits, uint32_t* out)
{
    encodeHilbert<uint32_t, kMaxLevel32>(x, y, z, n, box_limits, out);
}

int64_t cst_compute_octree_u64(const uint64_t* sorted_codes, int64_t n,
                               uint32_t bucket, uint64_t* tree_keys,
                               uint32_t* counts, int64_t cap)
{
    return computeOctree<uint64_t, kMaxLevel64>(sorted_codes, n, bucket,
                                                tree_keys, counts, cap);
}

int64_t cst_compute_octree_u32(const uint32_t* sorted_codes, int64_t n,
                               uint32_t bucket, uint32_t* tree_keys,
                               uint32_t* counts, int64_t cap)
{
    return computeOctree<uint32_t, kMaxLevel32>(sorted_codes, n, bucket,
                                                tree_keys, counts, cap);
}

} // extern "C"
