// The Hilbert key codec of sfc/encode.py for NVIDIA Hopper (sm_90a):
// float coordinates -> keys, integer grid coordinates -> keys, keys ->
// integer grid coordinates, one thread an element and every round in
// registers, one launch a call.
//
// Replaces no TPU kernel. The JAX package encodes with plain JAX, and the
// port's plain codec (sfc/hilbert.py, the version CPU tensors take) loops
// over the 21 levels in Python with about 43 int64 torch operations a
// level over the whole array: 941 passes for one compute_sfc_keys of 2M
// particles, 11.6 ms of device time where the work needs microseconds.
//
// What bounds it (H100 SXM, 700 W; the main path's 2M float32 particles,
// uint64 keys): the float encode reads 3 x 4 bytes and writes one 8-byte
// key, 20 bytes a particle, 40 MB, 12 us at 3.35 TB/s; the decode reads 8
// and writes 3 x 8, 64 MB, 19 us. A round is 39 32-bit integer operations
// as written (three bit extracts, the octant and its Hilbert digit, the
// key's shift-add, the three reflection masks and xors, the rotate-or-swap
// selects), 21 rounds about 820 a particle, 1.6e9 for 2M; the compiler
// folds most three-input logic into one LOP3, and the card issues 64
// integer lanes an SM (132 SMs, 1.98 GHz), so the rounds' issue, not the
// bytes, sets the pace: about 0.08 ms for the 2M encode in the profiler,
// against the plain codec's 11.6 ms of int64 passes. A 12-state lookup
// table would take fewer operations a round; at 0.1 ms of a step of tens
// of ms it is not worth a second formulation to hold bit-equal.
//
// Design:
// - Grid-stride over the elements, BLOCK threads a block; loads and stores
//   are coalesced, neighbouring threads on neighbouring elements.
// - Coordinates run in 32-bit registers: they fit in 21 bits. The
//   reflections (x ^= -mask) flip bits above the key width too, as the
//   plain codec's int64 ones do; a round reads only bit `level` < lmax,
//   so those bits never reach the key, and truncating int64 inputs to
//   their low 32 bits gives the same key (lmax <= 31).
// - The float encode reproduces encode._grid_coords bit for bit: i =
//   (floor(c * m) - min * m) in the coordinates' type, each operation
//   rounded on its own (--fmad=false, and floor stands between the product
//   and the difference), truncated to int32 by the same saturating
//   conversion torch's cast compiles to, then min(i, cube - 1). The six
//   values m and min * m come from the card, computed by the same torch
//   operations as the plain path, so nothing is read back to the host.
// - Keys are templated on width: uint32 keys with lmax 10, uint64 keys
//   with lmax 21, written into the int32 / int64 storage of ops/keys64.py.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for arguments
// it does not take. It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ float floor_of(float v) { return floorf(v); }
__device__ __forceinline__ double floor_of(double v) { return floor(v); }

// The first `levels` rounds of the depth-lmax encode (hilbert.hpp:58-109;
// sfc/hilbert._hilbert_rounds): the top 3 * levels bits of the key.
template <typename Key>
__device__ __forceinline__ Key encode_rounds(uint32_t px, uint32_t py, uint32_t pz, int lmax, int levels) {
    Key key = 0;
    for (int level = lmax - 1; level >= lmax - levels; --level) {
        const uint32_t xi = (px >> level) & 1u;
        const uint32_t yi = (py >> level) & 1u;
        const uint32_t zi = (pz >> level) & 1u;
        const uint32_t octant = (xi << 2) | (yi << 1) | zi;
        key = (key << 3) + static_cast<Key>((octant ^ (octant >> 1)) ^ (octant >> 2));

        const uint32_t not_yi = yi ^ 1u, not_zi = zi ^ 1u;
        const uint32_t mx = xi & (not_yi | zi);
        const uint32_t my = (xi & (yi | zi)) | (yi & not_zi);
        const uint32_t mz = (xi & not_yi & not_zi) | (yi & not_zi);
        px ^= 0u - mx;
        py ^= 0u - my;
        pz ^= 0u - mz;

        // if zi: cyclic rotation (px, py, pz) <- (py, pz, px); elif !yi: swap px, pz
        if (zi) {
            const uint32_t t = px;
            px = py;
            py = pz;
            pz = t;
        } else if (!yi) {
            const uint32_t t = px;
            px = pz;
            pz = t;
        }
    }
    return key;
}

// Inverse of the full encode (hilbert.hpp:145-188; sfc/hilbert.decode_hilbert).
template <typename Key>
__device__ __forceinline__ void decode_rounds(Key key, int lmax, uint32_t& ox, uint32_t& oy, uint32_t& oz) {
    uint32_t px = 0, py = 0, pz = 0;
    for (int level = 0; level < lmax; ++level) {
        const uint32_t octant = static_cast<uint32_t>(key >> (3 * level)) & 7u;
        const uint32_t xi = octant >> 2;
        const uint32_t yi = (octant >> 1) & 1u;
        const uint32_t zi = octant & 1u;

        // if yi ^ zi: cyclic rotation (px, py, pz) <- (pz, px, py);
        // elif the octant is 0 or 7: swap px and pz
        if (yi ^ zi) {
            const uint32_t t = px;
            px = pz;
            pz = py;
            py = t;
        } else if (octant == 0u || octant == 7u) {
            const uint32_t t = px;
            px = pz;
            pz = t;
        }

        const uint32_t not_xi = xi ^ 1u, not_yi = yi ^ 1u, not_zi = zi ^ 1u;
        const uint32_t mask = (1u << level) - 1u;
        const uint32_t mx = xi & (yi | zi);
        const uint32_t my = (xi & (not_yi | not_zi)) | (not_xi & yi & zi);
        const uint32_t mz = (xi & not_yi & not_zi) | (yi & zi);
        px ^= mask & (0u - mx);
        py ^= mask & (0u - my);
        pz ^= mask & (0u - mz);

        px |= xi << level;
        py |= (xi ^ yi) << level;
        pz |= (yi ^ zi) << level;
    }
    ox = px;
    oy = py;
    oz = pz;
}

// encode._grid_coords for one coordinate: (floor(c * m) - min * m) in F,
// truncated to int32 (saturating, as torch's cast), clamped to cube - 1
template <typename F, int LMAX>
__device__ __forceinline__ uint32_t grid_coord(F c, F m, F min_m) {
    const int i = static_cast<int>(floor_of(c * m) - min_m);
    return static_cast<uint32_t>(min(i, (1 << LMAX) - 1));
}

template <typename F, typename Key, int LMAX>
__global__ void __launch_bounds__(BLOCK) encode_coords_kernel(const F* __restrict__ x, const F* __restrict__ y,
                                                              const F* __restrict__ z, const F* __restrict__ scale,
                                                              int64_t n, Key* __restrict__ keys) {
    const F mx = scale[0], my = scale[1], mz = scale[2];
    const F min_mx = scale[3], min_my = scale[4], min_mz = scale[5];
    for (int64_t i = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        const uint32_t px = grid_coord<F, LMAX>(x[i], mx, min_mx);
        const uint32_t py = grid_coord<F, LMAX>(y[i], my, min_my);
        const uint32_t pz = grid_coord<F, LMAX>(z[i], mz, min_mz);
        keys[i] = encode_rounds<Key>(px, py, pz, LMAX, LMAX);
    }
}

template <typename Coord, typename Key>
__global__ void __launch_bounds__(BLOCK) encode_grid_kernel(const Coord* __restrict__ px, const Coord* __restrict__ py,
                                                            const Coord* __restrict__ pz, int64_t n, int lmax,
                                                            int levels, Key* __restrict__ keys) {
    for (int64_t i = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        keys[i] = encode_rounds<Key>(static_cast<uint32_t>(px[i]), static_cast<uint32_t>(py[i]),
                                     static_cast<uint32_t>(pz[i]), lmax, levels);
    }
}

template <typename Key, int LMAX>
__global__ void __launch_bounds__(BLOCK) decode_kernel(const Key* __restrict__ keys, int64_t n,
                                                       int64_t* __restrict__ px, int64_t* __restrict__ py,
                                                       int64_t* __restrict__ pz) {
    for (int64_t i = blockIdx.x * static_cast<int64_t>(BLOCK) + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        uint32_t x, y, z;
        decode_rounds<Key>(keys[i], LMAX, x, y, z);
        px[i] = x;
        py[i] = y;
        pz[i] = z;
    }
}

int blocks_for(int64_t n) {
    const int64_t b = (n + BLOCK - 1) / BLOCK;
    return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename F>
void launch_encode_coords(const void* x, const void* y, const void* z, const void* scale, int64_t n, int key64,
                          void* keys, cudaStream_t s) {
    const auto fx = static_cast<const F*>(x), fy = static_cast<const F*>(y), fz = static_cast<const F*>(z);
    const auto sc = static_cast<const F*>(scale);
    if (key64) {
        encode_coords_kernel<F, uint64_t, 21>
            <<<blocks_for(n), BLOCK, 0, s>>>(fx, fy, fz, sc, n, static_cast<uint64_t*>(keys));
    } else {
        encode_coords_kernel<F, uint32_t, 10>
            <<<blocks_for(n), BLOCK, 0, s>>>(fx, fy, fz, sc, n, static_cast<uint32_t*>(keys));
    }
}

template <typename Coord>
void launch_encode_grid(const void* px, const void* py, const void* pz, int64_t n, int lmax, int levels, int key64,
                        void* keys, cudaStream_t s) {
    const auto cx = static_cast<const Coord*>(px), cy = static_cast<const Coord*>(py);
    const auto cz = static_cast<const Coord*>(pz);
    if (key64) {
        encode_grid_kernel<Coord, uint64_t>
            <<<blocks_for(n), BLOCK, 0, s>>>(cx, cy, cz, n, lmax, levels, static_cast<uint64_t*>(keys));
    } else {
        encode_grid_kernel<Coord, uint32_t>
            <<<blocks_for(n), BLOCK, 0, s>>>(cx, cy, cz, n, lmax, levels, static_cast<uint32_t*>(keys));
    }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// float32 (float64 = 0) or float64 coordinates -> uint32 (key64 = 0, lmax
// 10) or uint64 keys (lmax 21). scale: the six values m[0..2], (min *
// m)[0..2] in the coordinates' type, on the card.
extern "C" int cstone_sfc_encode_coords(const void* x, const void* y, const void* z, const void* scale, int64_t n,
                                        int float64, int key64, void* keys, void* stream) {
    if (n < 0) return invalid();
    if (n > 0) {
        const auto s = static_cast<cudaStream_t>(stream);
        if (float64) {
            launch_encode_coords<double>(x, y, z, scale, n, key64, keys, s);
        } else {
            launch_encode_coords<float>(x, y, z, scale, n, key64, keys, s);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// int32 (coord64 = 0) or int64 grid coordinates -> the top 3 * levels
// bits of their depth-lmax key, as uint32 (key64 = 0) or uint64
extern "C" int cstone_sfc_encode_grid(const void* px, const void* py, const void* pz, int64_t n, int coord64,
                                      int lmax, int levels, int key64, void* keys, void* stream) {
    if (n < 0 || lmax > 31 || levels < 0 || levels > lmax || 3 * levels > (key64 ? 64 : 32)) return invalid();
    if (n > 0) {
        const auto s = static_cast<cudaStream_t>(stream);
        if (coord64) {
            launch_encode_grid<int64_t>(px, py, pz, n, lmax, levels, key64, keys, s);
        } else {
            launch_encode_grid<int32_t>(px, py, pz, n, lmax, levels, key64, keys, s);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// uint32 (key64 = 0, lmax 10) or uint64 keys (lmax 21) -> int64 grid coordinates
extern "C" int cstone_sfc_decode(const void* keys, int64_t n, int key64, int64_t* px, int64_t* py, int64_t* pz,
                                 void* stream) {
    if (n < 0) return invalid();
    if (n > 0) {
        const auto s = static_cast<cudaStream_t>(stream);
        if (key64) {
            decode_kernel<uint64_t, 21><<<blocks_for(n), BLOCK, 0, s>>>(static_cast<const uint64_t*>(keys), n, px, py, pz);
        } else {
            decode_kernel<uint32_t, 10><<<blocks_for(n), BLOCK, 0, s>>>(static_cast<const uint32_t*>(keys), n, px, py, pz);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
