// 27-point cell-list stencil for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cstone_tpu/ops/pallas_stencil.py::_kernel_sym
// (op="count" and op="density"). Inputs are (n_cells, cap) ELL planes in
// row-major cell order of a D^3 grid, D = 2^level >= 4. Target slot i of a
// cell counts the candidates j != i of the 27 neighbour cells with
// d2 < r2_i, or sums m_j * W(sqrt(d2) / h_i) with the unnormalised cubic
// spline W. Periodic dims wrap and shift the candidate coordinate by +-L;
// open dims skip the ghost cells. Self is excluded by slot identity in the
// centre cell only. Invalid targets write 0, invalid candidates add nothing.
//
// Design: one CTA per cell, one thread per target slot (blockDim = cap).
// The 27 candidate cells are staged one at a time through shared memory;
// every thread then reads each candidate as a broadcast. A thread owns its
// output slot, so there are no atomics and the result is deterministic.
// Occupied ELL slots form a prefix of each row, so the candidate loop runs
// only to the last valid slot of the staged cell.
//
// Bound on the H100: FP32 instruction throughput on the distance tests,
// ~11 flops per pair and ~8.3e8 pairs per step at 1M particles, level 5.
// Each unordered pair is tested from both ends (about 1.9x the TPU kernel's symmetric
// half-stencil); symmetry with atomics, cp.async/TMA staging and
// multi-cell CTAs are later work.
//
// Rounding: d2 = ((dx*dx + dy*dy) + dz*dz) with each operation rounded on
// its own (__fmul_rn/__fadd_rn, and the library is built with
// --fmad=false), the operation order of the plain PyTorch version, so
// counts agree with it bit for bit.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float cubic_spline_w(float q) {
    if (q < 1.0f) {
        float a = __fmul_rn(__fmul_rn(1.5f, q), q);
        float b = __fsub_rn(1.0f, __fmul_rn(0.5f, q));
        return __fsub_rn(1.0f, __fmul_rn(a, b));
    }
    if (q < 2.0f) {
        float t = __fsub_rn(2.0f, q);
        return __fmul_rn(0.25f, __fmul_rn(__fmul_rn(t, t), t));
    }
    return 0.0f;
}

// DENSITY=false: rad holds r2, out_i receives counts.
// DENSITY=true:  rad holds h, out_f receives sums; mass may be null (m = 1).
template <bool DENSITY>
__global__ void stencil_kernel(const float* __restrict__ px, const float* __restrict__ py,
                               const float* __restrict__ pz, const float* __restrict__ rad,
                               const float* __restrict__ mass, const uint8_t* __restrict__ valid,
                               const float* __restrict__ lengths, int per_x, int per_y,
                               int per_z, int level, int cap, int32_t* __restrict__ out_i,
                               float* __restrict__ out_f) {
    extern __shared__ float smem[];
    float* sx = smem;
    float* sy = sx + cap;
    float* sz = sy + cap;
    float* sm = sz + cap;
    int* sv = reinterpret_cast<int*>(sm + cap);
    __shared__ int s_n;

    const int D = 1 << level;
    const int cell = blockIdx.x;
    const int ix = cell >> (2 * level);
    const int iy = (cell >> level) & (D - 1);
    const int iz = cell & (D - 1);
    const int t = threadIdx.x;
    const int64_t slot = static_cast<int64_t>(cell) * cap + t;

    const bool tv = valid[slot] != 0;
    const float tx = px[slot];
    const float ty = py[slot];
    const float tz = pz[slot];
    const float tr = rad[slot];
    const float inv_h = DENSITY ? __fdiv_rn(1.0f, tr) : 0.0f;
    const float lx = lengths[0], ly = lengths[1], lz = lengths[2];

    int count = 0;
    float acc = 0.0f;

    for (int dx = -1; dx <= 1; ++dx) {
        const int cx = ix + dx;
        const int ox = cx < 0 ? -1 : (cx >= D ? 1 : 0);
        if (ox != 0 && !per_x) continue;  // uniform across the block
        for (int dy = -1; dy <= 1; ++dy) {
            const int cy = iy + dy;
            const int oy = cy < 0 ? -1 : (cy >= D ? 1 : 0);
            if (oy != 0 && !per_y) continue;
            for (int dz = -1; dz <= 1; ++dz) {
                const int cz = iz + dz;
                const int oz = cz < 0 ? -1 : (cz >= D ? 1 : 0);
                if (oz != 0 && !per_z) continue;
                const int ccell = ((cx - ox * D) * D + (cy - oy * D)) * D + (cz - oz * D);
                const int64_t cslot = static_cast<int64_t>(ccell) * cap + t;
                const bool centre = dx == 0 && dy == 0 && dz == 0;

                __syncthreads();  // previous cell's reads are done
                if (t == 0) s_n = 0;
                __syncthreads();
                const int cv = valid[cslot] != 0;
                float vx = px[cslot], vy = py[cslot], vz = pz[cslot];
                if (ox != 0) vx = __fadd_rn(vx, static_cast<float>(ox) * lx);
                if (oy != 0) vy = __fadd_rn(vy, static_cast<float>(oy) * ly);
                if (oz != 0) vz = __fadd_rn(vz, static_cast<float>(oz) * lz);
                sx[t] = vx;
                sy[t] = vy;
                sz[t] = vz;
                if (DENSITY) sm[t] = mass != nullptr ? mass[cslot] : 1.0f;
                sv[t] = cv;
                if (cv) atomicMax(&s_n, t + 1);
                __syncthreads();

                if (!tv) continue;
                const int n = s_n;
                for (int j = 0; j < n; ++j) {
                    if (!sv[j] || (centre && j == t)) continue;
                    const float ddx = __fsub_rn(tx, sx[j]);
                    const float ddy = __fsub_rn(ty, sy[j]);
                    const float ddz = __fsub_rn(tz, sz[j]);
                    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
                                               __fmul_rn(ddz, ddz));
                    if (DENSITY) {
                        const float w = cubic_spline_w(__fmul_rn(__fsqrt_rn(d2), inv_h));
                        acc = __fadd_rn(acc, mass != nullptr ? __fmul_rn(w, sm[j]) : w);
                    } else {
                        count += d2 < tr;
                    }
                }
            }
        }
    }
    if (DENSITY) {
        out_f[slot] = tv ? acc : 0.0f;
    } else {
        out_i[slot] = tv ? count : 0;
    }
}

size_t smem_bytes(int cap) { return static_cast<size_t>(cap) * (4 * sizeof(float) + sizeof(int)); }

}  // namespace

extern "C" int cstone_stencil_counts(const float* px, const float* py, const float* pz,
                                     const float* r2, const uint8_t* valid, const float* lengths,
                                     int per_x, int per_y, int per_z, int level, int n_cells,
                                     int cap, int32_t* out, void* stream) {
    stencil_kernel<false><<<n_cells, cap, smem_bytes(cap), static_cast<cudaStream_t>(stream)>>>(
        px, py, pz, r2, nullptr, valid, lengths, per_x, per_y, per_z, level, cap, out, nullptr);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int cstone_stencil_density(const float* px, const float* py, const float* pz,
                                      const float* h, const float* mass, const uint8_t* valid,
                                      const float* lengths, int per_x, int per_y, int per_z,
                                      int level, int n_cells, int cap, float* out,
                                      void* stream) {
    stencil_kernel<true><<<n_cells, cap, smem_bytes(cap), static_cast<cudaStream_t>(stream)>>>(
        px, py, pz, h, mass, valid, lengths, per_x, per_y, per_z, level, cap, nullptr, out);
    return static_cast<int>(cudaGetLastError());
}
