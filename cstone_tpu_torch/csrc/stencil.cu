// 27-point cell-list stencil for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cstone_tpu/ops/pallas_stencil.py:
//   B1/B2  :295 _kernel_sym, op="count" / op="density" (self excluded);
//   B3     :295 _kernel_sym with cross=True (_call_sym_cross :589): targets
//          and candidates are two disjoint particle sets on one grid;
//   B4     :149 _kernel (the one-sided stencil that counts the self pair;
//          the wrapper subtracts it).
// One kernel serves all four: target and candidate ELL tables are passed
// separately (they may have different caps), and `self_mask` turns the
// centre-cell exclusion of slot i by slot i on (B1/B2) or off (B3, B4).
//
// Inputs are (n_cells, cap) ELL planes in row-major cell order of a D^3
// grid, D = 2^level >= 4; valid slots form a prefix of each row (as
// ell_pack builds them). Target slot i counts the candidates j of the 27
// neighbour cells with d2 < r2_i, or sums m_j * W(sqrt(d2) / h_i) with the
// unnormalised cubic spline W. Periodic dims wrap and shift the candidate
// coordinate by +-L; open dims skip the ghost cells. Invalid targets
// write 0.
//
// Design: a fixed block of B threads (B = 32..256, from the target cap)
// per (cell, chunk of B target slots); each thread owns one target slot,
// so there are no atomics and the result is deterministic. Each candidate
// cell is staged through shared memory in chunks of B slots; every thread
// then reads each candidate as a broadcast. A block whose first target
// slot is empty exits at once, and the candidate loop stops after the
// first chunk that is not full, so sparse rows of a large cap cost little.
// The block size is independent of the cap: any cap launches (the earlier
// blockDim = cap design refused caps above 1024).
//
// Bound on the H100: FP32 instruction issue on the distance tests (about
// 11 flops and a dozen instructions per pair); shared-memory staging keeps
// device-memory traffic at one read of each candidate chunk per target
// chunk. Each unordered pair is tested from both ends (the TPU kernel's
// symmetric half-stencil tests it once); symmetry with atomics,
// cp.async/TMA staging and multi-cell CTAs are later work.
//
// Rounding: d2 = ((dx*dx + dy*dy) + dz*dz) with each operation rounded on
// its own (__fmul_rn/__fadd_rn, and the library is built with
// --fmad=false), the operation order of the plain PyTorch version, so
// counts agree with it bit for bit. The sum order of a density target is
// fixed (cells in stencil order, slots in row order) and independent of B.
//
// C interface: the entry point launches on the given stream and returns
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

struct Ell {
    const float* x;
    const float* y;
    const float* z;
    const float* w;  // targets: r2 (count) or h (density); candidates: mass or null
    const uint8_t* valid;
    int cap;
};

// DENSITY=false: tgt.w holds r2, out_i receives counts.
// DENSITY=true:  tgt.w holds h, out_f receives sums; cand.w (mass) may be null (m = 1).
template <bool DENSITY>
__global__ void stencil_kernel(Ell tgt, Ell cand, const float* __restrict__ lengths, int per_x,
                               int per_y, int per_z, int level, int self_mask,
                               int32_t* __restrict__ out_i, float* __restrict__ out_f) {
    extern __shared__ float smem[];
    const int B = blockDim.x;
    float* sx = smem;
    float* sy = sx + B;
    float* sz = sy + B;
    float* sm = sz + B;

    const int D = 1 << level;
    const int cell = blockIdx.x;
    const int ix = cell >> (2 * level);
    const int iy = (cell >> level) & (D - 1);
    const int iz = cell & (D - 1);
    const int t = threadIdx.x;
    const int ti = blockIdx.y * B + t;  // target slot within the row
    const bool in_row = ti < tgt.cap;
    const int64_t row = static_cast<int64_t>(cell) * tgt.cap;
    const int64_t slot = row + ti;

    // valid slots are a prefix of the row: an empty first slot means the
    // whole chunk is empty (block-uniform exit, before any barrier)
    if (!tgt.valid[row + static_cast<int64_t>(blockIdx.y) * B]) {
        if (in_row) {
            if (DENSITY) out_f[slot] = 0.0f;
            else out_i[slot] = 0;
        }
        return;
    }
    const bool tv = in_row && tgt.valid[slot] != 0;
    const float tx = tv ? tgt.x[slot] : 0.0f;
    const float ty = tv ? tgt.y[slot] : 0.0f;
    const float tz = tv ? tgt.z[slot] : 0.0f;
    const float tr = tv ? tgt.w[slot] : 1.0f;
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
                const int64_t crow = static_cast<int64_t>(ccell) * cand.cap;
                const bool skip_self = self_mask && dx == 0 && dy == 0 && dz == 0;

                for (int c0 = 0; c0 < cand.cap; c0 += B) {
                    __syncthreads();  // previous chunk's reads are done
                    const int cj = c0 + t;
                    int cv = 0;
                    if (cj < cand.cap) {
                        const int64_t cslot = crow + cj;
                        cv = cand.valid[cslot] != 0;
                        if (cv) {
                            float vx = cand.x[cslot], vy = cand.y[cslot], vz = cand.z[cslot];
                            if (ox != 0) vx = __fadd_rn(vx, static_cast<float>(ox) * lx);
                            if (oy != 0) vy = __fadd_rn(vy, static_cast<float>(oy) * ly);
                            if (oz != 0) vz = __fadd_rn(vz, static_cast<float>(oz) * lz);
                            sx[t] = vx;
                            sy[t] = vy;
                            sz[t] = vz;
                            if (DENSITY) sm[t] = cand.w != nullptr ? cand.w[cslot] : 1.0f;
                        }
                    }
                    const int n = __syncthreads_count(cv);  // valid prefix of this chunk

                    if (tv) {
                        for (int j = 0; j < n; ++j) {
                            if (skip_self && c0 + j == ti) continue;
                            const float ddx = __fsub_rn(tx, sx[j]);
                            const float ddy = __fsub_rn(ty, sy[j]);
                            const float ddz = __fsub_rn(tz, sz[j]);
                            const float d2 = __fadd_rn(
                                __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
                                __fmul_rn(ddz, ddz));
                            if (DENSITY) {
                                const float w = cubic_spline_w(__fmul_rn(__fsqrt_rn(d2), inv_h));
                                acc = __fadd_rn(acc, cand.w != nullptr ? __fmul_rn(w, sm[j]) : w);
                            } else {
                                count += d2 < tr;
                            }
                        }
                    }
                    if (n < B) break;  // the row's valid prefix ended in this chunk
                }
            }
        }
    }
    if (in_row) {
        if (DENSITY) out_f[slot] = tv ? acc : 0.0f;
        else out_i[slot] = tv ? count : 0;
    }
}

int block_size(int cap_t) {
    int b = ((cap_t + 31) / 32) * 32;
    return b < 32 ? 32 : (b > 256 ? 256 : b);
}

}  // namespace

// density = 0: counts (t_w = r2, out int32); density = 1: spline sums
// (t_w = h, c_w = candidate mass or null, out float32).
extern "C" int cstone_stencil(int density, const float* tx, const float* ty, const float* tz,
                              const float* t_w, const uint8_t* t_valid, int cap_t,
                              const float* cx, const float* cy, const float* cz,
                              const float* c_w, const uint8_t* c_valid, int cap_c,
                              const float* lengths, int per_x, int per_y, int per_z, int level,
                              int self_mask, void* out, void* stream) {
    const Ell tgt{tx, ty, tz, t_w, t_valid, cap_t};
    const Ell cand{cx, cy, cz, c_w, c_valid, cap_c};
    const int b = block_size(cap_t);
    const dim3 grid(1u << (3 * level), (cap_t + b - 1) / b);
    const size_t smem = static_cast<size_t>(b) * 4 * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (density) {
        stencil_kernel<true><<<grid, b, smem, s>>>(tgt, cand, lengths, per_x, per_y, per_z, level,
                                                   self_mask, nullptr, static_cast<float*>(out));
    } else {
        stencil_kernel<false><<<grid, b, smem, s>>>(tgt, cand, lengths, per_x, per_y, per_z, level,
                                                    self_mask, static_cast<int32_t*>(out), nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}
