// Dense pairwise neighbour counts over pre-gathered candidates for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cstone_tpu/ops/pallas_neighbors.py:31
// _kernel (_pairwise_count_call :88-116, wrapper pairwise_count :62), the
// use_pallas="v1" route of find_neighbors.
//
// Target t of group g (global index g*G + t) counts the group's C
// candidates c with cidx_c != -1, cidx_c != g*G + t and d2 < r2_t. The
// candidates arrive already wrapped to the periodic image nearest the
// group centre (the wrapper does it, as _pairwise_pallas does), so there
// is no per-pair image arithmetic. Targets with r2 < 0 count 0.
//
// Design: one CTA per group, one thread per target (blockDim = G <= 1024);
// the C candidates and their indices are staged in shared-memory tiles of
// G and read as broadcasts. No atomics, deterministic.
//
// Bound on the H100: device-memory reads of the pre-gathered (n_groups, C,
// 3) candidate array (16 bytes per candidate with its index) are amortised
// over G targets, so FP32 issue on the pair tests bounds it, about 10
// instructions per pair.
//
// Rounding: d2 = ((dx*dx + dy*dy) + dz*dz), each operation rounded on its
// own (--fmad=false), the order of the plain PyTorch version: counts agree
// with it bit for bit.
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pairwise_count_kernel(const float* __restrict__ targets,
                                      const float* __restrict__ r2,
                                      const float* __restrict__ cand,
                                      const int32_t* __restrict__ cidx, int C,
                                      int32_t* __restrict__ out) {
    extern __shared__ float smem[];
    const int G = blockDim.x;
    float* sx = smem;
    float* sy = sx + G;
    float* sz = sy + G;
    int* si = reinterpret_cast<int*>(sz + G);

    const int64_t g = blockIdx.x;
    const int t = threadIdx.x;
    const int64_t tidx = g * G + t;
    const float tx = targets[3 * tidx + 0];
    const float ty = targets[3 * tidx + 1];
    const float tz = targets[3 * tidx + 2];
    const float tr2 = r2[tidx];
    const int64_t crow = g * C;

    int count = 0;
    for (int base = 0; base < C; base += G) {
        __syncthreads();  // previous tile's reads are done
        if (base + t < C) {
            const int64_t c = crow + base + t;
            sx[t] = cand[3 * c + 0];
            sy[t] = cand[3 * c + 1];
            sz[t] = cand[3 * c + 2];
            si[t] = cidx[c];
        }
        __syncthreads();
        const int m = min(G, C - base);
        for (int j = 0; j < m; ++j) {
            const int ci = si[j];
            if (ci < 0 || ci == tidx) continue;
            const float dx = __fsub_rn(tx, sx[j]);
            const float dy = __fsub_rn(ty, sy[j]);
            const float dz = __fsub_rn(tz, sz[j]);
            const float d2 =
                __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
            count += d2 < tr2;
        }
    }
    out[tidx] = count;
}

}  // namespace

extern "C" int cstone_pairwise_count(const float* targets, const float* r2, const float* cand,
                                     const int32_t* cidx, int n_groups, int group_size, int C,
                                     int32_t* out, void* stream) {
    const size_t smem = static_cast<size_t>(group_size) * (3 * sizeof(float) + sizeof(int));
    pairwise_count_kernel<<<n_groups, group_size, smem, static_cast<cudaStream_t>(stream)>>>(
        targets, r2, cand, cidx, C, out);
    return static_cast<int>(cudaGetLastError());
}
