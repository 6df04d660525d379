// Run-streaming pairwise neighbour counts for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cstone_tpu/ops/pallas_neighbors_v2.py:103
// _kernel (_call :251-283, wrapper pairwise_count_runs :206), the default
// counts path of find_neighbors.
//
// Per group of G SFC-consecutive targets, the group's candidate particles
// are a few contiguous runs of the SFC-sorted coordinate arrays
// (merge_leaf_runs). Target t of group g (global index g*G + t) counts the
// candidates c of the group's runs with c != g*G + t and d2 < r2_t, where
// each displacement takes the minimum image exactly as the TPU kernel
// does: k = floor(d * (1/L) + 0.5), d -= (p * L) * k, with p = 1 on
// periodic dims and 0 on open ones. Targets with r2 < 0 count 0.
//
// Design: one CTA per group, one thread per target (blockDim = G <= 1024).
// The block walks the group's runs with run_len > 0; each run is staged in
// tiles of G elements of x/y/z through shared memory and every thread
// reads each candidate as a broadcast. A thread owns its output: no
// atomics, deterministic. The TPU kernel's 1024-element window alignment,
// clamped-window mask and group_block padding are HBM-slice workarounds
// and are not needed here.
//
// Bound on the H100: FP32 issue on the pair tests (about 20 instructions
// per pair with the three image roundings); each candidate tile is read
// once per group from device memory (L2-resident for neighbouring groups).
//
// Rounding: each operation is rounded on its own (__f*_rn, --fmad=false),
// in the operation order of the plain PyTorch version, so counts agree
// with it bit for bit.
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float min_image(float d, float il, float pl) {
    const float k = floorf(__fadd_rn(__fmul_rn(d, il), 0.5f));
    return __fsub_rn(d, __fmul_rn(pl, k));
}

// box: Lx Ly Lz iLx iLy iLz px py pz (the JAX kernel's box_params)
__global__ void count_runs_kernel(const float* __restrict__ targets, const float* __restrict__ r2,
                                  const int32_t* __restrict__ run_start,
                                  const int32_t* __restrict__ run_len, int R,
                                  const float* __restrict__ xs, const float* __restrict__ ys,
                                  const float* __restrict__ zs, const float* __restrict__ box,
                                  int32_t* __restrict__ out) {
    extern __shared__ float smem[];
    const int G = blockDim.x;
    float* sx = smem;
    float* sy = sx + G;
    float* sz = sy + G;

    const int64_t g = blockIdx.x;
    const int t = threadIdx.x;
    const int64_t tidx = g * G + t;
    const float tx = targets[3 * tidx + 0];
    const float ty = targets[3 * tidx + 1];
    const float tz = targets[3 * tidx + 2];
    const float tr2 = r2[tidx];
    const float ilx = box[3], ily = box[4], ilz = box[5];
    const float plx = __fmul_rn(box[6], box[0]);
    const float ply = __fmul_rn(box[7], box[1]);
    const float plz = __fmul_rn(box[8], box[2]);

    int count = 0;
    for (int r = 0; r < R; ++r) {
        const int64_t start = run_start[g * R + r];
        const int len = run_len[g * R + r];  // uniform across the block
        for (int base = 0; base < len; base += G) {
            __syncthreads();  // previous tile's reads are done
            if (base + t < len) {
                sx[t] = xs[start + base + t];
                sy[t] = ys[start + base + t];
                sz[t] = zs[start + base + t];
            }
            __syncthreads();
            const int m = min(G, len - base);
            for (int j = 0; j < m; ++j) {
                const float dx = min_image(__fsub_rn(tx, sx[j]), ilx, plx);
                const float dy = min_image(__fsub_rn(ty, sy[j]), ily, ply);
                const float dz = min_image(__fsub_rn(tz, sz[j]), ilz, plz);
                const float d2 =
                    __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
                count += (d2 < tr2) && (start + base + j != tidx);
            }
        }
    }
    out[tidx] = count;
}

}  // namespace

extern "C" int cstone_count_runs(const float* targets, const float* r2, const int32_t* run_start,
                                 const int32_t* run_len, int n_groups, int group_size, int R,
                                 const float* xs, const float* ys, const float* zs,
                                 const float* box, int32_t* out, void* stream) {
    const size_t smem = static_cast<size_t>(group_size) * 3 * sizeof(float);
    count_runs_kernel<<<n_groups, group_size, smem, static_cast<cudaStream_t>(stream)>>>(
        targets, r2, run_start, run_len, R, xs, ys, zs, box, out);
    return static_cast<int>(cudaGetLastError());
}
