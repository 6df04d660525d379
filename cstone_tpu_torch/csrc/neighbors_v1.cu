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
// Bound on the H100 (SXM, 700 W) at chip_smoke.py phase 6's shape (1M
// uniform particles, 3,907 groups of 256, C = 4096, about 2,620 valid
// candidates a group): 2.6e9 live pairs x (d2, 8 operations, and a
// compare) = 2.4e13 FP32 operations, 0.352 ms at 67 TFLOP/s, against 0.33
// GB of reads (0.10 ms at 3.35 TB/s), so FP32 issue bounds it. The 67
// TFLOP/s peak counts an FMA as two flops; bit parity forbids FMA
// (--fmad=false), so a test issues at least its 9 operations one an
// instruction: twice the bound, about 0.70 ms, is the reachable floor.
//
// What held the first draft back: one thread per target, so each
// staged candidate read served one test; four scalar shared loads (x, y,
// z, index) and a data-dependent branch per test; every slot tested,
// though only about 2,620 of 4,096 are valid (the slots past a group's
// candidates are -1); two block barriers around a synchronous load per
// tile of G candidates.
//
// Design:
// - Register blocking: each thread holds TPT = 4 targets of the group
//   (t, t + B, t + 2B, t + 3B for a block of B threads, B a multiple of 32
//   from ceil(G / 4)), so one broadcast 16-byte shared load of a
//   candidate serves four tests. Any G from 1 to 1024 launches; lanes past
//   G hold r2 = -1 and write nothing.
// - Staging: tiles of T = 256 candidates packed into shared memory as
//   float4 (x, y, z, index bits), double-buffered with cp.async (4 bytes a
//   word: a group's candidate rows are 12-byte records, so a 16-byte copy
//   cannot land them as float4): the next tile is in flight while the
//   current one is tested. The last tile is masked at C.
// - Empty slots: once its copies are in, each thread looks at its own
//   staged slots; a slot with a negative index gets x = +inf, so every test of it
//   yields d2 = +inf and fails, exactly as skipping it would, and the
//   tile's length is cut to one past its last valid slot (a shared
//   atomicMax). A tile with no valid slot costs no tests. This is exact
//   for any input: valid slots need not form a prefix, and a hole of -1
//   slots inside a tile only costs its tests.
// - The self test stays an integer compare of the staged index with the
//   target's global index. Each thread owns its four counts: no atomics,
//   deterministic.
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

constexpr int TPT = 4;    // targets per thread
constexpr int TILE = 256;  // candidates per staged tile

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

// cnt += (d2 < r2) && (ci != self) as two compares and a predicated add
// (setp.lt is false on NaN, as the C++ compare is); compiled from C++ the
// increment becomes a select between cnt and cnt + 1, two instructions.
__device__ __forceinline__ void count_if_near_other(int& cnt, float d2, float r2, int ci, int self) {
    asm("{\n\t.reg .pred s, p;\n\tsetp.ne.s32 s, %3, %4;\n\tsetp.lt.and.f32 p, %1, %2, s;"
        "\n\t@p add.s32 %0, %0, 1;\n\t}"
        : "+r"(cnt)
        : "f"(d2), "f"(r2), "r"(ci), "r"(self));
}

__global__ void pairwise_count_kernel(const float* __restrict__ targets,
                                      const float* __restrict__ r2,
                                      const float* __restrict__ cand,
                                      const int32_t* __restrict__ cidx, int G, int C,
                                      int32_t* __restrict__ out) {
    __shared__ float4 tile[2][TILE];
    __shared__ int tile_len[2];
    const int B = blockDim.x;
    const int j = threadIdx.x;
    const int64_t g = blockIdx.x;

    float tx[TPT], ty[TPT], tz[TPT], tr[TPT];
    int tidx[TPT], cnt[TPT];
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
        const int t = j + q * B;
        tidx[q] = static_cast<int>(g * G + t);
        cnt[q] = 0;
        if (t < G) {
            const int64_t i = g * G + t;
            tx[q] = targets[3 * i + 0];
            ty[q] = targets[3 * i + 1];
            tz[q] = targets[3 * i + 2];
            tr[q] = r2[i];
        } else {
            tx[q] = ty[q] = tz[q] = 0.0f;
            tr[q] = -1.0f;
        }
    }

    const float* crow = cand + g * C * 3;
    const int32_t* irow = cidx + g * C;
    const int n_tiles = (C + TILE - 1) / TILE;
    // each thread copies slots j, j + B, ... of a tile, 4 words each
    auto stage = [&](int tix, int buf) {
        const int base = tix * TILE;
        for (int k = j; k < TILE && base + k < C; k += B) {
            float* d = reinterpret_cast<float*>(&tile[buf][k]);
            const int64_t c = base + k;
            cp_async4(d + 0, crow + 3 * c + 0);
            cp_async4(d + 1, crow + 3 * c + 1);
            cp_async4(d + 2, crow + 3 * c + 2);
            cp_async4(d + 3, irow + c);
        }
    };

    if (j == 0) tile_len[0] = tile_len[1] = 0;
    __syncthreads();
    if (n_tiles > 0) stage(0, 0);
    cp_async_commit();
    for (int tix = 0; tix < n_tiles; ++tix) {
        const int buf = tix & 1;
        if (tix + 1 < n_tiles) stage(tix + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait_one();  // this thread's copies of the current tile are in

        // poison this thread's empty slots and find the tile's last valid slot
        const int base = tix * TILE;
        int last = 0;
        for (int k = j; k < TILE && base + k < C; k += B) {
            if (__float_as_int(tile[buf][k].w) < 0) tile[buf][k].x = __int_as_float(0x7f800000);
            else last = k + 1;
        }
        if (last) atomicMax(&tile_len[buf], last);
        __syncthreads();  // every thread's copies, fixes and length are visible

        const int m = tile_len[buf];
#pragma unroll 4
        for (int k = 0; k < m; ++k) {
            const float4 c = tile[buf][k];
            const int ci = __float_as_int(c.w);
#pragma unroll
            for (int q = 0; q < TPT; ++q) {
                const float dx = __fsub_rn(tx[q], c.x);
                const float dy = __fsub_rn(ty[q], c.y);
                const float dz = __fsub_rn(tz[q], c.z);
                const float d2 =
                    __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
                count_if_near_other(cnt[q], d2, tr[q], ci, tidx[q]);
            }
        }
        __syncthreads();  // the tile is read before the next stage overwrites it
        if (j == 0) tile_len[buf] = 0;  // its next atomicMax comes after the next barrier
    }
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
        if (j + q * B < G) out[g * G + j + q * B] = cnt[q];
    }
}

}  // namespace

extern "C" int cstone_pairwise_count(const float* targets, const float* r2, const float* cand,
                                     const int32_t* cidx, int n_groups, int group_size, int C,
                                     int32_t* out, void* stream) {
    if (group_size < 1 || group_size > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const int per = (group_size + TPT - 1) / TPT;
    const int block = ((per + 31) / 32) * 32;
    if (n_groups > 0) {
        pairwise_count_kernel<<<n_groups, block, 0, static_cast<cudaStream_t>(stream)>>>(
            targets, r2, cand, cidx, group_size, C, out);
    }
    return static_cast<int>(cudaGetLastError());
}
