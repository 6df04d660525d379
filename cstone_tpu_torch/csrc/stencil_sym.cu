// Symmetric half-stencil cell-list kernel for NVIDIA Hopper (sm_90a):
// neighbour counts (B1) and SPH density sums (B2) in one source.
//
// Replaces the Pallas TPU kernel cstone_tpu/ops/pallas_stencil.py:295
// _kernel_sym, op="count" and op="density" (self excluded). The one-sided
// kernel of csrc/stencil.cu keeps serving B3 (cross) and B4 (one-sided).
//
// Contract (that of stencil.cu with self_mask on): inputs are (n_cells,
// cap) ELL planes in row-major cell order of a D^3 grid, D = 2^level >= 4;
// valid slots form a prefix of each row. Slot i counts the slots j != i of
// the 27 neighbour cells with d2 < r2_i, or sums m_j W(sqrt(d2) / h_i)
// with the unnormalised cubic spline W. Periodic dims wrap with a +-L
// shift; open dims skip the ghost cells. Invalid slots get 0.
//
// Design:
// - Half stencil. Each unordered pair is tested once. A target cell T is
//   paired with itself (slot pairs j > i only) and with its 13 "forward"
//   neighbours (direction (dx, dy, dz) > (0, 0, 0) lexicographically);
//   the other 13 neighbours see T as their forward neighbour. With D >= 4
//   every unordered cell pair appears exactly once, wrap included.
// - One d2 per pair, ((dx*dx + dy*dy) + dz*dz) with every operation rounded
//   on its own (__f*_rn, --fmad=false), the plain version's order. Off the
//   wrap, x_j - x_i = -(x_i - x_j) exactly, so both ends share it. For a
//   forward cell reached across a periodic wrap (a warp-uniform branch) the
//   candidate end recomputes its d2 from its own end with the opposite
//   shift, x_j - (x_i - o L), as the one-sided plain version does. Counts
//   are therefore bit-equal to stencil_counts_plain, and every density term
//   has the plain version's arguments; only the sum order differs.
// - Work unit: one warp per (target cell, chunk of 32 target slots), one
//   lane per target slot, 4 warps per CTA, each with its own staging
//   buffers. Grid order puts every cell's first chunk before any second
//   chunk, so the warps of mostly empty second chunks retire together.
//   Any cap launches: a warp walks as many candidate chunks as the rows
//   hold, and a warp whose chunk is past its row's valid prefix exits at
//   once. Row lengths come from a prologue kernel (one warp per row).
// - Staging: each chunk of 32 candidates is packed into shared memory as
//   float4 (x, y, z, r2 | h) plus a mass plane, so one broadcast 16-byte
//   load serves a pair. The copy is cp.async, 4 bytes per lane and plane
//   (a 16-byte cp.async copies 4 slots of one plane and cannot interleave
//   the planes), double-buffered: the next chunk of the walk is in flight
//   while the current one is tested. Density then turns h into 1/h in
//   place, one division per staged slot instead of one per pair.
// - Candidate-end sums: lane k owns candidate k of the chunk. Counts take
//   a warp __ballot_sync + __popc per candidate; density a butterfly
//   __shfl_xor_sync sum, skipped when no lane has a term (__any_sync). Each
//   lane flushes its candidate with one global atomicAdd per (target
//   chunk, candidate chunk), and each target with one atomicAdd at the
//   end, into an output the wrapper zeroed. Integer counts are therefore
//   deterministic; float sums change order from run to run.
// - Density skips the sqrt and spline of pairs with d2 / h^2 >= 4.0004
//   (q >= 2 with margin): W is exactly 0 there, so the sums are unchanged.
//
// Bound on the H100 (SXM, 700 W) at the phase-4 shape of chip_smoke
// (1M uniform particles, level 5, cap 64, about 30.5 per cell): 4.12e8
// unordered pairs; counts need d2 (8 operations) and a compare at each
// end, 10 a pair (4.1e9, 0.062 ms at 67 TFLOP/s FP32), against about
// 27 MB (valid and result per slot, planes at valid slots: 0.008 ms at
// 3.35 TB/s), so the bound is FP32 issue. Density adds the spline only
// at the 5.8e7 ends with q < 2 (about 9 operations each): 0.070 ms. The
// 67 TFLOP/s peak counts an FMA as two flops; bit parity forbids FMA
// (--fmad=false), so one instruction does one flop and half that rate is
// the reachable ceiling. The one-sided kernel tests each pair twice. This
// one tests it once, feeds each test from one broadcast load, and overlaps
// staging with the tests; what remains is the issue slots around the 8
// flops of a test (shared load, two compares, the candidate-end ballot or
// shuffle sum, the loop) and the idle lanes of warps whose chunk holds
// few of a row's slots (rows of 33-64 slots take two warps).
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;   // warps per CTA, one work unit each
constexpr int NDIR = 14;   // the centre cell and 13 forward neighbours
constexpr float QCUT2 = 4.0004f;

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

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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

struct Table {
    const float* x;
    const float* y;
    const float* z;
    const float* w;  // r2 (counts) or h (density)
    const float* m;  // mass (density) or null (m = 1)
    int cap;
};

struct Stage {
    float4 c[2][32];
    float m[2][32];
};

// Length of each row's valid prefix: one warp per row.
__global__ void row_counts_kernel(const uint8_t* __restrict__ valid, int cap, int n_cells,
                                  int32_t* __restrict__ counts) {
    const int lane = threadIdx.x & 31;
    const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= n_cells) return;
    const uint8_t* v = valid + row * cap;
    int n = 0;
    for (int c0 = 0; c0 < cap; c0 += 32) {
        const unsigned bal = __ballot_sync(FULL, c0 + lane < cap && v[c0 + lane] != 0);
        if (bal != FULL) {
            n += __ffs(~bal) - 1;
            break;
        }
        n += 32;
    }
    if (lane == 0) counts[row] = n;
}

template <bool DENSITY>
__device__ __forceinline__ void stage_chunk(const Table& t, int64_t row, int n, Stage& s, int buf,
                                            int lane) {
    if (lane < n) {
        const int64_t g = row + lane;
        float* d = reinterpret_cast<float*>(&s.c[buf][lane]);
        cp_async4(d + 0, t.x + g);
        cp_async4(d + 1, t.y + g);
        cp_async4(d + 2, t.z + g);
        cp_async4(d + 3, t.w + g);
        if (DENSITY) {
            if (t.m != nullptr) cp_async4(&s.m[buf][lane], t.m + g);
            else s.m[buf][lane] = 1.0f;
        }
    }
}

// The tests of one staged chunk of n candidates against the warp's targets.
// WRAP: the chunk's cell was reached across a periodic wrap; (sx, sy, sz)
// is the shift o L added to the candidate at the target end, and
// (txs, tys, tzs) = target - o L is the target seen from the candidate end.
// kmin: candidate k pairs with lane only when k > kmin (the centre cell's
// own chunk: slot j > slot i).
template <bool DENSITY, bool WRAP>
__device__ __forceinline__ void test_chunk(const float4* __restrict__ c4, const float* __restrict__ cm,
                                           int n, int kmin, bool tv, float tx, float ty, float tz,
                                           float tw, float tm, float sx, float sy, float sz,
                                           float txs, float tys, float tzs, int lane, int& cnt,
                                           float& acc, int& ccnt, float& cacc) {
#pragma unroll 4  // overlaps the independent tests of consecutive candidates
    for (int k = 0; k < n; ++k) {
        const float4 c = c4[k];
        float d2i, d2j;
        if (WRAP) {
            d2i = dist2(__fsub_rn(tx, __fadd_rn(c.x, sx)), __fsub_rn(ty, __fadd_rn(c.y, sy)),
                        __fsub_rn(tz, __fadd_rn(c.z, sz)));
            d2j = dist2(__fsub_rn(c.x, txs), __fsub_rn(c.y, tys), __fsub_rn(c.z, tzs));
        } else {
            d2i = dist2(__fsub_rn(tx, c.x), __fsub_rn(ty, c.y), __fsub_rn(tz, c.z));
            d2j = d2i;
        }
        const bool live = tv && k > kmin;
        if (DENSITY) {
            // tw = 1/h_i, c.w = 1/h_j
            if (live && __fmul_rn(__fmul_rn(d2i, tw), tw) < QCUT2) {
                const float w = cubic_spline_w(__fmul_rn(__fsqrt_rn(d2i), tw));
                acc = __fadd_rn(acc, __fmul_rn(w, cm[k]));
            }
            float wj = 0.0f;
            if (live && __fmul_rn(__fmul_rn(d2j, c.w), c.w) < QCUT2) {
                wj = __fmul_rn(cubic_spline_w(__fmul_rn(__fsqrt_rn(d2j), c.w)), tm);
            }
            if (__any_sync(FULL, wj != 0.0f)) {
                for (int o = 16; o > 0; o >>= 1) wj = __fadd_rn(wj, __shfl_xor_sync(FULL, wj, o));
                if (lane == k) cacc = wj;
            }
        } else {
            cnt += live && d2i < tw;
            const unsigned bal = __ballot_sync(FULL, live && d2j < c.w);
            if (lane == k) ccnt = __popc(bal);
        }
    }
}

template <bool DENSITY>
__global__ void __launch_bounds__(WARPS * 32)
sym_kernel(Table t, const int32_t* __restrict__ counts, int n_cells, int n_tchunks,
           const float* __restrict__ lengths, int per_x, int per_y, int per_z, int level,
           int32_t* __restrict__ out_i, float* __restrict__ out_f) {
    __shared__ Stage stage[WARPS];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int64_t unit = static_cast<int64_t>(blockIdx.x) * WARPS + wid;
    if (unit >= static_cast<int64_t>(n_cells) * n_tchunks) return;
    const int a = static_cast<int>(unit / n_cells);  // target chunk
    const int cell = static_cast<int>(unit - static_cast<int64_t>(a) * n_cells);
    const int nT = counts[cell];
    const int t0 = a * 32;
    if (t0 >= nT) return;  // warp-uniform: nothing to test
    Stage& s = stage[wid];

    const int D = 1 << level;
    const int ix = cell >> (2 * level);
    const int iy = (cell >> level) & (D - 1);
    const int iz = cell & (D - 1);
    const int cap = t.cap;
    const int64_t trow = static_cast<int64_t>(cell) * cap;
    const int ti = t0 + lane;
    const bool tv = ti < nT;
    float tx = 0.0f, ty = 0.0f, tz = 0.0f, tw = 1.0f, tm = 1.0f;
    if (tv) {
        tx = t.x[trow + ti];
        ty = t.y[trow + ti];
        tz = t.z[trow + ti];
        tw = t.w[trow + ti];
        if (DENSITY && t.m != nullptr) tm = t.m[trow + ti];
    }
    if (DENSITY) tw = __fdiv_rn(1.0f, tw);

    // lane d < NDIR holds direction d: its cell, row length and wrap shift
    int f_cell = 0, f_n = 0;
    float f_sx = 0.0f, f_sy = 0.0f, f_sz = 0.0f;
    if (lane < NDIR) {
        const int lin = 13 + lane;  // 13 = centre, 14..26 = forward in (dx, dy, dz) order
        const int cx = ix + lin / 9 - 1, cy = iy + (lin / 3) % 3 - 1, cz = iz + lin % 3 - 1;
        const int ox = cx < 0 ? -1 : (cx >= D ? 1 : 0);
        const int oy = cy < 0 ? -1 : (cy >= D ? 1 : 0);
        const int oz = cz < 0 ? -1 : (cz >= D ? 1 : 0);
        if ((ox == 0 || per_x) && (oy == 0 || per_y) && (oz == 0 || per_z)) {
            f_cell = ((cx - ox * D) * D + (cy - oy * D)) * D + (cz - oz * D);
            f_n = counts[f_cell];
            f_sx = static_cast<float>(ox) * lengths[0];
            f_sy = static_cast<float>(oy) * lengths[1];
            f_sz = static_cast<float>(oz) * lengths[2];
        }
    }

    int cnt = 0;
    float acc = 0.0f;
    // the walk: (direction d, candidate chunk b), starting at the centre
    // cell's own chunk, which exists since t0 < nT
    int d = 0, b = a, buf = 0;
    stage_chunk<DENSITY>(t, trow + t0, min(32, nT - t0), s, 0, lane);
    cp_async_commit();
    while (d < NDIR) {
        int nd = d, nb = b + 1;
        while (nd < NDIR && nb * 32 >= __shfl_sync(FULL, f_n, nd)) {
            ++nd;
            nb = 0;
        }
        if (nd < NDIR) {
            const int64_t nrow = static_cast<int64_t>(__shfl_sync(FULL, f_cell, nd)) * cap + nb * 32;
            stage_chunk<DENSITY>(t, nrow, min(32, __shfl_sync(FULL, f_n, nd) - nb * 32), s, buf ^ 1,
                                 lane);
        }
        cp_async_commit();
        cp_async_wait_one();  // this lane's copies of the current chunk are in

        const int fcell = __shfl_sync(FULL, f_cell, d);
        const int c0 = b * 32;
        const int n = min(32, __shfl_sync(FULL, f_n, d) - c0);
        const float sx = __shfl_sync(FULL, f_sx, d);
        const float sy = __shfl_sync(FULL, f_sy, d);
        const float sz = __shfl_sync(FULL, f_sz, d);
        if (DENSITY && lane < n) s.c[buf][lane].w = __fdiv_rn(1.0f, s.c[buf][lane].w);
        __syncwarp();  // every lane's copies are visible to the warp

        const int kmin = (d == 0 && b == a) ? lane : -1;
        int ccnt = 0;
        float cacc = 0.0f;
        if (sx != 0.0f || sy != 0.0f || sz != 0.0f) {
            const float txs = __fsub_rn(tx, sx), tys = __fsub_rn(ty, sy), tzs = __fsub_rn(tz, sz);
            test_chunk<DENSITY, true>(s.c[buf], s.m[buf], n, kmin, tv, tx, ty, tz, tw, tm, sx, sy,
                                      sz, txs, tys, tzs, lane, cnt, acc, ccnt, cacc);
        } else {
            test_chunk<DENSITY, false>(s.c[buf], s.m[buf], n, kmin, tv, tx, ty, tz, tw, tm, 0.0f,
                                       0.0f, 0.0f, tx, ty, tz, lane, cnt, acc, ccnt, cacc);
        }
        const int64_t cslot = static_cast<int64_t>(fcell) * cap + c0 + lane;
        if (DENSITY) {
            if (cacc != 0.0f) atomicAdd(out_f + cslot, cacc);
        } else {
            if (ccnt != 0) atomicAdd(out_i + cslot, ccnt);
        }
        __syncwarp();  // the buffer is read before the next stage overwrites it
        d = nd;
        b = nb;
        buf ^= 1;
    }
    if (DENSITY) {
        if (acc != 0.0f) atomicAdd(out_f + trow + ti, acc);
    } else {
        if (cnt != 0) atomicAdd(out_i + trow + ti, cnt);
    }
}

}  // namespace

// density = 0: counts (w = r2, out int32); density = 1: spline sums (w = h,
// m = mass or null, out float32). `out` must be zeroed; `row_counts` is
// (n_cells,) int32 scratch.
extern "C" int cstone_stencil_sym(int density, const float* x, const float* y, const float* z,
                                  const float* w, const float* m, const uint8_t* valid, int cap,
                                  const float* lengths, int per_x, int per_y, int per_z, int level,
                                  int32_t* row_counts, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_cells = 1 << (3 * level);
    row_counts_kernel<<<(n_cells + 7) / 8, 256, 0, s>>>(valid, cap, n_cells, row_counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const Table t{x, y, z, w, m, cap};
    const int n_tchunks = (cap + 31) / 32;
    const int64_t units = static_cast<int64_t>(n_cells) * n_tchunks;
    const unsigned blocks = static_cast<unsigned>((units + WARPS - 1) / WARPS);
    if (density) {
        sym_kernel<true><<<blocks, WARPS * 32, 0, s>>>(t, row_counts, n_cells, n_tchunks, lengths,
                                                       per_x, per_y, per_z, level, nullptr,
                                                       static_cast<float*>(out));
    } else {
        sym_kernel<false><<<blocks, WARPS * 32, 0, s>>>(t, row_counts, n_cells, n_tchunks, lengths,
                                                        per_x, per_y, per_z, level,
                                                        static_cast<int32_t*>(out), nullptr);
    }
    return static_cast<int>(cudaGetLastError());
}
