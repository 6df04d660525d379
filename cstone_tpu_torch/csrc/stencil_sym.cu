// Cell-list stencil kernels for NVIDIA Hopper (sm_90a): the half stencil
// of one table for neighbour counts (B1) and SPH density sums (B2), the
// cross pass between two disjoint tables (B3), and the one-sided counts
// of one table (B4), in one source.
//
// Replaces the Pallas TPU kernels cstone_tpu/ops/pallas_stencil.py:295
// _kernel_sym, op="count" and op="density" (self excluded), its
// cross=True variant (_call_sym_cross :589), and :149 _kernel (_call
// :225), the one-sided impl="pallas_asym" route (B4, mode ONE_SIDED).
//
// Contract: inputs are (n_cells,
// cap) ELL planes in row-major cell order of a D^3 grid, D = 2^level >= 4;
// valid slots form a prefix of each row. Slot i counts the slots j of the
// 27 neighbour cells with d2 < r2_i, or sums m_j W(sqrt(d2) / h_i) with the
// unnormalised cubic spline W: over its own table with j != i (B1/B2), or
// over the other table (B3, both tables' results from one pass). Periodic
// dims wrap with a +-L shift; open dims skip the ghost cells. Invalid slots
// get 0.
//
// Design:
// - Each pair is tested once. B1/B2: a target cell T is paired with itself
//   (slot pairs j > i only) and with its 13 "forward" neighbours (direction
//   (dx, dy, dz) > (0, 0, 0) lexicographically); the other 13 neighbours
//   see T as their forward neighbour. B3: the two sets are disjoint, so a
//   cell of the lane table is paired with all 27 neighbour cells of the
//   staged table, with no self mask. With D >= 4 every cell pair appears
//   exactly once, wrap included.
// - One d2 per pair, ((dx*dx + dy*dy) + dz*dz) with every operation rounded
//   on its own (__f*_rn, --fmad=false), the plain version's order. Off the
//   wrap, x_j - x_i = -(x_i - x_j) exactly, so both ends share it. For a
//   cell reached across a periodic wrap (a warp-uniform branch) the staged
//   end recomputes its d2 from its own end with the opposite shift,
//   x_j - (x_i - o L), as the one-sided plain version does. Counts are
//   therefore bit-equal to stencil_counts_plain / stencil_cross_plain, and
//   every density term has the plain version's arguments; only the sum
//   order differs.
// - Work unit: one warp per (lane-table cell, chunk of 32 lane slots) that
//   holds valid slots, one lane per slot, 4 warps per CTA, each with its
//   own staging buffers. A prologue kernel takes each row's length (one
//   warp per row) and a second lists the busy units, so no warp is spent on
//   an empty chunk: a table of cap 2432 whose rows are mostly short costs
//   what its filled chunks cost. The grid holds as many CTAs as the card
//   keeps resident; each warp takes the next unit of the list with one
//   atomicAdd until the list is spent. Any cap launches: a warp walks as
//   many staged chunks as the rows hold. B3 puts the lanes on the table
//   whose busy chunks hold more valid slots each, decided on the card from
//   the two lists' totals: a lane chunk costs a full warp however few of
//   its 32 slots are valid, while a staged chunk costs only its slots.
// - Staging: each chunk of 32 staged slots is packed into shared memory as
//   float4 (x, y, z, r2 | h) plus a mass plane, so one broadcast 16-byte
//   load serves a pair. The copy is cp.async, 4 bytes per lane and plane
//   (a 16-byte cp.async copies 4 slots of one plane and cannot interleave
//   the planes), double-buffered: the next chunk of the walk is in flight
//   while the current one is tested. Density then turns h into 1/h in
//   place, one division per staged slot instead of one per pair.
// - Staged-end sums: lane k owns staged slot k of the chunk. Counts take a
//   warp __ballot_sync + __popc per slot; density a butterfly
//   __shfl_xor_sync sum, skipped when no lane has a term (__any_sync). Each
//   lane flushes its staged slot with one global atomicAdd per (lane chunk,
//   staged chunk), and its own slot with one atomicAdd at the end, into
//   outputs the wrapper zeroed. Integer counts are therefore deterministic;
//   float sums change order from run to run.
// - Density skips the sqrt and spline of pairs with d2 / h^2 >= 4.0004
//   (q >= 2 with margin): W is exactly 0 there, so the sums are unchanged.
//
// Bound on the H100 (SXM, 700 W) at the phase-4 shape of chip_smoke
// (1M uniform particles, level 5, cap 64, about 30.5 per cell): 4.12e8
// unordered pairs; counts need d2 (8 operations) and a compare at each
// end, 10 a pair (4.1e9, 0.062 ms at 67 TFLOP/s FP32), against about
// 27 MB (valid and result per slot, planes at valid slots: 0.008 ms at
// 3.35 TB/s), so the bound is FP32 issue. Density adds the spline only
// at the 5.8e7 ends with q < 2 (about 9 operations each): 0.070 ms. B3 on
// the tiered path (1M Gaussian, adaptive h) holds 4.9e8 cross pairs over
// its three passes: 0.073 ms, likewise FP32 issue. The 67 TFLOP/s peak
// counts an FMA as two flops; bit parity forbids FMA (--fmad=false), so one
// instruction does one flop and half that rate is the reachable ceiling.
// The one-sided kernel tests each pair twice. This one tests it once, feeds
// each test from one broadcast load, and overlaps staging with the tests;
// what remains is the issue slots around the 8 flops of a test (shared
// load, two compares, the staged-end ballot or shuffle sum, the loop) and
// the idle lanes of warps whose chunk holds few of a row's slots.
//
// B4, the one-sided mode: slot i counts every valid slot j of the 27
// neighbour cells with d2 < r2_i, itself included (the wrapper subtracts
// the self pair, the JAX kernel's contract); a periodic shift is added to
// the staged slot, x_j + o L, as the plain version shifts its candidate,
// so every test has the plain version's arguments and counts are
// bit-equal to it across a wrap. Its bound at the phase-4 shape: the
// function's is B1's, 0.062 ms; tested one-sided, each ordered pair once,
// 8.2e8 tests x 9 operations (d2, a compare) = 7.4e9, 0.11 ms at 67
// TFLOP/s, or twice that at one flop an instruction. What held the first
// draft of B1-B4 (one thread a target slot) back: 64-thread blocks, one a cell, so the
// second warp of nearly every block held no valid target yet staged and
// waited at every barrier; 27 x (__syncthreads + __syncthreads_count) a
// block around synchronous loads, so the load latency was exposed 27
// times; three scalar shared loads and a byte-wide valid read per test.
// The mode runs on the machinery above: the work list of busy (cell,
// 64-slot chunk) units, so no warp runs an empty chunk; lanes on the
// target slots, two a lane (slots lane and lane + 32) in a unit that
// holds more than 32, so a row of 33-64 slots is walked once and not by a
// second, mostly idle warp; each warp walks the valid prefixes of all 27
// neighbour rows with double-buffered cp.async staging of (x, y, z) and
// warp barriers only; one broadcast 16-byte shared load serves each test,
// or two; each lane owns its counts and stores them once, so there are no
// atomics and the result is deterministic.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps per CTA, one work unit each
constexpr float QCUT2 = 4.0004f;

// HALF: B1/B2, the half stencil of one table; CROSS: B3, two disjoint
// tables; ONE_SIDED: B4, counts of one table from the lane end only, over
// all 27 cells, the self pair included.
enum Mode { HALF = 0, CROSS = 1, ONE_SIDED = 2 };

// Lane-table slots a work unit covers: one per lane, or two in the
// one-sided mode (slots lane and lane + 32), so that a row of 33-64 slots
// is walked once and each staged load serves two tests.
__host__ __device__ constexpr int unit_slots(Mode m) { return m == ONE_SIDED ? 64 : 32; }

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

// The table's work list: the units a * n_cells + cell (lane chunk a of a
// row, `width` slots a chunk) whose chunk holds valid slots, one thread
// per unit of the full grid of n_grid = n_cells * ceil(cap / width). Each
// block compacts its range of the grid and reserves its place with one
// atomicAdd on stats[0], which counts the table's busy chunks; stats[1]
// sums its valid slots. Blocks
// reserve in about grid order, so the list runs chunk by chunk: the chunks
// of one row are far apart in it, and the warps that run at once seldom
// credit the same staged slots with their atomics. The order changes no
// result but the order of float atomics.
constexpr int LIST_THREADS = 1024;

__global__ void __launch_bounds__(LIST_THREADS)
work_list_kernel(const int32_t* __restrict__ counts, int n_cells, int64_t n_grid, int width,
                 int32_t* __restrict__ units, unsigned long long* __restrict__ stats) {
    __shared__ int warp_busy[LIST_THREADS / 32];
    __shared__ int warp_slots[LIST_THREADS / 32];
    __shared__ unsigned long long block_base;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int64_t v = static_cast<int64_t>(blockIdx.x) * LIST_THREADS + threadIdx.x;
    int slots = 0;
    bool busy = false;
    if (v < n_grid) {
        const int a = static_cast<int>(v / n_cells);
        const int n = counts[v - static_cast<int64_t>(a) * n_cells];
        busy = a * width < n;
        slots = a == 0 ? n : 0;  // each row's slots once
    }
    const unsigned bal = __ballot_sync(FULL, busy);
    for (int o = 16; o > 0; o >>= 1) slots += __shfl_xor_sync(FULL, slots, o);
    if (lane == 0) {
        warp_busy[wid] = __popc(bal);
        warp_slots[wid] = slots;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long total = 0, all_slots = 0;
        for (int w = 0; w < LIST_THREADS / 32; ++w) {
            const int c = warp_busy[w];
            warp_busy[w] = static_cast<int>(total);  // exclusive prefix over the warps
            total += c;
            all_slots += warp_slots[w];
        }
        block_base = total ? atomicAdd(&stats[0], total) : 0;
        if (all_slots) atomicAdd(&stats[1], all_slots);
    }
    __syncthreads();
    if (busy) {
        units[block_base + warp_busy[wid] + __popc(bal & ((1u << lane) - 1))] = static_cast<int32_t>(v);
    }
}

template <bool DENSITY, bool KEY>
__device__ __forceinline__ void stage_chunk(const Table& t, int64_t row, int n, Stage& s, int buf,
                                            int lane) {
    if (lane < n) {
        const int64_t g = row + lane;
        float* d = reinterpret_cast<float*>(&s.c[buf][lane]);
        cp_async4(d + 0, t.x + g);
        cp_async4(d + 1, t.y + g);
        cp_async4(d + 2, t.z + g);
        if (KEY) cp_async4(d + 3, t.w + g);
        if (DENSITY) {
            if (t.m != nullptr) cp_async4(&s.m[buf][lane], t.m + g);
            else s.m[buf][lane] = 1.0f;
        }
    }
}

// The tests of one staged chunk of n slots against the warp's lane slots.
// WRAP: the chunk's cell was reached across a periodic wrap; (sx, sy, sz)
// is the shift o L added to the staged slot at the lane end, and
// (txs, tys, tzs) = lane slot - o L is the lane slot seen from the staged
// end. kmin: staged slot k pairs with lane only when k > kmin (the centre
// cell's own chunk of B1/B2: slot j > slot i).
template <bool DENSITY, bool WRAP>
__device__ __forceinline__ void test_chunk(const float4* __restrict__ c4, const float* __restrict__ cm,
                                           int n, int kmin, bool tv, float tx, float ty, float tz,
                                           float tw, float tm, float sx, float sy, float sz,
                                           float txs, float tys, float tzs, int lane, int& cnt,
                                           float& acc, int& ccnt, float& cacc) {
#pragma unroll 4  // overlaps the independent tests of consecutive staged slots
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

// cnt += d2 < r2 as one compare and a predicated add (setp.lt is false on
// NaN, as the C++ compare is); compiled from C++ the increment becomes a
// select between cnt and cnt + 1, two instructions.
__device__ __forceinline__ void count_if_less(int& cnt, float d2, float r2) {
    asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
        : "+r"(cnt)
        : "f"(d2), "f"(r2));
}

// One-sided counts (B4): the tests of one staged chunk of n slots against
// this lane's target slot t1 = (x, y, z, r2) and, with TWO, its second
// slot t2; r2 is -1 for an empty slot. WRAP: the chunk's cell was reached
// across a periodic wrap, and the shift o L = (sx, sy, sz) is added to the
// staged slot, as the plain version shifts its candidate.
template <bool WRAP, bool TWO>
__device__ __forceinline__ void count_chunk(const float4* __restrict__ c4, int n, float4 t1,
                                            float4 t2, float sx, float sy, float sz, int& cnt1,
                                            int& cnt2) {
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        float4 c = c4[k];
        if (WRAP) {
            c.x = __fadd_rn(c.x, sx);
            c.y = __fadd_rn(c.y, sy);
            c.z = __fadd_rn(c.z, sz);
        }
        count_if_less(cnt1, dist2(__fsub_rn(t1.x, c.x), __fsub_rn(t1.y, c.y), __fsub_rn(t1.z, c.z)),
                      t1.w);
        if (TWO) {
            count_if_less(cnt2, dist2(__fsub_rn(t2.x, c.x), __fsub_rn(t2.y, c.y), __fsub_rn(t2.z, c.z)),
                          t2.w);
        }
    }
}

// One work unit: lane chunk a of cell `cell` of the lane table t against
// the staged table c (the same table unless M == CROSS), crediting out_t
// and, unless M == ONE_SIDED, out_c. Every lane of the warp calls it with
// the same unit.
template <bool DENSITY, Mode M>
__device__ __forceinline__ void run_unit(const Table& t, const Table& c,
                                         const int32_t* __restrict__ counts_t,
                                         const int32_t* __restrict__ counts_c, int a, int cell,
                                         const float* __restrict__ lengths, int per_x, int per_y,
                                         int per_z, int level, void* out_t, void* out_c, Stage& s,
                                         int lane) {
    constexpr bool ALL27 = M != HALF;  // all 27 cells, from the lane end's first
    constexpr int NDIR = ALL27 ? 27 : 14;
    const int nT = counts_t[cell];
    const int t0 = a * unit_slots(M);

    const int D = 1 << level;
    const int ix = cell >> (2 * level);
    const int iy = (cell >> level) & (D - 1);
    const int iz = cell & (D - 1);
    const int64_t trow = static_cast<int64_t>(cell) * t.cap;
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
    // the one-sided mode's second slot, 32 above the first; `two` is
    // warp-uniform: the unit holds more than 32 slots
    const bool two = M == ONE_SIDED && nT - t0 > 32;
    const bool tv2 = two && ti + 32 < nT;
    float4 t2 = make_float4(0.0f, 0.0f, 0.0f, -1.0f);  // r2 -1: an empty slot counts nothing
    if (tv2) t2 = make_float4(t.x[trow + ti + 32], t.y[trow + ti + 32], t.z[trow + ti + 32],
                              t.w[trow + ti + 32]);
    if (M == ONE_SIDED && !tv) tw = -1.0f;

    // lane d < NDIR holds direction d: its cell, row length and wrap shift
    int f_cell = 0, f_n = 0;
    float f_sx = 0.0f, f_sy = 0.0f, f_sz = 0.0f;
    if (lane < NDIR) {
        // (dx, dy, dz) in lexicographic order; B1/B2 start at 13, the centre
        const int lin = ALL27 ? lane : 13 + lane;
        const int cx = ix + lin / 9 - 1, cy = iy + (lin / 3) % 3 - 1, cz = iz + lin % 3 - 1;
        const int ox = cx < 0 ? -1 : (cx >= D ? 1 : 0);
        const int oy = cy < 0 ? -1 : (cy >= D ? 1 : 0);
        const int oz = cz < 0 ? -1 : (cz >= D ? 1 : 0);
        if ((ox == 0 || per_x) && (oy == 0 || per_y) && (oz == 0 || per_z)) {
            f_cell = ((cx - ox * D) * D + (cy - oy * D)) * D + (cz - oz * D);
            f_n = counts_c[f_cell];
            f_sx = static_cast<float>(ox) * lengths[0];
            f_sy = static_cast<float>(oy) * lengths[1];
            f_sz = static_cast<float>(oz) * lengths[2];
        }
    }
    // from (d, b), the first (direction, staged chunk) of the walk that
    // holds slots
    auto skip_empty = [&](int& d, int& b) {
        while (d < NDIR && b * 32 >= __shfl_sync(FULL, f_n, d)) {
            ++d;
            b = 0;
        }
    };
    auto stage_at = [&](int d, int b, int buf) {
        const int64_t row = static_cast<int64_t>(__shfl_sync(FULL, f_cell, d)) * c.cap + b * 32;
        stage_chunk<DENSITY, M != ONE_SIDED>(c, row, min(32, __shfl_sync(FULL, f_n, d) - b * 32), s,
                                             buf, lane);
    };

    int cnt = 0, cnt2 = 0;
    float acc = 0.0f;
    // B1/B2 start at the centre cell's own chunk, which exists since t0 < nT
    int d = 0, b = ALL27 ? 0 : a, buf = 0;
    skip_empty(d, b);
    if (d == NDIR) return;  // no staged slot in any neighbour cell
    stage_at(d, b, 0);
    cp_async_commit();
    while (d < NDIR) {
        int nd = d, nb = b + 1;
        skip_empty(nd, nb);
        if (nd < NDIR) stage_at(nd, nb, buf ^ 1);
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

        const bool wrap = sx != 0.0f || sy != 0.0f || sz != 0.0f;  // warp-uniform
        if (M == ONE_SIDED) {
            const float4 t1 = make_float4(tx, ty, tz, tw);
            if (two) {
                if (wrap) count_chunk<true, true>(s.c[buf], n, t1, t2, sx, sy, sz, cnt, cnt2);
                else count_chunk<false, true>(s.c[buf], n, t1, t2, 0.0f, 0.0f, 0.0f, cnt, cnt2);
            } else {
                if (wrap) count_chunk<true, false>(s.c[buf], n, t1, t2, sx, sy, sz, cnt, cnt2);
                else count_chunk<false, false>(s.c[buf], n, t1, t2, 0.0f, 0.0f, 0.0f, cnt, cnt2);
            }
            __syncwarp();  // the buffer is read before the next stage overwrites it
            d = nd;
            b = nb;
            buf ^= 1;
            continue;
        }
        const int kmin = (M == HALF && d == 0 && b == a) ? lane : -1;
        int ccnt = 0;
        float cacc = 0.0f;
        if (wrap) {
            const float txs = __fsub_rn(tx, sx), tys = __fsub_rn(ty, sy), tzs = __fsub_rn(tz, sz);
            test_chunk<DENSITY, true>(s.c[buf], s.m[buf], n, kmin, tv, tx, ty, tz, tw, tm, sx, sy,
                                      sz, txs, tys, tzs, lane, cnt, acc, ccnt, cacc);
        } else {
            test_chunk<DENSITY, false>(s.c[buf], s.m[buf], n, kmin, tv, tx, ty, tz, tw, tm, 0.0f,
                                       0.0f, 0.0f, tx, ty, tz, lane, cnt, acc, ccnt, cacc);
        }
        const int64_t cslot = static_cast<int64_t>(fcell) * c.cap + c0 + lane;
        if (DENSITY) {
            if (cacc != 0.0f) atomicAdd(static_cast<float*>(out_c) + cslot, cacc);
        } else {
            if (ccnt != 0) atomicAdd(static_cast<int32_t*>(out_c) + cslot, ccnt);
        }
        __syncwarp();  // the buffer is read before the next stage overwrites it
        d = nd;
        b = nb;
        buf ^= 1;
    }
    if (M == ONE_SIDED) {
        // the unit owns its lane slots
        if (tv) static_cast<int32_t*>(out_t)[trow + ti] = cnt;
        if (tv2) static_cast<int32_t*>(out_t)[trow + ti + 32] = cnt2;
    } else if (DENSITY) {
        if (acc != 0.0f) atomicAdd(static_cast<float*>(out_t) + trow + ti, acc);
    } else {
        if (cnt != 0) atomicAdd(static_cast<int32_t*>(out_t) + trow + ti, cnt);
    }
}

// Tables a and b with their row lengths and work lists; stats holds each
// table's (busy chunks, valid slots) and, at [4], the units handed out.
// HALF (B1/B2): a and b are one table, walked over the centre cell (slots
// j > i) and the 13 forward cells. CROSS (B3): two disjoint tables; the
// lanes go on the one whose rows fill their 32-slot chunks better (each
// lane chunk costs a full warp however few slots it holds), and all 27
// cells of the other are staged. ONE_SIDED (B4): one table, all 27 cells
// staged, the lane end credited alone. out_a / out_b are the tables'
// zeroed outputs (int32 counts or float32 sums; one array unless CROSS).
// The grid holds at most as many warps as the card keeps resident; each
// warp takes units from the lane table's list until it is spent.
template <bool DENSITY, Mode M>
__global__ void __launch_bounds__(WARPS * 32)
sym_kernel(Table ta, Table tb, const int32_t* __restrict__ counts_a,
           const int32_t* __restrict__ counts_b, const int32_t* __restrict__ units_a,
           const int32_t* __restrict__ units_b, unsigned long long* __restrict__ stats,
           int n_cells, const float* __restrict__ lengths, int per_x, int per_y, int per_z,
           int level, void* out_a, void* out_b) {
    __shared__ Stage stage[WARPS];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    // lanes on b when b's busy chunks hold more slots each: sb / cb > sa / ca
    const bool lanes_b = M == CROSS && stats[3] * stats[0] > stats[1] * stats[2];
    const Table t = lanes_b ? tb : ta;
    const Table c = lanes_b ? ta : tb;
    const int32_t* counts_t = lanes_b ? counts_b : counts_a;
    const int32_t* counts_c = lanes_b ? counts_a : counts_b;
    const int32_t* units = lanes_b ? units_b : units_a;
    void* out_t = lanes_b ? out_b : out_a;
    void* out_c = lanes_b ? out_a : out_b;
    const long long n_units = static_cast<long long>(stats[lanes_b ? 2 : 0]);
    for (;;) {
        unsigned long long u = 0;
        if (lane == 0) u = atomicAdd(&stats[4], 1ull);
        u = __shfl_sync(FULL, u, 0);
        if (static_cast<long long>(u) >= n_units) return;
        const int unit = units[u];
        const int a = unit / n_cells;  // lane chunk
        run_unit<DENSITY, M>(t, c, counts_t, counts_c, a, unit - a * n_cells, lengths, per_x,
                             per_y, per_z, level, out_t, out_c, stage[wid], lane);
        __syncwarp();  // the warp's staging buffers are free for the next unit
    }
}

// Blocks of the symmetric kernel the card keeps resident at once.
template <bool DENSITY, Mode M>
int resident_blocks() {
    static int blocks = 0;
    if (blocks == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sym_kernel<DENSITY, M>,
                                                      WARPS * 32, 0);
        blocks = sms * per_sm;
    }
    return blocks;
}

template <bool DENSITY, Mode M>
void launch_sym(const Table& a, const Table& b, const int32_t* counts_a, const int32_t* counts_b,
                const int32_t* units_a, const int32_t* units_b, unsigned long long* stats,
                int n_cells, int64_t max_units, const float* lengths, int per_x, int per_y,
                int per_z, int level, void* out_a, void* out_b, cudaStream_t s) {
    const int64_t want = (max_units + WARPS - 1) / WARPS;
    const int blocks = static_cast<int>(std::min<int64_t>(want, resident_blocks<DENSITY, M>()));
    if (blocks > 0) {
        sym_kernel<DENSITY, M><<<blocks, WARPS * 32, 0, s>>>(
            a, b, counts_a, counts_b, units_a, units_b, stats, n_cells, lengths, per_x, per_y,
            per_z, level, out_a, out_b);
    }
}

// Row lengths, work lists and the symmetric kernel. units_* hold n_cells *
// ceil(cap / 32) int32 each; stats is 5 zeroed-here unsigned 64-bit words.
template <Mode M>
int launch(int density, const Table& a, const uint8_t* a_valid, const Table& b,
           const uint8_t* b_valid, const float* lengths, int per_x, int per_y, int per_z,
           int level, int32_t* counts_a, int32_t* counts_b, int32_t* units_a, int32_t* units_b,
           unsigned long long* stats, void* out_a, void* out_b, cudaStream_t s) {
    const int n_cells = 1 << (3 * level);
    const int64_t chunks = (std::max(a.cap, b.cap) + 31) / 32;
    if (static_cast<int64_t>(n_cells) * chunks > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);  // a unit must fit in int32
    }
    cudaMemsetAsync(stats, 0, 5 * sizeof(unsigned long long), s);
    constexpr int W = unit_slots(M);
    auto list = [&](const Table& t, const uint8_t* valid, int32_t* counts, int32_t* units,
                    unsigned long long* table_stats) {
        const int64_t n_grid = static_cast<int64_t>(n_cells) * ((t.cap + W - 1) / W);
        row_counts_kernel<<<(n_cells + 7) / 8, 256, 0, s>>>(valid, t.cap, n_cells, counts);
        work_list_kernel<<<static_cast<unsigned>((n_grid + LIST_THREADS - 1) / LIST_THREADS),
                           LIST_THREADS, 0, s>>>(counts, n_cells, n_grid, W, units, table_stats);
    };
    list(a, a_valid, counts_a, units_a, stats);
    if (M == CROSS) list(b, b_valid, counts_b, units_b, stats + 2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t max_units = static_cast<int64_t>(n_cells) * chunks;
    if constexpr (M == ONE_SIDED) {  // counts only
        if (density) return static_cast<int>(cudaErrorInvalidValue);
    } else if (density) {
        launch_sym<true, M>(a, b, counts_a, counts_b, units_a, units_b, stats, n_cells, max_units,
                            lengths, per_x, per_y, per_z, level, out_a, out_b, s);
        return static_cast<int>(cudaGetLastError());
    }
    launch_sym<false, M>(a, b, counts_a, counts_b, units_a, units_b, stats, n_cells, max_units,
                         lengths, per_x, per_y, per_z, level, out_a, out_b, s);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1/B2. density = 0: counts (w = r2, out int32); density = 1: spline sums
// (w = h, m = mass or null, out float32). `out` must be zeroed; scratch:
// `row_counts` (n_cells,) int32, `units` (n_cells * ceil(cap / 32),)
// int32, `stats` 5 unsigned 64-bit words.
extern "C" int cstone_stencil_sym(int density, const float* x, const float* y, const float* z,
                                  const float* w, const float* m, const uint8_t* valid, int cap,
                                  const float* lengths, int per_x, int per_y, int per_z, int level,
                                  int32_t* row_counts, int32_t* units, void* stats, void* out,
                                  void* stream) {
    const Table t{x, y, z, w, m, cap};
    return launch<HALF>(density, t, valid, t, valid, lengths, per_x, per_y, per_z, level,
                        row_counts, row_counts, units, units,
                        static_cast<unsigned long long*>(stats), out, out,
                        static_cast<cudaStream_t>(stream));
}

// B3: the cross pass between tables a and b, two disjoint sets on one grid.
// w = r2 (counts) or h (density), m = per-slot mass or null. out_a / out_b
// receive each table's results (each slot against the other table, at its
// own radius) and must be zeroed; scratch: row_counts_* (n_cells,) int32,
// units_* (n_cells * ceil(max(cap_a, cap_b) / 32),) int32, `stats` 5
// unsigned 64-bit words.
extern "C" int cstone_stencil_cross(int density, const float* ax, const float* ay,
                                    const float* az, const float* aw, const float* am,
                                    const uint8_t* a_valid, int cap_a, const float* bx,
                                    const float* by, const float* bz, const float* bw,
                                    const float* bm, const uint8_t* b_valid, int cap_b,
                                    const float* lengths, int per_x, int per_y, int per_z,
                                    int level, int32_t* row_counts_a, int32_t* row_counts_b,
                                    int32_t* units_a, int32_t* units_b, void* stats, void* out_a,
                                    void* out_b, void* stream) {
    const Table a{ax, ay, az, aw, am, cap_a};
    const Table b{bx, by, bz, bw, bm, cap_b};
    return launch<CROSS>(density, a, a_valid, b, b_valid, lengths, per_x, per_y, per_z, level,
                        row_counts_a, row_counts_b, units_a, units_b,
                        static_cast<unsigned long long*>(stats), out_a, out_b,
                        static_cast<cudaStream_t>(stream));
}

// B4: one-sided counts of one table, the self pair included (the wrapper
// subtracts it): slot i counts the valid slots j of the 27 neighbour cells
// with d2 < r2_i, d2 from i's end. `out` must be zeroed (empty slots stay
// 0); scratch as for cstone_stencil_sym.
extern "C" int cstone_stencil_one_sided(const float* x, const float* y, const float* z,
                                        const float* r2, const uint8_t* valid, int cap,
                                        const float* lengths, int per_x, int per_y, int per_z,
                                        int level, int32_t* row_counts, int32_t* units, void* stats,
                                        void* out, void* stream) {
    const Table t{x, y, z, r2, nullptr, cap};
    return launch<ONE_SIDED>(0, t, valid, t, valid, lengths, per_x, per_y, per_z, level,
                             row_counts, row_counts, units, units,
                             static_cast<unsigned long long*>(stats), out, out,
                             static_cast<cudaStream_t>(stream));
}
