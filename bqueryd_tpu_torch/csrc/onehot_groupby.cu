// One-hot groupby contraction for Hopper (sm_90a): the kernels of the port's
// contraction route, bound to Python with ctypes through a plain C interface
// (bqueryd_tpu_torch/ops/onehot.py builds and loads this file and chooses
// the branch of each kernel from the shape alone).
//
// All compute  out[.., r, g] = sum_k rows[r, k] * (codes[k] == g)  over
// stacked bf16 rows (count flags, 8-bit limbs of biased ints, bf16 Dekker
// limbs of float32 values) and int32 group codes.  Row r of the stacked
// operand starts at rows + r * ld; ld is a multiple of 8 elements, so every
// row start is 16-byte aligned (the caller stacks into [R, round_up(n, 8)]),
// and every kernel reads 8 data rows at a time with 16-byte loads.  A code
// outside [0, g_pad) -- the folded -1 of a filtered or null-key row --
// contributes nowhere.
//
// ---------------------------------------------------------------------------
// onehot_rows_dot (replaces bqueryd_tpu/ops/pallas_groupby.py
// onehot_rows_dot / _make_kernel): one float32 partial per block of
// kBlockK = 32768 rows, out f32[nb, r_pad, g_pad].  Every partial of integer
// rows is an integer below 32768 * 255 < 2^24, so float32 sums are exact.
// Bound: bytes.  Rows (R * 2 B/row) and codes (4 B/row) are read once:
// 22 MB for a 1M-row shard at R = 9, against a handful of operations per
// row at the main path's 9-10 groups.
//
// Branch "mma" (few groups): the TPU kernel's MXU product, on the tensor
// cores.  mma.sync.m16n8k16 (bf16 in, f32 out) takes A = 16 stacked rows x
// 16 data rows -- R16 is exactly the instruction's M -- and B = the one-hot
// of those 16 codes against 8 groups, which each lane builds in registers as
// (code == g) ? 1.0 : 0 packed into bf16x2.  Only NT = ceil(G/8) n-tiles
// (rounded to a compiled power of two) are computed, so there are no atomics
// in the inner loop.  mma.sync and not wgmma: the kernel is bound by bytes
// (two MMAs per 16 data rows at G <= 16), wgmma's M = 64 fits neither R16
// nor a one-hot built in registers, and wgmma would need B in shared memory.
//   Feeding: the order of the 16 data rows inside one MMA is free as long as
//   A and B agree, so lane (g, t) of a warp takes data rows 8t .. 8t+7 of a
//   32-row chunk: one 16-byte load each of stacked rows g and g + 8 is its
//   A fragment for two MMAs, and two 16-byte loads of codes give it the 8
//   codes its B fragments need.  No shuffles, no shared-memory staging; each
//   warp keeps kMmaUnroll chunks of loads in flight, and two CTAs of a
//   cluster of 8 share an SM.  (A TMA ring of swizzled [16 x 64] boxes read
//   with ldmatrix was built first; on the H100 it was slower than these
//   direct loads even with all its arithmetic removed, so the loads go
//   straight to the fragments.)
//   Exactness: every MMA starts from a zero C, so one MMA sums at most
//   16 * 255 < 2^12 (exact whatever the tensor core's internal width), and
//   the results are added into per-thread f32 sums with IEEE adds, exact
//   below 2^24.
//   Reduction: each 32768-row block is one thread-block cluster of
//   `cluster` CTAs.  Warps fold their fragments into the CTA's [16][g_pad]
//   table in a fixed order, one n-tile at a time through a small scratch;
//   after cluster.sync() every CTA sums its share of
//   the table over the cluster's CTAs in rank order through distributed
//   shared memory and writes every element of out[b] (zeros and padding
//   included).  No atomics touch float rows, so the output is identical from
//   run to run, and the caller allocates it with torch.empty.
//   Codes in [NT*8, g_pad) (past the computed n-tiles, outside any caller's
//   [0, G) but inside the output) take a rare path: shared-memory atomics
//   into the table, from the A fragment the lane already holds.
//
// Branch "table" (past MMA_GROUPS_LIMIT groups in onehot.py, where the
// tensor-core work, growing as G/8, costs more than the table's atomics): a
// CTA owns 1/kSplit of one block and one tile of g_tile groups and adds
// into a float32 [R][g_tile] shared-memory table (`copies` per-warp copies
// where they fit), then adds the table's non-zero slots into the zeroed
// out[b] with one float32 atomic each.  At thousands of groups the table
// atomics rarely collide.
//
// ---------------------------------------------------------------------------
// onehot_rows_dot_hicard (replaces bqueryd_tpu/ops/pallas_groupby.py
// onehot_rows_dot_hicard / _make_hicard_kernel): the same contraction over
// ALL rows into uint32 [r_pad, g_pad], wrapping mod 2^32 like the TPU
// kernel's int32 accumulation.  Int rows only (values 0..255); the caller
// bounds n by HICARD_MAX_ROWS so a limb total wraps at most once.
// Bound: bytes (the same row and code streams, plus the 4.7 MB output at
// 16 x 73,728); in practice the scattered adds, about 4M per 1M-row shard,
// and the per-SM read volume below.
//
// Branch "cluster": the group table lives in distributed shared memory.  A
// cluster of kHicardCluster = 16 CTAs (a non-portable size) owns a
// contiguous slice of the group range, each CTA 1/16 of it as a uint32
// [R][slice] table.  Each CTA streams 1/16 of all rows (rows stay in L2
// once the first cluster has read them), and adds each non-zero value whose
// code falls in its cluster's range into the owning CTA's table with a
// shared-memory atomic through map_shared_rank.  After cluster.sync() each
// CTA writes its slice with plain coalesced stores: no global atomics and no
// zero fill.  What bounds it: every SM reads n/16 rows whatever the cluster
// count C (so only 16 C SMs share the stream), L2 serves C times the input,
// and every add crosses the cluster's network; on the H100 it is slower
// than the "global" branch at the main path's shape (PERF.md).
//
// Branch "global" (tables too big for a cluster's shared memory): one global
// atomicAdd per non-zero (row, r) value into the L2-resident, zeroed table.
//
// Every entry returns cudaGetLastError() (0 on success).  Launches go on the
// caller's stream, do not synchronise and allocate nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockK = 32768;  // rows per output block (BLOCK_K)

// ---- base kernel, branch "mma" --------------------------------------------
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaUnroll = 2;                  // 32-row chunks per warp step
constexpr int kMmaWarpRows = 32 * kMmaUnroll;
constexpr int kMaxCluster = 8;

// ---- base kernel, branch "table"; hicard branch "global" ------------------
constexpr int kSplit = 8;       // CTAs sharing one block's rows
constexpr int kThreads = 256;

// ---- hicard kernel, branch "cluster" --------------------------------------
constexpr int kHicardCluster = 16;
constexpr int kHicardThreads = 512;

// stacked rows loaded together: their 16-byte loads are in flight at once
constexpr int kRowGroup = 4;

// Eight codes from k on (code -1 at and past n), with two 16-byte loads
// when all eight are in range.
__device__ __forceinline__ void load_codes8(const int32_t* __restrict__ codes,
                                            long long k, long long n,
                                            int (&c)[8]) {
    if (k + 8 <= n) {
        const int4 lo = *reinterpret_cast<const int4*>(codes + k);
        const int4 hi = *reinterpret_cast<const int4*>(codes + k + 4);
        c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
        c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) c[i] = k + i < n ? codes[k + i] : -1;
    }
}

// Eight bf16 values of one stacked row from k on (zero at and past n: the
// padding past n is never read, so it may hold anything).
__device__ __forceinline__ uint4 load_row8(const __nv_bfloat16* __restrict__ src,
                                           long long k, long long n) {
    if (k + 8 <= n) return *reinterpret_cast<const uint4*>(src);
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    const long long left = n - k;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t lo = 2 * i < left ? s[2 * i] : 0u;
        const uint32_t hi = 2 * i + 1 < left ? s[2 * i + 1] : 0u;
        w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// The i-th bf16 of eight, as its 16 bits (i known at compile time).
__device__ __forceinline__ uint32_t bf16_at(const uint4& raw, int i) {
    const int q = i >> 1;
    const uint32_t w = q == 0 ? raw.x : q == 1 ? raw.y : q == 2 ? raw.z : raw.w;
    return (i & 1) ? (w >> 16) : (w & 0xFFFFu);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
}

// Stacked rows r0 .. r0 + kRowGroup - 1 (zero past n_rows) from k on.
__device__ __forceinline__ void load_row_group(uint4 (&v)[kRowGroup],
                                               const __nv_bfloat16* __restrict__ rows,
                                               int r0, int n_rows, long long ld,
                                               long long k, long long n) {
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q)
        v[q] = r0 + q < n_rows ? load_row8(rows + (r0 + q) * ld + k, k, n)
                               : make_uint4(0u, 0u, 0u, 0u);
}

// bf16x2 one-hot of two codes against group `gid`: the lower half holds the
// element with the smaller index, as the mma fragments want it
__device__ __forceinline__ uint32_t onehot2(int c0, int c1, int gid) {
    return (c0 == gid ? 0x3F80u : 0u) | (c1 == gid ? 0x3F800000u : 0u);
}

// d = A(16x16 bf16, row) * B(16x8 bf16, col) + 0, in float32
__device__ __forceinline__ void mma_zero_c(float (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0,
                                           uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

// One lane's share of a 32-row chunk: data rows 8t .. 8t+7 of the chunk,
// their codes and their values in stacked rows g and g + 8.
struct Chunk {
    int c[8];
    uint4 top, bot;
};

__device__ __forceinline__ void load_chunks(Chunk (&ch)[kMmaUnroll],
                                            const int32_t* __restrict__ codes,
                                            const __nv_bfloat16* top,
                                            const __nv_bfloat16* bot,
                                            long long base, int t,
                                            long long k_end) {
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) {
        const long long k = base + u * 32 + 8 * t;
        load_codes8(codes, k, k_end, ch[u].c);
        ch[u].top = top ? load_row8(top + k, k, k_end) : make_uint4(0u, 0u, 0u, 0u);
        ch[u].bot = bot ? load_row8(bot + k, k, k_end) : make_uint4(0u, 0u, 0u, 0u);
    }
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
onehot_mma_kernel(const int32_t* __restrict__ codes,
                  const __nv_bfloat16* __restrict__ rows,
                  float* __restrict__ out, long long n, long long ld,
                  int n_rows, int r_pad, int g_pad, int cluster_size) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int b = blockIdx.x / cluster_size;  // output block
    const int m = blockIdx.y;                 // 16-row tile of stacked rows
    extern __shared__ float table[];  // [16][g_pad], then the fold's scratch

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    constexpr int kCovered = NT * 8;

    for (int i = threadIdx.x; i < 16 * g_pad; i += kMmaThreads) table[i] = 0.f;
    __syncthreads();

    // this lane's A rows: stacked rows g and g + 8 of the tile, where present
    const int r_top = m * 16 + g;
    const __nv_bfloat16* top =
        r_top < n_rows ? rows + static_cast<long long>(r_top) * ld : nullptr;
    const __nv_bfloat16* bot =
        r_top + 8 < n_rows ? rows + static_cast<long long>(r_top + 8) * ld
                           : nullptr;

    const long long span = kBlockK / cluster_size;
    const long long k0 = static_cast<long long>(b) * kBlockK + rank * span;
    const long long k_end = k0 + span < n ? k0 + span : n;

    // per-thread sums of the D fragments: acc[j] holds groups j*8 + 2t, +1
    // of stacked rows g and g + 8
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    // each warp steps over kMmaWarpRows rows at a time, all of a step's
    // loads in flight together
    const long long stride = static_cast<long long>(kMmaWarps) * kMmaWarpRows;
    for (long long base = k0 + warp * kMmaWarpRows; base < k_end;
         base += stride) {
        Chunk cur[kMmaUnroll];
        load_chunks(cur, codes, top, bot, base, t, k_end);
#pragma unroll
        for (int u = 0; u < kMmaUnroll; ++u) {
            const Chunk& ch = cur[u];
            int cmax = ch.c[0];
#pragma unroll
            for (int i = 1; i < 8; ++i) cmax = max(cmax, ch.c[i]);
            if (cmax >= kCovered) {
                // rare: codes past the n-tiles but inside the output
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (ch.c[i] < kCovered || ch.c[i] >= g_pad) continue;
                    atomicAdd(&table[g * g_pad + ch.c[i]],
                              bf16_bits_to_float(bf16_at(ch.top, i)));
                    atomicAdd(&table[(g + 8) * g_pad + ch.c[i]],
                              bf16_bits_to_float(bf16_at(ch.bot, i)));
                }
            }
            // MMA 0 takes data rows 8t .. 8t+3 (k-slots 2t, 2t+1, 2t+8,
            // 2t+9), MMA 1 data rows 8t+4 .. 8t+7
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int gid = j * 8 + g;
                float d[4];
                mma_zero_c(d, ch.top.x, ch.bot.x, ch.top.y, ch.bot.y,
                           onehot2(ch.c[0], ch.c[1], gid),
                           onehot2(ch.c[2], ch.c[3], gid));
                acc[j][0] += d[0];
                acc[j][1] += d[1];
                acc[j][2] += d[2];
                acc[j][3] += d[3];
                mma_zero_c(d, ch.top.z, ch.bot.z, ch.top.w, ch.bot.w,
                           onehot2(ch.c[4], ch.c[5], gid),
                           onehot2(ch.c[6], ch.c[7], gid));
                acc[j][0] += d[0];
                acc[j][1] += d[1];
                acc[j][2] += d[2];
                acc[j][3] += d[3];
            }
        }
    }

    // fold the warps' fragments into the table one n-tile at a time: each
    // warp parks its [16][8] fragment, then 128 threads sum the warps in
    // order (a fixed order, so float rows come out the same on every run)
    float* part = table + 16 * g_pad;  // [kMmaWarps][16][8]
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        float* mine = part + warp * 128;
        mine[g * 8 + 2 * t] = acc[j][0];
        mine[g * 8 + 2 * t + 1] = acc[j][1];
        mine[(g + 8) * 8 + 2 * t] = acc[j][2];
        mine[(g + 8) * 8 + 2 * t + 1] = acc[j][3];
        __syncthreads();
        if (threadIdx.x < 128) {
            float sum = 0.f;
            for (int w = 0; w < kMmaWarps; ++w) sum += part[w * 128 + threadIdx.x];
            table[(threadIdx.x / 8) * g_pad + j * 8 + threadIdx.x % 8] += sum;
        }
        __syncthreads();
    }

    // every CTA of the cluster writes its share of out[b], summing the
    // CTAs' tables in rank order
    cluster.sync();
    const int total = 16 * g_pad;
    float* dst = out + (static_cast<long long>(b) * r_pad + m * 16) * g_pad;
    for (int i = rank * kMmaThreads + threadIdx.x; i < total;
         i += cluster_size * kMmaThreads) {
        float part[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
            part[q] = q < cluster_size ? cluster.map_shared_rank(table, q)[i] : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
            if (q < cluster_size) sum += part[q];
        dst[i] = sum;
    }
    cluster.sync();  // peers' tables stay alive until every read is done
}

__global__ void __launch_bounds__(kThreads)
onehot_table_kernel(const int32_t* __restrict__ codes,
                    const __nv_bfloat16* __restrict__ rows,
                    float* __restrict__ out, long long n, long long ld,
                    int n_rows, int r_pad, int g_pad, int g_tile, int copies) {
    extern __shared__ float acc_s[];  // [copies][n_rows][g_tile]
    const int table = n_rows * g_tile;
    const int b = blockIdx.x / kSplit;
    const int split = blockIdx.x % kSplit;
    const int g0 = blockIdx.y * g_tile;
    const int gt = min(g_tile, g_pad - g0);

    for (int i = threadIdx.x; i < copies * table; i += kThreads) acc_s[i] = 0.f;
    __syncthreads();

    float* mine = acc_s + ((threadIdx.x / 32) % copies) * table;
    constexpr long long span = kBlockK / kSplit;
    const long long start = static_cast<long long>(b) * kBlockK + split * span;
    const long long stop = start + span < n ? start + span : n;
    for (long long k = start + threadIdx.x * 8; k < stop; k += kThreads * 8) {
        // the first row group's loads go out with the codes
        int c[8];
        uint4 v[kRowGroup];
        load_codes8(codes, k, stop, c);
        load_row_group(v, rows, 0, n_rows, ld, k, stop);
        // negative codes wrap to large unsigned values and fall out with the
        // codes of other tiles
        unsigned rel[8];
        bool any = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            rel[i] = static_cast<unsigned>(c[i]) - static_cast<unsigned>(g0);
            any |= rel[i] < static_cast<unsigned>(gt);
        }
        if (!any) continue;
        for (int r0 = 0;;) {
#pragma unroll
            for (int q = 0; q < kRowGroup; ++q) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (rel[i] >= static_cast<unsigned>(gt)) continue;
                    const float x = bf16_bits_to_float(bf16_at(v[q], i));
                    if (x != 0.f) atomicAdd(&mine[(r0 + q) * g_tile + rel[i]], x);
                }
            }
            r0 += kRowGroup;
            if (r0 >= n_rows) break;
            load_row_group(v, rows, r0, n_rows, ld, k, stop);
        }
    }
    __syncthreads();

    float* dst = out + static_cast<long long>(b) * r_pad * g_pad + g0;
    for (int i = threadIdx.x; i < table; i += kThreads) {
        const int r = i / g_tile;
        const int gg = i - r * g_tile;
        if (gg >= gt) continue;
        float sum = 0.f;
        for (int cp = 0; cp < copies; ++cp) sum += acc_s[cp * table + i];
        if (sum != 0.f) atomicAdd(&dst[static_cast<long long>(r) * g_pad + gg], sum);
    }
}

__global__ void __launch_bounds__(kHicardThreads)
hicard_cluster_kernel(const int32_t* __restrict__ codes,
                      const __nv_bfloat16* __restrict__ rows,
                      uint32_t* __restrict__ out, long long n, long long ld,
                      int n_rows, int r_pad, int g_pad, int slice) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int cl = blockIdx.x / kHicardCluster;
    extern __shared__ uint32_t table_u[];  // [n_rows][slice]

    for (int i = threadIdx.x; i < n_rows * slice; i += kHicardThreads)
        table_u[i] = 0u;
    cluster.sync();  // every table is zero before any peer adds into it

    const int g_lo = cl * kHicardCluster * slice;
    const unsigned width = static_cast<unsigned>(kHicardCluster * slice);
    const long long chunk =
        ((n + kHicardCluster - 1) / kHicardCluster + 7) / 8 * 8;
    const long long start = rank * chunk;
    const long long stop = start + chunk < n ? start + chunk : n;
    for (long long k = start + threadIdx.x * 8; k < stop;
         k += kHicardThreads * 8) {
        // the first row group's loads go out with the codes
        int c[8];
        uint4 v[kRowGroup];
        load_codes8(codes, k, stop, c);
        load_row_group(v, rows, 0, n_rows, ld, k, stop);
        unsigned rel[8];
        bool any = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            rel[i] = static_cast<unsigned>(c[i]) - static_cast<unsigned>(g_lo);
            any |= rel[i] < width;
        }
        if (!any) continue;
        uint32_t* dst[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            dst[i] = nullptr;
            if (rel[i] < width) {
                const unsigned owner = rel[i] / slice;
                dst[i] = cluster.map_shared_rank(table_u, owner) +
                         (rel[i] - owner * slice);
            }
        }
        for (int r0 = 0;;) {
#pragma unroll
            for (int q = 0; q < kRowGroup; ++q) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const uint32_t x = static_cast<uint32_t>(
                        bf16_bits_to_float(bf16_at(v[q], i)));
                    if (dst[i] != nullptr && x != 0u)
                        atomicAdd(dst[i] + (r0 + q) * slice, x);
                }
            }
            r0 += kRowGroup;
            if (r0 >= n_rows) break;
            load_row_group(v, rows, r0, n_rows, ld, k, stop);
        }
    }
    cluster.sync();  // every add into this CTA's table has landed

    const int g0 = g_lo + rank * slice;
    for (int i = threadIdx.x; i < r_pad * slice; i += kHicardThreads) {
        const int r = i / slice;
        const int j = i - r * slice;
        out[static_cast<long long>(r) * g_pad + g0 + j] =
            r < n_rows ? table_u[i] : 0u;
    }
}

__global__ void __launch_bounds__(kThreads)
hicard_global_kernel(const int32_t* __restrict__ codes,
                     const __nv_bfloat16* __restrict__ rows,
                     uint32_t* __restrict__ out, long long n, long long ld,
                     int n_rows, int g_pad) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads * 8;
    for (long long k = (static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x) * 8;
         k < n; k += stride) {
        // the first row group's loads go out with the codes
        int c[8];
        uint4 v[kRowGroup];
        load_codes8(codes, k, n, c);
        load_row_group(v, rows, 0, n_rows, ld, k, n);
        bool any = false;
#pragma unroll
        for (int i = 0; i < 8; ++i)
            any |= static_cast<unsigned>(c[i]) < static_cast<unsigned>(g_pad);
        if (!any) continue;
        for (int r0 = 0;;) {
#pragma unroll
            for (int q = 0; q < kRowGroup; ++q) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const uint32_t x = static_cast<uint32_t>(
                        bf16_bits_to_float(bf16_at(v[q], i)));
                    if (static_cast<unsigned>(c[i]) < static_cast<unsigned>(g_pad) &&
                        x != 0u)
                        atomicAdd(&out[static_cast<long long>(r0 + q) * g_pad + c[i]], x);
                }
            }
            r0 += kRowGroup;
            if (r0 >= n_rows) break;
            load_row_group(v, rows, r0, n_rows, ld, k, n);
        }
    }
}

template <int NT>
cudaError_t launch_mma(const int32_t* codes, const __nv_bfloat16* rows,
                       float* out, long long n, long long ld, int n_rows,
                       int r_pad, int g_pad, int cluster, int smem,
                       cudaStream_t stream) {
    auto kernel = onehot_mma_kernel<NT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const long long nb = (n + kBlockK - 1) / kBlockK;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(nb * cluster),
                       static_cast<unsigned>(r_pad / 16), 1);
    cfg.blockDim = dim3(kMmaThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, codes, rows, out, n, ld, n_rows,
                              r_pad, g_pad, cluster);
}

cudaError_t hicard_cluster_config(int smem, cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr, int clusters,
                                  cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        hicard_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(hicard_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(static_cast<unsigned>(clusters * kHicardCluster), 1, 1);
    cfg->blockDim = dim3(kHicardThreads, 1, 1);
    cfg->dynamicSmemBytes = static_cast<size_t>(smem);
    cfg->stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kHicardCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

}  // namespace

extern "C" {

// Branch "mma".  out: f32[ceil(n / 32768), r_pad, g_pad], every element
// written by the kernel.  ntiles in {1, 2, 4, 8, 16, 32}, ntiles * 8 <=
// g_pad; cluster in {1, 2, 4, 8}; smem = (16 * g_pad + kMmaWarps * 128) * 4.
int onehot_mma_launch(const void* codes, const void* rows, void* out,
                      long long n, long long ld, int n_rows, int r_pad,
                      int g_pad, int ntiles, int cluster, int smem,
                      void* stream) {
    const int32_t* c = static_cast<const int32_t*>(codes);
    const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(rows);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cluster < 1 || cluster > kMaxCluster || kBlockK % (cluster * kMmaWarpRows))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (ntiles) {
        case 1: err = launch_mma<1>(c, r, o, n, ld, n_rows, r_pad, g_pad, cluster, smem, s); break;
        case 2: err = launch_mma<2>(c, r, o, n, ld, n_rows, r_pad, g_pad, cluster, smem, s); break;
        case 4: err = launch_mma<4>(c, r, o, n, ld, n_rows, r_pad, g_pad, cluster, smem, s); break;
        case 8: err = launch_mma<8>(c, r, o, n, ld, n_rows, r_pad, g_pad, cluster, smem, s); break;
        case 16: err = launch_mma<16>(c, r, o, n, ld, n_rows, r_pad, g_pad, cluster, smem, s); break;
        case 32: err = launch_mma<32>(c, r, o, n, ld, n_rows, r_pad, g_pad, cluster, smem, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Branch "table".  out: f32[ceil(n / 32768), r_pad, g_pad], zeroed by the
// caller.  g_tile * n_rows * copies * 4 bytes of shared memory per CTA.
int onehot_table_launch(const void* codes, const void* rows, void* out,
                        long long n, long long ld, int n_rows, int r_pad,
                        int g_pad, int g_tile, int copies, void* stream) {
    const long long nb = (n + kBlockK - 1) / kBlockK;
    const int tiles = (g_pad + g_tile - 1) / g_tile;
    const size_t smem =
        static_cast<size_t>(copies) * n_rows * g_tile * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        onehot_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(static_cast<unsigned>(nb * kSplit), static_cast<unsigned>(tiles));
    onehot_table_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes),
        static_cast<const __nv_bfloat16*>(rows), static_cast<float*>(out), n,
        ld, n_rows, r_pad, g_pad, g_tile, copies);
    return static_cast<int>(cudaGetLastError());
}

// Branch "cluster".  out: uint32[r_pad, g_pad], every element written by
// the kernel; g_pad = clusters * 16 * slice, n_rows * slice * 4 = smem.
int hicard_cluster_launch(const void* codes, const void* rows, void* out,
                          long long n, long long ld, int n_rows, int r_pad,
                          int g_pad, int clusters, int smem, void* stream) {
    if (clusters < 1 || g_pad % (clusters * kHicardCluster) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int slice = g_pad / (clusters * kHicardCluster);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = hicard_cluster_config(
        smem, &cfg, attr, clusters, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, hicard_cluster_kernel,
                             static_cast<const int32_t*>(codes),
                             static_cast<const __nv_bfloat16*>(rows),
                             static_cast<uint32_t*>(out), n, ld, n_rows, r_pad,
                             g_pad, slice);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// How many 16-CTA clusters of the "cluster" branch can be resident at once
// with `smem` bytes of shared memory per CTA (a diagnostic).
int hicard_max_active_clusters(int smem, int* count) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = hicard_cluster_config(smem, &cfg, attr, 1, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveClusters(
        count, reinterpret_cast<const void*>(hicard_cluster_kernel), &cfg);
    return static_cast<int>(err);
}

// Branch "global".  out: uint32[r_pad, g_pad], zeroed by the caller.
int hicard_global_launch(const void* codes, const void* rows, void* out,
                         long long n, long long ld, int n_rows, int g_pad,
                         int blocks, void* stream) {
    hicard_global_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes),
        static_cast<const __nv_bfloat16*>(rows), static_cast<uint32_t*>(out),
        n, ld, n_rows, g_pad);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
