// One-hot groupby contraction for Hopper (sm_90a): the two kernels of the
// port's contraction route, bound to Python with ctypes through a plain C
// interface (bqueryd_tpu_torch/ops/onehot.py builds and loads this file).
//
// Both compute  out[.., r, g] = sum_k rows[r, k] * (codes[k] == g)  over
// stacked bf16 rows (count flags, 8-bit limbs of biased ints, bf16 Dekker
// limbs of float32 values) and int32 group codes.  A code outside
// [0, g_pad) -- the folded -1 of a filtered or null-key row -- contributes
// nowhere.  The one-hot is a selector, so the natural Hopper form is not a
// matrix product but a segmented sum into an on-chip table: each row adds
// its R values into the slot of its code.
//
// onehot_rows_dot (replaces bqueryd_tpu/ops/pallas_groupby.py
// onehot_rows_dot / _make_kernel): one float32 partial per block of
// kBlockK = 32768 rows, out f32[nb, r_pad, g_pad].  Every partial of
// integer rows is an integer below 32768 * 255 < 2^24, so float32 sums are
// exact in any order and the atomics below are too.
//   Bound: bytes.  Rows are read once (R * 2 B/row) plus the codes
//   (4 B/row): about 22 MB for a 1M-row shard at R = 9, against a few
//   hundred integer operations per row.
//   Design: a CTA owns 1/kSplit of one 32768-row block and one tile of
//   g_tile groups.  It streams its codes and rows with coalesced loads and
//   adds into a float32 [R][g_tile] table in shared memory.  At the main
//   path's 9-10 groups every lane of a warp hits the same ~10 slots, so
//   each warp gets its own copy of the table (`copies`, chosen by the
//   wrapper to fit the shared-memory budget) and zero values (the constant
//   middle limbs of small ints) are skipped.  The CTA then folds its copies
//   and adds the non-zero slots into out[b] with one float32 atomic each.
//
// onehot_rows_dot_hicard (replaces bqueryd_tpu/ops/pallas_groupby.py
// onehot_rows_dot_hicard / _make_hicard_kernel): the same contraction
// reduced over ALL rows into uint32 [r_pad, g_pad], wrapping mod 2^32 like
// the TPU kernel's int32 accumulation.  Int rows only (values 0..255); the
// caller bounds n by HICARD_MAX_ROWS so a limb total wraps at most once.
//   Bound: bytes (the same row and code streams); the table of
//   R * g_pad * 4 B (2.6 MB at 9 x 73,728) sits in the 50 MB L2.
//   Design: a grid-stride loop over rows with one global atomicAdd per
//   non-zero (row, r) value into the L2-resident table.
//
// Every entry returns cudaGetLastError() (0 on success).  Launches go on
// the caller's stream, do not synchronise and allocate nothing: the wrapper
// allocates and zeroes `out`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 32768;  // rows per output block (BLOCK_K)
constexpr int kSplit = 8;       // CTAs sharing one block's rows
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
onehot_rows_dot_kernel(const int32_t* __restrict__ codes,
                       const __nv_bfloat16* __restrict__ rows,
                       float* __restrict__ out, int64_t n, int n_rows,
                       int r_pad, int g_pad, int g_tile, int copies) {
    extern __shared__ float acc[];  // [copies][n_rows][g_tile]
    const int table = n_rows * g_tile;
    const int b = blockIdx.x / kSplit;
    const int split = blockIdx.x % kSplit;
    const int g0 = blockIdx.y * g_tile;
    const int gt = min(g_tile, g_pad - g0);

    for (int i = threadIdx.x; i < copies * table; i += kThreads) acc[i] = 0.f;
    __syncthreads();

    float* mine = acc + ((threadIdx.x / 32) % copies) * table;
    constexpr int64_t span = kBlockK / kSplit;
    const int64_t start = static_cast<int64_t>(b) * kBlockK + split * span;
    const int64_t stop = start + span < n ? start + span : n;
    for (int64_t k = start + threadIdx.x; k < stop; k += kThreads) {
        // negative codes wrap to large unsigned values and fall out with
        // the codes of other tiles
        const unsigned c = static_cast<unsigned>(codes[k] - g0);
        if (c >= static_cast<unsigned>(gt)) continue;
        const __nv_bfloat16* src = rows + k;
        for (int r = 0; r < n_rows; ++r) {
            const float v = __bfloat162float(src[static_cast<int64_t>(r) * n]);
            if (v != 0.f) atomicAdd(&mine[r * g_tile + c], v);
        }
    }
    __syncthreads();

    float* dst = out + static_cast<int64_t>(b) * r_pad * g_pad + g0;
    for (int i = threadIdx.x; i < table; i += kThreads) {
        const int r = i / g_tile;
        const int g = i - r * g_tile;
        if (g >= gt) continue;
        float sum = 0.f;
        for (int cp = 0; cp < copies; ++cp) sum += acc[cp * table + i];
        if (sum != 0.f) atomicAdd(&dst[static_cast<int64_t>(r) * g_pad + g], sum);
    }
}

__global__ void __launch_bounds__(kThreads)
onehot_rows_dot_hicard_kernel(const int32_t* __restrict__ codes,
                              const __nv_bfloat16* __restrict__ rows,
                              uint32_t* __restrict__ out, int64_t n,
                              int n_rows, int g_pad) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         k < n; k += stride) {
        const unsigned c = static_cast<unsigned>(codes[k]);
        if (c >= static_cast<unsigned>(g_pad)) continue;
        const __nv_bfloat16* src = rows + k;
        for (int r = 0; r < n_rows; ++r) {
            const uint32_t v = static_cast<uint32_t>(static_cast<int32_t>(
                __bfloat162float(src[static_cast<int64_t>(r) * n])));
            if (v != 0u) atomicAdd(&out[static_cast<int64_t>(r) * g_pad + c], v);
        }
    }
}

}  // namespace

extern "C" {

// out: f32[ceil(n / 32768), r_pad, g_pad], zeroed by the caller.
// g_tile * n_rows * copies * 4 bytes of dynamic shared memory per CTA.
int onehot_rows_dot_launch(const void* codes, const void* rows, void* out,
                           long long n, int n_rows, int r_pad, int g_pad,
                           int g_tile, int copies, void* stream) {
    const long long nb = (n + kBlockK - 1) / kBlockK;
    const int tiles = (g_pad + g_tile - 1) / g_tile;
    const size_t smem =
        static_cast<size_t>(copies) * n_rows * g_tile * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        onehot_rows_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(static_cast<unsigned>(nb * kSplit), static_cast<unsigned>(tiles));
    onehot_rows_dot_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes),
        static_cast<const __nv_bfloat16*>(rows), static_cast<float*>(out), n,
        n_rows, r_pad, g_pad, g_tile, copies);
    return static_cast<int>(cudaGetLastError());
}

// out: uint32[r_pad, g_pad], zeroed by the caller.
int onehot_rows_dot_hicard_launch(const void* codes, const void* rows,
                                  void* out, long long n, int n_rows,
                                  int g_pad, int blocks, void* stream) {
    onehot_rows_dot_hicard_kernel<<<blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes),
        static_cast<const __nv_bfloat16*>(rows), static_cast<uint32_t*>(out),
        n, n_rows, g_pad);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
