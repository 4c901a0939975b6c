// All-pairs cosine ROC histogram: the per-client 1:1 verification kernel.
//
// Replaces the TPU kernel fedfr_tpu/ops/pallas_kernels.py::_roc_hist_kernel
// (launched by roc_histogram_pair, wrapped by roc_histogram), which the
// per-round personalized 1:1 eval runs once per candidate client
// (LocalVerificationCallback.veri_test -> client_roc ->
// pairwise_roc_histogram).
//
// What it computes.  feats (N, E) fp32 with the T target rows first, labels
// (N,) int32.  For every pair i < T, i < j < N:
//     sim = <feats[i], feats[j]>            IEEE fp32, summed in k order
//     bin = clamp((int)((sim + 1) * 1000), 0, 2000)   two rounded steps,
//                                                      truncated toward zero
//     out[2 * bin + (labels[i] != labels[j])] += 1
// out is the interleaved [pos, neg] histogram of 2 x 2001 int64 counts.
//
// What bounds it on an H100.  2 * E FFMA-operations per pair on the SIMT
// cores (TF32 tensor cores would move pairs by about one bin): at the
// reference shape (T = 4,000 of N = 160,000, E = 512) that is 631,998,000
// pairs, 6.47e11 operations, 9.7 ms at 67 TFLOP/s of fp32, against 0.1 ms
// to read the 328 MB of features from HBM.  So it is bound by operations.
//
// Design.  The TPU kernel counts each tile with a radix one-hot matmul in
// VMEM and carries the count block across its sequential grid.  CUDA blocks
// run in parallel, so here:
//   * block (x, y) owns BM target rows (x) and a contiguous range of BN-row
//     j-tiles (y), split so that the grid holds about two blocks per SM;
//     j-tiles wholly at or below the diagonal (j_max <= i_min) are skipped,
//     and the i < j guard applies inside the diagonal tile;
//   * each 128 x 128 similarity tile is computed with fp32 FFMA on the SIMT
//     cores: per 8-wide K-slice the 256 threads stage both tiles in shared
//     memory, transposed, and each thread keeps an 8 x 8 micro-tile of dot
//     products in registers, reading its rows and columns as float4s;
//   * each pair is binned in registers and counted with a shared-memory
//     atomicAdd into the block's private 4,002 x int32 histogram (16 KB):
//     the reference's own atomics design (roc_cuda.py:26-28), made
//     hierarchical;
//   * the block flushes once, with a 64-bit global atomicAdd per non-zero bin.
// Ragged edges are masked (loads past an edge read 0; pairs past T or N are
// not counted), so nothing is padded.  A block's int32 counters hold at most
// BM x (its j-rows) pairs, which the wrapper's 2^31-element limit on feats
// keeps below 2^31.
//
// Interface: a plain C function (built with nvcc into a shared library and
// called through ctypes) that launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().  The caller zeroes `out`.

#include <cuda_runtime.h>

namespace {

constexpr int BINS = 2001;         // int((cos + 1) * 1000) for cos in [-1, 1]
constexpr int HIST = 2 * BINS;     // interleaved [pos, neg]
constexpr int BM = 128;            // target rows per block
constexpr int BN = 128;            // j rows per tile
constexpr int BK = 8;              // K-slice staged in shared memory
constexpr int TM = 8;              // micro-tile rows per thread
constexpr int TN = 8;              // micro-tile cols per thread
constexpr int TPC = BN / TN;       // 16 threads share one row of the block
constexpr int THREADS = (BM / TM) * TPC;  // 256
constexpr int PAD = 4;             // keeps float4 alignment of each k-row

static_assert(THREADS == 256, "tiling assumes 256 threads");
static_assert(BM == BN, "the diagonal skip assumes square tiles");
static_assert(BM * BK == THREADS * 4 && BN * BK == THREADS * 4,
              "each thread stages 4 elements of each operand per K-slice");

// rows / cols of a thread: two 4-wide halves 64 apart, so that the 16
// threads of a row group read consecutive float4s from shared memory
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
}

// (sim + 1) * 1000 as two IEEE-rounded fp32 steps (never contracted into an
// FMA), truncated toward zero like the JAX package's .astype(int32)
__device__ __forceinline__ int bin_of(float sim) {
  const int b = __float2int_rz(__fmul_rn(__fadd_rn(sim, 1.0f), 1000.0f));
  return min(max(b, 0), BINS - 1);
}

__global__ void __launch_bounds__(THREADS, 2)
roc_hist_kernel(const float* __restrict__ feats, const int* __restrict__ labels,
                unsigned long long* __restrict__ out, int n, int t, int e,
                int j_tiles, int splits) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ int hist[HIST];

  const int tid = threadIdx.x;
  for (int b = tid; b < HIST; b += THREADS) hist[b] = 0;

  const int tx = tid % TPC;        // column group within the tile
  const int ty = tid / TPC;        // row group within the tile
  const int i0 = blockIdx.x * BM;

  // j-tile jt holds a pair with j > i for some i of this block iff
  // jt * BN + BN - 1 > i0, i.e. jt >= blockIdx.x (square tiles)
  const long long span = j_tiles - blockIdx.x;
  const int jt_begin = blockIdx.x + (int)(span * blockIdx.y / splits);
  const int jt_end = blockIdx.x + (int)(span * (blockIdx.y + 1) / splits);

  // staging map: thread -> (row, 4 consecutive k) of a BM x BK slice
  const int ld_row = tid / 2;
  const int ld_k = (tid % 2) * 4;
  const int a_row = i0 + ld_row;

  int lab_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i0 + tile_row(ty, i);
    lab_i[i] = row < t ? __ldg(labels + row) : 0;
  }
  __syncthreads();  // hist is zeroed

  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int j0 = jt * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    const int b_row = j0 + ld_row;
    for (int k0 = 0; k0 < e; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + ld_k + q;
        As[ld_k + q][ld_row] =
            (a_row < t && k < e) ? __ldg(feats + (size_t)a_row * e + k) : 0.0f;
        Bs[ld_k + q][ld_row] =
            (b_row < n && k < e) ? __ldg(feats + (size_t)b_row * e + k) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][BM / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // bin and count this tile's pairs: i a target row, j real, i < j
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tile_col(tx, j);
      if (col < n) {
        const int lab_j = __ldg(labels + col);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = i0 + tile_row(ty, i);
          if (row < t && row < col)
            atomicAdd(&hist[2 * bin_of(acc[i][j]) + (lab_i[i] != lab_j)], 1);
        }
      }
    }
  }

  __syncthreads();
  for (int b = tid; b < HIST; b += THREADS) {
    const int c = hist[b];
    if (c != 0) atomicAdd(out + b, static_cast<unsigned long long>(c));
  }
}

}  // namespace

extern "C" int fedfr_roc_hist(const float* feats, const int* labels,
                              unsigned long long* out, int n, int t, int e,
                              int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && t > 0 && splits > 0) {
    const int i_tiles = (t + BM - 1) / BM;
    const int j_tiles = (n + BN - 1) / BN;
    const dim3 grid(i_tiles, splits);
    roc_hist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, labels, out, n, t, e, j_tiles, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
