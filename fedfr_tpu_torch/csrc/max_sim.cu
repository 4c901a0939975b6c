// Hard-negative mining kernel: out[p] = max_l <public[p], local[l]>.
//
// Replaces the TPU kernel fedfr_tpu/ops/pallas_kernels.py::_max_sim_kernel
// (launched by _max_sim_padded, wrapped by max_cosine_similarity), which
// feature-based hard-negative mining runs once per sampled client per round
// (Client.select_hard_negatives -> embed.max_similarity).
//
// What bounds it on an H100.  This version takes fp32 operands and
// accumulates with fp32 FFMA on the SIMT cores, so it is bound by FFMA
// throughput: at the reference shape (420,671 public x 6,500 local x 512)
// it does 2 * 420,671 * 6,500 * 512 = 2.80e12 operations, 42 ms at the
// H100 SXM's 67 TFLOP/s of non-tensor fp32, against 2.8 ms for the same
// work in bf16 on the tensor cores and 0.26 ms to read its 0.88 GB from HBM.
// A bf16 wgmma/TMA version (the TPU kernel's own precision) is later work.
//
// Design.  A Pallas grid runs in order, so the TPU kernel carries each
// public tile's running max across the local-tile axis in its output block.
// CUDA blocks run in parallel, so here each block owns one tile of BM public
// rows and loops over ALL local tiles itself:
//   * per local tile, K-slices of both tiles are staged in shared memory
//     (transposed, so a thread reads its rows and columns as float4s);
//   * each thread keeps a TM x TN micro-tile of fp32 dot products in
//     registers (16 FFMA per 4 shared loads) and, once a local tile's dot
//     products are complete, folds them into a running max per row;
//   * after the last local tile the TPR threads that share a row reduce
//     their maxima with warp shuffles, and one thread writes each row once.
// The similarity matrix never leaves registers; there are no atomics, no
// second pass and no padding copies.  Ragged edges are masked: loads past
// an edge read 0, the max starts at -inf, and only real local rows enter it
// (the TPU wrapper's "local pad rows repeat row 0" contract).  Public rows
// past the edge are computed and never stored.
//
// Interface: a plain C function (built with nvcc into a shared library and
// called through ctypes) that launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 128;            // public rows per block
constexpr int BN = 128;            // local rows per tile
constexpr int BK = 8;              // K-slice staged in shared memory
constexpr int TM = 8;              // micro-tile rows per thread
constexpr int TN = 8;              // micro-tile cols per thread
constexpr int TPC = BN / TN;       // 16 threads share one row of the block
constexpr int THREADS = (BM / TM) * TPC;  // 256
constexpr int PAD = 4;             // keeps float4 alignment of each k-row

static_assert(THREADS == 256, "tiling assumes 256 threads");
static_assert(BM * BK == THREADS * 4 && BN * BK == THREADS * 4,
              "each thread stages 4 elements of each operand per K-slice");
static_assert(TPC == 16, "row reduction shuffles within 16 lanes");

__global__ void __launch_bounds__(THREADS, 2)
max_sim_kernel(const float* __restrict__ pub, const float* __restrict__ loc,
               float* __restrict__ out, int n_pub, int n_loc, int e) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % TPC;        // column group within the tile
  const int ty = tid / TPC;        // row group within the tile
  const int p0 = blockIdx.x * BM;

  // staging map: thread -> (row, 4 consecutive k) of a BM x BK slice
  const int ld_row = tid / 2;
  const int ld_k = (tid % 2) * 4;
  const int a_row = p0 + ld_row;

  // this thread's rows/cols: two 4-wide halves 64 apart, so that the 16
  // threads of a row group read consecutive float4s from shared memory
  float row_max[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) row_max[i] = -CUDART_INF_F;

  for (int l0 = 0; l0 < n_loc; l0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    const int b_row = l0 + ld_row;
    for (int k0 = 0; k0 < e; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + ld_k + q;
        As[ld_k + q][ld_row] =
            (a_row < n_pub && k < e) ? __ldg(pub + (size_t)a_row * e + k) : 0.0f;
        Bs[ld_k + q][ld_row] =
            (b_row < n_loc && k < e) ? __ldg(loc + (size_t)b_row * e + k) : 0.0f;
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

    // fold this local tile into the running row max, real local rows only
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = l0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (col < n_loc) {
#pragma unroll
        for (int i = 0; i < TM; ++i) row_max[i] = fmaxf(row_max[i], acc[i][j]);
      }
    }
  }

  // the 16 threads of a row group are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m = row_max[i];
#pragma unroll
    for (int off = TPC / 2; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    row_max[i] = m;
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = p0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
      if (row < n_pub) out[row] = row_max[i];
    }
  }
}

}  // namespace

extern "C" int fedfr_max_sim(const float* pub, const float* loc, float* out,
                             int n_pub, int n_loc, int e, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pub > 0) {
    const dim3 grid((n_pub + BM - 1) / BM);
    max_sim_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        pub, loc, out, n_pub, n_loc, e);
  }
  return static_cast<int>(cudaGetLastError());
}
