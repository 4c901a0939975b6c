// All-pairs cosine ROC histogram: the per-client 1:1 verification kernel.
//
// Replaces the TPU kernel fedfr_tpu/ops/pallas_kernels.py::_roc_hist_kernel
// (pallas_kernels.py:93; launched by roc_histogram_pair, wrapped by
// roc_histogram), which the per-round personalized 1:1 eval runs once per
// candidate client (LocalVerificationCallback.veri_test -> client_roc ->
// pairwise_roc_histogram).
//
// What it computes.  feats (N, E) fp32 with the T target rows first, labels
// (N,) int32.  For every pair i < T, j0 <= j < j1, i < j (global row
// indices, the counterpart of roc_histogram_pair's gi/gj operands):
//     sim = <feats[i], feats[j]>            IEEE fp32 fmaf, summed in k order
//     bin = clamp((int)((sim + 1) * 1000), 0, 2000)   two rounded steps,
//                                                      truncated toward zero
//     out[2 * bin + (labels[i] != labels[j])] += 1
// out is the interleaved [pos, neg] histogram of 2 x 2001 int64 counts.
// [j0, j1) = [0, N) is the whole histogram; a mesh gives each device a
// contiguous j-range of its own (ops/roc_histogram.py::
// pairwise_roc_histogram_sharded), and since each pair's sum is the same
// fmaf chain wherever its rows lie, the ranges' histograms add up bit for
// bit to the whole.  The kernel reads the features K-major: featsT (E_pad,
// n_cols), the wrapper's zero-padded transposed copy of the T target rows
// (columns 0..) and of the range's rows (columns b_col.., b_col past the
// targets' padding): featsT[k][c] = feats[row of column c][k].  It holds the
// targets and the range only, not all N rows.  Zero columns past E add
// exact zeros at the end of each sum; rows past the range and T are masked,
// so padding changes no count.
//
// What bounds it on an H100.  2 * E FFMA-operations per pair on the SIMT
// cores (TF32 tensor cores would move pairs by about one bin): at the
// reference shape (T = 4,000 of N = 160,000, E = 512) that is 631,998,000
// pairs, 6.47e11 operations, 9.66 ms at 67 TFLOP/s of fp32, against 0.1 ms
// to read the 328 MB of features from HBM.  So it is bound by operations,
// and the design's work is to keep the FFMA pipes issuing.
//
// Design.  The TPU kernel counts each tile with a radix one-hot matmul in
// VMEM and carries the count block across its sequential grid.  CUDA blocks
// run in parallel, so here:
//   * block (x, y) owns BM target rows (x) and a contiguous range of BN-row
//     j-tiles of the j-range (y); j-tiles wholly at or below the diagonal
//     are skipped and the i < j guard applies inside the tile.  The wrapper
//     sizes the split from the kernel's own occupancy
//     (fedfr_roc_hist_config) and the range's own j-tiles, so that the grid
//     is one wave: a second, partial wave nearly doubles the time;
//   * staging: the block walks its (j-tile, K-slice) sequence as one stream
//     through a ring of STAGES shared-memory buffers.  Each buffer holds
//     one BK-wide K-slice of the target tile and of the j-tile, already in
//     the [k][row] layout the inner loop reads, copied by 16-byte
//     cp.async.cg (each warp one contiguous 512-byte run of a featsT row,
//     no register round trip).  STAGES - 1 slices are in flight while one
//     is computed, across j-tile boundaries and under the epilogue, with
//     one __syncthreads per slice;
//   * reuse: the target tile is re-read from L2 for every j-tile (it does
//     not fit in shared memory at E = 512); 32 KB per 128 x 128 x 32 slice
//     is ~8 bytes per SM clock, well inside L2's rate.  Measured on the
//     H100, a 128 x 256 tile (512 threads, one block per SM), which halves
//     those rereads, was no faster, nor were 16-wide slices in 4 stages or
//     a 2-stage ring (PERF.md), so the tile and the ring are fixed;
//   * each thread keeps an 8 x 8 micro-tile of dot products in registers
//     (two 4-wide halves BM/2 and BN/2 apart, so that its row group reads
//     consecutive float4s: 4 shared loads feed 64 FFMAs);
//   * each pair is binned in registers and counted with a shared-memory
//     atomicAdd into the block's private 4,002 x int32 histogram (16 KB):
//     the reference's own atomics design (roc_cuda.py:26-28), made
//     hierarchical.  Scores clustered in a few bins took -1.5% to +1.6% of
//     the spread scores' time on the H100 (64 atomics per 32,768 FFMA a
//     thread and tile), so same-bin counts are not aggregated within a warp
//     first;
//   * the block flushes once, with a 64-bit global atomicAdd per non-zero bin.
// A block's int32 counters hold at most BM x (the range's rows, padded)
// pairs; the wrapper keeps that below 2^31.  Dynamic shared memory: STAGES x 32,768 B of ring +
// 16,008 B of histogram + 512 B of the block's labels = 114,824 B, so 2
// blocks per SM, as the 128 registers a thread that __launch_bounds__
// allows.
//
// Interface: plain C functions (built with nvcc into a shared library and
// called through ctypes).  fedfr_roc_hist_config reports the tile sizes and
// how many blocks of the kernel, as built, fit on one SM.  fedfr_roc_hist
// launches on the caller's stream on `device`, does not synchronise, and
// returns cudaGetLastError().  Both leave the caller's current device as
// they found it.  The caller zeroes `out`.

#include <cuda_runtime.h>

namespace {

constexpr int BINS = 2001;         // int((cos + 1) * 1000) for cos in [-1, 1]
constexpr int HIST = 2 * BINS;     // interleaved [pos, neg]
constexpr int BM = 128;            // target rows per block tile
constexpr int BN = 128;            // j rows per block tile
constexpr int BK = 32;             // K-slice per ring stage
constexpr int STAGES = 3;          // ring depth: STAGES - 1 slices in flight
constexpr int TM = 8;              // micro-tile rows per thread
constexpr int TN = 8;              // micro-tile cols per thread
constexpr int TPC = BN / TN;       // threads across one row of the tile
constexpr int THREADS = (BM / TM) * TPC;
constexpr int MIN_BLOCKS = 512 / THREADS;  // caps registers at 128 a thread
constexpr int A_FLOATS = BK * BM;  // one stage: [BK][BM] targets, then
constexpr int B_FLOATS = BK * BN;  //            [BK][BN] j-rows
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int SMEM_BYTES = (STAGES * STAGE_FLOATS + HIST + BM) * 4;

static_assert(TM == 8 && TN == 8, "micro-tiles are two 4-wide halves");
static_assert(A_FLOATS % (4 * THREADS) == 0 && B_FLOATS % (4 * THREADS) == 0,
              "each thread copies whole 16-byte vectors of each operand");
static_assert(BM % 128 == 0 && BN % 128 == 0,
              "a warp copies a contiguous 512-byte run of one featsT row");

// rows / cols of a thread: two 4-wide halves BM/2 (BN/2) apart, so that the
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copies of K-slice k0 of the target tile (featsT columns a0..)
// and of the j-tile (columns b0..) into one ring stage.  Vector v of an
// operand is row v / (cols / 4), float4 v % (cols / 4) of its [BK][cols]
// slice, so that consecutive threads copy consecutive 16 bytes.
__device__ __forceinline__ void load_slice(float* stage,
                                           const float* __restrict__ featsT,
                                           int n_cols, int a0, int b0, int k0,
                                           int tid) {
#pragma unroll
  for (int q = 0; q < A_FLOATS / (4 * THREADS); ++q) {
    const int v = q * THREADS + tid;
    const int r = v / (BM / 4), c = (v % (BM / 4)) * 4;
    cp_async16(stage + r * BM + c, featsT + (size_t)(k0 + r) * n_cols + a0 + c);
  }
#pragma unroll
  for (int q = 0; q < B_FLOATS / (4 * THREADS); ++q) {
    const int v = q * THREADS + tid;
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    cp_async16(stage + A_FLOATS + r * BN + c,
               featsT + (size_t)(k0 + r) * n_cols + b0 + c);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
roc_hist_kernel(const float* __restrict__ featsT,
                const int* __restrict__ labels_i, const int* __restrict__ labels_j,
                unsigned long long* __restrict__ out, int t, int m, int j0,
                int b_col, int n_cols, int k_slices, int j_tiles, int splits) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  int* hist = reinterpret_cast<int*>(smem + STAGES * STAGE_FLOATS);
  int* lab_i = hist + HIST;

  const int tid = threadIdx.x;
  const int tx = tid % TPC;        // column group within the tile
  const int ty = tid / TPC;        // row group within the tile
  const int i0 = blockIdx.x * BM;

  for (int b = tid; b < HIST; b += THREADS) hist[b] = 0;
  for (int r = tid; r < BM; r += THREADS)
    lab_i[r] = i0 + r < t ? __ldg(labels_i + i0 + r) : 0;

  // j-tile jt (the range's rows jt * BN.., global j0 + jt * BN..) holds a
  // pair with j > i for some i >= i0 of this block iff
  // j0 + jt * BN + BN - 1 > i0
  const long long d = (long long)i0 - j0 - BN + 1;
  const long long jt_first = d < 0 ? 0 : d / BN + 1;
  const long long span = jt_first < j_tiles ? j_tiles - jt_first : 0;
  const int jt_begin = (int)(jt_first + span * blockIdx.y / splits);
  const int jt_end = (int)(jt_first + span * (blockIdx.y + 1) / splits);
  const int steps = (jt_end - jt_begin) * k_slices;

  // the producer side of the ring: the next (j-tile, K-slice) to copy
  int ld_jt = jt_begin, ld_ks = 0, ld_stage = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      load_slice(ring + ld_stage * STAGE_FLOATS, featsT, n_cols, i0,
                 b_col + ld_jt * BN, ld_ks * BK, tid);
      if (++ld_ks == k_slices) { ld_ks = 0; ++ld_jt; }
      ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  int jt = jt_begin, ks = 0, rd_stage = 0;
  for (int step = 0; step < steps; ++step) {
    // this thread's copies of slice `step` have landed; the barrier makes
    // everyone's visible and frees the stage that slice step - 1 used
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (step + STAGES - 1 < steps) {
      load_slice(ring + ld_stage * STAGE_FLOATS, featsT, n_cols, i0,
                 b_col + ld_jt * BN, ld_ks * BK, tid);
      if (++ld_ks == k_slices) { ld_ks = 0; ++ld_jt; }
      ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
    }
    cp_async_commit();

    const float* as = ring + rd_stage * STAGE_FLOATS;
    const float* bs = as + A_FLOATS;
    rd_stage = rd_stage + 1 == STAGES ? 0 : rd_stage + 1;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * BM + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * BN + BN / 2 + tx * 4);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (++ks < k_slices) continue;

    // the j-tile is complete: bin and count its pairs (i a target row, j
    // in the range, i < j) while the next tile's first slices are in flight
    const int r0 = jt * BN;
    int li[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) li[i] = lab_i[tile_row(ty, i)];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = r0 + tile_col(tx, j);
      if (r < m) {
        const int lab_j = __ldg(labels_j + r);
        const int col = j0 + r;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = i0 + tile_row(ty, i);
          if (row < t && row < col)
            atomicAdd(&hist[2 * bin_of(acc[i][j]) + (li[i] != lab_j)], 1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    ks = 0;
    ++jt;
  }

  __syncthreads();
  for (int b = tid; b < HIST; b += THREADS) {
    const int c = hist[b];
    if (c != 0) atomicAdd(out + b, static_cast<unsigned long long>(c));
  }
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(roc_hist_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

// Makes `device` current for a launch and gives the caller its own current
// device back on every return path: PyTorch reads the thread's current
// device for every allocation and synchronize that names no index.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : err_(cudaGetDevice(&prev_)) {
    if (err_ != cudaSuccess) {
      prev_ = -1;
      return;
    }
    if (prev_ != device) err_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

}  // namespace

// cfg <- {BM, BN, BK, blocks of the kernel that fit on one SM, threads per
// block, dynamic shared memory bytes per block}
extern "C" int fedfr_roc_hist_config(int device, int* cfg) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err == cudaSuccess) err = allow_smem();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, roc_hist_kernel,
                                                        THREADS, SMEM_BYTES);
  cfg[0] = BM; cfg[1] = BN; cfg[2] = BK;
  cfg[3] = blocks; cfg[4] = THREADS; cfg[5] = SMEM_BYTES;
  return static_cast<int>(err);
}

// The pairs i < t, j0 <= j < j0 + m, i < j.  featsT (e_pad, n_cols): the t
// targets in columns 0.., the range's m rows in columns b_col..; n_cols and
// b_col multiples of BN, e_pad a positive multiple of BK (an E = 0 input
// still needs one slice of zeros), zero-padded.  labels_i: the t targets'
// labels; labels_j: the range's m labels.
extern "C" int fedfr_roc_hist(const float* featsT, const int* labels_i,
                              const int* labels_j, unsigned long long* out,
                              int t, int m, int j0, int b_col, int n_cols,
                              int e_pad, int splits, int device, void* stream) {
  const long long a_cols = (t + BM - 1) / BM * (long long)BM;
  const long long b_cols = (m + BN - 1) / BN * (long long)BN;
  if (n_cols % BN != 0 || b_col % BN != 0 || e_pad % BK != 0 || e_pad < BK ||
      t < 0 || m < 0 || j0 < 0 || a_cols > n_cols || b_col + b_cols > n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err == cudaSuccess) err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0 && t > 0 && splits > 0) {
    const dim3 grid((t + BM - 1) / BM, splits);
    roc_hist_kernel<<<grid, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
        featsT, labels_i, labels_j, out, t, m, j0, b_col, n_cols, e_pad / BK,
        (m + BN - 1) / BN, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
