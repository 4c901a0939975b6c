// Hard-negative mining kernel: out[p] = max_l <bf16(public[p]), bf16(local[l])>,
// products summed in fp32 on the tensor cores.
//
// Replaces the TPU kernel fedfr_tpu/ops/pallas_kernels.py::_max_sim_kernel
// (pallas_kernels.py:31-46; launched by _max_sim_padded, wrapped by
// max_cosine_similarity), which feature-based hard-negative mining runs once
// per sampled client per round (Client.select_hard_negatives ->
// embed.max_similarity).
//
// Precision.  The TPU kernel runs one bf16 MXU pass with fp32 accumulation
// (DEFAULT precision): mining cuts at a heuristic 0.4 and its features come
// out of a bf16 trunk (DESIGN.md deviation 6).  This kernel computes the same
// function: operands rounded to bf16 (round to nearest even, by the
// wrapper), every product exact in fp32, sums in fp32 in the tensor cores'
// order.  The CPU path of the wrapper stays fp32, as the JAX package's
// non-TPU path does.
//
// What bounds it on an H100.  At the reference shape (420,671 public x 6,500
// local x 512) it does 2 * 420,671 * 6,500 * 512 = 2.80e12 operations: 2.83
// ms at 989 TFLOP/s of dense bf16, against 0.13 ms to read its 0.44 GB of
// bf16 operands from HBM.  So it is bound by operations.  But every block
// rereads the whole local set from L2: 3,287 blocks x 6.66 MB = 21.9 GB, which
// at a few TB/s of L2 may cost more than the tensor work.  A cluster of two
// blocks along the public axis with TMA multicast of the local chunks would
// halve that; it is not done here.
//
// Design.  A Pallas grid runs in order, so the TPU kernel carries each public
// tile's running max across the local-tile axis in its output block.  CUDA
// blocks run in parallel, so here each block owns BM = 128 public rows and
// loops over ALL local tiles itself.  Three warpgroups:
//   * warpgroup 0, the producer: one thread issues TMA loads.  First the
//     block's public tile (BM x E bf16, at most 128 KB), which stays resident
//     in shared memory; then, for every local tile of BN = 128 rows, its
//     BK = 64-wide K-chunks (16 KB each) through a ring of STAGES buffers,
//     each guarded by a "full" mbarrier (TMA bytes landed) and an "empty"
//     one (both consumers done with it).  Every box is 64 bf16 = 128 bytes
//     wide, stored with the 128-byte swizzle that wgmma reads.
//   * warpgroups 1 and 2, the consumers: each owns 64 public rows.  Per
//     K-chunk it issues four wgmma.mma_async m64n128k16 (bf16 x bf16 -> fp32,
//     both operands described in shared memory) into 64 fp32 accumulators a
//     thread, keeping one chunk's wgmma group in flight while it waits for
//     the next chunk.  After a local tile's last chunk it waits for the
//     group and folds the accumulators into two running row maxima (each
//     thread holds two rows x 32 columns of the 64 x 128 tile).
//   * after the last local tile the four lanes that share a row reduce their
//     maxima with warp shuffles, and one lane writes each row once.
// The similarity matrix never leaves registers; there are no atomics and no
// second pass.  Ragged edges: TMA fills rows past either edge with zeros.
// Public rows past the edge are computed and never stored.  Local columns
// past n_loc are masked out of the max, since a zero row would inject
// sim = 0 into it (the TPU wrapper pads with copies of row 0 instead).  The
// width must be a multiple of 64 (the wrapper pads with zero columns, which
// add nothing to a dot) and at most 512 (the resident public tile).
//
// Interface: a plain C function (built with nvcc into a shared library and
// called through ctypes) that encodes the two TMA tensor maps, launches on
// the caller's stream on `device`, does not synchronise, leaves the caller's
// current device as it found it, and returns cudaGetLastError(), or a
// negative code of its own (see below).  The tensor maps are encoded
// with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// so the build needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // public rows per block (64 per consumer)
constexpr int BN = 128;            // local rows per tile: the wgmma N
constexpr int BK = 64;             // K-chunk: 64 bf16 = one 128-byte swizzle row
constexpr int WK = 16;             // K of one wgmma
constexpr int STAGES = 4;          // ring of local K-chunks
constexpr int MAX_WIDTH = 512;     // resident public tile: BM x 512 bf16 = 128 KB
constexpr int THREADS = 384;       // producer + two consumer warpgroups
constexpr uint32_t CHUNK_BYTES = BN * BK * 2;  // 16 KB, also BM x BK
constexpr uint32_t ROW_BYTES = BK * 2;         // 128

static_assert(BM == BN, "one TMA box shape serves both operands");
static_assert(BM == 2 * 64, "each consumer warpgroup owns 64 rows");

// own error codes, beside cudaError_t's non-negative ones
constexpr int ERR_NO_ENCODER = -1;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;       // cuTensorMapEncodeTiled refused a map
constexpr int ERR_WIDTH = -3;        // width not a multiple of 64 in [64, 512]

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the phase of the given parity has completed.  A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box (BK columns x 128 rows) at (col, row) into shared memory;
// its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile stored with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart.  Moving along
// K inside the 128-byte row is a plain offset of the start address (the
// swizzle is a function of the address bits, and every chunk is 1,024-byte
// aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)  // start address
         | (static_cast<uint64_t>(1) << 16)           // leading offset (unused)
         | (static_cast<uint64_t>(1024 >> 4) << 32)   // stride: 8 rows x 128 B
         | (static_cast<uint64_t>(1) << 62);          // 128-byte swizzle
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                            \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) = a (64 x 16, bf16) * b (128 x 16, bf16)^T [+ d]
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, uint32_t accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef ACC8

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
max_sim_kernel(const __grid_constant__ CUtensorMap pub_map,
               const __grid_constant__ CUtensorMap loc_map,
               float* __restrict__ out, int n_pub, int n_loc, int kc) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align every buffer to it
  const uint32_t pub_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // kc chunks
  const uint32_t ring_s = pub_s + kc * CHUNK_BYTES;              // STAGES chunks
  const uint32_t pub_bar = ring_s + STAGES * CHUNK_BYTES;
  const uint32_t full_bar = pub_bar + 8;                         // STAGES of them
  const uint32_t empty_bar = full_bar + 8 * STAGES;              // STAGES of them

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BM;
  const int n_chunks = (n_loc + BN - 1) / BN * kc;

  if (tid == 0) {
    mbar_init(pub_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load
    if (tid == 0) {
      mbar_arrive_expect_tx(pub_bar, kc * CHUNK_BYTES);
      for (int c = 0; c < kc; ++c)
        tma_load(pub_s + c * CHUNK_BYTES, &pub_map, pub_bar, c * BK, p0);
      int s = 0, c = 0, l0 = 0;
      uint32_t parity = 0;
      for (int i = 0; i < n_chunks; ++i) {
        mbar_wait(empty_bar + 8 * s, parity ^ 1);
        mbar_arrive_expect_tx(full_bar + 8 * s, CHUNK_BYTES);
        tma_load(ring_s + s * CHUNK_BYTES, &loc_map, full_bar + 8 * s, c * BK, l0);
        if (++c == kc) { c = 0; l0 += BN; }
        if (++s == STAGES) { s = 0; parity ^= 1; }
      }
    }
    return;
  }

  // ---- consumer warpgroups 1 and 2: rows (wg - 1) * 64 .. + 63 of the tile
  const int wg_row = (tid / 128 - 1) * 64;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const uint32_t a_s = pub_s + wg_row * ROW_BYTES;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float max_lo = -CUDART_INF_F;  // row wg_row + warp * 16 + lane / 4
  float max_hi = -CUDART_INF_F;  // the row 8 below it

  mbar_wait(pub_bar, 0);
  int s = 0, prev = 0;
  uint32_t parity = 0;
  for (int l0 = 0; l0 < n_loc; l0 += BN) {
    for (int c = 0; c < kc; ++c) {
      mbar_wait(full_bar + 8 * s, parity);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / WK; ++k)
        wgmma_m64n128k16(acc, sw128_desc(a_s + c * CHUNK_BYTES + k * WK * 2),
                         sw128_desc(ring_s + s * CHUNK_BYTES + k * WK * 2),
                         (c > 0 || k > 0) ? 1u : 0u);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      if (c > 0) {
        // the previous chunk's group is done: hand its buffer back
        wgmma_wait<1>();
        mbar_arrive(empty_bar + 8 * prev);
      }
      prev = s;
      if (++s == STAGES) { s = 0; parity ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty_bar + 8 * prev);

    // fold the tile: d[4j + {0,1}] is (lo row, column 8j + 2 (lane % 4) +
    // {0,1}), d[4j + {2,3}] the same columns of the hi row
    const int valid = n_loc - l0;
    if (valid >= BN) {
#pragma unroll
      for (int j = 0; j < 64; j += 4) {
        max_lo = fmaxf(max_lo, fmaxf(acc[j], acc[j + 1]));
        max_hi = fmaxf(max_hi, fmaxf(acc[j + 2], acc[j + 3]));
      }
    } else {
      const int col0 = 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 64; j += 4) {
        const int col = 2 * j + col0;  // 8 * (j / 4) + col0
        if (col < valid) {
          max_lo = fmaxf(max_lo, acc[j]);
          max_hi = fmaxf(max_hi, acc[j + 2]);
        }
        if (col + 1 < valid) {
          max_lo = fmaxf(max_lo, acc[j + 1]);
          max_hi = fmaxf(max_hi, acc[j + 3]);
        }
      }
    }
  }

  // the four lanes of a quad hold the same two rows
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    max_lo = fmaxf(max_lo, __shfl_xor_sync(0xffffffffu, max_lo, off));
    max_hi = fmaxf(max_hi, __shfl_xor_sync(0xffffffffu, max_hi, off));
  }
  if (lane % 4 == 0) {
    const int row = p0 + wg_row + warp * 16 + lane / 4;
    if (row < n_pub) out[row] = max_lo;
    if (row + 8 < n_pub) out[row + 8] = max_hi;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, width) row-major bf16 at ptr, read in boxes of BK columns x 128 rows
// with the 128-byte swizzle; rows past the edge read as zeros.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows,
                int width) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * 2};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// pub (n_pub, width) and loc (n_loc, width): bf16, row-major, 16-byte
// aligned; width a multiple of 64 in [64, 512]; n_loc >= 1.  out: n_pub fp32.
extern "C" int fedfr_max_sim(const void* pub, const void* loc, float* out,
                             int n_pub, int n_loc, int width, int device,
                             void* stream) {
  if (width % BK != 0 || width < BK || width > MAX_WIDTH) return ERR_WIDTH;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pub == 0) return 0;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap pub_map, loc_map;
  if (!encode_map(encode, &pub_map, pub, n_pub, width) ||
      !encode_map(encode, &loc_map, loc, n_loc, width))
    return ERR_ENCODE;
  const int kc = width / BK;
  const size_t smem = 1024 + (kc + STAGES) * CHUNK_BYTES + 8 * (1 + 2 * STAGES);
  err = cudaFuncSetAttribute(max_sim_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  max_sim_kernel<<<(n_pub + BM - 1) / BM, THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(pub_map, loc_map, out,
                                                        n_pub, n_loc, kc);
  return static_cast<int>(cudaGetLastError());
}
