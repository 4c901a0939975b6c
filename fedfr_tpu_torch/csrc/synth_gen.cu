// The synth: image generator: (B, size, size, 3) uint8 NHWC images from a
// (B,) key vector, byte for byte the images of the JAX package's jitted
// generator.
//
// Replaces fedfr_tpu/data/synthetic.py::_make_generator (its `gen`,
// synthetic.py:83-141), which XLA fuses into one program on the TPU; it is
// not a Pallas kernel.  Every synth: batch of the round (the public embed,
// mining's local embed, the combined training batches, the local-eval veri
// embeds) is one launch.  The plain PyTorch version and the statement of the
// function are in ops/synth_gen.py; the PRNG is JAX's threefry2x32 with the
// partitionable bit layout (ops/threefry.py).
//
// What bounds it on an H100.  Each output byte costs two threefry2x32 hashes
// (one per split key of its noise draw: 20 rounds of add, rotate, xor plus 5
// key injections, 72 instructions each at least) and JAX's uint32 randint
// arithmetic (three remainders by the span): ~157 instructions a byte
// against one byte written.  So it is bound by instruction issue (132 SMs x
// 128 lanes x 1.98 GHz = 33.5 T/s), not by the bytes (3.35 TB/s): 0.0904 ms
// against 0.006 ms for a 512-image batch at 112x112 (chip_smoke.py,
// synth_bound_ms, counts the instructions).
//
// Design, for Hopper (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W:
// 0.0794-0.0838 ms per 256 images and 0.1468-0.1506 per 512, 0.54-0.57 and
// 0.60-0.62 of the bound; the one-block-an-image kernel with divisions in
// its byte loop took 0.2435 per 512; PERF.md gives each lever's figure):
// - The byte loop divides by nothing known only at run time.  The noise's
//   three remainders by its span 2 * noise + 1 are one 64-bit multiply-add
//   and a shift each, exact for every uint32 numerator (FastMod; the host
//   computes the magic numbers once, ops/synth_gen.py::fastmod_magic).
// - A thread owns runs of RUN = 4 consecutive output bytes of one row.  Per
//   run it finds its pre-roll row ys and byte bs (the roll moves a row's
//   bytes by 3 dx, and pre-roll byte bs of row ys draws its noise at flat
//   index ys * 3 S + bs), steps bs with a compare-and-wrap, takes the
//   template's row and column from two small shared tables, and stores the
//   run as one 4-byte word.  The run's 8 hashes are independent chains,
//   which hides the add-rotate-xor latency.  Sizes whose rows are not a
//   multiple of RUN bytes take the same kernel with runs of one byte.
// - One wave of equal chunks: the batch's runs, flat over images, are cut
//   into as many chunks of whole warps as the card holds blocks at once
//   (the kernel's own occupancy query), one a block, so the card fills at
//   every batch size, ragged ones included.  A chunk spans at most KMAX
//   images.
// - The block computes its chunk's image constants once, at its start,
//   into shared memory, the per-template work hoisted: fold_in(master, g)
//   and randint's split keys once per template (gid, bgid and, under expr
//   > 0, the distractor); then one thread a template value (block x block
//   x 3 of them) draws and blends it, and one thread each draws an image's
//   scalars (contrast scale, brightness offset, roll dy and dx, the noise's
//   split keys, the distractor's weight and id).  No barrier or prologue
//   interrupts the byte loop.  Templates of more than 48 KB in all (block
//   32 and up) take the SM's opted-in shared memory.
// What binds now: the loop's SASS holds ~180.5 instructions a byte, 108.8 on
// the 64-lane ALU pipe (the hashes' 40 rotations and 42 xors among them) and
// 67.8 IMADs on the FMA pipe, and runs at ~0.83 of the ALU pipe's rate.
//
// Numbers.  JAX computes each float op rounded on its own in this order; a
// fused multiply-add would round once and can move a pixel across an integer
// boundary, so every float op here is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts.  The uint32 arithmetic wraps as
// JAX's does (randint's multiplier ((2^16 % span)^2) % span is 0 for the
// distractor's span 2^30 - 2^26).
//
// Interface: plain C functions (built with nvcc into a shared library and
// called through ctypes): the launch runs on the caller's stream on
// `device`, does not synchronise, and returns cudaGetLastError(); both calls
// leave the caller's current device as they found it; the config call reports the
// run length, occupancy and registers the wrapper sizes the grid from.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 4;  // bytes a thread owns per run: one 4-byte store
constexpr int32_t TEMPLATE_LO = 30, TEMPLATE_HI = 226;
constexpr int32_t DISTRACTOR_LO = 1 << 26, DISTRACTOR_HI = 1 << 30;
constexpr int32_t OFFSET_LO = -20, OFFSET_HI = 21;
constexpr uint32_t DSEED_BASE = 1u << 30;
constexpr int N_SCALAR_THREADS = 7;  // scale, offset, dy, dx, noise keys, u, dgid
constexpr int KMAX = 4;              // images a block's chunk may span

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ Key threefry2x32(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks0 = k.a, ks1 = k.b, ks2 = k.a ^ k.b ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
#define FEDFR_ROUND(r) { x0 += x1; x1 = rotl(x1, r); x1 ^= x0; }
#define FEDFR_ROUNDS_A FEDFR_ROUND(13) FEDFR_ROUND(15) FEDFR_ROUND(26) FEDFR_ROUND(6)
#define FEDFR_ROUNDS_B FEDFR_ROUND(17) FEDFR_ROUND(29) FEDFR_ROUND(16) FEDFR_ROUND(24)
  FEDFR_ROUNDS_A
  x0 += ks1; x1 += ks2 + 1u;
  FEDFR_ROUNDS_B
  x0 += ks2; x1 += ks0 + 2u;
  FEDFR_ROUNDS_A
  x0 += ks0; x1 += ks1 + 3u;
  FEDFR_ROUNDS_B
  x0 += ks1; x1 += ks2 + 4u;
  FEDFR_ROUNDS_A
  x0 += ks2; x1 += ks0 + 5u;
#undef FEDFR_ROUNDS_B
#undef FEDFR_ROUNDS_A
#undef FEDFR_ROUND
  return {x0, x1};
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  return threefry2x32(k, 0u, d);
}

// jax.random.bits(key, shape, uint32) at flat index idx (< 2^32)
__device__ __forceinline__ uint32_t bits32(Key k, uint32_t idx) {
  const Key o = threefry2x32(k, 0u, idx);
  return o.a ^ o.b;
}

// n % d for every uint32 n, without a division: n / d = (n * m + a) >> (32
// + l), one 64-bit multiply-add and a shift (Granlund and Montgomery 1994,
// theorem 4.2, with m rounded up and a = 0, or Robison 2005, with m rounded
// down and a = m, whichever is exact for d; ops/synth_gen.py::fastmod_magic)
struct FastMod {
  uint32_t d, m, a, l;
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    const uint32_t q = (uint32_t)(((uint64_t)n * m + a) >> 32) >> l;
    return n - q * d;
  }
};

// a remainder off the byte loop (per image or per template value)
struct PlainMod {
  uint32_t d;
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const { return n % d; }
};

// jax.random.randint(key, shape, minval, maxval) for int32: the two split
// keys of its key, and its per-element arithmetic on their bits
struct Split {
  Key k1, k2;
};

__device__ __forceinline__ Split split(Key k) {
  return {threefry2x32(k, 0u, 0u), threefry2x32(k, 0u, 1u)};
}

__host__ __device__ constexpr uint32_t randint_span(int32_t lo, int32_t hi) {
  return hi > lo ? (uint32_t)hi - (uint32_t)lo : 1u;
}

__host__ __device__ constexpr uint32_t randint_mult(uint32_t span) {
  return ((65536u % span) * (65536u % span)) % span;  // wraps, as JAX's does
}

template <typename Mod>
__device__ __forceinline__ int32_t randint_at(const Split& s, uint32_t idx, int32_t minval,
                                              uint32_t mult, const Mod& mod) {
  const uint32_t hi = bits32(s.k1, idx), lo = bits32(s.k2, idx);
  return (int32_t)((uint32_t)minval + mod(mod(hi) * mult + mod(lo)));
}

__device__ __forceinline__ int32_t scalar_int(Key k, int32_t lo, int32_t hi) {
  const uint32_t span = randint_span(lo, hi);
  return randint_at(split(k), 0u, lo, randint_mult(span), PlainMod{span});
}

__device__ __forceinline__ float uniform_at(Key k, uint32_t idx) {
  return __fsub_rn(__uint_as_float((bits32(k, idx) >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float template_value(const Split& s, int i) {
  constexpr uint32_t span = randint_span(TEMPLATE_LO, TEMPLATE_HI);
  return (float)randint_at(s, (uint32_t)i, TEMPLATE_LO, randint_mult(span), PlainMod{span});
}

struct Params {
  const int32_t *keys, *gids, *bgids, *dseeds;
  const float* bw;
  Key master;
  int size, noise, block, shift_div;
  float expr;
  FastMod noise_mod;  // by the noise's span
  long long runs;     // B x the image's runs
  long long chunk;    // runs a block: at most (KMAX - 1) images' worth
  uint8_t* out;
};

// an image's constants, beside its blended template in shared memory
struct Image {
  Split noise;
  float scale, offset, u;
  int32_t dy, dx;
};

size_t smem_bytes(int size, int block) {
  // KMAX templates (floats), then the column and row tables (ints)
  return sizeof(float) * (KMAX * (size_t)block * block * 3 + (size_t)size * 3 + size);
}

// one output byte from its noise draw at flat index idx and its template
// value, in JAX's order of rounded float ops
__device__ __forceinline__ uint32_t pixel(const Split& nk, uint32_t idx, float base,
                                          int32_t nmin, uint32_t nmult, const FastMod& nmod,
                                          float scale, float offset) {
  const float n = (float)randint_at(nk, idx, nmin, nmult, nmod);
  const float v = __fadd_rn(__fmul_rn(__fadd_rn(base, n), scale), offset);
  return __float2uint_rz(fminf(fmaxf(v, 0.0f), 255.0f));
}

template <int R>
__global__ void __launch_bounds__(THREADS) synth_gen_kernel(const Params p) {
  static_assert(R == 1 || R == RUN, "a run is one byte or one 4-byte word");
  extern __shared__ float s_base[];  // KMAX blended templates, block x block x 3 each
  __shared__ Split s_tsplit[KMAX][3];  // T[gid], T[bgid], T[dgid] of each image
  __shared__ Image s_img[KMAX];

  const int size = p.size, block = p.block, rep = size / block;
  const int row_bytes = 3 * size, n_t = block * block * 3;
  // template byte of a pre-roll row byte bs, and template row of a row ys
  int* s_col = reinterpret_cast<int*>(s_base + KMAX * n_t);
  int* s_trow = s_col + row_bytes;
  for (int i = threadIdx.x; i < row_bytes; i += THREADS)
    s_col[i] = (i / 3 / rep) * 3 + i % 3;
  for (int i = threadIdx.x; i < size; i += THREADS) s_trow[i] = (i / rep) * block * 3;

  const int runs_row = row_bytes / R, runs_img = size * runs_row;
  const long long begin = blockIdx.x * p.chunk;
  const long long end = begin + p.chunk < p.runs ? begin + p.chunk : p.runs;
  const int img0 = (int)(begin / runs_img);
  const int n_img = (int)((end - 1) / runs_img) - img0 + 1;  // <= KMAX

  // the constants of the chunk's images: each template's split keys and each
  // image's scalars (16 threads an image), then the template values
  const int t = threadIdx.x, k = t / 16, role = t % 16;
  if (k < n_img && role < 2 + N_SCALAR_THREADS) {
    const int img = img0 + k;
    const int amp = size / p.shift_div;
    if (role < 2) {
      s_tsplit[k][role] = split(fold_in(p.master, (uint32_t)(role == 0 ? p.gids : p.bgids)[img]));
    } else {
      const Key ki = fold_in(fold_in(p.master, DSEED_BASE + (uint32_t)p.dseeds[img]),
                             (uint32_t)p.keys[img]);
      Image& im = s_img[k];
      switch (role - 2) {
        case 0:
          im.scale = __fadd_rn(0.75f, __fmul_rn(0.5f, uniform_at(fold_in(ki, 1u), 0u)));
          break;
        case 1:
          im.offset = (float)scalar_int(fold_in(ki, 2u), OFFSET_LO, OFFSET_HI);
          break;
        case 2:
          im.dy = scalar_int(fold_in(ki, 3u), -amp, amp + 1);
          break;
        case 3:
          im.dx = scalar_int(fold_in(ki, 4u), -amp, amp + 1);
          break;
        case 4:
          im.noise = split(fold_in(ki, 0u));
          break;
        case 5:
          im.u = __fmul_rn(p.expr, uniform_at(fold_in(ki, 5u), 0u));
          break;
        default:
          if (p.expr > 0.0f)
            s_tsplit[k][2] = split(fold_in(p.master, (uint32_t)scalar_int(
                fold_in(ki, 6u), DISTRACTOR_LO, DISTRACTOR_HI)));
      }
    }
  }
  __syncthreads();
  for (int f = t; f < n_img * n_t; f += THREADS) {
    const int kk = f / n_t, i = f - kk * n_t, img = img0 + kk;
    const Split sg = s_tsplit[kk][0], sb = s_tsplit[kk][1];
    const float w = p.bw[img];
    float v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), template_value(sg, i)),
                        __fmul_rn(w, template_value(sb, i)));
    if (p.expr > 0.0f) {
      const float u = s_img[kk].u;
      v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), v),
                    __fmul_rn(u, template_value(s_tsplit[kk][2], i)));
    }
    s_base[f] = v;
  }
  __syncthreads();

  // the byte loop: the chunk's runs, THREADS apart, image after image
  const FastMod nmod = p.noise_mod;
  const uint32_t nmult = randint_mult(nmod.d);
  const int32_t nmin = -p.noise;
  const int step_rows = THREADS / runs_row, step_col = THREADS % runs_row;
  long long q = begin + t;
  for (int kk = 0; kk < n_img; ++kk) {
    const long long img_begin = (long long)(img0 + kk) * runs_img;
    const long long img_end = img_begin + runs_img < end ? img_begin + runs_img : end;
    if (q >= img_end) continue;
    const Image& im = s_img[kk];
    const Split nk = im.noise;
    const float scale = im.scale, offset = im.offset;
    const int dy = im.dy, dxb = 3 * im.dx;
    const float* tmpl = s_base + kk * n_t;
    const int ql = (int)(q - img_begin), n_runs = (int)((img_end - q + THREADS - 1) / THREADS);
    int y = ql / runs_row, col = ql - y * runs_row;
    uint8_t* dst = p.out + (size_t)q * R;
    q += (long long)n_runs * THREADS;
    for (int r = 0; r < n_runs; ++r, dst += THREADS * R) {
      int ys = y - dy;  // |dy| <= size: one wrap at most
      ys += ys < 0 ? size : 0;
      ys -= ys >= size ? size : 0;
      int bs = col * R - dxb;  // |3 dx| <= row_bytes
      bs += bs < 0 ? row_bytes : 0;
      bs -= bs >= row_bytes ? row_bytes : 0;
      const uint32_t row_idx = (uint32_t)(ys * row_bytes);
      const float* trow = tmpl + s_trow[ys];
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int b = bs + j >= row_bytes ? bs + j - row_bytes : bs + j;
        const uint32_t byte = pixel(nk, row_idx + (uint32_t)b, trow[s_col[b]], nmin, nmult,
                                    nmod, scale, offset);
        // byte j of the word from byte 0 of `byte`
        word = j == 0 ? byte : __byte_perm(word, byte, j == 1 ? 0x3240u
                                                     : j == 2 ? 0x3410u : 0x4210u);
      }
      if constexpr (R == RUN)
        *reinterpret_cast<uint32_t*>(dst) = word;
      else
        *dst = (uint8_t)word;
      y += step_rows;
      col += step_col;
      if (col >= runs_row) {
        col -= runs_row;
        ++y;
      }
    }
  }
}

// the run length for an image size: RUN where a row is whole runs, else 1
int run_for(int size) { return (3 * size) % RUN == 0 ? RUN : 1; }

// lets the kernel take `smem` dynamic shared bytes, above the default 48 KB
// where the SM opts them in; fails where it cannot
template <int R>
cudaError_t fit_smem(int device, size_t smem) {
  int optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, synth_gen_kernel<R>);
  if (err != cudaSuccess) return err;
  if (smem + attr.sharedSizeBytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(synth_gen_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int R>
cudaError_t occupancy(int device, size_t smem, int* cfg) {
  int blocks = 0, sms = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = fit_smem<R>(device, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, synth_gen_kernel<R>, THREADS,
                                                        smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, synth_gen_kernel<R>);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cfg[0] = THREADS; cfg[1] = R; cfg[2] = blocks; cfg[3] = attr.numRegs; cfg[4] = sms;
  cfg[5] = (int)smem; cfg[6] = KMAX;
  return err;
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

// cfg <- threads, run bytes, blocks per SM, registers per thread, SMs,
// dynamic shared bytes, images a chunk may span, for images of `size` with
// `block` x `block` templates
extern "C" int fedfr_synth_gen_config(int device, int size, int block, int* cfg) {
  if (size < 1 || block < 1 || size % block != 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const size_t smem = smem_bytes(size, block);
  return (int)(run_for(size) == RUN ? occupancy<RUN>(device, smem, cfg)
                                    : occupancy<1>(device, smem, cfg));
}

// `run` and `chunk` from the wrapper (ops/synth_gen.py::launch_grid): the
// run length fedfr_synth_gen_config reported, and the runs each block
// takes; (noise_m, noise_a, noise_l) the magic of the noise's span
extern "C" int fedfr_synth_gen(const void* keys, const void* gids, const void* bgids,
                               const void* bw, const void* dseeds, unsigned master0,
                               unsigned master1, int batch, int size, int noise,
                               int block, float expr, int shift_div, unsigned noise_m,
                               unsigned noise_a, int noise_l, int run, long long chunk,
                               int device, void* out, void* stream) {
  const size_t smem = smem_bytes(size, block);
  if (size < 1 || block < 1 || size % block != 0 || shift_div < 1 ||
      run != run_for(size) || reinterpret_cast<uintptr_t>(out) % run != 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  Params p{(const int32_t*)keys, (const int32_t*)gids, (const int32_t*)bgids,
           (const int32_t*)dseeds, (const float*)bw, Key{master0, master1}, size, noise,
           block, shift_div, expr,
           FastMod{randint_span(-noise, noise + 1), noise_m, noise_a, (uint32_t)noise_l},
           (long long)batch * size * (3 * size / run), chunk, (uint8_t*)out};
  if (chunk > (long long)(KMAX - 1) * size * (3 * size / run))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (p.runs + chunk - 1) / chunk;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    if (smem > 48 * 1024) err = run == RUN ? fit_smem<RUN>(device, smem) : fit_smem<1>(device, smem);
    if (err != cudaSuccess) return (int)err;
    if (run == RUN)
      synth_gen_kernel<RUN><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
    else
      synth_gen_kernel<1><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
