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
// 128 lanes x 1.98 GHz = 33.5 T/s; only the xors must use the 64-lane ALU
// pipe), not by the bytes (3.35 TB/s): about 0.09 ms against 0.006 ms for a
// 512-image batch at 112x112.  chip_smoke.py counts the instructions.
//
// Design.  One block per image.  A prologue puts the image's constants in
// shared memory, each computed by one thread: the blended template
// (1 - bw) * T[gid] + bw * T[bgid] (block x block x 3 values, one a thread,
// then under expr > 0 blended toward the distractor T[dgid] with weight u),
// the contrast scale, the brightness offset, the roll (dy, dx) and the two
// split keys of the noise.  Then every thread walks the image's output bytes
// with a stride of the block size, so that a warp writes 32 neighbouring
// bytes: it finds the pre-roll pixel ((y - dy) mod S, (x - dx) mod S), draws
// the noise at that pixel's flat index (jnp.roll comes after the noise),
// and writes clip(((T + n) * scale) + offset, 0, 255) truncated to uint8.
//
// Numbers.  JAX computes each float op rounded on its own in this order; a
// fused multiply-add would round once and can move a pixel across an integer
// boundary, so every float op here is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts.  The uint32 arithmetic wraps as
// JAX's does (randint's multiplier ((2^16 % span)^2) % span is 0 for the
// distractor's span 2^30 - 2^26).
//
// Interface: a plain C function (built with nvcc into a shared library and
// called through ctypes) that launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TEMPLATE_LO = 30, TEMPLATE_HI = 226;
constexpr int32_t DISTRACTOR_LO = 1 << 26, DISTRACTOR_HI = 1 << 30;
constexpr uint32_t DSEED_BASE = 1u << 30;
constexpr int N_SCALARS = 7;  // scale, offset, dy, dx, noise keys, u, dgid

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

// jax.random.randint(key, shape, minval, maxval) for int32: the per-key part
struct RandInt {
  Key k1, k2;
  uint32_t span, mult;
  int32_t minval;
};

__device__ RandInt randint_setup(Key k, int32_t minval, int32_t maxval) {
  RandInt r;
  r.k1 = threefry2x32(k, 0u, 0u);  // the fold-like split
  r.k2 = threefry2x32(k, 0u, 1u);
  r.span = maxval > minval ? (uint32_t)maxval - (uint32_t)minval : 1u;
  const uint32_t m = 65536u % r.span;
  r.mult = (m * m) % r.span;  // wraps, as JAX's uint32 multiply does
  r.minval = minval;
  return r;
}

__device__ __forceinline__ int32_t randint_at(const RandInt& r, uint32_t idx) {
  const uint32_t hi = bits32(r.k1, idx), lo = bits32(r.k2, idx);
  const uint32_t off = ((hi % r.span) * r.mult + lo % r.span) % r.span;
  return (int32_t)((uint32_t)r.minval + off);
}

__device__ __forceinline__ float uniform_at(Key k, uint32_t idx) {
  return __fsub_rn(__uint_as_float((bits32(k, idx) >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float template_value(Key master, uint32_t gid, int i) {
  return (float)randint_at(randint_setup(fold_in(master, gid), TEMPLATE_LO,
                                         TEMPLATE_HI), (uint32_t)i);
}

__global__ void __launch_bounds__(THREADS)
synth_gen_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ gids,
                 const int32_t* __restrict__ bgids, const float* __restrict__ bw,
                 const int32_t* __restrict__ dseeds, Key master, int size,
                 int noise, int block, float expr, int shift_div,
                 uint8_t* __restrict__ out) {
  extern __shared__ float s_base[];  // block x block x 3 template
  __shared__ RandInt s_noise;
  __shared__ float s_scale, s_u;
  __shared__ int32_t s_offset, s_dy, s_dx;
  __shared__ uint32_t s_dgid;

  const int img = blockIdx.x;
  const int n_t = block * block * 3;
  const Key ki = fold_in(fold_in(master, DSEED_BASE + (uint32_t)dseeds[img]),
                         (uint32_t)keys[img]);
  const int amp = size / shift_div;

  for (int t = threadIdx.x; t < n_t + N_SCALARS; t += blockDim.x) {
    if (t < n_t) {
      const float w = bw[img];
      s_base[t] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w),
                                      template_value(master, (uint32_t)gids[img], t)),
                            __fmul_rn(w, template_value(master, (uint32_t)bgids[img], t)));
      continue;
    }
    switch (t - n_t) {
      case 0:
        s_scale = __fadd_rn(0.75f, __fmul_rn(0.5f, uniform_at(fold_in(ki, 1u), 0u)));
        break;
      case 1:
        s_offset = randint_at(randint_setup(fold_in(ki, 2u), -20, 21), 0u);
        break;
      case 2:
        s_dy = randint_at(randint_setup(fold_in(ki, 3u), -amp, amp + 1), 0u);
        break;
      case 3:
        s_dx = randint_at(randint_setup(fold_in(ki, 4u), -amp, amp + 1), 0u);
        break;
      case 4:
        s_noise = randint_setup(fold_in(ki, 0u), -noise, noise + 1);
        break;
      case 5:
        s_u = __fmul_rn(expr, uniform_at(fold_in(ki, 5u), 0u));
        break;
      default:
        s_dgid = (uint32_t)randint_at(
            randint_setup(fold_in(ki, 6u), DISTRACTOR_LO, DISTRACTOR_HI), 0u);
    }
  }
  __syncthreads();
  if (expr > 0.0f) {
    const float u = s_u;
    for (int t = threadIdx.x; t < n_t; t += blockDim.x)
      s_base[t] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), s_base[t]),
                            __fmul_rn(u, template_value(master, s_dgid, t)));
    __syncthreads();
  }

  const RandInt rn = s_noise;
  const float scale = s_scale, offset = (float)s_offset;
  const int dy = s_dy, dx = s_dx, rep = size / block, row = size * 3;
  const int n_out = size * row;
  uint8_t* dst = out + (size_t)img * n_out;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int y = o / row, r = o - y * row, x = r / 3, c = r - x * 3;
    int ys = (y - dy) % size, xs = (x - dx) % size;
    ys += ys < 0 ? size : 0;
    xs += xs < 0 ? size : 0;
    const float n = (float)randint_at(rn, (uint32_t)((ys * size + xs) * 3 + c));
    const float base = s_base[((ys / rep) * block + xs / rep) * 3 + c];
    float v = __fadd_rn(__fmul_rn(__fadd_rn(base, n), scale), offset);
    v = fminf(fmaxf(v, 0.0f), 255.0f);
    dst[o] = (uint8_t)__float2uint_rz(v);
  }
}

}  // namespace

extern "C" int fedfr_synth_gen(const void* keys, const void* gids, const void* bgids,
                               const void* bw, const void* dseeds, unsigned master0,
                               unsigned master1, int batch, int size, int noise,
                               int block, float expr, int shift_div, void* out,
                               void* stream) {
  const size_t smem = (size_t)block * block * 3 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  synth_gen_kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)gids, (const int32_t*)bgids,
      (const float*)bw, (const int32_t*)dseeds, Key{master0, master1}, size, noise,
      block, expr, shift_div, (uint8_t*)out);
  return (int)cudaGetLastError();
}
