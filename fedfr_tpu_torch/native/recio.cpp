// Native data plane of the port: a threaded reader of indexed RecordIO
// splits, with a JPEG decoder of its own.
//
// The counterpart of fedfr_tpu/native/recio.cpp, which decodes through
// libjpeg.  This file needs nothing but a C++17 compiler: it carries its own
// baseline and progressive Huffman JPEG decoder, whose output is byte for
// byte libjpeg(-turbo)'s default decompression to RGB (jidctint.c's ISLOW
// IDCT, jdsample.c's fancy upsampling, jdcolor.c's fixed-point YCbCr->RGB).
// Each payload goes through two stages, timed per image: entropy decode to
// coefficient blocks, then reconstruction (dequantise, IDCT, upsample,
// colour).  Images of a batch are taken by std::threads through an atomic
// index and written into a caller-provided NHWC uint8 buffer.
//
// Decoded: SOF0/1/2 Huffman frames of 8-bit samples with 1 or 3 components;
// sampling factors of at most 2 whose ratios to the largest are 1 or 2
// (4:4:4, 4:2:2, 4:4:0, 4:2:0); restart intervals; any image size; and the
// FRAW raw payload (fedfr_tpu_torch/data/codec.py encode_raw).  Everything
// else is an error with its reason: arithmetic coding, 12-bit, lossless or
// hierarchical frames, 2 or 4 components, other sampling factors, a scan that
// names an undefined table, a progressive image whose low coefficients are
// left unrefined (libjpeg would smooth its blocks), a payload that ends
// early.  A failure never falls back to another decoder.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC recio.cpp -o librecio.so -lpthread
//
// C ABI (ctypes):
//   void* recio_open(const char* idx, const char* rec);   // NULL on failure
//   void  recio_close(void* h);
//   long  recio_num_keys(void* h);
//   int   recio_read_labels(void* h, const long* keys, long n, int* out);
//   int   recio_batch_decode(void* h, const long* keys, long n,
//                            unsigned char* out_imgs, int height, int width,
//                            int* out_labels, int nthreads,
//                            const long* rows, long long* stage_ns);
//   int   recio_probe(void* h, long key, int* height, int* width);
//   int   recio_last_error(long* key, char* reason, int len);
// The int calls return 0 on success and -1 on failure; recio_last_error then
// gives the key and reason of the calling thread's last failure (the first
// among a batch's threads) and returns 1.  Image i of a batch goes to row
// rows[i] of out_imgs (row i where rows is NULL).  stage_ns (may be NULL) receives
// the call's nanoseconds of entropy decode and of reconstruction, each summed
// over its threads at image granularity.  recio_probe decodes one record to
// learn whether the reader supports the split, and its size.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct Failure : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& why) { throw Failure(why); }

std::string hex_marker(int m) {
  char buf[8];
  std::snprintf(buf, sizeof buf, "0xFF%02X", m);
  return buf;
}

// zigzag position -> natural (row-major) position of a coefficient
constexpr uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------------ reconstruction tables

// jdmaster.c's range limit after the IDCT: the output is indexed by the
// descaled value & 1023, so that x in [-128, 127] maps to x + 128, larger
// values saturate and far-out values wrap as libjpeg's table does.
// jdcolor.c's YCbCr->RGB tables at SCALEBITS 16.
struct Tables {
  uint8_t idct_limit[1024];
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  Tables() {
    for (int i = 0; i < 1024; ++i) {
      idct_limit[i] = i < 128 ? uint8_t(i + 128)
                    : i < 512 ? 255
                    : i < 896 ? 0
                              : uint8_t(i - 896);
    }
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = int(-fix(0.71414) * x);
      cb_g[i] = int(-fix(0.34414) * x + kHalf);
    }
  }
};
const Tables kTab;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// jidctint.c's jpeg_idct_islow: dequantise and inverse-DCT one block (LL&M,
// CONST_BITS 13, PASS1_BITS 2) into 8x8 samples at out with row stride.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                    F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                    F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                    F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  int32_t ws[64];  // libjpeg's int workspace; its temporaries are JLONG
  // pass 1: columns, from the coefficients into the work array
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qc = q + c;
    int32_t* w = ws + c;
    if (!(in[8] | in[16] | in[24] | in[32] | in[40] | in[48] | in[56])) {
      int32_t dc = int32_t(in[0]) * qc[0] * (1 << kPass1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int32_t(in[16]) * qc[16], z3 = int32_t(in[48]) * qc[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 - z3 * F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = int32_t(in[0]) * qc[0];
    z3 = int32_t(in[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * qc[56];
    tmp1 = int32_t(in[40]) * qc[40];
    tmp2 = int32_t(in[24]) * qc[24];
    tmp3 = int32_t(in[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 = z3 * -F1_961 + z5;
    z4 = z4 * -F0_390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int kS = kConst - kPass1;
    constexpr int64_t kR = int64_t(1) << (kS - 1);
    w[0] = int32_t((t10 + tmp3 + kR) >> kS);
    w[56] = int32_t((t10 - tmp3 + kR) >> kS);
    w[8] = int32_t((t11 + tmp2 + kR) >> kS);
    w[48] = int32_t((t11 - tmp2 + kR) >> kS);
    w[16] = int32_t((t12 + tmp1 + kR) >> kS);
    w[40] = int32_t((t12 - tmp1 + kR) >> kS);
    w[24] = int32_t((t13 + tmp0 + kR) >> kS);
    w[32] = int32_t((t13 - tmp0 + kR) >> kS);
  }
  // pass 2: rows, from the work array into the samples
  const uint8_t* lim = kTab.idct_limit;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      uint8_t v = lim[((int64_t(w[0]) + (1 << (kPass1 + 2))) >> (kPass1 + 3)) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 - z3 * F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConst);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConst);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 = z3 * -F1_961 + z5;
    z4 = z4 * -F0_390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int kS = kConst + kPass1 + 3;
    constexpr int64_t kR = int64_t(1) << (kS - 1);
    o[0] = lim[((t10 + tmp3 + kR) >> kS) & 1023];
    o[7] = lim[((t10 - tmp3 + kR) >> kS) & 1023];
    o[1] = lim[((t11 + tmp2 + kR) >> kS) & 1023];
    o[6] = lim[((t11 - tmp2 + kR) >> kS) & 1023];
    o[2] = lim[((t12 + tmp1 + kR) >> kS) & 1023];
    o[5] = lim[((t12 - tmp1 + kR) >> kS) & 1023];
    o[3] = lim[((t13 + tmp0 + kR) >> kS) & 1023];
    o[4] = lim[((t13 - tmp0 + kR) >> kS) & 1023];
  }
}

// jdsample.c's fancy upsamplers over one output row.  in0 is the input row
// nearest the output row, in1 the next nearest (the row above for an even
// output row, below for an odd one; at the image's edges the edge row
// itself); n is the component's real (downsampled) width.
void h2v1_fancy(const uint8_t* in, int n, uint8_t* out) {
  if (n <= 2) {  // libjpeg replicates when the row is this narrow
    for (int i = 0; i < n; ++i) out[2 * i] = out[2 * i + 1] = in[i];
    return;
  }
  out[0] = in[0];
  out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < n - 1; ++i) {
    int v = in[i] * 3;
    out[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
  }
  out[2 * n - 2] = uint8_t((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
  out[2 * n - 1] = in[n - 1];
}

void h1v2_fancy(const uint8_t* in0, const uint8_t* in1, int bias, int n,
                uint8_t* out) {
  for (int i = 0; i < n; ++i) out[i] = uint8_t((in0[i] * 3 + in1[i] + bias) >> 2);
}

void h2v2_fancy(const uint8_t* in0, const uint8_t* in1, int n, int16_t* sum,
                uint8_t* out) {
  if (n <= 2) {  // libjpeg's box filter: the nearest row, replicated
    for (int i = 0; i < n; ++i) out[2 * i] = out[2 * i + 1] = in0[i];
    return;
  }
  // the column sums 3 * nearest + next nearest, then 3/4 and 1/4 of them
  for (int i = 0; i < n; ++i) sum[i] = int16_t(in0[i] * 3 + in1[i]);
  out[0] = uint8_t((sum[0] * 4 + 8) >> 4);
  out[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
  for (int i = 1; i < n - 1; ++i) {
    out[2 * i] = uint8_t((sum[i] * 3 + sum[i - 1] + 8) >> 4);
    out[2 * i + 1] = uint8_t((sum[i] * 3 + sum[i + 1] + 7) >> 4);
  }
  out[2 * n - 2] = uint8_t((sum[n - 1] * 3 + sum[n - 2] + 8) >> 4);
  out[2 * n - 1] = uint8_t((sum[n - 1] * 4 + 7) >> 4);
}

// ------------------------------------------------------------ entropy decode

struct Huffman {
  static constexpr int kLook = 9;
  uint16_t fast[1 << kLook];  // (code length << 8) | symbol, 0: longer code
  // an AC code and its coefficient's extra bits, where both fit in the
  // lookahead: value * 256 + (run << 4) + bits; 0: decode the symbol
  int32_t fast_ac[1 << kLook];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
  bool defined = false;

  // jdhuff.c's jpeg_make_d_derived_tbl
  void build(const uint8_t* counts, const uint8_t* symbols) {
    uint8_t size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l - 1]; ++i) size[p++] = uint8_t(l);
    size[p] = 0;
    int total = p;
    uint32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1u << si)) fail("bad Huffman table (code space overflows)");
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l - 1]) {
        valoffset[l] = p - int32_t(code[p]);
        p += counts[l - 1];
        maxcode[l] = int32_t(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memcpy(vals, symbols, total);
    std::memset(fast, 0, sizeof fast);
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i, ++p) {
        uint32_t look = code[p] << (kLook - l);
        for (uint32_t r = 0; r < (1u << (kLook - l)); ++r)
          fast[look + r] = uint16_t((l << 8) | symbols[p]);
      }
    }
    for (int i = 0; i < (1 << kLook); ++i) {
      int l = fast[i] >> 8, r = (fast[i] >> 4) & 15, s = fast[i] & 15;
      fast_ac[i] = 0;
      if (l && s && l + s <= kLook) {
        int v = (i >> (kLook - l - s)) & ((1 << s) - 1);
        v = v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
        fast_ac[i] = v * 256 + (r << 4) + l + s;
      }
    }
    defined = true;
  }
};

// MSB-first bit reader over entropy-coded data.  It stops at a marker and
// then supplies zero bits, counting them in `pad`: a scan that consumes
// any of them ran past its data.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;
  int cnt = 0;
  int64_t pad = 0;
  bool stopped = false;

  void reset(const uint8_t* from, const uint8_t* to) {
    p = from;
    end = to;
    buf = 0;
    cnt = 0;
    pad = 0;
    stopped = false;
  }
  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (!stopped && p < end) {
        if (*p != 0xFF) {
          byte = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes before a marker
          if (q < end && *q == 0x00) {
            byte = 0xFF;
            p = q + 1;
          } else {
            stopped = true;  // a marker (or the payload's end): p rests on it
          }
        }
      } else {
        stopped = true;
      }
      if (stopped) pad += 8;
      buf |= uint64_t(byte) << (56 - cnt);
      cnt += 8;
    }
  }
  // an AC symbol with its coefficient from the lookahead alone, or 0
  inline int32_t fast_ac(const Huffman& h) {
    if (cnt < 16) fill();
    int32_t f = h.fast_ac[buf >> (64 - Huffman::kLook)];
    if (f) {
      buf <<= f & 15;
      cnt -= f & 15;
    }
    return f;
  }
  inline uint32_t bits(int n) {  // n in [1, 16]
    if (cnt < n) fill();
    uint32_t v = uint32_t(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  inline int decode(const Huffman& h) {
    if (cnt < 16) fill();
    int v = h.fast[buf >> (64 - Huffman::kLook)];
    if (v) {
      int l = v >> 8;
      buf <<= l;
      cnt -= l;
      return v & 0xFF;
    }
    int l = Huffman::kLook + 1;
    int32_t code = int32_t(buf >> (64 - l));
    while (code > h.maxcode[l]) {
      ++l;
      code = int32_t(buf >> (64 - l));
    }
    if (l > 16) fail("bad Huffman code in the entropy-coded data");
    buf <<= l;
    cnt -= l;
    return h.vals[code + h.valoffset[l]];
  }
  bool overran() const { return cnt < pad; }
  // skip to the next marker; returns its position or end
  const uint8_t* marker() const {
    const uint8_t* q = p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 && q[1] != 0xFF)) ++q;
    return q + 1 < end ? q : end;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // real (downsampled) width and height in samples
  int bw = 0, bh = 0;    // blocks stored (padded to whole MCUs)
  int td = 0, ta = 0;    // the current scan's table selectors
  int dc_pred = 0;
  bool latched = false;  // the quantisation table is taken at its first scan
  bool scanned = false;
  uint16_t q[64];
  int8_t coef_bits[64];  // progressive: last Al seen for each coefficient
  int16_t* coefs = nullptr;
  uint8_t* plane = nullptr;
};

enum class Space { Gray, YCbCr, RGB };

class Decoder {
 public:
  int width = 0, height = 0;
  // stage 1: markers and every scan, into coefficient blocks
  void entropy_decode(const uint8_t* data, size_t len);
  // stage 2: dequantise + IDCT, upsample, colour -> height*width*3 RGB
  void reconstruct(uint8_t* out);
  // the frame's size from its SOF, without decoding
  static void frame_size(const uint8_t* data, size_t len, int* h, int* w);

 private:
  const uint8_t* data_ = nullptr;
  size_t len_ = 0, pos_ = 0;
  int ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  bool progressive_ = false, have_frame_ = false, jfif_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0, scans_ = 0;
  Component comp_[3];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  BitReader br_;
  std::vector<int16_t> coef_store_;
  std::vector<uint8_t> plane_store_, rows_;
  std::vector<int16_t> sums_;

  int byte() {
    if (pos_ >= len_) fail("the payload ends inside a marker segment");
    return data_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker();
  size_t segment();
  void read_dqt();
  void read_dht();
  void read_sof(int m);
  void read_sos();
  void read_app(int m);
  void decode_scan(int n, const int* ci, int ss, int se, int ah, int al);
};

int Decoder::next_marker() {
  // libjpeg skips stray bytes before a marker (with a warning)
  while (pos_ < len_ && data_[pos_] != 0xFF) ++pos_;
  while (pos_ < len_ && data_[pos_] == 0xFF) ++pos_;
  if (pos_ >= len_) fail("the payload ends before its EOI marker");
  return data_[pos_++];
}

size_t Decoder::segment() {
  int n = word();
  if (n < 2 || pos_ - 2 + n > len_)
    fail("a marker segment runs past the end of the payload");
  return pos_ - 2 + n;  // its end
}

void Decoder::read_dqt() {
  size_t end = segment();
  while (pos_ < end) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) fail("bad DQT segment");
    for (int k = 0; k < 64; ++k) qt_[tq][kNatural[k]] = uint16_t(pq ? word() : byte());
    qt_defined_[tq] = true;
  }
  if (pos_ != end) fail("bad DQT segment length");
}

void Decoder::read_dht() {
  size_t end = segment();
  while (pos_ < end) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail("bad DHT segment");
    uint8_t counts[16], symbols[256];
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(byte());
    if (total > 256) fail("bad DHT segment (more than 256 symbols)");
    for (int i = 0; i < total; ++i) symbols[i] = uint8_t(byte());
    (tc ? ac_ : dc_)[th].build(counts, symbols);
  }
  if (pos_ != end) fail("bad DHT segment length");
}

void Decoder::read_app(int m) {
  size_t end = segment();
  size_t n = end - pos_;
  const uint8_t* s = data_ + pos_;
  if (m == 0xE0 && n >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif_ = true;
  if (m == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0)
    adobe_transform_ = s[11];
  pos_ = end;
}

void Decoder::read_sof(int m) {
  if (have_frame_) fail("a second frame header (SOF)");
  size_t end = segment();
  progressive_ = m == 0xC2;
  int precision = byte();
  height = word();
  width = word();
  ncomp_ = byte();
  if (precision != 8)
    fail(std::to_string(precision) + "-bit samples (only 8-bit frames are read)");
  if (height == 0) fail("a frame whose height comes in a DNL marker");
  if (width == 0) fail("a frame of width 0");
  if (ncomp_ != 1 && ncomp_ != 3)
    fail(std::to_string(ncomp_) + " components (only 1 or 3 are read)");
  hmax_ = vmax_ = 1;
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c = Component();
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail("bad frame header (sampling factors or table number)");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  if (pos_ != end) fail("bad SOF segment length");
  if (ncomp_ == 1) {  // one component: an MCU is one block (jdinput.c)
    comp_[0].h = comp_[0].v = 1;
    hmax_ = vmax_ = 1;
  }
  for (int i = 0; i < ncomp_; ++i) {
    const Component& c = comp_[i];
    if (hmax_ > 2 || vmax_ > 2 || hmax_ % c.h || vmax_ % c.v)
      fail("sampling factors " + std::to_string(comp_[0].h) + "x" +
           std::to_string(comp_[0].v) + "," + std::to_string(comp_[1].h) + "x" +
           std::to_string(comp_[1].v) + "," + std::to_string(comp_[2].h) + "x" +
           std::to_string(comp_[2].v) +
           " (each ratio to the largest must be 1 or 2, the largest at most 2)");
  }
  mcus_x_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcus_y_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  size_t total = 0;
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.dw = (width * c.h + hmax_ - 1) / hmax_;
    c.dh = (height * c.v + vmax_ - 1) / vmax_;
    c.bw = mcus_x_ * c.h;
    c.bh = mcus_y_ * c.v;
    total += size_t(c.bw) * c.bh * 64;
    std::memset(c.coef_bits, -1, sizeof c.coef_bits);
  }
  coef_store_.assign(total, 0);
  int16_t* p = coef_store_.data();
  for (int i = 0; i < ncomp_; ++i) {
    comp_[i].coefs = p;
    p += size_t(comp_[i].bw) * comp_[i].bh * 64;
  }
  have_frame_ = true;
}

void Decoder::read_sos() {
  if (!have_frame_) fail("a scan before the frame header");
  size_t end = segment();
  int n = byte();
  if (n < 1 || n > ncomp_) fail("bad scan header (component count)");
  int ci[3];
  for (int i = 0; i < n; ++i) {
    int id = byte(), tables = byte();
    int k = 0;
    while (k < ncomp_ && comp_[k].id != id) ++k;
    if (k == ncomp_) fail("a scan names an unknown component");
    for (int j = 0; j < i; ++j)
      if (ci[j] == k) fail("a scan names a component twice");
    ci[i] = k;
    comp_[k].td = tables >> 4;
    comp_[k].ta = tables & 15;
    if (comp_[k].td > 3 || comp_[k].ta > 3) fail("bad scan header (table number)");
  }
  int ss = byte(), se = byte(), ahal = byte();
  int ah = ahal >> 4, al = ahal & 15;
  if (pos_ != end) fail("bad SOS segment length");
  if (progressive_) {
    bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || n != 1);
    if (bad || (ah != 0 && al != ah - 1) || al > 13)
      fail("bad progression parameters in a scan");
  } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
    fail("a sequential scan with progression parameters");
  }
  for (int i = 0; i < n; ++i) {
    Component& c = comp_[ci[i]];
    if (!c.latched) {
      if (!qt_defined_[c.tq]) fail("a component's quantisation table is undefined");
      std::memcpy(c.q, qt_[c.tq], sizeof c.q);
      c.latched = true;
    }
    bool need_dc = !progressive_ || (ss == 0 && ah == 0);
    bool need_ac = !progressive_ || ss > 0;
    if ((need_dc && !dc_[c.td].defined) || (need_ac && !ac_[c.ta].defined))
      fail("a scan uses an undefined Huffman table");
    c.scanned = true;
    if (progressive_) {  // jdphuff.c's coef_bits bookkeeping
      for (int k = ss; k <= se; ++k) {
        if ((ah == 0) != (c.coef_bits[k] < 0) || (ah != 0 && c.coef_bits[k] != ah))
          fail("progressive scans out of order");
        c.coef_bits[k] = int8_t(al);
      }
    }
  }
  decode_scan(n, ci, ss, se, ah, al);
  ++scans_;
}

void Decoder::decode_scan(int n, const int* ci, int ss, int se, int ah, int al) {
  br_.reset(data_ + pos_, data_ + len_);
  for (int i = 0; i < n; ++i) comp_[ci[i]].dc_pred = 0;
  int per_row, rows;
  if (n == 1) {
    per_row = (comp_[ci[0]].dw + 7) / 8;
    rows = (comp_[ci[0]].dh + 7) / 8;
  } else {
    per_row = mcus_x_;
    rows = mcus_y_;
  }
  const long total = long(per_row) * rows;
  int restarts_left = restart_interval_, next_rst = 0;
  int eobrun = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } mode =
      !progressive_ ? kSeq
      : ss == 0     ? (ah == 0 ? kDcFirst : kDcRefine)
                    : (ah == 0 ? kAcFirst : kAcRefine);

  // one AC correction bit of jdphuff.c's decode_mcu_AC_refine
  auto refine = [&](int16_t* coef) {
    if (br_.bits(1) && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
  };
  auto block = [&](Component& c, int bx, int by) {
    int16_t* b = c.coefs + (size_t(by) * c.bw + bx) * 64;
    switch (mode) {
      case kSeq: {
        int s = br_.decode(dc_[c.td]);
        if (s > 15) fail("bad DC symbol in the entropy-coded data");
        if (s) s = extend(int(br_.bits(s)), s);
        c.dc_pred += s;
        b[0] = int16_t(c.dc_pred);
        const Huffman& h = ac_[c.ta];
        for (int k = 1; k < 64; ++k) {
          if (int32_t f = br_.fast_ac(h)) {
            k += (f >> 4) & 15;
            if (k > 63) fail("AC coefficients run past the block");
            b[kNatural[k]] = int16_t(f >> 8);
            continue;
          }
          int rs = br_.decode(h);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            if (k > 63) fail("AC coefficients run past the block");
            b[kNatural[k]] = int16_t(extend(int(br_.bits(s)), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        break;
      }
      case kDcFirst: {
        int s = br_.decode(dc_[c.td]);
        if (s > 15) fail("bad DC symbol in the entropy-coded data");
        if (s) s = extend(int(br_.bits(s)), s);
        c.dc_pred += s;
        b[0] = int16_t(c.dc_pred * (1 << al));
        break;
      }
      case kDcRefine:
        if (br_.bits(1)) b[0] = int16_t(b[0] | p1);
        break;
      case kAcFirst: {
        if (eobrun > 0) {
          --eobrun;
          break;
        }
        const Huffman& h = ac_[c.ta];
        for (int k = ss; k <= se; ++k) {
          if (int32_t f = br_.fast_ac(h)) {
            k += (f >> 4) & 15;
            if (k > se) fail("AC coefficients run past the spectral band");
            b[kNatural[k]] = int16_t((f >> 8) * (1 << al));
            continue;
          }
          int rs = br_.decode(h);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (k > se) fail("AC coefficients run past the spectral band");
            b[kNatural[k]] = int16_t(extend(int(br_.bits(s)), s) * (1 << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += int(br_.bits(r));
            --eobrun;
            break;
          }
        }
        break;
      }
      case kAcRefine: {
        int k = ss;
        if (eobrun == 0) {
          const Huffman& h = ac_[c.ta];
          for (; k <= se; ++k) {
            int rs = br_.decode(h);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              if (s != 1) fail("bad AC refinement symbol");
              s = br_.bits(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += int(br_.bits(r));
              break;  // the band's rest is refined below
            }
            // advance over nonzero coefficients (refining each) and r zeros
            do {
              int16_t* coef = b + kNatural[k];
              if (*coef != 0) {
                refine(coef);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) {
              if (k > se) fail("AC refinement runs past the spectral band");
              b[kNatural[k]] = int16_t(s);
            }
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t* coef = b + kNatural[k];
            if (*coef != 0) refine(coef);
          }
          --eobrun;
        }
        break;
      }
    }
  };

  for (long m = 0; m < total; ++m) {
    if (restart_interval_ && restarts_left == 0) {
      // jdhuff.c's process_restart: drop the buffered bits, pass the RSTn
      if (br_.overran()) fail("the entropy-coded data ends early");
      const uint8_t* q = br_.marker();
      if (q == br_.end || q[1] != 0xD0 + next_rst)
        fail("restart marker RST" + std::to_string(next_rst) + " is missing");
      br_.reset(q + 2, data_ + len_);
      next_rst = (next_rst + 1) & 7;
      restarts_left = restart_interval_;
      eobrun = 0;
      for (int i = 0; i < n; ++i) comp_[ci[i]].dc_pred = 0;
    }
    int mx = int(m % per_row), my = int(m / per_row);
    if (n == 1) {
      block(comp_[ci[0]], mx, my);
    } else {
      for (int i = 0; i < n; ++i) {
        Component& c = comp_[ci[i]];
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) block(c, mx * c.h + h, my * c.v + v);
      }
    }
    --restarts_left;
  }
  if (br_.overran()) fail("the entropy-coded data ends early");
  const uint8_t* q = br_.marker();
  pos_ = size_t(q - data_);
}

void Decoder::entropy_decode(const uint8_t* data, size_t len) {
  data_ = data;
  len_ = len;
  pos_ = 2;
  have_frame_ = jfif_ = false;
  adobe_transform_ = -1;
  restart_interval_ = scans_ = 0;
  std::memset(qt_defined_, 0, sizeof qt_defined_);
  for (int i = 0; i < 4; ++i) dc_[i].defined = ac_[i].defined = false;
  for (;;) {
    int m = next_marker();
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        break;
      case 0xC3: case 0xC7: case 0xCB: case 0xCF:
        fail("a lossless frame (SOF " + hex_marker(m) + ")");
      case 0xC5: case 0xC6: case 0xCD: case 0xCE:
        fail("a hierarchical frame (SOF " + hex_marker(m) + ")");
      case 0xC9: case 0xCA: case 0xCC:
        fail("arithmetic coding (" + hex_marker(m) + ")");
      case 0xC4: read_dht(); break;
      case 0xDB: read_dqt(); break;
      case 0xDD: {
        size_t end = segment();
        restart_interval_ = word();
        if (pos_ != end) fail("bad DRI segment length");
        break;
      }
      case 0xDA: read_sos(); break;
      case 0xD9: {
        if (!have_frame_ || scans_ == 0) fail("an EOI before any scan");
        for (int i = 0; i < ncomp_; ++i) {
          const Component& c = comp_[i];
          if (!c.scanned) fail("a component that no scan codes");
          if (progressive_) {
            // jdcoefct.c smooths blocks whose low coefficients are not yet
            // exact; the reader refuses such images instead
            for (int k = 0; k < 10; ++k)
              if (c.coef_bits[k] != 0)
                fail("progressive scans leave low coefficients unrefined");
          }
        }
        return;
      }
      case 0xDC: fail("a DNL marker");
      case 0xD8: fail("a second SOI marker");
      case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        break;  // parameterless markers, ignored as libjpeg does
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
          read_app(m);
          break;
        }
        fail("an unknown marker " + hex_marker(m));
    }
  }
}

void Decoder::reconstruct(uint8_t* out) {
  // dequantise + IDCT every block the image shows into one plane a component
  size_t need = 0;
  int stride[3];
  for (int i = 0; i < ncomp_; ++i) {
    stride[i] = (comp_[i].dw + 7) / 8 * 8;
    need += size_t(stride[i]) * ((comp_[i].dh + 7) / 8 * 8);
  }
  if (plane_store_.size() < need) plane_store_.resize(need);
  uint8_t* p = plane_store_.data();
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.plane = p;
    int bw = stride[i] / 8, bh = (c.dh + 7) / 8;
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx)
        idct_islow(c.coefs + (size_t(by) * c.bw + bx) * 64, c.q,
                   p + size_t(by) * 8 * stride[i] + bx * 8, stride[i]);
    p += size_t(stride[i]) * bh * 8;
  }
  Space space = Space::Gray;
  if (ncomp_ == 3) {
    // jdapimin.c's default_decompress_parms
    space = Space::YCbCr;
    if (!jfif_) {
      if (adobe_transform_ == 0)
        space = Space::RGB;
      else if (adobe_transform_ < 0 && comp_[0].id == 'R' && comp_[1].id == 'G' &&
               comp_[2].id == 'B')
        space = Space::RGB;
    }
  }
  // upsample each row of each component to the full width, then colour
  size_t row_len = size_t(mcus_x_) * 16 + 16;
  if (rows_.size() < 3 * row_len) rows_.resize(3 * row_len);
  if (sums_.size() < row_len) sums_.resize(row_len);
  for (int y = 0; y < height; ++y) {
    const uint8_t* row[3];
    for (int i = 0; i < ncomp_; ++i) {
      const Component& c = comp_[i];
      int rh = hmax_ / c.h, rv = vmax_ / c.v;
      int iy = rv == 1 ? y : y >> 1;
      const uint8_t* in0 = c.plane + size_t(iy) * stride[i];
      if (rh == 1 && rv == 1) {
        row[i] = in0;
        continue;
      }
      uint8_t* o = rows_.data() + i * row_len;
      row[i] = o;
      if (rv == 1) {
        h2v1_fancy(in0, c.dw, o);
        continue;
      }
      // the next nearest input row: above for an even output row, below
      // for an odd one, the edge row itself at the edges
      int ny = (y & 1) ? std::min(iy + 1, c.dh - 1) : std::max(iy - 1, 0);
      const uint8_t* in1 = c.plane + size_t(ny) * stride[i];
      if (rh == 1)
        h1v2_fancy(in0, in1, (y & 1) ? 2 : 1, c.dw, o);
      else
        h2v2_fancy(in0, in1, c.dw, sums_.data(), o);
    }
    uint8_t* o = out + size_t(y) * width * 3;
    if (space == Space::Gray) {
      for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[0][x];
    } else if (space == Space::RGB) {
      for (int x = 0; x < width; ++x) {
        o[3 * x] = row[0][x];
        o[3 * x + 1] = row[1][x];
        o[3 * x + 2] = row[2][x];
      }
    } else {
      for (int x = 0; x < width; ++x) {
        int yy = row[0][x], cb = row[1][x], cr = row[2][x];
        o[3 * x] = clamp255(yy + kTab.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + ((kTab.cb_g[cb] + kTab.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + kTab.cb_b[cb]);
      }
    }
  }
}

// the size in the first frame header (any SOFn: entropy_decode names what
// it does not read)
void Decoder::frame_size(const uint8_t* data, size_t len, int* h, int* w) {
  Decoder d;
  d.data_ = data;
  d.len_ = len;
  d.pos_ = 2;
  for (;;) {
    int m = d.next_marker();
    if ((m & 0xF0) == 0xC0 && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      d.segment();
      d.byte();
      *h = d.word();
      *w = d.word();
      return;
    }
    if (m == 0xD9 || m == 0xDA) fail("no frame header before the first scan");
    if (m != 0x01 && (m < 0xD0 || m > 0xD7)) d.pos_ = d.segment();
  }
}

// ------------------------------------------------------------- the records

struct Record {
  uint32_t flag;
  float label;
  const uint8_t* payload;
  size_t payload_len;
};

struct Handle {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::unordered_map<int64_t, size_t> offsets;
  std::vector<int64_t> keys;
};

// the calling thread's last failure (ctypes calls run on the caller's thread)
struct LastError {
  bool set = false;
  long key = 0;
  std::string reason;
};
thread_local LastError last_error;

// the first failure among a batch's threads
struct FirstFailure {
  std::mutex mu;
  bool set = false;
  long key = 0;
  std::string reason;
  void record(long k, const char* why) {
    std::lock_guard<std::mutex> g(mu);
    if (set) return;
    set = true;
    key = k;
    reason = why;
  }
};

int failed(long key, const char* why) {
  last_error.set = true;
  last_error.key = key;
  last_error.reason = why;
  return -1;
}

// the frame (8 bytes), the 24-byte IRHeader and, when flag > 0, the label
// array (the port's recordio.py unpack); the label is its first float then
Record parse_record(const Handle* h, int64_t key) {
  auto it = h->offsets.find(key);
  if (it == h->offsets.end()) fail("no such key in the index");
  size_t off = it->second;
  if (off + 8 > h->size) fail("the record's offset lies past the end of the rec");
  uint32_t magic, lrec;
  std::memcpy(&magic, h->base + off, 4);
  std::memcpy(&lrec, h->base + off + 4, 4);
  if (magic != kMagic) fail("bad record magic");
  if (lrec >> 29)
    fail("a continuation record (mxnet cflag " + std::to_string(lrec >> 29) +
         "), which this reader does not support");
  size_t len = lrec & kLenMask;
  if (off + 8 + len > h->size) fail("the record runs past the end of the rec");
  if (len < 24) fail("the record is shorter than its header");
  const uint8_t* body = h->base + off + 8;
  Record r;
  std::memcpy(&r.flag, body, 4);
  std::memcpy(&r.label, body + 4, 4);
  size_t skip = 24;
  if (r.flag > 0) {
    skip += size_t(r.flag) * 4;
    if (len < skip) fail("the record is shorter than its label array");
    std::memcpy(&r.label, body + 24, 4);
  }
  r.payload = body + skip;
  r.payload_len = len - skip;
  return r;
}

std::string payload_kind(const uint8_t* p, size_t n) {
  if (n >= 8 && std::memcmp(p, "\x89PNG", 4) == 0) return "a PNG payload";
  char buf[96];
  std::snprintf(buf, sizeof buf,
                "neither a JPEG nor a FRAW payload (%zu bytes, starting %02x %02x %02x %02x)",
                n, n > 0 ? p[0] : 0, n > 1 ? p[1] : 0, n > 2 ? p[2] : 0, n > 3 ? p[3] : 0);
  return buf;
}

bool is_jpeg(const uint8_t* p, size_t n) { return n >= 2 && p[0] == 0xFF && p[1] == 0xD8; }
bool is_raw(const uint8_t* p, size_t n) { return n >= 10 && std::memcmp(p, "FRAW", 4) == 0; }

using Clock = std::chrono::steady_clock;

long long ns_since(Clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() - t0).count();
}

// one payload into out (height*width*3 RGB); stage times added to the sums
void decode_payload(Decoder& dec, const uint8_t* p, size_t n, uint8_t* out,
                    int height, int width, long long* ent_ns, long long* rec_ns) {
  if (is_raw(p, n)) {
    uint16_t h, w, c;
    std::memcpy(&h, p + 4, 2);
    std::memcpy(&w, p + 6, 2);
    std::memcpy(&c, p + 8, 2);
    if (c != 3) fail("a FRAW payload of " + std::to_string(c) + " channels");
    if (h != height || w != width)
      fail("the image is " + std::to_string(h) + "x" + std::to_string(w) +
           ", the reader expects " + std::to_string(height) + "x" + std::to_string(width));
    if (n != 10 + size_t(h) * w * c) fail("the FRAW payload's length does not match its header");
    auto t0 = Clock::now();
    std::memcpy(out, p + 10, size_t(h) * w * c);
    *rec_ns += ns_since(t0);
    return;
  }
  if (!is_jpeg(p, n)) fail(payload_kind(p, n));
  int h = 0, w = 0;
  Decoder::frame_size(p, n, &h, &w);
  if (h != height || w != width)
    fail("the image is " + std::to_string(h) + "x" + std::to_string(w) +
         ", the reader expects " + std::to_string(height) + "x" + std::to_string(width));
  auto t0 = Clock::now();
  dec.entropy_decode(p, n);
  auto t1 = Clock::now();
  dec.reconstruct(out);
  *ent_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count();
  *rec_ns += ns_since(t1);
}

}  // namespace

extern "C" {

void* recio_open(const char* idx_path, const char* rec_path) {
  auto* h = new Handle();
  h->fd = open(rec_path, O_RDONLY);
  struct stat st;
  if (h->fd < 0 || fstat(h->fd, &st) != 0) {
    if (h->fd >= 0) close(h->fd);
    delete h;
    return nullptr;
  }
  h->size = size_t(st.st_size);
  if (h->size > 0) {
    void* m = mmap(nullptr, h->size, PROT_READ, MAP_PRIVATE, h->fd, 0);
    if (m == MAP_FAILED) {
      close(h->fd);
      delete h;
      return nullptr;
    }
    h->base = static_cast<const uint8_t*>(m);
    madvise(m, h->size, MADV_WILLNEED);
  }
  FILE* f = std::fopen(idx_path, "r");
  if (!f) {
    if (h->base) munmap(const_cast<uint8_t*>(h->base), h->size);
    close(h->fd);
    delete h;
    return nullptr;
  }
  long long key, off;
  while (std::fscanf(f, "%lld\t%lld", &key, &off) == 2) {
    h->offsets.emplace(key, size_t(off));
    h->keys.push_back(key);
  }
  std::fclose(f);
  return h;
}

void recio_close(void* hp) {
  auto* h = static_cast<Handle*>(hp);
  if (!h) return;
  if (h->base) munmap(const_cast<uint8_t*>(h->base), h->size);
  if (h->fd >= 0) close(h->fd);
  delete h;
}

long recio_num_keys(void* hp) { return long(static_cast<Handle*>(hp)->keys.size()); }

int recio_read_labels(void* hp, const long* keys, long n, int* out) {
  auto* h = static_cast<Handle*>(hp);
  last_error.set = false;
  for (long i = 0; i < n; ++i) {
    try {
      out[i] = int(parse_record(h, keys[i]).label);
    } catch (const std::exception& e) {
      return failed(keys[i], e.what());
    }
  }
  return 0;
}

int recio_batch_decode(void* hp, const long* keys, long n, unsigned char* out_imgs,
                       int height, int width, int* out_labels, int nthreads,
                       const long* rows, long long* stage_ns) {
  auto* h = static_cast<Handle*>(hp);
  last_error.set = false;
  std::atomic<long> next(0);
  std::atomic<long long> ent_sum(0), rec_sum(0);
  FirstFailure first;
  std::atomic<bool> stop(false);
  const size_t img_bytes = size_t(height) * width * 3;

  auto worker = [&]() {
    Decoder dec;
    long long ent = 0, rec = 0;
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n || stop.load()) break;
      try {
        Record r = parse_record(h, keys[i]);
        out_labels[i] = int(r.label);
        size_t row = size_t(rows ? rows[i] : i);
        decode_payload(dec, r.payload, r.payload_len, out_imgs + row * img_bytes,
                       height, width, &ent, &rec);
      } catch (const std::exception& e) {
        first.record(keys[i], e.what());
        stop.store(true);
        break;
      }
    }
    ent_sum += ent;
    rec_sum += rec;
  };

  int k = int(std::max<long>(1, std::min<long>(nthreads, n)));
  if (k == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(k);
    for (int t = 0; t < k; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  if (stage_ns) {
    stage_ns[0] = ent_sum.load();
    stage_ns[1] = rec_sum.load();
  }
  return first.set ? failed(first.key, first.reason.c_str()) : 0;
}

int recio_probe(void* hp, long key, int* height, int* width) {
  auto* h = static_cast<Handle*>(hp);
  last_error.set = false;
  try {
    Record r = parse_record(h, key);
    const uint8_t* p = r.payload;
    size_t n = r.payload_len;
    if (is_raw(p, n)) {
      uint16_t hh, ww;
      std::memcpy(&hh, p + 4, 2);
      std::memcpy(&ww, p + 6, 2);
      *height = hh;
      *width = ww;
    } else if (is_jpeg(p, n)) {
      Decoder::frame_size(p, n, height, width);
    } else {
      fail(payload_kind(p, n));
    }
    // decode it once: a split is read natively only where this succeeds
    std::vector<uint8_t> img(size_t(*height) * *width * 3);
    Decoder dec;
    long long ent = 0, rec = 0;
    decode_payload(dec, p, n, img.data(), *height, *width, &ent, &rec);
  } catch (const std::exception& e) {
    return failed(key, e.what());
  }
  return 0;
}

int recio_last_error(long* key, char* reason, int len) {
  if (!last_error.set) return 0;
  *key = last_error.key;
  if (len > 0) std::snprintf(reason, size_t(len), "%s", last_error.reason.c_str());
  return 1;
}

}  // extern "C"
