// Modulated deformable convolution (DCNv2) forward, fp32 and bf16, for
// Hopper (sm_90a), contracting on the tensor cores.
//
// Replaces the TPU kernel edvr_tpu/ops/dcn_band.py::band_forward together
// with its XLA partner outlier_patch (both wired in by
// edvr_tpu/ops/dcn.py::_band_apply). It computes the function of
// edvr_tpu/ops/dcn.py::modulated_deform_conv, not the band formulation:
// the static windows, one-hot selection, 128-lane packing and outlier patch
// exist only because Mosaic has no in-kernel gather. Here every sample is a
// plain gather, exact for any offset magnitude, including taps wholly
// outside the image.
//
// Element types (dcn_common.cuh): float, and bf16 with band_forward's
// rounding points (coordinates and coefficients in float32, the
// coefficient and each corner's product rounded to bf16, the contraction
// accumulated in float32, the output rounded to bf16 and the bias added in
// bf16 as the caller's `out.astype(x.dtype) + bias` does).
//
// What bounds it on an H100 SXM, reckoned at EDVR-M L1 (n=5, 64 channels,
// 180x320, dg=8, 3x3 taps): 2*5*57600*64*576 = 21.2 GFLOP against ~396 MB
// of compulsory traffic in fp32 (x, offset, mask read once, out written
// once), 0.118 ms at 3.35 TB/s. fp32 contracts in 3xTF32 (three TF32
// products per fp32 product, 63.6 GFLOP at 495 TFLOP/s): 0.129 ms, so the
// operations bound it (0.317 ms on the fp32 pipe). bf16 takes two exact
// bf16 products per column entry (42.4 GFLOP at 989 TFLOP/s, 0.043 ms)
// against half the bytes, 0.059 ms, so the bytes bound it.
//
// Design: one block owns TP = 64 output pixels of one image and 64 or 128
// output channels (one column, built once, serves every 64-channel chunk;
// EDVR-L's cout 128 takes one block column). The contraction's rows are
// the (deformable group, tap, channel) triples in the weights' order,
// walked in slabs of at most 64 rows and 16 group-taps (a slab may span
// groups: tap_shared's eight K=1 groups make one). The slab's offset and
// mask rows and its weight rows are copied by cp.async into one of two
// buffers while the previous slab is built and multiplied. Per slab:
//  1. one thread per (group-tap, pixel) takes its fields from shared
//     memory and gathers the four corners from x, which the wrapper lays
//     out group-major, (n, dg, h, w, C_PER): a corner's C_PER channels are
//     one contiguous read and neighbouring pixels' corners lie C_PER
//     elements apart, so a warp's gather touches a few cache lines, not
//     one per lane as channels-last rows of 64 channels would. The four
//     loads go out together (a corner outside the image is read at a
//     clamped address and adds nothing). The masked bilinear column of its
//     C_PER channels goes to column[pixel][row] (bf16: split into a bf16
//     hi and lo, which holds ~16 bits of the float32 entry, so the
//     products keep band_forward's rounding points and add none);
//  2. eight warps, each 16 pixels x 32 channels of each chunk, take
//     mma.sync products into fresh accumulators (fp32: m16n8k8 TF32 x3,
//     both operands split as their fragments are read; bf16: m16n8k16,
//     column hi and lo against the exact bf16 weights, fragments by
//     ldmatrix) and add the slab's sum to the running sum with one float32
//     add: the tensor cores round their float32 sums toward zero, and a
//     running sum over deep, large sums drifts
//     (tests/test_torch_tf32split.py).
// wgmma from shared memory, the operands split once per slab (and launched
// asynchronously over the next slab's build), was correct and slower here
// (PERF.md): its operands' shared memory left two blocks per SM, and its
// accumulators, live through the next build, spilled. The epilogue
// stages the sums as [channel][pixel] in shared memory and stores 16-byte
// pieces of each output channel's row (NCHW), the bias added as they are
// stored. No atomics: the output is bitwise the same from run to run. The
// strides keep every fragment read and column write free of bank
// conflicts (rows of 68 words for the fp32 column, 36 for the bf16 halves,
// weight rows of 8 mod 32 words, or 4 mod 32 for ldmatrix).
//
// Ablation variants (dev tooling, the port of the TPU tool
// scripts/dev/ablate_band.py::build_variant): the compile-time MODE strips
// components of this same kernel, so no variant can drift from the shipped
// one (MODE = FULL). The components are (a) reading the offset and mask
// fields, (b) the per-(pixel, tap) coordinate and coefficient math, (c)
// the four corner loads from x, (d) the blend into the shared-memory
// column and (e) the tensor-core contraction. Each variant computes a
// stated function (edvr_tpu_torch/ops/dcn_ablate.py holds its plain
// version):
//   FULL         a-e   DCNv2
//   NO_COEF      a,c,e sum_k W_k . (sum of the 4 clamped corners); the
//                      mask is read and added times 0, so its traffic stays
//   INT_COEF     a,b,one corner,d,e  sum_k W_k . (floor corner x validity
//                      x mask)
//   NO_GATHER    a,b,d,e  the FULL function with x == 1; x is never read
//   COORDS_ONLY  a,b   per pixel sum over groups and taps of
//                      wy0 + wy1 + wx0 + wx1 + y0 + x0, on every channel
//   IO_ONLY      a     per pixel sum over groups and taps of dy + dx + m,
//                      on every channel
// Every variant adds the bias and stores as FULL does; the variants run
// with one 64-channel chunk per block.

#include "dcn_common.cuh"
#include "mma_common.cuh"

// Measurement builds only (python -m edvr_tpu_torch.tools.ab_kernels
// --ablate): -DDCN_FWD_ONE_PRODUCT keeps one product per fragment (fp32:
// hi*hi of the three; bf16: the column's hi, not its lo), -DDCN_FWD_NO_MMA
// drops the products. Their results are off by design; the shipped build
// sets neither.

namespace {

using dcn::from_f32;
using dcn::kBf16;
using dcn::round_bf16;
using dcn::to_f32;
using namespace mma;

constexpr int TP = 64;        // output pixels per block
constexpr int TO = 64;        // output channels per chunk
constexpr int THREADS = 256;  // 8 warps: 4 m16 pixel bands x 2 halves
constexpr int DEPTH = 64;     // column rows per slab, at most
constexpr int LDO = TP + 4;   // row of the staged output (floats)

enum Mode { FULL = 0, NO_COEF, INT_COEF, NO_GATHER, COORDS_ONLY, IO_ONLY };

template <typename T, int C_PER, int NCH>
struct Cfg {
  // group-taps per slab: DEPTH rows, at most 16 taps (the fields' buffer)
  static constexpr int KT = DEPTH / C_PER < 16 ? DEPTH / C_PER : 16;
  static constexpr int SLAB = KT * C_PER;  // column rows per full slab
  static constexpr int ROUNDS = (KT * TP + THREADS - 1) / THREADS;
  static constexpr int NO = NCH * TO;      // output channels per block
  static constexpr int V = 16 / (int)sizeof(T);  // elements per 16 bytes
  // two buffers each of the slab's weights [SLAB][LDW] and of its fields
  // [3 KT][TP] (offset rows, then mask rows), as T; the column [TP][LDA]
  // (fp32 floats; bf16 hi, then lo)
  static constexpr int LDW = NO + 8;
  static constexpr int LDA = kBf16<T> ? DEPTH + 8 : DEPTH + 4;
  static constexpr size_t W_BYTES = (size_t)SLAB * LDW * sizeof(T);
  static constexpr size_t F_BYTES = (size_t)3 * KT * TP * sizeof(T);
  static constexpr size_t COL_OFF = 2 * W_BYTES + 2 * F_BYTES;
  static constexpr size_t COL_BYTES =
      kBf16<T> ? (size_t)2 * TP * LDA * 2 : (size_t)TP * LDA * 4;
  static constexpr size_t OUT_BYTES = (size_t)NO * LDO * 4;
  static constexpr size_t SMEM = COL_OFF + COL_BYTES > OUT_BYTES
                                     ? COL_OFF + COL_BYTES
                                     : OUT_BYTES;
  // the one-value-per-row column of COORDS_ONLY and IO_ONLY, as floats
  static constexpr int LDV = DEPTH + 4;
  static_assert((size_t)TP * LDV * 4 <= COL_BYTES, "value rows fit");
  static_assert(KT * TP % THREADS == 0 || KT * TP < THREADS, "rounds");
};

// Slab s0's fields (offset rows 2 s0 .. 2 (s0 + kt) - 1, mask rows s0 ..
// s0 + kt - 1, pixels p0 .. p0 + TP - 1) and, when `weights`, its weight
// rows r0 = s0 C_PER .. r0 + kt C_PER - 1 (channels o0 .. o0 + NO - 1)
// into buffer `buf`, zero past P, the slab's rows or cout: by cp.async in
// 16-byte pieces where the rows allow it (vf, vw), else by plain loads.
// One commit group per slab.
template <typename T, int C_PER, int NCH>
__device__ __forceinline__ void prefetch(unsigned char* sm, int buf,
                                         const T* __restrict__ offb,
                                         const T* __restrict__ mb,
                                         const T* __restrict__ wt, int s0,
                                         int kt, int P, int p0, int o0,
                                         int cout, bool weights, bool vf,
                                         bool vw, int tid) {
  using C = Cfg<T, C_PER, NCH>;
  constexpr int V = C::V;
  T* F = reinterpret_cast<T*>(sm + 2 * C::W_BYTES + buf * C::F_BYTES);
  auto field_row = [&](int r) -> const T* {  // null: a row this slab skips
    if (r < 2 * C::KT)
      return r < 2 * kt ? offb + (size_t)(2 * s0 + r) * P : nullptr;
    r -= 2 * C::KT;
    return r < kt ? mb + (size_t)(s0 + r) * P : nullptr;
  };
  if (vf) {  // P % V == 0: a piece is wholly in range or out
    for (int i = tid; i < 3 * C::KT * (TP / V); i += THREADS) {
      const int r = i / (TP / V), pl = (i % (TP / V)) * V;
      const T* src = field_row(r);
      if (src == nullptr) continue;
      const int p = p0 + pl;
      cp_async16(F + r * TP + pl, p < P ? src + p : src, p < P);
    }
  } else {
    for (int i = tid; i < 3 * C::KT * TP; i += THREADS) {
      const int r = i / TP, pl = i % TP;
      const T* src = field_row(r);
      if (src == nullptr) continue;
      const int p = p0 + pl;
      F[r * TP + pl] = p < P ? src[p] : from_f32<T>(0.f);
    }
  }
  if (weights) {
    T* W = reinterpret_cast<T*>(sm + buf * C::W_BYTES);
    const int r0 = s0 * C_PER, d = kt * C_PER;
    if (vw) {  // cout % V == 0: a piece is wholly in range or out
      for (int i = tid; i < C::SLAB * (C::NO / V); i += THREADS) {
        const int r = i / (C::NO / V), c = (i % (C::NO / V)) * V;
        const int o = o0 + c;
        const bool ok = r < d && o < cout;
        cp_async16(W + r * C::LDW + c,
                   ok ? wt + (size_t)(r0 + r) * cout + o : wt, ok);
      }
    } else {
      for (int i = tid; i < C::SLAB * C::NO; i += THREADS) {
        const int r = i / C::NO, c = i % C::NO, o = o0 + c;
        W[r * C::LDW + c] = (r < d && o < cout)
                                ? wt[(size_t)(r0 + r) * cout + o]
                                : from_f32<T>(0.f);
      }
    }
  }
  cp_async_commit();
}

// The masked bilinear column of C_PER channels, as
// dcn_common.cuh::masked_column forms it (corners 00, 01, 10, 11, each
// add_corner'ed when it lies in the image, then finish_column), with the
// four corners of each 8-channel piece loaded together: a corner outside
// the image is read at a clamped address and adds nothing. xg is the
// group's (h, w, C_PER) plane of x.
template <typename T, int C_PER>
__device__ __forceinline__ void gather_column(const T* __restrict__ xg,
                                              const dcn::Sample& s, int h,
                                              int w, float* v) {
  constexpr int CV = C_PER < 8 ? C_PER : 8;
#pragma unroll
  for (int c = 0; c < C_PER; ++c) v[c] = 0.f;
  const float wy[2] = {1.f - s.fy, s.fy};
  const float wx[2] = {1.f - s.fx, s.fx};
  const bool ok[4] = {s.vy0 && s.vx0, s.vy0 && s.vx1, s.vy1 && s.vx0,
                      s.vy1 && s.vx1};
  const T* src[4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int yy = min(max(s.y0 + a, 0), h - 1);
      const int xx = min(max(s.x0 + b, 0), w - 1);
      src[2 * a + b] = xg + ((size_t)yy * w + xx) * C_PER;
    }
#pragma unroll
  for (int c0 = 0; c0 < C_PER; c0 += CV) {
    float t[4][CV];
#pragma unroll
    for (int q = 0; q < 4; ++q) dcn::load_f32<T, CV>(src[q] + c0, t[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ok[q])
        dcn::add_corner<T, CV>(v + c0, t[q], wy[q >> 1], wx[q & 1], s.m);
  }
  if (s.any) dcn::finish_column<T, C_PER>(v, s.m);
}

// The C_PER column entries of one (group-tap, pixel) item: rows r .. r +
// C_PER - 1 of pixel pl's column row, in 4-, 8- or 16-byte pieces (bf16:
// split into a hi and a lo row).
template <typename T, int C_PER, int NCH>
__device__ __forceinline__ void put_column(unsigned char* sm, int pl, int r,
                                           const float* v) {
  using C = Cfg<T, C_PER, NCH>;
  unsigned char* base = sm + C::COL_OFF;
  if constexpr (kBf16<T>) {
    __nv_bfloat16* ch =
        reinterpret_cast<__nv_bfloat16*>(base) + pl * C::LDA + r;
    __nv_bfloat16* cl = ch + TP * C::LDA;
    if constexpr (C_PER == 1) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[0]);
      ch[0] = hi;
      cl[0] = __float2bfloat16_rn(v[0] - __bfloat162float(hi));
    } else {
      uint32_t hi[C_PER / 2], lo[C_PER / 2];
#pragma unroll
      for (int c = 0; c < C_PER; c += 2)
        split_bf16x2(v[c], v[c + 1], hi[c / 2], lo[c / 2]);
      if constexpr (C_PER >= 8) {
#pragma unroll
        for (int i = 0; i < C_PER / 8; ++i) {
          reinterpret_cast<uint4*>(ch)[i] = make_uint4(
              hi[4 * i], hi[4 * i + 1], hi[4 * i + 2], hi[4 * i + 3]);
          reinterpret_cast<uint4*>(cl)[i] = make_uint4(
              lo[4 * i], lo[4 * i + 1], lo[4 * i + 2], lo[4 * i + 3]);
        }
      } else if constexpr (C_PER == 4) {
        *reinterpret_cast<uint2*>(ch) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(cl) = make_uint2(lo[0], lo[1]);
      } else {
        *reinterpret_cast<uint32_t*>(ch) = hi[0];
        *reinterpret_cast<uint32_t*>(cl) = lo[0];
      }
    }
  } else {
    float* cp = reinterpret_cast<float*>(base) + pl * C::LDA + r;
    if constexpr (C_PER >= 4) {
#pragma unroll
      for (int i = 0; i < C_PER / 4; ++i)
        reinterpret_cast<float4*>(cp)[i] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < C_PER; ++c) cp[c] = v[c];
    }
  }
}

// part[j] += column (pixels 16 mt .. +15, rows 0 .. d-1) x W (rows 0 ..
// d-1, the n8 tile n0 + 8 j of the staged channels), j = 0 .. 3; d is a
// multiple of the mma depth, rows past the slab's are zero in both.
template <typename T, int C_PER, int NCH>
__device__ __forceinline__ void mma_slab(float (*part)[4],
                                         const unsigned char* sm,
                                         const T* W, int n0, int mt,
                                         int lane, int d) {
  using C = Cfg<T, C_PER, NCH>;
  const int gq = lane >> 2, q = lane & 3;
  if constexpr (kBf16<T>) {
    const __nv_bfloat16* ch =
        reinterpret_cast<const __nv_bfloat16*>(sm + C::COL_OFF);
    const __nv_bfloat16* cl = ch + TP * C::LDA;
    const int mi = lane >> 3, r = lane & 7;
    const int arow = (16 * mt + r + 8 * (mi & 1)) * C::LDA + 8 * (mi >> 1);
    const int brow = (r + 8 * (mi & 1)) * C::LDW + n0 + 8 * (mi >> 1);
#pragma unroll 2
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t a_hi[4], a_lo[4];
      ldsm_x4(a_hi, ch + arow + k0);
      ldsm_x4(a_lo, cl + arow + k0);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bb[4];  // the n8 tiles 2 jp and 2 jp + 1
        ldsm_x4_trans(bb, W + brow + k0 * C::LDW + 16 * jp);
#ifndef DCN_FWD_ONE_PRODUCT
        mma_bf16(part[2 * jp], a_lo, bb);
        mma_bf16(part[2 * jp + 1], a_lo, bb + 2);
#endif
        mma_bf16(part[2 * jp], a_hi, bb);
        mma_bf16(part[2 * jp + 1], a_hi, bb + 2);
      }
    }
  } else {
    const float* a0 = reinterpret_cast<const float*>(sm + C::COL_OFF) +
                      (16 * mt + gq) * C::LDA + q;
    const float* a1 = a0 + 8 * C::LDA;
#pragma unroll 2
    for (int k0 = 0; k0 < d; k0 += 8) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(a0[k0], a_hi[0], a_lo[0]);
      split_tf32(a1[k0], a_hi[1], a_lo[1]);
      split_tf32(a0[k0 + 4], a_hi[2], a_lo[2]);
      split_tf32(a1[k0 + 4], a_hi[3], a_lo[3]);
      const float* w0 = W + (k0 + q) * C::LDW + n0 + gq;
      const float* w1 = w0 + 4 * C::LDW;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(w0[8 * j], b_hi[0], b_lo[0]);
        split_tf32(w1[8 * j], b_hi[1], b_lo[1]);
#ifdef DCN_FWD_ONE_PRODUCT
        mma_tf32(part[j], a_hi, b_hi);
#else
        mma_3xtf32(part[j], a_hi, a_lo, b_hi, b_lo);
#endif
      }
    }
  }
}

template <typename T, int C_PER, int NCH, int MODE>
__global__ void __launch_bounds__(THREADS, kBf16<T> ? 4 : 3)
dcn_fwd_kernel(const T* __restrict__ x,       // (n, dg, h, w, C_PER)
               const T* __restrict__ offset,  // (n, dg*2K, oh, ow)
               const T* __restrict__ mask,    // (n, dg*K, oh, ow)
               const T* __restrict__ wt,      // (dg, K, C_PER, cout)
               const T* __restrict__ bias,    // (cout) or null
               T* __restrict__ out,           // (n, cout, oh, ow)
               int h, int w, int cin, int cout, int oh, int ow, int kh,
               int kw, int stride, int pad, int dil, int dg, bool vf,
               bool vw, bool vo) {
  using C = Cfg<T, C_PER, NCH>;
  // COORDS_ONLY and IO_ONLY neither copy weights nor contract: one value
  // per (group-tap, pixel), summed per pixel
  constexpr bool CONTRACT = MODE != COORDS_ONLY && MODE != IO_ONLY;
  constexpr int KSTEP = kBf16<T> ? 16 : 8;  // mma depth
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  float* val_s = reinterpret_cast<float*>(sm + C::COL_OFF);  // [TP][LDV]

  const int K = kh * kw;
  const int GK = dg * K;
  const int P = oh * ow;
  const int tiles = (P + TP - 1) / TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * TP;
  const int o0 = blockIdx.y * C::NO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 3;          // pixels 16 mt .. +15
  const int nw = 32 * (warp >> 2);  // channels nw .. nw + 31 of each chunk

  float acc[NCH][4][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  float pix = 0.f;  // COORDS_ONLY, IO_ONLY: pixel p0 + tid's sum

  const T* xb = x + (size_t)b * h * w * cin;
  const T* offb = offset + (size_t)b * dg * 2 * K * P;
  const T* mb = mask + (size_t)b * dg * K * P;

  // slab si's fields and weights are copied while slab si - 1 is blended
  // and multiplied (two buffers of each)
  const int nslab = (GK + C::KT - 1) / C::KT;
  prefetch<T, C_PER, NCH>(sm, 0, offb, mb, wt, 0, min(C::KT, GK), P, p0, o0,
                          cout, CONTRACT, vf, vw, tid);
  for (int si = 0; si < nslab; ++si) {
    const int s0 = si * C::KT, buf = si & 1;
    const int kt = min(C::KT, GK - s0);  // group-taps of this slab
    const int d = kt * C_PER;            // its column rows
    cp_async_wait<0>();
    __syncthreads();  // slab si landed; slab si - 1's products are done
    if (si + 1 < nslab)
      prefetch<T, C_PER, NCH>(sm, buf ^ 1, offb, mb, wt, s0 + C::KT,
                              min(C::KT, GK - s0 - C::KT), P, p0, o0, cout,
                              CONTRACT, vf, vw, tid);
    const T* F = reinterpret_cast<const T*>(sm + 2 * C::W_BYTES +
                                            buf * C::F_BYTES);

#pragma unroll
    for (int rr = 0; rr < C::ROUNDS; ++rr) {
      const int it = tid + rr * THREADS;
      if (it >= C::KT * TP) break;
      const int pl = it % TP, j = it / TP;
      const int p = p0 + pl;
      float v[C_PER];
#pragma unroll
      for (int c = 0; c < C_PER; ++c) v[c] = 0.f;
      if (j < kt && p < P) {
        const int gk = s0 + j, g = gk / K, k = gk - g * K;
        const T* xg = xb + (size_t)g * h * w * C_PER;
        const dcn::Sample s = dcn::sample_from(
            to_f32(F[2 * j * TP + pl]), to_f32(F[(2 * j + 1) * TP + pl]),
            to_f32(F[(2 * C::KT + j) * TP + pl]), k, p / ow, p % ow, kw, h,
            w, stride, pad, dil);
        if constexpr (MODE == FULL) {
          gather_column<T, C_PER>(xg, s, h, w, v);
        } else if constexpr (MODE == NO_COEF) {
          // the four corners clamped into the image, summed unweighted
          const int ya = (int)fminf(fmaxf(s.y0f, 0.f), (float)(h - 1));
          const int yb =
              (int)fminf(fmaxf(s.y0f + 1.f, 0.f), (float)(h - 1));
          const int xa = (int)fminf(fmaxf(s.x0f, 0.f), (float)(w - 1));
          const int xc =
              (int)fminf(fmaxf(s.x0f + 1.f, 0.f), (float)(w - 1));
          const int ys[2] = {ya, yb}, xs[2] = {xa, xc};
#pragma unroll
          for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              float t[C_PER];
              dcn::load_f32<T, C_PER>(
                  xg + ((size_t)ys[a] * w + xs[bb]) * C_PER, t);
#pragma unroll
              for (int c = 0; c < C_PER; ++c) v[c] += t[c];
            }
          }
          v[0] += 0.f * s.m;
        } else if constexpr (MODE == INT_COEF) {
          if (s.vy0 && s.vx0) {
            float t[C_PER];
            dcn::load_f32<T, C_PER>(
                xg + ((size_t)s.y0 * w + s.x0) * C_PER, t);
            const float coef = s.m;  // vy0 * m * vx0, both validities 1
#pragma unroll
            for (int c = 0; c < C_PER; ++c)
              v[c] = kBf16<T> ? round_bf16(round_bf16(coef) * t[c])
                              : t[c] * coef;
          }
        } else if constexpr (MODE == NO_GATHER) {
          // FULL's column with every table value 1
          if (s.any) {
            const float wy[2] = {1.f - s.fy, s.fy};
            const float wx[2] = {1.f - s.fx, s.fx};
            const bool vy[2] = {s.vy0, s.vy1};
            const bool vx[2] = {s.vx0, s.vx1};
            float sum = 0.f;
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int bb = 0; bb < 2; ++bb) {
                if (!(vy[a] && vx[bb])) continue;
                // __fmul_rn: no fused multiply-add, as FULL rounds the
                // product before its sum
                sum += kBf16<T> ? round_bf16((wy[a] * s.m) * wx[bb])
                                : __fmul_rn(wy[a], wx[bb]);
              }
            if constexpr (!kBf16<T>) sum *= s.m;
#pragma unroll
            for (int c = 0; c < C_PER; ++c) v[c] = sum;
          }
        } else if constexpr (MODE == COORDS_ONLY) {
          // products rounded before the sums (__fmul_rn), as the plain
          // version computes them
          const float wy0 = __fmul_rn((1.f - s.fy) * (float)s.vy0, s.m);
          const float wy1 = __fmul_rn(s.fy * (float)s.vy1, s.m);
          const float wx0 = __fmul_rn(1.f - s.fx, (float)s.vx0);
          const float wx1 = __fmul_rn(s.fx, (float)s.vx1);
          v[0] = wy0 + wy1 + wx0 + wx1 + s.y0f + s.x0f;
        } else {  // IO_ONLY
          v[0] = s.dy + s.dx + s.m;
        }
      }
      // items past kt write zeros: the rows past d up to the slab's are zero
      if constexpr (CONTRACT)
        put_column<T, C_PER, NCH>(sm, pl, j * C_PER, v);
      else
        val_s[pl * C::LDV + j] = v[0];
    }
    __syncthreads();

    if constexpr (CONTRACT) {
      const int dk = (d + KSTEP - 1) / KSTEP * KSTEP;
      const T* W = reinterpret_cast<const T*>(sm + buf * C::W_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        // the slab's sum apart, joined by one round-to-nearest add
        float part[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#ifndef DCN_FWD_NO_MMA
        mma_slab<T, C_PER, NCH>(part, sm, W, c * TO + nw, mt, lane, dk);
#endif
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][j][e] += part[j][e];
      }
    } else if (tid < TP) {
      for (int j = 0; j < kt; ++j) pix += val_s[tid * C::LDV + j];
    }
  }
  __syncthreads();  // the staged output below overlays the operands

  // ---- epilogue: the sums as out_s[channel][pixel], then 16-byte rows
  float* out_s = reinterpret_cast<float*>(sm);
  if constexpr (CONTRACT) {
    const int m = 16 * mt + (lane >> 2), q2 = 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = c * TO + nw + 8 * j + q2;
        out_s[nn * LDO + m] = acc[c][j][0];
        out_s[(nn + 1) * LDO + m] = acc[c][j][1];
        out_s[nn * LDO + m + 8] = acc[c][j][2];
        out_s[(nn + 1) * LDO + m + 8] = acc[c][j][3];
      }
  } else if (tid < TP) {
    out_s[tid] = pix;  // one row, read for every channel
  }
  __syncthreads();

  constexpr int V = C::V;
  auto finish = [&](float a, int o) -> T {
    if constexpr (kBf16<T>) {
      const __nv_bfloat16 r = from_f32<T>(a);
      return bias ? from_f32<T>(to_f32(r) + to_f32(bias[o])) : r;
    } else {
      return a + (bias ? bias[o] : 0.f);
    }
  };
  if (vo) {  // P % V == 0: a piece is wholly in range or out
    for (int i = tid; i < C::NO * (TP / V); i += THREADS) {
      const int nn = i / (TP / V), pl = (i % (TP / V)) * V;
      const int o = o0 + nn, p = p0 + pl;
      if (o >= cout || p >= P) continue;
      const float* src = out_s + (CONTRACT ? nn * LDO : 0) + pl;
      alignas(16) T piece[V];
#pragma unroll
      for (int e = 0; e < V; ++e) piece[e] = finish(src[e], o);
      *reinterpret_cast<uint4*>(out + ((size_t)b * cout + o) * P + p) =
          *reinterpret_cast<const uint4*>(piece);
    }
  } else {
    for (int i = tid; i < C::NO * TP; i += THREADS) {
      const int nn = i / TP, pl = i % TP;
      const int o = o0 + nn, p = p0 + pl;
      if (o >= cout || p >= P) continue;
      out[((size_t)b * cout + o) * P + p] =
          finish(out_s[(CONTRACT ? nn * LDO : 0) + pl], o);
    }
  }
}

template <typename T, int C_PER, int NCH, int MODE>
int launch(const void* x, const void* offset, const void* mask,
           const void* wt, const void* bias, void* out, int n, int h, int w,
           int cin, int cout, int oh, int ow, int kh, int kw, int stride,
           int pad, int dil, int dg, cudaStream_t stream) {
  using C = Cfg<T, C_PER, NCH>;
  auto kernel = dcn_fwd_kernel<T, C_PER, NCH, MODE>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const int P = oh * ow;
  auto aligned = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  // 16-byte pieces of the fields' rows, the weights' rows and the output's
  const bool vf = P % C::V == 0 && aligned(offset) && aligned(mask);
  const bool vw = cout % C::V == 0 && aligned(wt);
  const bool vo = P % C::V == 0 && aligned(out);
  const dim3 grid(n * ((P + TP - 1) / TP), (cout + C::NO - 1) / C::NO);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(wt),
      static_cast<const T*>(bias), static_cast<T*>(out), h, w, cin, cout, oh,
      ow, kh, kw, stride, pad, dil, dg, vf, vw, vo);
  return (int)cudaGetLastError();
}

// FULL takes two 64-channel chunks per block when cout > 64, so that one
// column serves up to 128 channels; the ablation variants take one.
template <typename T, int C_PER, int MODE>
int launch_chunks(const void* x, const void* offset, const void* mask,
                  const void* wt, const void* bias, void* out, int n, int h,
                  int w, int cin, int cout, int oh, int ow, int kh, int kw,
                  int stride, int pad, int dil, int dg, cudaStream_t stream) {
  if constexpr (MODE == FULL) {
    if (cout > TO)
      return launch<T, C_PER, 2, MODE>(x, offset, mask, wt, bias, out, n, h,
                                       w, cin, cout, oh, ow, kh, kw, stride,
                                       pad, dil, dg, stream);
  }
  return launch<T, C_PER, 1, MODE>(x, offset, mask, wt, bias, out, n, h, w,
                                   cin, cout, oh, ow, kh, kw, stride, pad,
                                   dil, dg, stream);
}

template <typename T, int MODE>
int dispatch(const void* x, const void* offset, const void* mask,
             const void* wt, const void* bias, void* out, int n, int h,
             int w, int cin, int cout, int oh, int ow, int kh, int kw,
             int stride, int pad, int dil, int dg, void* stream) {
  if (n == 0 || oh * ow == 0 || cout == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define DCN_CASE(C)                                                          \
  case C:                                                                    \
    return launch_chunks<T, C, MODE>(x, offset, mask, wt, bias, out, n, h,   \
                                     w, cin, cout, oh, ow, kh, kw, stride,   \
                                     pad, dil, dg, st);
  switch (cin / dg) {
    DCN_CASE(1)
    DCN_CASE(2)
    DCN_CASE(4)
    DCN_CASE(8)
    DCN_CASE(16)
    DCN_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCN_CASE
}

template <typename T>
int dispatch_mode(int mode, const void* x, const void* offset,
                  const void* mask, const void* wt, const void* bias,
                  void* out, int n, int h, int w, int cin, int cout, int oh,
                  int ow, int kh, int kw, int stride, int pad, int dil,
                  int dg, void* stream) {
#define MODE_CASE(M)                                                         \
  case M:                                                                    \
    return dispatch<T, M>(x, offset, mask, wt, bias, out, n, h, w, cin,      \
                          cout, oh, ow, kh, kw, stride, pad, dil, dg,        \
                          stream);
  switch (mode) {
    MODE_CASE(FULL)
    MODE_CASE(NO_COEF)
    MODE_CASE(INT_COEF)
    MODE_CASE(NO_GATHER)
    MODE_CASE(COORDS_ONLY)
    MODE_CASE(IO_ONLY)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MODE_CASE
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers to
// elements of the entry's type (float for *_f32, bf16 for *_bf16) and all
// share it; `stream` is the caller's cudaStream_t. The caller checks
// shapes, dtypes, devices and contiguity and allocates `out`. Returns the
// cudaError_t of the launch (0 on success); an unsupported cin/dg split or
// mode returns cudaErrorInvalidValue without launching.
#define DCN_ARGS                                                             \
  const void *x, const void *offset, const void *mask, const void *wt,       \
      const void *bias, void *out, int n, int h, int w, int cin, int cout,   \
      int oh, int ow, int kh, int kw, int stride, int pad, int dil, int dg
#define DCN_PASS                                                             \
  x, offset, mask, wt, bias, out, n, h, w, cin, cout, oh, ow, kh, kw,        \
      stride, pad, dil, dg

extern "C" int dcn_fwd_f32(DCN_ARGS, void* stream) {
  return dispatch<float, FULL>(DCN_PASS, stream);
}

extern "C" int dcn_fwd_bf16(DCN_ARGS, void* stream) {
  return dispatch<__nv_bfloat16, FULL>(DCN_PASS, stream);
}

// The ablation variants (mode: 0 FULL, 1 NO_COEF, 2 INT_COEF, 3 NO_GATHER,
// 4 COORDS_ONLY, 5 IO_ONLY); mode 0 is the shipped kernel.
extern "C" int dcn_fwd_ablate_f32(DCN_ARGS, int mode, void* stream) {
  return dispatch_mode<float>(mode, DCN_PASS, stream);
}

extern "C" int dcn_fwd_ablate_bf16(DCN_ARGS, int mode, void* stream) {
  return dispatch_mode<__nv_bfloat16>(mode, DCN_PASS, stream);
}
