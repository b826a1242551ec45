// Modulated deformable convolution (DCNv2) backward, fp32 and bf16, for
// Hopper (sm_90a): one launch, both contractions on the tensor cores.
//
// Replaces the TPU kernel edvr_tpu/ops/dcn_band.py::band_backward together
// with its XLA partners fold_windows and outlier_patch_bwd (all three wired
// in by edvr_tpu/ops/dcn.py::_band_apply_bwd). It computes the gradient of
// the function that dcn_fwd.cu computes, not of the band formulation: there
// are no windows to fold and no outliers to patch, and it is exact for any
// offset magnitude. Given dout it returns
//
//   dx       the table (input) gradient: col2im of dcol * mask * bilinear;
//   doffset  the analytic coordinate gradient (the reference's
//            col2im_coord): sum_c dcol * mask * d sample / d (y, x);
//   dmask    sum_c dcol * sample;
//   dW       sum over every image and pixel of dout x masked column,
//
// where dcol = W^T . dout is the column gradient. In bf16 (x, offset,
// mask, weights and dout in bf16) every sum is float32: dcol from exact
// bf16 products, d_offset and d_mask in float32 (stored in bf16), dx
// scattered with float32 atomics into a float32 buffer that the caller
// casts (bf16 atomics would lose the sum), dW summed from float32
// partials; the weight gradient contracts the column the bf16 forward
// contracted (dcn_common.cuh::masked_column, with its rounding points).
// floor() has no gradient and corner validity is a step, so the
// derivative at an exactly integer coordinate follows the same floor
// convention as the plain version
// (edvr_tpu_torch/ops/dcn.py::modulated_deform_conv_plain).
//
// What bounds it on an H100 SXM, reckoned at the EDVR-M training L1 shape
// (n=20 frames of a 64x64 crop, 64 channels, dg=8, 3x3 taps): ~205 MB of
// compulsory traffic in fp32 (x, offset, mask, dout read once; dx,
// doffset, dmask written once), 0.061 ms at 3.35 TB/s, against the two
// contractions (dcol and dW), 2 x 2*64*576*81920 = 12.1 GFLOP: in fp32
// 36.2 GFLOP of TF32 products in 3xTF32, 0.073 ms at 495 TFLOP/s, so the
// operations bound it (0.18 ms on the fp32 pipe); in bf16 0.012 ms on the
// tensor cores against half the bytes, 0.031 ms, so the bytes bound it.
//
// Design: one block per (run of tiles, deformable group, 64 output
// channels z) -- for taps other than 3x3 and 1x1, per (run of tiles, group
// and chunk of at most 9 taps, z), so that shared memory does not grow with
// kh x kw (a tap's gradients read no other tap's weights); it walks its
// share of the 64-pixel tiles of that group, persistent, holding the group's weight slice in shared memory and its
// dW^T tile in registers. Per tile:
//  1. dcol^T (64 pixels x K*C_PER) = dout_tile^T . W_g on the tensor
//     cores, over every 64-channel chunk of dout, into shared memory
//     (blocks with z > 0 skip 1 and 2);
//  2. one thread per (tap, pixel) reads the four corners once (channels-
//     last: one contiguous read per corner), accumulates dmask and
//     doffset in registers, scatters dx to the corners with float32
//     vector atomics (float4: four channels per operation), and writes the
//     masked column over its dcol entries;
//  3. dW^T (64 channels x K*C_PER) += dout_tile . column^T on the tensor
//     cores, the tile's sum taken apart and added in float32 (the tensor
//     cores round their sums toward zero; at the running sum's magnitude,
//     tile after tile, that drifts).
// fp32 takes both products in 3xTF32 (mma_common.cuh). bf16 takes dcol as
// one m16n8k16 bf16 product (W and dout are bf16: the products are exact),
// and dW with the float32 column split into a bf16 hi and lo (two
// products), so the column keeps the forward's rounding points and no new
// one. Each block writes one partial of dW; the caller's sum over
// partials is the deterministic second pass. Atomics make dx's summation
// order vary from run to run; a deterministic scatter would need a sort
// or per-tile windows (the band kernel's fold), which is a later PR's
// choice. The shared-memory strides (and, in fp32, an XOR swizzle of the
// dout tile, which is read in two transposed patterns) keep the fragment
// reads free of bank conflicts; bf16 fragments come by ldmatrix.

#include "dcn_common.cuh"
#include "mma_common.cuh"

// Measurement builds only (python -m edvr_tpu_torch.tools.ab_kernels
// --ablate): -DDCN_BWD_NO_ATOMICS drops the dx scatter, -DDCN_BWD_NO_GATHER
// replaces the corner loads by a constant, -DDCN_BWD_NO_MMA drops both
// products, -DDCN_BWD_NO_ITEMS the whole (tap, pixel) pass. Their results
// are wrong by design; the shipped build sets none.

namespace {

using dcn::from_f32;
using dcn::kBf16;
using namespace mma;

constexpr int TP = 64;        // pixels per tile
constexpr int TO = 64;        // output channels per chunk
constexpr int THREADS = 256;  // 8 warps: 4 m16 bands x 2 n8 interleaves
constexpr int LDD = TP + 8;   // row of the staged dout tile (elements)
// taps a block takes when kh x kw is neither 3x3 nor 1x1 (a chunk)
constexpr int BWD_TAP_CHUNK = 9;

// the tap chunks of a kh x kw backward, a factor of the grid's y: 1 for
// 3x3 and 1x1 (one block's compile-time taps) and any kh x kw up to 9
// taps. The launch sizes its grid by it, and the caller its block count
// (dcn_bwd_tap_chunks).
constexpr int tap_chunks(int kh, int kw) {
  return (kh * kw + BWD_TAP_CHUNK - 1) / BWD_TAP_CHUNK;
}

template <typename T, int C_PER, int K>
struct Cfg {
  static constexpr int KC = K * C_PER;
  static constexpr int KCN = (KC + 7) / 8 * 8;  // N of both products
  static constexpr int NT = KCN / 8;            // n8 tiles
  static constexpr int NTW = (NT + 1) / 2;      // n8 tiles per warp, at most
  static constexpr int LDW = kBf16<T> ? TO + 8 : TO + 4;  // W_s row (T)
  static constexpr int LDC = kBf16<T> ? TP + 8 : TP + 4;  // dc_s row (f32)
  static constexpr size_t W_BYTES = (size_t)KCN * LDW * sizeof(T);
  static constexpr size_t D_BYTES = (size_t)TO * LDD * sizeof(T);
  static constexpr size_t SMEM = W_BYTES + D_BYTES + (size_t)KCN * LDC * 4;
  static constexpr int MIN_BLOCKS = KC <= 72 ? 2 : 1;  // per SM
};

// Element (o, p) of the staged dout tile. fp32 swaps the two 4-pixel
// halves of each 8 when bit 2 of o is set: the tile is read as (o: 4, p:
// 8) and as (o: 8, p: 4) lane patterns, and with rows of 72 words both
// then fall on 32 distinct banks.
template <typename T>
__device__ __forceinline__ int dout_at(int o, int p) {
  if constexpr (kBf16<T>)
    return o * LDD + p;
  else
    return o * LDD + (p ^ (o & 4));
}

// W_g's rows kc < kcv (the block's taps) and channels o_base .. o_base + 63
// as W_s[kc][o], zero outside.
template <typename T, int C_PER, int K>
__device__ __forceinline__ void stage_w(T* W_s, const T* __restrict__ wg,
                                        int kcv, int o_base, int cout,
                                        int tid) {
  using C = Cfg<T, C_PER, K>;
  for (int i = tid; i < C::KCN * TO; i += THREADS) {
    const int kc = i / TO, col = i % TO, o = o_base + col;
    W_s[kc * C::LDW + col] = (kc < kcv && o < cout)
                                 ? wg[(size_t)kc * cout + o]
                                 : from_f32<T>(0.f);
  }
}

// dout's channels o_base .. +63 at pixels p0 .. p0 + 63 of one image, zero
// outside; 16 bytes a thread where the rows allow it.
template <typename T>
__device__ __forceinline__ void stage_dout(T* d_s, const T* __restrict__ db,
                                           int o_base, int cout, int p0,
                                           int P, bool vec, int tid) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vec) {  // P % V == 0: a piece is wholly in range or out
    for (int i = tid; i < TO * TP / V; i += THREADS) {
      const int r = i / (TP / V), pl = (i % (TP / V)) * V;
      const int o = o_base + r, p = p0 + pl;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (o < cout && p < P)
        u = __ldg(reinterpret_cast<const uint4*>(db + (size_t)o * P + p));
      *reinterpret_cast<uint4*>(d_s + dout_at<T>(r, pl)) = u;
    }
  } else {
    for (int i = tid; i < TO * TP; i += THREADS) {
      const int r = i / TP, pl = i % TP;
      const int o = o_base + r, p = p0 + pl;
      d_s[dout_at<T>(r, pl)] =
          (o < cout && p < P) ? db[(size_t)o * P + p] : from_f32<T>(0.f);
    }
  }
}

// acc[j] += dcol^T tiles (m16 band mt of the pixels, n8 tiles nt0 + 2j of
// the K*C_PER rows) of one 64-channel chunk: A = dout^T, B = W_g.
template <typename T, int C_PER, int K>
__device__ __forceinline__ void mma_dcol(float (*acc)[4], const T* W_s,
                                         const T* d_s, int mt, int nt0,
                                         int lane) {
  using C = Cfg<T, C_PER, K>;
  const int gq = lane >> 2, q = lane & 3;
  if constexpr (kBf16<T>) {
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < TO; k0 += 16) {
      uint32_t a[4];  // stored [o][p]: the transposed load gives (p, o)
      ldsm_x4_trans(a, d_s + (k0 + 8 * (mi >> 1) + r) * LDD + 16 * mt +
                           8 * (mi & 1));
#pragma unroll
      for (int j = 0; j < C::NTW; ++j) {
        const int nt = nt0 + 2 * j;
        if (nt >= C::NT) break;
        uint32_t b[2];
        ldsm_x2(b, W_s + (8 * nt + r) * C::LDW + k0 + 8 * (mi & 1));
        mma_bf16(acc[j], a, b);
      }
    }
  } else {
    const int p1 = 16 * mt + gq, p2 = p1 + 8;
#pragma unroll 2
    for (int k0 = 0; k0 < TO; k0 += 8) {
      const int o1 = k0 + q, o2 = o1 + 4;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(d_s[dout_at<T>(o1, p1)], a_hi[0], a_lo[0]);
      split_tf32(d_s[dout_at<T>(o1, p2)], a_hi[1], a_lo[1]);
      split_tf32(d_s[dout_at<T>(o2, p1)], a_hi[2], a_lo[2]);
      split_tf32(d_s[dout_at<T>(o2, p2)], a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < C::NTW; ++j) {
        const int nt = nt0 + 2 * j;
        if (nt >= C::NT) break;
        const T* wr = W_s + (8 * nt + gq) * C::LDW;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(wr[o1], b_hi[0], b_lo[0]);
        split_tf32(wr[o2], b_hi[1], b_lo[1]);
        mma_3xtf32(acc[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
}

// acc[j] += dW^T tiles (m16 band mt of the 64 channels, n8 tiles nt0 + 2j
// of the K*C_PER rows) over the tile's 64 pixels: A = dout, B = column^T.
template <typename T, int C_PER, int K>
__device__ __forceinline__ void mma_dw(float (*acc)[4], const T* d_s,
                                       const float* dc_s, int mt, int nt0,
                                       int lane) {
  using C = Cfg<T, C_PER, K>;
  const int gq = lane >> 2, q = lane & 3;
  if constexpr (kBf16<T>) {
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < TP; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, d_s + (16 * mt + 8 * (mi & 1) + r) * LDD + k0 +
                     8 * (mi >> 1));
#pragma unroll
      for (int j = 0; j < C::NTW; ++j) {
        const int nt = nt0 + 2 * j;
        if (nt >= C::NT) break;
        const float* cr = dc_s + (8 * nt + gq) * C::LDC + k0 + 2 * q;
        const float2 x0 = *reinterpret_cast<const float2*>(cr);
        const float2 x1 = *reinterpret_cast<const float2*>(cr + 8);
        uint32_t b_hi[2], b_lo[2];
        split_bf16x2(x0.x, x0.y, b_hi[0], b_lo[0]);
        split_bf16x2(x1.x, x1.y, b_hi[1], b_lo[1]);
        mma_bf16(acc[j], a, b_lo);
        mma_bf16(acc[j], a, b_hi);
      }
    }
  } else {
    const int o1 = 16 * mt + gq, o2 = o1 + 8;
#pragma unroll 2
    for (int k0 = 0; k0 < TP; k0 += 8) {
      const int p1 = k0 + q, p2 = p1 + 4;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(d_s[dout_at<T>(o1, p1)], a_hi[0], a_lo[0]);
      split_tf32(d_s[dout_at<T>(o2, p1)], a_hi[1], a_lo[1]);
      split_tf32(d_s[dout_at<T>(o1, p2)], a_hi[2], a_lo[2]);
      split_tf32(d_s[dout_at<T>(o2, p2)], a_hi[3], a_lo[3]);
#pragma unroll
      for (int j = 0; j < C::NTW; ++j) {
        const int nt = nt0 + 2 * j;
        if (nt >= C::NT) break;
        const float* cr = dc_s + (8 * nt + gq) * C::LDC;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(cr[p1], b_hi[0], b_lo[0]);
        split_tf32(cr[p2], b_hi[1], b_lo[1]);
        mma_3xtf32(acc[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
}

// CV consecutive channels of one corner as floats (zeros when the corner
// is out).
template <typename T, int CV>
__device__ __forceinline__ void load_corner(const T* src, bool ok, float* v) {
#ifdef DCN_BWD_NO_GATHER
#pragma unroll
  for (int e = 0; e < CV; ++e) v[e] = ok ? 0.5f : 0.f;
  return;
#endif
  if (!ok) {
#pragma unroll
    for (int e = 0; e < CV; ++e) v[e] = 0.f;
    return;
  }
  dcn::load_f32<T, CV>(src, v);
}

// dst[e] += g[e] * wgt for CV consecutive channels of one corner: one
// vector atomic (sm_90 adds float2 and float4 in global memory as one
// operation), so a corner of 8 channels costs 2 atomics, not 8.
template <int CV>
__device__ __forceinline__ void scatter_corner(float* dst, const float* g,
                                               float wgt) {
  if constexpr (CV == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(g[0] * wgt, g[1] * wgt, g[2] * wgt, g[3] * wgt));
  } else if constexpr (CV == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst),
              make_float2(g[0] * wgt, g[1] * wgt));
  } else {
    atomicAdd(dst, g[0] * wgt);
  }
}

// K is the block's tap capacity. CHUNKED false: the kernel's K taps in
// one block per group; true: ktot taps in chunks of K (the last ragged),
// blockIdx.y = group * chunks + chunk. The taps' gradients are independent
// (dcol of tap k reads W's rows of tap k only), so a chunk is a whole
// backward of its taps, and shared memory stays that of K taps whatever
// ktot is.
template <typename T, int C_PER, int K, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, (Cfg<T, C_PER, K>::MIN_BLOCKS))
dcn_bwd_kernel(const T* __restrict__ x,       // (n, h, w, cin)
               const T* __restrict__ offset,  // (n, dg*2ktot, oh, ow)
               const T* __restrict__ mask,    // (n, dg*ktot, oh, ow)
               const T* __restrict__ wt,      // (dg, ktot, C_PER, cout)
               const T* __restrict__ dout,    // (n, cout, oh, ow)
               float* __restrict__ dx,        // (n, h, w, cin), zeroed
               T* __restrict__ doffset,       // (n, dg*2ktot, oh, ow)
               T* __restrict__ dmask,         // (n, dg*ktot, oh, ow)
               float* __restrict__ partial,   // (nb, dg, ktot*C_PER, cout)
               int n, int h, int w, int cin, int cout, int oh, int ow,
               int kw, int stride, int pad, int dil, int dg, int ktot_arg,
               bool vec) {
  using C = Cfg<T, C_PER, K>;
  // this block's taps k0 .. k0 + kn - 1 of ktot (compile-time 0, K, K
  // unless CHUNKED)
  const int ktot = CHUNKED ? ktot_arg : K;
  const int chunks = CHUNKED ? (ktot + K - 1) / K : 1;
  const int k0 = (blockIdx.y % chunks) * K;
  const int kn = CHUNKED ? min(K, ktot - k0) : K;
  const int kcv = kn * C_PER;
  constexpr int CV = C_PER >= 4 ? 4 : C_PER;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  T* W_s = reinterpret_cast<T*>(sm);                       // [KCN][LDW]
  T* d_s = reinterpret_cast<T*>(sm + C::W_BYTES);          // [TO][LDD]
  float* dc_s = reinterpret_cast<float*>(sm + C::W_BYTES + C::D_BYTES);
  // dc_s [KCN][LDC]: dcol, then the masked column over it

  const int P = oh * ow;
  const int tiles = (P + TP - 1) / TP;
  const int total = n * tiles;
  const int g = blockIdx.y / chunks, z = blockIdx.z, nz = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 3, nt0 = warp >> 2;
  const T* wg = wt + ((size_t)g * ktot + k0) * C_PER * cout;
  const long long plane = (long long)h * w * cin;

  for (int i = kcv * C::LDC + tid; i < C::KCN * C::LDC; i += THREADS)
    dc_s[i] = 0.f;
  if (z == 0 && nz == 1) stage_w<T, C_PER, K>(W_s, wg, kcv, 0, cout, tid);

  float acc_w[C::NTW][4];
#pragma unroll
  for (int j = 0; j < C::NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_w[j][e] = 0.f;

  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / tiles;
    const int p0 = (t % tiles) * TP;
    const T* doutb = dout + (size_t)b * cout * P;
    const T* xg = x + b * plane + g * C_PER;
    const T* offb = offset + (size_t)b * dg * 2 * ktot * P;
    const T* mb = mask + (size_t)b * dg * ktot * P;

    if (z == 0) {
      // ---- 1. dcol^T = dout^T . W_g over every channel chunk; chunk 0
      // last, so that it stays staged for dW ----
      float acc_d[C::NTW][4];
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_d[j][e] = 0.f;
      for (int c = nz - 1; c >= 0; --c) {
        if (nz > 1) stage_w<T, C_PER, K>(W_s, wg, kcv, c * TO, cout, tid);
        stage_dout<T>(d_s, doutb, c * TO, cout, p0, P, vec, tid);
        __syncthreads();
#ifndef DCN_BWD_NO_MMA
        mma_dcol<T, C_PER, K>(acc_d, W_s, d_s, mt, nt0, lane);
#endif
        if (c > 0) __syncthreads();
      }
      {
        const int p1 = 16 * mt + (lane >> 2), kq = 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < C::NTW; ++j) {
          const int nt = nt0 + 2 * j;
          if (nt >= C::NT) break;
          const int kc = 8 * nt + kq;
          if (kc < kcv) {
            dc_s[kc * C::LDC + p1] = acc_d[j][0];
            dc_s[kc * C::LDC + p1 + 8] = acc_d[j][2];
          }
          if (kc + 1 < kcv) {
            dc_s[(kc + 1) * C::LDC + p1] = acc_d[j][1];
            dc_s[(kc + 1) * C::LDC + p1 + 8] = acc_d[j][3];
          }
        }
      }
      __syncthreads();

      // ---- 2. per (tap, pixel): dx scatter, doffset, dmask, column ----
      float* dxg = dx + b * plane + g * C_PER;
      T* doffb = doffset + (size_t)b * dg * 2 * ktot * P;
      T* dmb = dmask + (size_t)b * dg * ktot * P;
#ifndef DCN_BWD_NO_ITEMS
      for (int it = tid; it < kn * TP; it += THREADS) {
        const int pl = it % TP, k = it / TP;
        const int p = p0 + pl;
        float* dcp = dc_s + k * C_PER * C::LDC + pl;  // channel c: c * LDC
        if (p >= P) {
#pragma unroll
          for (int c = 0; c < C_PER; ++c) dcp[c * C::LDC] = 0.f;
          continue;
        }
        const dcn::Sample s = dcn::sample_at(offb, mb, g, k0 + k, p, P, ktot,
                                             p / ow, p % ow, kw, h, w,
                                             stride, pad, dil);
        const bool ok00 = s.vy0 && s.vx0, ok01 = s.vy0 && s.vx1;
        const bool ok10 = s.vy1 && s.vx0, ok11 = s.vy1 && s.vx1;
        float gm = 0.f, gy = 0.f, gx = 0.f;
        if (s.any) {
          const float fy = s.fy, fx = s.fx, m = s.m;
          const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
          const float w10 = fy * (1.f - fx), w11 = fy * fx;
          const long long i00 = ((long long)s.y0 * w + s.x0) * cin;
          const long long i01 = i00 + cin;
          const long long i10 = i00 + (long long)w * cin;
          const long long i11 = i10 + cin;
#pragma unroll
          for (int c0 = 0; c0 < C_PER; c0 += CV) {
            float v00[CV], v01[CV], v10[CV], v11[CV];
            load_corner<T, CV>(xg + i00 + c0, ok00, v00);
            load_corner<T, CV>(xg + i01 + c0, ok01, v01);
            load_corner<T, CV>(xg + i10 + c0, ok10, v10);
            load_corner<T, CV>(xg + i11 + c0, ok11, v11);
            // the masked column, as dcn_common.cuh::masked_column forms it
            float col[CV];
#pragma unroll
            for (int e = 0; e < CV; ++e) col[e] = 0.f;
            if (ok00) dcn::add_corner<T, CV>(col, v00, 1.f - fy, 1.f - fx, m);
            if (ok01) dcn::add_corner<T, CV>(col, v01, 1.f - fy, fx, m);
            if (ok10) dcn::add_corner<T, CV>(col, v10, fy, 1.f - fx, m);
            if (ok11) dcn::add_corner<T, CV>(col, v11, fy, fx, m);
            dcn::finish_column<T, CV>(col, m);
            float dm[CV];
#pragma unroll
            for (int e = 0; e < CV; ++e) {
              const float d = dcp[(c0 + e) * C::LDC];
              const float smp = w00 * v00[e] + w01 * v01[e] + w10 * v10[e] +
                                w11 * v11[e];
              gm = fmaf(d, smp, gm);
              dm[e] = d * m;
              gy = fmaf(dm[e], (1.f - fx) * (v10[e] - v00[e]) +
                                   fx * (v11[e] - v01[e]), gy);
              gx = fmaf(dm[e], (1.f - fy) * (v01[e] - v00[e]) +
                                   fy * (v11[e] - v10[e]), gx);
              dcp[(c0 + e) * C::LDC] = col[e];
            }
#ifndef DCN_BWD_NO_ATOMICS
            if (ok00) scatter_corner<CV>(dxg + i00 + c0, dm, w00);
            if (ok01) scatter_corner<CV>(dxg + i01 + c0, dm, w01);
            if (ok10) scatter_corner<CV>(dxg + i10 + c0, dm, w10);
            if (ok11) scatter_corner<CV>(dxg + i11 + c0, dm, w11);
#endif
          }
        } else {
#pragma unroll
          for (int c = 0; c < C_PER; ++c) dcp[c * C::LDC] = 0.f;
        }
        const int kg = k0 + k;
        dmb[(size_t)(g * ktot + kg) * P + p] = from_f32<T>(gm);
        doffb[(size_t)(g * 2 * ktot + 2 * kg) * P + p] = from_f32<T>(gy);
        doffb[(size_t)(g * 2 * ktot + 2 * kg + 1) * P + p] = from_f32<T>(gx);
      }
#endif
    } else {
      // channels beyond the first 64: the column and this chunk of dout
      stage_dout<T>(d_s, doutb, z * TO, cout, p0, P, vec, tid);
      for (int it = tid; it < kn * TP; it += THREADS) {
        const int pl = it % TP, k = it / TP;
        const int p = p0 + pl;
        float v[C_PER];
#pragma unroll
        for (int c = 0; c < C_PER; ++c) v[c] = 0.f;
        if (p < P) {
          const dcn::Sample s = dcn::sample_at(offb, mb, g, k0 + k, p, P,
                                               ktot, p / ow, p % ow, kw, h,
                                               w, stride, pad, dil);
          dcn::masked_column<T, C_PER>(xg, s, w, cin, v);
        }
        float* dcp = dc_s + k * C_PER * C::LDC + pl;
#pragma unroll
        for (int c = 0; c < C_PER; ++c) dcp[c * C::LDC] = v[c];
      }
    }
    __syncthreads();

    // ---- 3. dW^T += dout . column^T: the tile's sum apart, joined by
    // one float32 add (the tensor cores round their sums toward zero) ----
    {
      float part[C::NTW][4];
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#ifndef DCN_BWD_NO_MMA
      mma_dw<T, C_PER, K>(part, d_s, dc_s, mt, nt0, lane);
#endif
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_w[j][e] += part[j][e];
    }
    __syncthreads();
  }

  // this block's partial: dW[k0 * C_PER + kc][o] for its taps and its 64
  // channels
  float* pb = partial +
              (((size_t)blockIdx.x * dg + g) * ktot + k0) * C_PER * cout;
  const int o1 = z * TO + 16 * mt + (lane >> 2), kq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) {
    const int nt = nt0 + 2 * j;
    if (nt >= C::NT) break;
    const int kc = 8 * nt + kq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = o1 + 8 * hh;
      if (o >= cout) continue;
      if (kc < kcv) pb[(size_t)kc * cout + o] = acc_w[j][2 * hh];
      if (kc + 1 < kcv) pb[(size_t)(kc + 1) * cout + o] = acc_w[j][2 * hh + 1];
    }
  }
}

template <typename T, int C_PER, int K, bool CHUNKED>
int launch(const T* x, const T* offset, const T* mask, const T* wt,
           const T* dout, float* dx, T* doffset, T* dmask, float* partial,
           int nb, int n, int h, int w, int cin, int cout, int oh, int ow,
           int kh, int kw, int stride, int pad, int dil, int dg,
           cudaStream_t stream) {
  using C = Cfg<T, C_PER, K>;
  auto kernel = dcn_bwd_kernel<T, C_PER, K, CHUNKED>;
  const int chunks = tap_chunks(kh, kw);
  if (C::SMEM > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e) return e;
  }
  const int P = oh * ow;
  const bool vec = P % (16 / (int)sizeof(T)) == 0 && (uintptr_t)dout % 16 == 0;
  const dim3 grid(nb, dg * chunks, (cout + TO - 1) / TO);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      x, offset, mask, wt, dout, dx, doffset, dmask, partial, n, h, w, cin,
      cout, oh, ow, kw, stride, pad, dil, dg, kh * kw, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* offset, const void* mask,
             const void* wt, const void* dout, void* dx, void* doffset,
             void* dmask, void* partial, int nb, int n, int h, int w, int cin,
             int cout, int oh, int ow, int kh, int kw, int stride, int pad,
             int dil, int dg, void* stream) {
  if (n == 0 || oh * ow == 0 || cout == 0 || nb < 1) return 0;
  const auto* xt = static_cast<const T*>(x);
  const auto* ot = static_cast<const T*>(offset);
  const auto* mt = static_cast<const T*>(mask);
  const auto* wt_ = static_cast<const T*>(wt);
  const auto* dt = static_cast<const T*>(dout);
  auto* dxf = static_cast<float*>(dx);
  auto* dot = static_cast<T*>(doffset);
  auto* dmt = static_cast<T*>(dmask);
  auto* pf = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  // 3x3 and 1x1 (EDVR's) with the tap count fixed at compile time; any
  // other kh x kw in chunks of BWD_TAP_CHUNK taps
  const int K = kh * kw;
#define DCN_CASE(C, KK, CH)                                                  \
  if (cin / dg == C)                                                         \
    return launch<T, C, KK, CH>(xt, ot, mt, wt_, dt, dxf, dot, dmt, pf, nb,  \
                                n, h, w, cin, cout, oh, ow, kh, kw, stride,  \
                                pad, dil, dg, st);
#define DCN_CPERS(KK, CH)                                                    \
  DCN_CASE(1, KK, CH) DCN_CASE(2, KK, CH) DCN_CASE(4, KK, CH)                \
  DCN_CASE(8, KK, CH) DCN_CASE(16, KK, CH) DCN_CASE(32, KK, CH)
  if (K == 9) {
    DCN_CPERS(9, false)
  } else if (K == 1) {
    DCN_CPERS(1, false)
  } else {
    DCN_CPERS(BWD_TAP_CHUNK, true)
  }
#undef DCN_CPERS
#undef DCN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers;
// x, offset, mask, wt, dout, doffset and dmask hold the entry's element
// type (float for dcn_bwd_f32, bf16 for dcn_bwd_bf16), dx and partial are
// float32 in both. `stream` is the caller's cudaStream_t. The caller checks
// shapes, dtypes, devices and contiguity, zeroes `dx` (channels-last,
// accumulated with atomics) and allocates `doffset`, `dmask` and the (nb,
// dg, K*C_PER, cout) `partial` workspace, whose sum over its first axis is
// dW in the forward's (dg, K, C_PER, cout) weight layout; nb blocks walk
// each group's pixel tiles (times dcn_bwd_tap_chunks(kh, kw) tap chunks).
// Returns the cudaError_t of the launch (0 on success); an
// unsupported cin/dg split returns cudaErrorInvalidValue without launching.
#define DCN_BWD_ARGS                                                         \
  const void *x, const void *offset, const void *mask, const void *wt,       \
      const void *dout, void *dx, void *doffset, void *dmask, void *partial, \
      int nb, int n, int h, int w, int cin, int cout, int oh, int ow, int kh, \
      int kw, int stride, int pad, int dil, int dg, void *stream
#define DCN_BWD_PASS                                                         \
  x, offset, mask, wt, dout, dx, doffset, dmask, partial, nb, n, h, w, cin,  \
      cout, oh, ow, kh, kw, stride, pad, dil, dg, stream

extern "C" int dcn_bwd_f32(DCN_BWD_ARGS) {
  return dispatch<float>(DCN_BWD_PASS);
}

extern "C" int dcn_bwd_bf16(DCN_BWD_ARGS) {
  return dispatch<__nv_bfloat16>(DCN_BWD_PASS);
}

// The tap chunks of a kh x kw backward: each (group, 64 output channels)
// takes nb blocks per chunk. Launches nothing.
extern "C" int dcn_bwd_tap_chunks(int kh, int kw) {
  return tap_chunks(kh, kw);
}
