// Modulated deformable convolution (DCNv2) backward, fp32 and bf16, for
// Hopper (sm_90a).
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
// mask, weights and dout in bf16) every sum and product is float32: dcol,
// d_offset and d_mask in float32 (the latter two stored in bf16), dx
// scattered with float32 atomics into a float32 buffer that the caller
// casts (bf16 atomics would lose the sum), dW summed from float32
// partials; the weight gradient contracts the column the bf16 forward
// contracted (dcn_common.cuh::masked_column, with its rounding points).
// floor() has no gradient
// and corner validity is a step, so the derivative at an exactly integer
// coordinate follows the same floor convention as the plain version
// (edvr_tpu_torch/ops/dcn.py::modulated_deform_conv_plain).
//
// What bounds it on an H100 SXM, reckoned at the EDVR-M training L1 shape
// (n=20 frames of a 64x64 crop, 64 channels, dg=8, 3x3 taps): the two
// contractions (dcol and dW) are 2 x 2*64*576*81920 = 12.1 GFLOP of fp32
// FMA work, 0.18 ms at 67 TFLOP/s, against ~205 MB of compulsory traffic
// (x, offset, mask, dout read once; dx, doffset, dmask written once),
// 0.06 ms at 3.35 TB/s. So, like the forward, it is bounded by the fp32
// pipe; in bf16 the operations would take 0.012 ms on the tensor cores
// and the traffic about half, 0.03 ms, so there bytes bound it.
//
// Two launches, both with their products inside the kernel body:
//
// (a) dcn_bwd_data: one block per (image, 64-pixel tile, deformable group).
//     It stages the group's weight slice and the dout tile in shared
//     memory, contracts them in registers (each thread a RT x 4 tile of
//     dcol, rows kc = tr + 16 r) into a K*C_PER x 64 dcol tile in shared
//     memory, then one thread per (tap, pixel) walks the C_PER channels:
//     it reads the four corners once (channels-last, so a corner's
//     channels are one contiguous read), accumulates dmask and doffset in
//     registers (no cross-thread reduction is needed) and scatters dx to
//     the corners with fp32 vector atomicAdd (float4: four channels per
//     operation) into a channels-last buffer. Atomics make dx's summation
//     order vary from run to run; a deterministic scatter would need a
//     sort or per-tile windows (the band kernel's fold), which is a later
//     PR's choice.
// (b) dcn_bwd_weight: one block per (pixel chunk, deformable group, 64
//     output channels). It walks its chunk's tiles, recomputes the masked
//     column tile as the forward does, stages the transposed dout tile, and
//     accumulates dW in registers; each block writes one partial to a
//     workspace. The caller's sum over partials is the cross-block second
//     pass: deterministic, and a few MB at these shapes.

#include "dcn_common.cuh"

namespace {

using dcn::from_f32;
using dcn::to_f32;

constexpr int TP = 64;        // pixels per tile
constexpr int TO = 64;        // output channels per chunk
constexpr int TOS = TO + 4;   // padded row of the transposed dout tile
constexpr int THREADS = 256;  // 16 x 16

// CV consecutive channels of one corner as floats (zeros when the corner
// is out).
template <typename T, int CV>
__device__ __forceinline__ void load_corner(const T* src, bool ok, float* v) {
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

template <typename T, int C_PER, int K>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_data_kernel(const T* __restrict__ x,       // (n, h, w, cin)
                    const T* __restrict__ offset,  // (n, dg*2K, oh, ow)
                    const T* __restrict__ mask,    // (n, dg*K, oh, ow)
                    const T* __restrict__ wt,      // (dg, K, C_PER, cout)
                    const T* __restrict__ dout,    // (n, cout, oh, ow)
                    float* __restrict__ dx,        // (n, h, w, cin), zeroed
                    T* __restrict__ doffset,       // (n, dg*2K, oh, ow)
                    T* __restrict__ dmask,         // (n, dg*K, oh, ow)
                    int h, int w, int cin, int cout, int oh, int ow, int kw,
                    int stride, int pad, int dil, int dg) {
  constexpr int KC = K * C_PER;
  constexpr int RT = (KC + 15) / 16;  // dcol rows per thread
  constexpr int KCP = 16 * RT;
  constexpr int CV = C_PER >= 4 ? 4 : C_PER;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;                // [KCP][TO], rows >= KC zero
  float* d_s = w_s + KCP * TO;      // [TO][TP]
  float* dcol_s = d_s + TO * TP;    // [KC][TP]

  const int P = oh * ow;
  const int tiles = (P + TP - 1) / TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * TP;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int tp = tid & 15;  // pixels 4*tp .. +3
  const int tr = tid >> 4;  // dcol rows tr + 16 r

  // ---- dcol = W_g^T . dout over the tile, in registers ----
  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  const T* wg = wt + (size_t)g * KC * cout;
  const T* doutb = dout + (size_t)b * cout * P;
  for (int o0 = 0; o0 < cout; o0 += TO) {
    for (int i = tid; i < KCP * TO; i += THREADS) {
      const int kc = i / TO, o = o0 + i % TO;
      w_s[i] = (kc < KC && o < cout) ? to_f32(wg[(size_t)kc * cout + o])
                                     : 0.f;
    }
    for (int i = tid; i < TO * TP; i += THREADS) {
      const int o = o0 + i / TP, p = p0 + i % TP;
      d_s[i] = (o < cout && p < P) ? to_f32(doutb[(size_t)o * P + p]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int o = 0; o < TO; ++o) {
      const float4 d = *reinterpret_cast<const float4*>(&d_s[o * TP + 4 * tp]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float wv = w_s[(tr + 16 * r) * TO + o];
        acc[r][0] = fmaf(wv, d.x, acc[r][0]);
        acc[r][1] = fmaf(wv, d.y, acc[r][1]);
        acc[r][2] = fmaf(wv, d.z, acc[r][2]);
        acc[r][3] = fmaf(wv, d.w, acc[r][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int kc = tr + 16 * r;
    if (kc < KC)
      *reinterpret_cast<float4*>(&dcol_s[kc * TP + 4 * tp]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // ---- per (tap, pixel): dx scatter, doffset and dmask ----
  const long long plane = (long long)h * w * cin;
  const T* xg = x + b * plane + g * C_PER;
  float* dxg = dx + b * plane + g * C_PER;
  const T* offb = offset + (size_t)b * dg * 2 * K * P;
  const T* mb = mask + (size_t)b * dg * K * P;
  T* doffb = doffset + (size_t)b * dg * 2 * K * P;
  T* dmb = dmask + (size_t)b * dg * K * P;
  for (int q = tid; q < K * TP; q += THREADS) {
    const int pl = q % TP, k = q / TP;
    const int p = p0 + pl;
    if (p >= P) continue;
    const dcn::Sample s = dcn::sample_at(offb, mb, g, k, p, P, K, p / ow,
                                         p % ow, kw, h, w, stride, pad, dil);
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
        float dm[CV];
#pragma unroll
        for (int e = 0; e < CV; ++e) {
          const float d = dcol_s[(k * C_PER + c0 + e) * TP + pl];
          const float smp = w00 * v00[e] + w01 * v01[e] + w10 * v10[e] +
                            w11 * v11[e];
          gm = fmaf(d, smp, gm);
          dm[e] = d * m;
          gy = fmaf(dm[e], (1.f - fx) * (v10[e] - v00[e]) +
                               fx * (v11[e] - v01[e]), gy);
          gx = fmaf(dm[e], (1.f - fy) * (v01[e] - v00[e]) +
                               fy * (v11[e] - v10[e]), gx);
        }
        if (ok00) scatter_corner<CV>(dxg + i00 + c0, dm, w00);
        if (ok01) scatter_corner<CV>(dxg + i01 + c0, dm, w01);
        if (ok10) scatter_corner<CV>(dxg + i10 + c0, dm, w10);
        if (ok11) scatter_corner<CV>(dxg + i11 + c0, dm, w11);
      }
    }
    dmb[(size_t)(g * K + k) * P + p] = from_f32<T>(gm);
    doffb[(size_t)(g * 2 * K + 2 * k) * P + p] = from_f32<T>(gy);
    doffb[(size_t)(g * 2 * K + 2 * k + 1) * P + p] = from_f32<T>(gx);
  }
}

template <typename T, int C_PER, int K>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_weight_kernel(const T* __restrict__ x,       // (n, h, w, cin)
                      const T* __restrict__ offset,  // (n, dg*2K, oh, ow)
                      const T* __restrict__ mask,    // (n, dg*K, oh, ow)
                      const T* __restrict__ dout,    // (n, cout, oh, ow)
                      float* __restrict__ partial,  // (nb, dg, K*C_PER, cout)
                      int n, int h, int w, int cin, int cout, int oh, int ow,
                      int kw, int stride, int pad, int dil, int dg) {
  constexpr int KC = K * C_PER;
  constexpr int RT = (KC + 15) / 16;  // dW rows per thread
  constexpr int KCP = 16 * RT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* col_s = smem;               // [KCP][TP], rows >= KC zero
  float* d_s = col_s + KCP * TP;     // [TP][TOS], dout transposed

  const int P = oh * ow;
  const int tiles = (P + TP - 1) / TP;
  const int total = n * tiles;
  const int g = blockIdx.y;
  const int o0 = blockIdx.z * TO;
  const int tid = threadIdx.x;
  const int to = tid & 15;  // channels o0 + 4*to .. +3
  const int tr = tid >> 4;  // dW rows tr + 16 r

  for (int i = KC * TP + tid; i < KCP * TP; i += THREADS) col_s[i] = 0.f;

  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  const long long plane = (long long)h * w * cin;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / tiles;
    const int p0 = (t % tiles) * TP;
    const T* doutb = dout + (size_t)b * cout * P;
    for (int i = tid; i < TO * TP; i += THREADS) {
      const int o = o0 + i / TP, pl = i % TP;
      d_s[pl * TOS + i / TP] = (o < cout && p0 + pl < P)
                                   ? to_f32(doutb[(size_t)o * P + p0 + pl])
                                   : 0.f;
    }

    // the masked column tile, as the forward builds it
    const T* xg = x + b * plane + g * C_PER;
    const T* offb = offset + (size_t)b * dg * 2 * K * P;
    const T* mb = mask + (size_t)b * dg * K * P;
    for (int q = tid; q < K * TP; q += THREADS) {
      const int pl = q % TP, k = q / TP;
      const int p = p0 + pl;
      float v[C_PER];
#pragma unroll
      for (int c = 0; c < C_PER; ++c) v[c] = 0.f;
      if (p < P) {
        const dcn::Sample s = dcn::sample_at(offb, mb, g, k, p, P, K, p / ow,
                                             p % ow, kw, h, w, stride, pad,
                                             dil);
        dcn::masked_column<T, C_PER>(xg, s, w, cin, v);
      }
#pragma unroll
      for (int c = 0; c < C_PER; ++c) col_s[(k * C_PER + c) * TP + pl] = v[c];
    }
    __syncthreads();

#pragma unroll 4
    for (int pl = 0; pl < TP; ++pl) {
      const float4 d = *reinterpret_cast<const float4*>(&d_s[pl * TOS + 4 * to]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float c = col_s[(tr + 16 * r) * TP + pl];
        acc[r][0] = fmaf(c, d.x, acc[r][0]);
        acc[r][1] = fmaf(c, d.y, acc[r][1]);
        acc[r][2] = fmaf(c, d.z, acc[r][2]);
        acc[r][3] = fmaf(c, d.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

  float* pb = partial + ((size_t)blockIdx.x * dg + g) * KC * cout;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int kc = tr + 16 * r;
    if (kc >= KC) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + 4 * to + e;
      if (o < cout) pb[(size_t)kc * cout + o] = acc[r][e];
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int C_PER, int K>
int launch(const T* x, const T* offset, const T* mask, const T* wt,
           const T* dout, float* dx, T* doffset, T* dmask, float* partial,
           int nb, int n, int h, int w, int cin, int cout, int oh, int ow,
           int kw, int stride, int pad, int dil, int dg,
           cudaStream_t stream) {
  constexpr int KC = K * C_PER;
  constexpr int KCP = 16 * ((KC + 15) / 16);
  const int P = oh * ow;
  const int tiles = (P + TP - 1) / TP;

  const size_t smem_a = (size_t)(KCP * TO + TO * TP + KC * TP) * sizeof(float);
  int e = allow_smem(dcn_bwd_data_kernel<T, C_PER, K>, smem_a);
  if (e) return e;
  dcn_bwd_data_kernel<T, C_PER, K><<<dim3(n * tiles, dg), THREADS, smem_a,
                                     stream>>>(
      x, offset, mask, wt, dout, dx, doffset, dmask, h, w, cin, cout, oh, ow,
      kw, stride, pad, dil, dg);
  e = (int)cudaGetLastError();
  if (e) return e;

  const size_t smem_b = (size_t)(KCP * TP + TP * TOS) * sizeof(float);
  e = allow_smem(dcn_bwd_weight_kernel<T, C_PER, K>, smem_b);
  if (e) return e;
  dcn_bwd_weight_kernel<T, C_PER, K><<<dim3(nb, dg, (cout + TO - 1) / TO),
                                       THREADS, smem_b, stream>>>(
      x, offset, mask, dout, partial, n, h, w, cin, cout, oh, ow, kw, stride,
      pad, dil, dg);
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
#define DCN_CASE(C, KK)                                                      \
  if (cin / dg == C && kh * kw == KK)                                        \
    return launch<T, C, KK>(xt, ot, mt, wt_, dt, dxf, dot, dmt, pf, nb, n,   \
                            h, w, cin, cout, oh, ow, kw, stride, pad, dil,   \
                            dg, st);
  DCN_CASE(1, 9)
  DCN_CASE(2, 9)
  DCN_CASE(4, 9)
  DCN_CASE(8, 9)
  DCN_CASE(16, 9)
  DCN_CASE(32, 9)
  DCN_CASE(1, 1)
  DCN_CASE(2, 1)
  DCN_CASE(4, 1)
  DCN_CASE(8, 1)
  DCN_CASE(16, 1)
  DCN_CASE(32, 1)
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
// dW in the forward's (dg, K, C_PER, cout) weight layout. Returns the
// cudaError_t of the launches (0 on success); an unsupported cin/dg split
// or tap count returns cudaErrorInvalidValue without launching.
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
