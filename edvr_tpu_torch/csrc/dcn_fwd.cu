// Modulated deformable convolution (DCNv2) forward, fp32 and bf16, for
// Hopper (sm_90a).
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
// 180x320, dg=8, 3x3 taps): 2*5*57600*64*576 = 21.2 GFLOP. In fp32 that is
// 0.32 ms at 67 TFLOP/s against ~396 MB of compulsory traffic (x, offset,
// mask read once, out written once), 0.12 ms at 3.35 TB/s: compute-bound on
// the fp32 pipe. In bf16 the traffic halves (0.059 ms) and the operations
// would take 0.021 ms on the tensor cores, so bf16 is bound by bytes; this
// kernel still contracts on the CUDA cores (a wgmma contraction is later
// work). The design keeps every intermediate on chip: one block owns TP
// output pixels of one image for TO output channels; for each deformable
// group it writes the masked bilinear column slice (K*C_PER x TP) and the
// group's weight slice (K*C_PER x TO) to shared memory in float32, then
// every thread accumulates a 4x4 (pixel x channel) register tile in fp32.
// The output is written once. x is read channels-last, so the C_PER
// channels of one corner are one contiguous read (16 bytes is 4 fp32 or 8
// bf16 channels).
//
// Ablation variants (dev tooling, the port of the TPU tool
// scripts/dev/ablate_band.py::build_variant): the compile-time MODE strips
// components of this same kernel, so no variant can drift from the shipped
// one (MODE = FULL). The components are (a) reading the offset and mask
// fields, (b) the per-(pixel, tap) coordinate and coefficient math, (c)
// the four corner loads from x, (d) the blend into the shared-memory
// column and (e) the register-tiled contraction. Each variant computes a
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
// Every variant adds the bias and stores as FULL does.

#include "dcn_common.cuh"

namespace {

using dcn::from_f32;
using dcn::kBf16;
using dcn::round_bf16;
using dcn::to_f32;

constexpr int TP = 64;        // output pixels per block
constexpr int TO = 64;        // output channels per block
constexpr int THREADS = 256;  // 16 pixel groups x 16 channel groups

enum Mode { FULL = 0, NO_COEF, INT_COEF, NO_GATHER, COORDS_ONLY, IO_ONLY };

template <typename T, int C_PER, int MODE>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const T* __restrict__ x,       // (n, h, w, cin)
               const T* __restrict__ offset,  // (n, dg*2K, oh, ow)
               const T* __restrict__ mask,    // (n, dg*K, oh, ow)
               const T* __restrict__ wt,      // (dg, K, C_PER, cout)
               const T* __restrict__ bias,    // (cout) or null
               T* __restrict__ out,           // (n, cout, oh, ow)
               int h, int w, int cin, int cout, int oh, int ow, int kh,
               int kw, int stride, int pad, int dil, int dg) {
  // COORDS_ONLY and IO_ONLY neither stage weights nor contract: one value
  // per (tap, pixel) goes to the column, summed over the taps
  constexpr bool CONTRACT = MODE != COORDS_ONLY && MODE != IO_ONLY;
  constexpr int CW = CONTRACT ? C_PER : 1;  // column rows per tap
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = kh * kw;
  const int KC = K * C_PER;
  float* col_s = smem;           // [K*CW][TP]
  float* w_s = smem + KC * TP;   // [KC][TO]

  const int P = oh * ow;
  const int tiles = (P + TP - 1) / TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * TP;
  const int o0 = blockIdx.y * TO;
  const int tid = threadIdx.x;
  // neighbouring threads own neighbouring pixels, so the epilogue's stores
  // of one output channel are contiguous
  const int tp = tid & 15;   // pixels p0 + 4*tp .. +3
  const int to = tid >> 4;   // channels o0 + 4*to .. +3

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  const T* xb = x + (size_t)b * h * w * cin;
  const T* offb = offset + (size_t)b * dg * 2 * K * P;
  const T* mb = mask + (size_t)b * dg * K * P;

  for (int g = 0; g < dg; ++g) {
    if constexpr (CONTRACT) {
      const T* wg = wt + (size_t)g * KC * cout;
      for (int i = tid; i < KC * TO; i += THREADS) {
        const int kc = i / TO, o = o0 + i % TO;
        w_s[i] = o < cout ? to_f32(wg[(size_t)kc * cout + o]) : 0.f;
      }
    }

    const T* xg = xb + g * C_PER;
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
        if constexpr (MODE == FULL) {
          dcn::masked_column<T, C_PER>(xg, s, w, cin, v);
        } else if constexpr (MODE == NO_COEF) {
          // the four corners clamped into the image, summed unweighted
          const int ya = (int)fminf(fmaxf(s.y0f, 0.f), (float)(h - 1));
          const int yb = (int)fminf(fmaxf(s.y0f + 1.f, 0.f), (float)(h - 1));
          const int xa = (int)fminf(fmaxf(s.x0f, 0.f), (float)(w - 1));
          const int xc = (int)fminf(fmaxf(s.x0f + 1.f, 0.f), (float)(w - 1));
          const int ys[2] = {ya, yb}, xs[2] = {xa, xc};
#pragma unroll
          for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              float t[C_PER];
              dcn::load_f32<T, C_PER>(
                  xg + ((size_t)ys[a] * w + xs[bb]) * cin, t);
#pragma unroll
              for (int c = 0; c < C_PER; ++c) v[c] += t[c];
            }
          }
          v[0] += 0.f * s.m;
        } else if constexpr (MODE == INT_COEF) {
          if (s.vy0 && s.vx0) {
            float t[C_PER];
            dcn::load_f32<T, C_PER>(xg + ((size_t)s.y0 * w + s.x0) * cin,
                                    t);
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
#pragma unroll
      for (int c = 0; c < CW; ++c) col_s[(k * CW + c) * TP + pl] = v[c];
    }
    __syncthreads();

    if constexpr (CONTRACT) {
#pragma unroll 4
      for (int kc = 0; kc < KC; ++kc) {
        const float4 a =
            *reinterpret_cast<const float4*>(&col_s[kc * TP + 4 * tp]);
        const float4 wv =
            *reinterpret_cast<const float4*>(&w_s[kc * TO + 4 * to]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][jj] = fmaf(av[ii], wr[jj], acc[ii][jj]);
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float sum = 0.f;
        for (int k = 0; k < K; ++k) sum += col_s[k * TP + 4 * tp + ii];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int o = o0 + 4 * to + jj;
    if (o >= cout) continue;
    T* ob = out + ((size_t)b * cout + o) * P;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int p = p0 + 4 * tp + ii;
      if (p >= P) continue;
      if constexpr (kBf16<T>) {
        const __nv_bfloat16 r = from_f32<T>(acc[ii][jj]);
        ob[p] = bias ? from_f32<T>(to_f32(r) + to_f32(bias[o])) : r;
      } else {
        ob[p] = acc[ii][jj] + (bias ? bias[o] : 0.f);
      }
    }
  }
}

template <typename T, int C_PER, int MODE>
int launch(const void* x, const void* offset, const void* mask,
           const void* wt, const void* bias, void* out, int n, int h, int w,
           int cin, int cout, int oh, int ow, int kh, int kw, int stride,
           int pad, int dil, int dg, cudaStream_t stream) {
  const size_t smem = (size_t)kh * kw * C_PER * (TP + TO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dcn_fwd_kernel<T, C_PER, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int P = oh * ow;
  const dim3 grid(n * ((P + TP - 1) / TP), (cout + TO - 1) / TO);
  dcn_fwd_kernel<T, C_PER, MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(wt),
      static_cast<const T*>(bias), static_cast<T*>(out), h, w, cin, cout, oh,
      ow, kh, kw, stride, pad, dil, dg);
  return (int)cudaGetLastError();
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
    return launch<T, C, MODE>(x, offset, mask, wt, bias, out, n, h, w, cin,  \
                              cout, oh, ow, kh, kw, stride, pad, dil, dg,    \
                              st);
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
