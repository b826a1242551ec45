// Modulated deformable convolution (DCNv2) forward, fp32, for Hopper (sm_90a).
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
// What bounds it on an H100 SXM, reckoned at EDVR-M L1 (n=5, 64 channels,
// 180x320, dg=8, 3x3 taps): 2*5*57600*64*576 = 21.2 GFLOP of fp32 FMA work,
// 0.32 ms at 67 TFLOP/s, against ~396 MB of compulsory traffic (x, offset,
// mask read once, out written once), 0.12 ms at 3.35 TB/s. So it is
// compute-bound on the fp32 pipe. The design keeps every intermediate on
// chip: one block owns TP output pixels of one image for TO output channels;
// for each deformable group it writes the masked bilinear column slice
// (K*C_PER x TP) and the group's weight slice (K*C_PER x TO) to shared
// memory, then every thread accumulates a 4x4 (pixel x channel) register
// tile in fp32. The output is written once. x is read channels-last, so the
// C_PER channels of one corner are one contiguous read.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;        // output pixels per block
constexpr int TO = 64;        // output channels per block
constexpr int THREADS = 256;  // 16 pixel groups x 16 channel groups

template <int C_PER>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const float* __restrict__ x,       // (n, h, w, cin)
               const float* __restrict__ offset,  // (n, dg*2K, oh, ow)
               const float* __restrict__ mask,    // (n, dg*K, oh, ow)
               const float* __restrict__ wt,      // (dg, K, C_PER, cout)
               const float* __restrict__ bias,    // (cout) or null
               float* __restrict__ out,           // (n, cout, oh, ow)
               int h, int w, int cin, int cout, int oh, int ow, int kh,
               int kw, int stride, int pad, int dil, int dg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = kh * kw;
  const int KC = K * C_PER;
  float* col_s = smem;           // [KC][TP]
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

  const float* xb = x + (size_t)b * h * w * cin;
  const float* offb = offset + (size_t)b * dg * 2 * K * P;
  const float* mb = mask + (size_t)b * dg * K * P;

  for (int g = 0; g < dg; ++g) {
    const float* wg = wt + (size_t)g * KC * cout;
    for (int i = tid; i < KC * TO; i += THREADS) {
      const int kc = i / TO, o = o0 + i % TO;
      w_s[i] = o < cout ? wg[(size_t)kc * cout + o] : 0.f;
    }

    const float* xg = xb + g * C_PER;
    for (int q = tid; q < K * TP; q += THREADS) {
      const int pl = q % TP, k = q / TP;
      const int p = p0 + pl;
      float v[C_PER];
#pragma unroll
      for (int c = 0; c < C_PER; ++c) v[c] = 0.f;
      if (p < P) {
        const int oy = p / ow, ox = p % ow;
        const int i = k / kw, j = k % kw;
        const float dy = offb[(size_t)(g * 2 * K + 2 * k) * P + p];
        const float dx = offb[(size_t)(g * 2 * K + 2 * k + 1) * P + p];
        const float m = mb[(size_t)(g * K + k) * P + p];
        const float cy = (float)(oy * stride - pad + i * dil) + dy;
        const float cx = (float)(ox * stride - pad + j * dil) + dx;
        const float y0f = floorf(cy), x0f = floorf(cx);
        const float fy = cy - y0f, fx = cx - x0f;
        // corner validity is decided in float before any integer
        // conversion, so offsets of any magnitude stay exact (per-tap zero
        // boundary: out-of-image corners contribute nothing)
        const bool vy0 = y0f >= 0.f && y0f <= (float)(h - 1);
        const bool vy1 = y0f >= -1.f && y0f <= (float)(h - 2);
        const bool vx0 = x0f >= 0.f && x0f <= (float)(w - 1);
        const bool vx1 = x0f >= -1.f && x0f <= (float)(w - 2);
        if ((vy0 || vy1) && (vx0 || vx1)) {
          const int y0 = (int)y0f, x0 = (int)x0f;
          auto corner = [&](int yy, int xx, float wgt) {
            const float* src = xg + ((size_t)yy * w + xx) * cin;
            if constexpr (C_PER % 4 == 0) {
#pragma unroll
              for (int c4 = 0; c4 < C_PER / 4; ++c4) {
                const float4 t = __ldg(reinterpret_cast<const float4*>(src) + c4);
                v[4 * c4 + 0] += wgt * t.x;
                v[4 * c4 + 1] += wgt * t.y;
                v[4 * c4 + 2] += wgt * t.z;
                v[4 * c4 + 3] += wgt * t.w;
              }
            } else {
#pragma unroll
              for (int c = 0; c < C_PER; ++c) v[c] += wgt * __ldg(src + c);
            }
          };
          if (vy0 && vx0) corner(y0, x0, (1.f - fy) * (1.f - fx));
          if (vy0 && vx1) corner(y0, x0 + 1, (1.f - fy) * fx);
          if (vy1 && vx0) corner(y0 + 1, x0, fy * (1.f - fx));
          if (vy1 && vx1) corner(y0 + 1, x0 + 1, fy * fx);
        }
#pragma unroll
        for (int c = 0; c < C_PER; ++c) v[c] *= m;
      }
#pragma unroll
      for (int c = 0; c < C_PER; ++c) col_s[(k * C_PER + c) * TP + pl] = v[c];
    }
    __syncthreads();

#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      const float4 a = *reinterpret_cast<const float4*>(&col_s[kc * TP + 4 * tp]);
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[kc * TO + 4 * to]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], wr[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int o = o0 + 4 * to + jj;
    if (o >= cout) continue;
    const float bv = bias ? bias[o] : 0.f;
    float* ob = out + ((size_t)b * cout + o) * P;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int p = p0 + 4 * tp + ii;
      if (p < P) ob[p] = acc[ii][jj] + bv;
    }
  }
}

template <int C_PER>
int launch(const float* x, const float* offset, const float* mask,
           const float* wt, const float* bias, float* out, int n, int h,
           int w, int cin, int cout, int oh, int ow, int kh, int kw,
           int stride, int pad, int dil, int dg, cudaStream_t stream) {
  const size_t smem = (size_t)kh * kw * C_PER * (TP + TO) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dcn_fwd_kernel<C_PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int P = oh * ow;
  const dim3 grid(n * ((P + TP - 1) / TP), (cout + TO - 1) / TO);
  dcn_fwd_kernel<C_PER><<<grid, THREADS, smem, stream>>>(
      x, offset, mask, wt, bias, out, h, w, cin, cout, oh, ow, kh, kw, stride,
      pad, dil, dg);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// `stream` is the caller's cudaStream_t. The caller checks shapes, dtypes,
// devices and contiguity and allocates `out`. Returns the cudaError_t of
// the launch (0 on success); an unsupported cin/dg split returns
// cudaErrorInvalidValue without launching.
extern "C" int dcn_fwd_f32(const void* x, const void* offset,
                           const void* mask, const void* wt,
                           const void* bias, void* out, int n, int h, int w,
                           int cin, int cout, int oh, int ow, int kh, int kw,
                           int stride, int pad, int dil, int dg,
                           void* stream) {
  if (n == 0 || oh * ow == 0 || cout == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* of = static_cast<const float*>(offset);
  const auto* mf = static_cast<const float*>(mask);
  const auto* wf = static_cast<const float*>(wt);
  const auto* bf = static_cast<const float*>(bias);
  auto* outf = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define DCN_CASE(C)                                                          \
  case C:                                                                    \
    return launch<C>(xf, of, mf, wf, bf, outf, n, h, w, cin, cout, oh, ow,   \
                     kh, kw, stride, pad, dil, dg, st);
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
