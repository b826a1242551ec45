// Device code shared by the DCNv2 forward (dcn_fwd.cu) and backward
// (dcn_bwd.cu) kernels: element conversions, vector loads of a corner's
// channels, the sample geometry of one (tap, pixel) and the masked
// bilinear column, so that the backward recomputes exactly the column the
// forward contracted.
//
// Element types: float, and __nv_bfloat16. In bf16 the arithmetic follows
// the TPU kernel edvr_tpu/ops/dcn_band.py::band_forward (:501-536):
// coordinates, fractions, validity and coefficients in float32; each
// corner's coefficient (mask included) rounded to bf16, each corner's
// product with the bf16 table value rounded to bf16; sums in float32.
// Every conversion goes through the cuda_bf16.h intrinsics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace dcn {

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the nearest bf16 (ties to even) and widened back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// N consecutive elements of T as floats, read through the read-only cache
// in pieces of up to 16 bytes; src is aligned to the piece (channels-last
// rows of cin = dg * N elements keep every group's corner aligned).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ src,
                                         float* v) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) v[i * PER + j] = to_f32(e[j]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
  } else if constexpr (BYTES == 4) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(src));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
  } else {
    static_assert(BYTES == 2, "one bf16 element");
    const unsigned short u =
        __ldg(reinterpret_cast<const unsigned short*>(src));
    v[0] = to_f32(*reinterpret_cast<const T*>(&u));
  }
}

// Geometry of one (tap, pixel) sample: the floor corner, the bilinear
// fractions and which of the four corners lie inside the image. Validity
// is decided in float before any integer conversion, so offsets of any
// magnitude stay exact; y0/x0 are set only when some corner is valid.
struct Sample {
  float dy, dx, m;    // the offset and mask fields, as floats
  float y0f, x0f;     // floor of the sample coordinate
  float fy, fx;
  bool vy0, vy1, vx0, vx1;
  bool any;
  int y0, x0;
};

// The sample of tap k at output pixel (oy, ox) from its field values dy,
// dx (the offset) and m (the mask), as floats.
__device__ __forceinline__ Sample sample_from(float dy, float dx, float m,
                                              int k, int oy, int ox, int kw,
                                              int h, int w, int stride,
                                              int pad, int dil) {
  Sample s;
  const int i = k / kw, j = k % kw;
  s.dy = dy;
  s.dx = dx;
  s.m = m;
  const float cy = (float)(oy * stride - pad + i * dil) + s.dy;
  const float cx = (float)(ox * stride - pad + j * dil) + s.dx;
  s.y0f = floorf(cy);
  s.x0f = floorf(cx);
  s.fy = cy - s.y0f;
  s.fx = cx - s.x0f;
  s.vy0 = s.y0f >= 0.f && s.y0f <= (float)(h - 1);
  s.vy1 = s.y0f >= -1.f && s.y0f <= (float)(h - 2);
  s.vx0 = s.x0f >= 0.f && s.x0f <= (float)(w - 1);
  s.vx1 = s.x0f >= -1.f && s.x0f <= (float)(w - 2);
  s.any = (s.vy0 || s.vy1) && (s.vx0 || s.vx1);
  s.y0 = s.any ? (int)s.y0f : 0;
  s.x0 = s.any ? (int)s.x0f : 0;
  return s;
}

// The same, reading the fields of (group g, tap k, pixel p) from the
// offset (dg*2K rows) and mask (dg*K rows) planes of one image.
template <typename T>
__device__ __forceinline__ Sample sample_at(const T* offb, const T* mb, int g,
                                            int k, int p, int P, int K,
                                            int oy, int ox, int kw, int h,
                                            int w, int stride, int pad,
                                            int dil) {
  return sample_from(to_f32(offb[(size_t)(g * 2 * K + 2 * k) * P + p]),
                     to_f32(offb[(size_t)(g * 2 * K + 2 * k + 1) * P + p]),
                     to_f32(mb[(size_t)(g * K + k) * P + p]), k, oy, ox, kw,
                     h, w, stride, pad, dil);
}

// One corner's share of the masked bilinear sample of N channels: v[c] +=
// its contribution for table values t (wya, wxb: the corner's row and
// column factors). float: v += (wya * wxb) * t, the mask applied once at
// the end (finish_column); bf16: v += bf16(bf16(wya * m * wxb) * t), as
// band_forward rounds it.
template <typename T, int N>
__device__ __forceinline__ void add_corner(float* v, const float* t,
                                           float wya, float wxb, float m) {
  if constexpr (kBf16<T>) {
    const float coef = round_bf16((wya * m) * wxb);
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] += round_bf16(coef * t[c]);
  } else {
    const float wgt = wya * wxb;
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] += wgt * t[c];
  }
}

template <typename T, int N>
__device__ __forceinline__ void finish_column(float* v, float m) {
  if constexpr (!kBf16<T>) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] *= m;
  }
}

// The masked bilinear sample of C_PER channels (per-tap zero boundary:
// out-of-image corners contribute nothing), corners in the order 00, 01,
// 10, 11 (add_corner). float: v = (sum of coefficient x value) x mask, as
// the plain version computes it. bf16: v = sum of bf16(bf16(ay * bx) x
// value), the mask inside ay, as band_forward rounds it.
template <typename T, int C_PER>
__device__ __forceinline__ void masked_column(const T* __restrict__ xg,
                                              const Sample& s, int w,
                                              int cin, float* v) {
#pragma unroll
  for (int c = 0; c < C_PER; ++c) v[c] = 0.f;
  if (!s.any) return;
  const float wy[2] = {1.f - s.fy, s.fy};
  const float wx[2] = {1.f - s.fx, s.fx};
  const bool vy[2] = {s.vy0, s.vy1};
  const bool vx[2] = {s.vx0, s.vx1};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!(vy[a] && vx[b])) continue;
      float t[C_PER];
      load_f32<T, C_PER>(xg + ((size_t)(s.y0 + a) * w + (s.x0 + b)) * cin,
                         t);
      add_corner<T, C_PER>(v, t, wy[a], wx[b], s.m);
    }
  }
  finish_column<T, C_PER>(v, s.m);
}

}  // namespace dcn
