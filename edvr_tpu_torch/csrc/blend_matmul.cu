// Fused blend + tap-concatenation GEMM of the packed DCN route, fp32, for
// Hopper (sm_90a):
//
//     out = out_prev + (g_cat * repeat_interleave(cs_cat, C_PER, 1)) @ wexp_g
//
// Replaces the TPU kernel edvr_tpu/ops/dcn_pallas.py::blend_matmul_group
// (the forward of blend_matmul_group_ad, wired in by
// edvr_tpu/ops/dcn.py::_mdcn_packed under EDVR_TPU_DCN_PALLAS=1).
// g_cat (NP, W) holds one deformable group's K gathered 128-lane tiles per
// output pixel, lane-concatenated (W = K*lanes); cs_cat (NP, W/C_PER) the
// compact per-slot bilinear coefficients; wexp_g (W, cout) the tap weights
// tiled across the slots. The TPU kernel expands the coefficients with a
// one-hot matmul on the MXU and pads NP to its block rows; here each
// coefficient is read once per slot while the chunk is staged, and the
// ragged tail of NP is masked.
//
// What bounds it on an H100 SXM, reckoned at EDVR-M inference L1 (one
// group, NP = 288,000, W = 1152, cout = 64): 2*NP*W*cout = 42.5 GFLOP of
// fp32 FMA work, 0.63 ms at 67 TFLOP/s, against 1.64 GB of compulsory
// traffic (g_cat, cs_cat, out_prev read once, out written once), 0.49 ms
// at 3.35 TB/s. So it is compute-bound on the fp32 pipe, by a formulation
// that spends 16x the work of the direct DCN (at most 4 of the 16 slots
// carry a non-zero coefficient). The design is the register-tiled SIMT
// GEMM of dcn_fwd.cu: a block owns 64 rows x 64 output channels; per
// 32-wide chunk of W it stages the blended g_cat chunk (multiplied by its
// slot's coefficient on the way in, stored transposed) and the matching
// wexp_g rows in shared memory, and every thread accumulates a 4x4
// (row x channel) register tile in fp32. out_prev is added at the store.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;        // rows (output pixels) per block
constexpr int TO = 64;        // output channels per block
constexpr int BK = 32;        // width of the contraction chunk
constexpr int LDG = TP + 4;   // padded row of the staged chunk, 16-byte aligned
constexpr int THREADS = 256;  // 16 row groups x 16 channel groups

template <int C_PER>
__global__ void __launch_bounds__(THREADS)
blend_matmul_kernel(const float* __restrict__ g,     // (NP, W)
                    const float* __restrict__ cs,    // (NP, W / C_PER)
                    const float* __restrict__ wexp,  // (W, cout)
                    const float* __restrict__ prev,  // (NP, cout)
                    float* __restrict__ out,         // (NP, cout)
                    int NP, int W, int cout) {
  __shared__ __align__(16) float g_s[BK * LDG];  // [BK][TP], blended
  __shared__ __align__(16) float w_s[BK * TO];   // [BK][TO]

  const int r0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TO;
  const int tid = threadIdx.x;
  // neighbouring threads own neighbouring channels, so the epilogue's
  // stores of one row are contiguous
  const int to = tid & 15;  // channels o0 + 4*to .. +3
  const int tp = tid >> 4;  // rows r0 + 4*tp .. +3
  const int CW = W / C_PER;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < W; k0 += BK) {
    // the g_cat chunk, 16 bytes a thread (8 threads cover one row's 32
    // columns), times each column's slot coefficient
#pragma unroll
    for (int pass = 0; pass < TP * BK / 4 / THREADS; ++pass) {
      const int q = tid + pass * THREADS;
      const int rl = q / (BK / 4), c4 = q % (BK / 4);
      const int r = r0 + rl, c = k0 + 4 * c4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < NP && c < W) {  // W % 4 == 0: the whole float4 is in range
        const float4 t = __ldg(reinterpret_cast<const float4*>(g + (size_t)r * W + c));
        const float* csr = cs + (size_t)r * CW;
        if constexpr (C_PER >= 4) {  // c % 4 == 0: one slot for all four
          const float s = __ldg(csr + c / C_PER);
          v[0] = t.x * s; v[1] = t.y * s; v[2] = t.z * s; v[3] = t.w * s;
        } else {
          v[0] = t.x * __ldg(csr + (c + 0) / C_PER);
          v[1] = t.y * __ldg(csr + (c + 1) / C_PER);
          v[2] = t.z * __ldg(csr + (c + 2) / C_PER);
          v[3] = t.w * __ldg(csr + (c + 3) / C_PER);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) g_s[(4 * c4 + e) * LDG + rl] = v[e];
    }
    for (int q = tid; q < BK * TO; q += THREADS) {
      const int kc = q / TO, o = o0 + q % TO;
      w_s[q] = (k0 + kc < W && o < cout) ? __ldg(wexp + (size_t)(k0 + kc) * cout + o) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < BK; ++kc) {
      const float4 a = *reinterpret_cast<const float4*>(&g_s[kc * LDG + 4 * tp]);
      const float4 b = *reinterpret_cast<const float4*>(&w_s[kc * TO + 4 * to]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = r0 + 4 * tp + ii;
    if (r >= NP) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = o0 + 4 * to + jj;
      if (o < cout) {
        const size_t at = (size_t)r * cout + o;
        out[at] = prev[at] + acc[ii][jj];
      }
    }
  }
}

template <int C_PER>
int launch(const float* g, const float* cs, const float* wexp,
           const float* prev, float* out, int NP, int W, int cout,
           cudaStream_t stream) {
  const dim3 grid((NP + TP - 1) / TP, (cout + TO - 1) / TO);
  blend_matmul_kernel<C_PER><<<grid, THREADS, 0, stream>>>(g, cs, wexp, prev,
                                                           out, NP, W, cout);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers
// (g 16-byte aligned); `stream` is the caller's cudaStream_t. The caller
// checks shapes (W % 4 == 0, W % c_per == 0), dtypes, devices and
// contiguity and allocates `out`. Returns the cudaError_t of the launch
// (0 on success); a c_per outside {1, 2, 4, 8, 16, 32} returns
// cudaErrorInvalidValue without launching.
extern "C" int blend_matmul_f32(const void* g, const void* cs,
                                const void* wexp, const void* prev,
                                void* out, int NP, int W, int cout,
                                int c_per, void* stream) {
  if (NP == 0 || cout == 0) return 0;
  const auto* gf = static_cast<const float*>(g);
  const auto* cf = static_cast<const float*>(cs);
  const auto* wf = static_cast<const float*>(wexp);
  const auto* pf = static_cast<const float*>(prev);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define BLEND_CASE(C)                                                  \
  case C:                                                              \
    return launch<C>(gf, cf, wf, pf, of, NP, W, cout, st);
  switch (c_per) {
    BLEND_CASE(1)
    BLEND_CASE(2)
    BLEND_CASE(4)
    BLEND_CASE(8)
    BLEND_CASE(16)
    BLEND_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BLEND_CASE
}
