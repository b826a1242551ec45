// Row gather out[i, :] = table[idx[i], :] of 32-bit words, for Hopper
// (sm_90a).
//
// The counterpart of the in-kernel row gather that
// scripts/dev/probe_mosaic_gather.py probes on the TPU (a (R, 128) table
// gathered at data-dependent rows), which is the gather of the packed DCN
// route: edvr_tpu/ops/dcn.py::_mdcn_packed takes one (NP, 128) tile per
// output pixel and tap with jnp.take(tab, row, axis=0), and Mosaic has no
// such gather. Hopper has one, so this is a plain copy. A bf16 table is
// gathered as the 32-bit words that hold its pairs of lanes.
//
// What bounds it on an H100 SXM: nothing but bytes. At EDVR-M inference L1
// one deformable group gathers G = NP*K = 2,592,000 rows of 128 floats:
// 1.33 GB written, and the 41,400 distinct table rows read (the table
// stays in the 50 MB L2), 0.41 ms at 3.35 TB/s, and no arithmetic.
//
// Design: the lanes of a warp are mapped to the row's real width. A row of
// L4 16-byte pieces (L4 = L / 4 in {1, 2, 4, 8, 16, 32}) takes L4 lanes, so
// a warp moves 32 / L4 rows at once: a 512-byte fp32 tile row a whole warp,
// a 256-byte bf16 one half a warp (two rows a warp). Each warp issues the
// loads of UNROLL such steps before their stores, so several rows per lane
// are in flight; the output, which no later step of this kernel reads, is
// written with streaming stores (st.global.cs) so it does not push the
// table out of L2. The grid holds one block per eight warp-steps of work:
// at EDVR-M's L1 a grid-stride loop over the resident blocks read 16%
// slower, plain stores 1-16% slower, and 1, 2 or 4 steps in flight level
// (PERF.md). Rows of other widths take one warp per row
// (16 bytes a lane, or 4 when L % 4 != 0).
//
// An index outside [0, R) fails the kernel with a device-side assertion,
// as index_select does on CUDA: the process's CUDA context is then lost
// and the next synchronising call raises cudaErrorAssert, naming this
// file's line on stderr. No zero row is ever written in its place, and the
// launch needs no flag read back by the host.

#include <cuda_runtime.h>

#include <cassert>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // row steps per warp in flight

// the output: written once, never read again by this kernel
template <class T>
__device__ __forceinline__ void store_out(T* p, T v) {
  __stcs(p, v);
}

__device__ __forceinline__ long long checked_row(const int* __restrict__ idx,
                                                 long long i, int R) {
  const int r = __ldg(idx + i);
  assert(r >= 0 && r < R && "row_gather: an index lies outside [0, R)");
  return r;
}

// rows of exactly LANES 16-byte pieces, 32 / LANES rows a warp per step
template <int LANES>
__global__ void __launch_bounds__(THREADS)
gather_narrow(const float4* __restrict__ table, const int* __restrict__ idx,
              float4* __restrict__ out, long long G, int R) {
  constexpr int RPW = 32 / LANES;       // rows a warp moves per step
  constexpr int SPAN = RPW * UNROLL;    // rows of a warp's unrolled step
  const int lane = threadIdx.x & 31;
  const int sub = lane / LANES, c = lane % LANES;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long base = warp * SPAN; base < G; base += warps * SPAN) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * RPW + sub;
      if (i < G) v[u] = __ldg(table + checked_row(idx, i, R) * LANES + c);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * RPW + sub;
      if (i < G) store_out(out + i * LANES + c, v[u]);
    }
  }
}

// any other width: one warp per row, 16 bytes a lane (VEC4) or 4
template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
gather_wide(const float* __restrict__ table, const int* __restrict__ idx,
            float* __restrict__ out, long long G, int R, int L) {
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * WARPS;
  const int lane = threadIdx.x & 31;
  for (long long i = warp; i < G; i += warps) {
    const float* src = table + checked_row(idx, i, R) * L;
    float* dst = out + i * L;
    if constexpr (VEC4) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int c = lane; c < L / 4; c += 32) store_out(d4 + c, __ldg(s4 + c));
    } else {
      for (int c = lane; c < L; c += 32) store_out(dst + c, __ldg(src + c));
    }
  }
}

// the grid: a block for each WARPS of `units` warp-steps
unsigned grid_for(long long units) {
  return (unsigned)((units + WARPS - 1) / WARPS);
}

template <int LANES>
void launch_narrow(const void* table, const int* idx, void* out, long long G,
                   int R, cudaStream_t st) {
  constexpr int SPAN = 32 / LANES * UNROLL;
  gather_narrow<LANES><<<grid_for((G + SPAN - 1) / SPAN), THREADS, 0, st>>>(
      static_cast<const float4*>(table), idx, static_cast<float4*>(out), G,
      R);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers
// (table and out 16-byte aligned when L % 4 == 0); `stream` is the
// caller's cudaStream_t. The caller checks shapes, dtypes, devices and
// contiguity and allocates `out`. Returns the cudaError_t of the launch
// (0 on success); an index outside [0, R) fails the kernel itself (see
// above).
extern "C" int row_gather_f32(const void* table, const void* idx, void* out,
                              int G, int R, int L, void* stream) {
  if (G == 0 || L == 0) return 0;
  const auto* ix = static_cast<const int*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L % 4 == 0 ? L / 4 : 0) {
    case 32: launch_narrow<32>(table, ix, out, G, R, st); break;
    case 16: launch_narrow<16>(table, ix, out, G, R, st); break;
    case 8: launch_narrow<8>(table, ix, out, G, R, st); break;
    case 4: launch_narrow<4>(table, ix, out, G, R, st); break;
    case 2: launch_narrow<2>(table, ix, out, G, R, st); break;
    case 1: launch_narrow<1>(table, ix, out, G, R, st); break;
    default: {
      const auto* tf = static_cast<const float*>(table);
      auto* of = static_cast<float*>(out);
      if (L % 4 == 0)
        gather_wide<true><<<grid_for(G), THREADS, 0, st>>>(tf, ix, of, G, R,
                                                           L);
      else
        gather_wide<false><<<grid_for(G), THREADS, 0, st>>>(tf, ix, of, G,
                                                            R, L);
    }
  }
  return (int)cudaGetLastError();
}
