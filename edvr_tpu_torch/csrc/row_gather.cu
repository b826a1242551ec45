// Row gather out[i, :] = table[idx[i], :], fp32, for Hopper (sm_90a).
//
// The counterpart of the in-kernel row gather that
// scripts/dev/probe_mosaic_gather.py probes on the TPU (a (R, 128) table
// gathered at data-dependent rows), which is the gather of the packed DCN
// route: edvr_tpu/ops/dcn.py::_mdcn_packed takes one (NP, 128) tile per
// output pixel and tap with jnp.take(tab, row, axis=0), and Mosaic has no
// such gather. Hopper has one, so this is a plain copy.
//
// What bounds it on an H100 SXM: nothing but bytes. At EDVR-M inference L1
// one deformable group gathers G = NP*K = 2,592,000 rows of 128 floats:
// 1.33 GB read and 1.33 GB written, 0.79 ms at 3.35 TB/s, and no
// arithmetic. The design moves each row as one warp-wide 512-byte read and
// write (16 bytes a lane, neighbouring lanes on neighbouring addresses), a
// warp per row and eight rows per block, so every access is a full
// coalesced transaction. An index outside [0, R) writes a zero row and
// raises the caller's error flag; the wrapper turns the flag into an
// exception.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;  // one warp per row

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const float* __restrict__ table,  // (R, L)
                  const int* __restrict__ idx,      // (G)
                  float* __restrict__ out,          // (G, L)
                  int G, int R, int L, int* __restrict__ bad) {
  const long long i = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= G) return;
  const int r = __ldg(idx + i);
  float* dst = out + i * L;
  if (r < 0 || r >= R) {
    if (lane == 0) *bad = 1;  // every writer stores the same 1
    for (int c = lane; c < L; c += 32) dst[c] = 0.f;
    return;
  }
  const float* src = table + (size_t)r * L;
  if constexpr (VEC4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < L / 4; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < L; c += 32) dst[c] = __ldg(src + c);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// `bad` is one int32 the caller zeroes; `stream` is the caller's
// cudaStream_t. The caller checks shapes, dtypes, devices and contiguity
// and allocates `out`. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int row_gather_f32(const void* table, const void* idx, void* out,
                              void* bad, int G, int R, int L, void* stream) {
  if (G == 0 || L == 0) return 0;
  const auto* tf = static_cast<const float*>(table);
  const auto* ix = static_cast<const int*>(idx);
  auto* of = static_cast<float*>(out);
  auto* bf = static_cast<int*>(bad);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((G + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  // 16-byte rows need L % 4 == 0 (the wrapper checks the base pointers)
  if (L % 4 == 0)
    row_gather_kernel<true><<<blocks, THREADS, 0, st>>>(tf, ix, of, G, R, L, bf);
  else
    row_gather_kernel<false><<<blocks, THREADS, 0, st>>>(tf, ix, of, G, R, L, bf);
  return (int)cudaGetLastError();
}
