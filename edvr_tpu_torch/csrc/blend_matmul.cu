// Fused blend + tap-concatenation GEMM of the packed DCN route, fp32, for
// Hopper (sm_90a), on the tensor cores in 3xTF32:
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
// coefficient multiplies its g_cat elements as the A fragments are read
// from shared memory (the blended strip never exists in device memory),
// and the ragged tails of NP, W and cout are zero-filled by cp.async.
//
// What bounds it on an H100 SXM, reckoned at EDVR-M inference L1 (one
// group, NP = 288,000, W = 1152, cout = 64): 1.64 GB of compulsory traffic
// (g_cat, cs_cat, wexp_g and out_prev read once, out written once), 0.49
// ms at 3.35 TB/s, against 2*NP*W*cout = 42.5 GFLOP, which is 127.5 GFLOP
// of TF32 products in 3xTF32, 0.26 ms at 495 TFLOP/s (0.63 ms as fp32
// FMAs on the CUDA cores). So on the tensor cores the bytes bound it.
//
// Design: a block owns 128 rows x 64 output channels, four warps of 64 x
// 32 (4 x 4 tiles of m16n8). W is walked in 32-wide chunks through a ring
// of three cp.async stages in dynamic shared memory (the raw g_cat chunk,
// its cs_cat slots and the wexp_g rows), so the loads of two chunks are in
// flight while the third is multiplied. Each A element is formed as g * c
// in fp32 (the plain version's product) and split hi + lo; each B element
// is split as it is read; every m16n8k8 tile takes three TF32 mma.sync
// into a per-chunk sum, which joins the running sum by one float32 add.
// The strides keep every fragment read free of bank conflicts: A rows of
// 36 words, B rows of 72, coefficient rows of S+1 or S+4 words for S
// slots per chunk. out_prev is added at the store.
//
// The bf16 form (blend_matmul_bf16) is what the TPU kernel computes for
// bf16 operands (dcn_pallas.py:66-75), the form the packed route takes in
// the bf16 training step: g_cat, cs_cat and wexp_g bf16, out_prev and out
// float32,
//
//     out = out_prev + bf16(g_cat * expand(cs_cat)) @ wexp_g
//
// with each blended element rounded to bf16 (round to nearest even: the
// product of two bf16 values is exact in float32 and rounded once, as the
// TPU kernel's bf16 multiply rounds it), exact bf16 products and float32
// sums. Reckoned at EDVR-M inference L1 it moves 0.894 GB (g_cat 664 MB,
// cs_cat 83 MB, out_prev and out 74 MB each), 0.27 ms at 3.35 TB/s,
// against 42.5 GFLOP, 0.043 ms at 989 TFLOP/s: bytes bound it, and g_cat
// is three quarters of them. Design: a block owns 128 rows across all of
// cout up to 128 (a 64- or 128-wide tile), so each g_cat row is read from
// device memory once and blended once. Eight warps (4 x 2, each 32 rows x
// half the tile) stream 64-wide chunks (128 bytes of a g_cat row, with
// their coefficient slot pairs and wexp_g rows) through a cp.async ring;
// all of them blend each raw chunk once into a bf16 A tile in shared
// memory (16-byte pieces of each row swizzled by the row, as are the
// wexp_g rows, so ldmatrix reads both without bank conflicts), then,
// behind a barrier, multiply it: m16n8k16 bf16 mma.sync, A by ldmatrix, B
// by ldmatrix.trans, summed per chunk in float32 and joined to the running
// sum by one round-to-nearest add, as in the fp32 form. At a 64-wide tile
// two blocks share an SM (128 registers, a 3-stage ring), which hides one
// block's ring fill and epilogue behind the other's; a 128-wide tile keeps
// one (240 registers, 5 stages). Measured on an H100 (PERF.md):
// blending chunk k + 1 beside the products of chunk k, and wgmma for the
// products, were no faster; at a 64-wide tile the kernel runs at the
// speed of its own loads and stores. No wexp_g split: its bf16 values are
// the operands. g_cat rows take W % 8 == 0 and coefficient rows an even
// count of slots (whole 4-byte pairs); the wrapper checks both.

#include "mma_common.cuh"

// Measurement builds only (python -m edvr_tpu_torch.tools.ab_kernels
// --ablate): -DBLEND_ONE_PRODUCT keeps hi*hi of the three products,
// -DBLEND_NO_SPLIT takes the raw float bits as hi and zero as lo (no
// cvt). Their results are off by design; the shipped build sets neither.

namespace {

using namespace mma;

constexpr int BM = 128;       // rows (output pixels) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // width of a contraction chunk
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 128;  // 2 x 2 warps of 64 rows x 32 channels
constexpr int LDA = BK + 4;   // g_cat chunk row: A reads conflict-free
constexpr int LDB = BN + 8;   // wexp_g chunk row: B reads conflict-free
static_assert(BM == THREADS, "load_stage copies BM x S coefficients in S passes");

template <int C_PER>
struct Cfg {
  static constexpr int S = BK / C_PER;                // slots per chunk
  static constexpr int LDC = S >= 8 ? S + 4 : S + 1;  // coefficient row
  static constexpr int A_FL = BM * LDA;
  static constexpr int B_FL = BK * LDB;
  static constexpr int C_FL = BM * LDC;
  static constexpr int STAGE_FL = A_FL + B_FL + C_FL;  // multiple of 4
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_FL * sizeof(float);
};

template <int C_PER>
__device__ __forceinline__ void load_stage(
    float* st, const float* __restrict__ g, const float* __restrict__ cs,
    const float* __restrict__ wexp, int r0, int o0, int k0, int NP, int W,
    int cout, bool vec_b, int tid) {
  using C = Cfg<C_PER>;
  float* a_s = st;
  float* b_s = st + C::A_FL;
  float* c_s = b_s + C::B_FL;
  // g_cat: 128 rows x 8 pieces of 16 bytes (W % 4 == 0: a piece is wholly
  // in range or out)
#pragma unroll
  for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q / (BK / 4), c4 = q % (BK / 4);
    const int r = r0 + row, c = k0 + 4 * c4;
    const bool ok = r < NP && c < W;
    cp_async16(a_s + row * LDA + 4 * c4, ok ? g + (size_t)r * W + c : g, ok);
  }
  // wexp_g: 32 rows x 64 channels
#pragma unroll
  for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
    const int q = tid + i * THREADS;
    const int kk = q / (BN / 4), o4 = q % (BN / 4);
    const int k = k0 + kk, o = o0 + 4 * o4;
    float* dst = b_s + kk * LDB + 4 * o4;
    if (vec_b) {
      const bool ok = k < W && o < cout;
      cp_async16(dst, ok ? wexp + (size_t)k * cout + o : wexp, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < W && o + e < cout;
        cp_async4(dst + e, ok ? wexp + (size_t)k * cout + o + e : wexp, ok);
      }
    }
  }
  // cs_cat: 128 rows x S slots, 4 bytes each (a row of W / C_PER floats
  // keeps no 16-byte alignment in general)
  const int CW = W / C_PER;
  const int j0 = k0 / C_PER;
#pragma unroll
  for (int i = 0; i < C::S; ++i) {
    const int q = tid + i * THREADS;
    const int row = q / C::S, j = q % C::S;
    const int r = r0 + row;
    const bool ok = r < NP && j0 + j < CW;
    cp_async4(c_s + row * C::LDC + j, ok ? cs + (size_t)r * CW + j0 + j : cs,
              ok);
  }
}

template <int C_PER>
__global__ void __launch_bounds__(THREADS, 2)
blend_matmul_kernel(const float* __restrict__ g,     // (NP, W)
                    const float* __restrict__ cs,    // (NP, W / C_PER)
                    const float* __restrict__ wexp,  // (W, cout)
                    const float* __restrict__ prev,  // (NP, cout)
                    float* __restrict__ out,         // (NP, cout)
                    int NP, int W, int cout, bool vec_b, bool vec_out) {
  using C = Cfg<C_PER>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int r0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int wm = (warp >> 1) * 64;  // the warp's rows within the block
  const int wn = (warp & 1) * 32;   // and channels

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (W + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<C_PER>(smem + s * C::STAGE_FL, g, cs, wexp, r0, o0, s * BK,
                        NP, W, cout, vec_b, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed
    __syncthreads();              // and every warp is done with kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<C_PER>(smem + (nxt % STAGES) * C::STAGE_FL, g, cs, wexp, r0,
                        o0, nxt * BK, NP, W, cout, vec_b, tid);
    cp_async_commit();

    const float* a_s = smem + (kt % STAGES) * C::STAGE_FL;
    const float* b_s = a_s + C::A_FL;
    const float* c_s = b_s + C::B_FL;
    // the chunk's sum, apart: the tensor cores round their float32 sums
    // toward zero, so the running sum takes each chunk by one float32 add
    // (round to nearest) instead of 12 truncations at its full magnitude
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // A: the blended g_cat elements of the warp's four m16 tiles
      uint32_t a_hi[4][4], a_lo[4][4];
      const int k1 = kk + q, k2 = k1 + 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r1 = wm + 16 * i + gq, r2 = r1 + 8;
        const float* c1 = c_s + r1 * C::LDC;
        const float* c2 = c_s + r2 * C::LDC;
        const float v[4] = {
            a_s[r1 * LDA + k1] * c1[k1 / C_PER],
            a_s[r2 * LDA + k1] * c2[k1 / C_PER],
            a_s[r1 * LDA + k2] * c1[k2 / C_PER],
            a_s[r2 * LDA + k2] * c2[k2 / C_PER]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#ifdef BLEND_NO_SPLIT
          a_hi[i][e] = __float_as_uint(v[e]);
          a_lo[i][e] = 0u;
#else
          split_tf32(v[e], a_hi[i][e], a_lo[i][e]);
#endif
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + gq;
        uint32_t b_hi[2], b_lo[2];
#ifdef BLEND_NO_SPLIT
        b_hi[0] = __float_as_uint(b_s[k1 * LDB + n]);
        b_hi[1] = __float_as_uint(b_s[k2 * LDB + n]);
        b_lo[0] = b_lo[1] = 0u;
#else
        split_tf32(b_s[k1 * LDB + n], b_hi[0], b_lo[0]);
        split_tf32(b_s[k2 * LDB + n], b_hi[1], b_lo[1]);
#endif
#pragma unroll
        for (int i = 0; i < 4; ++i)
#ifdef BLEND_ONE_PRODUCT
          mma_tf32(part[i][j], a_hi[i], b_hi);
#else
          mma_3xtf32(part[i][j], a_hi[i], a_lo[i], b_hi, b_lo);
#endif
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // epilogue: out = out_prev + acc, two neighbouring channels a lane
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm + 16 * i + gq + 8 * h;
      if (r >= NP) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + wn + 8 * j + 2 * q;
        const size_t at = (size_t)r * cout + o;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        if (vec_out && o + 1 < cout) {
          const float2 p = *reinterpret_cast<const float2*>(prev + at);
          *reinterpret_cast<float2*>(out + at) = make_float2(p.x + x0,
                                                             p.y + x1);
        } else {
          if (o < cout) out[at] = prev[at] + x0;
          if (o + 1 < cout) out[at + 1] = prev[at + 1] + x1;
        }
      }
    }
  }
}

template <int C_PER>
int launch(const float* g, const float* cs, const float* wexp,
           const float* prev, float* out, int NP, int W, int cout,
           cudaStream_t stream) {
  using C = Cfg<C_PER>;
  auto kernel = blend_matmul_kernel<C_PER>;
  int e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e) return e;
  const bool vec_b = cout % 4 == 0 && (uintptr_t)wexp % 16 == 0;
  const bool vec_out = cout % 2 == 0 && (uintptr_t)prev % 8 == 0 &&
                       (uintptr_t)out % 8 == 0;
  const dim3 grid((NP + BM - 1) / BM, (cout + BN - 1) / BN);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(g, cs, wexp, prev, out, NP, W,
                                              cout, vec_b, vec_out);
  return (int)cudaGetLastError();
}

// ---- bf16 ----------------------------------------------------------------

// Measurement builds of the bf16 form, wrong by design (python -m
// edvr_tpu_torch.tools.ab_kernels --ablate blend_matmul_bf16): what is
// left of the kernel's time without a part of its work.
// -DBLEND_BF16_NO_MMA skips the products, -DBLEND_BF16_NO_BLEND copies the
// raw g_cat chunk in place of the blend, -DBLEND_BF16_NO_B loads no wexp_g
// rows.

namespace bf {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;          // width of a contraction chunk (128 bytes)
constexpr int THREADS = 256;    // 4 x 2 warps of 32 rows x BN/2 channels
constexpr int SMEM_SM = 233472;   // shared memory of an H100 SM
constexpr int SMEM_MAX = 232448;  // of one block

// the deepest ring of at most s stages, and at least 2, whose stages of
// stage_b bytes fit beside `fixed` bytes in `budget`
constexpr int fit_stages(int s, int stage_b, int fixed, int budget) {
  return s > 2 && s * stage_b + fixed > budget
             ? fit_stages(s - 1, stage_b, fixed, budget) : s;
}

// BN channels (64 or 128, all of cout up to 128) of BM rows per block
template <int C_PER, int BN>
struct Cfg {
  static constexpr int S = BK / C_PER;        // slots per chunk, even
  static constexpr int LDCW = (S / 2) | 1;    // coefficient row, words
  static constexpr int G_B = BM * BK * 2;     // raw g_cat chunk
  static constexpr int B_B = BK * BN * 2;     // wexp_g chunk (swizzled)
  static constexpr int C_B = (BM * LDCW * 4 + 15) / 16 * 16;  // cs_cat
  static constexpr int STAGE_B = G_B + B_B + C_B;
  static constexpr int A_B = BM * BK * 2;     // one blended A tile
  // two blocks an SM at a 64-wide tile (one read 0.50 ms against 0.36 at
  // EDVR-M's L1, PERF.md), one at 128
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  // each block's share of the SM (the runtime keeps 1 KB a block)
  static constexpr int BUDGET =
      SMEM_SM / MIN_BLOCKS - 1024 < SMEM_MAX ? SMEM_SM / MIN_BLOCKS - 1024
                                             : SMEM_MAX;
  // the deepest ring of up to 5 stages that fits beside the A tile
  static constexpr int STAGES = fit_stages(5, STAGE_B, A_B, BUDGET);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_B + A_B;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

// 16-byte piece p of row r of a tile of 8 or more pieces a row, at piece
// p ^ (r % 8): ldmatrix's eight rows of one piece fall on distinct banks
template <int ROW>
__device__ __forceinline__ int swz(int r, int p) {
  return r * ROW + ((p ^ (r & 7)) << 3);
}

// copy chunk k0 of g_cat, its cs_cat slot pairs and its wexp_g rows into
// a ring stage (zero-filled beyond NP, W and cout)
template <int C_PER, int BN>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const bf16* __restrict__ g,
    const uint32_t* __restrict__ cs, const bf16* __restrict__ wexp, int r0,
    int o0, int k0, int NP, int W, int cout, bool vec_b, int tid) {
  using C = Cfg<C_PER, BN>;
  bf16* g_s = reinterpret_cast<bf16*>(st);
  bf16* b_s = reinterpret_cast<bf16*>(st + C::G_B);
  uint32_t* c_s = reinterpret_cast<uint32_t*>(st + C::G_B + C::B_B);
  // g_cat: 128 rows x 8 pieces of 16 bytes, unpadded (the blend reads a
  // row's 8 pieces with 8 lanes); W % 8 == 0: a piece is wholly in or out
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q >> 3, c8 = q & 7;
    const int r = r0 + row, c = k0 + 8 * c8;
    const bool ok = r < NP && c < W;
    cp_async16(g_s + row * BK + 8 * c8, ok ? g + (size_t)r * W + c : g, ok);
  }
  // wexp_g: 64 rows x BN channels, pieces swizzled; a ragged cout by
  // plain loads
#ifndef BLEND_BF16_NO_B
#pragma unroll
  for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
    const int q = tid + i * THREADS;
    const int kk = q / (BN / 8), o8 = q % (BN / 8);
    const int k = k0 + kk, o = o0 + 8 * o8;
    bf16* dst = b_s + swz<BN>(kk, o8);
    if (vec_b) {
      const bool ok = k < W && o < cout;
      cp_async16(dst, ok ? wexp + (size_t)k * cout + o : wexp, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = k < W && o + e < cout ? wexp[(size_t)k * cout + o + e]
                                       : __float2bfloat16(0.f);
    }
  }
#endif
  // cs_cat: 128 rows x S/2 pairs of slots, 4 bytes each
  const int CW2 = W / C_PER / 2;
  const int j0 = k0 / C_PER / 2;
  for (int q = tid; q < BM * (C::S / 2); q += THREADS) {
    const int row = q / (C::S / 2), j = q % (C::S / 2);
    const int r = r0 + row;
    const bool ok = r < NP && j0 + j < CW2;
    cp_async4(c_s + row * C::LDCW + j,
              ok ? cs + (size_t)r * CW2 + j0 + j : cs, ok);
  }
}

// blend a raw ring stage into A tile a_s, once for the whole block: each
// element bf16(g * c) (the exact float product rounded to nearest even,
// as the TPU kernel's bf16 multiply), 8 columns a thread per piece
template <int C_PER, int BN>
__device__ __forceinline__ void blend_chunk(const unsigned char* st,
                                            bf16* a_s, int tid) {
  using C = Cfg<C_PER, BN>;
  const bf16* g_s = reinterpret_cast<const bf16*>(st);
  const bf16* c_s = reinterpret_cast<const bf16*>(st + C::G_B + C::B_B);
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q >> 3, v = q & 7;
    const uint4 raw = *reinterpret_cast<const uint4*>(g_s + row * BK + 8 * v);
#ifdef BLEND_BF16_NO_BLEND
    *reinterpret_cast<uint4*>(a_s + swz<BK>(row, v)) = raw;
    continue;
#endif
    const bf16* c_row = c_s + 2 * row * C::LDCW;
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 8 * v + 2 * e;
      const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
      const float c0 = __bfloat162float(c_row[k / C_PER]);
      const float c1 = __bfloat162float(c_row[(k + 1) / C_PER]);
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(__low2float(g2) * c0, __high2float(g2) * c1);
      o[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(a_s + swz<BK>(row, v)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// the products of one chunk: A tile a_s (blended) by the ring stage's
// wexp_g rows b_s into the warp's per-chunk sums
template <int BN>
__device__ __forceinline__ void mma_chunk(const bf16* a_s, const bf16* b_s,
                                          float (*part)[BN / 16][4], int wm,
                                          int wn, int lane) {
  // ldmatrix.x4 of an m16 x k16 A tile: lane l gives row l % 16, piece
  // l / 16 of the k16 step; ldmatrix.x4.trans of two n8 B tiles: lane l
  // gives row l % 8 of matrix l / 8, the matrices being (k 0-7, n8 tile),
  // (k 8-15, tile), (k 0-7, tile + 1), (k 8-15, tile + 1)
  const int arow = lane & 15, ahalf = lane >> 4;
  const int mi = lane >> 3, bk = (lane & 7) + 8 * (mi & 1);
  const int bp = (wn >> 3) + (mi >> 1);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], a_s + swz<BK>(wm + 16 * i + arow, 2 * kk + ahalf));
#pragma unroll
    for (int jp = 0; jp < BN / 32; ++jp) {
      uint32_t bb[4];  // the n8 tiles 2 jp and 2 jp + 1
      ldsm_x4_trans(bb, b_s + swz<BN>(16 * kk + bk, bp + 2 * jp));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(part[i][2 * jp], a[i], bb);
        mma_bf16(part[i][2 * jp + 1], a[i], bb + 2);
      }
    }
  }
}

// out = out_prev + acc over the warp's tile of the 128 rows from r0 (two
// neighbouring channels a lane)
template <int BN>
__device__ __forceinline__ void store_band(float (*acc)[BN / 16][4],
                                           const float* __restrict__ prev,
                                           float* __restrict__ out, int r0,
                                           int o0, int NP, int cout,
                                           bool vec_out, int wm, int wn,
                                           int lane) {
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm + 16 * i + gq + 8 * h;
      if (r >= NP) continue;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int o = o0 + wn + 8 * j + 2 * q;
        const size_t at = (size_t)r * cout + o;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        if (vec_out && o + 1 < cout) {
          const float2 p = *reinterpret_cast<const float2*>(prev + at);
          *reinterpret_cast<float2*>(out + at) = make_float2(p.x + x0,
                                                             p.y + x1);
        } else {
          if (o < cout) out[at] = prev[at] + x0;
          if (o + 1 < cout) out[at + 1] = prev[at + 1] + x1;
        }
      }
    }
  }
}

template <int C_PER, int BN>
__global__ void __launch_bounds__(THREADS, (Cfg<C_PER, BN>::MIN_BLOCKS))
blend_matmul_bf16_kernel(const bf16* __restrict__ g,        // (NP, W)
                         const uint32_t* __restrict__ cs,   // (NP, W / C_PER)
                         const bf16* __restrict__ wexp,     // (W, cout)
                         const float* __restrict__ prev,    // (NP, cout)
                         float* __restrict__ out,           // (NP, cout)
                         int NP, int W, int cout, bool vec_b, bool vec_out) {
  using C = Cfg<C_PER, BN>;
  constexpr int STAGES = C::STAGES;
  constexpr int NT = BN / 16;  // n8 tiles of a warp
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  bf16* a_tile = reinterpret_cast<bf16*>(ring + STAGES * C::STAGE_B);

  const int r0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32;        // the warp's rows within the block
  const int wn = (warp & 1) * (BN / 2);   // and channels

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (W + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<C_PER, BN>(ring + s * C::STAGE_B, g, cs, wexp, r0, o0,
                            s * BK, NP, W, cout, vec_b, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed
    __syncthreads();              // every warp is done with kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<C_PER, BN>(ring + (nxt % STAGES) * C::STAGE_B, g, cs, wexp,
                            r0, o0, nxt * BK, NP, W, cout, vec_b, tid);
    cp_async_commit();
    // the chunk blended once, by the whole block, then multiplied
    blend_chunk<C_PER, BN>(ring + (kt % STAGES) * C::STAGE_B, a_tile, tid);
    __syncthreads();
    const bf16* b_s =
        reinterpret_cast<const bf16*>(ring + (kt % STAGES) * C::STAGE_B +
                                      C::G_B);
    // the chunk's sum, apart (the tensor cores truncate their float32
    // sums), joined to the running sum by one float32 add
    float part[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#ifndef BLEND_BF16_NO_MMA
    mma_chunk<BN>(a_tile, b_s, part, wm, wn, lane);
#endif
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  store_band<BN>(acc, prev, out, r0, o0, NP, cout, vec_out, wm, wn, lane);
}

template <int C_PER, int BN>
int launch_bn(const bf16* g, const uint32_t* cs, const bf16* wexp,
              const float* prev, float* out, int NP, int W, int cout,
              cudaStream_t stream) {
  using C = Cfg<C_PER, BN>;
  auto kernel = blend_matmul_bf16_kernel<C_PER, BN>;
  int e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e) return e;
  const bool vec_b = cout % 8 == 0 && (uintptr_t)wexp % 16 == 0;
  const bool vec_out = cout % 2 == 0 && (uintptr_t)prev % 8 == 0 &&
                       (uintptr_t)out % 8 == 0;
  const dim3 grid((NP + BM - 1) / BM, (cout + BN - 1) / BN);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(g, cs, wexp, prev, out, NP, W,
                                              cout, vec_b, vec_out);
  return (int)cudaGetLastError();
}

// one block column for cout <= 128 (64 wide up to 64): every g_cat row is
// read and blended by one block
template <int C_PER>
int launch(const bf16* g, const uint32_t* cs, const bf16* wexp,
           const float* prev, float* out, int NP, int W, int cout,
           cudaStream_t stream) {
  return cout <= 64
             ? launch_bn<C_PER, 64>(g, cs, wexp, prev, out, NP, W, cout,
                                    stream)
             : launch_bn<C_PER, 128>(g, cs, wexp, prev, out, NP, W, cout,
                                     stream);
}

}  // namespace bf

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

// The bf16 form: g, cs and wexp bf16 (g 16-byte and cs 4-byte aligned),
// prev and out float32. The caller also checks W % 8 == 0 and an even
// W / c_per. Same return values as blend_matmul_f32.
extern "C" int blend_matmul_bf16(const void* g, const void* cs,
                                 const void* wexp, const void* prev,
                                 void* out, int NP, int W, int cout,
                                 int c_per, void* stream) {
  if (NP == 0 || cout == 0) return 0;
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* cb = static_cast<const uint32_t*>(cs);
  const auto* wb = static_cast<const __nv_bfloat16*>(wexp);
  const auto* pf = static_cast<const float*>(prev);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define BLEND_CASE(C)                                                  \
  case C:                                                              \
    return bf::launch<C>(gb, cb, wb, pf, of, NP, W, cout, st);
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
