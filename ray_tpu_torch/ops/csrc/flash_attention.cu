// Flash attention, forward and backward, hand-written for Hopper (sm_90a).
// The kernels and the TPU kernels they replace:
//
//   flash_fwd_tc_kernel  replaces ray_tpu/ops/flash_attention.py::_flash_kernel
//                        (online-softmax forward, causal tile skip, lse) for
//                        bf16 at D 64 and 128, on the tensor cores
//   flash_fwd_kernel     the same on CUDA cores, for f32 and for bf16 at D 32
//                        and 256
//   flash_dq_tc_kernel   replaces ray_tpu/ops/flash_attention.py::_dq_kernel
//                        (dQ = sm * sum_kv dS K, P rebuilt from lse) for bf16
//                        at D 64 and 128, on the tensor cores
//   flash_dkv_tc_kernel  replaces ray_tpu/ops/flash_attention.py::_dkv_kernel
//                        (dV = sum_q P^T dO, dK = sm * sum_q dS^T Q) likewise
//   flash_dq_kernel,     the two backward kernels on CUDA cores, for f32 and
//   flash_dkv_kernel     for bf16 at D 32 and 256
//
// The kernels are built for head dims 32, 64, 128 and 256 (256 on the CUDA
// cores only, above 48 KB of dynamic shared memory); the Python wrapper
// zero-pads any other head dim up to 256 to the next of those and passes
// the true head dim's softmax scale (zero columns add nothing to q . k or
// to delta, and dq, dk, dv come out zero there).
//
// They compute what the Pallas kernels compute, not block by block:
//
// - q, k, v, dO are read in place as [B, T, H, D] (row stride H*D); the
//   Pallas wrappers' transposes to [BH, T, D] are a TPU layout artefact.
// - lse and delta are [B*H, T] f32 rows, not the [BH, T, 128] lane
//   broadcast Mosaic needs.
// - The sequential kv (or q) grid axis becomes a loop inside one CTA; the
//   other two grid axes (tile, b*h) are the CUDA grid. Nothing is
//   reduced across CTAs, so there are no atomics and results are
//   deterministic.
// - Ragged T is masked inside the kernels (rows past T load as zeros,
//   columns past T are masked, rows past T are not written), so every T
//   runs here; the reference's XLA fallback for T without a 128-multiple
//   divisor has no counterpart.
//
// Numerics follow the reference: scores in f32 from (q * sm_scale) . k
// (the tensor-core kernels scale the f32 product q . k instead: the same
// value at D 64, where sm_scale is a power of two, and one f32 rounding
// apart otherwise); masked scores are the finite NEG_INF; the forward
// rounds p to v's dtype before p . V, relative to the running row max (so
// bf16 outputs match JAX's), while l sums the f32 p; the backward
// rebuilds p = exp(s - lse) and dS = p * (dO . V^T - delta) in f32 and
// writes dq/dk/dv in the input dtype. The tensor-core backward rounds P
// and dS to bf16 once before its products (P^T dO, dS K, dS^T Q), which
// moves each element by at most 2^-8 of the same product of absolute
// values (flash_attention.py's flash_backward_abs_bound).
//
// What bounds them on an H100: at the training shape (B 8, T 1024, H 16,
// D 64, causal, bf16) the forward moves 67 MB and does 17.2 GFLOP, so the
// 3.35 TB/s bound it (~20 us); dQ (25.8 GFLOP) and dK/dV (34.4 GFLOP) add
// products and are bound by the tensor cores' 989 TFLOP/s (~26 and
// ~35 us).
//
// The bf16 forward on the tensor cores (flash_fwd_tc_kernel): a CTA owns
// 128 query rows of one (b, h), two consumer warpgroups of 64 rows each,
// and one producer warp that loads the Q tile once and then streams K and
// V tiles of 128 keys by TMA through a 2-stage mbarrier ring; the maps
// are 4-D, (D, H, T, B) over [B, T, H, D] with boxes of 64 columns x 1
// head x 128 rows, so a box never crosses into another head or batch and
// rows past T read as zeros. Per kv tile, S = Q K^T is a
// wgmma.m64n128k16 chain (both operands K-major, 128-byte swizzled); the
// online softmax runs on S's accumulators (row max and sum across the 4
// lanes of a quad, exp2f of scores prescaled by sm_scale * log2(e), masks
// only on the diagonal and ragged tiles); P is rounded to bf16 straight
// into the A registers of O += P V, a wgmma.m64n{D}k16 chain with V read
// MN-major through the transpose bit. O is rescaled by exp(m_old - m_new)
// between tiles and divided by l at the end. Causal CTAs skip the tiles
// above the diagonal, and the grid starts the heaviest query tiles first.
// This is the simple version: each warpgroup waits for its products
// before the softmax (no ping-pong between the warpgroups; issuing the
// next S and this P . V together, with the softmax under P . V, measured
// no faster at the training shape), O is stored from registers, and at
// 167 registers a thread one CTA fills an SM, so a CTA's first loads are
// not overlapped with another's work.
//
// The bf16 backward on the tensor cores keeps the reference's split into
// a dQ pass and a dK/dV pass, each owning 128 rows of one (b, h) (two
// consumer warpgroups of 64) and streaming 64-row tiles of the other side
// through a 3-stage TMA ring (64-row boxes of the same 4-D maps):
// - flash_dq_tc_kernel owns query rows (Q, dO, lse, delta loaded once) and
//   streams K, V: S = Q K^T and dP = dO V^T (wgmma.m64n64k16, K-major),
//   P = exp2(s sm log2(e) - lse log2(e)) while dP runs, dS = P (dP -
//   delta) rounded to bf16 from the accumulators into the A registers of
//   dQ += dS K (K read MN-major). Heaviest causal tiles first.
// - flash_dkv_tc_kernel owns key rows (K, V loaded once) and streams Q,
//   dO with their lse and delta (copied into the stage by the producer
//   warp's 32 lanes; lse is +1e30 past T, so TMA's zero rows give P = 0):
//   it works in the transposed form, S^T = K Q^T and dP^T = V dO^T, so
//   P^T and dS^T come out as the A fragments of dV += P^T dO and dK +=
//   dS^T Q, with no shared-memory round trip. Causal CTAs start at their
//   diagonal, the low key tiles (the most query rows) first. Its two f32
//   accumulators (128 registers a thread at D 128) do not fit the 168
//   registers 9 warps leave, so its producer is a warpgroup that gives
//   registers to the consumers (setmaxnreg: 40 and 232).
// Each warpgroup waits for its products before the next tile (no overlap
// of one tile's softmax with the next tile's products).
//
// The CUDA-core kernels (f32, bf16 at D 32, whose 64-byte rows are under
// the 128-byte swizzle span the tensor-core kernels' TMA boxes use, and
// bf16 at D 256) are the simple first version: 64 x 64 tiles (32 x 32 at
// D 256) of f32 FMA from shared memory (each thread owns a 4 x 8 block of
// scores and a 4 x D/8 block of the accumulator, 2 x 4 and 2 x D/8 at D
// 256, rows spaced 16 apart and columns 8 apart so a warp reads shared
// memory without bank conflicts), so they run at the CUDA cores' rate,
// far from the bound.
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a head dim it has no
// instantiation for); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite, as flash_attention.py's NEG_INF
constexpr int kThreads = 128;      // 4 warps
constexpr int G = 8;               // lanes of a row group

// The CUDA-core kernels' tiles at head dim D: BT rows of a q tile and of
// a kv tile (64, and 32 at D 256 so that four transposed f32 tiles fit in
// an SM's shared memory and dK/dV's two accumulators in registers), LD
// the padded row of a transposed tile. Thread t owns tile rows rg + 16*i
// (i < RI) and columns cg + 8*j (j < CJ), rg = t / 8, cg = t % 8: the G
// = 8 threads of one row group are 8 consecutive lanes, so row
// reductions are three xor shuffles.
template <int D>
struct Tile {
  static constexpr int BT = D > 128 ? 32 : 64;
  static constexpr int LD = BT + 1;
  static constexpr int RI = BT / 16;
  static constexpr int CJ = BT / G;
};

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (p.astype(v.dtype) in the reference).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows row0 .. row0+BT-1 of one (b, h) slice, transposed and
// scaled, into xt[D][LD] (f32). base points at element (b, 0, h, 0);
// row t lives at base + t * HD. Rows past Tn load as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* xt, const T* base, int row0,
                                        int Tn, int HD, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = D / VEC;
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD;
  for (int e = threadIdx.x; e < BT * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < Tn) {
      Vec16<T>::load(base + (size_t)(row0 + r) * HD + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) xt[(c + i) * LD + r] = v[i] * scale;
  }
}

// The same rows untransposed into xs[BT][D].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* xs, const T* base, int row0,
                                           int Tn, int HD) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = D / VEC;
  constexpr int BT = Tile<D>::BT;
  for (int e = threadIdx.x; e < BT * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < Tn) {
      Vec16<T>::load(base + (size_t)(row0 + r) * HD + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) xs[r * D + c + i] = v[i];
  }
}

// acc[i][j] += sum_d at[d][rg + 16 i] * bt[d][cg + 8 j]: a BT x BT tile
// of A . B^T from two transposed tiles.
template <int D>
__device__ __forceinline__ void tile_abt(
    float (&acc)[Tile<D>::RI][Tile<D>::CJ], const float* at, const float* bt,
    int rg, int cg) {
  constexpr int LD = Tile<D>::LD, RI = Tile<D>::RI, CJ = Tile<D>::CJ;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = at[d * LD + rg + 16 * i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = bt[d * LD + cg + 8 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tn, int H, float scale) {
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD, RI = Tile<D>::RI,
                CJ = Tile<D>::CJ;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* qt = smem;            // [D][LD], q * scale
  float* kt = qt + D * LD;     // [D][LD]
  float* vs = kt + D * LD;     // [BT][D]
  float* ps = vs + BT * D;     // [BT][LD], p rounded to v's dtype

  const int nt = (Tn + BT - 1) / BT;
  const int q0 = (nt - 1 - blockIdx.x) * BT;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;

  stage_t<T, D>(qt, q + base, q0, Tn, HD, scale);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int last_row = min(q0 + BT, Tn) - 1;
  const int n_kv = CAUSAL ? last_row / BT + 1 : nt;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // the previous tile's kt / vs / ps are consumed
    stage_t<T, D>(kt, k + base, k0, Tn, HD, 1.f);
    stage_rows<T, D>(vs, v + base, k0, Tn, HD);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    tile_abt<D>(s, qt, kt, rg, cg);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kc = k0 + cg + 8 * j;
        const bool live = kc < Tn && (!CAUSAL || kc <= q0 + r);
        s[i][j] = live ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[r * LD + cg + 8 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float pa[RI], vb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pa[i] = ps[(rg + 16 * i) * LD + kk];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) vb[jd] = vs[kk * D + cg + 8 * jd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          acc[i][jd] = fmaf(pa[i], vb[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row < Tn) {
      T* o = out + base + (size_t)row * HD;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd)
        o[cg + 8 * jd] = from_f32<T>(acc[i][jd] * inv);
      if (lse != nullptr && cg == 0)
        lse[(size_t)bh * Tn + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tn, int H, float scale) {
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD, RI = Tile<D>::RI,
                CJ = Tile<D>::CJ;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* qt = smem;            // [D][LD], q * scale
  float* dot = qt + D * LD;    // [D][LD], dO
  float* kt = dot + D * LD;    // [D][LD]
  float* vt = kt + D * LD;     // [D][LD]
  float* dss = vt + D * LD;    // [BT][LD], dS

  const int nt = (Tn + BT - 1) / BT;
  const int q0 = (nt - 1 - blockIdx.x) * BT;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;

  stage_t<T, D>(qt, q + base, q0, Tn, HD, scale);
  stage_t<T, D>(dot, dout + base, q0, Tn, HD, 1.f);
  float row_lse[RI], row_delta[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg + 16 * i;
    row_lse[i] = row < Tn ? lse[(size_t)bh * Tn + row] : 0.f;
    row_delta[i] = row < Tn ? delta[(size_t)bh * Tn + row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int last_row = min(q0 + BT, Tn) - 1;
  const int n_kv = CAUSAL ? last_row / BT + 1 : nt;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BT;
    __syncthreads();
    stage_t<T, D>(kt, k + base, k0, Tn, HD, 1.f);
    stage_t<T, D>(vt, v + base, k0, Tn, HD, 1.f);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, qt, kt, rg, cg);
    tile_abt<D>(dp, dot, vt, rg, cg);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kc = k0 + cg + 8 * j;
        const bool live = kc < Tn && (!CAUSAL || kc <= q0 + r);
        const float p = live ? expf(s[i][j] - row_lse[i]) : 0.f;
        dss[r * LD + cg + 8 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

    // acc[i][jd] += sum_c dS[r_i][c] * K[c][cg + 8 jd], K read from kt.
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float da[RI], kb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) da[i] = dss[(rg + 16 * i) * LD + kk];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) kb[jd] = kt[(cg + 8 * jd) * LD + kk];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          acc[i][jd] = fmaf(da[i], kb[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row < Tn) {
      T* o = dq + base + (size_t)row * HD;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd)
        o[cg + 8 * jd] = from_f32<T>(acc[i][jd] * scale);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tn, int H, float scale) {
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD, RI = Tile<D>::RI,
                CJ = Tile<D>::CJ;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* kt = smem;            // [D][LD]
  float* vt = kt + D * LD;     // [D][LD]
  float* qt = vt + D * LD;     // [D][LD], q * scale
  float* dot = qt + D * LD;    // [D][LD], dO
  float* pt = dot + D * LD;    // [BT][LD], P^T (kv row, q column)
  float* dst = pt + BT * LD;   // [BT][LD], dS^T
  float* lse_s = dst + BT * LD;   // [BT]
  float* delta_s = lse_s + BT;    // [BT]

  const int nt = (Tn + BT - 1) / BT;
  const int k0 = blockIdx.x * BT;  // low kv tiles see the most q rows
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;

  stage_t<T, D>(kt, k + base, k0, Tn, HD, 1.f);
  stage_t<T, D>(vt, v + base, k0, Tn, HD, 1.f);
  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  // Under causal masking q tiles before the kv tile see none of it.
  for (int t = CAUSAL ? blockIdx.x : 0; t < nt; ++t) {
    const int q0 = t * BT;
    __syncthreads();
    stage_t<T, D>(qt, q + base, q0, Tn, HD, scale);
    stage_t<T, D>(dot, dout + base, q0, Tn, HD, 1.f);
    for (int e = threadIdx.x; e < BT; e += kThreads) {
      const int row = q0 + e;
      lse_s[e] = row < Tn ? lse[(size_t)bh * Tn + row] : 0.f;
      delta_s[e] = row < Tn ? delta[(size_t)bh * Tn + row] : 0.f;
    }
    __syncthreads();

    // Transposed scores: s[i][j] for kv row rg + 16 i, q column cg + 8 j.
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, kt, qt, rg, cg);
    tile_abt<D>(dp, vt, dot, rg, cg);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = cg + 8 * j;
        const int qr = q0 + c;
        const bool live = qr < Tn && (!CAUSAL || qr >= k0 + r);
        const float p = live ? expf(s[i][j] - lse_s[c]) : 0.f;
        pt[r * LD + c] = p;
        dst[r * LD + c] = p * (dp[i][j] - delta_s[c]);
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T (q * scale); dO and q read from their
    // transposed tiles.
#pragma unroll 2
    for (int qq = 0; qq < BT; ++qq) {
      float pa[RI], da[RI], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = pt[(rg + 16 * i) * LD + qq];
        da[i] = dst[(rg + 16 * i) * LD + qq];
      }
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        ob[jd] = dot[(cg + 8 * jd) * LD + qq];
        qb[jd] = qt[(cg + 8 * jd) * LD + qq];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          acc_v[i][jd] = fmaf(pa[i], ob[jd], acc_v[i][jd]);
          acc_k[i][jd] = fmaf(da[i], qb[jd], acc_k[i][jd]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + rg + 16 * i;
    if (row < Tn) {
      T* ok = dk + base + (size_t)row * HD;
      T* ov = dv + base + (size_t)row * HD;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        ok[cg + 8 * jd] = from_f32<T>(acc_k[i][jd]);
        ov[cg + 8 * jd] = from_f32<T>(acc_v[i][jd]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores (D 64 and 128)
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr int BM = 128;                  // query rows of a CTA
constexpr int BN = 128;                  // keys of a kv tile
constexpr int STAGES = 2;                // kv tiles in flight
constexpr int CONSUMERS = 256;           // 2 warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int BOX = 128;                 // bytes of a box row: 64 bf16 columns

template <int D>
struct Geom {
  static_assert(D == 64 || D == 128, "the tensor-core forward takes D 64, 128");
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;   // one of K, V
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + (1 + 2 * STAGES) * 8;
};

// d[0:64] (+)= A (64 x 16, descriptor da) . B (16 x 128, descriptor db),
// both K-major: one wgmma.m64n128k16, bf16 in, f32 accumulators; with
// accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at N 64: d[0:32] (+)= A (64 x 16) . B (16 x 64), both K-major,
// one wgmma.m64n64k16.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] += A (64 x 16: four registers of bf16 pairs) . B (16 x 64,
// descriptor db, MN-major): one wgmma.m64n64k16 with A from registers.
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:64] += A (64 x 16: four registers of bf16 pairs) . B (16 x 128,
// descriptor db, MN-major): one wgmma.m64n128k16 with A from registers.
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// out = softmax(q k^T * scale, causal) v and lse for 128 query rows of one
// (b, h): CTA (bh, i) takes query tile nt - 1 - i, so the heaviest causal
// tiles start first. mq, mk, mv: 4-D maps (D, H, T, B) over [B, T, H, D]
// with boxes of 64 columns x 1 head x 128 rows x 1 batch (rows past T
// read as zeros). Shared memory: Q [D / 64 atoms][128 rows][128 B], then
// per stage K and V alike, all 128-byte swizzled.
//
// Register layouts (wgmma m64nN f32 accumulators): s[4 j + 2 hh + c] is
// query row 64 wg + 16 warp + lane / 4 + 8 hh of the CTA's tile, key
// 8 j + 2 (lane % 4) + c of the kv tile; o the same with column d. The
// bf16 A fragment of k step kk of P . V is s[8 kk + 2 r], s[8 kk + 2 r + 1]
// for register r < 4, so P goes from S's accumulators to A registers
// without a shuffle.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int Tn, int H, float scale_log2) {
  using G = Geom<D>;
  constexpr int ATOMS = D / 64;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t skv = sq + G::Q_BYTES;   // stage s: K, then V
  const uint32_t q_full = skv + STAGES * 2 * G::KV_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  const int nt = (Tn + BM - 1) / BM;
  const int q0 = (nt - 1 - static_cast<int>(blockIdx.y)) * BM;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int last = min(q0 + BM, Tn) - 1;
  const int n_kv = CAUSAL ? last / BN + 1 : (Tn + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // producer warp: one thread issues TMA
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(sq + a * BM * BOX, &mq, 64 * a, h, q0, b, q_full);
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + 8 * st, (t / STAGES - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * G::KV_BYTES);
        const uint32_t sk = skv + st * 2 * G::KV_BYTES;
        const uint32_t sv = sk + G::KV_BYTES;
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_4d(sk + a * BN * BOX, &mk, 64 * a, h, t * BN, b, bar);
          tma_load_4d(sv + a * BN * BOX, &mv, 64 * a, h, t * BN, b, bar);
        }
      }
    }
    return;
  }

  constexpr float kLn2 = 0.6931471805599453f;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int row_lo = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  // Scores in log2 units: x = q . k * scale * log2(e); m is the running
  // max of x, l this thread's part of the running sum of exp2(x - m).
  float s[64], o[D / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int st = t % STAGES, k0 = t * BN;
    const uint32_t sk = skv + st * 2 * G::KV_BYTES;
    const uint32_t sv = sk + G::KV_BYTES;
    mbar_wait(full + 8 * st, (t / STAGES) & 1);

    // S = Q K^T: K-major operands, the next 16 d are 32 bytes along the
    // swizzled row, the next 64 d the next atom.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = smem_desc(
          sq + (kk >> 2) * BM * BOX + wg * 64 * BOX + (kk & 3) * 32, 16, 1024);
      const uint64_t db =
          smem_desc(sk + (kk >> 2) * BN * BOX + (kk & 3) * 32, 16, 1024);
      wgmma_qk(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax. Only the diagonal tile (causal) and the ragged last
    // tile mask; the 4 lanes of a quad hold a row's 128 keys.
    const bool edge = k0 + BN > Tn || (CAUSAL && k0 + BN - 1 > q0 + 64 * wg);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_lo + 8 * hh;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * hh + c] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + cq + c;
            if (col >= Tn || (CAUSAL && col > row)) x = kNegInf;
          }
          s[4 * j + 2 * hh + c] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[hh], mt);
      const float corr = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * j + 2 * hh + c] - m_new);
          s[4 * j + 2 * hh + c] = p;
          rs += p;
        }
      l[hh] = l[hh] * corr + rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) o[4 * j + 2 * hh + c] *= corr;
    }

    // O += P V: P rounded to bf16 (v's dtype) in A registers; V is
    // MN-major (d contiguous): the next 16 keys are 16 rows of 128 B
    // further, the next 64 d the next atom (BN rows of 128 B).
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 pr =
            __floats2bfloat162_rn(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        pa[kk][r] = *reinterpret_cast<const uint32_t*>(&pr);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv(o, pa[kk], smem_desc(sv + kk * 16 * BOX, BN * BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row_lo + 8 * hh;
    if (row < Tn) {
      const float inv = 1.f / lt;
      bf16* op = out + ((size_t)(b * Tn + row) * H + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
            o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * Tn + row] = (m[hh] + log2f(lt)) * kLn2;
    }
  }
}

// A 4-D map (D, H, T, B) over a contiguous [B, T, H, D] bf16 tensor with
// boxes of 64 columns x 1 x `rows` rows x 1.
bool make_map(CUtensorMap* map, const void* ptr, int B, int Tn, int H, int D,
              int rows = BM) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(Tn),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(Tn) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

template <int D, bool C>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Tn, int H, float scale,
                       cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Tn, H, D) || !make_map(&mk, k, B, Tn, H, D) ||
      !make_map(&mv, v, B, Tn, H, D))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Geom<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tn + BM - 1) / BM);
  flash_fwd_tc_kernel<D, C><<<grid, THREADS, Geom<D>::SMEM, s>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, Tn, H,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores (D 64 and 128)
// ---------------------------------------------------------------------------
// Both kernels own 128 rows of one (b, h) (query rows for dQ, key rows
// for dK/dV), two consumer warpgroups of 64 rows each, and stream tiles of
// SB = 64 rows of the other side through a STAGES-deep TMA ring fed by one
// producer warp. The owned tensors are loaded once. All products are
// wgmma with f32 accumulators; P and dS are rounded to bf16 straight from
// the accumulator layout into A registers (no shared-memory round trip).
constexpr int OWN = 128;    // rows a CTA owns
constexpr int SB = 64;      // rows of a streamed tile
constexpr int BSTAGES = 3;  // streamed tiles in flight
// dK/dV holds two 64 x D f32 accumulators a warpgroup (128 registers a
// thread at D 128) besides S^T and dP^T: more than the 168 registers a
// thread that 9 or 12 warps leave. Its producer is a whole warpgroup that
// gives registers back (setmaxnreg) to the two consumer warpgroups: per
// SM sub-partition one producer warp at 40 and two consumer warps at 232
// fill the 16,384 registers.
constexpr int DKV_THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int D>
struct BwdGeom {
  static_assert(D == 64 || D == 128, "the tensor-core backward takes D 64, 128");
  static constexpr int OWN_BYTES = OWN * D * 2;   // one owned tensor
  static constexpr int TILE_BYTES = SB * D * 2;   // one streamed tensor
  static constexpr int ROW_BYTES = 2 * SB * 4;    // a tile's lse and delta
  static constexpr int SMEM = 1024 + 2 * OWN_BYTES + BSTAGES * 2 * TILE_BYTES +
                              BSTAGES * ROW_BYTES + (1 + 2 * BSTAGES) * 8;
};

// Keeps the compiler from reusing A-fragment registers that an in-flight
// wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Loads `rows` rows from row r0 of map m into a tile of D / 64 atoms of
// [tile_rows][128 B], in boxes of SB rows.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* m,
                                          int tile_rows, int rows, int h,
                                          int r0, int b, uint32_t bar) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    for (int r = 0; r < rows; r += SB)
      tma_load_4d(dst + (a * tile_rows + r) * BOX, m, 64 * a, h, r0 + r, b,
                  bar);
}

// dq = scale * sum_kv dS K for 128 query rows of one (b, h), with P =
// exp(s - lse) and dS = P * (dO V^T - delta) rebuilt per kv tile: CTA
// (bh, i) takes query tile nt - 1 - i, so the heaviest causal tiles start
// first. mq, mdo: maps with 64-row boxes over q, dO (loaded once); mk, mv:
// the same over k, v (streamed, 64 keys a stage). lse, delta: [B*H, T] f32.
//
// Per kv tile each warpgroup runs S = Q K^T and dP = dO V^T (m64n64k16,
// both operands K-major), P and dS in registers, and dQ += dS K with dS
// from registers and K read MN-major (m64n{D}k16). Register layouts as in
// flash_fwd_tc_kernel.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Tn, int H, float scale) {
  using G = BwdGeom<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + G::OWN_BYTES;
  const uint32_t skv = sdo + G::OWN_BYTES;  // stage s: K, then V
  const uint32_t own_full = skv + BSTAGES * 2 * G::TILE_BYTES +
                            BSTAGES * G::ROW_BYTES;
  const uint32_t full = own_full + 8, empty = full + 8 * BSTAGES;

  const int nt = (Tn + OWN - 1) / OWN;
  const int q0 = (nt - 1 - static_cast<int>(blockIdx.y)) * OWN;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int last = min(q0 + OWN, Tn) - 1;
  const int n_kv = CAUSAL ? last / SB + 1 : (Tn + SB - 1) / SB;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // producer warp: one thread issues TMA
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(own_full, 2 * G::OWN_BYTES);
      load_rows<D>(sq, &mq, OWN, OWN, h, q0, b, own_full);
      load_rows<D>(sdo, &mdo, OWN, OWN, h, q0, b, own_full);
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % BSTAGES;
        if (t >= BSTAGES) mbar_wait(empty + 8 * st, (t / BSTAGES - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * G::TILE_BYTES);
        const uint32_t sk = skv + st * 2 * G::TILE_BYTES;
        load_rows<D>(sk, &mk, SB, SB, h, t * SB, b, bar);
        load_rows<D>(sk + G::TILE_BYTES, &mv, SB, SB, h, t * SB, b, bar);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int wrow0 = q0 + 64 * wg;   // the warpgroup's first query row
  const int row_lo = wrow0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + 8 * hh;
    lse2[hh] = row < Tn ? lse[(size_t)bh * Tn + row] * kLog2e : 0.f;
    dlt[hh] = row < Tn ? delta[(size_t)bh * Tn + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(own_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int st = t % BSTAGES, k0 = t * SB;
    const uint32_t sk = skv + st * 2 * G::TILE_BYTES;
    const uint32_t sv = sk + G::TILE_BYTES;
    mbar_wait(full + 8 * st, (t / BSTAGES) & 1);
    if (CAUSAL && k0 > wrow0 + 63) {   // every key after every row
      mbar_arrive(empty + 8 * st);
      continue;
    }

    // S = Q K^T and dP = dO V^T, two commit groups.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(s,
               smem_desc(sq + (kk >> 2) * OWN * BOX + wg * 64 * BOX +
                             (kk & 3) * 32, 16, 1024),
               smem_desc(sk + (kk >> 2) * SB * BOX + (kk & 3) * 32, 16, 1024),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(dp,
               smem_desc(sdo + (kk >> 2) * OWN * BOX + wg * 64 * BOX +
                             (kk & 3) * 32, 16, 1024),
               smem_desc(sv + (kk >> 2) * SB * BOX + (kk & 3) * 32, 16, 1024),
               kk > 0);
    wgmma_commit();

    // P = exp2(s * scale * log2(e) - lse * log2(e)) while dP runs; masks
    // only on the diagonal and ragged tiles (keys past T are zeros).
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = k0 + SB > Tn || (CAUSAL && k0 + SB - 1 > wrow0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * hh + c;
          float p = exp2f(fmaf(s[i], scale_log2, -lse2[hh]));
          if (edge) {
            const int col = k0 + 8 * j + cq + c;
            if (col >= Tn || (CAUSAL && col > row_lo + 8 * hh)) p = 0.f;
          }
          s[i] = p;
        }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P (dP - delta), rounded to bf16 into the A fragments of
    // dQ += dS K: register r of k step kk is elements 8 kk + 2 r, + 1.
    uint32_t ds[SB / 16][4];
#pragma unroll
    for (int kk = 0; kk < SB / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float d0 = dlt[r & 1];
        ds[kk][r] = pack_bf16(s[i] * (dp[i] - d0), s[i + 1] * (dp[i + 1] - d0));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SB / 16; ++kk)
      wgmma_pv(acc, ds[kk], smem_desc(sk + kk * 16 * BOX, SB * BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(ds);
    mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + 8 * hh;
    if (row < Tn) {
      bf16* op = dq + ((size_t)(b * Tn + row) * H + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
    }
  }
}

// dk = scale * sum_q dS^T Q and dv = sum_q P^T dO for 128 key rows of one
// (b, h): CTA (bh, i) takes key tile i, so the low tiles, which see the
// most query rows under a causal mask, start first; under a causal mask
// the query tiles start at the CTA's diagonal. mk, mv: maps with 64-row
// boxes over k, v (loaded once); mq, mdo: the same over q, dO (streamed,
// 64 query rows a stage, with their lse and delta, which the producer
// warp's 32 lanes copy into the stage: lse * log2(e), and +1e30 for rows
// past T, so that a row TMA filled with zeros gets P = 0).
//
// Per query tile each warpgroup runs the transposed products S^T = K Q^T
// and dP^T = V dO^T (m64n64k16, both operands K-major), so P^T and dS^T
// come out in the accumulator layout that is the A fragment of dV += P^T
// dO and dK += dS^T Q (dO and Q read MN-major, m64n{D}k16).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Tn,
                        int H, float scale) {
  using G = BwdGeom<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + G::OWN_BYTES;
  const uint32_t sqd = sv + G::OWN_BYTES;   // stage s: Q, then dO
  const uint32_t srow = sqd + BSTAGES * 2 * G::TILE_BYTES;
  // stage s: lse * log2(e) [SB], then delta [SB]
  float* rows = reinterpret_cast<float*>(smem + (srow - smem_addr(smem)));
  const uint32_t own_full = srow + BSTAGES * G::ROW_BYTES;
  const uint32_t full = own_full + 8, empty = full + 8 * BSTAGES;

  const int k0 = blockIdx.y * OWN;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int t0 = CAUSAL ? k0 / SB : 0;
  const int n_q = (Tn + SB - 1) / SB - t0;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < BSTAGES; ++s) {
      // the expect_tx arrival, then one arrival per producer lane after
      // its lse / delta stores
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // producer warpgroup: its first warp
    reg_dealloc<PRODUCER_REGS>();
    const int pl = threadIdx.x - CONSUMERS;
    if (pl >= 32) return;
    if (pl == 0) {
      mbar_expect_tx(own_full, 2 * G::OWN_BYTES);
      load_rows<D>(sk, &mk, OWN, OWN, h, k0, b, own_full);
      load_rows<D>(sv, &mv, OWN, OWN, h, k0, b, own_full);
    }
    for (int i = 0; i < n_q; ++i) {
      const int st = i % BSTAGES, q0 = (t0 + i) * SB;
      if (i >= BSTAGES) mbar_wait(empty + 8 * st, (i / BSTAGES - 1) & 1);
      const uint32_t bar = full + 8 * st;
      if (pl == 0) {
        mbar_expect_tx(bar, 2 * G::TILE_BYTES);
        const uint32_t sq = sqd + st * 2 * G::TILE_BYTES;
        load_rows<D>(sq, &mq, SB, SB, h, q0, b, bar);
        load_rows<D>(sq + G::TILE_BYTES, &mdo, SB, SB, h, q0, b, bar);
      }
      float* rl = rows + st * 2 * SB;
      for (int r = pl; r < SB; r += 32) {
        const int row = q0 + r;
        const bool live = row < Tn;
        rl[r] = live ? lse[(size_t)bh * Tn + row] * kLog2e : 1e30f;
        rl[SB + r] = live ? delta[(size_t)bh * Tn + row] : 0.f;
      }
      mbar_arrive(bar);
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int wrow0 = k0 + 64 * wg;   // the warpgroup's first key row
  const int row_lo = wrow0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float scale_log2 = scale * kLog2e;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(own_full, 0);
  for (int i = 0; i < n_q; ++i) {
    const int st = i % BSTAGES, q0 = (t0 + i) * SB;
    const uint32_t sq = sqd + st * 2 * G::TILE_BYTES;
    const uint32_t sdo = sq + G::TILE_BYTES;
    const float* rl = rows + st * 2 * SB;
    mbar_wait(full + 8 * st, (i / BSTAGES) & 1);
    if (CAUSAL && q0 + SB - 1 < wrow0) {   // every query before every key
      mbar_arrive(empty + 8 * st);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T, two commit groups.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(s,
               smem_desc(sk + (kk >> 2) * OWN * BOX + wg * 64 * BOX +
                             (kk & 3) * 32, 16, 1024),
               smem_desc(sq + (kk >> 2) * SB * BOX + (kk & 3) * 32, 16, 1024),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(dp,
               smem_desc(sv + (kk >> 2) * OWN * BOX + wg * 64 * BOX +
                             (kk & 3) * 32, 16, 1024),
               smem_desc(sdo + (kk >> 2) * SB * BOX + (kk & 3) * 32, 16, 1024),
               kk > 0);
    wgmma_commit();

    // P^T = exp2(s * scale * log2(e) - lse[q] * log2(e)), zero where the
    // query precedes the key (diagonal tiles only).
    wgmma_wait<1>();
    fence_regs(s);
    const bool diag = CAUSAL && q0 < wrow0 + 63;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + cq + c;
        const float l2 = rl[col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i2 = 4 * j + 2 * hh + c;
          float p = exp2f(fmaf(s[i2], scale_log2, -l2));
          if (diag && q0 + col < row_lo + 8 * hh) p = 0.f;
          s[i2] = p;
        }
      }
    wgmma_wait<0>();
    fence_regs(dp);

    // P^T and dS^T = P^T (dP^T - delta[q]) rounded to bf16 into A
    // fragments: register r of k step kk is elements 8 kk + 2 r, + 1,
    // query columns 16 kk + 8 (r >> 1) + cq, + 1.
    uint32_t pf[SB / 16][4], df[SB / 16][4];
#pragma unroll
    for (int kk = 0; kk < SB / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i2 = 8 * kk + 2 * r;
        const int col = 16 * kk + 8 * (r >> 1) + cq;
        pf[kk][r] = pack_bf16(s[i2], s[i2 + 1]);
        df[kk][r] = pack_bf16(s[i2] * (dp[i2] - rl[SB + col]),
                              s[i2 + 1] * (dp[i2 + 1] - rl[SB + col + 1]));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SB / 16; ++kk)
      wgmma_pv(dva, pf[kk], smem_desc(sdo + kk * 16 * BOX, SB * BOX, 1024));
#pragma unroll
    for (int kk = 0; kk < SB / 16; ++kk)
      wgmma_pv(dka, df[kk], smem_desc(sq + kk * 16 * BOX, SB * BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_frags(pf);
    fence_frags(df);
    mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_lo + 8 * hh;
    if (row < Tn) {
      const size_t off = ((size_t)(b * Tn + row) * H + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(dka[4 * j + 2 * hh] * scale,
                                  dka[4 * j + 2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// The four maps of a backward launch, 64-row boxes.
bool make_bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                   const void* v, const void* dout, int B, int Tn, int H,
                   int D) {
  return make_map(&m[0], q, B, Tn, H, D, SB) &&
         make_map(&m[1], k, B, Tn, H, D, SB) &&
         make_map(&m[2], v, B, Tn, H, D, SB) &&
         make_map(&m[3], dout, B, Tn, H, D, SB);
}

template <int D, bool C>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Tn, int H, float scale,
                      cudaStream_t s) {
  CUtensorMap m[4];
  if (!make_bwd_maps(m, q, k, v, dout, B, Tn, H, D))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_tc_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdGeom<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tn + OWN - 1) / OWN);
  flash_dq_tc_kernel<D, C><<<grid, THREADS, BwdGeom<D>::SMEM, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dq), Tn, H,
      scale);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int Tn, int H, float scale,
                       cudaStream_t s) {
  CUtensorMap m[4];
  if (!make_bwd_maps(m, q, k, v, dout, B, Tn, H, D))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_tc_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdGeom<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tn + OWN - 1) / OWN);
  flash_dkv_tc_kernel<D, C><<<grid, DKV_THREADS, BwdGeom<D>::SMEM, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Tn, H, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
constexpr size_t fwd_smem() {
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD;
  return (size_t)(2 * D * LD + BT * D + BT * LD) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD;
  return (size_t)(4 * D * LD + BT * LD) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int BT = Tile<D>::BT, LD = Tile<D>::LD;
  return (size_t)(4 * D * LD + 2 * BT * LD + 2 * BT) * sizeof(float);
}

// Above 48 KB a kernel takes dynamic shared memory only after opting in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool C>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Tn, int H, float scale,
                       cudaStream_t s) {
  const size_t smem = fwd_smem<D>();
  constexpr int BT = Tile<D>::BT;
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, B * H);
  flash_fwd_kernel<T, D, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tn, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool C>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Tn, int H, float scale,
                      cudaStream_t s) {
  const size_t smem = dq_smem<D>();
  constexpr int BT = Tile<D>::BT;
  cudaError_t err = allow_smem(flash_dq_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, B * H);
  flash_dq_kernel<T, D, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tn, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool C>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int Tn, int H, float scale,
                       cudaStream_t s) {
  const size_t smem = dkv_smem<D>();
  constexpr int BT = Tile<D>::BT;
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, B * H);
  flash_dkv_kernel<T, D, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, scale);
  return cudaGetLastError();
}

// Calls F<T, D, causal>::run(args...) for the runtime (dtype, D, causal);
// cudaErrorInvalidValue when there is no such instantiation. bf16 takes
// D 32 and 256 only: bf16 heads of 64 and 128 run on the tensor cores.
template <template <typename, int, bool> class F, typename... A>
cudaError_t dispatch(int dtype, int D, int causal, A... args) {
#define RTT_CASE(T, DD)                                              \
  if (D == DD)                                                       \
    return causal ? F<T, DD, true>::run(args...)                     \
                  : F<T, DD, false>::run(args...);
  if (dtype == 0) {
    RTT_CASE(float, 32)
    RTT_CASE(float, 64)
    RTT_CASE(float, 128)
    RTT_CASE(float, 256)
  } else if (dtype == 1) {
    RTT_CASE(__nv_bfloat16, 32)
    RTT_CASE(__nv_bfloat16, 256)
  }
#undef RTT_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool C>
struct Fwd {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Tn, int H,
                         float scale, cudaStream_t s) {
    return launch_fwd<T, D, C>(q, k, v, out, lse, B, Tn, H, scale, s);
  }
};

template <typename T, int D, bool C>
struct Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int B, int Tn, int H,
                         float scale, cudaStream_t s) {
    return launch_dq<T, D, C>(q, k, v, dout, lse, delta, dq, B, Tn, H, scale,
                              s);
  }
};

template <typename T, int D, bool C>
struct Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int Tn, int H, float scale, cudaStream_t s) {
    return launch_dkv<T, D, C>(q, k, v, dout, lse, delta, dk, dv, B, Tn, H,
                               scale, s);
  }
};

}  // namespace

// The forward on CUDA cores: float32 (dtype 0) at D 32, 64, 128, 256 and
// bfloat16 (dtype 1) at D 32 and 256. q, k, v, out: [B, T, H, D] contiguous; lse:
// [B*H, T] f32 or null (the inference variant skips its write).
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int T, int H, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  return static_cast<int>(dispatch<Fwd>(
      dtype, D, causal, q, k, v, out, static_cast<float*>(lse), B, T, H,
      scale, static_cast<cudaStream_t>(stream)));
}

// The bfloat16 forward on the tensor cores at D 64 and 128: the same
// arguments, 16-byte-aligned tensors.
extern "C" int rtt_flash_fwd_tc(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int T, int H,
                                int D, float scale, int causal,
                                void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (D == 64)
    return causal ? tc::launch_fwd<64, true>(q, k, v, out, l, B, T, H, scale, s)
                  : tc::launch_fwd<64, false>(q, k, v, out, l, B, T, H, scale,
                                              s);
  if (D == 128)
    return causal
               ? tc::launch_fwd<128, true>(q, k, v, out, l, B, T, H, scale, s)
               : tc::launch_fwd<128, false>(q, k, v, out, l, B, T, H, scale,
                                            s);
  return cudaErrorInvalidValue;
}

// The backward on CUDA cores (float32 at D 32, 64, 128, 256; bfloat16 at
// D 32 and 256).
// dout, dq: [B, T, H, D]; lse, delta: [B*H, T] f32.
extern "C" int rtt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T, int H,
                            int D, float scale, int causal, int dtype,
                            void* stream) {
  return static_cast<int>(dispatch<Dq>(
      dtype, D, causal, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dq, B, T, H, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int rtt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int T, int H, int D, float scale, int causal,
                             int dtype, void* stream) {
  return static_cast<int>(dispatch<Dkv>(
      dtype, D, causal, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, B, T, H, scale,
      static_cast<cudaStream_t>(stream)));
}

// The bfloat16 backward on the tensor cores at D 64 and 128: the same
// arguments as rtt_flash_dq / rtt_flash_dkv without the dtype,
// 16-byte-aligned tensors.
extern "C" int rtt_flash_dq_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int T,
                               int H, int D, float scale, int causal,
                               void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (D == 64)
    return causal ? tc::launch_dq<64, true>(q, k, v, dout, l, dl, dq, B, T, H,
                                            scale, s)
                  : tc::launch_dq<64, false>(q, k, v, dout, l, dl, dq, B, T,
                                             H, scale, s);
  if (D == 128)
    return causal ? tc::launch_dq<128, true>(q, k, v, dout, l, dl, dq, B, T,
                                             H, scale, s)
                  : tc::launch_dq<128, false>(q, k, v, dout, l, dl, dq, B, T,
                                              H, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int rtt_flash_dkv_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int T, int H, int D, float scale, int causal,
                                void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (D == 64)
    return causal ? tc::launch_dkv<64, true>(q, k, v, dout, l, dl, dk, dv, B,
                                             T, H, scale, s)
                  : tc::launch_dkv<64, false>(q, k, v, dout, l, dl, dk, dv, B,
                                              T, H, scale, s);
  if (D == 128)
    return causal ? tc::launch_dkv<128, true>(q, k, v, dout, l, dl, dk, dv, B,
                                              T, H, scale, s)
                  : tc::launch_dkv<128, false>(q, k, v, dout, l, dl, dk, dv,
                                               B, T, H, scale, s);
  return cudaErrorInvalidValue;
}
