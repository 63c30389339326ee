// Fused cross-entropy over a tied embedding, hand-written for Hopper
// (sm_90a). The kernels and the TPU kernels they replace:
//
//   forward, replacing ray_tpu/ops/fused_xent.py::_fwd_kernel (per row:
//   logsumexp of x . E^T over the vocabulary and the raw target logit,
//   without the [N, V] logits):
//   bf16 (tensor cores), two kernels:
//   xent_fwd_tc_kernel    per (128-row tile, 256-column vocabulary tile):
//                         the tile's max and sum of exp for each row into a
//                         [V / 256, N] workspace, and the target logit
//   xent_fwd_merge_kernel per row: logsumexp of its partials, in tile order
//   f32 (CUDA cores): xent_fwd_kernel
//   bf16 backward, per vocabulary chunk of C rows (E_c = E[v0 : v0 + C]):
//   xent_dlog_kernel dlog_c = c_lse * exp(x . E_c^T - lse) + c_tgt * onehot,
//                    stored once as bf16 [N_pad, C]; shared by the two
//                    kernels below, as _recompute_dlog is shared by
//                    _dx_kernel and _de_kernel
//   xent_dx_kernel   replaces _dx_kernel: dx (+)= dlog_c . E_c
//   xent_de_kernel   replaces _de_kernel: dE_c = dlog_c^T . x
//   f32 backward (exact in f32 on CUDA cores, for f32 inputs):
//   xent_bwd_kernel<ROW_PANEL = true>   replaces _dx_kernel
//   xent_bwd_kernel<ROW_PANEL = false>  replaces _de_kernel
//
// with dlog = c_lse * exp(s - lse) + c_tgt * onehot(target), s = x . E^T
// rebuilt from the forward's saved lse, exactly as the shared
// _recompute_dlog does. The logits are f32 sums of exact products (bf16
// products are exact in f32; the f32 kernels cast the inputs to f32), dx
// and dE are written as f32 (the wrapper casts at the autograd boundary,
// as the reference's custom_vjp does). Widths D 64 and every multiple of
// 128 up to 1024 are instantiated (the f32 kernels' accumulator columns
// need one of those; the tensor-core kernels take any multiple of 64);
// the Python wrapper zero-pads any other width up to the next of them.
//
// The bf16 kernels on the tensor cores. At bench.py's loss shape (N
// 24576, V 50304, D 1024) the forward is one product of 2 N V D = 2.53
// TFLOP (the logits) and the backward three (the rebuilt logits, dx, dE):
// 2.5 and 7.6 TFLOP against ~0.2 GB of inputs, so the tensor cores' 989
// TFLOP/s bound them (2.6 and 7.7 ms). The design:
// - One GEMM core (`gemm`) serves all four product kernels: a 128 x 256
//   CTA tile, Hopper's wgmma.mma_async.m64n256k16 (bf16 in, f32
//   accumulators, 128 a thread) issued by two consumer warpgroups of 64
//   rows each, K streamed 64 at a time through a 4-stage ring in shared
//   memory (192 KB). One producer warp fills the ring with TMA
//   (cp.async.bulk.tensor, one mbarrier per stage for "full" and one for
//   "empty"), so no thread spends instructions on loads. Each operand is
//   staged as it lies in memory, 128-byte swizzled: K-major (x and E rows
//   for the logits, dlog rows for dx) or MN-major (E_c for dx; dlog and x
//   for dE, read with wgmma's transpose bit). Rows and columns past an
//   operand's map read as zeros (TMA's out-of-bounds fill), so ragged N
//   and V need no masking on the way in. The tensor maps are encoded per
//   launch through cudaGetDriverEntryPoint("cuTensorMapEncodeTiled")
//   (hopper.cuh), so the library does not link libcuda.
// - The forward reduces in the accumulators' registers: per row, the max
//   and the sum of exp2f (log2(e) prescale) over the tile's columns < V
//   (TMA's zero-filled columns past V would add exp(0 - m)), across the
//   4 lanes of a quad with two xor shuffles, and one (m, l) per (row,
//   tile) into an f32 workspace (8 B x N x V / 256: 39 MB at the loss
//   shape). The lane that holds a row's target column writes the target
//   logit; a second kernel merges each row's partials in tile order.
//   Every value has one writer: no atomics, deterministic results. The
//   CTAs run band by band (16 vocabulary tiles, 4096 rows of E), every
//   row tile passing through a band before the next starts, so the 8 MB of
//   E in a band stays in L2 and E is read from device memory once (x once
//   per band: 13 times, 0.65 GB at the loss shape).
// - The logits are rebuilt once per chunk, not once per product: dlog is
//   formed in the accumulators' registers (exp2f with a log2(e)
//   prescale, masked past N and past V) and written as bf16 to a scratch
//   buffer that the dx and dE kernels read. That is the only rounding
//   the bf16 backward adds: |d dx| <= 2^-8 |dlog| . |E| and |d dE| <=
//   2^-8 |dlog|^T . |x| per element.
// - The sequential reduction axes of the Pallas kernels become launch
//   order: dx reads, adds and writes its own tile once per chunk (the
//   first chunk writes), and each chunk's dE rows are written once from
//   a K loop over all N. Every output element has one owner per launch
//   and launches run in stream order: no atomics, deterministic results.
// - Wide tiles against short K: a 128 x 1024 f32 panel of dx or dE
//   cannot live in one CTA's registers (the f32 kernels below keep 32
//   rows and re-stream the other operand twice per panel), so a CTA owns
//   a 128 x 256 tile and the chunk loop splits the vocabulary sum.
// What is left: with one CTA an SM, the epilogues (the forward's
// reductions, dlog's exp2f and bf16 stores, dx's f32 read-add-write) are
// not overlapped with any mainloop, and the K loops are short (16 steps
// at D 1024), so these run below the dE kernel's rate. A persistent grid
// that overlaps one tile's epilogue with the next tile's loads is the
// next step.
//
// The f32 kernels, and what carries over from the Pallas kernels:
//
// - The sequential grid axis (vocab blocks for fwd/dx, row blocks for dE)
//   becomes a loop inside one CTA; nothing is reduced across CTAs, so there
//   are no atomics and results are deterministic.
// - The Pallas blocks do not fit an SM: the dx scratch is [256, 1024] f32
//   (1 MB) and the dE scratch [384, 1024] f32 (1.5 MB). Here a CTA owns a
//   *panel* of RT = 32 rows (x rows for fwd/dx, embedding rows for dE) and
//   keeps its [32, D] f32 accumulator in registers (D / 8 floats a thread
//   for 256 threads: 128 at D = 1024). It streams the other operand in
//   tiles of ST = 128 rows: (A) the [32 x 128] score tile, D streamed
//   through shared memory in chunks of KC = 32 columns (both chunks staged
//   transposed in f32); (B) dlog formed in registers and parked in shared
//   memory; (C) dlog times the tile's rows, staged VK = 16 rows at a time.
// - lse, the cotangents and the targets are [N] rows, not [N, 128] lane
//   broadcasts, and ragged N and V are masked inside the kernels (rows past
//   N load as zeros and are not written; columns past V are masked), so no
//   shape leaves the kernel path.
//
// The f32 forward and backward are the simple version: f32 FMA on CUDA
// cores from shared memory (each thread owns a 4 x 4 block of scores, read
// as one broadcast float4 and one float4 per k, and a 4-row block of the
// accumulator across D), so they run at the CUDA cores' rate (67 TFLOP/s
// at most), far from the tensor cores.
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a width or shape it
// does not take); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;   // finite, as fused_xent.py's _NEG
constexpr int kThreads = 256;    // 8 warps
constexpr int RT = 32;           // panel rows per CTA
constexpr int ST = 128;          // stream rows per tile
constexpr int KC = 32;           // D columns per staged chunk
constexpr int VK = 16;           // stream rows per accumulate stage
constexpr int LDP = RT + 4;      // padded row of a transposed panel chunk
constexpr int LDS = ST + 4;      // padded row of a transposed stream chunk
// Thread t: warp ty = t / 32 owns panel rows 4 ty .. 4 ty + 3; lane tx owns
// stream columns 4 tx .. 4 tx + 3 of the score tile.

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

// Stage columns k0 .. k0 + KC - 1 of rows row0 .. row0 + ROWS - 1 of a
// [n, D] matrix, transposed to dst[KC][ld] (f32). Rows past n are zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_chunk_t(float* dst, int ld,
                                              const T* src, int row0, int n,
                                              int k0) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = KC / VEC;
  for (int e = threadIdx.x; e < ROWS * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < n) {
      Vec16<T>::load(src + (size_t)(row0 + r) * D + k0 + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[(c + i) * ld + r] = v[i];
  }
}

// Stage whole rows row0 .. row0 + VK - 1 of a [n, D] matrix into
// dst[VK][D] (f32). Rows past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int n) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = D / VEC;
  for (int e = threadIdx.x; e < VK * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < n) {
      Vec16<T>::load(src + (size_t)(row0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * D + c + i] = v[i];
  }
}

// s[i][j] = panel row (p0 + 4 ty + i) . stream row (s0 + 4 tx + j), over
// all of D, in f32. pt / st are the chunk buffers. Starts and ends at a
// point where every thread may overwrite pt / st.
template <typename T, int D>
__device__ __forceinline__ void score_tile(float (&s)[4][4], float* pt,
                                           float* st, const T* P, int p0,
                                           int np, const T* S, int s0,
                                           int ns) {
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed
    stage_chunk_t<T, D, RT>(pt, LDP, P, p0, np, k0);
    stage_chunk_t<T, D, ST>(st, LDS, S, s0, ns, k0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(pt + k * LDP + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(st + k * LDS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// x [N, D], e [V, D], tgt_ids [N] i32 -> lse [N], tgt [N] f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ e,
                    const int* __restrict__ tgt_ids, float* __restrict__ lse,
                    float* __restrict__ tgt, int N, int V) {
  __shared__ __align__(16) float pt[KC * LDP];
  __shared__ __align__(16) float st[KC * LDS];
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int p0 = blockIdx.x * RT;

  float m[4], l[4], tg[4];
  int id[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    m[i] = kNeg;
    l[i] = 0.f;
    tg[i] = 0.f;
    id[i] = row < N ? tgt_ids[row] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += ST) {
    float s[4][4];
    score_tile<T, D>(s, pt, st, x, p0, N, e, v0, V);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + 4 * tx + j;
        const bool valid = col < V;
        if (valid && col == id[i]) tg[i] += s[i][j];
        s[i][j] = valid ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    const float t = warp_sum(tg[i]);
    if (tx == 0 && row < N) {
      lse[row] = m[i] + logf(l[i]);
      tgt[row] = t;
    }
  }
}

// Vector width and count of the accumulator columns a lane owns: lane tx
// owns columns tx * VW + 32 * VW * j + w (j < NJ, w < VW), so a warp reads
// one contiguous row segment per j.
template <int D>
struct AccCols {
  static constexpr int VW = D >= 128 ? 4 : D / 32;
  static constexpr int NJ = D / (32 * VW);
  static_assert(VW == 2 || VW == 4, "D must be 64 or a multiple of 128");
  static_assert(NJ * 32 * VW == D, "D must be 64 or a multiple of 128");
};

template <int VW>
__device__ __forceinline__ void lds_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int D>
constexpr size_t bwd_smem() {
  return (size_t)(KC * LDP + KC * LDS + ST * LDP + VK * D + 4 * ST) *
         sizeof(float);
}

// ROW_PANEL (dx): the panel is RT rows of x, the stream is E, out = dx
// [N, D]. !ROW_PANEL (dE): the panel is RT rows of E, the stream is x, out
// = dE [V, D]. lse, c_lse, c_tgt [N] f32 and tgt_ids [N] i32 are per x row.
template <typename T, int D, bool ROW_PANEL>
__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_kernel(const T* __restrict__ x, const T* __restrict__ e,
                    const int* __restrict__ tgt_ids,
                    const float* __restrict__ lse,
                    const float* __restrict__ c_lse,
                    const float* __restrict__ c_tgt, float* __restrict__ out,
                    int N, int V) {
  using C = AccCols<D>;
  extern __shared__ __align__(16) float smem[];
  float* pt = smem;                 // [KC][LDP]
  float* st = pt + KC * LDP;        // [KC][LDS]
  float* dl = st + KC * LDS;        // [ST][LDP], dlog (stream row, panel row)
  float* rs = dl + ST * LDP;        // [VK][D], stream rows for (C)
  float* st_lse = rs + VK * D;      // [ST] stream-row stats (dE only)
  float* st_cl = st_lse + ST;
  float* st_ct = st_cl + ST;
  int* st_id = reinterpret_cast<int*>(st_ct + ST);

  const T* P = ROW_PANEL ? x : e;
  const T* S = ROW_PANEL ? e : x;
  const int np = ROW_PANEL ? N : V;
  const int ns = ROW_PANEL ? V : N;
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int p0 = blockIdx.x * RT;

  // dx: the panel rows' stats, once.
  float r_lse[4], r_cl[4], r_ct[4];
  int r_id[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    const bool live = ROW_PANEL && row < N;
    r_lse[i] = live ? lse[row] : 0.f;
    r_cl[i] = live ? c_lse[row] : 0.f;
    r_ct[i] = live ? c_tgt[row] : 0.f;
    r_id[i] = live ? tgt_ids[row] : -1;
  }

  float acc[4][C::NJ][C::VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int w = 0; w < C::VW; ++w) acc[i][j][w] = 0.f;

  for (int s0 = 0; s0 < ns; s0 += ST) {
    if (!ROW_PANEL) {
      // dE: this tile's x-row stats (the previous tile's readers are past
      // the barriers of its accumulate stage).
      for (int r = threadIdx.x; r < ST; r += kThreads) {
        const int row = s0 + r;
        const bool live = row < N;
        st_lse[r] = live ? lse[row] : 0.f;
        st_cl[r] = live ? c_lse[row] : 0.f;
        st_ct[r] = live ? c_tgt[row] : 0.f;
        st_id[r] = live ? tgt_ids[row] : -1;
      }
    }
    // (A) scores; its barriers also publish the stats above.
    float s[4][4];
    score_tile<T, D>(s, pt, st, P, p0, np, S, s0, ns);

    // (B) dlog, parked as dl[stream row][panel row].
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pr = p0 + 4 * ty + i;   // panel row
        const int sr = s0 + 4 * tx + j;   // stream row
        float v_lse, v_cl, v_ct;
        int v_id, vocab;
        bool valid;
        if (ROW_PANEL) {
          v_lse = r_lse[i];
          v_cl = r_cl[i];
          v_ct = r_ct[i];
          v_id = r_id[i];
          vocab = sr;
          valid = pr < N && sr < V;
        } else {
          const int c = 4 * tx + j;
          v_lse = st_lse[c];
          v_cl = st_cl[c];
          v_ct = st_ct[c];
          v_id = st_id[c];
          vocab = pr;
          valid = pr < V && sr < N;
        }
        float d = 0.f;
        if (valid) {
          d = v_cl * expf(s[i][j] - v_lse);
          if (vocab == v_id) d += v_ct;
        }
        dl[(4 * tx + j) * LDP + 4 * ty + i] = d;
      }
    }

    // (C) acc[i][col] += sum_r dl[r][i] * stream[s0 + r][col].
    for (int r0 = 0; r0 < ST; r0 += VK) {
      __syncthreads();  // dl is complete; the previous rows are consumed
      stage_rows<T, D>(rs, S, s0 + r0, ns);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < VK; ++r) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(dl + (r0 + r) * LDP + 4 * ty);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          float ev[C::VW];
          lds_vec<C::VW>(rs + r * D + tx * C::VW + 32 * C::VW * j, ev);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < C::VW; ++w)
              acc[i][j][w] = fmaf(dv[i], ev[w], acc[i][j][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    if (row < np) {
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
        st_vec<C::VW>(out + (size_t)row * D + tx * C::VW + 32 * C::VW * j,
                      acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one wgmma GEMM core, four epilogues
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr int BM = 128, BN = 256, BK = 64;   // CTA tile; K step per stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;               // 2 warpgroups of 64 x 256
constexpr int THREADS = CONSUMERS + 32;      // + the producer warp
constexpr int A_BYTES = BM * BK * 2;         // 16 KB a stage
constexpr int B_BYTES = BN * BK * 2;         // 32 KB a stage
constexpr int ATOM = 64 * BK * 2;            // 64 rows (or columns) x BK
constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;

// d[0:128] += A (64 x 16, descriptor da) . B (16 x 256, descriptor db):
// one wgmma.m64n256k16, bf16 in, f32 accumulators. TA / TB: the operand
// is MN-major (1) or K-major (0) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc = A[m0 : m0 + BM, 0 : K] . B[0 : K, n0 : n0 + BN] for this consumer
// thread's part; returns false in the producer warp, whose work ends
// here. A_K: A is K-major in memory (a row of its map is one m, its K
// values contiguous), else M-major (a row is one k); B_K likewise. The
// tensor maps are 2-D, bf16, 128-byte swizzled, with boxes of 64 columns
// by BM (A, K-major), BN (B, K-major) or 64 rows (MN-major); (a_mn, a_k)
// and (b_mn, b_k) are the operands' base coordinates. Out-of-range boxes
// read as zeros. Stage ring: the producer's TMA loads complete on
// full[s]; the 256 consumer threads arrive on empty[s] once the
// wgmmas that read stage s have retired.
//
// Accumulator order (wgmma m64n256 f32): acc[4 j + 2 h + c] is row 64 wg
// + 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + c of the tile,
// wg = the consumer's warpgroup, warp its warp within the warpgroup.
template <bool A_K, bool B_K>
__device__ __forceinline__ bool gemm(float (&acc)[128], const CUtensorMap& ma,
                                     const CUtensorMap& mb, int a_mn, int a_k,
                                     int b_mn, int b_k, int K,
                                     unsigned char* smem) {
  const uint32_t raw = smem_addr(smem);
  const uint32_t sa = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB aligned
  const uint32_t sb = sa + STAGES * A_BYTES;
  const uint32_t full = sb + STAGES * B_BYTES, empty = full + STAGES * 8;
  const int KT = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // producer warp: one thread issues TMA
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % STAGES, k0 = kt * BK;
        if (kt >= STAGES) mbar_wait(empty + 8 * st, (kt / STAGES - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, A_BYTES + B_BYTES);
        const uint32_t ta = sa + st * A_BYTES, tb = sb + st * B_BYTES;
        if constexpr (A_K) {
          tma_load_2d(ta, &ma, a_k + k0, a_mn, bar);
        } else {
#pragma unroll
          for (int j = 0; j < BM / 64; ++j)
            tma_load_2d(ta + j * ATOM, &ma, a_mn + 64 * j, a_k + k0, bar);
        }
        if constexpr (B_K) {
          tma_load_2d(tb, &mb, b_k + k0, b_mn, bar);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(tb + j * ATOM, &mb, b_mn + 64 * j, b_k + k0, bar);
        }
      }
    }
    return false;
  }

#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // This warpgroup's 64 rows of A: rows 64 wg of a K-major tile (64 rows
  // x 128 B) or the wg-th 64-column atom of an M-major one; both 8 KB in.
  const uint32_t a_off = (threadIdx.x >> 7) * ATOM;
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(full + 8 * st, (kt / STAGES) & 1);
    const uint32_t ta = sa + st * A_BYTES + a_off, tb = sb + st * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: the next 16 k are 32 bytes along the swizzled row (LBO
      // unused, SBO = 8 rows x 128 B). MN-major: the next 16 k are 16
      // rows of 128 B further (LBO = the next 64-wide MN atom, SBO = 8
      // k rows).
      const uint64_t da = A_K ? smem_desc(ta + 32 * kk, 16, 1024)
                              : smem_desc(ta + 2048 * kk, ATOM, 1024);
      const uint64_t db = B_K ? smem_desc(tb + 32 * kk, 16, 1024)
                              : smem_desc(tb + 2048 * kk, ATOM, 1024);
      wgmma_256<A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's wgmmas have retired
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  return true;
}

// The forward's vocabulary bands: FWD_BAND tiles of BN embedding rows
// (4096 rows, 8 MB of E at D 1024) that every row tile passes through
// before the next band starts, so E is read from device memory once.
constexpr int FWD_BAND = 16;

struct FwdArgs {
  const int* tgt_ids;   // [N]
  float2* part;         // [nvt, N]: (max, sum of exp(s - max)) per tile
  float* tgt;           // [N]: the target logit, written by its tile
  int N, V, D, nrt, nvt;
};

// Per (row tile, vocabulary tile): s = x . E_tile^T on the GEMM core, then
// for each x row its max and sum of exp over the tile's columns < V (the
// zero-filled columns past V are left out) as one partial (m, l), and the
// target logit where a column is the row's target. mx: x [N, D]; me: E
// [V, D], both K-major. CTA b takes band b / (FWD_BAND nrt), then row
// tiles in order, each over the band's vocabulary tiles.
__global__ void __launch_bounds__(THREADS, 1)
    xent_fwd_tc_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap me,
                       const FwdArgs p) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int per_band = FWD_BAND * p.nrt;
  const int band = blockIdx.x / per_band;
  const int r = blockIdx.x - band * per_band;
  const int width = min(FWD_BAND, p.nvt - band * FWD_BAND);
  const int rt = r / width;
  const int vt = band * FWD_BAND + (r - rt * width);
  const int m0 = rt * BM, n0 = vt * BN;
  float acc[128];
  if (!gemm<true, true>(acc, mx, me, m0, 0, n0, 0, p.D, tc_smem)) return;

  constexpr float kLog2e = 1.4426950408889634f;
  const int t = threadIdx.x;
  const int row0 = m0 + 64 * (t >> 7) + 16 * ((t >> 5) & 3) + ((t & 31) >> 2);
  const int col0 = n0 + 2 * (t & 3);
  // The last tile's columns past V (TMA's zeros) drop out of the max and
  // the sum as kNeg, masked in place once (per-element masks in the loops
  // below would hold 64 predicates live and spill).
  if (n0 + BN > p.V) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (col0 + 8 * j + c >= p.V) acc[4 * j + c] = acc[4 * j + 2 + c] = kNeg;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    // The 4 lanes of a quad hold all 256 columns of the row; every tile
    // has a column < V, so the max is a real logit.
    float m = kNeg;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) m = fmaxf(m, acc[4 * j + 2 * h + c]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m2 = m * kLog2e;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        l += exp2f(fmaf(acc[4 * j + 2 * h + c], kLog2e, -m2));
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row < p.N) {
      if ((t & 3) == 0) p.part[(size_t)vt * p.N + row] = make_float2(m, l);
      // This lane holds the target's column if it is 8 j + c (c < 2)
      // past col0 and below V.
      const int id = p.tgt_ids[row];
      const int rel = id - col0;
      if (id < p.V && rel >= 0 && rel < BN && (rel & 6) == 0) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            v = rel == 8 * j + c ? acc[4 * j + 2 * h + c] : v;
        p.tgt[row] = v;
      }
    }
  }
}

// lse[n] = logsumexp over the nvt partials of row n, merged in tile
// order; tgt[n] = 0 for a target outside [0, V) (no tile wrote it).
__global__ void __launch_bounds__(256)
    xent_fwd_merge_kernel(const float2* __restrict__ part,
                          const int* __restrict__ tgt_ids,
                          float* __restrict__ lse, float* __restrict__ tgt,
                          int N, int V, int nvt) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = kNeg, l = 0.f;
  for (int i = 0; i < nvt; ++i) {
    const float2 q = part[(size_t)i * N + n];
    const float m_new = fmaxf(m, q.x);
    l = l * expf(m - m_new) + q.y * expf(q.x - m_new);
    m = m_new;
  }
  lse[n] = m + logf(l);
  const int id = tgt_ids[n];
  if (id < 0 || id >= V) tgt[n] = 0.f;
}

struct DlogArgs {
  const float* lse;
  const float* cl;
  const float* ct;
  const int* tgt;
  bf16* dlog;     // [n_pad, ldd]
  int N, D, v0, cw, ldd;
};

// dlog[n, c] for the chunk's column c < cw (vocabulary row v0 + c) and
// x row n < N; 0 past either (rows up to n_pad, columns up to the tile's
// end), so the dx and dE kernels may read whole tiles. mx: x [N, D];
// me: E [v0 + cw, D], both K-major.
__global__ void __launch_bounds__(THREADS, 1)
    xent_dlog_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap me,
                     const DlogArgs p) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[128];
  if (!gemm<true, true>(acc, mx, me, m0, 0, p.v0 + n0, 0, p.D, tc_smem))
    return;

  constexpr float kLog2e = 1.4426950408889634f;
  const int t = threadIdx.x;
  const int row0 = m0 + 64 * (t >> 7) + 16 * ((t >> 5) & 3) + ((t & 31) >> 2);
  const int col0 = n0 + 2 * (t & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool live = row < p.N;
    const float lse2 = live ? p.lse[row] * kLog2e : 0.f;
    const float cl = live ? p.cl[row] : 0.f;
    const float ct = live ? p.ct[row] : 0.f;
    const int hit = live ? p.tgt[row] - p.v0 : -1;   // column of the target
    bf16* out = p.dlog + (size_t)row * p.ldd;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      float d[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = 0.f;
        if (live && col + c < p.cw) {
          v = cl * exp2f(fmaf(acc[4 * j + 2 * h + c], kLog2e, -lse2));
          if (col + c == hit) v += ct;
        }
        d[c] = v;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + col) =
          __floats2bfloat162_rn(d[0], d[1]);
    }
  }
}

struct GradArgs {
  float* out;   // [rows, cols] f32, row-major
  int rows, cols, K, accumulate;
};

// out[m0 .., n0 ..] (+)= acc for rows < rows, columns < cols.
__device__ __forceinline__ void store_f32(const float (&acc)[128],
                                          const GradArgs& p, int m0, int n0) {
  const int t = threadIdx.x;
  const int row0 = m0 + 64 * (t >> 7) + 16 * ((t >> 5) & 3) + ((t & 31) >> 2);
  const int col0 = n0 + 2 * (t & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.rows) continue;
    float* out = p.out + (size_t)row * p.cols;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.cols) continue;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      float2* q = reinterpret_cast<float2*>(out + col);
      if (p.accumulate) {
        const float2 o = *q;
        v.x += o.x;
        v.y += o.y;
      }
      *q = v;
    }
  }
}

// dx [N, D] (+)= dlog_c [n_pad, cw] . E_c [cw, D]. ma: the dlog buffer,
// K-major; mb: E [v0 + cw, D], MN-major, its chunk starting at row v0.
__global__ void __launch_bounds__(THREADS, 1)
    xent_dx_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb, const int v0,
                   const GradArgs p) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[128];
  if (!gemm<true, false>(acc, ma, mb, m0, 0, n0, v0, p.K, tc_smem)) return;
  store_f32(acc, p, m0, n0);
}

// dE_c [cw, D] = dlog_c^T . x. ma: the dlog buffer, read M-major (a row
// is one x row, a column one vocabulary row of the chunk); mb: x [N, D],
// MN-major. K runs over all n_pad rows.
__global__ void __launch_bounds__(THREADS, 1)
    xent_de_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb, const GradArgs p) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[128];
  if (!gemm<false, false>(acc, ma, mb, m0, 0, n0, 0, p.K, tc_smem)) return;
  store_f32(acc, p, m0, n0);
}

// A 2-D bf16 map over a row-major [rows, cols] matrix, boxes of 64
// columns (128 B, the swizzle span) by box_rows rows; out-of-range
// elements read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return hopper::encode_bf16(map, ptr, 2, dims, strides, box);
}

template <typename... Args>
cudaError_t launch(void (*kernel)(CUtensorMap, CUtensorMap, Args...),
                   int rows, int cols, const CUtensorMap& ma,
                   const CUtensorMap& mb, cudaStream_t s, Args... args) {
  // Above 48 KB a kernel takes dynamic shared memory only after opting in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((cols + BN - 1) / BN, (rows + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, s>>>(ma, mb, args...);
  return cudaGetLastError();
}

// The chunk geometry every bf16 backward entry checks: the dlog buffer is
// [n_pad, ldd] with n_pad a multiple of BM covering N, ldd a multiple of
// BN holding the chunk's cw columns, and D a multiple of 64.
bool bad_chunk(int N, int n_pad, int D, int cw, int ldd) {
  return N <= 0 || n_pad < N || n_pad % BM != 0 || D <= 0 || D % 64 != 0 ||
         cw <= 0 || cw > ldd || ldd % BN != 0;
}

}  // namespace tc

template <typename T, int D>
cudaError_t launch_fwd(const void* x, const void* e, const int* ids,
                       float* lse, float* tgt, int N, int V, cudaStream_t s) {
  xent_fwd_kernel<T, D><<<(N + RT - 1) / RT, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(e), ids, lse, tgt, N,
      V);
  return cudaGetLastError();
}

template <typename T, int D, bool ROW_PANEL>
cudaError_t launch_bwd(const void* x, const void* e, const int* ids,
                       const float* lse, const float* cl, const float* ct,
                       float* out, int N, int V, cudaStream_t s) {
  constexpr size_t smem = bwd_smem<D>();
  // Above 48 KB a kernel takes dynamic shared memory only after opting in.
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<T, D, ROW_PANEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int panels = ROW_PANEL ? N : V;
  xent_bwd_kernel<T, D, ROW_PANEL>
      <<<(panels + RT - 1) / RT, kThreads, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(e), ids, lse, cl,
          ct, out, N, V);
  return cudaGetLastError();
}

// Calls F<T, D>::run(args...) for the runtime width D;
// cudaErrorInvalidValue when there is no such instantiation.
template <template <typename, int> class F, typename T, typename... A>
cudaError_t dispatch_width(int D, A... args) {
  switch (D) {
    case 64: return F<T, 64>::run(args...);
    case 128: return F<T, 128>::run(args...);
    case 256: return F<T, 256>::run(args...);
    case 384: return F<T, 384>::run(args...);
    case 512: return F<T, 512>::run(args...);
    case 640: return F<T, 640>::run(args...);
    case 768: return F<T, 768>::run(args...);
    case 896: return F<T, 896>::run(args...);
    case 1024: return F<T, 1024>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
struct Fwd {
  static cudaError_t run(const void* x, const void* e, const int* ids,
                         float* lse, float* tgt, int N, int V,
                         cudaStream_t s) {
    return launch_fwd<T, D>(x, e, ids, lse, tgt, N, V, s);
  }
};

template <typename T, int D>
struct Dx {
  static cudaError_t run(const void* x, const void* e, const int* ids,
                         const float* lse, const float* cl, const float* ct,
                         float* out, int N, int V, cudaStream_t s) {
    return launch_bwd<T, D, true>(x, e, ids, lse, cl, ct, out, N, V, s);
  }
};

template <typename T, int D>
struct De {
  static cudaError_t run(const void* x, const void* e, const int* ids,
                         const float* lse, const float* cl, const float* ct,
                         float* out, int N, int V, cudaStream_t s) {
    return launch_bwd<T, D, false>(x, e, ids, lse, cl, ct, out, N, V, s);
  }
};

}  // namespace

// The f32 forward on CUDA cores. x [N, D], e [V, D] float32; targets [N]
// int32; lse, tgt [N] float32 outputs.
extern "C" int rtt_xent_fwd(const void* x, const void* e, const void* targets,
                            void* lse, void* tgt, int N, int V, int D,
                            void* stream) {
  return static_cast<int>(dispatch_width<Fwd, float>(
      D, x, e, static_cast<const int*>(targets), static_cast<float*>(lse),
      static_cast<float*>(tgt), N, V, static_cast<cudaStream_t>(stream)));
}

// The bf16 forward on the tensor cores, first kernel: x [N, D], e [V, D]
// bfloat16, targets [N] int32; part the float32 [ceil(V / 256), N, 2]
// workspace of per-tile partials; tgt [N] float32 (the in-vocabulary
// targets' logits written here, the others by rtt_xent_fwd_merge).
extern "C" int rtt_xent_fwd_tc(const void* x, const void* e,
                               const void* targets, void* part, void* tgt,
                               int N, int V, int D, void* stream) {
  using namespace tc;
  if (N <= 0 || V <= 0 || D <= 0 || D % BK != 0) return cudaErrorInvalidValue;
  CUtensorMap mx, me;
  if (!make_map(&mx, x, N, D, BM) || !make_map(&me, e, V, D, BN))
    return cudaErrorInvalidValue;
  const int nrt = (N + BM - 1) / BM, nvt = (V + BN - 1) / BN;
  const FwdArgs args{static_cast<const int*>(targets),
                     static_cast<float2*>(part), static_cast<float*>(tgt), N,
                     V, D, nrt, nvt};
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  xent_fwd_tc_kernel<<<nrt * nvt, THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(mx, me, args);
  return static_cast<int>(cudaGetLastError());
}

// Second kernel: lse [N] float32 from the partials; tgt [N] zeroed for
// targets outside [0, V).
extern "C" int rtt_xent_fwd_merge(const void* part, const void* targets,
                                  void* lse, void* tgt, int N, int V,
                                  void* stream) {
  using namespace tc;
  if (N <= 0 || V <= 0) return cudaErrorInvalidValue;
  xent_fwd_merge_kernel<<<(N + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(part), static_cast<const int*>(targets),
      static_cast<float*>(lse), static_cast<float*>(tgt), N, V,
      (V + BN - 1) / BN);
  return static_cast<int>(cudaGetLastError());
}

// The f32 backward on CUDA cores. x [N, D], e [V, D] float32; lse, c_lse,
// c_tgt [N] float32; dx [N, D] float32 output.
extern "C" int rtt_xent_dx(const void* x, const void* e, const void* targets,
                           const void* lse, const void* c_lse,
                           const void* c_tgt, void* dx, int N, int V, int D,
                           void* stream) {
  return static_cast<int>(dispatch_width<Dx, float>(
      D, x, e, static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(c_lse),
      static_cast<const float*>(c_tgt), static_cast<float*>(dx), N, V,
      static_cast<cudaStream_t>(stream)));
}

// dE [V, D] float32 output.
extern "C" int rtt_xent_de(const void* x, const void* e, const void* targets,
                           const void* lse, const void* c_lse,
                           const void* c_tgt, void* de, int N, int V, int D,
                           void* stream) {
  return static_cast<int>(dispatch_width<De, float>(
      D, x, e, static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(c_lse),
      static_cast<const float*>(c_tgt), static_cast<float*>(de), N, V,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 backward, one vocabulary chunk: rows v0 .. v0 + cw - 1 of E.
// x [N, D], e [V, D] bfloat16; targets [N] int32; lse, c_lse, c_tgt [N]
// float32; dlog the bfloat16 [n_pad, ldd] chunk buffer (written here).
extern "C" int rtt_xent_dlog(const void* x, const void* e, const void* targets,
                             const void* lse, const void* c_lse,
                             const void* c_tgt, void* dlog, int N, int n_pad,
                             int D, int v0, int cw, int ldd, void* stream) {
  using namespace tc;
  if (bad_chunk(N, n_pad, D, cw, ldd)) return cudaErrorInvalidValue;
  CUtensorMap mx, me;
  if (!make_map(&mx, x, N, D, BM) || !make_map(&me, e, v0 + cw, D, BN))
    return cudaErrorInvalidValue;
  const DlogArgs args{static_cast<const float*>(lse),
                      static_cast<const float*>(c_lse),
                      static_cast<const float*>(c_tgt),
                      static_cast<const int*>(targets),
                      static_cast<bf16*>(dlog), N, D, v0, cw, ldd};
  return static_cast<int>(launch(xent_dlog_kernel, n_pad, cw, mx, me,
                                 static_cast<cudaStream_t>(stream), args));
}

// dx [N, D] float32: written by the chunk at v0 = 0 (accumulate = 0),
// added to by the later ones (accumulate = 1).
extern "C" int rtt_xent_dx_tc(const void* dlog, const void* e, void* dx, int N,
                              int n_pad, int D, int v0, int cw, int ldd,
                              int accumulate, void* stream) {
  using namespace tc;
  if (bad_chunk(N, n_pad, D, cw, ldd)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!make_map(&ma, dlog, n_pad, ldd, BM) ||
      !make_map(&mb, e, v0 + cw, D, 64))
    return cudaErrorInvalidValue;
  const GradArgs args{static_cast<float*>(dx), N, D, cw, accumulate};
  return static_cast<int>(launch(xent_dx_kernel, N, D, ma, mb,
                                 static_cast<cudaStream_t>(stream), v0, args));
}

// dE [V, D] float32: rows v0 .. v0 + cw - 1 written.
extern "C" int rtt_xent_de_tc(const void* dlog, const void* x, void* de, int N,
                              int n_pad, int D, int v0, int cw, int ldd,
                              void* stream) {
  using namespace tc;
  if (bad_chunk(N, n_pad, D, cw, ldd)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!make_map(&ma, dlog, n_pad, ldd, 64) || !make_map(&mb, x, N, D, 64))
    return cudaErrorInvalidValue;
  const GradArgs args{static_cast<float*>(de) + (size_t)v0 * D, cw, D, n_pad,
                      0};
  return static_cast<int>(launch(xent_de_kernel, cw, D, ma, mb,
                                 static_cast<cudaStream_t>(stream), args));
}
