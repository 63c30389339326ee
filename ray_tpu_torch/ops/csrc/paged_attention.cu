// Decode and paged attention over a KV cache, hand-written for Hopper
// (sm_90a). The kernels and the TPU kernels they replace:
//
//   decode_kernel        replaces ray_tpu/ops/decode_attention.py::_decode_kernel
//                        (single query per (row, head) over a contiguous
//                        [B, S, H, D] cache, read in place: the TPU wrapper's
//                        transpose to [BH, S, D] and head padding are gone)
//   paged_decode_kernel  replaces ray_tpu/ops/decode_attention.py::_paged_kernel
//                        (single query per (row, head), decode tick; split-K)
//   paged_mq_tc_kernel   replaces ray_tpu/ops/decode_attention.py::_paged_mq_kernel
//                        for bf16 (W queries per (row, head) with the
//                        staircase mask col <= pos + i: chunked prefill and
//                        spec verify; tensor cores, split-K)
//   paged_mq_kernel      the same for f32, on CUDA cores
//
// All compute what the Pallas kernels compute -- softmax(q K^T * D^-0.5) V
// over the logical positions a row may see, f32 statistics and
// accumulation, output in the input dtype -- but are not carried over
// block by block:
//
// - The pool is read in place, [n_blocks, bs, H, D] through strides. The
//   TPU wrappers transpose the whole pool to head-major on every call
//   (34 MB per layer per call at the serving shape); nothing here does.
// - D is not padded to 128, and pos / tables are read by each CTA from
//   device memory instead of riding in as broadcast [BH, 128] rows.
//
// What bounds them on an H100: all are device-memory bound. Decode does
// ~1 flop per byte of K/V it reads (4*D flops per position against 4*D
// bytes in bf16); prefill at C = 64 does ~C flops per byte of K/V, still
// under the card's ~295 flop/byte balance point. So the goal is to read
// each K/V row that a row may see exactly once, 16 bytes per thread, with
// enough loads in flight across enough SMs, and to skip positions past
// the last visible one at run time.
//
// Split-K (both paged kernels). The key range of the table, S = mb * bs
// positions, is cut into n_split = ceil(S / KS) splits of KS positions
// (KS a multiple of 128, chosen by the wrapper from the shapes so that
// n_split <= 16), one CTA each, so a long row no longer runs on one SM
// while short rows leave the others idle. The grid is fixed by shapes;
// pos is read on the device, and a CTA whose split starts past the last
// position its rows may see returns at once. Each live CTA reads its
// split's table entries once into shared memory. With one live split
// (n_live = last visible position / KS + 1) the CTA writes the output
// itself. Otherwise each live CTA writes its rows' softmax state (max m,
// sum l, unnormalised acc[D], f32) to a workspace sized by shapes, and
// the last of them to finish -- found by an int32 ticket per (row, head,
// query tile), taken with one atomicAdd after a __threadfence -- merges
// the n_live states in split order (all of a row's loads issued at once)
// and resets the ticket to 0. One launch
// per call, no float atomics, and the merge order does not depend on
// which CTA finishes last, so two calls give bit-identical outputs. The
// ticket buffer lives across calls (one per device and stream, zeroed
// once), so a CUDA graph may capture and replay a call as it is.
//
// - paged_decode_kernel: one CTA per (b, h, split), 128 threads (measured
//   faster than 256 at the serving shapes: more CTAs fit an SM, and most
//   of a short row's splits return at once). Groups of GP lanes own one
//   key row each (16-byte vector loads, NV vectors a lane: GP is D / VEC
//   rounded up to a power of two, NV 2 only for f32 above 128), and keep
//   U rows in flight (128 rows a CTA step, at most 8 / NV a group), so at
//   the serving shape (bf16, D 64, KS 128) all 128 rows of a split are
//   loaded at once.
//   Each group keeps its own online-softmax state; the groups merge once
//   through shared memory.
// - paged_mq_tc_kernel (bf16): one CTA per (b*h, tile of 64 query rows,
//   split), four warps of 16 query rows, so one CTA serves every query row
//   of a chunk and reads each K/V row once. K and V tiles of KT keys (64;
//   32 at D 256) stream through a 3-stage shared-memory ring by
//   cp.async.cg, 16 bytes a thread with zero fill past D and past the
//   split's last visible key, addresses computed through the table. Q is
//   staged once. cp.async rather than TMA: a block's bs rows of one head
//   sit H*D apart, D and bs vary, and a tensor map would have to be
//   encoded on the host every call of a host-bound path; per-thread
//   addresses take any block size and head dim with no host work. S = Q
//   K^T and O += P V run on the tensor cores (mma.sync.m16n8k16, bf16 in,
//   f32 accumulate; K through ldmatrix, V through ldmatrix.trans); the
//   online softmax runs on S's accumulator fragments in the log2 domain
//   (scale * log2(e) folded in), and P is rounded to bf16 straight from
//   them into the A operand of P V, relative to the running row max, as
//   the flash forward does (so per element the output may move by 2^-8 *
//   P|V| against an f32 P). The staircase mask is applied only on key
//   tiles that cross a row's horizon. Head dims are multiples of 8 up to
//   256 on tiles 32, 64, 128 or 256 wide (zero columns), block sizes any
//   multiple of 8, read directly.
// - paged_mq_kernel (f32, CUDA cores): one CTA per (b*h, tile of QT = 256 /
//   BS query rows). Each logical block's K and V tile is staged in shared
//   memory (f32, columns past D zero up to the kernel's width DP, 32, 64,
//   128 or 256) and shared by the QT rows; one thread per (row, column)
//   score, row reductions by warp shuffles, P and the per-row rescale go
//   through shared memory to the P V product. It takes block sizes 8, 16
//   and 32; the Python wrapper presents any other multiple of 8 as one of
//   them (a [n, 64, H, D] pool is a [2n, 32, H, D] pool).
// - decode_kernel: one CTA per (b, h) over the whole contiguous cache,
//   with the decode kernel's lane groups (U = 4 rows in flight a group).
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it has no
// instantiation for); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as decode_attention.py's NEG_INF
constexpr int kThreads = 256;
constexpr int kMaxSplits = 16;     // decode_attention.py's _MAX_SPLITS
constexpr int kDecodeThreads = 128;   // paged_decode_kernel's CTA

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static void load(const float* p, float* out) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Single-query attention for one (b, h) per CTA over a contiguous cache:
// q [B, H, D]; k, v [B, S, H, D]; pos [B] i32; out [B, H, D]. Row b attends
// to positions 0..min(pos[b], S - 1). Groups of GP lanes read a key row,
// NV 16-byte vectors a lane (lane gl's vector j holds columns (j * GP +
// gl) * VEC ..); vectors at or past D idle (D a multiple of VEC, at most
// GP * NV * VEC).
template <typename T, int GP, int U, int NV>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q,
                                              const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              int S,
                                              const int* __restrict__ pos,
                                              T* __restrict__ out, int H,
                                              int D, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CV = NV * VEC;
  constexpr int NG = kThreads / GP;  // key rows per CTA step
  static_assert(GP <= 32 && 32 % GP == 0, "bad lane group");

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = threadIdx.x / GP;
  const int gl = threadIdx.x - g * GP;

  float qf[CV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * GP + gl) * VEC;
    if (col < D) {
      Vec16<T>::load(q + (size_t)bh * D + col, qf + j * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[j * VEC + i] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < CV; ++i) qf[i] *= scale;

  const int last = min(pos[b], S - 1);

  float m = kNegInf, l = 0.f;
  float acc[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) acc[i] = 0.f;

  // t0 is uniform across the CTA, so every lane reaches every shuffle.
  for (int t0 = 0; t0 <= last; t0 += NG * U) {
    float kf[U][CV], vf[U][CV];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NG + g;
      live[u] = t <= last;
      const size_t row = ((size_t)b * S + t) * H + h;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = (j * GP + gl) * VEC;
        if (live[u] && col < D) {
          Vec16<T>::load(k + row * D + col, kf[u] + j * VEC);
          Vec16<T>::load(v + row * D + col, vf[u] + j * VEC);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) kf[u][j * VEC + i] = vf[u][j * VEC + i] = 0.f;
        }
      }
    }
    float s[U];
    float smax = kNegInf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) d += qf[i] * kf[u][i];
#pragma unroll
      for (int off = GP / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = live[u] ? d : kNegInf;
      smax = fmaxf(smax, s[u]);
    }
    const float m_new = fmaxf(m, smax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < CV; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live[u]) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < CV; ++i) acc[i] += p * vf[u][i];
      }
    }
    m = m_new;
  }

  // Merge the NG per-group softmax states. A group that saw no live row
  // holds (m = -1e30, l = 0, acc = 0) and drops out with weight exp(-huge).
  __shared__ float sm_m[NG];
  __shared__ float sm_l[NG];
  __shared__ float sm_acc[NG][GP * CV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      sm_acc[g][(j * GP + gl) * VEC + i] = acc[j * VEC + i];
  if (gl == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = kNegInf;
    for (int gg = 0; gg < NG; ++gg) mx = fmaxf(mx, sm_m[gg]);
    float lsum = 0.f, o = 0.f;
    for (int gg = 0; gg < NG; ++gg) {
      const float w = expf(sm_m[gg] - mx);
      lsum += sm_l[gg] * w;
      o += sm_acc[gg][d] * w;
    }
    out[(size_t)bh * D + d] = from_f32<T>(o / lsum);
  }
}

// q [B, H, D]; k, v [B, S, H, D] read in place; pos [B] i32; out [B, H, D].
// Row b attends to positions 0..min(pos[b], S-1).
template <typename T, int GP, int NV>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ pos,
                  T* __restrict__ out, int H, int D, int S, float scale) {
  decode_attend<T, GP, 4, NV>(q, k, v, S, pos, out, H, D, scale);
}

// ---------------------------------------------------------------------------
// split-K: the workspace of partial softmax states and the ticket
// ---------------------------------------------------------------------------

// After this CTA has written its state to the workspace: true in the CTA
// that finishes last of the n_live that share `*ticket`, which then owns
// the merge (and has reset the ticket to 0 for the next call).
__device__ __forceinline__ bool last_to_finish(int* ticket, int n_live) {
  __shared__ int is_last;
  __threadfence();   // this CTA's workspace writes before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(ticket, 1) == n_live - 1;
    if (is_last) *ticket = 0;   // every other live CTA has taken its ticket
  }
  __syncthreads();
  return is_last;
}

// q [B, H, D]; pools [n_blocks, bs, H, D]; tables [B, mb] i32; pos [B] i32;
// out [B, H, D]. Row b attends to logical positions 0..min(pos[b], mb*bs
// - 1); this CTA to those of split blockIdx.y, positions [split * ks,
// split * ks + ks). ws: B * H * n_split * D floats of acc, then B * H *
// n_split (m, l) pairs; tickets [B * H] i32, zero between calls.
template <typename T, int GP, int NV>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        int H, int D, int bs, int mb, int ks, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CV = NV * VEC;
  constexpr int NG = kDecodeThreads / GP;   // key rows per CTA step
  // key rows in flight per group: a 128-position split in one step, at
  // most 8 16-byte vectors of K and of V a lane
  constexpr int U = 128 / NG < 1 ? 1 : (128 / NG > 8 / NV ? 8 / NV : 128 / NG);
  static_assert(GP <= 32 && 32 % GP == 0, "bad lane group");
  extern __shared__ int dec_tbl[];    // the split's table entries
  __shared__ float sm_m[NG];
  __shared__ float sm_l[NG];
  __shared__ float sm_acc[NG][GP * CV];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int split = blockIdx.y;
  const int last = min(pos[b], mb * bs - 1);
  const int t0 = split * ks;
  if (t0 > last) return;                  // uniform: nothing to see here
  const int t1 = min(t0 + ks, last + 1);  // this split's end, exclusive
  const int n_live = last / ks + 1;
  const int blk0 = t0 / bs;
  const int* tbl = tables + (size_t)b * mb + blk0;
  for (int i = threadIdx.x; i <= (t1 - 1) / bs - blk0; i += kDecodeThreads)
    dec_tbl[i] = tbl[i];

  const int g = threadIdx.x / GP;
  const int gl = threadIdx.x - g * GP;
  float qf[CV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * GP + gl) * VEC;
    if (col < D) {
      Vec16<T>::load(q + (size_t)bh * D + col, qf + j * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[j * VEC + i] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < CV; ++i) qf[i] *= scale;
  __syncthreads();   // dec_tbl

  float m = kNegInf, l = 0.f;
  float acc[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) acc[i] = 0.f;

  // tb is uniform across the CTA, so every lane reaches every shuffle.
  for (int tb = t0; tb < t1; tb += NG * U) {
    uint4 kr[U][NV], vr[U][NV];   // raw 16-byte vectors, all in flight
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u * NG + g;
      live[u] = t < t1;
      size_t row = 0;
      if (live[u]) {
        const int j = t / bs;
        row = ((size_t)dec_tbl[j - blk0] * bs + (t - j * bs)) * H + h;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = (j * GP + gl) * VEC;
        if (live[u] && col < D) {
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(k_pool + row * D + col));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(v_pool + row * D + col));
        } else {
          kr[u][j] = vr[u][j] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float s[U];
    float smax = kNegInf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float kf[VEC];
        Vec16<T>::unpack(kr[u][j], kf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qf[j * VEC + i] * kf[i];
      }
#pragma unroll
      for (int off = GP / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = live[u] ? d : kNegInf;
      smax = fmaxf(smax, s[u]);
    }
    const float m_new = fmaxf(m, smax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < CV; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live[u]) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          Vec16<T>::unpack(vr[u][j], vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[j * VEC + i] += p * vf[i];
        }
      }
    }
    m = m_new;
  }

  // Merge the NG per-group states into this split's (a group that saw no
  // live row holds m = -1e30, l = 0, acc = 0 and drops out).
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      sm_acc[g][(j * GP + gl) * VEC + i] = acc[j * VEC + i];
  if (gl == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
  __syncthreads();
  float mx = kNegInf;
  for (int gg = 0; gg < NG; ++gg) mx = fmaxf(mx, sm_m[gg]);
  float lsum = 0.f;
  for (int gg = 0; gg < NG; ++gg) lsum += sm_l[gg] * expf(sm_m[gg] - mx);

  T* o_row = out + (size_t)bh * D;
  if (n_live == 1) {
    for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
      float o = 0.f;
      for (int gg = 0; gg < NG; ++gg) o += sm_acc[gg][d] * expf(sm_m[gg] - mx);
      o_row[d] = from_f32<T>(o / lsum);
    }
    return;
  }
  const int n_split = gridDim.y;
  const size_t st0 = (size_t)bh * n_split;   // this (b, h)'s first state
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(ws + (size_t)gridDim.x * n_split * D);
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float o = 0.f;
    for (int gg = 0; gg < NG; ++gg) o += sm_acc[gg][d] * expf(sm_m[gg] - mx);
    ws_acc[(st0 + split) * D + d] = o;
  }
  if (threadIdx.x == 0) ws_ml[st0 + split] = make_float2(mx, lsum);
  if (!last_to_finish(tickets + bh, n_live)) return;

  // The merge, in split order (L2 reads: other SMs wrote these), every
  // split's load issued before any is used; splits past n_live add 0.
  float w[kMaxSplits], ls[kMaxSplits];
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp) {
    const float2 ml = sp < n_live ? __ldcg(&ws_ml[st0 + sp])
                                  : make_float2(kNegInf, 0.f);
    w[sp] = ml.x;
    ls[sp] = ml.y;
  }
  float big = kNegInf;
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp) big = fmaxf(big, w[sp]);
  float lt = 0.f;
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp) {
    w[sp] = expf(w[sp] - big);
    lt += ls[sp] * w[sp];
  }
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float a[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      a[sp] = sp < n_live ? __ldcg(&ws_acc[(st0 + sp) * D + d]) : 0.f;
    float o = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) o += a[sp] * w[sp];
    o_row[d] = from_f32<T>(o / lt);
  }
}

// ---------------------------------------------------------------------------
// paged multi-query, f32 on CUDA cores
// ---------------------------------------------------------------------------

template <int DP, int BS>
constexpr size_t mq_smem() {
  constexpr int QT = kThreads / BS;
  return (size_t)((QT + 2 * BS) * (DP + 1) + QT * (BS + 1) + QT) *
         sizeof(float);
}

// q [B, W, H, D]; pools [n_blocks, BS, H, D]; tables [B, mb] i32; pos [B]
// i32; out [B, W, H, D]. Query i of row b sees logical positions
// <= pos[b] + i (and < mb * BS). D <= DP: shared tiles are DP wide, zero
// past D.
template <typename T, int DP, int BS>
__global__ void __launch_bounds__(kThreads)
    paged_mq_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out, int W,
                    int H, int D, int mb, float scale) {
  constexpr int QT = kThreads / BS;         // query rows per CTA
  constexpr int OSTEP = kThreads / DP;      // output rows per thread pass
  constexpr int NR = QT * DP / kThreads;    // outputs per thread
  static_assert(BS <= 32 && 32 % BS == 0, "bad block size");
  static_assert(kThreads % DP == 0 && NR >= 1, "bad head dim");

  // +1: conflict-free column walks
  extern __shared__ float mq_smem_f[];
  auto qs = reinterpret_cast<float (*)[DP + 1]>(mq_smem_f);   // [QT]
  auto ks = qs + QT;                                          // [BS]
  auto vs = ks + BS;                                          // [BS]
  auto ps = reinterpret_cast<float (*)[BS + 1]>(vs + BS);     // [QT]
  float* cs = reinterpret_cast<float*>(ps + QT);              // [QT]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int p0 = pos[b];
  const int* tbl = tables + (size_t)b * mb;

  for (int e = tid; e < QT * DP; e += kThreads) {
    const int i = e / DP, d = e - (e / DP) * DP;
    const int qi = min(i0 + i, W - 1);  // padded rows copy the last real row
    qs[i][d] =
        d < D ? to_f32(q[((size_t)(b * W + qi) * H + h) * D + d]) * scale
              : 0.f;
  }

  // Score role: thread (si, st) owns score column st of query row si.
  const int si = tid / BS;
  const int st = tid - si * BS;
  const int limit = p0 + min(i0 + si, W - 1);
  float m = kNegInf, l = 0.f;

  // Output role: thread owns (oi0 + r * OSTEP, od) for r < NR.
  const int od = tid % DP;
  const int oi0 = tid / DP;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  // Runtime block skip: nothing past the tile's last real row's horizon.
  const int last_row = min(i0 + QT, W) - 1;
  const int n_blk = min((p0 + last_row) / BS + 1, mb);
  for (int j = 0; j < n_blk; ++j) {
    __syncthreads();  // the previous block's ks/vs/ps are consumed
    const size_t base = (size_t)tbl[j] * BS;
    for (int e = tid; e < BS * DP; e += kThreads) {
      const int t = e / DP, d = e - (e / DP) * DP;
      const size_t off = ((base + t) * H + h) * D + d;
      ks[t][d] = d < D ? to_f32(k_pool[off]) : 0.f;
      vs[t][d] = d < D ? to_f32(v_pool[off]) : 0.f;
    }
    __syncthreads();

    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) s += qs[si][d] * ks[st][d];
    s = (j * BS + st <= limit) ? s : kNegInf;
    float bmax = s;
#pragma unroll
    for (int off = BS / 2; off > 0; off >>= 1)
      bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
    const float m_new = fmaxf(m, bmax);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    float psum = p;
#pragma unroll
    for (int off = BS / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
    ps[si][st] = p;
    if (st == 0) cs[si] = corr;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int oi = oi0 + r * OSTEP;
      float a = acc[r] * cs[oi];
#pragma unroll
      for (int t = 0; t < BS; ++t) a += ps[oi][t] * vs[t][od];
      acc[r] = a;
    }
  }
  __syncthreads();
  if (st == 0) cs[si] = l;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int oi = oi0 + r * OSTEP;
    const int qi = i0 + oi;
    if (qi < W && od < D)
      out[((size_t)(b * W + qi) * H + h) * D + od] =
          from_f32<T>(acc[r] / cs[oi]);
  }
}

// ---------------------------------------------------------------------------
// paged multi-query, bf16 on the tensor cores (mma.sync + cp.async)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;   // 4 warps of 16 query rows
constexpr int QR = 64;         // query rows of a CTA
constexpr int STAGES = 3;      // K/V tiles in flight
static_assert(QR <= THREADS, "one merge row a thread");

template <int DP>
struct Geom {
  static constexpr int KT = DP > 128 ? 32 : 64;   // keys of a tile
  static constexpr int PITCH = (DP + 8) * 2;      // bytes of a staged row
  static constexpr int Q_BYTES = QR * PITCH;
  static constexpr int TILE_BYTES = KT * PITCH;   // one of K, V
  static constexpr int RING = Q_BYTES + STAGES * 2 * TILE_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8. TRANS: each lane gets column pairs.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  }
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// q [B, W, H, D]; pools [n_blocks, bs, H, D]; tables [B, mb] i32; pos [B]
// i32; out [B, W, H, D] (all bf16 but the indices). Query i of row b sees
// logical positions <= pos[b] + i and < mb * bs. This CTA: query rows
// [64 tile, 64 tile + 64) of (b, h) = blockIdx.x, key positions [split *
// ks, split * ks + ks). ws: n_states * wr * D floats of acc, then n_states
// * wr (m, l) pairs (log2 domain), n_states = B * H * n_tiles * n_split,
// wr = min(W, 64) rows a state; tickets [B * H * n_tiles] i32, zero
// between calls.
//
// Fragments (mma.m16n8k16; lane = 4 g + t): S and O accumulators hold
// (row g, columns 2t, 2t+1) and (row g + 8, the same columns) of each
// 8-column block; an A operand (row g | g + 8, k 2t, 2t+1 | 2t+8, 2t+9).
template <int DP>
__global__ void __launch_bounds__(THREADS)
    paged_mq_tc_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k_pool,
                       const bf16* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ tickets,
                       int W, int H, int D, int bs, int mb, int ks,
                       float scale_log2) {
  using G = Geom<DP>;
  constexpr int KT = G::KT, PITCH = G::PITCH;
  constexpr int CH = DP / 8;           // 16-byte chunks of a staged row
  constexpr int NS = KT / 8;           // 8-key blocks of a tile
  constexpr int NO = DP / 8;           // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char mq_smem_b[];
  const uint32_t sq = smem_addr(mq_smem_b);
  const uint32_t sring = sq + G::Q_BYTES;
  int* tbl_s = reinterpret_cast<int*>(mq_smem_b + G::RING);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * QR;
  const int split = blockIdx.z;
  const int rows_here = min(QR, W - i0);
  const int p0 = pos[b];
  const int span = mb * bs;
  const int lim = min(p0 + i0 + rows_here - 1, span - 1);  // tile's last key
  const int k0 = split * ks;
  if (k0 > lim) return;                   // uniform: nothing to see here
  const int kend = min(k0 + ks, lim + 1); // exclusive
  const int n_live = lim / ks + 1;
  const int nt = (kend - k0 + KT - 1) / KT;
  const int blk0 = k0 / bs;
  const int tid = threadIdx.x;
  for (int i = tid; i <= (kend - 1) / bs - blk0; i += THREADS)
    tbl_s[i] = tables[(size_t)b * mb + blk0 + i];

  // Q once (part of the first copy group): rows past W and columns past
  // D are zeros.
  for (int e = tid; e < QR * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    const bool ok = i0 + r < W && c * 8 < D;
    const bf16* src = ok ? q + ((size_t)(b * W + i0 + r) * H + h) * D + c * 8
                         : q;
    cp_async16(sq + r * PITCH + c * 16, src, ok);
  }
  __syncthreads();   // tbl_s

  // Tile j's K and V rows into stage st; keys at or past kend, and
  // columns past D, are zeros.
  auto load_tile = [&](int j, int st) {
    const uint32_t dk = sring + st * 2 * G::TILE_BYTES;
    const uint32_t dv = dk + G::TILE_BYTES;
    const int kt0 = k0 + j * KT;
    for (int e = tid; e < KT * CH; e += THREADS) {
      const int r = e / CH, c = e - r * CH;
      const int t = kt0 + r;
      const bool ok = t < kend && c * 8 < D;
      size_t off = 0;
      if (ok) {
        const int blk = t / bs;
        off = (((size_t)tbl_s[blk - blk0] * bs + (t - blk * bs)) * H + h) * D +
              c * 8;
      }
      cp_async16(dk + r * PITCH + c * 16, k_pool + off, ok);
      cp_async16(dv + r * PITCH + c * 16, v_pool + off, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load_tile(st, st);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
  // This thread's two query rows (warp's rows g and g + 8): their
  // horizons, clamped to the split's last key.
  int hz[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    hz[hh] = min(p0 + min(i0 + warp * 16 + g + 8 * hh, W - 1), kend - 1);
  // Tiles ending at or before this key are visible to every row.
  const int all_see = min(p0 + i0, kend - 1);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // A operand addresses of this warp's Q rows (ldmatrix x4: rows mr
  // (+8 for odd matrices), columns +8 for matrices 2, 3).
  const uint32_t qa = sq + (warp * 16 + (mi & 1) * 8 + mr) * PITCH +
                      (mi >> 1) * 16;

  for (int j = 0; j < nt; ++j) {
    if (j + STAGES - 1 < nt) load_tile(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // tile j (and Q) have landed
    __syncthreads();
    const uint32_t tk = sring + (j % STAGES) * 2 * G::TILE_BYTES;
    const uint32_t tv = tk + G::TILE_BYTES;

    // S = Q K^T: K rows are the B operand as they lie (keys x d).
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4<false>(qa + kk * 32, a);
#pragma unroll
      for (int nb = 0; nb < KT / 16; ++nb) {
        uint32_t bk[4];   // keys nb*16 + (mi/2)*8 + mr, d kk*16 + (mi%2)*8
        ldsm_x4<false>(tk + (nb * 16 + (mi >> 1) * 8 + mr) * PITCH +
                           kk * 32 + (mi & 1) * 16, bk);
        mma(s[2 * nb], a, bk[0], bk[1]);
        mma(s[2 * nb + 1], a, bk[2], bk[3]);
      }
    }

    // Online softmax in the log2 domain; masks only where a tile crosses
    // a row's horizon. Masked entries get p = 0.
    const int kt0 = k0 + j * KT;
    const bool full = kt0 + KT - 1 <= all_see;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = s[n][2 * hh + c] * scale_log2;
          if (!full && kt0 + 8 * n + 2 * t4 + c > hz[hh]) v = kNegInf;
          s[n][2 * hh + c] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float corr = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = s[n][2 * hh + c];
          const float p = v == kNegInf ? 0.f : exp2f(v - m_new);
          s[n][2 * hh + c] = p;
          rs += p;
        }
      l[hh] = l[hh] * corr + rs;   // this lane's columns; summed at the end
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * hh] *= corr;
        o[n][2 * hh + 1] *= corr;
      }
    }

    // O += P V: P rounded to bf16 from S's fragments into the A operand;
    // V through ldmatrix.trans (keys kk*16 + (mi%2)*8 + mr, d dn*16 +
    // (mi/2)*8).
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4<true>(tv + (kk * 16 + (mi & 1) * 8 + mr) * PITCH + dn * 32 +
                          (mi >> 1) * 16, bv);
        mma(o[2 * dn], a, bv[0], bv[1]);
        mma(o[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // stage j % STAGES is free for tile j + STAGES
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const int n_tiles = gridDim.y, n_split = gridDim.z;
  if (n_live == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
      if (r >= rows_here) continue;
      bf16* dst = out + ((size_t)(b * W + i0 + r) * H + h) * D + 2 * t4;
      const float inv = 1.f / l[hh];
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (n * 8 < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
    return;
  }

  const int wr = min(W, QR);
  const size_t tile_id = (size_t)bh * n_tiles + blockIdx.y;
  const size_t st0 = tile_id * n_split * wr;   // first row of split 0
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(
      ws + (size_t)gridDim.x * n_tiles * n_split * wr * D);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= rows_here) continue;
    const size_t row = st0 + (size_t)split * wr + r;
    if (t4 == 0) ws_ml[row] = make_float2(m[hh], l[hh]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n * 8 < D)
        *reinterpret_cast<float2*>(ws_acc + row * D + n * 8 + 2 * t4) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
  }
  if (!last_to_finish(tickets + tile_id, n_live)) return;

  // The merge, in split order (L2 reads: other SMs wrote these), every
  // split's load issued before any is used; splits past n_live add 0.
  // First each row's weights exp2(m_s - M) / L, one row a thread.
  __shared__ float wsm[QR][kMaxSplits + 1];
  for (int r = tid; r < rows_here; r += THREADS) {
    float w[kMaxSplits], ls[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      const float2 ml = sp < n_live ? __ldcg(&ws_ml[st0 + (size_t)sp * wr + r])
                                    : make_float2(kNegInf, 0.f);
      w[sp] = ml.x;
      ls[sp] = ml.y;
    }
    float big = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) big = fmaxf(big, w[sp]);
    float lt = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      w[sp] = exp2f(w[sp] - big);
      lt += ls[sp] * w[sp];
    }
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) wsm[r][sp] = w[sp] / lt;
  }
  __syncthreads();
  // Then each (row, 4 columns) a thread.
  const int quads = D / 4;
  for (int e = tid; e < rows_here * quads; e += THREADS) {
    const int r = e / quads, c = (e - r * quads) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += 8) {   // 8 splits' loads at once
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = s0 + i < n_live
                   ? __ldcg(reinterpret_cast<const float4*>(
                         ws_acc + (st0 + (size_t)(s0 + i) * wr + r) * D + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = wsm[r][s0 + i];
        o.x += a[i].x * w;
        o.y += a[i].y * w;
        o.z += a[i].z * w;
        o.w += a[i].w * w;
      }
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + ((size_t)(b * W + i0 + r) * H + h) * D + c) =
        packed;
  }
}

template <int DP>
cudaError_t launch_mq(const void* q, const void* k, const void* v,
                      const int* tables, const int* pos, void* out, float* ws,
                      int* tickets, int B, int W, int H, int D, int bs,
                      int mb, int ks, int n_split, float scale,
                      cudaStream_t s) {
  const size_t smem = Geom<DP>::RING + (size_t)(ks / bs + 2) * sizeof(int);
  // Above 48 KB a kernel takes dynamic shared memory only after opting in.
  const cudaError_t err = cudaFuncSetAttribute(
      paged_mq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (W + QR - 1) / QR, n_split);
  constexpr float kLog2e = 1.4426950408889634f;
  paged_mq_tc_kernel<DP><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tables, pos, static_cast<bf16*>(out), ws,
      tickets, W, H, D, bs, mb, ks, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

// Threads per key row and 16-byte vectors per lane for a runtime head
// dim: (D / VEC rounded up to a power of two, 1), or (32, 2) for f32
// above 128; false when D is not a multiple of VEC in 1 .. 256.
template <typename T>
bool lane_layout(int D, int* gp, int* nv) {
  constexpr int VEC = Vec16<T>::N;
  if (D <= 0 || D % VEC != 0 || D > 256) return false;
  *nv = D > 32 * VEC ? 2 : 1;
  *gp = 1;
  while (*gp * *nv * VEC < D) *gp *= 2;
  return true;
}

// Calls F<T, GP, NV>::run(args...) for the lane layout of head dim D;
// false when there is none.
template <template <typename, int, int> class F, typename T, typename... A>
bool dispatch_group(int D, A... args) {
  int gp = 0, nv = 0;
  if (!lane_layout<T>(D, &gp, &nv)) return false;
  if constexpr (Vec16<T>::N == 4) {
    if (nv == 2) {
      F<T, 32, 2>::run(args...);
      return true;
    }
  }
  switch (gp) {
    case 1: F<T, 1, 1>::run(args...); return true;
    case 2: F<T, 2, 1>::run(args...); return true;
    case 4: F<T, 4, 1>::run(args...); return true;
    case 8: F<T, 8, 1>::run(args...); return true;
    case 16: F<T, 16, 1>::run(args...); return true;
    case 32: F<T, 32, 1>::run(args...); return true;
    default: return false;
  }
}

template <typename T, int GP, int NV>
struct PagedDecode {
  static void run(const void* q, const void* k, const void* v,
                  const int* tables, const int* pos, void* out, float* ws,
                  int* tickets, int B, int H, int D, int bs, int mb, int ks,
                  int n_split, float scale, cudaStream_t stream) {
    const size_t smem = (size_t)(ks / bs + 2) * sizeof(int);
    paged_decode_kernel<T, GP, NV>
        <<<dim3(B * H, n_split), kDecodeThreads, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), tables, pos, static_cast<T*>(out), ws,
            tickets, H, D, bs, mb, ks, scale);
  }
};

template <typename T, int GP, int NV>
struct DenseDecode {
  static void run(const void* q, const void* k, const void* v, const int* pos,
                  void* out, int B, int H, int D, int S, float scale,
                  cudaStream_t stream) {
    decode_kernel<T, GP, NV><<<B * H, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos, static_cast<T*>(out), H, D, S, scale);
  }
};

template <typename T, int DP, int BS>
cudaError_t launch_mq(const void* q, const void* k, const void* v,
                      const int* tables, const int* pos, void* out, int B,
                      int W, int H, int D, int mb, float scale,
                      cudaStream_t stream) {
  constexpr int QT = kThreads / BS;
  constexpr size_t smem = mq_smem<DP, BS>();
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_mq_kernel<T, DP, BS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (W + QT - 1) / QT);
  paged_mq_kernel<T, DP, BS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, pos, static_cast<T*>(out), W, H, D, mb,
      scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dispatch_mq_bs(int bs, const void* q, const void* k,
                           const void* v, const int* tables, const int* pos,
                           void* out, int B, int W, int H, int D, int mb,
                           float scale, cudaStream_t s) {
  switch (bs) {
    case 8: return launch_mq<T, DP, 8>(q, k, v, tables, pos, out, B, W, H, D, mb, scale, s);
    case 16: return launch_mq<T, DP, 16>(q, k, v, tables, pos, out, B, W, H, D, mb, scale, s);
    case 32: return launch_mq<T, DP, 32>(q, k, v, tables, pos, out, B, W, H, D, mb, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The narrowest of the 32-, 64-, 128- and 256-wide tiles that holds D (0
// when D is not a multiple of 8 in 8 .. 256).
int tile_width(int D) {
  if (D <= 0 || D % 8 != 0 || D > 256) return 0;
  int dp = 32;
  while (dp < D) dp *= 2;
  return dp;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D a multiple of 8 up to 256 (of 4 for
// f32 decode). The split-K kernels also take ks (positions a split, a
// multiple of 128), n_split = ceil(mb * bs / ks), the f32 workspace ws
// (see the kernels) and the zeroed int32 tickets.
extern "C" int rtt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* pos, void* out, void* ws,
                                void* tickets, int B, int H, int D, int bs,
                                int mb, int ks, int n_split, float scale,
                                int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (B <= 0 || H <= 0 || bs <= 0 || mb <= 0 || ks <= 0 || ks % 128 != 0 ||
      n_split != (mb * bs + ks - 1) / ks || n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_group<PagedDecode, float>(D, q, k_pool, v_pool, t, p, out, w, tk, B, H, D, bs, mb, ks, n_split, scale, s);
  else if (dtype == 1)
    ok = dispatch_group<PagedDecode, __nv_bfloat16>(D, q, k_pool, v_pool, t, p, out, w, tk, B, H, D, bs, mb, ks, n_split, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// q [B, H, D]; k, v [B, S, H, D] contiguous; pos [B] i32; out [B, H, D].
extern "C" int rtt_decode(const void* q, const void* k, const void* v,
                          const void* pos, void* out, int B, int S, int H,
                          int D, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_group<DenseDecode, float>(D, q, k, v, p, out, B, H, D, S, scale, s);
  else if (dtype == 1)
    ok = dispatch_group<DenseDecode, __nv_bfloat16>(D, q, k, v, p, out, B, H, D, S, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The f32 multi-query kernel on CUDA cores: block size bs one of 8, 16, 32.
extern "C" int rtt_paged_mq(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* pos, void* out, int B, int W, int H,
                            int D, int bs, int mb, float scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  switch (tile_width(D)) {
    case 32: return static_cast<int>(dispatch_mq_bs<float, 32>(bs, q, k_pool, v_pool, t, p, out, B, W, H, D, mb, scale, s));
    case 64: return static_cast<int>(dispatch_mq_bs<float, 64>(bs, q, k_pool, v_pool, t, p, out, B, W, H, D, mb, scale, s));
    case 128: return static_cast<int>(dispatch_mq_bs<float, 128>(bs, q, k_pool, v_pool, t, p, out, B, W, H, D, mb, scale, s));
    case 256: return static_cast<int>(dispatch_mq_bs<float, 256>(bs, q, k_pool, v_pool, t, p, out, B, W, H, D, mb, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 multi-query kernel on the tensor cores: any block size bs that
// is a multiple of 8, ks and n_split as for rtt_paged_decode, ws the f32
// workspace of 2 + D floats for each of B * H * ceil(W / 64) * n_split *
// min(W, 64) rows, tickets [B * H * ceil(W / 64)] zeroed int32.
extern "C" int rtt_paged_mq_tc(const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* pos, void* out, void* ws,
                               void* tickets, int B, int W, int H, int D,
                               int bs, int mb, int ks, int n_split,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (B <= 0 || W <= 0 || H <= 0 || bs <= 0 || bs % 8 != 0 || mb <= 0 ||
      ks <= 0 || ks % 128 != 0 || n_split != (mb * bs + ks - 1) / ks ||
      n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile_width(D)) {
    case 32: return static_cast<int>(tc::launch_mq<32>(q, k_pool, v_pool, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    case 64: return static_cast<int>(tc::launch_mq<64>(q, k_pool, v_pool, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    case 128: return static_cast<int>(tc::launch_mq<128>(q, k_pool, v_pool, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    case 256: return static_cast<int>(tc::launch_mq<256>(q, k_pool, v_pool, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
