// Decode and paged attention over a KV cache, hand-written for Hopper
// (sm_90a). The kernels and the TPU kernels they replace:
//
//   decode_kernel        replaces ray_tpu/ops/decode_attention.py::_decode_kernel
//                        (single query per (row, head) over a contiguous
//                        [B, S, H, D] cache, read in place: the TPU wrapper's
//                        transpose to [BH, S, D] and head padding are gone;
//                        split-K)
//   paged_decode_kernel  replaces ray_tpu/ops/decode_attention.py::_paged_kernel
//                        (single query per (row, head), decode tick; the
//                        same split-K body as decode_kernel)
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
// Split-K. The grid is fixed by shapes: one CTA per (row, head, split)
// and n_split <= 16 splits (chosen by the wrapper from the cache's span);
// pos is read on the device, and no host work depends on it. Each CTA
// takes one piece of its row's visible positions (paged_mq_tc_kernel:
// splits of KS positions, a multiple of 128 the wrapper's split_geometry
// fixes; the decode kernels: see below) and returns at once when its
// piece is empty. With one live split the CTA writes the output
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
// - decode_kernel (contiguous cache) and paged_decode_kernel (pool through
//   the table) share one body, decode_split, templated on how a position
//   maps to its row of K and V (CacheRows: b * S + t; PoolRows: through
//   the split's table entries, read once into shared memory). Each row
//   picks its split length on the device from pos (split_length): a row
//   that sees at most one_cta positions runs in one CTA, which walks it
//   128 rows a step and writes the output with no workspace and no merge
//   (short rows pay for neither); a longer row is cut into splits of the
//   least multiple of 128 positions that keeps it to n_split of them, so
//   it no longer runs on one SM. one_cta is a constant of the wrapper
//   (decode_attention.py's _ONE_CTA, chosen by measurement). 128 threads
//   a CTA (faster than 256 at the serving shapes: more CTAs fit an SM,
//   and the dead ones cost less). Groups of GP lanes own one key row each
//   (16-byte vector loads, NV vectors a lane: GP is D / VEC rounded up to
//   a power of two, NV 2 for f32 above 128 and for bf16 and int8 above
//   256, 4 for f32 above 256), and keep U rows in
//   flight (128 rows a CTA step, at most 8 / NV a group), so at the
//   serving shape (bf16, D 64) a 128-position split is loaded at once.
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
// - paged_mq_kernel (f32, and bf16 above head dim 256; CUDA cores): one
//   CTA per (b*h, tile of QT = 256 / BS query rows). Each logical block's
//   K and V tile is staged in shared memory (f32, columns past D zero up
//   to the kernel's width DP, 32, 64, 128, 256 or 512) and shared by the
//   QT rows; one thread per (row, column)
//   score, row reductions by warp shuffles, P and the per-row rescale go
//   through shared memory to the P V product. It takes block sizes 8, 16
//   and 32; the Python wrapper presents any other multiple of 8 as one of
//   them (a [n, 64, H, D] pool is a [2n, 32, H, D] pool).
// - Head dims above 512 (the wrappers pad them to a multiple of 512): the
//   decode body and paged_mq_kernel work in slabs of 512 columns. Each
//   output slab is a CTA of its own (grid x = B * H * nslab); each score
//   sums the CTA's own slab and every other slab's q . k, read slab by
//   slab, so every slab's CTAs recompute the scores (nslab times the K
//   reads): the simple first version, for head dims no served model has.
// - Int8 pools (the Pallas kernels' quantized branches: int8 K/V with one
//   f32 scale per (position, head) row, ops/quant.py's quantize_rows):
//   each paged kernel has an int8 instance that reads the payload and its
//   row's scale and never dequantizes a pool in memory. The decode body
//   reads 8 int8 columns (8 bytes) a lane, so it keeps the bf16 lane
//   geometry, and dequantizes in registers: score (q . k) k_scale, value
//   p v_scale v; the f32 multi-query kernel dequantizes as it stages a
//   block; the tensor-core kernel widens int8 tiles to bf16 in shared
//   memory and applies the scales in f32 around its MMAs (see
//   paged_mq_tc_kernel). Their bound is the payload plus 4 bytes a row:
//   at D 64, 68 bytes of K (or V) a row against bf16's 128.
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it has no
// instantiation for); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as decode_attention.py's NEG_INF
constexpr int kThreads = 256;
constexpr int kMaxSplits = 16;     // decode_attention.py's _MAX_SPLITS
constexpr int kSplitUnit = 128;    // decode_attention.py's _SPLIT_UNIT
constexpr int kDecodeThreads = 128;   // the decode kernels' CTA

// A lane's vector of a K/V row: 16 bytes of f32 (4 columns) or bf16 (8),
// 8 bytes of int8 (8 columns, so an int8 pool keeps bf16's lane
// geometry and takes every head dim that is a multiple of 8).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using Raw = uint4;
  static constexpr int N = 4;
  __device__ static void unpack(const Raw& raw, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int N = 8;
  __device__ static void unpack(const Raw& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<int8_t> {
  using Raw = uint2;
  static constexpr int N = 8;
  __device__ static void unpack(const Raw& raw, float* out) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// ---------------------------------------------------------------------------
// single-query decode: one body for the contiguous cache and the paged pool
// ---------------------------------------------------------------------------

// Where position t of row b lives for head h: its row of the [*, H, D]
// view of k and v. The body calls stage() once with its split's range
// [t0, t1) (then __syncthreads) and row() for every key row it reads.
struct CacheRows {   // contiguous cache [B, S, H, D]: row (b * S + t) * H + h
  int S;
  __device__ int span() const { return S; }
  __device__ void stage(int, int, int) {}
  __device__ size_t row(int b, int t, int h, int H) const {
    return ((size_t)b * S + t) * H + h;
  }
};

struct PoolRows {    // pool [n_blocks, bs, H, D] through tables [B, mb]
  const int* tables;
  int bs, mb;
  int* tbl;          // shared memory: the split's table entries
  int blk0;          // the split's first logical block
  __device__ int span() const { return mb * bs; }
  __device__ void stage(int b, int t0, int t1) {
    blk0 = t0 / bs;
    const int* src = tables + (size_t)b * mb + blk0;
    for (int i = threadIdx.x; i <= (t1 - 1) / bs - blk0; i += kDecodeThreads)
      tbl[i] = src[i];
  }
  __device__ size_t row(int, int t, int h, int H) const {
    const int j = t / bs;
    return ((size_t)tbl[j - blk0] * bs + (t - j * bs)) * H + h;
  }
};

// Positions a split of a row that sees `seen` positions: all of them when
// seen <= one_cta (one CTA, which writes the output itself), else the
// least multiple of kSplitUnit that cuts the row into n_split splits or
// fewer (decode_attention.py's decode_split_length).
__host__ __device__ __forceinline__ int split_length(int seen, int n_split,
                                                     int one_cta) {
  if (seen <= one_cta) return seen;
  const int unit = kSplitUnit * n_split;
  return kSplitUnit * ((seen + unit - 1) / unit);
}

// q [B, H, nslab * D]; k, v read through `rows` (rows nslab * D wide);
// pos [B] i32; out [B, H, nslab * D]. Row b attends to positions
// 0..min(pos[b], span - 1); this CTA (x = blockIdx.x = bh * nslab + os,
// split = blockIdx.y) to [split * ks, split * ks + ks) of them, ks =
// split_length(seen, gridDim.y, one_cta), and writes output slab os
// (columns os * D .. os * D + D - 1). With nslab > 1 (head dims above
// 512, padded to a multiple of 512: D is 512) each score sums over every
// slab: the CTA's own slab from its registers, the others read from
// memory per key row; every slab's CTA recomputes the scores. ws:
// gridDim.x * n_split * D floats of acc, then gridDim.x * n_split (m, l)
// pairs; tickets [gridDim.x] i32, zero between calls. Groups of GP lanes read a key row, NV vectors
// a lane (Vec<P>: lane gl's vector j holds columns (j * GP + gl) * VEC
// ..); vectors at or past D idle. P is the pool's element type: T, or
// int8_t with per-row f32 scales k_scale, v_scale (one a key row, at the
// row's index in the [*, H] view): the score of an int8 row is (q .
// k_int8) k_scale and its value row enters as p v_scale v_int8, so the
// payload is dequantized in registers and the math stays f32, as the
// reference dequantizes in VMEM.
template <typename T, typename P, int GP, int NV, typename Rows>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const P* __restrict__ k,
    const P* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, Rows rows,
    const int* __restrict__ pos, T* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ tickets, int H, int D, int nslab, int one_cta,
    float scale) {
  using PV = Vec<P>;
  using QV = Vec<T>;
  constexpr bool Q8 = std::is_same_v<P, int8_t>;
  constexpr int VEC = PV::N;
  constexpr int QN = VEC / QV::N;           // q's 16-byte vectors a vector
  constexpr int CV = NV * VEC;
  constexpr int NG = kDecodeThreads / GP;   // key rows per CTA step
  // key rows in flight per group: a 128-position split in one step, at
  // most 8 vectors of K and of V a lane
  constexpr int U = 128 / NG < 1 ? 1 : (128 / NG > 8 / NV ? 8 / NV : 128 / NG);
  static_assert(GP <= 32 && 32 % GP == 0, "bad lane group");
  static_assert(QN >= 1 && VEC % QV::N == 0, "bad q vector");
  __shared__ float sm_m[NG];
  __shared__ float sm_l[NG];
  __shared__ float sm_acc[NG][GP * CV];

  const int x = blockIdx.x;               // (row, head, output slab)
  const int bh = x / nslab;
  const int os = x - bh * nslab;
  const int b = bh / H;
  const int h = bh - b * H;
  const int split = blockIdx.y;
  const int g = threadIdx.x / GP;
  const int gl = threadIdx.x - g * GP;
  // q's load goes out with pos's, not after it
  uint4 qr[NV][QN];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * GP + gl) * VEC;
#pragma unroll
    for (int i = 0; i < QN; ++i)
      qr[j][i] = col < D ? __ldg(reinterpret_cast<const uint4*>(
                               q + (size_t)x * D + col + i * QV::N))
                         : make_uint4(0, 0, 0, 0);
  }
  // positions this row sees (pos < 0 sees none: split 0 writes zeros)
  const int seen = min(max(pos[b], -1), rows.span() - 1) + 1;
  const int ks = split_length(seen, gridDim.y, one_cta);
  const int t0 = split * ks;
  if (t0 >= seen) {                       // uniform: nothing to see here
    if (seen == 0 && split == 0)
      for (int d = threadIdx.x; d < D; d += kDecodeThreads)
        out[(size_t)x * D + d] = from_f32<T>(0.f);
    return;
  }
  const int t1 = min(t0 + ks, seen);      // this split's end, exclusive
  const int n_live = (seen + ks - 1) / ks;
  rows.stage(b, t0, t1);
  float qf[CV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < QN; ++i) QV::unpack(qr[j][i], qf + j * VEC + i * QV::N);
#pragma unroll
  for (int i = 0; i < CV; ++i) qf[i] *= scale;
  __syncthreads();   // the staged rows


  float m = kNegInf, l = 0.f;
  float acc[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) acc[i] = 0.f;

  // tb is uniform across the CTA, so every lane reaches every shuffle.
  for (int tb = t0; tb < t1; tb += NG * U) {
    typename PV::Raw kr[U][NV], vr[U][NV];   // raw vectors, all in flight
    float ksr[U], vsr[U];                    // an int8 row's scales
    bool live[U];
    size_t rowi[U];                          // the key rows' [*, H] index
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u * NG + g;
      live[u] = t < t1;
      const size_t row = live[u] ? rows.row(b, t, h, H) : 0;
      rowi[u] = row;
      if constexpr (Q8) {
        ksr[u] = live[u] ? __ldg(k_scale + row) : 0.f;
        vsr[u] = live[u] ? __ldg(v_scale + row) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = (j * GP + gl) * VEC;
        if (live[u] && col < D) {
          const size_t off = (row * nslab + os) * D + col;
          kr[u][j] = __ldg(reinterpret_cast<const typename PV::Raw*>(k + off));
          vr[u][j] = __ldg(reinterpret_cast<const typename PV::Raw*>(v + off));
        } else {
          kr[u][j] = vr[u][j] = typename PV::Raw{};
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
        PV::unpack(kr[u][j], kf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qf[j * VEC + i] * kf[i];
      }
      if (nslab > 1 && live[u]) {   // the other slabs' share of the score
        for (int sl = 0; sl < nslab; ++sl) {
          if (sl == os) continue;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int col = (j * GP + gl) * VEC;
            if (col >= D) continue;
            float kf[VEC], qx[VEC];
            PV::unpack(__ldg(reinterpret_cast<const typename PV::Raw*>(
                           k + (rowi[u] * nslab + sl) * D + col)),
                       kf);
#pragma unroll
            for (int i = 0; i < QN; ++i)
              QV::unpack(__ldg(reinterpret_cast<const uint4*>(
                             q + ((size_t)bh * nslab + sl) * D + col +
                             i * QV::N)),
                         qx + i * QV::N);
#pragma unroll
            for (int i = 0; i < VEC; ++i) d += qx[i] * scale * kf[i];
          }
        }
      }
#pragma unroll
      for (int off = GP / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if constexpr (Q8) d *= ksr[u];
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
        float pv = p;
        if constexpr (Q8) pv *= vsr[u];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          PV::unpack(vr[u][j], vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[j * VEC + i] += pv * vf[i];
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

  T* o_row = out + (size_t)x * D;
  if (n_live == 1) {
    for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
      float o = 0.f;
      for (int gg = 0; gg < NG; ++gg) o += sm_acc[gg][d] * expf(sm_m[gg] - mx);
      o_row[d] = from_f32<T>(o / lsum);
    }
    return;
  }
  const int n_split = gridDim.y;
  const size_t st0 = (size_t)x * n_split;   // this (b, h, os)'s first state
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(ws + (size_t)gridDim.x * n_split * D);
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float o = 0.f;
    for (int gg = 0; gg < NG; ++gg) o += sm_acc[gg][d] * expf(sm_m[gg] - mx);
    ws_acc[(st0 + split) * D + d] = o;
  }
  if (threadIdx.x == 0) ws_ml[st0 + split] = make_float2(mx, lsum);
  if (!last_to_finish(tickets + x, n_live)) return;

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

// Contiguous cache: k, v [B, S, H, D] read in place (no int8 mode, as in
// the reference).
template <typename T, int GP, int NV>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ pos,
                  T* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ tickets, int H, int D, int nslab,
                  int S, int one_cta, float scale) {
  decode_split<T, T, GP, NV>(q, k, v, nullptr, nullptr, CacheRows{S}, pos,
                             out, ws, tickets, H, D, nslab, one_cta, scale);
}

// Paged pool: pools [n_blocks, bs, H, D] of P (T, or int8_t with k_scale,
// v_scale [n_blocks, bs, H] f32); tables [B, mb] i32; dynamic shared
// memory for the longest split's table entries.
template <typename T, typename P, int GP, int NV>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        int H, int D, int nslab, int bs, int mb,
                        int one_cta, float scale) {
  extern __shared__ int dec_tbl[];
  decode_split<T, P, GP, NV>(q, k_pool, v_pool, k_scale, v_scale,
                             PoolRows{tables, bs, mb, dec_tbl, 0}, pos, out,
                             ws, tickets, H, D, nslab, one_cta, scale);
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

// q [B, W, H, nslab * D]; pools [n_blocks, BS, H, nslab * D] of P (T, or
// int8_t with k_scale, v_scale [n_blocks, BS, H] f32, dequantized as they
// are staged: the reference's k * k_scale, in f32); tables [B, mb] i32;
// pos [B] i32; out [B, W, H, nslab * D]. Query i of row b sees logical
// positions <= pos[b] + i (and < mb * BS). D <= DP: shared tiles are DP
// wide, zero past D. With nslab > 1 (head dims above 512, padded to a
// multiple of 512: D = DP = 512), this CTA (blockIdx.x = bh * nslab + os)
// writes output slab os, and each block's scores sum over every slab,
// staged one after another.
template <typename T, typename P, int DP, int BS>
__global__ void __launch_bounds__(kThreads)
    paged_mq_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out, int W,
                    int H, int D, int nslab, int mb, float scale) {
  constexpr int QT = kThreads / BS;         // query rows per CTA
  constexpr int DPT = DP < kThreads ? DP : kThreads;  // output column stride
  constexpr int OC = DP / DPT;              // output columns per thread
  constexpr int OSTEP = kThreads / DPT;     // output rows per thread pass
  constexpr int NR = QT / OSTEP;            // output rows per thread
  static_assert(BS <= 32 && 32 % BS == 0, "bad block size");
  static_assert(DP % DPT == 0 && QT % OSTEP == 0 && NR >= 1, "bad head dim");

  // +1: conflict-free column walks
  extern __shared__ float mq_smem_f[];
  auto qs = reinterpret_cast<float (*)[DP + 1]>(mq_smem_f);   // [QT]
  auto ks = qs + QT;                                          // [BS]
  auto vs = ks + BS;                                          // [BS]
  auto ps = reinterpret_cast<float (*)[BS + 1]>(vs + BS);     // [QT]
  float* cs = reinterpret_cast<float*>(ps + QT);              // [QT]

  const int bh = blockIdx.x / nslab;
  const int os = blockIdx.x - bh * nslab;   // this CTA's output slab
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int p0 = pos[b];
  const int* tbl = tables + (size_t)b * mb;
  const int RW = nslab * D;                 // elements of a q / K / V row

  // Slab sl of the tile's q rows into qs.
  auto stage_q = [&](int sl) {
    for (int e = tid; e < QT * DP; e += kThreads) {
      const int i = e / DP, d = e - (e / DP) * DP;
      const int qi = min(i0 + i, W - 1);  // padded rows copy the last real row
      qs[i][d] = d < D ? to_f32(q[((size_t)(b * W + qi) * H + h) * RW +
                                  sl * D + d]) * scale
                       : 0.f;
    }
  };
  // Slab sl of block j's K (or V) rows into dst.
  auto stage_kv = [&](float (*dst)[DP + 1], const P* pool, const float* sc,
                      int j, int sl) {
    const size_t base = (size_t)tbl[j] * BS;
    for (int e = tid; e < BS * DP; e += kThreads) {
      const int t = e / DP, d = e - (e / DP) * DP;
      const size_t row = (base + t) * H + h;
      float x = d < D ? to_f32(pool[row * RW + sl * D + d]) : 0.f;
      if constexpr (std::is_same_v<P, int8_t>) x *= sc[row];
      dst[t][d] = x;
    }
  };
  if (nslab == 1) stage_q(0);

  // Score role: thread (si, st) owns score column st of query row si.
  const int si = tid / BS;
  const int st = tid - si * BS;
  const int limit = p0 + min(i0 + si, W - 1);
  float m = kNegInf, l = 0.f;

  // Output role: thread owns (oi0 + r * OSTEP, od + c * DPT) for r < NR,
  // c < OC.
  const int od = tid % DPT;
  const int oi0 = tid / DPT;
  float acc[NR][OC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;

  // Runtime block skip: nothing past the tile's last real row's horizon.
  const int last_row = min(i0 + QT, W) - 1;
  const int n_blk = min((p0 + last_row) / BS + 1, mb);
  for (int j = 0; j < n_blk; ++j) {
    __syncthreads();  // the previous block's qs/ks/vs/ps are consumed
    float s = 0.f;
    if (nslab == 1) {
      stage_kv(ks, k_pool, k_scale, j, 0);
      stage_kv(vs, v_pool, v_scale, j, 0);
      __syncthreads();
#pragma unroll 16
      for (int d = 0; d < DP; ++d) s += qs[si][d] * ks[st][d];
    } else {
      for (int sl = 0; sl < nslab; ++sl) {
        if (sl > 0) __syncthreads();   // the previous slab's qs/ks are read
        stage_q(sl);
        stage_kv(ks, k_pool, k_scale, j, sl);
        if (sl == 0) stage_kv(vs, v_pool, v_scale, j, os);
        __syncthreads();
#pragma unroll 16
        for (int d = 0; d < DP; ++d) s += qs[si][d] * ks[st][d];
      }
    }
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
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        float a = acc[r][c] * cs[oi];
#pragma unroll
        for (int t = 0; t < BS; ++t) a += ps[oi][t] * vs[t][od + c * DPT];
        acc[r][c] = a;
      }
    }
  }
  __syncthreads();
  if (st == 0) cs[si] = l;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int oi = oi0 + r * OSTEP;
    const int qi = i0 + oi;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = od + c * DPT;
      if (qi < W && d < D)
        out[((size_t)(b * W + qi) * H + h) * RW + os * D + d] =
            from_f32<T>(acc[r][c] / cs[oi]);
    }
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

// Shared memory: Q (bf16), then a ring of STAGES stages of K and V. A
// bf16 pool's stage is its K and V tiles as the MMAs read them; an int8
// pool's (Q8) is the K and V int8 tiles (rows I_PITCH bytes apart) and
// their KT f32 scales each, widened to bf16 into one K and one V tile
// (after the ring) before the MMAs read them.
template <int DP, bool Q8>
struct Geom {
  static constexpr int KT = DP > 128 ? 32 : 64;   // keys of a tile
  static constexpr int PITCH = (DP + 8) * 2;      // bytes of a bf16 row
  static constexpr int I_PITCH = DP + 16;         // bytes of an int8 row
  static constexpr int Q_BYTES = QR * PITCH;
  static constexpr int TILE_BYTES = KT * PITCH;   // one of K, V (bf16)
  static constexpr int I_TILE_BYTES = KT * I_PITCH + KT * 4;  // int8 + scales
  static constexpr int STAGE_BYTES = 2 * (Q8 ? I_TILE_BYTES : TILE_BYTES);
  static constexpr int WIDE = Q_BYTES + STAGES * STAGE_BYTES;  // Q8's bf16 tiles
  static constexpr int RING = WIDE + (Q8 ? 2 * TILE_BYTES : 0);
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

// 4 or 8 bytes from global to shared memory, or zeros when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
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
// Q8: the pools are int8 [n_blocks, bs, H, D] with k_scale, v_scale
// [n_blocks, bs, H] f32. A tile's int8 rows and its scales come in by
// cp.async and are widened to bf16 in shared memory (exact: |x| <= 127)
// before ldmatrix; each score column is multiplied by its key's k_scale
// after Q K^T, in f32 (q . (k s) = s (q . k)); each key's v_scale is
// folded into P's column before P is rounded to bf16 for P V, so the
// product is sum_t bf16(p_t v_scale_t) v_int8_t, against the reference's
// f32 sum_t p_t (v_scale_t v_int8_t): one more bf16 rounding of each
// term, 2^-8 P|V| at most, as for a bf16 pool (l sums the f32 p).
//
// Fragments (mma.m16n8k16; lane = 4 g + t): S and O accumulators hold
// (row g, columns 2t, 2t+1) and (row g + 8, the same columns) of each
// 8-column block; an A operand (row g | g + 8, k 2t, 2t+1 | 2t+8, 2t+9).
template <int DP, bool Q8>
__global__ void __launch_bounds__(THREADS)
    paged_mq_tc_kernel(const bf16* __restrict__ q,
                       const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ tickets,
                       int W, int H, int D, int bs, int mb, int ks,
                       float scale_log2) {
  using G = Geom<DP, Q8>;
  constexpr int KT = G::KT, PITCH = G::PITCH, I_PITCH = G::I_PITCH;
  constexpr int CH = DP / 8;           // 8-column chunks of a staged row
  constexpr int NS = KT / 8;           // 8-key blocks of a tile
  constexpr int NO = DP / 8;           // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char mq_smem_b[];
  const uint32_t sq = smem_addr(mq_smem_b);
  const uint32_t sring = sq + G::Q_BYTES;
  int* tbl_s = reinterpret_cast<int*>(mq_smem_b + G::RING);
  const char* kp8 = static_cast<const char*>(k_pool);
  const char* vp8 = static_cast<const char*>(v_pool);

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

  // The pool row (in the [*, H] view) of key t, t < kend.
  auto key_row = [&](int t) {
    const int blk = t / bs;
    return ((size_t)tbl_s[blk - blk0] * bs + (t - blk * bs)) * H + h;
  };
  // Tile j's K and V rows (and, Q8, their scales) into stage st; keys at
  // or past kend, and columns past D, are zeros.
  auto load_tile = [&](int j, int st) {
    const uint32_t dk = sring + st * G::STAGE_BYTES;
    const int kt0 = k0 + j * KT;
    for (int e = tid; e < KT * CH; e += THREADS) {
      const int r = e / CH, c = e - r * CH;
      const int t = kt0 + r;
      const bool ok = t < kend && c * 8 < D;
      const size_t off = ok ? key_row(t) * D + c * 8 : 0;
      if constexpr (Q8) {
        const uint32_t dv = dk + KT * I_PITCH;
        cp_async_ca<8>(dk + r * I_PITCH + c * 8, kp8 + off, ok);
        cp_async_ca<8>(dv + r * I_PITCH + c * 8, vp8 + off, ok);
      } else {
        const uint32_t dv = dk + G::TILE_BYTES;
        cp_async16(dk + r * PITCH + c * 16, kp8 + off * 2, ok);
        cp_async16(dv + r * PITCH + c * 16, vp8 + off * 2, ok);
      }
    }
    if constexpr (Q8) {
      const uint32_t dks = dk + 2 * KT * I_PITCH;
      for (int r = tid; r < KT; r += THREADS) {
        const int t = kt0 + r;
        const bool ok = t < kend;
        const size_t row = ok ? key_row(t) : 0;
        cp_async_ca<4>(dks + r * 4, k_scale + row, ok);
        cp_async_ca<4>(dks + (KT + r) * 4, v_scale + row, ok);
      }
    }
  };
  // Q8: stage st's int8 K and V tiles widened to the bf16 tiles the MMAs
  // read (8 columns a chunk).
  auto widen = [&](int st) {
    const unsigned char* src = mq_smem_b + G::Q_BYTES + st * G::STAGE_BYTES;
    unsigned char* dst = mq_smem_b + G::WIDE;
    for (int e = tid; e < 2 * KT * CH; e += THREADS) {
      const int kv = e / (KT * CH), rc = e - kv * KT * CH;
      const int r = rc / CH, c = rc - r * CH;
      const uint2 raw = *reinterpret_cast<const uint2*>(
          src + kv * KT * I_PITCH + r * I_PITCH + c * 8);
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      uint4 w;
      w.x = pack_bf16(x[0], x[1]);
      w.y = pack_bf16(x[2], x[3]);
      w.z = pack_bf16(x[4], x[5]);
      w.w = pack_bf16(x[6], x[7]);
      *reinterpret_cast<uint4*>(dst + kv * G::TILE_BYTES + r * PITCH +
                                c * 16) = w;
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
    const uint32_t stage = sring + (j % STAGES) * G::STAGE_BYTES;
    uint32_t tk = stage;
    // Q8: this tile's scales, k_scale[KT] then v_scale[KT]
    const float* scl = reinterpret_cast<const float*>(
        mq_smem_b + G::Q_BYTES + (j % STAGES) * G::STAGE_BYTES +
        2 * KT * I_PITCH);
    if constexpr (Q8) {
      widen(j % STAGES);
      __syncthreads();
      tk = sq + G::WIDE;
    }
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
          if constexpr (Q8) v *= scl[8 * n + 2 * t4 + c];
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

    // O += P V: P rounded to bf16 from S's fragments into the A operand
    // (Q8: each column times its key's v_scale first); V through
    // ldmatrix.trans (keys kk*16 + (mi%2)*8 + mr, d dn*16 + (mi/2)*8).
    if constexpr (Q8) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] *= scl[KT + 8 * n + 2 * t4 + (c & 1)];
    }
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

template <int DP, bool Q8>
cudaError_t launch_mq(const void* q, const void* k, const void* v,
                      const float* k_scale, const float* v_scale,
                      const int* tables, const int* pos, void* out, float* ws,
                      int* tickets, int B, int W, int H, int D, int bs,
                      int mb, int ks, int n_split, float scale,
                      cudaStream_t s) {
  const size_t smem =
      Geom<DP, Q8>::RING + (size_t)(ks / bs + 2) * sizeof(int);
  // Above 48 KB a kernel takes dynamic shared memory only after opting in.
  const cudaError_t err = cudaFuncSetAttribute(
      paged_mq_tc_kernel<DP, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (W + QR - 1) / QR, n_split);
  constexpr float kLog2e = 1.4426950408889634f;
  paged_mq_tc_kernel<DP, Q8><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), k, v, k_scale, v_scale, tables, pos,
      static_cast<bf16*>(out), ws, tickets, W, H, D, bs, mb, ks,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_q8(const void* q, const void* k, const void* v,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* pos, void* out,
                        float* ws, int* tickets, int B, int W, int H, int D,
                        int bs, int mb, int ks, int n_split, float scale,
                        cudaStream_t s) {
  if (k_scale != nullptr)
    return launch_mq<DP, true>(q, k, v, k_scale, v_scale, tables, pos, out,
                               ws, tickets, B, W, H, D, bs, mb, ks, n_split,
                               scale, s);
  return launch_mq<DP, false>(q, k, v, nullptr, nullptr, tables, pos, out, ws,
                              tickets, B, W, H, D, bs, mb, ks, n_split, scale,
                              s);
}

}  // namespace tc

// A head dim above 512 runs in slabs of 512 (it must be a multiple of
// 512: the wrappers pad it): the slab width and the number of slabs, or
// false for a head dim that is neither.
bool head_slabs(int D, int* width, int* nslab) {
  if (D <= 512) {
    *width = D;
    *nslab = 1;
    return true;
  }
  *width = 512;
  *nslab = D / 512;
  return D % 512 == 0;
}

// Threads per key row and vectors per lane for a runtime head dim (of a
// slab): (D / VEC rounded up to a power of two, 1); above 32 vectors, 32
// lanes of 2 (bf16 and int8 above 256, f32 above 128) or 4 (f32 above
// 256) vectors; false when D is not a multiple of VEC in 1 .. 512.
template <typename P>
bool lane_layout(int D, int* gp, int* nv) {
  constexpr int VEC = Vec<P>::N;
  if (D <= 0 || D % VEC != 0 || D > 512) return false;
  *nv = D > 64 * VEC ? 4 : D > 32 * VEC ? 2 : 1;
  *gp = 1;
  while (*gp * *nv * VEC < D) *gp *= 2;
  return true;
}

// Calls F<T, P, GP, NV>::run(args...) for the lane layout of head dim D
// over a pool of P; false when there is none.
template <template <typename, typename, int, int> class F, typename T,
          typename P, typename... A>
bool dispatch_group(int D, A... args) {
  int gp = 0, nv = 0;
  if (!lane_layout<P>(D, &gp, &nv)) return false;
  if (nv == 4) {
    if constexpr (Vec<P>::N == 4) {
      F<T, P, 32, 4>::run(args...);
      return true;
    }
    return false;
  }
  if (nv == 2) {
    F<T, P, 32, 2>::run(args...);
    return true;
  }
  switch (gp) {
    case 1: F<T, P, 1, 1>::run(args...); return true;
    case 2: F<T, P, 2, 1>::run(args...); return true;
    case 4: F<T, P, 4, 1>::run(args...); return true;
    case 8: F<T, P, 8, 1>::run(args...); return true;
    case 16: F<T, P, 16, 1>::run(args...); return true;
    case 32: F<T, P, 32, 1>::run(args...); return true;
    default: return false;
  }
}

// One decode launch: grid (B * H * nslab, n_split) of kDecodeThreads (D
// the width of a slab). A contiguous cache comes as tables == nullptr
// with bs = S and mb = 1 (its row b is one block of S positions); a
// paged pool takes dynamic shared memory for the longest split's table
// entries.
template <typename T, typename P, int GP, int NV>
struct SplitDecode {
  static void run(const void* q, const void* k, const void* v,
                  const float* k_scale, const float* v_scale,
                  const int* tables, const int* pos, void* out, float* ws,
                  int* tickets, int B, int H, int D, int nslab, int bs,
                  int mb, int n_split, int one_cta, float scale,
                  cudaStream_t stream) {
    const dim3 grid(B * H * nslab, n_split);
    if constexpr (std::is_same_v<T, P>) {
      if (tables == nullptr) {
        decode_kernel<T, GP, NV><<<grid, kDecodeThreads, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), pos, static_cast<T*>(out), ws,
            tickets, H, D, nslab, bs, one_cta, scale);
        return;
      }
    }
    const int span = mb * bs;
    const int ks =
        std::max(std::min(one_cta, span), split_length(span, n_split, 0));
    const size_t smem = (size_t)(ks / bs + 2) * sizeof(int);
    paged_decode_kernel<T, P, GP, NV>
        <<<grid, kDecodeThreads, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const P*>(k),
            static_cast<const P*>(v), k_scale, v_scale, tables, pos,
            static_cast<T*>(out), ws, tickets, H, D, nslab, bs, mb, one_cta,
            scale);
  }
};

template <typename T, typename P, int DP, int BS>
cudaError_t launch_mq(const void* q, const void* k, const void* v,
                      const float* k_scale, const float* v_scale,
                      const int* tables, const int* pos, void* out, int B,
                      int W, int H, int D, int nslab, int mb, float scale,
                      cudaStream_t stream) {
  constexpr int QT = kThreads / BS;
  constexpr size_t smem = mq_smem<DP, BS>();
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_mq_kernel<T, P, DP, BS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H * nslab, (W + QT - 1) / QT);
  paged_mq_kernel<T, P, DP, BS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), k_scale, v_scale, tables, pos,
      static_cast<T*>(out), W, H, D, nslab, mb, scale);
  return cudaGetLastError();
}

template <typename T, typename P, int DP>
cudaError_t dispatch_mq_bs(int bs, const void* q, const void* k,
                           const void* v, const float* ks, const float* vs,
                           const int* tables, const int* pos, void* out,
                           int B, int W, int H, int D, int nslab, int mb,
                           float scale, cudaStream_t s) {
  switch (bs) {
    case 8: return launch_mq<T, P, DP, 8>(q, k, v, ks, vs, tables, pos, out, B, W, H, D, nslab, mb, scale, s);
    case 16: return launch_mq<T, P, DP, 16>(q, k, v, ks, vs, tables, pos, out, B, W, H, D, nslab, mb, scale, s);
    case 32: return launch_mq<T, P, DP, 32>(q, k, v, ks, vs, tables, pos, out, B, W, H, D, nslab, mb, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The narrowest of the 32-, 64-, 128-, 256- and 512-wide tiles that holds
// D (0 when D is not a multiple of 8 in 8 .. 512).
int tile_width(int D) {
  if (D <= 0 || D % 8 != 0 || D > 512) return 0;
  int dp = 32;
  while (dp < D) dp *= 2;
  return dp;
}

// The CUDA-core multi-query kernel for q of T over a pool of P at head dim
// D (slabs of 512 above 512, head_slabs). bf16 q runs here only above 256
// (the tensor-core kernel takes the rest), so it is built at 512 alone.
template <typename T, typename P>
cudaError_t dispatch_mq(int D, int bs, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        const int* t, const int* p, void* out, int B, int W,
                        int H, int mb, float scale, cudaStream_t s) {
  int ds = 0, ns = 0;
  if (!head_slabs(D, &ds, &ns)) return cudaErrorInvalidValue;
  const int dp = tile_width(ds);
  if (dp == 512)
    return dispatch_mq_bs<T, P, 512>(bs, q, k, v, ks, vs, t, p, out, B, W, H, ds, ns, mb, scale, s);
  if constexpr (std::is_same_v<T, float>) {
    switch (dp) {
      case 32: return dispatch_mq_bs<T, P, 32>(bs, q, k, v, ks, vs, t, p, out, B, W, H, ds, ns, mb, scale, s);
      case 64: return dispatch_mq_bs<T, P, 64>(bs, q, k, v, ks, vs, t, p, out, B, W, H, ds, ns, mb, scale, s);
      case 128: return dispatch_mq_bs<T, P, 128>(bs, q, k, v, ks, vs, t, p, out, B, W, H, ds, ns, mb, scale, s);
      case 256: return dispatch_mq_bs<T, P, 256>(bs, q, k, v, ks, vs, t, p, out, B, W, H, ds, ns, mb, scale, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// The decode kernels of both caches (SplitDecode's arguments). k_scale
// and v_scale: both null (the pool is of q's dtype), or both set (an int8
// pool, paged only). D is the whole head dim (slabs of 512 above 512).
int launch_decode(const void* q, const void* k, const void* v,
                  const float* k_scale, const float* v_scale,
                  const int* tables, const void* pos, void* out, void* ws,
                  void* tickets, int B, int H, int D, int bs, int mb,
                  int n_split, int one_cta, float scale, int dtype,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  const bool q8 = k_scale != nullptr;
  int ds = 0, ns = 0;
  if (B <= 0 || H <= 0 || bs <= 0 || mb <= 0 || n_split < 1 ||
      n_split > kMaxSplits || one_cta < 0 || q8 != (v_scale != nullptr) ||
      (q8 && tables == nullptr) || !head_slabs(D, &ds, &ns))
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (dtype == 0 && !q8)
    ok = dispatch_group<SplitDecode, float, float>(ds, q, k, v, k_scale, v_scale, tables, p, out, w, tk, B, H, ds, ns, bs, mb, n_split, one_cta, scale, s);
  else if (dtype == 1 && !q8)
    ok = dispatch_group<SplitDecode, __nv_bfloat16, __nv_bfloat16>(ds, q, k, v, k_scale, v_scale, tables, p, out, w, tk, B, H, ds, ns, bs, mb, n_split, one_cta, scale, s);
  else if (dtype == 0)
    ok = dispatch_group<SplitDecode, float, int8_t>(ds, q, k, v, k_scale, v_scale, tables, p, out, w, tk, B, H, ds, ns, bs, mb, n_split, one_cta, scale, s);
  else if (dtype == 1)
    ok = dispatch_group<SplitDecode, __nv_bfloat16, int8_t>(ds, q, k, v, k_scale, v_scale, tables, p, out, w, tk, B, H, ds, ns, bs, mb, n_split, one_cta, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The decode kernels. dtype (q's): 0 = float32, 1 = bfloat16; D a multiple
// of 8 up to 512 (of 4 for f32), or a multiple of 512 (in slabs of 512:
// nslab = D / 512, else 1). n_split (1 .. 16) fixes the grid; a row that
// sees at most one_cta positions runs in one CTA, a longer one in splits
// of split_length(); ws is the f32 workspace of B * H * n_split * (D + 2
// nslab) floats, tickets B * H * nslab zeroed int32 (see decode_split).
// Paged: q [B, H, D]; pools [n_blocks, bs, H, D] of q's dtype, with
// k_scale = v_scale = null, or int8 with k_scale, v_scale [n_blocks, bs,
// H] f32; tables [B, mb] i32; pos [B] i32; out [B, H, D].
extern "C" int rtt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* pos, void* out, void* ws,
                                void* tickets, int B, int H, int D, int bs,
                                int mb, int n_split, int one_cta,
                                float scale, int dtype, void* stream) {
  if (tables == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode(q, k_pool, v_pool, static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale),
                       static_cast<const int*>(tables), pos, out, ws,
                       tickets, B, H, D, bs, mb, n_split, one_cta, scale,
                       dtype, stream);
}

// Contiguous cache: q [B, H, D]; k, v [B, S, H, D]; pos [B] i32; out
// [B, H, D].
extern "C" int rtt_decode(const void* q, const void* k, const void* v,
                          const void* pos, void* out, void* ws,
                          void* tickets, int B, int S, int H, int D,
                          int n_split, int one_cta, float scale, int dtype,
                          void* stream) {
  return launch_decode(q, k, v, nullptr, nullptr, nullptr, pos, out, ws,
                       tickets, B, H, D, S, 1, n_split, one_cta, scale,
                       dtype, stream);
}

// The multi-query kernel on CUDA cores: dtype (q's) 0 = float32 at any
// head dim, 1 = bfloat16 above 256 (D as rtt_paged_decode takes it);
// block size bs one of 8, 16, 32; pools of q's dtype (k_scale = v_scale
// = null) or int8 (both scales set).
extern "C" int rtt_paged_mq(const void* q, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* pos, void* out, int B, int W, int H,
                            int D, int bs, int mb, float scale, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = ks == nullptr
              ? dispatch_mq<float, float>(D, bs, q, k_pool, v_pool, ks, vs, t, p, out, B, W, H, mb, scale, s)
              : dispatch_mq<float, int8_t>(D, bs, q, k_pool, v_pool, ks, vs, t, p, out, B, W, H, mb, scale, s);
  else if (dtype == 1 && D > 256)
    err = ks == nullptr
              ? dispatch_mq<bf16, bf16>(D, bs, q, k_pool, v_pool, ks, vs, t, p, out, B, W, H, mb, scale, s)
              : dispatch_mq<bf16, int8_t>(D, bs, q, k_pool, v_pool, ks, vs, t, p, out, B, W, H, mb, scale, s);
  return static_cast<int>(err);
}

// The bf16 multi-query kernel on the tensor cores: pools of bf16 (k_scale
// = v_scale = null) or int8 (both scales set), any block size bs that is
// a multiple of 8, ks and n_split as for rtt_paged_decode, ws the f32
// workspace of 2 + D floats for each of B * H * ceil(W / 64) * n_split *
// min(W, 64) rows, tickets [B * H * ceil(W / 64)] zeroed int32.
extern "C" int rtt_paged_mq_tc(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* pos, void* out, void* ws,
                               void* tickets, int B, int W, int H, int D,
                               int bs, int mb, int ks, int n_split,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (B <= 0 || W <= 0 || H <= 0 || bs <= 0 || bs % 8 != 0 || mb <= 0 ||
      ks <= 0 || ks % 128 != 0 || n_split != (mb * bs + ks - 1) / ks ||
      n_split > kMaxSplits || (ksc == nullptr) != (vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile_width(D)) {
    case 32: return static_cast<int>(tc::dispatch_q8<32>(q, k_pool, v_pool, ksc, vsc, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    case 64: return static_cast<int>(tc::dispatch_q8<64>(q, k_pool, v_pool, ksc, vsc, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    case 128: return static_cast<int>(tc::dispatch_q8<128>(q, k_pool, v_pool, ksc, vsc, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    case 256: return static_cast<int>(tc::dispatch_q8<256>(q, k_pool, v_pool, ksc, vsc, t, p, out, w, tk, B, W, H, D, bs, mb, ks, n_split, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);   // above 256: rtt_paged_mq
  }
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
