// Masked multi-head attention for Hopper (sm_90a): the two kernels that
// replace odam_tpu/ops/pallas_attention.py.
//
//   odam_fused_attention  <- pallas_attention.py:fused_attention (_attn_kernel)
//   odam_flash_attention  <- pallas_attention.py:flash_attention (_flash_kernel)
//
// Both read q [B, Lq, H, dh] and k, v [B, Lk, H, dh] through their strides
// (the last dim contiguous; pointers and the other strides 16-byte aligned,
// which the wrapper ensures), take an optional key padding mask [B, Lk] of
// bytes (nonzero = padded key), and write o [B, Lq, H, dh] in the input type.
// Logits are q.k * dh^-1/2 in f32, kept in base 2 (scaled by log2(e) and
// exponentiated with exp2f, which gives the same softmax); a padded key gets
// the finite logit -1e9, so a query whose keys are all padded averages V
// uniformly over the Lk real keys, exactly as the plain path does.  (The
// TPU flash kernel also averages over its pad block in that case,
// pallas_attention.py:160-168; these kernels never pad Lk and follow the
// plain path, which pallas_attention.py:9-11 names as the reference.)  Keys
// at or past Lk take no part.
//
// Design.  A block is 8 warps on one (b, h) and one 16-row query tile; the
// eight warps split the keys, each keeping its own online-softmax state
// (row max m, row sum l, f32 accumulator acc[16][dh]) in registers, and
// merge those states in shared memory at the end of the same launch.
//
// - Both matrix products run on the tensor cores with mma.sync, one warp on
//   16 query rows.  bf16: m16n8k16 with f32 accumulation; P is rounded to
//   bf16 for P.V, as FlashAttention-2 does.  f32: 3xTF32 with m16n8k8.tf32:
//   each operand x splits into hi = tf32(x) and lo = tf32(x - hi), and
//   hi.hi' + hi.lo' + lo.hi' are summed in f32, which keeps the error near
//   f32 (plain TF32, about 1e-3, would miss the 2e-5 / 3e-5 bars).  hi is
//   rounded to nearest (ties away, as cvt.rna.tf32) by an integer add and
//   mask; lo goes in as the f32 x - hi, whose low 13 bits the tensor core
//   ignores, which costs lo at most 2^-10 of itself (2^-21 of x).
// - The f32 accumulator of Q.K^T holds columns 2t, 2t+1 of each 8-key tile,
//   where the tf32 A operand of P.V wants columns t, t+4.  The kernel does
//   not move P: it feeds P.V's k index in the permuted order (k index t is
//   key 2t, k index t+4 is key 2t+1) and reads V's B fragment in the same
//   order (rows 2t and 2t+1), since the sum over keys does not care about
//   order.  In bf16 the accumulator is already the A layout.  The small
//   3xTF32 products go to a sum of their own, so the three do not wait on
//   each other, and the key mask is read a step ahead into a bit set.
// - flash: warp w takes the 16-key tiles w, w+8, w+16, ... and stages them
//   with cp.async (16-byte copies, the ragged edge zero-filled) into a
//   double-buffered ring of its own, so the next tile loads while the
//   current one is computed and the warps sync only among their own lanes.
// - fused: the block stages the (b, h) K/V slice with cp.async in slabs of
//   256 keys, the whole slice in one slab when Lk < 256; in each slab warp w
//   takes a contiguous eighth of its 16-key groups, computes those logits
//   once and keeps them in registers (at most 32 keys, 16 floats a thread),
//   then takes the row max, exp, sum and P.V: one pass, no second Q.K^T.  It
//   is the one-stage case of flash's tile routine, and a warp carries its
//   online-softmax state from one slab to the next.  The TPU kernel holds a
//   slice of any Lk in VMEM; here a slice of 1050 keys in f32 at dh 32
//   would take 304 KB of shared memory against a block's 227 KB, hence the
//   slabs (at most 139 KB, f32 at dh 64).  A slab is staged after every
//   warp is done with the one before: no overlap of copy and compute past
//   256 keys, where flash is the streaming kernel.
//
// What bounds them, and why mma.sync and not wgmma/TMA: at the main path's
// shapes (dh 32 or 64, Lk <= 850, B = 1) the work is a few MFLOP to 0.74
// GFLOP on at most 3.5 MB, so bytes bound the small calls and the tensor
// cores (3xTF32 at a third of 495 TFLOP/s) the encoder's.  A wgmma tile has
// 64 rows: that gives at most 112 tiles at the largest call and 16 at the
// decoder cross on 132 SMs, so occupancy, not issue rate, would be the
// limit.  16-row warp tiles with the keys split eight ways give 432 blocks
// at the encoder and 56 at the decoder cross instead.  Eight warps and
// 16-key tiles took the least device time a frame on the H100 of 4 or 8
// warps and 16- or 32-key tiles (four warps are faster at the encoder
// alone, eight at the decoder cross).  PERF.md has the times and what still
// holds them back: each warp's steps run one after another, about 1.3 us a
// 16-key tile, and two query tiles a block sharing K/V did not pay.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // warps per block; they split the keys
constexpr int kThreads = kWarps * 32;        // 256
constexpr int kRows = 16;                    // query rows per block: one mma tile
constexpr int kTileK = 16;                   // keys per flash tile
constexpr int kStages = 2;                   // flash: tiles in flight per warp
constexpr int kGroup = 16;                   // fused: keys per group a warp takes
constexpr int kFusedSlab = 256;              // fused: keys staged at once
constexpr int kFusedWarpKeys = kFusedSlab / kWarps;   // 32: most keys a warp holds
constexpr float kMasked = -1e9f;             // logit of a padded key
constexpr int kMaxDevices = 64;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory row pitch in elements: a row padded by 16 bytes keeps the
// fragment reads below free of bank conflicts and the rows 16-byte aligned.
template <typename T, int DH> __host__ __device__ constexpr int pitch() {
  return DH + 16 / (int)sizeof(T);
}

struct Strides {
  int qb, ql, qh;
  int kb, kl, kh;
  int vb, vl, vh;
  int ob, ol, oh;
  int mb;
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;              // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (nearest, ties away), lo the rest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: a.b with both split, the lo.lo' term dropped: big += hi.hi',
// small += lo.hi' + hi.lo'.  Two sums, so that the three products do not
// wait on each other.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x, the low half, = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [r0, r0 + nrows) of one (b, h) slice of K or V into shared rows
// of pitch P with 16-byte cp.async, by `nthreads` threads from `tid`.  Rows
// at or past Lk are zero-filled: a zero V row times p = 0 adds nothing.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base, int stride, int r0,
                                           int nrows, int Lk, T* dst, int tid, int nthreads) {
  constexpr int kChunk = 16 / (int)sizeof(T);   // elements per copy
  constexpr int kPerRow = DH / kChunk;
  constexpr int P = pitch<T, DH>();
  for (int e = tid; e < nrows * kPerRow; e += nthreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kChunk;
    const bool valid = r0 + r < Lk;
    cp_async16(dst + r * P + c, base + (long long)(valid ? r0 + r : 0) * stride + c, valid);
  }
}

// ------------------------------------------------------- the tile routine
//
// Fragment layouts (PTX ISA, mma.sync): lane = 4 g + t.  The f32 C/D tile
// 16 x 8 holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  A thread so
// owns query rows g and g+8 of the warp's tile.

template <typename T, int DH> struct QFrag;
template <int DH> struct QFrag<float, DH> {        // m16n8k8.tf32 A, split
  uint32_t hi[DH / 8][4], lo[DH / 8][4];
};
template <int DH> struct QFrag<__nv_bfloat16, DH> {   // m16n8k16.bf16 A
  uint32_t x[DH / 16][4];
};

template <int DH> struct RowState {
  float m[2];            // running max of rows g, g+8 (the same in the 4 lanes of a row)
  float l[2];            // this lane's part of the running sum
  float acc[DH / 8][4];  // output columns 8j + 2t, 8j + 2t + 1 of rows g, g+8
};

template <int DH> __device__ __forceinline__ void init_state(RowState<DH>& st) {
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.acc[j][i] = 0.f;
}

// Q rows [0, nrows) of the tile at qt (row stride ql); rows past nrows read 0.
template <int DH>
__device__ __forceinline__ void load_q(const float* __restrict__ qt, int ql, int nrows,
                                       QFrag<float, DH>& f) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
      const int r = g + (i & 1) * 8;
      const float x = r < nrows ? qt[(long long)r * ql + 8 * ks + t + (i >> 1) * 4] : 0.f;
      split_tf32(x, f.hi[ks][i], f.lo[ks][i]);
    }
}
template <int DH>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ qt, int ql, int nrows,
                                       QFrag<__nv_bfloat16, DH>& f) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // a_i: row g + 8 (i & 1), cols 16 ks + 2t + 8 (i >> 1) + 0, 1
      const int r = g + (i & 1) * 8;
      f.x[ks][i] = r < nrows ? *reinterpret_cast<const uint32_t*>(
                                   qt + (long long)r * ql + 16 * ks + 2 * t + (i >> 1) * 8)
                             : 0u;
    }
}

// s += Q . K^T for the 8 keys whose shared rows start at krow + g * P.
template <int DH>
__device__ __forceinline__ void qk_tile(const QFrag<float, DH>& f, const float* krow,
                                        float (&s)[4]) {
  const int t = threadIdx.x & 3;
  float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks)       // B: (k = t, n = g), (k = t + 4, n = g)
    mma_3xtf32(s, small, f.hi[ks], f.lo[ks], krow[8 * ks + t], krow[8 * ks + t + 4]);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] += small[i];
}
template <int DH>
__device__ __forceinline__ void qk_tile(const QFrag<__nv_bfloat16, DH>& f,
                                        const __nv_bfloat16* krow, float (&s)[4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)      // B: k = 16 ks + 2t + {0, 1} (+ 8), n = g
    mma_bf16(s, f.x[ks], *reinterpret_cast<const uint32_t*>(krow + 16 * ks + 2 * t),
             *reinterpret_cast<const uint32_t*>(krow + 16 * ks + 8 + 2 * t));
}

// acc += P . V for the 8 keys of one tile, the small 3xTF32 products into
// corr; p is the tile's C fragment and vrow points at the tile's shared row
// 2t.  k index t is key 2t, k index t + 4 is key 2t + 1 (see the header).
template <int DH>
__device__ __forceinline__ void pv_tile(const float (&p)[4], const float* vrow,
                                        float (&acc)[DH / 8][4], float (&corr)[DH / 8][4]) {
  constexpr int P = pitch<float, DH>();
  const int g = (threadIdx.x & 31) >> 2;
  uint32_t ah[4], al[4];
  split_tf32(p[0], ah[0], al[0]);   // (g, k t)      = (g, key 2t)
  split_tf32(p[2], ah[1], al[1]);   // (g+8, k t)    = (g+8, key 2t)
  split_tf32(p[1], ah[2], al[2]);   // (g, k t+4)    = (g, key 2t+1)
  split_tf32(p[3], ah[3], al[3]);   // (g+8, k t+4)  = (g+8, key 2t+1)
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    mma_3xtf32(acc[j], corr[j], ah, al, vrow[8 * j + g], vrow[P + 8 * j + g]);
}
// bf16: the 16 keys of two tiles; p0, p1 are their C fragments and vrow
// points at the pair's shared row 2t.
template <int DH>
__device__ __forceinline__ void pv_pair(const float (&p0)[4], const float (&p1)[4],
                                        const __nv_bfloat16* vrow, float (&acc)[DH / 8][4]) {
  constexpr int P = pitch<__nv_bfloat16, DH>();
  const int g = (threadIdx.x & 31) >> 2;
  const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                         pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int n = 8 * j + g;
    mma_bf16(acc[j], a, pack_bf16(vrow[n], vrow[P + n]),
             pack_bf16(vrow[8 * P + n], vrow[9 * P + n]));
  }
}

// Of this lane's keys key0 + 8 nt + 2t + e (e = 0, 1) in a step of NT
// tiles, the padded ones: bit 2 nt + e.  Read a step ahead, so that the
// mask's latency hides behind the work of the step before.
template <int NT>
__device__ __forceinline__ uint32_t padded_keys(const uint8_t* __restrict__ mrow, int key0,
                                                int n_tiles, int Lk) {
  uint32_t bits = 0;
  if (mrow == nullptr) return bits;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * nt + 2 * t + e;
      if (nt < n_tiles && key < Lk && mrow[key]) bits |= 1u << (2 * nt + e);
    }
  return bits;
}

// One warp's step over the keys [key0, key0 + 8 n_tiles) of its (b, h), in
// shared rows kt, vt (n_tiles <= NT; bf16 needs n_tiles even): logits on
// the tensor cores, the key mask (padded, from padded_keys) and ragged edge,
// the online-softmax update of (m, l, acc) in base 2, and P . V.  With
// m = -inf on entry it is the one-pass softmax of these keys.
template <typename T, int DH, int NT>
__device__ __forceinline__ void attend(const QFrag<T, DH>& f, const T* kt, const T* vt,
                                       uint32_t padded, int key0, int n_tiles, int Lk,
                                       float scale, RowState<DH>& st) {
  constexpr int P = pitch<T, DH>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float s[NT][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    if (nt < n_tiles) {
      qk_tile<DH>(f, kt + (8 * nt + g) * P, s[nt]);
      const int j = key0 + 8 * nt + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j + (i & 1);
        float x = s[nt][i] * scale;
        if (key >= Lk) x = -INFINITY;                             // ragged edge: no part
        else if ((padded >> (2 * nt + (i & 1))) & 1u) x = kMasked;   // padded key
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = -INFINITY;
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);
    // A step always holds a key < Lk, so m_new is finite; the guard keeps
    // exp(-inf - -inf) out all the same.
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(st.m[r] - m_use[r]);   // 0 while m is still -inf
    st.m[r] = m_new;
    st.l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      st.acc[j][2 * r] *= alpha;
      st.acc[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = exp2f(s[nt][i] - m_use[i >> 1]);    // -inf -> 0
      st.l[i >> 1] += s[nt][i];
    }
  if constexpr (sizeof(T) == 4) {
    float corr[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) corr[j][i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < n_tiles) pv_tile<DH>(s[nt], vt + (8 * nt + 2 * t) * P, st.acc, corr);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st.acc[j][i] += corr[j][i];
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2)
      if (nt < n_tiles) pv_pair<DH>(s[nt], s[nt + 1], vt + (8 * nt + 2 * t) * P, st.acc);
  }
}

// Merge the kWarps states of the block's 16 rows in shared memory and write
// rows [0, nrows) of the tile at ot.  A warp that saw no key has m = -inf
// and weight 0; a row whose keys are all padded has m = -1e9 in every warp
// that saw a key, and so averages V over them.
template <typename T, int DH>
__device__ __forceinline__ void merge_store(RowState<DH>& st, float* smem, T* __restrict__ ot,
                                            int ol, int nrows) {
  constexpr int AP = DH + 4;
  float* sm_m = smem;
  float* sm_l = smem + kWarps * kRows;
  float* sm_acc = smem + 2 * kWarps * kRows;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
  __syncthreads();   // every warp is done with the K/V rows this reuses
  if (t == 0) {
    sm_m[warp * kRows + g] = st.m[0];
    sm_m[warp * kRows + g + 8] = st.m[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * kRows + row]);
    const float a = st.m[r] == -INFINITY ? 0.f : exp2f(st.m[r] - M);
    if (t == 0) sm_l[warp * kRows + row] = st.l[r] * a;
    float* dst = sm_acc + (warp * kRows + row) * AP + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dst[8 * j] = st.acc[j][2 * r] * a;
      dst[8 * j + 1] = st.acc[j][2 * r + 1] * a;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * DH; e += kThreads) {
    const int row = e / DH;
    const int col = e - row * DH;
    float L = 0.f, x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      L += sm_l[w * kRows + row];
      x += sm_acc[(w * kRows + row) * AP + col];
    }
    ot[(long long)row * ol + col] = from_f32<T>(x / L);
  }
}

template <int DH> constexpr size_t merge_bytes() {
  return (size_t)(2 * kWarps * kRows + kWarps * kRows * (DH + 4)) * sizeof(float);
}
constexpr size_t max_bytes(size_t a, size_t b) { return a > b ? a : b; }

// ---------------------------------------------------------------- kernels

// Streaming (online-softmax) attention: warp w walks the 16-key tiles w,
// w + 8, ... through its own two-stage cp.async ring.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, T* __restrict__ o,
                  int H, int Lq, int Lk, Strides st, float scale) {
  constexpr int kTile = kTileK * pitch<T, DH>();   // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, Lq - row0);
  T* ring = reinterpret_cast<T*>(smem) + warp * kStages * 2 * kTile;

  const T* kbase = k + (long long)b * st.kb + (long long)h * st.kh;
  const T* vbase = v + (long long)b * st.vb + (long long)h * st.vh;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * st.mb : nullptr;
  const int n_tiles = (Lk + kTileK - 1) / kTileK;

  int tile = warp;
  if (tile < n_tiles) {
    stage_rows<T, DH>(kbase, st.kl, tile * kTileK, kTileK, Lk, ring, lane, 32);
    stage_rows<T, DH>(vbase, st.vl, tile * kTileK, kTileK, Lk, ring + kTile, lane, 32);
  }
  cp_async_commit();
  uint32_t padded = padded_keys<kTileK / 8>(mrow, tile * kTileK, kTileK / 8, Lk);

  QFrag<T, DH> f;
  load_q<DH>(q + (long long)b * st.qb + (long long)h * st.qh + (long long)row0 * st.ql, st.ql,
             nrows, f);
  RowState<DH> rs;
  init_state<DH>(rs);

  for (int i = 0; tile < n_tiles; ++i, tile += kWarps) {
    T* cur = ring + (i & 1) * 2 * kTile;
    const int next = tile + kWarps;
    uint32_t padded_next = 0;
    if (next < n_tiles) {   // the other stage, read last step: refill it now
      T* nxt = ring + ((i + 1) & 1) * 2 * kTile;
      stage_rows<T, DH>(kbase, st.kl, next * kTileK, kTileK, Lk, nxt, lane, 32);
      stage_rows<T, DH>(vbase, st.vl, next * kTileK, kTileK, Lk, nxt + kTile, lane, 32);
      padded_next = padded_keys<kTileK / 8>(mrow, next * kTileK, kTileK / 8, Lk);
    }
    cp_async_commit();      // an empty group keeps the count uniform
    cp_async_wait<1>();     // this step's tile has landed
    __syncwarp();
    attend<T, DH, kTileK / 8>(f, cur, cur + kTile, padded, tile * kTileK, kTileK / 8, Lk,
                              scale, rs);
    padded = padded_next;
    __syncwarp();           // every lane is done with cur before it is refilled
  }
  cp_async_wait<0>();
  merge_store<T, DH>(rs, reinterpret_cast<float*>(smem),
                     o + (long long)b * st.ob + (long long)h * st.oh + (long long)row0 * st.ol,
                     st.ol, nrows);
}

// Single-stage attention: the block stages the keys of the (b, h) slice in
// slabs of kFusedSlab (one slab when Lk < 256); in each slab warp w takes a
// contiguous eighth of the 16-key groups and attends to them in one pass
// with its logits in registers, its softmax state carried across slabs.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
fused_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, T* __restrict__ o,
                  int H, int Lq, int Lk, Strides st, float scale) {
  constexpr int P = pitch<T, DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, Lq - row0);
  const int slab_groups = (min(Lk, kFusedSlab) + kGroup - 1) / kGroup;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + slab_groups * kGroup * P;

  const T* kbase = k + (long long)b * st.kb + (long long)h * st.kh;
  const T* vbase = v + (long long)b * st.vb + (long long)h * st.vh;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * st.mb : nullptr;
  int key0 = 0;
  int n_groups = slab_groups;
  stage_rows<T, DH>(kbase, st.kl, 0, n_groups * kGroup, Lk, ks, threadIdx.x, kThreads);
  stage_rows<T, DH>(vbase, st.vl, 0, n_groups * kGroup, Lk, vs, threadIdx.x, kThreads);
  cp_async_commit();

  QFrag<T, DH> f;
  load_q<DH>(q + (long long)b * st.qb + (long long)h * st.qh + (long long)row0 * st.ql, st.ql,
             nrows, f);
  RowState<DH> rs;
  init_state<DH>(rs);
  while (true) {
    const int per_warp = (n_groups + kWarps - 1) / kWarps;
    const int g0 = warp * per_warp;
    const int gn = min(per_warp, n_groups - g0);
    const uint32_t padded = padded_keys<kFusedWarpKeys / 8>(mrow, key0 + g0 * kGroup,
                                                            gn * kGroup / 8, Lk);
    cp_async_wait<0>();
    __syncthreads();
    if (gn > 0) {
      attend<T, DH, kFusedWarpKeys / 8>(f, ks + g0 * kGroup * P, vs + g0 * kGroup * P, padded,
                                        key0 + g0 * kGroup, gn * kGroup / 8, Lk, scale, rs);
    }
    key0 += kFusedSlab;
    if (key0 >= Lk) break;
    n_groups = (min(kFusedSlab, Lk - key0) + kGroup - 1) / kGroup;
    __syncthreads();   // every warp is done with the slab before it is refilled
    stage_rows<T, DH>(kbase, st.kl, key0, n_groups * kGroup, Lk, ks, threadIdx.x, kThreads);
    stage_rows<T, DH>(vbase, st.vl, key0, n_groups * kGroup, Lk, vs, threadIdx.x, kThreads);
    cp_async_commit();
  }
  merge_store<T, DH>(rs, reinterpret_cast<float*>(smem),
                     o + (long long)b * st.ob + (long long)h * st.oh + (long long)row0 * st.ol,
                     st.ol, nrows);
}

template <typename T, int DH> size_t flash_smem_bytes() {
  return max_bytes((size_t)kWarps * kStages * 2 * kTileK * pitch<T, DH>() * sizeof(T),
                   merge_bytes<DH>());
}
template <typename T, int DH> size_t fused_smem_bytes(int Lk) {
  const int slab = Lk < kFusedSlab ? Lk : kFusedSlab;
  const size_t rows = (size_t)(slab + kGroup - 1) / kGroup * kGroup;
  return max_bytes(2 * rows * pitch<T, DH>() * sizeof(T), merge_bytes<DH>());
}

// Above 48 KB a block needs the opt-in, which is per device and kernel: ask
// once for the most this kernel can take, on each device it runs on.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int DH>
cudaError_t launch(bool fused, const void* q, const void* k, const void* v, const void* mask,
                   void* o, int B, int H, int Lq, int Lk, const Strides& st,
                   cudaStream_t stream) {
  static bool fused_ready[kMaxDevices], flash_ready[kMaxDevices];
  const float scale = (float)(1.4426950408889634 / sqrt((double)DH));   // log2(e) / sqrt(dh)
  const dim3 grid((Lq + kRows - 1) / kRows, B * H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(o);
  cudaError_t err;
  if (fused) {
    err = allow_smem(fused_attn_kernel<T, DH>, fused_smem_bytes<T, DH>(kFusedSlab),
                     fused_ready);
    if (err != cudaSuccess) return err;
    fused_attn_kernel<T, DH><<<grid, kThreads, fused_smem_bytes<T, DH>(Lk), stream>>>(
        qp, kp, vp, mp, op, H, Lq, Lk, st, scale);
  } else {
    err = allow_smem(flash_attn_kernel<T, DH>, flash_smem_bytes<T, DH>(), flash_ready);
    if (err != cudaSuccess) return err;
    flash_attn_kernel<T, DH><<<grid, kThreads, flash_smem_bytes<T, DH>(), stream>>>(
        qp, kp, vp, mp, op, H, Lq, Lk, st, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(bool fused, int dh, const void* q, const void* k, const void* v,
                        const void* mask, void* o, int B, int H, int Lq, int Lk,
                        const Strides& st, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(fused, q, k, v, mask, o, B, H, Lq, Lk, st, stream);
    case 32: return launch<T, 32>(fused, q, k, v, mask, o, B, H, Lq, Lk, st, stream);
    case 64: return launch<T, 64>(fused, q, k, v, mask, o, B, H, Lq, Lk, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool fused, const void* q, const void* k, const void* v, const void* mask, void* o,
        int dtype, int B, int H, int Lq, int Lk, int dh,
        int sqb, int sql, int sqh, int skb, int skl, int skh, int svb, int svl, int svh,
        int sob, int sol, int soh, int smb, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Strides st{sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh, smb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dh<float>(fused, dh, q, k, v, mask, o, B, H, Lq, Lk, st, s);
  } else if (dtype == 1) {
    err = dispatch_dh<__nv_bfloat16>(fused, dh, q, k, v, mask, o, B, H, Lq, Lk, st, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements.  mask may be null.  Returns a cudaError_t code.
extern "C" int odam_fused_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, int dtype, int B, int H,
                                    int Lq, int Lk, int dh, int sqb, int sql, int sqh,
                                    int skb, int skl, int skh, int svb, int svl, int svh,
                                    int sob, int sol, int soh, int smb, void* stream) {
  return run(true, q, k, v, mask, o, dtype, B, H, Lq, Lk, dh, sqb, sql, sqh, skb, skl, skh,
             svb, svl, svh, sob, sol, soh, smb, stream);
}

extern "C" int odam_flash_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, int dtype, int B, int H,
                                    int Lq, int Lk, int dh, int sqb, int sql, int sqh,
                                    int skb, int skl, int skh, int svb, int svl, int svh,
                                    int sob, int sol, int soh, int smb, void* stream) {
  return run(false, q, k, v, mask, o, dtype, B, H, Lq, Lk, dh, sqb, sql, sqh, skb, skl, skh,
             svb, svl, svh, sob, sol, soh, smb, stream);
}
