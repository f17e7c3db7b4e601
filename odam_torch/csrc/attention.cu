// Masked multi-head attention for Hopper (sm_90a): the two kernels that
// replace odam_tpu/ops/pallas_attention.py.
//
//   odam_fused_attention  <- pallas_attention.py:fused_attention (_attn_kernel)
//   odam_flash_attention  <- pallas_attention.py:flash_attention (_flash_kernel)
//
// Both read q [B, Lq, H, dh] and k, v [B, Lk, H, dh] through their strides
// (the last dim must be contiguous), take an optional key padding mask
// [B, Lk] of bytes (nonzero = padded key), and write o [B, Lq, H, dh] in the
// input type.  Logits are q.k * dh^-1/2 in f32; a padded key gets the finite
// logit -1e9, so a query whose keys are all padded averages V uniformly over
// the Lk real keys, exactly as the plain path does.  (The TPU flash kernel
// also averages over its pad block in that case, pallas_attention.py:160-168;
// these kernels never pad Lk and follow the plain path, which
// pallas_attention.py:9-11 names as the reference.)
//
// Layout of a block: 64 query rows x 4 lanes = 256 threads.  The 4 lanes of
// a row are consecutive threads of one warp; lane t owns keys t, t+4, t+8, ...
// so each lane keeps its own softmax state (max m, sum l, f32 accumulator
// acc[dh]) with no per-key communication, and the 4 partial states merge
// with warp shuffles at the end.  K and V tiles sit in shared memory as f32
// rows padded by 4 floats, so the 4 lanes of a row read 4 different banks.
//
// What bounds them on the card: at the main path's shapes (dh 32 or 64,
// Lk <= 850) the work is a few MFLOP to 0.75 GFLOP on at most 3.5 MB, and
// B*H*ceil(Lq/64) is 4 to 112 blocks, fewer than the 132 SMs.  So neither
// the memory rate nor the tensor cores are the limit: these are latency and
// occupancy bound, with f32 FMAs on the CUDA cores.  The design keeps it
// simple and right (no tensor cores, no TMA); PERF.md holds the times, and a
// tensor-core redesign (wgmma, more blocks per head) is the next kernel work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                  // query rows per block
constexpr int kLanes = 4;                    // threads per query row
constexpr int kThreads = kBlockQ * kLanes;   // 256
constexpr int kTileK = 64;                   // keys per shared tile (flash)
constexpr int kMaxFusedKeys = 256;           // fused holds all Lk < 256 keys
constexpr float kMasked = -1e9f;             // logit of a padded key

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int qb, ql, qh;
  int kb, kl, kh;
  int vb, vl, vh;
  int ob, ol, oh;
  int mb;
};

// Copy keys [k0, k0 + nk) of one (b, h) into shared rows of length LD as f32
// (rows >= nk are zero), and their padding flags.
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_kv(const T* __restrict__ kbase, const T* __restrict__ vbase,
                                        const uint8_t* __restrict__ mrow, int k0, int nk,
                                        int rows, int kl, int vl,
                                        float* ks, float* vs, uint8_t* pad) {
  for (int e = threadIdx.x; e < rows * DH; e += kThreads) {
    const int j = e / DH;
    const int d = e - j * DH;
    float kv = 0.f, vv = 0.f;
    if (j < nk) {
      kv = to_f32(kbase[(long long)(k0 + j) * kl + d]);
      vv = to_f32(vbase[(long long)(k0 + j) * vl + d]);
    }
    ks[j * LD + d] = kv;
    vs[j * LD + d] = vv;
  }
  for (int j = threadIdx.x; j < rows; j += kThreads) {
    pad[j] = (j < nk && mrow != nullptr) ? mrow[k0 + j] : 0;
  }
}

template <int DH>
__device__ __forceinline__ float logit(const float (&qr)[DH], const float* krow, float scale) {
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], krow[d], dot);
  return dot * scale;
}

// Write this row's output: lane t stores the dims d with d % 4 == t.
template <typename T, int DH>
__device__ __forceinline__ void store_row(T* __restrict__ orow, const float (&acc)[DH],
                                          float l, int lane) {
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    if (d % kLanes == lane) orow[d] = from_f32<T>(acc[d] / denom);
  }
}

// Streaming (online-softmax) attention over 64-key tiles.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, T* __restrict__ o,
                  int H, int Lq, int Lk, Strides st, float scale) {
  constexpr int LD = DH + 4;
  constexpr int KPL = kTileK / kLanes;   // keys per lane per tile
  __shared__ float ks[kTileK * LD];
  __shared__ float vs[kTileK * LD];
  __shared__ uint8_t pad[kTileK];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x - row * kLanes;
  const int qi = blockIdx.x * kBlockQ + row;
  const bool live = qi < Lq;

  float qr[DH];
  const T* qrow = q + (long long)b * st.qb + (long long)(live ? qi : 0) * st.ql +
                  (long long)h * st.qh;
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = to_f32(qrow[d]);

  const T* kbase = k + (long long)b * st.kb + (long long)h * st.kh;
  const T* vbase = v + (long long)b * st.vb + (long long)h * st.vh;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * st.mb : nullptr;

  float m = -INFINITY, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int nk = min(kTileK, Lk - k0);
    __syncthreads();   // the previous tile has been read by every thread
    load_kv<T, DH, LD>(kbase, vbase, mrow, k0, nk, kTileK, st.kl, st.vl, ks, vs, pad);
    __syncthreads();

    float s[KPL];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = i * kLanes + lane;
      float x = logit<DH>(qr, ks + j * LD, scale);
      if (pad[j]) x = kMasked;
      s[i] = j < nk ? x : -INFINITY;   // the ragged edge takes no part
      tile_max = fmaxf(tile_max, s[i]);
    }
    if (tile_max > -INFINITY) {        // this lane owns a real key here
      const float m_new = fmaxf(m, tile_max);
      const float alpha = expf(m - m_new);   // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        if (s[i] > -INFINITY) {
          const float p = expf(s[i] - m_new);
          const float* vrow = vs + (i * kLanes + lane) * LD;
          l += p;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vrow[d], acc[d]);
        }
      }
      m = m_new;
    }
  }

  // Merge the 4 lanes' states; a lane that saw no key has m = -inf, l = 0.
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float a = m == -INFINITY ? 0.f : expf(m - m_new);
    const float a_o = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * a + acc_o * a_o;
    }
    m = m_new;
  }
  if (live) {
    store_row<T, DH>(o + (long long)b * st.ob + (long long)qi * st.ol + (long long)h * st.oh,
                     acc, l, lane);
  }
}

// Single-tile attention for Lk < 256: every key of the (b, h) slice sits in
// shared memory at once, so the softmax is the plain two-pass one (row max,
// then exp, sum and P.V) with no rescaling, as in the TPU fused kernel.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
fused_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, T* __restrict__ o,
                  int H, int Lq, int Lk, Strides st, float scale) {
  constexpr int LD = DH + 4;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + Lk * LD;
  uint8_t* pad = reinterpret_cast<uint8_t*>(vs + Lk * LD);

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x - row * kLanes;
  const int qi = blockIdx.x * kBlockQ + row;
  const bool live = qi < Lq;

  const T* kbase = k + (long long)b * st.kb + (long long)h * st.kh;
  const T* vbase = v + (long long)b * st.vb + (long long)h * st.vh;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * st.mb : nullptr;
  load_kv<T, DH, LD>(kbase, vbase, mrow, 0, Lk, Lk, st.kl, st.vl, ks, vs, pad);

  float qr[DH];
  const T* qrow = q + (long long)b * st.qb + (long long)(live ? qi : 0) * st.ql +
                  (long long)h * st.qh;
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = to_f32(qrow[d]);
  __syncthreads();

  float m = -INFINITY;
  for (int j = lane; j < Lk; j += kLanes) {
    const float x = pad[j] ? kMasked : logit<DH>(qr, ks + j * LD, scale);
    m = fmaxf(m, x);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float l = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int j = lane; j < Lk; j += kLanes) {
    const float x = pad[j] ? kMasked : logit<DH>(qr, ks + j * LD, scale);
    const float p = expf(x - m);
    const float* vrow = vs + j * LD;
    l += p;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vrow[d], acc[d]);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (live) {
    store_row<T, DH>(o + (long long)b * st.ob + (long long)qi * st.ol + (long long)h * st.oh,
                     acc, l, lane);
  }
}

size_t fused_smem_bytes(int Lk, int dh) {
  const size_t floats = 2 * (size_t)Lk * (dh + 4);
  return floats * sizeof(float) + ((Lk + 15) / 16) * 16;
}

template <typename T, int DH>
cudaError_t launch(bool fused, const void* q, const void* k, const void* v, const void* mask,
                   void* o, int B, int H, int Lq, int Lk, const Strides& st,
                   cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(o);
  if (fused) {
    // Above 48 KB a block needs the opt-in, which is per device: ask each time.
    const cudaError_t err = cudaFuncSetAttribute(
        fused_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)fused_smem_bytes(kMaxFusedKeys, DH));
    if (err != cudaSuccess) return err;
    fused_attn_kernel<T, DH><<<grid, kThreads, fused_smem_bytes(Lk, DH), stream>>>(
        qp, kp, vp, mp, op, H, Lq, Lk, st, scale);
  } else {
    flash_attn_kernel<T, DH><<<grid, kThreads, 0, stream>>>(qp, kp, vp, mp, op, H, Lq, Lk, st,
                                                            scale);
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
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
  if (fused && Lk >= kMaxFusedKeys) return (int)cudaErrorInvalidValue;
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
