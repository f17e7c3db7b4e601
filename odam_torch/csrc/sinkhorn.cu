// Log-space optimal transport with a dustbin row and column (Sinkhorn) on
// the card (sm_90a): the whole of odam_torch/ops/sinkhorn.py's
// log_optimal_transport in one launch, one block a problem.
//
//   odam_sinkhorn  <- odam_tpu/ops/sinkhorn.py:log_optimal_transport (a
//                     lax.scan that XLA compiles into one region; there is
//                     no Pallas kernel to port)
//
// Input scores [S, M, N] float32, row_mask [S, M] and col_mask [S, N] bool
// (one byte each; a null pointer: every row, or column, valid), alpha one
// float32 on the device; all contiguous.  Output [S, M+1, N+1] float32: the
// log assignment, scaled so probabilities are multiplied by (m + n).  Per
// problem, as the plain path computes it, step for step in float32:
//
// - Z [M+1, N+1]: the scores where both row and column are valid, else
//   -1e9; the dustbin column alpha at valid rows, else -1e9; the dustbin
//   row alpha at valid columns, else -1e9; the corner alpha;
// - m, n the valid counts, norm = -logf(m + n); log_mu = norm at valid rows,
//   -1e9 at the others, logf(n) + norm at the dustbin; log_nu likewise with
//   logf(m) + norm;
// - `iters` times: u = log_mu - lse_j(Z + v), then v = log_nu - lse_i(Z + u),
//   from u = v = 0, where each lse is torch.logsumexp's: the max m of the
//   line, replaced by 0 where it is +-inf, then logf(sum expf(x - m)) + m;
// - out = ((Z + u) + v) - norm.
// Only the order of each sum differs from ATen's, so live entries agree to
// float32 rounding.  An empty store (m = 0) or a frame without detections
// (n = 0) gives logf(0) = -inf in the marginals, and both at once gives
// -inf + inf = NaN: the same elementwise operations give the same -inf and
// NaN entries (a NaN in a line makes its sum NaN whatever the max is, so
// fmaxf, which skips NaN where ATen's amax keeps it, changes nothing).
//
// What bounds it: neither bytes nor operations.  At the lane step's
// [16, 65, 31] a call reads 123 KB and writes 129 KB (under 0.1 us at
// 3.35 TB/s) and takes 2 x 2015 expf a problem an iteration.  The chain of
// 2 x iters dependent passes, each a max, a sum and a __syncthreads, sets
// its time.  The plain path issues some 22 kernels an iteration from the
// host, ~2,200 a call, each of a microsecond or two on the card and ~10 us
// of host issue.
//
// Design.  One block of 1024 threads a problem keeps Z, u, v, log_mu and
// log_nu in shared memory for all the iterations and writes the output
// once.  Z's rows are `ld` = (N + 1) | 1 floats apart, so a column's
// elements fall in distinct banks.  A pass splits the block into groups of
// `group` lanes (group_for: the largest power of two up to 32 that still
// gives every line its own group), one line (a row of the row pass, a
// column of the column pass) a group: lane p of a group takes the line's
// elements p, p + group, ..., keeps its max and its sum in that order, and
// the group combines them by xor shuffles, offsets group / 2 down to 1.  At
// [65, 31] a row pass runs 65 groups of 8 lanes (4 elements a lane, 3
// shuffle levels) and a column pass 31 warps (2 or 3 elements a lane, 5
// levels).  The layout is chosen here alone, from M and N.  The launch
// neither synchronizes nor allocates, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;                    // ops/sinkhorn.py's _NEG
constexpr size_t kSmemLimit = 232448;            // dynamic shared memory a block may use
constexpr size_t kSmemDefault = 48 * 1024;       // above it only after the attribute call
constexpr int kTooLarge = -1;                    // odam_sinkhorn: Z does not fit one block

// out[l] = mu[l] - lse_k(Z[l ls + k ks] + w[k]) for every line l < L of K
// elements, a group of `group` lanes a line.
__device__ __forceinline__ void lse_pass(const float* Z, int ls, int ks, const float* w,
                                         const float* mu, float* out, int L, int K, int group) {
  const int groups = kThreads / group;
  const int g = threadIdx.x / group, p = threadIdx.x % group;
  for (int base = 0; base < L; base += groups) {       // uniform over the block
    const int l = base + g;
    const bool live = l < L;
    const float* z = Z + (live ? l : 0) * ls;
    float m = -CUDART_INF_F;
    if (live)
      for (int k = p; k < K; k += group) m = fmaxf(m, z[k * ks] + w[k]);
    for (int off = group >> 1; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (fabsf(m) == CUDART_INF_F) m = 0.f;              // ATen's logsumexp
    float s = 0.f;
    if (live)
      for (int k = p; k < K; k += group) s += expf((z[k * ks] + w[k]) - m);
    for (int off = group >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (live && p == 0) out[l] = mu[l] - (logf(s) + m);
  }
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ row_mask,
                const uint8_t* __restrict__ col_mask, const float* __restrict__ alpha_ptr,
                float* __restrict__ out, int M, int N, int ld, int row_group, int col_group,
                int iters) {
  extern __shared__ float smem[];
  __shared__ int counts[2];                            // valid rows, valid columns
  const int R = M + 1, C = N + 1;
  float* Z = smem;                                     // [R, ld]
  float* u = Z + R * ld;                               // [R]
  float* v = u + R;                                    // [C]
  float* log_mu = v + C;                               // [R]
  float* log_nu = log_mu + R;                          // [C]
  const long long s = blockIdx.x;
  const float* sc = scores + s * M * N;
  const uint8_t* rm = row_mask ? row_mask + s * M : nullptr;
  const uint8_t* cm = col_mask ? col_mask + s * N : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp < 2) {                                      // warp 0 counts rows, warp 1 columns
    const uint8_t* mask = warp == 0 ? rm : cm;
    const int n = warp == 0 ? M : N;
    unsigned c = 0;
    for (int i = lane; i < n; i += 32) c += mask ? (mask[i] != 0) : 1u;
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) counts[warp] = static_cast<int>(c);
  }
  __syncthreads();
  const float alpha = *alpha_ptr;
  const float ms = static_cast<float>(counts[0]), ns = static_cast<float>(counts[1]);
  const float norm = -logf(ms + ns);
  for (int i = tid; i < R; i += kThreads) {
    log_mu[i] = i < M ? ((!rm || rm[i]) ? norm : kNeg) : logf(ns) + norm;
    u[i] = 0.f;
  }
  for (int j = tid; j < C; j += kThreads) {
    log_nu[j] = j < N ? ((!cm || cm[j]) ? norm : kNeg) : logf(ms) + norm;
    v[j] = 0.f;
  }
  for (int idx = tid; idx < R * C; idx += kThreads) {
    const int i = idx / C, j = idx - i * C;
    const bool row_ok = i == M || !rm || rm[i];        // the dustbin row is always valid
    const bool col_ok = j == N || !cm || cm[j];
    float z = alpha;                                   // the corner and valid bins
    if (i < M && j < N) z = row_ok && col_ok ? sc[static_cast<long long>(i) * N + j] : kNeg;
    else if (!(row_ok && col_ok)) z = kNeg;
    Z[i * ld + j] = z;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    lse_pass(Z, ld, 1, v, log_mu, u, R, C, row_group);       // rows: u
    __syncthreads();
    lse_pass(Z, 1, ld, u, log_nu, v, C, R, col_group);       // columns: v
    __syncthreads();
  }

  float* o = out + s * R * C;
  for (int idx = tid; idx < R * C; idx += kThreads) {
    const int i = idx / C, j = idx - i * C;
    o[idx] = ((Z[i * ld + j] + u[i]) + v[j]) - norm;
  }
}

size_t smem_bytes(int M, int N, int ld) {
  return 4 * (static_cast<size_t>(M + 1) * ld + 2 * static_cast<size_t>(M + 1)
              + 2 * static_cast<size_t>(N + 1));
}

// The largest power of two up to 32 that still gives each of `lines` lines
// its own group of the block's threads.
int group_for(int lines) {
  int g = 32;
  while (g > 1 && kThreads / g < lines) g >>= 1;
  return g;
}

}  // namespace

extern "C" {

// S blocks of 1024 threads on `stream`, laid out from M and N (Design).
// Returns 0 on success, kTooLarge (-1) for a problem whose Z, potentials and
// marginals one block's shared memory cannot hold, cudaErrorInvalidValue for
// negative sizes, else the cudaError_t of the attribute call (made on every
// launch above 48 KB: the attribute is the current device's) or of the launch.
int odam_sinkhorn(const float* scores, const uint8_t* row_mask, const uint8_t* col_mask,
                  const float* alpha, float* out, int S, int M, int N, int iters,
                  void* stream) {
  if (S < 0 || M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = (N + 1) | 1;
  const size_t smem = smem_bytes(M, N, ld);
  if (smem > kSmemLimit) return kTooLarge;
  if (S == 0) return 0;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(sinkhorn_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sinkhorn_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, row_mask, col_mask, alpha, out, M, N, ld, group_for(M + 1), group_for(N + 1),
      iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
