// Fused clipped-surrogate PPO loss: forward (5 channel means) and the
// closed-form backward d loss / d (mean, log_std, value).
//
// Replaces the TPU kernels surreal_tpu/ops/pallas_ppo_loss.py::_fwd_kernel
// (called from _fwd_call) and ::_bwd_kernel (called from _fused_bwd, the
// custom VJP). Per row i, with A action dims:
//   logp  = -0.5 * sum_a (z^2 + 2 log_std + log 2pi),  z = (action - mean) e^-log_std
//   ratio = exp(clip(logp - logp_old, -20, 20))
//   surr  = min(ratio*adv, clip(ratio, 1-eps, 1+eps)*adv)
//   vloss = 0.5*max((v - vt)^2, (v_old + clip(v - v_old, -eps, eps) - vt)^2)
//   ent   = sum_a (log_std + 0.5 (log 2pi + 1))
//   kl    = sum_a (log_std - lso + 0.5 (e^{2(lso - log_std)} + dmu^2 - 1)),
//           dmu = (mean_old - mean) e^-log_std
//   clip  = |ratio - 1| > eps
// The forward returns the 5 sums divided by N; the backward reproduces the
// reference's tie rules (min takes the unclipped branch at ties, max takes
// the raw value error at ties) and passes zero gradient through the +-20
// clamp and outside the value clip band.
//
// Bound on the H100: bytes. At the main path's N=4096, A=6 the forward
// reads 0.48 MB; the backward reads 0.28 MB (every input but mean_old and
// log_std_old) and writes 0.21 MB. With ~100-250 flops per row, both are
// far below a microsecond of memory time,
// so launch latency dominates. Design: one thread per row, rows in
// contiguous blocks so neighbouring threads touch neighbouring rows.
// log_std and log_std_old take a row stride (0 = one (A,) vector shared by
// all rows), so the state-independent log-std is never broadcast into
// device memory. The forward reduces each block's rows to 5 partial sums
// in a (blocks, 5) scratch buffer with a fixed-order tree in shared
// memory, then a second single-block kernel reduces the partials in a
// fixed order: the result is deterministic, with no float atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 5;
constexpr float kLog2Pi = 1.8378770664093453f;

struct Inputs {
  const float* mean;
  const float* log_std;
  const float* value;
  const float* action;
  const float* logp_old;
  const float* mean_old;
  const float* log_std_old;
  const float* adv;
  const float* vtarg;
  const float* v_old;
  int n;
  int a;
  int ls_stride;
  int lso_stride;
};

// min / max / clip that propagate NaN as jnp and torch do (fminf/fmaxf
// would drop it and hide a diverged row from the caller's finiteness check).
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

__device__ float row_logp(const Inputs& in, int i) {
  const float* mean = in.mean + static_cast<long>(i) * in.a;
  const float* ls = in.log_std + static_cast<long>(i) * in.ls_stride;
  const float* act = in.action + static_cast<long>(i) * in.a;
  float acc = 0.0f;
  for (int k = 0; k < in.a; ++k) {
    const float z = (act[k] - mean[k]) * expf(-ls[k]);
    acc += z * z + 2.0f * ls[k] + kLog2Pi;
  }
  return -0.5f * acc;
}

__global__ void loss_fwd_partial(Inputs in, float eps, float* __restrict__ partial) {
  __shared__ float sh[kSums][kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float vals[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < in.n) {
    const float ratio = expf(clampf(row_logp(in, i) - in.logp_old[i], -20.0f, 20.0f));
    const float adv = in.adv[i];
    const float r_clip = clampf(ratio, 1.0f - eps, 1.0f + eps);
    vals[0] = min_nan(ratio * adv, r_clip * adv);

    const float v = in.value[i], v_old = in.v_old[i], vt = in.vtarg[i];
    const float v_cl = v_old + clampf(v - v_old, -eps, eps);
    const float e1 = (v - vt) * (v - vt), e2 = (v_cl - vt) * (v_cl - vt);
    vals[1] = 0.5f * max_nan(e1, e2);

    const float* mean = in.mean + static_cast<long>(i) * in.a;
    const float* ls = in.log_std + static_cast<long>(i) * in.ls_stride;
    const float* mo = in.mean_old + static_cast<long>(i) * in.a;
    const float* lso = in.log_std_old + static_cast<long>(i) * in.lso_stride;
    float ent = 0.0f, kl = 0.0f;
    for (int k = 0; k < in.a; ++k) {
      ent += ls[k] + 0.5f * (kLog2Pi + 1.0f);
      const float var_ratio = expf(2.0f * (lso[k] - ls[k]));
      const float dmu = (mo[k] - mean[k]) * expf(-ls[k]);
      kl += ls[k] - lso[k] + 0.5f * (var_ratio + dmu * dmu - 1.0f);
    }
    vals[2] = ent;
    vals[3] = kl;
    vals[4] = fabsf(ratio - 1.0f) > eps ? 1.0f : 0.0f;
  }
  for (int k = 0; k < kSums; ++k) sh[k][threadIdx.x] = vals[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int k = 0; k < kSums; ++k) sh[k][threadIdx.x] += sh[k][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < kSums) partial[blockIdx.x * kSums + threadIdx.x] = sh[threadIdx.x][0];
}

__global__ void loss_fwd_final(const float* __restrict__ partial, int blocks, int n,
                               float* __restrict__ out) {
  __shared__ float sh[kSums][kThreads];
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = threadIdx.x; j < blocks; j += kThreads) {
    for (int k = 0; k < kSums; ++k) acc[k] += partial[j * kSums + k];
  }
  for (int k = 0; k < kSums; ++k) sh[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int k = 0; k < kSums; ++k) sh[k][threadIdx.x] += sh[k][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < kSums) out[threadIdx.x] = sh[threadIdx.x][0] / static_cast<float>(n);
}

__global__ void loss_bwd(Inputs in, float eps, float value_coef, float entropy_coef,
                         float inv_n, float* __restrict__ dmean, float* __restrict__ dls,
                         float* __restrict__ dv) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= in.n) return;
  const float x = row_logp(in, i) - in.logp_old[i];
  const float ratio = expf(clampf(x, -20.0f, 20.0f));
  const float in_band_lr = fabsf(x) < 20.0f ? 1.0f : 0.0f;
  const float adv = in.adv[i];
  const float r_clip = clampf(ratio, 1.0f - eps, 1.0f + eps);
  const float use_unclipped = ratio * adv <= r_clip * adv ? 1.0f : 0.0f;
  const float g_logp = -inv_n * (use_unclipped * ratio * adv * in_band_lr);
  const float ent_term = entropy_coef * inv_n;

  const float* mean = in.mean + static_cast<long>(i) * in.a;
  const float* ls = in.log_std + static_cast<long>(i) * in.ls_stride;
  const float* act = in.action + static_cast<long>(i) * in.a;
  for (int k = 0; k < in.a; ++k) {
    const float inv_std = expf(-ls[k]);
    const float z = (act[k] - mean[k]) * inv_std;
    dmean[static_cast<long>(i) * in.a + k] = g_logp * z * inv_std;
    dls[static_cast<long>(i) * in.a + k] = g_logp * (z * z - 1.0f) - ent_term;
  }

  const float v = in.value[i], v_old = in.v_old[i], vt = in.vtarg[i];
  const float dvv = v - v_old;
  const float v_cl = v_old + clampf(dvv, -eps, eps);
  const float e1 = (v - vt) * (v - vt), e2 = (v_cl - vt) * (v_cl - vt);
  const float use_raw = e1 >= e2 ? 1.0f : 0.0f;
  const float in_band = fabsf(dvv) < eps ? 1.0f : 0.0f;
  const float dvloss = use_raw * (v - vt) + (1.0f - use_raw) * (v_cl - vt) * in_band;
  dv[i] = (value_coef * inv_n) * dvloss;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

Inputs make_inputs(const float* mean, const float* log_std, const float* value,
                   const float* action, const float* logp_old, const float* mean_old,
                   const float* log_std_old, const float* adv, const float* vtarg,
                   const float* v_old, int n, int a, int ls_stride, int lso_stride) {
  return Inputs{mean, log_std, value, action, logp_old, mean_old, log_std_old,
                adv,  vtarg,   v_old, n,      a,        ls_stride, lso_stride};
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// partial: (ceil(n / 256), 5) scratch; out: (5,) channel means.
int ppo_loss_fwd(const float* mean, const float* log_std, const float* value,
                 const float* action, const float* logp_old, const float* mean_old,
                 const float* log_std_old, const float* adv, const float* vtarg,
                 const float* v_old, int n, int a, int ls_stride, int lso_stride,
                 float eps, float* partial, float* out, cudaStream_t stream) {
  const Inputs in = make_inputs(mean, log_std, value, action, logp_old, mean_old,
                                log_std_old, adv, vtarg, v_old, n, a, ls_stride, lso_stride);
  const int blocks = blocks_for(n);
  loss_fwd_partial<<<blocks, kThreads, 0, stream>>>(in, eps, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_fwd_final<<<1, kThreads, 0, stream>>>(partial, blocks, n, out);
  return static_cast<int>(cudaGetLastError());
}

int ppo_loss_bwd(const float* mean, const float* log_std, const float* value,
                 const float* action, const float* logp_old, const float* mean_old,
                 const float* log_std_old, const float* adv, const float* vtarg,
                 const float* v_old, int n, int a, int ls_stride, int lso_stride,
                 float eps, float value_coef, float entropy_coef, float inv_n,
                 float* dmean, float* dls, float* dv, cudaStream_t stream) {
  const Inputs in = make_inputs(mean, log_std, value, action, logp_old, mean_old,
                                log_std_old, adv, vtarg, v_old, n, a, ls_stride, lso_stride);
  loss_bwd<<<blocks_for(n), kThreads, 0, stream>>>(in, eps, value_coef, entropy_coef,
                                                        inv_n, dmean, dls, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
