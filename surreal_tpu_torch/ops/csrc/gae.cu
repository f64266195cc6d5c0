// Fused GAE over time-major (T, B) arrays: float32, with bool dones read
// as bytes (torch.bool is one byte holding 0 or 1).
//
// Replaces the TPU kernel surreal_tpu/ops/pallas_gae.py::_gae_kernel
// (gae_pallas). Per env column:
//   delta[t] = r[t] + gamma*disc[t]*V'[t] - V[t]
//   coef[t]  = gamma*lam*disc[t]*(1 - done[t])
//   adv[t]   = delta[t] + coef[t]*adv[t+1]      (reverse scan, adv[T] = 0)
//   vtarg[t] = adv[t] + V[t]
//
// Bound on the H100: bytes. Each element is read once from 4 float inputs
// and one bool, and written once to 2 outputs (25 bytes per element, ~10
// flops), and at the main path's (128, 256) the whole problem is 0.8 MB,
// far below a microsecond of memory time, so in practice the launch and
// the 128 serialized steps of memory latency dominate.
// Design: one thread per env column carries the scan in a register and
// walks t = T-1 .. 0 with the delta/coef prologue fused in, so nothing but
// the two outputs is written. Neighbouring threads read neighbouring
// addresses of each time row (coalesced). Any B: the edge is masked.
// Making it fast (more columns per SM, splitting T) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void gae_kernel(const float* __restrict__ r, const float* __restrict__ v,
                           const float* __restrict__ nv, const float* __restrict__ disc,
                           const uint8_t* __restrict__ done, float* __restrict__ adv,
                           float* __restrict__ vtarg, int T, int B, float gamma,
                           float lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float gl = gamma * lam;
  float carry = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const long i = static_cast<long>(t) * B + b;
    const float d = disc[i];
    const float val = v[i];
    const float delta = r[i] + gamma * d * nv[i] - val;
    const float coef = gl * d * (done[i] ? 0.0f : 1.0f);
    carry = delta + coef * carry;
    adv[i] = carry;
    vtarg[i] = carry + val;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gae_fused(const float* r, const float* v, const float* nv, const float* disc,
              const uint8_t* done, float* adv, float* vtarg, int T, int B, float gamma,
              float lam, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  gae_kernel<<<blocks, threads, 0, stream>>>(r, v, nv, disc, done, adv, vtarg, T, B,
                                             gamma, lam);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
