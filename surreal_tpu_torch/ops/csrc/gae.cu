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
// far below a microsecond of memory time. In practice the kernel is bound
// by the launch, one round trip to memory and the serial steps between
// them, so the design keeps those few:
//  - The loads do not depend on the scan's carry; only T multiply-adds do.
//    Step t is the affine map y -> delta[t] + coef[t]*y and maps compose
//    associatively, so T is split across threads. A block owns kCols
//    neighbouring columns and all of T; thread (c, s) owns column c and the
//    L = ceil(T / kChunks) <= kSteps consecutive steps of chunk s. The grid
//    is ceil(B / kCols) blocks (32 at B = 256), not one thread per column.
//  - Lanes run over the columns first, so each load of a warp reads whole
//    rows of the tile (kCols floats = one 32-byte sector). Every thread
//    starts all its 5*L loads before any arithmetic: one memory round trip
//    for the whole kernel instead of one per step. All accesses are 4 bytes
//    (1 for dones), so a contiguous view at any offset is taken as it is.
//  - Each thread scans its chunk backwards from a carry of 0, keeping per
//    step the local value y_t and the product p_t of the coefficients from
//    t to the chunk's end, and publishes its chunk's map (p, y at its first
//    step) to shared memory. After one __syncthreads() every thread of a
//    column composes the maps from the last chunk down, in that fixed
//    order, and picks up the carry that enters its own chunk on the way;
//    then adv[t] = y_t + p_t*carry. Nothing but the two outputs is written
//    to device memory.
//  - T above kChunks*kSteps (256) is walked in segments of that many steps
//    from the end. The composition run to its end is the carry into the
//    next segment, which every thread of the column holds in a register;
//    the maps are double-buffered in shared memory, so a segment costs one
//    barrier. A ragged last chunk, steps past T and columns past B are
//    masked; an empty chunk publishes the identity map.
// (kCols, kChunks) = (8, 32) is what chip_smoke.py --gae-sweep supports.
//
// Numerics. y_t + p_t*carry rounds at other places than the sequential
// delta + coef*carry, so the result differs from the sequential scan by a
// few float32 spacings of the advantages (|coef| <= gamma*lam < 1, so the
// products shrink); the reference's default scan is associative as well.
// Every operation is an explicit round-to-nearest intrinsic, so the
// compiler's contraction setting (-fmad) changes nothing: delta, coef and
// vtarg are formed as the plain version forms them, and each step of the
// recurrences is one fused multiply-add. The wrapper passes gamma*lam
// rounded once from double, as torch does. Sums have a fixed order and
// there are no atomics: two calls are bitwise equal. 0*NaN is formed as in
// the plain version, so a NaN or inf reaches every earlier step of its
// column, across dones and zero discounts too, and no other column.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 8;     // columns per block: a tile row is one 32-byte sector
constexpr int kChunks = 32;  // time chunks per block; kCols*kChunks threads
constexpr int kSteps = 8;    // most steps of one thread per segment, in registers
constexpr int kSegment = kChunks * kSteps;

__global__ void __launch_bounds__(kCols* kChunks)
    gae_kernel(const float* __restrict__ r, const float* __restrict__ v,
               const float* __restrict__ nv, const float* __restrict__ disc,
               const uint8_t* __restrict__ done, float* __restrict__ adv,
               float* __restrict__ vtarg, int T, int B, float gamma, float gamma_lam) {
  // chunk s's map y -> .y + .x*y, one buffer per segment parity
  __shared__ float2 maps[2][kChunks][kCols];
  const int c = threadIdx.x % kCols, s = threadIdx.x / kCols;
  const int b = blockIdx.x * kCols + c;
  float seg_carry = 0.0f;  // adv at the first step of the segment above
  int buf = 0;
  for (int t0 = (T - 1) / kSegment * kSegment; t0 >= 0; t0 -= kSegment, buf ^= 1) {
    const int len = min(kSegment, T - t0);
    const int L = (len + kChunks - 1) / kChunks;
    const int first = t0 + s * L;  // my chunk: steps first .. first + n - 1
    const int n = b < B ? max(0, min(L, t0 + len - first)) : 0;
    const long base = static_cast<long>(first) * B + b;

    float rr[kSteps], vv[kSteps], nn[kSteps], dd[kSteps];
    uint8_t dn[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j < n) {
        const long i = base + static_cast<long>(j) * B;
        rr[j] = r[i];
        vv[j] = v[i];
        nn[j] = nv[i];
        dd[j] = disc[i];
        dn[j] = done[i];
      }
    }

    float y[kSteps], p[kSteps];
    float yc = 0.0f, pc = 1.0f;
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      if (j < n) {
        const float delta =
            __fsub_rn(__fadd_rn(rr[j], __fmul_rn(__fmul_rn(gamma, dd[j]), nn[j])), vv[j]);
        const float coef = __fmul_rn(__fmul_rn(gamma_lam, dd[j]), dn[j] ? 0.0f : 1.0f);
        yc = __fmaf_rn(coef, yc, delta);
        pc = __fmul_rn(coef, pc);
        y[j] = yc;
        p[j] = pc;
      }
    }
    maps[buf][s][c] = make_float2(pc, yc);  // the identity where n == 0
    __syncthreads();

    float carry = seg_carry, mine = 0.0f;
#pragma unroll 16
    for (int k = kChunks - 1; k >= 0; --k) {
      if (k == s) mine = carry;
      const float2 m = maps[buf][k][c];
      carry = __fmaf_rn(m.x, carry, m.y);
    }
    seg_carry = carry;

#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j < n) {
        const long i = base + static_cast<long>(j) * B;
        const float a = __fmaf_rn(p[j], mine, y[j]);
        adv[i] = a;
        vtarg[i] = __fadd_rn(a, vv[j]);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gae_fused(const float* r, const float* v, const float* nv, const float* disc,
              const uint8_t* done, float* adv, float* vtarg, int T, int B, float gamma,
              float gamma_lam, cudaStream_t stream) {
  const int blocks = (B + kCols - 1) / kCols;
  gae_kernel<<<blocks, kCols * kChunks, 0, stream>>>(r, v, nv, disc, done, adv, vtarg, T, B,
                                                     gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
