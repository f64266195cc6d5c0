// Fused clipped-surrogate PPO loss: the forward (the loss and its five
// metrics) and the closed-form backward d loss / d (mean, log_std, value),
// one launch each.
//
// Replaces the TPU kernels surreal_tpu/ops/pallas_ppo_loss.py::_fwd_kernel
// (called from _fwd_call) and ::_bwd_kernel (called from _fused_bwd, the
// custom VJP), and the scalar arithmetic the reference does around them.
// Per row i, with A action dims:
//   logp  = -0.5 * sum_a (z^2 + 2 log_std + log 2pi),  z = (action - mean) e^-log_std
//   ratio = exp(clip(logp - logp_old, -20, 20))
//   surr  = min(ratio*adv, clip(ratio, 1-eps, 1+eps)*adv)
//   vloss = 0.5*max((v - vt)^2, (v_old + clip(v - v_old, -eps, eps) - vt)^2)
//   ent   = sum_a (log_std + 0.5 (log 2pi + 1))
//   kl    = sum_a (log_std - lso + 0.5 (e^{2(lso - log_std)} + dmu^2 - 1)),
//           dmu = (mean_old - mean) e^-log_std
//   clip  = |ratio - 1| > eps
// With s = the five sums / N, the forward writes the loss
// (-s0 + value_coef*s1) - entropy_coef*s2 and the metrics
// [-s0, s1, s2, s3, s4]. The backward takes the loss's cotangent g from
// device memory and writes g*dmean, g*dvalue and g*dlog_std; the latter is
// summed over rows inside the kernel when log_std is one (A,) vector shared
// by all rows. It keeps the reference kernel's tie rules (min takes the
// unclipped branch at ties, max the raw value error) and passes zero
// gradient through the +-20 clamp and outside the value clip band.
// min/max/clip propagate NaN as jnp and torch do.
//
// There is no matrix product and no tensor-core work: each row is ~150
// float32 operations of elementwise and transcendental work.
//
// Bound on the H100: bytes, and far below a microsecond. At the main path's
// N=4096, A=6 the forward reads 0.48 MB and writes 24 B; the backward reads
// 0.28 MB and writes 0.11 MB. Both kernels are bound in practice by launch
// latency and by the serial steps inside one launch, so the design keeps
// everything in one launch and each step short:
//  - The grid is one cluster of 16 blocks (kCluster) of 256 threads. Each
//    block takes a contiguous range of rows, one row per thread, and loops
//    over chunks of 256 rows when N exceeds the cluster's 4096 threads.
//    16 is above the portable cluster size of 8 (the kernel sets
//    cudaFuncAttributeNonPortableClusterSizeAllowed); on the H100 it ran
//    both kernels ~0.3 us faster than 8 blocks of 512 threads, since each SM
//    stages half the bytes and runs half the rows.
//  - Each chunk's contiguous (rows x A) slabs are staged into shared memory
//    by cp.async; a slab sits in shared memory at the same offset mod 16
//    bytes as in device memory, so the aligned middle goes in 16-byte copies
//    and any 4-byte aligned view is taken, its head and tail (at most 3
//    floats each) and the shared (A,) vectors in 4-byte copies. No thread
//    waits on a copy until all are issued; the (N,) arrays are read one
//    coalesced float per thread meanwhile. The backward stages its
//    (rows x A) outputs in shared memory too and stores them with 16-byte
//    stores.
//  - Sums are reduced in a fixed order with no float atomics: each thread
//    over its rows; shuffle trees of fixed shape within a warp (the five
//    channels interleaved), over the block's warps, and over the cluster's
//    blocks, whose partials lane r of block 0 reads from block r's shared
//    memory (distributed shared memory) between two cluster barriers. The
//    backward sums a shared log_std's gradient by columns of its staged
//    (rows x A) slab, one warp per column. The result is the same from run
//    to run, and nothing goes through global scratch.
//  - What this costs (chip_smoke.py --loss-sweep): an empty launch of a
//    cluster takes ~2 us against ~1 us for plain blocks, and the cluster
//    reduction ~1.4 us (the backward runs in ~3.4 us for a per-row log_std,
//    which needs no row sum, against ~4.8 us for a shared one).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // one row per thread per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;  // the whole grid: one cluster, twice the portable size
constexpr int kSums = 5;
constexpr int kSmemBudget = 224 * 1024;  // dynamic shared memory one block may take
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
  int ls_stride;   // A, or 0 when log_std is one (A,) vector
  int lso_stride;  // the same for log_std_old
};

// How a launch cuts the rows: each block takes rows_per_block contiguous
// rows in chunks of `chunk`; a staged slab takes `slab` floats of shared
// memory and a shared (A,) vector `vec`.
struct Plan {
  int rows_per_block;
  int chunk;
  int slab;
  int vec;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// Each v[k] summed over lanes [0, kWidth) of the warp in a fixed tree
// order; lane 0 holds the sums. The kN trees' shuffles interleave, so they
// cost the depth of one tree.
template <int kWidth, int kN>
__device__ __forceinline__ void lane_sums(float (&v)[kN]) {
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    for (int k = 0; k < kN; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
}

template <int kWidth>
__device__ __forceinline__ float lane_sum(float v) {
  float w[1] = {v};
  lane_sums<kWidth>(w);
  return w[0];
}

// Floats from `p` to the next 16-byte boundary's offset: where a slab for
// the device array at `p` starts in its shared region.
__device__ __forceinline__ int pad_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void copy_async(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

// Starts the copy of src[0, count) into region[pad_of(src) + j]; both sides
// then share their offset mod 16 bytes, so the aligned middle goes by
// 16-byte cp.async and the head and tail by 4-byte ones: no thread waits
// here. The caller waits (stage_wait).
__device__ void stage(float* region, const float* src, int count) {
  float* dst = region + pad_of(src);
  const int head = min(count, (4 - pad_of(src)) & 3);
  const int vecs = (count - head) >> 2;
  const int tail = head + 4 * vecs;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    copy_async(dst + head + 4 * v, src + head + 4 * v, 16);
  }
  const int t = threadIdx.x;
  const int j = t < head ? t : tail + t - head;
  if (j < count) copy_async(dst + j, src + j, 4);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Stores region[pad_of(dst) + j] to dst[0, count) with 16-byte stores for
// the aligned middle.
__device__ void unstage(float* dst, const float* region, int count) {
  const float* src = region + pad_of(dst);
  const int head = min(count, (4 - pad_of(dst)) & 3);
  const int vecs = (count - head) >> 2;
  const int tail = head + 4 * vecs;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const int j = head + 4 * v;
    *reinterpret_cast<float4*>(dst + j) = *reinterpret_cast<const float4*>(src + j);
  }
  const int t = threadIdx.x;
  const int j = t < head ? t : tail + t - head;
  if (j < count) dst[j] = src[j];
}

// Starts the copy of a shared (A,) vector (stride 0, on the first chunk) or
// of this chunk's slab of a per-row one; returns the row-0 offset into
// `region`.
__device__ int stage_rows_or_vector(float* region, const float* src, int stride, long off,
                                    int count, bool first_chunk, int a) {
  if (stride) {
    stage(region, src + off, count);
    return pad_of(src + off);
  }
  if (first_chunk) {
    for (int k = threadIdx.x; k < a; k += blockDim.x) copy_async(region + k, src + k, 4);
  }
  return 0;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    ppo_loss_fwd_kernel(Inputs in, Plan plan, float eps, float value_coef, float entropy_coef,
                        float* __restrict__ loss, float* __restrict__ metrics) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_part[kSums][kWarps];
  __shared__ float block_part[kSums];
  const int a = in.a, t = threadIdx.x;
  float* s_mean = reinterpret_cast<float*>(smem4);
  float* s_act = s_mean + plan.slab;
  float* s_mo = s_act + plan.slab;
  float* s_ls = s_mo + plan.slab;
  float* s_lso = s_ls + (in.ls_stride ? plan.slab : plan.vec);

  const int begin = min(in.n, static_cast<int>(blockIdx.x) * plan.rows_per_block);
  const int end = min(in.n, begin + plan.rows_per_block);
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int row0 = begin; row0 < end; row0 += plan.chunk) {
    const int rows = min(plan.chunk, end - row0);
    const long off = static_cast<long>(row0) * a;
    const int count = rows * a;
    stage(s_mean, in.mean + off, count);
    stage(s_act, in.action + off, count);
    stage(s_mo, in.mean_old + off, count);
    const bool first = row0 == begin;
    const int p_ls = stage_rows_or_vector(s_ls, in.log_std, in.ls_stride, off, count, first, a);
    const int p_lso =
        stage_rows_or_vector(s_lso, in.log_std_old, in.lso_stride, off, count, first, a);
    const bool valid = t < rows;
    const int i = row0 + t;
    float lp_old = 0.0f, adv = 0.0f, v = 0.0f, v_old = 0.0f, vt = 0.0f;
    if (valid) {
      lp_old = in.logp_old[i];
      adv = in.adv[i];
      v = in.value[i];
      v_old = in.v_old[i];
      vt = in.vtarg[i];
    }
    stage_wait();
    if (valid) {
      const float* m = s_mean + pad_of(in.mean + off) + t * a;
      const float* act = s_act + pad_of(in.action + off) + t * a;
      const float* mo = s_mo + pad_of(in.mean_old + off) + t * a;
      const float* ls = s_ls + p_ls + (in.ls_stride ? t * a : 0);
      const float* lso = s_lso + p_lso + (in.lso_stride ? t * a : 0);
      float quad = 0.0f, ent = 0.0f, kl = 0.0f;
      for (int k = 0; k < a; ++k) {
        const float inv_std = expf(-ls[k]);
        const float z = (act[k] - m[k]) * inv_std;
        quad += z * z + 2.0f * ls[k] + kLog2Pi;
        ent += ls[k] + 0.5f * (kLog2Pi + 1.0f);
        const float var_ratio = expf(2.0f * (lso[k] - ls[k]));
        const float dmu = (mo[k] - m[k]) * inv_std;
        kl += ls[k] - lso[k] + 0.5f * (var_ratio + dmu * dmu - 1.0f);
      }
      const float ratio = expf(clampf(-0.5f * quad - lp_old, -20.0f, 20.0f));
      const float r_clip = clampf(ratio, 1.0f - eps, 1.0f + eps);
      acc[0] += min_nan(ratio * adv, r_clip * adv);
      const float v_cl = v_old + clampf(v - v_old, -eps, eps);
      const float e1 = (v - vt) * (v - vt), e2 = (v_cl - vt) * (v_cl - vt);
      acc[1] += 0.5f * max_nan(e1, e2);
      acc[2] += ent;
      acc[3] += kl;
      acc[4] += fabsf(ratio - 1.0f) > eps ? 1.0f : 0.0f;
    }
    __syncthreads();  // the next chunk overwrites the slabs
  }

  // threads -> warps -> the block's 5 partials -> block 0 over the cluster
  const int lane = t & 31, warp = t >> 5;
  lane_sums<32>(acc);
  if (lane == 0) {
    for (int k = 0; k < kSums; ++k) warp_part[k][warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    float part[kSums];
    for (int k = 0; k < kSums; ++k) part[k] = lane < kWarps ? warp_part[k][lane] : 0.0f;
    lane_sums<kWarps>(part);
    if (lane == 0) {
      for (int k = 0; k < kSums; ++k) block_part[k] = part[k];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && warp == 0) {
    // lane r reads block r's partials; the tree sums them in a fixed order
    float s[kSums];
    const float* part = cluster.map_shared_rank(block_part, lane < kCluster ? lane : 0);
    for (int k = 0; k < kSums; ++k) s[k] = lane < kCluster ? part[k] : 0.0f;
    lane_sums<kCluster>(s);
    if (lane == 0) {
      const float n = static_cast<float>(in.n);
      for (int k = 0; k < kSums; ++k) s[k] = s[k] / n;
      // (-s0 + value_coef*s1) - entropy_coef*s2, rounded step by step
      *loss = __fsub_rn(__fadd_rn(-s[0], __fmul_rn(value_coef, s[1])),
                        __fmul_rn(entropy_coef, s[2]));
      metrics[0] = -s[0];
      for (int k = 1; k < kSums; ++k) metrics[k] = s[k];
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    ppo_loss_bwd_kernel(Inputs in, Plan plan, const float* __restrict__ g_loss, float eps,
                        float value_coef, float entropy_coef, float inv_n,
                        float* __restrict__ dmean, float* __restrict__ dls,
                        float* __restrict__ dv) {
  extern __shared__ float4 smem4[];
  const int a = in.a, t = threadIdx.x;
  const bool shared_ls = in.ls_stride == 0;
  float* s_mean = reinterpret_cast<float*>(smem4);
  float* s_act = s_mean + plan.slab;
  float* s_dmean = s_act + plan.slab;
  float* s_dls = s_dmean + plan.slab;  // g*dls per row
  float* s_ls = s_dls + plan.slab;
  float* col_part = s_ls + (shared_ls ? plan.vec : plan.slab);  // the block's (A,) sums
  for (int k = t; k < a; k += blockDim.x) col_part[k] = 0.0f;

  const float g = *g_loss;
  const float ent_term = entropy_coef * inv_n;
  const int begin = min(in.n, static_cast<int>(blockIdx.x) * plan.rows_per_block);
  const int end = min(in.n, begin + plan.rows_per_block);
  const int lane = t & 31, warp = t >> 5;
  for (int row0 = begin; row0 < end; row0 += plan.chunk) {
    const int rows = min(plan.chunk, end - row0);
    const long off = static_cast<long>(row0) * a;
    const int count = rows * a;
    stage(s_mean, in.mean + off, count);
    stage(s_act, in.action + off, count);
    const int p_ls =
        stage_rows_or_vector(s_ls, in.log_std, in.ls_stride, off, count, row0 == begin, a);
    const bool valid = t < rows;
    const int i = row0 + t;
    float lp_old = 0.0f, adv = 0.0f, v = 0.0f, v_old = 0.0f, vt = 0.0f;
    if (valid) {
      lp_old = in.logp_old[i];
      adv = in.adv[i];
      v = in.value[i];
      v_old = in.v_old[i];
      vt = in.vtarg[i];
    }
    stage_wait();
    // the dls slab sits at dls's offset mod 16 when written out row by row
    const int p_dls = shared_ls ? 0 : pad_of(dls + off);
    if (valid) {
      const float* m = s_mean + pad_of(in.mean + off) + t * a;
      const float* act = s_act + pad_of(in.action + off) + t * a;
      const float* ls = s_ls + p_ls + (shared_ls ? 0 : t * a);
      float* dm = s_dmean + pad_of(dmean + off) + t * a;
      float* dl = s_dls + p_dls + t * a;
      float quad = 0.0f;
      for (int k = 0; k < a; ++k) {
        const float z = (act[k] - m[k]) * expf(-ls[k]);
        quad += z * z + 2.0f * ls[k] + kLog2Pi;
      }
      const float x = -0.5f * quad - lp_old;
      const float ratio = expf(clampf(x, -20.0f, 20.0f));
      const float in_band_lr = fabsf(x) < 20.0f ? 1.0f : 0.0f;  // the clamp passes no gradient
      const float r_clip = clampf(ratio, 1.0f - eps, 1.0f + eps);
      const float use_unclipped = ratio * adv <= r_clip * adv ? 1.0f : 0.0f;
      const float g_logp = -inv_n * (use_unclipped * ratio * adv * in_band_lr);
      for (int k = 0; k < a; ++k) {
        const float inv_std = expf(-ls[k]);
        const float z = (act[k] - m[k]) * inv_std;
        dm[k] = g * (g_logp * z * inv_std);
        dl[k] = g * (g_logp * (z * z - 1.0f) - ent_term);
      }

      const float dvv = v - v_old;
      const float v_cl = v_old + clampf(dvv, -eps, eps);
      const float e1 = (v - vt) * (v - vt), e2 = (v_cl - vt) * (v_cl - vt);
      const float use_raw = e1 >= e2 ? 1.0f : 0.0f;
      const float in_band = fabsf(dvv) < eps ? 1.0f : 0.0f;
      const float dvloss = use_raw * (v - vt) + (1.0f - use_raw) * (v_cl - vt) * in_band;
      dv[i] = g * ((value_coef * inv_n) * dvloss);
    }
    __syncthreads();
    unstage(dmean + off, s_dmean, count);
    if (shared_ls) {
      // warp w sums columns w, w + kWarps, ...: lane l its rows l, l + 32, ...
      for (int k = warp; k < a; k += kWarps) {
        float s = 0.0f;
        for (int r = lane; r < rows; r += 32) s += s_dls[r * a + k];
        s = lane_sum<32>(s);
        if (lane == 0) col_part[k] += s;
      }
    } else {
      unstage(dls + off, s_dls, count);
    }
    __syncthreads();  // the next chunk overwrites the slabs
  }
  if (!shared_ls) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    // warp w sums columns w, w + kWarps, ... over the blocks: lane r reads
    // block r's sum, and the tree adds them in rank order
    for (int k = warp; k < a; k += kWarps) {
      const float s = lane < kCluster ? cluster.map_shared_rank(col_part, lane)[k] : 0.0f;
      const float total = lane_sum<kCluster>(s);
      if (lane == 0) dls[k] = total;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

int round4(int x) { return (x + 3) & ~3; }

// The plan for n rows of a action dims with `slabs` staged (rows x A) slabs,
// `vecs` shared (A,) vectors and `extra` more floats of shared memory; the
// chunk shrinks below kThreads rows only when A is too wide for a full one.
// Returns false when not even one row fits.
bool make_plan(int n, int a, int slabs, int vecs, int extra, Plan* plan, int* smem_bytes) {
  const int per_block = (n + kCluster - 1) / kCluster;
  plan->rows_per_block = round4(per_block);  // chunks then start 16-byte aligned
  plan->vec = round4(a);
  for (int chunk = kThreads; chunk > 0; chunk -= chunk > 32 ? 32 : 1) {
    plan->chunk = chunk;
    plan->slab = round4(chunk * a + 3);
    const long bytes = 4L * (static_cast<long>(slabs) * plan->slab +
                             static_cast<long>(vecs) * plan->vec + extra);
    if (bytes <= kSmemBudget) {
      *smem_bytes = static_cast<int>(bytes);
      return true;
    }
  }
  return false;
}

// Lets a kernel launch as a cluster of kCluster blocks and take up to
// kSmemBudget of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t configure(Kernel kernel, unsigned long long* done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done_mask & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  }
  if (err == cudaSuccess) *done_mask |= bit;
  return err;
}

unsigned long long fwd_configured = 0, bwd_configured = 0;

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// loss: () and metrics: (5,) [-surr, vloss, entropy, kl, clip_frac] means.
int ppo_loss_fwd(const float* mean, const float* log_std, const float* value,
                 const float* action, const float* logp_old, const float* mean_old,
                 const float* log_std_old, const float* adv, const float* vtarg,
                 const float* v_old, int n, int a, int ls_stride, int lso_stride, float eps,
                 float value_coef, float entropy_coef, float* loss, float* metrics,
                 cudaStream_t stream) {
  const Inputs in{mean, log_std, value, action, logp_old, mean_old, log_std_old,
                  adv,  vtarg,   v_old, n,      a,        ls_stride, lso_stride};
  const int per_row = (ls_stride ? 1 : 0) + (lso_stride ? 1 : 0);
  Plan plan;
  int smem = 0;
  if (!make_plan(n, a, 3 + per_row, 2 - per_row, 0, &plan, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure(ppo_loss_fwd_kernel, &fwd_configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_loss_fwd_kernel<<<kCluster, kThreads, smem, stream>>>(in, plan, eps, value_coef,
                                                            entropy_coef, loss, metrics);
  return static_cast<int>(cudaGetLastError());
}

// g_loss: the loss's cotangent (one float on the device). dmean (N, A),
// dv (N,), and dls (A,) when ls_stride is 0 (summed over rows) else (N, A).
int ppo_loss_bwd(const float* mean, const float* log_std, const float* value,
                 const float* action, const float* logp_old, const float* adv,
                 const float* vtarg, const float* v_old, const float* g_loss, int n, int a,
                 int ls_stride, float eps, float value_coef, float entropy_coef, float inv_n,
                 float* dmean, float* dls, float* dv, cudaStream_t stream) {
  const Inputs in{mean, log_std, value, action, logp_old, nullptr, nullptr,
                  adv,  vtarg,   v_old, n,      a,        ls_stride, 0};
  Plan plan;
  int smem = 0;
  // mean, action, dmean, dls and log_std per row, or the shared log_std
  // vector; the block's (A,) sums
  const int per_row = ls_stride ? 1 : 0;
  if (!make_plan(n, a, 4 + per_row, 2 - per_row, 0, &plan, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure(ppo_loss_bwd_kernel, &bwd_configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_loss_bwd_kernel<<<kCluster, kThreads, smem, stream>>>(
      in, plan, g_loss, eps, value_coef, entropy_coef, inv_n, dmean, dls, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
