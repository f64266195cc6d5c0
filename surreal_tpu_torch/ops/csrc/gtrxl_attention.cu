// Transformer-XL relative-position attention of the GTrXL's segment pass
// (models/gtrxl.py::GTrXL.segment), forward and backward, one launch each,
// float32 on the CUDA cores (the configuration runs float32 with TF32 off).
//
// Replaces no TPU kernel: the JAX package has no GTrXL. It replaces the
// torch ops of `ops/gtrxl_attention_kernel.py::attention_plain` (content and
// relative einsums, a gather, a masked softmax and the weighted values, and
// autograd's reverse of each), which write scores of shape (B, H, T, m + T)
// about fourteen times each way. Here the scores, the relative term, the
// mask and the probabilities live in registers and shared memory only.
//
// Per (b, h), with the memory's keys taken in distance order (key n < m is
// ring slot (p + n) mod m, p = t0 mod m; key n >= m is the chunk's step
// n - m), a query i and a key n lie dist = m + i - n apart, and
//   S[i, n] = ((qu_i . k_n) + (qv_i . pos[m + i - n])) * scale
//   visible iff i <= n <= m + i and kep[n] == ep[i]
// ep[i] the query's episode counted from the chunk's start, kep[n] the
// key's: 0 for a valid memory slot, -1 for an empty one, ep[n - m] for the
// chunk's own. Every query sees its own key (n = m + i), so no row is empty.
// The forward writes softmax(S) v and each row's log-sum-exp; the backward
// recomputes P from it and writes dqu, dqv, dk and dv (every key, the
// memory's too, in the callers' storage order) and dpos, summed over b.
//
// Bound on the H100: float32 operations. At the GTrXL cell's (B, H, T, m,
// d) = (128, 8, 128, 512, 32) a layer's forward is ~15 GFLOP against ~0.22
// GB moved, the backward ~30 GFLOP against ~0.44 GB (0.22 and 0.45 ms at 67
// TFLOP/s; benchmark/metrics/gtrxl_segment_attention_roofline.py). So the
// design keeps every product register-tiled from shared memory and every
// intermediate on chip:
//  - A block of 256 threads works on 64 x 64 (query, key) tiles. Thread
//    (ty, tx) of a 16 x 16 grid holds the scores of queries ty + 16a and
//    keys tx + 16c (a, c < 4). The relative term is Toeplitz: the position
//    row of (i, n) is the band row i - n + 63, so the thread's 16 scores need
//    4 rows of qv and 7 rows of the band, as the content needs 4 of qu and 4
//    of k. Tiles are row-major in shared memory, 36 floats a row (no bank
//    conflict for 16 consecutive rows read as float4).
//  - Tiles whose every pair is masked are skipped: outside the window, the
//    memory's keys for queries past an episode start, the chunk's keys of
//    episodes the queries have left (ep is non-decreasing).
//  - Forward: a block per (b, h, 64 queries), an online softmax over the key
//    tiles in float32, P through shared memory into the weighted values.
//  - Backward: a block per (b, h) over every (key tile, query tile); dk and
//    dv of the key tile sum in registers over the query tiles. G = P (dP - D)
//    scale is stored once by diagonal (GdT[i][i - n + 63]), from which dk,
//    dqu (Toeplitz in k), dqv and dpos (plain products over the band) read.
//    dqu and dqv of the (b, h) sum in place in the outputs, and dpos in a
//    (b, h) slice of a workspace, each element by one thread or between
//    barriers in a fixed order.
//  - dpos sums over b in two fixed-order levels in the same launch: the
//    last block of each group of 16 sequences (by an integer counter) sums
//    the group's slices, the last group of a head the groups'. No float
//    atomics anywhere: two launches give the same bits.
//  - D = dout . out is computed once a block; the read-modify-writes of dq
//    and dpos load their old sums before the products that add to them.
// exp is expf; the scores add the content and relative sums in one
// accumulator, in another order than torch's einsums: on the H100, at most
// 6e-7 of each output's largest element, 3.2e-6 for dpos, which sums
// 128 x 128 x 640 terms (tests/test_torch_gtrxl_attention.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 32;              // head width the kernels are built for
constexpr int kTQ = 64;             // queries a tile
constexpr int kTK = 64;             // keys a tile
constexpr int kThreads = 256;       // a 16 x 16 grid
constexpr int kLD = kD + 4;         // row stride of the [row][d] tiles
constexpr int kBand = kTQ + kTK - 1;  // position rows a tile reads (127)
constexpr int kLP = kTQ + 4;        // forward P: [n][4 (i % 16) + i / 16]
constexpr int kLG = 128;            // backward G by diagonal: [i][i - n + 63]
constexpr int kGroup = 16;          // sequences a first-level dpos partial sums

struct Args {
  const float* qu;     // (B, T, H, D)
  const float* qv;     // (B, T, H, D)
  const float* k;      // (B, J, H, D) at strides (kb, kr, D, 1)
  const float* v;      // the same strides as k
  const float* pos;    // (m + 1, H, D)
  const int* ep;       // (B, T) the queries' episodes, non-decreasing in t
  const uint8_t* valid;  // (B, m) ring slots of the chunk-start episode
  int B, T, H, m, p;
  long long kb, kr;
  float scale;
};

constexpr int kFwdFloats = 2 * kTQ * kLD + 2 * kTK * kLD + kBand * kLD + kTK * kLP + kTK;
constexpr int kBwdFloats =
    3 * kTQ * kLD + 2 * kTK * kLD + kBand * kLD + kTQ * kTK + kTQ * kLG + 4 * kTQ;
constexpr int kFwdSmem = kFwdFloats * 4;
constexpr int kBwdSmem = kBwdFloats * 4;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float fma4(const float4 a, const float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

__device__ __forceinline__ float comp(const float4 v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// The ring slot (or chunk row) of the key at distance order n.
__device__ __forceinline__ int key_row(const Args& a, int n) {
  if (n >= a.m) return n;
  const int r = a.p + n;
  return r >= a.m ? r - a.m : r;
}

// False where every (query, key) pair of the tile is masked: outside the
// window, memory keys all empty or seen by no query of episode 0, the
// chunk's keys all of episodes before the tile's first query's. Called by
// every thread of the block; the same answer in each.
__device__ bool tile_live(const Args& a, int b, int i0, int n0, int tid) {
  const int J = a.m + a.T;
  const int i1 = min(i0 + kTQ, a.T) - 1;
  const int n1 = min(n0 + kTK, J) - 1;
  if (n1 < i0 || n0 > a.m + i1) return false;
  const int* ep = a.ep + static_cast<long long>(b) * a.T;
  const int first = ep[i0];
  if (n0 >= a.m) return ep[n1 - a.m] >= first;
  if (n1 >= a.m) return true;
  if (first != 0) return false;
  const int n = n0 + tid;
  const bool seen =
      tid < kTK && n <= n1 && a.valid[static_cast<long long>(b) * a.m + key_row(a, n)];
  return __syncthreads_or(seen) != 0;
}

// 64 rows of D floats from `src` (row stride `stride` floats) into a
// [row][kLD] tile; rows at and past `rows` are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int rows, int tid) {
  for (int c = tid; c < 64 * (kD / 4); c += kThreads) {
    const int r = c / (kD / 4), q = c % (kD / 4);
    const bool ok = r < rows;
    cp16(dst + r * kLD + 4 * q, ok ? src + r * stride + 4 * q : src, ok);
  }
}

// The key tile's keys and values (distance order n0.., zero past J) and
// each key's episode (-3 past J, which no query has).
__device__ __forceinline__ void load_keys(const Args& a, int b, int h, int n0, float* Ks,
                                          float* Vs, int* kep, int tid) {
  const int J = a.m + a.T;
  for (int c = tid; c < kTK * (kD / 4); c += kThreads) {
    const int r = c / (kD / 4), q = c % (kD / 4);
    const int n = n0 + r;
    const bool ok = n < J;
    const long long off =
        ok ? b * a.kb + key_row(a, n) * a.kr + static_cast<long long>(h) * kD + 4 * q : 0;
    cp16(Ks + r * kLD + 4 * q, a.k + off, ok);
    cp16(Vs + r * kLD + 4 * q, a.v + off, ok);
  }
  if (tid < kTK) {
    const int n = n0 + tid;
    int e = -3;
    if (n < a.m)
      e = a.valid[static_cast<long long>(b) * a.m + key_row(a, n)] ? 0 : -1;
    else if (n < J)
      e = a.ep[static_cast<long long>(b) * a.T + n - a.m];
    kep[tid] = e;
  }
}

// The tile's band of projected positions: band row r' holds pos[R0 - 63 +
// r'], R0 = m + i0 - n0, zero outside 0..m.
__device__ __forceinline__ void load_band(const Args& a, int h, int i0, int n0, float* Pb,
                                          int tid) {
  const int lo = a.m + i0 - n0 - (kTK - 1);
  for (int c = tid; c < kBand * (kD / 4); c += kThreads) {
    const int r = c / (kD / 4), q = c % (kD / 4);
    const int row = lo + r;
    const bool ok = row >= 0 && row <= a.m;
    const float* src = ok ? a.pos + (static_cast<long long>(row) * a.H + h) * kD + 4 * q : a.pos;
    cp16(Pb + r * kLD + 4 * q, src, ok);
  }
}

// The unscaled scores of thread (ty, tx): s[a][c] for query ty + 16a and key
// tx + 16c of the tile, content then relative term into one sum.
__device__ __forceinline__ void scores(const float* Qu, const float* Qv, const float* Ks,
                                       const float* Pb, int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) s[x][y] = 0.0f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      qa[x] = *reinterpret_cast<const float4*>(Qu + (ty + 16 * x) * kLD + d);
#pragma unroll
    for (int y = 0; y < 4; ++y)
      kb[y] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * y) * kLD + d);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] = fma4(qa[x], kb[y], s[x][y]);
  }
  const int rb = ty - tx + kTK - 1;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 qa[4], pr[7];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      qa[x] = *reinterpret_cast<const float4*>(Qv + (ty + 16 * x) * kLD + d);
#pragma unroll
    for (int j = 0; j < 7; ++j)
      pr[j] = *reinterpret_cast<const float4*>(Pb + (rb + 16 * (j - 3)) * kLD + d);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] = fma4(qa[x], pr[x - y + 3], s[x][y]);
  }
}

// Queries past T carry episode -2, which no key has.
__device__ __forceinline__ bool visible(const Args& a, int i, int n, int qe, int ke) {
  return n >= i && n <= a.m + i && ke == qe;
}

__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(const Args a, float* __restrict__ out,
                                                       float* __restrict__ lse) {
  extern __shared__ float4 smem4[];
  float* Qu = reinterpret_cast<float*>(smem4);
  float* Qv = Qu + kTQ * kLD;
  float* Ks = Qv + kTQ * kLD;
  float* Vs = Ks + kTK * kLD;
  float* Pb = Vs + kTK * kLD;
  float* Pt = Pb + kBand * kLD;
  int* kep = reinterpret_cast<int*>(Pt + kTK * kLP);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nqt = (a.T + kTQ - 1) / kTQ;
  const int qt = blockIdx.x % nqt, bh = blockIdx.x / nqt;
  const int h = bh % a.H, b = bh / a.H;
  const int i0 = qt * kTQ, J = a.m + a.T;
  const long long HD = static_cast<long long>(a.H) * kD;
  const long long qoff = (static_cast<long long>(b) * a.T + i0) * HD + h * kD;
  load_rows(Qu, a.qu + qoff, HD, a.T - i0, tid);
  load_rows(Qv, a.qv + qoff, HD, a.T - i0, tid);

  int qe[4];
  float mrun[4], lrun[4], o[4][2];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = i0 + ty + 16 * x;
    qe[x] = i < a.T ? a.ep[static_cast<long long>(b) * a.T + i] : -2;
    mrun[x] = neg_inf();
    lrun[x] = 0.0f;
    o[x][0] = o[x][1] = 0.0f;
  }

  const int nkt = (J + kTK - 1) / kTK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int n0 = kt * kTK;
    if (!tile_live(a, b, i0, n0, tid)) continue;
    __syncthreads();  // the last tile's reads are done
    load_keys(a, b, h, n0, Ks, Vs, kep, tid);
    load_band(a, h, i0, n0, Pb, tid);
    cp_wait();
    __syncthreads();

    float s[4][4];
    scores(Qu, Qv, Ks, Pb, ty, tx, s);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + ty + 16 * x;
      float mx = neg_inf();
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int n = n0 + tx + 16 * y;
        s[x][y] = visible(a, i, n, qe[x], kep[tx + 16 * y]) ? s[x][y] * a.scale : neg_inf();
        mx = fmaxf(mx, s[x][y]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mnew = fmaxf(mrun[x], mx);
      const float mref = mnew == neg_inf() ? 0.0f : mnew;
      const float alpha = expf(mrun[x] - mref);
      float sum = 0.0f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        s[x][y] = expf(s[x][y] - mref);
        sum += s[x][y];
      }
      lrun[x] = fmaf(lrun[x], alpha, sum);
      o[x][0] *= alpha;
      o[x][1] *= alpha;
      mrun[x] = mnew;
    }
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * y) * kLP + 4 * ty) =
          make_float4(s[0][y], s[1][y], s[2][y], s[3][y]);
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kTK; ++n) {
      const float4 pp = *reinterpret_cast<const float4*>(Pt + n * kLP + 4 * ty);
      const float2 v2 = *reinterpret_cast<const float2*>(Vs + n * kLD + 2 * tx);
      const float v0 = v2.x, v1 = v2.y;
      o[0][0] = fmaf(pp.x, v0, o[0][0]);
      o[0][1] = fmaf(pp.x, v1, o[0][1]);
      o[1][0] = fmaf(pp.y, v0, o[1][0]);
      o[1][1] = fmaf(pp.y, v1, o[1][1]);
      o[2][0] = fmaf(pp.z, v0, o[2][0]);
      o[2][1] = fmaf(pp.z, v1, o[2][1]);
      o[3][0] = fmaf(pp.w, v0, o[3][0]);
      o[3][1] = fmaf(pp.w, v1, o[3][1]);
    }
  }

#pragma unroll
  for (int x = 0; x < 4; ++x) {
    float l = lrun[x];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    const int i = i0 + ty + 16 * x;
    if (i < a.T) {
      float* row = out + (static_cast<long long>(b) * a.T + i) * HD + h * kD;
      *reinterpret_cast<float2*>(row + 2 * tx) = make_float2(o[x][0] / l, o[x][1] / l);
      if (tx == 0) lse[(static_cast<long long>(b) * a.H + h) * a.T + i] = mrun[x] + logf(l);
    }
  }
}

struct Grads {
  const float* out;   // (B, T, H, D) the forward's output
  const float* lse;   // (B, H, T)
  const float* dout;  // (B, T, H, D)
  float* dqu;         // (B, T, H, D)
  float* dqv;
  float* dk;          // (B, J, H, D), storage order
  float* dv;
  float* dd;          // (B, H, T): D = dout . out, by the block of (b, h)
  float* ws;          // (B, H, m + 1, D): a sequence's dpos
  float* gws;         // (groups, H, m + 1, D): a group's
  int* count;         // (H * groups + H), zero at the launch
  float* dpos;        // (m + 1, H, D)
};

// Sums `n` slices of `len` floats, `stride` apart, in order into `dst`,
// whose rows of D floats lie `dst_row` floats apart.
__device__ void sum_slices(float* dst, long long dst_row, const float* src, int n,
                           long long stride, int len, int tid) {
  for (int e = 4 * tid; e < len; e += 4 * kThreads) {
    float4 acc = __ldcg(reinterpret_cast<const float4*>(src + e));
    for (int j = 1; j < n; ++j) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(src + j * stride + e));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(dst + (e / kD) * dst_row + e % kD) = acc;
  }
}

__global__ void __launch_bounds__(kThreads, 2) bwd_kernel(const Args a, const Grads g) {
  extern __shared__ float4 smem4[];
  float* Qu = reinterpret_cast<float*>(smem4);
  float* Qv = Qu + kTQ * kLD;
  float* dO = Qv + kTQ * kLD;
  float* Ks = dO + kTQ * kLD;
  float* Vs = Ks + kTK * kLD;
  float* Pb = Vs + kTK * kLD;
  float* Pt = Pb + kBand * kLD;  // P: [i][2 (n % 32) + n / 32]
  float* Gd = Pt + kTQ * kTK;    // G: [i][i - n + 63]
  float* lse_s = Gd + kTQ * kLG;
  float* D_s = lse_s + kTQ;
  int* qep = reinterpret_cast<int*>(D_s + kTQ);
  int* kep = qep + kTQ;
  __shared__ int last;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x % a.B, h = blockIdx.x / a.B;
  const int J = a.m + a.T, M1 = a.m + 1;
  const long long HD = static_cast<long long>(a.H) * kD;
  const long long slice = static_cast<long long>(M1) * kD;
  float* ws = g.ws + (static_cast<long long>(b) * a.H + h) * slice;

  for (int e = tid; e < kTQ * kLG; e += kThreads) Gd[e] = 0.0f;
  for (int e = 4 * tid; e < slice; e += 4 * kThreads)
    *reinterpret_cast<float4*>(ws + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = tid; e < a.T * (kD / 2); e += kThreads) {
    const long long off = (static_cast<long long>(b) * a.T + e / (kD / 2)) * HD + h * kD +
                          2 * (e % (kD / 2));
    *reinterpret_cast<float2*>(g.dqu + off) = make_float2(0.0f, 0.0f);
    *reinterpret_cast<float2*>(g.dqv + off) = make_float2(0.0f, 0.0f);
  }

  float* dd = g.dd + (static_cast<long long>(b) * a.H + h) * a.T;
  for (int r = tid >> 2; r < ((a.T + 63) & ~63); r += kThreads / 4) {  // D, four threads a row
    const int part = tid & 3;
    float acc = 0.0f;
    if (r < a.T) {
      const long long off = (static_cast<long long>(b) * a.T + r) * HD + h * kD + 8 * part;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(g.dout + off + e);
        const float4 y = *reinterpret_cast<const float4*>(g.out + off + e);
        acc = fma4(x, y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && r < a.T) dd[r] = acc;
  }

  // the roles of the threads in the products after the scores
  const int c32 = tid >> 3, e8 = tid & 7;     // dk, dv: keys c, c + 32; d 4e..4e+3
  const int iy = tid >> 4, dx = tid & 15;     // dq: queries 4iy..4iy+3; d 2dx, 2dx+1
  const int rp = tid >> 4;                    // dpos: band rows 4rp.. and 4 (rp + 16)..; d 2dx..

  const int nkt = (J + kTK - 1) / kTK, nqt = (a.T + kTQ - 1) / kTQ;
  for (int kt = 0; kt < nkt; ++kt) {
    const int n0 = kt * kTK;
    cp_wait();
    __syncthreads();  // the last key tile's reads are done
    load_keys(a, b, h, n0, Ks, Vs, kep, tid);
    float dk[2][4], dv[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * kTQ;
      if (!tile_live(a, b, i0, n0, tid)) continue;
      __syncthreads();  // the last tile's reads are done
      const int rows = a.T - i0;
      const long long qoff = (static_cast<long long>(b) * a.T + i0) * HD + h * kD;
      load_rows(Qu, a.qu + qoff, HD, rows, tid);
      load_rows(Qv, a.qv + qoff, HD, rows, tid);
      load_rows(dO, g.dout + qoff, HD, rows, tid);
      load_band(a, h, i0, n0, Pb, tid);
      if (tid < kTQ) {
        const int i = i0 + tid;
        lse_s[tid] = i < a.T ? g.lse[(static_cast<long long>(b) * a.H + h) * a.T + i] : 0.0f;
        D_s[tid] = i < a.T ? dd[i] : 0.0f;
        qep[tid] = i < a.T ? a.ep[static_cast<long long>(b) * a.T + i] : -2;
      }
      cp_wait();
      __syncthreads();
      float s[4][4], gr[4][4];
      scores(Qu, Qv, Ks, Pb, ty, tx, s);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int il = ty + 16 * x;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int nl = tx + 16 * y;
          s[x][y] = visible(a, i0 + il, n0 + nl, qep[il], kep[nl])
                        ? expf(fmaf(s[x][y], a.scale, -lse_s[il]))
                        : 0.0f;
          gr[x][y] = 0.0f;
        }
      }
#pragma unroll
      for (int d = 0; d < kD; d += 4) {  // dP = dout v^T
        float4 oa[4], vb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          oa[x] = *reinterpret_cast<const float4*>(dO + (ty + 16 * x) * kLD + d);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          vb[y] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * y) * kLD + d);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) gr[x][y] = fma4(oa[x], vb[y], gr[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int il = ty + 16 * x;
        const float Di = D_s[il];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          gr[x][y] = s[x][y] * (gr[x][y] - Di) * a.scale;
          Gd[il * kLG + il - (tx + 16 * y) + kTK - 1] = gr[x][y];
        }
        // keys tx, tx + 16, tx + 32, tx + 48 at 2tx, 2tx + 32, 2tx + 1, 2tx + 33
        *reinterpret_cast<float2*>(Pt + il * kTK + 2 * tx) = make_float2(s[x][0], s[x][2]);
        *reinterpret_cast<float2*>(Pt + il * kTK + 2 * tx + 32) = make_float2(s[x][1], s[x][3]);
      }
      __syncthreads();

      const int ilim = min(kTQ, rows);
      // dv += P^T dout, dk += G^T qu: keys c32, c32 + 32
      for (int i = 0; i < ilim; ++i) {
        const float2 pp = *reinterpret_cast<const float2*>(Pt + i * kTK + 2 * c32);
        const float4 o4 = *reinterpret_cast<const float4*>(dO + i * kLD + 4 * e8);
        const float g0 = Gd[i * kLG + i - c32 + kTK - 1];
        const float g1 = Gd[i * kLG + i - c32 - 32 + kTK - 1];
        const float4 q4 = *reinterpret_cast<const float4*>(Qu + i * kLD + 4 * e8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[0][e] = fmaf(pp.x, comp(o4, e), dv[0][e]);
          dv[1][e] = fmaf(pp.y, comp(o4, e), dv[1][e]);
          dk[0][e] = fmaf(g0, comp(q4, e), dk[0][e]);
          dk[1][e] = fmaf(g1, comp(q4, e), dk[1][e]);
        }
      }

      {  // dqu += G k, dqv += G pos over the band, queries 4iy + x
        float aq[4][2], av[4][2];
        float2 oq[4], ov[4];  // the sums so far, loaded before the products
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          aq[x][0] = aq[x][1] = av[x][0] = av[x][1] = 0.0f;
          const int i = i0 + 4 * iy + x;
          if (i < a.T) {
            const long long off = (static_cast<long long>(b) * a.T + i) * HD + h * kD + 2 * dx;
            oq[x] = *reinterpret_cast<const float2*>(g.dqu + off);
            ov[x] = *reinterpret_cast<const float2*>(g.dqv + off);
          }
        }
        if (4 * iy < rows) {
          for (int g4 = 0; g4 < 17; ++g4) {
            const int r0 = 4 * iy + 4 * g4;  // band rows r0 + c
            float4 G4[4];
#pragma unroll
            for (int x = 0; x < 4; ++x)
              G4[x] = *reinterpret_cast<const float4*>(Gd + (4 * iy + x) * kLG + r0);
            float2 P2[4], K2[7];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              P2[c] = *reinterpret_cast<const float2*>(Pb + min(r0 + c, kBand - 1) * kLD + 2 * dx);
#pragma unroll
            for (int j = 0; j < 7; ++j) {  // key 63 - 4 g4 + (x - c), zero G outside
              const int n = min(max(kTK - 1 - 4 * g4 + j - 3, 0), kTK - 1);
              K2[j] = *reinterpret_cast<const float2*>(Ks + n * kLD + 2 * dx);
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float gv = comp(G4[x], c);
                av[x][0] = fmaf(gv, P2[c].x, av[x][0]);
                av[x][1] = fmaf(gv, P2[c].y, av[x][1]);
                aq[x][0] = fmaf(gv, K2[x - c + 3].x, aq[x][0]);
                aq[x][1] = fmaf(gv, K2[x - c + 3].y, aq[x][1]);
              }
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = i0 + 4 * iy + x;
          if (i < a.T) {
            const long long off = (static_cast<long long>(b) * a.T + i) * HD + h * kD + 2 * dx;
            *reinterpret_cast<float2*>(g.dqu + off) =
                make_float2(oq[x].x + aq[x][0], oq[x].y + aq[x][1]);
            *reinterpret_cast<float2*>(g.dqv + off) =
                make_float2(ov[x].x + av[x][0], ov[x].y + av[x][1]);
          }
        }
      }

      // dpos over the band += G^T qv: band rows 4ry..4ry+3 for ry = rp and rp + 16
      // (4 rp + 4 and 63 - 4 rp queries: 67 together), d 2dx, 2dx + 1
      const int lo = a.m + i0 - n0 - (kTK - 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ry = rp + 16 * half;
        float ap[4][2];
        float2 ow[4];  // the sums so far
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ap[r][0] = ap[r][1] = 0.0f;
          const int row = lo + 4 * ry + r;
          if (4 * ry + r < kBand && row >= 0 && row <= a.m)
            ow[r] = *reinterpret_cast<const float2*>(ws + static_cast<long long>(row) * kD + 2 * dx);
        }
        const int ilo = max(0, 4 * ry - (kTK - 1)), ihi = min(ilim - 1, 4 * ry + 3);
        for (int i = ilo; i <= ihi; ++i) {
          const float4 gv = *reinterpret_cast<const float4*>(Gd + i * kLG + 4 * ry);
          const float2 q2 = *reinterpret_cast<const float2*>(Qv + i * kLD + 2 * dx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ap[r][0] = fmaf(comp(gv, r), q2.x, ap[r][0]);
            ap[r][1] = fmaf(comp(gv, r), q2.y, ap[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = lo + 4 * ry + r;
          if (4 * ry + r < kBand && row >= 0 && row <= a.m)
            *reinterpret_cast<float2*>(ws + static_cast<long long>(row) * kD + 2 * dx) =
                make_float2(ow[r].x + ap[r][0], ow[r].y + ap[r][1]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + c32 + 32 * j;
      if (n < J) {
        const long long off =
            (static_cast<long long>(b) * J + key_row(a, n)) * HD + h * kD + 4 * e8;
        *reinterpret_cast<float4*>(g.dk + off) = make_float4(dk[j][0], dk[j][1], dk[j][2], dk[j][3]);
        *reinterpret_cast<float4*>(g.dv + off) = make_float4(dv[j][0], dv[j][1], dv[j][2], dv[j][3]);
      }
    }
  }

  // dpos: the last block of a group sums its sequences' slices in order,
  // the last group of the head the groups' partials in order
  const int groups = (a.B + kGroup - 1) / kGroup, grp = b / kGroup;
  const int members = min(kGroup, a.B - grp * kGroup);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(g.count + h * groups + grp, 1) == members - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* part = g.gws + (static_cast<long long>(grp) * a.H + h) * slice;
  sum_slices(part, kD, g.ws + (static_cast<long long>(grp) * kGroup * a.H + h) * slice,
             members, a.H * slice, static_cast<int>(slice), tid);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(g.count + a.H * groups + h, 1) == groups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_slices(g.dpos + h * kD, HD, g.gws + static_cast<long long>(h) * slice, groups,
             a.H * slice, static_cast<int>(slice), tid);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gtrxl_attention_fwd(const float* qu, const float* qv, const float* k, const float* v,
                        const float* pos, const int* ep, const uint8_t* valid, float* out,
                        float* lse, int B, int T, int H, int m, int p, long long kb,
                        long long kr, float scale, cudaStream_t stream) {
  const Args a{qu, qv, k, v, pos, ep, valid, B, T, H, m, p, kb, kr, scale};
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = B * H * ((T + kTQ - 1) / kTQ);
  fwd_kernel<<<blocks, kThreads, kFwdSmem, stream>>>(a, out, lse);
  return static_cast<int>(cudaGetLastError());
}

int gtrxl_attention_bwd(const float* qu, const float* qv, const float* k, const float* v,
                        const float* pos, const int* ep, const uint8_t* valid, const float* out,
                        const float* lse, const float* dout, float* dqu, float* dqv, float* dk,
                        float* dv, float* dd, float* ws, float* gws, int* count, float* dpos,
                        int B, int T,
                        int H, int m, int p, long long kb, long long kr, float scale,
                        cudaStream_t stream) {
  const Args a{qu, qv, k, v, pos, ep, valid, B, T, H, m, p, kb, kr, scale};
  const Grads g{out, lse, dout, dqu, dqv, dk, dv, dd, ws, gws, count, dpos};
  cudaError_t err =
      cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<<<B * H, kThreads, kBwdSmem, stream>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

// The groups of the backward's first dpos level: its workspace takes (B +
// groups) * H * (m + 1) * D floats, its counters H * groups + H ints.
int gtrxl_attention_groups(int B) { return (B + kGroup - 1) / kGroup; }

}  // extern "C"
