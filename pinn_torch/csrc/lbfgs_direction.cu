// The L-BFGS two-loop direction for Hopper (sm_90a), in one launch: the
// literal recursion of pinn_torch/optim/lbfgs.py:_two_loop over the
// filled slots of the (m, P) history ring,
//
//     q = -g
//     for j = k-1 .. 0:  rho_j = 1 / (y_j . s_j),  a_j = rho_j (s_j . q),
//                        q = q - a_j y_j
//     r = hdiag q
//     for j = 0 .. k-1:  b_j = rho_j (y_j . r),    r = r + (a_j - b_j) s_j
//
// where logical slot j (oldest first) is ring row (head - k + j) mod m.
//
// Replaces no TPU kernel.  The JAX package's _two_loop
// (pinn/optim/lbfgs.py) is a lax loop that XLA compiles into the
// optimizer's while loop.  The port ran it as eager PyTorch: ~17
// launches a pair, ~850 a direction at a full 50-pair ring, each sent
// by the host onto a queue that the memory guard before it and the
// descent test after it leave empty, so the card waited through the
// host's launches (PERF.md, L-BFGS cell).  This kernel does the same
// work in one launch.
//
// What bounds it on this card.  Bytes: each ring row once, with g and
// the direction, (2 k + 2) P elements, 25.1 MB at P = 30,802, k = 50 in
// float64, 7.5 us at 3.35 TB/s.  Both rings fit in the 50 MB L2, and
// the second loop starts on the rows the first read last, so its
// re-reads need not reach HBM (counting them, 4 k P elements, gives
// 14.7 us).  Its real limit is latency: 2k reductions over all P
// entries, each of which the next step waits for, one after another.
//
// Design.  One thread-block cluster of C CTAs (C from the wrapper: a
// function of P, at most 16, the non-portable cluster size).  CTA
// `rank` owns the contiguous slice [rank L, (rank+1) L) of the P entries
// and keeps its slice of q (then r) in the output buffer, where each
// thread reads and writes only its own entries (a slice of ~16 KB stays
// in L1 and L2), so P has no bound.
// On an H100 at P = 30,802, float64, C = 16, this took 0.364 ms a
// launch, where q in shared memory took 0.424 (nvcc gives that form
// fewer registers, 32 against 40).
// Each step of either loop:
//   - each thread accumulates its entries' products in index order
//     (the next ring row pair is prefetched into L2 meanwhile);
//   - warp shuffles, then the warps in index order, give the CTA's
//     partials, which thread 0 writes to its shared memory (a slot of
//     two, by step parity, so one cluster barrier a step suffices);
//   - a cluster barrier; then every warp reads the C partials through
//     distributed shared memory and adds them in rank order, so every
//     thread of every CTA holds the same total, bit for bit, with no
//     atomics and no host round trip;
//   - each thread updates its own entries.
// Loop 1 takes y.s and s.q in one pass and keeps rho_j and a_j in
// shared memory for loop 2.  hdiag is read through its pointer.
//
// Same work, same precision: the vectors' own type (float64, float32 or
// bfloat16), every step of the recursion in the eager version's order
// and with its roundings: each product, sum and reciprocal rounded on
// its own (explicit _rn intrinsics, so nvcc contracts nothing into an
// FMA); a dot product accumulates by FMA in the element type (float
// for bfloat16, whose dot cuBLAS also sums in float) and, for
// bfloat16, rounds its total to bfloat16 as the eager dot's result is.
// The order of every sum is fixed by P and C, so two launches on the
// same inputs give bitwise-equal directions.
//
// Returns cudaGetLastError() (or cudaErrorInvalidValue on arguments it
// does not take; the wrapper checks them first).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kSliceAlign = 32;     // a slice starts on a 32-element line
constexpr int kLine = 128;          // bytes a prefetch covers

// The arithmetic of element type T: A is the type it is computed in;
// every operation's result is rounded to T, as an eager op on a tensor
// of T rounds it.
template <typename T>
struct Num;

template <>
struct Num<double> {
  using A = double;
  static __device__ __forceinline__ A ld(double v) { return v; }
  static __device__ __forceinline__ double st(A v) { return v; }
  static __device__ __forceinline__ A rnd(A v) { return v; }
  static __device__ __forceinline__ A mul(A a, A b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ A sub(A a, A b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ A rcp(A a) { return __drcp_rn(a); }
  static __device__ __forceinline__ A fma(A a, A b, A c) {
    return __fma_rn(a, b, c);
  }
};

template <>
struct Num<float> {
  using A = float;
  static __device__ __forceinline__ A ld(float v) { return v; }
  static __device__ __forceinline__ float st(A v) { return v; }
  static __device__ __forceinline__ A rnd(A v) { return v; }
  static __device__ __forceinline__ A mul(A a, A b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ A sub(A a, A b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ A rcp(A a) { return __frcp_rn(a); }
  static __device__ __forceinline__ A fma(A a, A b, A c) {
    return __fmaf_rn(a, b, c);
  }
};

template <>
struct Num<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A ld(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 st(A v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ A rnd(A v) { return ld(st(v)); }
  static __device__ __forceinline__ A mul(A a, A b) {
    return rnd(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ A add(A a, A b) {
    return rnd(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ A sub(A a, A b) {
    return rnd(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ A rcp(A a) { return rnd(__frcp_rn(a)); }
  static __device__ __forceinline__ A fma(A a, A b, A c) {
    return __fmaf_rn(a, b, c);
  }
};

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  // Lane 0 ends with the warp's sum, in a fixed tree order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The cluster-wide sums of a and b (b unused when kTwo is false), the
// same bits in every thread of every CTA.  slot: this step's pair of
// partials in this CTA's shared memory (two slots alternate by step).
template <bool kTwo, typename A>
__device__ __forceinline__ void cluster_sum(A& a, A& b, A (*red)[2],
                                            A* slot,
                                            cg::cluster_group& cluster,
                                            int n_ranks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  if (kTwo) b = warp_sum(b);
  if (lane == 0) {
    red[warp][0] = a;
    if (kTwo) red[warp][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    A sa = red[0][0], sb = kTwo ? red[0][1] : A(0);
    for (int w = 1; w < kWarps; ++w) {
      sa += red[w][0];
      if (kTwo) sb += red[w][1];
    }
    slot[0] = sa;
    if (kTwo) slot[1] = sb;
  }
  cluster.sync();
  // Lane r < n_ranks reads rank r's first partial, lane 16 + r its
  // second; every lane adds them up in rank order.
  A v = A(0);
  if (lane < n_ranks) {
    v = cluster.map_shared_rank(slot, lane)[0];
  } else if (kTwo && lane >= 16 && lane - 16 < n_ranks) {
    v = cluster.map_shared_rank(slot, lane - 16)[1];
  }
  A ta = __shfl_sync(0xffffffffu, v, 0);
  A tb = kTwo ? __shfl_sync(0xffffffffu, v, 16) : A(0);
  for (int r = 1; r < n_ranks; ++r) {
    ta += __shfl_sync(0xffffffffu, v, r);
    if (kTwo) tb += __shfl_sync(0xffffffffu, v, 16 + r);
  }
  a = ta;
  b = tb;
}

// Pull the CTA's slice of the next ring rows into L2 while this step
// reduces.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* s, const T* y, int n) {
  const char* ps = reinterpret_cast<const char*>(s);
  const char* py = reinterpret_cast<const char*>(y);
  const long bytes = long(n) * sizeof(T);
  for (long b = long(threadIdx.x) * kLine; b < bytes; b += long(kThreads) * kLine) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(ps + b));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(py + b));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lbfgs_two_loop_kernel(const T* __restrict__ g, const T* __restrict__ S,
                          const T* __restrict__ Y, const T* __restrict__ hdiag,
                          T* out, int P, int m, int k, int head, int slice) {
  using N = Num<T>;
  using A = typename N::A;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = int(cluster.num_blocks());
  const long lo = long(cluster.block_rank()) * slice;
  const long hi = lo + slice < long(P) ? lo + slice : long(P);
  const int n = hi > lo ? int(hi - lo) : 0;     // this CTA's entries

  __shared__ A red[kWarps][2];
  __shared__ A part[2][2];
  extern __shared__ __align__(16) unsigned char smem[];
  A* rho = reinterpret_cast<A*>(smem);       // rho_j, j < k
  A* alpha = rho + k;                        // a_j, j < k
  T* q = out + lo;                           // this CTA's slice

  auto row_of = [&](int j) {                 // logical slot -> ring row
    const int r = head - k + j;
    return size_t(r < 0 ? r + m : r) * size_t(P) + size_t(lo);
  };

  for (int i = threadIdx.x; i < n; i += kThreads) {
    q[i] = N::st(-N::ld(g[lo + i]));
  }
  int step = 0;
  for (int j = k - 1; j >= 0; --j, ++step) {          // newest -> oldest
    const T* s = S + row_of(j);
    const T* y = Y + row_of(j);
    if (j > 0) prefetch_rows(S + row_of(j - 1), Y + row_of(j - 1), n);
    A ys = A(0), sq = A(0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const A sv = N::ld(__ldg(s + i));
      ys = N::fma(N::ld(__ldg(y + i)), sv, ys);
      sq = N::fma(sv, N::ld(q[i]), sq);
    }
    cluster_sum<true>(ys, sq, red, part[step & 1], cluster, n_ranks);
    const A r_j = N::rcp(N::rnd(ys));
    const A a_j = N::mul(r_j, N::rnd(sq));
    if (threadIdx.x == 0) {
      rho[j] = r_j;
      alpha[j] = a_j;
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      q[i] = N::st(N::sub(N::ld(q[i]), N::mul(a_j, N::ld(__ldg(y + i)))));
    }
  }
  const A h = N::ld(*hdiag);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    q[i] = N::st(N::mul(N::ld(q[i]), h));
  }
  for (int j = 0; j < k; ++j, ++step) {               // oldest -> newest
    const T* s = S + row_of(j);
    const T* y = Y + row_of(j);
    if (j + 1 < k) prefetch_rows(S + row_of(j + 1), Y + row_of(j + 1), n);
    A yr = A(0), unused = A(0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      yr = N::fma(N::ld(__ldg(y + i)), N::ld(q[i]), yr);
    }
    cluster_sum<false>(yr, unused, red, part[step & 1], cluster, n_ranks);
    // rho_j and a_j were written by thread 0 before at least one barrier.
    const A b_j = N::mul(rho[j], N::rnd(yr));
    const A c_j = N::sub(alpha[j], b_j);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      q[i] = N::st(N::add(N::ld(q[i]), N::mul(c_j, N::ld(__ldg(s + i)))));
    }
  }
  // No CTA leaves while another may still read its partials.
  cluster.sync();
}

// cudaFuncSetAttribute, once a device for each instance: clusters of
// up to 16 CTAs, and as much dynamic shared memory (the history
// scalars) as the device lets a block opt in to.
template <typename T>
cudaError_t configure() {
  constexpr int kDevices = 64;
  static std::atomic<bool> ready[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && ready[dev].load())) return err;
  auto kernel = lbfgs_two_loop_kernel<T>;
  int optin = 0;
  cudaFuncAttributes attrs = {};
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - int(attrs.sharedSizeBytes));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && dev < kDevices) ready[dev].store(true);
  return err;
}

template <typename T>
int launch(const void* g, const void* S, const void* Y, const void* hdiag,
           void* out, int P, int m, int k, int head, int cluster,
           cudaStream_t stream) {
  using A = typename Num<T>::A;
  if (P < 1 || m < 1 || k < 0 || k > m || head < 0 || head >= m ||
      cluster < 1 || cluster > kMaxCluster) {
    return cudaErrorInvalidValue;
  }
  const long per = (long(P) + cluster - 1) / cluster;
  const int slice = int((per + kSliceAlign - 1) / kSliceAlign * kSliceAlign);
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  const size_t dyn = 2 * size_t(k) * sizeof(A);     // rho_j and a_j

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lbfgs_two_loop_kernel<T>,
                           static_cast<const T*>(g), static_cast<const T*>(S),
                           static_cast<const T*>(Y),
                           static_cast<const T*>(hdiag), static_cast<T*>(out),
                           P, m, k, head, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ---- host entry point (plain C interface, loaded with ctypes) ----

extern "C" {

// The direction into out (P elements); g (P), S and Y (m, P) row-major,
// hdiag one element, all of one element type: elem 0 float64, 1
// float32, 2 bfloat16.  cluster: the CTAs of the one cluster, 1-16.
int lbfgs_two_loop(const void* g, const void* S, const void* Y,
                   const void* hdiag, void* out, int P, int m, int k,
                   int head, int elem, int cluster, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 0:
      return launch<double>(g, S, Y, hdiag, out, P, m, k, head, cluster, st);
    case 1:
      return launch<float>(g, S, Y, hdiag, out, P, m, k, head, cluster, st);
    case 2:
      return launch<__nv_bfloat16>(g, S, Y, hdiag, out, P, m, k, head,
                                   cluster, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
