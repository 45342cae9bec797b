// The register-blocked loss+grad kernel of the fused Burgers inference
// loss (sm_90a), f32 streams, for nets whose hidden layers all have one
// width H: pt_narrow_rb_loss_grad_kernel, which burgers_train.cu's
// burgers_loss_grad_rb launches (H = 20).  It replaces the TPU kernel
// _make_train_kernel (pinn/ops/pallas_train.py:524), as
// pt_narrow_loss_grad_kernel (pt_narrow.cuh) does, and gives that
// kernel's loss, gradients and partials rows bit for bit.  The wrapper
// (pinn_torch/ops/fused_train.py) takes it for every float32 inference
// call at width 20: on an H100 it was the faster at every point count
// measured, N = 1,000 to 1,000,100 (PERF.md, row 1).
//
// Why a second design.  pt_narrow_loss_grad_kernel gives each thread
// one (neuron, point) pair, so every product reads both operands from
// shared memory: 5 loads for 4 FMAs in the forward and the input
// adjoints, 2 for 1 in the weight gradients, ~55,000 shared-memory
// wavefronts a 32-point tile at [2, 20x8, 1] against ~8,400 cycles of
// FFMA issue.  At N = 1,000,100 (31,254 tiles, 237 an SM) that pipe
// sets the pace (7.8 ms a call against the 1.14 ms bound); and its
// device workspace of saved streams, 2.56 GB a call, goes out to HBM.
//
// Here each value a thread loads feeds several FMAs held in registers,
// and a tile's saved streams stay in shared memory.  A block is one
// 32-point tile (one row of the partials, as in pt_narrow.cuh, so
// pt_reduce sums the same rows) and kPtRbThreads = 128 threads, four
// warps; at [2, 20x8, 1] its 110,096 bytes of shared memory let two
// blocks share an SM.  Lanes are the tile's points wherever a phase
// works on rows of neurons.  Phases, between block barriers:
//   forward, per hidden layer: warp w computes neurons [w J, w J + J),
//     J = H / 4, for its lane's point: per input k one load of each of
//     the point's four streams and two uniform float4 loads of the J
//     weights feed 4 J FMAs; then the J tanh side by side, the stream
//     recombination, the saved (t, z1, z11, z2) to the tile's shared
//     workspace and the outputs to the next activation buffer;
//   head: warp 0, a lane a point: the output streams as
//     pt_narrow_output's chains, Head::eval, pt_warp_sum;
//   backward, per hidden layer l = L-1 .. 1, two phases:
//     B1: warps 2-3 turn the output adjoints they hold in registers
//       (H / 2 neurons a warp) into the pre-activation adjoints gz,
//       stored for the products, while warps 0-1 rematerialise layer
//       l-1's outputs from the workspace and add the previous layer's
//       weight gradient from its four stream parts;
//     B2: warps 0-1 the weight gradient's stream parts, a thread one
//       stream and an (H / 4) x (H / 4) block of (j, k), walking the
//       tile's points in order four at a time: at H = 20 ten float4
//       loads feed 100 FMAs; warps 2-3 the input adjoints Wt_l^T gz
//       into registers, a thread a point and H / 2 inputs: per neuron j
//       four loads and three uniform float4 loads feed 2 H FMAs; the
//       bias gradient beside them;
//   layer 0 as pt_narrow.cuh.
// Each phase's weights are copied to shared memory by cp.async a phase
// ahead of it, from offsets a thread works out once (every layer past
// the first starts H H + H floats after the one before), so no copy's
// latency and no index arithmetic sits in a phase's path.  The first
// layer's tangent rows (z1, z2) are the same for every point and its
// z11 is 0, so the workspace holds only its t; the backward reads the
// others from a staged copy, a zero included, as pt_narrow.cuh reads
// them from its workspace: the same values.
//
// Bit for bit.  Every sum is the fixed-order per-thread fmaf chain of
// pt_narrow.cuh: the forward over k ascending from 0.0f, then + b; the
// input adjoints over j ascending; each stream part of dW over the
// tile's points in order, the four parts added in stream order; the
// bias and layer-0 sums in their order.  The register blocks change
// which thread runs a chain, not its order, and each elementwise step
// is pt_narrow.cuh's expression.
//
// Bound at [2, 20x8, 1]: ~1.08 M FMAs a tile (33,600 warp FFMAs, ~8,400
// cycles of issue at four a cycle an SM; 1.14 ms a call at N =
// 1,000,100 at 67 TFLOP/s), no workspace traffic to device memory (the
// old kernel's 2.56 GB a call), and by count ~14,000 shared-memory
// wavefronts a tile (a uniform float4 load counted as one) against
// ~55,000 for pt_narrow_loss_grad_kernel.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W, by device time: 3.63 ms a call at N = 1,000,100
// (31% of the bound; the old kernel 7.83 ms) and 0.063 ms at N = 10,100
// (0.1145); 158 registers, no spills.  A block then issues about 0.57
// instructions a cycle a scheduler: the FFMAs are half of its
// instructions, and two blocks of four warps an SM leave little to hide
// the phases' latency (PERF.md).
// Precision: IEEE f32 (fmaf, tanhf); build without --use_fast_math.

#pragma once

#include "pt_narrow.cuh"

namespace {

constexpr int kPtRbWarps = 4;
constexpr int kPtRbThreads = 32 * kPtRbWarps;
// Activation rows: a neuron's four streams, each padded to 36 floats, so
// that a row of four points is one aligned float4 and the weight
// gradient's float4 loads hit distinct banks.
constexpr int kPtRbTS = PT_TILE + 4;
constexpr int kPtRbLD = 4 * kPtRbTS;

constexpr int pt_rb_round4(int n) { return (n + 3) / 4 * 4; }
constexpr int pt_rb_max(int a, int b) { return a > b ? a : b; }

// The carve-up of a block's shared memory at hidden width H, in floats
// from its start (each buffer a multiple of four floats, so float4 loads
// are aligned).  Two weight buffers, each one layer staged for the
// phase that reads it: the forward's Wt_l as [k][warp][kJP] then b_l,
// the input adjoints' as [j][warp - 2][kK2P], the first layer's and the
// output layer's as they are packed.
template <int H>
struct PtRbSmem {
  static_assert(H % 4 == 0 && H / 4 <= 8, "four warps of H / 4 neurons");
  static constexpr int kJ = H / 4;              // forward: neurons a warp
  static constexpr int kJP = (kJ + 3) / 4 * 4;
  static constexpr int kK2 = H / 2;             // adjoints: inputs a warp
  static constexpr int kK2P = (kK2 + 3) / 4 * 4;
  static constexpr int kB = H / 4;              // dW: a thread's j and k
  static constexpr int kFwd = H * 4 * kJP + H;  // forward layout's floats
  static constexpr int kAdj = H * 2 * kK2P;     // adjoints layout's floats
  static constexpr int kW =
      pt_rb_round4(pt_rb_max(pt_rb_max(kFwd, kAdj), pt_rb_max(3 * H, H + 1)));
  static constexpr int kActSize = H * kPtRbLD;  // [k][stream][36]
  static constexpr int kAct = 2 * kW;
  static constexpr int kPart = kAct + 2 * kActSize;  // 4 parts of a dW
  static constexpr int kGu = kPart + 4 * H * H;      // gU [stream][36]
  static constexpr int kGb = kGu + kPtRbLD;
  static constexpr int kX = kGb + PT_TILE;           // the two inputs
  static constexpr int kTr = kX + 2 * PT_TILE;       // z1row, z2row, 0
  static constexpr int kWs = kTr + pt_rb_round4(2 * H + 1);
  // Floats of a net of n_hidden hidden layers: the workspace holds the
  // first layer's t and every other hidden layer's (t, z1, z11, z2), a
  // row of 32 points each.
  static int floats(int n_hidden) {
    return kWs + PT_TILE * H * (1 + 4 * (n_hidden - 1));
  }
  // Workspace row of stream s of neuron j of hidden layer l >= 1.
  static __device__ __forceinline__ int ws_row(int l, int s, int j) {
    return kWs + PT_TILE * (H + ((l - 1) * 4 + s) * H + j);
  }
};

// The staged weight layouts, as offsets from a hidden layer's Wt_l in
// wpack (-1: padding, loaded by the float4 reads but never used): entry
// i of the forward's layout ([k][warp][kJP], then b_l) and of the input
// adjoints' ([j][warp - 2][kK2P]).  Every hidden layer l >= 1 and the
// output layer start at w_off[1] + (l - 1) (H H + H), so a thread works
// its entries' offsets out once and adds the layer's start.
template <int H>
__device__ __forceinline__ int pt_rb_fwd_rel(int i) {
  using Sm = PtRbSmem<H>;
  constexpr int J = Sm::kJ, JP = Sm::kJP;
  if (i >= Sm::kFwd) return -1;
  if (i >= H * 4 * JP) return H * H + i - H * 4 * JP;
  const int k = i / (4 * JP), r = i - k * 4 * JP;
  const int w = r / JP, jj = r - w * JP;
  return jj < J ? (w * J + jj) * H + k : -1;
}

template <int H>
__device__ __forceinline__ int pt_rb_adj_rel(int i) {
  using Sm = PtRbSmem<H>;
  constexpr int K2 = Sm::kK2, K2P = Sm::kK2P;
  if (i >= Sm::kAdj) return -1;
  const int j = i / (2 * K2P), r = i - j * 2 * K2P;
  const int w = r / K2P, kk = r - w * K2P;
  return kk < K2 ? j * H + w * K2 + kk : -1;
}

// One float from device to shared memory without a register
// (cp.async): the copies of a phase's staging are issued at its start
// and waited for (pt_rb_wait) at its end, so their latency hides behind
// the phase's products.
__device__ __forceinline__ void pt_rb_copy(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void pt_rb_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// pt_narrow_gz's step for one (neuron, point): the adjoints gz of the
// pre-activation streams from the output adjoints g and the saved
// (t, z1, z11, z2).
__device__ __forceinline__ void pt_rb_gz(float t, float z1, float z11,
                                         float z2, const float g[4],
                                         float* gj) {
  constexpr int TS = kPtRbTS;
  const float g0 = g[0];
  const float g1 = g[1];
  const float g2 = g[2];
  const float g3 = g[3];
  const float sp = 1.0f - t * t;
  const float spp = -2.0f * t * sp;
  const float gt = g0 + g1 * (-2.0f * t * z1)
                   + g2 * ((6.0f * t * t - 2.0f) * z1 * z1 - 2.0f * t * z11)
                   + g3 * (-2.0f * t * z2);
  gj[0 * TS] = sp * gt;
  gj[1 * TS] = g1 * sp + g2 * (2.0f * spp * z1);
  gj[2 * TS] = g2 * sp;
  gj[3 * TS] = g3 * sp;
}

// pt_narrow_remat's step for one (neuron, point): its output streams
// rebuilt from the saved (t, z1, z11, z2).
__device__ __forceinline__ void pt_rb_remat(float tp, float z1p, float z11p,
                                            float z2p, float* ak) {
  constexpr int TS = kPtRbTS;
  const float spp_ = 1.0f - tp * tp;
  const float sppp = -2.0f * tp * spp_;
  ak[0 * TS] = tp;
  ak[1 * TS] = spp_ * z1p;
  ak[2 * TS] = sppp * z1p * z1p + spp_ * z11p;
  ak[3 * TS] = spp_ * z2p;
}

__device__ __forceinline__ float4 pt_rb_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Loss and every gradient of tile blockIdx.x into partials row
// blockIdx.x (1 + n_weights floats), kPtRbThreads threads.
template <class Head, int H>
__global__ void __launch_bounds__(kPtRbThreads)
pt_narrow_rb_loss_grad_kernel(PtNet net, const float* __restrict__ a0,
                              const float* __restrict__ wpack, int n_pts,
                              typename Head::Args args,
                              float* __restrict__ partials) {
  static_assert(Head::kOut == 1 && Head::kExtra == 0, "the inference head");
  using Sm = PtRbSmem<H>;
  constexpr int T = PT_TILE, TS = kPtRbTS, LD = kPtRbLD;
  constexpr int J = Sm::kJ, JP = Sm::kJP, K2 = Sm::kK2, K2P = Sm::kK2P;
  constexpr int B = Sm::kB;
  extern __shared__ __align__(16) float pt_rb_buf[];
  float* const smem = pt_rb_buf;
  float* const x_s = smem + Sm::kX;
  float* const tr_s = smem + Sm::kTr;   // z1row, z2row, then 0.0f
  float* const gu_s = smem + Sm::kGu;
  float* const gb_s = smem + Sm::kGb;
  float* const part_s = smem + Sm::kPart;
  auto wbuf = [&](int l) { return smem + (l & 1) * Sm::kW; };
  auto act = [&](int i) { return smem + Sm::kAct + i * Sm::kActSize; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = net.n_layers - 1;   // the output layer
  const int col0 = blockIdx.x * T;
  float* const part = partials + (size_t)blockIdx.x * (1 + net.n_weights) + 1;

  // The staging: each thread's entries of the two layouts, and the
  // start of layer l >= 1 in wpack.
  constexpr int kFwdPer = (Sm::kFwd + kPtRbThreads - 1) / kPtRbThreads;
  constexpr int kAdjPer = (Sm::kAdj + 63) / 64;
  int rel_f[kFwdPer], rel_a[kAdjPer];
#pragma unroll
  for (int q = 0; q < kFwdPer; ++q) rel_f[q] = pt_rb_fwd_rel<H>(tid + q * kPtRbThreads);
#pragma unroll
  for (int q = 0; q < kAdjPer; ++q) rel_a[q] = pt_rb_adj_rel<H>(tid + q * 64);
  const int w_off1 = net.w_off[1];
  auto layer = [&](int l) { return wpack + w_off1 + (l - 1) * (H * H + H); };
  // Layer l's forward weights into dst: the forward layout (l < L) or,
  // for the output layer, as packed.
  auto stage_fwd = [&](int l, float* dst) {
    const float* src = layer(l);
    if (l < L) {
#pragma unroll
      for (int q = 0; q < kFwdPer; ++q) {
        if (rel_f[q] >= 0) pt_rb_copy(dst + tid + q * kPtRbThreads, src + rel_f[q]);
      }
    } else if (tid <= H) {
      pt_rb_copy(dst + tid, src + tid);
    }
  };
  // Layer l's weights in the input adjoints' layout into dst (warps 0-1).
  auto stage_adj = [&](int l, float* dst) {
    const float* src = layer(l);
#pragma unroll
    for (int q = 0; q < kAdjPer; ++q) {
      if (rel_a[q] >= 0) pt_rb_copy(dst + tid + q * 64, src + rel_a[q]);
    }
  };

  // ---- inputs, the first layer and its tangent rows ----
  if (tid < T) {
    const int col = col0 + tid;
    if (col < n_pts) {
      pt_rb_copy(x_s + tid, a0 + col);
      pt_rb_copy(x_s + T + tid, a0 + n_pts + col);
    } else {
      x_s[tid] = 0.0f;
      x_s[T + tid] = 0.0f;
    }
  }
  for (int i = tid; i < 3 * H; i += kPtRbThreads) {
    pt_rb_copy(wbuf(0) + i, wpack + net.w_off[0] + i);   // Wt_0, then b_0
  }
  if (tid < H) {
    pt_rb_copy(tr_s + tid, wpack + net.z1_off + tid);
    pt_rb_copy(tr_s + H + tid, wpack + net.z2_off + tid);
  }
  if (tid == 0) tr_s[2 * H] = 0.0f;
  pt_rb_wait();
  __syncthreads();

  // ---- layer 0: warp w its J neurons at its lane's point ----
  {
    stage_fwd(1, wbuf(1));
    const float* Wt = wbuf(0);
    const float* b = Wt + 2 * H;
    float* cur = act(0);
    const float x0 = x_s[lane], x1 = x_s[T + lane];
    float tj[J], z1j[J], z2j[J];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = warp * J + jj;
      const float zv = Wt[2 * j] * x0 + Wt[2 * j + 1] * x1 + b[j];
      z1j[jj] = tr_s[j];
      z2j[jj] = tr_s[H + j];
      tj[jj] = tanhf(zv);
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = warp * J + jj;
      const float z1 = z1j[jj];
      const float z2 = z2j[jj];
      const float t = tj[jj];
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      smem[Sm::kWs + j * T + lane] = t;
      float* o = cur + j * LD + lane;
      o[0 * TS] = t;
      o[1 * TS] = sp * z1;
      o[2 * TS] = spp * z1 * z1;
      o[3 * TS] = sp * z2;
    }
    pt_rb_wait();
  }
  __syncthreads();

  // ---- hidden layers 1 .. L-1: per input k, one load a stream and
  // two uniform float4 loads of the warp's J weights feed 4 J FMAs ----
  int ic = 0;   // the buffer that holds the current layer's inputs
  for (int l = 1; l < L; ++l) {
    stage_fwd(l + 1, wbuf(l + 1));
    const float* wf = wbuf(l);
    const float* ap = act(ic) + lane;
    float* nxt = act(ic ^ 1);
    float acc[J][4];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float a_0 = ap[k * LD + 0 * TS];
      const float a_1 = ap[k * LD + 1 * TS];
      const float a_2 = ap[k * LD + 2 * TS];
      const float a_3 = ap[k * LD + 3 * TS];
      float w[JP];
#pragma unroll
      for (int q = 0; q < JP / 4; ++q) {
        const float4 v = pt_rb_ld4(wf + (k * 4 + warp) * JP + 4 * q);
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        acc[jj][0] = fmaf(w[jj], a_0, acc[jj][0]);
        acc[jj][1] = fmaf(w[jj], a_1, acc[jj][1]);
        acc[jj][2] = fmaf(w[jj], a_2, acc[jj][2]);
        acc[jj][3] = fmaf(w[jj], a_3, acc[jj][3]);
      }
    }
    const float* b = wf + H * 4 * JP;
    float tj[J];   // the J tanh side by side, for their latency
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      float zv = acc[jj][0];
      zv += b[warp * J + jj];
      tj[jj] = tanhf(zv);
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = warp * J + jj;
      const float z1 = acc[jj][1], z11 = acc[jj][2], z2 = acc[jj][3];
      const float t = tj[jj];
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      smem[Sm::ws_row(l, 0, j) + lane] = t;
      smem[Sm::ws_row(l, 1, j) + lane] = z1;
      smem[Sm::ws_row(l, 2, j) + lane] = z11;
      smem[Sm::ws_row(l, 3, j) + lane] = z2;
      float* o = nxt + j * LD + lane;
      o[0 * TS] = t;
      o[1 * TS] = sp * z1;
      o[2 * TS] = spp * z1 * z1 + sp * z11;
      o[3 * TS] = sp * z2;
    }
    pt_rb_wait();
    __syncthreads();
    ic ^= 1;
  }
  const float* cur = act(ic);   // the last hidden layer's outputs

  // ---- output layer and head: warp 0, a lane a point (the output
  // streams as pt_narrow_output's chains over k ascending) ----
  if (warp == 0) {
    const int col = col0 + lane;
    const typename Head::Point pt = Head::load(args, n_pts, col, col < n_pts);
    const float* wo = wbuf(L);
    const float* ap = cur + lane;
    float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float wk = wo[k];
      u0 = fmaf(wk, ap[k * LD + 0 * TS], u0);
      u1 = fmaf(wk, ap[k * LD + 1 * TS], u1);
      u2 = fmaf(wk, ap[k * LD + 2 * TS], u2);
      u3 = fmaf(wk, ap[k * LD + 3 * TS], u3);
    }
    float U[1][4], gU[1][4], ex[1];
    U[0][0] = u0 + wo[H];
    U[0][1] = u1;
    U[0][2] = u2;
    U[0][3] = u3;
    const float loss_tile = pt_warp_sum(Head::eval(args, pt, U, gU, ex));
    if (lane == 0) part[-1] = loss_tile;
    gb_s[lane] = gU[0][0];
    for (int s = 0; s < 4; ++s) gu_s[s * TS + lane] = gU[0][s];
  }
  __syncthreads();

  // ---- the output layer's gradients (warps 0-1) and the last hidden
  // layer's output adjoints Wt_out^T gU into g (warps 2-3) ----
  float g[K2][4];   // warps 2-3: the output adjoints of inputs [w' K2, ..)
  const int w2 = warp - 2;
  if (warp < 2) {
    if (L > 1) stage_adj(L - 1, wbuf(L - 1));
    if (tid < H) {
      const float* ar = cur + tid * LD;
      float ps[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int p = 0; p < T; p += 4) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float4 gv = pt_rb_ld4(gu_s + s * TS + p);
          const float4 av = pt_rb_ld4(ar + s * TS + p);
          ps[s] = fmaf(gv.x, av.x, ps[s]);
          ps[s] = fmaf(gv.y, av.y, ps[s]);
          ps[s] = fmaf(gv.z, av.z, ps[s]);
          ps[s] = fmaf(gv.w, av.w, ps[s]);
        }
      }
      part[net.w_off[L] + tid] = ps[0] + ps[1] + ps[2] + ps[3];
    } else if (tid == H) {
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < T; p += 4) {
        const float4 v = pt_rb_ld4(gb_s + p);
        s += v.x;
        s += v.y;
        s += v.z;
        s += v.w;
      }
      part[net.b_off[L]] = s;
    }
  } else {
    const float* wo = wbuf(L);
#pragma unroll
    for (int kk = 0; kk < K2; ++kk) {
      const float wk = wo[w2 * K2 + kk];
#pragma unroll
      for (int s = 0; s < 4; ++s) g[kk][s] = fmaf(wk, gu_s[s * TS + lane], 0.0f);
    }
  }
  __syncthreads();

  // ---- hidden layers L-1 .. 1 ----
  float* const G = act(ic ^ 1);   // gz of layer l
  float* const A = act(ic);       // layer l-1's outputs, rematerialised
  constexpr int n_w = H * H;
  for (int l = L - 1; l >= 1; --l) {
    // B1
    // Each phase reads its saved streams before it stores anything: a
    // load the compiler cannot move above a store to shared memory
    // would wait for it.
    float sv[K2][4];
    if (warp >= 2) {
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          sv[kk][s] = smem[Sm::ws_row(l, s, w2 * K2 + kk) + lane];
        }
      }
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
        pt_rb_gz(sv[kk][0], sv[kk][1], sv[kk][2], sv[kk][3], g[kk],
                 G + (w2 * K2 + kk) * LD + lane);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
        const int k = warp * K2 + kk;
        if (l == 1) {
          sv[kk][0] = smem[Sm::kWs + k * T + lane];
          sv[kk][1] = tr_s[k];
          sv[kk][2] = tr_s[2 * H];
          sv[kk][3] = tr_s[H + k];
        } else {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            sv[kk][s] = smem[Sm::ws_row(l - 1, s, k) + lane];
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
        pt_rb_remat(sv[kk][0], sv[kk][1], sv[kk][2], sv[kk][3],
                    A + (warp * K2 + kk) * LD + lane);
      }
      if (l + 1 < L) {   // layer l+1's dW from its four stream parts
        float* dst = part + net.w_off[l + 1];
#pragma unroll
        for (int q = 0; q < (n_w + 63) / 64; ++q) {
          const int i = tid + q * 64;
          if (i < n_w) {
            dst[i] = part_s[i] + part_s[n_w + i] + part_s[2 * n_w + i] +
                     part_s[3 * n_w + i];
          }
        }
      }
      pt_rb_wait();
    }
    __syncthreads();
    // B2
    if (warp < 2) {
      if (l > 1) stage_adj(l - 1, wbuf(l - 1));
      // stream s, neurons [jb B, jb B + B), inputs [kb B, kb B + B),
      // four points a float4
      const int s = tid & 3, kb = (tid >> 2) & 3, jb = tid >> 4;
      const float* gr = G + jb * B * LD + s * TS;
      const float* ar = A + kb * B * LD + s * TS;
      float acc[B][B];
#pragma unroll
      for (int jj = 0; jj < B; ++jj) {
#pragma unroll
        for (int kk = 0; kk < B; ++kk) acc[jj][kk] = 0.0f;
      }
#pragma unroll 2
      for (int p = 0; p < T; p += 4) {
        float4 gv[B], av[B];
#pragma unroll
        for (int i = 0; i < B; ++i) {
          gv[i] = pt_rb_ld4(gr + i * LD + p);
          av[i] = pt_rb_ld4(ar + i * LD + p);
        }
#pragma unroll
        for (int jj = 0; jj < B; ++jj) {
#pragma unroll
          for (int kk = 0; kk < B; ++kk) {
            float a = acc[jj][kk];
            a = fmaf(gv[jj].x, av[kk].x, a);
            a = fmaf(gv[jj].y, av[kk].y, a);
            a = fmaf(gv[jj].z, av[kk].z, a);
            acc[jj][kk] = fmaf(gv[jj].w, av[kk].w, a);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < B; ++jj) {
#pragma unroll
        for (int kk = 0; kk < B; ++kk) {
          part_s[s * n_w + (jb * B + jj) * H + kb * B + kk] = acc[jj][kk];
        }
      }
    } else {
      const float* wa = wbuf(l) + w2 * K2P;
      const float* gp = G + lane;
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
        g[kk][0] = g[kk][1] = g[kk][2] = g[kk][3] = 0.0f;
      }
#pragma unroll 2
      for (int j = 0; j < H; ++j) {
        const float g_0 = gp[j * LD + 0 * TS];
        const float g_1 = gp[j * LD + 1 * TS];
        const float g_2 = gp[j * LD + 2 * TS];
        const float g_3 = gp[j * LD + 3 * TS];
        float w[K2P];
#pragma unroll
        for (int q = 0; q < K2P / 4; ++q) {
          const float4 v = pt_rb_ld4(wa + j * 2 * K2P + 4 * q);
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < K2; ++kk) {
          g[kk][0] = fmaf(w[kk], g_0, g[kk][0]);
          g[kk][1] = fmaf(w[kk], g_1, g[kk][1]);
          g[kk][2] = fmaf(w[kk], g_2, g[kk][2]);
          g[kk][3] = fmaf(w[kk], g_3, g[kk][3]);
        }
      }
      if (warp == 2 && lane < H) {   // the bias gradient: gz's value row
        const float* row = G + lane * LD;
        float s = 0.0f;
#pragma unroll
        for (int p = 0; p < T; p += 4) {
          const float4 v = pt_rb_ld4(row + p);
          s += v.x;
          s += v.y;
          s += v.z;
          s += v.w;
        }
        part[net.b_off[l] + lane] = s;
      }
    }
    __syncthreads();
  }

  // ---- layer 0: its gz (warps 2-3) beside layer 1's dW; then W0 on
  // the value stream, the tangent rows' adjoints as column sums ----
  if (warp >= 2) {
    float sv[K2][4];
#pragma unroll
    for (int kk = 0; kk < K2; ++kk) {
      const int j = w2 * K2 + kk;
      sv[kk][0] = smem[Sm::kWs + j * T + lane];
      sv[kk][1] = tr_s[j];
      sv[kk][2] = tr_s[2 * H];
      sv[kk][3] = tr_s[H + j];
    }
#pragma unroll
    for (int kk = 0; kk < K2; ++kk) {
      pt_rb_gz(sv[kk][0], sv[kk][1], sv[kk][2], sv[kk][3], g[kk],
               G + (w2 * K2 + kk) * LD + lane);
    }
  } else if (L > 1) {
    float* dst = part + net.w_off[1];
#pragma unroll
    for (int q = 0; q < (n_w + 63) / 64; ++q) {
      const int i = tid + q * 64;
      if (i < n_w) {
        dst[i] = part_s[i] + part_s[n_w + i] + part_s[2 * n_w + i] +
                 part_s[3 * n_w + i];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 5 * H; idx += kPtRbThreads) {
    const int j = idx / 5, q = idx - 5 * j;
    const float* gj = G + j * LD;
    float s = 0.0f;
    if (q < 2) {
      const float* xq = x_s + q * T;
#pragma unroll
      for (int p = 0; p < T; p += 4) {
        const float4 gv = pt_rb_ld4(gj + p), xv = pt_rb_ld4(xq + p);
        s = fmaf(gv.x, xv.x, s);
        s = fmaf(gv.y, xv.y, s);
        s = fmaf(gv.z, xv.z, s);
        s = fmaf(gv.w, xv.w, s);
      }
      part[net.w_off[0] + 2 * j + q] = s;
    } else {
      const float* row = gj + (q == 2 ? 0 : q == 3 ? TS : 3 * TS);
#pragma unroll
      for (int p = 0; p < T; p += 4) {
        const float4 v = pt_rb_ld4(row + p);
        s += v.x;
        s += v.y;
        s += v.z;
        s += v.w;
      }
      part[q == 2 ? net.b_off[0] + j : (q == 3 ? net.z1_off : net.z2_off) + j] = s;
    }
  }
}

// Loss and every gradient through the register-blocked kernel, for a
// layer list [2, H, ..., H, 1].  partials: n_tiles * (1 + n_weights)
// floats and pt_reduce's scratch; out: 1 + n_weights floats, n_tiles =
// ceil(n_pts / 32); no workspace.  Nonzero on another layer list or a
// launch the card refuses; there is no fallback.
template <class Head, int H>
int pt_narrow_rb_launch_loss_grad(const int* widths, int n_layers,
                                  const float* a0, const float* wpack,
                                  int n_pts, typename Head::Args args,
                                  float* partials, float* out, void* stream) {
  static PtNarrowCache cache;
  PtNet net;
  int err = pt_make_net(widths, n_layers, Head::kOut, H, &net);
  if (err) return err;
  if (n_pts < 1) return (int)cudaErrorInvalidValue;
  for (int l = 1; l < n_layers; ++l) {
    if (widths[l] != H) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * PtRbSmem<H>::floats(n_layers - 1);
  const void* kernel = (const void*)pt_narrow_rb_loss_grad_kernel<Head, H>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.dev != dev || cache.smem != smem) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      }
      if (e != cudaSuccess) return (int)e;
      cache.dev = dev;
      cache.smem = smem;
    }
  }
  const int n_tiles = (n_pts + PT_TILE - 1) / PT_TILE;
  cudaStream_t s = (cudaStream_t)stream;
  pt_narrow_rb_loss_grad_kernel<Head, H><<<n_tiles, kPtRbThreads, smem, s>>>(
      net, a0, wpack, n_pts, args, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, n_tiles, 1 + net.n_weights, out, s);
}

}  // namespace
