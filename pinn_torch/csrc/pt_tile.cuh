// Block-tiled kernels of the fused PINN losses (sm_90a), for nets with
// wide hidden layers: the Schrodinger net [2, 100x4, 2] and any hidden
// width up to 128.  pt_tile_loss_grad_kernel computes the loss and
// every parameter gradient (schrodinger_train.cu's
// schrodinger_sse_grad[_bf16]), pt_tile_loss_kernel the loss alone
// (schrodinger_sse[_bf16]), with pt_mlp.cuh's Head, PtNet, weight pack,
// stream type S, rounding points and buffers, shaped as the TPU kernels
// (_make_fwd_bwd_kernel and _fwd_kernel, pinn/ops/pallas_schrodinger.py:95
// and :70) shape them: each layer of a tile is one matrix product over
// the four streams.  pt_tile_eval_kernel runs the loss-only kernel's
// forward (f32) and stores per-point values from warp 0 in place of the
// loss sum: residual_eval.cu's schrodinger_residual launches it
// (replacing _schrodinger_kernel_fmajor, pinn/ops/pallas_residual.py:248)
// with an input policy that normalises the raw points and builds the
// tangent rows from Wt_0; at its grid's 51,456 points that is 1,608
// tiles on 132 blocks, 12 full rounds and one 18% full: 0.60 ms of
// device time, of which the last round 0.04 ms (PERF.md; an NVIDIA H100
// 80GB HBM3 at 700 W).
//
// Why.  One thread a point (the port's first design of these kernels)
// keeps a point's 2-3 x 4W stream floats in local memory and chains
// scalar FMAs on them; at width 100 the weights (124 KB) leave one
// block of 5 warps an SM.  Here the streams of a tile live in shared
// memory and every thread of a block works on every layer product.
//
// Tile.  A block owns T = PT_TILE = 32 points, the points of one row
// of the partials that pt_mlp.cuh's callers allocate, so the buffers of
// the C interface cover every block.  Its activations are the TPU
// kernel's a_cat: h rows (neurons) of 4T columns, stream-major then
// point (value, d/dx, d2/dx2, d/dt), row stride 4T + 4 floats (so that
// 16-byte loads of eight consecutive rows fall in eight different bank
// groups).  Hidden widths are padded to a multiple of 4 with zero
// weights and zero activations, which adds exactly 0 everywhere.
//
// Shared memory (PtTileSmem, the one carve-up): two activation buffers
// of hp x (4T + 4) floats (hp = the widest hidden layer, padded), the
// current layer's Wt (at most hp x hp, row stride padded), the output
// streams U and then their adjoints gU (kOut x 4T), with gradients the
// output bias adjoints (kOut x T), and per point the loss and the two
// inputs.  At T = 32: 147,264 bytes at width 100 and 202,368 at 128
// with gradients, 147,008 and 202,112 without, of the 232,448 a block
// may have, so one block of 800 threads an SM.  The weight pack is not
// resident: each layer's Wt is copied in (S-rounded) in the phase
// before its product, from L2.
//
// Products, 4 x 4 outputs a thread from 16-byte shared loads, f32
// FFMA, each output summed in one fixed order:
//   forward  Z (h x 4T)   = Wt (h x hin) . A (hin x 4T)
//   weights  dW (h x hin) += gz (h x 4T) . A^T, depth 4T
//   inputs   G (hin x 4T) = Wt^T . gz, written over A's buffer
// The elementwise passes (bias, tanh, stream recombination; the
// adjoint of that; the rematerialised layer inputs) run one thread per
// (neuron, point) with pt_streams / pt_gz, the math of pt_narrow.cuh's
// per-point loops.  The forward (pt_tile_forward) is one template for
// the three kernels; the loss-only and eval kernels run it with nothing
// saved and have no backward.  Its input policy In reads the points and
// the tangent rows (PtTilePackIn, the default: the loss kernels' a0 and
// pack).  Each of its sums is an fmaf chain over the inputs in
// ascending order, as in pt_narrow.cuh's forward (a zero-padded column
// leaves a nonzero sum as it is), so a residual does not depend on the
// grid.
//
// Saved activations (loss+grad).  (t, z1, z11, z2) of every hidden
// neuron go to the block's own slot of ws, [slot][layer][stream]
// [neuron][point] with T points a row.  Blocks are persistent (grid =
// min(tiles, SMs x blocks an SM)); block b takes tiles b, b + grid, ...
// and reuses its slot for each, so the workspace in use is grid x
// ws_rows x T values (27 MB at f32 for 132 slots at the flagship),
// which stays in the 50 MB L2.
//
// Partials without atomics.  Block b owns row b of partials [grid, 1 +
// n_weights] (loss+grad) or [grid] (loss only): its first tile stores
// its sums there, each later tile adds its own by read-add-write in the
// block's fixed tile order, and pt_reduce sums the grid rows in a
// tree fixed by their count.  Every sum over points or streams inside
// a tile has a fixed order too, so two launches on the same inputs and
// card give bitwise-equal results, and the two kernels give the same
// loss bit for bit when their grids are equal (at widths 100 and 128
// both run one block an SM).
//
// Precision: IEEE f32 (fmaf, tanhf), no TF32, no fast math; with S =
// __nv_bfloat16 the roundings of pt_mlp.cuh's header, at the same
// points.  Heads with extra accumulators (kExtra > 0) are not taken.

#pragma once

#include "pt_mlp.cuh"

#include <mutex>

namespace {

// Threads a block: 25 warps, one 4 x 4 output tile a thread in one
// pass of a width-100 layer product (PERF.md records the H100 sweep of
// 256 to 1024 threads, and of 16-point tiles, that chose it).
constexpr int kPtTileThreads = 800;

__host__ __device__ __forceinline__ int pt_pad4(int n) { return (n + 3) & ~3; }

// The carve-up of a block's shared memory at hidden width hp (padded)
// and n_out outputs, in floats from its start, in order; the kernels
// and their launches take it from here alone.
struct PtTileSmem {
  int buf0, buf1, w, u, gb, l, x, floats;
  __host__ __device__ __forceinline__ PtTileSmem(int hp, int n_out,
                                                 bool grads) {
    constexpr int T = PT_TILE, LD = 4 * T + 4;
    buf0 = 0;                           // activations
    buf1 = buf0 + hp * LD;              // activations
    w = buf1 + hp * LD;                 // the current layer's Wt
    u = w + hp * hp;                    // U, then the rounded gU
    gb = u + n_out * 4 * T;             // output bias adjoints (grads)
    l = gb + (grads ? n_out * T : 0);   // per-point loss
    x = l + T;                          // the inputs, rounded
    floats = x + 2 * T;
  }
};

__device__ __forceinline__ void pt_tile_add(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

__device__ __forceinline__ float4 pt_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The elementwise math of the forward and backward, which pt_narrow.cuh
// keeps as inline copies of its own: routing the per-point loops of the
// port's first, one-thread-a-point kernels through these helpers
// changed a loss+grad kernel's code (56 to 48 registers) and made it
// 1.5x slower on the H100 (chip_smoke.py, phase 3).
//
// A hidden neuron's four output streams from its tanh value t and its
// pre-activation tangents (z1, z11, z2), S-rounded: the recombination
// of the TPU kernels' _layer_fwd.
template <class S>
__device__ __forceinline__ void pt_streams(float t, float z1, float z11,
                                           float z2, float o[4]) {
  using St = PtStream<S>;
  const float sp = 1.0f - t * t;
  const float spp = -2.0f * t * sp;
  o[0] = St::rnd(t);
  o[1] = St::rnd(sp * z1);
  o[2] = St::rnd(spp * z1 * z1 + sp * z11);
  o[3] = St::rnd(sp * z2);
}

// Adjoints gz of a hidden neuron's pre-activation streams from its
// saved (t, z1, z11, z2) and the adjoints g of its four outputs,
// S-rounded (_layer_bwd of the TPU kernels).
template <class S>
__device__ __forceinline__ void pt_gz(float t, float z1, float z11, float z2,
                                      const float g[4], float gz[4]) {
  using St = PtStream<S>;
  const float sp = 1.0f - t * t;
  const float spp = -2.0f * t * sp;
  const float gt = g[0] + g[1] * (-2.0f * t * z1)
                   + g[2] * ((6.0f * t * t - 2.0f) * z1 * z1 - 2.0f * t * z11)
                   + g[3] * (-2.0f * t * z2);
  gz[0] = St::rnd(sp * gt);
  gz[1] = St::rnd(g[1] * sp + g[2] * (2.0f * spp * z1));
  gz[2] = St::rnd(g[2] * sp);
  gz[3] = St::rnd(g[3] * sp);
}

// w_s <- Wt_l, S-rounded: hout rows (padded to 4 for a hidden layer)
// of pt_pad4(hin) columns, zero past the real ones.
template <class S>
__device__ void pt_tile_load_w(const PtNet& net, int l,
                               const float* __restrict__ wpack, float* w_s) {
  const int hin = net.width[l], hout = net.width[l + 1];
  const int ld = pt_pad4(hin);
  const int rows = l == net.n_layers - 1 ? hout : pt_pad4(hout);
  const float* W = wpack + net.w_off[l];
  for (int i = threadIdx.x; i < rows * ld; i += blockDim.x) {
    const int j = i / ld, k = i - j * ld;
    w_s[i] = (j < hout && k < hin) ? PtStream<S>::rnd(W[j * hin + k]) : 0.0f;
  }
}

// z[j][m] = sum_k w[j][k] a[k][m] for j < hp, k < ld (w's row stride).
__device__ __forceinline__ void pt_tile_fwd_product(const float* w, int ld,
                                                    const float* a, float* z,
                                                    int hp) {
  // CT: column tiles of 4.
  constexpr int T = PT_TILE, LD = 4 * T + 4, CT = T;
  for (int id = threadIdx.x; id < (hp / 4) * CT; id += blockDim.x) {
    const int jt = id / CT, ct = id - jt * CT;
    const float* wr = w + 4 * jt * ld;
    const float* ac = a + 4 * ct;
    float acc[4][4] = {};
    for (int k = 0; k < ld; k += 4) {
      float4 wv[4], av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i] = pt_ld4(wr + i * ld + k);
        av[i] = pt_ld4(ac + (k + i) * LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wk[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(wk[kk], av[kk].x, acc[i][0]);
          acc[i][1] = fmaf(wk[kk], av[kk].y, acc[i][1]);
          acc[i][2] = fmaf(wk[kk], av[kk].z, acc[i][2]);
          acc[i][3] = fmaf(wk[kk], av[kk].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(z + (4 * jt + i) * LD + 4 * ct) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// g_in[k][m] = sum_j w[j][k] gz[j][m] for k < ld (w's row stride), j < hp.
__device__ __forceinline__ void pt_tile_adj_product(const float* w, int ld,
                                                    const float* gz,
                                                    float* g_in, int hp) {
  constexpr int T = PT_TILE, LD = 4 * T + 4, CT = T;
  for (int id = threadIdx.x; id < (ld / 4) * CT; id += blockDim.x) {
    const int kt = id / CT, ct = id - kt * CT;
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = 0; j < hp; ++j) {
      const float4 wv = pt_ld4(w + j * ld + 4 * kt);
      const float4 gv = pt_ld4(gz + j * LD + 4 * ct);
      const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(wk[i], gv.x, acc[i][0]);
        acc[i][1] = fmaf(wk[i], gv.y, acc[i][1]);
        acc[i][2] = fmaf(wk[i], gv.z, acc[i][2]);
        acc[i][3] = fmaf(wk[i], gv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(g_in + (4 * kt + i) * LD + 4 * ct) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// dst[j * hin + k] (+)= sum_m gz[j][m] a[k][m] for j < h, k < hin.  A
// thread owns rows jt + i * JT and columns kt + c * KT, so the a rows a
// warp loads at once are consecutive (distinct bank groups).
__device__ __forceinline__ void pt_tile_wgrad(const float* gz, const float* a,
                                              int h, int hin, float* dst,
                                              bool first) {
  constexpr int T = PT_TILE, M = 4 * T, LD = M + 4;
  const int JT = pt_pad4(h) / 4, KT = pt_pad4(hin) / 4;
  for (int id = threadIdx.x; id < JT * KT; id += blockDim.x) {
    const int jt = id / KT, kt = id - jt * KT;
    float acc[4][4] = {};
    for (int m = 0; m < M; m += 4) {
      float4 gv[4], av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gv[i] = pt_ld4(gz + (jt + i * JT) * LD + m);
        av[i] = pt_ld4(a + (kt + i * KT) * LD + m);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = acc[i][c];
          s = fmaf(gv[i].x, av[c].x, s);
          s = fmaf(gv[i].y, av[c].y, s);
          s = fmaf(gv[i].z, av[c].z, s);
          acc[i][c] = fmaf(gv[i].w, av[c].w, s);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + i * JT, k = kt + c * KT;
        if (j < h && k < hin) pt_tile_add(dst + j * hin + k, acc[i][c], first);
      }
    }
  }
}

// g <- the adjoints of hidden layer l's pre-activation streams, in
// place: g holds the adjoints of the layer's outputs, ws slot its
// saved (t, z1, z11, z2).  Padded rows get 0.
template <class S>
__device__ void pt_tile_gz(const PtNet& net, int l, const S* slot, float* g) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, LD = 4 * T + 4;
  const int h = net.width[l + 1];
  for (int idx = threadIdx.x; idx < pt_pad4(h) * T; idx += blockDim.x) {
    const int j = idx / T, p = idx - j * T;
    float* gj = g + j * LD + p;
    float gz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (j < h) {
      const S* sv = slot + (size_t)(net.s_off[l] + j) * T + p;
      const float go[4] = {gj[0], gj[T], gj[2 * T], gj[3 * T]};
      pt_gz<S>(St::get(sv[0]), St::get(sv[h * T]), St::get(sv[2 * h * T]),
               St::get(sv[3 * h * T]), go, gz);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) gj[s * T] = gz[s];
  }
}

// What pt_tile_forward reads besides the pack's Wt and b: the loss
// kernels' inputs, a0 (2, N) holding the normalised points and the
// first layer's tangent rows from the pack.  Another policy
// (residual_eval.cu's) normalises raw points (2, N) and builds the
// tangent rows from Wt_0; it has the same members.
struct PtTilePackIn {
  __device__ __forceinline__ float x0(const float* a0, int, int col) const {
    return a0[col];
  }
  __device__ __forceinline__ float x1(const float* a0, int n_pts,
                                      int col) const {
    return a0[n_pts + col];
  }
  template <class S>
  __device__ __forceinline__ float z1(const PtNet& net,
                                      const float* __restrict__ wpack,
                                      int j) const {
    return PtStream<S>::rnd(wpack[net.z1_off + j]);
  }
  template <class S>
  __device__ __forceinline__ float z2(const PtNet& net,
                                      const float* __restrict__ wpack,
                                      int j) const {
    return PtStream<S>::rnd(wpack[net.z2_off + j]);
  }
};

// The forward of tile `tile`, the TPU kernels' _layer_fwd on a_cat:
// x_s <- its two inputs, S-rounded; layer 0 elementwise; each hidden
// layer one product over the 4T columns, then bias, tanh and the
// stream recombination; u_s <- the output streams U (f32, the bias on
// the value stream).  On return cur holds the last hidden layer's
// outputs, nxt is the other activation buffer and w_s holds Wt_out.
// With kSave each hidden neuron's (t, z1, z11, z2) go to slot.  kSave
// is a template argument: with a runtime test the compiler keeps both
// versions of each loop (one thread a point, a runtime test of ws made
// a loss+grad kernel 1.7x slower on the H100).  `in` reads the inputs
// and the tangent rows.
template <int NO, class S, bool kSave, class In = PtTilePackIn>
__device__ __forceinline__ void pt_tile_forward(
    const PtNet& net, const float* __restrict__ a0,
    const float* __restrict__ wpack, int n_pts, int tile, float* smem,
    const PtTileSmem& sm, S* slot, float*& cur, float*& nxt,
    const In& in = In()) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, M = 4 * T, LD = M + 4;
  float* const w_s = smem + sm.w;
  float* const u_s = smem + sm.u;
  float* const x_s = smem + sm.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int L = net.n_layers - 1;   // the output layer
  auto w_at = [&](int i) { return St::rnd(wpack[i]); };

  for (int p = tid; p < T; p += nth) {
    const int col = tile * T + p;
    const bool live = col < n_pts;
    x_s[p] = St::rnd(live ? in.x0(a0, n_pts, col) : 0.0f);
    x_s[T + p] = St::rnd(live ? in.x1(a0, n_pts, col) : 0.0f);
  }
  pt_tile_load_w<S>(net, 1, wpack, w_s);
  __syncthreads();

  // ---- layer 0: two inputs, constant tangent rows, z11 = 0 ----
  cur = smem + sm.buf0;
  nxt = smem + sm.buf1;
  {
    const int h = net.width[1];
    for (int idx = tid; idx < pt_pad4(h) * T; idx += nth) {
      const int j = idx / T, p = idx - j * T;
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < h) {
        const float zv = w_at(net.w_off[0] + 2 * j) * x_s[p]
                         + w_at(net.w_off[0] + 2 * j + 1) * x_s[T + p]
                         + w_at(net.b_off[0] + j);
        const float z1 = in.template z1<S>(net, wpack, j);
        const float z2 = in.template z2<S>(net, wpack, j);
        const float t = tanhf(zv);
        if (kSave) {
          S* sv = slot + (size_t)(net.s_off[0] + j) * T + p;
          sv[0] = St::put(t);
          sv[h * T] = St::put(z1);
          sv[2 * h * T] = St::put(0.0f);
          sv[3 * h * T] = St::put(z2);
        }
        const float sp = 1.0f - t * t;
        const float spp = -2.0f * t * sp;
        o[0] = St::rnd(t);
        o[1] = St::rnd(sp * z1);
        o[2] = St::rnd(spp * z1 * z1);
        o[3] = St::rnd(sp * z2);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) cur[j * LD + s * T + p] = o[s];
    }
  }
  __syncthreads();

  // ---- hidden layers 1 .. L-1 ----
  for (int l = 1; l < L; ++l) {
    const int ld = pt_pad4(net.width[l]), h = net.width[l + 1];
    pt_tile_fwd_product(w_s, ld, cur, nxt, pt_pad4(h));
    __syncthreads();
    for (int idx = tid; idx < pt_pad4(h) * T; idx += nth) {
      const int j = idx / T, p = idx - j * T;
      float* zj = nxt + j * LD + p;
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < h) {
        const float zv = zj[0] + w_at(net.b_off[l] + j);
        const float z1 = zj[T], z11 = zj[2 * T], z2 = zj[3 * T];
        const float t = tanhf(zv);
        if (kSave) {
          S* sv = slot + (size_t)(net.s_off[l] + j) * T + p;
          sv[0] = St::put(t);
          sv[h * T] = St::put(z1);
          sv[2 * h * T] = St::put(z11);
          sv[3 * h * T] = St::put(z2);
        }
        pt_streams<S>(t, z1, z11, z2, o);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) zj[s * T] = o[s];
    }
    pt_tile_load_w<S>(net, l + 1, wpack, w_s);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // ---- output layer ----
  const int hin = net.width[L], ld = pt_pad4(hin);
  for (int idx = tid; idx < NO * M; idx += nth) {
    const int o = idx / M, m = idx - o * M;
    const float* wo = w_s + o * ld;
    float u = 0.0f;
    for (int k = 0; k < hin; ++k) u = fmaf(wo[k], cur[k * LD + m], u);
    u_s[idx] = m < T ? u + w_at(net.b_off[L] + o) : u;
  }
  __syncthreads();
}

// Loss and every gradient; tiles of T points, one partials row a block.
template <class Head, class S>
__global__ void __launch_bounds__(kPtTileThreads)
pt_tile_loss_grad_kernel(PtNet net, int hp_max,
                         const float* __restrict__ a0,
                         const float* __restrict__ wpack, int n_pts,
                         typename Head::Args args, S* __restrict__ ws,
                         float* __restrict__ partials) {
  static_assert(Head::kExtra == 0, "pt_tile takes heads without extras");
  using St = PtStream<S>;
  constexpr int T = PT_TILE, M = 4 * T, LD = M + 4, NO = Head::kOut;
  extern __shared__ float4 pt_tile_buf[];
  float* const smem = reinterpret_cast<float*>(pt_tile_buf);
  const PtTileSmem sm(hp_max, NO, true);
  float* const w_s = smem + sm.w;
  float* const u_s = smem + sm.u;
  float* const gb_s = smem + sm.gb;
  float* const l_s = smem + sm.l;
  float* const x_s = smem + sm.x;

  const int tid = threadIdx.x, nth = blockDim.x;
  const int L = net.n_layers - 1;   // the output layer
  const int n_tiles = (n_pts + T - 1) / T;
  S* const slot = ws + (size_t)blockIdx.x * net.ws_rows * T;
  float* const loss_out = partials + (size_t)blockIdx.x * (1 + net.n_weights);
  float* const grad = loss_out + 1;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    float* cur;
    float* nxt;
    pt_tile_forward<NO, S, true>(net, a0, wpack, n_pts, tile, smem, sm,
                                 slot, cur, nxt);

    // ---- head ----
    const int hin = net.width[L], ld = pt_pad4(hin);
    for (int p = tid; p < T; p += nth) {
      const int col = tile * T + p;
      const typename Head::Point pt = Head::load(args, n_pts, col, col < n_pts);
      float U[NO][4], gU[NO][4], ex[1];
      for (int o = 0; o < NO; ++o) {
        for (int s = 0; s < 4; ++s) U[o][s] = u_s[o * M + s * T + p];
      }
      l_s[p] = Head::eval(args, pt, U, gU, ex);
      for (int o = 0; o < NO; ++o) {
        gb_s[o * T + p] = Head::kRoundedBias ? St::rnd(gU[o][0]) : gU[o][0];
        for (int s = 0; s < 4; ++s) u_s[o * M + s * T + p] = St::rnd(gU[o][s]);
      }
    }
    __syncthreads();
    // Sums over the tile; nxt <- the last hidden layer's output
    // adjoints, Wt_out^T gU.
    if (tid == 0) {
      float s = 0.0f;
      for (int p = 0; p < T; ++p) s += l_s[p];
      pt_tile_add(loss_out, s, first);
    }
    for (int o = tid; o < NO; o += nth) {
      float s = 0.0f;
      for (int p = 0; p < T; ++p) s += gb_s[o * T + p];
      pt_tile_add(grad + net.b_off[L] + o, s, first);
    }
    for (int idx = tid; idx < NO * hin; idx += nth) {
      const int o = idx / hin, k = idx - o * hin;
      float s = 0.0f;
      for (int m = 0; m < M; m += 4) {
        const float4 g = pt_ld4(u_s + o * M + m);
        const float4 a = pt_ld4(cur + k * LD + m);
        s = fmaf(g.x, a.x, s);
        s = fmaf(g.y, a.y, s);
        s = fmaf(g.z, a.z, s);
        s = fmaf(g.w, a.w, s);
      }
      pt_tile_add(grad + net.w_off[L] + idx, s, first);
    }
    for (int idx = tid; idx < ld * M; idx += nth) {
      const int k = idx / M, m = idx - k * M;
      float a = w_s[k] * u_s[m];
      for (int o = 1; o < NO; ++o) a = fmaf(w_s[o * ld + k], u_s[o * M + m], a);
      nxt[k * LD + m] = a;
    }
    __syncthreads();

    // ---- hidden layers L-1 .. 1: g holds the layer's output adjoints ----
    float* g = nxt;
    float* a = cur;
    for (int l = L - 1; l >= 1; --l) {
      const int h = net.width[l + 1], hin_l = net.width[l];
      pt_tile_gz<S>(net, l, slot, g);
      // a <- this layer's inputs, rematerialised from layer l-1.
      for (int idx = tid; idx < pt_pad4(hin_l) * T; idx += nth) {
        const int k = idx / T, p = idx - k * T;
        float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k < hin_l) {
          const S* sv = slot + (size_t)(net.s_off[l - 1] + k) * T + p;
          pt_streams<S>(St::get(sv[0]), St::get(sv[hin_l * T]),
                        St::get(sv[2 * hin_l * T]), St::get(sv[3 * hin_l * T]),
                        o);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) a[k * LD + s * T + p] = o[s];
      }
      pt_tile_load_w<S>(net, l, wpack, w_s);
      __syncthreads();
      pt_tile_wgrad(g, a, h, hin_l, grad + net.w_off[l], first);
      for (int j = tid; j < h; j += nth) {
        float s = 0.0f;
        for (int p = 0; p < T; ++p) s += g[j * LD + p];
        pt_tile_add(grad + net.b_off[l] + j, s, first);
      }
      __syncthreads();
      pt_tile_adj_product(w_s, pt_pad4(hin_l), g, a, pt_pad4(h));
      __syncthreads();
      float* tmp = g;
      g = a;
      a = tmp;
    }

    // ---- layer 0: W0 sees only the value stream; the tangent rows'
    // adjoints are column sums of gz_1 and gz_2 ----
    pt_tile_gz<S>(net, 0, slot, g);
    __syncthreads();
    for (int j = tid; j < net.width[1]; j += nth) {
      const float* gj = g + j * LD;
      float c0 = 0.0f, c1 = 0.0f, cb = 0.0f, cz1 = 0.0f, cz2 = 0.0f;
      for (int p = 0; p < T; ++p) {
        c0 = fmaf(gj[p], x_s[p], c0);
        c1 = fmaf(gj[p], x_s[T + p], c1);
        cb += gj[p];
        cz1 += gj[T + p];
        cz2 += gj[3 * T + p];
      }
      pt_tile_add(grad + net.w_off[0] + 2 * j, c0, first);
      pt_tile_add(grad + net.w_off[0] + 2 * j + 1, c1, first);
      pt_tile_add(grad + net.b_off[0] + j, cb, first);
      pt_tile_add(grad + net.z1_off + j, cz1, first);
      pt_tile_add(grad + net.z2_off + j, cz2, first);
    }
    __syncthreads();
  }
}

// The loss alone, in pt_tile_loss_grad_kernel's tiles, grid and order:
// its forward with nothing saved, Head::eval a point (one warp, a point
// a lane), the tile's sum in point order added to the block's partial.
// At the same grid the two kernels' losses are bitwise equal.
template <class Head, class S>
__global__ void __launch_bounds__(kPtTileThreads)
pt_tile_loss_kernel(PtNet net, int hp_max, const float* __restrict__ a0,
                    const float* __restrict__ wpack, int n_pts,
                    typename Head::Args args, float* __restrict__ partials) {
  static_assert(Head::kExtra == 0, "pt_tile takes heads without extras");
  static_assert(kPtTileThreads >= PT_TILE, "a tile's points in one pass");
  constexpr int T = PT_TILE, M = 4 * T, NO = Head::kOut;
  extern __shared__ float4 pt_tile_buf[];
  float* const smem = reinterpret_cast<float*>(pt_tile_buf);
  const PtTileSmem sm(hp_max, NO, false);
  const float* const u_s = smem + sm.u;
  float* const l_s = smem + sm.l;

  const int tid = threadIdx.x;
  const int n_tiles = (n_pts + T - 1) / T;
  float* const loss_out = partials + blockIdx.x;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    float* cur;
    float* nxt;
    pt_tile_forward<NO, S, false>(net, a0, wpack, n_pts, tile, smem, sm,
                                  static_cast<S*>(nullptr), cur, nxt);
    // Only warp 0 touches l_s and the partial; the next tile writes
    // u_s after barriers that warp 0 reaches first.
    if (tid < T) {
      const int p = tid, col = tile * T + p;
      const typename Head::Point pt = Head::load(args, n_pts, col, col < n_pts);
      float U[NO][4], gU[NO][4], ex[1];
      for (int o = 0; o < NO; ++o) {
        for (int s = 0; s < 4; ++s) U[o][s] = u_s[o * M + s * T + p];
      }
      l_s[p] = Head::eval(args, pt, U, gU, ex);
    }
    __syncwarp();
    if (tid == 0) {
      float s = 0.0f;
      for (int p = 0; p < T; ++p) s += l_s[p];
      pt_tile_add(loss_out, s, first);
    }
  }
}

// Head's per-point values (Head::store at out) in pt_tile_loss_kernel's
// tiles, grid and order: its forward (f32 streams, nothing saved) on
// In's inputs, then in warp 0, a lane a point, each live point's output
// streams from u_s.  No sum crosses points: no partials.
template <class Head, class In>
__global__ void __launch_bounds__(kPtTileThreads)
pt_tile_eval_kernel(PtNet net, int hp_max, In in, const float* __restrict__ X,
                    const float* __restrict__ wpack, int n_pts,
                    typename Head::Args args, float* __restrict__ out) {
  static_assert(kPtTileThreads >= PT_TILE, "a tile's points in one pass");
  constexpr int T = PT_TILE, M = 4 * T, NO = Head::kOut;
  extern __shared__ float4 pt_tile_buf[];
  float* const smem = reinterpret_cast<float*>(pt_tile_buf);
  const PtTileSmem sm(hp_max, NO, false);
  const float* const u_s = smem + sm.u;

  const int p = threadIdx.x;
  const int n_tiles = (n_pts + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float* cur;
    float* nxt;
    pt_tile_forward<NO, float, false, In>(net, X, wpack, n_pts, tile, smem,
                                          sm, static_cast<float*>(nullptr),
                                          cur, nxt, in);
    // Only warp 0 reads u_s; the next tile writes it after barriers
    // that warp 0 reaches first.
    const int col = tile * T + p;
    if (p < T && col < n_pts) {
      float U[NO][4];
      for (int o = 0; o < NO; ++o) {
        for (int s = 0; s < 4; ++s) U[o][s] = u_s[o * M + s * T + p];
      }
      Head::store(args, U, out, n_pts, col);
    }
  }
}

// The launch shape of one kernel instance on one device at one hidden
// width hp (padded): its dynamic shared memory, the SM count and the
// blocks an SM.  Each instance keeps the last one it launched with in
// its own PtTileCache, so the attribute is set and the occupancy asked
// only when the device or the width changes.
struct PtTileShape {
  int dev = -1, hp = 0, n_sm = 0, per_sm = 0;
  size_t smem = 0;
};

struct PtTileCache {
  std::mutex mu;
  PtTileShape last;
};

// The net, launch shape and grid of a tiled kernel over n_pts points at
// hidden width <= max_width: grid = min(tiles, SMs x blocks an SM).  A
// tile is one partials row's points, so a block's slot and partials row
// fit the C interface's buffers (ceil(n_pts / 32) rows) while the grid
// is at most the tile count; a grid past them is refused.
int pt_tile_plan(const int* widths, int n_layers, int n_out, int max_width,
                 int n_pts, const void* kernel, bool grads,
                 PtTileCache* cache, PtNet* net, PtTileShape* sh,
                 int* grid) {
  constexpr int T = PT_TILE;
  int err = pt_make_net(widths, n_layers, n_out, max_width, net);
  if (err) return err;
  if (n_pts < 1) return (int)cudaErrorInvalidValue;
  int hp = 4;
  for (int l = 1; l < n_layers; ++l) {
    hp = pt_pad4(widths[l]) > hp ? pt_pad4(widths[l]) : hp;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(cache->mu);
    if (cache->last.dev != dev || cache->last.hp != hp) {
      PtTileShape fresh;
      fresh.dev = dev;
      fresh.hp = hp;
      fresh.smem = sizeof(float) * PtTileSmem(hp, n_out, grads).floats;
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fresh.smem);
      if (e == cudaSuccess) {
        e = cudaDeviceGetAttribute(&fresh.n_sm,
                                   cudaDevAttrMultiProcessorCount, dev);
      }
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &fresh.per_sm, kernel, kPtTileThreads, fresh.smem);
      }
      if (e != cudaSuccess) return (int)e;
      if (fresh.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      cache->last = fresh;
    }
    *sh = cache->last;
  }
  const int n_tiles = (n_pts + T - 1) / T;
  const int n_rows = (n_pts + PT_TILE - 1) / PT_TILE;
  const int slots = sh->n_sm * sh->per_sm;
  *grid = n_tiles < slots ? n_tiles : slots;
  if ((size_t)*grid * T > (size_t)n_rows * PT_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Loss, every gradient, through the tiled kernel at hidden width <= W.
// The buffers are pt_narrow_launch_loss_grad's (ws: ws_rows * n_rows *
// 32 values of S; partials: n_rows * (1 + n_weights) floats and
// pt_reduce's scratch, n_rows =
// ceil(n_pts / 32)).  A launch the card refuses (shared memory,
// threads) returns its error; there is no fallback.
template <class Head, int W, class S>
int pt_tile_launch_loss_grad(const int* widths, int n_layers, const float* a0,
                             const float* wpack, int n_pts,
                             typename Head::Args args, S* ws, float* partials,
                             float* out, void* stream) {
  static PtTileCache cache;
  PtNet net;
  PtTileShape sh;
  int grid = 0;
  int err = pt_tile_plan(widths, n_layers, Head::kOut, W, n_pts,
                         (const void*)pt_tile_loss_grad_kernel<Head, S>, true,
                         &cache, &net, &sh, &grid);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  pt_tile_loss_grad_kernel<Head, S><<<grid, kPtTileThreads, sh.smem, s>>>(
      net, sh.hp, a0, wpack, n_pts, args, ws, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, grid, 1 + net.n_weights, out, s);
}

// The loss alone, through the tiled kernel at hidden width <= W.
// partials: n_rows floats and pt_reduce's scratch; out: 1 float.
template <class Head, int W, class S>
int pt_tile_launch_loss(const int* widths, int n_layers, const float* a0,
                        const float* wpack, int n_pts,
                        typename Head::Args args, float* partials,
                        float* out, void* stream) {
  static PtTileCache cache;
  PtNet net;
  PtTileShape sh;
  int grid = 0;
  int err = pt_tile_plan(widths, n_layers, Head::kOut, W, n_pts,
                         (const void*)pt_tile_loss_kernel<Head, S>, false,
                         &cache, &net, &sh, &grid);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  pt_tile_loss_kernel<Head, S><<<grid, kPtTileThreads, sh.smem, s>>>(
      net, sh.hp, a0, wpack, n_pts, args, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, grid, 1, out, s);
}

// Head's per-point values (out: Head::kOut * n_pts floats) through the
// tiled eval kernel at hidden width <= W, with In's inputs (X, wpack:
// Wt_l then b_l, no tangent rows).  No fallback, as above.
template <class Head, int W, class In>
int pt_tile_launch_eval(const int* widths, int n_layers, const In& in,
                        const float* X, const float* wpack, int n_pts,
                        typename Head::Args args, float* out, void* stream) {
  static PtTileCache cache;
  PtNet net;
  PtTileShape sh;
  int grid = 0;
  int err = pt_tile_plan(widths, n_layers, Head::kOut, W, n_pts,
                         (const void*)pt_tile_eval_kernel<Head, In>, false,
                         &cache, &net, &sh, &grid);
  if (err) return err;
  pt_tile_eval_kernel<Head, In><<<grid, kPtTileThreads, sh.smem,
                                  (cudaStream_t)stream>>>(
      net, sh.hp, in, X, wpack, n_pts, args, out);
  return (int)cudaGetLastError();
}

}  // namespace
