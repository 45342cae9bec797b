// Block-tiled kernels of the fused Burgers losses (sm_90a) for nets
// with narrow hidden layers (width <= 64).
//
// pt_narrow_loss_grad_kernel gives the loss, every parameter gradient
// and a head's extra sums.  Five entries of burgers_train.cu launch it:
// burgers_loss_grad[_bf16] on the inference head (BurgersInfHead),
// burgers_ide_loss_grad[_bf16] on the identification head
// (BurgersIdeHead, two extra accumulators A1, A2) and burgers_sse_grad
// on the v1 residual-SSE head (BurgersSseHead).  On the inference head
// with float32 streams it serves only nets whose hidden layers are not
// all 20 wide; for those ops/fused_train.py launches
// burgers_loss_grad_rb (pt_narrow_rb.cuh's register-blocked kernel, the
// same outputs bit for bit), the faster at every point count measured
// (N = 1,000 to 1,000,100 on an H100), and burgers_loss_grad is its
// reference in the card tests.  pt_narrow_loss_kernel gives the loss
// alone, with the same forward and nothing saved; the five loss-only
// entries launch it on the same heads: burgers_loss[_bf16],
// burgers_ide_loss[_bf16] and burgers_sse.  They replace the TPU
// kernels _make_train_kernel (pinn/ops/pallas_train.py:524),
// _fwd_train_kernel (:576), _make_ide_kernel (:847), _fwd_ide_kernel
// (:906), _make_fwd_bwd_kernel (:305) and _fwd_kernel (:277), and are
// shaped as those are: each layer of a tile is one product over the
// four stacked streams.  They take pt_mlp.cuh's Head, PtNet, weight
// pack, stream type S, rounding points and buffers.
// pt_narrow_eval_kernel runs the loss-only kernel's forward (f32) and
// stores a per-point value in place of the loss sum: residual_eval.cu's
// two Burgers residual entries launch it, each with an input policy
// that normalises the raw points and stages its layout of the weights:
// burgers_residual (replacing _residual_kernel,
// pinn/ops/pallas_residual.py:55) on X (N, 2) and W_l (h_in, h_out),
// transposed as they stage; burgers_residual_fmajor (replacing
// _residual_kernel_fmajor, :107) on X^T (2, N) and W_l^T (h_out, h_in),
// staged as they are.
//
// Why not one thread a point (the port's first design: a thread
// carries a point through every layer).  It gives the inference
// flagship's N = 10,100 points 316 one-warp blocks, 2.4 warps an SM,
// and the identification flagship's N = 2,000 only 63, with nothing to
// hide latency; its
// stream arrays are sized for width 64 (3 KB of local memory a thread,
// 80 floats of each used at width 20); its products are serial fmaf
// chains a thread, with nothing shared across a warp's points; a
// weight gradient summed by
// shuffles is a five-step butterfly over the tile (3,061 of them a warp
// at width 20); and with bf16 streams a rounding sits inside every
// dependency chain.  pt_tile.cuh's layout does not fit width 20 as it
// is (800 threads and one block an SM for 4 x 4 outputs a thread: at
// width 20 most of them would idle).
//
// Tile and block.  A block owns one tile of T = PT_TILE = 32 points,
// the points of one row of the partials that the C interface's callers
// allocate, so the grid is ceil(N / 32) and the buffers cover every
// block.  The loss+grad kernel has kPtNarrowThreads threads; at 42 KB
// of shared memory and 32 registers (width 20) up to five blocks share
// an SM, so the inference flagship's 316 tiles run in one wave on 132
// SMs, and the identification flagship's 63 leave 69 SMs idle.  The
// loss-only and eval kernels have 25 KB at width 20 and a block size
// chosen at launch from the grid and the SM count (kPtNarrowLossThreads
// while blocks share SMs, kPtNarrowLossThreadsFew when each has one to
// itself); the RAR pool's 200,000 points are 6,250 blocks.
// Activations are the TPU kernel's a_cat: a row per neuron,
// stream-major then point (value, d/dx, d2/dx2, d/dt), each stream
// padded to 33 floats and a row to 132, so that a warp reading one
// point of 32 (neuron, stream) rows, as the weight gradients do, hits
// 32 banks.
//
// Shared memory (PtNarrowSmem, the one carve-up), at hp = the widest
// hidden layer: activation buffers of hp rows (three with gradients,
// two without); two weight buffers, each one layer's Wt and b
// (S-rounded as they load, or transposed from W by the residual's
// policy), so the next layer's load shares a phase with this layer's
// product; with gradients the output adjoints gU and the output bias
// adjoints; the two inputs; with gradients the 4 x h x
// hin partial sums of a weight gradient.  With gradients 42,352 bytes
// at [2, 20x8, 1] and 201,104 at [2, 64x14, 1], the widest pack the
// entry points take (its 213 KB of weights would not fit beside the
// buffers, so no pack is resident); without, 24,736 and 101,120.
//
// Phases, each between block barriers; threads take (neuron, point)
// pairs, a warp one neuron and a lane one point, so a weight is a
// warp-wide broadcast and an activation a conflict-free row:
//   forward (pt_narrow_forward, one template for both loss kernels;
//     the eval kernel's pt_narrow_eval_forward has the same phases on
//     an input policy's loads), per hidden layer: the four
//     pre-activation streams as fmaf chains over the inputs k ascending
//     from 0.0f, then + b, tanh and the stream recombination; the
//     loss+grad kernel saves (t, z1, z11, z2) to ws,
//     [layer][stream][neuron][point] at PtNet's row offsets, coalesced
//     over the tile's points, L2-resident;
//   head: one warp, a lane a point: the output streams as fmaf chains
//     over k ascending (pt_narrow_output), Head::eval, the tile's loss
//     summed by pt_warp_sum into its partials row and, with gradients,
//     each of the head's kExtra accumulators likewise into the slots
//     after the weight gradients (a row is 1 + n_weights + kExtra
//     floats); the eval kernel's head stores each live point's value;
//   backward (loss+grad), per hidden layer l = L-1 .. 1:
//     A: the adjoints gz in place over the output adjoints (the TPU
//        kernels' _layer_bwd; fused_train.py's _layer_bwd is the plain
//        version), layer l's inputs rematerialised from ws, Wt_l
//        loaded, the previous layer's weight gradient summed from its
//        parts;
//     B: dW's four parts (one per stream: depth 32 each, an fmaf chain
//        over the points), the bias gradient, and the input adjoints
//        Wt_l^T gz into the free buffer;
//   layer 0: dW0 on the value stream, the tangent rows' adjoints as
//     column sums of gz_1 and gz_2.
// Each point's forward and head are the same expressions in both loss
// kernels, each tile's loss the same pt_warp_sum, and pt_reduce sums
// the tiles in a tree fixed by their count, so the loss of the two
// kernels is the same bit for bit on the same head; the block size
// changes the order of no sum.  The eval kernel's forward makes the same sums in the same order
// whatever its input policy, so the two Burgers residual layouts give
// the same values bit for bit on the same points and weights.
// Every gradient is a fixed-order sum (the four stream parts added in
// stream order), no atomics: two launches on the same inputs are
// bitwise equal.
//
// bf16 streams (S = __nv_bfloat16): each value is rounded once, where
// pt_mlp.cuh's header says, as it is stored to a shared buffer or to
// ws; the products read f32 values that hold rounded numbers.  No
// conversion sits inside a product's dependency chain.
//
// Bound: at the inference flagship ~0.7 GFLOP of FFMA a loss+grad call
// (0.0115 ms at 67 TFLOP/s); the products read both operands from
// shared memory (5 loads for 4 FMAs in the forward and input adjoints,
// 2 for 1 in the weight gradients): by count ~55,000 shared-memory
// wavefronts a tile, at one a cycle an SM, against ~8,400 cycles of
// FFMA dispatch, so the shared-memory pipe, not the FMA units, bounds a
// block while several blocks share an SM; a block alone on its SM (the
// identification flagship's 63 tiles) is bound by its phases' latency
// instead.  The loss-only and eval calls are a third of the FFMA and
// of the shared-memory loads.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md), by device time: the loss+grad kernel 0.114 ms at the
// inference flagship, 0.071 ms (f32) and 0.062 ms (bf16) at the
// identification flagship; the loss-only kernel 0.031 ms and, with 640
// threads a block, 0.015 ms; the eval kernel 0.39-0.42 ms on the RAR
// pool's 6,250 tiles and 0.061-0.065 ms on the Burgers grid's 800, in
// either layout.
// Precision: IEEE f32 (fmaf, tanhf); build without --use_fast_math.

#pragma once

#include "pt_mlp.cuh"

#include <mutex>

namespace {

// Threads a block: ten warps, two rounds of a width-20 layer's 640
// (neuron, point) pairs.  The sweep of 128 to 640 threads
// (chip_narrow_probe.py --sweep, PERF.md; an NVIDIA H100 80GB HBM3 at
// 700 W) put it first at [2, 20x8, 1], N = 10,100, where 2.4 blocks
// share an SM: 0.109 ms of device time against 0.110-0.116 for 256 and
// 384-640 and 0.145 for 128.  At N = 2,000 (63 blocks, one an SM) more
// threads are faster, 0.044 ms at 640 against 0.067 at 320.
constexpr int kPtNarrowThreads = 320;

// Threads a block of the loss-only kernel, constants of its own (its
// block does a third of the loss+grad kernel's work), chosen at launch:
// kPtNarrowLossThreads, ten warps, two rounds of a width-20 layer's 640
// (neuron, point) pairs, while the grid is larger than the SM count and
// blocks share SMs; kPtNarrowLossThreadsFew, twenty warps, one round,
// when it is not, so that each block has an SM to itself and only its
// phases' latency bounds it.  The block size changes the order of no
// sum.  The sweep of 128 to 640 threads (chip_narrow_probe.py --sweep,
// PERF.md; an NVIDIA H100 80GB HBM3 at 700 W) at [2, 20x8, 1]: at N =
// 10,100 (316 blocks) flat within 5% from 320 up, 128 slowest; at N =
// 2,000 (63 blocks) 0.014-0.015 ms of device time at 640 against
// 0.017-0.021 at 320.
constexpr int kPtNarrowLossThreads = 320;
constexpr int kPtNarrowLossThreadsFew = 640;
static_assert(kPtNarrowLossThreads >= PT_TILE, "a tile's head in one warp");
static_assert(kPtNarrowLossThreadsFew >= kPtNarrowLossThreads,
              "the kernel's __launch_bounds__");

constexpr int kPtNarrowTS = PT_TILE + 1;       // stream stride in a row
constexpr int kPtNarrowLD = 4 * kPtNarrowTS;   // row stride

// The carve-up of a block's shared memory at hidden width hp and n_out
// outputs, with the gradients' buffers (grads) or without, in floats
// from its start, in order; the kernels and their launches take it
// from here alone.  The buffers are found by arithmetic (act(i), w(l)),
// not by indexing an array of offsets, which would put the struct in
// local memory.
struct PtNarrowSmem {
  int act_size, w0, w_size, gu, gb, x, part, floats;
  __host__ __device__ __forceinline__ PtNarrowSmem(int hp, int n_out,
                                                   bool grads) {
    constexpr int T = PT_TILE, LD = kPtNarrowLD;
    const int hw = hp > n_out ? hp : n_out;
    act_size = hp * LD;                   // three activation buffers, or two
    w0 = (grads ? 3 : 2) * act_size;      // two of Wt (h x hin), b (h)
    w_size = hw * ((hp > 2 ? hp : 2) + 1);
    gu = w0 + 2 * w_size;                 // gU, S-rounded (n_out rows)
    gb = gu + (grads ? n_out * LD : 0);   // output bias adjoints
    x = gb + (grads ? n_out * T : 0);     // the inputs, S-rounded
    part = x + 2 * T;                     // 4 parts of a weight gradient
    floats = part + (grads ? 4 * hw * hp : 0);
  }
  __device__ __forceinline__ int act(int i) const { return i * act_size; }
  // The weight buffer of layer l: the two alternate.
  __device__ __forceinline__ int w(int l) const {
    return w0 + (l & 1) * w_size;
  }
};

// w_s <- Wt_l (h x hin, row-major) then b_l (h), S-rounded.
template <class S>
__device__ __forceinline__ void pt_narrow_load_w(const PtNet& net, int l,
                                                 const float* __restrict__ wpack,
                                                 float* w_s) {
  const int n = net.width[l + 1] * (net.width[l] + 1);
  const float* src = wpack + net.w_off[l];   // b_l follows Wt_l in wpack
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    w_s[i] = PtStream<S>::rnd(src[i]);
  }
}

// Hidden layer l >= 1: nxt <- its four output streams from cur and,
// with kSave, ws <- its (t, z1, z11, z2).
template <class S, bool kSave>
__device__ __forceinline__ void pt_narrow_fwd_layer(const PtNet& net, int l,
                                                    const float* w_s,
                                                    const float* cur,
                                                    float* nxt, S* ws,
                                                    int cols, int col0) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  const int hin = net.width[l], h = net.width[l + 1];
  const float* b = w_s + h * hin;
  for (int idx = threadIdx.x; idx < h * T; idx += blockDim.x) {
    const int j = idx / T, p = idx - j * T;
    const float* Wj = w_s + j * hin;
    const float* a = cur + p;
    float zv = 0.0f, z1 = 0.0f, z11 = 0.0f, z2 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < hin; ++k) {
      const float wk = Wj[k];
      const float* ak = a + k * LD;
      zv = fmaf(wk, ak[0 * TS], zv);
      z1 = fmaf(wk, ak[1 * TS], z1);
      z11 = fmaf(wk, ak[2 * TS], z11);
      z2 = fmaf(wk, ak[3 * TS], z2);
    }
    zv += b[j];
    const float t = tanhf(zv);
    const float sp = 1.0f - t * t;
    const float spp = -2.0f * t * sp;
    if (kSave) {
      S* sv = ws + (size_t)(net.s_off[l] + j) * cols + col0 + p;
      sv[0] = St::put(t);
      sv[(size_t)h * cols] = St::put(z1);
      sv[(size_t)2 * h * cols] = St::put(z11);
      sv[(size_t)3 * h * cols] = St::put(z2);
    }
    float* o = nxt + j * LD + p;
    o[0 * TS] = St::rnd(t);
    o[1 * TS] = St::rnd(sp * z1);
    o[2 * TS] = St::rnd(spp * z1 * z1 + sp * z11);
    o[3 * TS] = St::rnd(sp * z2);
  }
}

// g <- the adjoints gz of hidden layer l's pre-activation streams, in
// place over the adjoints of its outputs: the derivative of the stream
// recombination (tanh and its first two derivatives) at the saved (t,
// z1, z11, z2), S-rounded.
template <class S>
__device__ __forceinline__ void pt_narrow_gz(const PtNet& net, int l,
                                             float* g, const S* ws, int cols,
                                             int col0) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  const int h = net.width[l + 1];
  for (int idx = threadIdx.x; idx < h * T; idx += blockDim.x) {
    const int j = idx / T, p = idx - j * T;
    const S* sv = ws + (size_t)(net.s_off[l] + j) * cols + col0 + p;
    const float t = St::get(sv[0]);
    const float z1 = St::get(sv[(size_t)h * cols]);
    const float z11 = St::get(sv[(size_t)2 * h * cols]);
    const float z2 = St::get(sv[(size_t)3 * h * cols]);
    float* gj = g + j * LD + p;
    const float g0 = gj[0 * TS];
    const float g1 = gj[1 * TS];
    const float g2 = gj[2 * TS];
    const float g3 = gj[3 * TS];
    const float sp = 1.0f - t * t;
    const float spp = -2.0f * t * sp;
    const float gt = g0 + g1 * (-2.0f * t * z1)
                     + g2 * ((6.0f * t * t - 2.0f) * z1 * z1 - 2.0f * t * z11)
                     + g3 * (-2.0f * t * z2);
    gj[0 * TS] = St::rnd(sp * gt);
    gj[1 * TS] = St::rnd(g1 * sp + g2 * (2.0f * spp * z1));
    gj[2 * TS] = St::rnd(g2 * sp);
    gj[3 * TS] = St::rnd(g3 * sp);
  }
}

// a <- hidden layer l's output streams, rebuilt from its saved block.
template <class S>
__device__ __forceinline__ void pt_narrow_remat(const PtNet& net, int l,
                                                float* a, const S* ws,
                                                int cols, int col0) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  const int h = net.width[l + 1];
  for (int idx = threadIdx.x; idx < h * T; idx += blockDim.x) {
    const int k = idx / T, p = idx - k * T;
    const S* sv = ws + (size_t)(net.s_off[l] + k) * cols + col0 + p;
    const float tp = St::get(sv[0]);
    const float z1p = St::get(sv[(size_t)h * cols]);
    const float z11p = St::get(sv[(size_t)2 * h * cols]);
    const float z2p = St::get(sv[(size_t)3 * h * cols]);
    const float spp_ = 1.0f - tp * tp;
    const float sppp = -2.0f * tp * spp_;
    float* ak = a + k * LD + p;
    ak[0 * TS] = St::rnd(tp);
    ak[1 * TS] = St::rnd(spp_ * z1p);
    ak[2 * TS] = St::rnd(sppp * z1p * z1p + spp_ * z11p);
    ak[3 * TS] = St::rnd(spp_ * z2p);
  }
}

// part[s][j * hin + k] = sum over the tile's points p, ascending, of
// g[j][s][p] a[k][s][p]: the four stream parts of dW (h x hin).
__device__ __forceinline__ void pt_narrow_wgrad_parts(const float* g,
                                                      const float* a, int h,
                                                      int hin, float* part) {
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  const int n = h * hin;
  for (int idx = threadIdx.x; idx < 4 * n; idx += blockDim.x) {
    const int s = idx & 3, jk = idx >> 2;
    const int j = jk / hin, k = jk - j * hin;
    const float* gr = g + j * LD + s * TS;
    const float* ar = a + k * LD + s * TS;
    float acc = 0.0f;
#pragma unroll 8
    for (int p = 0; p < T; ++p) acc = fmaf(gr[p], ar[p], acc);
    part[s * n + jk] = acc;
  }
}

// dst[jk] = the four parts of a weight gradient of n values, added in
// stream order.
__device__ __forceinline__ void pt_narrow_wgrad_sum(const float* part, int n,
                                                    float* dst) {
  for (int jk = threadIdx.x; jk < n; jk += blockDim.x) {
    dst[jk] = part[jk] + part[n + jk] + part[2 * n + jk] + part[3 * n + jk];
  }
}

// dst[k][s][p] = sum over j < h, ascending, of w[j * hin + k] g[j][s][p]:
// the adjoints of a layer's inputs, Wt^T g per stream.
__device__ __forceinline__ void pt_narrow_adj(const float* w, const float* g,
                                              int h, int hin, float* dst) {
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  for (int idx = threadIdx.x; idx < hin * T; idx += blockDim.x) {
    const int k = idx / T, p = idx - k * T;
    const float* gp = g + p;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
    for (int j = 0; j < h; ++j) {
      const float wjk = w[j * hin + k];
      const float* gj = gp + j * LD;
      s0 = fmaf(wjk, gj[0 * TS], s0);
      s1 = fmaf(wjk, gj[1 * TS], s1);
      s2 = fmaf(wjk, gj[2 * TS], s2);
      s3 = fmaf(wjk, gj[3 * TS], s3);
    }
    float* o = dst + k * LD + p;
    o[0 * TS] = s0;
    o[1 * TS] = s1;
    o[2 * TS] = s2;
    o[3 * TS] = s3;
  }
}

// The forward of tile blockIdx.x (col0 its first point): x_s <- its
// two inputs, S-rounded; layer 0, then each hidden layer, in shared
// memory; with kSave each hidden neuron's (t, z1, z11, z2) to ws.
// Returns the activation buffer that holds the last hidden layer's
// outputs (its index in ic); w(L) then holds Wt_out and b_out.  kSave is
// a template argument: with a runtime test both versions of each loop
// would stay in the code.
template <class S, bool kSave>
__device__ __forceinline__ float* pt_narrow_forward(
    const PtNet& net, const float* __restrict__ a0,
    const float* __restrict__ wpack, int n_pts, float* smem,
    const PtNarrowSmem& sm, S* ws, int cols, int col0, int& ic) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  float* const x_s = smem + sm.x;
  auto wbuf = [&](int l) { return smem + sm.w(l); };
  const int tid = threadIdx.x, nth = blockDim.x;
  const int L = net.n_layers - 1;   // the output layer

  // ---- inputs and Wt_0 ----
  for (int p = tid; p < T; p += nth) {
    const int col = col0 + p;
    const bool live = col < n_pts;
    x_s[p] = St::rnd(live ? a0[col] : 0.0f);
    x_s[T + p] = St::rnd(live ? a0[n_pts + col] : 0.0f);
  }
  pt_narrow_load_w<S>(net, 0, wpack, wbuf(0));
  __syncthreads();

  // ---- layer 0: two inputs, constant tangent rows, z11 = 0 ----
  float* cur = smem + sm.act(0);
  {
    const int h = net.width[1];
    const float* Wt = wbuf(0);
    const float* b = Wt + 2 * h;
    for (int idx = tid; idx < h * T; idx += nth) {
      const int j = idx / T, p = idx - j * T;
      const float x0 = x_s[p], x1 = x_s[T + p];
      const float zv = Wt[2 * j] * x0 + Wt[2 * j + 1] * x1 + b[j];
      const float z1 = St::rnd(wpack[net.z1_off + j]);
      const float z2 = St::rnd(wpack[net.z2_off + j]);
      const float t = tanhf(zv);
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      if (kSave) {
        S* sv = ws + (size_t)(net.s_off[0] + j) * cols + col0 + p;
        sv[0] = St::put(t);
        sv[(size_t)h * cols] = St::put(z1);
        sv[(size_t)2 * h * cols] = St::put(0.0f);
        sv[(size_t)3 * h * cols] = St::put(z2);
      }
      float* o = cur + j * LD + p;
      o[0 * TS] = St::rnd(t);
      o[1 * TS] = St::rnd(sp * z1);
      o[2 * TS] = St::rnd(spp * z1 * z1);
      o[3 * TS] = St::rnd(sp * z2);
    }
    pt_narrow_load_w<S>(net, 1, wpack, wbuf(1));
  }
  __syncthreads();

  // ---- hidden layers 1 .. L-1; Wt_{l+1} loads beside layer l ----
  ic = 0;
  for (int l = 1; l < L; ++l) {
    float* nxt = smem + sm.act(ic ^ 1);
    pt_narrow_fwd_layer<S, kSave>(net, l, wbuf(l), cur, nxt, ws, cols, col0);
    pt_narrow_load_w<S>(net, l + 1, wpack, wbuf(l + 1));
    __syncthreads();
    ic ^= 1;
    cur = nxt;
  }
  return cur;
}

// U[o][s] = sum over k < hin, ascending, of Wt_out[o][k] a[k][s][p],
// plus b_o on the value stream (s = 0): point p's output streams from
// the last hidden layer's outputs a, w_out = Wt_out then b_out.
template <int NO>
__device__ __forceinline__ void pt_narrow_output(const float* w_out,
                                                 const float* a, int p,
                                                 int hin, float U[NO][4]) {
  constexpr int TS = kPtNarrowTS, LD = kPtNarrowLD;
  for (int o = 0; o < NO; ++o) {
    const float* Wo = w_out + o * hin;
    const float* ap = a + p;
    float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
    for (int k = 0; k < hin; ++k) {
      const float wk = Wo[k];
      const float* ak = ap + k * LD;
      u0 = fmaf(wk, ak[0 * TS], u0);
      u1 = fmaf(wk, ak[1 * TS], u1);
      u2 = fmaf(wk, ak[2 * TS], u2);
      u3 = fmaf(wk, ak[3 * TS], u3);
    }
    U[o][0] = u0 + w_out[NO * hin + o];
    U[o][1] = u1;
    U[o][2] = u2;
    U[o][3] = u3;
  }
}

// Loss, every gradient and the head's extras of tile blockIdx.x into
// partials row blockIdx.x (1 + n_weights + kExtra floats).
template <class Head, class S>
__global__ void __launch_bounds__(kPtNarrowThreads)
pt_narrow_loss_grad_kernel(PtNet net, int hp, const float* __restrict__ a0,
                           const float* __restrict__ wpack, int n_pts,
                           typename Head::Args args, S* __restrict__ ws,
                           float* __restrict__ partials) {
  using St = PtStream<S>;
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  constexpr int NO = Head::kOut;
  extern __shared__ float pt_narrow_buf[];
  float* const smem = pt_narrow_buf;
  const PtNarrowSmem sm(hp, NO, true);
  float* const gu_s = smem + sm.gu;
  float* const gb_s = smem + sm.gb;
  float* const x_s = smem + sm.x;
  float* const part_s = smem + sm.part;
  auto wbuf = [&](int l) { return smem + sm.w(l); };

  const int tid = threadIdx.x, nth = blockDim.x;
  const int L = net.n_layers - 1;   // the output layer
  const int tile = blockIdx.x;
  const int col0 = tile * T;
  const int cols = gridDim.x * T;
  float* const part =
      partials + (size_t)tile * (1 + net.n_weights + Head::kExtra) + 1;

  int ic = 0;   // the buffer that holds cur
  float* cur = pt_narrow_forward<S, true>(net, a0, wpack, n_pts, smem, sm,
                                          ws, cols, col0, ic);

  // ---- output layer and head: one warp, a lane a point ----
  const int hin_L = net.width[L];
  if (tid < T) {
    const int p = tid, col = col0 + p;
    const typename Head::Point pt = Head::load(args, n_pts, col, col < n_pts);
    float U[NO][4], gU[NO][4], ex[Head::kExtra + 1];
    pt_narrow_output<NO>(wbuf(L), cur, p, hin_L, U);
    const float loss = Head::eval(args, pt, U, gU, ex);
    const float loss_tile = pt_warp_sum(loss);
    if (p == 0) part[-1] = loss_tile;
    for (int e = 0; e < Head::kExtra; ++e) {
      const float es = pt_warp_sum(ex[e]);
      if (p == 0) part[net.n_weights + e] = es;
    }
    for (int o = 0; o < NO; ++o) {
      gb_s[o * T + p] = Head::kRoundedBias ? St::rnd(gU[o][0]) : gU[o][0];
      for (int s = 0; s < 4; ++s) gu_s[o * LD + s * TS + p] = St::rnd(gU[o][s]);
    }
  }
  __syncthreads();

  // ---- output layer's gradients; the last hidden layer's output
  // adjoints Wt_out^T gU ----
  float* g = smem + sm.act(ic ^ 1);
  pt_narrow_wgrad_parts(gu_s, cur, NO, hin_L, part_s);
  for (int o = tid; o < NO; o += nth) {
    float s = 0.0f;
    for (int p = 0; p < T; ++p) s += gb_s[o * T + p];
    part[net.b_off[L] + o] = s;
  }
  pt_narrow_adj(wbuf(L), gu_s, NO, hin_L, g);
  __syncthreads();
  int prev_off = net.w_off[L], prev_n = NO * hin_L;   // parts to sum
  int ig = ic ^ 1;   // the buffer that holds g

  // ---- hidden layers L-1 .. 1 ----
  for (int l = L - 1; l >= 1; --l) {
    const int h = net.width[l + 1], hin = net.width[l];
    const int ia = ig == 0 ? 1 : 0;   // the two buffers other than g
    const int io = 3 - ig - ia;
    float* a = smem + sm.act(ia);
    pt_narrow_wgrad_sum(part_s, prev_n, part + prev_off);
    pt_narrow_gz<S>(net, l, g, ws, cols, col0);
    pt_narrow_remat<S>(net, l - 1, a, ws, cols, col0);
    pt_narrow_load_w<S>(net, l, wpack, wbuf(l));
    __syncthreads();
    pt_narrow_wgrad_parts(g, a, h, hin, part_s);
    for (int j = tid; j < h; j += nth) {
      float s = 0.0f;
      for (int p = 0; p < T; ++p) s += g[j * LD + p];
      part[net.b_off[l] + j] = s;
    }
    float* g_in = smem + sm.act(io);
    pt_narrow_adj(wbuf(l), g, h, hin, g_in);
    __syncthreads();
    prev_off = net.w_off[l];
    prev_n = h * hin;
    ig = io;
    g = g_in;
  }

  // ---- layer 0: W0 sees only the value stream; the tangent rows'
  // adjoints are column sums of gz_1 and gz_2 ----
  pt_narrow_wgrad_sum(part_s, prev_n, part + prev_off);
  pt_narrow_gz<S>(net, 0, g, ws, cols, col0);
  __syncthreads();
  const int h1 = net.width[1];
  for (int idx = tid; idx < 5 * h1; idx += nth) {
    const int j = idx / 5, q = idx - 5 * j;
    const float* gj = g + j * LD;
    float s = 0.0f;
    if (q < 2) {
      const float* xq = x_s + q * T;
      for (int p = 0; p < T; ++p) s = fmaf(gj[p], xq[p], s);
      part[net.w_off[0] + 2 * j + q] = s;
    } else {
      const float* row = gj + (q == 2 ? 0 : q == 3 ? TS : 3 * TS);
      for (int p = 0; p < T; ++p) s += row[p];
      part[q == 2 ? net.b_off[0] + j : (q == 3 ? net.z1_off : net.z2_off) + j] = s;
    }
  }
}

// The loss alone of tile blockIdx.x into partials[blockIdx.x]: the
// loss+grad kernel's forward with nothing saved, and its head's loss.
template <class Head, class S>
__global__ void __launch_bounds__(kPtNarrowLossThreadsFew)
pt_narrow_loss_kernel(PtNet net, int hp, const float* __restrict__ a0,
                      const float* __restrict__ wpack, int n_pts,
                      typename Head::Args args, float* __restrict__ partials) {
  constexpr int T = PT_TILE, NO = Head::kOut;
  extern __shared__ float pt_narrow_buf[];
  float* const smem = pt_narrow_buf;
  const PtNarrowSmem sm(hp, NO, false);
  const int L = net.n_layers - 1;   // the output layer
  const int col0 = blockIdx.x * T;

  int ic = 0;
  const float* cur = pt_narrow_forward<S, false>(
      net, a0, wpack, n_pts, smem, sm, static_cast<S*>(nullptr), 0, col0, ic);

  // ---- output layer and head: one warp, a lane a point ----
  if (threadIdx.x < T) {
    const int p = threadIdx.x, col = col0 + p;
    const typename Head::Point pt = Head::load(args, n_pts, col, col < n_pts);
    float U[NO][4], gU[NO][4], ex[Head::kExtra + 1];
    pt_narrow_output<NO>(smem + sm.w(L), cur, p, net.width[L], U);
    const float loss_tile = pt_warp_sum(Head::eval(args, pt, U, gU, ex));
    if (p == 0) partials[blockIdx.x] = loss_tile;
  }
}

// The eval kernel's forward of tile blockIdx.x (col0 its first
// point), f32, nothing saved: pt_narrow_forward's phases and
// expressions, with the input policy In reading the points (x0, x1),
// staging each layer's Wt and b (load_w) and giving the first layer's
// tangent rows from the staged Wt_0 (z1, z2).  A forward of its own,
// not a policy argument of pt_narrow_forward: that argument, empty by
// default, still changed two of the loss kernels' instances (an FMUL's
// operands swapped in their SASS).  Returns the buffer that holds the
// last hidden layer's outputs; w(L) then holds Wt_out and b_out.
template <class In>
__device__ __forceinline__ const float* pt_narrow_eval_forward(
    const PtNet& net, const In& in, const float* __restrict__ X,
    const float* __restrict__ wpack, int n_pts, float* smem,
    const PtNarrowSmem& sm, int col0) {
  constexpr int T = PT_TILE, TS = kPtNarrowTS, LD = kPtNarrowLD;
  float* const x_s = smem + sm.x;
  auto wbuf = [&](int l) { return smem + sm.w(l); };
  const int tid = threadIdx.x, nth = blockDim.x;
  const int L = net.n_layers - 1;   // the output layer

  for (int p = tid; p < T; p += nth) {
    const int col = col0 + p;
    const bool live = col < n_pts;
    x_s[p] = live ? in.x0(X, n_pts, col) : 0.0f;
    x_s[T + p] = live ? in.x1(X, n_pts, col) : 0.0f;
  }
  in.load_w(net, 0, wpack, wbuf(0));
  __syncthreads();

  // ---- layer 0: two inputs, constant tangent rows, z11 = 0 ----
  float* cur = smem + sm.act(0);
  {
    const int h = net.width[1];
    const float* Wt = wbuf(0);
    const float* b = Wt + 2 * h;
    for (int idx = tid; idx < h * T; idx += nth) {
      const int j = idx / T, p = idx - j * T;
      const float x0 = x_s[p], x1 = x_s[T + p];
      const float zv = Wt[2 * j] * x0 + Wt[2 * j + 1] * x1 + b[j];
      const float z1 = in.z1(Wt, j);
      const float z2 = in.z2(Wt, j);
      const float t = tanhf(zv);
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      float* o = cur + j * LD + p;
      o[0 * TS] = t;
      o[1 * TS] = sp * z1;
      o[2 * TS] = spp * z1 * z1;
      o[3 * TS] = sp * z2;
    }
    in.load_w(net, 1, wpack, wbuf(1));
  }
  __syncthreads();

  // ---- hidden layers 1 .. L-1; Wt_{l+1} loads beside layer l ----
  int ic = 0;
  for (int l = 1; l < L; ++l) {
    float* nxt = smem + sm.act(ic ^ 1);
    pt_narrow_fwd_layer<float, false>(net, l, wbuf(l), cur, nxt,
                                      static_cast<float*>(nullptr), 0, col0);
    in.load_w(net, l + 1, wpack, wbuf(l + 1));
    __syncthreads();
    ic ^= 1;
    cur = nxt;
  }
  return cur;
}

// The per-point values of tile blockIdx.x: pt_narrow_eval_forward, then
// in warp 0, a lane a point, each live point's output streams and
// Head::store's values at out (no sum across points, no partials).
template <class Head, class In>
__global__ void __launch_bounds__(kPtNarrowLossThreadsFew)
pt_narrow_eval_kernel(PtNet net, int hp, In in, const float* __restrict__ X,
                      const float* __restrict__ wpack, int n_pts,
                      typename Head::Args args, float* __restrict__ out) {
  constexpr int T = PT_TILE, NO = Head::kOut;
  extern __shared__ float pt_narrow_buf[];
  float* const smem = pt_narrow_buf;
  const PtNarrowSmem sm(hp, NO, false);
  const int L = net.n_layers - 1;   // the output layer
  const int col0 = blockIdx.x * T;

  const float* cur =
      pt_narrow_eval_forward<In>(net, in, X, wpack, n_pts, smem, sm, col0);

  const int p = threadIdx.x, col = col0 + p;
  if (p < T && col < n_pts) {
    float U[NO][4];
    pt_narrow_output<NO>(smem + sm.w(L), cur, p, net.width[L], U);
    Head::store(args, U, out, n_pts, col);
  }
}

// The dynamic shared memory of one kernel instance on one device at
// one hidden width, and the device's SM count: each instance keeps the
// last device and size it launched with, so the attribute is set only
// when the device or the size changes, and the SM count read only when
// the device does.
struct PtNarrowCache {
  std::mutex mu;
  int dev = -1;
  size_t smem = 0;
  int n_sm = 0;
};

// What both launches share: the net of a layer list with hidden widths
// <= max_width, its widest hidden layer hp, the dynamic shared memory
// of `kernel` (with or without the gradients' buffers), set on the
// device when it changes, and the device's SM count (n_sm, where not
// null).  Nonzero on what the kernels do not take.
int pt_narrow_plan(const int* widths, int n_layers, int n_out, int max_width,
                   int n_pts, const void* kernel, bool grads,
                   PtNarrowCache* cache, PtNet* net, int* hp, size_t* smem,
                   int* n_sm) {
  int err = pt_make_net(widths, n_layers, n_out, max_width, net);
  if (err) return err;
  if (n_pts < 1) return (int)cudaErrorInvalidValue;
  *hp = 1;
  for (int l = 1; l < n_layers; ++l) *hp = widths[l] > *hp ? widths[l] : *hp;
  *smem = sizeof(float) * PtNarrowSmem(*hp, n_out, grads).floats;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(cache->mu);
  if (cache->dev != dev) {
    e = cudaDeviceGetAttribute(&cache->n_sm, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (cache->dev != dev || cache->smem != *smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return (int)e;
    cache->dev = dev;
    cache->smem = *smem;
  }
  if (n_sm) *n_sm = cache->n_sm;
  return 0;
}

// Loss, every gradient and the head's extras, through the narrow kernel
// at hidden width <= W.  ws: ws_rows * n_tiles * 32 values of S;
// partials: n_tiles * (1 + n_weights + kExtra) floats and pt_reduce's
// scratch; out: 1 + n_weights + kExtra floats, n_tiles = ceil(n_pts /
// 32).  A launch the card refuses (shared memory, threads) returns its
// error; there is no fallback.
template <class Head, int W, class S>
int pt_narrow_launch_loss_grad(const int* widths, int n_layers,
                               const float* a0, const float* wpack, int n_pts,
                               typename Head::Args args, S* ws,
                               float* partials, float* out, void* stream) {
  static PtNarrowCache cache;
  PtNet net;
  int hp = 0;
  size_t smem = 0;
  int err = pt_narrow_plan(widths, n_layers, Head::kOut, W, n_pts,
                           (const void*)pt_narrow_loss_grad_kernel<Head, S>,
                           true, &cache, &net, &hp, &smem, nullptr);
  if (err) return err;
  const int n_tiles = (n_pts + PT_TILE - 1) / PT_TILE;
  cudaStream_t s = (cudaStream_t)stream;
  pt_narrow_loss_grad_kernel<Head, S><<<n_tiles, kPtNarrowThreads, smem, s>>>(
      net, hp, a0, wpack, n_pts, args, ws, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, n_tiles, 1 + net.n_weights + Head::kExtra, out,
                   s);
}

// The loss alone, through the narrow loss-only kernel at hidden width
// <= W, kPtNarrowLossThreadsFew threads a block when the n_tiles blocks
// fit the SMs one each, else kPtNarrowLossThreads.  partials: n_tiles
// floats; out: 1 float.  No fallback, as above.
template <class Head, int W, class S>
int pt_narrow_launch_loss(const int* widths, int n_layers, const float* a0,
                          const float* wpack, int n_pts,
                          typename Head::Args args, float* partials,
                          float* out, void* stream) {
  static PtNarrowCache cache;
  PtNet net;
  int hp = 0;
  size_t smem = 0;
  int n_sm = 0;
  int err = pt_narrow_plan(widths, n_layers, Head::kOut, W, n_pts,
                           (const void*)pt_narrow_loss_kernel<Head, S>, false,
                           &cache, &net, &hp, &smem, &n_sm);
  if (err) return err;
  const int n_tiles = (n_pts + PT_TILE - 1) / PT_TILE;
  const int threads =
      n_tiles <= n_sm ? kPtNarrowLossThreadsFew : kPtNarrowLossThreads;
  cudaStream_t s = (cudaStream_t)stream;
  pt_narrow_loss_kernel<Head, S><<<n_tiles, threads, smem, s>>>(
      net, hp, a0, wpack, n_pts, args, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, n_tiles, 1, out, s);
}

// Head's per-point values (out: Head::kOut * n_pts floats) through the
// narrow eval kernel at hidden width <= W, with In's inputs (X, wpack),
// in the loss-only kernel's blocks: a 32-point tile each,
// kPtNarrowLossThreadsFew threads when the tiles fit the SMs one each,
// else kPtNarrowLossThreads.  No fallback, as above.
template <class Head, int W, class In>
int pt_narrow_launch_eval(const int* widths, int n_layers, const In& in,
                          const float* X, const float* wpack, int n_pts,
                          typename Head::Args args, float* out,
                          void* stream) {
  static PtNarrowCache cache;
  PtNet net;
  int hp = 0;
  size_t smem = 0;
  int n_sm = 0;
  int err = pt_narrow_plan(widths, n_layers, Head::kOut, W, n_pts,
                           (const void*)pt_narrow_eval_kernel<Head, In>, false,
                           &cache, &net, &hp, &smem, &n_sm);
  if (err) return err;
  const int n_tiles = (n_pts + PT_TILE - 1) / PT_TILE;
  const int threads =
      n_tiles <= n_sm ? kPtNarrowLossThreadsFew : kPtNarrowLossThreads;
  pt_narrow_eval_kernel<Head, In><<<n_tiles, threads, smem,
                                    (cudaStream_t)stream>>>(
      net, hp, in, X, wpack, n_pts, args, out);
  return (int)cudaGetLastError();
}

}  // namespace
