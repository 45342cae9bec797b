// Shared code of the fused PINN kernels (sm_90a): the net, head and
// buffer conventions that every kernel of pt_narrow.cuh, pt_tile.cuh
// and residual_eval.cu takes, the stream type's roundings, the
// fixed-order reduction of the partials, and the one-thread-a-point
// forward of a tanh MLP with four Taylor streams (value, d/dx, d2/dx2,
// d/dt) that residual_eval.cu's pt_eval_kernel runs for one entry,
// burgers_residual_fmajor.  The other entries run pt_narrow.cuh's
// kernels (the Burgers losses and burgers_residual) or pt_tile.cuh's
// (the Schrodinger losses and schrodinger_residual).
//
// Three things are template parameters:
//
//   Head  the output-layer misfit: its output width (kOut), its
//         per-point inputs (Point, loaded by load()), its loss and the
//         adjoints gU[o][s] of the output streams (eval()), and any
//         extra accumulators (kExtra slots after the weight gradients).
//   W     the maximum hidden width, which sizes the per-thread stream
//         arrays (2 x 4W floats of local memory).
//   S     the stream type: float (exact) or __nv_bfloat16 (the bf16
//         streams of the TPU kernels' stream_dtype="bfloat16").
//
// Layout.  a0 (2, N) holds the normalised points.  wpack is every
// weight in one f32 vector: per affine layer l, Wt_l (h_out, h_in)
// row-major then b_l (h_out); then z1row (h1) and z2row (h1), the first
// layer's constant tangent rows.  A gradient output has the loss in
// slot 0, the gradient of wpack in wpack's own order, then the head's
// kExtra accumulators.  A loss+grad kernel saves (t, z1, z11, z2) of
// every hidden neuron to a device workspace ws laid out
// [layer][stream][neuron][point], the rows of hidden layer l from
// PtNet::s_off[l], n_tiles * 32 points a row, and sums a tile's loss
// and gradients into its row of partials[n_tiles, 1 + n_weights +
// kExtra]; a loss-only kernel a tile's loss into partials[n_tiles].
// pt_reduce_rows_kernel then sums the rows in tile order.  No float
// atomics, so two launches on the same inputs give bitwise-equal
// results.
//
// A Head is a struct with kOut, kExtra, kRoundedBias (whether the
// output bias gradient sums the stream-rounded value adjoint, as the
// Burgers TPU kernels do, or the f32 one, as the Schrodinger kernel
// does), Args (passed to the kernel by value), Point, and
//   static __device__ Point load(const Args&, int n_pts, int col, bool live);
//   static __device__ float eval(const Args&, const Point&, float U[][4],
//                                float gU[][4], float* extra);
// where eval returns the point's loss term; a point past the ragged
// edge (live == false) must give 0 and zero adjoints.
//
// The one-thread-a-point forward (pt_forward_hidden, pt_output), which
// the block-tiled forwards reproduce sum for sum.  One thread carries
// one point through every neuron, its streams in per-thread arrays of
// 4W floats (local memory), the weights of the whole net in shared
// memory, shared by the threads of a block; past 48 KB of weights one
// block fits on an SM, and pt_warps_per_block sizes the block to keep
// the grid within one wave of the SMs.
//
// bf16 streams (S = __nv_bfloat16).  The TPU kernels round to bf16 at
// fixed points (pinn/ops/pallas_train.py:121-274) and the kernels round
// at the same ones, round-to-nearest-even as JAX's astype: the weights,
// biases, tangent rows and a0 as they are loaded; each layer's four
// output streams (the next layer is computed from the unrounded t, z1,
// z11, z2, while the backward reads them rounded from ws); the output
// adjoints gU; each layer's pre-activation adjoints gz (feeding both the
// input adjoints and the weight gradients); and the rematerialised
// layer inputs.  Every product takes rounded operands and accumulates
// in f32; the loss, its aux rows, the partials and their reduction stay
// f32.  ws holds S, which halves it.  The weights stay f32 in shared
// memory, holding rounded values, so no product pays a conversion.
// With S = float every rounding is the identity and the code is the
// f32 kernels'.
//
// Precision: IEEE f32 arithmetic throughout (fmaf, tanhf); build
// without --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define PT_MAX_LAYERS 16  // affine layers (n_hidden + 1)
#define PT_TILE 32        // points per tile = one warp
#define PT_MAX_WARPS 8    // warps per block when the weights are large

struct PtNet {
  int n_layers;                     // affine layers, n_hidden + 1
  int width[PT_MAX_LAYERS + 1];     // width[0] = 2, width[n_layers] = kOut
  int w_off[PT_MAX_LAYERS];         // Wt_l offset in wpack
  int b_off[PT_MAX_LAYERS];         // b_l offset in wpack
  int s_off[PT_MAX_LAYERS];         // first workspace row of hidden layer l
  int z1_off, z2_off, n_weights;
  int ws_rows;                      // 4 * sum of hidden widths
};

namespace {

// The stream type's rounding (rnd), and its stores and loads of ws.
template <class S>
struct PtStream;

template <>
struct PtStream<float> {
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float put(float x) { return x; }
  static __device__ __forceinline__ float get(float x) { return x; }
};

template <>
struct PtStream<__nv_bfloat16> {
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float get(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

__device__ __forceinline__ float pt_warp_sum(float v) {
  // Fixed butterfly: every lane ends with the same, order-fixed sum.
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// Forward of one point through the hidden stack.  On return act holds
// the last hidden layer's four output streams [s * W + k], S-rounded;
// nxt is scratch of the same size.
template <int W, class S>
__device__ void pt_forward_hidden(const PtNet& net, const float* w_s,
                                  float x0, float x1, float* act,
                                  float* nxt) {
  using St = PtStream<S>;
  const int n_hidden = net.n_layers - 1;
  // Layer 0: two inputs, constant tangent rows, z11 = 0.
  {
    const int h = net.width[1];
    const float* Wt = w_s + net.w_off[0];
    const float* b = w_s + net.b_off[0];
    for (int j = 0; j < h; ++j) {
      const float zv = Wt[2 * j] * x0 + Wt[2 * j + 1] * x1 + b[j];
      const float z1 = w_s[net.z1_off + j];
      const float z2 = w_s[net.z2_off + j];
      const float t = tanhf(zv);
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      act[0 * W + j] = St::rnd(t);
      act[1 * W + j] = St::rnd(sp * z1);
      act[2 * W + j] = St::rnd(spp * z1 * z1);
      act[3 * W + j] = St::rnd(sp * z2);
    }
  }
  for (int l = 1; l < n_hidden; ++l) {
    const int hin = net.width[l];
    const int h = net.width[l + 1];
    const float* Wt = w_s + net.w_off[l];
    const float* b = w_s + net.b_off[l];
    for (int j = 0; j < h; ++j) {
      const float* Wj = Wt + j * hin;
      float zv = 0.0f, z1 = 0.0f, z11 = 0.0f, z2 = 0.0f;
#pragma unroll 4
      for (int k = 0; k < hin; ++k) {
        const float wk = Wj[k];
        zv = fmaf(wk, act[0 * W + k], zv);
        z1 = fmaf(wk, act[1 * W + k], z1);
        z11 = fmaf(wk, act[2 * W + k], z11);
        z2 = fmaf(wk, act[3 * W + k], z2);
      }
      zv += b[j];
      const float t = tanhf(zv);
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      nxt[0 * W + j] = St::rnd(t);
      nxt[1 * W + j] = St::rnd(sp * z1);
      nxt[2 * W + j] = St::rnd(spp * z1 * z1 + sp * z11);
      nxt[3 * W + j] = St::rnd(sp * z2);
    }
    for (int s = 0; s < 4; ++s) {
      for (int j = 0; j < h; ++j) {
        act[s * W + j] = nxt[s * W + j];
      }
    }
  }
}

// Output layer: U[o][s] = sum_k Wt_out[o][k] act[s][k], plus b_o on the
// value stream (s = 0).  Streams: value, d/dx, d2/dx2, d/dt.
template <int W, int NO>
__device__ __forceinline__ void pt_output(const PtNet& net, const float* w_s,
                                          const float* act, float U[NO][4]) {
  const int L = net.n_layers - 1;
  const int hin = net.width[L];
  for (int o = 0; o < NO; ++o) {
    const float* Wo = w_s + net.w_off[L] + o * hin;
    float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
    for (int k = 0; k < hin; ++k) {
      const float wk = Wo[k];
      u0 = fmaf(wk, act[0 * W + k], u0);
      u1 = fmaf(wk, act[1 * W + k], u1);
      u2 = fmaf(wk, act[2 * W + k], u2);
      u3 = fmaf(wk, act[3 * W + k], u3);
    }
    U[o][0] = u0 + w_s[net.b_off[L] + o];
    U[o][1] = u1;
    U[o][2] = u2;
    U[o][3] = u3;
  }
}

// out[p] = sum over rows r = 0, 1, ... of partials[r, p], in row order.
__global__ void pt_reduce_rows_kernel(const float* __restrict__ partials,
                                      int rows, int n_cols,
                                      float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_cols) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) {
    s += partials[(size_t)r * n_cols + p];
  }
  out[p] = s;
}

// ---- host side ----

// Offsets of a layer list [2, h1, ..., hH, n_out] with every hidden
// width in [1, max_width]; nonzero on a list the kernels do not take.
int pt_make_net(const int* widths, int n_layers, int n_out, int max_width,
                PtNet* net) {
  if (n_layers < 2 || n_layers > PT_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (widths[0] != 2 || widths[n_layers] != n_out) return (int)cudaErrorInvalidValue;
  net->n_layers = n_layers;
  int off = 0, rows = 0;
  for (int l = 0; l <= n_layers; ++l) net->width[l] = widths[l];
  for (int l = 0; l < n_layers; ++l) {
    const int hin = widths[l], hout = widths[l + 1];
    if (l < n_layers - 1 && (hout < 1 || hout > max_width)) {
      return (int)cudaErrorInvalidValue;
    }
    net->w_off[l] = off;
    off += hin * hout;
    net->b_off[l] = off;
    off += hout;
    if (l < n_layers - 1) {
      net->s_off[l] = rows;
      rows += 4 * hout;
    }
  }
  net->z1_off = off;
  off += widths[1];
  net->z2_off = off;
  off += widths[1];
  net->n_weights = off;
  net->ws_rows = rows;
  return 0;
}

int pt_sizes(const int* widths, int n_layers, int n_out, int max_width,
             int* n_weights, int* ws_rows) {
  PtNet net;
  const int err = pt_make_net(widths, n_layers, n_out, max_width, &net);
  if (err) return err;
  *n_weights = net.n_weights;
  *ws_rows = net.ws_rows;
  return 0;
}

int pt_smem_bytes(const PtNet& net, const void* kernel, size_t* bytes) {
  *bytes = (size_t)net.n_weights * sizeof(float);
  if (*bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Warps per block.  Weights within 48 KB: one warp, and many blocks
// share an SM.  Larger weights allow one block per SM, so the warps of
// a block share one copy: as many as keep the grid within one wave of
// the SMs, at most PT_MAX_WARPS.
int pt_warps_per_block(size_t smem, int n_tiles, int* warps) {
  *warps = 1;
  if (smem <= 48 * 1024) return 0;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int w = (n_tiles + n_sm - 1) / n_sm;
  *warps = w < 1 ? 1 : (w > PT_MAX_WARPS ? PT_MAX_WARPS : w);
  return 0;
}

int pt_reduce(const float* partials, int rows, int n_cols, float* out,
              cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n_cols + threads - 1) / threads;
  pt_reduce_rows_kernel<<<blocks, threads, 0, stream>>>(partials, rows,
                                                        n_cols, out);
  return (int)cudaGetLastError();
}

}  // namespace
