// Shared code of the fused PINN kernels (sm_90a): the net, head and
// buffer conventions that every kernel of pt_narrow.cuh, pt_tile.cuh
// and residual_eval.cu takes for a tanh MLP with four Taylor streams
// (value, d/dx, d2/dx2, d/dt), the stream type's roundings, the warp
// sum and the fixed-order reduction of the partials.  The entries run
// pt_narrow.cuh's kernels (the Burgers losses and both Burgers
// residuals) or pt_tile.cuh's (the Schrodinger losses and
// schrodinger_residual).
//
// Three things are template parameters:
//
//   Head  the output-layer misfit: its output width (kOut), its
//         per-point inputs (Point, loaded by load()), its loss and the
//         adjoints gU[o][s] of the output streams (eval()), and any
//         extra accumulators (kExtra slots after the weight gradients).
//   W     the maximum hidden width an entry takes (pt_make_net's
//         limit).
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

int pt_reduce(const float* partials, int rows, int n_cols, float* out,
              cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n_cols + threads - 1) / threads;
  pt_reduce_rows_kernel<<<blocks, threads, 0, stream>>>(partials, rows,
                                                        n_cols, out);
  return (int)cudaGetLastError();
}

}  // namespace
