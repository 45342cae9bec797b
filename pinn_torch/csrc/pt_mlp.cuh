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
// pt_reduce then sums the rows of each column in a fixed tree whose
// shape depends on the row count alone (below), in float64, rounded to
// float32 once; the buffer holding the partials also holds the
// reduction's scratch after them (pt_reduce_scratch_floats).  No
// atomics, so two launches on the same inputs give bitwise-equal
// results, and a column sums the same whatever the number of columns,
// so a loss-only kernel's loss is its loss+grad twin's bit for bit.
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

// The sum of the partials' rows, column by column, as a tree of fixed
// shape in float64: each chunk of PT_REDUCE_CHUNK = 256 rows is summed
// as a perfect binary tree (pairs of rows, pairs of pairs, ..., eight
// levels; rows past the end are +0), and the chunks' sums likewise,
// pass after pass, until one row is left; the last pass rounds to
// float32 once.  The tree and every operand's place in it depend on the
// row count alone: never on the columns or on how a launch maps the
// tree onto threads.  So the error is about one float32 rounding of the
// result whatever the row count (an in-order float32 sum loses ~1.7e-8
// a row), a column sums the same in a loss-only kernel's one-column
// partials as in its loss+grad twin's, and with no atomics two launches
// are bitwise equal.
//
// One kernel folds a pass: a block a chunk and PT_REDUCE_COLS = 32
// columns (a warp reads 32 neighbouring floats of a row), a thread one
// column of LPT consecutive 8-row leaves, its loads all unconditional
// (rows and columns past the edge read the last one and count +0) and
// its subtree folded in registers, then the block's subtrees folded by
// one warp through shared memory.  Blocks run over the columns first,
// so the blocks in flight read whole rows.  A pass over many chunks
// takes LPT = 8 (4 warps a block, 64 loads in flight a thread); the
// last pass LPT = 2 with only the warps its rows fill (a short pass is
// bound by latency, not bytes).  Every array index is fixed at compile
// time, so nothing goes to local memory.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W, device time a call: 0.143 ms for the inference
// flagship's 383 MB of partials at N_f = 1,000,000 (bound 0.114 ms at
// 3.35 TB/s), 0.007 ms for the Schrodinger flagship's grid rows at
// N_f = 1,000,000 (30,803 columns).
#define PT_REDUCE_CHUNK 256
#define PT_REDUCE_COLS 32

// v[0] + ... + v[N-1] as a perfect binary tree (N a power of two).
template <int N>
struct PtFold {
  static __device__ __forceinline__ double run(double* v) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) v[i] = v[2 * i] + v[2 * i + 1];
    return PtFold<N / 2>::run(v);
  }
};

template <>
struct PtFold<1> {
  static __device__ __forceinline__ double run(double* v) { return v[0]; }
};

// out[c, p] = the tree sum of chunk c of column p; grid
// (ceil(n_cols / PT_REDUCE_COLS), chunks), block (PT_REDUCE_COLS, the
// groups of LPT leaves that hold rows, at most 32 / LPT).
template <int LPT, class In, class Out>
__global__ void __launch_bounds__(PT_REDUCE_COLS * PT_REDUCE_CHUNK / (8 * LPT))
pt_reduce_pass_kernel(const In* __restrict__ in, int rows, int n_cols,
                      Out* __restrict__ out) {
  constexpr int kRows = 8 * LPT, kGroups = PT_REDUCE_CHUNK / kRows;
  __shared__ double part[kGroups][PT_REDUCE_COLS];
  const int col = blockIdx.x * PT_REDUCE_COLS + threadIdx.x;
  const bool live = col < n_cols;
  const int c = live ? col : n_cols - 1;
  const long long r0 = (long long)blockIdx.y * PT_REDUCE_CHUNK +
                       (long long)threadIdx.y * kRows;
  double v[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0 + i < rows ? r0 + i : rows - 1;
    const double x = (double)in[(size_t)r * n_cols + c];
    v[i] = r0 + i < rows ? x : 0.0;
  }
  part[threadIdx.y][threadIdx.x] = PtFold<kRows>::run(v);
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    double g[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      g[i] = i < (int)blockDim.y ? part[i][threadIdx.x] : 0.0;
    }
    out[(size_t)blockIdx.y * n_cols + col] = (Out)PtFold<kGroups>::run(g);
  }
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

// Rows left after one pass over `rows`.
int pt_reduce_rows_after(int rows) {
  return (rows + PT_REDUCE_CHUNK - 1) / PT_REDUCE_CHUNK;
}

// The floats the reduction of rows x n_cols partials needs after them:
// each pass's output but the last, as float64, at the first 8-byte
// boundary after the partials (one float of slack); 0 for one pass.
size_t pt_reduce_scratch_floats(int rows, int n_cols) {
  size_t doubles = 0;
  for (int r = rows; r > PT_REDUCE_CHUNK; r = pt_reduce_rows_after(r)) {
    doubles += (size_t)pt_reduce_rows_after(r) * n_cols;
  }
  return doubles ? 2 * doubles + 1 : 0;
}

template <int LPT, class In, class Out>
int pt_reduce_pass(const In* in, int rows, int n_cols, Out* out,
                   cudaStream_t stream) {
  const int rows_a_group = 8 * LPT;
  const int groups = rows < PT_REDUCE_CHUNK
                         ? (rows + rows_a_group - 1) / rows_a_group
                         : PT_REDUCE_CHUNK / rows_a_group;
  const dim3 grid((n_cols + PT_REDUCE_COLS - 1) / PT_REDUCE_COLS,
                  pt_reduce_rows_after(rows));
  pt_reduce_pass_kernel<LPT, In, Out>
      <<<grid, dim3(PT_REDUCE_COLS, groups), 0, stream>>>(in, rows, n_cols,
                                                           out);
  return (int)cudaGetLastError();
}

// out[p] = the sum over the rows of partials[rows, n_cols] of column p,
// by the tree above; partials is followed by
// pt_reduce_scratch_floats(rows, n_cols) floats of scratch.
int pt_reduce(float* partials, int rows, int n_cols, float* out,
              cudaStream_t stream) {
  if (rows < 1 || n_cols < 1 || pt_reduce_rows_after(rows) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= PT_REDUCE_CHUNK) {
    return pt_reduce_pass<2>(partials, rows, n_cols, out, stream);
  }
  const size_t start = (size_t)rows * n_cols;
  double* buf = reinterpret_cast<double*>(partials + start + (start & 1));
  int err = pt_reduce_pass<8>(partials, rows, n_cols, buf, stream);
  rows = pt_reduce_rows_after(rows);
  while (!err && rows > PT_REDUCE_CHUNK) {
    double* next = buf + (size_t)rows * n_cols;
    err = pt_reduce_pass<8>((const double*)buf, rows, n_cols, next, stream);
    buf = next;
    rows = pt_reduce_rows_after(rows);
  }
  return err ? err
             : pt_reduce_pass<2>((const double*)buf, rows, n_cols, out, stream);
}

}  // namespace
