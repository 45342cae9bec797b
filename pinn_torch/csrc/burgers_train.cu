// Fused Burgers training loss for Hopper (sm_90a): the loss
//
//     L = sum_i w_i f_i^2,   f_i = d_i (u_i - target_i)
//                                  + (1 - d_i)(u_t + u u_x - nu u_xx)_i
//
// of a tanh MLP [2, h1, ..., hH, 1] over data and collocation points in
// one stream, with every parameter gradient, in one pass.
//
// Replaces (pinn/ops/pallas_train.py):
//   burgers_loss_grad  <- _make_train_kernel (:524), launched by
//                         _train_loss_grad_call (:665)
//   burgers_loss       <- _fwd_train_kernel (:576), launched by
//                         _train_loss_call (:619)
//
// Layout.  a0 (2, N) holds the normalised points, aux (3, N) the rows
// target, w, d.  wpack is every weight in one f32 vector, in this
// order: per affine layer l, Wt_l (h_out, h_in) row-major then b_l
// (h_out); then z1row (h1) and z2row (h1), the first layer's constant
// tangent rows (vx·scale) @ W0 and (vt·scale) @ W0.  The gradient
// output has the loss in slot 0 followed by the gradient of wpack in
// wpack's own order, so the wrapper splits both with one offset table.
//
// Design.  One thread carries one point through the network: the four
// Taylor streams (value, d/dx, d2/dx2, d/dt) of every neuron, then the
// hand-derived backward of _layer_bwd/_run_backward.  A block is one
// warp, i.e. a tile of 32 points; the weights of the whole net sit in
// shared memory (12.2 KB at [2, 20x8, 1], 46.9 KB at [2, 40x8, 1]) and
// every read of them is a warp-wide broadcast.  Per-point weight
// gradients are summed over the tile with a fixed butterfly of warp
// shuffles, and each block writes its tile's loss and gradients to its
// own row of partials[n_blocks, 1 + n_weights].  burgers_reduce_rows
// then sums the rows in block order.  No float atomics anywhere, so
// two launches on the same inputs give bitwise-equal results.
//
// Saved activations.  The backward needs (t, z1, z11, z2) of every
// hidden neuron of the point: n_hidden·4·h floats (2,560 B a point at
// width 20, 5,120 B at width 40), too much for registers or a warp's
// share of shared memory.  They go to a device workspace (ws, allocated
// by the wrapper) laid out [layer][stream][neuron][point] so that the
// 32 threads of a warp touch 32 consecutive floats; at the flagship
// N = 10,100 it is 25.9 MB and stays in the 50 MB L2.  Each layer's
// input activations are rematerialised from the previous layer's
// saved block, as the TPU kernel does.
//
// Bounds on this card.  The flagship step is ~0.7 GFLOP of f32 FMA
// for ~26 MB of workspace traffic, but N = 10,100 points make only 316
// warps: 2.4 per SM, so the kernel is bound by latency (of the shuffle
// reductions, 3,021 per warp at the flagship, and of per-thread
// local-memory arrays) rather than by FLOP/s or bandwidth.  Spreading a
// point's neurons over several lanes is the next step for speed.
//
// Precision: IEEE f32 throughout (fmaf, tanhf); build without
// --use_fast_math.  Every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#define PT_MAX_LAYERS 16  // affine layers (n_hidden + 1)
#define PT_MAX_WIDTH 64   // hidden width
#define PT_TILE 32        // points per block = one warp

struct PtNet {
  int n_layers;                     // affine layers, n_hidden + 1
  int width[PT_MAX_LAYERS + 1];     // width[0] = 2, width[n_layers] = 1
  int w_off[PT_MAX_LAYERS];         // Wt_l offset in wpack
  int b_off[PT_MAX_LAYERS];         // b_l offset in wpack
  int s_off[PT_MAX_LAYERS];         // first workspace row of hidden layer l
  int z1_off, z2_off, n_weights;
  int ws_rows;                      // 4 * sum of hidden widths
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

__device__ __forceinline__ void pt_load_weights(const PtNet& net,
                                                const float* __restrict__ wpack,
                                                float* w_s) {
  for (int i = threadIdx.x; i < net.n_weights; i += blockDim.x) {
    w_s[i] = wpack[i];
  }
  __syncthreads();
}

// Forward of one point through the hidden stack.  On return act holds
// the last hidden layer's four output streams [s * PT_MAX_WIDTH + k].
// With ws != nullptr each hidden layer's (t, z1, z11, z2) is saved at
// ws[(s_off[l] + s * h + j) * cols + col].
__device__ void pt_forward_hidden(const PtNet& net, const float* w_s,
                                  float x0, float x1, float* act,
                                  float* nxt, float* ws, int cols,
                                  int col) {
  const int n_hidden = net.n_layers - 1;
  // Layer 0: two inputs, constant tangent rows, z11 = 0.
  {
    const int h = net.width[1];
    const float* W = w_s + net.w_off[0];
    const float* b = w_s + net.b_off[0];
    for (int j = 0; j < h; ++j) {
      const float zv = W[2 * j] * x0 + W[2 * j + 1] * x1 + b[j];
      const float z1 = w_s[net.z1_off + j];
      const float z2 = w_s[net.z2_off + j];
      const float t = tanhf(zv);
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      if (ws != nullptr) {
        const int r = net.s_off[0] + j;
        ws[(size_t)(r + 0 * h) * cols + col] = t;
        ws[(size_t)(r + 1 * h) * cols + col] = z1;
        ws[(size_t)(r + 2 * h) * cols + col] = 0.0f;
        ws[(size_t)(r + 3 * h) * cols + col] = z2;
      }
      act[0 * PT_MAX_WIDTH + j] = t;
      act[1 * PT_MAX_WIDTH + j] = sp * z1;
      act[2 * PT_MAX_WIDTH + j] = spp * z1 * z1;
      act[3 * PT_MAX_WIDTH + j] = sp * z2;
    }
  }
  for (int l = 1; l < n_hidden; ++l) {
    const int hin = net.width[l];
    const int h = net.width[l + 1];
    const float* W = w_s + net.w_off[l];
    const float* b = w_s + net.b_off[l];
    for (int j = 0; j < h; ++j) {
      const float* Wj = W + j * hin;
      float zv = 0.0f, z1 = 0.0f, z11 = 0.0f, z2 = 0.0f;
#pragma unroll 4
      for (int k = 0; k < hin; ++k) {
        const float wk = Wj[k];
        zv = fmaf(wk, act[0 * PT_MAX_WIDTH + k], zv);
        z1 = fmaf(wk, act[1 * PT_MAX_WIDTH + k], z1);
        z11 = fmaf(wk, act[2 * PT_MAX_WIDTH + k], z11);
        z2 = fmaf(wk, act[3 * PT_MAX_WIDTH + k], z2);
      }
      zv += b[j];
      const float t = tanhf(zv);
      const float sp = 1.0f - t * t;
      const float spp = -2.0f * t * sp;
      if (ws != nullptr) {
        const int r = net.s_off[l] + j;
        ws[(size_t)(r + 0 * h) * cols + col] = t;
        ws[(size_t)(r + 1 * h) * cols + col] = z1;
        ws[(size_t)(r + 2 * h) * cols + col] = z11;
        ws[(size_t)(r + 3 * h) * cols + col] = z2;
      }
      nxt[0 * PT_MAX_WIDTH + j] = t;
      nxt[1 * PT_MAX_WIDTH + j] = sp * z1;
      nxt[2 * PT_MAX_WIDTH + j] = spp * z1 * z1 + sp * z11;
      nxt[3 * PT_MAX_WIDTH + j] = sp * z2;
    }
    for (int s = 0; s < 4; ++s) {
      for (int j = 0; j < h; ++j) {
        act[s * PT_MAX_WIDTH + j] = nxt[s * PT_MAX_WIDTH + j];
      }
    }
  }
}

// Output layer (h_out = 1): U[s] = sum_k Wt_out[k] act[s][k], u = U0 + b.
__device__ __forceinline__ void pt_output(const PtNet& net, const float* w_s,
                                          const float* act, float U[4]) {
  const int L = net.n_layers - 1;
  const int hin = net.width[L];
  const float* W = w_s + net.w_off[L];
  float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
  for (int k = 0; k < hin; ++k) {
    const float wk = W[k];
    u0 = fmaf(wk, act[0 * PT_MAX_WIDTH + k], u0);
    u1 = fmaf(wk, act[1 * PT_MAX_WIDTH + k], u1);
    u2 = fmaf(wk, act[2 * PT_MAX_WIDTH + k], u2);
    u3 = fmaf(wk, act[3 * PT_MAX_WIDTH + k], u3);
  }
  U[0] = u0 + w_s[net.b_off[L]];  // u
  U[1] = u1;                       // u_x
  U[2] = u2;                       // u_xx
  U[3] = u3;                       // u_t
}

// Adjoints of a hidden layer's pre-activation streams (_layer_bwd):
// g holds the adjoints of the layer's four outputs, gz receives
// (gz_v, gz_1, gz_11, gz_2).
__device__ __forceinline__ void pt_layer_bwd(const PtNet& net, int l,
                                             const float* g, float* gz,
                                             const float* ws, int cols,
                                             int col) {
  const int h = net.width[l + 1];
  for (int j = 0; j < h; ++j) {
    const int r = net.s_off[l] + j;
    const float t = ws[(size_t)(r + 0 * h) * cols + col];
    const float z1 = ws[(size_t)(r + 1 * h) * cols + col];
    const float z11 = ws[(size_t)(r + 2 * h) * cols + col];
    const float z2 = ws[(size_t)(r + 3 * h) * cols + col];
    const float g0 = g[0 * PT_MAX_WIDTH + j];
    const float g1 = g[1 * PT_MAX_WIDTH + j];
    const float g2 = g[2 * PT_MAX_WIDTH + j];
    const float g3 = g[3 * PT_MAX_WIDTH + j];
    const float sp = 1.0f - t * t;
    const float spp = -2.0f * t * sp;
    const float gt = g0 + g1 * (-2.0f * t * z1)
                     + g2 * ((6.0f * t * t - 2.0f) * z1 * z1 - 2.0f * t * z11)
                     + g3 * (-2.0f * t * z2);
    gz[0 * PT_MAX_WIDTH + j] = sp * gt;
    gz[1 * PT_MAX_WIDTH + j] = g1 * sp + g2 * (2.0f * spp * z1);
    gz[2 * PT_MAX_WIDTH + j] = g2 * sp;
    gz[3 * PT_MAX_WIDTH + j] = g3 * sp;
  }
}

// Per-point misfit and its adjoints; returns w f^2.
__device__ __forceinline__ float pt_misfit(const float U[4], float target,
                                           float w, float d, float nu,
                                           float gU[4]) {
  const float e = 1.0f - d;
  const float f = d * (U[0] - target) + e * (U[3] + U[0] * U[1] - nu * U[2]);
  const float g_f = 2.0f * w * f;
  gU[0] = g_f * (d + e * U[1]);
  gU[1] = g_f * e * U[0];
  gU[2] = -nu * g_f * e;
  gU[3] = g_f * e;
  return w * f * f;
}

__global__ void burgers_loss_grad_kernel(PtNet net,
                                         const float* __restrict__ a0,
                                         const float* __restrict__ aux,
                                         const float* __restrict__ wpack,
                                         int n_pts, float nu,
                                         float* __restrict__ ws,
                                         float* __restrict__ partials) {
  extern __shared__ float w_s[];
  pt_load_weights(net, wpack, w_s);

  const int lane = threadIdx.x;
  const int cols = gridDim.x * PT_TILE;
  const int col = blockIdx.x * PT_TILE + lane;
  const bool live = col < n_pts;
  // Points past the ragged edge run with zero inputs and w = 0: they
  // add exactly 0 to the loss and every gradient, and keep the warp
  // converged for the shuffles.
  const float x0 = live ? a0[col] : 0.0f;
  const float x1 = live ? a0[n_pts + col] : 0.0f;
  const float target = live ? aux[col] : 0.0f;
  const float w = live ? aux[n_pts + col] : 0.0f;
  const float d = live ? aux[2 * n_pts + col] : 0.0f;

  float act[4 * PT_MAX_WIDTH];
  float buf[4 * PT_MAX_WIDTH];
  float gz[4 * PT_MAX_WIDTH];

  pt_forward_hidden(net, w_s, x0, x1, act, buf, ws, cols, col);
  float U[4], gU[4];
  pt_output(net, w_s, act, U);
  const float loss = pt_misfit(U, target, w, d, nu, gU);

  float* part = partials + (size_t)blockIdx.x * (1 + net.n_weights) + 1;
  const float loss_tile = pt_warp_sum(loss);
  if (lane == 0) part[-1] = loss_tile;

  // ---- output layer ----
  const int L = net.n_layers - 1;
  {
    const int hin = net.width[L];
    const float* W = w_s + net.w_off[L];
    for (int k = 0; k < hin; ++k) {
      const float c = gU[0] * act[0 * PT_MAX_WIDTH + k]
                      + gU[1] * act[1 * PT_MAX_WIDTH + k]
                      + gU[2] * act[2 * PT_MAX_WIDTH + k]
                      + gU[3] * act[3 * PT_MAX_WIDTH + k];
      const float cs = pt_warp_sum(c);
      if (lane == 0) part[net.w_off[L] + k] = cs;
    }
    const float cb = pt_warp_sum(gU[0]);
    if (lane == 0) part[net.b_off[L]] = cb;
    // buf <- adjoints of the last hidden layer's outputs.
    for (int s = 0; s < 4; ++s) {
      for (int k = 0; k < hin; ++k) {
        buf[s * PT_MAX_WIDTH + k] = W[k] * gU[s];
      }
    }
  }

  // ---- hidden layers L-1 .. 1 ----
  for (int l = L - 1; l >= 1; --l) {
    const int hin = net.width[l];
    const int h = net.width[l + 1];
    const float* W = w_s + net.w_off[l];
    pt_layer_bwd(net, l, buf, gz, ws, cols, col);
    // act <- this layer's inputs, rematerialised from layer l-1.
    for (int k = 0; k < hin; ++k) {
      const int r = net.s_off[l - 1] + k;
      const float tp = ws[(size_t)(r + 0 * hin) * cols + col];
      const float z1p = ws[(size_t)(r + 1 * hin) * cols + col];
      const float z11p = ws[(size_t)(r + 2 * hin) * cols + col];
      const float z2p = ws[(size_t)(r + 3 * hin) * cols + col];
      const float spp_ = 1.0f - tp * tp;
      const float sppp = -2.0f * tp * spp_;
      act[0 * PT_MAX_WIDTH + k] = tp;
      act[1 * PT_MAX_WIDTH + k] = spp_ * z1p;
      act[2 * PT_MAX_WIDTH + k] = sppp * z1p * z1p + spp_ * z11p;
      act[3 * PT_MAX_WIDTH + k] = spp_ * z2p;
    }
    for (int j = 0; j < h; ++j) {
      const float gz0 = gz[0 * PT_MAX_WIDTH + j];
      const float gz1 = gz[1 * PT_MAX_WIDTH + j];
      const float gz2 = gz[2 * PT_MAX_WIDTH + j];
      const float gz3 = gz[3 * PT_MAX_WIDTH + j];
      for (int k = 0; k < hin; ++k) {
        const float c = gz0 * act[0 * PT_MAX_WIDTH + k]
                        + gz1 * act[1 * PT_MAX_WIDTH + k]
                        + gz2 * act[2 * PT_MAX_WIDTH + k]
                        + gz3 * act[3 * PT_MAX_WIDTH + k];
        const float cs = pt_warp_sum(c);
        if (lane == 0) part[net.w_off[l] + j * hin + k] = cs;
      }
      const float cb = pt_warp_sum(gz0);
      if (lane == 0) part[net.b_off[l] + j] = cb;
    }
    // buf <- adjoints of this layer's inputs: Wt^T gz per stream.
    for (int k = 0; k < hin; ++k) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (int j = 0; j < h; ++j) {
        const float wjk = W[j * hin + k];
        s0 = fmaf(wjk, gz[0 * PT_MAX_WIDTH + j], s0);
        s1 = fmaf(wjk, gz[1 * PT_MAX_WIDTH + j], s1);
        s2 = fmaf(wjk, gz[2 * PT_MAX_WIDTH + j], s2);
        s3 = fmaf(wjk, gz[3 * PT_MAX_WIDTH + j], s3);
      }
      buf[0 * PT_MAX_WIDTH + k] = s0;
      buf[1 * PT_MAX_WIDTH + k] = s1;
      buf[2 * PT_MAX_WIDTH + k] = s2;
      buf[3 * PT_MAX_WIDTH + k] = s3;
    }
  }

  // ---- layer 0: W0 sees only the value stream; the tangent rows'
  // adjoints are column sums of gz_1 and gz_2 ----
  {
    const int h = net.width[1];
    pt_layer_bwd(net, 0, buf, gz, ws, cols, col);
    for (int j = 0; j < h; ++j) {
      const float gz0 = gz[0 * PT_MAX_WIDTH + j];
      const float c0 = pt_warp_sum(gz0 * x0);
      const float c1 = pt_warp_sum(gz0 * x1);
      const float cb = pt_warp_sum(gz0);
      const float cz1 = pt_warp_sum(gz[1 * PT_MAX_WIDTH + j]);
      const float cz2 = pt_warp_sum(gz[3 * PT_MAX_WIDTH + j]);
      if (lane == 0) {
        part[net.w_off[0] + 2 * j] = c0;
        part[net.w_off[0] + 2 * j + 1] = c1;
        part[net.b_off[0] + j] = cb;
        part[net.z1_off + j] = cz1;
        part[net.z2_off + j] = cz2;
      }
    }
  }
}

__global__ void burgers_loss_kernel(PtNet net, const float* __restrict__ a0,
                                    const float* __restrict__ aux,
                                    const float* __restrict__ wpack,
                                    int n_pts, float nu,
                                    float* __restrict__ partials) {
  extern __shared__ float w_s[];
  pt_load_weights(net, wpack, w_s);

  const int lane = threadIdx.x;
  const int col = blockIdx.x * PT_TILE + lane;
  const bool live = col < n_pts;
  const float x0 = live ? a0[col] : 0.0f;
  const float x1 = live ? a0[n_pts + col] : 0.0f;
  const float target = live ? aux[col] : 0.0f;
  const float w = live ? aux[n_pts + col] : 0.0f;
  const float d = live ? aux[2 * n_pts + col] : 0.0f;

  float act[4 * PT_MAX_WIDTH];
  float buf[4 * PT_MAX_WIDTH];
  pt_forward_hidden(net, w_s, x0, x1, act, buf, nullptr, 0, col);
  float U[4], gU[4];
  pt_output(net, w_s, act, U);
  const float loss_tile = pt_warp_sum(pt_misfit(U, target, w, d, nu, gU));
  if (lane == 0) partials[blockIdx.x] = loss_tile;
}

// out[p] = sum over rows r = 0, 1, ... of partials[r, p], in row order.
__global__ void burgers_reduce_rows_kernel(const float* __restrict__ partials,
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

// ---- host entry points (plain C interface, loaded with ctypes) ----

static int pt_make_net(const int* widths, int n_layers, PtNet* net) {
  if (n_layers < 2 || n_layers > PT_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (widths[0] != 2 || widths[n_layers] != 1) return (int)cudaErrorInvalidValue;
  net->n_layers = n_layers;
  int off = 0, rows = 0;
  for (int l = 0; l <= n_layers; ++l) net->width[l] = widths[l];
  for (int l = 0; l < n_layers; ++l) {
    const int hin = widths[l], hout = widths[l + 1];
    if (l < n_layers - 1 && (hout < 1 || hout > PT_MAX_WIDTH)) {
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

static int pt_smem_bytes(const PtNet& net, const void* kernel, size_t* bytes) {
  *bytes = (size_t)net.n_weights * sizeof(float);
  if (*bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

static int pt_reduce(const float* partials, int rows, int n_cols, float* out,
                     cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n_cols + threads - 1) / threads;
  burgers_reduce_rows_kernel<<<blocks, threads, 0, stream>>>(partials, rows,
                                                             n_cols, out);
  return (int)cudaGetLastError();
}

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Packed weight count and workspace rows for a layer list; the wrapper
// sizes wpack, ws and partials from these.  Returns nonzero on a layer
// list the kernels do not take.
int burgers_train_sizes(const int* widths, int n_layers, int* n_weights,
                        int* ws_rows) {
  PtNet net;
  const int err = pt_make_net(widths, n_layers, &net);
  if (err) return err;
  *n_weights = net.n_weights;
  *ws_rows = net.ws_rows;
  return 0;
}

// Loss and all gradients.  ws: ws_rows * (n_blocks * 32) floats;
// partials: n_blocks * (1 + n_weights); out: 1 + n_weights, where
// n_blocks = ceil(n_pts / 32).
int burgers_loss_grad(const float* a0, const float* aux, const float* wpack,
                      const int* widths, int n_layers, int n_pts, float nu,
                      float* ws, float* partials, float* out, void* stream) {
  PtNet net;
  int err = pt_make_net(widths, n_layers, &net);
  if (err) return err;
  if (n_pts < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  err = pt_smem_bytes(net, (const void*)burgers_loss_grad_kernel, &smem);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n_pts + PT_TILE - 1) / PT_TILE;
  burgers_loss_grad_kernel<<<blocks, PT_TILE, smem, s>>>(net, a0, aux, wpack,
                                                         n_pts, nu, ws,
                                                         partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, blocks, 1 + net.n_weights, out, s);
}

// Loss only.  partials: n_blocks floats; out: 1 float.
int burgers_loss(const float* a0, const float* aux, const float* wpack,
                 const int* widths, int n_layers, int n_pts, float nu,
                 float* partials, float* out, void* stream) {
  PtNet net;
  int err = pt_make_net(widths, n_layers, &net);
  if (err) return err;
  if (n_pts < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  err = pt_smem_bytes(net, (const void*)burgers_loss_kernel, &smem);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n_pts + PT_TILE - 1) / PT_TILE;
  burgers_loss_kernel<<<blocks, PT_TILE, smem, s>>>(net, a0, aux, wpack, n_pts,
                                                    nu, partials);
  err = (int)cudaGetLastError();
  if (err) return err;
  return pt_reduce(partials, blocks, 1, out, s);
}

}  // extern "C"
