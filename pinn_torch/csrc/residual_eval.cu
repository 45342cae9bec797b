// Residual evaluation for Hopper (sm_90a): the PDE residual of a tanh
// MLP at every point, no loss and no gradient.  One forward pass
// carries the four Taylor streams (value, d/dx, d2/dx2, d/dt) through
// the hidden layers and the head combines the output streams:
//
//   Burgers      f = u_t + u u_x - nu u_xx                  (N values)
//   Schrodinger  f_u = u_t + 0.5 v_xx + (u^2 + v^2) v,
//                f_v = v_t - 0.5 u_xx - (u^2 + v^2) u       (2 x N values)
//
// Replaces (pinn/ops/pallas_residual.py):
//   burgers_residual         <- _residual_kernel (:55), launched by
//                               burgers_residual (:231)
//   burgers_residual_fmajor  <- _residual_kernel_fmajor (:107), launched
//                               by burgers_residual_fmajor (:188)
//   schrodinger_residual     <- _schrodinger_kernel_fmajor (:248),
//                               launched by schrodinger_residual (:331)
//
// As in the TPU kernels, the inputs are the raw points and the box
// (lb, ub): each thread normalises its point as 2 (x - lb) / (ub - lb)
// - 1, and each block builds the first layer's constant tangent rows
// z1row = scale_x W0[0, :], z2row = scale_t W0[1, :] with scale =
// 2 / (ub - lb), in that order, with IEEE division (no fast math).
//
// Layouts.  The points-major kernel takes X (N, 2) interleaved and the
// weights as the JAX parameters hold them, W_l (h_in, h_out) then
// b_l (h_out), and transposes them as it loads them into shared
// memory; the features-major kernels take X^T (2, N) and W_l^T
// (h_out, h_in), which is pt_mlp.cuh's layout.  The output is (N, 1)
// or (1, N) (both f[i] at i) and (2, N) for Schrodinger (f_u[i],
// f_v[N + i]).  The TPU wrappers pad N to a tile of 2,048 points and
// slice; here each live thread writes its own point and none writes
// past N, so nothing is padded.
//
// Design.  One thread carries one point through pt_mlp.cuh's
// pt_forward_hidden and pt_output (the hidden stack's four streams,
// then the output layer's): no workspace, no partials, no reduction,
// no atomics, so the output is bitwise repeatable.  The weights sit in
// shared memory, loaded once per block: 128-thread blocks while they
// fit in 48 KB (12.2 KB at [2, 20x8, 1]); above that one block fits on
// an SM ([2, 100x4, 2] holds 31,002 floats, 124 KB), and a block takes
// the train kernels' shape (pt_warps_per_block: 8 warps x 201 blocks
// at Schrodinger's 51,456 grid points).  13 warps x 124 blocks, one
// wave, measured no faster on the H100: the per-thread stream arrays,
// not the waves, bound it.  The Schrodinger head reads no d/dx output
// stream; pt_output computes it all the same (1/150 of the work at
// [2, 100x4, 2]).
//
// Bounds on this card.  Per point ~25 kFLOP of f32 FMA and tanh at
// [2, 20x8, 1] and ~247 kFLOP at [2, 100x4, 2], for 12-16 bytes of
// input and output: bound by operations (0.075 ms for 200,000 Burgers
// points, 0.19 ms for Schrodinger's 51,456 at 67 TFLOP/s f32).  What
// holds it back is the per-thread stream arrays (2 x 4 x W floats) in
// local memory and one thread's serial chain through every neuron; a
// later design would spread a point's neurons over lanes and run the
// layer products on the tensor cores.
//
// Every entry returns cudaGetLastError().

#include "pt_mlp.cuh"

#define RESIDUAL_BURGERS_MAX_WIDTH 64
#define RESIDUAL_SCHRODINGER_MAX_WIDTH 128
#define RESIDUAL_THREADS 128  // threads a block while the weights fit in 48 KB

namespace {

struct PtBox {
  float lb0, lb1, ub0, ub1;
};

// X (N, 2) and W_l (h_in, h_out): the layout of _residual_kernel.
struct PointsMajor {
  static __device__ __forceinline__ void point(const float* X, int, int i,
                                               float* x0, float* x1) {
    *x0 = X[2 * (size_t)i];
    *x1 = X[2 * (size_t)i + 1];
  }
  static __device__ void load_weights(const PtNet& net, const float* wpack,
                                      float* w_s) {
    for (int l = 0; l < net.n_layers; ++l) {
      const int hin = net.width[l], hout = net.width[l + 1];
      const float* W = wpack + net.w_off[l];
      float* Wt = w_s + net.w_off[l];
      for (int t = threadIdx.x; t < hin * hout; t += blockDim.x) {
        const int j = t / hin, k = t - j * hin;
        Wt[t] = W[k * hout + j];
      }
      for (int j = threadIdx.x; j < hout; j += blockDim.x) {
        w_s[net.b_off[l] + j] = wpack[net.b_off[l] + j];
      }
    }
  }
};

// X^T (2, N) and W_l^T (h_out, h_in): the layout of the fmajor kernels.
struct FeaturesMajor {
  static __device__ __forceinline__ void point(const float* X, int n_pts,
                                               int i, float* x0, float* x1) {
    *x0 = X[i];
    *x1 = X[(size_t)n_pts + i];
  }
  static __device__ void load_weights(const PtNet& net, const float* wpack,
                                      float* w_s) {
    for (int i = threadIdx.x; i < net.z1_off; i += blockDim.x) {
      w_s[i] = wpack[i];
    }
  }
};

struct BurgersResidual {
  static constexpr int kOut = 1;
  struct Args {
    float nu;
  };
  static __device__ __forceinline__ void store(const Args& a, float U[][4],
                                               float* out, int, int i) {
    out[i] = U[0][3] + U[0][0] * U[0][1] - a.nu * U[0][2];
  }
};

struct SchrodingerResidual {
  static constexpr int kOut = 2;
  struct Args {};
  static __device__ __forceinline__ void store(const Args&, float U[][4],
                                               float* out, int n_pts, int i) {
    const float u = U[0][0], v = U[1][0];
    const float h2 = u * u + v * v;
    out[i] = U[0][3] + 0.5f * U[1][2] + h2 * v;
    out[(size_t)n_pts + i] = U[1][3] - 0.5f * U[0][2] - h2 * u;
  }
};

template <class Head, int W, class Layout>
__global__ void pt_eval_kernel(PtNet net, const float* __restrict__ X,
                               const float* __restrict__ wpack, int n_pts,
                               PtBox box, typename Head::Args args,
                               float* __restrict__ out) {
  extern __shared__ float w_s[];
  const float sx = 2.0f / (box.ub0 - box.lb0);
  const float st = 2.0f / (box.ub1 - box.lb1);
  Layout::load_weights(net, wpack, w_s);
  __syncthreads();
  // The tangent rows from the transposed first layer, W0^T[j] = (w_x, w_t).
  const float* Wt0 = w_s + net.w_off[0];
  for (int j = threadIdx.x; j < net.width[1]; j += blockDim.x) {
    w_s[net.z1_off + j] = sx * Wt0[2 * j];
    w_s[net.z2_off + j] = st * Wt0[2 * j + 1];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pts) return;  // no barrier follows
  float x0, x1;
  Layout::point(X, n_pts, i, &x0, &x1);
  const float a0 = 2.0f * (x0 - box.lb0) / (box.ub0 - box.lb0) - 1.0f;
  const float a1 = 2.0f * (x1 - box.lb1) / (box.ub1 - box.lb1) - 1.0f;

  float act[4 * W];
  float buf[4 * W];
  pt_forward_hidden<W, float>(net, w_s, a0, a1, act, buf);
  float U[Head::kOut][4];
  pt_output<W, Head::kOut>(net, w_s, act, U);
  Head::store(args, U, out, n_pts, i);
}

// out: Head::kOut * n_pts floats.
template <class Head, int W, class Layout>
int pt_launch_eval(const int* widths, int n_layers, const float* X,
                   const float* wpack, int n_pts, PtBox box,
                   typename Head::Args args, float* out, void* stream) {
  PtNet net;
  int err = pt_make_net(widths, n_layers, Head::kOut, W, &net);
  if (err) return err;
  if (n_pts < 1) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)pt_eval_kernel<Head, W, Layout>;
  size_t smem = 0;
  err = pt_smem_bytes(net, kernel, &smem);
  if (err) return err;
  int threads = RESIDUAL_THREADS;
  if (smem > 48 * 1024) {
    int warps = 1;
    err = pt_warps_per_block(smem, (n_pts + PT_TILE - 1) / PT_TILE, &warps);
    if (err) return err;
    threads = warps * PT_TILE;
  }
  const int blocks = (n_pts + threads - 1) / threads;
  pt_eval_kernel<Head, W, Layout><<<blocks, threads, smem,
                                    (cudaStream_t)stream>>>(
      net, X, wpack, n_pts, box, args, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ----
//
// wpack: every layer's weight then bias, in the layout the kernel
// names (W_l (h_in, h_out) for burgers_residual, W_l^T (h_out, h_in)
// for the other two), without tangent rows.  The layer limits are the
// train kernels' (burgers_train_sizes, schrodinger_train_sizes).

extern "C" {

int burgers_residual(const float* X, const float* wpack, const int* widths,
                     int n_layers, int n_pts, float lb0, float lb1, float ub0,
                     float ub1, float nu, float* out, void* stream) {
  const PtBox box = {lb0, lb1, ub0, ub1};
  const BurgersResidual::Args args = {nu};
  return pt_launch_eval<BurgersResidual, RESIDUAL_BURGERS_MAX_WIDTH,
                        PointsMajor>(widths, n_layers, X, wpack, n_pts, box,
                                     args, out, stream);
}

int burgers_residual_fmajor(const float* X, const float* wpack,
                            const int* widths, int n_layers, int n_pts,
                            float lb0, float lb1, float ub0, float ub1,
                            float nu, float* out, void* stream) {
  const PtBox box = {lb0, lb1, ub0, ub1};
  const BurgersResidual::Args args = {nu};
  return pt_launch_eval<BurgersResidual, RESIDUAL_BURGERS_MAX_WIDTH,
                        FeaturesMajor>(widths, n_layers, X, wpack, n_pts, box,
                                       args, out, stream);
}

int schrodinger_residual(const float* X, const float* wpack, const int* widths,
                         int n_layers, int n_pts, float lb0, float lb1,
                         float ub0, float ub1, float* out, void* stream) {
  const PtBox box = {lb0, lb1, ub0, ub1};
  return pt_launch_eval<SchrodingerResidual, RESIDUAL_SCHRODINGER_MAX_WIDTH,
                        FeaturesMajor>(widths, n_layers, X, wpack, n_pts, box,
                                       SchrodingerResidual::Args{}, out,
                                       stream);
}

}  // extern "C"
