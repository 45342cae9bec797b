// Residual evaluation for Hopper (sm_90a): the PDE residual of a tanh
// MLP at every point, no loss and no gradient.  One forward pass
// carries the four Taylor streams (value, d/dx, d2/dx2, d/dt) through
// the hidden layers and the head combines the output streams:
//
//   Burgers      f = u_t + u u_x - nu u_xx                  (N values)
//   Schrodinger  f_u = u_t + 0.5 v_xx + (u^2 + v^2) v,
//                f_v = v_t - 0.5 u_xx - (u^2 + v^2) u       (2 x N values)
//
// Replaces (pinn/ops/pallas_residual.py), each entry on its kernel:
//   burgers_residual         <- _residual_kernel (:55), launched by
//                               burgers_residual (:231); runs
//                               pt_narrow.cuh's pt_narrow_eval_kernel
//                               on the RawPointsMajor policy
//   burgers_residual_fmajor  <- _residual_kernel_fmajor (:107), launched
//                               by burgers_residual_fmajor (:188); runs
//                               pt_narrow_eval_kernel on the
//                               RawFeaturesMajor policy
//   schrodinger_residual     <- _schrodinger_kernel_fmajor (:248),
//                               launched by schrodinger_residual (:331);
//                               runs pt_tile.cuh's pt_tile_eval_kernel
//                               on the RawFeaturesMajor policy
//
// As in the TPU kernels, the inputs are the raw points and the box
// (lb, ub): each point is normalised as 2 (x - lb) / (ub - lb) - 1, and
// the first layer's constant tangent rows are built as z1row = scale_x
// W0[0, :], z2row = scale_t W0[1, :] with scale = 2 / (ub - lb), in
// that order, with IEEE division (no fast math).  An input policy does
// this in the block's load (RawPointsMajor, RawFeaturesMajor); the
// weight packs carry no tangent rows.
//
// Layouts.  burgers_residual takes X (N, 2) interleaved and the weights
// as the JAX parameters hold them, W_l (h_in, h_out) then b_l (h_out),
// and transposes them as it stages them into shared memory; the
// features-major entries take X^T (2, N) and W_l^T (h_out, h_in), which
// is pt_mlp.cuh's layout and is staged as it is.  The output is (N, 1)
// or (1, N) (both f[i] at i) and (2, N) for Schrodinger (f_u[i],
// f_v[N + i]).  The TPU wrappers pad N to a tile of 2,048 points and
// slice; here only live points are written and nothing past N, so
// nothing is padded.
//
// Design.  Both Burgers entries run the narrow loss-only kernel's
// phases (pt_narrow_eval_forward: a block a 32-point tile, a warp a
// neuron, a lane a point, the streams in shared memory, Wt staged a
// layer at a time; 320 threads a block, 640 when the tiles fit the SMs
// one each) and store f from warp 0; they differ only in their policy's
// loads, so on the same points and weights they give the same f bit for
// bit.  schrodinger_residual runs the tiled loss-only kernel's forward
// (132 persistent blocks of 800 threads at width 100, 4 x 4 FFMA
// outputs a thread) and stores f_u, f_v from warp 0.  Each
// pre-activation is an fmaf chain over the inputs in ascending order,
// so an f does not depend on the block size.  No partials, no
// reduction, no atomics: each output is bitwise repeatable.
//
// Bounds on this card.  Per point ~25 kFLOP of f32 FMA and tanh at
// [2, 20x8, 1] and ~247 kFLOP at [2, 100x4, 2], for 12-16 bytes of
// input and output: bound by operations (0.073 ms for 200,000 Burgers
// points, 0.19 ms for Schrodinger's 51,456 at 67 TFLOP/s f32).  PERF.md
// records each entry's device time on an NVIDIA H100 80GB HBM3 (700 W).
//
// Every entry returns cudaGetLastError().

#include "pt_mlp.cuh"
#include "pt_narrow.cuh"
#include "pt_tile.cuh"

#define RESIDUAL_BURGERS_MAX_WIDTH 64
#define RESIDUAL_SCHRODINGER_MAX_WIDTH 128

namespace {

struct PtBox {
  float lb0, lb1, ub0, ub1;
};

// A raw coordinate on [lb, ub] normalised to [-1, 1], and the tangent
// rows' scale 2 / (ub - lb): the expressions of the TPU kernels.
__device__ __forceinline__ float pt_normalise(float x, float lb, float ub) {
  return 2.0f * (x - lb) / (ub - lb) - 1.0f;
}

__device__ __forceinline__ float pt_scale(float lb, float ub) {
  return 2.0f / (ub - lb);
}

// pt_narrow_eval_forward's inputs for burgers_residual: X (N, 2) raw,
// and W_l (h_in, h_out) then b_l, staged as Wt_l (h_out, h_in) then
// b_l; the tangent rows from the staged Wt_0.
struct RawPointsMajor {
  PtBox box;
  __device__ __forceinline__ float x0(const float* X, int, int col) const {
    return pt_normalise(X[2 * (size_t)col], box.lb0, box.ub0);
  }
  __device__ __forceinline__ float x1(const float* X, int, int col) const {
    return pt_normalise(X[2 * (size_t)col + 1], box.lb1, box.ub1);
  }
  // Read in W's order (coalesced), written transposed; b_l follows W_l
  // at the same offset in both layouts.
  __device__ __forceinline__ void load_w(const PtNet& net, int l,
                                         const float* __restrict__ wpack,
                                         float* w_s) const {
    const int hin = net.width[l], hout = net.width[l + 1];
    const int n = hin * hout;
    const float* W = wpack + net.w_off[l];
    for (int t = threadIdx.x; t < n + hout; t += blockDim.x) {
      const int k = t / hout, j = t - k * hout;
      w_s[t < n ? j * hin + k : t] = W[t];
    }
  }
  __device__ __forceinline__ float z1(const float* Wt0, int j) const {
    return pt_scale(box.lb0, box.ub0) * Wt0[2 * j];
  }
  __device__ __forceinline__ float z2(const float* Wt0, int j) const {
    return pt_scale(box.lb1, box.ub1) * Wt0[2 * j + 1];
  }
};

// The features-major inputs, X^T (2, N) raw and the pack W_l^T then
// b_l, f32 only.  pt_tile_forward (schrodinger_residual) reads the
// tangent rows from Wt_0 in the pack (the template z1, z2);
// pt_narrow_eval_forward (burgers_residual_fmajor) stages each layer as
// the pack holds it, the narrow stage buffer's own layout (load_w), and
// reads the tangent rows from the staged Wt_0 (z1, z2 of Wt0).
struct RawFeaturesMajor {
  PtBox box;
  __device__ __forceinline__ float x0(const float* X, int, int col) const {
    return pt_normalise(X[col], box.lb0, box.ub0);
  }
  __device__ __forceinline__ float x1(const float* X, int n_pts,
                                      int col) const {
    return pt_normalise(X[(size_t)n_pts + col], box.lb1, box.ub1);
  }
  template <class S>
  __device__ __forceinline__ float z1(const PtNet& net,
                                      const float* __restrict__ wpack,
                                      int j) const {
    return pt_scale(box.lb0, box.ub0) * wpack[net.w_off[0] + 2 * j];
  }
  template <class S>
  __device__ __forceinline__ float z2(const PtNet& net,
                                      const float* __restrict__ wpack,
                                      int j) const {
    return pt_scale(box.lb1, box.ub1) * wpack[net.w_off[0] + 2 * j + 1];
  }
  __device__ __forceinline__ void load_w(const PtNet& net, int l,
                                         const float* __restrict__ wpack,
                                         float* w_s) const {
    pt_narrow_load_w<float>(net, l, wpack, w_s);
  }
  __device__ __forceinline__ float z1(const float* Wt0, int j) const {
    return pt_scale(box.lb0, box.ub0) * Wt0[2 * j];
  }
  __device__ __forceinline__ float z2(const float* Wt0, int j) const {
    return pt_scale(box.lb1, box.ub1) * Wt0[2 * j + 1];
  }
};

// The heads: a point's residual(s) from its output streams U[o][s],
// stored at out.
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
  const RawPointsMajor in = {{lb0, lb1, ub0, ub1}};
  const BurgersResidual::Args args = {nu};
  return pt_narrow_launch_eval<BurgersResidual, RESIDUAL_BURGERS_MAX_WIDTH>(
      widths, n_layers, in, X, wpack, n_pts, args, out, stream);
}

int burgers_residual_fmajor(const float* X, const float* wpack,
                            const int* widths, int n_layers, int n_pts,
                            float lb0, float lb1, float ub0, float ub1,
                            float nu, float* out, void* stream) {
  const RawFeaturesMajor in = {{lb0, lb1, ub0, ub1}};
  const BurgersResidual::Args args = {nu};
  return pt_narrow_launch_eval<BurgersResidual, RESIDUAL_BURGERS_MAX_WIDTH>(
      widths, n_layers, in, X, wpack, n_pts, args, out, stream);
}

int schrodinger_residual(const float* X, const float* wpack, const int* widths,
                         int n_layers, int n_pts, float lb0, float lb1,
                         float ub0, float ub1, float* out, void* stream) {
  const RawFeaturesMajor in = {{lb0, lb1, ub0, ub1}};
  return pt_tile_launch_eval<SchrodingerResidual,
                             RESIDUAL_SCHRODINGER_MAX_WIDTH>(
      widths, n_layers, in, X, wpack, n_pts, SchrodingerResidual::Args{}, out,
      stream);
}

}  // extern "C"
