// Fused nonlinear-Schrödinger residual SSE for Hopper (sm_90a): the sum
//
//     SSE = sum_i (f_u^2 + f_v^2)_i,
//     f_u = u_t + 0.5 v_xx + (u^2 + v^2) v,
//     f_v = v_t - 0.5 u_xx - (u^2 + v^2) u,
//
// of a two-output tanh MLP [2, h1, ..., hH, 2], (u, v) = (Re h, Im h),
// over the collocation points, with every parameter gradient, in one
// pass.  Points past the ragged edge carry weight 0, where the TPU
// kernel masks by n_real.
//
// Replaces (pinn/ops/pallas_schrodinger.py):
//   schrodinger_sse_grad  <- _make_fwd_bwd_kernel (:95), launched at :244
//                            by _sse_fwd_bwd_call
//   schrodinger_sse       <- _fwd_kernel (:70), launched at :201 by
//                            _sse_fwd_call
// and, with the suffix _bf16, both with stream_dtype="bfloat16" (bf16
// streams and saved activations, f32 accumulation; pt_mlp.cuh).  As in
// the TPU kernel, the output bias gradient sums the f32 value adjoints
// (kRoundedBias = false), the weight gradients the rounded ones.  The
// output layer carries 2 x 4 streams; the adjoint of the d/dx stream is
// 0 (the residual has no first x derivative).
//
// What bounds them on this card: operations.  At the flagship [2,
// 100x4, 2], N_f = 20,000, a loss+grad call is 14.8 GFLOP (forward,
// weight gradients and input adjoints of three 100 x 100 layers on
// four streams, chip_smoke._bound): 0.223 ms at the 67 TFLOP/s f32
// rate outside the tensor cores, and 0.0209 ms for the bf16 entry with
// its layer products counted at the 989 TFLOP/s bf16 tensor-core rate.
// The loss-only call is a third of that work.
//
// Design.  Every entry runs one of pt_tile.cuh's block-tiled kernels:
// tiles of 32 points, every layer of a tile one product in shared
// memory on f32 FFMA, persistent blocks, one partials row a block.  The
// loss+grad entries (rows 7 and 7b of PERF.md's kernel table) save
// their activations to an L2-resident slot a block and run the
// backward; the loss-only entries (rows 8 and 8b) run the same forward
// with nothing saved, so at the same grid their loss is bitwise the
// loss+grad entries'.  One thread a point, the port's first design, kept
// the streams in local memory: 6 KB a thread for loss+grad, 1.6-2.3x
// the plain PyTorch version's time, and loss-only 1.7-2.5x its plain
// version's.
//
// Every entry returns cudaGetLastError().

#include "pt_mlp.cuh"
#include "pt_tile.cuh"

#define SCHRODINGER_MAX_WIDTH 128

namespace {

struct SchrodingerHead {
  static constexpr int kOut = 2;
  static constexpr int kExtra = 0;
  static constexpr bool kRoundedBias = false;
  struct Args {};
  struct Point {
    float m;  // 1 on live points, 0 past the ragged edge
  };
  static __device__ __forceinline__ Point load(const Args&, int, int,
                                               bool live) {
    Point p;
    p.m = live ? 1.0f : 0.0f;
    return p;
  }
  static __device__ __forceinline__ float eval(const Args&, const Point& p,
                                               float U[][4], float gU[][4],
                                               float*) {
    const float u = U[0][0], v = U[1][0];
    const float h2 = u * u + v * v;
    const float f_u = p.m * (U[0][3] + 0.5f * U[1][2] + h2 * v);
    const float f_v = p.m * (U[1][3] - 0.5f * U[0][2] - h2 * u);
    const float g_fu = 2.0f * f_u;
    const float g_fv = 2.0f * f_v;
    gU[0][0] = g_fu * (2.0f * u * v) - g_fv * (3.0f * u * u + v * v);
    gU[1][0] = g_fu * (u * u + 3.0f * v * v) - g_fv * (2.0f * u * v);
    gU[0][1] = 0.0f;
    gU[1][1] = 0.0f;
    gU[0][2] = -0.5f * g_fv;
    gU[1][2] = 0.5f * g_fu;
    gU[0][3] = g_fu;
    gU[1][3] = g_fv;
    return f_u * f_u + f_v * f_v;
  }
};

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ----

extern "C" {

// Packed weight count and workspace rows; nonzero on a layer list the
// kernels do not take (input 2, output 2, at most 15 hidden layers of
// width <= 128).
int schrodinger_train_sizes(const int* widths, int n_layers, int* n_weights,
                            int* ws_rows) {
  return pt_sizes(widths, n_layers, 2, SCHRODINGER_MAX_WIDTH, n_weights,
                  ws_rows);
}

// SSE and all gradients.  ws: ws_rows * (n_tiles * 32) floats (bf16
// values for the _bf16 entry); partials: n_tiles * (1 + n_weights),
// then pt_reduce's scratch; out: 1 + n_weights, where n_tiles =
// ceil(n_pts / 32).
int schrodinger_sse_grad(const float* a0, const float* wpack,
                         const int* widths, int n_layers, int n_pts,
                         float* ws, float* partials, float* out,
                         void* stream) {
  return pt_tile_launch_loss_grad<SchrodingerHead, SCHRODINGER_MAX_WIDTH,
                                  float>(
      widths, n_layers, a0, wpack, n_pts, SchrodingerHead::Args{}, ws,
      partials, out, stream);
}

int schrodinger_sse_grad_bf16(const float* a0, const float* wpack,
                              const int* widths, int n_layers, int n_pts,
                              __nv_bfloat16* ws, float* partials, float* out,
                              void* stream) {
  return pt_tile_launch_loss_grad<SchrodingerHead, SCHRODINGER_MAX_WIDTH,
                                  __nv_bfloat16>(
      widths, n_layers, a0, wpack, n_pts, SchrodingerHead::Args{}, ws,
      partials, out, stream);
}

// SSE only.  partials: n_tiles floats, then pt_reduce's scratch; out:
// 1 float.
int schrodinger_sse(const float* a0, const float* wpack, const int* widths,
                    int n_layers, int n_pts, float* partials, float* out,
                    void* stream) {
  return pt_tile_launch_loss<SchrodingerHead, SCHRODINGER_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, SchrodingerHead::Args{}, partials,
      out, stream);
}

int schrodinger_sse_bf16(const float* a0, const float* wpack,
                         const int* widths, int n_layers, int n_pts,
                         float* partials, float* out, void* stream) {
  return pt_tile_launch_loss<SchrodingerHead, SCHRODINGER_MAX_WIDTH,
                             __nv_bfloat16>(widths, n_layers, a0, wpack,
                                            n_pts, SchrodingerHead::Args{},
                                            partials, out, stream);
}

}  // extern "C"
