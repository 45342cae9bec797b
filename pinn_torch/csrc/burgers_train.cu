// Fused Burgers training losses for Hopper (sm_90a): the loss of a tanh
// MLP [2, h1, ..., hH, 1] with every parameter gradient, in one pass.
//
// Inference (aux rows target, w, d; data and collocation points in one
// stream):
//
//     L = sum_i w_i f_i^2,   f_i = d_i (u_i - target_i)
//                                  + (1 - d_i)(u_t + u u_x - nu u_xx)_i
//
// Identification (aux rows target, w_d, w_f; both misfits at the same
// points; lam = (lambda1, exp(log_lambda2)) in a 2-float device buffer):
//
//     L = sum_i w_d (u - target)^2 + w_f f^2,
//     f = u_t + lambda1 u u_x - exp(log_lambda2) u_xx,
//
// plus A1 = sum g_f u u_x and A2 = sum g_f u_xx (g_f = 2 w_f f) in the
// two slots after the weight gradients.  The coefficients are read on
// the card, so a training step needs no device-to-host copy for them.
//
// Replaces (pinn/ops/pallas_train.py):
//   burgers_loss_grad      <- _make_train_kernel (:524), launched by
//                             _train_loss_grad_call (:665); and
//   burgers_loss_grad_rb      the same outputs bit for bit on
//                             pt_narrow_rb.cuh's register-blocked
//                             kernel, at hidden width 20 (below)
//   burgers_loss           <- _fwd_train_kernel (:576), launched by
//                             _train_loss_call (:619)
//   burgers_ide_loss_grad  <- _make_ide_kernel (:847), launched by
//                             _ide_loss_grad_call (:971)
//   burgers_ide_loss       <- _fwd_ide_kernel (:906), launched by
//                             _ide_loss_call (:942)
// and, each with the suffix _bf16, the same four kernels with
// stream_dtype="bfloat16": bf16 streams and saved activations, f32
// accumulation (pt_mlp.cuh says where they round).  They take the
// same f32 inputs and round them as they load them; ws holds bf16.
//
// The v1 residual SSE (make_burgers_sse; collocation points only, no
// aux rows, f32 streams only):
//
//     SSE = sum_i f_i^2,   f = u_t + u u_x - nu u_xx,
//
//   burgers_sse_grad  <- _make_fwd_bwd_kernel (:305), launched by
//                        _sse_fwd_bwd_call (:430)
//   burgers_sse       <- _fwd_kernel (:277), launched by
//                        _sse_fwd_call (:388)
//
// A point past the ragged edge carries the mask 0, so it adds exactly
// 0 to the sum and to every gradient, as the TPU kernel's
// where(i*T + col < n_real, f, 0) does.  The pair has its own head
// rather than being burgers_loss_grad with w = 1, d = 0: it reads no
// aux rows and sums f^2, not a weighted mean.
//
// One design.  Every entry launches one of pt_narrow.cuh's block-tiled
// kernels: a block a 32-point tile, each layer one product over the
// four streams in shared memory, the weights staged a layer at a time,
// the head in one warp, the identification head's A1 and A2 summed
// there beside the loss.  The five loss+grad entries,
// burgers_loss_grad[_bf16], burgers_ide_loss_grad[_bf16] and
// burgers_sse_grad, run pt_narrow_loss_grad_kernel (320 threads a
// block, 42 KB of shared memory at [2, 20x8, 1], so several blocks
// share an SM and the inference flagship's 316 tiles run in one wave);
// the five loss-only entries, burgers_loss[_bf16],
// burgers_ide_loss[_bf16] and burgers_sse, run pt_narrow_loss_kernel,
// its forward with nothing saved (25 KB; its block size is fitted to
// the grid at launch, pt_narrow.cuh says how).  The loss of each
// loss+grad entry is its loss-only entry's bit for bit.  The
// saved-activation workspace is 2,560 B a point at width 20 (25.9 MB at
// the inference flagship's N = 10,100, inside the 50 MB L2), half that
// with bf16 streams, and partials hold a row per 32-point tile.  All
// are instantiated at hidden width <= 64.
//
// Bounds on this card.  The inference flagship step is ~0.7 GFLOP of
// f32 FMA for ~26 MB of workspace traffic (0.0115 ms at 67 TFLOP/s).
// The narrow kernels' products read both operands from shared memory,
// so a block is bound by the shared-memory pipe and by the latency of
// its phases, not by FLOP/s; at the identification flagship's N = 2,000
// its 63 blocks fill under half of the 132 SMs.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W, by device time: the narrow loss+grad kernel
// 0.114 ms at N = 10,100 (f32 and bf16), 0.071 ms (f32) and 0.062 ms
// (bf16) at N = 2,000; PERF.md has the rest.
//
// burgers_loss_grad_rb runs pt_narrow_rb_loss_grad_kernel instead: 128
// threads a tile, each value loaded from shared memory feeding several
// FMAs held in registers, and the tile's saved streams in shared memory
// (110,096 bytes a block at [2, 20x8, 1], two blocks an SM) instead of
// a workspace in device memory; ops/fused_train.py takes it for every
// float32 inference call at hidden width 20 (pt_narrow_rb.cuh says why
// and what it measured).
//
// Every entry returns cudaGetLastError().

#include "pt_narrow.cuh"
#include "pt_narrow_rb.cuh"

#define BURGERS_MAX_WIDTH 64
#define BURGERS_RB_WIDTH 20   // the hidden width of burgers_loss_grad_rb

namespace {

struct BurgersInfHead {
  static constexpr int kOut = 1;
  static constexpr int kExtra = 0;
  static constexpr bool kRoundedBias = true;
  struct Args {
    const float* aux;  // (3, N): target, w, d
    float nu;
  };
  struct Point {
    float target, w, d;
  };
  static __device__ __forceinline__ Point load(const Args& a, int n_pts,
                                               int col, bool live) {
    Point p;
    p.target = live ? a.aux[col] : 0.0f;
    p.w = live ? a.aux[n_pts + col] : 0.0f;
    p.d = live ? a.aux[2 * n_pts + col] : 0.0f;
    return p;
  }
  // Per-point misfit and its stream adjoints; returns w f^2.
  static __device__ __forceinline__ float eval(const Args& a, const Point& p,
                                               float U[][4], float gU[][4],
                                               float*) {
    const float e = 1.0f - p.d;
    const float f = p.d * (U[0][0] - p.target)
                    + e * (U[0][3] + U[0][0] * U[0][1] - a.nu * U[0][2]);
    const float g_f = 2.0f * p.w * f;
    gU[0][0] = g_f * (p.d + e * U[0][1]);
    gU[0][1] = g_f * e * U[0][0];
    gU[0][2] = -a.nu * g_f * e;
    gU[0][3] = g_f * e;
    return p.w * f * f;
  }
};

struct BurgersIdeHead {
  static constexpr int kOut = 1;
  static constexpr int kExtra = 2;  // A1, A2
  static constexpr bool kRoundedBias = true;
  struct Args {
    const float* aux;  // (3, N): target, w_d, w_f
    const float* lam;  // (2,): lambda1, exp(log_lambda2)
  };
  struct Point {
    float target, w_d, w_f, l1, l2;
  };
  static __device__ __forceinline__ Point load(const Args& a, int n_pts,
                                               int col, bool live) {
    Point p;
    p.target = live ? a.aux[col] : 0.0f;
    p.w_d = live ? a.aux[n_pts + col] : 0.0f;
    p.w_f = live ? a.aux[2 * n_pts + col] : 0.0f;
    p.l1 = __ldg(a.lam);
    p.l2 = __ldg(a.lam + 1);
    return p;
  }
  static __device__ __forceinline__ float eval(const Args&, const Point& p,
                                               float U[][4], float gU[][4],
                                               float* ex) {
    const float u = U[0][0], u_x = U[0][1], u_xx = U[0][2], u_t = U[0][3];
    const float f = u_t + p.l1 * u * u_x - p.l2 * u_xx;
    const float e = u - p.target;
    const float g_f = 2.0f * p.w_f * f;
    const float g_d = 2.0f * p.w_d * e;
    ex[0] = g_f * u * u_x;  // A1
    ex[1] = g_f * u_xx;     // A2
    gU[0][0] = g_d + g_f * p.l1 * u_x;
    gU[0][1] = g_f * p.l1 * u;
    gU[0][2] = -p.l2 * g_f;
    gU[0][3] = g_f;
    return p.w_d * e * e + p.w_f * f * f;
  }
};

struct BurgersSseHead {
  static constexpr int kOut = 1;
  static constexpr int kExtra = 0;
  static constexpr bool kRoundedBias = true;  // f32 streams: no rounding
  struct Args {
    float nu;
  };
  struct Point {
    float m;  // 1 on live points, 0 past the ragged edge
  };
  static __device__ __forceinline__ Point load(const Args&, int, int,
                                               bool live) {
    Point p;
    p.m = live ? 1.0f : 0.0f;
    return p;
  }
  // f^2 and the adjoints (2f u_x, 2f u, -2 nu f, 2f) (pallas_train.py:345-347).
  static __device__ __forceinline__ float eval(const Args& a, const Point& p,
                                               float U[][4], float gU[][4],
                                               float*) {
    const float f = p.m * (U[0][3] + U[0][0] * U[0][1] - a.nu * U[0][2]);
    const float g_f = 2.0f * f;
    gU[0][0] = g_f * U[0][1];
    gU[0][1] = g_f * U[0][0];
    gU[0][2] = -a.nu * g_f;
    gU[0][3] = g_f;
    return f * f;
  }
};

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ----

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Packed weight count and workspace rows for a layer list; the wrapper
// sizes wpack, ws and partials from these.  Returns nonzero on a layer
// list the kernels do not take (input 2, output 1, at most 15 hidden
// layers of width <= 64).
int burgers_train_sizes(const int* widths, int n_layers, int* n_weights,
                        int* ws_rows) {
  return pt_sizes(widths, n_layers, 1, BURGERS_MAX_WIDTH, n_weights, ws_rows);
}

// The floats of scratch that the partials' sum (pt_mlp.cuh's pt_reduce)
// needs after rows x n_cols partials; every wrapper's partials buffer
// holds them.
int pt_reduce_scratch(int rows, int n_cols) {
  return (int)pt_reduce_scratch_floats(rows, n_cols);
}

// pt_reduce on its own, as every entry runs it: out[p] = the sum of
// column p of partials (rows x n_cols floats, then pt_reduce_scratch
// floats of scratch).
int pt_reduce_rows(float* partials, int rows, int n_cols, float* out,
                   void* stream) {
  return pt_reduce(partials, rows, n_cols, out, (cudaStream_t)stream);
}

// Loss and all gradients.  ws: ws_rows * (n_tiles * 32) floats (bf16
// values for the _bf16 entry); partials: n_tiles * (1 + n_weights),
// then the reduction's scratch (pt_reduce_scratch); out: 1 + n_weights,
// where n_tiles = ceil(n_pts / 32).  Every partials buffer below is
// followed by that scratch.
int burgers_loss_grad(const float* a0, const float* aux, const float* wpack,
                      const int* widths, int n_layers, int n_pts, float nu,
                      float* ws, float* partials, float* out, void* stream) {
  const BurgersInfHead::Args args = {aux, nu};
  return pt_narrow_launch_loss_grad<BurgersInfHead, BURGERS_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, args, ws, partials, out, stream);
}

int burgers_loss_grad_bf16(const float* a0, const float* aux,
                           const float* wpack, const int* widths,
                           int n_layers, int n_pts, float nu,
                           __nv_bfloat16* ws, float* partials, float* out,
                           void* stream) {
  const BurgersInfHead::Args args = {aux, nu};
  return pt_narrow_launch_loss_grad<BurgersInfHead, BURGERS_MAX_WIDTH,
                                    __nv_bfloat16>(widths, n_layers, a0, wpack,
                                                   n_pts, args, ws, partials,
                                                   out, stream);
}

// burgers_loss_grad's outputs bit for bit through pt_narrow_rb.cuh's
// register-blocked kernel, for [2, 20, ..., 20, 1] (at most 15 hidden
// layers), with no workspace: the tile's saved streams stay in shared
// memory.  partials and out as burgers_loss_grad's.
int burgers_loss_grad_rb(const float* a0, const float* aux,
                         const float* wpack, const int* widths, int n_layers,
                         int n_pts, float nu, float* partials, float* out,
                         void* stream) {
  const BurgersInfHead::Args args = {aux, nu};
  return pt_narrow_rb_launch_loss_grad<BurgersInfHead, BURGERS_RB_WIDTH>(
      widths, n_layers, a0, wpack, n_pts, args, partials, out, stream);
}

// Loss only.  partials: n_tiles floats; out: 1 float.
int burgers_loss(const float* a0, const float* aux, const float* wpack,
                 const int* widths, int n_layers, int n_pts, float nu,
                 float* partials, float* out, void* stream) {
  const BurgersInfHead::Args args = {aux, nu};
  return pt_narrow_launch_loss<BurgersInfHead, BURGERS_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, args, partials, out, stream);
}

int burgers_loss_bf16(const float* a0, const float* aux, const float* wpack,
                      const int* widths, int n_layers, int n_pts, float nu,
                      float* partials, float* out, void* stream) {
  const BurgersInfHead::Args args = {aux, nu};
  return pt_narrow_launch_loss<BurgersInfHead, BURGERS_MAX_WIDTH,
                               __nv_bfloat16>(widths, n_layers, a0, wpack,
                                              n_pts, args, partials, out,
                                              stream);
}

// Identification loss, all net gradients, then A1 and A2.  partials:
// n_tiles * (3 + n_weights); out: 3 + n_weights.
int burgers_ide_loss_grad(const float* a0, const float* aux, const float* lam,
                          const float* wpack, const int* widths, int n_layers,
                          int n_pts, float* ws, float* partials, float* out,
                          void* stream) {
  const BurgersIdeHead::Args args = {aux, lam};
  return pt_narrow_launch_loss_grad<BurgersIdeHead, BURGERS_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, args, ws, partials, out, stream);
}

int burgers_ide_loss_grad_bf16(const float* a0, const float* aux,
                               const float* lam, const float* wpack,
                               const int* widths, int n_layers, int n_pts,
                               __nv_bfloat16* ws, float* partials, float* out,
                               void* stream) {
  const BurgersIdeHead::Args args = {aux, lam};
  return pt_narrow_launch_loss_grad<BurgersIdeHead, BURGERS_MAX_WIDTH,
                                    __nv_bfloat16>(widths, n_layers, a0, wpack,
                                                   n_pts, args, ws, partials,
                                                   out, stream);
}

// Identification loss only.  partials: n_tiles floats; out: 1 float.
int burgers_ide_loss(const float* a0, const float* aux, const float* lam,
                     const float* wpack, const int* widths, int n_layers,
                     int n_pts, float* partials, float* out, void* stream) {
  const BurgersIdeHead::Args args = {aux, lam};
  return pt_narrow_launch_loss<BurgersIdeHead, BURGERS_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, args, partials, out, stream);
}

int burgers_ide_loss_bf16(const float* a0, const float* aux, const float* lam,
                          const float* wpack, const int* widths, int n_layers,
                          int n_pts, float* partials, float* out,
                          void* stream) {
  const BurgersIdeHead::Args args = {aux, lam};
  return pt_narrow_launch_loss<BurgersIdeHead, BURGERS_MAX_WIDTH,
                               __nv_bfloat16>(widths, n_layers, a0, wpack,
                                              n_pts, args, partials, out,
                                              stream);
}

// v1 residual SSE and all gradients.  ws: ws_rows * (n_tiles * 32)
// floats; partials: n_tiles * (1 + n_weights); out: 1 + n_weights.
int burgers_sse_grad(const float* a0, const float* wpack, const int* widths,
                     int n_layers, int n_pts, float nu, float* ws,
                     float* partials, float* out, void* stream) {
  const BurgersSseHead::Args args = {nu};
  return pt_narrow_launch_loss_grad<BurgersSseHead, BURGERS_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, args, ws, partials, out, stream);
}

// v1 residual SSE only.  partials: n_tiles floats; out: 1 float.
int burgers_sse(const float* a0, const float* wpack, const int* widths,
                int n_layers, int n_pts, float nu, float* partials,
                float* out, void* stream) {
  const BurgersSseHead::Args args = {nu};
  return pt_narrow_launch_loss<BurgersSseHead, BURGERS_MAX_WIDTH, float>(
      widths, n_layers, a0, wpack, n_pts, args, partials, out, stream);
}

}  // extern "C"
