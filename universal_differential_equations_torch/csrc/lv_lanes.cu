// Loss and gradient of the Lotka-Volterra noise study's lanes, in one launch.
//
// Lane l is the scenario-1 UDE
//
//   du1 = alpha * u1 + NN1(u),   du2 = -delta * u2 + NN2(u),
//
// NN the 2 -> 5 -> 5 -> 5 -> 2 Gaussian-RBF MLP (exp(-x^2) on the hidden
// layers, identity on the output) on the lane's own 87 parameters theta[l], in
// the flat layout of flatten_util.ravel_pytree (per layer its bias, then its
// weight (out, in) row-major).  It is solved by fixed-step Tsit5 from data[l, 0]
// over (samples - 1) * sub steps, the last stage carried to the next step
// (FSAL).  loss[l] is the mean of the 2 * samples squared residuals
// y[s * sub] - data[l, s], the first sample included; grad[l] is its gradient
// with respect to theta[l], by the discrete adjoint of the same scheme: the
// gradient autograd takes through examples/run_loops.py's mean_loss.
//
// It replaces no TPU kernel.  The JAX package leaves this function to XLA
// (jax.vmap of integrate_fixed under jax.grad); the port's plain path, the same
// function under torch.func.vmap and autograd, replays as a CUDA graph of about
// 68k kernels of 1-3 us on (500, <= 5) tensors per evaluation.
//
// What bounds it on an H100.  Not FLOP/s (151 MFLOP an evaluation at 500
// lanes, 2.3 us at 67 TFLOP/s) and not bytes (theta and data, 0.3 MB): each
// lane is a serial chain of 721 net evaluations forward, 720 more to recompute
// the stages backward and 720 stage VJPs, so the bound is that chain's latency.
// Through the three hidden layers a net evaluation is ~12 dependent FMAs, 3
// dependent expf and 3 rounds of shuffles; a stage VJP ~17 dependent FMAs and
// multiplies and 3 rounds of shuffles.
//
// Design.
//   * A group of kGroup = 8 threads per lane, 4 lanes to a 32-thread block
//     (500 lanes are 125 blocks, one warp on each SM).  Thread r of the group
//     owns row r of each hidden layer: its weights, its dot products, its expf
//     and its share of the gradient (threads 5-7 repeat row 4 and write
//     nothing).  Each layer's activations reach the whole group by 5 warp
//     shuffles.  The state, the stage sums, the output layer and the input's
//     cotangent are computed alike on every thread of the group, so they need
//     no exchange.  Against one thread per lane this halves the time (0.374
//     against 0.776 ms at 500 lanes on an H100, 700 W): one thread held all 87
//     weights and 87 gradient sums, used 255 registers, spilled 804 bytes, and
//     issued every instruction of the chain itself.
//   * Shared memory holds each lane's states y_n (2 floats a step) and, during
//     the reverse sweep of one step, each thread's record of each stage (its
//     input, the three layers' activations and the thread's own
//     pre-activations: 20 floats), laid out [item][thread] so a warp's accesses
//     hit 32 distinct banks: 47 KB at 1000 steps, within the default 48 KB.
//   * Forward: the solve, storing y_n, summing the squared residuals in double.
//     Reverse: for n = N-1 .. 0, recompute step n's stages from the stored y_n
//     (the same code as forward, so the same values), then back-propagate
//     through stages 6 .. 1 with the net's VJP at each stage input, adding each
//     VJP's weight terms to the gradient sums, and add the residual's
//     2 (y - d) / (2 * samples) at every sub-th step.
//   * The stage coefficients come from the caller already multiplied by dt,
//     as the plain path forms them (float32 dt times float32 tableau entry),
//     from solvers/tableaus.py.  Sums are explicit fmaf, so no contraction
//     choice of the compiler makes the recomputed stages differ from the
//     forward ones.  expf, not __expf: the benchmark holds the gradient to 8e-6
//     of the plain path's.  Nothing is clamped: a lane that goes non-finite
//     stays so, and the others do not see it.
#include <cuda_runtime.h>

namespace {

constexpr int kIn = 2, kHidden = 5, kOut = 2;
constexpr int kParams = (kHidden + kHidden * kIn) + 2 * (kHidden + kHidden * kHidden)
                        + (kOut + kOut * kHidden);  // 87
constexpr int kStages = 6;  // Tsit5's stages that enter a step's update (b[6] = 0)
constexpr int kCoefA = 15;  // the lower triangle of a, rows 1 .. 5
constexpr int kGroup = 8;   // threads per lane
constexpr int kThreads = 32;
constexpr int kLanesPerBlock = kThreads / kGroup;
constexpr int kRec = kIn + 3 * kHidden + 3;  // a stage's record: u, a1, a2, a3, own h1, h2, h3
constexpr int kMaxSteps = 1000;              // shared memory within 48 KB
// the flat layout's offsets: per layer the bias, then the weight
constexpr int kOff1 = kHidden + kHidden * kIn, kOff2 = kOff1 + kHidden + kHidden * kHidden;
constexpr int kOff3 = kOff2 + kHidden + kHidden * kHidden;

static_assert(kParams == 87, "the study's net has 87 parameters");
static_assert(kGroup >= kHidden && kThreads % kGroup == 0, "a group holds a hidden layer");

struct Coef {
  float a[kCoefA];   // dt * a[i][j], row i = 1 .. 5 starting at i * (i - 1) / 2
  float b[kStages];  // dt * b[j]
};

struct Rows {  // one thread's share of the net
  float w0[kIn], b0, w1[kHidden], b1, w2[kHidden], b2;  // own rows
  float c1[kHidden], c2[kHidden];                       // own columns of w1, w2
  float w0all[kHidden][kIn], w3[kOut][kHidden], b3[kOut];
};

struct Sums {  // one thread's share of the gradient
  float w0[kIn], b0, w1[kHidden], b1, w2[kHidden], b2, w3[kOut], b3[kOut];
};

struct Rec {
  float u[kIn], a1[kHidden], a2[kHidden], a3[kHidden], h1, h2, h3;
};

// item f of a record at s[f * stride] (kLoad: from s into v, else back)
template <bool kLoad, int R>
__device__ __forceinline__ void io_shared(float (&v)[R], float* s, int stride, int& f) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (kLoad) v[r] = s[f * stride]; else s[f * stride] = v[r];
    ++f;
  }
}

template <bool kLoad>
__device__ __forceinline__ void io_rec(Rec& a, float* s, int stride) {
  int f = 0;
  io_shared<kLoad>(a.u, s, stride, f);
  io_shared<kLoad>(a.a1, s, stride, f);
  io_shared<kLoad>(a.a2, s, stride, f);
  io_shared<kLoad>(a.a3, s, stride, f);
  float h[3] = {a.h1, a.h2, a.h3};
  io_shared<kLoad>(h, s, stride, f);
  if constexpr (kLoad) {
    a.h1 = h[0];
    a.h2 = h[1];
    a.h3 = h[2];
  }
}

// every thread of the group gets each owner's value: all[c] from thread base + c
__device__ __forceinline__ void gather(float mine, int base, float (&all)[kHidden]) {
#pragma unroll
  for (int c = 0; c < kHidden; ++c) all[c] = __shfl_sync(0xffffffffu, mine, base + c);
}

// the thread's row: h = w . x + b, returns exp(-h^2)
template <int K>
__device__ __forceinline__ float rbf_row(const float (&w)[K], const float (&x)[K], float b,
                                         float& h) {
  float s = __fmul_rn(w[0], x[0]);
#pragma unroll
  for (int c = 1; c < K; ++c) s = __fmaf_rn(w[c], x[c], s);
  h = __fadd_rn(s, b);
  return expf(-__fmul_rn(h, h));
}

// f(a.u), every activation kept in a
__device__ __forceinline__ void rhs(const Rows& p, float alpha, float delta, int base, Rec& a,
                                    float& f0, float& f1) {
  gather(rbf_row(p.w0, a.u, p.b0, a.h1), base, a.a1);
  gather(rbf_row(p.w1, a.a1, p.b1, a.h2), base, a.a2);
  gather(rbf_row(p.w2, a.a2, p.b2, a.h3), base, a.a3);
  float o[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    float s = __fmul_rn(p.w3[j][0], a.a3[0]);
#pragma unroll
    for (int c = 1; c < kHidden; ++c) s = __fmaf_rn(p.w3[j][c], a.a3[c], s);
    o[j] = __fadd_rn(s, p.b3[j]);
  }
  f0 = __fmaf_rn(alpha, a.u[0], o[0]);
  f1 = __fmaf_rn(-delta, a.u[1], o[1]);
}

// Back through the thread's row of h = W x + b, a = exp(-h^2): ba (the
// cotangent of its a) in; its weight terms added to gw, gb; returns its dh,
// -2 ((ba a) h), autograd's rounding.
template <int K>
__device__ __forceinline__ float rbf_back(float ba, float a, float h, const float (&x)[K],
                                          float (&gw)[K], float& gb) {
  const float dh = __fmul_rn(-2.0f, __fmul_rn(__fmul_rn(ba, a), h));
  gb = __fadd_rn(gb, dh);
#pragma unroll
  for (int c = 0; c < K; ++c) gw[c] = __fmaf_rn(dh, x[c], gw[c]);
  return dh;
}

// the thread's column of W^T dh, dh gathered from the group
__device__ __forceinline__ float back_col(const float (&col)[kHidden], float dh, int base) {
  float all[kHidden];
  gather(dh, base, all);
  float s = __fmul_rn(col[0], all[0]);
#pragma unroll
  for (int c = 1; c < kHidden; ++c) s = __fmaf_rn(col[c], all[c], s);
  return s;
}

// The VJP of f at the stage recorded in a, cotangent (v0, v1): the input's
// cotangent (bu0, bu1) out, the thread's weight terms added to g.
__device__ __forceinline__ void rhs_vjp(const Rows& p, Sums& g, const Rec& a, int r, int base,
                                        float alpha, float delta, float v0, float v1, float& bu0,
                                        float& bu1) {
  const float v[kOut] = {v0, v1};
  // the thread's own entries, selected without indexing by r
  float ar1 = a.a1[0], ar2 = a.a2[0], ar3 = a.a3[0], w30 = p.w3[0][0], w31 = p.w3[1][0];
#pragma unroll
  for (int c = 1; c < kHidden; ++c)
    if (r == c) {
      ar1 = a.a1[c];
      ar2 = a.a2[c];
      ar3 = a.a3[c];
      w30 = p.w3[0][c];
      w31 = p.w3[1][c];
    }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    g.b3[j] = __fadd_rn(g.b3[j], v[j]);
    g.w3[j] = __fmaf_rn(v[j], ar3, g.w3[j]);
  }
  float ba = __fmaf_rn(w31, v[1], __fmul_rn(w30, v[0]));
  ba = back_col(p.c2, rbf_back(ba, ar3, a.h3, a.a2, g.w2, g.b2), base);
  ba = back_col(p.c1, rbf_back(ba, ar2, a.h2, a.a1, g.w1, g.b1), base);
  float dh[kHidden];
  gather(rbf_back(ba, ar1, a.h1, a.u, g.w0, g.b0), base, dh);
  float bu[kIn];
#pragma unroll
  for (int c = 0; c < kIn; ++c) {
    float s = __fmul_rn(p.w0all[0][c], dh[0]);
#pragma unroll
    for (int k = 1; k < kHidden; ++k) s = __fmaf_rn(p.w0all[k][c], dh[k], s);
    bu[c] = s;
  }
  bu0 = __fmaf_rn(alpha, v0, bu[0]);
  bu1 = __fmaf_rn(-delta, v1, bu[1]);
}

// Stages 1 .. 5 of a step from (y0, y1), k0[0], k1[0] = f(y) given; with
// kStore, stage i's record goes to recs + i * kRec * kThreads.
template <bool kStore>
__device__ __forceinline__ void stages(const Rows& p, const Coef& cf, float alpha, float delta,
                                       int base, float y0, float y1, float (&k0)[kStages],
                                       float (&k1)[kStages], float* recs) {
#pragma unroll
  for (int i = 1; i < kStages; ++i) {
    const int row = i * (i - 1) / 2;
    Rec a;
    a.u[0] = y0;
    a.u[1] = y1;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      a.u[0] = __fmaf_rn(cf.a[row + j], k0[j], a.u[0]);
      a.u[1] = __fmaf_rn(cf.a[row + j], k1[j], a.u[1]);
    }
    rhs(p, alpha, delta, base, a, k0[i], k1[i]);
    if (kStore) io_rec<false>(a, recs + i * kRec * kThreads, kThreads);
  }
}

// the cotangent of a saved state from its residual: 2 (w (y - d)), w the
// mean's 1 / (2 samples)
__device__ __forceinline__ float seed(float y, float d, float w) {
  return __fmul_rn(2.0f, __fmul_rn(w, __fsub_rn(y, d)));
}

__global__ void __launch_bounds__(kThreads)
lv_lanes_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                float* __restrict__ loss, float* __restrict__ grad, int lanes, int samples,
                int sub, float alpha, float delta, Coef cf) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, q = t / kGroup, base = q * kGroup;
  const int r = min(t % kGroup, kHidden - 1);
  const bool owner = t % kGroup < kHidden, first = t % kGroup == 0;
  const int lane = blockIdx.x * kLanesPerBlock + q;
  // a group past the last lane runs it again and writes nothing: every thread
  // of the warp takes part in every shuffle
  const bool real = lane < lanes;
  const int l = real ? lane : lanes - 1;
  const int n_steps = (samples - 1) * sub;
  float2* ys = reinterpret_cast<float2*>(smem) + q;  // the group's y_n at ys[n * kLanesPerBlock]
  float* recs = smem + 2 * (n_steps + 1) * kLanesPerBlock + t;
  const float* d = data + (size_t)l * samples * 2;
  const float* th = theta + (size_t)l * kParams;

  Rows p;
  p.b0 = th[r];
  p.b1 = th[kOff1 + r];
  p.b2 = th[kOff2 + r];
#pragma unroll
  for (int c = 0; c < kIn; ++c) p.w0[c] = th[kHidden + r * kIn + c];
#pragma unroll
  for (int c = 0; c < kHidden; ++c) {
    p.w1[c] = th[kOff1 + kHidden + r * kHidden + c];
    p.c1[c] = th[kOff1 + kHidden + c * kHidden + r];
    p.w2[c] = th[kOff2 + kHidden + r * kHidden + c];
    p.c2[c] = th[kOff2 + kHidden + c * kHidden + r];
  }
#pragma unroll
  for (int k = 0; k < kHidden; ++k)
#pragma unroll
    for (int c = 0; c < kIn; ++c) p.w0all[k][c] = th[kHidden + k * kIn + c];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    p.b3[j] = th[kOff3 + j];
#pragma unroll
    for (int c = 0; c < kHidden; ++c) p.w3[j][c] = th[kOff3 + kOut + j * kHidden + c];
  }

  // forward: the solve, each y_n kept, the squared residuals summed
  float y0 = d[0], y1 = d[1];
  if (first) ys[0] = make_float2(y0, y1);
  double sq = 0.0;
  {
    const float r0 = __fsub_rn(y0, d[0]), r1 = __fsub_rn(y1, d[1]);
    sq += (double)__fmul_rn(r0, r0) + (double)__fmul_rn(r1, r1);
  }
  float k0[kStages], k1[kStages];
  {
    Rec a;
    a.u[0] = y0;
    a.u[1] = y1;
    rhs(p, alpha, delta, base, a, k0[0], k1[0]);
  }
  for (int n = 0; n < n_steps; ++n) {
    stages<false>(p, cf, alpha, delta, base, y0, y1, k0, k1, recs);
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      y0 = __fmaf_rn(cf.b[j], k0[j], y0);
      y1 = __fmaf_rn(cf.b[j], k1[j], y1);
    }
    if (first) ys[(n + 1) * kLanesPerBlock] = make_float2(y0, y1);
    if ((n + 1) % sub == 0) {
      const int s = (n + 1) / sub;
      const float r0 = __fsub_rn(y0, d[2 * s]), r1 = __fsub_rn(y1, d[2 * s + 1]);
      sq += (double)__fmul_rn(r0, r0) + (double)__fmul_rn(r1, r1);
    }
    Rec a;  // the last stage, f(y_{n+1}): the next step's first
    a.u[0] = y0;
    a.u[1] = y1;
    rhs(p, alpha, delta, base, a, k0[0], k1[0]);
  }
  if (real && first) loss[l] = (float)(sq / (2.0 * samples));
  __syncwarp();  // the group's states, written by its first thread

  // reverse: (l0, l1) the adjoint of y_n, from the last step back
  Sums g{};
  const float w = 1.0f / (float)(2 * samples);
  float l0 = seed(y0, d[2 * (samples - 1)], w), l1 = seed(y1, d[2 * (samples - 1) + 1], w);
  for (int n = n_steps - 1; n >= 0; --n) {
    const float2 yn = ys[n * kLanesPerBlock];
    {
      Rec a;
      a.u[0] = yn.x;
      a.u[1] = yn.y;
      rhs(p, alpha, delta, base, a, k0[0], k1[0]);
      io_rec<false>(a, recs, kThreads);
    }
    stages<true>(p, cf, alpha, delta, base, yn.x, yn.y, k0, k1, recs);
    // y_{n+1} = y_n + sum_j cb_j k_j: each k_j's cotangent starts at cb_j l
    float bk0[kStages], bk1[kStages];
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      bk0[j] = __fmul_rn(cf.b[j], l0);
      bk1[j] = __fmul_rn(cf.b[j], l1);
    }
    float by0 = l0, by1 = l1;
#pragma unroll
    for (int i = kStages - 1; i >= 0; --i) {
      Rec a;
      io_rec<true>(a, recs + i * kRec * kThreads, kThreads);
      float bu0, bu1;
      rhs_vjp(p, g, a, r, base, alpha, delta, bk0[i], bk1[i], bu0, bu1);
      by0 = __fadd_rn(by0, bu0);
      by1 = __fadd_rn(by1, bu1);
      const int row = i * (i - 1) / 2;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        bk0[j] = __fmaf_rn(cf.a[row + j], bu0, bk0[j]);
        bk1[j] = __fmaf_rn(cf.a[row + j], bu1, bk1[j]);
      }
    }
    l0 = by0;
    l1 = by1;
    if (n > 0 && n % sub == 0) {
      const int s = n / sub;
      l0 = __fadd_rn(l0, seed(yn.x, d[2 * s], w));
      l1 = __fadd_rn(l1, seed(yn.y, d[2 * s + 1], w));
    }
  }
  if (real && owner) {
    float* gl = grad + (size_t)l * kParams;
    gl[r] = g.b0;
    gl[kOff1 + r] = g.b1;
    gl[kOff2 + r] = g.b2;
#pragma unroll
    for (int c = 0; c < kIn; ++c) gl[kHidden + r * kIn + c] = g.w0[c];
#pragma unroll
    for (int c = 0; c < kHidden; ++c) {
      gl[kOff1 + kHidden + r * kHidden + c] = g.w1[c];
      gl[kOff2 + kHidden + r * kHidden + c] = g.w2[c];
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) gl[kOff3 + kOut + j * kHidden + r] = g.w3[j];
    if (first) {
#pragma unroll
      for (int j = 0; j < kOut; ++j) gl[kOff3 + j] = g.b3[j];
    }
  }
}

}  // namespace

extern "C" {

// the most steps a launch takes
int ude_lv_lanes_max_steps() { return kMaxSteps; }

// loss (lanes,) and grad (lanes, 87) of theta (lanes, 87) and data (lanes,
// samples, 2), all float32 and contiguous on the current device; coef holds
// 21 host floats: dt * a[i][j] (rows 1 .. 5 of Tsit5's a), then dt * b[j]
// (j = 0 .. 5).  Returns a cudaError_t.
int ude_lv_lanes(const float* theta, const float* data, float* loss, float* grad, int lanes,
                 int samples, int sub, float alpha, float delta, const float* coef,
                 void* stream) {
  if (lanes < 1 || samples < 2 || sub < 1 || (long)(samples - 1) * sub > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  Coef cf;
  for (int k = 0; k < kCoefA; ++k) cf.a[k] = coef[k];
  for (int k = 0; k < kStages; ++k) cf.b[k] = coef[kCoefA + k];
  const int n_steps = (samples - 1) * sub;
  const size_t smem = sizeof(float) * ((size_t)2 * (n_steps + 1) * kLanesPerBlock
                                       + (size_t)kStages * kRec * kThreads);
  const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  lv_lanes_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      theta, data, loss, grad, lanes, samples, sub, alpha, delta, cf);
  return (int)cudaGetLastError();
}

}  // extern "C"
