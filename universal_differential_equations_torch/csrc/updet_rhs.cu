// Fused universal-PDE right-hand side for the Fisher-KPP model family, and its
// tangent:
//
//   out[r, i] = MLP(u[r, i]) + d0 * (taps0 * u[r, i-1] + taps1 * u[r, i] + taps2 * u[r, i+1])
//
// with a periodic wrap inside each of the `rows` independent rows of length n.
// MLP is pointwise, 1 -> h1 -> ... -> 1, tanh on hidden layers, identity on the
// output, weights W (h_in, h_out) and biases b (h_out).
//
// Kernel A (`rhs_net`, `rhs_generic`) computes `out`.  It replaces the two
// Pallas TPU kernels of universal_differential_equations_tpu/ops/pallas_stencil.py,
// `_kernel` (:58, one VMEM block, N % 1024 == 0) and `_kernel_gridded` (:160, a
// blocked grid with an SMEM halo table beyond the VMEM budget): on Hopper one
// launch over a grid of thread blocks takes any n >= 1 and any number of rows.
//
// Kernel B (`tan_net`, `tan_generic`) computes the JVP of the same function for
// T directions in one launch:
//
//   dout[t] = dMLP(u; du[t], dW[t], db[t]) + dd0[t] * conv(u) + d0 * dconv[t],
//   dconv[t] = conv_{dtaps[t]}(u) + conv_{taps}(du[t]),
//
// the counterpart of the JAX package's tangent rule `_fused_rhs_jvp`
// (pallas_stencil.py:153, `jax.jvp` of the XLA math).  Under
// `torch.func.jacfwd` the Levenberg-Marquardt trainer's every RHS call costs
// one launch of A and one of B.  There is no backward kernel: the VJP is
// PyTorch math, as the JAX package's is XLA math.
//
// Design.
//   * Compile-time widths.  `rhs_net<P, W...>` and `tan_net<W...>` are
//     instantiated for the nets in UDE_NETS below (the four reaction nets of
//     models/fisher_kpp.py); every layer is unrolled, so the activations live
//     in registers (ptxas: 0-byte stack frame, 0 spills).  Any other widths run
//     the runtime-width kernels `rhs_generic` / `tan_generic`, whose
//     activations live in local memory.  `ude_nets` reports the compiled list,
//     and the Python dispatch reads it from here.
//   * Parameters are passed by value as pointers plus element strides (the
//     model hands in transposed views), so no per-call packing copy exists.
//     Each block stages the weights it needs in shared memory, as W^T rows
//     padded to 4 floats so a warp reads them as uniform (broadcast) loads.
//   * Kernel A gives each thread P consecutive points (P = 2 for the paper
//     net, 4 for the small ones): each staged weight feeds P independent FMA
//     chains, u and out move as 8- or 16-byte vectors where the row is
//     aligned, and the one-element periodic halo comes from the neighbouring
//     lane by warp shuffle (lanes 0 and 31 and the row's ends read device
//     memory, where L1 holds it).
//   * Kernel B serves one direction per block (blockIdx.z): the block stages
//     the primal weights and that direction's weight tangents, then each thread
//     recomputes h and carries dz = dh W + h dW + db, dh = (1 - h^2) dz.
//   * tanh is 1 - 2 / (1 + e^{2x}) with the fast exp2 and reciprocal (two MUFU
//     instructions).  Absolute error ~2e-7 against tanhf: far inside the 2e-5
//     bound against the plain PyTorch version.  `tanh.approx.f32` (one MUFU,
//     ~2^-11 relative error) would break it; a rational approximation (one
//     MUFU, ~15 FMAs) would load the FMA pipe more than it relieves MUFU.
//
// What bounds it on an H100 (SXM, 700 W; 132 SMs, 128 FP32 lanes and 16 MUFU
// lanes per SM per clock).  The paper net, per point: 2 * (10 + 200 + 200 + 10)
// = 840 FLOP of layer FMAs, 41 bias adds, 40 tanh, 7 stencil ops: 928 FLOP
// counted the roofline's way, against 8 bytes of u and out, so f32-compute
// bound at large n (0.97 GFLOP at n = 2^20: 14.5 us at 67 TFLOP/s).  In issue
// slots the 40 tanh cost 80 MUFU (5 clocks per point per SM at 16 a clock)
// against ~590 FMA-pipe instructions (4.6 clocks at 128 a clock), so the MUFU
// pipe, not the FMA pipe, sets the floor.  That is also why tensor cores
// (mma.sync with a 3xTF32 split for the 10->20 and 20->10 layers) are not
// used: they would take 400 FMAs per point off a pipe that is not the limit,
// and add the split's conversions and the fragment shuffles to the issue
// slots, while the 80 MUFU per point remain.  The small nets (1->3->1: 26 FLOP
// per point) are memory bound: 8 bytes per point at 3.35 TB/s.  At the model's
// n = 26 one warp does all the work and the launch sets the time.  Kernel B
// needs the primal net once per point and 1856 FLOP per (direction, point) for
// the tangent of the paper net (4 per weight, one per bias, 3 per tanh, 15 for
// the stencil): at the main path's T = 465, n = 26 that is 22.5 MFLOP, 0.34 us
// at 67 TFLOP/s, under the launch floor; its worth is the ~60 PyTorch launches
// of the plain tangent that each of its launches replaces.
// chip_smoke.py phase 2 prints each kernel's registers, stack frame and spills
// (ptxas) and its FFMA and MUFU counts (cuobjdump -sass).
//
// The kernels allocate nothing and launch on the caller's stream; each launch
// function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define UDE_TPB 128          // threads per block of the specialised kernels and tan_generic
#define UDE_GENERIC_TPB 256  // threads per block of rhs_generic
#define UDE_MAX_LAYERS 8
#define UDE_MAX_WIDTH 64
#define UDE_MAX_PACKED 8192  // floats of weights and biases the runtime-width kernels stage

// The nets compiled with fixed widths: X(points per thread, widths...).
#define UDE_NETS(X)      \
  X(2, 1, 10, 20, 10, 1) \
  X(4, 1, 3, 1)          \
  X(4, 1, 2, 1)          \
  X(4, 1, 1, 1)

// One layer's weights W[j, k] = W[t * wt + j * w0 + k * w1] and biases
// b[k] = b[t * bt + k * bs]; t is the tangent direction (0 for the primal).
struct Layer {
  const float* W;
  const float* b;
  long long wt, w0, w1, bt, bs;
};

// taps[i] = taps[t * taps_t + i * taps_s], d0 = d0[t * d0_t].
struct NetArgs {
  const float* taps;
  const float* d0;
  long long taps_t, taps_s, d0_t;
  int n_layers;
  int widths[UDE_MAX_LAYERS + 1];
  Layer L[UDE_MAX_LAYERS];
};

__device__ __forceinline__ float tanh_fast(float x) {
  const float r = __fdividef(1.0f, 1.0f + __expf(2.0f * x));
  return fmaf(-2.0f, r, 1.0f);
}

// ---------------------------------------------------------------------------
// compile-time nets
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

template <int IN, int OUT>
struct LayerSize {  // staged floats: W^T rows padded to 4, then the padded bias
  static constexpr int value = OUT * pad4(IN) + pad4(OUT);
};

template <int... W>
struct NetSize;
template <int A>
struct NetSize<A> {
  static constexpr int value = 0;
};
template <int A, int B, int... R>
struct NetSize<A, B, R...> {
  static constexpr int value = LayerSize<A, B>::value + NetSize<B, R...>::value;
};

template <int... W>
struct Count {
  static constexpr int value = sizeof...(W);
};

// Element e of layers LI.. of direction t, counted through each layer's W
// (h_in * h_out, row k of W^T after row k - 1) and then its b: returns the
// value and sets dst to its staged offset (-1 past the last layer), where
// s[k * pad4(IN) + j] = W[j, k], then b.
template <int LI, int... W>
struct Elem;
template <int LI, int A>
struct Elem<LI, A> {
  static constexpr int count = 0;
  __device__ static __forceinline__ float load(int, const NetArgs&, int, int& dst, int) {
    dst = -1;
    return 0.0f;
  }
};
template <int LI, int IN, int OUT, int... R>
struct Elem<LI, IN, OUT, R...> {
  static constexpr int count = IN * OUT + OUT + Elem<LI + 1, OUT, R...>::count;
  __device__ static __forceinline__ float load(int e, const NetArgs& a, int t, int& dst,
                                               int base) {
    const Layer& l = a.L[LI];
    if (e < IN * OUT) {
      const int k = e / IN, j = e - k * IN;
      dst = base + k * pad4(IN) + j;
      return l.W[t * l.wt + j * l.w0 + k * l.w1];
    }
    if (e < IN * OUT + OUT) {
      const int k = e - IN * OUT;
      dst = base + OUT * pad4(IN) + k;
      return l.b[t * l.bt + k * l.bs];
    }
    return Elem<LI + 1, OUT, R...>::load(e - IN * OUT - OUT, a, t, dst,
                                         base + LayerSize<IN, OUT>::value);
  }
};

// Stages direction t's weights into s (a block of UDE_TPB threads).  Each
// thread issues all its loads before its first shared-memory store: a store
// waits for its load, so a loop of load-store pairs would put one device-memory
// round trip per pair on the critical path that sets the time at small n.
template <int... W>
struct Stage {
  static constexpr int K = (Elem<0, W...>::count + UDE_TPB - 1) / UDE_TPB;
  __device__ static __forceinline__ void load(const NetArgs& a, int t, float (&v)[K],
                                              int (&dst)[K]) {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = Elem<0, W...>::load(threadIdx.x + r * UDE_TPB, a, t, dst[r], 0);
  }
  __device__ static __forceinline__ void store(float* s, const float (&v)[K], const int (&dst)[K]) {
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (dst[r] >= 0) s[dst[r]] = v[r];
  }
};

// The net on P points: x is the layer's input, y receives the net's output.
template <int P, int IN, int OUT, int... R>
struct Fwd {
  __device__ static __forceinline__ void run(const float* __restrict__ s,
                                             const float (&x)[IN][P], float (&y)[P]) {
    constexpr int INP = pad4(IN);
    constexpr bool last = sizeof...(R) == 0;
    float h[OUT][P];
#pragma unroll
    for (int k = 0; k < OUT; ++k) {
      const float bk = s[OUT * INP + k];
#pragma unroll
      for (int p = 0; p < P; ++p) h[k][p] = bk;
#pragma unroll
      for (int j = 0; j < IN; ++j) {
        const float w = s[k * INP + j];
#pragma unroll
        for (int p = 0; p < P; ++p) h[k][p] = fmaf(w, x[j][p], h[k][p]);
      }
      if (!last) {
#pragma unroll
        for (int p = 0; p < P; ++p) h[k][p] = tanh_fast(h[k][p]);
      }
    }
    if constexpr (last) {
      static_assert(OUT == 1, "the net ends in one output");
#pragma unroll
      for (int p = 0; p < P; ++p) y[p] = h[0][p];
    } else {
      Fwd<P, OUT, R...>::run(s + LayerSize<IN, OUT>::value, h, y);
    }
  }
};

// The net and its tangent at one point: s holds the staged weights, ds their
// tangents; (x, dx) is the layer's input and its tangent.
template <int IN, int OUT, int... R>
struct Tan {
  __device__ static __forceinline__ void run(const float* __restrict__ s,
                                             const float* __restrict__ ds,
                                             const float (&x)[IN], const float (&dx)[IN],
                                             float& y, float& dy) {
    constexpr int INP = pad4(IN);
    constexpr bool last = sizeof...(R) == 0;
    float h[OUT], dh[OUT];
#pragma unroll
    for (int k = 0; k < OUT; ++k) {
      float z = s[OUT * INP + k];
      float dz = ds[OUT * INP + k];
#pragma unroll
      for (int j = 0; j < IN; ++j) {
        const float w = s[k * INP + j];
        z = fmaf(w, x[j], z);
        dz = fmaf(w, dx[j], fmaf(ds[k * INP + j], x[j], dz));
      }
      if (last) {
        h[k] = z;
        dh[k] = dz;
      } else {
        h[k] = tanh_fast(z);
        dh[k] = fmaf(-h[k], h[k], 1.0f) * dz;
      }
    }
    if constexpr (last) {
      static_assert(OUT == 1, "the net ends in one output");
      y = h[0];
      dy = dh[0];
    } else {
      Tan<OUT, R...>::run(s + LayerSize<IN, OUT>::value, ds + LayerSize<IN, OUT>::value, h, dh,
                          y, dy);
    }
  }
};

template <int P>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// Kernel A, compile-time widths: grid (ceil(n / (UDE_TPB * P)), rows); each
// thread takes the P consecutive points from (blockIdx.x * UDE_TPB + threadIdx.x) * P.
template <int P, int... W>
__global__ void __launch_bounds__(UDE_TPB)
    rhs_net(const float* __restrict__ u, float* __restrict__ out,
            const __grid_constant__ NetArgs a, int n) {
  using V = typename Vec<P>::T;
  __shared__ __align__(16) float s_w[NetSize<W...>::value];

  // Every device-memory load is issued before the barrier, so that at small
  // n, where latency sets the time, they overlap the weights' staging.
  const float t0 = a.taps[0], t1 = a.taps[a.taps_s], t2 = a.taps[2 * a.taps_s];
  const float d0 = a.d0[0];
  const int lane = threadIdx.x & 31;
  const int i0 = (blockIdx.x * UDE_TPB + threadIdx.x) * P;
  const size_t row_off = (size_t)blockIdx.y * n;
  const float* row = u + row_off;
  const int c = min(P, n - i0);  // this thread's points (<= 0 past the row's end)
  const int after = i0 + c;      // the point right of this thread's last one
  const bool vec = c == P && reinterpret_cast<uintptr_t>(row + i0) % sizeof(V) == 0 &&
                   reinterpret_cast<uintptr_t>(out + row_off + i0) % sizeof(V) == 0;
  float x[P];
  if (vec) {
    const V v = *reinterpret_cast<const V*>(row + i0);
    memcpy(x, &v, sizeof(V));
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) x[p] = p < c ? row[i0 + p] : 0.0f;
  }
  // the halo where no neighbouring lane holds it: the row's wrap, and lanes 0 and 31
  const float left_mem = c > 0 && (i0 == 0 || lane == 0) ? row[i0 == 0 ? n - 1 : i0 - 1] : 0.0f;
  const float right_mem = c > 0 && (after == n || lane == 31) ? row[after == n ? 0 : after] : 0.0f;
  float wv[Stage<W...>::K];
  int wdst[Stage<W...>::K];
  Stage<W...>::load(a, 0, wv, wdst);
  Stage<W...>::store(s_w, wv, wdst);

  const float from_left = __shfl_up_sync(0xffffffffu, x[P - 1], 1);
  const float from_right = __shfl_down_sync(0xffffffffu, x[0], 1);
  __syncthreads();  // the staged weights
  if (c <= 0) return;
  const float left = i0 == 0 || lane == 0 ? left_mem : from_left;
  const float right = after == n || lane == 31 ? right_mem : from_right;

  float in[1][P];
#pragma unroll
  for (int p = 0; p < P; ++p) in[0][p] = x[p];
  float rx[P];
  Fwd<P, W...>::run(s_w, in, rx);

  float o[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float xl = p == 0 ? left : x[p == 0 ? 0 : p - 1];
    const float xr = p + 1 < c ? x[p + 1 < P ? p + 1 : P - 1] : right;
    o[p] = rx[p] + d0 * (t0 * xl + t1 * x[p] + t2 * xr);
  }
  float* orow = out + row_off;
  if (vec) {
    V v;
    memcpy(&v, o, sizeof(V));
    *reinterpret_cast<V*>(orow + i0) = v;
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (p < c) orow[i0 + p] = o[p];
  }
}

// Kernel B, compile-time widths: grid (ceil(n / UDE_TPB), rows, T); block z
// serves direction z.  du and dout are (T, rows, n) contiguous.  The bound of
// 4 blocks per SM caps registers at 128 (the paper net takes 127, so the 465
// blocks of the main path run in one wave); without a minimum ptxas kept
// tan_net<1, 3, 1> at 32 registers with a 4-byte spill.
template <int... W>
__global__ void __launch_bounds__(UDE_TPB, 4)
    tan_net(const float* __restrict__ u, const float* __restrict__ du, float* __restrict__ dout,
            const __grid_constant__ NetArgs a, const __grid_constant__ NetArgs da, int n,
            int rows) {
  __shared__ __align__(16) float s_w[NetSize<W...>::value];
  __shared__ __align__(16) float s_dw[NetSize<W...>::value];
  const int t = blockIdx.z;
  {
    float wv[Stage<W...>::K], dwv[Stage<W...>::K];
    int wdst[Stage<W...>::K], dwdst[Stage<W...>::K];
    Stage<W...>::load(a, 0, wv, wdst);
    Stage<W...>::load(da, t, dwv, dwdst);
    Stage<W...>::store(s_w, wv, wdst);
    Stage<W...>::store(s_dw, dwv, dwdst);
  }
  __syncthreads();
  // Unlike rhs_net, the loads follow the barrier: issued before it, their
  // values stay live across the unrolled net and push the paper net past 128
  // registers, and then the main path's 465 blocks no longer fit the card at once.
  const int i = blockIdx.x * UDE_TPB + threadIdx.x;
  if (i >= n) return;
  const int il = i == 0 ? n - 1 : i - 1;
  const int ir = i == n - 1 ? 0 : i + 1;
  const float* row = u + (size_t)blockIdx.y * n;
  const size_t drow_off = ((size_t)t * rows + blockIdx.y) * n;
  const float* drow = du + drow_off;
  const float x = row[i], xl = row[il], xr = row[ir];
  const float dx = drow[i], dxl = drow[il], dxr = drow[ir];

  const float in[1] = {x}, din[1] = {dx};
  float y, dy;
  Tan<W...>::run(s_w, s_dw, in, din, y, dy);

  const float t0 = a.taps[0], t1 = a.taps[a.taps_s], t2 = a.taps[2 * a.taps_s];
  const float* dtaps = da.taps + t * da.taps_t;
  const float dt0 = dtaps[0], dt1 = dtaps[da.taps_s], dt2 = dtaps[2 * da.taps_s];
  const float d0 = a.d0[0], dd0 = da.d0[t * da.d0_t];
  const float conv = t0 * xl + t1 * x + t2 * xr;
  const float dconv = dt0 * xl + dt1 * x + dt2 * xr + t0 * dxl + t1 * dx + t2 * dxr;
  dout[drow_off + i] = dy + dd0 * conv + d0 * dconv;
}

// ---------------------------------------------------------------------------
// runtime widths
// ---------------------------------------------------------------------------
// Stage direction t's layers into s as W (h_in, h_out) row-major, then b.
__device__ void stage_generic(float* s, const NetArgs& a, int t) {
  int off = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int h_in = a.widths[l], h_out = a.widths[l + 1];
    const Layer& L = a.L[l];
    const float* W = L.W + t * L.wt;
    const float* b = L.b + t * L.bt;
    for (int i = threadIdx.x; i < h_in * h_out; i += blockDim.x) {
      const int j = i / h_out, k = i - j * h_out;
      s[off + i] = W[j * L.w0 + k * L.w1];
    }
    off += h_in * h_out;
    for (int k = threadIdx.x; k < h_out; k += blockDim.x) s[off + k] = b[k * L.bs];
    off += h_out;
  }
}

// Kernel A, runtime widths: one point per thread; grid (ceil(n / UDE_GENERIC_TPB), rows).
// Shared memory: n_par staged floats, then the block's span of u with one halo
// element on each side.
__global__ void __launch_bounds__(UDE_GENERIC_TPB)
    rhs_generic(const float* __restrict__ u, float* __restrict__ out,
                const __grid_constant__ NetArgs a, int n_par, int n) {
  extern __shared__ float smem[];
  float* s_par = smem;
  float* s_u = smem + n_par;
  const int tid = threadIdx.x;
  const int start = blockIdx.x * UDE_GENERIC_TPB;
  const float* row_u = u + (size_t)blockIdx.y * n;
  float* row_out = out + (size_t)blockIdx.y * n;

  stage_generic(s_par, a, 0);
  const int count = min(UDE_GENERIC_TPB, n - start);
  for (int i = tid; i < count + 2; i += UDE_GENERIC_TPB) {
    int g = start - 1 + i;  // in [start - 1, start + count] subset of [-1, n]
    g = g < 0 ? g + n : (g >= n ? g - n : g);
    s_u[i] = row_u[g];
  }
  __syncthreads();
  if (tid >= count) return;

  const float x = s_u[tid + 1];
  float buf_a[UDE_MAX_WIDTH];
  float buf_b[UDE_MAX_WIDTH];
  float* in = buf_a;
  float* nxt = buf_b;
  in[0] = x;
  const float* p = s_par;
  for (int l = 0; l < a.n_layers; ++l) {
    const int h_in = a.widths[l];
    const int h_out = a.widths[l + 1];
    const float* W = p;
    const float* bias = p + h_in * h_out;
    const bool hidden = l < a.n_layers - 1;
    for (int k = 0; k < h_out; ++k) {
      float acc = bias[k];
      for (int j = 0; j < h_in; ++j) acc = fmaf(W[j * h_out + k], in[j], acc);
      nxt[k] = hidden ? tanh_fast(acc) : acc;
    }
    p += h_in * h_out + h_out;
    float* tmp = in;
    in = nxt;
    nxt = tmp;
  }
  const float t0 = a.taps[0], t1 = a.taps[a.taps_s], t2 = a.taps[2 * a.taps_s];
  const float conv = t0 * s_u[tid] + t1 * x + t2 * s_u[tid + 2];
  row_out[start + tid] = in[0] + a.d0[0] * conv;
}

// Kernel B, runtime widths: grid (ceil(n / UDE_TPB), rows, T); shared memory holds
// the primal's n_par staged floats, then direction blockIdx.z's.
__global__ void __launch_bounds__(UDE_TPB)
    tan_generic(const float* __restrict__ u, const float* __restrict__ du,
                float* __restrict__ dout, const __grid_constant__ NetArgs a,
                const __grid_constant__ NetArgs da, int n_par, int n, int rows) {
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_dp = smem + n_par;
  const int t = blockIdx.z;
  stage_generic(s_p, a, 0);
  stage_generic(s_dp, da, t);
  __syncthreads();
  const int i = blockIdx.x * UDE_TPB + threadIdx.x;
  if (i >= n) return;
  const int il = i == 0 ? n - 1 : i - 1;
  const int ir = i == n - 1 ? 0 : i + 1;
  const float* row = u + (size_t)blockIdx.y * n;
  const size_t drow_off = ((size_t)t * rows + blockIdx.y) * n;
  const float* drow = du + drow_off;
  const float x = row[i], dx = drow[i];

  float h_a[UDE_MAX_WIDTH], dh_a[UDE_MAX_WIDTH], h_b[UDE_MAX_WIDTH], dh_b[UDE_MAX_WIDTH];
  float *h = h_a, *dh = dh_a, *h2 = h_b, *dh2 = dh_b;
  h[0] = x;
  dh[0] = dx;
  int off = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int h_in = a.widths[l], h_out = a.widths[l + 1];
    const bool hidden = l < a.n_layers - 1;
    for (int k = 0; k < h_out; ++k) {
      float z = s_p[off + h_in * h_out + k];
      float dz = s_dp[off + h_in * h_out + k];
      for (int j = 0; j < h_in; ++j) {
        const float w = s_p[off + j * h_out + k];
        z = fmaf(w, h[j], z);
        dz = fmaf(w, dh[j], fmaf(s_dp[off + j * h_out + k], h[j], dz));
      }
      if (hidden) {
        h2[k] = tanh_fast(z);
        dh2[k] = fmaf(-h2[k], h2[k], 1.0f) * dz;
      } else {
        h2[k] = z;
        dh2[k] = dz;
      }
    }
    off += h_in * h_out + h_out;
    float* tmp = h;
    h = h2;
    h2 = tmp;
    tmp = dh;
    dh = dh2;
    dh2 = tmp;
  }
  const float xl = row[il], xr = row[ir], dxl = drow[il], dxr = drow[ir];
  const float t0 = a.taps[0], t1 = a.taps[a.taps_s], t2 = a.taps[2 * a.taps_s];
  const float* dtaps = da.taps + t * da.taps_t;
  const float dt0 = dtaps[0], dt1 = dtaps[da.taps_s], dt2 = dtaps[2 * da.taps_s];
  const float conv = t0 * xl + t1 * x + t2 * xr;
  const float dconv = dt0 * xl + dt1 * x + dt2 * xr + t0 * dxl + t1 * dx + t2 * dxr;
  dout[drow_off + i] = dh[0] + da.d0[t * da.d0_t] * conv + a.d0[0] * dconv;
}

__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef int (*FwdFn)(const float*, float*, const NetArgs&, int, int, cudaStream_t);
typedef int (*TanFn)(const float*, const float*, float*, const NetArgs&, const NetArgs&, int,
                     int, int, cudaStream_t);

template <int P, int... W>
static int launch_fwd(const float* u, float* out, const NetArgs& a, int n, int rows,
                      cudaStream_t st) {
  const int per_block = UDE_TPB * P;
  dim3 grid((n + per_block - 1) / per_block, rows);
  auto kern = rhs_net<P, W...>;
  kern<<<grid, UDE_TPB, 0, st>>>(u, out, a, n);
  return (int)cudaGetLastError();
}

template <int P, int... W>
static int launch_tan(const float* u, const float* du, float* dout, const NetArgs& a,
                      const NetArgs& da, int n, int rows, int T, cudaStream_t st) {
  dim3 grid((n + UDE_TPB - 1) / UDE_TPB, rows, T);
  auto kern = tan_net<W...>;
  kern<<<grid, UDE_TPB, 0, st>>>(u, du, dout, a, da, n, rows);
  return (int)cudaGetLastError();
}

struct NetEntry {
  int n_layers;
  int widths[UDE_MAX_LAYERS + 1];
  FwdFn fwd;
  TanFn tan;
};

#define UDE_ENTRY(P, ...) \
  {Count<__VA_ARGS__>::value - 1, {__VA_ARGS__}, &launch_fwd<P, __VA_ARGS__>, &launch_tan<P, __VA_ARGS__>},
static const NetEntry kNets[] = {UDE_NETS(UDE_ENTRY)};
static const int kNumNets = (int)(sizeof(kNets) / sizeof(kNets[0]));

// Checks the widths (1 -> ... -> 1, each in 1..UDE_MAX_WIDTH) and, for net >= 0,
// that they are the compiled net's; returns the staged floats, or -1.
static int check_net(int net, const int* widths, int n_layers) {
  if (n_layers < 1 || n_layers > UDE_MAX_LAYERS || widths[0] != 1 || widths[n_layers] != 1)
    return -1;
  int n_par = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (widths[l + 1] < 1 || widths[l + 1] > UDE_MAX_WIDTH) return -1;
    n_par += widths[l] * widths[l + 1] + widths[l + 1];
  }
  if (net >= 0) {
    if (net >= kNumNets || kNets[net].n_layers != n_layers) return -1;
    for (int l = 0; l <= n_layers; ++l)
      if (kNets[net].widths[l] != widths[l]) return -1;
  } else if (n_par > UDE_MAX_PACKED) {
    return -1;
  }
  return n_par;
}

// args: the pointers taps, d0, then W and b of each layer, as integers; then
// the element strides.  With `tangent` false: taps_s, then (w0, w1, bs) per
// layer.  With `tangent` true: taps_t, taps_s, d0_t, then (wt, w0, w1, bt, bs)
// per layer.
static void fill_args(NetArgs* a, const long long* args, const int* widths, int n_layers,
                      bool tangent) {
  memset(a, 0, sizeof(*a));
  const long long* s = args + 2 + 2 * n_layers;
  a->taps = (const float*)(uintptr_t)args[0];
  a->d0 = (const float*)(uintptr_t)args[1];
  if (tangent) {
    a->taps_t = s[0];
    a->taps_s = s[1];
    a->d0_t = s[2];
    s += 3;
  } else {
    a->taps_s = s[0];
    s += 1;
  }
  a->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) a->widths[l] = widths[l];
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = a->L[l];
    L.W = (const float*)(uintptr_t)args[2 + 2 * l];
    L.b = (const float*)(uintptr_t)args[3 + 2 * l];
    if (tangent) {
      L.wt = s[0];
      L.w0 = s[1];
      L.w1 = s[2];
      L.bt = s[3];
      L.bs = s[4];
      s += 5;
    } else {
      L.w0 = s[0];
      L.w1 = s[1];
      L.bs = s[2];
      s += 3;
    }
  }
}

extern "C" {

// Writes each compiled net as (n_layers, w0, ..., w_L) into buf (at most cap
// ints) and returns the number of ints all of them need.
int ude_nets(int* buf, int cap) {
  int k = 0;
  for (int i = 0; i < kNumNets; ++i) {
    const int L = kNets[i].n_layers;
    if (k < cap) buf[k] = L;
    ++k;
    for (int l = 0; l <= L; ++l, ++k)
      if (k < cap) buf[k] = kNets[i].widths[l];
  }
  return k;
}

// Kernel A: net >= 0 launches compiled net `net` (its widths must match), net
// == -1 the runtime-width kernel.  u and out are (rows, n) contiguous.
int ude_updet_rhs(int net, const float* u, float* out, const long long* args,
                  const int* widths, int n_layers, int n, int rows, void* stream) {
  if (n < 1 || rows < 1 || rows > 65535) return (int)cudaErrorInvalidValue;
  const int n_par = check_net(net, widths, n_layers);
  if (n_par < 0) return (int)cudaErrorInvalidValue;
  NetArgs a;
  fill_args(&a, args, widths, n_layers, false);
  cudaStream_t st = (cudaStream_t)stream;
  if (net >= 0) return kNets[net].fwd(u, out, a, n, rows, st);
  dim3 grid((n + UDE_GENERIC_TPB - 1) / UDE_GENERIC_TPB, rows);
  const size_t smem = (size_t)(n_par + UDE_GENERIC_TPB + 2) * sizeof(float);
  rhs_generic<<<grid, UDE_GENERIC_TPB, smem, st>>>(u, out, a, n_par, n);
  return (int)cudaGetLastError();
}

// Kernel B: T directions; du and dout are (T, rows, n) contiguous.  targs
// describes the tangents (dtaps, dd0, dW and db of each layer) as args does
// the primal's, with each tensor's direction stride first.
int ude_updet_rhs_tangent(int net, const float* u, const float* du, float* dout,
                          const long long* args, const long long* targs, const int* widths,
                          int n_layers, int n, int rows, int T, void* stream) {
  if (n < 1 || rows < 1 || rows > 65535 || T < 1 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_par = check_net(net, widths, n_layers);
  if (n_par < 0) return (int)cudaErrorInvalidValue;
  NetArgs a, da;
  fill_args(&a, args, widths, n_layers, false);
  fill_args(&da, targs, widths, n_layers, true);
  cudaStream_t st = (cudaStream_t)stream;
  if (net >= 0) return kNets[net].tan(u, du, dout, a, da, n, rows, T, st);
  const size_t smem = (size_t)2 * n_par * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tan_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + UDE_TPB - 1) / UDE_TPB, rows, T);
  tan_generic<<<grid, UDE_TPB, smem, st>>>(u, du, dout, a, da, n_par, n, rows);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel: the card's launch floor.
int ude_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* ude_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The caps the wrapper checks before a launch: threads per block of the
// runtime-width forward kernel, layers, width, staged floats.
void ude_limits(int* out4) {
  out4[0] = UDE_GENERIC_TPB;
  out4[1] = UDE_MAX_LAYERS;
  out4[2] = UDE_MAX_WIDTH;
  out4[3] = UDE_MAX_PACKED;
}

}  // extern "C"
