// Fused universal-PDE right-hand side for the Fisher-KPP model family:
//
//   out[r, i] = MLP(u[r, i]) + d0 * (taps0 * u[r, i-1] + taps1 * u[r, i] + taps2 * u[r, i+1])
//
// with a periodic wrap inside each of the `rows` independent rows of length n.
// MLP is pointwise, 1 -> h1 -> ... -> 1, tanh on hidden layers, identity on the
// output.
//
// Replaces the two Pallas TPU kernels of
// universal_differential_equations_tpu/ops/pallas_stencil.py: `_kernel`
// (single VMEM block, N % 1024 == 0) and `_kernel_gridded` (blocked grid with an
// SMEM halo table, used beyond the VMEM budget).  On Hopper, thread blocks run in
// parallel and read their neighbours straight from device memory, so one launch
// over a grid of blocks covers both, at any n >= 1 and any number of rows.
//
// Layout:
//   * one thread per grid point; grid = (ceil(n / UDE_BLOCK), rows);
//   * each block stages its span of u plus one halo element on each side in
//     shared memory (the wrap is index arithmetic);
//   * `packed` holds [taps0, taps1, taps2, d0] and then, for each layer, its
//     weight matrix W (h_in, h_out) row-major followed by its bias (h_out).
//     Each block copies it to shared memory, where every thread of a warp reads
//     the same word (a broadcast, no bank conflicts).  The paper's
//     1->10->20->10->1 net is 461 floats;
//   * hidden activations live in per-thread arrays of UDE_MAX_WIDTH floats.
//     With runtime layer widths the compiler keeps them in local memory (L1).
//
// Arithmetic is f32 FMA with the accurate tanhf: build without
// --use_fast_math, whose tanh.approx.f32 (~2^-11 relative error) would break
// the 2e-5 parity bound with the plain PyTorch version.
//
// What bounds it on an H100: per point it reads and writes 4 bytes each and does
// about 2 * (1*10 + 10*20 + 20*10 + 10*1) = 840 FLOP plus 40 tanhf, about 105
// FLOP per byte, above the f32 ridge (~67 TFLOP/s over 3.35 TB/s, ~20 FLOP per
// byte).  So at large n it is bound by f32 arithmetic and tanhf, not by memory;
// at the model's n = 26 a single block does the work and the launch latency
// dominates.  The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

#define UDE_BLOCK 256
#define UDE_MAX_LAYERS 8
#define UDE_MAX_WIDTH 64
#define UDE_MAX_PACKED 8192  // floats; with the staged span this stays under 48 KB of shared memory

struct NetShape {
  int n_layers;
  int widths[UDE_MAX_LAYERS + 1];
};

__global__ void __launch_bounds__(UDE_BLOCK)
updet_rhs_kernel(const float* __restrict__ u, float* __restrict__ out,
                 const float* __restrict__ packed, int n_packed, NetShape net, int n) {
  extern __shared__ float smem[];
  float* s_par = smem;            // n_packed floats
  float* s_u = smem + n_packed;   // UDE_BLOCK + 2 floats: halo, span, halo

  const int tid = threadIdx.x;
  const int start = blockIdx.x * UDE_BLOCK;
  const float* row_u = u + (size_t)blockIdx.y * n;
  float* row_out = out + (size_t)blockIdx.y * n;

  for (int i = tid; i < n_packed; i += UDE_BLOCK) s_par[i] = packed[i];
  const int count = min(UDE_BLOCK, n - start);
  for (int i = tid; i < count + 2; i += UDE_BLOCK) {
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
  const float* p = s_par + 4;
  for (int l = 0; l < net.n_layers; ++l) {
    const int h_in = net.widths[l];
    const int h_out = net.widths[l + 1];
    const float* W = p;
    const float* bias = p + h_in * h_out;
    const bool hidden = l < net.n_layers - 1;
    for (int k = 0; k < h_out; ++k) {
      float acc = bias[k];
      for (int j = 0; j < h_in; ++j) acc = fmaf(W[j * h_out + k], in[j], acc);
      nxt[k] = hidden ? tanhf(acc) : acc;
    }
    p += h_in * h_out + h_out;
    float* t = in;
    in = nxt;
    nxt = t;
  }
  const float conv = s_par[0] * s_u[tid] + s_par[1] * x + s_par[2] * s_u[tid + 2];
  row_out[start + tid] = in[0] + s_par[3] * conv;
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on success).
// `widths` is a host array of n_layers + 1 ints; the wrapper has checked that the
// shapes chain and that `packed` holds the sum of h_in*h_out + h_out plus 4.
int ude_updet_rhs(const float* u, float* out, const float* packed, int n_packed,
                  const int* widths, int n_layers, int n, int rows, void* stream) {
  if (n_layers < 1 || n_layers > UDE_MAX_LAYERS || n < 1 || rows < 1 ||
      rows > 65535 || n_packed > UDE_MAX_PACKED)
    return (int)cudaErrorInvalidValue;
  NetShape net;
  net.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1 || widths[i] > UDE_MAX_WIDTH) return (int)cudaErrorInvalidValue;
    net.widths[i] = widths[i];
  }
  for (int i = n_layers + 1; i <= UDE_MAX_LAYERS; ++i) net.widths[i] = 0;
  dim3 grid((n + UDE_BLOCK - 1) / UDE_BLOCK, rows);
  size_t smem = (size_t)(n_packed + UDE_BLOCK + 2) * sizeof(float);
  updet_rhs_kernel<<<grid, UDE_BLOCK, smem, (cudaStream_t)stream>>>(u, out, packed, n_packed,
                                                                    net, n);
  return (int)cudaGetLastError();
}

const char* ude_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The caps the wrapper checks before a launch: block size, layers, width, packed floats.
void ude_limits(int* out4) {
  out4[0] = UDE_BLOCK;
  out4[1] = UDE_MAX_LAYERS;
  out4[2] = UDE_MAX_WIDTH;
  out4[3] = UDE_MAX_PACKED;
}

}  // extern "C"
