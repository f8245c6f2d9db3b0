// Connected components of the climbed mean-shift seeds, for Hopper (sm_90a).
//
// A kernel of the port with no TPU counterpart: the JAX package runs this
// step in XLA (unseenobjectswithmeanshift_tpu/ops/mean_shift.py
// connected_components, :81-115, a fori_loop over the seeds). Same function
// as ops/mean_shift.connected_components_plain (the numpy sweep): for each
// image's [S, S] adjacency `within` (seeds at cosine distance <= epsilon,
// computed on the device by the caller) and i = 0 .. S-1 in order, a seed i
// without a label gives every seed of row i the mode of the labels that row
// already holds (ties to the smallest label), or a new label K (then K + 1)
// when none of them has one. -> labels [B, S] int32 in [0, S).
//
// Bound. S^2 bytes of adjacency a image (10 KB at S = 100): nothing, next to
// a launch. What it removes is the host round trip of the numpy sweep (one
// copy and one sync per clustering call, 0.2 ms at B = 1 and 1.9 ms at
// B = 20 on the H100), so that UCN's stage 1 queues without a sync.
//
// Design: one block per image, one thread per seed (S <= 128). The sweep is
// sequential in i, as the reference's is; each step is block-parallel over
// the row: the row's labelled members count into a shared histogram
// (integer atomics, so the order does not matter), a block argmax takes the
// largest count with ties to the smallest label, and the row's members take
// the result. Every thread reads the same label of seed i after a barrier,
// so the branch is block-uniform.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SEEDS = 128;
constexpr int WARPS = MAX_SEEDS / 32;

// (count, label): larger count first, then the smaller label
__device__ __forceinline__ bool better(int c, int l, int bc, int bl) {
  return c > bc || (c == bc && l < bl);
}

__global__ void __launch_bounds__(MAX_SEEDS) cc_sweep_kernel(const uint8_t* __restrict__ within,
                                                             int* __restrict__ labels, int S) {
  __shared__ int lab[MAX_SEEDS];
  __shared__ int cnt[MAX_SEEDS];
  __shared__ int red_c[WARPS], red_l[WARPS];
  const int b = blockIdx.x, t = threadIdx.x;
  const uint8_t* w = within + (size_t)b * S * S;
  lab[t] = -1;
  int K = 0;   // labels opened so far (every thread keeps the same count)
  __syncthreads();
  for (int i = 0; i < S; ++i) {
    if (lab[i] != -1) continue;   // block-uniform: read after a barrier
    cnt[t] = 0;
    const bool member = t < S && w[(size_t)i * S + t] != 0;
    const int own = member ? lab[t] : -1;
    __syncthreads();
    if (own >= 0) atomicAdd(&cnt[own], 1);
    __syncthreads();
    int c = cnt[t], l = t;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int oc = __shfl_down_sync(0xffffffffu, c, off);
      const int ol = __shfl_down_sync(0xffffffffu, l, off);
      if (better(oc, ol, c, l)) { c = oc; l = ol; }
    }
    if (t % 32 == 0) { red_c[t / 32] = c; red_l[t / 32] = l; }
    __syncthreads();
    c = red_c[0];
    l = red_l[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k)
      if (better(red_c[k], red_l[k], c, l)) { c = red_c[k]; l = red_l[k]; }
    const bool has_labelled = c > 0;
    if (member) lab[t] = has_labelled ? l : K;
    K += has_labelled ? 0 : 1;
    __syncthreads();
  }
  if (t < S) labels[(size_t)b * S + t] = lab[t];
}

}  // namespace

extern "C" {

const char* uoms_cc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One launch on `stream`: within [B, S, S] u8 (nonzero = adjacent), labels
// [B, S] i32 (output). Returns 0, or the CUDA error (invalid value for S
// outside [1, 128]).
int uoms_connected_components(const uint8_t* within, int* labels, int B, int S, void* stream) {
  if (B < 1 || S < 1 || S > MAX_SEEDS) return (int)cudaErrorInvalidValue;
  cc_sweep_kernel<<<B, MAX_SEEDS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(within, labels, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
