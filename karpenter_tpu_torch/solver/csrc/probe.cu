// Device round-trip probe, hand-written for Hopper (sm_90a).
//
//   rtt_probe  <- TPUSolver.device_rtt (karpenter_tpu/solver/solver.py:1519-1543):
//                 the jitted `x + 1` on int32[8] whose result the host reads
//                 back, so that race admission knows what one device round
//                 trip costs
//
// The work is a handful of words: the launch and the copy back are the
// whole cost, which is what the probe measures. The plain PyTorch version
// (x + 1) lives beside the wrapper in solver/torch_solver.py.

#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 32;

struct ProbeArgs {
  const int* x;  // [n]
  int* y;        // [n] = x + 1, wrapping as int32 does
  long long n;
};

// One thread per value. Bound: bytes, n values read and written once (64
// bytes for the probe's int32[8]), far below a launch's own cost.
__global__ void __launch_bounds__(kProbeThreads) k_rtt_probe(ProbeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < a.n) a.y[i] = static_cast<int>(static_cast<unsigned>(a.x[i]) + 1u);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface: launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 when the launch was accepted).
// ---------------------------------------------------------------------------

extern "C" {

int kts_rtt_probe(const int* x, int* y, long long n, void* stream) {
  ProbeArgs a{x, y, n};
  const long long blocks = (n + kProbeThreads - 1) / kProbeThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 1 ? 1 : blocks);
  k_rtt_probe<<<grid, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
