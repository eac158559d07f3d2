// Rational polyphase resampling of a block of every stream, the filter's
// taps computed directly:
//
//   y[n] = sum_k W[(n*M) % L, k] * full[floor(n*M/L) + K-1 - k],
//   full = [history (K-1 samples) | x (in_block samples)],
//
// and the new history, the last K-1 samples of full.  W [L, K] is
// ops/resample.py's design_polyphase table in f32; products and sums are
// f32, k = 0..K-1 in order.  One kernel for every (L, M, K): the engine's
// 48 -> 16 kHz (L = 1, M = 3, K = 97) and 24 -> 48 kHz (L = 2, M = 1,
// K = 33) edges, and offline conversion at any client rate (44.1 kHz in:
// L/M = 160/441).
//
// It replaces no TPU kernel: the JAX package computes the block as a
// banded-matrix product [history | x] @ S (beatrice_vst_tpu/ops/resample.py),
// which suits the TPU's matrix unit.  On the H100 that product ran in f32
// on the CUDA cores, 97 % of it multiplications by zero (at B = 4,096 and
// T = 25, 203 GFLOP where the taps are 6.2), after a copy of the whole
// block into [history | x] and of its sub-block windows.  Its plain
// PyTorch version is that dense product, Resampler.apply_block on a CPU
// tensor in beatrice_vst_tpu_torch/ops/resample.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): each input sample is
// read once and each output written once.  At B = 4,096 and T = 25 the two
// edges read 12,000 + 6,000 samples a stream and write 4,000 + 12,000,
// with 96 + 32 of history read and written: 137 KB a stream, 0.56 GB,
// 0.17 ms; their taps are 3.2 G multiply-adds, 0.10 ms at f32 peak.
// Bound by bytes.
//
// Design.  A block of kThreads threads takes `tile` consecutive outputs of
// one stream (kThreads x kReps, each thread kReps outputs kThreads apart,
// their sums interleaved), so the grid is batch x ceil(out_block / tile)
// blocks and every sample is loaded by one block (plus a window's overlap
// of K samples).  The block stages in shared memory the inputs its outputs
// read (`window` samples from full[floor(n0*M/L)], read from history and
// x where they lie: no concatenated copy) and the table's rows its outputs
// use (`rows` = min(L, tile) rows, row i holding the phase of output
// n0 + i; output n0 + i uses row i % rows, as phases repeat every L
// outputs).  Loads and stores are coalesced scalars; with L = 1 the taps
// are one row, read as a broadcast.  The blocks of tile 0 also write the
// stream's new history.  The wrapper (ops/resample.py, _plan) chooses
// kReps and checks the shared memory; the launch allocates nothing and
// does not synchronise, so a CUDA graph can capture it.

#include <cuda_runtime.h>

// The launch's arguments (ctypes mirror: ops/resample.py _Args); outside
// the anonymous namespace, as the extern "C" launcher takes it.
struct PolyphaseArgs {
  const float* x;        // [batch, in_block]
  const float* history;  // [batch, K - 1]
  const float* table;    // [L, K]
  float* y;              // [batch, out_block]
  float* new_history;    // [batch, K - 1]
  int batch, L, M, K, in_block, out_block, tile, window, rows;
};

namespace {

constexpr int kThreads = 128;
// the most dynamic shared memory a block may ask for on an H100 (227 KB)
constexpr int kMaxSmemBytes = 232448;

template <int kReps>
__global__ void __launch_bounds__(kThreads)
    polyphase_resample_kernel(const PolyphaseArgs a) {
  extern __shared__ float smem[];
  float* w = smem;                 // [rows, K]
  float* win = smem + a.rows * a.K;  // [window]
  const int tiles = (a.out_block + a.tile - 1) / a.tile;
  const long long stream = blockIdx.x / tiles;
  const int t = blockIdx.x - static_cast<int>(stream) * tiles;
  const long long n0 = static_cast<long long>(t) * a.tile;
  const long long w0 = n0 * a.M / a.L;
  const int hist = a.K - 1;
  const long long total = hist + static_cast<long long>(a.in_block);
  const float* h = a.history + stream * hist;
  const float* x = a.x + stream * a.in_block;

  for (int i = threadIdx.x; i < a.rows * a.K; i += kThreads) {
    const int r = i / a.K;
    const int phase = static_cast<int>(((n0 + r) * a.M) % a.L);
    w[i] = a.table[phase * a.K + (i - r * a.K)];
  }
  for (int i = threadIdx.x; i < a.window; i += kThreads) {
    const long long j = w0 + i;
    win[i] = j < hist ? h[j] : (j < total ? x[j - hist] : 0.0f);
  }
  if (t == 0) {
    float* nh = a.new_history + stream * hist;
    for (int i = threadIdx.x; i < hist; i += kThreads) {
      const long long j = static_cast<long long>(a.in_block) + i;
      nh[i] = j < hist ? h[j] : x[j - hist];
    }
  }
  __syncthreads();

  const float* wr[kReps];
  const float* xr[kReps];
  float acc[kReps];
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    // an output past the stream's last reads the last one's taps and is
    // not stored
    const long long want = n0 + threadIdx.x + r * kThreads;
    const long long n = want < a.out_block ? want : a.out_block - 1;
    const int li = static_cast<int>(n - n0);
    wr[r] = w + (li % a.rows) * a.K;
    xr[r] = win + (n * a.M / a.L - w0) + hist;
    acc[r] = 0.0f;
  }
  for (int k = 0; k < a.K; ++k) {
#pragma unroll
    for (int r = 0; r < kReps; ++r) acc[r] = fmaf(wr[r][k], xr[r][-k], acc[r]);
  }
  float* y = a.y + stream * a.out_block;
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    const long long n = n0 + threadIdx.x + r * kThreads;
    if (n < a.out_block) y[n] = acc[r];
  }
}

int smem_bytes(const PolyphaseArgs& a) {
  return static_cast<int>(sizeof(float)) * (a.rows * a.K + a.window);
}

// Allows each form its dynamic shared memory on the current device (once
// per device and form).
template <int kReps>
cudaError_t configure() {
  static int done[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(polyphase_resample_kernel<kReps>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = 1;
  return err;
}

template <int kReps>
int launch(const PolyphaseArgs& a, cudaStream_t stream) {
  const cudaError_t err = configure<kReps>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.batch) * ((a.out_block + a.tile - 1) / a.tile);
  polyphase_resample_kernel<kReps>
      <<<static_cast<unsigned>(blocks), kThreads, smem_bytes(a), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the resampler for `args->batch` streams on `stream`: tile =
// 128 x reps outputs a block, reps 1, 2 or 4.  Return cudaGetLastError()
// (0 = launched); cudaErrorInvalidValue (1) for a shape the kernel does
// not take, without launching.
extern "C" int polyphase_resample_launch(const PolyphaseArgs* args, int reps, void* stream) {
  const PolyphaseArgs& a = *args;
  if (a.batch <= 0 || a.out_block <= 0) return 0;
  if (a.L <= 0 || a.M <= 0 || a.K <= 0 || a.tile != kThreads * reps || a.rows <= 0 ||
      a.rows > a.L || a.window <= 0 || smem_bytes(a) > kMaxSmemBytes ||
      static_cast<long long>(a.batch) * ((a.out_block + a.tile - 1) / a.tile) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (reps) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
