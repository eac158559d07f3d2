// Version 1 of csrc/fused_upsampler.cu, kept as the baseline it is timed
// against: chip_smoke.py builds both and times them on the same inputs in
// every run (same arguments and launcher).  The port launches version 2
// only.
//
// Fused vocoder upsampler head, one 10 ms frame (T = 1) per stream, f32.
//
// Replaces the TPU kernel beatrice_vst_tpu/models/pallas_upsampler.py:203
// fused_upsample (pl.pallas_call at :260, with _kernel :115, _stage :83 and
// _snake :67).  Its plain PyTorch version is fused_upsample_reference in
// beatrice_vst_tpu_torch/models/fused_upsampler.py.
//
// Per stream: four depth-to-time stages (rate r, channels C_in -> C_out):
//   (4, 256 -> 128), (5, 128 -> 64), (4, 64 -> 32), (3, 32 -> 16).
// Stage input seq = [2 carried rows | T_in new rows] x C_in.  A k=3 causal
// conv gives T_in rows x (r * C_out) columns; conv column rho*C_out + c of
// row t is output row t*r + rho, channel c (depth-to-time as index
// arithmetic).  Each output adds src_feats[row] @ src_w + src_b (9 source
// features) and goes through the polynomial snake.  A final k=3 conv to one
// channel and tanh give 240 samples, written in time order.  The new carry
// of each conv is the last two rows of its input seq.
//
// Bound on an H100 SXM (67 TFLOP/s f32 on CUDA cores, 3.35 TB/s):
//   operations: 1,830,144 multiply-adds = 3.66 MFLOP per stream, 0.94 GFLOP
//     at B = 256 -> 14 us;
//   bytes: 22.3 KB per stream (h, carries in and out, source features,
//     audio) plus 2.2 MB of weights -> 7.9 MB at B = 256 -> 2.4 us.
// So it is bound by operations on the f32 CUDA cores.
//
// Design (first version, simple and right): one thread block per stream.
// All inter-stage activations stay in shared memory (9,440 floats =
// 37.8 KB: [3x256], [6x128], [22x64], [82x32], [242x16] including the
// carried rows), so nothing between the input carries and the audio goes
// to device memory.  Weights are read through L2 (__ldg): 2.2 MB per
// stream, the same for every block.  Threads own (conv column, group of
// ROWS output rows): neighbouring threads read neighbouring weight columns
// (coalesced) and the same activation (shared-memory broadcast), and each
// weight load is reused for ROWS rows.  No wgmma or TMA yet: the weight
// traffic through L2 (256 x 2.2 MB at B = 256) is the likely limit of this
// design, and sharing weights across several streams per block is the
// next step.

#include <cuda_runtime.h>
#include <math.h>

struct FusedUpsamplerArgs {
  const float* h;             // [B, 1, 256]
  const float* state[5];      // [B,2,256] [B,2,128] [B,2,64] [B,2,32] [B,2,16]
  const float* src[4];        // [B,4,9] [B,20,9] [B,80,9] [B,240,9]
  const float* conv_w[4];     // [3,256,512] [3,128,320] [3,64,128] [3,32,48]
  const float* conv_b[4];     // [512] [320] [128] [48]
  const float* src_w[4];      // [9, C_out]
  const float* src_b[4];      // [C_out]
  const float* log_alpha[4];  // [C_out]
  const float* final_w;       // [3, 16, 1]
  const float* final_b;       // [1]
  float* audio;               // [B, 240]
  float* new_state[5];        // shapes of state
};

namespace {

constexpr int kThreads = 256;
constexpr int kSrc = 9;
constexpr int kOut = 240;

// layers.snake: y + 16 / (a + 1e-9) * (u (1 - u))^2, u = frac(y a / pi).
__device__ __forceinline__ float snake(float y, float a) {
  const float t = y * (a / 3.14159265358979323846f);
  const float u = t - floorf(t);
  const float q = u * (1.0f - u);
  return y + (16.0f / (a + 1e-9f)) * (q * q);
}

// One stage: seq is [(T_IN + 2) x CIN] in shared memory, out receives
// [T_IN * RATE x COUT] (the next stage's rows after its 2 carried rows).
template <int CIN, int RATE, int COUT, int T_IN, int ROWS>
__device__ __forceinline__ void upsample_stage(
    const float* seq, float* out, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ src,
    const float* __restrict__ sw, const float* __restrict__ sb,
    const float* __restrict__ log_alpha) {
  constexpr int N = RATE * COUT;
  static_assert(T_IN % ROWS == 0, "ROWS must divide T_IN");
  constexpr int kItems = N * (T_IN / ROWS);
  for (int item = threadIdx.x; item < kItems; item += blockDim.x) {
    const int n = item % N;
    const int t0 = (item / N) * ROWS;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* wj = w + (size_t)j * CIN * N + n;
      const float* sj = seq + (t0 + j) * CIN;
#pragma unroll 4
      for (int ci = 0; ci < CIN; ++ci) {
        const float wv = __ldg(wj + (size_t)ci * N);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sj[r * CIN + ci], wv, acc[r]);
      }
    }
    const int rho = n / COUT;
    const int c = n - rho * COUT;
    const float a = expf(__ldg(log_alpha + c));
    const float b = __ldg(bias + n);
    const float sbc = __ldg(sb + c);
    float swc[kSrc];
#pragma unroll
    for (int k = 0; k < kSrc; ++k) swc[k] = __ldg(sw + k * COUT + c);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = (t0 + r) * RATE + rho;
      const float* s = src + row * kSrc;
      float proj = 0.0f;
#pragma unroll
      for (int k = 0; k < kSrc; ++k) proj = fmaf(__ldg(s + k), swc[k], proj);
      out[row * COUT + c] = snake((acc[r] + b) + (proj + sbc), a);
    }
  }
}

__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
fused_upsampler_kernel(const FusedUpsamplerArgs p) {
  __shared__ float seq1[3 * 256];
  __shared__ float seq2[6 * 128];
  __shared__ float seq3[22 * 64];
  __shared__ float seq4[82 * 32];
  __shared__ float seqf[242 * 16];
  const size_t b = blockIdx.x;

  copy_rows(seq1, p.state[0] + b * 2 * 256, 2 * 256);
  copy_rows(seq1 + 2 * 256, p.h + b * 256, 256);
  copy_rows(seq2, p.state[1] + b * 2 * 128, 2 * 128);
  copy_rows(seq3, p.state[2] + b * 2 * 64, 2 * 64);
  copy_rows(seq4, p.state[3] + b * 2 * 32, 2 * 32);
  copy_rows(seqf, p.state[4] + b * 2 * 16, 2 * 16);
  __syncthreads();
  copy_rows(p.new_state[0] + b * 2 * 256, seq1 + 256, 2 * 256);

  upsample_stage<256, 4, 128, 1, 1>(seq1, seq2 + 2 * 128, p.conv_w[0], p.conv_b[0],
                                    p.src[0] + b * 4 * kSrc, p.src_w[0], p.src_b[0],
                                    p.log_alpha[0]);
  __syncthreads();
  copy_rows(p.new_state[1] + b * 2 * 128, seq2 + 4 * 128, 2 * 128);

  upsample_stage<128, 5, 64, 4, 4>(seq2, seq3 + 2 * 64, p.conv_w[1], p.conv_b[1],
                                   p.src[1] + b * 20 * kSrc, p.src_w[1], p.src_b[1],
                                   p.log_alpha[1]);
  __syncthreads();
  copy_rows(p.new_state[2] + b * 2 * 64, seq3 + 20 * 64, 2 * 64);

  upsample_stage<64, 4, 32, 20, 5>(seq3, seq4 + 2 * 32, p.conv_w[2], p.conv_b[2],
                                   p.src[2] + b * 80 * kSrc, p.src_w[2], p.src_b[2],
                                   p.log_alpha[2]);
  __syncthreads();
  copy_rows(p.new_state[3] + b * 2 * 32, seq4 + 80 * 32, 2 * 32);

  upsample_stage<32, 3, 16, 80, 16>(seq4, seqf + 2 * 16, p.conv_w[3], p.conv_b[3],
                                    p.src[3] + b * kOut * kSrc, p.src_w[3], p.src_b[3],
                                    p.log_alpha[3]);
  __syncthreads();
  copy_rows(p.new_state[4] + b * 2 * 16, seqf + kOut * 16, 2 * 16);

  // final k=3 conv, 16 -> 1 channel, then tanh; output u reads seq rows u..u+2
  const float fb = __ldg(p.final_b);
  for (int u = threadIdx.x; u < kOut; u += blockDim.x) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int ci = 0; ci < 16; ++ci)
        acc = fmaf(seqf[(u + j) * 16 + ci], __ldg(p.final_w + j * 16 + ci), acc);
    }
    p.audio[b * kOut + u] = tanhf(acc + fb);
  }
}

}  // namespace

// Launches the kernel for `batch` streams on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int fused_upsampler_launch(const FusedUpsamplerArgs* args, int batch,
                                      void* stream) {
  if (batch <= 0) return 0;
  fused_upsampler_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
