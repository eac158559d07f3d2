// Fused vocoder upsampler head, one 10 ms frame (T = 1) per stream, in two
// forms: f32, and bf16 storage with f32 arithmetic.
// Version 2: tiles of 16 streams over thread-block clusters of 8 CTAs.
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
//     at B = 256 -> 14.0 us;
//   bytes: 22.3 KB per stream (h, carries in and out, source features,
//     audio) plus 2.2 MB of weights -> 7.9 MB at B = 256 -> 2.4 us.
// So it is bound by operations on the f32 CUDA cores.
//
// The bf16 form (fused_upsampler_bf16_launch) computes what the TPU kernel
// computes with compute_dtype = bfloat16: frame features, carries and the
// conv, source and final-conv weights are read as bf16; source features,
// biases and snake alphas as f32.  Each value is converted to f32 and the
// products are f32 FFMA: a product of two bf16 values is exact in f32, so
// this equals a bf16 tensor-core product with f32 accumulation up to the
// order of the sums.  Source features are rounded to bf16 where they are
// read, and every stage's output is rounded to bf16 where it is stored for
// the next stage (and for the carries); audio is tanh in f32.  Its bound:
// the same operations over 989 TFLOP/s of dense bf16 tensor-core peak,
// 0.95 us at B = 256, and 5.66 MB moved at B = 256 (17.8 KB per stream:
// bf16 frame features and carries, f32 source features and audio; 1.1 MB
// of bf16 weights and f32 biases), 1.69 us: bound by bytes.  Shared memory keeps f32 (bf16-valued) activations, so
// the tiling is the f32 form's; the weights' L2 traffic halves.
//
// Design.  Version 1 ran one block per stream: every block read all 2.2 MB
// of weights through L2 (560 MB of L2 traffic per call at B = 256) and
// stage 1 was a GEMV.  Here a cluster of 8 CTAs takes a tile of 16 streams
// (ceil(B / 16) clusters; streams past B read as zeros and are not stored):
//  * Stages 1 and 2 (2.06 MB of weights, 48 % of the multiply-adds) are
//    split by output columns across the cluster: each CTA computes
//    [16 streams x rows, 3 C_in] . [3 C_in, N / 8] (64 of 512 columns, then
//    40 of 320), so the cluster reads each weight once and it serves all 16
//    streams: about 33 MB of L2 weight traffic per call at B = 256.  The
//    outputs go through distributed shared memory to the CTAs that need
//    them (all eight for stage 1's, the stream's owner for stage 2's);
//    cluster.sync() orders the exchange.
//  * Stages 3, 4 and the final conv (116 KB of weights, 48 % of the
//    multiply-adds, 20 to 240 rows a stream) are split by stream: each CTA
//    owns 2 streams and reads the stage's weights for both (116 KB a CTA;
//    its warps share them through L1).
//  * f32 FFMA with register tiles: a thread owns (streams x rows x 1-4
//    columns) outputs over a slice of the input channels; per channel it
//    loads the activation rows its three taps read once (shared memory,
//    [channel][row][stream], so a stream group is one vector load) and one
//    weight vector per tap, loaded a channel ahead (__ldg), so a weight
//    load serves NS * TM rows.  Split-K partial sums go to shared memory
//    and the epilogue adds them in a fixed order, with bias, the source
//    projection (its features copied in with cp.async while the conv runs)
//    and the snake: no atomics, so two launches on the same inputs are
//    bitwise equal.
//  * 115,584 bytes of dynamic shared memory and at most 128 registers, so
//    two CTAs fit on one SM.  With one CTA per SM the card's GPCs hold 15
//    clusters of 8 at once, and B = 256 needs 16; with two, the 16th
//    cluster shares 8 SMs with another instead of waiting for a second wave.
// Not used: wgmma (its 64-row tiles want 64 streams a tile, 4 tiles at
// B = 256, which leaves most SMs idle: the route for bf16 and for larger
// batches) and TMA (the weight slices are read once each, by __ldg).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// T: the storage type of frame features, carries and matmul weights
// (float or bf16); the rest is f32 in both forms.
template <typename T>
struct FusedUpsamplerArgs {
  const T* h;                 // [B, 1, 256]
  const T* state[5];          // [B,2,256] [B,2,128] [B,2,64] [B,2,32] [B,2,16]
  const float* src[4];        // [B,4,9] [B,20,9] [B,80,9] [B,240,9]
  const T* conv_w[4];         // [3,256,512] [3,128,320] [3,64,128] [3,32,48]
  const float* conv_b[4];     // [512] [320] [128] [48]
  const T* src_w[4];          // [9, C_out]
  const float* src_b[4];      // [C_out]
  const float* log_alpha[4];  // [C_out]
  const T* final_w;           // [3, 16, 1]
  const float* final_b;       // [1]
  float* audio;               // [B, 240]
  T* new_state[5];            // shapes of state
};

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;
constexpr int kTile = 16;               // streams per cluster
constexpr int kOwn = kTile / kCluster;  // streams per CTA in stages 3, 4 and final
constexpr int kSrc = 9;
constexpr int kOut = 240;

// Shared memory, in floats.  Region [0, kR) is reused from stage to stage:
//   stage 1: A1 [256 ch][3 rows][16 streams] at 0, A2 at kA2;
//            partial sums over A1 once it is read
//   stage 2: A2 [128 ch][6 rows][16 streams] at kA2; partial sums at 0
//   stages 3, 4: partial sums at 0, seq4 [32][83][2] at kSeq4,
//            seqf [16][243][2] at kSeqF (one spare row a channel, so that
//            the epilogue's stores, one column a lane, spread over banks)
// seq3 [64 ch][22 rows][2 streams] has its own region: the cluster's CTAs
// push stage 2's outputs into it while this CTA still works in [0, kR).
// Partial sums are [k group][row m][column n], rows padded to NLOC + 1
// floats so that the epilogue's reads across rows do not share banks.
constexpr int kA1 = 0;
constexpr int kA2 = 256 * 3 * kTile;       // 12,288
constexpr int kR = kA2 + 128 * 6 * kTile;  // 24,576
// partial sums of each stage: k groups x rows x (columns + 1)
constexpr int kPart1 = 8 * 16 * 65, kPart2 = 3 * 64 * 41, kPart3 = 2 * 40 * 129,
              kPart4 = 1 * 160 * 49;
constexpr int kSeq4 = (kPart3 + 15) / 16 * 16;
constexpr int kSeqF = kSeq4 + 32 * 83 * kOwn;
constexpr int kSeq3 = kR;
// Each stage's source features [streams][rows][9], copied in (cp.async)
// while its conv runs: stage 1 and 3 behind seq3, stage 2 behind stage 2's
// partial sums, stage 4 over seq3 once stage 3 has read it.
constexpr int kSrc1 = kSeq3 + 64 * 22 * kOwn;  // 27,392
constexpr int kSrc2 = kPart2;
constexpr int kSrc3 = kSrc1;
constexpr int kSrc4 = kSeq3;
constexpr int kSmemFloats = kSrc4 + kOwn * kOut * kSrc;
constexpr int kSmemBytes = int(sizeof(float)) * kSmemFloats;  // 115,584
static_assert(kSeqF + 16 * 243 * kOwn <= kR, "stages 3-4 overflow the shared region");
static_assert(kSrc2 + kTile * 20 * kSrc <= kA2 && kSrc3 + kOwn * 80 * kSrc <= kSmemFloats &&
              kSrc1 + kTile * 4 * kSrc <= kSmemFloats, "source features overflow");
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two CTAs must fit on one SM");
static_assert(kPart1 <= kA2 && kPart2 <= kA2, "stage 1-2 partials overlap A2");
static_assert(kPart4 <= kSeq4, "stage 4 partials overlap seq4");

// layers.snake: y + 16 / (a + 1e-9) * (u (1 - u))^2, u = frac(y a / pi),
// with a_pi = a / pi and k16 = 16 / (a + 1e-9), the channel's constants
// (snake_constants).
__device__ __forceinline__ void snake_constants(float log_alpha, float& a_pi, float& k16) {
  const float a = expf(log_alpha);
  a_pi = a / 3.14159265358979323846f;
  k16 = 16.0f / (a + 1e-9f);
}

__device__ __forceinline__ float snake(float y, float a_pi, float k16) {
  const float t = y * a_pi;
  const float u = t - floorf(t);
  const float q = u * (1.0f - u);
  return y + k16 * (q * q);
}

template <int N> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

// N floats from shared memory (p aligned to 4 N bytes).
template <int N>
__device__ __forceinline__ void lds(float* dst, const float* p) {
  const typename Vec<N>::T v = *reinterpret_cast<const typename Vec<N>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = f[i];
}

// N floats from global memory through the read-only path.
template <int N>
__device__ __forceinline__ void ldg(float* dst, const float* p) {
  const typename Vec<N>::T v = __ldg(reinterpret_cast<const typename Vec<N>::T*>(p));
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = f[i];
}

// The float of the bf16 in the low (hi = false) or high half of a word.
__device__ __forceinline__ float bf16_half(unsigned w, bool hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

// N bf16 values (p aligned to 2 N bytes) from global memory, as floats.
template <int N>
__device__ __forceinline__ void ldg(float* dst, const bf16* p) {
  if constexpr (N == 1) {
    dst[0] = bf16_half(__ldg(reinterpret_cast<const unsigned short*>(p)), false);
  } else if constexpr (N == 2) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    dst[0] = bf16_half(w, false);
    dst[1] = bf16_half(w, true);
  } else {
    static_assert(N == 4, "bf16 loads of 1, 2 or 4 values");
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    dst[0] = bf16_half(w.x, false);
    dst[1] = bf16_half(w.x, true);
    dst[2] = bf16_half(w.y, false);
    dst[3] = bf16_half(w.y, true);
  }
}

// One value from global memory, as a float.
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) {
  float v;
  ldg<1>(&v, p);
  return v;
}

// x rounded to the storage type T and back (the bf16 form's rounding of a
// value that the next stage reads as bf16); x itself for float.
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* g, float v) { *g = v; }
__device__ __forceinline__ void put(bf16* g, float v) { *g = __float2bfloat16_rn(v); }

// Rows [0, NROWS) of a [B, NROWS, C] tensor for streams b0 .. b0+NSTR-1
// into act[ch][row0 + row][stream] (ROWS rows a channel); streams past
// `batch` read as zeros.  Each thread issues all its loads before its
// stores, so their latencies overlap.
template <int C, int ROWS, int NSTR, int NROWS, typename T>
__device__ __forceinline__ void load_act(float* act, const T* __restrict__ g, int row0, int b0,
                                         int batch) {
  constexpr int kItems = NSTR * NROWS * (C / 4);
  constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  float v[kPer][4];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int s = i % NSTR;
    const int c4 = (i / NSTR) % (C / 4);
    const int row = i / (NSTR * (C / 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) v[k][e] = 0.0f;
    if ((kItems % kThreads == 0 || i < kItems) && b0 + s < batch)
      ldg<4>(v[k], g + ((size_t)(b0 + s) * NROWS + row) * C + 4 * c4);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int s = i % NSTR;
    const int c4 = (i / NSTR) % (C / 4);
    const int row = i / (NSTR * (C / 4));
    if (kItems % kThreads == 0 || i < kItems) {
#pragma unroll
      for (int e = 0; e < 4; ++e) act[((4 * c4 + e) * ROWS + row0 + row) * NSTR + s] = v[k][e];
    }
  }
}

// Starts copying n floats (a multiple of 4, 16-byte aligned) from global
// to shared memory with cp.async; cp_async_wait() waits for all copies.
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ g, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(g + 4 * i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The new carry: rows row0, row0 + 1 of act[ch][row][stream] for streams
// s0 .. s0+ns-1 (stream s is b0 + s) into g [B, 2, C]; streams past
// `batch` are skipped.
template <int C, int ROWS, int NSTR, typename T>
__device__ __forceinline__ void store_carry(T* __restrict__ g, const float* act, int row0, int s0,
                                            int ns, int b0, int batch) {
  for (int i = threadIdx.x; i < ns * 2 * C; i += kThreads) {
    const int c = i % C;
    const int row = (i / C) % 2;
    const int s = s0 + i / (2 * C);
    if (b0 + s < batch)
      put(g + ((size_t)(b0 + s) * 2 + row) * C + c, act[(c * ROWS + row0 + row) * NSTR + s]);
  }
}

// One thread's share of a stage's conv: acc[t][s][c] = sum over taps j and
// input channels ci = kg, kg + KSTEP, ... < CIN of
// act[ci][t0 + t + j][s0 + s] * w[j][ci][col + c].  Per channel the TM + 2
// activation rows are loaded once and each weight vector serves NS * TM
// rows; the next channel's weights are loaded one channel ahead.
template <int CIN, int ROWS, int NSTR, int NTOT, int NS, int TM, int TN, int KSTEP,
          typename T>
__device__ __forceinline__ void conv_acc(float (&acc)[TM][NS][TN], const float* act,
                                         const T* __restrict__ w, int kg, int s0, int t0,
                                         int col) {
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[t][s][c] = 0.0f;
  float wn[3][TN];
#pragma unroll
  for (int j = 0; j < 3; ++j) ldg<TN>(wn[j], w + ((size_t)j * CIN + kg) * NTOT + col);
  for (int ci = kg; ci < CIN; ci += KSTEP) {
    float wv[3][TN];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int c = 0; c < TN; ++c) wv[j][c] = wn[j][c];
    if (ci + KSTEP < CIN) {
#pragma unroll
      for (int j = 0; j < 3; ++j) ldg<TN>(wn[j], w + ((size_t)j * CIN + ci + KSTEP) * NTOT + col);
    }
    const float* a = act + (ci * ROWS + t0) * NSTR + s0;
    float x[TM + 2][NS];
#pragma unroll
    for (int r = 0; r < TM + 2; ++r) {
      if constexpr (NS % 4 == 0) {
#pragma unroll
        for (int s = 0; s < NS; s += 4) lds<4>(&x[r][s], a + r * NSTR + s);
      } else {
        lds<NS>(x[r], a + r * NSTR);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int t = 0; t < TM; ++t)
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[t][s][c] = fmaf(x[t + j][s], wv[j][c], acc[t][s][c]);
  }
}

// acc into the partial sums part[kg][m][n], m = stream * T_IN + row,
// n = local column; rows are NLOC + 1 floats.
template <int MTOT, int NLOC, int T_IN, int NS, int TM, int TN>
__device__ __forceinline__ void store_partial(float* part, const float (&acc)[TM][NS][TN], int kg,
                                              int s0, int t0, int n0) {
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        part[(kg * MTOT + (s0 + s) * T_IN + t0 + t) * (NLOC + 1) + n0 + c] = acc[t][s][c];
}

// A stage's outputs: the KG partial sums added in order, plus conv bias and
// the source projection src[s][row] @ sw + sb (src: the source features of
// streams b0, b0 + 1, ... staged in shared memory), through the snake; handed to
// store(s, row, c, value) with s the stream within [b0, b0 + MTOT / T_IN),
// row = t * RATE + rho the output row and c the channel.  Neighbouring
// threads take neighbouring rows m, so that stores into [channel][row]
// [stream] buffers spread over banks.  T is the storage type: source
// features and outputs are rounded to it.
template <int KG, int MTOT, int NLOC, int T_IN, int RATE, int COUT, int UNROLL, typename T,
          typename Store>
__device__ __forceinline__ void epilogue(const float* part, int col_base,
                                         const float* __restrict__ bias, const float* src,
                                         const T* __restrict__ sw,
                                         const float* __restrict__ sb,
                                         const float* __restrict__ log_alpha, int b0, int batch,
                                         Store store) {
  constexpr int kPer = MTOT * NLOC / kThreads;
  static_assert(kPer * kThreads == MTOT * NLOC && kPer % UNROLL == 0, "uneven epilogue");
  // UNROLL outputs are computed before any is stored, so that their loads
  // and arithmetic overlap (a store could alias a later load otherwise)
  for (int k0 = 0; k0 < kPer; k0 += UNROLL) {
    float v[UNROLL];
    int where[UNROLL][3];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int o = threadIdx.x + (k0 + u) * kThreads;
      const int m = o % MTOT;
      const int n = o / MTOT;
      float y = part[m * (NLOC + 1) + n];
#pragma unroll
      for (int k = 1; k < KG; ++k) y += part[(k * MTOT + m) * (NLOC + 1) + n];
      const int s = m / T_IN;
      const int t = m - s * T_IN;
      const int ng = col_base + n;
      const int rho = ng / COUT;
      const int c = ng - rho * COUT;
      const int row = t * RATE + rho;
      float proj = 0.0f;
      if (b0 + s < batch) {
        const float* f = src + (s * T_IN * RATE + row) * kSrc;
#pragma unroll
        for (int k = 0; k < kSrc; ++k) proj = fmaf(rnd<T>(f[k]), ld1(sw + k * COUT + c), proj);
      }
      float a_pi, k16;
      snake_constants(__ldg(log_alpha + c), a_pi, k16);
      v[u] = rnd<T>(snake((y + __ldg(bias + ng)) + (proj + __ldg(sb + c)), a_pi, k16));
      where[u][0] = s;
      where[u][1] = row;
      where[u][2] = c;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) store(where[u][0], where[u][1], where[u][2], v[u]);
  }
}

// The same outputs as epilogue() (col_base 0), but each thread keeps one
// column and walks rows, so the column's constants (9 source weights,
// bias, snake constants) are loaded once: for the stages with many rows.
// Threads past the last whole group of columns take no outputs.
template <int KG, int MTOT, int NLOC, int T_IN, int RATE, int COUT, int UNROLL, typename T,
          typename Store>
__device__ __forceinline__ void epilogue_by_column(const float* part,
                                                   const float* __restrict__ bias,
                                                   const float* src,
                                                   const T* __restrict__ sw,
                                                   const float* __restrict__ sb,
                                                   const float* __restrict__ log_alpha, int b0,
                                                   int batch, Store store) {
  constexpr int kGroups = kThreads / NLOC;  // threads per column
  constexpr int kRows = (MTOT + kGroups - 1) / kGroups;
  const int n = threadIdx.x % NLOC;
  const int g = threadIdx.x / NLOC;
  if (g >= kGroups) return;
  const int rho = n / COUT;
  const int c = n - rho * COUT;
  float swc[kSrc];
#pragma unroll
  for (int k = 0; k < kSrc; ++k) swc[k] = ld1(sw + k * COUT + c);
  const float bn = __ldg(bias + n), sbc = __ldg(sb + c);
  float a_pi, k16;
  snake_constants(__ldg(log_alpha + c), a_pi, k16);
  for (int r0 = 0; r0 < kRows; r0 += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = g + (r0 + u) * kGroups;
      if (r0 + u < kRows && m < MTOT) {
        float y = part[m * (NLOC + 1) + n];
#pragma unroll
        for (int k = 1; k < KG; ++k) y += part[(k * MTOT + m) * (NLOC + 1) + n];
        const int s = m / T_IN;
        const int row = (m - s * T_IN) * RATE + rho;
        float proj = 0.0f;
        if (b0 + s < batch) {
          const float* f = src + (s * T_IN * RATE + row) * kSrc;
#pragma unroll
          for (int k = 0; k < kSrc; ++k) proj = fmaf(rnd<T>(f[k]), swc[k], proj);
        }
        v[u] = rnd<T>(snake((y + bn) + (proj + sbc), a_pi, k16));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = g + (r0 + u) * kGroups;
      if (r0 + u < kRows && m < MTOT) {
        const int s = m / T_IN;
        store(s, (m - s * T_IN) * RATE + rho, c, v[u]);
      }
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
fused_upsampler_kernel(const FusedUpsamplerArgs<T> p, int batch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* const part = smem;
  float* const a1 = smem + kA1;
  float* const a2 = smem + kA2;
  float* const seq3 = smem + kSeq3;
  float* const seq4 = smem + kSeq4;
  float* const seqf = smem + kSeqF;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int tile0 = (blockIdx.x / kCluster) * kTile;  // first stream of the tile
  const int own0 = tile0 + kOwn * rank;               // first stream this CTA owns

  const int tile_n = min(kTile, batch - tile0);  // streams of the tile below batch
  copy_async(smem + kSrc1, p.src[0] + (size_t)tile0 * 4 * kSrc, tile_n * 4 * kSrc);
  load_act<256, 3, kTile, 2>(a1, p.state[0], 0, tile0, batch);
  load_act<256, 3, kTile, 1>(a1, p.h, 2, tile0, batch);
  load_act<128, 6, kTile, 2>(a2, p.state[1], 0, tile0, batch);
  load_act<64, 22, kOwn, 2>(seq3, p.state[2], 0, own0, batch);
  // a1 complete, and every CTA of the cluster has started (so its shared
  // memory may be written by the others)
  cluster.sync();
  store_carry<256, 3, kTile>(p.new_state[0], a1, 1, kOwn * rank, kOwn, tile0, batch);

  {  // stage 1: [16, 768] . [768, 64 columns of this rank]
    const int cg4 = tid % 32, kg = tid / 32;
    const int col_base = 64 * rank;
    float acc[1][16][2];
    conv_acc<256, 3, kTile, 512, 16, 1, 2, 8>(acc, a1, p.conv_w[0], kg, 0, 0, col_base + 2 * cg4);
    __syncthreads();  // the partial sums overwrite a1
    store_partial<16, 64, 1, 16, 1, 2>(part, acc, kg, 0, 0, 2 * cg4);
    cp_async_wait();
    __syncthreads();
    float* peer[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) peer[r] = cluster.map_shared_rank(a2, r);
    epilogue<8, 16, 64, 1, 4, 128, 4>(
        part, col_base, p.conv_b[0], smem + kSrc1, p.src_w[0], p.src_b[0], p.log_alpha[0], tile0,
        batch, [&](int s, int row, int c, float v) {
          const int i = (c * 6 + 2 + row) * kTile + s;
#pragma unroll
          for (int r = 0; r < kCluster; ++r) peer[r][i] = v;
        });
  }
  cluster.sync();  // a2 complete in every CTA
  store_carry<128, 6, kTile>(p.new_state[1], a2, 4, kOwn * rank, kOwn, tile0, batch);

  {  // stage 2: [16 x 4, 384] . [384, 40 columns of this rank]
    copy_async(smem + kSrc2, p.src[1] + (size_t)tile0 * 20 * kSrc, tile_n * 20 * kSrc);
    const bool active = tid < 240;
    const int cg4 = tid % 10, sg = (tid / 10) % 8, kg = tid / 80;
    const int col_base = 40 * rank;
    float acc[4][2][4];
    if (active) {
      conv_acc<128, 6, kTile, 320, 2, 4, 4, 3>(acc, a2, p.conv_w[1], kg, 2 * sg, 0,
                                                col_base + 4 * cg4);
      store_partial<64, 40, 4, 2, 4, 4>(part, acc, kg, 2 * sg, 0, 4 * cg4);
    }
    cp_async_wait();
    __syncthreads();
    epilogue<3, 64, 40, 4, 5, 64, 5>(
        part, col_base, p.conv_b[1], smem + kSrc2, p.src_w[1], p.src_b[1], p.log_alpha[1], tile0,
        batch, [&](int s, int row, int c, float v) {
          float* dst = cluster.map_shared_rank(seq3, s / kOwn);
          dst[(c * 22 + 2 + row) * kOwn + s % kOwn] = v;
        });
  }
  cluster.sync();  // seq3 complete; no shared memory of another CTA is used after this
  if (own0 >= batch) return;
  store_carry<64, 22, kOwn>(p.new_state[2], seq3, 20, 0, kOwn, own0, batch);
  const int own_n = min(kOwn, batch - own0);
  copy_async(smem + kSrc3, p.src[2] + (size_t)own0 * 80 * kSrc, own_n * 80 * kSrc);
  load_act<32, 83, kOwn, 2>(seq4, p.state[3], 0, own0, batch);
  load_act<16, 243, kOwn, 2>(seqf, p.state[4], 0, own0, batch);

  {  // stage 3: [2 x 20, 192] . [192, 128]
    const int cg4 = tid % 32, warp = tid / 32;
    const int tg = warp & 1, s = (warp >> 1) & 1, kg = warp >> 2;
    float acc[10][1][4];
    conv_acc<64, 22, kOwn, 128, 1, 10, 4, 2>(acc, seq3, p.conv_w[2], kg, s, 10 * tg, 4 * cg4);
    store_partial<40, 128, 20, 1, 10, 4>(part, acc, kg, s, 10 * tg, 4 * cg4);
    cp_async_wait();
    __syncthreads();
    epilogue_by_column<2, 40, 128, 20, 4, 32, 4>(
        part, p.conv_b[2], smem + kSrc3, p.src_w[2], p.src_b[2], p.log_alpha[2], own0, batch,
        [&](int s2, int row, int c, float v) { seq4[(c * 83 + 2 + row) * kOwn + s2] = v; });
    __syncthreads();
  }
  store_carry<32, 83, kOwn>(p.new_state[3], seq4, 80, 0, kOwn, own0, batch);

  {  // stage 4: [2 x 80, 96] . [96, 48]
    copy_async(smem + kSrc4, p.src[3] + (size_t)own0 * kOut * kSrc, own_n * kOut * kSrc);
    const bool active = tid < 240;
    const int cg4 = tid % 12, tg = (tid / 12) % 10, s = tid / 120;
    float acc[8][1][4];
    if (active) {
      conv_acc<32, 83, kOwn, 48, 1, 8, 4, 1>(acc, seq4, p.conv_w[3], 0, s, 8 * tg, 4 * cg4);
      store_partial<160, 48, 80, 1, 8, 4>(part, acc, 0, s, 8 * tg, 4 * cg4);
    }
    cp_async_wait();
    __syncthreads();
    epilogue_by_column<1, 160, 48, 80, 3, 16, 4>(
        part, p.conv_b[3], smem + kSrc4, p.src_w[3], p.src_b[3], p.log_alpha[3], own0, batch,
        [&](int s2, int row, int c, float v) { seqf[(c * 243 + 2 + row) * kOwn + s2] = v; });
    __syncthreads();
  }
  store_carry<16, 243, kOwn>(p.new_state[4], seqf, 240, 0, kOwn, own0, batch);

  // final k=3 conv, 16 -> 1 channel, then tanh; output u reads rows u..u+2
  const float fb = __ldg(p.final_b);
  for (int i = tid; i < kOwn * kOut; i += kThreads) {
    const int s = i / kOut, u = i - s * kOut;
    if (own0 + s >= batch) continue;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int ci = 0; ci < 16; ++ci)
        acc = fmaf(seqf[(ci * 243 + u + j) * kOwn + s], ld1(p.final_w + j * 16 + ci), acc);
    p.audio[(size_t)(own0 + s) * kOut + u] = tanhf(acc + fb);
  }
}

// Allows the kernel its dynamic shared memory on the current device (once
// per device and form).
template <typename T>
cudaError_t configure() {
  static int done[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_upsampler_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = 1;
  return err;
}

template <typename T>
int launch(const FusedUpsamplerArgs<T>* args, int batch, void* stream) {
  if (batch <= 0) return 0;
  const cudaError_t err = configure<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int clusters = (batch + kTile - 1) / kTile;
  fused_upsampler_kernel<T><<<clusters * kCluster, kThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(*args, batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int* max_active_clusters, int* smem_bytes) {
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  err = cudaOccupancyMaxActiveClusters(max_active_clusters, fused_upsampler_kernel<T>, &cfg);
  *smem_bytes = kSmemBytes;
  return static_cast<int>(err);
}

}  // namespace

// Launch the f32 or the bf16 form for `batch` streams on `stream`:
// ceil(batch / 16) clusters of 8 blocks.  Return cudaGetLastError()
// (0 = launched).
extern "C" int fused_upsampler_launch(const FusedUpsamplerArgs<float>* args, int batch,
                                      void* stream) {
  return launch(args, batch, stream);
}

extern "C" int fused_upsampler_bf16_launch(const FusedUpsamplerArgs<bf16>* args, int batch,
                                           void* stream) {
  return launch(args, batch, stream);
}

// How many of the form's clusters the current device holds at once, and
// its dynamic shared memory per block; return a CUDA error code.
extern "C" int fused_upsampler_occupancy(int* max_active_clusters, int* smem_bytes) {
  return occupancy<float>(max_active_clusters, smem_bytes);
}

extern "C" int fused_upsampler_bf16_occupancy(int* max_active_clusters, int* smem_bytes) {
  return occupancy<bf16>(max_active_clusters, smem_bytes);
}
