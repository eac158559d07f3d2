// Fused vocoder upsampler head, a chunk of T 10 ms frames per stream, bf16
// form on the tensor cores: mma.sync from shared memory, bf16 activations,
// weights staged by asynchronous copies.  Two entry points share one body:
// fused_upsampler_bf16_launch (T = 1, one frame a launch) and
// fused_upsampler_bf16_chunk_launch (any T, the chunk path).
//
// Replaces the TPU kernel beatrice_vst_tpu/models/pallas_upsampler.py:203
// fused_upsample (pl.pallas_call at :260, with _kernel :115, _stage :83 and
// _snake :67) at compute_dtype = bfloat16.  Its plain PyTorch version is
// fused_upsample_reference in beatrice_vst_tpu_torch/models/fused_upsampler.py
// on bf16 arguments.  The f32 form, and the bf16 form that does the same
// arithmetic as f32 FFMA (kept as the yardstick this one is timed against),
// are in fused_upsampler.cu.
//
// Per stream: four depth-to-time stages (rate r, channels C_in -> C_out):
//   (4, 256 -> 128), (5, 128 -> 64), (4, 64 -> 32), (3, 32 -> 16).
// Stage input seq = [2 carried rows | T_in new rows] x C_in.  A k=3 causal
// conv gives T_in rows x (r * C_out) columns; conv column rho*C_out + c of
// row t is output row t*r + rho, channel c.  Each output adds
// src_feats[row] @ src_w + src_b (9 source features) and goes through the
// polynomial snake.  A final k=3 conv to one channel and tanh give 240
// samples.  The new carry of each conv is the last two rows of its input.
// bf16: frame features, carries and the conv, source and final-conv weights
// are bf16; source features, biases and snake alphas f32.  Source features
// are rounded to bf16 where they are read, products of two bf16 values are
// exact in f32 and summed in f32, biases and the snake are f32, and each
// stage's output is rounded to bf16 where the next stage reads it (that
// rounded value is also what the carries store); the final conv and tanh
// are f32.
//
// Bound on an H100 SXM: 1,830,144 multiply-adds per stream, 0.94 GFLOP at
// B = 256, over 989 TFLOP/s of dense bf16 tensor-core peak: 0.95 us; bytes
// 17.8 KB per stream (bf16 frame features and carries in and out, f32
// source features and audio) plus 1.1 MB of weights, 5.66 MB at B = 256,
// over 3.35 TB/s: 1.69 us.  So it is bound by bytes, and what a design has
// to cut is latency: weight fetches, stage hand-offs and epilogues.
//
// Design.  A cluster of 8 CTAs (256 threads each) takes a tile of 16
// streams; ceil(B / 16) clusters, streams past B read as zeros and are not
// stored.  Against the FFMA form (fused_upsampler.cu):
//  1. Tensor cores.  Every stage is a GEMM on mma.sync.m16n8k16 (bf16 in,
//     f32 accumulators in registers), A and B fed by ldmatrix from shared
//     memory:  stage 1 [16, 768] . [768, 512], stage 2 [64, 384] . [384,
//     320], stage 3 [20 x 2, 192] . [192, 128] per CTA, stage 4 [80 x 2, 96]
//     . [96, 48] per CTA.  The source projection is one more mma per output
//     tile, its A fragment (the 9 features, rounded to bf16, zero past 9)
//     built in registers from the f32 features, its B fragment from
//     src_w.  The epilogue (bias, snake, rounding) works on the accumulator
//     registers; only stage 1, whose K is split over warps, goes through
//     shared memory, and its partial sums are added in a fixed order.  The
//     final k=3 conv (K = 48, N = 1) and tanh are f32 FFMA.
//  2. The stage hand-offs are store addresses.  Activations are bf16 in
//     shared memory, [stream][row][channel]: the three taps of the k=3 conv
//     are three row offsets into the same tile (A's k index j*C_in + c
//     reads row t + j, channel c, which matches the weights' [3, C_in, N]
//     flattened to [3 C_in, N]), so there is no im2col copy; depth-to-time
//     is the address of row 2 + t*r + rho of the next stage's sequence.
//     Rows of 8 or more 16-byte units are XOR-swizzled by (row + T_in * s)
//     mod 8, which is (GEMM row + tap) mod 8, and shorter rows are padded to
//     an odd number of units, so ldmatrix does not bank-conflict.
//  3. Shared memory is bf16: 114,832 bytes a CTA, two CTAs an SM.  Each
//     CTA's weight slices (stage 1: 64 of 512 columns, 98 KB; stage 2: 40 of
//     320, 31 KB; stages 3-4 whole, 58 KB) stream in 12 chunks of up to
//     16 KB through a ring of 4 slots, three chunks in flight ahead of the
//     one being read: stage 2's weights land while stage 1 computes, stage
//     3's while stage 2 computes, stage 4's while stage 3 computes.  One
//     thread issues each chunk as a TMA box (cp.async.bulk.tensor, the
//     128-byte swizzle where rows are 128 bytes) completing on the slot's
//     mbarrier, so the other threads spend no instructions or registers on
//     the copies (issued by every thread as cp.async, the weight copies
//     cost more time than the GEMMs, and the registers they took made the
//     kernel spill at the 128 a thread that two CTAs an SM allow).  Source
//     features and carries come by cp.async a stage ahead, into regions the
//     previous stages no longer use.
//  4. Work split.  Stages 1 and 2 are split by output columns across the
//     cluster, so each weight is read once per tile of 16 streams; their
//     outputs go through distributed shared memory to the CTAs that need
//     them (all eight for stage 1's, the stream's owner for stage 2's),
//     ordered by cluster barriers.  Stages 3, 4 and the final conv are split
//     by stream (2 per CTA).  At two CTAs per SM the card holds 30 clusters
//     of 8 (occupancy() reports it), so B = 256 (16 clusters) runs in one
//     wave, and with the math on the tensor cores a CTA that shares its SM
//     loses little.
// Deterministic: no atomics, every sum in a fixed order, so two launches on
// the same inputs are bitwise equal.
// Not used: wgmma (64-row tiles; stage 1 has 16 rows a tile of 16 streams).
//
// T frames (the chunk entry point).  A cluster runs frames one after
// another through the same per-frame body (the same roundings and sum
// orders, so a chunk equals T chained one-frame launches bitwise), with
// the carries on chip between frames:
//  - stage 1's carry is the frame features of the two previous frames, so
//    frame t's seq1 is rows t - 2, t - 1, t of h (the carry state[0] before
//    frame 0), loaded while the previous frame's final conv runs;
//  - stage 2's carry is stage 1's output of the previous frame at rho 2
//    and 3, computed by ranks 4-7: they keep it in two registers a thread
//    and push it into every CTA's seq2 rows 0, 1 with the frame's own
//    output (the cluster barrier that orders the pushes is arrived at once
//    the CTA is done with its seq2 region's other use, seq4);
//  - the own streams' carries of stages 3, 4 and the final conv (512, 256
//    and 128 bytes a CTA) are one word a thread (threads 0-127, 128-191,
//    192-223), saved after the rows are written and put back where the
//    one-frame kernel loads them from state[].
//  Only the frame's last block writes new_state; the weights stream through
//  the ring again for every frame (from L2: 1.1 MB for the whole card), the
//  next frame's first three chunks issued as the slots free up.
//  A frame is a function of its own (chunk_frame, not inlined) that the
//  loop calls: inlined, what a frame derives was hoisted out of the loop
//  and held across frames, and spilled (460-676 bytes a thread at the 128
//  registers two CTAs an SM allow, against 68 bytes in chunk_frame).
// Frames per GEMM, Tc: 1.  A Tc-frame tile would take seq1 of 16 (Tc + 2)
// rows of 512 bytes and seq2 of 16 (4 Tc + 2) rows of 256 bytes in every
// CTA, and stage 4's input 80 Tc + 2 rows a stream: at Tc = 2, 32 KB +
// 40 KB beside the 64 KB ring, over the 113 KB a CTA has at two CTAs an SM
// (the kernel already uses all but 880 bytes of it); at one CTA an SM
// (227 KB) Tc = 4 would fit and give wgmma its 64 rows, but half the CTAs
// that hide each other's latency.  So each frame is the one-frame GEMMs,
// and a chunk spares T - 1 launches and prologues and the carries' round
// trips, and reads the chunk's inputs where they lie.  What it buys over
// T one-frame launches (on contiguous copies of each frame's inputs, the
// copies not timed; H100 SXM): B = 1, T = 256 0.240 ms against 4.70 (the
// frame blocks below); B = 256, T = 25 0.635 against 0.624; B = 4,096,
// T = 25 5.60 against 5.23, 7 % slower with the card full (not traced
// further: the per-frame hand-offs and chunk_frame's spills are there).
// Frame blocks.  ceil(B / 16) tiles fill the card only from some 480
// streams on (30 clusters at once), so the frame axis is split as well:
// the launch takes `block_frames`, and cluster (tile, k) runs frames
// [k F, k F + F) of its tile, after one warm-up frame k F - 1 whose audio
// and carries it does not store.  The warm-up frame's carries of stages 2
// to 4 and the final conv come from state[] (any finite values), which
// reach none of the rows that become carries: stage 2's output rows 10-19
// read only its input rows 2-5 (stage 1's output), stage 3's rows 48-79
// only those, stage 4's rows 150-239 only stage 3's 48-79, and each carry
// is the last two rows; its seq1 rows come from h.  So the carries
// entering frame k F are those of a run from frame 0, bit for bit.
// Bound at T frames (fused_upsampler.bound_ms(b, bfloat16, frames=T)): the
// operations and the per-stream bytes scale with T, the weights do not;
// at B = 4,096 and T = 25, 0.375 TFLOP (0.38 ms at 989 TFLOP/s) and
// 1.44 GB, 1.27 GB of them f32 source features (0.43 ms at 3.35 TB/s).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// The argument block, the same as fused_upsampler.cu's (the wrapper's _Args
// mirrors it); T is the storage type of frame features, carries and matmul
// weights.
template <typename T>
struct FusedUpsamplerArgs {
  const T* h;                 // [B, F, 256] (F frames: 1, or T at the chunk entry point)
  const T* state[5];          // [B,2,256] [B,2,128] [B,2,64] [B,2,32] [B,2,16]
  const float* src[4];        // [B,4F,9] [B,20F,9] [B,80F,9] [B,240F,9]
  const T* conv_w[4];         // [3,256,512] [3,128,320] [3,64,128] [3,32,48]
  const float* conv_b[4];     // [512] [320] [128] [48]
  const T* src_w[4];          // [9, C_out]
  const float* src_b[4];      // [C_out]
  const float* log_alpha[4];  // [C_out]
  const T* final_w;           // [3, 16, 1]
  const float* final_b;       // [1]
  float* audio;               // [B, 240F]
  T* new_state[5];            // shapes of state
};

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;
constexpr int kTile = 16;               // streams per cluster
constexpr int kOwn = kTile / kCluster;  // streams per CTA in stages 3, 4 and final
constexpr int kSrc = 9;
constexpr int kOut = 240;

// A sequence buffer [stream][row][UNITS 16-byte units] of bf16 in shared
// memory, rows PITCH units apart.  Rows of a multiple of 8 units store unit u
// of (s, row) at u ^ ((row + TIN * s) & 7): GEMM row m = TIN * s + t reads
// row t + j for tap j, so the key is (m + j) & 7 and the 8 rows of an
// ldmatrix matrix fall in 8 bank groups.  Shorter rows have an odd PITCH.
template <int ROWS, int UNITS, int PITCH, int TIN>
struct Seq {
  static constexpr bool kSwizzle = UNITS % 8 == 0;
  static_assert(kSwizzle ? PITCH == UNITS : (PITCH >= UNITS), "pitch");
  static constexpr int kStreamBytes = ROWS * PITCH * 16;
  __device__ __forceinline__ static int offset(int s, int row, int u) {  // bytes
    const int pu = kSwizzle ? (u ^ ((row + TIN * s) & 7)) : u;
    return ((s * ROWS + row) * PITCH + pu) * 16;
  }
  // byte offset of channel c (and c + 1 ...: within one unit)
  __device__ __forceinline__ static int channel(int s, int row, int c) {
    return offset(s, row, c >> 3) + (c & 7) * 2;
  }
};
using Seq1 = Seq<3, 32, 32, 1>;     // 16 streams: stage-1 carry and h, 256 channels
using Seq2 = Seq<6, 16, 16, 4>;     // 16 streams, 128 channels
using Seq3 = Seq<22, 8, 8, 20>;     // own 2 streams, 64 channels
using Seq4 = Seq<82, 4, 5, 80>;     // own 2 streams, 32 channels (odd pitch)
using SeqF = Seq<242, 2, 2, 240>;   // own 2 streams, 16 channels (read by FFMA)

// Shared memory, in bytes.  Regions by phase (A: stage 1, B: stage 2, C:
// stage 3, D: stage 4 and the final conv):
//   [0, 24576)       A: seq1; after stage 1's GEMM its split-K partial sums
//                    [4][16][72] f32.  B: src2 staging [16][20][9] f32, seq3
//                    (pushed by the cluster from the start of B on), src3
//                    staging [2][80][9] f32.  C, D: seq3, src3, src4 of the
//                    first own stream [240][9] f32 at 0.
//   [24576, 49152)   A, B: seq2 (pushed by the cluster during A's epilogue).
//                    C, D: seq4, src4 of the second own stream.
//   [49152, 114688)  the weight ring, 4 slots of 16 KB; in D, seqf in slot 0.
//   [114688, 114800) final conv weights (48 bf16) and bias (f32).
//   [114800, 114832) the ring slots' mbarriers.
constexpr int kSlot = 16384;
constexpr int kHalfSlot = kSlot / 2;
constexpr int kSeq1 = 0;
constexpr int kPart1 = 0;
constexpr int kPartPitch = 72;  // floats a row of partial sums (64 + 8: no conflicts)
constexpr int kSrc2 = 0;
constexpr int kSeq3 = kTile * 20 * kSrc * 4;            // 11,520
constexpr int kSrc3 = kSeq3 + kOwn * Seq3::kStreamBytes;  // 17,152
constexpr int kSrc4a = 0;
constexpr int kSeq2 = 24576;
constexpr int kSeq4 = kSeq2;
constexpr int kSrc4b = kSeq4 + kOwn * Seq4::kStreamBytes;  // 37,696
constexpr int kRing = 49152;
constexpr int kSeqF = kRing;
constexpr int kConst = kRing + 4 * kSlot;  // 114,688
constexpr int kBars = kConst + 112;        // 4 x 8 bytes
constexpr int kSmemBytes = kBars + 32;     // 114,832
static_assert(kTile * Seq1::kStreamBytes <= kSeq2, "seq1");
static_assert(4 * 16 * kPartPitch * 4 <= kSeq2, "partial sums");
static_assert(kSrc3 + kOwn * 80 * kSrc * 4 <= kSeq2, "stage-2 region");
static_assert(kSrc4a + kOut * kSrc * 4 <= kSeq3, "src4 overlaps seq3");
static_assert(kTile * Seq2::kStreamBytes == kRing - kSeq2, "seq2");
static_assert(kSrc4b + kOut * kSrc * 4 <= kRing, "stage-3 region");
static_assert(kOwn * SeqF::kStreamBytes <= kSlot, "seqf");
static_assert(kSeq3 % 16 == 0 && kSrc3 % 16 == 0 && kSrc4b % 16 == 0, "alignment");
static_assert(kRing % 1024 == 0 && kSlot % 1024 == 0 && kBars % 8 == 0, "TMA and mbarrier alignment");
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two CTAs must fit on one SM");

// The weight stream: chunk i (of 12) of this CTA's slices, by stage, each
// one or two TMA boxes of the weight tensor [3 C_in rows, N columns]:
//   0-5: stage 1, k rows 128 i .. +128, columns 64 rank .. +64 (128-byte
//        rows, the 16-byte unit u of row k at u ^ (k & 7): TMA's 128-byte
//        swizzle in a 1024-byte aligned slot)
//   6-7: stage 2, k rows 192 (i - 6) .. +192, columns 40 rank .. +40 (80-byte
//        rows, 5 units: an odd count needs no swizzle)
//   8-10: stage 3, k rows 64 (i - 8) .. +64 (tap i - 8), columns 0-63 and
//        64-127 in the two halves of the slot, each swizzled as stage 1's
//   11: stage 4, all 96 k rows and 48 columns (96-byte rows)
constexpr int kChunks = 12;
constexpr int kW2Pitch = 5, kW4Pitch = 6;  // units a row

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// 16 bytes, or 16 zero bytes where !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a . b on the tensor cores: [16 x 16] bf16 . [16 x 8] bf16, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ldg_bf16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// layers.snake: y + 16 / (a + 1e-9) * (u (1 - u))^2, u = frac(y a / pi),
// with a_pi = a / pi and k16 = 16 / (a + 1e-9), the channel's constants.
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

// The A fragment of the source projection for the GEMM rows of mma row g
// (features f0) and g + 8 (f1): 9 features rounded to bf16 in k columns
// 0..8 of the 16, zeros after.  t4 = lane % 4.
__device__ __forceinline__ void src_a_frag(uint32_t (&a)[4], const float* f0, const float* f1,
                                           int t4) {
  a[0] = pack2(f0[2 * t4], f0[2 * t4 + 1]);
  a[1] = pack2(f1[2 * t4], f1[2 * t4 + 1]);
  a[2] = t4 == 0 ? pack2(f0[8], 0.0f) : 0u;
  a[3] = t4 == 0 ? pack2(f1[8], 0.0f) : 0u;
}

// The B fragment of the source projection for the 8 channels c0 .. c0 + 7
// of src_w [9, cout]: lane (g, t4) holds rows 2 t4, 2 t4 + 1 (and 8 for
// t4 = 0) of channel c0 + g.
__device__ __forceinline__ void src_b_frag(uint32_t (&b)[2], const bf16* w, int cout, int c0,
                                           int g, int t4) {
  const int c = c0 + g;
  b[0] = ldg_bf16(w + 2 * t4 * cout + c) | (ldg_bf16(w + (2 * t4 + 1) * cout + c) << 16);
  b[1] = t4 == 0 ? ldg_bf16(w + 8 * cout + c) : 0u;
}

// The epilogue constants of output columns n, n + 1 (channels c, c + 1):
// conv bias plus source bias, and the snake's.  load() issues the loads
// before a stage's GEMM; ready() turns log alpha into the snake constants
// after it, once the loads have landed.
struct Cols {
  float b0, b1, la0, la1, a0, k0, a1, k1;
  __device__ __forceinline__ void load(const float* conv_b, const float* src_b,
                                       const float* log_alpha, int n, int c) {
    b0 = __ldg(conv_b + n) + __ldg(src_b + c);
    b1 = __ldg(conv_b + n + 1) + __ldg(src_b + c + 1);
    la0 = __ldg(log_alpha + c);
    la1 = __ldg(log_alpha + c + 1);
  }
  __device__ __forceinline__ void ready() {
    snake_constants(la0, a0, k0);
    snake_constants(la1, a1, k1);
  }
  // the conv and source sums of columns n, n + 1 through bias and snake,
  // rounded to bf16
  __device__ __forceinline__ uint32_t out(float y0, float y1) const {
    return pack2(snake(y0 + b0, a0, k0), snake(y1 + b1, a1, k1));
  }
};

// cp.async of rows row0, row0 + 1 of g [B, 2, C] into buffer L for streams
// s_first .. s_first + ns - 1 (stream s is b_first + s - s_first); streams
// past `batch` are zeros.
template <class L, int C>
__device__ __forceinline__ void load_carry(uint32_t buf, const bf16* __restrict__ g, int row0,
                                           int s_first, int b_first, int ns, int batch) {
  constexpr int U = C / 8;
  for (int i = threadIdx.x; i < ns * 2 * U; i += kThreads) {
    const int u = i % U, row = (i / U) & 1, s = i / (2 * U);
    const int b = b_first + s;
    const bool valid = b < batch;
    cp_async16(buf + L::offset(s_first + s, row0 + row, u),
               g + ((size_t)(valid ? b : 0) * 2 + row) * C + 8 * u, valid);
  }
}

// The new carry: rows row0, row0 + 1 of buffer L for streams s_first ..
// s_first + ns - 1 into g [B, 2, C]; streams past `batch` are skipped.
template <class L, int C>
__device__ __forceinline__ void store_carry(bf16* __restrict__ g, const unsigned char* buf,
                                            int row0, int s_first, int b_first, int ns,
                                            int batch) {
  constexpr int U = C / 8;
  for (int i = threadIdx.x; i < ns * 2 * U; i += kThreads) {
    const int u = i % U, row = (i / U) & 1, s = i / (2 * U);
    const int b = b_first + s;
    if (b < batch)
      *reinterpret_cast<uint4*>(g + ((size_t)b * 2 + row) * C + 8 * u) =
          *reinterpret_cast<const uint4*>(buf + L::offset(s_first + s, row0 + row, u));
  }
}

// cp.async of `units` 16-byte units from g to dst (both 16-byte aligned)
__device__ __forceinline__ void copy_units(uint32_t dst, const float* __restrict__ g, int units) {
  for (int i = threadIdx.x; i < units; i += kThreads) cp_async16(dst + 16 * i, g + 4 * i);
}

// cp.async of `units` 16-byte units of each of ns streams, stream s from
// g + s * stride floats, to dst + 16 * units * s (a frame's rows of
// source features [B, F * rows, 9]: one run of units a stream)
__device__ __forceinline__ void copy_streams(uint32_t dst, const float* __restrict__ g,
                                             size_t stride, int ns, int units) {
  for (int i = threadIdx.x; i < ns * units; i += kThreads) {
    const int s = i / units;
    cp_async16(dst + 16 * i, g + s * stride + 4 * (i - s * units));
  }
}

// cp.async of frame fr's seq1 for the tile's 16 streams: rows 0, 1, 2 are
// the frame features of frames fr - 2, fr - 1, fr of h [B, F, 256], frames
// -2 and -1 being the carry state[0]; streams past `batch` are zeros.
__device__ __forceinline__ void load_seq1(uint32_t buf, const FusedUpsamplerArgs<bf16>& p,
                                          int tile0, int batch, int frames, int fr) {
  for (int i = threadIdx.x; i < kTile * 3 * 32; i += kThreads) {
    const int u = i & 31, row = (i >> 5) % 3, s = i / 96;
    const int b = tile0 + s;
    const bool valid = b < batch;
    const size_t bb = valid ? b : 0;
    const int x = fr - 2 + row;
    const bf16* g = x >= 0 ? p.h + (bb * frames + x) * 256 : p.state[0] + (bb * 2 + x + 2) * 256;
    cp_async16(buf + Seq1::offset(s, row, u), g + 8 * u, valid);
  }
}

// Word w of the carry rows row0, row0 + 1 of both own streams in buffer L
// of C channels (16 C / 8 words: w = 4 unit + word, units stream-major):
// what a thread keeps of an own stream's carry between frames.
template <class L, int C>
__device__ __forceinline__ uint32_t* carry_word(unsigned char* buf, int row0, int w) {
  constexpr int U = C / 8;
  const int unit = w >> 2, u = unit % U, row = (unit / U) & 1, s = unit / (2 * U);
  return reinterpret_cast<uint32_t*>(buf + L::offset(s, row0 + row, u) + 4 * (w & 3));
}

// The tensor maps of the four conv weights, [3 C_in, N] bf16 with the box
// of a chunk (encode_maps).
struct WeightMaps {
  CUtensorMap w[4];
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at columns x, rows y of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// One thread: chunk i of the weight stream into slot i % 4, its bytes
// expected on the slot's barrier.
__device__ __forceinline__ void issue_chunk(uint32_t ring, uint32_t bars, int i,
                                            const WeightMaps& m, int rank) {
  const uint32_t dst = ring + (i & 3) * kSlot, bar = bars + 8 * (i & 3);
  if (i < 6) {
    mbar_expect_tx(bar, 128 * 64 * 2);
    tma_load(dst, &m.w[0], 64 * rank, 128 * i, bar);
  } else if (i < 8) {
    mbar_expect_tx(bar, 192 * 40 * 2);
    tma_load(dst, &m.w[1], 40 * rank, 192 * (i - 6), bar);
  } else if (i < 11) {
    mbar_expect_tx(bar, 64 * 128 * 2);
    tma_load(dst, &m.w[2], 0, 64 * (i - 8), bar);
    tma_load(dst + kHalfSlot, &m.w[2], 64, 64 * (i - 8), bar);
  } else {
    mbar_expect_tx(bar, 96 * 48 * 2);
    tma_load(dst, &m.w[3], 0, 0, bar);
  }
}

// k row of a B operand (within a k step of 16) that lane feeds to ldmatrix
// .x4.trans / .x2.trans: matrices 0 and 2 rows 0-7, matrices 1 and 3 rows 8-15
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }

// Where a frame of a tile lies: the streams in the arguments, the frames a
// stream has there, the frame, the frames the cluster ran before it, the
// tile's first stream, the first frame whose audio is stored (the ones
// before are a block's warm-up frame), whether another frame follows, and
// whether this one writes new_state.
struct FrameOf {
  int batch, frames, fr, n, tile0, f_lo;
  bool more, store_state;
};

// One frame of a tile of 16 streams: stages 1-4 and the final conv, after
// upsample_tile's prologue.  In a chunk (kChunk) prev2 and keep carry ranks
// 4-7's stage-1 output at rho 2, 3 (the next frame's stage-2 carry rows)
// and one word of an own stream's carry of stage 3 (threads 0-127), 4
// (128-191) or the final conv (192-223) to the next frame.
template <bool kChunk>
__device__ __forceinline__ void tile_frame(const FusedUpsamplerArgs<bf16>& p,
                                           const WeightMaps& maps, const FrameOf f,
                                           uint2& prev2, uint32_t& keep) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = sb + kRing, bars = sb + kBars;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment: row group, column pair
  const int batch = f.batch, F = f.frames, fr = f.fr, n = f.n, tile0 = f.tile0;
  const bool first = n == 0, more = f.more, store_state = f.store_state;
  const int own0 = tile0 + kOwn * rank;  // first stream this CTA owns
  const int tile_n = min(kTile, batch - tile0);
  const int own_n = min(kOwn, batch - own0);

  // Before reading chunk i of the frame: wait for its barrier (chunks
  // i + 1 and i + 2 may still be in flight; a slot takes 3 chunks a
  // frame, so its barrier completes phase (i / 4 + n) % 2 for chunk i),
  // and for every warp to be done with chunk i - 1, whose slot then takes
  // chunk i + 3 (or the next frame's chunk i - 9: 1 and 2 here, 0 once
  // seqf has left slot 0).  Steps 0 and 11 also wait for the cp.async
  // copies that their stage reads (seq1; seq4's carry and src4).
  auto ring_step = [&](int i, auto&& also) {
    if (i == 0 || i == 11) cp_async_wait_all();
    mbar_wait(bars + 8 * (i & 3), ((i >> 2) + n) & 1);
    __syncthreads();
    also();
    if (tid == 0) {
      if (i + 3 < kChunks)
        issue_chunk(ring, bars, i + 3, maps, rank);
      else if (kChunk && more && i + 3 > kChunks)
        issue_chunk(ring, bars, i + 3 - kChunks, maps, rank);
    }
  };

  // ---- stage 1: [16, 768] . [768, 64 columns of this rank] -------------
  // warp (kq, nh): n tiles 4 nh .. 4 nh + 3, k steps kq and kq + 4 of each
  // chunk's 8; the kq partial sums are added in order in the epilogue.
  {
    const int nh = warp & 1, kq = warp >> 1;
    const int rho = rank >> 1;            // this rank's 64 columns lie in one rho
    const int cbase = 64 * (rank & 1);    // ... at channels cbase .. cbase + 63
    // epilogue: thread -> stream tid / 16, columns 4 (tid % 16) .. + 3
    const int es = tid >> 4, en = (tid & 15) * 4;
    Cols cols[2];
    cols[0].load(p.conv_b[0], p.src_b[0], p.log_alpha[0], 64 * rank + en, cbase + en);
    cols[1].load(p.conv_b[0], p.src_b[0], p.log_alpha[0], 64 * rank + en + 2, cbase + en + 2);

    float acc[4][4] = {};
    auto chunk = [&](int i) {
      ring_step(i, [&] {
        if (i == 0 && store_state)  // seq1 has landed: the new carry is its rows 1, 2
          store_carry<Seq1, 256>(p.new_state[0], smem + kSeq1, 1, kOwn * rank, own0, kOwn,
                                 batch);
      });
      const uint32_t w = ring + (i & 3) * kSlot;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = kq + 4 * h;  // k step within the chunk
        const int k = 128 * i + 16 * ks;
        uint32_t a[4];
        ldsm_x4(a, sb + kSeq1 + Seq1::offset(lane & 15, k >> 8, ((k & 255) >> 3) + (lane >> 4)));
        const int kr = 16 * ks + b_row(lane);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t b[4];
          const int u = 4 * nh + 2 * q + (lane >> 4);
          ldsm_x4_t(b, w + (kr * 8 + (u ^ (kr & 7))) * 16);
          mma(acc[2 * q], a, b[0], b[1]);
          mma(acc[2 * q + 1], a, b[2], b[3]);
        }
      }
    };
    for (int i = 0; i < 5; ++i) chunk(i);
    // the source projection (warps kq = 0), loaded while the last chunk
    // lands and computes: features of streams g, g + 8 and src_w's columns
    float f[2][kSrc];
    uint32_t sw[4][2];
    if (kq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = tile0 + g + 8 * h;
        const float* src =
            p.src[0] + (((size_t)(b < batch ? b : 0) * F + fr) * 4 + rho) * kSrc;
#pragma unroll
        for (int k = 0; k < kSrc; ++k) f[h][k] = b < batch ? __ldg(src + k) : 0.0f;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        src_b_frag(sw[nt], p.src_w[0], 128, cbase + 32 * nh + 8 * nt, g, t4);
    }
    chunk(5);
    if (kq == 0) {
      uint32_t sa[4];
      src_a_frag(sa, f[0], f[1], t4);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma(acc[nt], sa, sw[nt][0], sw[nt][1]);
    }
    cols[0].ready();
    cols[1].ready();
    __syncthreads();  // every warp is done with seq1: the partial sums overwrite it
    float* part = reinterpret_cast<float*>(smem + kPart1);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 32 * nh + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(part + (kq * 16 + g) * kPartPitch + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(part + (kq * 16 + g + 8) * kPartPitch + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
    float4 y = *reinterpret_cast<const float4*>(part + es * kPartPitch + en);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(part + (k * 16 + es) * kPartPitch + en);
      y.x += v.x;
      y.y += v.y;
      y.z += v.z;
      y.w += v.w;
    }
    const uint2 out = make_uint2(cols[0].out(y.x, y.y), cols[1].out(y.z, y.w));
    const int off = kSeq2 + Seq2::channel(es, 2 + rho, cbase + en);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      *reinterpret_cast<uint2*>(cluster.map_shared_rank(smem, r) + off) =
          out;
    if constexpr (kChunk) {
      if (rho >= 2) {  // the previous frame's rows 4, 5 are this frame's carry rows 0, 1
        if (!first) {
          const int coff = kSeq2 + Seq2::channel(es, rho - 2, cbase + en);
#pragma unroll
          for (int r = 0; r < kCluster; ++r)
            *reinterpret_cast<uint2*>(cluster.map_shared_rank(smem, r) +
                                      coff) = prev2;
        }
        prev2 = out;
      }
    }
  }
  cluster.sync();  // seq2 complete in every CTA

  // ---- stage 2: [16 x 4, 384] . [384, 40 columns of this rank] ----------
  // warp (mt, ns): m tile mt (streams 4 mt .. 4 mt + 3), n tiles 0-2 (ns 0)
  // or 3-4 (ns 1)
  {
    const int mt = warp & 3, ns = warp >> 2;
    const int nn = ns == 0 ? 3 : 2;
    Cols cols[3];
    uint32_t sw[3][2];
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      if (nt < nn) {
        const int n0 = 40 * rank + 8 * (3 * ns + nt);  // first column of the n tile
        const int c = n0 + 2 * t4;
        cols[nt].load(p.conv_b[1], p.src_b[1], p.log_alpha[1], c, c & 63);
        src_b_frag(sw[nt], p.src_w[1], 64, n0 & 63, g, t4);
      }
    }
    float acc[3][4] = {};
    for (int i = 6; i < 8; ++i) {
      ring_step(i, [&] {
        if (i == 6) {
          if (store_state)
            store_carry<Seq2, 128>(p.new_state[1], smem + kSeq2, 4, kOwn * rank, own0, kOwn,
                                   batch);
          // for stage 2's epilogue and stage 3: source features and seq3's carry
          if constexpr (kChunk) {
            copy_streams(sb + kSrc2, p.src[1] + ((size_t)tile0 * F + fr) * 20 * kSrc,
                         (size_t)F * 20 * kSrc, tile_n, 45);
            if (first)
              load_carry<Seq3, 64>(sb + kSeq3, p.state[2], 0, 0, own0, kOwn, batch);
            else if (tid < 128)
              *carry_word<Seq3, 64>(smem + kSeq3, 0, tid) = keep;
            copy_streams(sb + kSrc3, p.src[2] + ((size_t)own0 * F + fr) * 80 * kSrc,
                         (size_t)F * 80 * kSrc, max(own_n, 0), 180);
          } else {
            copy_units(sb + kSrc2, p.src[1] + (size_t)tile0 * 20 * kSrc, max(tile_n, 0) * 45);
            load_carry<Seq3, 64>(sb + kSeq3, p.state[2], 0, 0, own0, kOwn, batch);
            copy_units(sb + kSrc3, p.src[2] + (size_t)own0 * 80 * kSrc, max(own_n, 0) * 180);
          }
          cp_async_commit();
        }
      });
      const uint32_t w = ring + (i & 3) * kSlot;
      const int m = 16 * mt + (lane & 15), s = m >> 2, t = m & 3;
#pragma unroll
      for (int ks = 0; ks < 12; ++ks) {
        const int k = 192 * (i - 6) + 16 * ks;
        uint32_t a[4];
        ldsm_x4(a, sb + kSeq2 + Seq2::offset(s, t + (k >> 7), ((k & 127) >> 3) + (lane >> 4)));
        const int kr = 16 * ks + b_row(lane);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          if (nt < nn) {
            uint32_t b[2];
            ldsm_x2_t(b, w + (kr * kW2Pitch + 3 * ns + nt) * 16);
            mma(acc[nt], a, b[0], b[1]);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
      if (nt < nn) cols[nt].ready();
    cp_async_wait_all();  // the source features and seq3's carry (step 6) have landed
    __syncthreads();
    const float* src = reinterpret_cast<const float*>(smem + kSrc2);  // [16][20][9]
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      if (nt < nn) {
        const int n0 = 40 * rank + 8 * (3 * ns + nt);
        const int rho = n0 >> 6;
        const int m0 = 16 * mt + g, m1 = m0 + 8;  // rows (s, t) = (m / 4, m % 4)
        uint32_t a[4];
        src_a_frag(a, src + ((m0 >> 2) * 20 + (m0 & 3) * 5 + rho) * kSrc,
                   src + ((m1 >> 2) * 20 + (m1 & 3) * 5 + rho) * kSrc, t4);
        mma(acc[nt], a, sw[nt][0], sw[nt][1]);
        const int c = (n0 & 63) + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mm = m0 + 8 * h, s = mm >> 2, t = mm & 3;
          const int off = kSeq3 + Seq3::channel(s & 1, 2 + 5 * t + rho, c);
          unsigned char* owner = cluster.map_shared_rank(smem, s >> 1);
          *reinterpret_cast<uint32_t*>(owner + off) =
              cols[nt].out(acc[nt][2 * h], acc[nt][2 * h + 1]);
        }
      }
    }
  }
  cluster.sync();  // seq3 complete; no CTA writes another's shared memory in this frame now
  if (own0 >= batch) {  // no stream of its own: wait for the copies in flight (stage 3's weights)
    if constexpr (kChunk) {
      for (int i = 8; i < kChunks; ++i) ring_step(i, [] {});
    } else {
      cp_async_wait_all();
#pragma unroll
      for (int i = 8; i < 11; ++i) mbar_wait(bars + 8 * (i & 3), (i >> 2) & 1);
      return;
    }
  } else {
    // ---- stage 3: [2 x 20, 192] . [192, 128] ---------------------------
    // warp w: n tiles 2 w, 2 w + 1 (channels 16 w .. + 15 of rho = w / 2),
    // all three m tiles (rows 40-47 repeat row 39 and are not stored)
    {
      const int rho = warp >> 1;
      Cols cols[2];
      uint32_t sw[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n0 = 16 * warp + 8 * q;
        cols[q].load(p.conv_b[2], p.src_b[2], p.log_alpha[2], n0 + 2 * t4, (n0 & 31) + 2 * t4);
        src_b_frag(sw[q], p.src_w[2], 32, n0 & 31, g, t4);
      }
      float acc[3][2][4] = {};
      for (int i = 8; i < 11; ++i) {
        ring_step(i, [&] {
          if (i == 8) {
            if (store_state)
              store_carry<Seq3, 64>(p.new_state[2], smem + kSeq3, 20, 0, own0, kOwn, batch);
            else if (kChunk && tid < 128)
              keep = *carry_word<Seq3, 64>(smem + kSeq3, 20, tid);
            // for stage 4: seq4's carry and the source features
            if (!kChunk || first)
              load_carry<Seq4, 32>(sb + kSeq4, p.state[3], 0, 0, own0, kOwn, batch);
            else if (tid >= 128 && tid < 192)
              *carry_word<Seq4, 32>(smem + kSeq4, 0, tid - 128) = keep;
            const float* src4 = p.src[3] + ((size_t)own0 * F + fr) * kOut * kSrc;
            copy_units(sb + kSrc4a, src4, 540);
            if (own_n > 1) copy_units(sb + kSrc4b, src4 + (size_t)F * kOut * kSrc, 540);
            cp_async_commit();
          }
        });
        const uint32_t w = ring + (i & 3) * kSlot;
        const int j = i - 8;  // the chunk is tap j
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int kr = 16 * ks + b_row(lane);
          const int u = 2 * warp + (lane >> 4);
          uint32_t b[4];
          ldsm_x4_t(b, w + (u >> 3) * kHalfSlot + (kr * 8 + ((u & 7) ^ (kr & 7))) * 16);
#pragma unroll
          for (int mt = 0; mt < 3; ++mt) {
            const int m = min(16 * mt + (lane & 15), 39), s = m / 20, t = m - 20 * s;
            uint32_t a[4];
            ldsm_x4(a, sb + kSeq3 + Seq3::offset(s, t + j, 2 * ks + (lane >> 4)));
            mma(acc[mt][0], a, b[0], b[1]);
            mma(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
      cols[0].ready();
      cols[1].ready();
      const float* src = reinterpret_cast<const float*>(smem + kSrc3);  // [2][80][9]
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
        const int m0 = min(16 * mt + g, 39), m1 = min(16 * mt + g + 8, 39);
        const int s0 = m0 / 20, s1 = m1 / 20;
        uint32_t a[4];
        src_a_frag(a, src + (s0 * 80 + (m0 - 20 * s0) * 4 + rho) * kSrc,
                   src + (s1 * 80 + (m1 - 20 * s1) * 4 + rho) * kSrc, t4);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma(acc[mt][q], a, sw[q][0], sw[q][1]);
          const int c = ((16 * warp + 8 * q) & 31) + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 16 * mt + g + 8 * h;
            if (m < 40) {
              const int s = m / 20, t = m - 20 * s;
              *reinterpret_cast<uint32_t*>(smem + kSeq4 + Seq4::channel(s, 2 + 4 * t + rho, c)) =
                  cols[q].out(acc[mt][q][2 * h], acc[mt][q][2 * h + 1]);
            }
          }
        }
      }
    }

    // ---- stage 4: [2 x 80, 96] . [96, 48] ------------------------------
    // warp w: n tiles 3 (w & 1) .. + 2, m tiles w / 2, w / 2 + 4, w / 2 + 8 (< 10)
    ring_step(11, [&] {
      if (store_state)
        store_carry<Seq4, 32>(p.new_state[3], smem + kSeq4, 80, 0, own0, kOwn, batch);
      else if (kChunk && tid >= 128 && tid < 192)
        keep = *carry_word<Seq4, 32>(smem + kSeq4, 80, tid - 128);
      if (!kChunk || first)
        load_carry<SeqF, 16>(sb + kSeqF, p.state[4], 0, 0, own0, kOwn, batch);
      else if (tid >= 192 && tid < 224)
        *carry_word<SeqF, 16>(smem + kSeqF, 0, tid - 192) = keep;
      cp_async_commit();
    });
    {
      const int nh = warp & 1, mt0 = warp >> 1;
      Cols cols[3];
      uint32_t sw[3][2];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const int n0 = 8 * (3 * nh + nt);
        cols[nt].load(p.conv_b[3], p.src_b[3], p.log_alpha[3], n0 + 2 * t4, (n0 & 15) + 2 * t4);
        src_b_frag(sw[nt], p.src_w[3], 16, n0 & 15, g, t4);
      }
      const uint32_t w = ring + (11 & 3) * kSlot;
      float acc[3][3][4] = {};
#pragma unroll
      for (int ks = 0; ks < 6; ++ks) {
        const int kr = 16 * ks + b_row(lane);
        uint32_t b[3][2];
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) ldsm_x2_t(b[nt], w + (kr * kW4Pitch + 3 * nh + nt) * 16);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          const int mt = mt0 + 4 * mi;
          if (mt < 10) {
            const int m = 16 * mt + (lane & 15), s = m / 80, t = m - 80 * s;
            uint32_t a[4];
            ldsm_x4(a, sb + kSeq4 + Seq4::offset(s, t + (ks >> 1), 2 * (ks & 1) + (lane >> 4)));
#pragma unroll
            for (int nt = 0; nt < 3; ++nt) mma(acc[mi][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) cols[nt].ready();
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {
        const int mt = mt0 + 4 * mi;
        if (mt < 10) {
          const int m0 = 16 * mt + g;
          // an m tile lies in one stream; its source features [240][9] f32
          const int s0 = m0 / 80, t0 = m0 - 80 * s0, t1 = t0 + 8;
          const float* src = reinterpret_cast<const float*>(smem + (s0 ? kSrc4b : kSrc4a));
#pragma unroll
          for (int nt = 0; nt < 3; ++nt) {
            const int n0 = 8 * (3 * nh + nt), rho = n0 >> 4;
            uint32_t a[4];
            src_a_frag(a, src + (3 * t0 + rho) * kSrc, src + (3 * t1 + rho) * kSrc, t4);
            mma(acc[mi][nt], a, sw[nt][0], sw[nt][1]);
            const int c = (n0 & 15) + 2 * t4;
            *reinterpret_cast<uint32_t*>(smem + kSeqF + SeqF::channel(s0, 2 + 3 * t0 + rho, c)) =
                cols[nt].out(acc[mi][nt][0], acc[mi][nt][1]);
            *reinterpret_cast<uint32_t*>(smem + kSeqF + SeqF::channel(s0, 2 + 3 * t1 + rho, c)) =
                cols[nt].out(acc[mi][nt][2], acc[mi][nt][3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // seqf complete, with its carry rows
    if (store_state)
      store_carry<SeqF, 16>(p.new_state[4], smem + kSeqF, 240, 0, own0, kOwn, batch);
    else if (kChunk && tid >= 192 && tid < 224)
      keep = *carry_word<SeqF, 16>(smem + kSeqF, 240, tid - 192);

    // ---- final k=3 conv, 16 -> 1 channel, and tanh: output u reads rows
    // u .. u + 2 of seqf, 48 bf16 in a row (f32 FFMA); not for the
    // warm-up frame ------------------------------------------------------
    if (fr >= f.f_lo) {
      const bf16* wf = reinterpret_cast<const bf16*>(smem + kConst);
      const float fb = *reinterpret_cast<const float*>(smem + kConst + 96);
      for (int i = tid; i < kOwn * kOut; i += kThreads) {
        const int s = i / kOut, u = i - s * kOut;
        if (own0 + s >= batch) continue;
        const unsigned char* rows = smem + kSeqF + SeqF::offset(s, u, 0);
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(rows + 16 * q);
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc = fmaf(__uint_as_float(w4[e] << 16), __bfloat162float(wf[8 * q + 2 * e]), acc);
            acc = fmaf(__uint_as_float(w4[e] & 0xffff0000u),
                       __bfloat162float(wf[8 * q + 2 * e + 1]), acc);
          }
        }
        p.audio[((size_t)(own0 + s) * F + fr) * kOut + u] = tanhf(acc + fb);
      }
    }
  }

  // ---- the next frame (kChunk): its chunk 0 into slot 0 (seqf's), the
  // cluster barrier that lets the others push into this CTA's seq2
  // region (its seq4 and src4b are read), and its seq1
  if constexpr (kChunk) {
    if (more) {
      __syncthreads();
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_chunk(ring, bars, 0, maps, rank);
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      load_seq1(sb + kSeq1, p, tile0, batch, F, fr + 1);
      cp_async_commit();
    }
  }
}

// A frame of the chunk kernel, compiled apart from its loop over frames
// (not inlined): nothing a frame derives can then be hoisted out of the
// loop and held across frames, which at the 128 registers a thread that
// two CTAs an SM allow spilled 460-676 bytes a thread.
__device__ __noinline__ void chunk_frame(const FusedUpsamplerArgs<bf16>& p,
                                         const WeightMaps& maps, const FrameOf f, uint2& prev2,
                                         uint32_t& keep) {
  tile_frame<true>(p, maps, f, prev2, keep);
}

// The head for one tile of 16 streams: frames [f_lo, f_hi) of them, after a
// warm-up frame f_lo - 1 where f_lo > 0 (kChunk), or the one frame of a
// one-frame launch (!kChunk: frames = block_frames = 1, today's launch).
template <bool kChunk>
__device__ __forceinline__ void upsample_tile(const FusedUpsamplerArgs<bf16>& p,
                                              const WeightMaps& maps, int batch, int frames,
                                              int block_frames) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sb = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = sb + kRing, bars = sb + kBars;
  const int rank = static_cast<int>(cg::this_cluster().block_rank()), tid = threadIdx.x;
  // frames a stream in the arguments, and this cluster's tile and frames
  const int F = kChunk ? frames : 1;
  const int n_blocks = kChunk ? (frames + block_frames - 1) / block_frames : 1;
  const int cid = blockIdx.x / kCluster;
  const int tile0 = (cid / n_blocks) * kTile;  // first stream of the tile
  const int f_lo = kChunk ? (cid % n_blocks) * block_frames : 0;
  const int f_hi = kChunk ? min(f_lo + block_frames, frames) : 1;
  const int f_first = kChunk ? max(f_lo - 1, 0) : 0;
  const bool last_block = f_hi == F;  // writes new_state

  // every CTA of the cluster arrives now and waits before its first store
  // into another's shared memory, so that all have started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the weight ring: a barrier per slot, chunks 0-2 in flight (the
  // swizzle of the slots needs 1024-byte alignment)
  if (tid == 0) {
    if (sb & 1023) __trap();
#pragma unroll
    for (int k = 0; k < 4; ++k) mbar_init(bars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 3; ++i) issue_chunk(ring, bars, i, maps, rank);
  }
  // seq1 (stage-1 carry and h), seq2's carry rows, the final conv
  if constexpr (kChunk) {
    load_seq1(sb + kSeq1, p, tile0, batch, F, f_first);
  } else {
    for (int i = tid; i < kTile * 32; i += kThreads) {
      const int u = i & 31, s = i >> 5, b = tile0 + s;
      cp_async16(sb + kSeq1 + Seq1::offset(s, 2, u),
                 p.h + (size_t)(b < batch ? b : 0) * 256 + 8 * u, b < batch);
    }
    load_carry<Seq1, 256>(sb + kSeq1, p.state[0], 0, 0, tile0, kTile, batch);
  }
  load_carry<Seq2, 128>(sb + kSeq2, p.state[1], 0, 0, tile0, kTile, batch);
  if (tid < 6)
    cp_async16(sb + kConst + 16 * tid, p.final_w + 8 * tid);
  else if (tid == 6)
    cp_async4(sb + kConst + 96, p.final_b);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised before anyone waits on them

  uint2 prev2 = make_uint2(0u, 0u);
  uint32_t keep = 0u;
  if constexpr (kChunk) {
    for (int fr = f_first; fr < f_hi; ++fr)
      chunk_frame(p, maps, {batch, F, fr, fr - f_first, tile0, f_lo, fr + 1 < f_hi,
                            last_block && fr + 1 == f_hi},
                  prev2, keep);
  } else {
    tile_frame<false>(p, maps, {batch, 1, 0, 0, tile0, 0, false, true}, prev2, keep);
  }
}


__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
fused_upsampler_bf16_kernel(const __grid_constant__ FusedUpsamplerArgs<bf16> p,
                            const __grid_constant__ WeightMaps maps, int batch) {
  upsample_tile<false>(p, maps, batch, 1, 1);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
fused_upsampler_bf16_chunk_kernel(const __grid_constant__ FusedUpsamplerArgs<bf16> p,
                                  const __grid_constant__ WeightMaps maps, int batch, int frames,
                                  int block_frames) {
  upsample_tile<true>(p, maps, batch, frames, block_frames);
}

// Allows both entry points' kernels their dynamic shared memory on the
// current device (once per device), with the carveout that fits two CTAs
// on an SM.
cudaError_t configure() {
  static int done[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  const void* kernels[2] = {reinterpret_cast<const void*>(fused_upsampler_bf16_kernel),
                            reinterpret_cast<const void*>(fused_upsampler_bf16_chunk_kernel)};
  for (const void* kernel : kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = 1;
  return err;
}

// The tensor maps of the call's conv weights, from cuTensorMapEncodeTiled
// (looked up through the CUDA runtime's entry-point query, so the library
// needs no link against libcuda).
cudaError_t encode_maps(const FusedUpsamplerArgs<bf16>& a, WeightMaps* m) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // (columns N, rows 3 C_in, box columns, box rows, swizzle) of each stage
  const struct {
    int cols, rows, box_cols, box_rows;
    CUtensorMapSwizzle swizzle;
  } spec[4] = {{512, 768, 64, 128, CU_TENSOR_MAP_SWIZZLE_128B},
               {320, 384, 40, 192, CU_TENSOR_MAP_SWIZZLE_NONE},
               {128, 192, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B},
               {48, 96, 48, 96, CU_TENSOR_MAP_SWIZZLE_NONE}};
  for (int k = 0; k < 4; ++k) {
    const cuuint64_t dims[2] = {(cuuint64_t)spec[k].cols, (cuuint64_t)spec[k].rows};
    const cuuint64_t strides[1] = {(cuuint64_t)spec[k].cols * sizeof(bf16)};
    const cuuint32_t box[2] = {(cuuint32_t)spec[k].box_cols, (cuuint32_t)spec[k].box_rows};
    const cuuint32_t step[2] = {1, 1};
    const CUresult r =
        encode(&m->w[k], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(a.conv_w[k]),
               dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, spec[k].swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// Launch the one-frame kernel for `batch` streams on `stream`:
// ceil(batch / 16) clusters of 8 blocks.  Return cudaGetLastError() (0 =
// launched).
extern "C" int fused_upsampler_bf16_launch(const FusedUpsamplerArgs<bf16>* args, int batch,
                                           void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  WeightMaps maps;
  err = encode_maps(*args, &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int clusters = (batch + kTile - 1) / kTile;
  fused_upsampler_bf16_kernel<<<clusters * kCluster, kThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(*args, maps, batch);
  return static_cast<int>(cudaGetLastError());
}

// Launch the kernel for `frames` frames of `batch` streams on `stream`, the
// frame axis split into blocks of `block_frames`: ceil(batch / 16) x
// ceil(frames / block_frames) clusters of 8 blocks.  Return
// cudaGetLastError() (0 = launched).
extern "C" int fused_upsampler_bf16_chunk_launch(const FusedUpsamplerArgs<bf16>* args,
                                                 int batch, int frames, int block_frames,
                                                 void* stream) {
  if (batch <= 0 || frames <= 0) return 0;
  if (block_frames <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  WeightMaps maps;
  err = encode_maps(*args, &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long clusters = static_cast<long long>((batch + kTile - 1) / kTile) *
                             ((frames + block_frames - 1) / block_frames);
  if (clusters * kCluster > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_upsampler_bf16_chunk_kernel<<<static_cast<int>(clusters) * kCluster, kThreads, kSmemBytes,
                                      static_cast<cudaStream_t>(stream)>>>(
      *args, maps, batch, frames, block_frames);
  return static_cast<int>(cudaGetLastError());
}

// How many of the kernel's clusters the current device holds at once, and
// its dynamic shared memory per block; return a CUDA error code.
extern "C" int fused_upsampler_bf16_occupancy(int* max_active_clusters, int* smem_bytes) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  err = cudaOccupancyMaxActiveClusters(max_active_clusters, fused_upsampler_bf16_kernel, &cfg);
  *smem_bytes = kSmemBytes;
  return static_cast<int>(err);
}
