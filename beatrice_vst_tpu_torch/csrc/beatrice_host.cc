// beatrice_host: native host-edge runtime of the streaming server.
//
// A copy of native/beatrice_host.cc, built by the PyTorch port at first use
// with the host compiler (beatrice_vst_tpu_torch/cuda_build.py:build_host).
//
// Role: everything between a client's audio stream (arbitrary sample rate,
// arbitrary callback block sizes, real-time thread) and the engine's fixed
// 48 kHz / 480-sample tick grid, the counterpart of the reference's native
// streaming stack (src/common/resample.h + the VST processor's buffering):
//
//   - PolyphaseResampler: windowed-sinc rational resampler (Stern-Brocot
//     ratio approximation with denominators < 1000, Hann-windowed sinc
//     prototype -- same math as resample.h:25-46,209-237, reimplemented),
//     streaming with O(taps) history, SIMD-friendly inner loop.
//   - Reblocker: ring-buffer adapter from arbitrary I/O sizes to the fixed
//     inner block (ConvertStreamFunctionBlockSize semantics,
//     resample.h:331-364: output is the previous content of each slot, so
//     a fixed one-block latency, n-in == n-out per call).
//   - SpscRing: lock-free single-producer/single-consumer float ring for
//     per-stream ingest/egress between the audio thread and the engine
//     scheduler thread (SURVEY.md section 5.2).
//
// C ABI throughout (consumed via ctypes from Python).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Fraction {
  int numer, denom;
};

// Stern-Brocot mediant walk, numerator/denominator < limit (matches the
// behavior of the reference's ComputeSimpleFraction, resample.h:25-46).
Fraction SimpleFraction(double ratio, int limit) {
  Fraction l{0, 1}, r{1, 0};
  for (;;) {
    Fraction m{l.numer + r.numer, l.denom + r.denom};
    if (ratio * m.denom < m.numer) {
      if (m.numer >= limit || m.denom >= limit) return l;
      r = m;
    } else {
      if (m.numer >= limit || m.denom >= limit) return r;
      l = m;
    }
  }
}

int Gcd(int a, int b) { return b ? Gcd(b, a % b) : a; }

// Rational L/M polyphase resampler on the LCM grid; identical filter design
// to beatrice_vst_tpu/ops/resample.py (Hann-windowed sinc, per-phase DC
// normalization, k_fwd input samples of causal delay).
class PolyphaseResampler {
 public:
  PolyphaseResampler(double rate_in, double rate_out, int taps, double cutoff)
      : phase_(0) {
    Fraction f = SimpleFraction(rate_out / rate_in, 1000);
    int g = Gcd(f.numer, f.denom);
    L_ = f.numer / g;
    M_ = f.denom / g;
    const double zspace = std::max(L_, M_) / cutoff;
    const int c = static_cast<int>(std::lround(taps * zspace));
    const int length = 2 * c + 1;
    std::vector<double> proto(length);
    for (int i = 0; i < length; ++i) {
      const double x = (i - c) / zspace;
      const double sinc = x == 0.0 ? 1.0 : std::sin(kPi * x) / (kPi * x);
      const double hann =
          0.5 - 0.5 * std::cos(2.0 * kPi * i / (length - 1));
      proto[i] = sinc * hann;
    }
    k_fwd_ = (c + L_ - 1) / L_;
    const int k_bwd = c / L_;
    K_ = k_fwd_ + k_bwd + 1;
    weights_.assign(static_cast<size_t>(L_) * K_, 0.0f);
    for (int p = 0; p < L_; ++p) {
      double sum = 0.0;
      for (int k = 0; k < K_; ++k) {
        const int j = c + p + (k - k_fwd_) * L_;
        if (j >= 0 && j < length) {
          weights_[p * K_ + k] = static_cast<float>(proto[j]);
          sum += proto[j];
        }
      }
      if (sum > 1e-12) {
        for (int k = 0; k < K_; ++k)
          weights_[p * K_ + k] = static_cast<float>(weights_[p * K_ + k] / sum);
      }
    }
    history_.assign(K_ - 1, 0.0f);
  }

  int L() const { return L_; }
  int M() const { return M_; }
  int DelayInputSamples() const { return k_fwd_; }

  // Streaming: consume n_in samples, produce up to out_cap samples.
  // Returns the number of output samples written. Output count per call is
  // floor((total_in * L - phase)/M)-ish and varies by at most 1; callers
  // should size out_cap >= n_in * L / M + 2.
  int Process(const float* in, int n_in, float* out, int out_cap) {
    buf_.resize(history_.size() + n_in);
    std::memcpy(buf_.data(), history_.data(), history_.size() * sizeof(float));
    std::memcpy(buf_.data() + history_.size(), in, n_in * sizeof(float));
    const int hist = static_cast<int>(history_.size());
    int n_out = 0;
    // produce every output whose newest needed input sample has arrived:
    // output n (global) reads inputs up to base = floor(n*M/L); we track
    // next output index relative to consumed input via in_count_.
    const int64_t total_in = in_count_ + n_in;
    while (n_out < out_cap) {
      const int64_t base = next_out_ * M_ / L_;
      if (base >= total_in) break;
      const int p = static_cast<int>((next_out_ * M_) % L_);
      const float* w = &weights_[static_cast<size_t>(p) * K_];
      const int64_t local = base - in_count_ + hist;  // index of tap k=0
      float acc = 0.0f;
      for (int k = 0; k < K_; ++k) acc += w[k] * buf_[local - k];
      out[n_out++] = acc;
      ++next_out_;
    }
    // keep the last K-1 samples as history
    const size_t keep = history_.size();
    std::memcpy(history_.data(), buf_.data() + buf_.size() - keep,
                keep * sizeof(float));
    in_count_ = total_in;
    return n_out;
  }

 private:
  int L_, M_, K_, k_fwd_, phase_;
  int64_t in_count_ = 0;
  int64_t next_out_ = 0;
  std::vector<float> weights_;
  std::vector<float> history_;
  std::vector<float> buf_;
};

// Fixed-block adapter with one-block latency (semantics of
// ConvertStreamFunctionBlockSize, resample.h:331-364): Exchange(io, n)
// writes out the previously buffered samples while absorbing the new ones;
// whenever the internal block fills, the registered callback fires.
class Reblocker {
 public:
  explicit Reblocker(int block) : block_(block), buf_(block, 0.0f) {}

  int BlockSize() const { return block_; }
  int Fill() const { return idx_; }
  float* Block() { return buf_.data(); }

  // Push n samples; for each full block becomes available, it is left in
  // the pending vector for the host to hand to the engine.
  void Push(const float* in, int n) {
    int i = 0;
    while (i < n) {
      const int take = std::min(block_ - idx_, n - i);
      std::memcpy(buf_.data() + idx_, in + i, take * sizeof(float));
      idx_ += take;
      i += take;
      if (idx_ == block_) {
        pending_.insert(pending_.end(), buf_.begin(), buf_.end());
        idx_ = 0;
      }
    }
  }

  int PopPending(float* out, int max_samples) {
    const int n = std::min<int>(max_samples, static_cast<int>(pending_.size()));
    std::memcpy(out, pending_.data(), n * sizeof(float));
    pending_.erase(pending_.begin(), pending_.begin() + n);
    return n;
  }

 private:
  int block_;
  int idx_ = 0;
  std::vector<float> buf_;
  std::vector<float> pending_;
};

// Lock-free SPSC float ring (power-of-two capacity).
class SpscRing {
 public:
  explicit SpscRing(uint32_t capacity_pow2)
      : mask_(capacity_pow2 - 1), data_(capacity_pow2) {}

  uint32_t Capacity() const { return mask_ + 1; }

  uint32_t Readable() const {
    return tail_.load(std::memory_order_acquire) -
           head_.load(std::memory_order_acquire);
  }
  uint32_t Writable() const { return Capacity() - Readable(); }

  uint32_t Write(const float* in, uint32_t n) {
    const uint32_t can = std::min(n, Writable());
    uint32_t t = tail_.load(std::memory_order_relaxed);
    for (uint32_t i = 0; i < can; ++i) data_[(t + i) & mask_] = in[i];
    tail_.store(t + can, std::memory_order_release);
    return can;
  }

  uint32_t Read(float* out, uint32_t n) {
    const uint32_t can = std::min(n, Readable());
    uint32_t h = head_.load(std::memory_order_relaxed);
    for (uint32_t i = 0; i < can; ++i) out[i] = data_[(h + i) & mask_];
    head_.store(h + can, std::memory_order_release);
    return can;
  }

 private:
  std::atomic<uint32_t> head_{0}, tail_{0};
  uint32_t mask_;
  std::vector<float> data_;
};

}  // namespace

extern "C" {

// ---- resampler ----
void* bh_resampler_create(double rate_in, double rate_out, int taps,
                          double cutoff) {
  return new (std::nothrow) PolyphaseResampler(rate_in, rate_out, taps, cutoff);
}
void bh_resampler_destroy(void* h) {
  delete static_cast<PolyphaseResampler*>(h);
}
int bh_resampler_process(void* h, const float* in, int n_in, float* out,
                         int out_cap) {
  return static_cast<PolyphaseResampler*>(h)->Process(in, n_in, out, out_cap);
}
int bh_resampler_ratio_l(void* h) {
  return static_cast<PolyphaseResampler*>(h)->L();
}
int bh_resampler_ratio_m(void* h) {
  return static_cast<PolyphaseResampler*>(h)->M();
}
int bh_resampler_delay(void* h) {
  return static_cast<PolyphaseResampler*>(h)->DelayInputSamples();
}

// ---- reblocker ----
void* bh_reblocker_create(int block) {
  return new (std::nothrow) Reblocker(block);
}
void bh_reblocker_destroy(void* h) { delete static_cast<Reblocker*>(h); }
void bh_reblocker_push(void* h, const float* in, int n) {
  static_cast<Reblocker*>(h)->Push(in, n);
}
int bh_reblocker_pop(void* h, float* out, int max_samples) {
  return static_cast<Reblocker*>(h)->PopPending(out, max_samples);
}
int bh_reblocker_fill(void* h) { return static_cast<Reblocker*>(h)->Fill(); }

// ---- SPSC ring ----
void* bh_ring_create(uint32_t capacity_pow2) {
  if (capacity_pow2 == 0 || (capacity_pow2 & (capacity_pow2 - 1))) return nullptr;
  return new (std::nothrow) SpscRing(capacity_pow2);
}
void bh_ring_destroy(void* h) { delete static_cast<SpscRing*>(h); }
uint32_t bh_ring_write(void* h, const float* in, uint32_t n) {
  return static_cast<SpscRing*>(h)->Write(in, n);
}
uint32_t bh_ring_read(void* h, float* out, uint32_t n) {
  return static_cast<SpscRing*>(h)->Read(out, n);
}
uint32_t bh_ring_readable(void* h) {
  return static_cast<SpscRing*>(h)->Readable();
}
uint32_t bh_ring_writable(void* h) {
  return static_cast<SpscRing*>(h)->Writable();
}

}  // extern "C"
