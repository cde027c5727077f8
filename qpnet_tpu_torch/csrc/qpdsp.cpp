// qpdsp — the port's host DSP core: the MLSA filter and a causal FIR.
//
// The MLSA (mel log spectrum approximation) filter is a per-sample
// recursive IIR: the mel basis Phi_m cascade and an order-L Pade
// approximation of exp, split into the b[1] stage and the b[2:] stage, with
// gain exp(b[0]) (qpnet_tpu_torch/dsp/mlsa.py derives it and keeps a plain
// per-sample version of the same recursion).  The filter's whole state
// (two exp-filter stages of (stage inputs (L), basis outputs (L, M)) and
// the sample counter) goes in and comes back out of
// qpdsp_mlsa_filter_state, so a signal filtered in chunks, the state
// carried, gives the one-shot output bit for bit; the FIR carries its
// input history the same way.
//
// Plain C interface, float64, built with the host C++ compiler by
// qpnet_tpu_torch/ops/_build.py and bound with ctypes by
// qpnet_tpu_torch/dsp/native.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPade4[5] = {1.0, 4.999273e-1, 1.067005e-1, 1.170221e-2,
                              5.656279e-4};
constexpr double kPade5[6] = {1.0, 4.999391e-1, 1.107098e-1, 1.369984e-2,
                              9.564853e-4, 3.041721e-5};

// One exp(sum_{m>=1} b_m Phi_m) filter realized with the Pade rational
// exp(w) ~= N(w)/N(-w); every Phi_m carries >= 1 sample of delay, so the
// feedback is computable sample by sample.  The state lives in the
// caller's buffer: u_prev (L) then y_prev (L, M).
struct ExpFilter {
  int L;        // Pade order
  int M;        // filter order (number of Phi basis terms)
  double alpha;
  const double* A;  // Pade coefficients A_1..A_L
  double* u_prev;   // (L)
  double* y_prev;   // (L, M)

  ExpFilter(int pd, int order, double a, double* state)
      : L(pd), M(order), alpha(a), A(pd == 5 ? kPade5 + 1 : kPade4 + 1),
        u_prev(state), y_prev(state + pd) {}

  // Phi outputs of stage l from the stored (strictly delayed) state, then
  // F = sum_m b[m] * y_m; writes the new y into y_new.
  inline double stage_output(int l, const double* b, double* y_new) const {
    const double aa = 1.0 - alpha * alpha;
    const double* yp = y_prev + l * M;
    double f = 0.0;
    double y1 = aa * u_prev[l] + alpha * yp[0];
    y_new[0] = y1;
    f += b[1] * y1;
    for (int m = 1; m < M; ++m) {
      double ym = yp[m - 1] - alpha * y_new[m - 1] + alpha * yp[m];
      y_new[m] = ym;
      f += b[m + 1] * ym;
    }
    return f;
  }

  inline double step(double x, const double* b, double* scratch /* L*M */) {
    double s[8];  // L <= 5
    for (int l = 0; l < L; ++l) s[l] = stage_output(l, b, scratch + l * M);
    double u = x;
    double y = 0.0;
    double sign = -1.0;
    for (int l = 0; l < L; ++l) {
      u -= sign * A[l] * s[l];
      y += A[l] * s[l];
      sign = -sign;
    }
    y += u;
    // stage 0's input is u, stage l's is s_{l-1}
    u_prev[0] = u;
    for (int l = 1; l < L; ++l) u_prev[l] = s[l - 1];
    std::memcpy(y_prev, scratch, sizeof(double) * L * M);
    return y;
  }
};

}  // namespace

extern "C" {

// Doubles of one filter's state: two stages of (L) + (L, M).
int64_t qpdsp_mlsa_state_size(int order, int pd) {
  return 2 * (static_cast<int64_t>(pd) + static_cast<int64_t>(pd) * order);
}

// x: (n) input.  b_frames: (F, M+1) MLSA coefficients (from mc2b), which
// switch every `hopsize` samples of the running counter (the last frame
// holds past the end).  state: qpdsp_mlsa_state_size(M, pd) doubles, read
// and written back.  counter: the samples filtered before this call, read
// and advanced by n.  out: (n).  Returns 0 on success.
int qpdsp_mlsa_filter_state(const double* x, int64_t n,
                            const double* b_frames, int64_t n_frames,
                            int order_plus1, double alpha, int hopsize,
                            int pd, double* state, int64_t* counter,
                            double* out) {
  if (pd != 4 && pd != 5) return 1;
  const int M = order_plus1 - 1;
  if (M < 1 || n_frames < 1 || hopsize < 1 || *counter < 0) return 2;
  ExpFilter f1(pd, M, alpha, state);                   // b[1] term only
  ExpFilter f2(pd, M, alpha, state + pd + pd * M);     // b[2:] cascade
  std::vector<double> scratch(static_cast<size_t>(pd) * M);
  std::vector<double> b1(order_plus1, 0.0), b2(order_plus1, 0.0);
  const int64_t t0 = *counter;
  int64_t frame = -1;
  double gain = 1.0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t fr = (t0 + i) / hopsize;
    if (fr >= n_frames) fr = n_frames - 1;
    if (fr != frame) {
      frame = fr;
      const double* b = b_frames + fr * order_plus1;
      std::fill(b1.begin(), b1.end(), 0.0);
      std::fill(b2.begin(), b2.end(), 0.0);
      b1[1] = b[1];
      for (int m = 2; m <= M; ++m) b2[m] = b[m];
      gain = std::exp(b[0]);
    }
    double v = f1.step(x[i], b1.data(), scratch.data());
    double y = f2.step(v, b2.data(), scratch.data());
    out[i] = y * gain;
  }
  *counter = t0 + n;
  return 0;
}

// Causal FIR filter with carried input history:
// out[i] = sum_{k=0}^{n_taps-1} taps[k] * x[i-k], where x[j] for j < 0 is
// hist[n_taps-1 + j] (hist holds the n_taps-1 samples before x, oldest
// first, zeros at the start of a signal).  hist is updated to the last
// n_taps-1 samples seen, so chunks filtered in turn give the one-shot
// output bit for bit.
void qpdsp_fir_state(const double* x, int64_t n, const double* taps,
                     int n_taps, double* hist, double* out) {
  const int64_t h = n_taps - 1;
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int k = 0; k < n_taps; ++k) {
      const int64_t j = i - k;
      acc += taps[k] * (j >= 0 ? x[j] : hist[h + j]);
    }
    out[i] = acc;
  }
  if (n >= h) {
    std::memcpy(hist, x + n - h, sizeof(double) * h);
  } else {
    std::memmove(hist, hist + n, sizeof(double) * (h - n));
    std::memcpy(hist + h - n, x, sizeof(double) * n);
  }
}

}  // extern "C"
