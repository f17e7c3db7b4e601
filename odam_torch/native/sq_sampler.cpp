// Native superquadric surface sampler (host-side C++).
//
// Equal-distance sampling of (eta, omega) angle pairs on a superellipsoid
// after Pilu & Fisher (BMVC 1995) — the same capability as the reference's
// Cython/C++ fast_sampler (reference: fast_sampler/sampling.cpp,
// _sampler.pyx; see SURVEY.md C1).  Fresh implementation:
//
//   * equal-arclength angles come from a recursive chord-balanced bisection
//     of the superellipse arc;
//   * latitudes are importance-sampled from a ring-circumference CDF, either
//     with a seeded mt19937 (reference-compatible randomized mode) or with
//     stratified quantiles + a golden-ratio longitude lattice (deterministic
//     mode, matching odam_torch.ops.sampler's on-device construction);
//   * batched over B x M primitives through a flat C ABI (ctypes-friendly).
//
// A copy of odam_tpu/native/sq_sampler.cpp.  Build: odam_torch/native/__init__.py
// (g++ -O3 -shared -fPIC, at first use, into odam_torch/_build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

inline float signed_pow(float x, float p) {
    float m = std::pow(std::fabs(x), p);
    return x < 0.f ? -m : m;
}

struct Point2 {
    float x, y;
};

inline Point2 superellipse_point(float theta, float a, float b, float e) {
    return {a * signed_pow(std::cos(theta), e), b * signed_pow(std::sin(theta), e)};
}

inline float dist(const Point2 &p, const Point2 &q) {
    return std::hypot(p.x - q.x, p.y - q.y);
}

// Fill out[0 .. n-1] with angles between (lo, hi) whose superellipse points
// are approximately equally spaced in arclength.  Chord-balanced recursive
// bisection: the midpoint angle splits the budget proportionally to the two
// chord lengths.
void equal_arc_fill(float lo, float hi, const Point2 &plo, const Point2 &phi,
                    int n, float a, float b, float e, float *out) {
    if (n <= 0) return;
    float mid = 0.5f * (lo + hi);
    Point2 pm = superellipse_point(mid, a, b, e);
    float dl = dist(plo, pm);
    float dr = dist(pm, phi);
    float denom = dl + dr;
    int nl = denom > 0.f ? static_cast<int>(std::lround(dl / denom * (n - 1))) : (n - 1) / 2;
    int nr = n - 1 - nl;
    equal_arc_fill(lo, mid, plo, pm, nl, a, b, e, out);
    out[nl] = mid;
    equal_arc_fill(mid, hi, pm, phi, nr, a, b, e, out + nl + 1);
}

void equal_arc_angles(float lo, float hi, int grid, float a, float b, float e,
                      std::vector<float> &out) {
    out.resize(grid);
    out.front() = lo;
    out.back() = hi;
    equal_arc_fill(lo, hi, superellipse_point(lo, a, b, e),
                   superellipse_point(hi, a, b, e), grid - 2, a, b, e,
                   out.data() + 1);
}

// CDF over the eta grid proportional to the local ring circumference factor.
void ring_cdf(const std::vector<float> &etas, float a1_plus_a2, float e1,
              std::vector<float> &cdf) {
    const float smoothing = 1e-3f;
    cdf.resize(etas.size());
    float acc = 0.f;
    for (size_t i = 0; i < etas.size(); ++i) {
        acc += smoothing + a1_plus_a2 * signed_pow(std::cos(etas[i]), e1);
        cdf[i] = acc;
    }
    float inv = 1.f / cdf.back();
    for (float &c : cdf) c *= inv;
}

inline int cdf_pick(const std::vector<float> &cdf, float u) {
    auto it = std::lower_bound(cdf.begin(), cdf.end(), u);
    return static_cast<int>(std::min<size_t>(it - cdf.begin(), cdf.size() - 1));
}

}  // namespace

extern "C" {

// scales: [B*M*3] (a1, a2, a3); epsilons: [B*M*2] (e1, e2);
// etas/omegas out: [B*M*N].  mode 0 = seeded mt19937 (reference-compatible),
// mode 1 = deterministic stratified + golden-ratio lattice (matches the
// on-device sampler).  Returns 0 on success.
int odam_sample_sq_batch(const float *scales, const float *epsilons,
                         int B, int M, int N, int grid, int seed, int mode,
                         float *etas, float *omegas) {
    if (B <= 0 || M <= 0 || N <= 0 || grid < 4) return 1;
    std::mt19937 gen(static_cast<uint32_t>(seed));
    std::uniform_real_distribution<float> uni(0.f, 1.f);
    std::vector<float> eta_grid, omega_grid, cdf;
    const double phi_frac = 0.6180339887498949;

    for (int bm = 0; bm < B * M; ++bm) {
        const float *a = scales + 3 * bm;
        const float *e = epsilons + 2 * bm;
        float *eta_out = etas + static_cast<long>(N) * bm;
        float *omega_out = omegas + static_cast<long>(N) * bm;

        equal_arc_angles(kPi / 2, -kPi / 2, grid, a[0], a[2], e[0], eta_grid);
        equal_arc_angles(kPi, -kPi, grid, a[0], a[1], e[1], omega_grid);
        ring_cdf(eta_grid, a[0] + a[1], e[0], cdf);

        if (mode == 0) {
            for (int i = 0; i < N; ++i)
                eta_out[i] = eta_grid[cdf_pick(cdf, uni(gen))];
            for (int i = 0; i < N; ++i) {
                int j = static_cast<int>(uni(gen) * grid);
                omega_out[i] = omega_grid[std::min(j, grid - 1)];
            }
        } else {
            for (int i = 0; i < N; ++i) {
                float level = (i + 0.5f) / N;
                // match the device sampler: count of cdf entries < level
                int idx = static_cast<int>(
                    std::lower_bound(cdf.begin(), cdf.end(), level) - cdf.begin());
                eta_out[i] = eta_grid[std::min(idx, grid - 1)];
                double f = std::fmod(i * phi_frac, 1.0);
                int oj = std::min(static_cast<int>(f * grid), grid - 1);
                omega_out[i] = omega_grid[oj];
            }
        }
    }
    return 0;
}

}  // extern "C"
