// Copied verbatim from nyxus_tpu/native/src/geomfeats.cpp; pinned by tests/test_torch_tables.py.
// Native host-geometry kernels: chords, rotating calipers, min enclosing
// circle.  These are the hot sequential per-ROI algorithms of the host
// feature pass; each is a semantic port of the corresponding reference
// algorithm (citations per function) kept bit-compatible with the Python
// implementations in nyxus_tpu/pipeline/hostfeats.py (which remain as
// parity oracles).  Batched entry points fan ROIs out over a small thread
// pool (the reference runs these on std::async threads, parallel.h:23-42).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// ComputeCommonStatistics2 port (reference: common_stats.cpp:9-73)

struct CommonStats {
    double min_, max_, mean_, median_, stdev_, mode_;
};

CommonStats common_stats(std::vector<double>& d) {
    CommonStats o{0, 0, 0, 0, 0, 0};
    if (d.empty()) return o;
    o.max_ = *std::max_element(d.begin(), d.end());
    o.min_ = *std::min_element(d.begin(), d.end());
    double sum = 0;
    for (double v : d) sum += v;
    o.mean_ = sum / (double)d.size();
    double ss = 0;
    for (double v : d) ss += (v - o.mean_) * (v - o.mean_);
    o.stdev_ = std::sqrt(ss / (double)d.size());
    int imax = (int)std::ceil(o.max_), imin = (int)std::floor(o.min_);
    std::vector<int> bins(imax - imin + 1, 0);
    for (double v : d) bins[(int)v - imin]++;
    double best = 0;
    int bi = -1;
    for (size_t i = 0; i < bins.size(); i++)
        if (bins[i] > best) { best = bins[i]; bi = (int)i; }
    o.mode_ = bi + imin;
    std::sort(d.begin(), d.end());
    size_t half = d.size() / 2;
    o.median_ = d.size() % 2 ? d[half] : (d[half] + d[half - 1]) / 2.0;
    return o;
}

// rotate_around_center_fp port (reference: rotation.cpp:37-68): double
// rotation of the hull around its vertex centroid, stored as FLOAT32.
void rotate_fp(const double* hx, const double* hy, long k, double theta_deg,
               std::vector<double>& rx, std::vector<double>& ry) {
    double cx = 0, cy = 0;
    for (long i = 0; i < k; i++) { cx += hx[i]; cy += hy[i]; }
    cx /= (double)k;
    cy /= (double)k;
    float th = (float)theta_deg * (float)M_PI / 180.0f;
    // unqualified sin(float) in the reference resolves to the FLOAT
    // overload (rotation.cpp:57 with <cmath>), so trig runs in float32
    double s = (double)sinf(th), c = (double)cosf(th);
    rx.resize(k);
    ry.resize(k);
    for (long i = 0; i < k; i++) {
        double xr = (hx[i] - cx) * c - (hy[i] - cy) * s + cx;
        double yr = (hy[i] - cy) * c + (hx[i] - cx) * s + cy;
        rx[i] = (double)(float)xr;   // Point2f storage
        ry[i] = (double)(float)yr;
    }
}

// _hull_width_at_y port (reference: caliper_martin.cpp scanline extent)
double hull_width_at_y(const std::vector<double>& px,
                       const std::vector<double>& py, double y) {
    size_t n = px.size();
    bool have = false;
    double xlo = 0, xhi = 0;
    for (size_t i = 0; i < n; i++) {
        size_t j = (i + 1) % n;
        double lo = std::min(py[i], py[j]), hi = std::max(py[i], py[j]);
        if (y < lo || y > hi) continue;
        double e0, e1;
        if (py[j] != py[i]) {
            double x = px[i] + (px[j] - px[i]) * (y - py[i]) / (py[j] - py[i]);
            e0 = e1 = x;
        } else {
            e0 = std::min(px[i], px[j]);
            e1 = std::max(px[i], px[j]);
        }
        if (!have) { xlo = e0; xhi = e1; have = true; }
        else { xlo = std::min(xlo, e0); xhi = std::max(xhi, e1); }
    }
    return have ? xhi - xlo : 0.0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Feret caliper (reference: caliper_feret.cpp:16-102).
// out[8]: min_angle, max_angle, min, max, mean, median, stdev, mode

void nyx_caliper_feret_one(const double* hx, const double* hy, long k,
                           double* out) {
    std::vector<double> rx, ry, angles, ferets;
    for (double th = 0.0; th <= 180.0; th += 10.0) {
        rotate_fp(hx, hy, k, th, rx, ry);
        double mn = rx[0], mx = rx[0];
        for (long i = 0; i < k; i++) {
            mn = std::min(mn, rx[i]);
            mx = std::max(mx, rx[i]);
        }
        double f = mx - mn;
        if (f > 0) { angles.push_back(th); ferets.push_back(f); }
    }
    if (ferets.empty()) return;  // caller pre-fills the noval sentinel
    size_t imin = std::min_element(ferets.begin(), ferets.end()) - ferets.begin();
    size_t imax = std::max_element(ferets.begin(), ferets.end()) - ferets.begin();
    out[0] = angles[imin];
    out[1] = angles[imax];
    CommonStats s = common_stats(ferets);
    out[2] = s.min_; out[3] = s.max_; out[4] = s.mean_;
    out[5] = s.median_; out[6] = s.stdev_; out[7] = s.mode_;
}

// Martin caliper (reference: caliper_martin.cpp).
// out[6]: min, max, mean, median, stdev, mode
//
// Scanline widths are gathered edge-major: each hull edge only visits the
// scanlines its y-range covers (a convex hull meets each scanline in ~2
// edges, so this is ~15x less work than the scanline-major form), while
// every covered (edge, y) pair evaluates the identical IEEE expression --
// min/max are order-independent, so the result is bit-equal.
void nyx_caliper_martin_one(const double* hx, const double* hy, long k,
                            double* out) {
    const int NGRID = 100;
    std::vector<double> rx, ry, D;
    double xlo[NGRID], xhi[NGRID];
    bool have[NGRID];
    for (double th = 0.0; th < 180.0; th += 10.0) {
        rotate_fp(hx, hy, k, th, rx, ry);
        double miny = ry[0], maxy = ry[0];
        for (long i = 0; i < k; i++) {
            miny = std::min(miny, ry[i]);
            maxy = std::max(maxy, ry[i]);
        }
        if (maxy <= miny) continue;
        double stepy = (maxy - miny) / NGRID;
        for (int g = 0; g < NGRID; g++) have[g] = false;
        for (long i = 0; i < k; i++) {
            long j = (i + 1) % k;
            double lo = std::min(ry[i], ry[j]), hi = std::max(ry[i], ry[j]);
            // widened index window; the exact y in [lo, hi] test below keeps
            // bit-parity with the all-edges scan
            long g0 = (long)std::floor((lo - miny) / stepy - 0.5) - 1;
            long g1 = (long)std::ceil((hi - miny) / stepy - 0.5) + 1;
            g0 = std::max(g0, 0L);
            g1 = std::min(g1, (long)NGRID - 1);
            for (long g = g0; g <= g1; g++) {
                double y = miny + ((double)g + 0.5) * stepy;
                if (y < lo || y > hi) continue;
                double e0, e1;
                if (ry[j] != ry[i]) {
                    double x = rx[i] + (rx[j] - rx[i]) * (y - ry[i]) /
                                           (ry[j] - ry[i]);
                    e0 = e1 = x;
                } else {
                    e0 = std::min(rx[i], rx[j]);
                    e1 = std::max(rx[i], rx[j]);
                }
                if (!have[g]) { xlo[g] = e0; xhi[g] = e1; have[g] = true; }
                else { xlo[g] = std::min(xlo[g], e0);
                       xhi[g] = std::max(xhi[g], e1); }
            }
        }
        double widths[NGRID], total = 0;
        for (int g = 0; g < NGRID; g++) {
            widths[g] = have[g] ? xhi[g] - xlo[g] : 0.0;
            total += widths[g];
        }
        if (total <= 0) continue;
        double cum = 0;
        for (int g = 0; g < NGRID; g++) {
            cum += widths[g];
            if (cum >= 0.5 * total) { D.push_back(widths[g]); break; }
        }
    }
    if (D.empty()) return;
    CommonStats s = common_stats(D);
    out[0] = s.min_; out[1] = s.max_; out[2] = s.mean_;
    out[3] = s.median_; out[4] = s.stdev_; out[5] = s.mode_;
}

// Nassenstein caliper (reference: caliper_nassenstein.cpp).
// out[6]: min, max, mean, median, stdev, mode
void nyx_caliper_nassenstein_one(const double* hx, const double* hy, long k,
                                 double* out) {
    if (k < 3) return;
    std::vector<double> rx, ry, D;
    for (double th = 0.0; th < 180.0; th += 10.0) {
        rotate_fp(hx, hy, k, th, rx, ry);
        double ymax = ry[0];
        for (long i = 0; i < k; i++) ymax = std::max(ymax, ry[i]);
        double sx = 0;
        long cnt = 0;
        for (long i = 0; i < k; i++)
            if (std::fabs(ry[i] - ymax) < 1e-3) { sx += rx[i]; cnt++; }
        double xc = sx / (double)std::max(cnt, 1L);
        // height at x == width with axes swapped
        D.push_back(hull_width_at_y(ry, rx, xc));
    }
    if (D.empty()) return;
    CommonStats s = common_stats(D);
    out[0] = s.min_; out[1] = s.max_; out[2] = s.mean_;
    out[3] = s.median_; out[4] = s.stdev_; out[5] = s.mode_;
}

// ---------------------------------------------------------------------------
// Chords (reference: chords.cpp:11-112 + image_matrix get_chlen quirks).
// Inputs: per-ROI GLOBAL pixel coords + intensities in cloud (raster) order,
// AABB bounds.  out[16]:
//   0..7  MAXCHORDS max, max_ang, min, min_ang, median, mean, mode, stddev
//   8..15 ALLCHORDS same order

void nyx_chords_one(const int64_t* gx, const int64_t* gy, const double* inten,
                    long n, long x0, long x1, long y0, long y1, double* out) {
    const int n_angle_segments = 20, n_side_segments = 100;
    double cenx = (double)(x0 + x1) / 2.0, ceny = (double)(y0 + y1) / 2.0;
    std::vector<long> MCv;
    std::vector<double> ACv, ACang, MCang;
    std::vector<long> ACl;
    std::vector<long> xi(n), yi(n);
    std::vector<double> relx(n), rely(n);         // hoisted int->double
    for (long i = 0; i < n; i++) {
        relx[i] = (double)gx[i] - cenx;
        rely[i] = (double)gy[i] - ceny;
    }
    // epoch-stamped raster (no per-angle clear): cell value (epoch<<1)|nz
    // marks a cell written this angle with the LAST writer's nonzero flag
    // (same last-writer-wins as the double raster it replaces).
    // thread_local: reused across ROIs of one worker thread
    static thread_local std::vector<uint32_t> stamp;
    static thread_local std::vector<long> curv, bestv;
    static thread_local uint32_t epoch = 0;
    double angStep = M_PI / (double)n_angle_segments;
    for (double ang = 0; ang < M_PI; ang += angStep) {
        float ang32 = (float)ang;                 // float theta parameter
        // float-overload trig, as in rotate_cloud (rotation.cpp:81-83)
        double s = (double)sinf(ang32), c = (double)cosf(ang32);
        long minx = INT64_MAX, miny = INT64_MAX, maxx = INT64_MIN,
             maxy = INT64_MIN;
        for (long i = 0; i < n; i++) {
            double xr = relx[i] * c - rely[i] * s + cenx;
            double yr = rely[i] * c + relx[i] * s + ceny;
            xi[i] = (long)(float)xr;              // Pixel2(float) truncation
            yi[i] = (long)(float)yr;
            minx = std::min(minx, xi[i]);
            maxx = std::max(maxx, xi[i]);
            miny = std::min(miny, yi[i]);
            maxy = std::max(maxy, yi[i]);
        }
        long wr = maxx - minx + 1, hr = maxy - miny + 1;
        if ((size_t)(wr * hr) > stamp.size()) {
            stamp.assign((size_t)(wr * hr), 0);
            epoch = 0;
        }
        if (epoch >= 0x7ffffff0u) {               // headroom for epoch<<1
            std::fill(stamp.begin(), stamp.end(), 0);
            epoch = 0;
        }
        epoch++;
        for (long i = 0; i < n; i++) {            // last writer wins
            size_t cell = (size_t)((yi[i] - miny) * wr + (xi[i] - minx));
            stamp[cell] = (epoch << 1) | (uint32_t)(inten[i] != 0.0);
        }
        long step = wr >= 2 * n_side_segments ? wr / n_side_segments : 1;
        long tcBest = 0;
        bool tcAny = false;
        // get_chlen (image_matrix.cpp:206-236): per column, longest NONZERO
        // run TERMINATED by a zero; a run touching the bottom edge is lost
        // (the final open run is never flushed)
        if (step == 1) {
            // row-major sweep with per-column run state (cache-friendly; a
            // column-major walk strided every read across cache lines)
            if ((size_t)wr > curv.size()) {
                curv.resize((size_t)wr);
                bestv.resize((size_t)wr);
            }
            std::fill(curv.begin(), curv.begin() + wr, 0);
            std::fill(bestv.begin(), bestv.begin() + wr, 0);
            const uint32_t want = epoch << 1;
            for (long row = 0; row < hr; row++) {
                const uint32_t* base = stamp.data() + (size_t)(row * wr);
                for (long col = 0; col < wr; col++) {
                    if (base[col] == (want | 1u)) curv[col]++;
                    else {
                        bestv[col] = std::max(bestv[col], curv[col]);
                        curv[col] = 0;
                    }
                }
            }
            for (long col = 0; col < wr; col++) {
                long best = bestv[col];
                if (best > 0) {
                    ACl.push_back(best);
                    ACang.push_back(ang);
                    if (!tcAny || best > tcBest) { tcBest = best; tcAny = true; }
                }
            }
        } else {
            for (long col = 0; col < wr; col += step) {
                long best = 0, cur = 0;
                for (long row = 0; row < hr; row++) {
                    uint32_t v = stamp[(size_t)(row * wr + col)];
                    if (v == ((epoch << 1) | 1u)) cur++;
                    else { best = std::max(best, cur); cur = 0; }
                }
                if (best > 0) {
                    ACl.push_back(best);
                    ACang.push_back(ang);
                    if (!tcAny || best > tcBest) { tcBest = best; tcAny = true; }
                }
            }
        }
        if (tcAny) { MCv.push_back(tcBest); MCang.push_back(ang); }
    }
    if (MCv.empty()) return;

    auto run_stats = [](const std::vector<long>& V,
                        const std::vector<double>& A,
                        const std::vector<long>& H, double* o) {
        double mean = 0;
        for (long v : V) mean += (double)v;
        mean /= (double)V.size();
        double ss = 0;
        for (long v : V) ss += ((double)v - mean) * ((double)v - mean);
        double stddev = V.size() > 2
                            ? std::sqrt(ss / (double)(V.size() - 1)) : 0.0;
        std::vector<long> sh(H);
        std::sort(sh.begin(), sh.end());
        size_t half = sh.size() / 2;
        double median = sh.size() % 2
                            ? (double)sh[half]
                            : ((double)sh[half - 1] + (double)sh[half]) / 2.0;
        // mode: first max over sorted unique values
        std::map<long, long> freq;
        for (long v : H) freq[v]++;
        long bestc = 0, mode = 0;
        for (auto& kv : freq)
            if (kv.second > bestc) { bestc = kv.second; mode = kv.first; }
        size_t imin = std::min_element(V.begin(), V.end()) - V.begin();
        size_t imax = std::max_element(V.begin(), V.end()) - V.begin();
        o[0] = (double)V[imax];
        o[1] = A[imax];
        o[2] = (double)V[imin];
        o[3] = A[imin];
        o[4] = median;
        o[5] = mean;
        o[6] = (double)mode;
        o[7] = stddev;
    };
    run_stats(MCv, MCang, MCv, out);
    // ALLCHORDS histogram quirk: un-cleared TrivialHistogram reuse means
    // mode/median run over MC + AC concatenated (chords.cpp:72-99)
    std::vector<long> MCplusAC(MCv);
    MCplusAC.insert(MCplusAC.end(), ACl.begin(), ACl.end());
    run_stats(ACl, ACang, MCplusAC, out + 8);
}

// ---------------------------------------------------------------------------
// Min enclosing circle (reference: circle.cpp:28-216, float32 math)

struct P2f { float x, y; };
static const float CEPS = 1.0e-4f;

static float nl2(float dx, float dy) { return std::sqrt(dx * dx + dy * dy); }

static void circle3(const P2f p[3], P2f& center, float& radius) {
    P2f v1{p[1].x - p[0].x, p[1].y - p[0].y};
    P2f v2{p[2].x - p[0].x, p[2].y - p[0].y};
    P2f mid1{(p[0].x + p[1].x) / 2.0f, (p[0].y + p[1].y) / 2.0f};
    float c1 = mid1.x * v1.x + mid1.y * v1.y;
    P2f mid2{(p[0].x + p[2].x) / 2.0f, (p[0].y + p[2].y) / 2.0f};
    float c2 = mid2.x * v2.x + mid2.y * v2.y;
    float det = v1.x * v2.y - v1.y * v2.x;
    if (std::fabs(det) <= CEPS) {
        float d1 = nl2(p[0].x - p[1].x, p[0].y - p[1].y),
              d2 = nl2(p[0].x - p[2].x, p[0].y - p[2].y),
              d3 = nl2(p[1].x - p[2].x, p[1].y - p[2].y);
        radius = std::sqrt(std::max(d1, std::max(d2, d3))) * 0.5f + CEPS;
        if (d1 >= d2 && d1 >= d3)
            center = {(p[0].x + p[1].x) * 0.5f, (p[0].y + p[1].y) * 0.5f};
        else if (d2 >= d1 && d2 >= d3)
            center = {(p[0].x + p[2].x) * 0.5f, (p[0].y + p[2].y) * 0.5f};
        else
            center = {(p[1].x + p[2].x) * 0.5f, (p[1].y + p[2].y) * 0.5f};
        return;
    }
    float cx = (c1 * v2.y - c2 * v1.y) / det;
    float cy = (v1.x * c2 - v2.x * c1) / det;
    center.x = cx;
    center.y = cy;
    cx -= p[0].x;
    cy -= p[0].y;
    radius = std::sqrt(cx * cx + cy * cy) + CEPS;
}

static void third_point(const double* px, const double* py, long i, long j,
                        P2f& center, float& radius) {
    center.x = (float)(px[j] + px[i]) / 2.0f;
    center.y = (float)(py[j] + py[i]) / 2.0f;
    float dx = (float)(px[j] - px[i]), dy = (float)(py[j] - py[i]);
    radius = nl2(dx, dy) / 2.0f + CEPS;
    for (long k = 0; k < j; k++) {
        dx = center.x - (float)px[k];
        dy = center.y - (float)py[k];
        if (nl2(dx, dy) < radius) continue;
        P2f pts[3] = {{(float)px[i], (float)py[i]},
                      {(float)px[j], (float)py[j]},
                      {(float)px[k], (float)py[k]}};
        P2f nc;
        float nr = 0;
        circle3(pts, nc, nr);
        if (nr > 0) { radius = nr; center = nc; }
    }
}

static void second_point(const double* px, const double* py, long i,
                         P2f& center, float& radius) {
    center.x = (float)(px[0] + px[i]) / 2.0f;
    center.y = (float)(py[0] + py[i]) / 2.0f;
    float dx = (float)(px[0] - px[i]), dy = (float)(py[0] - py[i]);
    radius = nl2(dx, dy) / 2.0f + CEPS;
    for (long j = 1; j < i; j++) {
        dx = center.x - (float)px[j];
        dy = center.y - (float)py[j];
        if (nl2(dx, dy) < radius) continue;
        P2f nc;
        float nr = 0;
        third_point(px, py, i, j, nc, nr);
        if (nr > 0) { radius = nr; center = nc; }
    }
}

double nyx_min_enclosing_circle_diam(const double* px, const double* py,
                                     long n) {
    if (n == 0) return 0.0;
    if (n == 1) return 2.0 * (double)CEPS;
    if (n == 2) {
        float dx = (float)px[0] - (float)px[1], dy = (float)py[0] - (float)py[1];
        return 2.0 * (double)(nl2(dx, dy) / 2.0f + CEPS);
    }
    P2f center{(float)(px[0] + px[1]) / 2.0f, (float)(py[0] + py[1]) / 2.0f};
    float dx = (float)(px[0] - px[1]), dy = (float)(py[0] - py[1]);
    float radius = nl2(dx, dy) / 2.0f + CEPS;
    for (long i = 2; i < n; i++) {
        dx = (float)px[i] - center.x;
        dy = (float)py[i] - center.y;
        if (nl2(dx, dy) < radius) continue;
        P2f nc;
        float nr = 0;
        second_point(px, py, i, nc, nr);
        if (nr > 0) { radius = nr; center = nc; }
    }
    return 2.0 * (double)radius;
}

// ---------------------------------------------------------------------------
// Batched entry points: concatenated per-ROI arrays + offsets; a small
// thread pool splits ROIs (disjoint output rows, no synchronization).

typedef void (*hull_fn)(const double*, const double*, long, double*);

static void run_hull_family(hull_fn fn, const double* hx, const double* hy,
                            const int64_t* offsets, long n_rois, double* out,
                            long out_w, int n_threads) {
    auto worker = [&](long lo, long hi) {
        for (long r = lo; r < hi; r++) {
            long a = offsets[r], b = offsets[r + 1];
            if (b - a <= 0) continue;
            fn(hx + a, hy + a, b - a, out + r * out_w);
        }
    };
    if (n_threads <= 1 || n_rois < 4) {
        worker(0, n_rois);
        return;
    }
    std::vector<std::thread> ts;
    long chunk = (n_rois + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        long lo = t * chunk, hi = std::min(n_rois, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
}

void nyx_caliper_feret(const double* hx, const double* hy,
                       const int64_t* offsets, long n_rois, double* out,
                       int n_threads) {
    run_hull_family(nyx_caliper_feret_one, hx, hy, offsets, n_rois, out, 8,
                    n_threads);
}

void nyx_caliper_martin(const double* hx, const double* hy,
                        const int64_t* offsets, long n_rois, double* out,
                        int n_threads) {
    run_hull_family(nyx_caliper_martin_one, hx, hy, offsets, n_rois, out, 6,
                    n_threads);
}

void nyx_caliper_nassenstein(const double* hx, const double* hy,
                             const int64_t* offsets, long n_rois, double* out,
                             int n_threads) {
    run_hull_family(nyx_caliper_nassenstein_one, hx, hy, offsets, n_rois, out,
                    6, n_threads);
}

void nyx_chords(const int64_t* gx, const int64_t* gy, const double* inten,
                const int64_t* offsets, const int64_t* aabbs /* [n,4] */,
                long n_rois, double* out /* [n,16] */, int n_threads) {
    auto worker = [&](long lo, long hi) {
        for (long r = lo; r < hi; r++) {
            long a = offsets[r], b = offsets[r + 1];
            if (b - a <= 0) continue;
            nyx_chords_one(gx + a, gy + a, inten + a, b - a, aabbs[r * 4],
                           aabbs[r * 4 + 1], aabbs[r * 4 + 2],
                           aabbs[r * 4 + 3], out + r * 16);
        }
    };
    if (n_threads <= 1 || n_rois < 4) {
        worker(0, n_rois);
        return;
    }
    std::vector<std::thread> ts;
    long chunk = (n_rois + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        long lo = t * chunk, hi = std::min(n_rois, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
}

void nyx_min_enclosing_circles(const double* px, const double* py,
                               const int64_t* offsets, long n_rois,
                               double* out, int n_threads) {
    auto worker = [&](long lo, long hi) {
        for (long r = lo; r < hi; r++) {
            long a = offsets[r], b = offsets[r + 1];
            out[r] = nyx_min_enclosing_circle_diam(px + a, py + a, b - a);
        }
    };
    if (n_threads <= 1 || n_rois < 4) {
        worker(0, n_rois);
        return;
    }
    std::vector<std::thread> ts;
    long chunk = (n_rois + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        long lo = t * chunk, hi = std::min(n_rois, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
