// Copied verbatim from nyxus_tpu/native/src/contour.cpp; pinned by tests/test_torch_tables.py.
// Multicontour build: Moore tracing + crossing removal + loop chaining.
// Exact port of the reference's buildRegularContour pipeline (reference:
// src/nyx/features/contour.cpp:306-680); semantics pinned by the Python
// implementation in nyxus_tpu/pipeline/contour.py, which remains the
// fallback and the parity oracle.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Pt {
    int x, y;
};

// dial ranks for tie-breaking (contour.cpp:344-380)
inline int dial(int dx, int dy) {
    if (dy == 0) {
        if (dx == 1) return 1;
        if (dx == -1) return 5;
        return 0;
    }
    if (dy == -1) {
        if (dx == 1) return 2;
        if (dx == 0) return 3;
        return 4;
    }
    // dy == 1
    if (dx == 1) return -1;
    if (dx == 0) return -2;
    return -3;
}

}  // namespace

extern "C" {

// mask: h*w uint8; inten: h*w int64 raw values.
// out: caller buffer for (x, y, inten) triples, capacity cap TRIPLES.
// Returns triple count (merged loops, loop order preserved), or -1 if the
// buffer is too small.
int nyx_contour(const uint8_t* mask, const int64_t* inten, int h, int w,
                int64_t* out, int cap) {
    const int W2 = w + 2, H2 = h + 2;
    const int n = W2 * H2;
    std::vector<int64_t> P(n, 0);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            if (mask[y * w + x])
                P[(y + 1) * W2 + (x + 1)] = inten[y * w + x] + 1;

    // ---- stage 1: Moore tracing (contour.cpp:407-470)
    std::vector<int64_t> border(n, 0);
    const int off[8] = {-1, -3 - w, -w - 2, -1 - w, 1, 3 + w, w + 2, 1 + w};
    const int nxt[8] = {7, 7, 1, 1, 3, 3, 5, 5};
    bool inside = false;
    for (int pos = 0; pos < n; pos++) {
        int64_t bi = border[pos];
        int64_t pi = P[pos];
        if (bi != 0 && !inside) {
            inside = true;
        } else if (pi != 0 && inside) {
            continue;
        } else if (pi == 0 && inside) {
            inside = false;
        } else if (pi != 0 && !inside) {
            border[pos] = pi;
            int check_nr = 1;
            int start_pos = pos;
            int counter = 0, counter2 = 0;
            int p = pos;
            while (true) {
                int check_pos = p + off[check_nr - 1];
                int new_check = nxt[check_nr - 1];
                if (check_pos >= n || check_pos < 0) break;
                if (P[check_pos] != 0) {
                    if (check_pos == start_pos) {
                        counter++;
                        if (new_check == 1 || counter >= 3) {
                            inside = true;
                            break;
                        }
                    }
                    check_nr = new_check;
                    p = check_pos;
                    counter2 = 0;
                    border[check_pos] = P[check_pos];
                } else {
                    check_nr = 1 + (check_nr % 8);
                    if (counter2 > 8) {
                        counter2 = 0;
                        break;
                    }
                    counter2++;
                }
            }
        }
    }

    // ---- stage 2: raster collection with the reference's bounds quirks
    struct CPix {
        int x, y;
        int64_t inten;
    };
    std::vector<CPix> C;
    auto B = [&](int x, int y) { return border[y * W2 + x]; };
    for (int y = 0; y < H2; y++)
        for (int x = 0; x < W2; x++) {
            int64_t inte = B(x, y);
            if (!inte) continue;
            bool has = false;
            if (x > 0) has = has || B(x - 1, y) != 0;
            if (!has && x < w - 1) has = B(x + 1, y) != 0;
            if (!has && y > 0) has = B(x, y - 1) != 0;
            if (!has && y < h - 1) has = B(x, y + 1) != 0;
            if (!has && x > 0 && y > 0) has = B(x - 1, y - 1) != 0;
            if (!has && x < w - 1 && y > 0) has = B(x + 1, y - 1) != 0;
            if (!has && x > 0 && y < h - 1) has = B(x - 1, y + 1) != 0;
            if (!has && x < w - 1 && y < h - 1) has = B(x + 1, y + 1) != 0;
            if (has) C.push_back({x, y, inte - 1});
        }
    if (C.empty()) return 0;

    // ---- stage 3: crossing removal (evolving set, raster order)
    std::vector<uint8_t> live(n, 0);
    for (auto& c : C) live[c.y * W2 + c.x] = 1;
    auto L = [&](int x, int y) -> uint8_t {
        return (x >= 0 && x < W2 && y >= 0 && y < H2) ? live[y * W2 + x] : 0;
    };
    for (auto& c : C) {
        if (L(c.x, c.y - 1) && L(c.x, c.y + 1) && L(c.x - 1, c.y) &&
            L(c.x + 1, c.y))
            live[c.y * W2 + c.x] = 0;
    }

    std::vector<CPix> order;  // C-order surviving pixels
    for (auto& c : C)
        if (live[c.y * W2 + c.x]) order.push_back(c);
    std::vector<int64_t> inten_of(n, 0);
    for (auto& c : order) inten_of[c.y * W2 + c.x] = c.inten;

    // ---- stage 4: chain into loops
    std::vector<uint8_t> remaining(n, 0);
    for (auto& c : order) remaining[c.y * W2 + c.x] = 1;
    int out_n = 0;
    size_t scan = 0;
    std::vector<Pt> S, Pstack;
    std::vector<uint8_t> inU(n);
    while (true) {
        while (scan < order.size() &&
               !remaining[order[scan].y * W2 + order[scan].x])
            scan++;
        if (scan >= order.size()) break;
        Pt origin{order[scan].x, order[scan].y};

        // U = all remaining; walk
        std::memcpy(inU.data(), remaining.data(), n);
        size_t u_count = 0;
        for (size_t k = scan; k < order.size(); k++)
            if (remaining[order[k].y * W2 + order[k].x]) u_count++;
        S.clear();
        Pstack.clear();
        S.push_back(origin);
        inU[origin.y * W2 + origin.x] = 0;
        u_count--;
        Pt tip = origin;
        long looplen = 0;
        bool loop_ok;
        auto inu = [&](int x, int y) -> bool {
            return x >= 0 && x < W2 && y >= 0 && y < H2 && inU[y * W2 + x];
        };
        while (u_count > 0) {
            static const int d4[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
            static const int d8[4][2] = {{1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
            Pt cands[4];
            int nc = 0;
            for (auto& d : d4)
                if (inu(tip.x + d[0], tip.y + d[1]))
                    cands[nc++] = {tip.x + d[0], tip.y + d[1]};
            if (nc == 0)
                for (auto& d : d8)
                    if (inu(tip.x + d[0], tip.y + d[1]))
                        cands[nc++] = {tip.x + d[0], tip.y + d[1]};
            if (nc > 1) {
                Pstack.push_back(tip);
                Pt best = cands[0];
                for (int k = 1; k < nc; k++) {
                    Pt c = cands[k];
                    if (dial(c.x - tip.x, c.y - tip.y) >
                        dial(best.x - tip.x, best.y - tip.y))
                        best = c;
                }
                cands[0] = best;
                nc = 1;
            }
            if (nc == 0) {
                int dx = tip.x - origin.x, dy = tip.y - origin.y;
                if (std::abs(dx) == 1 || std::abs(dy) == 1) {
                    loop_ok = true;
                    goto done_walk;
                }
                if (Pstack.empty()) {
                    loop_ok = false;
                    goto done_walk;
                }
                tip = Pstack.back();
                Pstack.pop_back();
                continue;
            }
            tip = cands[0];
            looplen++;
            S.push_back(tip);
            inU[tip.y * W2 + tip.x] = 0;
            u_count--;
        }
        loop_ok = (looplen > 0);
    done_walk:
        if (loop_ok) {
            if (out_n + (int)S.size() > cap) return -1;
            for (auto& s : S) {
                out[3 * out_n] = s.x;
                out[3 * out_n + 1] = s.y;
                out[3 * out_n + 2] = inten_of[s.y * W2 + s.x];
                out_n++;
            }
        }
        for (auto& s : S) remaining[s.y * W2 + s.x] = 0;
    }
    return out_n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Monotone-chain convex hull, exact port of
// nyxus_tpu/pipeline/hostfeats.py build_convex_hull (the Python fallback is
// the parity oracle; reference analog: vendored quickhull, convex_hull.h).

extern "C" int nyx_convex_hull(const int64_t* xs, const int64_t* ys, int npts,
                               double* out /* cap 2*(npts+4) doubles */) {
    if (npts < 2) {
        for (int i = 0; i < npts; i++) {
            out[2 * i] = (double)xs[i];
            out[2 * i + 1] = (double)ys[i];
        }
        return npts;
    }
    // lexsort by (x, then y)
    std::vector<int> ord(npts);
    for (int i = 0; i < npts; i++) ord[i] = i;
    std::sort(ord.begin(), ord.end(), [&](int a, int b) {
        if (xs[a] != xs[b]) return xs[a] < xs[b];
        return ys[a] < ys[b];
    });
    // per-column extremes (first/last of each x run)
    std::vector<Pt> pts;
    pts.reserve(npts);
    for (int k = 0; k < npts; k++) {
        bool first = (k == 0) || xs[ord[k]] != xs[ord[k - 1]];
        bool last = (k == npts - 1) || xs[ord[k]] != xs[ord[k + 1]];
        if (first || last)
            pts.push_back({(int)xs[ord[k]], (int)ys[ord[k]]});
    }
    int m = (int)pts.size();
    if (m < 2) {
        for (int i = 0; i < m; i++) {
            out[2 * i] = pts[i].x;
            out[2 * i + 1] = pts[i].y;
        }
        return m;
    }
    auto right_turn = [](const Pt& p1, const Pt& p2, const Pt& p3) {
        return ((double)(p3.x - p1.x) * (p2.y - p1.y) -
                (double)(p3.y - p1.y) * (p2.x - p1.x)) > 0;
    };
    std::vector<Pt> upper{pts[0], pts[1]};
    for (int i = 2; i < m; i++) {
        while (upper.size() > 1 &&
               !right_turn(upper[upper.size() - 2], upper.back(), pts[i]))
            upper.pop_back();
        upper.push_back(pts[i]);
    }
    std::vector<Pt> lower{pts[m - 1], pts[m - 2]};
    for (int i = 2; i < m; i++) {
        const Pt& p = pts[m - i - 1];
        while (lower.size() > 1 &&
               !right_turn(lower[lower.size() - 2], lower.back(), p))
            lower.pop_back();
        lower.push_back(p);
    }
    // hull = upper + (lower minus points already in upper), order preserved
    int k = 0;
    for (auto& p : upper) {
        out[2 * k] = p.x;
        out[2 * k + 1] = p.y;
        k++;
    }
    for (auto& p : lower) {
        bool seen = false;
        for (auto& u : upper)
            if (u.x == p.x && u.y == p.y) {
                seen = true;
                break;
            }
        if (!seen) {
            out[2 * k] = p.x;
            out[2 * k + 1] = p.y;
            k++;
        }
    }
    return k;
}

// ---------------------------------------------------------------------------
// Approximate min/max squared distance from each point to an ORDERED contour.
// Semantic port of the reference's coarse-to-fine sampling search
// (reference: src/nyx/features/pixel.cpp:36-71 min_sqdist v2 and :110-143
// max_sqdist v2).  The approximation is part of the numeric contract: the
// weighted geometric moments, ROI radius and radial-distribution center all
// consume these (possibly non-minimal) distances, so an exact scan would
// diverge from the reference's outputs.

static inline double approx_extreme_sqdist(double px, double py,
                                           const double* cx, const double* cy,
                                           long nc, bool want_max) {
    auto sq = [&](long i) {
        double dx = px - cx[i], dy = py - cy[i];
        return dx * dx + dy * dy;
    };
    if (nc == 0) return 0.0;
    long a = 0, b = nc;
    double ext_d = sq(0);
    long ext_i = 0;
    if (nc == 1) return ext_d;
    long step = (long)((double)(b - a) / std::log((double)(b - a)));
    if (step < 1) step = 1;
    do {
        for (long i = a + step; i < b; i += step) {
            double d = sq(i);
            if (want_max ? (ext_d < d) : (ext_d > d)) {
                ext_d = d;
                ext_i = i;
            }
        }
        long stepL = ext_i >= step ? step : ext_i;
        long stepR = ext_i + step < nc ? step : nc - ext_i;
        a = ext_i - stepL;
        b = ext_i + stepR;
        step = (b - a) <= 10 ? 1
                             : (long)((double)(b - a) / std::log((double)(b - a)));
        if (step < 1) step = 1;
    } while (b - a > 2);
    return ext_d;
}

extern "C" void nyx_contour_sqdist_approx(const double* px, const double* py,
                                          long n, const double* cx,
                                          const double* cy, long nc,
                                          double* out_min, double* out_max) {
    for (long i = 0; i < n; i++) {
        if (out_min) out_min[i] = approx_extreme_sqdist(px[i], py[i], cx, cy,
                                                        nc, false);
        if (out_max) out_max[i] = approx_extreme_sqdist(px[i], py[i], cx, cy,
                                                        nc, true);
    }
}

// ---------------------------------------------------------------------------
// Batched contour extraction: trace every ROI of a resident labeled slide in
// one call, fanned over a thread pool.  Replaces the per-ROI Python loop
// (crop + ctypes call per ROI) that dominated the contour pass.
//
// labels: [H, W] int32 slide; intens: [H, W] int64 raw values.
// recs: [n, 5] int64 (label, y0, x0, h, w) per ROI.
// caps: [n+1] int64 prefix offsets into out (capacity h*w+16 triples/ROI).
// out: concatenated (x, y, inten) triples; counts: [n] actual triple count.

extern "C" void nyx_contours_batch(const int32_t* labels,
                                   const int64_t* intens, long H, long W,
                                   const int64_t* recs, long n_rois,
                                   const int64_t* caps, int64_t* out,
                                   int64_t* counts, int n_threads) {
    auto worker = [&](long lo, long hi) {
        std::vector<uint8_t> mask;
        std::vector<int64_t> crop;
        for (long r = lo; r < hi; r++) {
            int64_t lab = recs[r * 5], y0 = recs[r * 5 + 1],
                    x0 = recs[r * 5 + 2], h = recs[r * 5 + 3],
                    w = recs[r * 5 + 4];
            mask.assign((size_t)(h * w), 0);
            crop.assign((size_t)(h * w), 0);
            for (long y = 0; y < h; y++) {
                const int32_t* lrow = labels + (y0 + y) * W + x0;
                const int64_t* irow = intens + (y0 + y) * W + x0;
                for (long x = 0; x < w; x++) {
                    if (lrow[x] == (int32_t)lab) {
                        mask[(size_t)(y * w + x)] = 1;
                        crop[(size_t)(y * w + x)] = irow[x];
                    }
                }
            }
            int cap = (int)(caps[r + 1] - caps[r]);
            int k = nyx_contour(mask.data(), crop.data(), (int)h, (int)w,
                                out + caps[r] * 3, cap);
            counts[r] = k < 0 ? 0 : k;
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
