// Copied verbatim from nyxus_tpu/native/src/discover.cpp; pinned by tests/test_torch_tables.py.
// Phase-1 label discovery + pixel-cloud assembly in one native pass.
//
// The reference streams tiles and updates per-label records pixel-by-pixel
// (reference: src/nyx/phase1.cpp:24-124, pixel_feed.cpp).  The numpy
// equivalent (pipeline/labels.py discover_rois + runner._build_clouds) costs
// ~20 ms per megapixel slide in unique/argsort passes; this kernel does both
// in two linear scans and also emits the concatenated per-label clouds in
// raster order that the batched geometry pass consumes.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

template <typename T>
void discover_impl(const int32_t* labels, const T* intens, long H, long W,
                   // outputs
                   std::vector<int64_t>& labs, std::vector<int64_t>& area,
                   std::vector<int64_t>& bbox /* y0,y1,x0,x1 per label */,
                   std::vector<double>& vmin, std::vector<double>& vmax,
                   double* slide_min, double* slide_max) {
    std::unordered_map<int32_t, int> index;
    index.reserve(1024);
    double smin = 0, smax = 0;
    bool any = false;
    for (long y = 0; y < H; y++) {
        const int32_t* lrow = labels + y * W;
        const T* irow = intens + y * W;
        for (long x = 0; x < W; x++) {
            int32_t lab = lrow[x];
            if (!lab) continue;
            double v = (double)irow[x];
            auto it = index.find(lab);
            int k;
            if (it == index.end()) {
                k = (int)labs.size();
                index.emplace(lab, k);
                labs.push_back(lab);
                area.push_back(0);
                bbox.insert(bbox.end(), {y, y, x, x});
                vmin.push_back(v);
                vmax.push_back(v);
            } else {
                k = it->second;
            }
            area[k]++;
            int64_t* bb = &bbox[(size_t)k * 4];
            if (y < bb[0]) bb[0] = y;
            if (y > bb[1]) bb[1] = y;
            if (x < bb[2]) bb[2] = x;
            if (x > bb[3]) bb[3] = x;
            if (v < vmin[k]) vmin[k] = v;
            if (v > vmax[k]) vmax[k] = v;
            if (!any) { smin = smax = v; any = true; }
            else { smin = std::min(smin, v); smax = std::max(smax, v); }
        }
    }
    *slide_min = smin;
    *slide_max = smax;
}

template <typename T>
void clouds_impl(const int32_t* labels, const T* intens, long H, long W,
                 const std::unordered_map<int32_t, int>& order,
                 std::vector<int64_t>& cursor, int64_t* gx, int64_t* gy,
                 double* gi) {
    for (long y = 0; y < H; y++) {
        const int32_t* lrow = labels + y * W;
        const T* irow = intens + y * W;
        for (long x = 0; x < W; x++) {
            int32_t lab = lrow[x];
            if (!lab) continue;
            int k = order.at(lab);
            int64_t c = cursor[k]++;
            gx[c] = x;
            gy[c] = y;
            gi[c] = (double)irow[x];
        }
    }
}

// persistent result between the two entry points (single-threaded protocol:
// call nyx_discover, read sizes, allocate, call nyx_discover_fetch)
struct DiscoverState {
    std::vector<int64_t> labs, area, bbox;
    std::vector<double> vmin, vmax;
    double smin, smax;
    long H, W;
};
thread_local DiscoverState g_state;

template <typename T>
int discover_dispatch(const int32_t* labels, const void* intens, long H,
                      long W) {
    g_state = DiscoverState();
    g_state.H = H;
    g_state.W = W;
    discover_impl<T>(labels, (const T*)intens, H, W, g_state.labs,
                     g_state.area, g_state.bbox, g_state.vmin, g_state.vmax,
                     &g_state.smin, &g_state.smax);
    return (int)g_state.labs.size();
}

}  // namespace

extern "C" {

// dtype codes: 0=u8 1=u16 2=u32 3=i32 4=f32 5=f64 6=i64
int nyx_discover(const int32_t* labels, const void* intens, int dtype,
                 long H, long W) {
    switch (dtype) {
        case 0: return discover_dispatch<uint8_t>(labels, intens, H, W);
        case 1: return discover_dispatch<uint16_t>(labels, intens, H, W);
        case 2: return discover_dispatch<uint32_t>(labels, intens, H, W);
        case 3: return discover_dispatch<int32_t>(labels, intens, H, W);
        case 4: return discover_dispatch<float>(labels, intens, H, W);
        case 5: return discover_dispatch<double>(labels, intens, H, W);
        case 6: return discover_dispatch<int64_t>(labels, intens, H, W);
    }
    return -1;
}

// Fills per-label records (sorted by ascending label) and, when cloud
// buffers are non-null, the concatenated raster-order clouds + offsets.
// recs: [n, 8] int64 (label, area, y0, y1, x0, x1, -, -); fmm: [n, 2] f64
// (vmin, vmax); extrema: [2] f64 slide (min, max).
int nyx_discover_fetch(const int32_t* labels, const void* intens, int dtype,
                       int64_t* recs, double* fmm, double* extrema,
                       int64_t* offsets /* [n+1] */, int64_t* gx, int64_t* gy,
                       double* gi) {
    DiscoverState& st = g_state;
    int n = (int)st.labs.size();
    std::vector<int> order(n);
    for (int i = 0; i < n; i++) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        return st.labs[a] < st.labs[b];
    });
    for (int i = 0; i < n; i++) {
        int k = order[i];
        recs[i * 8 + 0] = st.labs[k];
        recs[i * 8 + 1] = st.area[k];
        recs[i * 8 + 2] = st.bbox[(size_t)k * 4];
        recs[i * 8 + 3] = st.bbox[(size_t)k * 4 + 1];
        recs[i * 8 + 4] = st.bbox[(size_t)k * 4 + 2];
        recs[i * 8 + 5] = st.bbox[(size_t)k * 4 + 3];
        recs[i * 8 + 6] = 0;
        recs[i * 8 + 7] = 0;
        fmm[i * 2] = st.vmin[k];
        fmm[i * 2 + 1] = st.vmax[k];
    }
    extrema[0] = st.smin;
    extrema[1] = st.smax;
    if (offsets) {
        offsets[0] = 0;
        std::unordered_map<int32_t, int> sorted_index;
        sorted_index.reserve(n * 2);
        for (int i = 0; i < n; i++) {
            offsets[i + 1] = offsets[i] + st.area[order[i]];
            sorted_index.emplace((int32_t)st.labs[order[i]], i);
        }
        std::vector<int64_t> cursor(n);
        for (int i = 0; i < n; i++) cursor[i] = offsets[i];
        switch (dtype) {
            case 0: clouds_impl<uint8_t>(labels, (const uint8_t*)intens,
                                         st.H, st.W, sorted_index, cursor,
                                         gx, gy, gi); break;
            case 1: clouds_impl<uint16_t>(labels, (const uint16_t*)intens,
                                          st.H, st.W, sorted_index, cursor,
                                          gx, gy, gi); break;
            case 2: clouds_impl<uint32_t>(labels, (const uint32_t*)intens,
                                          st.H, st.W, sorted_index, cursor,
                                          gx, gy, gi); break;
            case 3: clouds_impl<int32_t>(labels, (const int32_t*)intens,
                                         st.H, st.W, sorted_index, cursor,
                                         gx, gy, gi); break;
            case 4: clouds_impl<float>(labels, (const float*)intens,
                                       st.H, st.W, sorted_index, cursor,
                                       gx, gy, gi); break;
            case 5: clouds_impl<double>(labels, (const double*)intens,
                                        st.H, st.W, sorted_index, cursor,
                                        gx, gy, gi); break;
            case 6: clouds_impl<int64_t>(labels, (const int64_t*)intens,
                                         st.H, st.W, sorted_index, cursor,
                                         gx, gy, gi); break;
        }
    }
    g_state = DiscoverState();
    return n;
}

}  // extern "C"
