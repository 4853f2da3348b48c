// Copied verbatim from nyxus_tpu/native/src/csv_writer.cpp; pinned by tests/test_torch_tables.py.
// Native CSV feature-table writer.
//
// Equivalent role to the reference's CSV output stage
// (reference: src/nyx/output_2_csv.cpp save_features_2_csv): streams rows of
// (string prefix columns + double feature values) to disk without Python
// string formatting overhead.  Rows are FORMATTED on a small thread pool
// (snprintf of ~750 doubles per row dominates; a 300x747 slide costs ~70 ms
// single-threaded) into per-row buffers, then written sequentially.  Whole
// numbers take a fast integer path.  The caller-provided NAN/unassigned
// substitution text replaces NaN / -0.0 cells.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

void format_row(const char* prefix, const double* row, int64_t ncols,
                const char* fmt, bool shortest, const char* noval_text,
                int sub_negzero, std::string& out) {
    out.clear();
    if (prefix) out += prefix;
    char buf[64];
    for (int64_t c = 0; c < ncols; c++) {
        out += ',';
        double v = row[c];
        // unassigned sentinel: negative zero (roi_cache.h:17) or NaN
        if (std::isnan(v) || (sub_negzero && v == 0.0 && std::signbit(v))) {
            out += noval_text;
        } else if (v == (double)(long long)v && std::fabs(v) < 1e15) {
            // whole numbers (areas, counts, bbox, many zeros): fast itoa
            long long iv = (long long)v;
            if (iv == 0) {
                if (std::signbit(v)) out += "-0";
                else out += '0';
                continue;
            }
            char tmp[24];
            int n = 0;
            bool neg = iv < 0;
            unsigned long long u = neg ? -(unsigned long long)iv : iv;
            while (u) { tmp[n++] = '0' + (int)(u % 10); u /= 10; }
            if (neg) out += '-';
            while (n) out += tmp[--n];
        } else if (shortest) {
            // full-precision mode: shortest exact round-trip repr
            // (std::to_chars, ~8x faster than snprintf "%.17g" and never
            // loses a bit).  Floating-point to_chars needs libstdc++ from
            // GCC 11+; older toolchains fall back to %.17g so the whole
            // native library still builds.
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
            auto r = std::to_chars(buf, buf + sizeof buf, v);
            out.append(buf, (size_t)(r.ptr - buf));
#else
            int n = std::snprintf(buf, sizeof buf, "%.17g", v);
            out.append(buf, (size_t)n);
#endif
        } else {
            int n = std::snprintf(buf, sizeof buf, fmt, v);
            out.append(buf, (size_t)n);
        }
    }
    out += '\n';
}

}  // namespace

extern "C" {

// Write (or append to) a CSV file.  Args as before; precision selects
// "%.<precision>g" (the reference's CSV stage prints "%g" = 6,
// output_2_csv.cpp:225).  n_threads_req <= 0 means hardware concurrency.
// Rows are formatted+flushed in fixed-size chunks so peak memory stays
// bounded on 10^5+-ROI whole-slide tables.  Returns 0 on success.
int nyxcsv_write(const char* path, const char* header,
                 const char** row_prefixes, const double* values,
                 int64_t nrows, int64_t ncols, const char* noval_text,
                 int append, int precision, int sub_negzero,
                 int n_threads_req) {
    char fmt[16];
    std::snprintf(fmt, sizeof fmt, "%%.%dg", precision > 0 ? precision : 6);
    // precision >= 17 requests full double fidelity: use the shortest
    // exact round-trip representation instead of fixed 17 digits
    bool shortest = precision >= 17;
    FILE* f = std::fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    if (header && !append) {
        std::fputs(header, f);
        std::fputc('\n', f);
    }
    const int64_t CHUNK = 4096;
    int hw = n_threads_req > 0 ? n_threads_req
                               : (int)std::thread::hardware_concurrency();
    int n_threads = hw > 1 && nrows >= 16 ? hw : 1;
    std::vector<std::string> rows(
        (size_t)(nrows < CHUNK ? nrows : CHUNK));
    for (int64_t base = 0; base < nrows; base += CHUNK) {
        int64_t cn = nrows - base < CHUNK ? nrows - base : CHUNK;
        auto worker = [&](int t) {
            for (int64_t r = t; r < cn; r += n_threads)
                format_row(row_prefixes ? row_prefixes[base + r] : nullptr,
                           values + (base + r) * ncols, ncols, fmt, shortest,
                           noval_text, sub_negzero, rows[(size_t)r]);
        };
        if (n_threads == 1) {
            worker(0);
        } else {
            std::vector<std::thread> ts;
            for (int t = 0; t < n_threads; t++) ts.emplace_back(worker, t);
            for (auto& t : ts) t.join();
        }
        for (int64_t r = 0; r < cn; r++)
            std::fwrite(rows[(size_t)r].data(), 1, rows[(size_t)r].size(), f);
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
