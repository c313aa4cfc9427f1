// Native point-cloud text parser and streaming voxel accumulator — the
// ingestion path of the PyTorch port (io/native.py), a copy of the JAX
// package's native/pointio.cpp so that the port builds and loads its own.
//
// Built at first use by io/native.py:
//   g++ -O3 -shared -fPIC -o pyqsm_tpu_torch/_build/libpointio_<hash>.so pointio.cpp

#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>

namespace {
inline bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == ',';
}
}  // namespace

extern "C" {

// Parse whitespace-separated numeric text into a row-major double buffer.
// buf/len: input text; n_cols: expected columns per row (rows with fewer
// are dropped, extra columns are ignored); out: [max_rows * n_cols];
// returns number of complete rows parsed. Uses std::from_chars — no locale,
// ~5x faster than strtod.
int64_t parse_xyz(const char* buf, int64_t len, int32_t n_cols,
                  double* out, int64_t max_rows) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t row = 0;
    while (p < end && row < max_rows) {
        while (p < end && is_ws(*p)) ++p;
        if (p >= end) break;
        if (*p == '#' || *p == '/') {
            while (p < end && *p != '\n') ++p;
            continue;
        }
        int32_t col = 0;
        double* dst = out + row * n_cols;
        bool bad = false;
        while (col < n_cols) {
            double v;
            auto res = std::from_chars(p, end, v);
            if (res.ec != std::errc()) { bad = true; break; }
            dst[col++] = v;
            p = res.ptr;
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == ',')) ++p;
            if (col < n_cols && (p >= end || *p == '\n')) { bad = true; break; }
        }
        while (p < end && *p != '\n') ++p;
        if (!bad && col == n_cols) ++row;
    }
    return row;
}

// Count complete rows with >= n_cols numeric fields (for pre-allocation).
int64_t count_rows(const char* buf, int64_t len) {
    int64_t rows = 0;
    bool in_line = false;
    for (int64_t i = 0; i < len; ++i) {
        char c = buf[i];
        if (c == '\n') { if (in_line) ++rows; in_line = false; }
        else if (!is_ws(c) && c != 0x23) in_line = true;
    }
    if (in_line) ++rows;
    return rows;
}

// Voxel-downsample accumulation on the host during streaming ingestion:
// given points [n,3], bin into cells of size `voxel` relative to origin,
// and accumulate (sum, count) into a caller-provided open-addressing hash
// table (keys int64 packed 21-bit cells). Returns number of distinct
// occupied slots after insertion. Used by the tiled reader so raw scans
// never fully materialise in RAM.
int64_t voxel_accumulate(const double* pts, int64_t n, double voxel,
                         double ox, double oy, double oz,
                         int64_t* keys, double* sums, int64_t* counts,
                         int64_t table_size) {
    const int64_t EMPTY = INT64_MIN;
    int64_t occupied = 0;
    for (int64_t i = 0; i < n; ++i) {
        double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
        // floor (not truncate-toward-zero) to match the numpy path in
        // io/native.py: cells straddling the origin planes must not merge
        int64_t cx = (int64_t)std::floor((x - ox) / voxel);
        int64_t cy = (int64_t)std::floor((y - oy) / voxel);
        int64_t cz = (int64_t)std::floor((z - oz) / voxel);
        int64_t key = ((cx & 0x1FFFFF) << 42) | ((cy & 0x1FFFFF) << 21) | (cz & 0x1FFFFF);
        uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
        int64_t slot = (int64_t)(h % (uint64_t)table_size);
        while (true) {
            if (keys[slot] == EMPTY) {
                keys[slot] = key;
                ++occupied;
                break;
            }
            if (keys[slot] == key) break;
            slot = (slot + 1) % table_size;
        }
        sums[slot * 3] += x;
        sums[slot * 3 + 1] += y;
        sums[slot * 3 + 2] += z;
        counts[slot] += 1;
    }
    return occupied;
}

}  // extern "C"
