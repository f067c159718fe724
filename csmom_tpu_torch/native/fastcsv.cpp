// Fast CSV price-bar parser: the host-side ingest hot loop of
// csmom_tpu_torch (a copy of the JAX package's csmom_tpu/native/fastcsv.cpp,
// so each package builds its own).
//
// The reference demo's ingest is pandas read_csv plus defensive column
// renaming.  This parser covers the hot ingest path — fixed-layout price
// CSVs (a timestamp first column, numeric columns after) in either cache
// dialect — in a single pass with zero Python-object churn, feeding numpy
// buffers directly.
//
// Contract (mirrors csmom_tpu_torch/panel/ingest.py::read_price_csv, and
// is held cell for cell against the pandas engine, a CSV fuzzer included,
// by tests/test_torch_ingest.py):
//   - rows whose first cell (after unquoting/trimming) does not start with
//     a digit are preamble/junk and are skipped (dialect A junk ticker
//     row, dialect B Ticker/Date rows, the header itself);
//   - timestamps: "YYYY-MM-DD", optionally " HH:MM[:SS[.frac]]",
//     optionally a "+HH:MM"/"-HH:MM" UTC offset (normalized to UTC) — the
//     formats yfinance caches actually contain.  The whole cell must
//     parse (pandas' to_datetime(errors='coerce') semantics: trailing
//     junk -> dropped row, not a half-parsed date);
//   - cells split on commas OUTSIDE double quotes (RFC-4180 quoting, the
//     part of it price CSVs can contain; embedded newlines unsupported);
//   - empty/unparseable numeric cells become NaN; the whole cell must
//     parse (strtod prefix-parses "12abc" to 12, pandas' to_numeric
//     coerces it to NaN — full consumption keeps the engines identical);
//   - short rows are padded with NaN, long rows truncated to n_cols.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// days from civil date to days since 1970-01-01 (Howard Hinnant's algorithm)
inline int64_t days_from_civil(int y, int m, int d) {
    y -= m <= 2;
    const int era_base = (y >= 0 ? y : y - 399) / 400;
    const unsigned yoe = static_cast<unsigned>(y - era_base * 400);
    const unsigned doy = (153u * (m + (m > 2 ? -3 : 9)) + 2u) / 5u + d - 1u;
    const unsigned doe = yoe * 365u + yoe / 4u - yoe / 100u + doy;
    return static_cast<int64_t>(era_base) * 146097 + static_cast<int64_t>(doe) - 719468;
}

// parse up to `width` digits; returns -1 on non-digit
inline int parse_digits(const char*& p, const char* end, int width) {
    int v = 0, n = 0;
    while (p < end && n < width && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
        ++n;
    }
    return n ? v : -1;
}

// Cell trimming with pandas' quote semantics: a double quote is special
// ONLY at field start (its C parser treats mid-field quotes as literal
// text).  Strip trailing CR/spaces, then one wrapping quote pair if the
// field begins with a quote, then surrounding spaces.
inline void trim_cell(const char*& s, const char*& end) {
    while (end > s && (end[-1] == '\r' || end[-1] == ' ')) --end;
    if (end - s >= 2 && *s == '"' && end[-1] == '"') {
        ++s;
        --end;
    }
    while (s < end && *s == ' ') ++s;
    while (end > s && end[-1] == ' ') --end;
}

// next field separator; a field OPENING with a double quote protects
// commas until its closing quote ("" escapes a literal quote), matching
// pandas' parser — a quote later in the field is literal and protects
// nothing
inline const char* next_sep(const char* p, const char* line_end) {
    if (p < line_end && *p == '"') {
        const char* q = p + 1;
        while (q < line_end) {
            if (*q == '"') {
                if (q + 1 < line_end && q[1] == '"') {
                    q += 2;  // escaped quote
                    continue;
                }
                ++q;  // closing quote
                break;
            }
            ++q;
        }
        p = q;
    }
    const char* c = static_cast<const char*>(memchr(p, ',', line_end - p));
    return c ? c : line_end;
}

// calendar-valid day count (pandas to_datetime rejects e.g. Feb 31)
inline int days_in_month(int y, int m) {
    static const int dm[] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
    if (m == 2)
        return ((y % 4 == 0 && y % 100 != 0) || y % 400 == 0) ? 29 : 28;
    return dm[m - 1];
}

// timestamp cell -> epoch nanoseconds (UTC); returns false unless the
// whole cell is a date (pandas to_datetime coerce semantics)
bool parse_timestamp(const char* s, const char* end, int64_t* out_ns) {
    const char* p = s;
    int y = parse_digits(p, end, 4);
    if (y < 1000 || p >= end || *p != '-') return false;
    ++p;
    int mo = parse_digits(p, end, 2);
    if (mo < 1 || mo > 12 || p >= end || *p != '-') return false;
    ++p;
    int d = parse_digits(p, end, 2);
    if (d < 1 || d > days_in_month(y, mo)) return false;

    int64_t sec = days_from_civil(y, mo, d) * 86400;
    int64_t frac_ns = 0;
    if (p < end && (*p == ' ' || *p == 'T')) {
        ++p;
        int hh = parse_digits(p, end, 2);
        if (hh < 0 || hh > 23 || p >= end || *p != ':') return false;
        ++p;
        int mi = parse_digits(p, end, 2);
        if (mi < 0 || mi > 59) return false;
        int ss = 0;
        if (p < end && *p == ':') {
            ++p;
            ss = parse_digits(p, end, 2);
            if (ss < 0 || ss > 59) return false;
        }
        sec += hh * 3600 + mi * 60 + ss;
        // fractional seconds, kept at ns precision (pandas keeps them too;
        // dropping them would silently desynchronize the two engines)
        if (p < end && *p == '.') {
            ++p;
            int64_t scale = 100000000;  // first digit is 1e8 ns
            bool any = false;
            while (p < end && *p >= '0' && *p <= '9') {
                if (scale > 0) {
                    frac_ns += (*p - '0') * scale;
                    scale /= 10;
                }
                ++p;
                any = true;
            }
            if (!any) return false;
        }
        // UTC offset (strict: out-of-range offsets are not timestamps)
        if (p < end && (*p == '+' || *p == '-')) {
            int sign = (*p == '-') ? -1 : 1;
            ++p;
            int oh = parse_digits(p, end, 2);
            if (oh < 0 || oh > 23) return false;
            int om = 0;
            if (p < end && *p == ':') {
                ++p;
                om = parse_digits(p, end, 2);
                if (om < 0 || om > 59) return false;
            }
            sec -= sign * (oh * 3600 + om * 60);
        }
    }
    if (p != end) return false;  // trailing junk -> not a timestamp
    *out_ns = sec * 1000000000LL + frac_ns;
    return true;
}

// one numeric cell [s, end) -> double (NaN on empty/garbage).  The whole
// cell must be consumed: strtod prefix-parses ("12abc" -> 12) where
// pandas' to_numeric coerces to NaN, and strtod accepts hex ("0x1f")
// where pandas does not — both are rejected here for engine parity.
inline double parse_cell(const char* s, const char* end) {
    trim_cell(s, end);
    if (s >= end) return NAN;
    char buf[64];
    size_t n = static_cast<size_t>(end - s);
    if (n >= sizeof(buf)) return NAN;
    memcpy(buf, s, n);
    buf[n] = '\0';
    for (const char* h = buf; *h; ++h)
        if (*h == 'x' || *h == 'X') return NAN;  // hex (strtod-only) -> NaN
    char* q = nullptr;
    double v = strtod(buf, &q);
    if (q == buf) return NAN;
    while (*q == ' ') ++q;
    if (*q != '\0') return NAN;
    return v;
}

}  // namespace

extern "C" {

// Upper bound on data rows (= newline count); -1 if the file can't be read.
long long fastcsv_count_rows(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long long lines = 0;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0)
        for (size_t i = 0; i < got; ++i)
            if (buf[i] == '\n') ++lines;
    fclose(f);
    return lines + 1;
}

// Parse `path` into epoch_ns[max_rows] and values[max_rows * n_cols]
// (row-major).  Returns the number of data rows written, or -1 on I/O
// error.  Preamble rows (first cell not starting with a digit) and '#'
// comment lines are skipped.
long long fastcsv_parse(const char* path, long long max_rows, int n_cols,
                        int64_t* epoch_ns, double* values) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* data = static_cast<char*>(malloc(static_cast<size_t>(sz) + 1));
    if (!data) {
        fclose(f);
        return -1;
    }
    size_t got = fread(data, 1, static_cast<size_t>(sz), f);
    fclose(f);
    data[got] = '\0';

    long long rows = 0;
    const char* p = data;
    const char* file_end = data + got;
    while (p < file_end && rows < max_rows) {
        const char* line_end = static_cast<const char*>(memchr(p, '\n', file_end - p));
        if (!line_end) line_end = file_end;

        if (p < line_end && *p != '#') {
            const char* cell_end = next_sep(p, line_end);
            const char* ts = p;
            const char* ts_end = cell_end;
            trim_cell(ts, ts_end);  // pandas unquotes before parsing dates
            int64_t ns;
            if (ts < ts_end && *ts >= '0' && *ts <= '9' &&
                parse_timestamp(ts, ts_end, &ns)) {
                epoch_ns[rows] = ns;
                double* row = values + rows * n_cols;
                const char* q = (cell_end < line_end) ? cell_end + 1 : line_end;
                for (int c = 0; c < n_cols; ++c) {
                    if (q > line_end) {
                        row[c] = NAN;
                        continue;
                    }
                    const char* next = next_sep(q, line_end);
                    row[c] = parse_cell(q, next);
                    q = next + 1;
                }
                ++rows;
            }
        }
        p = line_end + 1;
    }
    free(data);
    return rows;
}

}  // extern "C"
