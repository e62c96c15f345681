// Host-side CSV ingest for the PyTorch port: a byte scan of the observation
// CSVs that utils/io.get_data reads, in place of Python's csv module.
//
// Copied from the JAX package's native library
// (bayesian_inference_trpl_tpu/native/src/trpl_native.cpp:34-88,
// trpl_count_rows and trpl_parse_obs_csv).  Its OpenMP weighted histograms
// are the CUDA kernels of csrc/hist_kernel.cu here; its fused weighted
// moments are not copied (the JAX package calls them from its tests only).
//
// Plain C ABI, built by native/__init__.py with the host compiler into
// build/ and loaded with ctypes.  Host code: no CUDA.
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {

// Number of '\n' bytes in the file plus one (a last line may have none),
// an upper bound on the rows trpl_parse_obs_csv writes; -1 if the file
// cannot be opened.
long trpl_count_rows(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long rows = 0;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof buf, f)) > 0) {
        for (size_t i = 0; i < got; ++i)
            if (buf[i] == '\n') ++rows;
    }
    fclose(f);
    return rows + 1;
}

// Parses a 3-column observation CSV (t, PL, sigma) up to its "END"
// sentinel row, skipping blank lines, into t/pl/unc (each sized by
// trpl_count_rows).  Every value goes through strtod, which rounds
// correctly, as Python's float() does.  Returns the rows parsed, -1 if
// the file cannot be read, -2 if a row's first or second field is not a
// number (a header row, say).
long trpl_parse_obs_csv(const char* path, double* t, double* pl, double* unc) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> data(size + 1);
    if (fread(data.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return -1;
    }
    fclose(f);
    data[size] = '\0';

    long n = 0;
    char* p = data.data();
    char* end = data.data() + size;
    while (p < end) {
        while (p < end && (*p == '\n' || *p == '\r')) ++p;  // blank lines
        if (p >= end) break;
        if (p[0] == 'E' && p[1] == 'N' && p[2] == 'D') break;  // sentinel
        char* q;
        double tv = strtod(p, &q);
        if (q == p) return -2;
        p = q;
        if (*p == ',') ++p;
        double pv = strtod(p, &q);
        if (q == p) return -2;
        p = q;
        if (*p == ',') ++p;
        double uv = strtod(p, &q);
        p = (q == p) ? p : q;
        while (p < end && *p != '\n') ++p;  // to the end of the line
        t[n] = tv;
        pl[n] = pv;
        unc[n] = uv;
        ++n;
    }
    return n;
}

}  // extern "C"
