// Fast integral-file parsing for pymes_tpu_torch (host code).
//
// The port's own copy of the JAX package's record parser: the hot text
// parsing of FCIDUMP/TCDUMP dumps (millions of "value i j k l [m n]"
// records) runs in C++ and returns packed arrays through a minimal C ABI
// consumed via ctypes.  The reference delegated bulk I/O to CTF's parallel
// read/write (pymes/util/fcidump.py:25, tcdump.py:14).
//
// Build: g++ -O3 -shared -fPIC pymes_tpu_torch/csrc/io_native.cpp -o
//        build/host_native/libio_native.so   (driven by
//        pymes_tpu_torch/_native.py at first use)

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse whitespace-separated records of (double, k ints) from `text`.
// Returns the number of records parsed; fills vals[n] and idx[n*k].
// cap is the maximum number of records the output buffers hold.
int64_t parse_records(const char* text, int64_t len, int32_t ints_per_rec,
                      double* vals, int64_t* idx, int64_t cap) {
    const char* p = text;
    const char* end = text + len;
    int64_t n = 0;
    while (p < end && n < cap) {
        // skip whitespace
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                           *p == '\r')) p++;
        if (p >= end) break;
        // copy the token into a small buffer, translating Fortran 'D'/'d'
        // exponents (1.0D-5) that strtod does not understand
        char buf[64];
        int64_t t = 0;
        const char* q = p;
        while (q < end && t < 63 && *q != ' ' && *q != '\n' && *q != '\t' &&
               *q != '\r') {
            char c = *q++;
            if (c == 'D' || c == 'd') c = 'e';
            buf[t++] = c;
        }
        buf[t] = '\0';
        char* next = nullptr;
        double v = strtod(buf, &next);
        if (next != buf + t) break;  // malformed token: stop, caller checks
        p = q;
        bool ok = true;
        for (int32_t k = 0; k < ints_per_rec; ++k) {
            while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                               *p == '\r')) p++;
            char* nx = nullptr;
            long long iv = strtoll(p, &nx, 10);
            if (nx == p) { ok = false; break; }
            idx[n * ints_per_rec + k] = (int64_t)iv;
            p = nx;
        }
        if (!ok) break;
        vals[n] = v;
        n++;
    }
    return n;
}

// Count whitespace-separated tokens (to size buffers: records = tokens /
// (1 + ints_per_rec)).
int64_t count_tokens(const char* text, int64_t len) {
    const char* p = text;
    const char* end = text + len;
    int64_t n = 0;
    bool in_tok = false;
    while (p < end) {
        bool ws = (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r');
        if (!ws && !in_tok) { n++; in_tok = true; }
        else if (ws) in_tok = false;
        p++;
    }
    return n;
}

}  // extern "C"
