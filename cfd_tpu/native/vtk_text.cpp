// Native text formatter for the legacy-VTK ASCII writer.
//
// Native equivalent of the reference's C++ I/O layer (VTKWriter,
// cavity-01.cpp:95-300): the device computes, the host formats. At the
// 2048^2 benchmark scale a snapshot is ~30M formatted values; Python-side
// numpy string formatting is 10-50x slower than this tight snprintf loop,
// and snprintf guarantees byte parity with the C++ iostream fixed<<6 output
// the golden files were produced with.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).
//
// "%.6f" of a double can be up to ~320 bytes (1e308 has 309 integral
// digits), far beyond the ~40-byte common case the caller sizes its buffer
// for. Each value is therefore formatted into a local scratch buffer first
// and copied only if it fits in the remaining capacity; on overflow the
// functions return -1 and the Python wrapper retries with worst-case slots.

#include <cstdio>
#include <cstring>

namespace {
constexpr long kScratch = 352;  // > sign + 309 digits + '.' + 6 + '\n' + NUL
}

extern "C" {

// Format n doubles as "%.6f\n" lines into out (cap = caller's buffer size).
// Where literal_mask[i] != 0 the reference streams the bare literal "0.0"
// instead (backwards_step-01.cpp:160,196,220,233). Returns bytes written,
// or -1 if the output would not fit in cap.
long fmt_scalar_fixed6(const double* x, long n, const unsigned char* literal_mask,
                       char* out, long cap) {
    char* w = out;
    char tmp[kScratch];
    for (long i = 0; i < n; ++i) {
        if (literal_mask && literal_mask[i]) {
            if (w - out + 4 > cap) return -1;
            std::memcpy(w, "0.0\n", 4);
            w += 4;
        } else {
            long r = std::snprintf(tmp, kScratch, "%.6f\n", x[i]);
            if (r < 0 || r >= kScratch || w - out + r > cap) return -1;
            std::memcpy(w, tmp, (size_t)r);
            w += r;
        }
    }
    return (long)(w - out);
}

// Vector rows "u v 0.0\n"; masked rows are the literal "0.0 0.0 0.0\n"
// (backwards_step-01.cpp:160-163).
long fmt_vector_fixed6(const double* u, const double* v, long n,
                       const unsigned char* literal_mask, char* out, long cap) {
    char* w = out;
    char tmp[2 * kScratch];
    for (long i = 0; i < n; ++i) {
        if (literal_mask && literal_mask[i]) {
            if (w - out + 12 > cap) return -1;
            std::memcpy(w, "0.0 0.0 0.0\n", 12);
            w += 12;
        } else {
            long r = std::snprintf(tmp, 2 * kScratch, "%.6f %.6f 0.0\n", u[i], v[i]);
            if (r < 0 || r >= 2 * kScratch || w - out + r > cap) return -1;
            std::memcpy(w, tmp, (size_t)r);
            w += r;
        }
    }
    return (long)(w - out);
}

}  // extern "C"
