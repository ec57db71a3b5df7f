// Host-side tiled-layout engine (C++, OpenMP) of slate_tpu_torch.
//
// The port's copy of slate_tpu/native/layout.cc: Matrix::fromLAPACK
// (Matrix.hh:58) and fromScaLAPACK (:73-96) layout adoption, and the
// scalapack_api descriptor decode (scalapack_slate.hh:27-29). PyTorch
// owns device memory; what remains native is the host-side repack
// between user layouts (column-major LAPACK, 2D-block-cyclic ScaLAPACK
// locals) and the package's padded row-major canonical form:
// bandwidth-bound loops that benefit from OpenMP and avoid numpy
// temporaries.
//
// Built by slate_tpu_torch.native (g++ -O3 -fopenmp -shared -fPIC, at
// first use, into build/); all entry points are extern "C" for ctypes.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

template <typename T>
void pack_colmajor(const T* src, int64_t m, int64_t n, int64_t ld,
                   T* dst, int64_t mpad, int64_t npad) {
  // column-major (m, n, leading dim ld) -> zero-padded row-major
  // (mpad, npad)
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < mpad; ++i) {
    T* drow = dst + i * npad;
    if (i < m) {
      for (int64_t j = 0; j < n; ++j) drow[j] = src[i + j * ld];
      if (n < npad) std::memset(drow + n, 0, sizeof(T) * (npad - n));
    } else {
      std::memset(drow, 0, sizeof(T) * npad);
    }
  }
}

template <typename T>
void unpack_colmajor(const T* src, int64_t mpad, int64_t npad, T* dst,
                     int64_t m, int64_t n, int64_t ld) {
  // padded row-major (mpad, npad) -> column-major (m, n, ld)
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < n; ++j) {
    T* dcol = dst + j * ld;
    for (int64_t i = 0; i < m; ++i) dcol[i] = src[i * npad + j];
  }
}

template <typename T>
void bc_import(const T* local, int64_t llm, int64_t lln, T* dst,
               int64_t m, int64_t n, int64_t npad, int64_t mb,
               int64_t nb, int64_t p, int64_t q, int64_t pi,
               int64_t qi) {
  // Scatter one rank's ScaLAPACK 2D-block-cyclic local array
  // (column-major, llm x lln) into the global padded row-major dense.
  // Global tile (ti, tj) lives on rank (ti % p, tj % q) at local tile
  // (ti / p, tj / q) — the BLACS descriptor decode of
  // scalapack_slate.hh:27-29.
  int64_t mt = (m + mb - 1) / mb;
  int64_t nt = (n + nb - 1) / nb;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t ti = 0; ti < mt; ++ti) {
    for (int64_t tj = 0; tj < nt; ++tj) {
      if (ti % p != pi || tj % q != qi) continue;
      int64_t li = (ti / p) * mb;   // local row offset
      int64_t lj = (tj / q) * nb;   // local col offset
      int64_t gi = ti * mb;
      int64_t gj = tj * nb;
      int64_t hm = (m - gi < mb) ? (m - gi) : mb;
      int64_t hn = (n - gj < nb) ? (n - gj) : nb;
      for (int64_t i = 0; i < hm; ++i) {
        for (int64_t j = 0; j < hn; ++j) {
          dst[(gi + i) * npad + (gj + j)] =
              local[(li + i) + (lj + j) * llm];
        }
      }
    }
  }
}

template <typename T>
void bc_export(const T* src, int64_t m, int64_t n, int64_t npad,
               T* local, int64_t llm, int64_t lln, int64_t mb,
               int64_t nb, int64_t p, int64_t q, int64_t pi,
               int64_t qi) {
  int64_t mt = (m + mb - 1) / mb;
  int64_t nt = (n + nb - 1) / nb;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t ti = 0; ti < mt; ++ti) {
    for (int64_t tj = 0; tj < nt; ++tj) {
      if (ti % p != pi || tj % q != qi) continue;
      int64_t li = (ti / p) * mb;
      int64_t lj = (tj / q) * nb;
      int64_t gi = ti * mb;
      int64_t gj = tj * nb;
      int64_t hm = (m - gi < mb) ? (m - gi) : mb;
      int64_t hn = (n - gj < nb) ? (n - gj) : nb;
      for (int64_t i = 0; i < hm; ++i) {
        for (int64_t j = 0; j < hn; ++j) {
          local[(li + i) + (lj + j) * llm] =
              src[(gi + i) * npad + (gj + j)];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

#define DEFINE_API(T, SUFFIX)                                              \
  void pack_colmajor_##SUFFIX(const T* src, int64_t m, int64_t n,          \
                              int64_t ld, T* dst, int64_t mpad,            \
                              int64_t npad) {                              \
    pack_colmajor<T>(src, m, n, ld, dst, mpad, npad);                      \
  }                                                                        \
  void unpack_colmajor_##SUFFIX(const T* src, int64_t mpad, int64_t npad,  \
                                T* dst, int64_t m, int64_t n,              \
                                int64_t ld) {                              \
    unpack_colmajor<T>(src, mpad, npad, dst, m, n, ld);                    \
  }                                                                        \
  void bc_import_##SUFFIX(const T* local, int64_t llm, int64_t lln,        \
                          T* dst, int64_t m, int64_t n, int64_t npad,      \
                          int64_t mb, int64_t nb, int64_t p, int64_t q,    \
                          int64_t pi, int64_t qi) {                        \
    bc_import<T>(local, llm, lln, dst, m, n, npad, mb, nb, p, q, pi, qi);  \
  }                                                                        \
  void bc_export_##SUFFIX(const T* src, int64_t m, int64_t n,              \
                          int64_t npad, T* local, int64_t llm,             \
                          int64_t lln, int64_t mb, int64_t nb,             \
                          int64_t p, int64_t q, int64_t pi, int64_t qi) {  \
    bc_export<T>(src, m, n, npad, local, llm, lln, mb, nb, p, q, pi, qi); \
  }

DEFINE_API(float, f32)
DEFINE_API(double, f64)

int64_t slate_tpu_native_abi_version() { return 1; }

}  // extern "C"
