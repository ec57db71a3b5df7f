// Passes of the shifted implicit QR iteration of a real tridiagonal
// (steqr_sweep) or upper bidiagonal (bdsqr_sweep) matrix, entirely on
// the card: clamp the negligible off-diagonals to zero, locate the
// trailing unreduced block [ll, m], compute the shift, run the gated
// bulge chase over the block, and count the off-diagonals still above
// tolerance. The device work of ops/kernels.py steqr_sweep /
// steqr_sweeps and bdsqr_sweep / bdsqr_sweeps for CUDA tensors.
//
// Replaces no Pallas kernel: it is the port of the XLA scans the
// reference runs per pass inside its while_loops,
// slate_tpu/linalg/eig.py _steqr_shifted_sweep (:553, loop :627-671)
// and slate_tpu/linalg/svd.py _bdsqr_shifted_sweep (:472, loop
// :555-590). In eager PyTorch a pass would be n-1 steps of ~15 scalar
// launches each, thousands of passes a solve.
//
// Bound on an H100: latency. The chase is a scalar recurrence (each
// rotation needs the previous step's bulge). The work is the active
// block only: steps outside [ll, m] change nothing in the reference's
// gated scan. Every operation rounds once (__fmul_rn, __fadd_rn,
// __fdiv_rn, sqrt through f64 for hypot), in the order of the plain
// versions steqr_sweep_plain / bdsqr_sweep_plain, so d, e and the
// rotations are bitwise theirs.
//
// The reference loops over passes on the device (a while_loop), so one
// launch runs up to max_passes passes, with d and e kept in shared
// memory between them, and stops as the reference's loop does: at a
// count of 0, or after the passes it was given (the caller passes what
// is left of its cap). Each pass writes its rotations to its own row;
// the caller reads the passes run and the count once a launch. The
// whole launch is one warp: its lanes share the clamp, the search, the
// count and the writes, and walk the chase in step. The chase carries
// its recurrence (steqr: d[k+1], e[k+1] and the bulge; bdsqr: f, g,
// d[i+1] and e[i+1]) from step to step in registers, with the next
// step's inputs loaded a step ahead, and stores only what outlives the
// pass; hypot's f64 sum of squares is one FMA (the squares of f32
// values are exact in f64, so that is the rounding of the product and
// sum it replaces). Its floor is the step's own dependent chain with
// this rounding (the f64 root, the IEEE divides, the f32 updates),
// measured by clock64 (steqr_chain_cycles, bdsqr_chain_cycles): on an
// H100 ~272 cycles a tridiagonal step, where a full-width pass at
// n = 2048 took ~300. A bidiagonal step holds two dependent rotations.
// The one-pass entries are the same kernels run for one pass whatever
// the count.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// |(f, g)| through f64: the squares of f32 values are exact in f64, so
// the FMA rounds once, as a sum of the two products would; then one
// rounding each for the root and the conversion back to f32.
__device__ __forceinline__ float hyp_fma(float f, float g) {
    const double fd = f, gd = g;
    return __double2float_rn(
        __dsqrt_rn(__fma_rn(fd, fd, __dmul_rn(gd, gd))));
}

// LAPACK dlartg: c f + s g = r.
__device__ __forceinline__ void lartg(float f, float g, float& c, float& s,
                                      float& r) {
    r = hyp_fma(f, g);
    if (r == 0.f) {
        c = 1.f;
        s = 0.f;
    } else {
        c = dvd(f, r);
        s = dvd(g, r);
    }
}

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }

// Smallest singular value of [[f, g], [0, h]] (LAPACK dlas2).
__device__ float dlas2_min(float f, float g, float h) {
    const float fa = fabsf(f), ga = fabsf(g), ha = fabsf(h);
    const float fhmn = fminf(fa, ha), fhmx = fmaxf(fa, ha);
    if (fhmn == 0.f) return 0.f;
    if (ga <= fhmx) {
        const float as_ = add(1.f, dvd(fhmn, fhmx));
        const float at = dvd(sub(fhmx, fhmn), fhmx);
        float au = dvd(ga, fhmx);
        au = mul(au, au);
        return mul(fhmn, dvd(2.f, add(sqrt_rn(add(mul(as_, as_), au)),
                                      sqrt_rn(add(mul(at, at), au)))));
    }
    const float au = dvd(fhmx, ga);
    if (au == 0.f) return dvd(mul(fhmn, fhmx), ga);
    const float x = mul(add(1.f, dvd(fhmn, fhmx)), au);
    const float y = mul(dvd(sub(fhmx, fhmn), fhmx), au);
    const float c = dvd(1.f, add(sqrt_rn(add(1.f, mul(x, x))),
                                 sqrt_rn(add(1.f, mul(y, y)))));
    return mul(mul(mul(2.f, fhmn), c), au);
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool above(const float* ds, const float* es,
                                      int i, float tol) {
    return fabsf(es[i]) > mul(tol, add(fabsf(ds[i]), fabsf(ds[i + 1])));
}

// The shifted chase of the tridiagonal block [ll, m] (m the block's
// last diagonal index) by one warp in step: every lane computes the
// same values and stores them to the same addresses, so no store
// diverges the warp (a store by lane 0 alone put a branch and a
// reconvergence on every step). The Wilkinson shift of the block's
// trailing 2x2, then the steps k = ll .. m-1 with d[k], e[k], d[k+1],
// e[k+1] and the bulge in registers. STORE = false (the floor
// measurement) stores nothing and returns a sum of what the steps
// computed.
template <bool STORE>
__device__ float steqr_chase(float* ds, float* es, int ll, int m, float* cs,
                             float* sn) {
    const float em1 = es[m - 1];
    const float delta = dvd(sub(ds[m - 1], ds[m]), 2.f);
    const float sgn = delta >= 0.f ? 1.f : -1.f;
    float denom = add(fabsf(delta), hyp_fma(delta, em1));
    if (denom == 0.f) denom = 1.f;
    const float shift = sub(ds[m], dvd(mul(mul(sgn, em1), em1), denom));
    float dk = ds[ll], ek = es[ll], dk1 = ds[ll + 1];
    float ek1 = ll + 1 < m ? es[ll + 1] : 0.f;
    float x = sub(dk, shift), z = ek;
    float acc = 0.f;
    for (int k = ll; k < m; ++k) {
        // step k+1's inputs, not written before it
        const float dk2 = k + 2 <= m ? ds[k + 2] : 0.f;
        const float ek2 = k + 2 < m ? es[k + 2] : 0.f;
        float c, s, r;
        lartg(x, z, c, s, r);
        if (STORE && k > ll) es[k - 1] = r;
        const float cc = mul(c, c), ss = mul(s, s);
        const float tcs = mul(mul(2.f, c), s);
        const float dnk = add(add(mul(cc, dk), mul(tcs, ek)), mul(ss, dk1));
        if (STORE) ds[k] = dnk;
        const float dn = add(sub(mul(ss, dk), mul(tcs, ek)), mul(cc, dk1));
        x = add(mul(mul(c, s), sub(dk1, dk)), mul(sub(cc, ss), ek));
        if (k < m - 1) {
            z = mul(s, ek1);
            ek = mul(c, ek1);
        }
        if (STORE) {
            cs[k] = c;
            sn[k] = s;
        }
        if (!STORE) acc = add(acc, add(dnk, add(c, s)));
        dk = dn;
        dk1 = dk2;
        ek1 = ek2;
    }
    if (STORE) {
        es[m - 1] = x;
        ds[m] = dk;
    }
    return add(acc, add(x, dk));
}

// The shifted chase of the bidiagonal block [ll, m] (m the block's last
// off-diagonal index) by one warp in step, as steqr_chase: the dlas2
// shift of the block's trailing 2x2, zeroed when negligible against
// d[ll], then LAPACK dbdsqr's downward steps i = ll .. m, each a right
// rotation (cr, sr) from (f, g) and a left one (cl, sl) from what it
// makes of d[i], e[i], d[i+1]. f, g, d[i], e[i], d[i+1] and the
// unrotated e[i+1] ride in registers; of a step's stores (d[i], e[i],
// d[i+1], e[i+1] in bdsqr_sweep_plain) only d[i] and the previous
// step's e[i-1] outlive the pass, the others are overwritten by the
// next step. STORE = false (the floor measurement) stores nothing and
// returns a sum of what the steps computed.
template <bool STORE>
__device__ float bdsqr_chase(float* ds, float* es, int ll, int m, float eps,
                             float* cr, float* sr, float* cl, float* sl) {
    float shift = dlas2_min(ds[m], es[m], ds[m + 1]);
    const float dll = ds[ll];
    const float dll_s = dll == 0.f ? 1.f : dll;
    const float q = dvd(shift, dll_s);
    if (mul(q, q) < eps) shift = 0.f;
    const float sgn = dll > 0.f ? 1.f : (dll < 0.f ? -1.f : 0.f);
    float f = mul(sub(fabsf(dll), shift), add(sgn, dvd(shift, dll_s)));
    float g = es[ll];
    float di = dll, ei = g, di1 = ds[ll + 1];
    float en = ll < m ? es[ll + 1] : 0.f;
    float acc = 0.f;
    for (int i = ll; i <= m; ++i) {
        // step i+1's inputs, not written before it
        const float dn2 = i < m ? ds[i + 2] : 0.f;
        const float en2 = i + 2 <= m ? es[i + 2] : 0.f;
        float cosr, sinr, r;
        lartg(f, g, cosr, sinr, r);
        if (STORE && i > ll) es[i - 1] = r;
        const float f2 = add(mul(cosr, di), mul(sinr, ei));
        const float e_i = sub(mul(cosr, ei), mul(sinr, di));
        const float g2 = mul(sinr, di1);
        const float d_i1 = mul(cosr, di1);
        float cosl, sinl, r2;
        lartg(f2, g2, cosl, sinl, r2);
        f = add(mul(cosl, e_i), mul(sinl, d_i1));
        di = sub(mul(cosl, d_i1), mul(sinl, e_i));
        if (i < m) {
            g = mul(sinl, en);
            ei = mul(cosl, en);
        }
        if (STORE) {
            ds[i] = r2;
            cr[i] = cosr;
            sr[i] = sinr;
            cl[i] = cosl;
            sl[i] = sinl;
        } else {
            acc = add(acc, add(add(r, r2), add(add(cosr, sinr),
                                               add(cosl, sinl))));
        }
        di1 = dn2;
        en = en2;
    }
    if (STORE) {
        es[m] = f;
        ds[m + 1] = di;
    }
    return add(acc, add(f, di));
}

// Count of the off-diagonals above tolerance, to every lane.
__device__ __forceinline__ int count_above(const float* ds, const float* es,
                                           int n, float tol) {
    int c = 0;
    for (int i = threadIdx.x; i < n - 1; i += 32) c += above(ds, es, i, tol);
    return __reduce_add_sync(FULL, c);
}

// Up to max_passes passes (exactly one if `force`) by ONE warp: while
// the count of off-diagonals above tolerance is not 0, one pass, its
// rotations to row p of the NROT outputs (n-1 each: cs, sn for steqr;
// cr, sr, cl, sl for bdsqr). Rows past the passes run are identity.
// Out: d, e after the last pass, *count (the count after it, or of the
// input if none ran) and, if given, *passes. The lanes share the clamp,
// the block search, the count and the writes (n / 32 entries each),
// and chase in step; a block of 32 warps, waiting at a barrier while
// one chased, ran the tridiagonal chase ~15% slower. The tolerance is
// eps (steqr) or 20 eps (bdsqr).
template <bool BD>
__device__ void sweeps(const float* d, const float* e, int n, float eps,
                       int max_passes, int force, float* d_out, float* e_out,
                       float* r0, float* r1, float* r2, float* r3,
                       int* passes, int* count) {
    extern __shared__ float sm[];
    float* ds = sm;
    float* es = sm + n;
    const int lane = threadIdx.x;
    const long nr = n - 1;
    const float tol = BD ? mul(20.f, eps) : eps;
    for (int i = lane; i < n; i += 32) ds[i] = d[i];
    for (int i = lane; i < n - 1; i += 32) es[i] = e[i];
    __syncwarp();
    int cnt = force ? 1 : count_above(ds, es, n, tol);
    int p = 0;
    for (; cnt > 0 && p < max_passes; ++p) {
        const long row = p * nr;
        // clamp, then the block [ll, mlast]
        int last = -1;
        for (int i = lane; i < n - 1; i += 32) {
            if (above(ds, es, i, tol))
                last = i;
            else
                es[i] = 0.f;
        }
        const int mlast = __reduce_max_sync(FULL, last);
        __syncwarp();
        int zero = -1;
        for (int i = lane; i < mlast; i += 32)
            if (es[i] == 0.f) zero = i;
        const int ll = __reduce_max_sync(FULL, zero) + 1;
        for (int k = lane; k < n - 1; k += 32)
            if (mlast < 0 || k < ll || k > mlast) {
                r0[row + k] = 1.f;
                r1[row + k] = 0.f;
                if (BD) {
                    r2[row + k] = 1.f;
                    r3[row + k] = 0.f;
                }
            }
        if (mlast >= 0) {
            if (BD)
                bdsqr_chase<true>(ds, es, ll, mlast, eps, r0 + row, r1 + row,
                                  r2 + row, r3 + row);
            else
                steqr_chase<true>(ds, es, ll, mlast + 1, r0 + row, r1 + row);
        }
        __syncwarp();
        cnt = count_above(ds, es, n, tol);
    }
    for (long q = (long)p * nr + lane; q < (long)max_passes * nr; q += 32) {
        r0[q] = 1.f;
        r1[q] = 0.f;
        if (BD) {
            r2[q] = 1.f;
            r3[q] = 0.f;
        }
    }
    for (int i = lane; i < n; i += 32) d_out[i] = ds[i];
    for (int i = lane; i < n - 1; i += 32) e_out[i] = es[i];
    if (lane == 0) {
        *count = cnt;
        if (passes) *passes = p;
    }
}

__global__ void __launch_bounds__(32)
steqr_sweeps_kernel(const float* d, const float* e, int n, float eps,
                    int max_passes, int force, float* d_out, float* e_out,
                    float* cs, float* sn, int* passes, int* count) {
    sweeps<false>(d, e, n, eps, max_passes, force, d_out, e_out, cs, sn,
                  nullptr, nullptr, passes, count);
}

__global__ void __launch_bounds__(32)
bdsqr_sweeps_kernel(const float* d, const float* e, int n, float eps,
                    int max_passes, int force, float* d_out, float* e_out,
                    float* cr, float* sr, float* cl, float* sl, int* passes,
                    int* count) {
    sweeps<true>(d, e, n, eps, max_passes, force, d_out, e_out, cr, sr, cl,
                 sl, passes, count);
}

// Measurement only (chip_smoke.py's bitwise floors of the sweeps): the
// chase over the whole of (d, e) with the kernel's step arithmetic and
// no stores, by one warp in step; out[0] = clock64 cycles of the chase,
// out[1] the bits of the sum of what it computed.
template <bool BD>
__global__ void __launch_bounds__(32)
chain_kernel(const float* d, const float* e, int n, long long* out) {
    extern __shared__ float sm[];
    float* ds = sm;
    float* es = sm + n;
    for (int i = threadIdx.x; i < n; i += 32) ds[i] = d[i];
    for (int i = threadIdx.x; i < n - 1; i += 32) es[i] = e[i];
    __syncwarp();
    const long long t0 = clock64();
    const float acc =
        BD ? bdsqr_chase<false>(ds, es, 0, n - 2, 1.1920929e-07f, nullptr,
                                nullptr, nullptr, nullptr)
           : steqr_chase<false>(ds, es, 0, n - 1, nullptr, nullptr);
    const long long t1 = clock64();
    if (threadIdx.x == 0) {
        out[0] = t1 - t0;
        out[1] = __float_as_int(acc);
    }
}

int set_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return 0;
}

// d and e in shared memory
size_t sweep_smem(int n) { return sizeof(float) * 2 * (size_t)n; }

template <bool BD>
int chain_cycles(const float* d, const float* e, int n, long long* out,
                 void* stream) {
    if (n < 2) return (int)cudaErrorInvalidValue;
    const int rc = set_smem((const void*)chain_kernel<BD>, sweep_smem(n));
    if (rc) return rc;
    chain_kernel<BD><<<1, 32, sweep_smem(n), (cudaStream_t)stream>>>(d, e, n,
                                                                   out);
    return (int)cudaGetLastError();
}

int bdsqr_launch(const float* d, const float* e, int n, float eps,
                 int max_passes, int force, float* d_out, float* e_out,
                 float* cr, float* sr, float* cl, float* sl, int* passes,
                 int* count, void* stream) {
    if (max_passes < 0) return (int)cudaErrorInvalidValue;
    const int rc = set_smem((const void*)bdsqr_sweeps_kernel, sweep_smem(n));
    if (rc) return rc;
    bdsqr_sweeps_kernel<<<1, 32, sweep_smem(n), (cudaStream_t)stream>>>(
        d, e, n, eps, max_passes, force, d_out, e_out, cr, sr, cl, sl, passes,
        count);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// One tridiagonal QR pass: d (n), e (n-1) in; d_out, e_out, the n-1
// rotations (cs, sn) and the int count out; on `stream`.
int steqr_sweep(const float* d, const float* e, int n, float eps,
                float* d_out, float* e_out, float* cs, float* sn,
                int* count, void* stream) {
    const int rc = set_smem((const void*)steqr_sweeps_kernel, sweep_smem(n));
    if (rc) return rc;
    steqr_sweeps_kernel<<<1, 32, sweep_smem(n), (cudaStream_t)stream>>>(
        d, e, n, eps, 1, 1, d_out, e_out, cs, sn, nullptr, count);
    return (int)cudaGetLastError();
}

// Up to max_passes tridiagonal QR passes, stopping at a count of 0:
// the rotations (cs, sn) as (max_passes, n-1) rows, identity past the
// passes run; ran[0] the passes run, ran[1] the count after them.
int steqr_sweeps(const float* d, const float* e, int n, float eps,
                 int max_passes, float* d_out, float* e_out, float* cs,
                 float* sn, int* ran, void* stream) {
    if (max_passes < 0) return (int)cudaErrorInvalidValue;
    const int rc = set_smem((const void*)steqr_sweeps_kernel, sweep_smem(n));
    if (rc) return rc;
    steqr_sweeps_kernel<<<1, 32, sweep_smem(n), (cudaStream_t)stream>>>(
        d, e, n, eps, max_passes, 0, d_out, e_out, cs, sn, ran, ran + 1);
    return (int)cudaGetLastError();
}

// The tridiagonal floor measurement: the chase over (d, e), n >= 2;
// out two int64 (cycles, checksum bits).
int steqr_chain_cycles(const float* d, const float* e, int n, long long* out,
                       void* stream) {
    return chain_cycles<false>(d, e, n, out, stream);
}

// One bidiagonal QR pass: the right rotations (cr, sr) and the left
// ones (cl, sl) out beside d_out, e_out and the count.
int bdsqr_sweep(const float* d, const float* e, int n, float eps,
                float* d_out, float* e_out, float* cr, float* sr, float* cl,
                float* sl, int* count, void* stream) {
    return bdsqr_launch(d, e, n, eps, 1, 1, d_out, e_out, cr, sr, cl, sl,
                        nullptr, count, stream);
}

// Up to max_passes bidiagonal QR passes, stopping at a count of 0: the
// rotations (cr, sr, cl, sl) as (max_passes, n-1) rows, identity past
// the passes run; ran[0] the passes run, ran[1] the count after them.
int bdsqr_sweeps(const float* d, const float* e, int n, float eps,
                 int max_passes, float* d_out, float* e_out, float* cr,
                 float* sr, float* cl, float* sl, int* ran, void* stream) {
    return bdsqr_launch(d, e, n, eps, max_passes, 0, d_out, e_out, cr, sr,
                        cl, sl, ran, ran + 1, stream);
}

// The bidiagonal floor measurement: the chase over (d, e) with the f32
// eps, n >= 2; out two int64 (cycles, checksum bits).
int bdsqr_chain_cycles(const float* d, const float* e, int n, long long* out,
                       void* stream) {
    return chain_cycles<true>(d, e, n, out, stream);
}

}  // extern "C"
