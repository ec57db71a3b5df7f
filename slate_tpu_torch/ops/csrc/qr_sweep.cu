// Passes of the shifted implicit QR iteration of a real tridiagonal
// (steqr_sweep) or upper bidiagonal (bdsqr_sweep) matrix, entirely on
// the card: clamp the negligible off-diagonals to zero, locate the
// trailing unreduced block [ll, m], compute the shift, run the gated
// bulge chase over the block, and count the off-diagonals still above
// tolerance. The device work of ops/kernels.py steqr_sweep /
// steqr_sweeps and bdsqr_sweep for CUDA tensors.
//
// Replaces no Pallas kernel: it is the port of the XLA scans the
// reference runs per pass inside its while_loops,
// slate_tpu/linalg/eig.py _steqr_shifted_sweep (:553, loop :627-671)
// and slate_tpu/linalg/svd.py _bdsqr_shifted_sweep (:472, loop
// :555-590). In eager PyTorch a pass would be n-1 steps of ~15 scalar
// launches each, thousands of passes a solve.
//
// Bound on an H100: latency. The chase is a scalar recurrence (each
// rotation needs the previous step's bulge). bdsqr: one thread walks
// it, while the block's other threads clamp, search the block
// (block-wide reductions), write identity rotations outside it, count
// and store. The work is the active block only: steps outside [ll, m]
// change nothing in the reference's gated scan. Every operation rounds
// once (__fmul_rn, __fadd_rn, __fdiv_rn, sqrt through f64 for hypot),
// in the order of the plain versions steqr_sweep_plain /
// bdsqr_sweep_plain, so d, e and the rotations are bitwise theirs.
//
// steqr: the reference loops over passes on the device (a
// while_loop), so one launch runs up to max_passes passes, with d and
// e kept in shared memory between them, and stops as the reference's
// loop does: at a count of 0, or after the passes it was given (the
// caller passes what is left of its cap). Each pass writes its
// rotations to its own row; the caller reads the passes run and the
// count once a launch. The whole launch is one warp: its lanes share
// the clamp, the search, the count and the writes, and walk the chase
// in step. The chase carries d[k+1], e[k+1] and the bulge (x, z) from
// step to step in registers, with the next step's inputs loaded a step
// ahead; hypot's f64 sum of squares is one FMA (the squares of f32
// values are exact in f64, so that is the rounding of the product and
// sum it replaces). Its floor is the step's own dependent chain with
// this rounding (the f64 root, two IEEE divides, the f32 updates):
// ~272 cycles a step by clock64 on an H100 (steqr_chain_cycles), where
// a full-width pass at n = 2048 took ~300 cycles a step. The one-pass
// entry is the same kernel run for one pass whatever the count.

#include <cuda_runtime.h>

namespace {

// threads of the bdsqr block
constexpr int THREADS = 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// |(f, g)| through f64: exact squares, one rounding each for the sum,
// the root and the conversion back to f32.
__device__ __forceinline__ float hyp(float f, float g) {
    const double fd = f, gd = g;
    return __double2float_rn(
        __dsqrt_rn(__dadd_rn(__dmul_rn(fd, fd), __dmul_rn(gd, gd))));
}

// LAPACK dlartg: c f + s g = r.
__device__ __forceinline__ void lartg(float f, float g, float& c, float& s,
                                      float& r) {
    r = hyp(f, g);
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

// Clamp e into shared memory, find the block, write identity rotations
// outside it. Returns (through shared ints) ll and mlast; mlast < 0
// when every off-diagonal is below tolerance.
__device__ void prologue(const float* d, const float* e, int n, float tol,
                         float* ds, float* es, int* s_last, int* s_zero) {
    const int tid = threadIdx.x;
    if (tid == 0) {
        *s_last = -1;
        *s_zero = -1;
    }
    for (int i = tid; i < n; i += THREADS) ds[i] = d[i];
    __syncthreads();
    int last = -1;
    for (int i = tid; i < n - 1; i += THREADS) {
        const float ei = e[i];
        const bool keep =
            fabsf(ei) > mul(tol, add(fabsf(ds[i]), fabsf(ds[i + 1])));
        es[i] = keep ? ei : 0.f;
        if (keep) last = i;
    }
    if (last >= 0) atomicMax(s_last, last);
    __syncthreads();
    const int mlast = *s_last;
    int zero = -1;
    for (int i = tid; i < mlast; i += THREADS)
        if (es[i] == 0.f) zero = i;
    if (zero >= 0) atomicMax(s_zero, zero);
    __syncthreads();
}

// Write d, e back and count the off-diagonals above tolerance.
__device__ void epilogue(const float* ds, const float* es, int n, float tol,
                         float* d_out, float* e_out, int* count,
                         int* s_count) {
    const int tid = threadIdx.x;
    if (tid == 0) *s_count = 0;
    __syncthreads();
    int c = 0;
    for (int i = tid; i < n; i += THREADS) d_out[i] = ds[i];
    for (int i = tid; i < n - 1; i += THREADS) {
        e_out[i] = es[i];
        if (fabsf(es[i]) > mul(tol, add(fabsf(ds[i]), fabsf(ds[i + 1]))))
            ++c;
    }
    if (c) atomicAdd(s_count, c);
    __syncthreads();
    if (tid == 0) *count = *s_count;
}

// hyp with the sum of squares as one FMA: bitwise hyp (f * f is exact
// in f64).
__device__ __forceinline__ float hyp_fma(float f, float g) {
    const double fd = f, gd = g;
    return __double2float_rn(
        __dsqrt_rn(__fma_rn(fd, fd, __dmul_rn(gd, gd))));
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool above(const float* ds, const float* es,
                                      int i, float tol) {
    return fabsf(es[i]) > mul(tol, add(fabsf(ds[i]), fabsf(ds[i + 1])));
}

// The shifted chase of the block [ll, m] (m the block's last diagonal
// index) by one warp in step: every lane computes the same values and
// stores them to the same addresses, so no store diverges the warp (a
// store by lane 0 alone put a branch and a reconvergence on every
// step). The Wilkinson shift of the block's trailing 2x2, then the
// steps k = ll .. m-1 with d[k], e[k], d[k+1], e[k+1] and the bulge in
// registers. STORE = false (the floor measurement) stores nothing and
// returns a sum of what the steps computed.
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
        float c, s;
        const float r = hyp_fma(x, z);
        if (r == 0.f) {
            c = 1.f;
            s = 0.f;
        } else {
            c = dvd(x, r);
            s = dvd(z, r);
        }
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

// Count of the off-diagonals above tolerance, to every lane.
__device__ __forceinline__ int count_above(const float* ds, const float* es,
                                           int n, float tol) {
    int c = 0;
    for (int i = threadIdx.x; i < n - 1; i += 32) c += above(ds, es, i, tol);
    return __reduce_add_sync(FULL, c);
}

// Up to max_passes tridiagonal passes (exactly one if `force`) by ONE
// warp: while the count of off-diagonals above tolerance is not 0, one
// pass, its rotations to row p of cs / sn (n-1 each). Rows past the
// passes run are identity. Out: d, e after the last pass, *count (the
// count after it, or of the input if none ran) and, if given, *passes.
// The lanes share the clamp, the block search, the count and the
// writes (n / 32 entries each; a pass's chase is ~300 cycles a step),
// and chase in step; a block of 32 warps, waiting at a barrier while
// one chased, ran the chase ~15% slower.
__global__ void __launch_bounds__(32)
steqr_sweeps_kernel(const float* d, const float* e, int n, float tol,
                    int max_passes, int force, float* d_out, float* e_out,
                    float* cs, float* sn, int* passes, int* count) {
    extern __shared__ float sm[];
    float* ds = sm;
    float* es = sm + n;
    const int lane = threadIdx.x;
    const long nr = n - 1;
    for (int i = lane; i < n; i += 32) ds[i] = d[i];
    for (int i = lane; i < n - 1; i += 32) es[i] = e[i];
    __syncwarp();
    int cnt = force ? 1 : count_above(ds, es, n, tol);
    int p = 0;
    for (; cnt > 0 && p < max_passes; ++p) {
        float* csp = cs + p * nr;
        float* snp = sn + p * nr;
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
                csp[k] = 1.f;
                snp[k] = 0.f;
            }
        if (mlast >= 0) steqr_chase<true>(ds, es, ll, mlast + 1, csp, snp);
        __syncwarp();
        cnt = count_above(ds, es, n, tol);
    }
    for (long q = (long)p * nr + lane; q < (long)max_passes * nr; q += 32) {
        cs[q] = 1.f;
        sn[q] = 0.f;
    }
    for (int i = lane; i < n; i += 32) d_out[i] = ds[i];
    for (int i = lane; i < n - 1; i += 32) e_out[i] = es[i];
    if (lane == 0) {
        *count = cnt;
        if (passes) *passes = p;
    }
}

// Measurement only (chip_smoke.py's bitwise floor of the sweep): the
// chase over the whole of (d, e) with steqr_chase's step arithmetic and
// no stores, by one warp in step; out[0] = clock64 cycles of the chase,
// out[1] the bits of the sum of what it computed.
__global__ void steqr_chain_kernel(const float* d, const float* e, int n,
                                   long long* out) {
    extern __shared__ float sm[];
    float* ds = sm;
    float* es = sm + n;
    for (int i = threadIdx.x; i < n; i += 32) ds[i] = d[i];
    for (int i = threadIdx.x; i < n - 1; i += 32) es[i] = e[i];
    __syncwarp();
    const long long t0 = clock64();
    const float acc = steqr_chase<false>(ds, es, 0, n - 1, nullptr, nullptr);
    const long long t1 = clock64();
    if (threadIdx.x == 0) {
        out[0] = t1 - t0;
        out[1] = __float_as_int(acc);
    }
}

__global__ void __launch_bounds__(THREADS)
bdsqr_sweep_kernel(const float* d, const float* e, int n, float eps,
                   float* d_out, float* e_out, float* cr, float* sr,
                   float* cl, float* sl, int* count) {
    extern __shared__ float sm[];
    float* ds = sm;
    float* es = sm + n;
    __shared__ int s_last, s_zero, s_count;
    const float tol = mul(20.f, eps);
    prologue(d, e, n, tol, ds, es, &s_last, &s_zero);
    const int m = s_last;
    const int ll = s_zero + 1;
    for (int k = threadIdx.x; k < n - 1; k += THREADS)
        if (m < 0 || k < ll || k > m) {
            cr[k] = 1.f;
            sr[k] = 0.f;
            cl[k] = 1.f;
            sl[k] = 0.f;
        }
    if (threadIdx.x == 0 && m >= 0) {
        const int mm = min(m, n - 2);
        float shift = dlas2_min(ds[mm], es[mm], ds[mm + 1]);
        const float dll = ds[ll];
        const float dll_s = dll == 0.f ? 1.f : dll;
        const float q = dvd(shift, dll_s);
        if (mul(q, q) < eps) shift = 0.f;
        const float sgn = dll > 0.f ? 1.f : (dll < 0.f ? -1.f : 0.f);
        float f = mul(sub(fabsf(dll), shift), add(sgn, dvd(shift, dll_s)));
        float g = es[ll];
        for (int i = ll; i <= m; ++i) {
            float cosr, sinr, r, cosl, sinl, r2;
            lartg(f, g, cosr, sinr, r);
            if (i > ll) es[i - 1] = r;
            const float di = ds[i], ei = es[i], di1 = ds[i + 1];
            const float f2 = add(mul(cosr, di), mul(sinr, ei));
            const float e_i = sub(mul(cosr, ei), mul(sinr, di));
            const float g2 = mul(sinr, di1);
            const float d_i1 = mul(cosr, di1);
            lartg(f2, g2, cosl, sinl, r2);
            f = add(mul(cosl, e_i), mul(sinl, d_i1));
            const float d_i1b = sub(mul(cosl, d_i1), mul(sinl, e_i));
            if (i < m) {
                g = mul(sinl, es[i + 1]);
                es[i + 1] = mul(cosl, es[i + 1]);
            }
            ds[i] = r2;
            ds[i + 1] = d_i1b;
            es[i] = e_i;
            cr[i] = cosr;
            sr[i] = sinr;
            cl[i] = cosl;
            sl[i] = sinl;
        }
        es[m] = f;
    }
    __syncthreads();
    epilogue(ds, es, n, tol, d_out, e_out, count, &s_count);
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
    const size_t smem = sizeof(float) * 2 * (size_t)n;
    const int rc = set_smem((const void*)steqr_sweeps_kernel, smem);
    if (rc) return rc;
    steqr_sweeps_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(
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
    const size_t smem = sizeof(float) * 2 * (size_t)n;
    const int rc = set_smem((const void*)steqr_sweeps_kernel, smem);
    if (rc) return rc;
    steqr_sweeps_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(
        d, e, n, eps, max_passes, 0, d_out, e_out, cs, sn, ran, ran + 1);
    return (int)cudaGetLastError();
}

// The floor measurement: steqr_chain_kernel on (d, e), n >= 2; out two
// int64 (cycles, checksum bits).
int steqr_chain_cycles(const float* d, const float* e, int n, long long* out,
                       void* stream) {
    if (n < 2) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * 2 * (size_t)n;
    const int rc = set_smem((const void*)steqr_chain_kernel, smem);
    if (rc) return rc;
    steqr_chain_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(d, e, n, out);
    return (int)cudaGetLastError();
}

// One bidiagonal QR pass: the right rotations (cr, sr) and the left
// ones (cl, sl) out beside d_out, e_out and the count.
int bdsqr_sweep(const float* d, const float* e, int n, float eps,
                float* d_out, float* e_out, float* cr, float* sr, float* cl,
                float* sl, int* count, void* stream) {
    const size_t smem = sizeof(float) * 2 * (size_t)n;
    const int rc = set_smem((const void*)bdsqr_sweep_kernel, smem);
    if (rc) return rc;
    bdsqr_sweep_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
        d, e, n, eps, d_out, e_out, cr, sr, cl, sl, count);
    return (int)cudaGetLastError();
}

}  // extern "C"
