// One pass of the shifted implicit QR iteration of a real tridiagonal
// (steqr_sweep) or upper bidiagonal (bdsqr_sweep) matrix, entirely on
// the card: clamp the negligible off-diagonals to zero, locate the
// trailing unreduced block [ll, m], compute the shift, run the gated
// bulge chase over the block, and count the off-diagonals still above
// tolerance. The device work of ops/kernels.py steqr_sweep and
// bdsqr_sweep for CUDA tensors; one launch per pass, and the host reads
// only the count.
//
// Replaces no Pallas kernel: it is the port of the XLA scans the
// reference runs per pass inside its while_loops,
// slate_tpu/linalg/eig.py _steqr_shifted_sweep (:553, loop :627-671)
// and slate_tpu/linalg/svd.py _bdsqr_shifted_sweep (:472, loop
// :555-590). In eager PyTorch a pass would be n-1 steps of ~15 scalar
// launches each, thousands of passes a solve.
//
// Bound on an H100: latency. The chase is a scalar recurrence (each
// rotation needs the previous step's bulge), so one thread walks it,
// with d and e in shared memory; the other threads load, clamp, search
// the block (block-wide max reductions), write identity rotations
// outside the block, and store. The work is the active block only:
// steps outside [ll, m] change nothing in the reference's gated scan.
// Every operation rounds once (__fmul_rn, __fadd_rn, __fdiv_rn,
// sqrt through f64 for hypot), in the order of the plain versions
// steqr_sweep_plain / bdsqr_sweep_plain, so d, e and the rotations are
// bitwise theirs.

#include <cuda_runtime.h>

namespace {

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

__global__ void __launch_bounds__(THREADS)
steqr_sweep_kernel(const float* d, const float* e, int n, float eps,
                   float* d_out, float* e_out, float* cs, float* sn,
                   int* count) {
    extern __shared__ float sm[];
    float* ds = sm;
    float* es = sm + n;
    __shared__ int s_last, s_zero, s_count;
    prologue(d, e, n, eps, ds, es, &s_last, &s_zero);
    const int mlast = s_last;
    const int ll = s_zero + 1;
    for (int k = threadIdx.x; k < n - 1; k += THREADS)
        if (mlast < 0 || k < ll || k > mlast) {
            cs[k] = 1.f;
            sn[k] = 0.f;
        }
    if (threadIdx.x == 0 && mlast >= 0) {
        const int m = mlast + 1;
        // Wilkinson shift from the block's trailing 2x2
        const float em1 = es[m - 1];
        const float delta = dvd(sub(ds[m - 1], ds[m]), 2.f);
        const float sgn = delta >= 0.f ? 1.f : -1.f;
        float denom = add(fabsf(delta), hyp(delta, em1));
        if (denom == 0.f) denom = 1.f;
        const float shift = sub(ds[m], dvd(mul(mul(sgn, em1), em1), denom));
        float x = sub(ds[ll], shift);
        float z = es[ll];
        for (int k = ll; k < m; ++k) {
            float c, s, r;
            lartg(x, z, c, s, r);
            if (k > ll) es[k - 1] = r;
            const float dk = ds[k], dk1 = ds[k + 1], ek = es[k];
            const float cc = mul(c, c), ss = mul(s, s);
            const float tcs = mul(mul(2.f, c), s);
            ds[k] = add(add(mul(cc, dk), mul(tcs, ek)), mul(ss, dk1));
            ds[k + 1] = add(sub(mul(ss, dk), mul(tcs, ek)), mul(cc, dk1));
            x = add(mul(mul(c, s), sub(dk1, dk)), mul(sub(cc, ss), ek));
            es[k] = x;
            if (k < m - 1) {
                z = mul(s, es[k + 1]);
                es[k + 1] = mul(c, es[k + 1]);
            }
            cs[k] = c;
            sn[k] = s;
        }
    }
    __syncthreads();
    epilogue(ds, es, n, eps, d_out, e_out, count, &s_count);
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
    const int rc = set_smem((const void*)steqr_sweep_kernel, smem);
    if (rc) return rc;
    steqr_sweep_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
        d, e, n, eps, d_out, e_out, cs, sn, count);
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
