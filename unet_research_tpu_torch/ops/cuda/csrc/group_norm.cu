// GroupNorm's conv epilogue on Hopper: the statistics, the fused
// affine-mask-rescale-activation pass and its two-pass backward.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the GroupNorm
// statistics, the apply, the mask's multiply and the activation of each conv
// site (models/unet.py group_norm_affine, then ops/dropblock.py, then the
// activation); the port ran them as ~25 plain PyTorch passes and (N, C) ops a
// site, and autograd's backward as ~10 more.
//
// What it computes, per (n, h, w, c) of a bf16 NHWC x with G groups of C/G
// channels (cnt = H*W*C/G positions a group):
//   mean, var = the group's mean and biased variance from the float32 sums
//               s1 = sum x, s2 = sum x^2 over (H, W) (gn_stats_kernel, or
//               K3's sums), var = max(s2/cnt - mean^2, 0), rstd = 1/sqrt(var +
//               eps); a = rstd*weight[c], b = bias[c] - mean*a (float32 (N, C),
//               gn_stats_finish_kernel);
//   z = ((x*a + b) * m) * s, m the int8 keep mask (or 1), s the per-sample
//       rescale (or 1); y = act(z) rounded once to bf16 (gn_apply_kernel);
//   backward, for the output cotangent gy: gz = act'(z)*gy*m*s with z
//       recomputed from x, a and b; per (n, c) the float32 sums B = sum gz and
//       A = sum gz*x (gn_grad_sums_kernel, which also writes dx = gz*a where
//       the sums came from K3); from them (gn_grad_finish_kernel) the weight
//       and bias gradients and the sums' cotangents ds1, ds2; and, where the
//       statistics were this pass's own, dx = gz*a + ds1 + 2*x*ds2
//       (gn_grad_dx_kernel).
//
// Bound: memory. The statistics read x once (2 B an element), the apply reads
// x and the mask and writes y (5 B), the backward reads gy, x and the mask
// twice and writes dx (12 B): at (1, 592, 576, 64) 44, 109 and 262 MB, 13, 33
// and 78 us at 3.35 TB/s. Design:
// - Every pass walks the same layout: a thread owns 8 consecutive channels
//   (one 16-byte bf16 access) of one sample, and a block covers up to 32 of
//   these octets (256 channels) for 256/octets positions a step, so a warp
//   reads whole 128-byte lines and each thread loads its 8 (a, b) pairs once.
// - The reductions accumulate in registers, four 16-byte loads in flight a
//   thread, then over the block's rows in shared memory in a fixed order; a
//   block writes one float32 partial a channel, and the finishing launch sums
//   the partials in a fixed order: no atomics, so two replays are
//   bit-identical. A finishing block takes whole groups of at most 8
//   channels (a wider group alone), its 1024 threads split into lanes over
//   a channel's partials, eight loads in flight each: its time is latency,
//   so the partials spread over as many blocks as there are such groups.
// - The apply and the backward's dx are one pass each; the backward
//   recomputes z instead of saving it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // a pass's block
constexpr int FIN_THREADS = 1024;  // a finishing launch's block
constexpr int QMAX = 32;           // octets (8 channels) a pass's block covers

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void mask8(const int8_t* m, float* f) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(m));
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)(int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// the pass's layout (file comment): octets a block covers, rows a step
struct Layout {
    int Q, qb, R, ql, r, q;
    __device__ __forceinline__ Layout(int C) {
        Q = C >> 3;
        qb = Q < QMAX ? Q : QMAX;
        R = THREADS / qb;
        ql = threadIdx.x % qb;
        r = threadIdx.x / qb;
        q = blockIdx.y * qb + ql;
    }
    __device__ __forceinline__ bool on() const { return r < R && q < Q; }
};

// z = ((x*a + b) * m) * s, each operation rounded in float32 (the plain
// version's order)
__device__ __forceinline__ float pre_act(float x, float a, float b, float m, float s) {
    return __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(x, a), b), m), s);
}

__device__ __forceinline__ float act_fwd(float z, int act, float slope) {
    if (act == ACT_RELU) return z <= 0.0f ? 0.0f : z;
    if (act == ACT_LEAKY) return z > 0.0f ? z : __fmul_rn(z, slope);
    return z;
}

// gz = ((act'(z) * gy) * m) * s
__device__ __forceinline__ float grad_z(float gy, float z, float m, float s, int act, float slope) {
    float g = gy;
    if (act == ACT_RELU) g = z > 0.0f ? g : 0.0f;
    if (act == ACT_LEAKY) g = z > 0.0f ? g : __fmul_rn(g, slope);
    return __fmul_rn(__fmul_rn(g, m), s);
}

// The block's two per-thread float32 sums of 8 channels, summed over the
// block's rows in a fixed order and written as the block's partial: part
// (2, N, NB, C), this block's row at (n, blockIdx.x).
__device__ __forceinline__ void write_partials(const Layout& L, const float* u, const float* v,
                                               float* __restrict__ part, int N, int C, int NB) {
    __shared__ float red[2][THREADS * 8];
    const int width = L.qb * 8;
    if (L.r < L.R) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            red[0][L.r * width + L.ql * 8 + e] = u[e];
            red[1][L.r * width + L.ql * 8 + e] = v[e];
        }
    }
    __syncthreads();
    const int n = blockIdx.z;
    for (int o = threadIdx.x; o < 2 * width; o += THREADS) {
        const int which = o / width, ch = o - which * width;
        const int c = blockIdx.y * width + ch;
        if (c >= C) continue;
        float acc = 0.0f;
        for (int rr = 0; rr < L.R; ++rr) acc += red[which][rr * width + ch];
        part[(((size_t)which * N + n) * NB + blockIdx.x) * C + c] = acc;
    }
}

// ---- the statistics ----------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part, int N, int P,
                int C, int NB) {
    const Layout L(C);
    float s1[8], s2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
    if (L.on()) {
        const __nv_bfloat16* base = x + (size_t)blockIdx.z * P * C + L.q * 8;
        const int step = NB * L.R;
        int p = blockIdx.x * L.R + L.r;
        for (; p + 3 * step < P; p += 4 * step) {
            uint4 v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[k] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(p + k * step) * C));
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                float f[8];
                unpack8(v[k], f);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    s1[e] += f[e];
                    s2[e] = fmaf(f[e], f[e], s2[e]);
                }
            }
        }
        for (; p < P; p += step) {
            float f[8];
            unpack8(__ldg(reinterpret_cast<const uint4*>(base + (size_t)p * C)), f);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                s1[e] += f[e];
                s2[e] = fmaf(f[e], f[e], s2[e]);
            }
        }
    }
    write_partials(L, s1, s2, part, N, C, NB);
}

// Sums lane j of channel c over partials j, j+J, ... (J lanes a channel), then
// the lanes in order: tot[2][CB] for the block's CB channels from c0, sample n.
__device__ __forceinline__ void channel_totals(const float* __restrict__ p0,
                                               const float* __restrict__ p1, int n, int C,
                                               int NB, int c0, int CB, float (*lane)[FIN_THREADS],
                                               float (*tot)[FIN_THREADS]) {
    const int J = FIN_THREADS / CB;
    const int c = threadIdx.x % CB, j = threadIdx.x / CB;
    if (j < J && c0 + c < C) {
        float u = 0.0f, v = 0.0f;
        const float* q0 = p0 + (size_t)n * NB * C + c0 + c;
        const float* q1 = p1 + (size_t)n * NB * C + c0 + c;
        int blk = j;
        // eight partials' loads in flight, added in the order of the plain loop
        for (; blk + 7 * J < NB; blk += 8 * J) {
            float a[8], b[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                a[k] = q0[(size_t)(blk + k * J) * C];
                b[k] = q1[(size_t)(blk + k * J) * C];
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                u += a[k];
                v += b[k];
            }
        }
        for (; blk < NB; blk += J) {
            u += q0[(size_t)blk * C];
            v += q1[(size_t)blk * C];
        }
        lane[0][j * CB + c] = u;
        lane[1][j * CB + c] = v;
    }
    __syncthreads();
    if (threadIdx.x < CB && c0 + (int)threadIdx.x < C) {
        float u = 0.0f, v = 0.0f;
        for (int jj = 0; jj < J; ++jj) {
            u += lane[0][jj * CB + threadIdx.x];
            v += lane[1][jj * CB + threadIdx.x];
        }
        tot[0][threadIdx.x] = u;
        tot[1][threadIdx.x] = v;
    }
    __syncthreads();
}

// a, b and (mean, rstd, gate) of gb groups from group blockIdx.x * gb, sample
// blockIdx.y. p0, p1: the (N, NB, C) partials of s1 and s2. ab: (2, N, C);
// mr: (3, N, G), gate = 1 where var was not clamped.
__global__ void __launch_bounds__(FIN_THREADS)
gn_stats_finish_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                       const float* __restrict__ weight, const float* __restrict__ bias,
                       float* __restrict__ ab, float* __restrict__ mr, int N, int C, int G,
                       int NB, int gb, float cnt, float eps) {
    __shared__ float lane[2][FIN_THREADS];
    __shared__ float tot[2][FIN_THREADS];
    __shared__ float gstat[2][FIN_THREADS];
    const int cg = C / G, n = blockIdx.y;
    const int g0 = blockIdx.x * gb, ng = min(gb, G - g0);
    const int c0 = g0 * cg, CB = gb * cg;
    channel_totals(p0, p1, n, C, NB, c0, CB, lane, tot);
    if (threadIdx.x < ng) {
        float g1 = 0.0f, g2 = 0.0f;
        for (int k = 0; k < cg; ++k) {
            g1 += tot[0][threadIdx.x * cg + k];
            g2 += tot[1][threadIdx.x * cg + k];
        }
        const float mean = __fdiv_rn(g1, cnt);
        const float var = __fsub_rn(__fdiv_rn(g2, cnt), __fmul_rn(mean, mean));
        const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(fmaxf(var, 0.0f), eps)));
        gstat[0][threadIdx.x] = mean;
        gstat[1][threadIdx.x] = rstd;
        const size_t at = (size_t)n * G + g0 + threadIdx.x;
        mr[at] = mean;
        mr[(size_t)N * G + at] = rstd;
        mr[(size_t)2 * N * G + at] = var >= 0.0f ? 1.0f : 0.0f;
    }
    __syncthreads();
    const int c = threadIdx.x;
    if (c < ng * cg) {
        const float a = __fmul_rn(gstat[1][c / cg], weight[c0 + c]);
        const float b = __fsub_rn(bias[c0 + c], __fmul_rn(gstat[0][c / cg], a));
        ab[(size_t)n * C + c0 + c] = a;
        ab[(size_t)N * C + (size_t)n * C + c0 + c] = b;
    }
}

// ---- the apply ----------------------------------------------------------------

// The thread's 8 (a, b) pairs and the sample's scale.
__device__ __forceinline__ void coeffs8(const Layout& L, const float* __restrict__ ab,
                                        const float* __restrict__ scale, int sstride, int N,
                                        int C, float* a, float* b, float& s) {
    const int n = blockIdx.z;
    const float4* pa = reinterpret_cast<const float4*>(ab + (size_t)n * C + L.q * 8);
    const float4* pb = reinterpret_cast<const float4*>(ab + (size_t)(N + n) * C + L.q * 8);
    const float4 a0 = __ldg(pa), a1 = __ldg(pa + 1), b0 = __ldg(pb), b1 = __ldg(pb + 1);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    s = scale == nullptr ? 1.0f : __ldg(scale + n * sstride);
}

__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
                const int8_t* __restrict__ mask, const float* __restrict__ scale, int sstride,
                __nv_bfloat16* __restrict__ y, int N, int P, int C, int NB, int act,
                float slope) {
    const Layout L(C);
    if (!L.on()) return;
    float a[8], b[8], s;
    coeffs8(L, ab, scale, sstride, N, C, a, b, s);
    const size_t base = (size_t)blockIdx.z * P * C + L.q * 8;
    const int step = NB * L.R;
#pragma unroll 2
    for (int p = blockIdx.x * L.R + L.r; p < P; p += step) {
        const size_t off = base + (size_t)p * C;
        float f[8], m[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + off)), f);
        if (mask != nullptr) {
            mask8(mask + off, m);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) m[e] = 1.0f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = act_fwd(pre_act(f[e], a[e], b[e], m[e], s), act, slope);
        *reinterpret_cast<uint4*>(y + off) = pack8(f);
    }
}

// ---- the backward ---------------------------------------------------------------

// part (2, N, NB, C): B = sum gz, A = sum gz*x; dx = gz*a where dx is given.
__global__ void __launch_bounds__(THREADS)
gn_grad_sums_kernel(const __nv_bfloat16* __restrict__ gy, const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ ab, const int8_t* __restrict__ mask,
                    const float* __restrict__ scale, int sstride, float* __restrict__ part,
                    __nv_bfloat16* __restrict__ dx, int N, int P, int C, int NB, int act,
                    float slope) {
    const Layout L(C);
    float sb[8], sa[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sb[e] = sa[e] = 0.0f;
    if (L.on()) {
        float a[8], b[8], s;
        coeffs8(L, ab, scale, sstride, N, C, a, b, s);
        const size_t base = (size_t)blockIdx.z * P * C + L.q * 8;
        const int step = NB * L.R;
        for (int p = blockIdx.x * L.R + L.r; p < P; p += 2 * step) {
            // two positions in flight: p and p + step
            const bool two = p + step < P;
            const size_t off0 = base + (size_t)p * C, off1 = off0 + (size_t)step * C;
            uint4 gv[2], xv[2];
            float m[2][8];
            gv[0] = __ldg(reinterpret_cast<const uint4*>(gy + off0));
            xv[0] = __ldg(reinterpret_cast<const uint4*>(x + off0));
            if (two) {
                gv[1] = __ldg(reinterpret_cast<const uint4*>(gy + off1));
                xv[1] = __ldg(reinterpret_cast<const uint4*>(x + off1));
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                if (k == 1 && !two) break;
                const size_t off = k == 0 ? off0 : off1;
                if (mask != nullptr) {
                    mask8(mask + off, m[k]);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) m[k][e] = 1.0f;
                }
                float g[8], f[8];
                unpack8(gv[k], g);
                unpack8(xv[k], f);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float z = pre_act(f[e], a[e], b[e], m[k][e], s);
                    g[e] = grad_z(g[e], z, m[k][e], s, act, slope);
                    sb[e] += g[e];
                    sa[e] = fmaf(g[e], f[e], sa[e]);
                    g[e] = __fmul_rn(g[e], a[e]);
                }
                if (dx != nullptr) *reinterpret_cast<uint4*>(dx + off) = pack8(g);
            }
        }
    }
    write_partials(L, sb, sa, part, N, C, NB);
}

// The weight and bias gradients and the sums' cotangents of gb groups from
// group blockIdx.x * gb, over every sample in order. part: (2, N, NB, C) from
// gn_grad_sums_kernel; ds: (2, N, C) = (ds1, ds2); dweight, dbias: (C,).
__global__ void __launch_bounds__(FIN_THREADS)
gn_grad_finish_kernel(const float* __restrict__ part, const float* __restrict__ ab,
                      const float* __restrict__ mr, const float* __restrict__ weight,
                      float* __restrict__ ds, float* __restrict__ dweight,
                      float* __restrict__ dbias, int N, int C, int G, int NB, int gb,
                      float cnt) {
    __shared__ float lane[2][FIN_THREADS];
    __shared__ float tot[2][FIN_THREADS];
    __shared__ float gsum[2][FIN_THREADS];
    const int cg = C / G;
    const int g0 = blockIdx.x * gb, ng = min(gb, G - g0);
    const int c0 = g0 * cg, CB = gb * cg;
    const int c = threadIdx.x;
    const bool mine = c < ng * cg;
    const float w = mine ? weight[c0 + c] : 0.0f;
    float dw = 0.0f, db = 0.0f;
    for (int n = 0; n < N; ++n) {
        channel_totals(part, part + (size_t)N * NB * C, n, C, NB, c0, CB, lane, tot);
        // tot[0] = B = sum gz, tot[1] = A = sum gz*x
        float centred = 0.0f;
        if (mine) {
            const float mean = mr[(size_t)n * G + g0 + c / cg];
            const float B = tot[0][c];
            centred = __fsub_rn(tot[1][c], __fmul_rn(mean, B));
            lane[0][c] = __fmul_rn(w, centred);
            lane[1][c] = __fmul_rn(ab[(size_t)n * C + c0 + c], B);
        }
        __syncthreads();
        if (c < ng) {
            float dr = 0.0f, dm = 0.0f;
            for (int k = 0; k < cg; ++k) {
                dr += lane[0][c * cg + k];
                dm += lane[1][c * cg + k];
            }
            const size_t at = (size_t)n * G + g0 + c;
            const float mean = mr[at], rstd = mr[(size_t)N * G + at];
            const float gate = mr[(size_t)2 * N * G + at];
            const float r3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
            const float dvar = __fmul_rn(gate, __fmul_rn(dr, __fmul_rn(-0.5f, r3)));
            const float dmean = __fsub_rn(-dm, __fmul_rn(__fmul_rn(2.0f, mean), dvar));
            gsum[0][c] = __fdiv_rn(dmean, cnt);
            gsum[1][c] = __fdiv_rn(dvar, cnt);
        }
        __syncthreads();
        if (mine) {
            const float rstd = mr[(size_t)N * G + (size_t)n * G + g0 + c / cg];
            ds[(size_t)n * C + c0 + c] = gsum[0][c / cg];
            ds[(size_t)N * C + (size_t)n * C + c0 + c] = gsum[1][c / cg];
            dw += __fmul_rn(rstd, centred);
            db += tot[0][c];
        }
        __syncthreads();
    }
    if (mine) {
        dweight[c0 + c] = dw;
        dbias[c0 + c] = db;
    }
}

// dx = gz*a + (ds1 + (2*x)*ds2)
__global__ void __launch_bounds__(THREADS)
gn_grad_dx_kernel(const __nv_bfloat16* __restrict__ gy, const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ ab, const int8_t* __restrict__ mask,
                  const float* __restrict__ scale, int sstride, const float* __restrict__ ds,
                  __nv_bfloat16* __restrict__ dx, int N, int P, int C, int NB, int act,
                  float slope) {
    const Layout L(C);
    if (!L.on()) return;
    float a[8], b[8], s, d1[8], d2[8];
    coeffs8(L, ab, scale, sstride, N, C, a, b, s);
    const int n = blockIdx.z;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        d1[e] = __ldg(ds + (size_t)n * C + L.q * 8 + e);
        d2[e] = __ldg(ds + (size_t)(N + n) * C + L.q * 8 + e);
    }
    const size_t base = (size_t)n * P * C + L.q * 8;
    const int step = NB * L.R;
#pragma unroll 2
    for (int p = blockIdx.x * L.R + L.r; p < P; p += step) {
        const size_t off = base + (size_t)p * C;
        float g[8], f[8], m[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(gy + off)), g);
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + off)), f);
        if (mask != nullptr) {
            mask8(mask + off, m);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) m[e] = 1.0f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float gz = grad_z(g[e], pre_act(f[e], a[e], b[e], m[e], s), m[e], s, act, slope);
            g[e] = __fadd_rn(__fmul_rn(gz, a[e]),
                             __fadd_rn(d1[e], __fmul_rn(__fmul_rn(2.0f, f[e]), d2[e])));
        }
        *reinterpret_cast<uint4*>(dx + off) = pack8(g);
    }
}

inline int err() { return (int)cudaGetLastError(); }

inline dim3 pass_grid(int N, int C, int NB) {
    const int Q = C / 8, qb = Q < QMAX ? Q : QMAX;
    return dim3(NB, (Q + qb - 1) / qb, N);
}

}  // namespace

// Every entry point: x, gy, y, dx (N, H*W = P, C) bf16 NHWC, contiguous and
// 16-byte aligned, C % 8 == 0; mask (N, P, C) int8, 8-byte aligned, or null;
// scale float32 read at n * sstride (sstride 0: one scale for the batch), or
// null; ab (2, N, C) and the partials (2, N, NB, C) float32; NB the blocks a
// sample and channel slice of a pass. Each returns 0 or the CUDA error of a
// refused launch.

extern "C" int gn_stats_launch(const void* x, float* part, int N, int P, int C, int NB,
                               void* stream) {
    gn_stats_kernel<<<pass_grid(N, C, NB), THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, part, N, P, C, NB);
    return err();
}

// p0, p1: (N, NB, C) partials of s1 and s2 (K3's sums are NB = 1); gb groups a
// block, gb * C/G <= 1024.
extern "C" int gn_stats_finish_launch(const float* p0, const float* p1, const float* weight,
                                      const float* bias, float* ab, float* mr, int N, int C,
                                      int G, int NB, int gb, float cnt, float eps,
                                      void* stream) {
    gn_stats_finish_kernel<<<dim3((G + gb - 1) / gb, N), FIN_THREADS, 0, (cudaStream_t)stream>>>(
        p0, p1, weight, bias, ab, mr, N, C, G, NB, gb, cnt, eps);
    return err();
}

extern "C" int gn_apply_launch(const void* x, const float* ab, const void* mask,
                               const float* scale, int sstride, void* y, int N, int P, int C,
                               int NB, int act, float slope, void* stream) {
    gn_apply_kernel<<<pass_grid(N, C, NB), THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, ab, (const int8_t*)mask, scale, sstride, (__nv_bfloat16*)y, N,
        P, C, NB, act, slope);
    return err();
}

extern "C" int gn_grad_sums_launch(const void* gy, const void* x, const float* ab,
                                   const void* mask, const float* scale, int sstride,
                                   float* part, void* dx, int N, int P, int C, int NB, int act,
                                   float slope, void* stream) {
    gn_grad_sums_kernel<<<pass_grid(N, C, NB), THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)gy, (const __nv_bfloat16*)x, ab, (const int8_t*)mask, scale,
        sstride, part, (__nv_bfloat16*)dx, N, P, C, NB, act, slope);
    return err();
}

extern "C" int gn_grad_finish_launch(const float* part, const float* ab, const float* mr,
                                     const float* weight, float* ds, float* dweight,
                                     float* dbias, int N, int C, int G, int NB, int gb,
                                     float cnt, void* stream) {
    gn_grad_finish_kernel<<<(G + gb - 1) / gb, FIN_THREADS, 0, (cudaStream_t)stream>>>(
        part, ab, mr, weight, ds, dweight, dbias, N, C, G, NB, gb, cnt);
    return err();
}

extern "C" int gn_grad_dx_launch(const void* gy, const void* x, const float* ab,
                                 const void* mask, const float* scale, int sstride,
                                 const float* ds, void* dx, int N, int P, int C, int NB, int act,
                                 float slope, void* stream) {
    gn_grad_dx_kernel<<<pass_grid(N, C, NB), THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)gy, (const __nv_bfloat16*)x, ab, (const int8_t*)mask, scale,
        sstride, ds, (__nv_bfloat16*)dx, N, P, C, NB, act, slope);
    return err();
}
