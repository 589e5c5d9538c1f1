// 3x3 SAME bias-free convolution over NHWC with the GroupNorm moment sums
// taken from the float32 accumulator (K3, forward).
//
// Replaces unet_research_tpu/ops/pallas/pair_conv.py::conv3x3_pair (body
// _conv_kernel): y = conv3x3_same(x, K), optionally s1[n, f] = sum_{h,w} acc
// and s2[n, f] = sum_{h,w} acc^2 before acc is rounded to the storage type,
// so the GroupNorm coefficients need no second pass over y.
//
// Two kernels, picked by the launcher:
// - bf16 with C_in % 16 == 0 (every main-path site): an implicit GEMM on the
//   tensor cores with mma.sync m16n8k16, float32 accumulate (design at
//   conv3x3_mma_kernel below);
// - anything else (float32, other C_in): the same function on the CUDA cores
//   with float32 FMAs. One block computes an 8x16 output tile of one sample
//   for 64 output channels; the input tile with its one-pixel zero halo (the
//   SAME padding) and the (3, 3, 8, 64) weight slice are staged in shared
//   memory in float32, and each thread keeps a 4-position x 8-channel tile
//   of accumulators (two runs of 4 channels, cg*4 and 32 + cg*4, so the
//   float4 weight loads of a quarter-warp hit distinct banks).
// The pair view and the 128-lane packing of the TPU kernel exist for the
// TPU's MXU and are not carried over.
//
// Bound: 2*9*C_in*C_out FLOP per output position against the bytes of x and
// y: at (16, 592, 576) 64->64 that is 402 GFLOP (0.41 ms at the 989 TFLOP/s
// bf16 tensor-core peak) and 1.40 GB (0.42 ms at 3.35 TB/s); at 128->64,
// 805 GFLOP (0.81 ms). The mma.sync kernel stages through shared memory with
// no copy/compute overlap and stays several times above that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;             // output tile rows
constexpr int TW = 16;            // output tile columns
constexpr int CO = 64;            // output channels per block
constexpr int CK = 8;             // input channels per shared-memory stage
constexpr int CKP = CK + 1;       // padded position stride of the input tile
constexpr int THREADS = 256;
constexpr int IN_H = TH + 2;
constexpr int IN_W = TW + 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ y,
               float* __restrict__ s1, float* __restrict__ s2, int H, int W, int Cin,
               int Cout) {
    __shared__ float s_in[IN_H * IN_W * CKP];
    __shared__ __align__(16) float s_w[9 * CK * CO];
    __shared__ float s_sum1[CO];
    __shared__ float s_sum2[CO];

    const int co_tiles = (Cout + CO - 1) / CO;
    const int n = blockIdx.z / co_tiles;
    const int co_base = (blockIdx.z % co_tiles) * CO;
    const int h0 = blockIdx.y * TH;
    const int w0 = blockIdx.x * TW;
    const int tid = threadIdx.x;
    const int cg = tid % 8;           // channel group: cg*4.. and 32+cg*4..
    const int pg = tid / 8;           // position group: 4 columns of one row
    const int r = pg / 4;
    const int col0 = (pg % 4) * 4;

    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;

    for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
        __syncthreads();
        for (int i = tid; i < IN_H * IN_W * CK; i += THREADS) {
            const int k = i % CK;
            const int pos = i / CK;
            const int hh = h0 - 1 + pos / IN_W;
            const int ww = w0 - 1 + pos % IN_W;
            const int ci = ci0 + k;
            float v = 0.0f;
            if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin)
                v = to_f(x[(((size_t)n * H + hh) * W + ww) * Cin + ci]);
            s_in[pos * CKP + k] = v;
        }
        for (int i = tid; i < 9 * CK * CO; i += THREADS) {
            const int co = i % CO;
            const int k = (i / CO) % CK;
            const int tap = i / (CO * CK);
            const int ci = ci0 + k;
            float v = 0.0f;
            if (ci < Cin && co_base + co < Cout)
                v = to_f(wt[((size_t)tap * Cout + co_base + co) * Cin + ci]);
            s_w[i] = v;
        }
        __syncthreads();

        const float4* s_w4 = reinterpret_cast<const float4*>(s_w);
#pragma unroll 2
        for (int k = 0; k < CK; ++k) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
                float xin[6];
#pragma unroll
                for (int j = 0; j < 6; ++j)
                    xin[j] = s_in[((r + ky) * IN_W + col0 + j) * CKP + k];
#pragma unroll
                for (int kx = 0; kx < 3; ++kx) {
                    const int base = ((ky * 3 + kx) * CK + k) * (CO / 4);
                    const float4 wa = s_w4[base + cg];
                    const float4 wb = s_w4[base + 8 + cg];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float xv = xin[j + kx];
                        acc[j][0] = fmaf(xv, wa.x, acc[j][0]);
                        acc[j][1] = fmaf(xv, wa.y, acc[j][1]);
                        acc[j][2] = fmaf(xv, wa.z, acc[j][2]);
                        acc[j][3] = fmaf(xv, wa.w, acc[j][3]);
                        acc[j][4] = fmaf(xv, wb.x, acc[j][4]);
                        acc[j][5] = fmaf(xv, wb.y, acc[j][5]);
                        acc[j][6] = fmaf(xv, wb.z, acc[j][6]);
                        acc[j][7] = fmaf(xv, wb.w, acc[j][7]);
                    }
                }
            }
        }
    }

    // epilogue: store y, and the tile's moment sums from the accumulator
    const bool stats = s1 != nullptr;
    if (stats && tid < CO) {
        s_sum1[tid] = 0.0f;
        s_sum2[tid] = 0.0f;
    }
    __syncthreads();
    float p1[8], p2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p1[k] = p2[k] = 0.0f;
    const int hh = h0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int ww = w0 + col0 + j;
        if (hh >= H || ww >= W) continue;
        T* dst = y + (((size_t)n * H + hh) * W + ww) * Cout + co_base;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int co = (k < 4) ? cg * 4 + k : 32 + cg * 4 + (k - 4);
            if (co_base + co >= Cout) continue;
            dst[co] = from_f<T>(acc[j][k]);
            p1[k] += acc[j][k];
            p2[k] += acc[j][k] * acc[j][k];
        }
    }
    if (!stats) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int co = (k < 4) ? cg * 4 + k : 32 + cg * 4 + (k - 4);
        atomicAdd(&s_sum1[co], p1[k]);
        atomicAdd(&s_sum2[co], p2[k]);
    }
    __syncthreads();
    if (tid < CO && co_base + tid < Cout) {
        atomicAdd(&s1[(size_t)n * Cout + co_base + tid], s_sum1[tid]);
        atomicAdd(&s2[(size_t)n * Cout + co_base + tid], s_sum2[tid]);
    }
}


// ---- bf16 tensor-core path: mma.sync m16n8k16, float32 accumulate ----------
//
// Implicit GEMM: M = output positions, N = output channels, K = 9 taps x C_in.
// A block owns an 8x32 output tile of one sample and 64 output channels;
// warp r computes row r (32 positions = two m16 tiles) for all 64 channels
// (eight n8 tiles), 64 float32 accumulators a thread. Per stage, 16 input
// channels of the (10 x 34) halo tile and the (9, 64, 16) weight slice sit
// in shared memory, padded to 24 bf16 a row so the fragment loads of a warp
// hit 32 distinct banks.

constexpr int MH = 8;             // output tile rows (one per warp)
constexpr int MW = 32;            // output tile columns
constexpr int MK = 16;            // input channels per stage (the mma K)
constexpr int MPAD = 24;          // bf16 per smem row (16 + 8 pad)
constexpr int M_IN_W = MW + 2;
constexpr int M_IN = (MH + 2) * M_IN_W;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ s1,
                   float* __restrict__ s2, int H, int W, int Cin, int Cout) {
    __shared__ __align__(16) __nv_bfloat16 s_in[M_IN * MPAD];
    __shared__ __align__(16) __nv_bfloat16 s_w[9 * CO * MPAD];
    __shared__ float s_sum1[CO];
    __shared__ float s_sum2[CO];

    const int co_tiles = (Cout + CO - 1) / CO;
    const int n = blockIdx.z / co_tiles;
    const int co_base = (blockIdx.z % co_tiles) * CO;
    const int h0 = blockIdx.y * MH;
    const int w0 = blockIdx.x * MW;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;          // fragment row group
    const int t = lane & 3;           // thread in group

    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

    for (int ci0 = 0; ci0 < Cin; ci0 += MK) {
        __syncthreads();
        // halo tile, 16 channels = two 16-byte vectors a position
        for (int i = tid; i < M_IN * 2; i += THREADS) {
            const int pos = i >> 1;
            const int half = i & 1;
            const int hh = h0 - 1 + pos / M_IN_W;
            const int ww = w0 - 1 + pos % M_IN_W;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (hh >= 0 && hh < H && ww >= 0 && ww < W)
                v = *reinterpret_cast<const uint4*>(
                    x + (((size_t)n * H + hh) * W + ww) * Cin + ci0 + half * 8);
            *reinterpret_cast<uint4*>(s_in + pos * MPAD + half * 8) = v;
        }
        // weights (tap, co, ci): 16 channels = two 16-byte vectors a row
        for (int i = tid; i < 9 * CO * 2; i += THREADS) {
            const int row = i >> 1;   // tap * CO + co
            const int half = i & 1;
            const int co = row % CO;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (co_base + co < Cout)
                v = *reinterpret_cast<const uint4*>(
                    wt + ((size_t)(row / CO) * Cout + co_base + co) * Cin + ci0 + half * 8);
            *reinterpret_cast<uint4*>(s_w + row * MPAD + half * 8) = v;
        }
        __syncthreads();

#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
            const int ky = tap / 3;
            const int kx = tap % 3;
            uint32_t b[8][2];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const __nv_bfloat16* pb = s_w + (tap * CO + nt * 8 + g) * MPAD + 2 * t;
                b[nt][0] = ld32(pb);
                b[nt][1] = ld32(pb + 8);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const __nv_bfloat16* pa =
                    s_in + ((warp + ky) * M_IN_W + mt * 16 + g + kx) * MPAD + 2 * t;
                uint32_t a[4];
                a[0] = ld32(pa);
                a[1] = ld32(pa + 8 * MPAD);
                a[2] = ld32(pa + 8);
                a[3] = ld32(pa + 8 * MPAD + 8);
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
            }
        }
    }

    // epilogue: bf16 y; moment sums of the float32 accumulator
    const bool stats = s1 != nullptr;
    if (stats && tid < CO) {
        s_sum1[tid] = 0.0f;
        s_sum2[tid] = 0.0f;
    }
    __syncthreads();
    const int hh = h0 + warp;
    float p1[8][2], p2[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) p1[nt][j] = p2[nt][j] = 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int ww = w0 + mt * 16 + g + hi * 8;
            if (hh >= H || ww >= W) continue;
            __nv_bfloat16* dst = y + (((size_t)n * H + hh) * W + ww) * Cout + co_base;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const int co = nt * 8 + 2 * t;
                if (co_base + co >= Cout) continue;
                const float v0 = acc[mt][nt][2 * hi];
                const float v1 = acc[mt][nt][2 * hi + 1];
                *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(v0, v1);
                p1[nt][0] += v0;
                p1[nt][1] += v1;
                p2[nt][0] += v0 * v0;
                p2[nt][1] += v1 * v1;
            }
        }
    }
    if (!stats) return;
    // sum over the 8 row groups (lane bits 2..4), then over the warps
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                p1[nt][j] += __shfl_xor_sync(0xffffffffu, p1[nt][j], o);
                p2[nt][j] += __shfl_xor_sync(0xffffffffu, p2[nt][j], o);
            }
    if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                atomicAdd(&s_sum1[nt * 8 + 2 * t + j], p1[nt][j]);
                atomicAdd(&s_sum2[nt * 8 + 2 * t + j], p2[nt][j]);
            }
    }
    __syncthreads();
    if (tid < CO && co_base + tid < Cout) {
        atomicAdd(&s1[(size_t)n * Cout + co_base + tid], s_sum1[tid]);
        atomicAdd(&s2[(size_t)n * Cout + co_base + tid], s_sum2[tid]);
    }
}

}  // namespace

// x: (N, H, W, Cin) NHWC; w: (3, 3, Cout, Cin); y: (N, H, W, Cout).
// s1, s2: (N, Cout) float32 zeroed by the caller, or both null.
// dtype: 0 float32, 1 bfloat16. bfloat16 with C_in % 16 == 0, even C_out and
// 16-byte aligned x runs on the tensor cores, anything else on the CUDA
// cores. Returns 1 + the path taken (1 CUDA cores, 2 tensor cores) on
// success, or -(the CUDA error) after a refused launch.
extern "C" int conv3x3_launch(const void* x, const void* w, void* y, float* s1, float* s2,
                              int N, int H, int W, int Cin, int Cout, int dtype,
                              void* stream) {
    const int co_tiles = (Cout + CO - 1) / CO;
    cudaStream_t s = (cudaStream_t)stream;
    int path;
    if (dtype == 1 && Cin % MK == 0 && Cout % 2 == 0 && ((uintptr_t)x & 15) == 0
        && ((uintptr_t)w & 15) == 0) {
        const dim3 grid((W + MW - 1) / MW, (H + MH - 1) / MH, N * co_tiles);
        conv3x3_mma_kernel<<<grid, THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, s1, s2,
            H, W, Cin, Cout);
        path = 2;
    } else {
        const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * co_tiles);
        if (dtype == 0) {
            conv3x3_kernel<float><<<grid, THREADS, 0, s>>>(
                (const float*)x, (const float*)w, (float*)y, s1, s2, H, W, Cin, Cout);
        } else {
            conv3x3_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
                (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, s1, s2,
                H, W, Cin, Cout);
        }
        path = 1;
    }
    const cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? path : -(int)err;
}
