// 3x3 SAME bias-free convolution over NHWC with the GroupNorm moment sums
// taken from the float32 accumulator (K3), its input gradient, and the fold
// of the sums' cotangents that comes before it.
//
// Replaces unet_research_tpu/ops/pallas/pair_conv.py::conv3x3_pair (body
// _conv_kernel): y = conv3x3_same(x, K), optionally s1[n, f] = sum_{h,w} acc
// and s2[n, f] = sum_{h,w} acc^2 before acc is rounded to the storage type,
// so the GroupNorm coefficients need no second pass over y; and its custom
// VJP's dx (_pair_vjp_bwd via _dx_conv, which re-enters the same kernel on
// rot_transpose(K)) and its fold g = dy + ds1 + 2*y*ds2 (:399-402).
//
// The conv has two kernels, picked by the launchers:
// - conv3x3_wgmma_kernel, bf16 with C_in % 16 == 0, C_in <= 128 and
//   C_out % 8 == 0 (every main-path site, forward and dx): an implicit GEMM
//   on Hopper's warpgroup MMA, fed by TMA (design below);
// - conv3x3_kernel, anything else (float32, other channel counts): the same
//   function on the CUDA cores with float32 FMAs. One block computes an 8x16
//   output tile of one sample for 64 output channels; the input tile with
//   its one-pixel zero halo (the SAME padding) and the (3, 3, 8, 64) weight
//   slice are staged in shared memory in float32, and each thread keeps a
//   4-position x 8-channel tile of accumulators (two runs of 4 channels,
//   cg*4 and 32 + cg*4, so the float4 weight loads of a quarter-warp hit
//   distinct banks).
// The pair view and the 128-lane packing of the TPU kernel exist for the
// TPU's MXU and are not carried over. The fold is conv3x3_fold_kernel, one
// pass over dy and y (design and the reason it is not inside the dx launch
// at conv3x3_fold_kernel).
//
// Bound: 2*9*C_in*C_out FLOP per output position against the bytes of x and
// y: at (16, 592, 576) 64->64 that is 402 GFLOP (0.41 ms at the 989 TFLOP/s
// bf16 tensor-core peak) and 1.40 GB (0.42 ms at 3.35 TB/s); at 128->64,
// 805 GFLOP (0.81 ms): the forward sits on the ridge, the 128-channel one on
// the tensor cores.

#include <cuda.h>
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


// ---- bf16 on the warpgroup MMA: wgmma + TMA, persistent ------------------
//
// Implicit GEMM: M = output positions, N = output channels, K = 9 taps x
// C_in. A tile is 2 output rows x 64 columns (128 positions; W = 576 = 9 x
// 64 leaves no ragged tile at the main-path width) of one sample.
//
// - Weights once per block. The grid is persistent: one block per SM walks
//   a contiguous range of tiles. All 9 x C_in x NT weights (NT = 64 output
//   channels, or 128 when C_in <= 64) sit in shared memory in the wgmma B
//   layout (K-major, 128-byte swizzle, one (NT x 64-channel) block per tap
//   and channel chunk), read by descriptor. They are gathered by index from
//   the HWIO tensor, or for dx from the same tensor read as rot180 with its
//   channels transposed, so the host launches no permute and no copy.
// - The input halo by TMA, in a ring. A 4-D tensor map over NHWC x boxes
//   (64 channels, 66 columns, 4 rows, 1 sample) at (c0, w0-1, h0-1, n);
//   the TMA unit fills the coordinates outside the tensor with zeros, which
//   is exactly the SAME padding. One producer thread keeps the ring full on
//   mbarriers; C_in = 128 takes two boxes (channel chunks) per tile.
// - A from registers. A tap's A operand is the halo tile shifted by (ky, kx)
//   positions, i.e. by whole 128-byte rows: a descriptor start that moves by
//   one row breaks the 1024-byte atom a 128-byte-swizzle descriptor needs,
//   so A is loaded with ldmatrix. The TMA box is 128-byte swizzled (16-byte
//   chunk j of position p at chunk j ^ (p & 7)), so the 8 rows of each 8x8
//   ldmatrix, 8 consecutive positions, hit 8 distinct bank groups.
// - Two consumer warpgroups, one output row each: per tap and 16-channel
//   step one wgmma.mma_async m64nNTk16 (float32 accumulate); the next tap's
//   fragments load while the current tap's MMAs run.
// - Shared memory (227 KB a block): 64->64 holds 72 KB of weights and four
//   33 KB stages; 128->64 and 64->128 hold 144 KB and two stages.
// - Epilogue: y stored as bf16 straight from the fragments; s1 and s2 from
//   the float32 accumulator, kept in registers across a block's tiles of one
//   sample and flushed with one atomicAdd per channel and warp when the
//   sample changes.
// - dx: the same kernel on the (folded) output cotangent, the weights read
//   as rot_transpose(K).

constexpr int WT = 64;                         // output columns per tile
constexpr int WR = 2;                          // output rows per tile
constexpr int HALO_W = WT + 2;
constexpr int HALO_H = WR + 2;
constexpr int KCH = 64;                        // channels per TMA box
constexpr int STAGE_BYTES = HALO_H * HALO_W * KCH * 2;   // 33,792 = 33 x 1024
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int WG_THREADS = CONSUMERS + 128;    // + the producer warpgroup
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait for the phase after `parity`; a wait of ~2^35 cycles (about 18 s)
// means a lost arrival and traps, so a fault fails the launch, not the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (!done && clock64() - t0 > (1ll << 35)) __trap();
    } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
           "r"(bar)
        : "memory");
}

// generic-proxy shared-memory writes become visible to the async proxy
// (wgmma's B reads, later TMA writes into the same stage)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma fence/wait
template <int NACC> __device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// K-major, 128-byte swizzle: rows of 128 bytes, 8-row atoms of 1024 bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, float32) += A (64 x 16 bf16, registers) * B (16 x N bf16, smem)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma_tile(float* d, const uint32_t* a, uint64_t desc) {
    if constexpr (NT == 64) wgmma_n64(d, a, desc);
    else wgmma_n128(d, a, desc);
}

// the 8 bf16 of a uint4 as floats
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

struct Tiles {
    int th, tw;
    __device__ __forceinline__ void decode(int t, int& n, int& hb, int& wb) const {
        const int per_n = th * tw;
        n = t / per_n;
        const int r = t - n * per_n;
        hb = r / tw;
        wb = r - hb * tw;
    }
};

// NT: output channels per block (the wgmma N). STATS: the moment sums.
template <int NT, bool STATS>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ s1, float* __restrict__ s2,
                     int N, int H, int W, int Cin, int Cout, int transposed, int stages) {
    constexpr int NACC = NT / 2;                 // float32 accumulators a thread
    constexpr int NSUM = STATS ? NT / 4 : 1;     // channels a thread sums
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const int KC = (Cin + KCH - 1) / KCH;
    const int wbytes = 9 * KC * NT * 128;
    uint8_t* s_w = smem;
    uint8_t* s_stage = smem + wbytes;
    // per stage: full (the TMA copy landed), empty (released by the MMAs)
    uint64_t* bars = reinterpret_cast<uint64_t*>(s_stage + stages * STAGE_BYTES);
    const uint32_t full0 = smem_u32(bars);
    const uint32_t empty0 = smem_u32(bars + stages);

    const int tid = threadIdx.x;
    const int co_base = blockIdx.y * NT;

    // weights into the B layout: (tap, chunk) blocks of NT rows x 128 bytes,
    // element (n, k) at n*128 + ((k/8) ^ (n%8))*16 + (k%8)*2, in 16-byte
    // pieces of 8 input channels of one output channel
    if (!transposed) {
        // K[t][ci][co], co contiguous: 8 rows of 8 output channels, turned
        // in registers into 8 pieces
        const int units = 9 * KC * 8 * (NT / 8);
        for (int u = tid; u < units; u += WG_THREADS) {
            const int n8 = u % (NT / 8);
            int r = u / (NT / 8);
            const int j = r % 8;
            r /= 8;
            const int kc = r % KC;
            const int t = r / KC;
            const int ci = kc * KCH + 8 * j;
            const int co = co_base + 8 * n8;
            uint32_t e[8][4];
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (ci < Cin && co < Cout)
                    v = *reinterpret_cast<const uint4*>(
                        wt + ((size_t)t * Cin + ci + kk) * Cout + co);
                e[kk][0] = v.x; e[kk][1] = v.y; e[kk][2] = v.z; e[kk][3] = v.w;
            }
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                // the bf16 of output channel nn from each of the 8 rows
                uint32_t h[8];
#pragma unroll
                for (int kk = 0; kk < 8; ++kk)
                    h[kk] = (nn & 1) ? (e[kk][nn >> 1] >> 16) : (e[kk][nn >> 1] & 0xFFFFu);
                const int n = 8 * n8 + nn;
                const int off = ((t * KC + kc) * NT + n) * 128 + ((j ^ (n & 7)) << 4);
                *reinterpret_cast<uint4*>(s_w + off) =
                    make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                               h[6] | (h[7] << 16));
            }
        }
    } else {
        // dx: rot_transpose(K)[t][ci][co] = K[8 - t][co][ci] of the forward's
        // (3, 3, Cout, Cin) kernel, ci contiguous: one load per piece
        const int units = 9 * KC * 8 * NT;
        for (int u = tid; u < units; u += WG_THREADS) {
            const int j = u % 8;
            int r = u / 8;
            const int n = r % NT;
            r /= NT;
            const int kc = r % KC;
            const int t = r / KC;
            const int ci = kc * KCH + 8 * j;
            const int co = co_base + n;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (ci < Cin && co < Cout)
                v = *reinterpret_cast<const uint4*>(
                    wt + ((size_t)(8 - t) * Cout + co) * Cin + ci);
            const int off = ((t * KC + kc) * NT + n) * 128 + ((j ^ (n & 7)) << 4);
            *reinterpret_cast<uint4*>(s_w + off) = v;
        }
    }
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fence_proxy_async();
    __syncthreads();

    const Tiles tiles{(H + WR - 1) / WR, (W + WT - 1) / WT};
    const int total = N * tiles.th * tiles.tw;
    const int t_begin = (int)((long long)total * blockIdx.x / gridDim.x);
    const int t_end = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);

    if (tid >= CONSUMERS) {
        // ---- producer warpgroup: one thread issues the halo copies ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == CONSUMERS) {
            int stage = 0;
            uint32_t phase = 0;
            for (int t = t_begin; t < t_end; ++t) {
                int n, hb, wb;
                tiles.decode(t, n, hb, wb);
                for (int kc = 0; kc < KC; ++kc) {
                    mbar_wait(empty0 + 8 * stage, phase ^ 1);
                    mbar_expect_tx(full0 + 8 * stage, STAGE_BYTES);
                    tma_load_4d(smem_u32(s_stage + stage * STAGE_BYTES), &xmap, full0 + 8 * stage,
                                kc * KCH, wb * WT - 1, hb * WR - 1, n);
                    if (++stage == stages) { stage = 0; phase ^= 1; }
                }
            }
        }
    } else {
        // ---- consumer warpgroups: wg = the tile row ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = tid >> 7;
        const int wq = (tid >> 5) & 3;               // warp in the warpgroup: 16 columns
        const int lane = tid & 31;
        const int grp = lane >> 2;
        const int tq = lane & 3;
        const int ld_col = 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ld_hi = lane >> 4;
        const uint64_t desc0 = smem_desc(smem_u32(s_w));

        float acc[NACC];
        float p1[NSUM], p2[NSUM];
#pragma unroll
        for (int j = 0; j < NSUM; ++j) p1[j] = p2[j] = 0.0f;

        auto flush = [&](int n) {
#pragma unroll
            for (int j = 0; j < NSUM; ++j) {
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    p1[j] += __shfl_xor_sync(0xffffffffu, p1[j], o);
                    p2[j] += __shfl_xor_sync(0xffffffffu, p2[j], o);
                }
                const int co = co_base + 8 * (j >> 1) + 2 * tq + (j & 1);
                if (grp == 0 && co < Cout) {
                    atomicAdd(&s1[(size_t)n * Cout + co], p1[j]);
                    atomicAdd(&s2[(size_t)n * Cout + co], p2[j]);
                }
                p1[j] = p2[j] = 0.0f;
            }
        };

        int stage = 0;
        uint32_t phase = 0;
        int cur_n = -1;
        for (int t = t_begin; t < t_end; ++t) {
            int n, hb, wb;
            tiles.decode(t, n, hb, wb);
            if (STATS && n != cur_n) {
                if (cur_n >= 0) flush(cur_n);
                cur_n = n;
            }
#pragma unroll
            for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
            fence_acc<NACC>(acc);

            for (int kc = 0; kc < KC; ++kc) {
                mbar_wait(full0 + 8 * stage, phase);
                uint8_t* buf = s_stage + stage * STAGE_BYTES;
                const uint32_t sbase = smem_u32(buf);
                uint32_t a[2][4][4];
                auto load_a = [&](uint32_t (*frag)[4], int tap) {
                    const int pos = (wg + tap / 3) * HALO_W + ld_col + tap % 3;
#pragma unroll
                    for (int s = 0; s < 4; ++s)
                        ldmatrix_x4(frag[s],
                                    sbase + pos * 128 + (((2 * s + ld_hi) ^ (pos & 7)) << 4));
                };
                if (kc > 0) wgmma_wait<0>();   // the last chunk's tap 8 read a[0]
                load_a(a[0], 0);
#pragma unroll
                for (int tap = 0; tap < 9; ++tap) {
                    const uint64_t desc = desc0 + (uint64_t)(((tap * KC + kc) * NT * 128) >> 4);
                    wgmma_fence();
#pragma unroll
                    for (int s = 0; s < 4; ++s)
                        wgmma_tile<NT>(acc, a[tap & 1][s], desc + (uint64_t)(2 * s));
                    wgmma_commit();
                    if (tap < 8) {
                        // the other fragment set fed the previous tap's MMAs
                        wgmma_wait<1>();
                        load_a(a[(tap + 1) & 1], tap + 1);
                    }
                }
                // every ldmatrix of this stage has returned: release it
                if (lane == 0) mbar_arrive(empty0 + 8 * stage);
                if (++stage == stages) { stage = 0; phase ^= 1; }
            }
            wgmma_wait<0>();
            fence_acc<NACC>(acc);

            // epilogue: rows (grp, grp + 8) of this warp's 16 columns
            const int h = hb * WR + wg;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int w = wb * WT + 16 * wq + grp + 8 * half;
                if (h >= H || w >= W) continue;
                __nv_bfloat16* dst = y + (((size_t)n * H + h) * W + w) * Cout;
#pragma unroll
                for (int i = 0; i < NT / 8; ++i) {
                    const int co = co_base + 8 * i + 2 * tq;
                    if (co >= Cout) continue;
                    const float v0 = acc[4 * i + 2 * half];
                    const float v1 = acc[4 * i + 2 * half + 1];
                    *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(v0, v1);
                    if constexpr (STATS) {
                        p1[2 * i] += v0;
                        p1[2 * i + 1] += v1;
                        p2[2 * i] += v0 * v0;
                        p2[2 * i + 1] += v1 * v1;
                    }
                }
            }
        }
        if (STATS && cur_n >= 0) flush(cur_n);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

int sm_count() {
    static int count = 0;
    if (count == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    }
    return count;
}

constexpr int MAX_DEVICES = 64;

template <int NT, bool STATS>
cudaError_t launch_wgmma(const CUtensorMap& map, int grid_x, int co_tiles, int smem,
                         cudaStream_t s, const __nv_bfloat16* w, __nv_bfloat16* y, float* s1,
                         float* s2, int N, int H, int W, int Cin, int Cout, int transposed,
                         int stages) {
    // The shared-memory limit is raised once per card and instantiation, at
    // the first launch that needs it, so that a launch recorded into a CUDA
    // graph (the trainer's scanned epochs) makes no attribute call.
    static int raised[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (smem > raised[dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            conv3x3_wgmma_kernel<NT, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        raised[dev] = smem;
    }
    conv3x3_wgmma_kernel<NT, STATS><<<dim3(grid_x, co_tiles), WG_THREADS, smem, s>>>(
        map, w, y, s1, s2, N, H, W, Cin, Cout, transposed, stages);
    return cudaGetLastError();
}

// ---- the fold of the backward --------------------------------------------
//
// The sums' cotangents folded into the output cotangent before K3's dx
// (JAX _pair_vjp_bwd, pair_conv.py:399-402): g = T((dy + ds1[n, c]) +
// (2*y)*ds2[n, c]) in float32, the plain version's operations in its order.
// Bound by memory: it reads dy and y once and writes g once (131 MB at
// (1, 592, 576, 64) bf16, 0.039 ms at 3.35 TB/s). A thread folds 8 channels
// of one position, with 16-byte accesses in bf16 (VEC). The fold once ran
// inside the dx launch, on each landed stage of the TMA ring (by the
// consumer warpgroups, then by the producer's three spare warps): that
// folds every halo position twice and reads y with a few warps per SM, and
// took the dx from 0.073 to 0.173 ms at (1, 592, 576, 64) -> 64 on an H100;
// this pass and the dx take 0.115 ms there (PERF.md, kernel table).
__device__ __forceinline__ float fold1(float dy, float y, float d1, float d2) {
    return __fadd_rn(__fadd_rn(dy, d1), __fmul_rn(__fmul_rn(2.0f, y), d2));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_fold_kernel(const T* __restrict__ dy, const T* __restrict__ yf,
                    const float* __restrict__ ds1, const float* __restrict__ ds2,
                    T* __restrict__ g, int items, int HW, int C) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= items) return;
    const int chunks = (C + 7) / 8;
    const int pos = i / chunks;
    const int c = (i - pos * chunks) * 8;
    const float* d1 = ds1 + (size_t)(pos / HW) * C + c;
    const float* d2 = ds2 + (size_t)(pos / HW) * C + c;
    const size_t off = (size_t)pos * C + c;
    if constexpr (VEC) {
        float a[8], b[8];
        unpack8(*reinterpret_cast<const uint4*>(dy + off), a);
        unpack8(*reinterpret_cast<const uint4*>(yf + off), b);
        float gv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) gv[e] = fold1(a[e], b[e], __ldg(d1 + e), __ldg(d2 + e));
        *reinterpret_cast<uint4*>(g + off) = make_uint4(pack2(gv[0], gv[1]), pack2(gv[2], gv[3]),
                                                        pack2(gv[4], gv[5]), pack2(gv[6], gv[7]));
    } else {
        for (int e = 0; e < 8 && c + e < C; ++e)
            g[off + e] = from_f<T>(fold1(to_f(dy[off + e]), to_f(yf[off + e]), d1[e], d2[e]));
    }
}

template <typename T>
void launch_fold(const void* dy, const void* y, const float* ds1, const float* ds2, void* g,
                 int items, int HW, int C, bool vec, cudaStream_t s) {
    const int blocks = (items + THREADS - 1) / THREADS;
    if (vec)
        conv3x3_fold_kernel<T, true><<<blocks, THREADS, 0, s>>>(
            (const T*)dy, (const T*)y, ds1, ds2, (T*)g, items, HW, C);
    else
        conv3x3_fold_kernel<T, false><<<blocks, THREADS, 0, s>>>(
            (const T*)dy, (const T*)y, ds1, ds2, (T*)g, items, HW, C);
}

}  // namespace

// CUDA cores. x: (N, H, W, Cin) NHWC; w: (3, 3, Cout, Cin); y: (N, H, W,
// Cout). s1, s2: (N, Cout) float32 zeroed by the caller, or both null.
// dtype: 0 float32, 1 bfloat16. Returns 0, or -(the CUDA error) after a
// refused launch.
extern "C" int conv3x3_launch(const void* x, const void* w, void* y, float* s1, float* s2,
                              int N, int H, int W, int Cin, int Cout, int dtype,
                              void* stream) {
    const int co_tiles = (Cout + CO - 1) / CO;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * co_tiles);
    if (dtype == 0) {
        conv3x3_kernel<float><<<grid, THREADS, 0, s>>>(
            (const float*)x, (const float*)w, (float*)y, s1, s2, H, W, Cin, Cout);
    } else {
        conv3x3_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, s1, s2,
            H, W, Cin, Cout);
    }
    const cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? 0 : -(int)err;
}

// The warpgroup-MMA kernel, bf16. x: (N, H, W, Cin) NHWC; w: the HWIO
// kernel, (3, 3, Cin, Cout) with transposed = 0 (y = conv(x, w)), or with
// transposed = 1 the forward kernel (3, 3, Cout, Cin) of which this call
// computes the input gradient (y = conv(x, rot_transpose(w)), x being the
// output cotangent). s1, s2: (N, Cout) float32 zeroed by the caller, or
// null. Needs Cin % 16 == 0, Cin <= 128, Cout % 8 == 0 and 16-byte aligned
// x and w. Returns 0, -(the CUDA error) after a refused launch, or -(1000 +
// CUresult) when the tensor map cannot be made.
extern "C" int conv3x3_wgmma_launch(const void* x, const void* w, void* y, float* s1, float* s2,
                                    int N, int H, int W, int Cin, int Cout, int transposed,
                                    void* stream) {
    if (Cin % 16 != 0 || Cin > 2 * KCH || Cout % 8 != 0 || ((uintptr_t)x & 15) != 0
        || ((uintptr_t)w & 15) != 0)
        return -(int)cudaErrorInvalidValue;
    const int KC = (Cin + KCH - 1) / KCH;
    const int NT = (Cout > 64 && KC == 1) ? 128 : 64;
    const int co_tiles = (Cout + NT - 1) / NT;
    const int wbytes = 9 * KC * NT * 128;
    int stages = (SMEM_LIMIT - 1024 - wbytes - 16 * MAX_STAGES) / STAGE_BYTES;
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    const int smem = 1024 + wbytes + stages * STAGE_BYTES + 16 * stages;

    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -(int)cudaErrorInvalidValue;
    alignas(64) CUtensorMap map;
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                   (cuuint64_t)H * W * Cin * 2};
    const cuuint32_t box[4] = {KCH, HALO_W, HALO_H, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult cr = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                               dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (cr != CUDA_SUCCESS) return -(1000 + (int)cr);

    const int total = N * ((H + WR - 1) / WR) * ((W + WT - 1) / WT);
    int grid_x = sm_count() / co_tiles;
    if (grid_x < 1) grid_x = 1;
    if (grid_x > total) grid_x = total;
    cudaStream_t s = (cudaStream_t)stream;
    const auto* wb = (const __nv_bfloat16*)w;
    auto* yb = (__nv_bfloat16*)y;
    cudaError_t err;
    if (NT == 64 && s1 != nullptr)
        err = launch_wgmma<64, true>(map, grid_x, co_tiles, smem, s, wb, yb, s1, s2, N, H, W,
                                     Cin, Cout, transposed, stages);
    else if (NT == 64)
        err = launch_wgmma<64, false>(map, grid_x, co_tiles, smem, s, wb, yb, s1, s2, N, H, W,
                                      Cin, Cout, transposed, stages);
    else if (s1 != nullptr)
        err = launch_wgmma<128, true>(map, grid_x, co_tiles, smem, s, wb, yb, s1, s2, N, H, W,
                                      Cin, Cout, transposed, stages);
    else
        err = launch_wgmma<128, false>(map, grid_x, co_tiles, smem, s, wb, yb, s1, s2, N, H, W,
                                       Cin, Cout, transposed, stages);
    return err == cudaSuccess ? 0 : -(int)err;
}

// The fold: dy, y, g (N, H, W, C) in dtype (0 float32, 1 bfloat16); ds1,
// ds2 (N, C) float32. N*H*W*ceil(C/8) < 2^31. Returns cudaGetLastError().
extern "C" int conv3x3_fold_launch(const void* dy, const void* y, const float* ds1,
                                   const float* ds2, void* g, int N, int H, int W, int C,
                                   int dtype, void* stream) {
    const int items = N * H * W * ((C + 7) / 8);
    const bool aligned = (((uintptr_t)dy | (uintptr_t)y | (uintptr_t)g) & 15) == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        launch_fold<float>(dy, y, ds1, ds2, g, items, H * W, C, false, s);
    else
        launch_fold<__nv_bfloat16>(dy, y, ds1, ds2, g, items, H * W, C, aligned && C % 8 == 0, s);
    return (int)cudaGetLastError();
}
