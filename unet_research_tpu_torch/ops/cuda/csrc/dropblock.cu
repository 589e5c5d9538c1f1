// DropBlock on Hopper: the fused GroupNorm-affine + mask + activation pass
// (K1) and the dense int8 mask producer (K2).
//
// Replaces unet_research_tpu/ops/pallas/dropblock_kernel.py:
//   K1 dropblock_fused_apply (body _fused_kernel), K2 dropblock_pallas_mask
//   (body _mask_kernel), which share the seed generator _gen_block_words.
//
// What it computes, per (n, h, w, c) of an NHWC tensor:
//   seed(n,h,w,c)    = interior(h, w) && u(idx) < gamma,
//                      idx = ((n*H + h)*W + w)*C + c, u = the port's counter
//                      hash (ops/dropblock.py::hash_uniform) keyed by two
//                      uint32 words, interior = [p, H-1-p] x [p, W-1-p];
//   dropped(n,h,w,c) = OR of seed over the b x b window centred at (h, w);
//   K1: out = act(dropped ? 0 : (x*a + b)), a/b per (n, c), rounded in the
//       storage type after each op as the plain version does;
//   K2: mask = !dropped as int8;
//   both: keep[n] += number of kept positions (exact, 64-bit).
//
// Design. One block owns a 32x32 spatial tile of one sample and a slice of
// 32 channels. A warp walks one halo row; at each position its 32 lanes hash
// the 32 channels and __ballot_sync packs the seeds into one word, so the tile
// plus its p = b//2 halo is a small array of words in shared memory and the
// b x b expansion is 2(2p+1) ORs per word (rows, then columns) for all 32
// channels at once. The apply is lane = channel, so each warp touches 32
// consecutive NHWC elements per position. The TPU kernel's bit planes along
// sublanes, its 8-row PRNG strips and its 16-bit gamma are TPU devices and
// are not carried over: the hash is counter-based, so halo seeds are simply
// recomputed by the neighbouring tile.
//
// Bound: memory. K1 reads x once and writes out once (2 x 698 MB at the top
// site (16,592,576,64) bf16: 0.42 ms at 3.35 TB/s); K2 writes 1 B/element
// (0.10 ms). In practice both are held up by the seed phase, one hash per
// element and halo position (1.41x the elements at b=7), not by the bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;          // spatial tile edge
constexpr int MAX_P = 8;          // b <= 17
constexpr int HALO = TILE + 2 * MAX_P;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t k0, uint32_t k1) {
    uint32_t x = (idx * 2654435761u) ^ k0;
    x = x ^ (x >> 16);
    x = x * 0x7FEB352Du;
    x = x ^ (x >> 15) ^ k1;
    x = x * 0x846CA68Bu;
    x = x ^ (x >> 16);
    return x;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// round to the storage type and back: one rounding step of the plain version
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// MODE 0: int8 keep-mask only (K2). MODE 1: fused apply (K1).
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
dropblock_kernel(const T* __restrict__ x, T* __restrict__ out, int8_t* __restrict__ mask,
                 const float* __restrict__ ab, unsigned long long* __restrict__ keep,
                 const long long* __restrict__ key, int N, int H, int W, int C,
                 uint32_t threshold, int p, int act, float slope) {
    __shared__ uint32_t s_seed[HALO * HALO];
    __shared__ uint32_t s_vert[TILE * HALO];
    __shared__ uint32_t s_drop[TILE * TILE];
    __shared__ unsigned long long s_cnt[WARPS];

    const int tiles_w = (W + TILE - 1) / TILE;
    const int h0 = (blockIdx.x / tiles_w) * TILE;
    const int w0 = (blockIdx.x % tiles_w) * TILE;
    const int c0 = blockIdx.y * 32;
    const int n = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c = c0 + lane;
    const bool c_ok = c < C;
    const uint32_t k0 = (uint32_t)key[0];
    const uint32_t k1 = (uint32_t)key[1];
    const int sw = TILE + 2 * p;   // halo tile edge for this block size

    // 1. seed words of the tile and its halo: one warp per halo row, one
    //    ballot per position. The flat index runs in uint32: it is < 2^32
    //    wherever a seed can sit, so wrapping intermediates do no harm.
    for (int r = warp; r < sw; r += WARPS) {
        const int hh = h0 - p + r;
        const bool row_ok = c_ok && hh >= p && hh <= H - 1 - p;
        uint32_t idx = (((uint32_t)n * H + (uint32_t)hh) * W + (uint32_t)(w0 - p)) * C + c;
        for (int col = 0; col < sw; ++col, idx += (uint32_t)C) {
            const int ww = w0 - p + col;
            // u < gamma on the 24-bit uniform, as the integer (bits >> 8) < threshold
            const bool seed = row_ok && ww >= p && ww <= W - 1 - p
                              && (hash_bits(idx, k0, k1) >> 8) < threshold;
            const uint32_t word = __ballot_sync(0xffffffffu, seed);
            if (lane == 0) s_seed[r * sw + col] = word;
        }
    }
    __syncthreads();

    // 2. OR over the 2p+1 rows of each window
    for (int i = threadIdx.x; i < TILE * sw; i += THREADS) {
        const int r = i / sw;
        const int col = i % sw;
        uint32_t v = 0;
        for (int d = 0; d <= 2 * p; ++d) v |= s_seed[(r + d) * sw + col];
        s_vert[i] = v;
    }
    __syncthreads();

    // 3. OR over the 2p+1 columns; count the kept positions of the tile
    const uint32_t cmask = (C - c0 >= 32) ? 0xffffffffu : ((1u << (C - c0)) - 1u);
    unsigned long long kept = 0;
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
        const int r = i / TILE;
        const int col = i % TILE;
        uint32_t v = 0;
        for (int d = 0; d <= 2 * p; ++d) v |= s_vert[r * sw + col + d];
        s_drop[i] = v;
        if (h0 + r < H && w0 + col < W) kept += __popc(cmask & ~v);
    }
    for (int o = 16; o > 0; o >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, o);
    if (lane == 0) s_cnt[warp] = kept;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long total = 0;
        for (int w = 0; w < WARPS; ++w) total += s_cnt[w];
        atomicAdd(keep + n, total);
    }
    if (!c_ok) return;

    // 4. write: lane = channel, one position per warp iteration
    float a = 1.0f, b = 0.0f;
    const bool affine = MODE == 1 && ab != nullptr;
    if (affine) {
        a = rnd<T>(ab[(size_t)n * C + c]);
        b = rnd<T>(ab[(size_t)N * C + (size_t)n * C + c]);
    }
    for (int i = warp; i < TILE * TILE; i += WARPS) {
        const int hh = h0 + i / TILE;
        const int ww = w0 + i % TILE;
        if (hh >= H || ww >= W) continue;
        const size_t off = (((size_t)n * H + hh) * W + ww) * C + c;
        const bool dropped = (s_drop[i] >> lane) & 1u;
        if (MODE == 0) {
            mask[off] = dropped ? 0 : 1;
        } else {
            float y = to_f(x[off]);
            if (affine) y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(y, a)), b));
            if (dropped) y = 0.0f;
            if (act == 1) y = y > 0.0f ? y : 0.0f;
            else if (act == 2) y = y > 0.0f ? y : rnd<T>(__fmul_rn(y, slope));
            out[off] = from_f<T>(y);
        }
    }
}

dim3 grid_for(int N, int H, int W, int C) {
    return dim3(((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE), (C + 31) / 32, N);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 leaky_relu.
// threshold: ceil(gamma * 2^24) clamped to [0, 2^24], gamma in float32: a seed
// is drawn where the hash's top 24 bits, as an integer, are below it, which
// is exactly u < gamma for the float32 uniform u = (bits >> 8) * 2^-24.
// ab: (2, N, C) float32 or null. keep: (N,) 64-bit, zeroed by the caller.
// key: two int64 words on the device. Returns cudaGetLastError().
extern "C" int dropblock_fused_apply_launch(const void* x, void* out, const float* ab,
                                            void* keep, const void* key, int N, int H,
                                            int W, int C, unsigned threshold,
                                            int block_size, int act, float slope, int dtype,
                                            void* stream) {
    const dim3 grid = grid_for(N, H, W, C);
    cudaStream_t s = (cudaStream_t)stream;
    const int p = block_size / 2;
    if (dtype == 0) {
        dropblock_kernel<float, 1><<<grid, THREADS, 0, s>>>(
            (const float*)x, (float*)out, nullptr, ab, (unsigned long long*)keep,
            (const long long*)key, N, H, W, C, threshold, p, act, slope);
    } else {
        dropblock_kernel<__nv_bfloat16, 1><<<grid, THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (__nv_bfloat16*)out, nullptr, ab,
            (unsigned long long*)keep, (const long long*)key, N, H, W, C, threshold, p, act,
            slope);
    }
    return (int)cudaGetLastError();
}

extern "C" int dropblock_mask_launch(void* mask, void* keep, const void* key, int N, int H,
                                     int W, int C, unsigned threshold, int block_size,
                                     void* stream) {
    dropblock_kernel<float, 0><<<grid_for(N, H, W, C), THREADS, 0, (cudaStream_t)stream>>>(
        nullptr, nullptr, (int8_t*)mask, nullptr, (unsigned long long*)keep,
        (const long long*)key, N, H, W, C, threshold, block_size / 2, 0, 0.0f);
    return (int)cudaGetLastError();
}
