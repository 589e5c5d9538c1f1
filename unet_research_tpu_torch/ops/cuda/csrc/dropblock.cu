// DropBlock on Hopper: the fused GroupNorm-affine + mask + activation pass
// (K1) and the dense int8 mask producer (K2).
//
// Replaces unet_research_tpu/ops/pallas/dropblock_kernel.py:
//   K1 dropblock_fused_apply (body _fused_kernel), K2 dropblock_pallas_mask
//   (body _mask_kernel), which share the seed generator _gen_block_words.
//
// What it computes, per (n, h, w, c) of an NHWC tensor:
//   seed(n,h,w,c)    = interior(h, w) && u(idx) < gamma,
//                      idx = (((o+n)*H + h)*W + w)*C + c, u = the port's counter
//                      hash (ops/dropblock.py::hash_uniform) keyed by two
//                      uint32 words, interior = [p, H-1-p] x [p, W-1-p],
//                      o = sample_offset (a rank's first global row);
//   dropped(n,h,w,c) = OR of seed over the b x b window centred at (h, w);
//   K1: out = act(dropped ? 0 : (x*a + b)), a/b per (n, c), rounded in the
//       storage type after each op as the plain version does;
//   K2: mask = !dropped as int8;
//   both: keep[n] += number of kept positions (exact, 64-bit).
//   K1's merge mode (a U-Net skip merge): the NHWC tensor is the
//       concatenation cat([relu(u*a + b), s*k], -1) of an up block's
//       pre-norm output u (C1 channels, a/b its GroupNorm coefficients, in
//       float32, rounded once: gn_apply's arithmetic) and a skip k (C2
//       channels, s its deferred per-sample scale rounded to the storage
//       type, the product rounded: a bf16 multiply), never written to
//       device memory; out = dropped ? 0 : that value, and the seeds, the
//       window and keep are the concatenation's, at its flat index.
//
// Bound: memory. K1 reads x once and writes out once (2 x 698 MB at the top
// site (16,592,576,64) bf16: 0.42 ms at 3.35 TB/s); K2 writes 1 B/element
// (0.10 ms). Instruction issue comes close behind the bytes: the seeds take
// a hash per element of the tile and its halo, about ten integer
// instructions each. The design spends as few instructions per element as
// the function allows:
// - A block owns a 32 x TW spatial tile (TW = 64 for b = 7, the main path;
//   32 for any other odd b <= 17) of one sample and a 64-channel slice: one
//   position's 64 bf16 channels are one 128-byte line, and its seeds are
//   two 32-bit words (bit = channel). The halo recompute is (32+6)(64+6) /
//   (32*64) = 1.30x the elements at b = 7.
// - Seeds: one thread per halo position hashes its 64 channels, unrolled,
//   so 64 independent hashes are in flight per lane; the interior test is
//   made once per position, and the two words are plain coalesced stores
//   (no ballot, no lane-0 store). gamma's threshold is compared on the whole
//   32-bit hash (h <= threshold*256 - 1, the same as (h >> 8) < threshold);
//   a zero threshold (drop probability 0) skips the hashing.
// - The b x b OR over words, rows then columns; with p = b // 2 a template
//   parameter (3 on the main path) the index arithmetic is by constants.
// - Apply: a thread takes 8 consecutive channels of a position (one 16-byte
//   load and store in bf16, so a warp touches 4 whole lines); its 8 drop bits
//   are one byte of a seed word; GN-affine, rounding and ReLU run on packed
//   bf16 pairs. K2 writes its 8 mask bytes with one 8-byte store.
// - The merge mode reads each 64-channel slice from the one input that holds
//   it (C1 is a multiple of 64), so the concatenation, the up block's
//   GroupNorm-ReLU pass and the skip's scale pass cost no bytes beyond the
//   bare merge site's: 2 x (C1 + C2) channels a position, in and out.
// The TPU kernel's bit planes along sublanes, its 8-row PRNG strips and its
// 16-bit gamma are TPU devices and are not carried over: the hash is
// counter-based, so halo seeds are simply recomputed by the neighbouring
// tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TH = 32;            // spatial tile rows
constexpr int CS = 64;            // channels per block (two seed words)
constexpr uint32_t HASH_K = 2654435761u;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// round to the storage type and back: one rounding step of the plain version
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// the counter hash of ops/dropblock.py::hash_uniform, from idx * HASH_K
__device__ __forceinline__ uint32_t hash_from(uint32_t idx_k, uint32_t k0, uint32_t k1) {
    uint32_t x = idx_k ^ k0;
    x = x ^ (x >> 16);
    x = x * 0x7FEB352Du;
    x = x ^ (x >> 15) ^ k1;
    x = x * 0x846CA68Bu;
    return x ^ (x >> 16);
}

// 32 seed bits of channels c0 .. c0+31 of one position
__device__ __forceinline__ uint32_t seed_word(uint32_t base_k, int c0, uint32_t k0, uint32_t k1,
                                              uint32_t lim) {
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c)
        if (hash_from(base_k + (uint32_t)(c0 + c) * HASH_K, k0, k1) <= lim) word |= 1u << c;
    return word;
}

// bf16 pair <-> two floats
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// keep mask of a bf16 pair from two drop bits
__device__ __forceinline__ uint32_t keep_pair(uint32_t bits2) {
    return ((bits2 & 1u) ? 0u : 0x0000FFFFu) | ((bits2 & 2u) ? 0u : 0xFFFF0000u);
}

// K1 on 8 bf16 channels: x*a, +b (each rounded to bf16), drop, act
__device__ __forceinline__ uint4 apply8(uint4 v, uint32_t bits, bool affine, const float* a,
                                        const float* b, int act, float slope) {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint32_t pr = w[i];
        if (affine) {
            pr = pack2(__fmul_rn(lo_f(pr), a[2 * i]), __fmul_rn(hi_f(pr), a[2 * i + 1]));
            pr = pack2(__fadd_rn(lo_f(pr), b[2 * i]), __fadd_rn(hi_f(pr), b[2 * i + 1]));
        }
        pr &= keep_pair(bits >> (2 * i));
        if (act == 1) {
            // y > 0 ? y : 0 on the bits: a set sign bit (negative or -0) gives 0
            pr &= ~(((pr >> 15) & 0x00010001u) * 0xFFFFu);
        } else if (act == 2) {
            float lo = lo_f(pr), hi = hi_f(pr);
            lo = lo > 0.0f ? lo : rnd<__nv_bfloat16>(__fmul_rn(lo, slope));
            hi = hi > 0.0f ? hi : rnd<__nv_bfloat16>(__fmul_rn(hi, slope));
            pr = pack2(lo, hi);
        }
        w[i] = pr;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// merge mode, the up half on 8 bf16 channels: relu(x*a + b) in float32,
// rounded once (gn_apply's arithmetic), then drop
__device__ __forceinline__ uint4 merge_up8(uint4 v, uint32_t bits, const float* a,
                                           const float* b) {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float lo = __fadd_rn(__fmul_rn(lo_f(w[i]), a[2 * i]), b[2 * i]);
        float hi = __fadd_rn(__fmul_rn(hi_f(w[i]), a[2 * i + 1]), b[2 * i + 1]);
        lo = lo <= 0.0f ? 0.0f : lo;
        hi = hi <= 0.0f ? 0.0f : hi;
        w[i] = pack2(lo, hi) & keep_pair(bits >> (2 * i));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// merge mode, the skip half on 8 bf16 channels: x*s rounded (s a bf16
// value; scaled false: s = 1, no multiply), then drop
__device__ __forceinline__ uint4 merge_skip8(uint4 v, uint32_t bits, bool scaled, float s) {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint32_t pr = w[i];
        if (scaled) pr = pack2(__fmul_rn(lo_f(pr), s), __fmul_rn(hi_f(pr), s));
        w[i] = pr & keep_pair(bits >> (2 * i));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// the same on one element of either type
template <typename T>
__device__ __forceinline__ T apply1(T xv, bool dropped, bool affine, float a, float b, int act,
                                    float slope) {
    float y = to_f(xv);
    if (affine) y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(y, a)), b));
    if (dropped) y = 0.0f;
    if (act == 1) y = y > 0.0f ? y : 0.0f;
    else if (act == 2) y = y > 0.0f ? y : rnd<T>(__fmul_rn(y, slope));
    return from_f<T>(y);
}

// 8 keep bytes (1 kept, 0 dropped) from 8 drop bits
__device__ __forceinline__ uint2 mask_bytes(uint32_t bits) {
    const uint32_t keep = ~bits & 0xFFu;
    return make_uint2(((keep & 0xFu) * 0x00204081u) & 0x01010101u,
                      ((keep >> 4) * 0x00204081u) & 0x01010101u);
}

// MODE 0: int8 keep-mask (K2). MODE 1: fused apply (K1). P: p = b // 2 as a
// constant, or 0 for a runtime p <= 8. TW: tile columns. MERGE (MODE 1, bf16):
// K1's merge mode, C = C1 + C2 output channels, channels [0, C1) from x
// (C1 a multiple of CS, ab its (2, N, C1) coefficients) and [C1, C) from
// skip, scaled by sscale[n] (or null: unscaled).
template <typename T, int MODE, int P, int TW, bool MERGE = false>
__device__ __forceinline__ void dropblock_tile(
        const T* __restrict__ x, T* __restrict__ out, int8_t* __restrict__ mask,
        const float* __restrict__ ab, unsigned long long* __restrict__ keep,
        const long long* __restrict__ key, int N, int H, int W, int C, int sample_offset,
        uint32_t threshold, int p_rt, int act, float slope,
        const T* __restrict__ skip = nullptr, const float* __restrict__ sscale = nullptr,
        int C1 = 0) {
    constexpr int MAXP = P > 0 ? P : 8;
    constexpr int SH = TH + 2 * MAXP;
    constexpr int SWM = TW + 2 * MAXP;
    // seeds [2][sh*sw], reused as the drop words [2][TH*TW]; row ORs [2][TH*sw]
    __shared__ uint32_t s_seed[2 * SH * SWM];
    __shared__ uint32_t s_vert[2 * TH * SWM];
    __shared__ unsigned long long s_cnt[WARPS];

    const int p = P > 0 ? P : p_rt;
    const int sw = TW + 2 * p;
    const int sh = TH + 2 * p;
    const int tiles_w = (W + TW - 1) / TW;
    const int h0 = (blockIdx.x / tiles_w) * TH;
    const int w0 = (blockIdx.x % tiles_w) * TW;
    const int cs = blockIdx.y * CS;
    const int n = blockIdx.z;
    const int tid = threadIdx.x;
    const int nch = min(CS, C - cs);
    const uint32_t cm0 = nch >= 32 ? 0xFFFFFFFFu : ((1u << nch) - 1u);
    const uint32_t cm1 = nch >= 64 ? 0xFFFFFFFFu : (nch > 32 ? ((1u << (nch - 32)) - 1u) : 0u);
    const uint32_t k0 = (uint32_t)key[0];
    const uint32_t k1 = (uint32_t)key[1];
    // (h >> 8) < threshold  <=>  h <= threshold * 256 - 1, for threshold >= 1
    const uint32_t lim = (threshold << 8) - 1u;

    // 1. seed words of the tile and its halo, one position per thread. The
    //    flat index is global: sample n of this launch is row
    //    sample_offset + n of the batch the counter spans (a rank's rows of
    //    a global batch), and it runs in uint32: the wrapper checks that
    //    (sample_offset + N) * H * W * C < 2^32.
    const int plane_s = sh * sw;
    for (int q = tid; q < plane_s; q += THREADS) {
        const int r = q / sw;
        const int col = q - r * sw;
        const int hh = h0 - p + r;
        const int ww = w0 - p + col;
        uint32_t word0 = 0, word1 = 0;
        if (threshold != 0 && hh >= p && hh <= H - 1 - p && ww >= p && ww <= W - 1 - p) {
            const uint32_t base_k =
                ((((uint32_t)(sample_offset + n) * H + (uint32_t)hh) * W + (uint32_t)ww) * C + cs)
                * HASH_K;
            word0 = seed_word(base_k, 0, k0, k1, lim) & cm0;
            if (nch > 32) word1 = seed_word(base_k, 32, k0, k1, lim) & cm1;
        }
        s_seed[q] = word0;
        s_seed[plane_s + q] = word1;
    }
    __syncthreads();

    // 2. OR over the 2p+1 rows of each window
    const int plane_v = TH * sw;
    for (int i = tid; i < 2 * plane_v; i += THREADS) {
        const int plane = i >= plane_v;
        const int rem = i - plane * plane_v;
        const int r = rem / sw;
        const int col = rem - r * sw;
        const uint32_t* src = s_seed + plane * plane_s + r * sw + col;
        uint32_t v = 0;
#pragma unroll
        for (int d = 0; d <= 2 * MAXP; ++d)
            if (P > 0 || d <= 2 * p) v |= src[d * sw];
        s_vert[i] = v;
    }
    __syncthreads();

    // 3. OR over the 2p+1 columns into the drop words [2][TH][TW]; count the
    //    kept positions of the tile
    constexpr int PLANE_D = TH * TW;
    unsigned long long kept = 0;
    for (int i = tid; i < 2 * PLANE_D; i += THREADS) {
        const int plane = i / PLANE_D;
        const int rem = i - plane * PLANE_D;
        const int r = rem / TW;
        const int col = rem - r * TW;
        const uint32_t* src = s_vert + plane * plane_v + r * sw + col;
        uint32_t v = 0;
#pragma unroll
        for (int d = 0; d <= 2 * MAXP; ++d)
            if (P > 0 || d <= 2 * p) v |= src[d];
        s_seed[i] = v;
        if (h0 + r < H && w0 + col < W) kept += __popc((plane ? cm1 : cm0) & ~v);
    }
    for (int o = 16; o > 0; o >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, o);
    if ((tid & 31) == 0) s_cnt[tid >> 5] = kept;
    __syncthreads();
    if (tid == 0) {
        unsigned long long total = 0;
        for (int w = 0; w < WARPS; ++w) total += s_cnt[w];
        atomicAdd(keep + n, total);
    }

    // 4. write: a thread owns channels c .. c+7 of one position per step, 32
    //    positions a step
    const int j = tid & 7;
    const int c = cs + 8 * j;
    if (c >= C) return;
    const bool vec = (C & 7) == 0;
    const uint32_t* drop = s_seed + (j >> 2) * PLANE_D;
    const int shift = (j & 3) * 8;
    if constexpr (MERGE) {
        // the block's slice lies in one input: the up half's or the skip's
        const bool up = cs < C1;
        const T* src = up ? x : skip;
        const int c_in = up ? C1 : C - C1;
        const int c_src = up ? c : c - C1;
        float a[8], b[8];
        const bool scaled = sscale != nullptr;
        const float s = scaled ? rnd<__nv_bfloat16>(sscale[n]) : 1.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            a[e] = up ? ab[(size_t)n * C1 + c + e] : 1.0f;
            b[e] = up ? ab[(size_t)N * C1 + (size_t)n * C1 + c + e] : 0.0f;
        }
#pragma unroll 4
        for (int q = tid >> 3; q < PLANE_D; q += THREADS / 8) {
            const int r = q / TW;
            const int col = q - r * TW;
            const int hh = h0 + r;
            const int ww = w0 + col;
            if (hh >= H || ww >= W) continue;
            const uint32_t bits = (drop[q] >> shift) & 0xFFu;
            const size_t pos = ((size_t)n * H + hh) * W + ww;
            const uint4 v = *reinterpret_cast<const uint4*>(src + pos * c_in + c_src);
            *reinterpret_cast<uint4*>(out + pos * C + c) =
                up ? merge_up8(v, bits, a, b) : merge_skip8(v, bits, scaled, s);
        }
        return;
    }
    const bool affine = MODE == 1 && ab != nullptr;
    float a[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        a[e] = 1.0f;
        b[e] = 0.0f;
        if (affine && c + e < C) {
            a[e] = rnd<T>(ab[(size_t)n * C + c + e]);
            b[e] = rnd<T>(ab[(size_t)N * C + (size_t)n * C + c + e]);
        }
    }
#pragma unroll 4
    for (int q = tid >> 3; q < PLANE_D; q += THREADS / 8) {
        const int r = q / TW;
        const int col = q - r * TW;
        const int hh = h0 + r;
        const int ww = w0 + col;
        if (hh >= H || ww >= W) continue;
        const uint32_t bits = (drop[q] >> shift) & 0xFFu;
        const size_t off = (((size_t)n * H + hh) * W + ww) * C + c;
        if (MODE == 0) {
            if (vec) {
                *reinterpret_cast<uint2*>(mask + off) = mask_bytes(bits);
            } else {
                for (int e = 0; e < 8 && c + e < C; ++e) mask[off + e] = ((bits >> e) & 1u) ? 0 : 1;
            }
        } else if (vec && sizeof(T) == 2) {
            const uint4 v = *reinterpret_cast<const uint4*>(x + off);
            *reinterpret_cast<uint4*>(out + off) = apply8(v, bits, affine, a, b, act, slope);
        } else if (vec) {
            const float4* src = reinterpret_cast<const float4*>(x + off);
            float4* dst = reinterpret_cast<float4*>(out + off);
#pragma unroll
            for (int hv = 0; hv < 2; ++hv) {
                const float4 v = src[hv];
                const float in[4] = {v.x, v.y, v.z, v.w};
                float o[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    o[e] = to_f(apply1<T>(from_f<T>(in[e]), (bits >> (4 * hv + e)) & 1u, affine,
                                          a[4 * hv + e], b[4 * hv + e], act, slope));
                dst[hv] = make_float4(o[0], o[1], o[2], o[3]);
            }
        } else {
            for (int e = 0; e < 8 && c + e < C; ++e)
                out[off + e] = apply1<T>(x[off + e], (bits >> e) & 1u, affine, a[e], b[e], act,
                                         slope);
        }
    }
}

template <typename T, int P, int TW>
__global__ void __launch_bounds__(THREADS, 4)
dropblock_apply_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ ab,
                       unsigned long long* __restrict__ keep, const long long* __restrict__ key,
                       int N, int H, int W, int C, int sample_offset, uint32_t threshold, int p,
                       int act, float slope) {
    dropblock_tile<T, 1, P, TW>(x, out, nullptr, ab, keep, key, N, H, W, C, sample_offset,
                                threshold, p, act, slope);
}

// K1's merge mode: the tile template on two inputs (dropblock_tile, MERGE)
template <int P, int TW>
__global__ void __launch_bounds__(THREADS, 4)
dropblock_apply_kernel_merge(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ skip,
                             __nv_bfloat16* __restrict__ out, const float* __restrict__ ab,
                             const float* __restrict__ sscale,
                             unsigned long long* __restrict__ keep,
                             const long long* __restrict__ key, int N, int H, int W, int C1,
                             int C, int sample_offset, uint32_t threshold, int p) {
    dropblock_tile<__nv_bfloat16, 1, P, TW, true>(x, out, nullptr, ab, keep, key, N, H, W, C,
                                                  sample_offset, threshold, p, 0, 0.0f, skip,
                                                  sscale, C1);
}

// threshold_dev: the threshold as a word on the device (a train step's,
// computed there from its drop probability), or null for the scalar
template <int P, int TW>
__global__ void __launch_bounds__(THREADS, 4)
dropblock_mask_kernel(int8_t* __restrict__ mask, unsigned long long* __restrict__ keep,
                      const long long* __restrict__ key, int N, int H, int W, int C,
                      int sample_offset, uint32_t threshold,
                      const uint32_t* __restrict__ threshold_dev, int p) {
    if (threshold_dev != nullptr) threshold = *threshold_dev;
    dropblock_tile<float, 0, P, TW>(nullptr, nullptr, mask, nullptr, keep, key, N, H, W, C,
                                    sample_offset, threshold, p, 0, 0.0f);
}

dim3 grid_for(int N, int H, int W, int C, int tw) {
    return dim3(((H + TH - 1) / TH) * ((W + tw - 1) / tw), (C + CS - 1) / CS, N);
}

template <typename T>
void launch_apply(const void* x, void* out, const float* ab, void* keep, const void* key, int N,
                  int H, int W, int C, int sample_offset, unsigned threshold, int p, int act,
                  float slope, cudaStream_t s) {
    if (p == 3) {
        dropblock_apply_kernel<T, 3, 64><<<grid_for(N, H, W, C, 64), THREADS, 0, s>>>(
            (const T*)x, (T*)out, ab, (unsigned long long*)keep, (const long long*)key, N, H, W,
            C, sample_offset, threshold, p, act, slope);
    } else {
        dropblock_apply_kernel<T, 0, 32><<<grid_for(N, H, W, C, 32), THREADS, 0, s>>>(
            (const T*)x, (T*)out, ab, (unsigned long long*)keep, (const long long*)key, N, H, W,
            C, sample_offset, threshold, p, act, slope);
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 leaky_relu.
// threshold: ceil(gamma * 2^24) clamped to [0, 2^24], gamma in float32: a seed
// is drawn where the hash's top 24 bits, as an integer, are below it, which
// is exactly u < gamma for the float32 uniform u = (bits >> 8) * 2^-24.
// ab: (2, N, C) float32 or null. keep: (N,) 64-bit, zeroed by the caller.
// key: two int64 words on the device. sample_offset: the global index of
// sample 0, where its hash counters start ((sample_offset + N) * H * W * C
// < 2^32); keep and the output stay indexed by the local sample. x and out
// 16-byte aligned. Odd block_size <= 17. Returns cudaGetLastError().
extern "C" int dropblock_fused_apply_launch(const void* x, void* out, const float* ab,
                                            void* keep, const void* key, int N, int H,
                                            int W, int C, int sample_offset, unsigned threshold,
                                            int block_size, int act, float slope, int dtype,
                                            void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int p = block_size / 2;
    if (dtype == 0)
        launch_apply<float>(x, out, ab, keep, key, N, H, W, C, sample_offset, threshold, p, act,
                            slope, s);
    else
        launch_apply<__nv_bfloat16>(x, out, ab, keep, key, N, H, W, C, sample_offset, threshold,
                                    p, act, slope, s);
    return (int)cudaGetLastError();
}

// K1's merge mode over bf16 NHWC inputs: x (N, H, W, C1) with ab (2, N, C1)
// float32, skip (N, H, W, C2), sscale (N,) float32 or null; out (N, H, W,
// C1 + C2). C1 and C2 multiples of 64; x, skip and out 16-byte aligned.
// Seeds, keep and sample_offset as dropblock_fused_apply_launch's, over the
// concatenation ((sample_offset + N) * H * W * (C1 + C2) < 2^32).
extern "C" int dropblock_merge_apply_launch(const void* x, const void* skip, void* out,
                                            const float* ab, const float* sscale, void* keep,
                                            const void* key, int N, int H, int W, int C1,
                                            int C2, int sample_offset, unsigned threshold,
                                            int block_size, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int p = block_size / 2;
    const int C = C1 + C2;
    if (p == 3) {
        dropblock_apply_kernel_merge<3, 64><<<grid_for(N, H, W, C, 64), THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)skip, (__nv_bfloat16*)out, ab,
            sscale, (unsigned long long*)keep, (const long long*)key, N, H, W, C1, C,
            sample_offset, threshold, p);
    } else {
        dropblock_apply_kernel_merge<0, 32><<<grid_for(N, H, W, C, 32), THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)skip, (__nv_bfloat16*)out, ab,
            sscale, (unsigned long long*)keep, (const long long*)key, N, H, W, C1, C,
            sample_offset, threshold, p);
    }
    return (int)cudaGetLastError();
}

// K2. threshold_dev: null, or a word on the device that replaces `threshold`
// (the same integer, read by every thread when the kernel starts; the low
// word of a little-endian int64 does).
extern "C" int dropblock_mask_launch(void* mask, void* keep, const void* key, int N, int H,
                                     int W, int C, int sample_offset, unsigned threshold,
                                     const unsigned* threshold_dev, int block_size,
                                     void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int p = block_size / 2;
    if (p == 3) {
        dropblock_mask_kernel<3, 64><<<grid_for(N, H, W, C, 64), THREADS, 0, s>>>(
            (int8_t*)mask, (unsigned long long*)keep, (const long long*)key, N, H, W, C,
            sample_offset, threshold, threshold_dev, p);
    } else {
        dropblock_mask_kernel<0, 32><<<grid_for(N, H, W, C, 32), THREADS, 0, s>>>(
            (int8_t*)mask, (unsigned long long*)keep, (const long long*)key, N, H, W, C,
            sample_offset, threshold, threshold_dev, p);
    }
    return (int)cudaGetLastError();
}
