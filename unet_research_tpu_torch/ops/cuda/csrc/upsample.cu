// TransUNet's decoder merge on Hopper: bilinear x2 upsampling (align_corners)
// written straight into the skip concatenation, the skip's zero pad included.
//
// Replaces no TPU kernel: TransUNet exists only in the port, whose decoder
// ran F.interpolate (PyTorch's NHWC bilinear kernel), torch.cat and the
// skip's F.pad as three passes over the same bytes.
//
// What it computes, for a contiguous NHWC x (N, h, w, C), C >= 16, and skip
// (N, hs, ws, Cs), hs <= 2h, ws <= 2w, both bf16 or both float32, into out
// (N, 2h, 2w, C + Cs):
//   out[..., :C] = bilinear_x2_align_corners(x), with aten's arithmetic
//                  (ATen/native/cuda/UpSample.cuh, UpSampleBilinear2d.cu's
//                  NHWC kernel, which aten runs from 16 channels up) so
//                  that the result is bit-equal to it:
//                  scale = float(in - 1) / (out - 1); src = scale * dst,
//                  i0 = (int)src, l1 = src - i0, l0 = 1 - l1, i1 = i0 + (i0 <
//                  in - 1); val = h0*(w0*a + w1*b) + h1*(w0*c + w1*d) in
//                  float32, rounded once, with the multiply-adds that nvcc
//                  fused in aten's kernel written out as intrinsics (`blend`:
//                  left to the compiler, this kernel's float32 build fused
//                  others and differed in the last bits on 18% of the
//                  elements);
//   out[..., C:] = skip where (oh, ow) < (hs, ws), else 0.
//
// Bound: memory. Each input and skip element read once, each output element
// written once: at TransUNet's four decoder merges, per member in bf16, 17.7,
// 35.3, 49.1 and 54.5 MB, 157 MB in all, 47 us at 3.35 TB/s. Design:
// - A thread owns 8 consecutive channels (an "octet") of one output pixel:
//   16-byte loads and stores in bf16, two of each in float32. Neighbouring
//   threads take neighbouring octets, then neighbouring output columns, so
//   a warp reads and writes whole 128-byte lines.
// - A block of 256 threads covers 256 octets of ROWS = 4 consecutive output
//   rows; a row's two input rows and their weight are the row's, the
//   column's two input pixels and weight the thread's. Consecutive output
//   rows share input rows, read again from L1; the neighbouring columns'
//   reads of an input pixel coalesce in the warp or hit L1. (One row a block
//   ran 5-25% slower at the decoder's shapes; 8 rows no faster than 4.)
// - The grid is (octets a row / 256, N * 2h / 4): thousands of blocks at
//   every decoder shape; past 65535 blocks a column, a block takes more rows.
// - The skip's octets are a 16-byte copy, or zeros past (hs, ws), in the
//   same pass; Cs = 0 is the plain upsampling.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;          // output rows a block covers
constexpr int MAX_ROWS = 65535;  // gridDim.y

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

// an octet of 8 channels in device memory: U 16-byte words
template <typename T>
struct Octet;

template <>
struct Octet<__nv_bfloat16> {
    static constexpr int U = 1;
    __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
    }
    __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* f) {
        *reinterpret_cast<uint4*>(p) = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                                                  pack2(f[4], f[5]), pack2(f[6], f[7]));
    }
};

template <>
struct Octet<float> {
    static constexpr int U = 2;
    __device__ __forceinline__ static void load(const float* p, float* f) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
    __device__ __forceinline__ static void store(float* p, const float* f) {
        reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
};

// aten's source index and weights at align_corners: src = scale * dst, i0
// its integer part, l1 = src - i0 (not fused), l0 = 1 - l1, and i1 = i0 + 1
// unless i0 is the last input index.
struct Tap {
    int i0, i1;
    float l0, l1;
    __device__ __forceinline__ Tap(float scale, int dst, int in) {
        const float src = __fmul_rn(scale, (float)dst);
        i0 = (int)src;
        i1 = i0 + (i0 < in - 1 ? 1 : 0);
        l1 = __fsub_rn(src, (float)i0);
        l0 = __fsub_rn(1.0f, l1);
    }
};

// aten's blend h0*(w0*a + w1*b) + h1*(w0*c + w1*d) with the multiply-adds
// that nvcc fused in aten's NHWC kernel, read off its output bits on the
// card: each sum fuses its first product, except the top row's in float32,
// which fuses its second.
template <typename T>
__device__ __forceinline__ float top(float w0, float a, float w1, float b) {
    return __fmaf_rn(w0, a, __fmul_rn(w1, b));
}

template <>
__device__ __forceinline__ float top<float>(float w0, float a, float w1, float b) {
    return __fmaf_rn(w1, b, __fmul_rn(w0, a));
}

template <typename T>
__device__ __forceinline__ float blend(const Tap& th, const Tap& tw, float a, float b, float c,
                                       float d) {
    const float t = top<T>(tw.l0, a, tw.l1, b);
    const float u = __fmaf_rn(tw.l0, c, __fmul_rn(tw.l1, d));
    return __fmaf_rn(th.l0, t, __fmul_rn(th.l1, u));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) upsample_concat_kernel(
        const T* __restrict__ x, const T* __restrict__ s, T* __restrict__ out, int N, int h,
        int w, int C, int hs, int ws, int Cs, float rh, float rw, int R) {
    const int H = 2 * h, W = 2 * w, CT = C + Cs, Q = CT >> 3;
    const int q = blockIdx.x * THREADS + threadIdx.x;  // the thread's octet in a row
    if (q >= W * Q) return;
    const int ow = q / Q, c = (q - ow * Q) * 8;
    const bool up = c < C;
    const Tap tw(rw, ow, w);
    const int first = blockIdx.y * R, last = min(first + R, N * H);
    for (int row = first; row < last; ++row) {
        const int n = row / H, oh = row - n * H;
        T* dst = out + ((size_t)row * W + ow) * CT + c;
        if (up) {
            const Tap th(rh, oh, h);
            const T* r0 = x + ((size_t)n * h + th.i0) * w * C + c;
            const T* r1 = x + ((size_t)n * h + th.i1) * w * C + c;
            float a[8], b[8], cc[8], d[8], v[8];
            Octet<T>::load(r0 + (size_t)tw.i0 * C, a);
            Octet<T>::load(r0 + (size_t)tw.i1 * C, b);
            Octet<T>::load(r1 + (size_t)tw.i0 * C, cc);
            Octet<T>::load(r1 + (size_t)tw.i1 * C, d);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                v[e] = blend<T>(th, tw, a[e], b[e], cc[e], d[e]);
            Octet<T>::store(dst, v);
        } else {
            uint4 v[Octet<T>::U];
            const int cs = c - C;
            if (oh < hs && ow < ws) {
                const uint4* src = reinterpret_cast<const uint4*>(
                    s + (((size_t)n * hs + oh) * ws + ow) * Cs + cs);
#pragma unroll
                for (int u = 0; u < Octet<T>::U; ++u) v[u] = __ldg(src + u);
            } else {
#pragma unroll
                for (int u = 0; u < Octet<T>::U; ++u) v[u] = make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < Octet<T>::U; ++u) reinterpret_cast<uint4*>(dst)[u] = v[u];
        }
    }
}

// aten's area_pixel_compute_scale at align_corners, on the host
inline float scale_of(int in) { return (float)(in - 1) / (float)(2 * in - 1); }

template <typename T>
int launch(const void* x, const void* s, void* out, int N, int h, int w, int C, int hs, int ws,
           int Cs, void* stream) {
    const int Q = (C + Cs) / 8;
    const int rows = N * 2 * h;
    const int R = rows > ROWS * MAX_ROWS ? (rows + MAX_ROWS - 1) / MAX_ROWS : ROWS;
    const dim3 grid((2 * w * Q + THREADS - 1) / THREADS, (rows + R - 1) / R);
    upsample_concat_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)s, (T*)out, N, h, w, C, hs, ws, Cs, scale_of(h), scale_of(w), R);
    return (int)cudaGetLastError();
}

}  // namespace

// x (N, h, w, C), skip (N, hs, ws, Cs) or null with Cs = 0, out (N, 2h, 2w,
// C + Cs): contiguous NHWC, 16-byte aligned, C % 8 == Cs % 8 == 0, N, h, w > 0,
// C >= 16; dtype 0 bf16, 1 float32. Returns the launch's cudaError_t.
extern "C" int upsample_concat_launch(const void* x, const void* skip, void* out, int N, int h,
                                      int w, int C, int hs, int ws, int Cs, int dtype,
                                      void* stream) {
    if (dtype == 0)
        return launch<__nv_bfloat16>(x, skip, out, N, h, w, C, hs, ws, Cs, stream);
    return launch<float>(x, skip, out, N, h, w, C, hs, ws, Cs, stream);
}
