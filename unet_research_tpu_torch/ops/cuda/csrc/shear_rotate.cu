// Rotation of a fan of angles as three shears on Hopper (K4).
//
// Replaces unet_research_tpu/ops/pallas/shear_rotate.py::rotate_fan (kernel
// _row_resample_kernel, called once per pass through _row_resample).
//
// What it computes, for member k of K with quarter turn qm[k] and the
// per-member scalars (r, t1, q, s, t2) of ops/cuda/shear_rotate.py::fan_params:
//   canvas  C_k = rot90(place(img_k), qm[k]) on an S x S canvas, the H x W
//           image at (py, px) and zeros elsewhere;
//   pass 1  r1[y, x] = (1-f) C_k[y, x+d] + f C_k[y, x+d+1],   d + f = r*y + t1
//   pass 2  r2[y, x] = (1-f) r1[y+d, x] + f r1[y+d+1, x],     d + f = q*x + s
//   pass 3  out[i, j] = (1-f) r2[y, x+d] + f r2[y, x+d+1],    d + f = r*y + t2,
//           y = py + i, x = px + j (only the crop window is computed),
// with d = floor(shift), f = shift - d, and zero for every tap outside [0, S).
//
// Design. One thread per output element and one launch per pass. Pass 1
// reads the input image straight through the placement and the member's
// rot90 index map, so no canvas or rotated copy is stored (at a quarter turn
// of 1 or 3 a warp's reads run down a column of the input); pass 2 resamples
// the columns in place of the TPU kernel's transpose, threads of a warp on
// neighbouring x, whose source row moves by |q| <= sin 45deg a column, so a
// warp's reads spread over up to 23 rows; pass 3 writes only the crop. The
// TPU kernel's 8-row strips and whole-strip lane rolls (Mosaic has no
// per-lane gather) are not carried over.
//
// Rounding. Each shift is __fmul_rn then __fadd_rn and each blend is
// t1 * (1 - f) + t2 * f with explicit round-to-nearest operations, so nvcc
// cannot contract them into FMAs: the kernel computes the plain version's
// float32 operations in the same order and is expected to equal it bit for
// bit (the stated limit, 1e-6 max abs, only allows for a floorf edge case).
//
// Bound: memory. Per fan it needs one read of the input and one write of
// the (K, H, W) output; the two (K, S, S) float32 intermediates add a write
// and a read each, which keeps it well above that bound.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_MEMBERS = 128;  // members per launch: 3 KB of kernel parameters

struct Member {
    float r, t1, q, s, t2;
    int qm;  // quarter turn, 0..3
};

// The members' scalars travel as a kernel parameter (read through the
// constant cache, uniform across a block), so a launch needs no copy to the
// card. __grid_constant__ keeps the array in parameter space when indexed.
struct Fan {
    Member m[MAX_MEMBERS];
};

__device__ __forceinline__ float blend(float a, float b, float f) {
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ float shift(float slope, int line, float offset) {
    return __fadd_rn(__fmul_rn(slope, (float)line), offset);
}

// The rotated canvas C_k[y, x]: jnp.rot90 / torch.rot90 of the placed image.
__device__ __forceinline__ float canvas(const float* img, int qm, int y, int x, int H, int W,
                                        int S, int py, int px) {
    if (x < 0 || x >= S) return 0.0f;
    int a, b;  // row and column of the unrotated canvas
    switch (qm) {
        case 0: a = y; b = x; break;
        case 1: a = x; b = S - 1 - y; break;
        case 2: a = S - 1 - y; b = S - 1 - x; break;
        default: a = S - 1 - x; b = y; break;
    }
    a -= py;
    b -= px;
    if (a < 0 || a >= H || b < 0 || b >= W) return 0.0f;
    return img[(long long)a * W + b];
}

__global__ void shear_x_first(const float* __restrict__ img, const __grid_constant__ Fan fan,
                              int k0, float* __restrict__ r1, int nimg, int H, int W, int S,
                              int py, int px) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    const int y = blockIdx.y;
    const int k = k0 + blockIdx.z;
    if (x >= S) return;
    const Member m = fan.m[blockIdx.z];
    const float delta = shift(m.r, y, m.t1);
    const float d = floorf(delta);
    const float f = __fsub_rn(delta, d);
    const int src = x + (int)d;
    const float* im = img + (nimg == 1 ? 0 : (long long)k * H * W);
    const float a = canvas(im, m.qm, y, src, H, W, S, py, px);
    const float b = canvas(im, m.qm, y, src + 1, H, W, S, py, px);
    r1[((long long)k * S + y) * S + x] = blend(a, b, f);
}

__global__ void shear_y(const float* __restrict__ r1, const __grid_constant__ Fan fan, int k0,
                        float* __restrict__ r2, int S) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    const int y = blockIdx.y;
    const int k = k0 + blockIdx.z;
    if (x >= S) return;
    const Member m = fan.m[blockIdx.z];
    const float delta = shift(m.q, x, m.s);
    const float d = floorf(delta);
    const float f = __fsub_rn(delta, d);
    const int src = y + (int)d;
    const float* col = r1 + (long long)k * S * S + x;
    const float a = (src >= 0 && src < S) ? col[(long long)src * S] : 0.0f;
    const float b = (src + 1 >= 0 && src + 1 < S) ? col[(long long)(src + 1) * S] : 0.0f;
    r2[((long long)k * S + y) * S + x] = blend(a, b, f);
}

__global__ void shear_x_crop(const float* __restrict__ r2, const __grid_constant__ Fan fan,
                             int k0, float* __restrict__ out, int H, int W, int S, int py,
                             int px) {
    const int j = blockIdx.x * THREADS + threadIdx.x;
    const int i = blockIdx.y;
    const int k = k0 + blockIdx.z;
    if (j >= W) return;
    const Member m = fan.m[blockIdx.z];
    const int y = py + i;
    const float delta = shift(m.r, y, m.t2);
    const float d = floorf(delta);
    const float f = __fsub_rn(delta, d);
    const int src = px + j + (int)d;
    const float* row = r2 + ((long long)k * S + y) * S;
    const float a = (src >= 0 && src < S) ? row[src] : 0.0f;
    const float b = (src + 1 >= 0 && src + 1 < S) ? row[src + 1] : 0.0f;
    out[((long long)k * H + i) * W + j] = blend(a, b, f);
}

}  // namespace

// img: (nimg, H, W) float32 on the card, nimg 1 (broadcast) or K. members:
// K Member rows in host memory (r, t1, q, s, t2 as float32, qm as int32 in
// [0, 4)), read before the function returns. r1, r2: (K, S, S) float32
// scratch. out: (K, H, W) float32. Three launches per MAX_MEMBERS members.
// Returns cudaGetLastError().
extern "C" int shear_rotate_launch(const void* img, const void* members, void* r1, void* r2,
                                   void* out, int K, int nimg, int H, int W, int S, int py,
                                   int px, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Member* host = (const Member*)members;
    for (int k0 = 0; k0 < K; k0 += MAX_MEMBERS) {
        const int n = K - k0 < MAX_MEMBERS ? K - k0 : MAX_MEMBERS;
        Fan fan;
        memcpy(fan.m, host + k0, n * sizeof(Member));
        const dim3 canvas_grid((S + THREADS - 1) / THREADS, S, n);
        shear_x_first<<<canvas_grid, THREADS, 0, st>>>((const float*)img, fan, k0, (float*)r1,
                                                       nimg, H, W, S, py, px);
        int status = (int)cudaGetLastError();
        if (status != 0) return status;
        shear_y<<<canvas_grid, THREADS, 0, st>>>((const float*)r1, fan, k0, (float*)r2, S);
        status = (int)cudaGetLastError();
        if (status != 0) return status;
        shear_x_crop<<<dim3((W + THREADS - 1) / THREADS, H, n), THREADS, 0, st>>>(
            (const float*)r2, fan, k0, (float*)out, H, W, S, py, px);
        status = (int)cudaGetLastError();
        if (status != 0) return status;
    }
    return 0;
}
