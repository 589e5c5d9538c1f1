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
// Design. One launch per 128 members; a block computes one 31 x 64 tile of
// the output of one member, and nothing but that output goes to device
// memory. The passes compose, so a tile needs one window of each earlier
// stage: pass 3 reads r2 at columns [c0, c1], pass 2 reads r1 at rows
// [R0, R1] of those columns, pass 1 reads the canvas at columns [v0, v1] of
// those rows. Every floored shift is monotone in its line, so each window
// follows from the shifts at the two ends of the range before it
// (ops/cuda/shear_rotate.py::tile_windows states the same arithmetic). The
// wrapper passes bounds on the windows' sizes, which size shared memory; a
// tile whose window exceeds them traps. In a block:
//   1. pass 2's floor and fraction per window column, a table;
//   2. the canvas values that pass 1 reads are copied into shared memory by
//      4-byte cp.async, with zero fill for what lies outside the image. Under
//      the member's rot90 index map they are spans of image rows: at quarter
//      turns 0 and 2 one span per canvas row (exact, by binary search on the
//      monotone table), at 1 and 3 one per canvas column (a range of rows
//      narrowed by three rounds of the window arithmetic). About 1.4 values
//      per output, against 5 for the whole rectangle. They are stored in
//      canvas orientation at an odd row pitch, so the transposed stores and
//      pass 1's reads down a column hit distinct banks;
//   3. pass 1 computes only the r1 values that pass 2 reads: for window
//      column c, the ni + 1 rows from y0 + d2(c), a warp per column and a
//      row per lane, kept column by column at an odd pitch (a sheared window,
//      2.7x smaller than the rectangle [R0, R1]);
//   4. each output takes its two r2 taps, each from two r1 values; the
//      threads of a warp write neighbouring output columns.
// The range tests of passes 2 and 3 move into pass 1: r1 is zero outside
// the canvas, which makes r2 zero there too. The TPU kernel's 8-row strips
// and whole-strip lane rolls (Mosaic has no per-lane gather) are not
// carried over.
//
// Two launches share the tile's code. shear_fan_kernel takes the members'
// rows as a kernel parameter, copied from the host (up to 128 a launch);
// shear_fan_table_kernel reads them from a table on the card at a chunk
// index on the card (rows index * K .. index * K + K - 1), so one launch
// serves every chunk of a fan and a CUDA graph can replay it for each (the
// rotational engine's captured chunk; the JAX package runs the fan inside
// one jitted program). The shared-memory limit is raised once per card and
// kernel, at the first launch that needs more, so that a launch recorded
// into a graph makes no attribute call.
//
// Rounding. Each shift is __fmul_rn then __fadd_rn and each blend is
// t1 * (1 - f) + t2 * f with explicit round-to-nearest operations, so nvcc
// cannot contract them into FMAs: the kernel computes the plain version's
// float32 operations in the same order and equals it bit for bit.
//
// Bound: memory. Per fan it needs one read of the input and one write of the
// (K, H, W) output: at K = 16 and 584 x 565, 6.7 us (one image in) and
// 12.6 us (16 images in) at 3.35 TB/s. The kernel takes about 39 us for
// either (H100 80GB HBM3, 700 W): its time is the work of a block's phases
// (staging, pass 1, the outputs), not device memory, and neither twice the
// blocks per SM nor fewer conversions per value moved it (PERF.md).

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MEMBERS = 128;  // members per launch: 3 KB of kernel parameters
// The output tile (ops/cuda/shear_rotate.py::TILE): 31 rows give each window
// column of pass 1 its 32 r1 values, one per lane of a warp.
constexpr int TI = 31, TJ = 64;

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

__device__ __forceinline__ int floor_shift(float slope, int line, float offset) {
    return (int)floorf(shift(slope, line, offset));
}

// 4-byte asynchronous copy to shared address dst; zeros when !valid.
__device__ __forceinline__ void copy4(unsigned dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

// The first c in [0, n) with pred(c), or n; pred is false, then true.
template <typename Pred>
__device__ __forceinline__ int first_true(int n, Pred pred) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (pred(mid)) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

// One block: the tile (blockIdx.y, blockIdx.x) of member k, whose scalars
// are m.
__device__ __forceinline__ void shear_fan_tile(const float* __restrict__ img, const Member m,
                                               int k, float* __restrict__ out, int nimg, int H,
                                               int W, int S, int py, int px, int max_cols,
                                               int max_rows, int max_canvas) {
    constexpr int RP = (TI + 1) | 1;  // odd pitch of the TI + 1 r1 values of a column
    const int pitch = max_canvas | 1;
    extern __shared__ float smem[];
    float* cv = smem;                                  // canvas window [max_rows][pitch]
    float* r1 = cv + max_rows * pitch;                 // sheared r1 window [max_cols][RP]
    float* f2 = r1 + max_cols * RP;                    // pass 2's fraction per column
    int* d2 = reinterpret_cast<int*>(f2 + max_cols);   // and its floor
    int* span_lo = d2 + max_cols;                      // staged span of each line
    int* span_hi = span_lo + max(max_rows, max_canvas);

    const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
    const int ni = min(TI, H - i0), nj = min(TJ, W - j0);
    const int y0 = py + i0, y1 = y0 + ni - 1;  // the tile in canvas coordinates
    const int x0 = px + j0, x1 = x0 + nj - 1;
    int ea = floor_shift(m.r, y0, m.t2), eb = floor_shift(m.r, y1, m.t2);
    const int c0 = x0 + min(ea, eb), c1 = x1 + max(ea, eb) + 1;  // r2 columns
    ea = floor_shift(m.q, c0, m.s);
    eb = floor_shift(m.q, c1, m.s);
    const int R0 = y0 + min(ea, eb), R1 = y1 + max(ea, eb) + 1;  // r1 and canvas rows
    ea = floor_shift(m.r, R0, m.t1);
    eb = floor_shift(m.r, R1, m.t1);
    const int v0 = c0 + min(ea, eb), v1 = c1 + max(ea, eb) + 1;  // canvas columns
    const int ncols = c1 - c0 + 1, nrows = R1 - R0 + 1, nv = v1 - v0 + 1;
    if (ncols > max_cols || nrows > max_rows || nv > max_canvas) __trap();

    // 1. Pass 2's floors and fractions per window column.
    for (int c = threadIdx.x; c < ncols; c += THREADS) {
        const float delta = shift(m.q, c0 + c, m.s);
        const float d = floorf(delta);
        d2[c] = (int)d;
        f2[c] = __fsub_rn(delta, d);
    }
    __syncthreads();

    // 2. The part of the canvas window that pass 1 reads, staged along image
    // rows: canvas rows at quarter turns 0 and 2, canvas columns at 1 and 3.
    // First the span of each staging line, in canvas coordinates.
    const bool by_rows = (m.qm & 1) == 0;
    const int nlines = by_rows ? nrows : nv;
    for (int t = threadIdx.x; t < nlines; t += THREADS) {
        if (by_rows) {
            // row y takes r1 from the columns c with d2[c] in [y - y0 - ni,
            // y - y0], a range of c since d2 is monotone
            const int y = R0 + t, tlo = y - y0 - ni, thi = y - y0;
            int clo, chi;
            if (m.q >= 0.0f) {
                clo = first_true(ncols, [&](int c) { return d2[c] >= tlo; });
                chi = first_true(ncols, [&](int c) { return d2[c] > thi; }) - 1;
            } else {
                clo = first_true(ncols, [&](int c) { return d2[c] <= thi; });
                chi = first_true(ncols, [&](int c) { return d2[c] < tlo; }) - 1;
            }
            const int d1 = floor_shift(m.r, y, m.t1);
            span_lo[t] = c0 + clo + d1;
            span_hi[t] = c0 + chi + d1 + 1;
        } else {
            // column x is read by the r1 values of columns x - d1(y) - {0, 1}
            // at rows y; narrow a range of rows that holds all of them
            const int x = v0 + t;
            int ylo = R0, yhi = R1;
            for (int it = 0; it < 3 && ylo <= yhi; ++it) {
                const int ea = floor_shift(m.r, ylo, m.t1), eb = floor_shift(m.r, yhi, m.t1);
                const int clo = max(x - 1 - max(ea, eb) - c0, 0);
                const int chi = min(x - min(ea, eb) - c0, ncols - 1);
                if (clo > chi) {
                    ylo = R1 + 1;
                    break;
                }
                ylo = max(ylo, y0 + min(d2[clo], d2[chi]));
                yhi = min(yhi, y0 + max(d2[clo], d2[chi]) + ni);
            }
            span_lo[t] = ylo;
            span_hi[t] = yhi;
        }
    }
    __syncthreads();
    // Element u of staging line t is image (aA + aT * t, bB + bU * u) and
    // canvas window element t * sT + (u - u0) * sU.
    int aA, aT, bB, bU;
    switch (m.qm) {
        case 0: aA = R0 - py; aT = 1; bB = -px; bU = 1; break;                 // (a, b) = (y, x)
        case 1: aA = v0 - py; aT = 1; bB = S - 1 - px; bU = -1; break;         // (x, S-1-y)
        case 2: aA = S - 1 - R0 - py; aT = -1; bB = S - 1 - px; bU = -1; break;  // (S-1-y, S-1-x)
        default: aA = S - 1 - v0 - py; aT = -1; bB = -px; bU = 1; break;       // (S-1-x, y)
    }
    const int sT = by_rows ? pitch : 1, sU = by_rows ? 1 : pitch, u0 = by_rows ? v0 : R0;
    const float* im = img + (nimg == 1 ? 0 : (long long)k * H * W);
    const unsigned cv_s = static_cast<unsigned>(__cvta_generic_to_shared(cv));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int t = warp; t < nlines; t += THREADS / 32) {
        const int a = aA + aT * t, hi = span_hi[t];
        const bool row_in = (unsigned)a < (unsigned)H;
        const float* row = im + (long long)(row_in ? a : 0) * W;
        for (int u = span_lo[t] + lane; u <= hi; u += 32) {
            const int b = bB + bU * u;
            const bool in = row_in && (unsigned)b < (unsigned)W;
            copy4(cv_s + 4u * (t * sT + (u - u0) * sU), in ? row + b : im, in);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 3. r1 at rows y0 + d2[c] + kk, kk in [0, ni], of window column c, a
    // warp per column (one row per lane at TI = 31); zero outside the
    // canvas, where pass 2's taps are zero. A canvas tap outside [0, S) lies
    // outside the image too and reads the zero fill.
    for (int c = warp; c < ncols; c += THREADS / 32) {
        const int x = c0 + c, ybase = y0 + d2[c];
        const bool x_in = (unsigned)x < (unsigned)S;
        for (int kk = lane; kk <= ni; kk += 32) {
            const int y = ybase + kk;
            float v = 0.0f;
            if (x_in && (unsigned)y < (unsigned)S) {
                const float delta = shift(m.r, y, m.t1);
                const float d = floorf(delta);
                const float* src = cv + (y - R0) * pitch + (x + (int)d - v0);
                v = blend(src[0], src[1], __fsub_rn(delta, d));
            }
            r1[c * RP + kk] = v;
        }
    }
    __syncthreads();

    // 4. out[i, j] from r2 at columns x0 + j + d3 and the next, each r2
    // from two r1 values of its column.
    const int j = threadIdx.x % TJ;
    if (j >= nj) return;
    float* dst = out + ((long long)k * H + i0) * W + j0 + j;
    for (int i = threadIdx.x / TJ; i < ni; i += THREADS / TJ) {
        const float delta = shift(m.r, y0 + i, m.t2);
        const float d = floorf(delta);
        const int c = x0 + j + (int)d - c0;
        const float* col = r1 + c * RP + i;
        const float a = blend(col[0], col[1], f2[c]);
        const float b = blend(col[RP], col[RP + 1], f2[c + 1]);
        dst[i * W] = blend(a, b, __fsub_rn(delta, d));
    }
}

__global__ void __launch_bounds__(THREADS)
shear_fan_kernel(const float* __restrict__ img, const __grid_constant__ Fan fan, int k0,
                 float* __restrict__ out, int nimg, int H, int W, int S, int py, int px,
                 int max_cols, int max_rows, int max_canvas) {
    shear_fan_tile(img, fan.m[blockIdx.z], k0 + blockIdx.z, out, nimg, H, W, S, py, px,
                   max_cols, max_rows, max_canvas);
}

// Member k of the launch is row (*index) * gridDim.z + k of the table's
// `rows`; an index past the table traps.
__global__ void __launch_bounds__(THREADS)
shear_fan_table_kernel(const float* __restrict__ img, const Member* __restrict__ table,
                       int rows, const long long* __restrict__ index, float* __restrict__ out,
                       int nimg, int H, int W, int S, int py, int px, int max_cols,
                       int max_rows, int max_canvas) {
    const long long row = *index * gridDim.z + blockIdx.z;
    if (row < 0 || row >= rows) __trap();
    const Member m = table[row];
    shear_fan_tile(img, m, blockIdx.z, out, nimg, H, W, S, py, px, max_cols, max_rows,
                   max_canvas);
}

constexpr int MAX_DEVICES = 64;

int smem_size(int max_cols, int max_rows, int max_canvas) {
    // ops/cuda/shear_rotate.py::smem_bytes mirrors this layout
    return (max_rows * (max_canvas | 1) + max_cols * (((TI + 1) | 1) + 2) +
            2 * (max_rows > max_canvas ? max_rows : max_canvas)) * (int)sizeof(float);
}

// Raise kernel's dynamic shared-memory limit to smem on the current card
// unless an earlier call did (raised: the limit set, per card).
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int* raised, int smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (smem > raised[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        raised[dev] = smem;
    }
    return cudaSuccess;
}

int launch(const float* img, const Member* host, float* out, int K, int nimg, int H, int W,
           int S, int py, int px, int max_cols, int max_rows, int max_canvas, cudaStream_t st) {
    static int raised[MAX_DEVICES] = {};
    const int smem = smem_size(max_cols, max_rows, max_canvas);
    cudaError_t err = raise_smem(shear_fan_kernel, raised, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + TJ - 1) / TJ, (H + TI - 1) / TI);
    for (int k0 = 0; k0 < K; k0 += MAX_MEMBERS) {
        const int n = K - k0 < MAX_MEMBERS ? K - k0 : MAX_MEMBERS;
        Fan fan;
        memcpy(fan.m, host + k0, n * sizeof(Member));
        shear_fan_kernel<<<dim3(grid.x, grid.y, n), THREADS, smem, st>>>(
            img, fan, k0, out, nimg, H, W, S, py, px, max_cols, max_rows, max_canvas);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

int launch_table(const float* img, const Member* table, int rows, const long long* index,
                 float* out, int K, int nimg, int H, int W, int S, int py, int px,
                 int max_cols, int max_rows, int max_canvas, cudaStream_t st) {
    static int raised[MAX_DEVICES] = {};
    const int smem = smem_size(max_cols, max_rows, max_canvas);
    cudaError_t err = raise_smem(shear_fan_table_kernel, raised, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + TJ - 1) / TJ, (H + TI - 1) / TI, K);
    shear_fan_table_kernel<<<grid, THREADS, smem, st>>>(img, table, rows, index, out, nimg, H,
                                                        W, S, py, px, max_cols, max_rows,
                                                        max_canvas);
    return (int)cudaGetLastError();
}

}  // namespace

// img: (nimg, H, W) float32 on the card, nimg 1 (broadcast) or K. members:
// K Member rows in host memory (r, t1, q, s, t2 as float32, qm as int32 in
// [0, 4)), read before the function returns. out: (K, H, W) float32.
// (ti, tj): the output tile, which must be (TI, TJ); max_*: bounds
// on a tile's r2 columns, r1 rows and canvas columns
// (ops/cuda/shear_rotate.py::window_limits). One launch per MAX_MEMBERS
// members. Returns a cudaError_t.
extern "C" int shear_rotate_launch(const void* img, const void* members, void* out, int K,
                                   int nimg, int H, int W, int S, int py, int px, int ti,
                                   int tj, int max_cols, int max_rows, int max_canvas,
                                   void* stream) {
    const float* x = (const float*)img;
    const Member* host = (const Member*)members;
    float* y = (float*)out;
    cudaStream_t st = (cudaStream_t)stream;
    if (ti != TI || tj != TJ) return (int)cudaErrorInvalidValue;
    return launch(x, host, y, K, nimg, H, W, S, py, px, max_cols, max_rows, max_canvas, st);
}

// The same function for the K members of chunk *index of a member table:
// table holds `rows` Member rows on the card (chunks * K of them), index one
// int64 on the card, both read by the kernel. K <= 65535 (one launch).
extern "C" int shear_rotate_table_launch(const void* img, const void* table, int rows,
                                         const void* index, void* out, int K, int nimg, int H,
                                         int W, int S, int py, int px, int ti, int tj,
                                         int max_cols, int max_rows, int max_canvas,
                                         void* stream) {
    if (ti != TI || tj != TJ || K < 1 || K > 65535) return (int)cudaErrorInvalidValue;
    return launch_table((const float*)img, (const Member*)table, rows, (const long long*)index,
                        (float*)out, K, nimg, H, W, S, py, px, max_cols, max_rows, max_canvas,
                        (cudaStream_t)stream);
}
