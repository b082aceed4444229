// Tile compositor, forward: front-to-back alpha compositing of the
// (tile, depth)-sorted intersections, one block per tile, one thread per pixel.
//
// Replaces the TPU kernel freegaussian_tpu/ops/rasterize_pallas.py:_fwd_kernel
// (launcher _run_fwd, with _alphas and _transmittance). It computes what that
// kernel computes, per pixel:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  alpha = min(0.999, op exp(-sigma))
//   skip the pair if sigma < 0 or alpha < 1/255 (or, at a tile size other
//   than 16, if the pixel's 16-px contract tile lies outside the Gaussian's
//   radius bbox: the gate of _alphas)
//   next_T = T (1 - alpha); if next_T <= 1e-4 the pixel terminates and this
//   Gaussian is NOT composited; else accumulate w = alpha T into color and alpha.
// Outputs, for every pixel of the image: color (H, W, C), alpha (H, W),
// livecnt (H, W) = slots of the tile's run walked before termination, and
// t_final (H, W) = transmittance after the last composited Gaussian.
//
// Bound on an H100: the work is one exp and ~22 + 2C f32 operations per
// (pixel, intersection) pair inside the Gaussian's 16-px tile bbox, up to the
// pixel's termination, against a read-once cost of the per-Gaussian rows
// ((7 + C) floats), one id per intersection and H*W*(C+3) output words. At the
// serving point (N = 1e5, 640x480) the operations bound it (chip_smoke.py
// prints both bounds from the run's own data). This first version stages each
// batch of 256 rows in shared memory (one row per thread, the contract bbox
// precomputed per row), and leaves the block as soon as __syncthreads_count
// says every pixel of the tile has terminated. Warp-level culling and smaller
// staged rows are later work.
//
// Built with -fmad=false so every product and sum rounds as PyTorch's
// separate elementwise kernels do: the plain version then reaches the same
// termination decisions bit for bit.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr int kMaxChannels = 8;
constexpr int kBatch = 256;
constexpr float kContractTile = 16.0f;

template <int TILE>
__global__ void __launch_bounds__(TILE * TILE)
rasterize_fwd_kernel(const float* __restrict__ means2d,    // (N, 2)
                     const float* __restrict__ conics,     // (N, 3)
                     const float* __restrict__ opacities,  // (N,)
                     const float* __restrict__ colors,     // (N, C)
                     const float* __restrict__ radii,      // (N,) bbox radius
                     const int32_t* __restrict__ gauss_ids,     // (I,)
                     const int32_t* __restrict__ tile_offsets,  // (T + 1,)
                     int C, int width, int height, int tiles_w, int gate,
                     float* __restrict__ out_color,    // (H, W, C)
                     float* __restrict__ out_alpha,    // (H, W)
                     int32_t* __restrict__ out_livecnt,  // (H, W)
                     float* __restrict__ out_tfinal)   // (H, W)
{
    __shared__ float s_mx[kBatch], s_my[kBatch];
    __shared__ float s_ca[kBatch], s_cb[kBatch], s_cc[kBatch];
    __shared__ float s_op[kBatch];
    // the Gaussian's radius bbox in 16-px contract tiles: [x0, x1) x [y0, y1)
    __shared__ float s_x0[kBatch], s_x1[kBatch], s_y0[kBatch], s_y1[kBatch];
    __shared__ float s_col[kBatch * kMaxChannels];

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int x = (tile % tiles_w) * TILE + tid % TILE;
    const int y = (tile / tiles_w) * TILE + tid / TILE;
    const bool inside = x < width && y < height;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    // the pixel's contract tile, as _alphas computes it
    const float ctx = floorf((px - 0.5f) / kContractTile);
    const float cty = floorf((py - 0.5f) / kContractTile);

    const int start = tile_offsets[tile];
    const int end = tile_offsets[tile + 1];

    float T = 1.0f;
    float acc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
    float acc_alpha = 0.0f;
    int walked = 0;
    bool done = !inside;

    for (int b0 = start; b0 < end; b0 += kBatch) {
        // also the barrier that keeps the previous batch's rows until all
        // threads have read them
        if (__syncthreads_count(!done) == 0) break;
        const int j = b0 + tid;
        if (tid < kBatch && j < end) {
            const int g = gauss_ids[j];
            s_mx[tid] = means2d[2 * g];
            s_my[tid] = means2d[2 * g + 1];
            s_ca[tid] = conics[3 * g];
            s_cb[tid] = conics[3 * g + 1];
            s_cc[tid] = conics[3 * g + 2];
            s_op[tid] = opacities[g];
            if (gate) {
                // the same f32 arithmetic as tile_bounds (/16 is exact)
                const float r = radii[g];
                s_x0[tid] = floorf((s_mx[tid] - r) / kContractTile);
                s_x1[tid] = ceilf((s_mx[tid] + r) / kContractTile);
                s_y0[tid] = floorf((s_my[tid] - r) / kContractTile);
                s_y1[tid] = ceilf((s_my[tid] + r) / kContractTile);
            }
            for (int c = 0; c < C; ++c) s_col[tid * kMaxChannels + c] = colors[g * C + c];
        }
        __syncthreads();
        if (done) continue;
        const int nb = min(kBatch, end - b0);
        for (int k = 0; k < nb; ++k) {
            const float gx = s_mx[k], gy = s_my[k];
            const float dx = gx - px;
            const float dy = gy - py;
            const float sigma = 0.5f * (s_ca[k] * dx * dx + s_cc[k] * dy * dy) + s_cb[k] * dx * dy;
            const float alpha = fminf(kMaxAlpha, s_op[k] * expf(-sigma));
            bool vis = sigma >= 0.0f && alpha >= kAlphaThreshold;
            if (gate)
                vis = vis && ctx >= s_x0[k] && ctx < s_x1[k] && cty >= s_y0[k] && cty < s_y1[k];
            if (vis) {
                const float next_T = T * (1.0f - alpha);
                if (next_T <= kTransmittanceEps) {
                    done = true;
                    break;
                }
                const float w = alpha * T;
#pragma unroll
                for (int c = 0; c < kMaxChannels; ++c)
                    if (c < C) acc[c] += w * s_col[k * kMaxChannels + c];
                acc_alpha += w;
                T = next_T;
            }
            ++walked;
        }
    }

    if (inside) {
        const int pix = y * width + x;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) out_color[pix * C + c] = acc[c];
        out_alpha[pix] = acc_alpha;
        out_livecnt[pix] = walked;
        out_tfinal[pix] = T;
    }
}

}  // namespace

extern "C" int rasterize_fwd(const void* means2d, const void* conics, const void* opacities,
                             const void* colors, const void* radii, const void* gauss_ids,
                             const void* tile_offsets, int C, int width, int height, int tile_size,
                             int tiles_w, int tiles_h, int gate, void* out_color, void* out_alpha,
                             void* out_livecnt, void* out_tfinal, void* stream) {
    if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
    const int num_tiles = tiles_w * tiles_h;
    if (num_tiles == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
#define FG_LAUNCH(TS)                                                                                     \
    rasterize_fwd_kernel<TS><<<num_tiles, TS * TS, 0, s>>>(                                              \
        (const float*)means2d, (const float*)conics, (const float*)opacities, (const float*)colors,      \
        (const float*)radii, (const int32_t*)gauss_ids, (const int32_t*)tile_offsets, C, width, height, \
        tiles_w, gate, (float*)out_color, (float*)out_alpha, (int32_t*)out_livecnt, (float*)out_tfinal)
    if (tile_size == 16) {
        FG_LAUNCH(16);
    } else if (tile_size == 32) {
        FG_LAUNCH(32);
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef FG_LAUNCH
    return (int)cudaGetLastError();
}

extern "C" const char* rasterize_fwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
