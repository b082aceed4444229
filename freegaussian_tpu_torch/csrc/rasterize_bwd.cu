// Tile compositor, backward: one walk of each tile's depth-sorted run that
// writes one gradient row per intersection, with the AbsGS absgrad. Two
// walks, one template (FWD):
//
//   reverse (rasterize_bwd)      replaces the TPU kernel
//       freegaussian_tpu/ops/rasterize_pallas.py:_bwd_kernel_rev (launcher
//       _run_bwd_rev, with _bwd_half_body_rev and _grad_rows). Each pixel
//       starts from the forward's t_final and walks its tile's run back to
//       front; a slot is live for the pixel when its rank in the run is below
//       the forward's livecnt (the slots walked before termination).
//   forward (rasterize_bwd_fwd)  replaces the TPU kernel
//       rasterize_pallas.py:_bwd_kernel (launcher _run_bwd, body
//       _bwd_half_body), selected there by BWD_WALK = "fwd". Each pixel walks
//       the run front to back from T = 1, replaying the forward's running
//       product T *= 1 - alpha in the forward's order and rounding (this file
//       is built with -fmad=false, as rasterize_fwd.cu is), so it stops at the
//       same slot the forward stopped at; the suffix comes from the identity
//       r_after = r_total - S, with S the running sum of w b up to and
//       including the slot and r_total = sum_c color g_color + alpha g_alpha
//       the pixel's total, computed by the caller.
//
// Per (pixel, live slot):
//   b      = g_alpha + sum_c g_color[c] color[c]
//   T_excl = the transmittance before the slot (reverse: T / (1 - alpha);
//            live alpha <= 0.999)
//   w      = alpha T_excl
//   da     = T_excl b - r_after / (1 - alpha)   (r_after: sum of w b over deeper slots)
//   dsigma = -alpha da, if the raw alpha op exp(-sigma) <= 0.999, else 0
// and the row of the slot holds the sums over the tile's pixels of
//   d means2d = dsigma (a dx + b dy, b dx + c dy)
//   d conic   = (dsigma dx^2 / 2, dsigma dx dy, dsigma dy^2 / 2)
//   d opacity = -sum dsigma / op
//   absgrad   = |d means2d|, the abs taken after the whole tile's sum
//   d colors  = w g_color
// At a tile size other than 16 the pair is gated by the Gaussian's 16-px
// contract bbox, as the forward gates it.
//
// Every row of the (I, 8 + C) output is written: rows whose rank is at or
// past every pixel's livecnt get exact zeros (the unwritten rows of the TPU
// kernel's output held garbage that poisoned the per-Gaussian reduction).
// The forward walk's suffix identity cancels where r_after is small next to
// r_total (deep in a saturated pixel): its gradients carry that error, which
// the reverse walk does not have.
//
// Bound on an H100: per live (pixel, slot) pair ~33 + 3C f32 operations for
// the slot's terms and one exp, against a read-once cost of the per-Gaussian
// rows, the ids, the per-pixel cotangents and an (I, 8 + C) f32 write; at
// the training point (N = 1e5, 640x480) the operations bound it (chip_smoke.py
// prints both bounds from the run's own data). This first version reduces
// each slot's 6 + C terms over a warp with shuffles (skipped when no lane of
// the warp has a live pair), stages the warp sums in shared memory, and sums
// the warps of a batch of slots in a fixed order: deterministic, no atomics.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr int kMaxChannels = 8;
constexpr int kHead = 8;                    // row columns ahead of the colors
constexpr int kCols = 6 + kMaxChannels;     // reduced terms per slot
constexpr float kContractTile = 16.0f;

template <int TILE, int BATCH, bool FWD>
__global__ void __launch_bounds__(TILE * TILE)
rasterize_bwd_kernel(const float* __restrict__ means2d,    // (N, 2)
                     const float* __restrict__ conics,     // (N, 3)
                     const float* __restrict__ opacities,  // (N,)
                     const float* __restrict__ colors,     // (N, C)
                     const float* __restrict__ radii,      // (N,) bbox radius
                     const int32_t* __restrict__ gauss_ids,     // (I,)
                     const int32_t* __restrict__ tile_offsets,  // (T + 1,)
                     const float* __restrict__ g_color,    // (H, W, C)
                     const float* __restrict__ g_alpha,    // (H, W)
                     const int32_t* __restrict__ livecnt,  // (H, W)
                     const float* __restrict__ t_final,    // (H, W), reverse walk
                     const float* __restrict__ r_total,    // (H, W), forward walk
                     int C, int width, int height, int tiles_w, int gate,
                     float* __restrict__ out_rows)         // (I, 8 + C)
{
    constexpr int kThreads = TILE * TILE;
    constexpr int kWarps = kThreads / 32;
    __shared__ float s_mx[BATCH], s_my[BATCH];
    __shared__ float s_ca[BATCH], s_cb[BATCH], s_cc[BATCH];
    __shared__ float s_op[BATCH];
    // the Gaussian's radius bbox in 16-px contract tiles: [x0, x1) x [y0, y1)
    __shared__ float s_x0[BATCH], s_x1[BATCH], s_y0[BATCH], s_y1[BATCH];
    __shared__ float s_col[BATCH * kMaxChannels];
    // per-warp sums of each slot's terms: [warp][slot][term]
    __shared__ float s_part[kWarps * BATCH * kCols];
    __shared__ int s_maxlive;

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int x = (tile % tiles_w) * TILE + tid % TILE;
    const int y = (tile / tiles_w) * TILE + tid / TILE;
    const bool inside = x < width && y < height;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    const float ctx = floorf((px - 0.5f) / kContractTile);
    const float cty = floorf((py - 0.5f) / kContractTile);

    const int start = tile_offsets[tile];
    const int n = tile_offsets[tile + 1] - start;
    const int D = kHead + C;
    float* rows = out_rows + (size_t)start * D;

    int lc = 0;
    float T = 1.0f;
    float rt = 0.0f;
    float ga = 0.0f;
    float gc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) gc[c] = 0.0f;
    if (inside) {
        const int pix = y * width + x;
        lc = livecnt[pix];
        if (FWD) rt = r_total[pix];
        else T = t_final[pix];
        ga = g_alpha[pix];
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) gc[c] = g_color[pix * C + c];
    }
    if (tid == 0) s_maxlive = 0;
    __syncthreads();
    if (lc > 0) atomicMax(&s_maxlive, lc);
    __syncthreads();
    const int maxlive = s_maxlive;

    // slots at or past every pixel's termination: exact zero rows
    for (int o = maxlive * D + tid; o < n * D; o += kThreads) rows[o] = 0.0f;

    float r_after = 0.0f;  // reverse: the sum of w b over the deeper slots
    float s_cum = 0.0f;    // forward: the sum of w b up to the slot
    bool done = !inside;   // forward: the pixel has terminated, as in the forward
    const int last_lo = maxlive > 0 ? ((maxlive - 1) / BATCH) * BATCH : -BATCH;
    for (int it = 0; it <= last_lo / BATCH; ++it) {
        const int lo = FWD ? it * BATCH : last_lo - it * BATCH;
        const int nb = min(BATCH, maxlive - lo);
        // also the barrier that keeps the previous batch's rows and sums
        // until every thread has read them
        __syncthreads();
        if (tid < nb) {
            const int g = gauss_ids[start + lo + tid];
            s_mx[tid] = means2d[2 * g];
            s_my[tid] = means2d[2 * g + 1];
            s_ca[tid] = conics[3 * g];
            s_cb[tid] = conics[3 * g + 1];
            s_cc[tid] = conics[3 * g + 2];
            s_op[tid] = opacities[g];
            if (gate) {
                // the forward's f32 bbox arithmetic (/16 is exact)
                const float r = radii[g];
                s_x0[tid] = floorf((s_mx[tid] - r) / kContractTile);
                s_x1[tid] = ceilf((s_mx[tid] + r) / kContractTile);
                s_y0[tid] = floorf((s_my[tid] - r) / kContractTile);
                s_y1[tid] = ceilf((s_my[tid] + r) / kContractTile);
            }
            for (int c = 0; c < C; ++c) s_col[tid * kMaxChannels + c] = colors[g * C + c];
        }
        __syncthreads();

        for (int kk = 0; kk < nb; ++kk) {
            const int k = FWD ? kk : nb - 1 - kk;
            float v[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j) v[j] = 0.0f;
            bool contrib = false;
            if (FWD ? !done : lo + k < lc) {
                // sigma and alpha as rasterize_fwd.cu computes them
                const float dx = s_mx[k] - px;
                const float dy = s_my[k] - py;
                const float ca = s_ca[k], cb = s_cb[k], cc = s_cc[k];
                const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
                const float raw = s_op[k] * expf(-sigma);
                const float alpha = fminf(kMaxAlpha, raw);
                bool vis = sigma >= 0.0f && alpha >= kAlphaThreshold;
                if (gate)
                    vis = vis && ctx >= s_x0[k] && ctx < s_x1[k] && cty >= s_y0[k] && cty < s_y1[k];
                if (vis) {
                    const float om = 1.0f - alpha;
                    float b = ga;
#pragma unroll
                    for (int c = 0; c < kMaxChannels; ++c)
                        if (c < C) b += gc[c] * s_col[k * kMaxChannels + c];
                    float t_excl, da;
                    if (FWD) {
                        const float next_T = T * om;
                        if (next_T <= kTransmittanceEps) {
                            done = true;  // the forward stopped here: not composited
                        } else {
                            t_excl = T;
                            s_cum += alpha * t_excl * b;
                            da = t_excl * b - (rt - s_cum) / om;
                            T = next_T;
                            contrib = true;
                        }
                    } else {
                        t_excl = T / om;
                        da = t_excl * b - r_after / om;
                        r_after += alpha * t_excl * b;
                        T = t_excl;
                        contrib = true;
                    }
                    if (contrib) {
                        const float w = alpha * t_excl;
                        const float dsig = raw <= kMaxAlpha ? -alpha * da : 0.0f;
                        v[0] = dsig * (ca * dx + cb * dy);
                        v[1] = dsig * (cb * dx + cc * dy);
                        v[2] = 0.5f * dsig * dx * dx;
                        v[3] = dsig * dx * dy;
                        v[4] = 0.5f * dsig * dy * dy;
                        v[5] = dsig;
#pragma unroll
                        for (int c = 0; c < kMaxChannels; ++c)
                            if (c < C) v[6 + c] = w * gc[c];
                    }
                }
            }
            float* part = s_part + (warp * BATCH + k) * kCols;
            if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    if (j < 6 + C) {
                        float s = v[j];
#pragma unroll
                        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
                        if (lane == 0) part[j] = s;
                    }
                }
            } else if (lane == 0) {
                for (int j = 0; j < 6 + C; ++j) part[j] = 0.0f;
            }
        }
        __syncthreads();

        // sum the warps of each slot in a fixed order and write its row
        for (int o = tid; o < nb * D; o += kThreads) {
            const int k = o / D;
            const int d = o - k * D;
            const int j = d < 6 ? d : (d < kHead ? d - 6 : d - 2);
            float s = 0.0f;
            for (int w = 0; w < kWarps; ++w) s += s_part[(w * BATCH + k) * kCols + j];
            float val = s;
            if (d == 5) val = s_op[k] > 0.0f ? -s / s_op[k] : 0.0f;
            else if (d == 6 || d == 7) val = fabsf(s);
            rows[(size_t)(lo + k) * D + d] = val;
        }
    }
}

template <bool FWD>
int launch(const void* means2d, const void* conics, const void* opacities, const void* colors, const void* radii,
           const void* gauss_ids, const void* tile_offsets, const void* g_color, const void* g_alpha,
           const void* livecnt, const void* t_final, const void* r_total, int C, int width, int height,
           int tile_size, int tiles_w, int tiles_h, int gate, void* out_rows, void* stream) {
    if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
    const int num_tiles = tiles_w * tiles_h;
    if (num_tiles == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
#define FG_LAUNCH(TS, B)                                                                                   \
    rasterize_bwd_kernel<TS, B, FWD><<<num_tiles, TS * TS, 0, s>>>(                                        \
        (const float*)means2d, (const float*)conics, (const float*)opacities, (const float*)colors,       \
        (const float*)radii, (const int32_t*)gauss_ids, (const int32_t*)tile_offsets,                     \
        (const float*)g_color, (const float*)g_alpha, (const int32_t*)livecnt, (const float*)t_final,     \
        (const float*)r_total, C, width, height, tiles_w, gate, (float*)out_rows)
    if (tile_size == 16) {
        FG_LAUNCH(16, 32);
    } else if (tile_size == 32) {
        FG_LAUNCH(32, 16);
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef FG_LAUNCH
    return (int)cudaGetLastError();
}

}  // namespace

// The reverse walk, from the forward's t_final.
extern "C" int rasterize_bwd(const void* means2d, const void* conics, const void* opacities,
                             const void* colors, const void* radii, const void* gauss_ids,
                             const void* tile_offsets, const void* g_color, const void* g_alpha,
                             const void* livecnt, const void* t_final, int C, int width, int height,
                             int tile_size, int tiles_w, int tiles_h, int gate, void* out_rows,
                             void* stream) {
    return launch<false>(means2d, conics, opacities, colors, radii, gauss_ids, tile_offsets, g_color, g_alpha,
                         livecnt, t_final, nullptr, C, width, height, tile_size, tiles_w, tiles_h, gate, out_rows,
                         stream);
}

// The forward walk, from the per-pixel totals r_total (H, W).
extern "C" int rasterize_bwd_fwd(const void* means2d, const void* conics, const void* opacities,
                                 const void* colors, const void* radii, const void* gauss_ids,
                                 const void* tile_offsets, const void* g_color, const void* g_alpha,
                                 const void* livecnt, const void* r_total, int C, int width, int height,
                                 int tile_size, int tiles_w, int tiles_h, int gate, void* out_rows,
                                 void* stream) {
    return launch<true>(means2d, conics, opacities, colors, radii, gauss_ids, tile_offsets, g_color, g_alpha,
                        livecnt, nullptr, r_total, C, width, height, tile_size, tiles_w, tiles_h, gate, out_rows,
                        stream);
}

extern "C" const char* rasterize_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
