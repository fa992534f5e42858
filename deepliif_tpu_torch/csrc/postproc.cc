// Native post-processing helpers (host code, not a GPU kernel): the port's
// copy of deepliif_tpu/native/postproc.cc.
//
// The reference implements these as Numba nopython kernels
// (reference deepliif/postprocessing.py:491-581 boundary tracing,
// :235-308 region grow). The tracing loop is inherently sequential, so it
// lives here as C, loaded via ctypes. Exact semantics parity with the
// vectorized Python fallbacks in deepliif_tpu_torch/postprocessing.py.
//
// Build: deepliif_tpu_torch/native.py (c++ -O3 -shared -fPIC into _build/).

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

extern "C" {

// Moore-neighborhood clockwise boundary tracing.
// mask: h*w uint8 labels, 0 = background. (x, y) must be the first raster
// pixel of the cell. Writes boundary points as interleaved x,y into out_xy
// (capacity max_pts points) and the bbox as {min_x, min_y, max_x, max_y}.
// Returns the number of boundary points, or -1 on overflow/invalid start.
int moore_trace(const uint8_t* mask, int h, int w, int x, int y,
                int32_t* out_xy, int max_pts, int32_t* bbox) {
    static const int nb[16][2] = {
        {-1,-1},{0,-1},{1,-1},{1,0},{1,1},{0,1},{-1,1},{-1,0},
        {-1,-1},{0,-1},{1,-1},{1,0},{1,1},{0,1},{-1,1},{-1,0}};
    if (x < 0 || x >= w || y < 0 || y >= h) return -1;
    if (mask[(size_t)y * w + x] == 0) return -1;

    // counter-clockwise search for the previous pixel
    int idx = 6;
    while (idx >= 0) {
        int nx = x + nb[idx][0], ny = y + nb[idx][1];
        if (nx >= 0 && nx < w && ny >= 0 && ny < h &&
            mask[(size_t)ny * w + nx] != 0) break;
        idx--;
    }
    if (idx < 0) {  // isolated pixel
        if (max_pts < 1) return -1;
        out_xy[0] = x; out_xy[1] = y;
        bbox[0] = x; bbox[1] = y; bbox[2] = x; bbox[3] = y;
        return 1;
    }

    int px = x + nb[idx][0], py = y + nb[idx][1];
    int first_px = px, first_py = py;   // boundary[0]
    int first_x = x, first_y = y;       // boundary[1]
    int min_x = x, max_x = x, min_y = y, max_y = y;

    int n = 0;
    if (n >= max_pts) return -1;
    out_xy[2 * n] = x; out_xy[2 * n + 1] = y; n++;  // boundary[1] onward

    for (;;) {
        int dx = px - x, dy = py - y;
        int start = -1;
        for (int i = 0; i < 8; i++) {
            if (nb[i][0] == dx && nb[i][1] == dy) { start = i + 1; break; }
        }
        int i = start;
        int nx, ny;
        for (;;) {
            nx = x + nb[i][0]; ny = y + nb[i][1];
            if (nx >= 0 && nx < w && ny >= 0 && ny < h &&
                mask[(size_t)ny * w + nx] != 0) break;
            i++;
        }
        px = x; py = y;
        x = nx; y = ny;
        if (n >= max_pts) return -1;
        out_xy[2 * n] = x; out_xy[2 * n + 1] = y; n++;

        if (x < min_x) min_x = x; else if (x > max_x) max_x = x;
        if (y < min_y) min_y = y; else if (y > max_y) max_y = y;

        if (px == first_px && py == first_py && x == first_x && y == first_y)
            break;
    }
    bbox[0] = min_x; bbox[1] = min_y; bbox[2] = max_x; bbox[3] = max_y;
    // drop the final repeat of boundary[1] (reference returns boundary[1:-1]
    // of a list that starts [prev, first, ...]; our out started at first)
    return n - 1;
}

// 8-connected components over mask != 0; labels assigned in raster order of
// each component's first pixel (1..n). Two-pass union-find.
int label8(const uint8_t* mask, int h, int w, int32_t* labels) {
    size_t total = (size_t)h * w;
    int32_t* parent = (int32_t*)malloc(sizeof(int32_t) * (total / 2 + 2));
    if (!parent) return -1;
    int next = 1;

    #define FIND(r) ({ int32_t _r = (r); \
        while (parent[_r] != _r) { parent[_r] = parent[parent[_r]]; _r = parent[_r]; } _r; })

    memset(labels, 0, sizeof(int32_t) * total);
    for (int yy = 0; yy < h; yy++) {
        for (int xx = 0; xx < w; xx++) {
            size_t p = (size_t)yy * w + xx;
            if (mask[p] == 0) continue;
            // neighbors above and left (already labeled): NW, N, NE, W
            int32_t best = 0;
            int32_t cand[4] = {0, 0, 0, 0};
            int nc = 0;
            if (yy > 0) {
                if (xx > 0 && labels[p - w - 1]) cand[nc++] = labels[p - w - 1];
                if (labels[p - w]) cand[nc++] = labels[p - w];
                if (xx + 1 < w && labels[p - w + 1]) cand[nc++] = labels[p - w + 1];
            }
            if (xx > 0 && labels[p - 1]) cand[nc++] = labels[p - 1];
            for (int i = 0; i < nc; i++) {
                int32_t r = FIND(cand[i]);
                if (best == 0 || r < best) best = r;
            }
            if (best == 0) {
                parent[next] = next;
                labels[p] = next++;
            } else {
                labels[p] = best;
                for (int i = 0; i < nc; i++) {
                    int32_t r = FIND(cand[i]);
                    if (r != best) parent[r] = best;
                }
            }
        }
    }

    // second pass: resolve + renumber in raster order of first occurrence
    int32_t* remap = (int32_t*)calloc(next, sizeof(int32_t));
    if (!remap) { free(parent); return -1; }
    int n_out = 0;
    for (size_t p = 0; p < total; p++) {
        if (labels[p] == 0) continue;
        int32_t r = FIND(labels[p]);
        if (remap[r] == 0) remap[r] = ++n_out;
        labels[p] = remap[r];
    }
    free(parent);
    free(remap);
    return n_out;
    #undef FIND
}

}  // extern "C"
