// Native geometry core for the host post-processing hot path (the port's
// own copy of classpose_tpu/native/geomfast.cpp, with contours_ccomp
// added).
//
// The WSI pipeline extracts and validates one polygon per detected cell;
// at production cell densities per-call numpy machinery on ~40-point
// rings would dominate, so these primitives are plain C++ loops behind an
// extern "C" ABI, loaded with ctypes (no Python.h / numpy-API coupling).
//
//   - ring_simple: proper-intersection test with the 1e-12 orientation
//     epsilon; endpoint touching and collinear overlap do not count;
//     adjacent segments (incl. the 0 <-> n-1 wraparound) are skipped.
//   - ring_metrics / rings_batch: shoelace signed area, area-weighted
//     centroid with the |2A| < 2e-12 vertex-mean fallback, perimeter.
//   - points_in_ring: ray-casting parity ((yi > y) != (yj > y),
//     x < xcross).
//   - contours_batch: every instance's outer contour in one pass over a
//     label image (Suzuki-Abe border following, CHAIN_APPROX_SIMPLE).
//   - contours_ccomp: outer and hole borders of a binary mask with the
//     RETR_CCOMP hierarchy (the GrandQC tissue and artefact regions).
//   - dedup_keep: grid-hash centroid pairs + greedy grouping.
//
// Built with g++ -O2 -shared -fPIC into classpose_tpu_torch/_build/ on
// first use (classpose_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline int orient(double ax, double ay, double bx, double by, double cx,
                  double cy) {
    double v = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    if (v > 1e-12) return 1;
    if (v < -1e-12) return -1;
    return 0;
}

}  // namespace

extern "C" {

// 1 if the ring has no proper self-intersection, 0 otherwise.
// xy: n points, interleaved x0,y0,x1,y1,...
int ring_simple(const double* xy, long n) {
    if (n < 4) return 1;
    for (long i = 0; i < n; ++i) {
        long i2 = (i + 1 == n) ? 0 : i + 1;
        double ax = xy[2 * i], ay = xy[2 * i + 1];
        double bx = xy[2 * i2], by = xy[2 * i2 + 1];
        double lox = ax < bx ? ax : bx, hix = ax < bx ? bx : ax;
        double loy = ay < by ? ay : by, hiy = ay < by ? by : ay;
        for (long j = i + 2; j < n; ++j) {
            if (i == 0 && j == n - 1) continue;  // wraparound adjacency
            long j2 = (j + 1 == n) ? 0 : j + 1;
            double cx = xy[2 * j], cy = xy[2 * j + 1];
            double dx = xy[2 * j2], dy = xy[2 * j2 + 1];
            // bbox reject
            if ((cx < lox && dx < lox) || (cx > hix && dx > hix) ||
                (cy < loy && dy < loy) || (cy > hiy && dy > hiy))
                continue;
            int o1 = orient(ax, ay, bx, by, cx, cy);
            int o2 = orient(ax, ay, bx, by, dx, dy);
            if (o1 == o2 || o1 == 0 || o2 == 0) continue;
            int o3 = orient(cx, cy, dx, dy, ax, ay);
            int o4 = orient(cx, cy, dx, dy, bx, by);
            if (o3 != o4 && o3 != 0 && o4 != 0) return 0;
        }
    }
    return 1;
}

// out[0] = signed area, out[1] = cx, out[2] = cy, out[3] = perimeter
void ring_metrics(const double* xy, long n, double* out) {
    double a2 = 0.0, cx6 = 0.0, cy6 = 0.0, per = 0.0;
    double sx = 0.0, sy = 0.0;
    for (long i = 0; i < n; ++i) {
        long i2 = (i + 1 == n) ? 0 : i + 1;
        double x0 = xy[2 * i], y0 = xy[2 * i + 1];
        double x1 = xy[2 * i2], y1 = xy[2 * i2 + 1];
        double c = x0 * y1 - x1 * y0;
        a2 += c;
        cx6 += (x0 + x1) * c;
        cy6 += (y0 + y1) * c;
        per += std::sqrt((x1 - x0) * (x1 - x0) + (y1 - y0) * (y1 - y0));
        sx += x0;
        sy += y0;
    }
    out[0] = 0.5 * a2;
    if (std::fabs(a2) < 2e-12) {
        out[1] = sx / (double)n;
        out[2] = sy / (double)n;
    } else {
        out[1] = cx6 / (3.0 * a2);
        out[2] = cy6 / (3.0 * a2);
    }
    out[3] = per;
}

// Batched ring metrics + simplicity over m rings packed into one xy
// buffer (offs: m+1 vertex offsets; ring k is vertices
// offs[k]..offs[k+1]). out is m×5: [signed_area, cx, cy, perimeter,
// simple] — one library call per tile instead of 3 ctypes round trips
// per detected cell (the ctypes marshalling dominated the per-cell
// polygon validity cost at ~900 cells/tile).
void rings_batch(const double* xy, const long* offs, long m,
                 double* out) {
    for (long k = 0; k < m; ++k) {
        const double* r = xy + 2 * offs[k];
        long n = offs[k + 1] - offs[k];
        ring_metrics(r, n, out + 5 * k);
        out[5 * k + 4] = (double)ring_simple(r, n);
    }
}

// Per-instance majority class vote (runner/model.py
// compute_class_masks_from_pixels, itself the reference
// models.py:191-230 bincount vote): counts[inst][cls] over foreground
// pixels, per-instance argmax with first-max (lowest class) tie-break
// exactly like np.argmax, out[px] = major[inst[px]] (0 for background).
// inst: npx int32 in [0, nmax]; cls: npx int8 in [0, n_classes);
// out: npx int32.
void class_vote(const int32_t* inst, const int8_t* cls, long npx,
                long n_classes, int32_t* out) {
    int32_t nmax = 0;
    for (long k = 0; k < npx; ++k)
        if (inst[k] > nmax) nmax = inst[k];
    std::vector<int64_t> counts((int64_t)(nmax + 1) * n_classes, 0);
    for (long k = 0; k < npx; ++k)
        if (inst[k] > 0) ++counts[(int64_t)inst[k] * n_classes + cls[k]];
    std::vector<int32_t> major(nmax + 1, 0);
    for (int64_t i = 1; i <= nmax; ++i) {
        const int64_t* row = counts.data() + i * n_classes;
        int32_t best = 0;
        for (long c = 1; c < n_classes; ++c)
            if (row[c] > row[best]) best = (int32_t)c;
        major[i] = best;
    }
    for (long k = 0; k < npx; ++k) out[k] = major[inst[k]];
}

// Per-instance hole fill + min-size filter + sequential relabel.
// Identical semantics to dynamics/masks.py
// fill_holes_and_remove_small_masks (itself the cellpose
// utils.fill_holes_and_remove_small_masks contract, reference
// models.py:171-174): iterate instance ids ASCENDING; skip ids with
// fewer than max(min_size, 1) pixels; fill 4-connected background
// components of the bbox crop not reachable from the (padded) crop
// border; write the filled region as the next sequential id,
// overwriting anything written earlier (later instances win inside
// overlapping bboxes, as the numpy loop does).
// masks: H*W int32 labels in [0, nmax]; out: H*W int32 (pre-zeroed by
// the caller). Returns the kept-instance count.
long fill_holes_relabel(const int32_t* masks, long H, long W,
                        long min_size, int32_t* out) {
    long npx = H * W;
    int32_t nmax = 0;
    for (long k = 0; k < npx; ++k)
        if (masks[k] > nmax) nmax = masks[k];
    if (nmax <= 0) return 0;
    if (min_size < 1) min_size = 1;

    // one pass: per-id bbox + pixel count
    std::vector<long> y0(nmax + 1, H), y1(nmax + 1, -1);
    std::vector<long> x0(nmax + 1, W), x1(nmax + 1, -1);
    std::vector<long> cnt(nmax + 1, 0);
    for (long y = 0; y < H; ++y) {
        const int32_t* row = masks + y * W;
        for (long x = 0; x < W; ++x) {
            int32_t v = row[x];
            if (v <= 0) continue;
            ++cnt[v];
            if (y < y0[v]) y0[v] = y;
            if (y > y1[v]) y1[v] = y;
            if (x < x0[v]) x0[v] = x;
            if (x > x1[v]) x1[v] = x;
        }
    }

    long max_crop = 0;
    for (int32_t i = 1; i <= nmax; ++i)
        if (cnt[i] >= min_size) {
            long a = (y1[i] - y0[i] + 3) * (x1[i] - x0[i] + 3);
            if (a > max_crop) max_crop = a;
        }
    // crop buffer with a 1-px pad ring: 0 = unvisited background,
    // 1 = instance pixel, 2 = border-reachable background
    std::vector<uint8_t> buf(max_crop > 0 ? max_crop : 1);
    std::vector<long> stack(max_crop > 0 ? max_crop : 1);

    int32_t new_id = 0;
    for (int32_t i = 1; i <= nmax; ++i) {
        if (cnt[i] < min_size) continue;
        ++new_id;
        long by = y0[i], bx = x0[i];
        long bh = y1[i] - by + 1, bw = x1[i] - bx + 1;
        long ph = bh + 2, pw = bw + 2;
        for (long k = 0; k < ph * pw; ++k) buf[k] = 0;
        for (long y = 0; y < bh; ++y) {
            const int32_t* row = masks + (by + y) * W + bx;
            uint8_t* brow = buf.data() + (y + 1) * pw + 1;
            for (long x = 0; x < bw; ++x)
                if (row[x] == i) brow[x] = 1;
        }
        // flood the background from the pad corner, 4-connected
        long sp = 0;
        stack[sp++] = 0;
        buf[0] = 2;
        while (sp) {
            long p = stack[--sp];
            long y = p / pw, x = p % pw;
            if (y > 0 && buf[p - pw] == 0) { buf[p - pw] = 2; stack[sp++] = p - pw; }
            if (y + 1 < ph && buf[p + pw] == 0) { buf[p + pw] = 2; stack[sp++] = p + pw; }
            if (x > 0 && buf[p - 1] == 0) { buf[p - 1] = 2; stack[sp++] = p - 1; }
            if (x + 1 < pw && buf[p + 1] == 0) { buf[p + 1] = 2; stack[sp++] = p + 1; }
        }
        // filled = instance pixels + unreached background (holes)
        for (long y = 0; y < bh; ++y) {
            const uint8_t* brow = buf.data() + (y + 1) * pw + 1;
            int32_t* orow = out + (by + y) * W + bx;
            for (long x = 0; x < bw; ++x)
                if (brow[x] != 2) orow[x] = new_id;
        }
    }
    return new_id;
}

// Batched outer-contour extraction over an int32 label image — the
// native replacement for the per-instance
// cv2.findContours(crop == id, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]
// loop of the reference PostProcessor (predict_wsi.py:578-656) /
// pipeline/postprocess.py. One pass finds every instance's bbox, pixel
// count and raster-first pixel; each instance's outer border is then
// traced directly on the label image (Suzuki-Abe border following,
// 8-connected foreground, exactly OpenCV's icvFetchContour step order),
// emitting CHAIN_APPROX_SIMPLE-compressed (x, y) vertices.
//
// cv2 parity detail: findContours returns EXTERNAL contours in REVERSE
// raster-discovery order, so for a DISCONNECTED instance contours[0]
// is the component whose outer-border start (its raster-first pixel)
// comes LAST in raster order (probed empirically; see
// tests/test_native_contours.py). An 8-connected flood fill from the
// instance's raster-first pixel (bbox-cropped, like
// fill_holes_relabel) detects disconnection (component pixels <
// instance pixels); the common connected case traces immediately, the
// rare disconnected one enumerates component starts and traces the
// raster-LAST component.
//
// Outputs, for the m instances emitted (ids with >= 1 pixel, ascending):
//   pts      : interleaved x,y int32 vertices, all contours concatenated
//   offs     : m+1 vertex offsets (contour k = pts[offs[k]..offs[k+1]))
//   cell_ids : the instance id of each contour
//   first_px : each instance's raster-first flat pixel index (the class
//              lookup pixel: class_masks.ravel()[first_px], matching the
//              reference's cell_mask[...][0] first-in-mask-pixel rule —
//              the WHOLE instance's first pixel, even when the traced
//              contour is a later component, exactly as the reference)
// Returns the emitted count m, or -1 when pts capacity `cap` (in
// vertices) would overflow — caller doubles the buffer and retries.
long contours_batch(const int32_t* masks, long H, long W, long cap,
                    int32_t* pts, long* offs, int32_t* cell_ids,
                    long* first_px) {
    long npx = H * W;
    int32_t nmax = 0;
    for (long k = 0; k < npx; ++k)
        if (masks[k] > nmax) nmax = masks[k];
    if (nmax <= 0) return 0;

    std::vector<long> first(nmax + 1, -1);
    std::vector<long> cnt(nmax + 1, 0);
    std::vector<long> by0(nmax + 1, H), by1(nmax + 1, -1);
    std::vector<long> bx0(nmax + 1, W), bx1(nmax + 1, -1);
    for (long y = 0; y < H; ++y) {
        const int32_t* row = masks + y * W;
        for (long x = 0; x < W; ++x) {
            int32_t v = row[x];
            if (v <= 0) continue;
            long k = y * W + x;
            if (first[v] < 0) first[v] = k;
            ++cnt[v];
            if (y < by0[v]) by0[v] = y;
            if (y > by1[v]) by1[v] = y;
            if (x < bx0[v]) bx0[v] = x;
            if (x > bx1[v]) bx1[v] = x;
        }
    }
    long max_crop = 0;
    for (int32_t i = 1; i <= nmax; ++i)
        if (first[i] >= 0) {
            long a = (by1[i] - by0[i] + 1) * (bx1[i] - bx0[i] + 1);
            if (a > max_crop) max_crop = a;
        }
    std::vector<uint8_t> vis(max_crop > 0 ? max_crop : 1);
    std::vector<long> stack(max_crop > 0 ? max_crop : 1);

    // OpenCV's 8-neighborhood deltas (contours.cpp icvCodeDeltas),
    // duplicated so the unbounded ++s scan needs no masking
    const long dx8[16] = {1, 1, 0, -1, -1, -1, 0, 1,
                          1, 1, 0, -1, -1, -1, 0, 1};
    const long dy8[16] = {0, -1, -1, -1, 0, 1, 1, 1,
                          0, -1, -1, -1, 0, 1, 1, 1};

    long m = 0;
    long np_total = 0;
    offs[0] = 0;
    for (int32_t id = 1; id <= nmax; ++id) {
        if (first[id] < 0) continue;  // absent id: find_objects None row

        // 8-connected flood from the raster-first pixel over the bbox
        // crop; disconnected instances then enumerate the remaining
        // components' start pixels and keep the raster-LAST (cv2's [0])
        long cy0 = by0[id], cx0 = bx0[id];
        long bh = by1[id] - cy0 + 1, bw = bx1[id] - cx0 + 1;
        for (long k = 0; k < bh * bw; ++k) vis[k] = 0;

        auto flood = [&](long seed_y, long seed_x) {
            long sp = 0;
            long p0 = (seed_y - cy0) * bw + (seed_x - cx0);
            vis[p0] = 1;
            stack[sp++] = p0;
            long n_px = 1;
            while (sp) {
                long p = stack[--sp];
                long ly = p / bw, lx = p % bw;
                for (long dy = -1; dy <= 1; ++dy)
                    for (long dx = -1; dx <= 1; ++dx) {
                        if (!dy && !dx) continue;
                        long ny = ly + dy, nx = lx + dx;
                        if (ny < 0 || ny >= bh || nx < 0 || nx >= bw)
                            continue;
                        long q = ny * bw + nx;
                        if (vis[q]) continue;
                        if (masks[(cy0 + ny) * W + cx0 + nx] != id)
                            continue;
                        vis[q] = 1;
                        stack[sp++] = q;
                        ++n_px;
                    }
            }
            return n_px;
        };

        long y0 = first[id] / W, x0 = first[id] % W;
        long seen = flood(y0, x0);
        if (seen < cnt[id]) {
            // disconnected: later components' raster-first pixels are
            // exactly the unvisited id pixels found in raster order
            for (long ly = 0; ly < bh; ++ly) {
                const int32_t* row = masks + (cy0 + ly) * W + cx0;
                for (long lx = 0; lx < bw; ++lx) {
                    if (row[lx] != id || vis[ly * bw + lx]) continue;
                    y0 = cy0 + ly;
                    x0 = cx0 + lx;
                    seen += flood(y0, x0);
                }
            }
            // (y0, x0) is now the raster-LAST component's start
        }

        // neighbor test with image-border clipping (outside = background)
        auto fg = [&](long y, long x) -> bool {
            return y >= 0 && y < H && x >= 0 && x < W &&
                   masks[y * W + x] == id;
        };

        // icvFetchContour: initial clockwise scan from the left neighbor
        // (s = 4), decrementing, for the first foreground neighbor
        int s = 4, s_end = 4;
        long y1 = 0, x1 = 0;
        do {
            s = (s - 1) & 7;
            y1 = y0 + dy8[s];
            x1 = x0 + dx8[s];
        } while (!fg(y1, x1) && s != s_end);

        if (s == s_end && !fg(y1, x1)) {
            // single-pixel component: one vertex
            if (np_total + 1 > cap) return -1;
            pts[2 * np_total] = (int32_t)x0;
            pts[2 * np_total + 1] = (int32_t)y0;
            ++np_total;
        } else {
            long cy = y0, cx = x0;       // i3, the current border pixel
            int prev_s = s ^ 4;
            for (;;) {
                s_end = s;
                long ny = 0, nx = 0;
                for (;;) {
                    ++s;
                    ny = cy + dy8[s & 15];
                    nx = cx + dx8[s & 15];
                    if (fg(ny, nx)) break;
                }
                s &= 7;
                if (s != prev_s) {  // CHAIN_APPROX_SIMPLE: direction change
                    if (np_total + 1 > cap) return -1;
                    pts[2 * np_total] = (int32_t)cx;
                    pts[2 * np_total + 1] = (int32_t)cy;
                    ++np_total;
                    prev_s = s;
                }
                // OpenCV termination: next pixel is the start AND the
                // current pixel is the initially-found neighbor i1
                if (ny == y0 && nx == x0 && cy == y1 && cx == x1)
                    break;
                cy = ny;
                cx = nx;
                s = (s + 4) & 7;
            }
        }
        cell_ids[m] = id;
        first_px[m] = first[id];
        offs[++m] = np_total;
    }
    return m;
}

// Outer and hole borders of a binary mask with the two-level hierarchy
// of cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_SIMPLE): the tissue
// and artefact regions of the GrandQC quality control
// (classpose_tpu/grandqc/helpers.py contours_with_holes).
//
// Suzuki-Abe as OpenCV runs it on a copy padded by one zero pixel: a
// raster scan that starts an outer border at a 0 -> 1 step and a hole
// border at a (1 or marked, not right-marked) -> 0 step, each traced by
// icvFetchContourEx's step order from its start pixel (the foreground
// pixel left of the hole for a hole: first scan direction 0, else 4).
// Tracing marks each border pixel with the border's number NBD, and with
// -NBD where the trace examined its right neighbour and found background
// (a right-marked pixel starts no hole). A hole's parent is the outer
// border of the contour whose mark the scan passed last on the row
// (LNBD), or that contour's own parent when it is a hole; every outer
// border is top level (RETR_CCOMP puts an island in a hole at the top).
// Marks are int32 and unique per border, where OpenCV wraps them at 127
// and tells the borders of one mark apart by bounding rectangles; both
// give the same parent (see tests/test_torch_grandqc.py).
//
// Outputs, in discovery (raster) order of the m borders:
//   pts    : interleaved x,y int32 vertices of all borders
//   offs   : m+1 vertex offsets
//   parent : -1 for an outer border, else the index of its outer border
// Returns m, or -1 when `cap` vertices or `cap_n` borders would overflow
// (the caller grows the buffers and retries).
long contours_ccomp(const uint8_t* mask, long H, long W, long cap,
                    long cap_n, int32_t* pts, long* offs,
                    int32_t* parent) {
    const long Wp = W + 2;
    std::vector<int32_t> img((H + 2) * Wp, 0);
    for (long y = 0; y < H; ++y)
        for (long x = 0; x < W; ++x)
            img[(y + 1) * Wp + x + 1] = mask[y * W + x] != 0;
    const long d8[16] = {1, -Wp + 1, -Wp, -Wp - 1, -1, Wp - 1, Wp, Wp + 1,
                         1, -Wp + 1, -Wp, -Wp - 1, -1, Wp - 1, Wp, Wp + 1};
    const long dx8[8] = {1, 1, 0, -1, -1, -1, 0, 1};
    const long dy8[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    std::vector<int32_t> outer_of;  // per border: its outer border's index
    long m = 0, np_total = 0;
    offs[0] = 0;
    for (long y = 1; y <= H; ++y) {
        long lnbd = 0;
        int32_t prev = 0;
        for (long x = 1; x <= W; ++x) {
            int32_t p = img[y * Wp + x];
            if (p == prev) continue;
            bool outer = prev == 0 && p == 1;
            bool hole = !outer && p == 0 && prev >= 1;
            if (!outer && !hole) {
                prev = p;
                if (p != 0 && p != 1) lnbd = x;
                continue;
            }
            if (hole && prev != 1) lnbd = x - 1;
            int32_t par = -1;
            if (hole) {
                int32_t lab = img[y * Wp + lnbd];
                lab = lab < 0 ? -lab : lab;
                par = lab >= 2 ? outer_of[lab - 2] : -1;
            }
            if (m + 1 > cap_n) return -1;
            const int32_t nbd = (int32_t)(m + 2);
            const long x0 = x - hole;
            lnbd = x0;
            const long i0 = y * Wp + x0;
            long py = y - 1, px = x0 - 1;  // unpadded vertex coordinates
            int s = hole ? 0 : 4, s_end = s;
            long i1 = 0;
            do {
                s = (s - 1) & 7;
                i1 = i0 + d8[s];
            } while (img[i1] == 0 && s != s_end);
            if (s == s_end) {  // single-pixel border
                img[i0] = -nbd;
                if (np_total + 1 > cap) return -1;
                pts[2 * np_total] = (int32_t)px;
                pts[2 * np_total + 1] = (int32_t)py;
                ++np_total;
            } else {
                long i3 = i0, i4 = 0;
                int prev_s = s ^ 4;
                for (;;) {
                    s_end = s;
                    for (;;) {
                        i4 = i3 + d8[++s];
                        if (img[i4] != 0) break;
                    }
                    s &= 7;
                    if ((unsigned)(s - 1) < (unsigned)s_end)
                        img[i3] = -nbd;
                    else if (img[i3] == 1)
                        img[i3] = nbd;
                    if (s != prev_s) {  // CHAIN_APPROX_SIMPLE
                        if (np_total + 1 > cap) return -1;
                        pts[2 * np_total] = (int32_t)px;
                        pts[2 * np_total + 1] = (int32_t)py;
                        ++np_total;
                    }
                    prev_s = s;
                    px += dx8[s];
                    py += dy8[s];
                    if (i4 == i0 && i3 == i1) break;
                    i3 = i4;
                    s = (s + 4) & 7;
                }
            }
            parent[m] = par;
            outer_of.push_back(hole ? par : (int32_t)m);
            offs[++m] = np_total;
            prev = img[y * Wp + x];  // the scan resumes past the start
        }
    }
    return m;
}

// Ray-cast containment of m points against an n-point ring.
// out[k] = 1 if pts[k] is inside. Matches _points_in_ring's parity rule.
void points_in_ring(const double* ring, long n, const double* pts, long m,
                    uint8_t* out) {
    for (long k = 0; k < m; ++k) out[k] = 0;
    for (long i = 0; i < n; ++i) {
        long i2 = (i + 1 == n) ? 0 : i + 1;
        double xi = ring[2 * i], yi = ring[2 * i + 1];
        double xj = ring[2 * i2], yj = ring[2 * i2 + 1];
        if (yi == yj) continue;  // (yi>y)!=(yj>y) is impossible
        double inv = 1.0 / (yj - yi);
        for (long k = 0; k < m; ++k) {
            double x = pts[2 * k], y = pts[2 * k + 1];
            if ((yi > y) != (yj > y)) {
                double xcross = xi + (y - yi) * inv * (xj - xi);
                if (x < xcross) out[k] ^= 1;
            }
        }
    }
}

// Centroid-distance deduplication (geometry/dedup.py, itself the
// reference predict_wsi.py:896-965): find every pair of cells whose
// centers lie within max_dist (scipy cKDTree.query_pairs semantics,
// d <= r), run the reference's greedy group assignment over the pairs in
// SORTED (a, b) order — including its quirks: a pair joining two
// existing groups appends to the FIRST member's group without updating
// the other member's mapping, and list membership is per-group — then
// keep only the largest-area member of each multi-member group
// (first-max tie-break, like np.argmax). Pair search is a uniform grid
// hash at cell size max_dist (3x3 neighborhood scan), O(n + pairs).
// centers: n interleaved x,y float64; sizes: n float64;
// keep: n uint8 out (1 = keep). Returns the number removed.
long dedup_keep(const double* centers, const double* sizes, long n,
                double max_dist, uint8_t* keep) {
    for (long i = 0; i < n; ++i) keep[i] = 1;
    if (n < 2) return 0;
    double minx = centers[0], miny = centers[1];
    for (long i = 1; i < n; ++i) {
        if (centers[2 * i] < minx) minx = centers[2 * i];
        if (centers[2 * i + 1] < miny) miny = centers[2 * i + 1];
    }
    const double inv = 1.0 / max_dist;
    const double r2 = max_dist * max_dist;
    // grid keys (gx, gy) packed into 64-bit; sort point ids by key
    std::vector<uint64_t> key(n);
    std::vector<long> order(n);
    for (long i = 0; i < n; ++i) {
        uint64_t gx = (uint64_t)((centers[2 * i] - minx) * inv);
        uint64_t gy = (uint64_t)((centers[2 * i + 1] - miny) * inv);
        key[i] = (gy << 32) | gx;
        order[i] = i;
    }
    std::sort(order.begin(), order.end(),
              [&](long a, long b) { return key[a] < key[b]; });
    std::vector<uint64_t> skey(n);
    for (long i = 0; i < n; ++i) skey[i] = key[order[i]];

    // pairs (a < b), later sorted lexicographically
    std::vector<std::pair<int64_t, int64_t>> pairs;
    for (long i = 0; i < n; ++i) {
        uint64_t gx = key[i] & 0xFFFFFFFFULL, gy = key[i] >> 32;
        double xi = centers[2 * i], yi = centers[2 * i + 1];
        for (int dy = -1; dy <= 1; ++dy) {
            if (gy == 0 && dy < 0) continue;
            for (int dx = -1; dx <= 1; ++dx) {
                if (gx == 0 && dx < 0) continue;
                uint64_t k = ((gy + dy) << 32) | (gx + dx);
                auto lo = std::lower_bound(skey.begin(), skey.end(), k)
                          - skey.begin();
                auto hi = std::upper_bound(skey.begin(), skey.end(), k)
                          - skey.begin();
                for (long t = lo; t < hi; ++t) {
                    long j = order[t];
                    if (j <= i) continue;
                    double ddx = centers[2 * j] - xi;
                    double ddy = centers[2 * j + 1] - yi;
                    if (ddx * ddx + ddy * ddy <= r2)
                        pairs.emplace_back(i, j);
                }
            }
        }
    }
    std::sort(pairs.begin(), pairs.end());

    // greedy grouping, bug-compatible with the Python reference loop
    // ("if x not in groups[gid]" is a literal list-membership scan —
    // groups stay small, and a point CAN legitimately appear in several
    // groups' lists when it joins via cross-group pairs without ever
    // getting its own mapping)
    std::vector<int64_t> member_to_group(n, -1);
    std::vector<std::vector<int64_t>> groups;
    for (auto& pr : pairs) {
        int64_t a = pr.first, b = pr.second, gid;
        if (member_to_group[a] < 0 && member_to_group[b] < 0) {
            gid = (int64_t)groups.size();
            groups.emplace_back();
            member_to_group[a] = gid;
            member_to_group[b] = gid;
        } else {
            gid = member_to_group[a] >= 0 ? member_to_group[a]
                                          : member_to_group[b];
        }
        auto& g = groups[gid];
        if (std::find(g.begin(), g.end(), a) == g.end()) g.push_back(a);
        if (std::find(g.begin(), g.end(), b) == g.end()) g.push_back(b);
    }

    long removed = 0;
    for (auto& g : groups) {
        if (g.size() < 2) continue;
        int64_t largest = g[0];
        double best = sizes[g[0]];
        for (size_t t = 1; t < g.size(); ++t)
            if (sizes[g[t]] > best) { best = sizes[g[t]]; largest = g[t]; }
        for (int64_t v : g)
            if (v != largest && keep[v]) { keep[v] = 0; ++removed; }
    }
    return removed;
}

}  // extern "C"
