// Native CPU inference over a kernel snapshot CSR — the host half of the
// host<->device split: peel rounds below the device size threshold
// (solver/static_score.py, pipeline.GnnScorer native=True) and the phase-2
// kernel re-score run here.  The JAX-CPU path pays a DeviceGraph rebuild +
// an XLA recompile per shape bucket; this routine runs the layer walk directly over the snapshot CSR with zero
// per-round build cost, like the reference's own inference loop
// (reference: src/gnn_inference.cpp:20-47) but threaded and without the
// dense matrix class.
//
// Layer semantics mirror models/gnn.py forward() with compat=True and
// x_is_node_weights=True exactly, including the w=16 graph-layer
// column-overwrite quirk (stats written at columns w+1..w+3 AFTER the
// input copy; reference: src/gnn_inference.cpp:27-42) — the published
// weights bake it in.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace mwvc {

// layer kind codes shared with core/api.py: 0=graph 1=linear 2=relu
// 3=sigmoid
inline void cpu_forward(uint32_t n, const uint64_t *indptr,
                        const uint32_t *indices, const uint32_t *wts,
                        const uint64_t *nwv, const uint32_t *deg,
                        float ws, uint32_t n_layers, const int8_t *kinds,
                        const int32_t *dims, const float *params,
                        float *out, uint32_t n_threads) {
    constexpr int STRIDE = 36;  // max live width is 35 (2*16 + 3)
    std::vector<float> bufa((size_t)n * STRIDE, 0.0f);
    std::vector<float> bufb((size_t)n * STRIDE, 0.0f);
    float *h = bufa.data(), *h2 = bufb.data();
    int w = 1;

    for (uint32_t u = 0; u < n; ++u)
        h[(size_t)u * STRIDE] = (float)wts[u] / ws;

    uint32_t nt = std::max<uint32_t>(1, n_threads);
    auto parfor = [&](auto &&body) {
        if (nt == 1 || n < 8192) {
            body((uint32_t)0, n);
            return;
        }
        std::vector<std::thread> ts;
        uint32_t chunk = (n + nt - 1) / nt;
        for (uint32_t t = 0; t < nt; ++t) {
            uint32_t lo = t * chunk, hi = std::min(n, lo + chunk);
            if (lo >= hi) break;
            ts.emplace_back(body, lo, hi);
        }
        for (auto &th : ts) th.join();
    };

    bool first_graph = true;
    const float *P = params;
    const int32_t *D = dims;
    for (uint32_t L = 0; L < n_layers; ++L) {
        switch (kinds[L]) {
        case 1: {  // linear: y = x W + b, W row-major (din, dout)
            const int din = D[0], dout = D[1];
            D += 2;
            const float *W = P;
            const float *B = W + (size_t)din * dout;
            P = B + dout;
            parfor([&](uint32_t lo, uint32_t hi) {
                for (uint32_t u = lo; u < hi; ++u) {
                    const float *x = h + (size_t)u * STRIDE;
                    float *y = h2 + (size_t)u * STRIDE;
                    for (int j = 0; j < dout; ++j) y[j] = B[j];
                    for (int i = 0; i < din; ++i) {
                        const float xi = x[i];
                        const float *Wr = W + (size_t)i * dout;
                        for (int j = 0; j < dout; ++j) y[j] += xi * Wr[j];
                    }
                }
            });
            std::swap(h, h2);
            w = dout;
            break;
        }
        case 2:  // relu (only live columns are ever read downstream)
            parfor([&](uint32_t lo, uint32_t hi) {
                for (uint32_t u = lo; u < hi; ++u) {
                    float *x = h + (size_t)u * STRIDE;
                    for (int j = 0; j < w; ++j) x[j] = x[j] > 0 ? x[j] : 0;
                }
            });
            break;
        case 3:  // sigmoid
            parfor([&](uint32_t lo, uint32_t hi) {
                for (uint32_t u = lo; u < hi; ++u) {
                    float *x = h + (size_t)u * STRIDE;
                    for (int j = 0; j < w; ++j)
                        x[j] = 1.0f / (1.0f + std::exp(-x[j]));
                }
            });
            break;
        default: {  // graph layer: neighbor sum + compat stat placement
            const int wi = w, wo = 2 * w + 3;
            const bool fg = first_graph;
            parfor([&](uint32_t lo, uint32_t hi) {
                float agg[STRIDE];
                for (uint32_t u = lo; u < hi; ++u) {
                    const float *xu = h + (size_t)u * STRIDE;
                    float *y = h2 + (size_t)u * STRIDE;
                    if (fg) {
                        // analytic first round: sum over N(u) of W(v)/ws
                        // == NW(u)/ws (models/gnn.py x_is_node_weights)
                        agg[0] = (float)nwv[u] / ws;
                    } else {
                        for (int j = 0; j < wi; ++j) agg[j] = 0.0f;
                        for (uint64_t e = indptr[u]; e < indptr[u + 1];
                             ++e) {
                            const float *xv =
                                h + (size_t)indices[e] * STRIDE;
                            for (int j = 0; j < wi; ++j) agg[j] += xv[j];
                        }
                    }
                    for (int j = 0; j < wi; ++j) y[j] = agg[j];
                    for (int j = 0; j < wi; ++j) y[wi + j] = xu[j];
                    for (int j = 2 * wi; j < wo; ++j) y[j] = 0.0f;
                    // stats AFTER the copy, at columns w+1..w+3 (the
                    // load-bearing w=16 overwrite quirk)
                    y[wi + 1] = (float)deg[u];
                    y[wi + 2] = (float)wts[u] / ws;
                    y[wi + 3] = (float)nwv[u] / ws;
                }
            });
            first_graph = false;
            std::swap(h, h2);
            w = wo;
            break;
        }
        }
    }
    for (uint32_t u = 0; u < n; ++u) out[u] = h[(size_t)u * STRIDE];
}

}  // namespace mwvc
