// Timing oracle: measure the reference m.predict() throughput on a METIS
// graph (our harness over the unmodified reference inference code).
// Usage: ./bench_predict <metis graph> [iters] [model.txt]
// Prints: <seconds-per-predict> <directed-edges> on one line.
#include "gnn_inference.hpp"
#include "reduction_graph.hpp"

#include <chrono>
#include <cstdio>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

using Tn = uint32_t;
using Tw = uint32_t;

int main(int argc, char **argv) {
    if (argc < 2) {
        std::fprintf(stderr, "usage: %s graph.metis [iters] [model.txt]\n", argv[0]);
        return 1;
    }
    std::ifstream fs(argv[1]);
    size_t N, E;
    std::string line;
    std::getline(fs, line);
    std::stringstream header(line);
    header >> N >> E;
    std::vector<Tw> weights(N);
    std::vector<std::pair<Tn, Tn>> edges;
    for (size_t i = 0; i < N; ++i) {
        std::getline(fs, line);
        std::stringstream ss(line);
        ss >> weights[i];
        size_t v;
        while (ss >> v)
            if (v - 1 > i)
                edges.push_back({(Tn)i, (Tn)(v - 1)});
    }
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
    reduction_graph<Tn, Tw> g(weights, edges);

    float ws = 0.0f;
    for (auto &&w : weights)
        ws = std::max(ws, (float)w);

    int iters = argc > 2 ? std::atoi(argv[2]) : 5;
    gnn::model m;
    const char *model_path =
        argc > 3 ? argv[3] : "gnn_mwvc/models/weights/gnn_vc_sea2022.txt";
    std::ifstream mf(model_path);
    if (!mf.is_open()) {
        std::fprintf(stderr, "cannot open model %s\n", model_path);
        return 1;
    }
    mf >> m;
    m.set_weight_scale(ws);

    matrix x(N, 1), out;
    for (size_t u = 0; u < N; ++u)
        x(u, 0) = (float)weights[u] / ws;

    m.predict(x, out, g); // warmup
    auto t0 = std::chrono::high_resolution_clock::now();
    for (int i = 0; i < iters; ++i)
        m.predict(x, out, g);
    auto t1 = std::chrono::high_resolution_clock::now();
    double sec = std::chrono::duration<double>(t1 - t0).count() / iters;
    std::printf("%.6f %zu\n", sec, edges.size() * 2);
    volatile float sink = out(0, 0);
    (void)sink;
    return 0;
}
