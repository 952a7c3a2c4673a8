// Test oracle: run the (unmodified, read-only) reference GNN inference on a
// METIS graph and dump per-layer... final activations for every vertex.
// Built against /root/reference headers purely for differential testing; this
// file is our code.  Usage: ./dump_activations <metis graph> [weight_scale]
// Prints one score per vertex ("%.9g").
#include "gnn_inference.hpp"
#include "reduction_graph.hpp"

#include <cstdio>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

using Tn = uint32_t;
using Tw = uint32_t;

int main(int argc, char **argv) {
    if (argc < 2) {
        std::fprintf(stderr, "usage: %s graph.metis [weight_scale] [model.txt]\n", argv[0]);
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
        while (ss >> v) {
            if (v - 1 > i)
                edges.push_back({(Tn)i, (Tn)(v - 1)});
        }
    }
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
    reduction_graph<Tn, Tw> g(weights, edges);

    float ws = 0.0f;
    for (auto &&w : weights)
        ws = std::max(ws, (float)w);
    if (argc > 2)
        ws = std::atof(argv[2]);

    gnn::model m;
    const char *model_path = argc > 3 ? argv[3] : "gnn_mwvc/models/weights/gnn_vc_sea2022.txt";
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
    m.predict(x, out, g);
    for (size_t u = 0; u < N; ++u)
        std::printf("%.9g\n", out(u, 0));
    return 0;
}
