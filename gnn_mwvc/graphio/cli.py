"""mwvc-tools: the data-prep / validation utility suite.

Subcommands mirror the reference's standalone apps (SURVEY.md §2.3):

  gen-weights       MTX edge list -> weighted "E N" instance
                    (reference: old_files/src/apps/gen_weights.cpp)
  gen-reduced       3-rule kernelization of an "E N" instance
                    (reference: gen_reduced_graph.cpp)
  mtx-to-graph      "E N" file -> METIS file (reference: mtx_to_graph.cpp)
  vc-validate       check a 0/1 solution covers a METIS graph; print cost
                    (reference: vc_validate.cpp)
  is-to-vc          validate an IS solution and convert to a VC file
                    (reference: is_vc_converter.cpp)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mwvc-tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gen-weights")
    p.add_argument("mtx_in")
    p.add_argument("graph_out")
    p.add_argument("min", type=int)
    p.add_argument("max", type=int)
    p.add_argument("seed", type=int)

    p = sub.add_parser("gen-reduced")
    p.add_argument("graph_in")
    p.add_argument("graph_out")

    p = sub.add_parser("mtx-to-graph")
    p.add_argument("graph_in")
    p.add_argument("metis_out")

    p = sub.add_parser("vc-validate")
    p.add_argument("metis_graph")
    p.add_argument("solution")

    p = sub.add_parser("is-to-vc")
    p.add_argument("metis_graph")
    p.add_argument("is_solution")
    p.add_argument("vc_out")

    args = ap.parse_args(argv)

    from gnn_mwvc.graphio import (
        cover_cost,
        gen_weights,
        independent_set_to_cover,
        is_independent_set,
        is_vertex_cover,
        mtx_to_metis,
        read_edge_graph,
        read_metis,
        read_mtx_edges,
        read_solution,
        write_edge_graph,
        write_solution,
    )

    if args.cmd == "gen-weights":
        n, edges = read_mtx_edges(args.mtx_in)
        g = gen_weights(n, edges, args.min, args.max, args.seed)
        write_edge_graph(args.graph_out, g)
        print(f"{g.n} vertices, {g.m} edges -> {args.graph_out}")
    elif args.cmd == "gen-reduced":
        from gnn_mwvc.train import gen_reduced_graph

        g = read_edge_graph(args.graph_in)
        kernel, cost, _ = gen_reduced_graph(g)
        write_edge_graph(args.graph_out, kernel)
        print(f"kernel: {kernel.n}/{g.n} vertices, {kernel.m}/{g.m} edges, "
              f"reduction cost {cost}")
    elif args.cmd == "mtx-to-graph":
        mtx_to_metis(args.graph_in, args.metis_out)
        print(f"wrote {args.metis_out}")
    elif args.cmd == "vc-validate":
        g = read_metis(args.metis_graph)
        s = read_solution(args.solution)[: g.n]
        if is_vertex_cover(g, s):
            print(f"Valid vertex cover, cost {cover_cost(g, s)}")
        else:
            print("NOT a vertex cover")
            return 1
    elif args.cmd == "is-to-vc":
        g = read_metis(args.metis_graph)
        s = read_solution(args.is_solution)[: g.n]
        if not is_independent_set(g, s):
            print("NOT an independent set")
            return 1
        vc = independent_set_to_cover(g, s)
        write_solution(args.vc_out, vc)
        is_w = int(g.weights[np.asarray(s, bool)].sum())
        print(f"IS weight {is_w}, VC cost {cover_cost(g, vc)} "
              f"-> {args.vc_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
