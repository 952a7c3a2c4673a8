// Reversible vertex-weighted graph for MWVC kernelization (host side).
//
// Capability-equivalent to the reference's reduction_graph
// (reference: include/reduction_graph.hpp), designed differently:
//
//  * adjacency = doubly-linked ("dancing links") entries over a flat arena
//    with per-node sentinel pairs -> O(1) unlink/relink instead of the
//    reference's binary-search + std::rotate window shuffles;
//  * every directed edge entry stores the arena index of its mirror, so
//    removing u from all neighbor lists is one pointer hop per neighbor;
//  * node ids are STABLE: there is no relabel/compaction mutation at all
//    (the reference's relable_graph + undo_relable_graph); device snapshots
//    are emitted by walking active nodes, which keeps the undo log simpler
//    and makes org_label == node id;
//  * undo is LIFO: most actions are reversed by re-walking the same
//    (untouched) source lists in reverse order; only neighborhood folds log
//    an explicit op sequence (their unlinks, followed by gadget-edge
//    appends);
//  * NW and cost are 64-bit (the reference's uint32 NW can overflow on
//    massive graphs).
//
// Sorted-order invariant: entries in each list are linked in ascending
// neighbor id; fold gadget nodes get the largest id so tail-append keeps
// order in their neighbors' lists (the reference relies on the same fact,
// reduction_graph.hpp:376-396), and a gadget's own list is appended sorted.

#pragma once
#include <algorithm>
#include <cassert>
#include <cstdint>
#include <vector>

namespace mwvc {

using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

enum class Act : u32 {
    NodeRemove,
    NbhdRemove,
    NbhdFold,
    TwinFold,
    IsoFold,
};

struct LogEntry {
    Act type;
    u32 u, v;          // v: twin partner or gadget node id
    u64 data_off, data_len;  // NbhdFold op sequence in data buffer
};

class RevGraph {
  public:
    struct Entry {
        u32 nbr;
        u32 prev, next;  // arena indices
        u32 mirror;      // arena index of the (nbr -> owner) entry
    };

    std::vector<Entry> arena;
    std::vector<u32> head, tail;     // sentinel arena indices per node
    std::vector<u32> deg;            // live degree
    std::vector<u64> w;              // node weight (reference W)
    std::vector<u64> nw;             // live neighborhood weight (reference NW)
    std::vector<uint8_t> active;
    std::vector<u32> stamp;          // scratch epoch marks
    u32 stamp_epoch = 0;

    std::vector<LogEntry> log;
    std::vector<u32> log_data;  // NbhdFold: arena indices of unlinked entries
    std::vector<u32> fold_scratch;

    u32 n_active = 0;

    // ---- construction --------------------------------------------------
    // edges: unique, u < v, lexicographically sorted.
    void init(u32 n, const u32 *weights, u64 m, const u32 *eu, const u32 *ev) {
        head.resize(n);
        tail.resize(n);
        deg.assign(n, 0);
        w.resize(n);
        nw.assign(n, 0);
        active.assign(n, 1);
        stamp.assign(n, 0);
        n_active = n;
        for (u32 i = 0; i < n; ++i)
            w[i] = weights[i];

        std::vector<u32> d(n, 0);
        for (u64 i = 0; i < m; ++i) {
            d[eu[i]]++;
            d[ev[i]]++;
            nw[eu[i]] += weights[ev[i]];
            nw[ev[i]] += weights[eu[i]];
        }
        // Arena layout: per node, [sentinel-head, entries..., sentinel-tail]
        // so initial lists are contiguous and cache friendly.
        std::vector<u64> base(n + 1, 0);
        for (u32 i = 0; i < n; ++i)
            base[i + 1] = base[i] + d[i] + 2;
        arena.resize(base[n]);
        for (u32 i = 0; i < n; ++i) {
            head[i] = (u32)base[i];
            tail[i] = (u32)(base[i + 1] - 1);
            arena[head[i]] = {UINT32_MAX, UINT32_MAX, head[i] + 1, UINT32_MAX};
            arena[tail[i]] = {UINT32_MAX, tail[i] - 1, UINT32_MAX, UINT32_MAX};
            deg[i] = d[i];
        }
        // Fill entries in sorted order; edges are sorted by (u, v) and each
        // node's neighbor sequence (merged from both directions) is built by
        // a counting pass.
        std::vector<u32> fill(n, 0);
        auto slot = [&](u32 a, u32 pos) { return head[a] + 1 + pos; };
        // first pass: u-side entries for (u, v) with v ascending arrive in
        // edge order for fixed u; v-side entries for (u, v) with u ascending
        // likewise.  To interleave into one sorted list we place neighbors
        // smaller than the node first (v-side of edges where node is the
        // larger endpoint), which come in sorted u order, then the larger
        // ones.  Count smaller-neighbors first:
        std::vector<u32> nsmall(n, 0);
        for (u64 i = 0; i < m; ++i)
            nsmall[ev[i]]++;  // ev is the larger endpoint; eu < ev is smaller
        std::vector<u32> fill_lo(n, 0), fill_hi(n, 0);
        for (u64 i = 0; i < m; ++i) {
            u32 a = eu[i], b = ev[i];
            u32 pa = nsmall[a] + fill_hi[a]++;  // b > a: goes after smalls
            u32 pb = fill_lo[b]++;              // a < b: among smalls, sorted
            u32 ea = slot(a, pa), eb = slot(b, pb);
            arena[ea] = {b, 0, 0, eb};
            arena[eb] = {a, 0, 0, ea};
        }
        // link
        for (u32 i = 0; i < n; ++i) {
            u32 prev = head[i];
            for (u32 k = 0; k < deg[i]; ++k) {
                u32 e = slot(i, k);
                arena[prev].next = e;
                arena[e].prev = prev;
                prev = e;
            }
            arena[prev].next = tail[i];
            arena[tail[i]].prev = prev;
        }
    }

    u32 size() const { return (u32)head.size(); }

    // ---- list primitives ----------------------------------------------
    inline u32 first(u32 u) const { return arena[head[u]].next; }
    inline bool at_end(u32 u, u32 e) const { return e == tail[u]; }
    inline u32 last(u32 u) const { return arena[tail[u]].prev; }
    inline bool at_rend(u32 u, u32 e) const { return e == head[u]; }

    inline void unlink(u32 e) {
        arena[arena[e].prev].next = arena[e].next;
        arena[arena[e].next].prev = arena[e].prev;
    }
    inline void relink(u32 e) {
        arena[arena[e].prev].next = e;
        arena[arena[e].next].prev = e;
    }

    u32 new_stamp() { return ++stamp_epoch; }

    u64 timestamp() const { return log.size(); }

    // ---- mutations -----------------------------------------------------
    void remove_node(u32 u) {
        assert(active[u]);
        active[u] = 0;
        n_active--;
        log.push_back({Act::NodeRemove, u, 0, 0, 0});
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            u32 v = arena[e].nbr;
            unlink(arena[e].mirror);
            deg[v]--;
            nw[v] -= w[u];
        }
    }

    void undo_remove_node(u32 u) {
        for (u32 e = last(u); !at_rend(u, e); e = arena[e].prev) {
            u32 v = arena[e].nbr;
            relink(arena[e].mirror);
            deg[v]++;
            nw[v] += w[u];
        }
        active[u] = 1;
        n_active++;
    }

    void remove_neighborhood(u32 u) {
        assert(active[u]);
        active[u] = 0;
        n_active--;
        log.push_back({Act::NbhdRemove, u, 0, 0, 0});
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            active[arena[e].nbr] = 0;
            n_active--;
        }
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            u32 v = arena[e].nbr;
            for (u32 f = first(v); !at_end(v, f); f = arena[f].next) {
                u32 x = arena[f].nbr;
                if (!active[x])
                    continue;
                unlink(arena[f].mirror);
                deg[x]--;
                nw[x] -= w[v];
            }
        }
    }

    void undo_remove_neighborhood(u32 u) {
        for (u32 e = last(u); !at_rend(u, e); e = arena[e].prev) {
            u32 v = arena[e].nbr;
            for (u32 f = last(v); !at_rend(v, f); f = arena[f].prev) {
                u32 x = arena[f].nbr;
                if (!active[x])
                    continue;
                relink(arena[f].mirror);
                deg[x]++;
                nw[x] += w[v];
            }
        }
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            active[arena[e].nbr] = 1;
            n_active++;
        }
        active[u] = 1;
        n_active++;
    }

    // Merge twin v into u (identical open neighborhoods, u keeps both
    // weights; NW of common neighbors is unchanged because W(u) grows by
    // exactly W(v) — same accounting trick as the reference,
    // reduction_graph.hpp:455-470).
    void fold_twin(u32 u, u32 v) {
        assert(active[u] && active[v]);
        active[v] = 0;
        n_active--;
        log.push_back({Act::TwinFold, u, v, 0, 0});
        for (u32 e = first(v); !at_end(v, e); e = arena[e].next) {
            unlink(arena[e].mirror);
            deg[arena[e].nbr]--;
        }
        w[u] += w[v];
        // NW of common neighbors and of u itself are already consistent:
        // twins have equal NW and are non-adjacent.
    }

    void undo_fold_twin(u32 u, u32 v) {
        w[u] -= w[v];
        for (u32 e = last(v); !at_rend(v, e); e = arena[e].prev) {
            relink(arena[e].mirror);
            deg[arena[e].nbr]++;
        }
        active[v] = 1;
        n_active++;
    }

    // Simplicial fold: u's closed neighborhood is a clique and every
    // neighbor dominates u.  Remove u and subtract W(u) from every
    // neighbor's weight (reference: reduction_graph.hpp:489-510).
    void fold_isolated(u32 u) {
        assert(active[u]);
        active[u] = 0;
        n_active--;
        log.push_back({Act::IsoFold, u, 0, 0, 0});
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            u32 v = arena[e].nbr;
            unlink(arena[e].mirror);
            deg[v]--;
            nw[v] -= w[u];
            w[v] -= w[u];
            for (u32 f = first(v); !at_end(v, f); f = arena[f].next)
                nw[arena[f].nbr] -= w[u];
        }
    }

    void undo_fold_isolated(u32 u) {
        for (u32 e = last(u); !at_rend(u, e); e = arena[e].prev) {
            u32 v = arena[e].nbr;
            for (u32 f = last(v); !at_rend(v, f); f = arena[f].prev)
                nw[arena[f].nbr] += w[u];
            w[v] += w[u];
            nw[v] += w[u];
            deg[v]++;
            relink(arena[e].mirror);
        }
        active[u] = 1;
        n_active++;
    }

    // Independent-neighborhood fold: remove u and N(u), add gadget node z of
    // weight NW(u) - W(u) adjacent to all active second neighbors
    // (reference: reduction_graph.hpp:335-397).  Returns z.
    //
    // The second neighbors are found in discovery order (per neighbor of u,
    // ascending) and appended to z's list after sorting, so z's own list
    // keeps the sorted-order invariant the merge predicates rely on
    // (is_twin, is_dominating, has_independent_neighbors).
    u32 fold_neighborhood(u32 u) {
        assert(active[u]);
        u32 z = (u32)head.size();
        u64 zw = nw[u] - w[u];
        // new node storage
        u32 zh = (u32)arena.size(), zt = zh + 1;
        arena.push_back({UINT32_MAX, UINT32_MAX, zt, UINT32_MAX});
        arena.push_back({UINT32_MAX, zh, UINT32_MAX, UINT32_MAX});
        head.push_back(zh);
        tail.push_back(zt);
        deg.push_back(0);
        w.push_back(zw);
        nw.push_back(0);
        active.push_back(1);
        stamp.push_back(0);
        n_active++;  // z active; u and N(u) deactivated below

        u64 off = log_data.size();
        active[u] = 0;
        n_active--;
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            active[arena[e].nbr] = 0;
            n_active--;
        }
        u32 mark = new_stamp();
        fold_scratch.clear();
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            u32 v = arena[e].nbr;
            for (u32 f = first(v); !at_end(v, f); f = arena[f].next) {
                u32 x = arena[f].nbr;
                if (!active[x])
                    continue;
                u32 g = arena[f].mirror;  // x-side entry for v
                unlink(g);
                deg[x]--;
                nw[x] -= w[v];
                log_data.push_back(g);
                if (stamp[x] != mark) {
                    stamp[x] = mark;
                    fold_scratch.push_back(x);
                }
            }
        }
        std::sort(fold_scratch.begin(), fold_scratch.end());
        for (u32 x : fold_scratch) {
            append_edge_tail(x, z);
            nw[z] += w[x];
            nw[x] += zw;
        }
        log.push_back({Act::NbhdFold, u, z, off, log_data.size() - off});
        return z;
    }

    void undo_fold_neighborhood(const LogEntry &le) {
        u32 u = le.u, z = le.v;
        u64 zw = w[z];
        // the gadget edges were appended after every unlink and are the
        // last 2*deg(z) arena slots (LIFO): drop them first, newest first
        while (deg[z] > 0) {
            u32 ez = (u32)arena.size() - 2;  // z-side entry
            u32 ex = ez + 1;                  // x-side entry
            u32 x = arena[ez].nbr;
            unlink(ex);
            unlink(ez);
            arena.pop_back();
            arena.pop_back();
            deg[x]--;
            deg[z]--;
            nw[x] -= zw;
            nw[z] -= w[x];
        }
        for (u64 i = le.data_off + le.data_len; i-- > le.data_off;) {
            u32 g = log_data[i];
            u32 v = arena[g].nbr;
            u32 x = arena[arena[g].mirror].nbr;
            relink(g);
            deg[x]++;
            nw[x] += w[v];
        }
        log_data.resize(le.data_off);
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            active[arena[e].nbr] = 1;
            n_active++;
        }
        active[u] = 1;
        n_active++;
        // destroy z
        n_active--;  // z was active
        arena.pop_back();  // z tail sentinel
        arena.pop_back();  // z head sentinel
        head.pop_back();
        tail.pop_back();
        deg.pop_back();
        w.pop_back();
        nw.pop_back();
        active.pop_back();
        stamp.pop_back();
    }

    // append an undirected edge (x, z) at both list tails; z must be the
    // largest id so sorted order is preserved.
    void append_edge_tail(u32 x, u32 z) {
        u32 ez = (u32)arena.size();      // entry in z's list, nbr = x
        u32 ex = ez + 1;                 // entry in x's list, nbr = z
        u32 zp = arena[tail[z]].prev, xp = arena[tail[x]].prev;
        arena.push_back({x, zp, tail[z], ex});
        arena.push_back({z, xp, tail[x], ez});
        arena[zp].next = ez;
        arena[tail[z]].prev = ez;
        arena[xp].next = ex;
        arena[tail[x]].prev = ex;
        deg[z]++;
        deg[x]++;
    }

    void pop_action() {
        LogEntry le = log.back();
        log.pop_back();
        switch (le.type) {
        case Act::NodeRemove: undo_remove_node(le.u); break;
        case Act::NbhdRemove: undo_remove_neighborhood(le.u); break;
        case Act::NbhdFold: undo_fold_neighborhood(le); break;
        case Act::TwinFold: undo_fold_twin(le.u, le.v); break;
        case Act::IsoFold: undo_fold_isolated(le.u); break;
        }
    }

    // ---- predicates (reference: reduction_graph.hpp:179-237) -----------
    bool is_twin(u32 u, u32 v) const {
        if (u == v || deg[u] != deg[v] || nw[u] != nw[v])
            return false;
        u32 a = first(u), b = first(v);
        while (!at_end(u, a)) {
            if (arena[a].nbr != arena[b].nbr)
                return false;
            a = arena[a].next;
            b = arena[b].next;
        }
        return true;
    }

    // u dominates v: N(v) \ {u} subset of N(u), with degree and weighted
    // pre-checks identical to the reference.
    bool is_dominating(u32 u, u32 v) const {
        if (deg[u] < deg[v] || (w[u] + nw[u]) < (w[v] + nw[v]))
            return false;
        u32 a = first(u), b = first(v);
        while (!at_end(v, b)) {
            if (arena[b].nbr == u) {
                b = arena[b].next;
                continue;
            }
            if (at_end(u, a))
                return false;
            if (arena[b].nbr < arena[a].nbr)
                return false;
            if (arena[a].nbr == arena[b].nbr)
                b = arena[b].next;
            a = arena[a].next;
        }
        return true;
    }

    bool is_isolated(u32 u) const {
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next)
            if (!is_dominating(arena[e].nbr, u))
                return false;
        return true;
    }

    bool has_independent_neighbors(u32 u) const {
        // no two neighbors adjacent <=> N(u) and N(v) disjoint for v in N(u)
        for (u32 e = first(u); !at_end(u, e); e = arena[e].next) {
            u32 v = arena[e].nbr;
            u32 a = first(u), b = first(v);
            while (!at_end(u, a) && !at_end(v, b)) {
                u32 x = arena[a].nbr, y = arena[b].nbr;
                if (x == y)
                    return false;
                if (x < y)
                    a = arena[a].next;
                else
                    b = arena[b].next;
            }
        }
        return true;
    }
};

}  // namespace mwvc
