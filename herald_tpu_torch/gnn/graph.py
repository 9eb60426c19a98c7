"""Graph containers and host-side preparation for the distributed GCN
(port of `herald_tpu/gnn/graph.py`).

Host numpy over the port's `ExchangeSpec` (`parallel/exchange.py`): the
symmetric-normalized adjacency D^-1/2 (A+I) D^-1/2, the stochastic block
model task, the edges partitioned by destination owner (dst % S) and
padded to a static per-shard capacity, the static halo plan, and the
locality relabeling. Every function gives the JAX package's arrays bit
for bit for the same arguments and seed: the same `RandomState` draws in
the same order, and the same padding (pad edges: src N, dst_local
rows_per_shard, weight 0; halo pad slots rows_per_shard, halo pad edges
index 0 with weight 0).

`synthetic_sbm` draws an [N, N] float64 matrix on the host, as JAX's
does: about 3.2 GB for a moment at 20,000 nodes, 80 GB at 100,000.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from herald_tpu_torch.parallel.exchange import ExchangeSpec


@dataclasses.dataclass
class Graph:
    """Host-side graph: COO edges with weights + node data."""
    num_nodes: int
    src: np.ndarray          # [E] int32
    dst: np.ndarray          # [E] int32
    weight: np.ndarray       # [E] f32 (normalized adjacency values)
    features: np.ndarray     # [N, F] f32
    labels: np.ndarray       # [N] int32
    train_mask: np.ndarray   # [N] bool
    eval_mask: np.ndarray    # [N] bool

    def dense_adjacency(self) -> np.ndarray:
        """[N, N] dense Ā — test oracle only."""
        a = np.zeros((self.num_nodes, self.num_nodes), np.float32)
        np.add.at(a, (self.dst, self.src), self.weight)
        return a


def normalize_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                    add_self_loops: bool = True,
                    symmetrize: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GCN normalization: Ā = D^-1/2 (A [+ I]) D^-1/2.

    Matches the reference's prepare step (prepare_data_GCN15d.py
    normalization): optional symmetrization, self loops, degree from the
    loop-augmented graph. Duplicate edges are merged.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        src, dst = np.concatenate([src, loop]), np.concatenate([dst, loop])
    # merge duplicates
    key = dst * num_nodes + src
    key = np.unique(key)
    dst, src = key // num_nodes, key % num_nodes
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = (inv_sqrt[dst] * inv_sqrt[src]).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w


def synthetic_sbm(num_nodes: int = 400, num_classes: int = 4,
                  feat_dim: int = 16, p_in: float = 0.08,
                  p_out: float = 0.005, noise: float = 0.6,
                  train_frac: float = 0.3, seed: int = 0) -> Graph:
    """Stochastic-block-model node-classification task.

    Community structure in the edges + noisy community signal in the
    features; a 2-layer GCN separates it easily, an MLP on the features
    alone does not (the aggregation is what denoises).
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=num_nodes).astype(np.int32)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    upper = np.triu(rng.random_sample((num_nodes, num_nodes)) < prob, k=1)
    src, dst = np.nonzero(upper)
    src, dst, w = normalize_edges(num_nodes, src, dst)

    basis = rng.normal(size=(num_classes, feat_dim))
    feats = basis[labels] + noise * rng.normal(size=(num_nodes, feat_dim))
    train = rng.random_sample(num_nodes) < train_frac
    return Graph(num_nodes=num_nodes, src=src, dst=dst, weight=w,
                 features=feats.astype(np.float32), labels=labels,
                 train_mask=train, eval_mask=~train)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Per-shard static-shape device inputs (leading axis = shard)."""
    src: np.ndarray        # [S, E_cap] int32 global src id; pad = N
    dst_local: np.ndarray  # [S, E_cap] int32 owner-local dst slot;
                           #     pad = rows_per_shard (dropped by
                           #     segment_sum's out-of-range rule)
    weight: np.ndarray     # [S, E_cap] f32; pad = 0
    edge_cap: int
    uniq_cap: int          # static dedup width for per-shard src ids


def partition_edges(spec: ExchangeSpec, g: Graph,
                    edge_cap: Optional[int] = None,
                    uniq_cap: Optional[int] = None) -> ShardedGraph:
    """Split edges by destination owner (dst % S), pad to a common cap."""
    S, rps = spec.num_shards, spec.rows_per_shard
    owner = g.dst % S
    counts = np.bincount(owner, minlength=S)
    cap = int(counts.max()) if edge_cap is None else int(edge_cap)
    if counts.max() > cap:
        raise ValueError(f"edge_cap {cap} < max per-shard edges "
                         f"{int(counts.max())}")
    src = np.full((S, cap), g.num_nodes, np.int32)
    dstl = np.full((S, cap), rps, np.int32)
    wgt = np.zeros((S, cap), np.float32)
    for s in range(S):
        sel = owner == s
        n = int(counts[s])
        src[s, :n] = g.src[sel]
        dstl[s, :n] = g.dst[sel] // S
        wgt[s, :n] = g.weight[sel]
    if uniq_cap is None:
        worst = max(int(len(np.unique(g.src[owner == s])))
                    for s in range(S)) if len(g.src) else 1
        uniq_cap = min(spec.num_rows, max(worst, 1))
    return ShardedGraph(src=src, dst_local=dstl, weight=wgt,
                        edge_cap=cap, uniq_cap=int(uniq_cap))


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-precomputed static exchange for a fixed graph.

    The graph never changes between steps, so the id routing the dynamic
    pull path re-derives every step (dedup + route_ids all_to_all) is
    computed ONCE here, exactly: per shard pair (t -> s), the sorted
    unique rows t must send s (only rows s actually references and does
    NOT own — locals never touch the wire), padded to the max pair width.
    """
    send_slot: np.ndarray     # [S, S, C] int32: [s, t, c] = local slot
                              #   shard s sends to shard t; pad = rps
    edge_vec_idx: np.ndarray  # [S, E_cap] int32 into
                              #   concat(own [rps], halo [S*C]); pad -> 0
                              #   (edge weight 0 kills the contribution)
    halo_cap: int             # C
    halo_rows: int            # total real (unpadded) halo rows


def plan_halo_exchange(spec: ExchangeSpec, g: Graph,
                       sg: ShardedGraph) -> HaloPlan:
    """Build the static halo-exchange plan from the partitioned edges."""
    S, rps, N = spec.num_shards, spec.rows_per_shard, g.num_nodes
    cap = sg.edge_cap
    # need[s][t] = sorted unique rows shard s references from owner t!=s
    need = [[None] * S for _ in range(S)]
    for s in range(S):
        real = sg.src[s][sg.src[s] < N]
        owners = real % S
        for t in range(S):
            if t == s:
                continue
            need[s][t] = np.unique(real[owners == t])
    C = max((len(need[s][t]) for s in range(S) for t in range(S)
             if t != s), default=1)
    C = max(C, 1)
    send_slot = np.full((S, S, C), rps, np.int32)
    halo_rows = 0
    for s in range(S):
        for t in range(S):
            if t == s or len(need[s][t]) == 0:
                continue
            rows = need[s][t]
            send_slot[t, s, :len(rows)] = rows // S  # t sends to s
            halo_rows += len(rows)
    edge_idx = np.zeros((S, cap), np.int32)
    for s in range(S):
        # halo position of remote row r (owner t): rps + t*C + rank in
        # need[s][t]
        pos = {}
        for t in range(S):
            if t == s or need[s][t] is None:
                continue
            for i, r in enumerate(need[s][t]):
                pos[int(r)] = rps + t * C + i
        for e, r in enumerate(sg.src[s]):
            r = int(r)
            if r >= N:
                continue  # pad edge: index 0, weight 0
            edge_idx[s, e] = (r // S) if r % S == s else pos[r]
    return HaloPlan(send_slot=send_slot, edge_vec_idx=edge_idx,
                    halo_cap=int(C), halo_rows=int(halo_rows))


def locality_reorder(g: Graph, num_shards: int,
                     rounds: int = 10, seed: int = 0) -> np.ndarray:
    """Relabeling that turns strided ownership into a locality partition.

    The reference fixes partition locality with offline reorder pipelines
    (METIS/slashburn/degree, `tests/test_DistGCN/
    prepare_data_GCN15d_reorder.py`). Here ownership is id % S, so ANY
    partition is realizable by relabeling: run label propagation to find
    communities, pack communities into S balanced groups, then give
    group p the ids congruent to p (mod S).

    Returns new_id[old_id]; apply with `relabel_graph`.
    """
    N, S = g.num_nodes, num_shards
    rng = np.random.RandomState(seed)
    label = np.arange(N, dtype=np.int64)
    # drop self loops for propagation
    m = g.src != g.dst
    src, dst = g.src[m].astype(np.int64), g.dst[m].astype(np.int64)
    nodes = np.concatenate([dst, src])
    for _ in range(rounds):
        # synchronous majority-vote label propagation: each node adopts
        # the most frequent neighbor label (ties -> larger label id,
        # deterministic). Majority voting keeps labels from flooding
        # across sparse community boundaries.
        nlabs = np.concatenate([label[src], label[dst]])
        key = nodes * np.int64(N) + nlabs
        uk, counts = np.unique(key, return_counts=True)
        kn, kl = uk // N, uk % N
        idx = np.lexsort((kl, counts, kn))
        last = np.r_[kn[idx][1:] != kn[idx][:-1], True]
        nxt = label.copy()
        nxt[kn[idx][last]] = kl[idx][last]
        if np.array_equal(nxt, label):
            break
        label = nxt
    # pack communities into S groups, biggest first, least-loaded group
    comm, counts = np.unique(label, return_counts=True)
    order = np.argsort(-counts)
    load = np.zeros(S, np.int64)
    group_of = {}
    for ci in order:
        p = int(np.argmin(load))
        group_of[int(comm[ci])] = p
        load[int(p)] += counts[ci]
    node_group = np.array([group_of[int(l)] for l in label])
    new_id = np.empty(N, np.int64)
    next_free = np.arange(S)  # next id ≡ p (mod S) per group
    for v in rng.permutation(N):
        p = node_group[v]
        new_id[v] = next_free[p]
        next_free[p] += S
    # groups are balanced only approximately: ids may exceed N for the
    # heavier groups — that's fine, the spec pads rows_per_shard anyway
    return new_id


def relabel_graph(g: Graph, new_id: np.ndarray) -> Graph:
    """Apply a node relabeling (features/labels/masks reindexed)."""
    n_new = int(new_id.max()) + 1
    inv = np.full(n_new, -1, np.int64)
    inv[new_id] = np.arange(g.num_nodes)
    present = inv >= 0
    take = np.where(present, inv, 0)
    feats = np.where(present[:, None], g.features[take], 0.0).astype(
        g.features.dtype)
    labels = np.where(present, g.labels[take], 0).astype(g.labels.dtype)
    tr = np.where(present, g.train_mask[take], False)
    ev = np.where(present, g.eval_mask[take], False)
    return Graph(num_nodes=n_new, src=new_id[g.src].astype(np.int32),
                 dst=new_id[g.dst].astype(np.int32),
                 weight=g.weight.copy(), features=feats, labels=labels,
                 train_mask=tr, eval_mask=ev)


def shard_node_array(spec: ExchangeSpec, x: np.ndarray,
                     fill=0) -> np.ndarray:
    """[N, ...] logical node array -> [S*rps, ...] physical layout
    (strided ownership), padding slots = `fill`."""
    phys = np.full((spec.padded_rows,) + x.shape[1:], fill, x.dtype)
    ids = np.arange(spec.num_rows)
    phys[spec.phys_index(ids)] = x
    return phys
