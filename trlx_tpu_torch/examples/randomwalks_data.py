"""Synthetic random-walk graph task (copy of examples/randomwalks_data.py,
so the port imports nothing outside its package).

A random directed graph over `n_nodes` nodes where node 0 is the goal;
training data are random walks (token id == node id); reward is the
negative number of steps taken to reach the goal (or -100 if never
reached); the quality metric is the percentage of optimal (BFS
shortest-path) length achieved.
"""

from collections import deque
from typing import Callable, List, Tuple

import numpy as np


def generate_random_walks(
    n_nodes: int = 21,
    max_length: int = 10,
    n_walks: int = 1000,
    p_edge: float = 0.1,
    seed: int = 1002,
) -> Tuple[List[List[int]], np.ndarray, Callable, Callable]:
    """Returns (walks, logit_mask, stats_fn, reward_fn).

    walks: token-id lists; logit_mask: [V, V] bool, True = edge ABSENT
    (disallowed transition), indexed by previous node — the reference's
    `~adj` convention (examples/ilql_randomwalks.py:72).
    """
    rng = np.random.default_rng(seed)
    goal = 0

    def bfs_dist(adj):
        """Shortest-path steps to the goal over edges u -> v."""
        dist = np.full(n_nodes, np.inf)
        dist[goal] = 0
        q = deque([goal])
        preds = [np.flatnonzero(adj[:, v]) for v in range(n_nodes)]
        while q:
            v = q.popleft()
            for u in preds[v]:
                if dist[u] == np.inf:
                    dist[u] = dist[v] + 1
                    q.append(u)
        return dist

    # Regenerate until every node has an outgoing edge AND every node can
    # reach the goal (the reference only retries on the first condition,
    # examples/ilql_randomwalks.py:24-28; requiring reachability too makes
    # every seed a well-posed task).
    for _ in range(1000):
        adj = rng.random((n_nodes, n_nodes)) < p_edge
        np.fill_diagonal(adj, False)
        if not adj.sum(1).all():
            continue
        # the goal is absorbing (reference: examples/ilql_randomwalks.py:31-33):
        # its only edge is the self-loop, so the eval-time logit mask forces
        # a walk that reaches the goal to stay there.
        adj[goal, :] = False
        adj[goal, goal] = True
        dist = bfs_dist(adj)
        if np.isfinite(dist[1:]).all():
            break
    else:
        raise RuntimeError("could not generate a solvable graph")

    def walk_from(start: int) -> List[int]:
        node, path = start, [start]
        for _ in range(max_length - 1):
            if node == goal:
                break
            node = int(rng.choice(np.flatnonzero(adj[node])))
            path.append(node)
        return path

    walks = [walk_from(int(rng.integers(1, n_nodes))) for _ in range(n_walks)]

    # worst = never reaching goal within max_length; best = shortest path
    # (dist from the generation loop above — every node is reachable)
    bestlen = float(
        np.mean([min(dist[n] + 1, max_length) for n in range(1, n_nodes)])
    )
    worstlen = float(max_length)

    def walk_length(sample: List[int]) -> int:
        """Steps until the goal token appears (max_length if never)."""
        for ix, tok in enumerate(sample):
            if tok == goal:
                return ix + 1
        return max_length

    def stats_fn(samples: List[List[int]]) -> dict:
        actlen = float(np.mean([walk_length(s) for s in samples]))
        pct = 100 * (worstlen - actlen) / max(worstlen - bestlen, 1e-9)
        return {"percentage": pct, "mean_walk_length": actlen}

    def reward_fn(samples: List[List[int]]) -> List[float]:
        rewards = []
        for s in samples:
            s = list(s)
            if goal in s:
                rewards.append(-float(s.index(goal) + 1))
            else:
                rewards.append(-100.0)
        return rewards

    logit_mask = ~adj
    return walks, logit_mask, stats_fn, reward_fn
