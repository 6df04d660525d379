"""The library's own octree build as bench.py's tree mode runs it
(bench.py:423-517, after the reference's test/performance/octree.cpp):
compute_octree from scratch and update_octree to convergence, held to the
host C++ oracle (native.compute_octree_host, the reference's
computeOctree).

The sample (`octree_sample`): n positions normal(0.5, 0.15) clipped to
[0, 1 - 1e-6] in the periodic unit box, then the same positions drifted
by uniform(-0.2, 0.2) x n^(-1/3) and clipped again, from one
RandomState(42). Bucket 16, bench.py's tree capacity
(multichip.tree_capacity) with its regrow rule, and the warm start
default_init_level(n, bucket, capacity).

`octree_build_path` runs it on a device through the port's public API;
`octree_checks` holds its trees to the cornerstone invariants
(`cornerstone_ok`), the unique fixed point (`fixed_point_ok`) and the
oracle. Failed checks raise RuntimeError."""

from __future__ import annotations

import numpy as np
import torch

from .multichip import tree_capacity

SEED = 42
BUCKET = 16


def _check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"octree build: {msg}")


def octree_sample(n: int, seed: int = SEED):
    """bench.py's tree-mode sample (bench.py:436-466): the float32 (n, 3)
    positions and their drifted copy, as the module docstring says."""
    rng = np.random.RandomState(seed)
    pos = rng.normal(0.5, 0.15, size=(n, 3)).astype(np.float32)
    pos = np.clip(pos, 0.0, 1.0 - 1e-6)
    spacing = (1.0 / n) ** (1.0 / 3.0)
    drift = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32) * spacing
    return pos, np.clip(pos + drift, 0.0, 1.0 - 1e-6)


def build_with_regrow(keys: torch.Tensor, bucket: int, capacity: int):
    """compute_octree from bench.py's warm start; where the tree outgrows
    `capacity`, the capacity regrows once as bench.py's does
    (bench.py:471-489, from the node count the build stopped at) and the
    build runs again. Returns (tree, capacity, the build's rebalance
    iterations, whether it regrew)."""
    from .tree import csarray

    n = keys.shape[0]
    real = csarray.rebalance_tree
    iters = [0]

    def counted(*a, **k):
        iters[0] += 1
        return real(*a, **k)

    csarray.rebalance_tree = counted
    try:
        for regrown in (False, True):
            iters[0] = 0
            try:
                tree = csarray.compute_octree(keys, bucket, capacity,
                                              init_level=csarray.default_init_level(n, bucket, capacity))
                return tree, capacity, iters[0], regrown
            except csarray.CapacityError as e:
                if regrown:
                    raise
                capacity = int(e.n_nodes * 1.15) // 1024 * 1024 + 4096
                print(f"octree build: regrow tree capacity -> {capacity} (the build stopped at {e.n_nodes} nodes)",
                      flush=True)
    finally:
        csarray.rebalance_tree = real


def update_to_convergence(tree, keys: torch.Tensor, bucket: int, capacity: int) -> list:
    """update_octree against `keys` until its decision converges: the list
    of (tree, converged) after each step, the last one converged. A
    step's flag judges the counts it was given, so the first step's judges
    the old keys' and the loop takes at least two."""
    from .tree.csarray import update_octree

    steps = []
    while len(steps) < 2 or not bool(steps[-1][1]):
        tree, conv = update_octree(tree, keys, bucket)
        _check(int(tree.n_nodes) <= capacity, f"the update outgrew capacity {capacity}")
        steps.append((tree, conv))
        _check(len(steps) <= 64, "update_octree does not converge in 64 steps")
    return steps


def quartiles(ms) -> dict:
    """Median and quartiles of a list of ms, and the list."""
    q1, med, q3 = np.percentile(ms, (25, 50, 75))
    return {"median": float(med), "q1": float(q1), "q3": float(q3), "ms": [float(t) for t in ms]}


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def octree_build_path(device, n: int, key_dtype, curve: str, reps: int = 0, bucket: int = BUCKET) -> dict:
    """The build at one configuration on `device`: the sample encoded by
    compute_sfc_keys and sorted by the unsigned sort, compute_octree from
    bench.py's capacity and warm start (build_with_regrow), then
    update_octree against the drifted keys to convergence. With reps > 0
    (on a card) also times `reps` builds, single update steps (bench.py's
    update) and updates to convergence by CUDA events after one warm-up
    each, each rep ending on a host read (n_nodes, the convergence flag).
    Returns a dict of the positions, the unsorted and sorted keys, the
    tree, the update steps, the iterations, the capacity and the times."""
    from .ops.keys64 import usort
    from .sfc import PERIODIC, compute_sfc_keys, make_box
    from .tree.csarray import compute_octree, default_init_level, update_octree

    pos, pos2 = octree_sample(n)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=device)

    def encode(p):
        raw = compute_sfc_keys(*(torch.from_numpy(np.ascontiguousarray(p[:, i])).to(device) for i in range(3)),
                               box, key_dtype, curve)
        return raw, usort(raw)[0]

    raw, keys = encode(pos)
    _, keys2 = encode(pos2)
    del pos2
    tree, capacity, iters, regrown = build_with_regrow(keys, bucket, tree_capacity(n, bucket))
    steps = update_to_convergence(tree, keys2, bucket, capacity)
    out = {"pos": pos, "raw": raw, "keys": keys, "keys2": keys2, "tree": tree, "steps": steps, "iters": iters,
           "capacity": capacity, "regrown": regrown}
    if reps:
        level = default_init_level(n, bucket, capacity)

        def build():
            int(compute_octree(keys, bucket, capacity, init_level=level).n_nodes)

        def one_step():
            bool(update_octree(tree, keys2, bucket)[1])

        def converge():
            update_to_convergence(tree, keys2, bucket, capacity)

        out["ms"] = {name: quartiles([_event_ms(fn) for _ in range(reps + 1)][1:])  # the first: warm-up
                     for name, fn in (("build", build), ("update_step", one_step), ("update", converge))}
    return out


def cornerstone_ok(tree, n: int, what: str = "tree") -> None:
    """The cornerstone invariants at the tree's key width: keys from 0 to
    2^(3 L) (L = 21 for 64-bit keys, 10 for 32-bit), every leaf range a
    power of 8, the counts summing to n."""
    from .ops.keys64 import to_numpy
    from .sfc.keys import max_tree_level

    nn = int(tree.n_nodes)
    top = 3 * max_tree_level(tree.keys.dtype)
    keys = to_numpy(tree.keys)[: nn + 1].astype(np.uint64)
    _check(keys[0] == 0 and int(keys[-1]) == 1 << top, f"{what}: a cornerstone tree spans [0, 2^{top})")
    d = np.diff(keys)
    _check(bool(((d & (d - np.uint64(1))) == 0).all() and (d > 0).all()), f"{what}: leaf ranges are powers of 2")
    lz = np.log2(d.astype(np.float64)).astype(np.int64)  # exact: each d is a power of 2
    _check(bool((lz % 3 == 0).all()), f"{what}: leaf ranges are powers of 8")
    _check(int(tree.counts[:nn].sum()) == n, f"{what}: leaf counts sum to n")


def fixed_point_ok(tree, bucket: int, what: str) -> int:
    """The unique converged tree at `bucket`: every leaf holds at most
    `bucket` keys or lies at the deepest level, and every complete group
    of 8 sibling leaves holds more than `bucket` (its parent would split).
    Returns the number of leaves at the deepest level above `bucket`."""
    from .ops.keys64 import to_numpy

    nn = int(tree.n_nodes)
    keys = to_numpy(tree.keys)[: nn + 1].astype(np.uint64)
    counts = tree.counts[:nn].cpu().numpy()
    d = np.diff(keys)
    deepest = d == np.uint64(1)
    over = (counts > bucket) & ~deepest
    _check(not over.any(), f"{what}: {int(over.sum())} leaves above the deepest level hold more than {bucket}")
    i = np.nonzero(keys[:max(nn - 7, 0)] % (d[:max(nn - 7, 0)] * np.uint64(8)) == 0)[0]  # a group's first slot
    group = np.all(d[i[:, None] + np.arange(8)] == d[i][:, None], axis=1)
    cs = np.concatenate([[0], np.cumsum(counts)])
    sums = (cs[i + 8] - cs[i])[group]
    _check(len(sums) > 0 and int(sums.min()) > bucket,
           f"{what}: a sibling group of {int(sums.min()) if len(sums) else -1} keys was not merged")
    return int((deepest & (counts > bucket)).sum())


def octree_checks(what: str, run: dict, n: int, key_dtype, curve: str, bucket: int = BUCKET):
    """The checks of one configuration: the cornerstone invariants and the
    unique fixed point of the build and of the converged update; both
    bit-equal, keys and counts viewed as unsigned, to the host C++ oracle
    of the same sorted keys; the keys of a Hilbert sample of at most 2M
    equal to native.hilbert_encode's. Returns the oracle's seconds and the
    build's leaves at the deepest level above the bucket. Raises if the
    oracle is unavailable (g++ missing or its build failed)."""
    import time

    from . import native
    from .ops.keys64 import to_numpy

    _check(native.available(), f"{what}: the host C++ oracle (native/csrc/cstone_host.cpp, g++) is unavailable")
    oracle_s, deep = 0.0, []
    for name, tree, keys in (("compute_octree", run["tree"], run["keys"]),
                             ("the converged update_octree", run["steps"][-1][0], run["keys2"])):
        cornerstone_ok(tree, n, f"{what}, {name}")
        deep.append(fixed_point_ok(tree, bucket, f"{what}, {name}"))
        host_keys = to_numpy(keys)
        t0 = time.perf_counter()
        want_keys, want_counts = native.compute_octree_host(host_keys, bucket, run["capacity"])
        oracle_s += time.perf_counter() - t0
        nn = int(tree.n_nodes)
        got_keys = to_numpy(tree.keys[:nn + 1])
        _check(nn + 1 == want_keys.size and np.array_equal(got_keys, want_keys),
               f"{what}: {name}'s {nn} leaves differ from the host oracle's {want_keys.size - 1}")
        _check(np.array_equal(tree.counts[:nn].cpu().numpy(), want_counts.astype(np.int64)),
               f"{what}: {name}'s counts differ from the host oracle's")
    if curve == "hilbert" and n <= 2_000_000:
        p = run["pos"]
        want = native.hilbert_encode(p[:, 0], p[:, 1], p[:, 2], [0, 1, 0, 1, 0, 1], key_dtype)
        _check(np.array_equal(to_numpy(run["raw"]), want), f"{what}: keys differ from native.hilbert_encode's")
    return oracle_s, deep[0]
